"""The port's native host pipeline (``accelerate_tpu_torch.native``) against
the JAX package's ``accelerate_tpu.native``, which compiles the same
``pipeline.cc``: collation, row gathers, the token dataset and the
prefetching loader, compared bitwise (both sides copy bytes; nothing is
rounded). The library builds with ``g++`` here, so these run the C++ code
on both sides, not a fallback."""

from __future__ import annotations

import numpy as np
import pytest

import accelerate_tpu.native as jnative
import accelerate_tpu_torch.native as tnative
from accelerate_tpu_torch import data_loader as tdl


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    assert tnative.is_native_available(), "the port's pipeline library must build here"
    assert jnative.is_native_available(), "the JAX package's pipeline library must build here"


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n, shape, dtype", [
    (8, (3, 5), np.float32),
    (64, (128, 33), np.int32),       # above the C++ team's 1 MiB threshold
    (3, (), np.float64),
    (16, (7,), np.uint16),
])
def test_parallel_collate_matches_jax(n, shape, dtype):
    rng = np.random.default_rng(0)
    samples = [rng.standard_normal(shape).astype(dtype) if np.dtype(dtype).kind == "f"
               else rng.integers(0, 1000, shape).astype(dtype) for _ in range(n)]
    _same(tnative.parallel_collate(samples), jnative.parallel_collate(samples))
    # both packages read a 0-d sample as one element (np.ascontiguousarray
    # gives it a dim): (N, 1), where np.stack gives (N,)
    want = np.stack(samples) if shape else np.stack(samples)[:, None]
    _same(tnative.parallel_collate(samples), want)


def test_parallel_collate_mixed_dtypes_promote_as_numpy():
    samples = [np.arange(6, dtype=np.int32).reshape(2, 3),
               np.arange(6, dtype=np.float64).reshape(2, 3)]
    _same(tnative.parallel_collate(samples), jnative.parallel_collate(samples))
    assert tnative.parallel_collate(samples).dtype == np.float64


def test_parallel_collate_into_out():
    samples = [np.full((4, 4), i, np.float32) for i in range(5)]
    out = np.empty((5, 4, 4), np.float32)
    got = tnative.parallel_collate(samples, out=out)
    assert got is out
    _same(got, jnative.parallel_collate(samples))
    with pytest.raises(ValueError):
        tnative.parallel_collate(samples, out=np.empty((5, 4, 4), np.float64))


@pytest.mark.parametrize("idx", [[3, 0, 7, 7, 1], [0], list(range(9, -1, -1))])
def test_gather_rows_matches_jax(idx):
    src = np.random.default_rng(1).standard_normal((10, 6, 2)).astype(np.float32)
    idx = np.asarray(idx)
    _same(tnative.gather_rows(src, idx), jnative.gather_rows(src, idx))
    _same(tnative.gather_rows(src, idx), src[idx])


@pytest.mark.parametrize("idx", [[-1, 2], [0, 10], []])
def test_gather_rows_bounds_as_jax(idx):
    src = np.arange(40, dtype=np.int64).reshape(10, 4)
    idx = np.asarray(idx, dtype=np.int64)
    try:
        want = jnative.gather_rows(src, idx)
    except IndexError:
        with pytest.raises(IndexError):
            tnative.gather_rows(src, idx)
        return
    _same(tnative.gather_rows(src, idx), want)


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tokens") / "shard.bin"
    # 37 records of 16 uint16 tokens, and a partial record the dataset drops
    toks = np.random.default_rng(2).integers(0, 50000, 37 * 16 + 5).astype(np.uint16)
    toks.tofile(path)
    return str(path)


def test_token_dataset_matches_jax(token_file):
    t, j = tnative.TokenDataset(token_file, 16), jnative.TokenDataset(token_file, 16)
    assert len(t) == len(j) == 37
    for i in (0, 5, 36):
        _same(t[i], j[i])
    t.close()
    j.close()


def test_token_dataset_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        tnative.TokenDataset(str(tmp_path / "absent.bin"), 16)


def _epochs(loader, n=2):
    return [[b.copy() for b in loader] for _ in range(n)]


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [True, False])
def test_native_loader_matches_jax_over_two_epochs(token_file, shuffle, drop_last):
    kw = dict(batch_size=5, shuffle=shuffle, seed=7, drop_last=drop_last, num_workers=3,
              prefetch_depth=2)
    t = tnative.NativeDataLoader(tnative.TokenDataset(token_file, 16), **kw)
    j = jnative.NativeDataLoader(jnative.TokenDataset(token_file, 16), **kw)
    assert len(t) == len(j) == (7 if drop_last else 8)
    got, want = _epochs(t), _epochs(j)
    for e in range(2):
        assert len(got[e]) == len(want[e]) == len(t)
        for a, b in zip(got[e], want[e]):
            _same(a, b)
    if shuffle:  # the second epoch reshuffles
        assert not np.array_equal(np.concatenate(got[0]), np.concatenate(got[1]))
    t.close()
    j.close()


def test_native_loader_partly_consumed_iterator(token_file):
    """An iterator abandoned after two batches does not carry its position
    into the next epoch: the epoch advances when an iterator starts."""
    kw = dict(batch_size=4, shuffle=True, seed=3)
    t = tnative.NativeDataLoader(tnative.TokenDataset(token_file, 16), **kw)
    j = jnative.NativeDataLoader(jnative.TokenDataset(token_file, 16), **kw)
    for loader in (t, j):
        it = iter(loader)
        next(it), next(it)
    got, want = list(t), list(j)
    assert len(got) == len(want) == len(t)
    for a, b in zip(got, want):
        _same(a, b)
    # ... and it is the epoch a loader read whole once before gives
    whole = tnative.NativeDataLoader(tnative.TokenDataset(token_file, 16), **kw)
    list(whole)
    for a, b in zip(list(whole), got):
        _same(a, b)
    for loader in (t, j, whole):
        loader.close()


def test_default_collate_one_mib_leaf_goes_native(monkeypatch):
    """A leaf of 1 MiB in all goes through parallel_collate once the library
    is loaded, with the bytes of np.stack; a smaller one through np.stack."""
    calls = []
    real = tnative.parallel_collate

    def spy(samples, **kw):
        calls.append(len(samples))
        return real(samples, **kw)

    monkeypatch.setattr(tnative, "parallel_collate", spy)
    rng = np.random.default_rng(4)
    big = [{"x": rng.standard_normal((256, 128)).astype(np.float32), "y": np.int64(i)}
           for i in range(8)]  # 8 x 128 KiB = 1 MiB
    out = tdl.default_collate(big)
    assert calls == [8]
    _same(out["x"], np.stack([s["x"] for s in big]))
    _same(out["y"], np.arange(8, dtype=np.int64))
    small = [s["x"][:8] for s in big]
    _same(tdl.default_collate(small), np.stack(small))
    assert calls == [8]
    # the JAX package's collate takes the same leaf to the same bytes
    from accelerate_tpu.data_loader import default_collate as jcollate

    _same(jcollate(big)["x"], out["x"])


def test_dataloader_warms_the_build(monkeypatch):
    seen = []
    monkeypatch.setattr(tnative, "warm_build", lambda: seen.append(True))
    tdl.DataLoader(list(range(4)), batch_size=2)
    assert seen == [True]
