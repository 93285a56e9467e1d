"""The port's prepared loader against the JAX package's, one process, on the
same datasets and seeds: a ``torch.utils.data.DataLoader`` rebuilt as JAX
rebuilds it (ROADMAP.md Queue C 7), skip and resume, ``SkipDataLoader``,
``state_dict`` round trips at ``prefetch_depth`` 0 and 2, a producer
exception, ``get_sampler``, the stateful-inner protocol, the
``use_stateful_dataloader`` errors and ``data_seed``.

Both sides run on the CPU: the JAX loader on a mesh of one device (or two,
for the data-parallel rows), the port's with ``device="cpu"``. Batches are
compared as integer and float arrays, exactly: a loader only moves rows.
The data-parallel case builds each rank's mesh without a process group
(``ParallelismConfig.build_mesh(2, rank=r)``), as the port's
``BatchSamplerShard`` tests hold index math without processes, and holds
rank ``r``'s batches to rows ``[r·bs, (r+1)·bs)`` of the JAX package's
global batch.
"""

import numpy as np
import pytest
import torch
import torch.utils.data as tud

import jax
from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import data_loader as jdl
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils.dataclasses import DataLoaderConfiguration as JDataLoaderConfiguration
from accelerate_tpu_torch import Accelerator, DataLoaderConfiguration
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.parallelism_config import ParallelismConfig
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.synthetic import DictDataset

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        for cls in (JAcceleratorState, JGradientState, JPartialState):
            cls._reset_state()

    reset()
    yield
    reset()


def _data(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"idx": np.arange(n, dtype=np.int64),
            "x": rng.standard_normal((n, 3)).astype(np.float32),
            "labels": rng.integers(0, 2, n).astype(np.int64)}


def _jax_mesh(dp: int = 1):
    pc = JParallelismConfig(dp_shard_size=dp)
    return pc.build_mesh(jax.devices()[:dp]), pc


def _jax_prepare(loader, dp: int = 1, **kwargs):
    mesh, pc = _jax_mesh(dp)
    return jdl.prepare_data_loader(loader, mesh=mesh, parallelism_config=pc, **kwargs)


def _np(batch) -> dict:
    return {k: np.asarray(v) for k, v in batch.items()}


def _same(got: list, want: list) -> None:
    assert len(got) == len(want), (len(got), len(want))
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.keys() == w.keys()
        for key in g:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def _epochs(loader, n: int = 2) -> list:
    out = []
    for epoch in range(n):
        loader.set_epoch(epoch)
        out.append(([_np(b) for b in loader], loader.remainder))
    return out


TORCH_CASES = {
    "shuffled": dict(n=24, bs=8, shuffle=True, drop_last=False, dp=1),
    "sequential_short_last": dict(n=21, bs=8, shuffle=False, drop_last=False, dp=1),
    "dp2_rows": dict(n=37, bs=4, shuffle=True, drop_last=False, dp=2),
}


@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_torch_dataloader_is_rebuilt_like_jax(case):
    """A plain map-style torch loader: the same batches and order over two
    epochs as the JAX package's ``prepare_data_loader`` of the same loader
    (its ``RandomSampler`` becomes the seeded permutation of epoch ``e``,
    and under dp 2 each rank reads its row), and the same ``remainder``,
    the real rows of the last global batch.

    One reference behaviour is not followed: with a short last batch and no
    padding (``sequential_short_last``, 21 rows in 8s) the JAX package
    divides by the last batch's own size (21 % 5 = 1), so its
    ``gather_for_metrics`` would keep 1 of the 5 real rows; the port's
    remainder is 21 % 8 = 5 there (ROADMAP.md Queue C 7)."""
    c = TORCH_CASES[case]
    loader = tud.DataLoader(DictDataset(_data(c["n"])), batch_size=c["bs"],
                            shuffle=c["shuffle"], drop_last=c["drop_last"])
    want = _epochs(_jax_prepare(loader, dp=c["dp"], prefetch_depth=0))
    for rank in range(c["dp"]):
        mesh = ParallelismConfig(dp_shard_size=c["dp"]).build_mesh(c["dp"], rank=rank)
        got = _epochs(tdl.prepare_data_loader(loader, CPU, mesh=mesh))
        for (g_batches, g_rem), (w_batches, w_rem) in zip(got, want):
            rows = [{k: v[rank * c["bs"]:(rank + 1) * c["bs"]] for k, v in b.items()}
                    for b in w_batches]
            _same(g_batches, rows)
            last_rows = len(w_batches[-1]["idx"])
            if last_rows == c["bs"] * c["dp"]:
                assert g_rem == w_rem, (g_rem, w_rem)
            else:
                assert (g_rem, w_rem) == (last_rows, c["n"] % last_rows), (g_rem, w_rem)
    if case == "shuffled":  # the seeded order, not torch's
        first = want[0][0][0]["idx"].tolist()
        assert first == np.random.default_rng(0).permutation(c["n"])[:c["bs"]].tolist()


def _native(n=23, bs=4, shuffle=True, seed=3):
    data = _data(n)
    return (tdl.DataLoader(DictDataset(data), batch_size=bs, shuffle=shuffle, seed=seed),
            jdl.DataLoader(DictDataset(data), batch_size=bs, shuffle=shuffle, seed=seed))


def _take(loader, k: int) -> list:
    out = []
    for i, b in enumerate(loader):
        out.append(_np(b))
        if i + 1 == k:
            break
    return out


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("stop", [2, 6], ids=["mid_epoch", "epoch_end"])
def test_state_dict_resume_matches_jax(depth, stop):
    """Read ``stop`` batches (6 is the whole epoch of 23 rows in 4s), save,
    and resume in a fresh loader: the states, the resumed epoch and the
    next one equal the JAX package's."""
    t_dl, j_dl = _native()
    t_loader = tdl.prepare_data_loader(t_dl, CPU, prefetch_depth=depth)
    j_loader = _jax_prepare(j_dl, prefetch_depth=depth)
    t_loader.set_epoch(1)
    j_loader.set_epoch(1)
    _same(_take(t_loader, stop), _take(j_loader, stop))
    t_state, j_state = t_loader.state_dict(), j_loader.state_dict()
    assert t_state == j_state, (t_state, j_state)
    t_dl2, j_dl2 = _native()
    t_new = tdl.prepare_data_loader(t_dl2, CPU, prefetch_depth=depth)
    j_new = _jax_prepare(j_dl2, prefetch_depth=depth)
    t_new.load_state_dict(t_state)
    j_new.load_state_dict(j_state)
    assert len(t_new) == len(j_new)
    t_new.set_epoch(t_state["iteration"])
    j_new.set_epoch(j_state["iteration"])
    _same([_np(b) for b in t_new], [_np(b) for b in j_new])
    _same([_np(b) for b in t_new], [_np(b) for b in j_new])
    assert t_new.state_dict() == j_new.state_dict()


def test_prefetch_depths_give_the_same_batches_and_states():
    """``prefetch_depth`` 0 and 2: equal batches, flags and states after each
    batch, through two epochs."""
    runs = []
    for depth in (0, 2):
        loader = tdl.prepare_data_loader(_native()[0], CPU, prefetch_depth=depth)
        seen = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            for b in loader:
                seen.append((b["idx"].tolist(), loader.end_of_dataloader, loader.remainder,
                             loader.state_dict()))
        runs.append(seen)
    assert runs[0] == runs[1]


def test_skip_first_batches_matches_jax():
    """One-shot: the first epoch skips, the next does not; on a prepared
    loader and on a plain one (wrapped)."""
    t_dl, j_dl = _native()
    t_loader = tdl.skip_first_batches(tdl.prepare_data_loader(t_dl, CPU), 3)
    j_loader = jdl.skip_first_batches(_jax_prepare(j_dl), 3)
    assert len(t_loader) == len(j_loader) == 3
    _same(_epochs(t_loader)[0][0], _epochs(j_loader)[0][0])
    _same([_np(b) for b in t_loader], [_np(b) for b in j_loader])
    t_dl, j_dl = _native()
    wrapped = tdl.skip_first_batches(t_dl, 2)
    assert isinstance(wrapped, tdl.DataLoaderShard) and len(wrapped) == len(t_dl) - 2
    acc = Accelerator(cpu=True)
    assert acc.skip_first_batches(wrapped, 4) is wrapped and wrapped.skip_batches == 4


def test_skip_data_loader_skips_every_epoch_and_a_resume_wins_once():
    t_dl, j_dl = _native()
    t_loader = tdl.SkipDataLoader(t_dl, skip_batches=2, device=CPU)
    mesh, pc = _jax_mesh()
    j_loader = jdl.SkipDataLoader(j_dl, skip_batches=2,
                                  assembler=jdl.GlobalBatchAssembler(mesh, pc))
    for epoch in range(2):
        t_loader.set_epoch(epoch)
        j_loader.set_epoch(epoch)
        assert len(t_loader) == len(j_loader)
        _same([_np(b) for b in t_loader], [_np(b) for b in j_loader])
    for loader in (t_loader, j_loader):
        loader.load_state_dict({"batches_seen": 4, "iteration": 2})
    assert len(t_loader) == len(j_loader)
    _same([_np(b) for b in t_loader], [_np(b) for b in j_loader])  # resumed: 4 skipped
    _same([_np(b) for b in t_loader], [_np(b) for b in j_loader])  # then 2 again


class _Boom:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        if i == 7:
            raise KeyError("row 7")
        return {"idx": np.int64(i)}


@pytest.mark.parametrize("depth", [0, 2])
def test_producer_exception_propagates(depth):
    """A dataset error in the producer thread is raised by the consumer,
    after the batches before it, as the JAX package's loader raises it."""
    got, want = [], []
    for mod, out in ((tdl, got), (jdl, want)):
        dl = mod.DataLoader(_Boom(), batch_size=2)
        loader = (tdl.prepare_data_loader(dl, CPU, prefetch_depth=depth) if mod is tdl
                  else _jax_prepare(dl, prefetch_depth=depth))
        with pytest.raises(KeyError, match="row 7"):
            for b in loader:
                out.append(np.asarray(b["idx"]).tolist())
    assert got == want == [[0, 1], [2, 3]]


def test_get_sampler_matches_jax():
    t_dl, j_dl = _native()
    t_loader, j_loader = tdl.prepare_data_loader(t_dl, CPU), _jax_prepare(j_dl)
    for t, j in ((t_loader, j_loader), (t_dl, j_dl)):
        ts, js = tdl.get_sampler(t), jdl.get_sampler(j)
        assert type(ts).__name__ == type(js).__name__ == "SeedableRandomSampler"
        assert ts.state_dict() == js.state_dict() == {"seed": 3, "epoch": 0}
    seq_t, seq_j = _native(shuffle=False)
    assert type(tdl.get_sampler(seq_t)).__name__ == type(jdl.get_sampler(seq_j)).__name__
    assert tdl.DataLoaderStateMixin is tdl.DataLoaderAdapter is tdl.DataLoaderShard


class _StatefulLoader:
    """A loader that keeps its own position (no torchdata here): batches of
    2 over 10 rows; ``_iterator_finished`` in a loaded state starts the next
    epoch from the top, as torchdata's loader does."""

    def __init__(self):
        self.pos = 0

    def __len__(self):
        return 5

    def __iter__(self):
        while self.pos < 10:
            start = self.pos
            self.pos += 2
            yield {"idx": np.arange(start, start + 2)}
        self.pos = 0

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, state):
        self.pos = 0 if state.get("_iterator_finished") else state["pos"]


@pytest.mark.parametrize("depth", [0, 2])
def test_stateful_inner_loader_protocol_matches_jax(depth):
    """The wrapped loader's state as it was after the batch last yielded
    (not after the one-ahead read), tagged with ``_iterator_finished``;
    loading it resumes at the next unread batch."""
    runs = []
    for mod in (tdl, jdl):
        loader = (tdl.prepare_data_loader(_StatefulLoader(), CPU, prefetch_depth=depth)
                  if mod is tdl else _jax_prepare(_StatefulLoader(), prefetch_depth=depth))
        states = [loader.state_dict()]
        seen = []
        for i, b in enumerate(loader):
            seen.append(np.asarray(b["idx"]).tolist())
            states.append(loader.state_dict())
            if i == 2:
                break
        fresh = (tdl.prepare_data_loader(_StatefulLoader(), CPU, prefetch_depth=depth)
                 if mod is tdl else _jax_prepare(_StatefulLoader(), prefetch_depth=depth))
        fresh.load_state_dict(states[-1])
        states.append(fresh.state_dict())
        seen.append([np.asarray(b["idx"]).tolist() for b in fresh])
        states.append(fresh.state_dict())
        runs.append((seen, states))
    assert runs[0] == runs[1]
    seen, states = runs[0]
    assert states[3] == {"pos": 6, "_iterator_finished": False}
    assert seen[-1] == [[6, 7], [8, 9]] and states[-1]["_iterator_finished"] is True


def test_use_stateful_dataloader_errors_match_jax(monkeypatch):
    """torchdata is absent: a plain torch loader raises ``ImportError`` on
    both sides; with a (stand-in) torchdata present, a loader that cannot
    be rebuilt raises ``TypeError``. The port's own loader passes."""
    assert not tdl.stateful_dataloader_available() and not jdl.stateful_dataloader_available()
    assert tdl.as_stateful_dataloader(tud.DataLoader(list(range(4)))) is None
    torch_loader = tud.DataLoader(DictDataset(_data(8)), batch_size=2)
    t_acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(
        use_stateful_dataloader=True))
    j_acc = JAccelerator(parallelism_config=JParallelismConfig(dp_shard_size=1),
                         dataloader_config=JDataLoaderConfiguration(use_stateful_dataloader=True))
    for acc in (t_acc, j_acc):
        with pytest.raises(ImportError, match="torchdata"):
            acc.prepare_data_loader(torch_loader)
    assert isinstance(t_acc.prepare_data_loader(_native()[0]), tdl.DataLoaderShard)

    class _NotRebuildable:
        def __iter__(self):
            return iter(())

    for mod in (tdl, jdl):
        monkeypatch.setattr(mod, "_stateful_dataloader_cls", lambda: object)
    for acc in (t_acc, j_acc):
        with pytest.raises(TypeError, match="cannot be rebuilt"):
            acc.prepare_data_loader(_NotRebuildable())


def test_data_seed_orders_a_rebuilt_torch_loader_like_jax():
    loader = tud.DataLoader(DictDataset(_data(20)), batch_size=4, shuffle=True)
    t_acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(data_seed=5))
    j_acc = JAccelerator(parallelism_config=JParallelismConfig(dp_shard_size=1),
                         dataloader_config=JDataLoaderConfiguration(data_seed=5))
    got, want = _epochs(t_acc.prepare_data_loader(loader)), _epochs(j_acc.prepare_data_loader(
        loader))
    for (g, gr), (w, wr) in zip(got, want):
        _same(g, w)
        assert gr == wr
    order = np.concatenate([b["idx"] for b in got[1][0]]).tolist()
    assert order == np.random.default_rng(5 + 1).permutation(20).tolist()
