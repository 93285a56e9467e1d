"""The port's blocked flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels (``_flash_fwd_kernel``,
``_flash_dq_kernel``, ``_flash_dkdv_kernel``) through Pallas' interpreter,
as ``tests/test_flash_kernel.py`` does; the port's side runs its plain
versions, which the CUDA kernels are held to on the card. Inputs are numpy
arrays from a seed; shapes and the five mask cases are those of
``tests/test_flash_kernel.py`` (B=2, S=128, H=4, Hkv=2, D=16, blocks of 32).
Each interpreted JAX call costs seconds here, so the JAX results are made
once per module and cached.

Tolerances, relative to the largest magnitude of the JAX result (at least
1): f32 1e-5 — both sides walk the same blocks with the same online softmax
and differ only in the order of f32 sums inside a block's products. bf16
2**-6 — both round p to bf16 against the same running max at the same
block boundaries, so a value on the other side of a rounding boundary
moves by one bf16 step (two allowed). The lattice is compared as integers,
exactly; the NaN-poison tests compare bitwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu_torch.ops import attention as tattn
tfa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("accelerate_tpu.ops.flash_attention")

B, S, H, HKV, D = 2, 128, 4, 2, 16
BQ = BKV = 32
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
PACKED = np.repeat([[1] * 64 + [2] * 40 + [0] * 24], B, 0).astype(np.int32)
MASK_CASES = {
    "dense": {},
    "causal": dict(causal=True),
    "window": dict(causal=True, window=40),
    "packed": dict(segment_ids=PACKED),
    "all": dict(causal=True, window=50, segment_ids=PACKED),
}


def _inputs(seed=0, h=H, hkv=HKV, b=B, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, D)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, D)).astype(np.float32)
    do = rng.standard_normal((b, s, h, D)).astype(np.float32)
    return q, k, v, do


def _assert_close(got, want, dtype, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, f"{what}: max abs err {err} (scale {scale})"


def _jax_flash(q, k, v, do, dtype, kw, grads=True, block_q=BQ, block_kv=BKV):
    """JAX ``flash_attention`` through its interpreted kernels: ``(out,)``
    or ``(out, dq, dk, dv)`` as f32 numpy."""
    jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    args = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    with pytest.MonkeyPatch.context() as mp:  # also inside module-scoped fixtures
        mp.setenv("ACCELERATE_FLASH_KERNEL", "interpret")
        fn = lambda a, b, c: jfa.flash_attention(a, b, c, block_q=block_q,  # noqa: E731
                                                 block_kv=block_kv, **jkw)
        if not grads:
            return (np.asarray(fn(*args), np.float32),)
        out, vjp = jax.vjp(fn, *args)
        return tuple(np.asarray(x, np.float32) for x in (out, *vjp(jnp.asarray(do).astype(dtype))))


def _port_flash(q, k, v, do, dtype, kw, grads=True, block_q=BQ, block_kv=BKV):
    tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val
           for key, val in kw.items()}
    ins = [torch.from_numpy(x).to(dtype).requires_grad_(grads) for x in (q, k, v)]
    out = tfa.flash_attention(*ins, block_q=block_q, block_kv=block_kv, **tkw)
    if not grads:
        return (out,)
    return (out, *torch.autograd.grad(out, ins, torch.from_numpy(do).to(dtype)))


@pytest.fixture(scope="module")
def jax_f32():
    q, k, v, do = _inputs()
    return {name: _jax_flash(q, k, v, do, jnp.float32, kw) for name, kw in MASK_CASES.items()}


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_f32_forward_and_grads_match_the_tpu_kernels(jax_f32, name):
    q, k, v, do = _inputs()
    got = _port_flash(q, k, v, do, torch.float32, MASK_CASES[name])
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, jax_f32[name]):
        _assert_close(a, b, "float32", f"{name} {what}")


@pytest.mark.parametrize("name", list(MASK_CASES))
def test_bf16_forward_matches_the_tpu_kernel(name):
    q, k, v, do = _inputs(1)
    want = _jax_flash(q, k, v, do, jnp.bfloat16, MASK_CASES[name], grads=False)[0]
    got = _port_flash(q, k, v, do, torch.bfloat16, MASK_CASES[name], grads=False)[0]
    assert got.dtype == torch.bfloat16
    _assert_close(got, want, "bfloat16", name)


def _jax_cfg(kw, h=H, hkv=HKV, block_q=BQ, block_kv=BKV):
    return jfa._FlashConfig(scale=1.0 / np.sqrt(D), causal=kw.get("causal", False),
                            window=kw.get("window"), block_q=block_q, block_kv=block_kv, h=h,
                            hkv=hkv, use_seg="segment_ids" in kw, interpret=True)


def _port_cfg(kw, h=H, hkv=HKV, block_q=BQ, block_kv=BKV):
    return tfa._FlashConfig(scale=1.0 / np.sqrt(D), causal=kw.get("causal", False),
                            window=kw.get("window"), block_q=block_q, block_kv=block_kv, h=h,
                            hkv=hkv, use_seg="segment_ids" in kw)


def _seg(kw):
    return kw.get("segment_ids", np.zeros((B, S), np.int32))


@pytest.mark.parametrize("name", ["causal", "all"])
def test_plain_passes_match_each_tpu_kernel(name):
    """The three plain versions against the three TPU kernels one by one,
    on the same saved tensors: out and lse; dq; dk and dv (the JAX layout
    is [B·H, S, D] and [B·H, S] for the row statistics)."""
    kw = MASK_CASES[name]
    q, k, v, do = _inputs(2)
    jcfg = _jax_cfg(kw)

    def flat(x):  # BSHD → [B·heads, S, D]
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, S, D))

    seg = _seg(kw)
    out3, res = jfa._flash_call_fwd(flat(q), flat(k), flat(v), jnp.asarray(seg), jcfg)
    dq3, dk3, dv3, _ = jfa._flash_call_bwd(jcfg, res, flat(do))
    lse = np.asarray(res[4]).reshape(B, H, S)

    cfg = _port_cfg(kw)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    tseg = torch.from_numpy(seg)
    ids, counts, idsT, countsT = tfa._block_lattice(tseg, cfg)
    out, tlse = tfa.flash_attention_fwd_reference(tq, tk, tv, tseg, ids, counts, cfg)

    def bshd(x3, heads):
        return np.asarray(x3).reshape(B, heads, S, D).transpose(0, 2, 1, 3)

    _assert_close(out, bshd(out3, H), "float32", "out")
    _assert_close(tlse, lse, "float32", "lse")
    # the backward from JAX's saved out and lse on both sides
    jout = torch.from_numpy(bshd(out3, H).copy())
    jlse = torch.from_numpy(lse.copy())
    delta = (tdo * jout).sum(-1).transpose(1, 2).contiguous()
    dq = tfa.flash_attention_dq_reference(tq, tk, tv, tseg, jlse, delta, tdo, ids, counts, cfg)
    dk, dv = tfa.flash_attention_dkdv_reference(tq, tk, tv, tseg, jlse, delta, tdo, idsT,
                                                countsT, cfg)
    _assert_close(dq, bshd(dq3, H), "float32", "dq")
    _assert_close(dk, bshd(dk3, HKV), "float32", "dk")
    _assert_close(dv, bshd(dv3, HKV), "float32", "dv")


@pytest.mark.parametrize("h,hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
def test_gqa_ratios_fwd_and_bwd(h, hkv):
    """The GQA broadcast (forward, dq) and the group fold (dk/dv) at every
    ratio of ``tests/test_flash_kernel.py``."""
    q, k, v, do = _inputs(3, h=h, hkv=hkv)
    kw = dict(causal=True)
    want = _jax_flash(q, k, v, do, jnp.float32, kw)
    got = _port_flash(q, k, v, do, torch.float32, kw)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        _assert_close(a, b, "float32", f"H={h} Hkv={hkv} {what}")


def test_rectangular_blocks():
    q, k, v, do = _inputs(4)
    kw = dict(causal=True)
    want = _jax_flash(q, k, v, do, jnp.float32, kw, block_q=32, block_kv=64)
    got = _port_flash(q, k, v, do, torch.float32, kw, block_q=32, block_kv=64)
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_close(a, b, "float32", f"32x64 {what}")


LATTICE_CASES = [
    (dict(), 32, 32), (dict(causal=True), 32, 32), (dict(causal=True, window=40), 32, 32),
    (dict(segment_ids=PACKED), 32, 32), (dict(causal=True, window=50, segment_ids=PACKED), 32, 32),
    (dict(causal=True, segment_ids=PACKED), 32, 64), (dict(causal=True, window=8), 64, 32),
]


@pytest.mark.parametrize("kw,block_q,block_kv", LATTICE_CASES)
def test_block_lattice_equals_jax(kw, block_q, block_kv):
    seg = _seg(kw)
    want = jfa._block_lattice(jnp.asarray(seg), _jax_cfg(kw, block_q=block_q, block_kv=block_kv))
    got = tfa._block_lattice(torch.from_numpy(seg), _port_cfg(kw, block_q=block_q,
                                                              block_kv=block_kv))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and a.is_contiguous()
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _poisoned(rows):
    q, k, v, do = _inputs(5, b=1, h=2, hkv=2)
    kbad, vbad = k.copy(), v.copy()
    kbad[:, rows] = np.nan
    vbad[:, rows] = np.nan
    return q, (k, v), (kbad, vbad), do


class TestBlockSkip:
    """A block the lattice skips is never read: NaN-poisoning it leaves
    every row that does not attend into it bitwise unchanged."""

    def test_sliding_window_skips_out_of_band_blocks(self):
        # window 32, blocks of 32: query rows >= 64 never touch kv block 0
        q, good, bad, _ = _poisoned(slice(0, 32))
        kw = dict(causal=True, window=32, block_q=BQ, block_kv=BKV)
        out = tfa.flash_attention(torch.from_numpy(q), *map(torch.from_numpy, good), **kw)
        outbad = tfa.flash_attention(torch.from_numpy(q), *map(torch.from_numpy, bad), **kw)
        assert torch.equal(out[:, 64:], outbad[:, 64:])
        assert torch.isfinite(outbad[:, 64:]).all()

    def test_packed_segments_skip_cross_document_blocks(self):
        q, good, bad, _ = _poisoned(slice(0, 64))
        seg = torch.tensor([[1] * 64 + [2] * 64], dtype=torch.int32)
        kw = dict(segment_ids=seg, block_q=BQ, block_kv=BKV)
        out = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(bad[0]),
                                  torch.from_numpy(good[1]), **kw)
        ref = tfa.flash_attention(torch.from_numpy(q), *map(torch.from_numpy, good), **kw)
        assert torch.equal(out[:, 64:], ref[:, 64:])

    def test_backward_also_skips(self):
        q, good, bad, _ = _poisoned(slice(0, 32))

        def dq_of(kk, vv):
            a = torch.from_numpy(q).requires_grad_(True)
            out = tfa.flash_attention(a, torch.from_numpy(kk), torch.from_numpy(vv), causal=True,
                                      window=32, block_q=BQ, block_kv=BKV)
            (out[:, 64:] ** 2).sum().backward()
            return a.grad

        assert torch.equal(dq_of(*good)[:, 64:], dq_of(*bad)[:, 64:])


def test_flash_raises_on_what_it_does_not_take():
    q = torch.zeros(1, 128, 2, 16)
    with pytest.raises(ValueError, match="window requires causal"):
        tfa.flash_attention(q, q, q, window=8)
    with pytest.raises(ValueError, match="window must be >= 1"):
        tfa.flash_attention(q, q, q, causal=True, window=0)
    with pytest.raises(ValueError, match="arbitrary mask"):
        tattn.dot_product_attention(q, q, q, impl="flash", mask=torch.ones(1, 1, 128, 128).bool())
    # the JAX wrapper drops to its einsum path here; the port raises and says so
    with pytest.raises(ValueError, match="impl='xla'"):
        tfa.flash_attention(q[:, :64], q, q, causal=True)
    with pytest.raises(ValueError, match="impl='xla'"):
        tfa.flash_attention(torch.zeros(1, 160, 2, 16), torch.zeros(1, 160, 2, 16),
                            torch.zeros(1, 160, 2, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention(torch.zeros(1, 128, 3, 16), q, q)


def test_dot_product_attention_reaches_flash(monkeypatch):
    """``impl="flash"`` goes through ``flash_attention`` with the window and
    segment ids; ``"auto"`` stays on the einsum path (the TPU crossover
    table is not inherited)."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    q, k, v, _ = _inputs(6)
    seg = torch.from_numpy(PACKED)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    out = tattn.dot_product_attention(*args, causal=True, window=40, segment_ids=seg,
                                      impl="flash")
    assert calls and calls[0]["window"] == 40 and calls[0]["segment_ids"] is seg
    ref = tattn.dot_product_attention(*args, causal=True, window=40, segment_ids=seg, impl="auto")
    assert len(calls) == 1
    _assert_close(out, ref.numpy(), "float32", "flash vs einsum")
