"""The port's fused attention against the TPU kernel bodies themselves.

``_fwd_kernel`` and ``_bwd_kernel`` of the JAX package run through Pallas'
interpreter on the CPU (``interpret=True``, the specs and batch blocks of
the JAX wrapper); the port's plain versions, which the CUDA kernels are
held to on the card, must repeat them. The port's autograd Function on CPU
tensors (the same forward/backward split as on the card) is also held to
``fused_attention`` + ``jax.vjp`` (off a TPU, the einsum path).

Tolerances, relative to the largest magnitude of the reference (at least
1): f32 1e-5 — the two sides differ only in the order of their f32 sums.
bf16 2**-6 — both round p, ds and the outputs to bf16 at the same points,
so a value landing on the other side of a rounding boundary moves by one
bf16 step (two allowed); dk/dv differ further by the GQA fold, which the
JAX package sums per q head in bf16 and the port in f32 before one
rounding. fp16 2**-9 — the same rounding points in fp16, whose step is
2**-10 of a value below 2: two steps.

The autograd Function in fp16 is held to JAX's ``fused_attention`` VJP in
fp16, which off a TPU is the einsum path (scores, softmax and the value
product in f32, one rounding of the output and of each gradient): the
port rounds p and ds to fp16 as well, a difference of a few fp16 steps of
the largest gradient, held to 2**-7.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from accelerate_tpu_torch.ops import attention as tattn
tfa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
jfa = importlib.import_module("accelerate_tpu.ops.fused_attention")

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}
VJP_TOL = {"float32": 1e-5, "float16": 2.0 ** -7}
CASES = {  # name: (H, Hkv, causal, padded)
    "padding": (4, 4, False, True),
    "causal": (4, 4, True, False),
    "causal_gqa": (4, 2, True, False),
}


def _inputs(seed, B, S, H, Hkv, D, padded):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    seg = None
    if padded:
        lens = rng.integers(S // 4, S, B)
        seg = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return q, k, v, do, seg


def _bhsd(x, dtype):
    return jnp.asarray(x.transpose(0, 2, 1, 3)).astype(dtype)


def _tpu_kernels(q, k, v, do, seg, scale, causal, dtype):
    """``_fwd_kernel`` then ``_bwd_kernel`` (on the interpreted forward's
    out and lse) through ``pl.pallas_call(interpret=True)``; BSHD numpy in,
    (out, lse [B, H, S], dq, dk, dv folded over the GQA group) out."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    use_seg = seg is not None
    jseg = jnp.asarray(seg if use_seg else np.zeros((B, S), np.int32)).reshape(B, 1, S)
    qj, kj, vj, doj = (_bhsd(x, dtype) for x in (q, k, v, do))
    kw = dict(scale=scale, causal=causal, rep=H // Hkv, use_seg=use_seg)

    bb = jfa._block_b(B, H, S, 2)
    q_spec, kv_spec, seg_spec, lse_spec = jfa._specs(H, Hkv, S, D, bb)
    out, lse = pl.pallas_call(
        functools.partial(jfa._fwd_kernel, **kw), grid=(B // bb,),
        in_specs=[q_spec, kv_spec, kv_spec, seg_spec], out_specs=[q_spec, lse_spec],
        out_shape=[jax.ShapeDtypeStruct(qj.shape, dtype),
                   jax.ShapeDtypeStruct((B, H, 1, S), jnp.float32)],
        interpret=True,
    )(qj, kj, vj, jseg)

    bb = jfa._block_b(B, H, S, 3)
    q_spec, kv_spec, seg_spec, lse_spec = jfa._specs(H, Hkv, S, D, bb)
    dq, dk, dv = pl.pallas_call(
        functools.partial(jfa._bwd_kernel, **kw), grid=(B // bb,),
        in_specs=[q_spec, kv_spec, kv_spec, seg_spec, lse_spec, q_spec, q_spec],
        out_specs=[q_spec, q_spec, q_spec],
        out_shape=[jax.ShapeDtypeStruct((B, H, S, D), dtype)] * 3,
        interpret=True,
    )(qj, kj, vj, jseg, lse, out, doj)
    if Hkv != H:  # the JAX wrapper's fold (_fused_bwd)
        dk = dk.reshape(B, Hkv, H // Hkv, S, D).sum(axis=2)
        dv = dv.reshape(B, Hkv, H // Hkv, S, D).sum(axis=2)

    def bshd(x):
        return np.ascontiguousarray(np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3))

    return bshd(out), np.array(lse[:, :, 0, :]), bshd(dq), bshd(dk), bshd(dv)


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _assert_close(got, want, dtype, what, tol=None):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want).max()))
    tol = TOL[dtype] if tol is None else tol
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} * {scale}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_the_tpu_kernel_bodies(case, S, D, dtype):
    H, Hkv, causal, padded = CASES[case]
    q, k, v, do, seg = _inputs(S + D, 2, S, H, Hkv, D, padded)
    if dtype != "float32":  # both sides start from the same 16-bit values
        q, k, v, do = (np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))
                       for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(D)
    want = _tpu_kernels(q, k, v, do, seg, scale, causal, getattr(jnp, dtype))

    tq, tk, tv, tdo = (_torch(x, dtype) for x in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    out, lse = tfa.fused_attention_fwd_reference(tq, tk, tv, tseg, scale, causal)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    _assert_close(out, want[0], dtype, "out")
    _assert_close(lse, want[1], "float32", "lse")
    # the backward from the saved out and lse, as the TPU kernel gets them
    grads = tfa.fused_attention_bwd_reference(tq, tk, tv, tseg, torch.from_numpy(want[1]),
                                              _torch(want[0], dtype), tdo, scale, causal)
    for got, ref, name in zip(grads, want[2:], ("dq", "dk", "dv")):
        assert got.dtype == tq.dtype
        _assert_close(got, ref, dtype, name)


@pytest.mark.parametrize("S,D,dtype", [
    pytest.param(128, 64, "float32", id="128-64"),
    pytest.param(256, 128, "float32", id="256-128"),
    pytest.param(128, 64, "float16", id="128-64-float16"),
    pytest.param(256, 128, "float16", id="256-128-float16"),
])
@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_matches_jax_fused_attention_vjp(case, S, D, dtype):
    """The port's Function (forward, then backward from the saved lse)
    against ``fused_attention`` and its VJP in JAX, in f32 and in fp16."""
    H, Hkv, causal, padded = CASES[case]
    q, k, v, do, seg = _inputs(7 + S, 2, S, H, Hkv, D, padded)
    q, k, v, do = (np.array(jnp.asarray(x).astype(dtype)) for x in (q, k, v, do))
    jseg = None if seg is None else jnp.asarray(seg)
    out_j, vjp = jax.vjp(lambda a, b, c: jfa.fused_attention(a, b, c, causal=causal,
                                                             segment_ids=jseg),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))

    ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    before = (tfa.fused_attention_fwd.launches, tfa.fused_attention_bwd.launches)
    out = tfa.fused_attention(*ins, causal=causal,
                              segment_ids=None if seg is None else torch.from_numpy(seg))
    grads = torch.autograd.grad(out, ins, torch.from_numpy(do))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (tfa.fused_attention_fwd.launches, tfa.fused_attention_bwd.launches) == before
    assert out.dtype == getattr(torch, dtype)
    _assert_close(out.detach(), out_j, dtype, "out", VJP_TOL[dtype])
    for got, ref, name in zip(grads, grads_j, ("dq", "dk", "dv")):
        _assert_close(got, ref, dtype, name, VJP_TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("causal,padded,Hkv", [(False, True, 4), (True, False, 2)])
def test_dot_product_attention_matches_jax(impl, causal, padded, Hkv):
    from accelerate_tpu.ops import attention as jattn

    q, k, v, _, seg = _inputs(11, 2, 128, 4, Hkv, 64, padded)
    jseg = None if seg is None else jnp.asarray(seg)
    want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=causal, segment_ids=jseg, impl=impl)
    got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal, impl=impl,
                                      segment_ids=None if seg is None else torch.from_numpy(seg))
    _assert_close(got, want, "float32", impl)


def test_xla_path_window_and_masks_match_jax():
    from accelerate_tpu.ops import attention as jattn

    rng = np.random.default_rng(12)
    q = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    allow = rng.random((2, 1, 8, 12)) < 0.7
    allow[..., -1] = True
    additive = np.where(allow, 0.0, -1e9).astype(np.float32)
    for kw in (dict(causal=True, window=5), dict(mask=allow), dict(mask=additive)):
        jkw = {key: jnp.asarray(val) if isinstance(val, np.ndarray) else val
               for key, val in kw.items()}
        tkw = {key: torch.from_numpy(val) if isinstance(val, np.ndarray) else val
               for key, val in kw.items()}
        want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           impl="xla", **jkw)
        got = tattn.dot_product_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), impl="xla", **tkw)
        _assert_close(got, want, "float32", str(sorted(kw)))


def test_attention_option_errors():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError, match="arbitrary mask"):
        tattn.dot_product_attention(q, q, q, impl="flash", mask=torch.ones(1, 1, 128, 128).bool())
    with pytest.raises(ValueError, match="impl='xla'"):
        tattn.dot_product_attention(q[:, :96], q, q, impl="flash")
    with pytest.raises(ValueError, match="window requires causal"):
        tattn.dot_product_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="arbitrary mask"):
        tattn.dot_product_attention(q, q, q, impl="fused", mask=torch.ones(1, 1, 128, 128).bool())
    with pytest.raises(ValueError, match="window"):
        tattn.dot_product_attention(q, q, q, impl="fused", causal=True, window=4)


ENVELOPE = [  # (B, Sq, H, D), (Skv, Hkv)
    ((2, 128, 12, 64), (128, 12)),    # BERT-base
    ((2, 256, 8, 128), (256, 2)),     # GQA
    ((1, 512, 2, 256), (512, 1)),
    ((2, 96, 4, 64), (96, 4)),        # S not a multiple of 128
    ((2, 128, 4, 48), (128, 4)),      # D not a multiple of 64
    ((2, 128, 4, 320), (128, 4)),     # D > 256
    ((2, 1152, 1, 64), (1152, 1)),    # S > 1024
    ((2, 128, 6, 64), (128, 4)),      # H not divisible by Hkv
    ((2, 128, 4, 64), (256, 4)),      # Sq != Skv
]


@pytest.mark.parametrize("qs,kvs", ENVELOPE)
def test_envelope_matches_fused_supported(qs, kvs):
    q = np.zeros(qs, np.float32)
    k = np.zeros((qs[0], kvs[0], kvs[1], qs[3]), np.float32)
    assert tfa.fused_supported(torch.from_numpy(q), torch.from_numpy(k)) == \
        jfa.fused_supported(q, k)


def test_envelope_drops_only_the_tpu_vmem_budget():
    """S=1024 at 12 heads: the TPU's one-row score block would not fit its
    VMEM budget, so the JAX package refuses it; the Hopper kernels stream
    tiles and take it."""
    q = np.zeros((2, 1024, 12, 64), np.float32)
    assert not jfa.fused_supported(q, q)
    assert tfa.fused_supported(torch.from_numpy(q), torch.from_numpy(q))
