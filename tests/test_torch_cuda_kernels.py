"""The CUDA kernels (paged attention, fused attention forward and backward,
flash attention forward, dq and dk/dv) against their plain PyTorch
versions, on the card (marker ``cuda``; skipped where no GPU is present);
two card-only properties of the offload paths: offloaded greedy
decoding (pinned host memory, copies on a side stream) gives the resident
path's tokens bit for bit, and ``remat="offload_dots"`` keeps its saved
projections in pinned host memory; and two of checkpoints, which need no
kernel: an async ``save_state`` owns its host bytes when it returns (the
params changed on the card right after it do not reach the file), and bf16
params on the card round-trip through ``model.npz`` (``|V2``) and the
sharded format bitwise. And the two library routes of fp8 training and
weight quantization, which replace no TPU kernel: ``fp8_dot``'s products
through ``torch._scaled_mm`` against the plain product of the same fp8
operands (with the zero padding of dimensions that are not multiples of
16), and ``int8_dynamic_matmul``'s block partials through
``torch._int_mm`` bitwise against the plain int32 product.

This file imports no JAX, so on a machine with a GPU and no JAX it runs
alone: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances (paged): f32 at atol 1e-5 (same f32 arithmetic, another
summation order); bf16 outputs at atol 2**-7, one bf16 rounding step of
outputs below 2 in magnitude (both sides accumulate in f32 and round
once). The fused and flash kernels' tolerances are stated beside their
tests.
"""

import importlib
import numpy as np
import pytest
import torch

fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _case(seed, B, S, H, Hkv, D, bs, W, starts, dev, q_dtype, kv_dtype):
    rng = np.random.default_rng(seed)
    nb = B * W + 1
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32))
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, W), np.int32)
    for b, s in enumerate(starts):
        need = min(-(-(s + S) // bs), W)
        tables[b, :need] = perm[b * W : b * W + need]
    qpos = np.asarray(starts, np.int32)[:, None] + np.arange(S, dtype=np.int32)[None]
    return (q.to(dev, q_dtype), k.to(dev, kv_dtype), v.to(dev, kv_dtype),
            torch.from_numpy(tables).to(dev), torch.from_numpy(qpos).to(dev))


DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)]


# (H, Hkv, D, bs, split): split None takes the wrapper's own keys per
# split on 5 rows of a 6-entry table (the last an inactive slot on the
# null block); otherwise the split is forced and the rows sit on its edges
# (1, C-1, C, C+1, 2C and the whole table) of a table three splits long,
# at GQA groups of 1, 4 and 16, then B=1 at the whole table and at C+1.
DECODE_CASES = [
    (32, 8, 64, 16, None), (8, 8, 32, 8, None), (16, 8, 128, 32, None), (16, 1, 64, 64, None),
    (8, 4, 64, 5, None),
    (8, 8, 64, 16, 32),      # G=1
    (32, 8, 64, 16, 64),     # G=4, the serving shape
    (16, 1, 128, 16, 128),   # G=16
    (16, 1, 64, 8, 32),
    (4, 4, 128, 32, 64),
    (32, 8, 32, 5, 128),     # a block size that does not divide the split
    (16, 1, 32, 16, 64),
    (32, 8, 128, 64, 32),    # one table entry spans two splits
    (8, 8, 32, 16, 128),
]


def _decode_rows(seed, lens, H, Hkv, D, bs, W, dev, q_dtype, kv_dtype):
    q, k, v, tables, qpos = _case(seed, len(lens), 1, H, Hkv, D, bs, W, [n - 1 for n in lens],
                                  dev, q_dtype, kv_dtype)
    return q, k, v, tables, (qpos[:, 0] + 1).to(torch.int32)


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("H,Hkv,D,bs,split", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, monkeypatch, q_dtype, kv_dtype, H, Hkv, D, bs, split):
    """Kernel vs plain; then table entries past each row's kv_len on a
    block of NaN leave the output bitwise unchanged; then a call on other
    pools and one on the first pools again, bitwise equal to the first
    call — each launch leaves the combine's tickets at 0."""
    if split is None:
        W, lens = 6, [1, 8, 3 * bs, 6 * bs, 3]
    else:
        monkeypatch.setattr(fa, "_decode_split_keys", lambda *args: split)
        W = -(-3 * split // bs)
        lens = [1, split - 1, split, split + 1, 2 * split, W * bs]
    q, k, v, tables, lens = _decode_rows(0, lens, H, Hkv, D, bs, W, dev, q_dtype, kv_dtype)
    if split is None:
        tables[4] = 0  # an inactive slot on the null block
    before = fa.paged_attention_decode.launches
    out = fa.paged_attention_decode(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert fa.paged_attention_decode.launches == before + 1
    ref = fa.paged_attention_decode_plain(q, k, v, tables, lens)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= ATOL[q_dtype]

    nan_block = k.shape[0]
    k_nan = torch.cat([k, torch.full_like(k[:1], float("nan"))])
    v_nan = torch.cat([v, torch.full_like(v[:1], float("nan"))])
    poisoned = tables.clone()
    for b, n in enumerate(lens.tolist()):
        poisoned[b, -(-n // bs):] = nan_block
    assert bool((poisoned == nan_block).any())
    out_nan = fa.paged_attention_decode(q, k_nan, v_nan, poisoned, lens)
    torch.cuda.synchronize()
    assert torch.equal(out_nan, out)

    out_other = fa.paged_attention_decode(q, v, k, tables, lens)
    out_again = fa.paged_attention_decode(q, k, v, tables, lens)
    torch.cuda.synchronize()
    ref_other = fa.paged_attention_decode_plain(q, v, k, tables, lens)
    assert float((out_other.float() - ref_other.float()).abs().max()) <= ATOL[q_dtype]
    assert torch.equal(out_again, out)

    if split is not None:  # one request alone: the whole table, then one past a split
        for n in (W * bs, split + 1):
            q1, k1, v1, t1, l1 = _decode_rows(1, [n], H, Hkv, D, bs, W, dev, q_dtype, kv_dtype)
            out1 = fa.paged_attention_decode(q1, k1, v1, t1, l1)
            torch.cuda.synchronize()
            ref1 = fa.paged_attention_decode_plain(q1, k1, v1, t1, l1)
            assert float((out1.float() - ref1.float()).abs().max()) <= ATOL[q_dtype]


def test_decode_kernel_two_streams(dev):
    """Decode calls on two streams at once, each on its own rows: every
    output is bitwise that of the same call alone — each stream merges its
    splits through scratch of its own."""
    W, bs = 32, 16
    cases = [_decode_rows(seed, lens, 32, 8, 64, bs, W, dev, torch.bfloat16, torch.bfloat16)
             for seed, lens in ((2, [37, 130, 256, 512]), (3, [512, 300, 1, 480]))]
    alone = [fa.paged_attention_decode(*c) for c in cases]
    streams = [torch.cuda.Stream(dev) for _ in cases]
    outs = [[], []]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(fa.paged_attention_decode(*cases[i]))
    torch.cuda.synchronize()
    for i in range(len(cases)):
        assert all(torch.equal(o, alone[i]) for o in outs[i])


# bf16 at D in {64, 128}, block size 8-64 and a group of 1-16 q heads per
# kv head takes the tensor-core kernel (tiles of 64/G queries x G heads);
# S below not a multiple of a tile's queries tests the partial last tile.
PREFILL_CASES = [
    # S, H, Hkv, D, bs
    (128, 32, 8, 64, 16), (37, 8, 2, 32, 8), (2, 4, 4, 128, 16), (70, 16, 1, 64, 64),
    (100, 16, 16, 64, 8),    # G=1: 64 queries a tile
    (37, 32, 8, 128, 8),     # G=4
    (70, 16, 1, 128, 32),    # G=16: 4 queries a tile
    (150, 4, 4, 128, 32),
    (45, 16, 1, 64, 16),
    (130, 8, 2, 64, 32),
    (60, 12, 4, 64, 16),     # G=3: the CUDA-core kernel in bf16 too
]


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("S,H,Hkv,D,bs", PREFILL_CASES)
def test_prefill_kernel_matches_plain(dev, q_dtype, kv_dtype, S, H, Hkv, D, bs):
    W = -(-(S + 3 * bs) // bs)
    q, k, v, tables, qpos = _case(1, 3, S, H, Hkv, D, bs, W, [0, bs + 3, 2 * bs],
                                  dev, q_dtype, kv_dtype)
    before = fa.paged_attention_prefill.launches
    out = fa.paged_attention_prefill(q, k, v, tables, qpos)
    torch.cuda.synchronize()
    assert fa.paged_attention_prefill.launches == before + 1
    ref = fa.paged_attention_prefill_plain(q, k, v, tables, qpos)
    assert float((out.float() - ref.float()).abs().max()) <= ATOL[q_dtype]



@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("S,H,Hkv,D,bs", [(128, 32, 8, 64, 16), (37, 32, 8, 128, 8),
                                          (70, 16, 1, 64, 32), (45, 8, 2, 32, 8)])
def test_prefill_kernel_never_reads_past_the_walk(dev, q_dtype, kv_dtype, S, H, Hkv, D, bs):
    """Table entries past each row's last attended block point at a block
    of NaN: the output stays finite, bitwise equal to the kernel's on the
    same table with those entries at a finite block, and within the
    tolerance of the plain version on that table."""
    W = -(-(S + 3 * bs) // bs)
    q, k, v, tables, qpos = _case(12, 3, S, H, Hkv, D, bs, W, [0, bs + 3, 2 * bs], dev,
                                  q_dtype, kv_dtype)
    nan_block = k.shape[0]
    k = torch.cat([k, torch.full_like(k[:1], float("nan"))])
    v = torch.cat([v, torch.full_like(v[:1], float("nan"))])
    poisoned = tables.clone()
    last = (qpos.max(dim=1).values // bs).tolist()  # each row's last attended block
    for b, w in enumerate(last):
        assert w + 1 < W
        poisoned[b, w + 1:] = nan_block
    out = fa.paged_attention_prefill(q, k, v, tables, qpos)
    out_poisoned = fa.paged_attention_prefill(q, k, v, poisoned, qpos)
    torch.cuda.synchronize()
    assert torch.isfinite(out_poisoned.float()).all()
    assert torch.equal(out_poisoned, out)
    ref = fa.paged_attention_prefill_plain(q, k, v, tables, qpos)
    assert float((out_poisoned.float() - ref.float()).abs().max()) <= ATOL[q_dtype]

# The speculative verify step's shape: 8 slot rows of k+1 = 4 queries each
# at their own positions, GQA 16/8 at D=64 over 16-token blocks and an
# 11-entry table, two padded rows on the null block at positions 0-3.
VERIFY_STARTS = [0, 15, 16, 47, 100, 159, 0, 0]  # rows 6 and 7: padded slots


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
def test_prefill_kernel_at_the_verify_shape(dev, q_dtype, kv_dtype):
    """B=8, S=4, H=16, Hkv=8, D=64, bs=16, W=11: the kernel against its
    plain version, one launch; then every table entry past each row's last
    attended block on a block of NaN (a rejected draft's stale KV sits past
    the emitted prefix, masked by position only): the output unchanged."""
    S, H, Hkv, D, bs, W = 4, 16, 8, 64, 16, 11
    q, k, v, tables, qpos = _case(21, len(VERIFY_STARTS), S, H, Hkv, D, bs, W, VERIFY_STARTS,
                                  dev, q_dtype, kv_dtype)
    tables[6:] = 0  # padded rows: every entry the null block
    before = fa.paged_attention_prefill.launches
    out = fa.paged_attention_prefill(q, k, v, tables, qpos)
    torch.cuda.synchronize()
    assert fa.paged_attention_prefill.launches == before + 1
    ref = fa.paged_attention_prefill_plain(q, k, v, tables, qpos)
    assert torch.isfinite(out.float()).all()
    assert float((out.float() - ref.float()).abs().max()) <= ATOL[q_dtype]
    nan_block = k.shape[0]
    k = torch.cat([k, torch.full_like(k[:1], float("nan"))])
    v = torch.cat([v, torch.full_like(v[:1], float("nan"))])
    poisoned = tables.clone()
    for b, w in enumerate((qpos.max(dim=1).values // bs).tolist()):
        poisoned[b, w + 1:] = nan_block
    assert int((poisoned == nan_block).sum()) > 0
    out_poisoned = fa.paged_attention_prefill(q, k, v, poisoned, qpos)
    torch.cuda.synchronize()
    assert torch.equal(out_poisoned, out)


# Fused attention (kernels #4 and #5). f32: same arithmetic, another
# summation order — outputs and lse within 1e-5, gradients within 1e-5 of
# their largest magnitude (they sum over up to 1024 keys). bf16: both sides
# round p, ds and the outputs to bf16 at the same points, so a value that
# lands on either side of a rounding boundary moves by one bf16 step: held
# within 2**-6 of the largest magnitude (two steps). fp16: the same points
# in fp16, whose step is 2**-10 below 2: within 2**-9 (two steps).
FUSED_CASES = [
    # B, S, H, Hkv, D, causal, padded
    (4, 128, 12, 12, 64, False, True),   # BERT-base's attention shape, smaller batch
    (2, 256, 8, 2, 128, True, False),
    (2, 256, 8, 2, 128, True, True),
    (2, 256, 8, 2, 64, True, True),      # causal GQA with padding at D=64
    (2, 128, 8, 2, 64, True, True),      # the same at S=128 (the single-pass backward)
    (2, 512, 8, 2, 128, False, True),    # padded GQA at D=128
    (1, 384, 4, 4, 192, False, True),
    (1, 128, 4, 1, 256, True, True),
    (2, 1024, 2, 2, 64, False, True),
    # the bf16 tensor-core forward at both head dims: one pass at S=128
    # (D=64), two passes above
    (2, 128, 8, 2, 128, True, True),     # causal, padded GQA at S=128, D=128
    (2, 128, 4, 4, 128, False, False),   # no mask at all
    (1, 1024, 4, 2, 128, True, True),    # causal, padded GQA at S=1024, D=128
    (2, 1024, 4, 1, 64, True, False),    # causal GQA at S=1024, D=64
]


def _fused_case(seed, B, S, H, Hkv, D, padded, dev, dtype):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    seg = None
    if padded:
        lens = rng.integers(S // 4, S + 1, B)
        lens[0] = S
        seg = torch.from_numpy((np.arange(S)[None] < lens[:, None]).astype(np.int32)).to(dev)
    return t(B, S, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D), seg, t(B, S, H, D)


FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}


def _close(a, b, dtype):
    scale = max(1.0, float(b.detach().float().abs().max()))
    return float((a.float() - b.float()).abs().max()) <= FUSED_TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,padded", FUSED_CASES)
def test_fused_kernels_match_plain(dev, dtype, B, S, H, Hkv, D, causal, padded):
    fused = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    q, k, v, seg, do = _fused_case(2, B, S, H, Hkv, D, padded, dev, dtype)
    scale = 1.0 / np.sqrt(D)
    before = (fused.fused_attention_fwd.launches, fused.fused_attention_bwd.launches)
    out, lse = fused.fused_attention_fwd(q, k, v, seg, scale, causal)
    dq, dk, dv = fused.fused_attention_bwd(q, k, v, seg, lse, out, do, scale, causal)
    torch.cuda.synchronize()
    assert (fused.fused_attention_fwd.launches, fused.fused_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_out, ref_lse = fused.fused_attention_fwd_reference(q, k, v, seg, scale, causal)
    assert out.dtype == dtype and lse.shape == (B, H, S)
    assert _close(out, ref_out, dtype)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
    # the backward from the same saved (out, lse) on both sides
    ref = fused.fused_attention_bwd_reference(q, k, v, seg, lse, out, do, scale, causal)
    for got, want in zip((dq, dk, dv), ref):
        assert got.shape == want.shape and got.dtype == dtype
        assert _close(got, want, dtype)


@pytest.mark.parametrize("dtype,D,causal,padded,Hkv", [
    (torch.float32, 64, False, True, 4), (torch.float32, 64, True, False, 2),
    (torch.bfloat16, 64, True, True, 2), (torch.bfloat16, 128, False, True, 4),
    (torch.float16, 64, True, True, 2), (torch.float16, 128, False, True, 4)])
def test_fused_autograd_matches_plain_autograd(dev, dtype, D, causal, padded, Hkv):
    """The autograd Function (both kernels) against autograd through the
    plain forward in f32; in bf16 and fp16 (the tensor-core backward)
    against the same Function with the plain versions in the kernels'
    place, which round p and ds at the same points."""
    fused = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    q, k, v, seg, do = _fused_case(3, 2, 256, 4, Hkv, D, padded, dev, dtype)

    def run():
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fused.fused_attention(*ins, causal=causal, segment_ids=seg)
        return (out, *torch.autograd.grad(out, ins, do))

    got = run()
    if dtype == torch.float32:
        ref_ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        ref_out, _ = fused.fused_attention_fwd_reference(*ref_ins, seg, 1 / np.sqrt(D), causal)
        want = (ref_out, *torch.autograd.grad(ref_out, ref_ins, do))
    else:
        kernels = (fused.fused_attention_fwd, fused.fused_attention_bwd)
        try:
            fused.fused_attention_fwd = fused.fused_attention_fwd_reference
            fused.fused_attention_bwd = fused.fused_attention_bwd_reference
            want = run()
        finally:
            fused.fused_attention_fwd, fused.fused_attention_bwd = kernels
    for a, b in zip(got, want):
        assert a.dtype == dtype and _close(a, b, dtype)


@pytest.mark.parametrize("B,S,H,Hkv,D,causal", [
    (4, 128, 12, 12, 64, False),   # BERT-base's shape: the single-pass backward
    (2, 256, 8, 2, 128, True),     # the two tensor-core passes
    (2, 128, 8, 2, 64, True),
    (1, 384, 4, 4, 192, False),    # the CUDA-core kernels
])
def test_fused_fp16_overflow_reaches_the_gradients(dev, B, S, H, Hkv, D, causal):
    """dO scaled as a loss scale scales it (kept inside fp16's range) until
    ds = p (dp - δ) passes fp16's range: every element of dq, dk and dv is
    non-finite in the kernels exactly where it is in the plain version, so
    the loss scaler's finite check sees the overflow."""
    fused = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    q, k, v, seg, do = _fused_case(5, B, S, H, Hkv, D, True, dev, torch.float16)
    scale = 1.0 / np.sqrt(D)
    out, lse = fused.fused_attention_fwd(q, k, v, seg, scale, causal)
    overflowed = False
    for mul in (1.0, 3e4):
        dd = (do.float() * mul).clamp(-6e4, 6e4).half()
        got = fused.fused_attention_bwd(q, k, v, seg, lse, out, dd, scale, causal)
        want = fused.fused_attention_bwd_reference(q, k, v, seg, lse, out, dd, scale, causal)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b))
        if mul == 1.0:
            assert all(bool(torch.isfinite(a).all()) for a in got)
        overflowed |= not bool(torch.isfinite(got[0]).all())
    assert overflowed


# Flash attention (kernels #1-#3). Same tolerances as the fused kernels and
# for the same reasons: f32 within 1e-5 of the largest magnitude (another
# summation order); bf16 within 2**-6 of it (both sides round p and ds to
# bf16 at the same points, against the same running max — the kernel
# rescales at the lattice's kv-block boundaries as the plain version does —
# so a value on the other side of a rounding boundary moves by one step).
FLASH_CASES = [
    # B, S, H, Hkv, D, causal, window, packed, block_q, block_kv
    (2, 512, 4, 2, 64, True, None, False, 128, 128),     # causal GQA
    (2, 512, 4, 4, 64, True, 96, False, 128, 128),       # sliding window
    (2, 512, 4, 2, 64, True, None, True, 128, 128),      # packed documents
    (1, 512, 4, 2, 64, False, None, True, 64, 128),      # packed, not causal, rectangular
    (2, 256, 8, 2, 128, True, None, False, 128, 128),    # GQA at D=128
    (1, 512, 8, 1, 128, True, 200, True, 128, 256),      # everything at D=128
    (1, 256, 2, 2, 256, True, None, False, 128, 128),    # D=256
]


def _flash_case(seed, B, S, H, Hkv, D, packed, dev, dtype):
    from accelerate_tpu_torch.utils.packing import pack_sequences

    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    seg = None
    if packed:
        docs = [np.ones(n, np.int32) for n in rng.integers(S // 8, S // 2, 4 * B)]
        _, seg_np = pack_sequences(docs, S)
        seg = torch.from_numpy(seg_np[:B]).to(dev)
    return t(B, S, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D), seg, t(B, S, H, D)


def _flash_cfg(q, k, causal, window, seg, block_q, block_kv):
    return fa._FlashConfig(scale=1.0 / np.sqrt(q.shape[3]), causal=causal, window=window,
                           block_q=block_q, block_kv=block_kv, h=q.shape[2], hkv=k.shape[2],
                           use_seg=seg is not None)


def _check_flash_kernels(q, k, v, seg, do, causal, window, block_q, block_kv):
    """The three flash kernels against their plain versions on one input:
    launch counts, dtypes, shapes, finiteness and the tolerances above."""
    B, S, H, _ = q.shape
    dtype, dev = q.dtype, q.device
    cfg = _flash_cfg(q, k, causal, window, seg, block_q, block_kv)
    seg_t = seg if seg is not None else torch.zeros(B, S, dtype=torch.int32, device=dev)
    ids, counts, idsT, countsT = fa._block_lattice(seg_t, cfg)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv)
    before = [kern.launches for kern in kernels]
    out, lse = fa.flash_attention_fwd(q, k, v, seg_t, ids, counts, cfg)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_attention_dq(q, k, v, seg_t, lse, delta, do, ids, counts, cfg)
    dk, dv = fa.flash_attention_dkdv(q, k, v, seg_t, lse, delta, do, idsT, countsT, cfg)
    torch.cuda.synchronize()
    assert [kern.launches for kern in kernels] == [n + 1 for n in before]
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, seg_t, ids, counts, cfg)
    assert out.dtype == dtype and lse.shape == (B, H, S)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert _close(out, ref_out, dtype)
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
    # the backward passes from the same saved (out, lse, delta) on both sides
    ref_dq = fa.flash_attention_dq_reference(q, k, v, seg_t, lse, delta, do, ids, counts, cfg)
    ref_dk, ref_dv = fa.flash_attention_dkdv_reference(q, k, v, seg_t, lse, delta, do, idsT,
                                                       countsT, cfg)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.isfinite(got.float()).all()
        assert _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,D,causal,window,packed,block_q,block_kv", FLASH_CASES)
def test_flash_kernels_match_plain(dev, dtype, B, S, H, Hkv, D, causal, window, packed, block_q,
                                   block_kv):
    q, k, v, seg, do = _flash_case(4, B, S, H, Hkv, D, packed, dev, dtype)
    _check_flash_kernels(q, k, v, seg, do, causal, window, block_q, block_kv)


# The bf16 kernels at D = 64 and 128 run on tensor cores with a block of
# 128 rows (64 when the lattice block is not a multiple of 128) and kv
# sub-tiles of up to 128 keys (block_kv = 256: a max pass, then a P V
# pass): every block pair they take, both head dims.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block_q", [64, 256])
@pytest.mark.parametrize("block_kv", [64, 128, 256])
def test_flash_kernels_block_shapes(dev, dtype, D, block_q, block_kv):
    q, k, v, seg, do = _flash_case(7, 1, 512, 4, 2, D, False, dev, dtype)
    _check_flash_kernels(q, k, v, seg, do, True, None, block_q, block_kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_window_masks_a_whole_first_block(dev, dtype, D):
    """Window 40 with 64-key blocks: q block 1 (rows 128-255) walks kv
    blocks 1-3, and rows 167-255 (keys r-39 .. r) attend nothing of kv
    block 1, its first: their running max stays -inf through it (the shift
    clamp)."""
    q, k, v, seg, do = _flash_case(8, 1, 512, 4, 2, D, False, dev, dtype)
    cfg = _flash_cfg(q, k, True, 40, None, 128, 64)
    ids, counts, _, _ = fa._block_lattice(torch.zeros(1, 512, dtype=torch.int32, device=dev), cfg)
    assert int(ids[0, 1, 0]) == 1 and int(counts[0, 1]) == 3
    _check_flash_kernels(q, k, v, seg, do, True, 40, 128, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,block_q,block_kv", [(64, 128, 128), (128, 64, 256)])
def test_flash_kernels_packed_rows_with_padding(dev, dtype, D, block_q, block_kv):
    """Packed documents followed by padding (segment 0), which attends
    only padding."""
    q, k, v, _, do = _flash_case(9, 2, 512, 4, 2, D, False, dev, dtype)
    seg = np.zeros((2, 512), np.int32)
    seg[0, :100], seg[0, 100:250], seg[0, 250:340] = 1, 2, 3
    seg[1, :300] = 1
    _check_flash_kernels(q, k, v, torch.from_numpy(seg).to(dev), do, True, None, block_q,
                         block_kv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_long_sequence(dev, dtype):
    """S = 8192, the long-context training length, at B=1 and one kv head
    shared by two q heads."""
    q, k, v, seg, do = _flash_case(10, 1, 8192, 2, 1, 64, False, dev, dtype)
    _check_flash_kernels(q, k, v, seg, do, True, None, 128, 128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_at_the_lm774m_shape(dev, dtype):
    """``bench.py`` config #4's attention: B=8, S=512, 20 q heads over 20
    kv heads (GQA group 1), D=64, causal."""
    q, k, v, seg, do = _flash_case(11, 8, 512, 20, 20, 64, False, dev, dtype)
    _check_flash_kernels(q, k, v, seg, do, True, None, 128, 128)


@pytest.mark.parametrize("remat", [True, "dots", "dots_no_batch", "offload_dots"])
def test_remat_through_the_flash_kernels(dev, remat):
    """``llama_loss`` under remat through the kernels, f32, 2 layers: the
    forward kernel runs twice a layer (the recompute), dq and dk/dv once,
    and the gradients equal no remat's within 1e-6 of each leaf's largest
    (the recompute repeats the same kernels on the same inputs; only the
    embedding's backward adds repeated rows in a nondeterministic order)."""
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import param_leaves

    config = tt.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                            max_seq_len=256, attn_impl="flash")
    ids = torch.from_numpy(np.random.default_rng(12).integers(0, 512, (2, 256))).to(dev)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv)

    def grads(r):
        params = tt.init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev)
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = [kern.launches for kern in kernels]
        tt.llama_loss(params, {"input_ids": ids}, config, remat=r).backward()
        torch.cuda.synchronize()
        return [t.grad for t in leaves], [kern.launches - b for kern, b in zip(kernels, before)]

    base, base_launches = grads(False)
    got, launches = grads(remat)
    L = config.n_layers
    assert base_launches == [L, L, L] and launches == [2 * L, L, L]
    for a, b in zip(got, base):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kernel", ["flash_dq", "flash_dkdv", "fused_bwd"])
def test_backward_kernels_are_deterministic(dev, kernel, D):
    """Each output row of the bf16 backward passes (flash dq, flash dk/dv,
    the fused backward's two) is summed by one block in a fixed order, with
    no atomics: two launches on the same inputs agree bitwise."""
    fused = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    q, k, v, seg, do = _flash_case(11, 2, 1024, 8, 2, D, True, dev, torch.bfloat16)
    if kernel == "fused_bwd":
        out, lse = fused.fused_attention_fwd(q, k, v, seg, 1 / np.sqrt(D), True)

        def launch():
            return fused.fused_attention_bwd(q, k, v, seg, lse, out, do, 1 / np.sqrt(D), True)
    else:
        cfg = _flash_cfg(q, k, True, None, seg, 128, 128)
        ids, counts, idsT, countsT = fa._block_lattice(seg, cfg)
        out, lse = fa.flash_attention_fwd(q, k, v, seg, ids, counts, cfg)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()

        def launch():
            if kernel == "flash_dq":
                return (fa.flash_attention_dq(q, k, v, seg, lse, delta, do, ids, counts, cfg),)
            return fa.flash_attention_dkdv(q, k, v, seg, lse, delta, do, idsT, countsT, cfg)
    first, second = launch(), launch()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("causal,window,packed,Hkv,D", [(True, None, True, 2, 64),
                                                        (True, 128, False, 1, 128)])
def test_flash_autograd_matches_plain_autograd(dev, causal, window, packed, Hkv, D):
    """``flash_attention`` (the three kernels) against the same autograd
    Function with the plain versions in their place, f32."""
    q, k, v, seg, do = _flash_case(5, 2, 512, 4, Hkv, D, packed, dev, torch.float32)

    def run():
        ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*ins, causal=causal, window=window, segment_ids=seg)
        return (out, *torch.autograd.grad(out, ins, do))

    got = run()
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv)
    try:
        fa.flash_attention_fwd = fa.flash_attention_fwd_reference
        fa.flash_attention_dq = fa.flash_attention_dq_reference
        fa.flash_attention_dkdv = fa.flash_attention_dkdv_reference
        want = run()
    finally:
        fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv = kernels
    for a, b in zip(got, want):
        assert _close(a, b, torch.float32)


def test_flash_kernels_skip_poisoned_blocks(dev):
    """A K/V block that the window's lattice skips is never read: NaN in it
    leaves every row that does not attend it bitwise unchanged, forward and
    dq."""
    q, k, v, _, do = _flash_case(6, 1, 512, 4, 2, 64, False, dev, torch.bfloat16)
    kbad, vbad = k.clone(), v.clone()
    kbad[:, :128] = float("nan")
    vbad[:, :128] = float("nan")

    def run(kk, vv):
        ins = [x.clone().requires_grad_(True) for x in (q, kk, vv)]
        out = fa.flash_attention(*ins, causal=True, window=64)
        return out, torch.autograd.grad(out[:, 256:], ins[0], do[:, 256:])[0]

    (out, dq), (out_bad, dq_bad) = run(k, v), run(kbad, vbad)
    # rows >= 256 sit in q blocks 2, 3, whose window reaches kv blocks 1..3 only
    assert torch.equal(out[:, 256:], out_bad[:, 256:])
    assert torch.isfinite(out_bad[:, 256:].float()).all()
    assert torch.equal(dq[:, 256:], dq_bad[:, 256:])


def _small_llama(dev, **kw):
    from accelerate_tpu_torch.models import transformer as tt

    config = tt.LlamaConfig(vocab_size=1024, dim=256, n_layers=4, n_heads=4, n_kv_heads=2,
                            max_seq_len=256, **kw)
    return config, tt.init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                                 dtype=torch.bfloat16)


def test_offloaded_greedy_equals_resident_bitwise(dev, tmp_path):
    """bf16, 4 layers: ``generate_dispatched`` over ``cpu_offload`` (host
    leaves pinned, each layer copied on the side stream while the previous
    one computes) and over ``disk_offload`` gives ``greedy_generate``'s
    tokens bit for bit: the same ops in the same order on the same values."""
    from accelerate_tpu_torch import (cpu_offload, disk_offload, generate_dispatched,
                                      greedy_generate, unstack_layer_params)

    config, params = _small_llama(dev)
    prompt = np.random.default_rng(13).integers(0, config.vocab_size, (4, 24)).astype(np.int32)
    want = greedy_generate(params, prompt, config, max_new_tokens=12)
    stages = unstack_layer_params(params, config)
    dp = cpu_offload(stages)
    assert dp.execution_device.type == "cuda" and all(t.is_pinned() for t in dp._host.values())
    np.testing.assert_array_equal(generate_dispatched(dp, prompt, config, max_new_tokens=12), want)
    assert dp._paged_cache.keys() <= {"embed_tokens/embedding", "final_norm/scale",
                                      "lm_head/kernel"}
    dp = disk_offload(stages, str(tmp_path))
    np.testing.assert_array_equal(generate_dispatched(dp, prompt, config, max_new_tokens=12), want)


def test_offload_dots_saves_to_pinned_host_memory(dev, monkeypatch):
    """f32, flash attention, 4 layers: between the forward and the backward
    every saved projection of ``remat="offload_dots"`` sits in pinned host
    memory (its device of origin recorded as the card); the flash forward
    runs twice a layer, dq and dk/dv once; the gradients equal
    ``"dots_no_batch"``'s within 1e-6 of each leaf's largest (as in
    ``test_remat_through_the_flash_kernels``)."""
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import param_leaves

    config, _ = _small_llama(dev, attn_impl="flash")
    ids = torch.from_numpy(np.random.default_rng(14).integers(0, 1024, (2, 256))).to(dev)
    stores = []
    real_init = tt._HostSaveMode.__init__

    def spy(self, saved, store):
        stores.append(store)
        real_init(self, saved, store)

    monkeypatch.setattr(tt._HostSaveMode, "__init__", spy)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkdv)

    def grads(remat):
        params = tt.init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev)
        leaves = param_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = [kern.launches for kern in kernels]
        loss = tt.llama_loss(params, {"input_ids": ids}, config, remat=remat)
        if remat == "offload_dots":
            held = [(host, d) for store in stores for entries in store.values()
                    for host, d in entries]
            assert len(stores) == config.n_layers and len(held) == 7 * config.n_layers
            assert all(host.device.type == "cpu" and host.is_pinned() and d.type == "cuda"
                       for host, d in held)
        loss.backward()
        torch.cuda.synchronize()
        return [t.grad for t in leaves], [kern.launches - b for kern, b in zip(kernels, before)]

    base, _ = grads("dots_no_batch")
    got, launches = grads("offload_dots")
    L = config.n_layers
    assert launches == [2 * L, L, L]
    for a, b in zip(got, base):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def _ckpt_acc(tmp_path):
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    return Accelerator(device="cuda", project_dir=str(tmp_path))


def test_async_snapshot_owns_its_bytes(dev, tmp_path):
    """``save_state(blocking=False)`` returns after the copies to pinned
    host memory have finished: work queued on the card right after it (a
    long chain of in-place updates of every param) does not reach the
    committed file, which holds the values at the call."""
    acc = _ckpt_acc(tmp_path)
    g = torch.Generator(device=dev).manual_seed(0)
    params = acc.prepare({"w": torch.randn(4096, 1024, device=dev, generator=g),
                          "b": torch.randn(1024, device=dev, generator=g).bfloat16()})
    want = {k: v.detach().cpu().clone() for k, v in params.items()}
    out = acc.save_state(str(tmp_path / "ck"), blocking=False)
    with torch.no_grad():
        for _ in range(50):
            for v in params.values():
                v.mul_(1.5).add_(1.0)
    acc.wait_for_checkpoint()
    with np.load(f"{out}/model.npz") as f:
        assert np.array_equal(f["w"], want["w"].numpy())
        assert f["b"].dtype == np.dtype("V2")
        assert f["b"].tobytes() == want["b"].view(torch.int16).numpy().tobytes()
    assert not torch.equal(params["w"].cpu(), want["w"])
    acc.end_training()


@pytest.mark.parametrize("sharded", [False, True], ids=["npz", "sharded"])
def test_bf16_params_round_trip(dev, tmp_path, sharded):
    """bf16 params on the card saved (``|V2`` bits in ``model.npz``, or f32
    chunks of a ``bfloat16`` leaf in the shard set) and loaded into other
    params in place: bitwise, still bf16, still on the card."""
    acc = _ckpt_acc(tmp_path)
    g = torch.Generator(device=dev).manual_seed(1)
    params = acc.prepare({"w": torch.randn(64, 32, device=dev, generator=g).bfloat16()})
    want = params["w"].detach().clone()
    out = acc.save_state(str(tmp_path / "ck"), sharded=sharded)
    with torch.no_grad():
        params["w"].zero_()
    acc.load_state(out)
    assert params["w"].dtype == torch.bfloat16 and params["w"].is_cuda
    assert torch.equal(params["w"], want)


@pytest.mark.parametrize("shape", [(256, 128, 192), (200, 72, 40)], ids=["aligned", "padded"])
def test_scaled_mm_route_matches_the_plain_fp8_product(dev, shape):
    """The three products of ``fp8_dot`` on the card: forward, dx and dw
    through ``scaled_mm`` (``_scaled_mm``, counted) against the plain
    version on the same fp8 tensors. Both add the exact fp8 products in f32,
    in another order (the fp8 tensor cores keep a narrower partial sum
    between promotions): measured within 2.2e-4 of the largest output on
    an H100 at config #4's shapes (``chip_smoke.py``'s ``_fp8_products``).
    The autograd function rounds out, dx and dw to bf16, so they are held
    to one bf16 step of the largest output, 2**-7 of it; its meta
    gradients bitwise."""
    from accelerate_tpu_torch.ops import fp8

    M, K, N = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    g = (torch.randn(M, N, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
    hist = {k: torch.full((16,), v, device=dev) for k, v in
            (("x_hist", float(x.abs().max())), ("w_hist", float(w.abs().max())),
             ("g_hist", float(g.abs().max())))}

    def run(device):
        tx = x.to(device, copy=True).requires_grad_(True)
        tw = w.to(device, copy=True).requires_grad_(True)
        tm = {k: v.to(device, copy=True).requires_grad_(True) for k, v in hist.items()}
        out = fp8.fp8_dot(tx, tw, tm)
        out.backward(g.to(device))
        return [t.detach().float().cpu() for t in (out, tx.grad, tw.grad)], {
            k: v.grad.cpu() for k, v in tm.items()}

    before = fp8.scaled_mm.launches
    (out, dx, dw), meta = run(dev)
    assert fp8.scaled_mm.launches - before == 3
    (pout, pdx, pdw), pmeta = run("cpu")
    for got, want in ((out, pout), (dx, pdx), (dw, pdw)):
        assert float((got - want).abs().max()) <= 2.0 ** -7 * float(want.abs().max())
    for k in meta:
        assert torch.equal(meta[k], pmeta[k])


def test_int_mm_route_matches_the_plain_int32_product_bitwise(dev):
    """``int8_dynamic_matmul``'s int32 block partials through ``_int_mm``
    (rows not a multiple of 16, padded) equal the plain int32 product of
    the same int8 values, computed on the CPU, bit for bit."""
    from accelerate_tpu_torch.ops import quantization as q

    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(40, 256, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn(256, 96, generator=gen, device=dev) / 16).to(torch.bfloat16)
    wq = q.quantize_int8_matmul_weight(w, block_size=128)
    before = q.int_mm.launches
    partials, x_scale = q.int8_block_partials(x, wq)
    assert q.int_mm.launches - before == 2
    xb, _ = q.quantize_rows(x, wq)
    plain = torch.stack([q.int_mm(xb[:, b].cpu(), wq.codes[b].cpu()) for b in range(2)])
    assert torch.equal(partials.cpu(), plain)
    out = q.int8_dynamic_matmul(x, wq, preferred_dtype=torch.float32)
    cpu_wq = wq.to("cpu")
    assert torch.allclose(out.cpu(), q.int8_dynamic_matmul(x.cpu(), cpu_wq,
                                                           preferred_dtype=torch.float32),
                          rtol=1e-6, atol=1e-6)
