"""The port's paged attention against the JAX package's.

The port's wrappers (``accelerate_tpu_torch.ops.flash_attention``) take
their plain PyTorch versions for CPU tensors; these tests hold those plain
versions — the arithmetic the CUDA kernels implement — against the JAX
Pallas kernels run in interpret mode and against the JAX gather reference,
on the same numpy inputs: scrambled block tables, ragged lengths, GQA
ratios 1/2/4, null-block rows and tables aliased up to a copy-on-write
divergence point.

Tolerances: f32 at atol 1e-5 — both sides compute in f32 and differ only in
summation order (observed ~1e-7). bf16 pools and queries: both sides
accumulate in f32 and round the output to bf16 once, so they may differ by
one bf16 rounding step of the output: atol 2**-7 covers one ulp for
|out| < 2, and the outputs here are averages of N(0, 1) values.
"""

import importlib
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops.flash_attention import paged_attention_decode as jax_decode
from accelerate_tpu.ops.flash_attention import paged_attention_prefill as jax_prefill
from accelerate_tpu.serving.kv_pager import paged_attention as jax_gather
fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
from accelerate_tpu_torch.serving.kv_pager import NULL_BLOCK, paged_attention as torch_gather

F32_ATOL = 1e-5
BF16_ATOL = 2.0 ** -7


def _tables(rng, nb, bs, W, lens):
    """Distinct non-null physical blocks in scrambled order, null-padded."""
    perm = rng.permutation(np.arange(1, nb))
    tables = np.full((len(lens), W), NULL_BLOCK, np.int32)
    used = 0
    for b, n in enumerate(lens):
        need = -(-int(n) // bs)
        tables[b, :need] = perm[used : used + need]
        used += need
    return tables


def _pools(rng, nb, bs, Hkv, D):
    k = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    return k, v


def _decode_case(seed, *, B, H, Hkv, D, bs, nb, W, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k, v = _pools(rng, nb, bs, Hkv, D)
    return q, k, v, _tables(rng, nb, bs, W, lens), np.asarray(lens, np.int32)


def _prefill_case(seed, *, B, S, H, Hkv, D, bs, nb, W, starts):
    """Each row's chunk of S queries starts at its own absolute position
    (KV before it is already landed in the pool)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = _pools(rng, nb, bs, Hkv, D)
    qpos = (np.asarray(starts, np.int32)[:, None] + np.arange(S, dtype=np.int32)[None]).astype(np.int32)
    tables = _tables(rng, nb, bs, W, [s + S for s in starts])
    return q, k, v, tables, qpos


def _t(x, dtype=torch.float32):
    t = torch.from_numpy(np.asarray(x))
    return t.to(dtype) if t.is_floating_point() else t


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype) if np.asarray(x).dtype.kind == "f" else jnp.asarray(x)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _port_decode(q, k, v, tables, lens, dtype=torch.float32):
    out = fa.paged_attention_decode(_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(tables), _t(lens))
    return out.float().numpy()


def _port_prefill(q, k, v, tables, qpos, dtype=torch.float32):
    out = fa.paged_attention_prefill(_t(q, dtype), _t(k, dtype), _t(v, dtype), _t(tables), _t(qpos))
    return out.float().numpy()


def _assert_decode_parity(q, k, v, tables, lens):
    ours = _port_decode(q, k, v, tables, lens)
    kern = jax_decode(_j(q), _j(k), _j(v), _j(tables), _j(lens), interpret=True)
    gather = jax_gather(_j(q), _j(k), _j(v), _j(tables), _j(lens - 1)[:, None])
    assert _err(ours, kern) <= F32_ATOL
    assert _err(ours, gather) <= F32_ATOL


def _assert_prefill_parity(q, k, v, tables, qpos):
    ours = _port_prefill(q, k, v, tables, qpos)
    kern = jax_prefill(_j(q), _j(k), _j(v), _j(tables), _j(qpos), interpret=True)
    gather = jax_gather(_j(q), _j(k), _j(v), _j(tables), _j(qpos))
    assert _err(ours, kern) <= F32_ATOL
    assert _err(ours, gather) <= F32_ATOL


def test_decode_scrambled_tables_ragged_lengths():
    _assert_decode_parity(*_decode_case(
        0, B=4, H=8, Hkv=2, D=32, bs=8, nb=24, W=5, lens=[37, 10, 40, 1]))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_decode_gqa_ratios(groups):
    _assert_decode_parity(*_decode_case(
        1, B=2, H=2 * groups, Hkv=2, D=16, bs=4, nb=16, W=4, lens=[13, 7]))


def test_decode_null_block_rows():
    """Inactive slots: every entry the null block, length 1."""
    q, k, v, tables, lens = _decode_case(2, B=3, H=4, Hkv=2, D=16, bs=4, nb=10, W=3,
                                         lens=[9, 1, 1])
    tables[1:] = NULL_BLOCK
    _assert_decode_parity(q, k, v, tables, lens)


def test_decode_cow_divergence_point():
    """Two rows share every block up to a copy-on-write point and diverge
    in their private last block."""
    q, k, v, tables, lens = _decode_case(3, B=2, H=4, Hkv=2, D=16, bs=4, nb=12, W=4,
                                         lens=[14, 14])
    tables[1, :3] = tables[0, :3]
    _assert_decode_parity(q, k, v, tables, lens)


# Lengths on the edges of every keys-per-split C the card kernel can take
# (1, C-1, C, C+1) and the whole 32-entry table.
SPLIT_EDGE_LENS = sorted({1, 32 * 8,
                          *(n for c in fa._DECODE_SPLIT_KEYS for n in (c - 1, c, c + 1))})


@pytest.mark.parametrize("kv_len", SPLIT_EDGE_LENS)
def test_decode_one_request_at_split_edges(kv_len):
    """B=1 against a W=32 table (bs=8, 256 keys): where the card kernel
    splits a row's keys, the plain version still matches the JAX kernel."""
    _assert_decode_parity(*_decode_case(
        12, B=1, H=8, Hkv=2, D=16, bs=8, nb=40, W=32, lens=[kv_len]))


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_prefill_gqa_ratios_with_landed_kv(groups):
    _assert_prefill_parity(*_prefill_case(
        4, B=2, S=6, H=2 * groups, Hkv=2, D=16, bs=4, nb=20, W=6, starts=[0, 9]))


def test_prefill_chunk_past_table_and_cow_alias():
    """Row 1's padded tail runs past its table (null entries) and it shares
    row 0's leading blocks."""
    q, k, v, tables, qpos = _prefill_case(5, B=2, S=8, H=4, Hkv=2, D=32, bs=4, nb=24, W=5,
                                          starts=[4, 8])
    tables[1, :2] = tables[0, :2]
    tables[1, 4:] = NULL_BLOCK
    _assert_prefill_parity(q, k, v, tables, qpos)


def test_bf16_envelope():
    """bf16 queries and pools: the port's plain versions against the JAX
    kernels fed the same bf16 values."""
    q, k, v, tables, lens = _decode_case(6, B=4, H=8, Hkv=2, D=32, bs=8, nb=24, W=5,
                                         lens=[37, 10, 40, 3])
    ours = _port_decode(q, k, v, tables, lens, torch.bfloat16)
    kern = jax_decode(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                      _j(tables), _j(lens), interpret=True)
    assert _err(ours, kern) <= BF16_ATOL
    q, k, v, tables, qpos = _prefill_case(7, B=2, S=8, H=8, Hkv=2, D=32, bs=8, nb=24, W=5,
                                          starts=[3, 16])
    ours = _port_prefill(q, k, v, tables, qpos, torch.bfloat16)
    kern = jax_prefill(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
                       _j(tables), _j(qpos), interpret=True)
    assert _err(ours, kern) <= BF16_ATOL


def test_gather_reference_matches_jax():
    q, k, v, tables, qpos = _prefill_case(8, B=2, S=5, H=4, Hkv=2, D=16, bs=4, nb=16, W=5,
                                          starts=[2, 7])
    ours = torch_gather(_t(q), _t(k), _t(v), _t(tables), _t(qpos).long()).numpy()
    ref = jax_gather(_j(q), _j(k), _j(v), _j(tables), _j(qpos))
    assert _err(ours, ref) <= F32_ATOL


def test_dispatch_splits_decode_and_prefill():
    """S == 1 → decode with kv_lens = q_positions[:, 0] + 1; S > 1 →
    prefill; CPU tensors never touch a kernel or its launch counter."""
    before = (fa.paged_attention_decode.launches, fa.paged_attention_prefill.launches)
    q, k, v, tables, lens = _decode_case(9, B=2, H=4, Hkv=2, D=16, bs=4, nb=12, W=4,
                                         lens=[11, 5])
    out = fa.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(lens - 1)[:, None])
    assert _err(out.numpy(), _port_decode(q, k, v, tables, lens)) == 0.0
    q, k, v, tables, qpos = _prefill_case(10, B=1, S=4, H=4, Hkv=2, D=16, bs=4, nb=12, W=4,
                                          starts=[5])
    out = fa.paged_attention(_t(q), _t(k), _t(v), _t(tables), _t(qpos))
    assert _err(out.numpy(), _port_prefill(q, k, v, tables, qpos)) == 0.0
    after = (fa.paged_attention_decode.launches, fa.paged_attention_prefill.launches)
    assert after == before


def test_wrappers_reject_wrong_query_length():
    q, k, v, tables, lens = _decode_case(11, B=1, H=4, Hkv=2, D=16, bs=4, nb=8, W=2, lens=[5])
    with pytest.raises(ValueError, match="S=1"):
        fa.paged_attention_decode(_t(np.repeat(q, 2, axis=1)), _t(k), _t(v), _t(tables),
                                  _t(lens))
    with pytest.raises(ValueError, match="S>1"):
        fa.paged_attention_prefill(_t(q), _t(k), _t(v), _t(tables), _t(lens)[:, None])
