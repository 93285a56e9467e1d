"""The CUDA paged-attention kernels against their plain PyTorch versions,
on the card (marker ``cuda``; skipped where no GPU is present).

This file imports no JAX, so on a machine with a GPU and no JAX it runs
alone: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cuda_kernels.py``.

Tolerances: f32 at atol 1e-5 (same f32 arithmetic, another summation
order); bf16 outputs at atol 2**-7, one bf16 rounding step of outputs
below 2 in magnitude (both sides accumulate in f32 and round once).
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.ops import flash_attention as fa

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


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("H,Hkv,D,bs", [(32, 8, 64, 16), (8, 8, 32, 8), (16, 8, 128, 32),
                                        (16, 1, 64, 64), (8, 4, 64, 5)])
def test_decode_kernel_matches_plain(dev, q_dtype, kv_dtype, H, Hkv, D, bs):
    q, k, v, tables, qpos = _case(0, 5, 1, H, Hkv, D, bs, 6, [0, 7, 3 * bs - 1, 6 * bs - 1, 2],
                                  dev, q_dtype, kv_dtype)
    tables[4] = 0  # an inactive slot on the null block
    lens = (qpos[:, 0] + 1).to(torch.int32)
    before = fa.paged_attention_decode.launches
    out = fa.paged_attention_decode(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert fa.paged_attention_decode.launches == before + 1
    ref = fa.paged_attention_decode_plain(q, k, v, tables, lens)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert float((out.float() - ref.float()).abs().max()) <= ATOL[q_dtype]


@pytest.mark.parametrize("q_dtype,kv_dtype", DTYPES)
@pytest.mark.parametrize("S,H,Hkv,D,bs", [(128, 32, 8, 64, 16), (37, 8, 2, 32, 8),
                                          (2, 4, 4, 128, 16), (70, 16, 1, 64, 64)])
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
