"""Paged attention for the serving engine: the port of the paged part of
``accelerate_tpu.ops.flash_attention``.

Two kernels, each a thin wrapper over a hand-written Hopper CUDA kernel
(``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``) with its plain
PyTorch version beside it:

- :func:`paged_attention_decode` — S=1 queries, ragged per-row ``kv_lens``;
- :func:`paged_attention_prefill` — S>1 chunks, per-query ``q_positions``.

The rule for both wrappers: tensors on the CPU go to the plain version;
tensors on a CUDA device launch the kernel or raise — there is no switch
and no fallback. Each wrapper counts its kernel launches in a plain integer
attribute (``paged_attention_decode.launches``), so a run can show that its
path went through the kernel.

The plain versions compute what the TPU kernels compute: f32 scores,
softmax and value product over the gathered blocks, masked by position,
cast to ``q.dtype`` at the end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..generation import _masked_attention
from ..serving.kv_pager import gather_blocks
from . import _build

__all__ = [
    "paged_attention",
    "paged_attention_decode",
    "paged_attention_decode_plain",
    "paged_attention_prefill",
    "paged_attention_prefill_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the kernels are instantiated for
_SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16)}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUPS = 16  # query heads per kv head the decode block holds


def _plain(q, k_pool, v_pool, block_tables, q_positions, scale):
    k = gather_blocks(k_pool, block_tables).float()
    v = gather_blocks(v_pool, block_tables).float()
    kv_pos = torch.arange(k.shape[1], device=q.device)
    allow = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, S, T]
    return _masked_attention(q.float(), k, v, allow[:, None], scale).to(q.dtype)


def paged_attention_decode_plain(q, k_pool, v_pool, block_tables, kv_lens, scale=None):
    """Plain version of the decode kernel: q ``[B, 1, H, D]``, key position
    ``t`` of row ``b`` attended iff ``t < kv_lens[b]``."""
    return _plain(q, k_pool, v_pool, block_tables, (kv_lens.long() - 1)[:, None], scale)


def paged_attention_prefill_plain(q, k_pool, v_pool, block_tables, q_positions, scale=None):
    """Plain version of the prefill kernel: query ``i`` of row ``b`` attends
    key position ``t`` iff ``t <= q_positions[b, i]``."""
    return _plain(q, k_pool, v_pool, block_tables, q_positions.long(), scale)


def _check_launch(q, k_pool, v_pool, block_tables, index):
    """Validate what the kernels take; raise on anything else."""
    if (q.dtype, k_pool.dtype) not in _SUPPORTED or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"paged kernels take (q, pool) dtypes {sorted((str(a), str(b)) for a, b in _SUPPORTED)}; "
            f"got q {q.dtype}, k {k_pool.dtype}, v {v_pool.dtype}"
        )
    tensors = (q, k_pool, v_pool, block_tables, index)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged kernels need every tensor on one device")
    if block_tables.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("block tables and lengths/positions must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous [num_blocks, block_size, Hkv, D]")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must share one [N, bs, Hkv, D] shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    B, S, H, D = q.shape
    Hkv = k_pool.shape[2]
    if D not in _HEAD_DIMS or k_pool.shape[3] != D:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS} and match the pool, got {D}")
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if block_tables.shape[0] != B:
        raise ValueError("block_tables must have one row per batch row")


def _launch_error(lib, err: int, name: str) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: {lib.kernel_error_string(err).decode()} ({err})")


def paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, scale=None):
    """q ``[B, 1, H, D]`` against one layer's pools ``[num_blocks,
    block_size, Hkv, D]`` through ``block_tables [B, W]`` (int32), with live
    lengths ``kv_lens [B]`` (int32). Returns ``[B, 1, H, D]`` in
    ``q.dtype``."""
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError(f"decode kernel wants S=1 queries, got S={S}")
    if not q.is_cuda:
        return paged_attention_decode_plain(q, k_pool, v_pool, block_tables, kv_lens, scale)
    _check_launch(q, k_pool, v_pool, block_tables, kv_lens)
    if H // k_pool.shape[2] > _MAX_GROUPS:
        raise ValueError(f"decode kernel holds at most {_MAX_GROUPS} q heads per kv head")
    lib = _build.load("paged_decode")
    q = q.contiguous()
    tables = block_tables.contiguous()
    lens = kv_lens.contiguous()
    out = torch.empty_like(q)
    sm_scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, H, k_pool.shape[2], D, k_pool.shape[1], tables.shape[1],
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "paged_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0


def paged_attention_prefill(q, k_pool, v_pool, block_tables, q_positions, scale=None):
    """q ``[B, S, H, D]`` (S > 1) against one layer's pools through
    ``block_tables [B, W]`` (int32), with per-query absolute positions
    ``q_positions [B, S]`` (int32). The chunk's own KV is already in the
    pool. Returns ``[B, S, H, D]`` in ``q.dtype``."""
    B, S, H, D = q.shape
    if S < 2:
        raise ValueError(f"prefill kernel wants S>1 queries, got S={S}")
    if not q.is_cuda:
        return paged_attention_prefill_plain(q, k_pool, v_pool, block_tables, q_positions, scale)
    _check_launch(q, k_pool, v_pool, block_tables, q_positions)
    lib = _build.load("paged_prefill")
    q = q.contiguous()
    tables = block_tables.contiguous()
    qpos = q_positions.contiguous()
    out = torch.empty_like(q)
    sm_scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    err = lib.paged_prefill_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), B, S, H, k_pool.shape[2], D, k_pool.shape[1], tables.shape[1],
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "paged_prefill")
    paged_attention_prefill.launches += 1
    return out


paged_attention_prefill.launches = 0


def paged_attention(q, k_pool, v_pool, block_tables, q_positions,
                    scale: Optional[float] = None):
    """The engine's dispatch point: S == 1 goes to the decode kernel with
    ``kv_lens = q_positions[:, 0] + 1``, S > 1 to the prefill kernel."""
    if q.shape[1] == 1:
        kv_lens = (q_positions[:, 0] + 1).to(torch.int32)
        return paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, scale)
    return paged_attention_prefill(q, k_pool, v_pool, block_tables,
                                   q_positions.to(torch.int32), scale)
