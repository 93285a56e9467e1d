"""Fused short-sequence attention: the port of ``accelerate_tpu.ops.fused_attention``.

One ``torch.autograd.Function`` over two hand-written Hopper CUDA kernels,
each a thin wrapper with its plain PyTorch version beside it:

- :func:`fused_attention_fwd` (``csrc/fused_attention_fwd.cu``) — ``O =
  softmax(mask(scale·QKᵀ)) V`` and the row logsumexp, the port of the TPU
  ``_fwd_kernel``;
- :func:`fused_attention_bwd` (``csrc/fused_attention_bwd.cu``) — dq, dk,
  dv recomputed from the saved logsumexp, the port of ``_bwd_kernel``; the
  GQA fold of dk/dv over the q heads of a group happens inside the kernel,
  in f32.

Both kernels take f32, bf16 and fp16 (the dtypes the TPU kernels take on
the training paths); the bf16 and fp16 variants at head dims 64 and 128
run their products on Hopper's tensor cores.

Public layout is BSHD (``q [B, S, H, D]``, ``k/v [B, S, Hkv, D]``), as in
the JAX package; the kernels read it through strides, so no transpose is
made. The rule for both wrappers: tensors on the CPU go to the plain
version; tensors on a CUDA device launch the kernel or raise. Each wrapper
counts its launches in ``.launches`` (one per call; a backward call that
issues two passes counts as one launch of its kernel).

The plain versions repeat the TPU kernels op by op, including where they
round to the input dtype: scores in f32, masked with ``NEG_INF``; ``p``
rounded to the value dtype before ``PV``; the division by ``l`` after
``PV`` in f32; in the backward ``δ = Σ dO·O`` from the stored output, and
``p`` and ``ds`` rounded to the input dtype before their products.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .flash_attention import _launch_error

__all__ = [
    "NEG_INF",
    "fused_attention",
    "fused_attention_bwd",
    "fused_attention_bwd_reference",
    "fused_attention_fwd",
    "fused_attention_fwd_reference",
    "fused_supported",
]

NEG_INF = -1e30  # the TPU kernel's mask value (not finfo.min: see _xla_attention)
# the dtypes the fused kernels are built for (codes of csrc/paged_common.cuh);
# fp16 is theirs alone: the flash and paged kernels keep refusing it
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_S, _MAX_D = 1024, 256


def fused_supported(q, k) -> bool:
    """Shapes the kernels take, the JAX package's envelope: Sq == Skv, S a
    multiple of 128 up to 1024, D a multiple of 64 up to 256, q heads
    divisible by kv heads. (The TPU's VMEM budget for one batch row's
    score block is not carried over: the Hopper kernels stream 64-row
    tiles, so every S in the envelope fits.)"""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Sq != Skv or Sq % 128 != 0 or Sq > _MAX_S:
        return False
    if D % 64 != 0 or D > _MAX_D:
        return False
    return H % Hkv == 0


def _heads(q, k, v):
    """BSHD → [B, H, S, D] f32 views, k/v broadcast to every q head."""
    rep = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    vh = v.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    return qh, kh, vh


def _masked_scores(qh, kh, seg, scale, causal):
    """[B, H, S, S] f32 scores, ``NEG_INF`` where masked (``_masked_scores``)."""
    s = (qh @ kh.transpose(-1, -2)) * scale
    S = s.shape[-1]
    if seg is not None:
        s = torch.where((seg[:, :, None] == seg[:, None, :])[:, None], s, NEG_INF)
    if causal:
        rows = torch.arange(S, device=s.device)
        s = torch.where(rows[:, None] >= rows[None, :], s, NEG_INF)
    return s


def fused_attention_fwd_reference(q, k, v, seg, scale, causal):
    """Plain version of kernel #4: ``(out [B, S, H, D] in q.dtype, lse [B,
    H, S] f32)``; ``seg`` is ``[B, S]`` int or ``None``."""
    qh, kh, vh = _heads(q, k, v)
    s = _masked_scores(qh, kh, seg, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)  # noqa: E741 - the TPU kernel's name
    o = (p.to(v.dtype).float() @ vh) / l
    return o.to(q.dtype).transpose(1, 2).contiguous(), (m + torch.log(l))[..., 0]


def fused_attention_bwd_reference(q, k, v, seg, lse, out, do, scale, causal):
    """Plain version of kernel #5: ``(dq, dk, dv)``; dq ``[B, S, H, D]``,
    dk/dv ``[B, S, Hkv, D]`` with the GQA fold summed in f32."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    qh, kh, vh = _heads(q, k, v)
    oh = out.transpose(1, 2).float()
    doh = do.transpose(1, 2).float()
    s = _masked_scores(qh, kh, seg, scale, causal)
    p = torch.exp(s - lse[..., None])
    pc = p.to(q.dtype).float()
    dv = pc.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = (ds @ kh) * scale
    dk = (ds.transpose(-1, -2) @ qh) * scale

    def fold(x, dtype):  # [B, H, S, D] → [B, S, Hkv, D]
        return x.view(B, Hkv, H // Hkv, S, D).sum(dim=2).to(dtype).transpose(1, 2).contiguous()

    return dq.to(q.dtype).transpose(1, 2).contiguous(), fold(dk, k.dtype), fold(dv, v.dtype)


def _check_launch(q, k, v, seg, *others):
    """Validate what the kernels take; raise on anything else."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused kernels take q, k, v of one dtype among "
                        f"{sorted(map(str, _DTYPE_CODES))}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"fused kernels take q [B, S, H, D] and k, v [B, S, Hkv, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or not fused_supported(q, k):
        raise ValueError(
            f"fused kernels do not take q={tuple(q.shape)} k={tuple(k.shape)}: they need Sq == "
            f"Skv, S a multiple of 128 and <= {_MAX_S}, D a multiple of 64 and <= {_MAX_D}, and "
            "q heads divisible by kv heads"
        )
    tensors = [q, k, v, *others] + ([] if seg is None else [seg])
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused kernels need every tensor on one device")
    # the allocator aligns storage; an offset view may break the 16-byte loads
    if any(not t.is_contiguous() or t.storage_offset() * t.element_size() % 16 for t in tensors):
        raise ValueError("fused kernels need contiguous, 16-byte aligned tensors")
    if seg is not None and (seg.dtype != torch.int32 or tuple(seg.shape) != tuple(q.shape[:2])):
        raise TypeError(f"segment ids must be int32 [B, S], got {seg.dtype} {tuple(seg.shape)}")


def fused_attention_fwd(q, k, v, seg, scale, causal):
    """Kernel #4 on a CUDA tensor, its plain version on a CPU one: ``(out,
    lse)`` as :func:`fused_attention_fwd_reference`."""
    if not q.is_cuda:
        return fused_attention_fwd_reference(q, k, v, seg, scale, causal)
    _check_launch(q, k, v, seg)
    lib = _build.load("fused_attention_fwd")
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = lib.fused_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, S, H, k.shape[2], D, _DTYPE_CODES[q.dtype],
        int(causal), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "fused_attention_fwd")
    fused_attention_fwd.launches += 1
    return out, lse


fused_attention_fwd.launches = 0


def fused_attention_bwd(q, k, v, seg, lse, out, do, scale, causal):
    """Kernel #5 on a CUDA tensor, its plain version on a CPU one: ``(dq,
    dk, dv)`` as :func:`fused_attention_bwd_reference`."""
    if not q.is_cuda:
        return fused_attention_bwd_reference(q, k, v, seg, lse, out, do, scale, causal)
    _check_launch(q, k, v, seg, lse, out, do)
    if out.shape != q.shape or do.shape != q.shape or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("out and do must match q's shape and dtype")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError("lse must be f32 [B, H, S]")
    lib = _build.load("fused_attention_bwd")
    B, S, H, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = lib.fused_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if seg is None else seg.data_ptr(),
        lse.data_ptr(), out.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), B, S, H, k.shape[2], D, _DTYPE_CODES[q.dtype],
        int(causal), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "fused_attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class _FusedAttention(torch.autograd.Function):
    """Forward through kernel #4 (saving ``lse`` and the output), backward
    through kernel #5 — on the CPU, through their plain versions, so the
    split is the same on both devices."""

    @staticmethod
    def forward(ctx, q, k, v, seg, scale, causal):
        out, lse = fused_attention_fwd(q, k, v, seg, scale, causal)
        ctx.save_for_backward(q, k, v, seg, lse, out)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, lse, out = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, seg, lse, out, do.contiguous(),
                                         ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-pass fused attention (BSHD in and out): ``q [B, S, H, D]``,
    ``k, v [B, S, Hkv, D]``, ``segment_ids [B, S]`` (padding = 0; position
    ``i`` attends ``j`` iff their ids match). A CUDA input outside
    :func:`fused_supported` raises; it never drops to another path."""
    if q.is_cuda and not fused_supported(q, k):
        raise ValueError(
            f"fused attention does not take q={tuple(q.shape)} k={tuple(k.shape)} (needs Sq == "
            f"Skv, S a multiple of 128 and <= {_MAX_S}, D a multiple of 64 and <= {_MAX_D}, q "
            "heads divisible by kv heads); use impl='xla'"
        )
    seg = None if segment_ids is None else segment_ids.to(torch.int32).contiguous()
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    return _FusedAttention.apply(q, k, v, seg, scale, bool(causal))
