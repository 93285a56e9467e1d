"""Attention with pluggable implementations: the port of
``accelerate_tpu.ops.attention``.

Layouts: ``q [B, Sq, H, D]``, ``k, v [B, Skv, Hkv, D]`` (BSHD); GQA when
``Hkv`` divides ``H``. Implementations:

- ``"xla"`` — the plain einsum path (:func:`_xla_attention`): f32 logits,
  masked with ``finfo(f32).min``, softmax in f32, the value product in the
  input dtype;
- ``"fused"`` — the single-pass kernels of :mod:`.fused_attention`;
- ``"flash"`` — the blocked streaming kernels of
  :func:`.flash_attention.flash_attention` (causal, window, segment ids);
- ``"auto"`` — the einsum path. The JAX package picks its flash kernel past
  a crossover table measured on a TPU (``ATTN_CROSSOVER_S``); that table
  says nothing about this card and is not carried over.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dot_product_attention", "make_padding_mask", "segment_mask"]


def segment_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` ids → ``[B, 1, Sq, Skv]`` bool allow-mask: attend iff the
    ids match."""
    return segment_ids[:, None, :, None] == segment_ids[:, None, None, :]


def _repeat_kv(hidden: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, Hkv, D]`` → ``[B, S, Hkv * n_rep, D]`` (GQA broadcast)."""
    if n_rep == 1:
        return hidden
    b, s, h, d = hidden.shape
    return hidden[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,  # [B, 1|H, Sq, Skv] additive or bool
    segment_ids: Optional[torch.Tensor] = None,  # [B, S] int; padding = 0
    scale: Optional[float] = None,
    window: Optional[int] = None,  # sliding window: attend iff 0 <= i-j < window
    impl: str = "auto",
) -> torch.Tensor:
    """Softmax attention, BSHD, with the JAX package's masking forms:
    ``segment_ids`` (attend iff same id), ``window`` (a causal band; needs
    ``causal=True``) and an arbitrary ``mask`` (einsum path only)."""
    if window is not None and not causal:
        raise ValueError("window requires causal=True (the sliding window is a causal band)")
    if impl == "auto":
        impl = "xla"
    if impl in ("flash", "fused") and mask is not None:
        raise ValueError(
            f"impl={impl!r} does not support an arbitrary mask (causal and segment_ids only); "
            "use impl='xla', or express padding/packing as segment_ids"
        )
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids,
                               window=window)
    if impl == "fused":
        if window is not None:
            raise ValueError(
                "impl='fused' does not support window (the short-S single-pass kernel has no "
                "band masking); use impl='flash' or 'xla'"
            )
        from .fused_attention import fused_attention

        return fused_attention(q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if segment_ids is not None:
        seg_mask = segment_mask(segment_ids)
        if mask is None:
            mask = seg_mask
        elif mask.dtype == torch.bool:
            mask = mask & seg_mask
        else:  # additive mask: fold the segment constraint in as finfo.min
            mask = mask + torch.where(seg_mask, 0.0, torch.finfo(torch.float32).min)
    return _xla_attention(q, k, v, causal=causal, mask=mask, scale=scale, window=window)


def _xla_attention(q, k, v, *, causal, mask, scale, window=None):
    sq, hq, d = q.shape[-3:]
    skv, hkv = k.shape[1], k.shape[2]
    if hq != hkv:
        k = _repeat_kv(k, hq // hkv)
        v = _repeat_kv(v, hq // hkv)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    # logits in f32 whatever the input dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = torch.finfo(torch.float32).min
    if causal or window is not None:
        # query i sits at absolute position i + (skv - sq)
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        if causal:
            logits = torch.where(kpos <= qpos, logits, neg)
        if window is not None:
            logits = torch.where(qpos - kpos < window, logits, neg)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, neg)
        else:
            logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def make_padding_mask(attention_mask: torch.Tensor, sq: int) -> torch.Tensor:
    """``[B, Skv]`` 1/0 padding mask → ``[B, 1, Sq, Skv]`` bool mask."""
    return attention_mask[:, None, None, :].bool().expand(
        attention_mask.shape[0], 1, sq, attention_mask.shape[1])
