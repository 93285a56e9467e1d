"""The pieces of ``accelerate_tpu.generation`` that the serving engine uses:
the shared masked-attention core and the QKV projection with RoPE. Greedy
selection is a plain ``torch.argmax`` (first index on ties, as
``jnp.argmax``).

Sampling (``sample_token_logits``) is not ported yet: JAX's threefry
streams cannot be reproduced in PyTorch, so a sampled stream can only be
held to the port's own non-speculative stream (see ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .models.transformer import LlamaConfig, apply_rope

__all__ = ["_masked_attention", "_project_qkv"]


def _masked_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      allow: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, S, H, D]`` against caches ``[B, T, Hkv, D]`` under a boolean
    ``allow`` mask broadcastable to ``[B, H, S, T]``. Scores and softmax are
    f32; masked slots get the ``finfo(f32).min`` fill, which underflows to an
    exact 0 weight after the max-subtraction. Probabilities are cast to
    ``q.dtype`` before the value product, as in the reference."""
    B, S, H, D = q.shape
    hkv = k_cache.shape[2]
    if hkv != H:
        rep = H // hkv
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    logits = logits.masked_fill(~allow, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.to(q.dtype))


def _project_qkv(layer: dict, x: torch.Tensor, positions: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, config: LlamaConfig):
    """x ``[B, S, dim]`` at per-row ``positions [B, S]`` → ``(q, k, v)`` in
    BSHD with RoPE applied to q and k."""
    B, S, _ = x.shape
    q = (x @ layer["wq"]["kernel"]).reshape(B, S, config.n_heads, config.head_dim)
    k = (x @ layer["wk"]["kernel"]).reshape(B, S, config.n_kv_heads, config.head_dim)
    v = (x @ layer["wv"]["kernel"]).reshape(B, S, config.n_kv_heads, config.head_dim)
    q = apply_rope(q, cos, sin, positions=positions)
    k = apply_rope(k, cos, sin, positions=positions)
    return q, k, v

