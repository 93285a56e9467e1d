"""The pieces of ``accelerate_tpu.generation`` that the serving engine uses:
the shared masked-attention core, the QKV projection with RoPE, and token
selection. Greedy selection is a plain ``torch.argmax`` (first index on
ties, as ``jnp.argmax``); :func:`sample_token_logits` samples from the
threefry streams of :mod:`.utils.random`, which reproduce ``jax.random``'s
bits exactly, so a sampled stream draws the JAX package's tokens from the
same key (up to the last bit of ``log`` in the Gumbel noise: a near-tie of
two perturbed logits can break the other way).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .models.transformer import LlamaConfig, apply_rope
from .utils.random import gumbel

__all__ = ["_masked_attention", "_project_qkv", "sample_token_logits"]


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


def sample_token_logits(logits: torch.Tensor, keys: torch.Tensor, *, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """One sampling step over ``logits [B, V]`` with one threefry key per
    row (``keys [B, 2]``, :mod:`.utils.random`): temperature scaling, then
    top-k truncation, then nucleus (top-p), then the Gumbel-max draw of
    ``jax.random.categorical``, in the JAX package's order.
    ``temperature == 0`` is greedy argmax. Returns int64 ``[B]``; no value
    is read back to the host."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    # a device tensor, not a Python scalar: CUDA divides by a host scalar
    # through its reciprocal, which rounds differently from a division
    logits = logits.float() / torch.tensor(temperature, dtype=torch.float32,
                                           device=logits.device)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=logits.device)
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])  # HF clamps an oversize top_k
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the smallest prefix reaching mass >= top_p (always keeps a token);
        # past the end, JAX's gather fills NaN and keeps every value, as the
        # last (smallest) value does here
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return torch.argmax(logits + gumbel(keys, logits.shape[-1]), dim=-1)
