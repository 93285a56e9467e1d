"""Llama decoder in PyTorch: the port of ``accelerate_tpu.models.transformer``.

Params keep the JAX package's layout — a nested dict whose per-layer
tensors are stacked on a leading layer axis (``params["layers"]["wq"]
["kernel"]`` is ``[L, dim, n_heads*head_dim]``) — so weights made by the
JAX initializer load unchanged through :mod:`.convert`. Matmuls are
``x @ kernel`` with ``kernel`` stored ``[in, out]``, as in the reference.

Only the dense SwiGLU FFN is ported; MoE configs raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "LlamaConfig",
    "apply_rope",
    "init_llama",
    "llama_ffn",
    "llama_forward",
    "rms_norm",
    "rope_frequencies",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0):
    """``(cos, sin)`` numpy tables ``[max_seq, head_dim/2]`` in f32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``[B, S, H, D]``; cos/sin ``[max_seq, D/2]``; half-split layout
    (the first and second halves of ``D`` are the rotated pair)."""
    seq = x.shape[1]
    if positions is None:
        cos_s = cos[:seq][None, :, None, :]
        sin_s = sin[:seq][None, :, None, :]
    else:
        cos_s = cos[positions][:, :, None, :]
        sin_s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos_s = cos_s.to(x.dtype)
    sin_s = sin_s.to(x.dtype)
    return torch.cat([x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s], dim=-1)


@dataclass(frozen=True)
class LlamaConfig:
    """Same fields and defaults as the JAX package's ``LlamaConfig``. The
    fields that select JAX-only machinery (``unroll_layers``, ``attn_impl``)
    are carried for parity and ignored; ``moe_experts > 0`` and
    ``dtype_recipe="fp8"`` are not ported yet and raise at init."""

    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    ffn_dim: Optional[int] = None  # default 8/3 * dim rounded to 256
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    unroll_layers: bool = True
    attn_impl: str = "auto"
    dtype_recipe: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def hidden_dim(self) -> int:
        if self.ffn_dim is not None:
            return self.ffn_dim
        return int(np.ceil(self.dim * 8 / 3 / 256) * 256)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=256)


def _check_supported(config: LlamaConfig) -> None:
    if config.moe_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet (see ROADMAP.md)")
    if config.dtype_recipe is not None:
        raise NotImplementedError(
            f"dtype_recipe={config.dtype_recipe!r} is not ported yet (see ROADMAP.md)"
        )


def init_llama(config: LlamaConfig, generator: Optional[torch.Generator] = None,
               device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Stacked-layer params with the JAX ``init_llama`` layout and scales:
    projections ``N(0, 1/in_dim)``, embedding and head ``N(0, 0.02^2)``, norm
    scales one. Draws come from ``generator`` (a fresh one seeded 0 on the
    target device when omitted), so they differ from JAX's threefry draws —
    parity tests load JAX-made weights through :mod:`.convert` instead."""
    _check_supported(config)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Hd = config.n_layers, config.dim, config.hidden_dim
    Dq = config.n_heads * config.head_dim
    Dkv = config.n_kv_heads * config.head_dim

    def dense(*shape, scale=None):
        in_dim = shape[-2]
        scale = 1.0 / math.sqrt(in_dim) if scale is None else scale
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(*shape, device=dev, dtype=dtype)

    params = {
        "embed_tokens": {"embedding": dense(config.vocab_size, D, scale=0.02)},
        "layers": {
            "attn_norm": {"scale": ones(L, D)},
            "wq": {"kernel": dense(L, D, Dq)},
            "wk": {"kernel": dense(L, D, Dkv)},
            "wv": {"kernel": dense(L, D, Dkv)},
            "wo": {"kernel": dense(L, Dq, D)},
            "mlp_norm": {"scale": ones(L, D)},
            "w1": {"kernel": dense(L, D, Hd)},
            "w3": {"kernel": dense(L, D, Hd)},
            "w2": {"kernel": dense(L, Hd, D)},
        },
        "final_norm": {"scale": ones(D)},
    }
    if not config.tie_embeddings:
        params["lm_head"] = {"kernel": dense(D, config.vocab_size, scale=0.02)}
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""
    return {name: {k: v[i] for k, v in entry.items()} for name, entry in params["layers"].items()}


def llama_ffn(layer: dict, x: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Dense SwiGLU FFN of one layer (``layer`` from :func:`layer_params`)."""
    if config.moe_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet (see ROADMAP.md)")
    gate = torch.nn.functional.silu(x @ layer["w1"]["kernel"])
    up = x @ layer["w3"]["kernel"]
    return (gate * up) @ layer["w2"]["kernel"]


def lm_logits(params: dict, h: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Final norm and output projection shared by every forward."""
    h = rms_norm(h, params["final_norm"]["scale"], config.norm_eps)
    if config.tie_embeddings:
        return h @ params["embed_tokens"]["embedding"].T
    return h @ params["lm_head"]["kernel"]


def llama_forward(params: dict, input_ids: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Plain full-sequence causal forward: logits ``[B, S, vocab]``. No cache
    and no kernel — the reference the cached serving path is held to."""
    from ..generation import _masked_attention, _project_qkv

    _check_supported(config)
    dev = input_ids.device
    cos, sin = (torch.from_numpy(t).to(dev) for t in
                rope_frequencies(config.head_dim, config.max_seq_len, config.rope_theta))
    B, S = input_ids.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    causal = positions[0][None, :] <= positions[0][:, None]  # [S(q), S(kv)]
    h = params["embed_tokens"]["embedding"][input_ids]
    for i in range(config.n_layers):
        layer = layer_params(params, i)
        x = rms_norm(h, layer["attn_norm"]["scale"], config.norm_eps)
        q, k, v = _project_qkv(layer, x, positions, cos, sin, config)
        attn = _masked_attention(q, k, v, causal[None, None])
        h = h + attn.reshape(B, S, -1) @ layer["wo"]["kernel"]
        x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
        h = h + llama_ffn(layer, x, config)
    return lm_logits(params, h, config)
