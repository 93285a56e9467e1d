"""Mixture-of-experts FFN with capacity-based top-k routing: the port of
``accelerate_tpu.parallel.moe``.

The same function as the JAX package's ``moe_ffn``: tokens are routed in
groups of ``g = min(group_size, N)`` (lowered to a divisor of ``N``), each
group with a per-expert capacity ``max(ceil(top_k · cf · g / E), 1)``;
the router runs in f32, its softmax's top ``top_k`` experts (ties to the
lower index) are renormalised with a ``1e-9`` floor; capacity is filled
choice-major — every first choice of a group claims its slot before any
second choice, tokens in group order within a choice — and a token past
capacity is dropped from that expert (its output from that choice is 0).
Each expert is ``gelu(x @ wi) @ wo`` with ``jax.nn.gelu``'s default tanh
approximation, and the combine weights are rounded to the expert output's
dtype before the weighted sum. The aux loss is GShard's ``E · Σ_e
fraction_first_choice(e) · mean_prob(e)``.

Dispatch is by index rather than JAX's dense one-hot einsums: each kept
(token, choice) is copied into its expert's slot of ``[E, G, C, D]``, and
each token gathers its slots back. The values are the same (a one-hot
product copies, and the combine sums at most ``top_k`` nonzero terms).
The expert products are batched over ``E`` (``torch.bmm``), plain products
as JAX computes them outside any Pallas kernel. ``mesh=`` (expert
parallelism over an ``ep`` axis) and ``moe_shard_rules`` are not ported yet
(ROADMAP.md Queue A item 6).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["init_moe_ffn", "moe_ffn", "moe_shard_rules"]

_MESH_NOT_PORTED = ("expert parallelism (mesh=, moe_shard_rules) is not ported yet: it comes "
                    "with ROADMAP.md Queue A item 6")


def init_moe_ffn(generator: Optional[torch.Generator], d_model: int, d_ff: int,
                 num_experts: int, dtype: Optional[torch.dtype] = None, device=None) -> dict:
    """Router and per-expert MLP stacks with the JAX ``init_moe_ffn`` tree
    and scales: ``router`` ``[D, E]`` and ``wi`` ``[E, D, F]`` at
    ``N(0, 1/D)``, ``wo`` ``[E, F, D]`` at ``N(0, 1/F)``. Draws come from
    ``generator`` (a fresh one seeded 0 on the target device when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype or torch.float32

    def normal(*shape, scale):
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    return {
        "router": {"kernel": normal(d_model, num_experts, scale=1 / math.sqrt(d_model))},
        "wi": {"kernel": normal(num_experts, d_model, d_ff, scale=1 / math.sqrt(d_model))},
        "wo": {"kernel": normal(num_experts, d_ff, d_model, scale=1 / math.sqrt(d_ff))},
    }


def moe_shard_rules():
    raise NotImplementedError(_MESH_NOT_PORTED)


class Routing(NamedTuple):
    """One call's routing: groups ``G`` of ``g`` tokens, ``capacity`` slots
    per expert and group; per (group, token, choice) the expert ``idx``,
    renormalised gate ``gates`` (f32), slot ``pos`` and ``keep`` (within
    capacity); the router ``probs`` ``[G, g, E]``."""

    G: int
    g: int
    capacity: int
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor


def route(router_kernel: torch.Tensor, x: torch.Tensor, top_k: int, capacity_factor: float,
          group_size: int = 4096) -> Routing:
    """The routing of :func:`moe_ffn` for ``x [B, S, D]``."""
    B, S, D = x.shape
    E = router_kernel.shape[-1]
    N = B * S
    g = min(group_size, N)
    while N % g:
        g -= 1
    G = N // g
    capacity = max(int(np.ceil(top_k * capacity_factor * g / E)), 1)
    logits = x.reshape(G, g, D).float() @ router_kernel.float()  # [G, g, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: on ties the lower expert comes first, as
    # lax.top_k orders them
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :top_k], order[..., :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    fill = torch.zeros((G, E, 1), dtype=torch.int32, device=x.device)
    pos = []
    for k in range(top_k):  # choice-major: first choices claim slots first
        # [G, E, g], tokens innermost: the running count is an inner-dim scan
        onehot = F.one_hot(idx[..., k], E).to(torch.int32).transpose(1, 2).contiguous()
        within = onehot.cumsum(dim=-1, dtype=torch.int32) - 1 + fill
        pos.append(within.gather(1, idx[:, None, :, k])[:, 0])
        fill = fill + onehot.sum(dim=-1, keepdim=True, dtype=torch.int32)
    pos = torch.stack(pos, dim=-1).long()  # [G, g, k]
    return Routing(G, g, capacity, idx, gates, pos, pos < capacity, probs)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
            mesh=None, ep_axis: str = "ep", activation=None,
            group_size: int = 4096) -> "tuple[torch.Tensor, torch.Tensor]":
    """Mixture-of-experts FFN on ``x [B, S, D]`` → ``(y [B, S, D], aux)``,
    ``aux`` the f32 load-balance loss (add it, scaled ~1e-2, to the
    training loss). ``activation`` defaults to tanh-approximated GELU."""
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    if activation is None:
        def activation(t):
            return F.gelu(t, approximate="tanh")
    B, S, D = x.shape
    wi, wo = params["wi"]["kernel"], params["wo"]["kernel"]
    E = wi.shape[0]
    r = route(params["router"]["kernel"], x, top_k, capacity_factor, group_size)
    G, g, C = r.G, r.g, r.capacity
    # slot of each (group, token, choice) in the flat [E * G * C] expert
    # input; a dropped one points at a spare row past the end
    group = torch.arange(G, device=x.device)[:, None, None]
    slot = torch.where(r.keep, (r.idx * G + group) * C + r.pos, E * G * C)
    token = torch.arange(G * g, device=x.device).reshape(G, g, 1).expand_as(slot)
    # which token fills each slot (N = none: the zero row appended to x)
    src = torch.full((E * G * C + 1,), G * g, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), token.reshape(-1))
    x_rows = torch.cat([x.reshape(G * g, D), x.new_zeros(1, D)])
    # index_select, not indexing: its backward adds at most top_k rows into
    # each token's gradient, where indexing's backward sorts the indices
    expert_in = x_rows.index_select(0, src[:-1]).reshape(E, G * C, D)
    h = activation(torch.bmm(expert_in, wi))
    expert_out = torch.bmm(h, wo).reshape(E * G * C, D)
    out_rows = torch.cat([expert_out, expert_out.new_zeros(1, D)])
    picked = out_rows.index_select(0, slot.reshape(-1)).reshape(G, g, top_k, D)
    combine = (r.gates * r.keep).to(expert_out.dtype)  # [G, g, k]
    y = (combine.float()[..., None] * picked.float()).sum(dim=2)
    first = F.one_hot(r.idx[..., 0].reshape(-1), E).float()
    aux = E * torch.sum(first.mean(dim=0) * r.probs.reshape(-1, E).mean(dim=0))
    return y.reshape(B, S, D).to(x.dtype), aux
