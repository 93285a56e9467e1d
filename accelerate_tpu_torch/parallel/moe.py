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
as JAX computes them outside any Pallas kernel.

``mesh=`` runs the same function on one rank's share of a sharded step
(routing by :func:`route`): ``x`` holds the rank's rows of the global batch,
split over ``(dp_replicate, dp_shard)``, and the groups are those of the
global ``[B·S]`` token order, so a group may straddle ranks; each token's
capacity slot then counts, per expert, the tokens of the lower ranks in its
group (an exclusive prefix over the batch ranks, from one all-gather of
the per-group counts), and the aux loss is a global mean. An ``ep`` axis is
not a batch axis: the ranks of an ``ep`` group hold the same rows and route
them alike, each computes its ``E/ep`` experts, and the combine sums over
``ep`` (the identity in the backward, where the expert input and the gates
sum their gradient over ``ep``). The expert weights' gradient is
gathered over ``ep`` to the rank that keeps it (a layer of the sharded
step's :class:`~.sharding.LayerStack` names it), or all-gathered where no
rank is named, so that the rank holds the whole gradient of every param,
as under ``tp``, and none is summed over it. A sequence split over ``cp``
or ``sp`` is not routed yet and raises.
:func:`moe_shard_rules` is the JAX package's table.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["init_moe_ffn", "moe_ffn", "moe_shard_rules"]



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
    """The JAX package's rules for MoE params: experts over ``ep``, router
    replicated. Compose with the model's base rules (first match wins). On
    the stacked ``[L, E, ...]`` tree of the MoE Llama they split the layer
    axis, as in the JAX package: each rank then holds ``1/ep`` of the
    expert bytes, whole layers, gathered on use."""
    from .sharding import PartitionSpec as P
    from .sharding import ShardingRules

    return ShardingRules([
        (r"router/kernel", P()),
        (r"wi/kernel", P("ep", None, "tp")),
        (r"wo/kernel", P("ep", "tp", None)),
    ])


class Routing(NamedTuple):
    """One call's routing: ``G`` groups of ``g`` tokens over the global
    batch, ``capacity`` slots per expert and group; per (token, choice) of
    the call's ``n`` tokens the expert ``idx``, renormalised gate ``gates``
    (f32), slot ``pos`` and ``keep`` (within capacity); the router
    ``probs`` ``[n, E]``; each token's global ``group``, the call's first
    group ``first_group`` and the ``groups`` its rows reach; the number of
    ``batch_ranks``."""

    G: int
    g: int
    capacity: int
    idx: torch.Tensor
    gates: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    group: torch.Tensor
    first_group: int
    groups: int
    batch_ranks: int


def _batch_rank(mesh, axes) -> tuple:
    """``(index, count)`` of this rank's rows among the batch ranks."""
    index, count = 0, 1
    for a in axes:
        index, count = index * mesh.shape[a] + mesh.coords[a], count * mesh.shape[a]
    return index, count


def _batch_axes(mesh, batch_axes) -> tuple:
    """The axes that split the batch rows: ``batch_axes`` when given, else
    every data-parallel axis of size > 1."""
    from ..parallelism_config import DP_AXES

    if mesh is None:
        return ()
    axes = DP_AXES if batch_axes is None else batch_axes
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def route(router_kernel: torch.Tensor, x: torch.Tensor, top_k: int, capacity_factor: float,
          group_size: int = 4096, mesh=None, batch_axes=None) -> Routing:
    """The routing of :func:`moe_ffn` for ``x [B, S, D]``: the whole batch,
    or under ``mesh`` one rank's rows of a global batch split over
    ``batch_axes`` (``(dp_replicate, dp_shard)`` by default). The groups are
    those of the global token order; each token's slot counts, per expert,
    the tokens of the lower ranks in its group (one all-gather of the
    per-group counts over the batch ranks). A sequence split over ``cp``
    or ``sp`` raises: each rank would route its chunk as if its tokens were
    a contiguous run of the global order."""
    from .sharding import _all_gather_dim

    if mesh is not None and mesh.sequence_axis is not None:
        raise NotImplementedError(
            f"MoE routing of a sequence split over {mesh.sequence_axis} is not ported: the "
            "groups and capacity slots count only the batch ranks' tokens")
    B, S, D = x.shape
    E = router_kernel.shape[-1]
    batch_axes = _batch_axes(mesh, batch_axes)
    b, nb = _batch_rank(mesh, batch_axes)
    n = B * S
    N = n * nb  # tokens of the global batch, this call's at [b·n, (b+1)·n)
    g = min(group_size, N)
    while N % g:
        g -= 1
    G = N // g
    C = max(int(np.ceil(top_k * capacity_factor * g / E)), 1)
    dev = x.device
    group = (b * n + torch.arange(n, device=dev)) // g
    logits = x.reshape(n, D).float() @ router_kernel.float()
    probs = torch.softmax(logits, dim=-1)  # [n, E]
    # a stable descending sort: on ties the lower expert comes first, as
    # lax.top_k orders them
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], order[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    onehots = [F.one_hot(idx[:, k], E).to(torch.int32) for k in range(top_k)]  # [n, E]
    # per (group, choice, expert) counts of this call's tokens, then of each
    # batch rank's (in batch order) by one all-gather
    counts = torch.zeros((G, top_k, E), dtype=torch.int32, device=dev)
    for k in range(top_k):
        counts[:, k].index_add_(0, group, onehots[k])
    per_rank = counts[None]
    for a in reversed(batch_axes):  # minor axis first: batch order
        per_rank = _all_gather_dim(per_rank, 0, mesh.group(a))
    before = per_rank[:b].sum(0, dtype=torch.int32)  # lower ranks' tokens of each group
    total = per_rank.sum(0, dtype=torch.int32)
    # choice-major: the choices before k fill their slots first
    fill = torch.cumsum(total, dim=1, dtype=torch.int32) - total
    first_of_group = torch.searchsorted(group, group)  # the call's first token of each group
    pos = []
    for k in range(top_k):
        before_t = onehots[k].cumsum(0, dtype=torch.int32) - onehots[k]  # [n, E]
        within = before_t - before_t[first_of_group]
        offset = before[group, k] + fill[group, k]
        pos.append((within + offset).gather(1, idx[:, k:k + 1])[:, 0])
    pos = torch.stack(pos, dim=-1).long()  # [n, k]
    first = b * n // g
    return Routing(G, g, C, idx, gates, pos, pos < C, probs, group, first,
                   ((b + 1) * n - 1) // g - first + 1, nb)


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
            mesh=None, ep_axis: str = "ep", activation=None,
            group_size: int = 4096, batch_axes=None) -> "tuple[torch.Tensor, torch.Tensor]":
    """Mixture-of-experts FFN on ``x [B, S, D]`` → ``(y [B, S, D], aux)``,
    ``aux`` the f32 load-balance loss (add it, scaled ~1e-2, to the
    training loss). ``activation`` defaults to tanh-approximated GELU.
    Under ``mesh`` (one rank of a sharded step) ``x`` is the rank's rows
    of the batch split over ``batch_axes`` (the data axes by default) and
    ``params`` are whole, or (a sharded decode) hold the rank's ``E/ep``
    experts already (see the module docstring)."""
    if activation is None:
        def activation(t):
            return F.gelu(t, approximate="tanh")
    B, S, D = x.shape
    n = B * S
    if mesh is not None and not any(size > 1 for size in mesh.shape.values()):
        mesh = None
    r = route(params["router"]["kernel"], x, top_k, capacity_factor, group_size, mesh,
              batch_axes)
    y = _experts(params, x.reshape(n, D), r.idx, r.gates, r.pos, r.keep, r.group - r.first_group,
                 r.groups, r.capacity, activation, mesh, ep_axis)
    return (y.reshape(B, S, D).to(x.dtype),
            _aux(r.idx[:, 0], r.probs, n * r.batch_ranks, mesh, batch_axes))


def _experts(params, x_rows, idx, gates, pos, keep, group, groups: int, C: int, activation,
             mesh, ep_axis: str) -> torch.Tensor:
    """The combined expert outputs ``[n, D]`` (f32) of ``n`` routed tokens
    ``x_rows``: each kept (token, choice) is copied into its expert's slot
    of ``[E, groups, C, D]`` (``group`` is each token's group among the
    ``groups`` this call holds), the experts run batched, and each token
    gathers its slots back weighted by its gates. Under an ``ep`` axis of
    ``mesh`` this rank runs its ``E/ep`` experts and the sum is completed
    over ``ep``."""
    n, D = x_rows.shape
    top_k = idx.shape[1]
    wi, wo = params["wi"]["kernel"], params["wo"]["kernel"]
    ep = 1 if mesh is None else mesh.shape.get(ep_axis, 1)
    n_experts = params["router"]["kernel"].shape[-1]
    presliced = ep > 1 and wi.shape[0] * ep == n_experts  # the rank's experts only
    if n_experts % ep:
        raise ValueError(f"{n_experts} experts do not split over {ep_axis}={ep}")
    e_loc = n_experts // ep
    e0 = 0 if ep == 1 else mesh.coords[ep_axis] * e_loc
    if ep > 1:  # the rest of these inputs' gradient comes from the other experts' ranks
        keep = keep & (idx >= e0) & (idx < e0 + e_loc)
        x_rows = _SumGradOverAxis.apply(x_rows, mesh, ep_axis)
        gates = _SumGradOverAxis.apply(gates, mesh, ep_axis)
        if not presliced:
            wi, wo = (_ExpertSlice.apply(w, mesh, ep_axis) for w in (wi, wo))
    # slot of each (token, choice) in the flat [E * groups * C] expert input;
    # a dropped one points at a spare row past the end
    spare = e_loc * groups * C
    slot = torch.where(keep, ((idx - e0) * groups + group[:, None]) * C + pos, spare)
    token = torch.arange(n, device=x_rows.device)[:, None].expand_as(slot)
    # which token fills each slot (n = none: the zero row appended to x)
    src = torch.full((spare + 1,), n, dtype=torch.long, device=x_rows.device)
    src.scatter_(0, slot.reshape(-1), token.reshape(-1))
    x_rows = torch.cat([x_rows, x_rows.new_zeros(1, D)])
    # index_select, not indexing: its backward adds at most top_k rows into
    # each token's gradient, where indexing's backward sorts the indices
    expert_in = x_rows.index_select(0, src[:-1]).reshape(e_loc, groups * C, D)
    h = activation(torch.bmm(expert_in, wi))
    expert_out = torch.bmm(h, wo).reshape(spare, D)
    out_rows = torch.cat([expert_out, expert_out.new_zeros(1, D)])
    picked = out_rows.index_select(0, slot.reshape(-1)).reshape(n, top_k, D)
    combine = (gates * keep).to(expert_out.dtype)  # [n, k]
    y = (combine.float()[..., None] * picked.float()).sum(dim=1)
    return _SumOverAxis.apply(y, mesh, ep_axis) if ep > 1 else y


def _aux(first_choice, probs, N: int, mesh, batch_axes=None) -> torch.Tensor:
    """GShard's load-balance loss over the ``N`` tokens of the global batch,
    from this rank's first choices and router probs: every rank's value is
    the global one, and its gradient ``nb`` times its rows' share for ``nb``
    batch ranks (the sharded step averages the ranks' gradients)."""
    E = probs.shape[-1]
    first = F.one_hot(first_choice, E).float()
    if mesh is None:
        return E * torch.sum(first.mean(dim=0) * probs.mean(dim=0))
    from .sharding import all_reduce_axes

    batch_axes = _batch_axes(mesh, batch_axes)
    nb = N // first.shape[0]
    prob_sum = probs.sum(0)
    sums = torch.stack([first.sum(0), prob_sum.detach()])
    if batch_axes:
        sums = all_reduce_axes(sums.clone(), mesh, batch_axes)
    mean_prob = (nb * prob_sum + (sums[1] - nb * prob_sum).detach()) / N
    return E * torch.sum(sums[0] / N * mean_prob)


class _SumOverAxis(torch.autograd.Function):
    """Summed over a mesh axis in the forward; the identity in the backward
    (every rank of the axis receives the same gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        from .sharding import all_reduce_axes

        return all_reduce_axes(x.clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SumGradOverAxis(torch.autograd.Function):
    """The identity in the forward; the gradient summed over a mesh axis in
    the backward (each rank of the axis holds part of it)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from .sharding import all_reduce_axes

        return all_reduce_axes(grad.contiguous().clone(), ctx.mesh, (ctx.axis,)), None, None


class _ExpertSlice(torch.autograd.Function):
    """This rank's experts of whole expert weights ``[E, ...]``; the
    backward gathers every ``ep`` rank's experts' gradient to the rank that
    keeps the weights' gradient (``w.layer_grad_owner``; the others pass
    zeros on), or all-gathers it when ``w`` names none, as for a param the
    axis replicates."""

    @staticmethod
    def forward(ctx, w, mesh, axis):
        ctx.mesh, ctx.axis, ctx.shape = mesh, axis, w.shape
        ctx.owner = getattr(w, "layer_grad_owner", {}).get(axis)
        n = w.shape[0] // mesh.shape[axis]
        return w[mesh.coords[axis] * n:(mesh.coords[axis] + 1) * n]

    @staticmethod
    def backward(ctx, grad):
        from .sharding import _all_gather_dim, _gather_dim

        group = ctx.mesh.group(ctx.axis)
        if ctx.owner is None:
            return _all_gather_dim(grad.contiguous(), 0, group), None, None
        full = _gather_dim(grad, 0, group, ctx.owner)
        return (grad.new_zeros(ctx.shape) if full is None else full), None, None
