"""The sharding decision surface, and the collectives of a sharded train
step: the port of ``accelerate_tpu.parallel.sharding``.

Spec inference is the JAX package's, line for line: ``rules`` (a TP table
such as :func:`llama_tp_rules`) claim dims first, FSDP puts ``(dp_shard,
cp)`` on the largest free dim of every param of at least
``min_fsdp_size`` elements, and :func:`canonicalize_spec` drops size-1 axes
and trailing ``None`` dims. It reads only the mesh's axis sizes, so it
runs without a process group. :class:`PartitionSpec` is a tuple with one
entry per dim (``None``, an axis name, or a tuple of names, major first),
as ``jax.sharding.PartitionSpec`` iterates.

A spec becomes one placement per mesh axis (:func:`placements`: ``Shard
(d)`` on every axis that shards dim ``d``, ``Replicate()`` elsewhere), and
each rank holds its block of every param as a plain tensor
(:func:`local_shard`), the block ``jax.sharding.NamedSharding.
devices_indices_map`` gives the device at the same mesh coordinates. An
uneven placement raises, as ``jax.device_put`` does.

Compute runs on plain tensors: :meth:`ShardingPlan.gather_params`
all-gathers every sharded param to its full value (minor axis first)
through an autograd function whose backward hands each rank its block of
the gradient: a reduce-scatter over the batch axes (``dp_replicate``,
``dp_shard``, and ``cp``/``sp``, which split the sequence) that shard the
dim, a local slice over the others (``tp``:
the activations are replicated there, so every ``tp`` rank already holds
the same gradient, and ``ep``, whose MoE FFN hands every rank the whole
expert gradient).
:meth:`ShardingPlan.reduce_grads` then sums over the batch axes that do not
shard the param, one all-reduce per group of params. The flash kernels
therefore see local tensors of the rank's rows with all heads.

The stacked ``layers`` subtree is not gathered whole: it reaches the loss
as a :class:`LayerStack`, which ``llama_forward`` reads one layer at a
time. Layer ``i``'s params are gathered when the forward reaches it (layer
``i+1``'s gather is issued asynchronously while layer ``i`` computes), and
its gradient is reduced to the ranks that hold it as soon as that layer's
backward ends, written straight into the rank's block of ``.grad``. Where
FSDP splits the layer axis (dim 0 of ``[L, ...]``), the ranks hold whole
layers: gathering layer ``i`` is a broadcast from the rank that owns it and
its gradient is summed to that owner. The gathered copy is dropped after
the layer's forward: the backward gathers it again (through
``saved_tensors_hooks`` without remat, through the recompute with it), so
at most two layers' gathered params are alive at any point of a step.
"""

from __future__ import annotations

import contextlib
import re
import weakref
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from ..parallelism_config import ParallelismConfig, axis_sizes
from ..utils.operations import record_collective

__all__ = [
    "FSDP_AXES",
    "GRAD_SUM_AXES",
    "LayerStack",
    "OptimizerOffload",
    "PartitionSpec",
    "ShardingPlan",
    "ShardingRules",
    "canonicalize_spec",
    "infer_param_specs",
    "llama_tp_rules",
    "local_shard",
    "make_sharding_plan",
    "placements",
    "replicate",
    "shard_index",
    "shard_like_params",
    "shard_params",
    "tree_specs_like",
    "zero1_state_specs",
]

FSDP_AXES = ("dp_shard", "cp")
_META_KEY = "fp8_meta"  # ops.fp8.META_KEY
# the axes the global batch's tokens are split over (the rows over
# dp_replicate and dp_shard, the sequence over cp or sp): each rank's
# gradient is its tokens' part, summed over these, and a step's mean loss
# divides by their ranks' count, as the JAX package's global mean does
GRAD_SUM_AXES = ("dp_replicate", "dp_shard", "cp", "sp")


class PartitionSpec(tuple):
    """One entry per dim: ``None``, a mesh axis, or a tuple of axes (major
    first). Compares equal to any tuple of the same entries."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(d) for d in self) + ")"


P = PartitionSpec


def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _spec_axes(spec) -> tuple:
    return tuple(a for d in spec for a in _dim_axes(d))


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; the path
    is the keys and indices joined by ``/``, as the JAX package spells a
    ``jax.tree_util`` key path."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return type(tree)((k, _map_with_path(fn, v, join(k))) for k, v in tree.items())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path, tree)


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _map(fn, *(t[k] for t in trees))) for k in first)
    if isinstance(first, (list, tuple)) and not isinstance(first, PartitionSpec):
        return type(first)(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def canonicalize_spec(spec, axis_sizes: Optional[dict] = None) -> PartitionSpec:
    """Size-1 mesh axes dropped (sharding over them is replication), a
    one-axis tuple as its axis, trailing ``None`` dims trimmed. Unknown
    axes are kept, so that placing the param raises."""
    dims = []
    for d in (list(spec) if spec is not None else []):
        axes = _dim_axes(d)
        if axis_sizes is not None:
            axes = tuple(a for a in axes if axis_sizes.get(a, 2) > 1)
        if not axes:
            dims.append(None)
        elif len(axes) == 1:
            dims.append(axes[0])
        else:
            dims.append(axes)
    while dims and dims[-1] is None:
        dims.pop()
    return PartitionSpec(*dims)


class ShardingRules:
    """Ordered ``(pattern, spec)`` table over ``/``-joined param paths;
    the first pattern that matches wins."""

    def __init__(self, rules: Sequence = ()):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]

    def match(self, path: str):
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return None

    def __add__(self, other: "ShardingRules") -> "ShardingRules":
        merged = ShardingRules()
        merged.rules = list(self.rules) + list(other.rules)
        return merged


def _merge_fsdp_into_spec(spec, shape, fsdp_axes: tuple, fsdp_size: int, sizes: dict):
    """Add the FSDP axes to a (possibly TP) spec: on dim 0 when it is free
    and divides, else on the largest free dim that divides; with no free
    dim, composed into dim 0's axes when the joint size divides; else the
    param stays replicated over them."""
    dims = list(spec) if spec is not None else []
    while len(dims) < len(shape):
        dims.append(None)
    candidates = [i for i, d in enumerate(dims)
                  if d is None and shape[i] >= 2 and shape[i] % fsdp_size == 0]
    if not candidates:
        if dims and dims[0] is not None:
            existing = _dim_axes(dims[0])
            existing_size = int(np.prod([sizes.get(a, 1) for a in existing]))
            if shape[0] % (fsdp_size * existing_size) == 0:
                dims[0] = tuple(fsdp_axes) + existing
        return canonicalize_spec(dims, sizes)
    target = 0 if 0 in candidates else max(candidates, key=lambda i: shape[i])
    dims[target] = tuple(fsdp_axes) if len(fsdp_axes) > 1 else fsdp_axes[0]
    return canonicalize_spec(dims, sizes)


def infer_param_specs(params, mesh, parallelism_config: Optional[ParallelismConfig] = None,
                      rules: Optional[ShardingRules] = None, min_fsdp_size: int = 2 ** 10):
    """The canonical :class:`PartitionSpec` tree of ``params`` on ``mesh``
    (a :class:`~..parallelism_config.Mesh` or ``{axis: size}``). fp8
    delayed-scaling meta is always whole: its gradients are new histories,
    MAX-reduced and never summed to an owner (FSDP would split a stack of
    64 layers or more in the JAX package, which reduces them in XLA)."""
    sizes = axis_sizes(mesh)
    pc = parallelism_config
    fsdp_on = pc is not None and pc.fsdp_enabled
    fsdp_axes = tuple(a for a in FSDP_AXES if sizes.get(a, 1) > 1)
    fsdp_size = int(np.prod([sizes[a] for a in fsdp_axes])) if fsdp_axes else 1

    def spec(path, value):
        shape = tuple(np.shape(value))
        if _META_KEY in path.split("/"):
            return PartitionSpec()
        base = rules.match(path) if rules is not None else None
        if fsdp_on and fsdp_size > 1 and int(np.prod(shape or (1,))) >= min_fsdp_size:
            return _merge_fsdp_into_spec(base, shape, fsdp_axes, fsdp_size, sizes)
        return canonicalize_spec(base, sizes)

    return _map_with_path(spec, params)


def shard_index(spec, shape, mesh, coords: Optional[dict] = None) -> tuple:
    """The block of a ``shape`` param under ``spec`` that the rank at mesh
    ``coords`` (this rank's by default) holds, as a tuple of slices. Raises
    on an uneven placement."""
    sizes = axis_sizes(mesh)
    coords = mesh.coords if coords is None else coords
    index = []
    for d, n in enumerate(shape):
        axes = _dim_axes(spec[d]) if d < len(spec) else ()
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} the mesh does not have")
        parts = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if n % parts:
            raise ValueError(f"a param of shape {tuple(shape)} cannot take {spec}: dim {d} "
                             f"({n}) is not divisible by {parts}")
        block = 0
        for a in axes:
            block = block * sizes[a] + coords[a]
        size = n // parts
        index.append(slice(block * size, (block + 1) * size))
    return tuple(index)


def local_shard(x, spec, mesh, coords: Optional[dict] = None):
    """This rank's block of ``x`` under ``spec`` (a view)."""
    return x[shard_index(spec, tuple(x.shape), mesh, coords)]


def placements(spec, mesh) -> list:
    """The DTensor placements of ``spec``: per mesh axis, ``Shard(d)`` when
    that axis shards dim ``d``, else ``Replicate()``. DTensor splits a dim
    sharded by several axes in mesh order, so their order in the spec must
    be the mesh's (as every canonical spec's is)."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in axis_sizes(mesh)}
    order = list(out)
    for d, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if [order.index(a) for a in axes] != sorted(order.index(a) for a in axes):
            raise ValueError(f"spec {spec} shards dim {d} over {axes}, not in mesh order")
        for a in axes:
            out[a] = Shard(d)
    return list(out.values())


def _place(x, spec, mesh, device=None):
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    t = local_shard(t, spec, mesh).contiguous()
    return t.to(device if device is not None else t.device, copy=True)


def shard_params(params, mesh, specs=None, parallelism_config=None, rules=None, device=None):
    """``(local params, specs)``: each rank's block of every param, a
    fresh tensor on ``device`` (the param's own by default)."""
    if specs is None:
        specs = infer_param_specs(params, mesh, parallelism_config, rules)
    return _map(lambda x, s: _place(x, s, mesh, device), params, specs), specs


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return list(a) == list(b) and all(_same_structure(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same_structure(x, y) for x, y in zip(a, b)))
    return not isinstance(a, (dict, list, tuple)) and not isinstance(b, (dict, list, tuple))


def tree_specs_like(tree, params, param_specs):
    """A spec tree for ``tree`` (an optimizer state, say): every subtree
    shaped as ``params`` takes ``param_specs``; every other leaf is
    replicated."""
    if tree is None:
        return None
    if _same_structure(tree, params):
        return param_specs
    if isinstance(tree, dict):
        return type(tree)((k, tree_specs_like(v, params, param_specs)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_specs_like(v, params, param_specs) for v in tree)
    return PartitionSpec()


def zero1_state_specs(state, specs, mesh, axis: str = "dp_replicate"):
    """Annotation-mode ZeRO-1: a replicated state leaf whose dim 0 divides
    the ``axis`` size is sharded on dim 0 over it; leaves FSDP or TP
    already shard, scalars and leaves that do not divide are kept."""
    size = axis_sizes(mesh).get(axis, 1)
    if size <= 1:
        return specs

    def maybe(leaf, spec):
        if any(d is not None for d in spec):
            return spec
        shape = tuple(getattr(leaf, "shape", ()))
        if len(shape) >= 1 and shape[0] > 0 and shape[0] % size == 0:
            return PartitionSpec(axis)
        return spec

    return _map(maybe, state, specs)


def shard_like_params(tree, mesh, params, param_specs, zero1_axis: Optional[str] = None):
    """Each rank's block of ``tree`` under :func:`tree_specs_like` (and
    :func:`zero1_state_specs` over ``zero1_axis``)."""
    specs = tree_specs_like(tree, params, param_specs)
    if zero1_axis is not None:
        specs = zero1_state_specs(tree, specs, mesh, axis=zero1_axis)
    return _map(lambda x, s: _place(x, s, mesh), tree, specs)


def replicate(tree, mesh):
    """Every rank takes rank 0's value of each leaf (under a process
    group); the tree unchanged without one."""
    from ..utils.operations import broadcast

    return broadcast(_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                          tree))


# ---------------------------------------------------------------------------
# Collectives of a sharded step (plain tensors; one process per device)


def _dist():
    import torch.distributed as dist

    return dist


def _all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    dist = _dist()
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    record_collective("step:all_gather", out.numel() * out.element_size())
    return out.movedim(0, dim)


def _gather_dim(x: torch.Tensor, dim: int, group, dst: int) -> Optional[torch.Tensor]:
    """The ranks' ``x`` concatenated along ``dim`` on the rank at
    coordinate ``dst`` of ``group``; None on the others."""
    dist = _dist()
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    mine = dist.get_rank(group) == dst
    parts = [torch.empty_like(xt) for _ in range(n)] if mine else None
    dist.gather(xt, parts, group=group, group_dst=dst)
    record_collective("step:gather", n * xt.numel() * xt.element_size())
    return torch.cat(parts).movedim(0, dim) if mine else None


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    dist = _dist()
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    record_collective("step:reduce_scatter", xt.numel() * xt.element_size())
    return out.movedim(0, dim)


def global_mean(total: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """A masked mean over the global batch as one rank's share: ``n ·
    total / (count summed over the n batch ranks)``, whose mean over the
    batch ranks (what a sharded step reports, and the mean of whose
    gradients it takes) is the sum of the totals over the sum of the
    counts. Without a mesh, ``total / max(count, 1)``."""
    ranks = 1
    if mesh is not None:
        sizes = axis_sizes(mesh)
        ranks = int(np.prod([sizes.get(a, 1) for a in GRAD_SUM_AXES]))
        if ranks > 1:
            count = all_reduce_axes(count.detach().clone(), mesh, GRAD_SUM_AXES)
    return total * ranks / count.clamp(min=1.0)


def all_reduce_axes(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place (``op``: ``"sum"``, ``"min"`` or ``"max"``)
    over the mesh ``axes`` (one all-reduce per axis of size > 1), and
    returned."""
    dist = _dist()
    reduce_op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                 "max": dist.ReduceOp.MAX}[op]
    for a in axes:
        group = mesh.group(a)
        if group is not None:
            dist.all_reduce(x, op=reduce_op, group=group)
            record_collective("step:all_reduce", x.numel() * x.element_size())
    return x


@dataclass(frozen=True)
class _Layout:
    """How one param is split: ``(dim, axes)`` for every sharded dim."""

    mesh: Any
    dims: tuple  # ((dim, (axis, ...)), ...)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        x = local
        for d, axes in self.dims:
            for a in reversed(axes):  # minor axis first
                x = _all_gather_dim(x, d, self.mesh.group(a))
        return x

    def scatter_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``grad`` (a full-shape gradient of its own
        rows), summed over the batch axes that shard it."""
        x = grad
        for d, axes in self.dims:
            for a in axes:  # major axis first: each narrows to its block
                if a in GRAD_SUM_AXES:
                    x = _reduce_scatter_dim(x, d, self.mesh.group(a))
                else:
                    size = x.shape[d] // self.mesh.shape[a]
                    x = x.narrow(d, self.mesh.coords[a] * size, size)
        return x.contiguous()


class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, layout):
        ctx.layout = layout
        return layout.gather(local)

    @staticmethod
    def backward(ctx, grad):
        return ctx.layout.scatter_grad(grad), None


def _broadcast(x: torch.Tensor, src: int, group, async_op: bool = False):
    """``x`` from the rank at coordinate ``src`` of ``group`` to the rest."""
    work = _dist().broadcast(x, group=group, group_src=src, async_op=async_op)
    record_collective("layer:broadcast", x.numel() * x.element_size())
    return work


class _Pending:
    """One layer group's gather: the buffer the owner broadcasts, the works
    in flight and the broadcast stages still to run."""

    def __init__(self, flat, works, stages, pieces=None):
        self.flat, self.works, self.stages, self.pieces = flat, works, stages, pieces


class _LayerGroup:
    """The stacked leaves of one layout and dtype, gathered and reduced
    together: one collective a stage for all of them on the layer axis."""

    def __init__(self, mesh, dims, leaves, meta: bool = False):
        self.mesh, self.leaves = mesh, leaves
        self.meta = meta  # fp8 meta: never cast to the compute dtype
        self.axes0 = next((axes for d, axes in dims if d == 0), ())
        self.rest = tuple((d - 1, axes) for d, axes in dims if d > 0)
        self.parts = int(np.prod([mesh.shape[a] for a in self.axes0])) if self.axes0 else 1
        self.n_layers = leaves[0].shape[0] * self.parts
        self.shapes = [tuple(t.shape[1:]) for t in leaves]
        self.numels = [int(np.prod(s)) for s in self.shapes]

    def slot(self, i: int):
        """``(row, mine, owner)``: layer ``i``'s row in its owner's block,
        whether this rank holds it, and the owner's coordinate on each axis
        that splits the layer axis."""
        if not self.axes0:
            return i, True, {}
        b, row = divmod(i, self.n_layers // self.parts)
        owner = {}
        for a in reversed(self.axes0):
            b, owner[a] = divmod(b, self.mesh.shape[a])
        return row, all(self.mesh.coords[a] == c for a, c in owner.items()), owner

    def start(self, i: int, async_op: bool) -> _Pending:
        """Issue layer ``i``'s broadcast from its owner (its first stage
        asynchronously with ``async_op``)."""
        row, mine, owner = self.slot(i)
        if not self.axes0:
            return _Pending(None, [], [], pieces=[t[i] for t in self.leaves])
        first = self.leaves[0]
        if mine:
            flat = torch.cat([t[row].reshape(-1) for t in self.leaves])
        else:
            flat = first.new_empty(sum(self.numels))
        stages = [(a, owner[a]) for a in reversed(self.axes0)]  # minor axis first
        works = []
        if async_op:
            a, src = stages.pop(0)
            works.append(_broadcast(flat, src, self.mesh.group(a), async_op=True))
        return _Pending(flat, works, stages)

    def finish(self, pending: _Pending) -> list:
        """The full per-layer tensors of a started gather, in the param
        dtype."""
        if pending.pieces is None:
            for work in pending.works:
                work.wait()
            for a, src in pending.stages:
                _broadcast(pending.flat, src, self.mesh.group(a))
            pieces = [p.view(s) for p, s in zip(pending.flat.split(self.numels), self.shapes)]
        else:
            pieces = pending.pieces
        for d, axes in self.rest:
            for a in reversed(axes):  # minor axis first
                pieces = [_all_gather_dim(p, d, self.mesh.group(a)) for p in pieces]
        return pieces

    def reduce(self, i: int, grads: list) -> None:
        """Add layer ``i``'s gradient (full per-layer tensors of this rank's
        rows) to the rank's block of each leaf's ``.grad``: the other dims as
        :meth:`_Layout.scatter_grad` does, then reduced to the owner over the
        layer axis's batch axes (every rank of any other axis holds the same
        gradient, and only the owner keeps it)."""
        for d, axes in self.rest:
            for a in axes:  # major axis first: each narrows to its block
                if a in GRAD_SUM_AXES:
                    grads = [_reduce_scatter_dim(g, d, self.mesh.group(a)) for g in grads]
                else:
                    n, c = self.mesh.shape[a], self.mesh.coords[a]
                    grads = [g.narrow(d, c * (g.shape[d] // n), g.shape[d] // n) for g in grads]
        row, _, owner = self.slot(i)
        if self.axes0:
            flat = torch.cat([g.reshape(-1) for g in grads])
            for a in self.axes0:
                if a in GRAD_SUM_AXES:
                    _dist().reduce(flat, group=self.mesh.group(a), group_dst=owner[a])
                    record_collective("layer:reduce", flat.numel() * flat.element_size())
                if self.mesh.coords[a] != owner[a]:
                    # the rank's groups on the axes still to reduce share
                    # this coordinate: none of them reaches the owner
                    return
            grads = [g.view(s) for g, s in zip(flat.split([g.numel() for g in grads]), [
                g.shape for g in grads])]
        for t, g in zip(self.leaves, grads):
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            t.grad[row].add_(g)


class _SavedLayerTensor:
    """What a layer's gathered param leaves in the autograd graph in place
    of itself: where to gather it again, and the view that was saved."""

    def __init__(self, key, x):
        self.key = key
        self.view = (tuple(x.shape), x.stride(), x.storage_offset())


class _GatherLayer(torch.autograd.Function):
    """One layer group's gathered params; the backward reduces their
    gradient into the ranks' blocks and returns none to autograd."""

    @staticmethod
    def forward(ctx, stack, i, g, *leaves):
        ctx.stack, ctx.i, ctx.g = stack, i, g
        return tuple(stack._gather(i, g))

    @staticmethod
    def backward(ctx, *grads):
        ctx.stack._reduce(ctx.i, ctx.g, grads)
        return (None, None, None) + (None,) * len(ctx.stack.groups[ctx.g].leaves)


class LayerStack(Mapping):
    """The stacked ``layers`` subtree of a sharded step, gathered one layer
    at a time (see the module docstring): :meth:`layer` gives layer ``i``'s
    params, whole and cast to ``dtype``, :meth:`prefetch` starts a layer's
    gather ahead, and :meth:`saved_tensors_hooks` keeps the gathered params
    out of the autograd graph of a forward without remat. Read as a mapping
    (any model other than ``llama_forward``), an entry is gathered whole,
    as the rest of the tree is. A gathered layer param whose layer axis is
    split carries ``layer_grad_owner``: the coordinate, on each axis that
    splits it, of the rank that keeps its gradient (an op that computes
    part of the gradient on each rank of such an axis, as the MoE FFN's
    experts under ``ep``, may send its part there alone).

    ``stats`` (the plan's ``layer_stats``) counts, for the step, the most
    layers whose gathered params were alive at once (``max_live_layers``)
    and the gathers (``gathers``: forward, prefetched, and again in the
    backward).

    ``grad_hook(group, i, grads)``, when given, takes each layer's gradient
    (one full per-layer tensor for each of ``group.leaves``, in their
    dtype) in place of the reduction into ``.grad``: ``lomo_backward``
    updates layer ``i`` there as its backward ends."""

    def __init__(self, mesh, local, layouts, dtype=None, stats: Optional[dict] = None,
                 grad_hook=None):
        self.local, self.layouts, self.dtype = local, layouts, dtype
        self.grad_hook = grad_hook
        self.stats = stats if stats is not None else {}
        self.stats.update(max_live_layers=0, gathers=0)
        paths: list = []
        _map_with_path(lambda path, x: paths.append(path), local)
        by_key: dict = {}
        for path, x, lay in zip(paths, _leaves(local), _leaves(layouts)):
            dims = lay.dims if lay is not None else ()
            meta = _META_KEY in path.split("/")
            by_key.setdefault((dims, x.dtype, meta), []).append((path, x))
        self.groups, self._where = [], {}
        for (dims, _, meta), members in by_key.items():
            for k, (path, _) in enumerate(members):
                self._where[path] = (len(self.groups), k)
            self.groups.append(_LayerGroup(mesh, dims, [x for _, x in members], meta))
        self._paths = paths
        self.n_layers = self.groups[0].n_layers
        self._pending: dict = {}  # (i, g) -> _Pending
        self._cache: dict = {}  # (i, g) -> outputs gathered again in the backward
        self._registry: dict = {}  # storage address -> (i, g, k) of a live output
        self._live: dict = {}  # layer -> live gathered tensors

    # -- the mapping (a model that reads the stack whole) --
    def __getitem__(self, key):
        full = _map(lambda x, lay: x if lay is None else _GatherParam.apply(x, lay),
                    self.local[key], self.layouts[key])
        return _map_with_path(
            lambda path, x: x if self.dtype is None or _META_KEY in path.split("/")
            else x.to(self.dtype), full, str(key))

    def __iter__(self):
        return iter(self.local)

    def __len__(self) -> int:
        return len(self.local)

    # -- one layer at a time --
    def _track(self, t: torch.Tensor, i: int) -> None:
        self._live[i] = self._live.get(i, 0) + 1
        live = sum(1 for n in self._live.values() if n > 0)
        self.stats["max_live_layers"] = max(self.stats["max_live_layers"], live)
        weakref.finalize(t, self._untrack, i)

    def _untrack(self, i: int) -> None:
        self._live[i] -= 1

    def prefetch(self, i: int) -> None:
        """Start layer ``i``'s gather (a no-op past the last layer)."""
        if i >= self.n_layers:
            return
        for g, group in enumerate(self.groups):
            if (i, g) not in self._pending and group.axes0:
                pending = group.start(i, async_op=True)
                self._track(pending.flat, i)
                self._pending[(i, g)] = pending

    def _gather(self, i: int, g: int) -> list:
        # out of sight of any dispatch mode (a selective checkpoint's cache
        # matches the recompute's ops to the forward's, and the forward may
        # have started this gather before its region)
        with _disable_current_modes():
            return self._gather_unseen(i, g)

    def _gather_unseen(self, i: int, g: int) -> list:
        group = self.groups[g]
        pending = self._pending.pop((i, g), None) or group.start(i, async_op=False)
        self.stats["gathers"] += 1
        outs = []
        for k, piece in enumerate(group.finish(pending)):
            out = piece.to(self.dtype) if self.dtype is not None and not group.meta else piece
            if out._base is not None:  # each output owns its storage: pack finds it there
                out = out.clone(memory_format=torch.contiguous_format)
            if group.axes0:
                out.layer_grad_owner = group.slot(i)[2]
            self._registry[out.untyped_storage().data_ptr()] = (i, g, k)
            weakref.finalize(out, self._registry.pop, out.untyped_storage().data_ptr(), None)
            self._track(out, i)
            outs.append(out)
        return outs

    def _reduce(self, i: int, g: int, grads) -> None:
        self._cache.pop((i, g), None)
        group = self.groups[g]
        grads = [torch.zeros(s, dtype=t.dtype, device=t.device) if gr is None
                 else gr.to(t.dtype) for gr, s, t in zip(grads, group.shapes, group.leaves)]
        if self.grad_hook is not None:
            self.grad_hook(group, i, grads)
        else:
            group.reduce(i, grads)

    def layer(self, i: int) -> dict:
        """Layer ``i``'s params (the tree of one layer), gathered: an
        autograd op whose backward reduces their gradient."""
        flat = {}
        for g, group in enumerate(self.groups):
            for k, out in enumerate(_GatherLayer.apply(self, i, g, *group.leaves)):
                flat[(g, k)] = out
        it = iter(self._paths)
        return _map(lambda _: flat[self._where[next(it)]], self.local)

    # -- the gathered params out of the graph of a forward without remat --
    def _pack(self, x):
        if isinstance(x, torch.Tensor) and x.layout == torch.strided:
            key = self._registry.get(x.untyped_storage().data_ptr())
            if key is not None:
                return _SavedLayerTensor(key, x)
        return x

    def _unpack(self, x):
        if not isinstance(x, _SavedLayerTensor):
            return x
        i, g, k = x.key
        outs = self._cache.get((i, g))
        if outs is None:
            with torch.no_grad():
                outs = self._cache[(i, g)] = self._gather(i, g)
        return outs[k].as_strided(*x.view)

    def saved_tensors_hooks(self):
        """A context in which autograd saves, in place of a gathered layer
        param, a handle that gathers it again in the backward (once a
        layer, dropped when that layer's gradient is reduced)."""
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)


@dataclass
class ShardingPlan:
    """One resolved sharding decision for a prepared model: the param
    specs (the gradients share them), the ZeRO-1 axis asked for, and the
    fused ZeRO-1 bucket plan when that path is on."""

    mesh: Any
    parallelism_config: Optional[ParallelismConfig]
    rules: Optional[ShardingRules]
    param_specs: Any
    zero1_axis: Optional[str] = None
    zero1: Optional[Any] = None  # Zero1BucketPlan when the fused path is on
    # the last step's per-layer gather counts (see LayerStack)
    layer_stats: dict = field(default_factory=dict)
    # leaf indices (tree order) of the fp8 meta that the optimizer replaces:
    # its gradients are no part of the bound params' collectives
    meta_indices: tuple = ()

    @property
    def grad_specs(self):
        return self.param_specs

    def bound_specs(self) -> list:
        """The specs of the leaves the optimizer updates (tree order): all
        but :attr:`meta_indices`."""
        skip = set(self.meta_indices)
        return [s for i, s in enumerate(_leaves(self.param_specs)) if i not in skip]

    @property
    def fused_zero1(self) -> bool:
        return self.zero1 is not None

    @property
    def batch_ranks(self) -> int:
        """How many ranks split the global batch's tokens (the rows over
        the data-parallel axes, the sequence over ``cp`` or ``sp``)."""
        sizes = axis_sizes(self.mesh)
        return int(np.prod([sizes.get(a, 1) for a in GRAD_SUM_AXES]))

    @property
    def sharded(self) -> bool:
        """True when some param is split over a mesh axis."""
        return any(len(s) for s in _leaves(self.param_specs))

    @property
    def distributed(self) -> bool:
        """True when a step needs a collective: a sharded param, more than
        one batch rank, or fused ZeRO-1. A plan on a mesh of size-1 axes is
        not: its step is the plain step."""
        return self.sharded or self.batch_ranks > 1 or self.fused_zero1

    def check_supported(self) -> None:
        """Raise for a mesh the port's sharded step does not run yet: a
        ``pp`` axis (ROADMAP.md Queue A item 11b)."""
        sizes = axis_sizes(self.mesh)
        if sizes.get("pp", 1) > 1:
            raise NotImplementedError(f"a pp axis of size {sizes['pp']} is not ported yet "
                                      "(ROADMAP.md Queue A item 11b: pipelines)")

    def layouts(self):
        """The :class:`_Layout` tree of the params (``None`` for a param
        that is not split)."""
        def layout(spec):
            dims = tuple((d, _dim_axes(e)) for d, e in enumerate(spec) if e is not None)
            return _Layout(self.mesh, dims) if dims else None

        return _map(layout, self.param_specs)

    def place_params(self, params, device=None):
        """Each rank's block of every param, on ``device``."""
        placed, _ = shard_params(params, self.mesh, specs=self.param_specs, device=device)
        return placed

    def gather_params(self, params, dtype: Optional[torch.dtype] = None):
        """The full value of every param, through an autograd function whose
        backward leaves each sharded param's block of the gradient; a
        stacked ``layers`` subtree with a split leaf comes as a
        :class:`LayerStack` of ``dtype`` (see the module docstring)."""
        layouts = self.layouts()
        stack = None
        if (isinstance(params, dict) and isinstance(params.get("layers"), dict)
                and any(lay is not None for lay in _leaves(layouts["layers"]))):
            stack = LayerStack(self.mesh, params["layers"], layouts["layers"], dtype,
                               stats=self.layer_stats)
        full = _map(lambda x, lay: x if lay is None else _GatherParam.apply(x, lay),
                    {k: v for k, v in params.items() if k != "layers"} if stack else params,
                    {k: v for k, v in layouts.items() if k != "layers"} if stack else layouts)
        if stack is None:
            return full
        return {k: stack if k == "layers" else full[k] for k in params}

    def gather_params_no_grad(self, params):
        with torch.no_grad():
            return _map(lambda x, lay: x if lay is None else lay.gather(x),
                        params, self.layouts())

    def reduce_grads(self, grads: list) -> list:
        """``grads`` (one per param leaf, in tree order, after the backward)
        summed over the batch axes that do not shard each param: one
        all-reduce per group of params with the same axes and dtype."""
        specs = self.bound_specs()
        sizes = axis_sizes(self.mesh)
        groups: dict = {}
        for i, (g, spec) in enumerate(zip(grads, specs)):
            rest = tuple(a for a in GRAD_SUM_AXES
                         if sizes.get(a, 1) > 1 and a not in _spec_axes(spec))
            if rest:
                groups.setdefault((rest, g.dtype), []).append(i)
        out = list(grads)
        for (rest, _), idx in groups.items():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            all_reduce_axes(flat, self.mesh, rest)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                out[i] = part.view_as(grads[i])
        return out

    def mean_over_batch(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over the batch ranks (a copy)."""
        n = self.batch_ranks
        if n == 1:
            return x
        return all_reduce_axes(x.detach().clone(), self.mesh, GRAD_SUM_AXES) / n

    def split_axes(self, spec) -> tuple:
        """The mesh axes (of size > 1) that split a param of ``spec``, in
        mesh order."""
        return tuple(a for a in axis_sizes(self.mesh) if a in _spec_axes(spec)
                     and self.mesh.shape[a] > 1)

    def leaf_splits(self, leaves: list) -> tuple:
        """``(shapes, dim_axes)`` of param blocks ``leaves`` (tree order):
        each param's global shape and, per dim, the mesh axes (of size > 1)
        that split it."""
        shapes, dim_axes = [], []
        for x, spec in zip(leaves, self.bound_specs()):
            axes = tuple(tuple(a for a in _dim_axes(spec[d]) if self.mesh.shape[a] > 1)
                         if d < len(spec) else () for d in range(x.dim()))
            dim_axes.append(axes)
            shapes.append(tuple(n * int(np.prod([self.mesh.shape[a] for a in ax]))
                                for n, ax in zip(x.shape, axes)))
        return shapes, dim_axes

    def leaf_sumsq(self, grads: list) -> list:
        """Each full gradient's sum of squares (f32) from the ranks' blocks:
        each block's sum, summed over the axes that split its param (one
        all-reduce per group of leaves split alike)."""
        specs = self.bound_specs()
        out = [torch.sum(g.float() * g.float()) for g in grads]
        groups: dict = {}
        for i, spec in enumerate(specs):
            axes = self.split_axes(spec)
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            summed = all_reduce_axes(torch.stack([out[i] for i in idx]), self.mesh, axes)
            for i, s in zip(idx, summed.unbind()):
                out[i] = s
        return out

    def global_sumsq(self, grads: list) -> torch.Tensor:
        """The sum of squares of the full gradients from the ranks' blocks."""
        return torch.stack(self.leaf_sumsq(grads)).sum()

    def zero1_collective_bytes(self) -> Optional[dict]:
        """Bytes the fused update moves a step (None when it is off)."""
        if not self.fused_zero1:
            return None
        n = self.zero1.collective_bytes
        return {"reduce_scatter": n, "all_gather": n}


def make_sharding_plan(params, mesh, parallelism_config: Optional[ParallelismConfig] = None,
                       rules: Optional[ShardingRules] = None, zero1_axis: Optional[str] = None,
                       zero1_fused: Optional[bool] = None,
                       zero1_bucket_bytes: Optional[int] = None, min_fsdp_size: int = 2 ** 10,
                       param_specs=None) -> ShardingPlan:
    """The one spec decision for a model. Fused ZeRO-1 is on when
    ``zero1_axis`` names an axis of size > 1, every param is floating and
    every param is replicated (pure data parallelism); ``zero1_fused=False``
    or ``ACCELERATE_ZERO1_FUSED=0`` turns it off."""
    sizes = axis_sizes(mesh)
    if param_specs is None:
        param_specs = infer_param_specs(params, mesh, parallelism_config, rules,
                                        min_fsdp_size=min_fsdp_size)
    else:
        param_specs = _map(lambda s: None if s is None else canonicalize_spec(s, sizes),
                           param_specs)
    plan = ShardingPlan(mesh=mesh, parallelism_config=parallelism_config, rules=rules,
                        param_specs=param_specs, zero1_axis=zero1_axis)
    if zero1_axis is None or sizes.get(zero1_axis, 1) <= 1:
        return plan
    if zero1_fused is None:
        from ..utils.environment import parse_flag_from_env

        zero1_fused = parse_flag_from_env("ACCELERATE_ZERO1_FUSED", default=True)
    if not zero1_fused:
        return plan
    if plan.sharded:
        return plan  # composite mesh: ZeRO-1 by annotation (optimizer.AnnotatedZero1)
    from .weight_update import build_bucket_plan

    try:
        # fp8 meta rides beside the buckets as passthrough slots (its
        # gradient is its new value), so the fused path stays engaged
        plan.zero1 = build_bucket_plan(params, zero1_axis, sizes[zero1_axis],
                                       bucket_bytes=zero1_bucket_bytes,
                                       passthrough=lambda path: _META_KEY in path)
    except ValueError:
        plan.zero1 = None
    return plan


def llama_tp_rules() -> ShardingRules:
    """Megatron-style rules for ``[in, out]`` kernels: column-parallel
    QKV and up, row-parallel out and down, vocab-parallel embedding and
    head. On the stacked ``[L, in, out]`` tree they land one dim to the
    left (ROADMAP.md Queue C records what each shards), as in the JAX
    package."""
    return ShardingRules([
        (r"(wq|wk|wv|q_proj|k_proj|v_proj|qkv)/kernel", P(None, "tp")),
        (r"(wo|o_proj|out_proj)/kernel", P("tp", None)),
        (r"(w1|gate_proj|up_proj|w3|fc1)/kernel", P(None, "tp")),
        (r"(w2|down_proj|fc2)/kernel", P("tp", None)),
        (r"(embed_tokens|wte|embedding)/(embedding|kernel)", P("tp", None)),
        (r"lm_head/kernel", P(None, "tp")),
    ])


# ---------------------------------------------------------------------------
# Optimizer state offloaded to host memory (ZeRO-Offload, FSDP cpu_offload)


def _offloadable(v) -> bool:
    """A state tensor that lives on the host between steps: any tensor with
    a dim (step counts and other scalars stay where the optimizer keeps
    them)."""
    return isinstance(v, torch.Tensor) and v.dim() > 0


class OptimizerOffload:
    """The optimizer state of one torch optimizer in pinned host memory
    between steps: the port of the JAX package's
    ``make_host_offloaded_step``, whose XLA program stages the state into
    device memory and commits it back inside the step.

    Every state tensor with a dim (AdamW's ``exp_avg``/``exp_avg_sq``,
    adafactor's factored moments, SGD's trace; of the tensors the optimizer
    owns: a rank's blocks, ZeRO-1 rows or chunks) is held on the host;
    scalars (AdamW's step counts) stay where the optimizer keeps them. The
    port keeps the fp16 loss scale on the ``AcceleratedOptimizer``, not in
    the optimizer's state, so it is not offloaded. :meth:`step` runs the
    optimizer's own ``step`` group by group:

    - a group is a run of params whose state holds at most ``group_bytes``.
      An elementwise optimizer (``elementwise=True``: AdamW, Adam, SGD) may
      take a param in blocks of rows, each updated through a view of the
      param, its gradient and its state (the same per-element arithmetic);
      any other (adafactor: its statistics span a whole param) takes whole
      params, a param larger than the bound forming a group of its own;
    - two device buffers alternate: group ``i+1`` is copied host to device
      on a side stream while group ``i`` is updated on the current stream;
      group ``i`` is then copied back device to host on the side stream,
      after an event that marks its update, and before group ``i+2`` is
      copied into the same buffer; each copy waits for an event of what it
      reads, and a copy into a buffer waits for the work queued on the
      current stream before it (the caching allocator may hand the buffer
      memory that work still reads). So at most two groups' state is on the device at any time
      (a state tensor the optimizer allocates anew, as adafactor's moving
      averages, joins its group until copied back; ``record_stream`` keeps
      it for the side stream's copy).

    A group holds at most :attr:`GROUP_BYTES`, 128 MiB: the two buffers then hold
    256 MiB, under 4 % of config #4's 6.88 GB of AdamW state, while each
    copy (about 5 ms over PCIe 5) is long enough that its launch and the
    group's Python work (under 1 ms) stay small beside it. The first step
    creates the state on the device and moves it to the host. The step
    waits for the last copy back before it returns, so the host state is
    complete when the caller reads it. On the CPU the same code runs with
    copies from the CPU to the CPU and no streams."""

    GROUP_BYTES = 128 << 20
    ALIGN = 256

    def __init__(self, optimizer: torch.optim.Optimizer, device, elementwise: bool):
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.elementwise = elementwise
        self.group_bytes = self.GROUP_BYTES
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.stats = {"steps": 0, "groups": 0, "h2d_bytes": 0, "d2h_bytes": 0}
        with torch.no_grad():
            for st in optimizer.state.values():
                for k, v in list(st.items()):
                    if _offloadable(v) and not self._on_host(v):
                        st[k] = self._host_like(v.shape, v.dtype).copy_(v)

    # -- where the state lives --
    def _on_host(self, v: torch.Tensor) -> bool:
        return v.device.type == "cpu" and (not self.cuda or v.is_pinned())

    def _host_like(self, shape, dtype) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.cuda)

    def host_bytes(self) -> int:
        """Bytes of offloaded state on the host."""
        return sum(v.numel() * v.element_size() for st in self.optimizer.state.values()
                   for v in st.values() if _offloadable(v))

    # -- the plan --
    def _state_bytes(self, p) -> int:
        st = self.optimizer.state.get(p, {})
        held = sum(v.numel() * v.element_size() for v in st.values() if _offloadable(v))
        return held or 2 * p.numel() * p.element_size()  # the first step: AdamW's two moments

    def _items(self, params: list) -> list:
        """``(index, rows, bytes)`` of each piece of the update: a whole
        param (``rows`` None) or a block of its rows."""
        items = []
        for i, p in enumerate(params):
            nbytes = self._state_bytes(p)
            if (self.elementwise and p.dim() >= 1 and p.shape[0] > 1
                    and nbytes > self.group_bytes):
                per_row = nbytes / p.shape[0]
                step = max(1, int(self.group_bytes // per_row))
                for a in range(0, p.shape[0], step):
                    b = min(a + step, p.shape[0])
                    items.append((i, slice(a, b), int(per_row * (b - a))))
            else:
                items.append((i, None, nbytes))
        return items

    def _groups(self, items: list) -> list:
        groups, cur, held = [], [], 0
        for item in items:
            if cur and held + item[2] > self.group_bytes:
                groups.append(cur)
                cur, held = [], 0
            cur.append(item)
            held += item[2]
        return groups + ([cur] if cur else [])

    # -- staging --
    def _stage(self, params: list, grads: Optional[list], group: list, slot: int,
               before: list):
        """Copy one group's host state into device buffer ``slot`` (on the
        side stream when there is one) and give each piece its target: the
        param itself or a view of its rows, with the view's state and
        gradient. ``before`` holds, per param, its scalar state and the keys
        of its offloaded state as they were when the update began."""
        sizes = []
        for i, rows, _ in group:
            for k, v in self.optimizer.state.get(params[i], {}).items():
                if k in before[i][1]:
                    n = (v[rows] if rows is not None else v).numel() * v.element_size()
                    sizes.append(-(-n // self.ALIGN) * self.ALIGN)
        total = sum(sizes)
        buf = self._buffers[slot]
        if total and (buf is None or buf.numel() < total):
            buf = self._buffers[slot] = torch.empty(total, dtype=torch.uint8,
                                                    device=self.device)
        pieces, offset = [], 0
        if self.stream is not None:
            # the buffer's memory may have been freed by work still queued on
            # the current stream: the copies into it wait for that work
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._side():
            for i, rows, _ in group:
                p = params[i]
                host = self.optimizer.state.get(p, {})
                target = p if rows is None else p.detach()[rows]
                staged, host_refs = {}, {}
                # the state as it was before this update: a block of a param
                # that an earlier group already wrote back reads the same
                # scalars, and one whose state is not made yet none at all
                held_scalars, held_keys = before[i]
                for k, v in host.items():
                    if k in held_keys:
                        host_refs[k] = v
                        src = v[rows] if rows is not None else v
                        n = src.numel() * src.element_size()
                        dst = buf[offset:offset + n].view(src.dtype).view(src.shape)
                        offset += -(-n // self.ALIGN) * self.ALIGN
                        dst.copy_(src, non_blocking=True)
                        staged[k] = dst
                        self.stats["h2d_bytes"] += n
                if rows is not None:  # a view takes a copy of the step count
                    for k, v in held_scalars.items():
                        staged[k] = v.clone() if isinstance(v, torch.Tensor) else v
                grad = None
                if grads is not None:
                    grad = grads[i] if rows is None else grads[i][rows]
                elif rows is not None and p.grad is not None:
                    grad = p.grad[rows]
                pieces.append((i, rows, target, staged, grad, host_refs))
        event = self.stream.record_event() if self.stream is not None else None
        return pieces, event

    def _side(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _write_back(self, params: list, pieces: list) -> None:
        """Copy a group's updated state to the host (on the side stream) and
        put the host tensors back into the optimizer's state."""
        state = self.optimizer.state
        with self._side():
            for i, rows, target, _, _, host_refs in pieces:
                p = params[i]
                held = state.setdefault(p, {})
                updated = dict(held) if target is p else state.pop(target)
                for k, v in updated.items():
                    if not _offloadable(v):
                        held[k] = v  # a scalar: the optimizer's own, or the view's copy
                        continue
                    whole = host_refs.get(k)
                    if whole is None and rows is not None and _offloadable(held.get(k)):
                        whole = held[k]  # made by an earlier block of the same param
                    if whole is None:  # the first step made this state on the device
                        shape = v.shape if rows is None else (p.shape[0], *v.shape[1:])
                        whole = self._host_like(shape, v.dtype)
                    if self.stream is not None:
                        v.record_stream(self.stream)
                    (whole if rows is None else whole[rows]).copy_(v, non_blocking=True)
                    held[k] = whole
                    self.stats["d2h_bytes"] += v.numel() * v.element_size()

    @torch.no_grad()
    def step(self, grads: Optional[list] = None) -> None:
        """One update of the optimizer (``grads``, one per param, for an
        optimizer that takes them; else each param's ``.grad``), staged
        group by group as the class docstring says."""
        opt = self.optimizer
        saved = opt.param_groups
        params = [p for g in saved for p in g["params"]]
        owner = {id(p): k for k, g in enumerate(saved) for p in g["params"]}
        groups = self._groups(self._items(params))
        self._buffers = [None, None]
        main = torch.cuda.current_stream(self.device) if self.cuda else None
        takes_grads = grads is not None
        before = []
        for p in params:
            st = opt.state.get(p, {})
            before.append(({k: v.clone() if isinstance(v, torch.Tensor) else v
                            for k, v in st.items() if not _offloadable(v)},
                           {k for k, v in st.items() if _offloadable(v)}))
        staged = self._stage(params, grads, groups[0], 0, before) if groups else None
        try:
            for gi, group in enumerate(groups):
                pieces, ready = staged
                if gi + 1 < len(groups):  # the next group's copy runs beside this update
                    staged = self._stage(params, grads, groups[gi + 1], (gi + 1) % 2, before)
                if ready is not None:
                    main.wait_event(ready)
                opt.param_groups = [dict(g, params=[]) for g in saved]
                sub_grads = []
                for i, rows, target, st, grad, _ in pieces:
                    opt.param_groups[owner[id(params[i])]]["params"].append(target)
                    if rows is None:
                        opt.state[target].update(st)
                    else:
                        opt.state[target] = st
                        if not takes_grads:
                            target.grad = grad
                    sub_grads.append(grad)
                if takes_grads:
                    opt.step(grads=sub_grads)
                else:
                    opt.step()
                for _, rows, target, _, _, _ in pieces:
                    if rows is not None:
                        target.grad = None
                opt.param_groups = saved
                if main is not None:
                    self.stream.wait_event(main.record_event())
                self._write_back(params, pieces)
                self.stats["groups"] += 1
        finally:
            opt.param_groups = saved
        if self.stream is not None:
            self.stream.synchronize()
        self._buffers = [None, None]
        self.stats["steps"] += 1

