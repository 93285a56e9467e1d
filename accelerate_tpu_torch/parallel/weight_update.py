"""Fused cross-replica weight-update sharding (ZeRO-1): the port of
``accelerate_tpu.parallel.weight_update``.

1. **Bucket**: the params are flattened and packed, in the JAX package's
   leaf order (dict keys sorted), into dtype-homogeneous buckets of at
   most ``bucket_bytes`` (:class:`Zero1BucketPlan`), each padded to a
   multiple of the replicate axis size. Names, sizes and
   ``collective_bytes`` are the JAX package's.
2. **Reduce-scatter**: after the backward, each bucket of gradients is
   summed over the other batch axis and reduce-scattered over the
   replicate axis: each rank keeps the sum of its ``1/N`` chunk.
3. **Shard-local update**: the optimizer owns only the chunks
   (:meth:`FusedZero1Update.chunks`), so its state and its math are
   ``1/N`` a rank. The transform is whatever the optimizer is, applied to
   the chunk, as the JAX package's ``tx.update`` on the chunk is.
4. **All-gather**: after each update the chunks are gathered back into
   the buckets, and the buckets unpacked into the replicated params, in
   place.

The JAX package's ``hlo_collective_bytes`` has no counterpart (there is
no HLO): the port counts what it sends, under ``step:reduce_scatter`` and
``step:all_gather`` in :func:`~..utils.operations.get_comm_counters`.
``ACCELERATE_ZERO1_FUSED=0`` turns the fused path off, as in the JAX
package; ``ACCELERATE_ZERO1_BUCKET_MB`` sets the bucket size.

Leaves that a ``passthrough`` predicate picks (the fp8 delayed-scaling
meta, whose gradient is its new value) stay out of the buckets, the
optimizer and the collectives: the plan lists them in
``passthrough_indices`` and the optimizer installs their gradient as it
is (:meth:`~..optimizer.AcceleratedOptimizer.install_meta`), as the JAX
package's fused update does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.operations import record_collective

__all__ = [
    "BUCKET_BYTES_ENV",
    "DEFAULT_BUCKET_BYTES",
    "FusedZero1Incompatible",
    "FusedZero1Update",
    "Zero1BucketPlan",
    "bucket_bytes_from_env",
    "build_bucket_plan",
    "init_bucketed_opt_state",
    "make_fused_zero1_update",
    "self_check",
]

DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024
BUCKET_BYTES_ENV = "ACCELERATE_ZERO1_BUCKET_MB"


class FusedZero1Incompatible(ValueError):
    """The fused path cannot run this model or optimizer."""


def bucket_bytes_from_env(default: int = DEFAULT_BUCKET_BYTES) -> int:
    raw = os.environ.get(BUCKET_BYTES_ENV, "").strip()
    if not raw:
        return default
    try:
        return max(1, int(float(raw) * 1024 * 1024))
    except ValueError:
        return default


@dataclass(frozen=True)
class _LeafSlot:
    """Where one param leaf lives in the buckets."""

    leaf_index: int  # position among the bucketed leaves (the port's tree order)
    bucket: str
    offset: int  # element offset into the bucket
    size: int
    shape: tuple
    dtype: str


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclass
class Zero1BucketPlan:
    """Static layout of the bucketed update for one param tree."""

    axis: str
    axis_size: int
    slots: list
    bucket_sizes: dict  # padded element counts
    bucket_dtypes: dict  # torch dtype per bucket
    n_elements: int = 0
    # positions among all param leaves (the port's tree order) of the leaves
    # kept out of the buckets; the slots index the others
    passthrough_indices: tuple = ()

    @property
    def bucket_names(self) -> list:
        return list(self.bucket_sizes)

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    def chunk_size(self, name: str) -> int:
        return self.bucket_sizes[name] // self.axis_size

    @property
    def bucket_nbytes(self) -> dict:
        return {name: size * torch.empty((), dtype=self.bucket_dtypes[name]).element_size()
                for name, size in self.bucket_sizes.items()}

    @property
    def collective_bytes(self) -> int:
        """Bytes moved per update in one direction (the reduce-scatter of
        the gradient buckets; the all-gather moves as many)."""
        return sum(self.bucket_nbytes.values())

    def bucket_tree(self, leaves: list) -> dict:
        """``{bucket: 1-D tensor}`` from the bucketed leaves (tree order,
        without the passthrough ones); padding is zeros."""
        parts: dict = {name: [] for name in self.bucket_sizes}
        filled = dict.fromkeys(self.bucket_sizes, 0)
        for slot in self.slots:
            parts[slot.bucket].append(leaves[slot.leaf_index].reshape(-1))
            filled[slot.bucket] += slot.size
        out = {}
        for name, pieces in parts.items():
            pad = self.bucket_sizes[name] - filled[name]
            if pad:
                pieces.append(pieces[0].new_zeros(pad))
            out[name] = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        return out

    def unbucket_tree(self, buckets: dict) -> list:
        """The param leaves (tree order) as views of the buckets."""
        leaves: list = [None] * len(self.slots)
        for slot in self.slots:
            leaves[slot.leaf_index] = buckets[slot.bucket][
                slot.offset:slot.offset + slot.size].view(slot.shape)
        return leaves

    def bucket_specs(self) -> dict:
        from .sharding import PartitionSpec

        return {name: PartitionSpec(self.axis) for name in self.bucket_sizes}


def _sorted_paths(tree) -> list:
    """``(path, leaf index, leaf)`` in the JAX package's flatten order
    (dict keys sorted); the index is the leaf's place in the port's tree
    order (insertion order)."""
    out = []

    def visit(node, path):
        if isinstance(node, dict):
            children = node.items()
        elif isinstance(node, (list, tuple)):
            children = enumerate(node)
        else:
            out.append((path, len(out), node))
            return
        for k, v in children:
            visit(v, path + (k,))

    visit(tree, ())
    out.sort(key=lambda item: tuple((0, k) if isinstance(k, int) else (1, str(k))
                                    for k in item[0]))
    return out


def build_bucket_plan(params, axis: str, axis_size: int, bucket_bytes: Optional[int] = None,
                      passthrough=None) -> Zero1BucketPlan:
    """Pack every param leaf greedily, in the JAX package's leaf order,
    into a bucket of its dtype; a bucket closes when the next leaf would
    take it past ``bucket_bytes``. Raises ``ValueError`` for a leaf that
    is not floating. ``passthrough`` (a predicate over a leaf's path, the
    tuple of its keys) keeps a leaf out of the buckets."""
    if bucket_bytes is None:
        bucket_bytes = bucket_bytes_from_env()
    paths = _sorted_paths(params)
    skipped = sorted(index for path, index, _ in paths
                     if passthrough is not None and passthrough(path))
    # a bucketed leaf's index among the bucketed leaves, in the port's order
    skip = set(skipped)
    rank = {index: r for r, index in enumerate(i for i in range(len(paths)) if i not in skip)}
    slots = []
    bucket_sizes: dict = {}
    bucket_dtypes: dict = {}
    open_bucket: dict = {}
    fill: dict = {}
    total = 0
    for path, index, leaf in paths:
        if index not in rank:
            continue
        if isinstance(leaf, torch.Tensor):
            dtype, shape = leaf.dtype, tuple(leaf.shape)
        else:
            arr = np.asarray(leaf)
            dtype, shape = torch.from_numpy(np.zeros(0, arr.dtype)).dtype, arr.shape
        if not dtype.is_floating_point:
            raise ValueError(f"fused ZeRO-1 needs floating-point params; leaf "
                             f"{'/'.join(map(str, path))} is {dtype}")
        size = int(np.prod(shape))
        itemsize = torch.empty((), dtype=dtype).element_size()
        total += size
        key = _dtype_name(dtype)
        name = open_bucket.get(key)
        if name is not None and (fill[name] + size) * itemsize > bucket_bytes and fill[name] > 0:
            name = None
        if name is None:
            name = f"b{len(bucket_sizes):03d}"
            open_bucket[key] = name
            bucket_sizes[name] = 0
            bucket_dtypes[name] = dtype
            fill[name] = 0
        slots.append(_LeafSlot(leaf_index=rank[index], bucket=name, offset=fill[name],
                               size=size, shape=shape, dtype=key))
        fill[name] += size
    for name, n in fill.items():
        bucket_sizes[name] = -(-n // axis_size) * axis_size
    return Zero1BucketPlan(axis=axis, axis_size=axis_size, slots=slots,
                           bucket_sizes=bucket_sizes, bucket_dtypes=bucket_dtypes,
                           n_elements=total, passthrough_indices=tuple(skipped))


class FusedZero1Update:
    """The fused update of one prepared model: ``params`` are the
    replicated bucketed leaves (tree order, without the passthrough ones);
    :attr:`chunks` are this rank's ``1/N`` of each bucket, the tensors the
    optimizer owns."""

    def __init__(self, plan: Zero1BucketPlan, mesh, params: list):
        if len(params) != len(plan.slots):
            raise FusedZero1Incompatible(f"the plan is for {len(plan.slots)} leaves, the model "
                                         f"has {len(params)}")
        self.plan = plan
        self.mesh = mesh
        self.params = params
        self.index = mesh.coords[plan.axis] if plan.axis_size > 1 else 0
        with torch.no_grad():
            buckets = plan.bucket_tree([p.detach() for p in params])
            self.chunks = [self._my_chunk(buckets[n], n).clone() for n in plan.bucket_names]

    def _my_chunk(self, bucket: torch.Tensor, name: str) -> torch.Tensor:
        c = self.plan.chunk_size(name)
        return bucket[self.index * c:(self.index + 1) * c]

    def reduce_scatter(self, grads: list, other_axes: tuple = ()) -> torch.Tensor:
        """The gradients (one per param, tree order) summed over the batch
        ranks, as this rank's chunks concatenated in bucket order: a sum
        over ``other_axes``, then a reduce-scatter over the replicate
        axis, per bucket."""
        from .sharding import all_reduce_axes

        dist = None
        group = self.mesh.group(self.plan.axis) if self.plan.axis_size > 1 else None
        if group is not None:
            import torch.distributed as dist
        out = []
        for name, bucket in self.plan.bucket_tree(grads).items():
            bucket = bucket.contiguous()
            all_reduce_axes(bucket, self.mesh, other_axes)
            if group is None:
                out.append(bucket)
                continue
            chunk = bucket.new_empty(self.plan.chunk_size(name))
            dist.reduce_scatter_tensor(chunk, bucket, group=group)
            record_collective("step:reduce_scatter", bucket.numel() * bucket.element_size())
            out.append(chunk)
        return torch.cat(out) if len(out) > 1 else out[0]

    @torch.no_grad()
    def all_gather(self) -> None:
        """The updated chunks gathered into the buckets, written into the
        params in place."""
        group = self.mesh.group(self.plan.axis) if self.plan.axis_size > 1 else None
        buckets = {}
        for name, chunk in zip(self.plan.bucket_names, self.chunks):
            if group is None:
                buckets[name] = chunk
                continue
            import torch.distributed as dist

            full = chunk.new_empty(self.plan.bucket_sizes[name])
            dist.all_gather_into_tensor(full, chunk, group=group)
            record_collective("step:all_gather", full.numel() * full.element_size())
            buckets[name] = full
        for p, new in zip(self.params, self.plan.unbucket_tree(buckets)):
            p.copy_(new)


def init_bucketed_opt_state(factory, params: list, plan: Zero1BucketPlan, mesh):
    """``(optimizer, update)``: the optimizer ``factory`` makes over this
    rank's chunks, and the :class:`FusedZero1Update` that owns them."""
    update = FusedZero1Update(plan, mesh, params)
    return factory(update.chunks), update


def make_fused_zero1_update(plan: Zero1BucketPlan, mesh, params: list) -> FusedZero1Update:
    return FusedZero1Update(plan, mesh, params)


def self_check(bucket_bytes: int = 1 << 12, device: str = "cpu") -> dict:
    """One fused AdamW step of a two-layer model against the plain AdamW
    step on the full params, over the running process group's ranks as the
    replicate axis (or one rank without a group): the plan's collective
    bytes, the bytes counted, this rank's share of the optimizer state and
    the largest difference of the updated params."""
    import torch.distributed as dist

    from ..optimizer import adamw, state_bytes
    from ..parallelism_config import ParallelismConfig
    from ..utils.operations import get_comm_counters, reset_comm_counters

    live = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if live else 1
    mesh = ParallelismConfig(dp_replicate_size=n).build_mesh(n, device_type=torch.device(
        device).type)
    gen = torch.Generator().manual_seed(0)
    params = [(torch.randn(64, 32, generator=gen) * 0.1).to(device),
              (torch.randn(32, 8, generator=gen) * 0.1).to(device)]
    batch = torch.ones(16, 64, device=device) * (mesh.rank + 1)
    plan = build_bucket_plan({"w1": params[0], "w2": params[1]}, "dp_replicate", n, bucket_bytes)

    def grads_of(ps, x):
        ps = [p.detach().requires_grad_(True) for p in ps]
        loss = torch.mean((torch.tanh(x @ ps[0]) @ ps[1]) ** 2)
        return torch.autograd.grad(loss, ps)

    fused_params = [p.clone() for p in params]
    opt, update = init_bucketed_opt_state(adamw(1e-3), fused_params, plan, mesh)
    reset_comm_counters()
    flat = update.reduce_scatter(list(grads_of(fused_params, batch))) / n
    for chunk, g in zip(update.chunks, flat.split([c.numel() for c in update.chunks])):
        chunk.grad = g
    opt.step()
    update.all_gather()
    counted = get_comm_counters()

    full = [p.clone().requires_grad_(True) for p in params]
    ref_opt = adamw(1e-3)(full)
    grads = [g.clone() for g in grads_of(params, batch)]
    if live:
        for g in grads:
            dist.all_reduce(g)
    for p, g in zip(full, grads):
        p.grad = g / n
    ref_opt.step()
    delta = max(float((a - b.detach()).abs().max()) for a, b in zip(fused_params, full))
    whole = sum(2 * p.numel() * p.element_size() for p in params)
    return {
        "n_devices": n,
        "num_buckets": plan.num_buckets,
        "plan_collective_bytes": plan.collective_bytes,
        "counted_collective_bytes": {k: v["bytes"] for k, v in counted.items()},
        "opt_state_shard_fraction": state_bytes(opt) / whole,
        "parity_max_abs_delta": delta,
    }
