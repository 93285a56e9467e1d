"""Batch helpers and collectives: the port of ``accelerate_tpu.utils.
operations``.

``stack_batches`` and ``send_to_device`` work on one process. The
collectives (``gather``, ``gather_object``, ``broadcast``,
``broadcast_object_list``, ``reduce``, ``pad_across_processes``) run
through ``torch.distributed`` whenever a process group is running, even a
group of one process, and return their input unchanged without one, as the
JAX package's do with one process. A tensor leaf is communicated on its
own device, which must be the backend's (CUDA for ``nccl``; ``gloo`` takes
either); a numpy leaf goes through the state's device and comes back as
numpy. Every call adds its payload to the byte counters that
:func:`get_comm_counters` reads, and so do the collectives of a sharded
train step (:mod:`..parallel.sharding`, :mod:`..parallel.weight_update`)
under ``step:`` names.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = [
    "CannotPadNestedTensorWarning",
    "DistributedOperationException",
    "avg_losses_across_data_parallel_group",
    "broadcast",
    "broadcast_object_list",
    "concatenate",
    "find_batch_size",
    "gather",
    "gather_across_data_parallel_groups",
    "gather_object",
    "get_comm_counters",
    "get_data_structure",
    "ignorant_find_batch_size",
    "initialize_tensors",
    "pad_across_processes",
    "pad_input_tensors",
    "record_collective",
    "recursively_apply",
    "reduce",
    "reset_comm_counters",
    "send_to_device",
    "slice_tensors",
    "stack_batches",
    "verify_operation",
]


class DistributedOperationException(Exception):
    """An operation cannot proceed consistently across processes."""


class CannotPadNestedTensorWarning(UserWarning):
    """``pad_across_processes`` met a leaf it cannot pad (an object array);
    the leaf passes through unpadded."""


_COMM_COUNTS: dict = {}  # op -> [calls, bytes]


def record_collective(op: str, nbytes: int) -> None:
    """Add one call of ``op`` moving ``nbytes`` to the counters."""
    rec = _COMM_COUNTS.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += int(nbytes)


def get_comm_counters() -> dict:
    """``{op: {"calls": n, "bytes": b}}`` since the last reset."""
    return {op: {"calls": rec[0], "bytes": rec[1]} for op, rec in _COMM_COUNTS.items()}


def reset_comm_counters() -> None:
    _COMM_COUNTS.clear()


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _tree_map(fn, *(t[k] for t in trees))) for k in first)
    if isinstance(first, (list, tuple)):
        mapped = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*mapped) if hasattr(first, "_fields") else type(first)(mapped)
    return fn(*trees)


def _is_tensorlike(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(func: Callable, data: Any, *args, test_type: Callable = _is_tensorlike,
                      error_on_other_type: bool = False, **kwargs):
    """``func`` on every leaf of nested lists, tuples (named too) and dicts
    that passes ``test_type``; other leaves pass through (or raise with
    ``error_on_other_type``)."""
    if isinstance(data, (list, tuple)):
        mapped = [recursively_apply(func, o, *args, test_type=test_type,
                                    error_on_other_type=error_on_other_type, **kwargs)
                  for o in data]
        return type(data)(*mapped) if hasattr(data, "_fields") else type(data)(mapped)
    if isinstance(data, dict):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs)
                           for k, v in data.items()})
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to a collective op — only "
                        "nested list/tuple/dict of tensors or arrays are supported.")
    return data


def stack_batches(batches: list):
    """Stack same-structure batches along a new leading step axis ``[K,
    ...]`` — the input of ``Accelerator.prepare_train_loop``. Tensor leaves
    stack with ``torch.stack`` (on their device), array leaves with
    ``np.stack``."""

    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack(leaves)

    return _tree_map(stack, *batches)


def send_to_device(tree, device):
    """Every tensor or numeric array leaf onto ``device`` as a tensor
    (arrays keep their dtype); strings and other objects pass through."""

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        arr = np.asarray(x)
        if arr.dtype.kind not in "biuf":
            return x
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return _tree_map(put, tree)


# ---------------------------------------------------------------- collectives --
def _dist():
    import torch.distributed as dist

    return dist


def _live() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _comm_device() -> torch.device:
    from ..state import PartialState

    return PartialState().device


def _to_comm(x):
    """``(tensor to communicate, back)``: numpy leaves become tensors on the
    state's device, bools travel as uint8; ``back`` undoes both."""
    if isinstance(x, torch.Tensor):
        t, restore = x.detach(), (lambda y: y)
    else:
        arr = np.asarray(x)
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(_comm_device())
        restore = (lambda y: y.cpu().numpy())
    if t.dtype == torch.bool:
        return t.to(torch.uint8), (lambda y, r=restore: r(y.to(torch.bool)))
    return t, restore


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather_one(x, group=None):
    dist = _dist()
    t, back = _to_comm(x)
    n = dist.get_world_size(group)
    t = t.reshape(1) if t.dim() == 0 else t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    record_collective("gather", _nbytes(out))
    return back(out)


def verify_operation(function: Callable) -> Callable:
    """Under ``ACCELERATE_DEBUG_MODE`` with more than one process, check that
    every process passes leaves of the same shapes before the collective,
    and raise :class:`DistributedOperationException` when they do not."""

    def wrapper(tree, *args, **kwargs):
        from ..state import PartialState
        from .environment import parse_flag_from_env

        state = PartialState()
        if state.num_processes > 1 and (getattr(state, "debug", False)
                                        or parse_flag_from_env("ACCELERATE_DEBUG_MODE")):
            shapes = recursively_apply(lambda x: tuple(np.shape(x)), tree)
            all_shapes = gather_object(shapes)
            if any(s != all_shapes[0] for s in all_shapes[1:]):
                raise DistributedOperationException(
                    f"Shapes mismatch across processes in {function.__name__}: {all_shapes}")
        return function(tree, *args, **kwargs)

    wrapper.__name__ = function.__name__
    wrapper.__doc__ = function.__doc__
    return wrapper


@verify_operation
def gather(tree):
    """Each tensor or array leaf concatenated along dim 0 across every
    process, in rank order (a 0-d leaf gives one row per process). One
    process without a process group: the tree unchanged."""
    if not _live():
        return tree
    return recursively_apply(_gather_one, tree)


def gather_object(obj: Any) -> list:
    """A picklable object from every process, in rank order."""
    if not _live():
        return [obj]
    dist = _dist()
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    record_collective("gather_object", 0)
    return out


@verify_operation
def broadcast(tree, from_process: int = 0):
    """Every leaf takes ``from_process``'s value."""
    if not _live():
        return tree
    dist = _dist()

    def bcast(x):
        t, back = _to_comm(x)
        t = t.clone()
        dist.broadcast(t, src=from_process)
        record_collective("broadcast", _nbytes(t))
        return back(t)

    return recursively_apply(bcast, tree)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """``object_list`` takes ``from_process``'s items (in place, and
    returned)."""
    if not _live():
        return object_list
    _dist().broadcast_object_list(object_list, src=from_process)
    record_collective("broadcast_object_list", 0)
    return object_list


def reduce(tree, reduction: str = "mean", scale: float = 1.0):
    """Each leaf summed (``"sum"``) or averaged (``"mean"``) over the
    processes, times ``scale``; ``"none"`` only scales."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean/sum/none, got {reduction}")
    dist = _dist()
    live = _live()

    def _reduce(x):
        t, back = _to_comm(x)
        if not (live and reduction != "none"):
            return back(t * scale)
        out = t.clone()
        dist.all_reduce(out)
        record_collective("reduce", _nbytes(out))
        if reduction == "mean":
            out = out / dist.get_world_size()
        return back(out * scale)

    return recursively_apply(_reduce, tree)


reduce_ = reduce  # the JAX package's alias, for import sites that shadow builtins


def pad_across_processes(tree, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Each leaf padded with ``pad_index`` along ``dim`` to the largest size
    any process holds (at the front with ``pad_first``), so that the
    leaves can then be gathered."""
    import warnings

    def _pad(x):
        if isinstance(x, np.ndarray) and x.dtype == object:
            warnings.warn(f"cannot pad a ragged/object leaf of type {type(x).__name__}; "
                          "passing it through unpadded", CannotPadNestedTensorWarning,
                          stacklevel=2)
            return x
        if dim >= x.ndim or not _live():
            return x
        sizes = _gather_one(torch.tensor([x.shape[dim]], device=_comm_device()))
        max_size = int(sizes.max())
        if max_size == x.shape[dim]:
            return x
        if isinstance(x, torch.Tensor):
            shape = list(x.shape)
            shape[dim] = max_size - x.shape[dim]
            fill = torch.full(shape, pad_index, dtype=x.dtype, device=x.device)
            return torch.cat([fill, x] if pad_first else [x, fill], dim=dim)
        pad_width = [(0, 0)] * x.ndim
        pad_width[dim] = ((max_size - x.shape[dim], 0) if pad_first
                          else (0, max_size - x.shape[dim]))
        return np.pad(x, pad_width, constant_values=pad_index)

    return recursively_apply(_pad, tree)


def pad_input_tensors(tree, batch_size: int, num_processes: int, dim: int = 0):
    """Pad each leaf along ``dim`` to a multiple of ``num_processes`` by
    repeating its last row."""

    def _pad(x):
        size = x.shape[dim]
        if size % num_processes == 0:
            return x
        extra = (size // num_processes + 1) * num_processes - size
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(size - 1, size)
        tail = x[tuple(idx)]
        reps = [1] * x.ndim
        reps[dim] = extra
        if isinstance(x, torch.Tensor):
            return torch.cat([x, tail.repeat(*reps)], dim=dim)
        return np.concatenate([x, np.tile(tail, reps)], axis=dim)

    return recursively_apply(_pad, tree)


def slice_tensors(data, tensor_slice, process_index: Optional[int] = None,
                  num_processes: Optional[int] = None):
    """``leaf[tensor_slice]`` on every leaf."""
    return recursively_apply(lambda x: x[tensor_slice], data)


def concatenate(data: list, dim: int = 0):
    """The leaves of same-structure trees concatenated along ``dim``."""
    first = data[0]
    if isinstance(first, (list, tuple)):
        return type(first)(concatenate([d[i] for d in data], dim=dim) for i in range(len(first)))
    if isinstance(first, dict):
        return type(first)({k: concatenate([d[k] for d in data], dim=dim) for k in first})
    if isinstance(first, torch.Tensor):
        return torch.cat(data, dim=dim)
    return np.concatenate(data, axis=dim)


def find_batch_size(data) -> Optional[int]:
    """The first dim of the first leaf with one (``None`` if there is
    none)."""
    if isinstance(data, (list, tuple)):
        for o in data:
            result = find_batch_size(o)
            if result is not None:
                return result
        return None
    if isinstance(data, dict):
        for v in data.values():
            result = find_batch_size(v)
            if result is not None:
                return result
        return None
    if _is_tensorlike(data) and data.ndim >= 1:
        return int(data.shape[0])
    return None


def ignorant_find_batch_size(data) -> Optional[int]:
    """:func:`find_batch_size` that never raises."""
    try:
        return find_batch_size(data)
    except Exception:
        return None


def gather_across_data_parallel_groups(tree):
    """Each leaf concatenated across the data-parallel processes: the ranks
    of the mesh's ``(dp_replicate, dp_shard)`` axes that share this rank's
    other coordinates, whose batch rows differ (ranks that differ only in
    ``tp`` hold the same rows). Without a mesh of more than one data-parallel
    rank: :func:`gather`."""
    from ..state import AcceleratorState

    state = AcceleratorState._shared_state
    mesh = state.get("mesh")
    if mesh is None or not _live():
        return gather(tree)
    for axis in ("dp_shard", "dp_replicate"):  # minor axis first: rows come out major-first
        group = mesh.group(axis)
        if group is not None:
            tree = recursively_apply(lambda x, g=group: _gather_one(x, g), tree)
    return tree


def avg_losses_across_data_parallel_group(losses):
    """The elementwise mean over the processes of a list of loss values."""
    if isinstance(losses, (list, tuple)):
        losses = torch.stack([torch.as_tensor(v) for v in losses])
    return reduce(losses, "mean")


class TensorInformation:
    """Shape and dtype of a leaf (the dispatcher's metadata record)."""

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype

    def __repr__(self) -> str:
        return f"TensorInformation(shape={self.shape}, dtype={self.dtype})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, TensorInformation) and self.shape == other.shape
                and self.dtype == other.dtype)


def is_tensor_information(x) -> bool:
    return isinstance(x, TensorInformation)


def get_data_structure(data):
    """The tree with every leaf replaced by its :class:`TensorInformation`."""
    return recursively_apply(lambda x: TensorInformation(x.shape, x.dtype), data)


def initialize_tensors(structure):
    """Zeros (numpy for numpy dtypes, torch for torch dtypes) matching a
    :func:`get_data_structure` tree."""

    def _init(x):
        if isinstance(x.dtype, torch.dtype):
            return torch.zeros(x.shape, dtype=x.dtype)
        return np.zeros(x.shape, dtype=x.dtype)

    return recursively_apply(_init, structure, test_type=is_tensor_information)
