"""Hooks around stage calls: the port of ``accelerate_tpu.hooks``.

A model here is a sequence of stage functions ``fn(params, *args)`` over a
nested dict of tensors, as in the JAX package, so a hook wraps the call:
it may replace the params the stage sees (page them onto the device, cast
them) and post-process the output. Host-to-device copies go through
:func:`_to_device`, which stages host tensors in pinned memory and copies
them with ``non_blocking=True`` when the target is a CUDA device; on the
CPU (when the caller asked for it) they are the tensors themselves.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from .utils.device import resolve_device

__all__ = [
    "AlignDevicesHook",
    "CpuOffloadHook",
    "LayerwiseCastingHook",
    "ModelHook",
    "PrefetchingLoader",
    "SequentialHook",
    "add_hook_to_fn",
    "remove_hook_from_fn",
]


class ModelHook:
    """Pre/post hooks around one stage call."""

    def init_hook(self, stage_name: str, params):
        """Called once when the hook is attached; may transform stored params."""
        return params

    def pre_forward(self, params, *args, **kwargs):
        """Return the ``(params, args, kwargs)`` the stage should see."""
        return params, args, kwargs

    def post_forward(self, params, output):
        """Return the (possibly transformed) output."""
        return output

    def detach_hook(self, params):
        return params


class SequentialHook(ModelHook):
    """Hooks composed in order."""

    def __init__(self, *hooks: ModelHook):
        self.hooks = list(hooks)

    def init_hook(self, stage_name, params):
        for h in self.hooks:
            params = h.init_hook(stage_name, params)
        return params

    def pre_forward(self, params, *args, **kwargs):
        for h in self.hooks:
            params, args, kwargs = h.pre_forward(params, *args, **kwargs)
        return params, args, kwargs

    def post_forward(self, params, output):
        for h in self.hooks:
            output = h.post_forward(params, output)
        return output

    def detach_hook(self, params):
        for h in self.hooks:
            params = h.detach_hook(params)
        return params


def add_hook_to_fn(fn: Callable, hook: ModelHook, stage_name: str = "") -> Callable:
    """Wrap ``fn(params, *args, **kwargs)`` with ``hook``; a second hook on an
    already wrapped function composes after the first. The wrapper carries
    ``_at_hook`` so :func:`remove_hook_from_fn` can unwrap it."""
    if getattr(fn, "_at_hook", None) is not None:
        hook = SequentialHook(fn._at_hook, hook)
        fn = fn._at_original

    @functools.wraps(fn)
    def wrapped(params, *args, **kwargs):
        params, args, kwargs = hook.pre_forward(params, *args, **kwargs)
        output = fn(params, *args, **kwargs)
        return hook.post_forward(params, output)

    wrapped._at_hook = hook
    wrapped._at_original = fn
    wrapped._at_stage = stage_name
    return wrapped


def remove_hook_from_fn(fn: Callable) -> Callable:
    return getattr(fn, "_at_original", fn)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    array = np.asarray(x)
    if array.dtype.name == "bfloat16":  # a JAX bf16 array: its bits
        return torch.from_numpy(array.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(array))


def _to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``. Host data bound for a CUDA device goes through
    pinned memory (a memmap or pageable tensor is staged there first) and
    a ``non_blocking`` copy on the current stream."""
    t = _as_tensor(x)
    if device.type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _to_host(x, pin: bool) -> torch.Tensor:
    """``x`` as a CPU tensor, in pinned memory when ``pin`` (the execution
    device is CUDA)."""
    t = _as_tensor(x).detach()
    if t.device.type != "cpu":
        t = t.cpu()
    return t.pin_memory() if pin and not t.is_pinned() else t


def _map_tree(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _queue_copies(place: Callable[[], Any], stream):
    """Run ``place()``, which issues host-to-device copies and returns them
    as a tree, on the side ``stream`` and record an event after them;
    returns ``(placed, event)``. Without a stream (the CPU) the copies are
    made in place and the event is ``None``."""
    if stream is None:
        return place(), None
    with torch.cuda.stream(stream):
        placed = place()
    event = torch.cuda.Event()
    event.record(stream)
    return placed, event


def _ready(placed, event, device: torch.device):
    """Make ``device``'s current (compute) stream wait for the copies that
    :func:`_queue_copies` queued, and mark each copy as used by it: they
    were allocated on the side stream, so without ``record_stream`` the
    allocator could hand their memory to a later copy while the compute
    stream still reads it."""
    if event is not None:
        compute = torch.cuda.current_stream(device)
        compute.wait_event(event)
        _map_tree(lambda t: t.record_stream(compute) if t is not None else None, placed)
    return placed


class AlignDevicesHook(ModelHook):
    """Page a stage's params onto the execution device before the call and
    drop the device copies after it. ``weights_map`` (any mapping ``path →
    tensor``, such as :class:`~.utils.offload.OffloadedWeightsLoader`)
    supplies the leaves that are ``None``; paths are relative to the stage.
    ``tied_params_map`` (``id(host) → (host, device copy)``, shareable
    between hooks) copies a tied weight once; each entry holds its host
    tensor, so the id cannot be reused by another object while the entry
    lives."""

    def __init__(
        self,
        execution_device=None,
        offload: bool = True,
        weights_map: Optional[Mapping[str, Any]] = None,
        tied_params_map: Optional[dict[int, Any]] = None,
    ):
        self.execution_device = resolve_device(execution_device)
        self.offload = offload
        self.weights_map = weights_map
        self.tied_params_map = tied_params_map if tied_params_map is not None else {}

    def init_hook(self, stage_name, params):
        self.stage_name = stage_name
        return params

    def _put(self, leaf):
        if leaf is None:
            return None
        key = id(leaf)
        entry = self.tied_params_map.get(key)
        if entry is not None and entry[0] is leaf:
            return entry[1]
        placed = _to_device(leaf, self.execution_device)
        self.tied_params_map[key] = (leaf, placed)
        return placed

    def pre_forward(self, params, *args, **kwargs):
        from .utils.modeling import named_parameters, unflatten_parameters

        flat = named_parameters(params)
        loaded = {}
        for path, leaf in flat.items():
            if leaf is None and self.weights_map is not None:
                leaf = self.weights_map[path]
            loaded[path] = self._put(leaf)
        args = tuple(_to_device(a, self.execution_device) if _is_arraylike(a) else a
                     for a in args)
        if isinstance(params, Mapping):
            return unflatten_parameters(loaded), args, kwargs
        # bare-leaf params flatten to {'': leaf}
        return loaded.get("", loaded), args, kwargs

    def post_forward(self, params, output):
        if self.offload:
            self.tied_params_map.clear()
        return output


class PrefetchingLoader:
    """Iterate ``(stage_name, stage_fn, host_params)`` triples, yielding each
    stage's params on the execution device one stage ahead: on a CUDA
    device stage i+1's copies are queued on a side stream while stage i
    computes, and the compute stream waits for them (an event) only when
    stage i+1 is yielded."""

    def __init__(self, stages: Sequence[tuple], execution_device=None):
        self.stages = list(stages)
        self.execution_device = resolve_device(execution_device)

    def _queue(self, host_params, stream):
        return _queue_copies(
            lambda: _map_tree(lambda x: _to_device(x, self.execution_device), host_params),
            stream)

    def __iter__(self):
        stream = (torch.cuda.Stream(self.execution_device)
                  if self.execution_device.type == "cuda" else None)
        pending = None
        for i, (name, fn, host_params) in enumerate(self.stages):
            current = pending if pending is not None else self._queue(host_params, stream)
            pending = (self._queue(self.stages[i + 1][2], stream)
                       if i + 1 < len(self.stages) else None)
            yield name, fn, _ready(*current, self.execution_device)


class CpuOffloadHook(ModelHook):
    """Keep params on the host between calls and page them onto the device
    for each call; with ``prev_hook``, the previous stage's device copy is
    dropped when this stage starts."""

    def __init__(self, execution_device=None, prev_hook: Optional["CpuOffloadHook"] = None):
        self.execution_device = resolve_device(execution_device)
        self.prev_hook = prev_hook
        self._device_copy = None

    def pre_forward(self, params, *args, **kwargs):
        if self.prev_hook is not None:
            self.prev_hook.release()
        self._device_copy = _map_tree(lambda x: _to_device(x, self.execution_device), params)
        return self._device_copy, args, kwargs

    def release(self):
        self._device_copy = None


class LayerwiseCastingHook(ModelHook):
    """Store params in ``storage_dtype`` (e.g. ``torch.float8_e4m3fn`` or
    ``torch.bfloat16``) and cast the floating ones to ``compute_dtype`` for
    each call."""

    def __init__(self, storage_dtype, compute_dtype):
        self.storage_dtype = storage_dtype
        self.compute_dtype = compute_dtype

    def init_hook(self, stage_name, params):
        return _map_tree(lambda x: x.to(self.storage_dtype) if _is_floating(x) else x, params)

    def pre_forward(self, params, *args, **kwargs):
        cast = _map_tree(lambda x: x.to(self.compute_dtype) if _is_floating(x) else x, params)
        return cast, args, kwargs


def _is_arraylike(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


def _is_floating(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()
