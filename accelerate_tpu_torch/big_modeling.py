"""Big-model inference: zero-memory init, module → device dispatch, paged
params. The port of ``accelerate_tpu.big_modeling``.

A model is ``(stage functions, params)``. :func:`dispatch_params` places a
param tree per a device map and returns a :class:`DispatchedParams` store
whose ``store[stage]`` is that stage's params on the execution device:
device-resident stages are returned as they are; host (``"cpu"``) stages
live in pinned memory when the execution device is CUDA and are copied in
on a side stream; disk stages go from their memmap to a pinned staging
buffer and then the same way. :meth:`DispatchedParams.prefetch` queues the
next stage's copies while the current stage computes — the one-ahead
overlap the JAX package gets from asynchronous ``device_put``.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Mapping, Optional, Sequence, Union

import torch

from .hooks import AlignDevicesHook, _map_tree, _queue_copies, _ready, _to_device, _to_host
from .utils.device import resolve_device
from .utils.modeling import (
    _devices_for_index,
    _indexed_device,
    abstract_params,
    get_balanced_memory,
    infer_auto_device_map,
    load_checkpoint_in_params,
    lookup_device,
    named_parameters,
    unflatten_parameters,
)
from .utils.offload import OffloadedWeightsLoader, offload_state_dict

__all__ = [
    "DispatchedParams",
    "UserCpuOffloadHook",
    "attach_align_device_hook",
    "attach_layerwise_casting_hooks",
    "cpu_offload",
    "cpu_offload_with_hook",
    "disk_offload",
    "dispatch_model",
    "dispatch_params",
    "init_empty_weights",
    "init_on_device",
    "load_checkpoint_and_dispatch",
]

# zero-memory init under the reference's names: a tree of meta tensors
init_empty_weights = abstract_params
init_on_device = abstract_params


class DispatchedParams(Mapping):
    """Per-stage param store honouring a device map.

    ``store[stage]`` returns the stage's params ready for compute. Stages
    mapped to a device index stay resident there. ``"cpu"`` leaves are
    held on the host (pinned when ``execution_device`` is CUDA) and
    ``"disk"`` leaves in ``offload_folder``; both are paged in by
    :meth:`prefetch` (or by the lookup itself) and dropped by
    :meth:`release`. ``execution_device`` defaults to the CUDA device and
    raises without one unless ``"cpu"`` is asked for; on the CPU the paged
    copies are the host tensors themselves and no stream is made.

    On CUDA, a stage's copies are queued on one side stream and an event is
    recorded after them; the lookup makes the current (compute) stream wait
    for that event and marks each copy as used by it (``record_stream``),
    so :meth:`release` dropping the reference cannot let the allocator hand
    the memory to a later copy while the compute stream still reads it.
    """

    def __init__(
        self,
        params: Mapping[str, Any],
        device_map: Mapping[str, Union[int, str]],
        offload_folder: Optional[str] = None,
        execution_device=None,
    ):
        self.device_map = dict(device_map)
        self.execution_device = resolve_device(execution_device)
        self.offload_folder = offload_folder
        on_cuda = self.execution_device.type == "cuda"
        devices = _devices_for_index(self.execution_device)

        flat = named_parameters(params)
        self._resident: dict[str, Any] = {}  # device stages
        self._host: dict[str, Any] = {}  # cpu-offloaded, pinned on CUDA
        disk_state: dict[str, Any] = {}
        hosted: dict[int, torch.Tensor] = {}  # id(leaf) → host copy: ties stay tied
        for path, leaf in flat.items():
            target = lookup_device(self.device_map, path)
            if target == "disk":
                disk_state[path] = leaf
            elif target == "cpu":
                if leaf is not None and id(leaf) not in hosted:
                    hosted[id(leaf)] = _to_host(leaf, pin=on_cuda)
                self._host[path] = None if leaf is None else hosted[id(leaf)]
            else:
                dev = _indexed_device(devices, target, path)
                self._resident[path] = None if leaf is None else _to_device(leaf, dev)
        if disk_state:
            if offload_folder is None:
                raise ValueError("device_map contains 'disk' but no offload_folder given")
            to_spill = {k: v for k, v in disk_state.items() if v is not None}
            if to_spill:
                offload_state_dict(offload_folder, to_spill)
            self._disk = OffloadedWeightsLoader(save_folder=offload_folder)
        else:
            self._disk = None
        self._stage_names = sorted({path.split("/")[0] for path in flat})
        self._paths_by_stage: dict[str, list[str]] = {}
        for path in flat:
            self._paths_by_stage.setdefault(path.split("/")[0], []).append(path)
        self._paged_cache: dict[str, Any] = {}
        # id(host tensor) → (host, device copy), so a tied weight is copied once
        self._tied_map: dict[int, Any] = {}
        self._stream = torch.cuda.Stream(self.execution_device) if on_cuda else None
        self._events: dict[str, Any] = {}  # stage → (its queued copies, event after them)

    # ----------------------------------------------------------- mapping API --
    def __iter__(self):
        return iter(self._stage_names)

    def __len__(self):
        return len(self._stage_names)

    def __getitem__(self, stage: str):
        paths = self._paths_by_stage.get(stage)
        if paths is None:
            raise KeyError(stage)
        self.prefetch(stage)
        pending = self._events.pop(stage, None)
        if pending is not None:
            _ready(*pending, self.execution_device)
        flat = {}
        for path in paths:
            flat[path[len(stage) + 1:] if path != stage else stage] = self._leaf_on_device(path)
        if len(flat) == 1 and stage in flat:
            return flat[stage]
        return unflatten_parameters(flat)

    def _leaf_on_device(self, path: str):
        if path in self._resident:
            return self._resident[path]
        if path in self._paged_cache:
            return self._paged_cache[path]
        host = self._host.get(path)
        if host is None and self._disk is not None:
            host = self._disk[path]  # a memmap: staged through pinned memory
        if host is None:
            return None
        # tied-weight dedup keyed by id(host); the entry holds the host
        # tensor so its id cannot be recycled while the entry lives
        key = id(host)
        entry = self._tied_map.get(key)
        if entry is not None and entry[0] is host:
            placed = entry[1]
        else:
            placed = _to_device(host, self.execution_device)
            self._tied_map[key] = (host, placed)
        self._paged_cache[path] = placed
        return placed

    def prefetch(self, stage: str) -> None:
        """Queue the copies of a stage's offloaded params (on CUDA, on the
        side stream; the host returns before they finish): call it for
        stage i+1 while stage i computes."""
        paths = self._paths_by_stage.get(stage, [])
        todo = [p for p in paths if p not in self._resident and p not in self._paged_cache]
        if not todo:
            return
        # one stream switch for the whole stage: the host's cost per leaf is
        # what paces the copies (a layer's 9 leaves against ~1.6 ms of copy)
        placed, event = _queue_copies(
            lambda: {path: self._leaf_on_device(path) for path in todo}, self._stream)
        if event is not None:
            self._events[stage] = (placed, event)

    def release(self, stage: Optional[str] = None) -> None:
        """Drop paged-in copies (of one stage, or all)."""
        if stage is None:
            self._paged_cache.clear()
            self._tied_map.clear()
            self._events.clear()
            return
        for path in self._paths_by_stage.get(stage, []):
            self._paged_cache.pop(path, None)
        self._events.pop(stage, None)
        self._tied_map.clear()

    def materialize(self) -> dict:
        """The whole tree with every leaf on the execution device."""
        out = {}
        for stage in self._stage_names:
            out[stage] = self[stage]
        self.release()
        return out

    # ------------------------------------------------------------- execution --
    def paged(self, names: Sequence[str], prefetch: bool = True):
        """Yield each named stage's params in turn: stage i+1's copies are
        queued before stage i is looked up, and stage i's are dropped when
        the caller asks for the next one."""
        for i, name in enumerate(names):
            if prefetch and i + 1 < len(names):
                self.prefetch(names[i + 1])
            yield self[name]
            self.release(name)

    def run(self, stages: Sequence[tuple[str, Callable]], x, prefetch: bool = True):
        """Run ``x`` through ``[(stage_name, fn(params, x)), ...]`` with paged
        params, prefetching one stage ahead."""
        for i, params in enumerate(self.paged([n for n, _ in stages], prefetch)):
            x = stages[i][1](params, x)
        return x


def attach_align_device_hook(params, execution_device=None, weights_map=None) -> AlignDevicesHook:
    """The paging hook for a params subtree."""
    return AlignDevicesHook(execution_device=execution_device, weights_map=weights_map)


def _infer_map(tree, device_map, max_memory, no_split_module_patterns, dtype):
    if device_map is None or device_map == "auto":
        return infer_auto_device_map(tree, max_memory=max_memory,
                                     no_split_module_patterns=no_split_module_patterns,
                                     dtype=dtype)
    if device_map == "balanced":
        balanced = get_balanced_memory(tree, max_memory, no_split_module_patterns, dtype)
        return infer_auto_device_map(tree, max_memory=balanced,
                                     no_split_module_patterns=no_split_module_patterns,
                                     dtype=dtype)
    return device_map


def dispatch_params(
    params: Mapping[str, Any],
    device_map: Optional[Union[str, Mapping[str, Union[int, str]]]] = None,
    max_memory: Optional[dict] = None,
    no_split_module_patterns: Optional[list[str]] = None,
    offload_folder: Optional[str] = None,
    execution_device=None,
    dtype=None,
) -> DispatchedParams:
    """Place a param tree per a device map, inferred when ``device_map`` is
    ``None``/``"auto"`` (greedy) or ``"balanced"``."""
    device_map = _infer_map(params, device_map, max_memory, no_split_module_patterns, dtype)
    return DispatchedParams(
        params, device_map, offload_folder=offload_folder, execution_device=execution_device
    )


def cpu_offload(params, execution_device=None) -> DispatchedParams:
    """Every leaf on the host, paged per stage."""
    return DispatchedParams(params, {"": "cpu"}, execution_device=execution_device)


class UserCpuOffloadHook:
    """Manual paging of one model in a pipeline of several: :meth:`load`
    places the tree on the device (offloading the previous model first),
    :meth:`offload` copies it back to the host and drops the device
    tensors."""

    def __init__(self, host_tree, device=None):
        self._device = resolve_device(device)
        self._pin = self._device.type == "cuda"
        self._host = _map_tree(lambda x: _to_host(x, self._pin), host_tree)
        self._on_device = None
        self.prev_hook: Optional["UserCpuOffloadHook"] = None

    @property
    def params(self):
        """The live tree: on the device after :meth:`load`, else on the host."""
        return self._on_device if self._on_device is not None else self._host

    def load(self):
        if self.prev_hook is not None:
            self.prev_hook.offload()
        if self._on_device is None:
            self._on_device = _map_tree(lambda x: _to_device(x, self._device), self._host)
        return self._on_device

    def offload(self):
        if self._on_device is not None:
            self._host = _map_tree(lambda x: _to_host(x, self._pin), self._on_device)
            self._on_device = None

    def remove(self):
        self.offload()


def cpu_offload_with_hook(
    params, execution_device=None, prev_module_hook: Optional[UserCpuOffloadHook] = None
):
    """Place ``params`` on the device now and return ``(device_params,
    hook)``; ``hook.offload()`` pages them off again. With
    ``prev_module_hook``, loading this model offloads that one."""
    hook = UserCpuOffloadHook(params, device=execution_device)
    hook.prev_hook = prev_module_hook
    return hook.load(), hook


def disk_offload(params, offload_dir: str, execution_device=None) -> DispatchedParams:
    """Every leaf spilled to memmaps under ``offload_dir``."""
    os.makedirs(offload_dir, exist_ok=True)
    return DispatchedParams(
        params, {"": "disk"}, offload_folder=offload_dir, execution_device=execution_device
    )


def load_checkpoint_and_dispatch(
    abstract_tree,
    checkpoint: str,
    device_map: Optional[Union[str, Mapping[str, Any]]] = "auto",
    max_memory: Optional[dict] = None,
    no_split_module_patterns: Optional[list[str]] = None,
    offload_folder: Optional[str] = None,
    dtype=None,
    execution_device=None,
) -> DispatchedParams:
    """Infer a map over the abstract tree (:func:`abstract_params`), then
    stream the checkpoint straight to the mapped places, never holding the
    whole model in host memory."""
    device_map = _infer_map(abstract_tree, device_map, max_memory, no_split_module_patterns,
                            dtype)
    tree, _ = load_checkpoint_in_params(
        abstract_tree, checkpoint, device_map=device_map, offload_folder=offload_folder,
        dtype=dtype, execution_device=execution_device,
    )
    return DispatchedParams(tree, device_map, offload_folder=offload_folder,
                            execution_device=execution_device)


# a model is its param tree here, so dispatching a model dispatches its params
dispatch_model = dispatch_params


def attach_layerwise_casting_hooks(fn, storage_dtype, compute_dtype, stage_name: str = ""):
    """Wrap a stage function so its params are stored in ``storage_dtype``
    (fp8/bf16) and cast to ``compute_dtype`` for the call. Returns
    ``(wrapped_fn, cast_params_fn)``: apply ``cast_params_fn`` once to the
    params to move their storage to the narrow dtype."""
    from .hooks import LayerwiseCastingHook, add_hook_to_fn

    hook = LayerwiseCastingHook(storage_dtype, compute_dtype)
    return add_hook_to_fn(fn, hook, stage_name), (
        lambda params: hook.init_hook(stage_name, params)
    )
