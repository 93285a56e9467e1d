"""Process state: the port of ``accelerate_tpu.state``.

``PartialState`` (topology, device, process control), ``AcceleratorState``
(adds the mixed-precision policy, the parallelism config and the mesh)
and ``GradientState`` (accumulation bookkeeping) are singletons sharing
their state across instances, as in the JAX package; ``_reset_state``
clears them.

The JAX package runs one process per host, which drives every device of
that host. The port runs one process per device: process ``RANK`` of
``WORLD_SIZE`` drives ``cuda:LOCAL_RANK`` (or the CPU with ``cpu=True``)
and joins a ``torch.distributed`` process group, ``nccl`` on CUDA and
``gloo`` on the CPU. The launcher's environment is torchrun's (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or the
JAX package's (``ACCELERATE_COORDINATOR_ADDRESS``, ``ACCELERATE_NUM_
PROCESSES``, ``ACCELERATE_PROCESS_ID``, ``ACCELERATE_LOCAL_PROCESS_
INDEX``); a coordinator ``file:///path`` rendezvouses through a
``FileStore`` instead of a TCP port. The rendezvous waits at most
``initialization_timeout`` seconds (``ACCELERATE_INITIALIZATION_TIMEOUT``,
300 by default, as JAX's), then raises.

``DistributedType`` keeps the JAX package's values, read for the same
topology: ``NO`` is one process on one device; ``SPMD`` is several
devices of one host (one process in JAX, several here: every process of
the run is on this host, ``LOCAL_WORLD_SIZE == WORLD_SIZE``, which is
assumed when the launcher does not set ``LOCAL_WORLD_SIZE``);
``MULTI_HOST`` is a run that spans hosts.
"""

from __future__ import annotations

import datetime
import os
import time
from contextlib import contextmanager
from functools import wraps
from typing import Any, Callable, Optional

import torch

from .parallelism_config import ParallelismConfig
from .utils.dataclasses import (
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)
from .utils.device import resolve_device
from .utils.environment import get_int_from_env, parse_flag_from_env, parse_seconds_from_env

__all__ = ["AcceleratorState", "GradientState", "PartialState"]


def _dist():
    import torch.distributed as dist

    return dist


def _rendezvous_store(coordinator: str, rank: int, world_size: int, timeout: float):
    """The store the ranks meet at: a ``FileStore`` for ``file:///path``,
    else a ``TCPStore`` at ``host:port`` served by rank 0. Both give up
    after ``timeout`` seconds."""
    dist = _dist()
    wait = datetime.timedelta(seconds=timeout)
    if coordinator.startswith("file://"):
        store = dist.FileStore(coordinator[len("file://"):], world_size)
        store.set_timeout(wait)
        return store
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {coordinator!r} is not host:port or file:///path")
    return dist.TCPStore(host, int(port), world_size, is_master=rank == 0, timeout=wait)


class PartialState:
    """Process topology: how many processes, which one this is, which
    device it drives. The first construction joins the process group when
    the launcher's environment asks for more than one process or names a
    coordinator. ``backend`` overrides the choice of ``nccl`` or ``gloo``
    (``gloo`` takes CUDA tensors too, and lets several processes share one
    card); ``device`` overrides ``cuda:LOCAL_RANK``."""

    _shared_state: dict = {}

    def __init__(self, cpu: bool = False, device=None, backend: Optional[str] = None,
                 **kwargs: Any):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        cpu = cpu or parse_flag_from_env("ACCELERATE_USE_CPU") or (
            device is not None and torch.device(device).type == "cpu")
        world_size = int(kwargs.pop("num_processes", get_int_from_env(
            ("ACCELERATE_NUM_PROCESSES", "WORLD_SIZE"), 1)))
        rank = int(kwargs.pop("process_id", get_int_from_env(
            ("ACCELERATE_PROCESS_ID", "RANK"), 0)))
        self.local_process_index = get_int_from_env(
            ("ACCELERATE_LOCAL_PROCESS_INDEX", "LOCAL_RANK"), 0)
        timeout = kwargs.pop("initialization_timeout", None)
        coordinator = kwargs.pop("coordinator_address", None) or os.environ.get(
            "ACCELERATE_COORDINATOR_ADDRESS")
        if not coordinator and os.environ.get("MASTER_ADDR"):
            coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        dist = _dist()
        live = dist.is_available() and dist.is_initialized()
        if device is None:
            # one process of several drives its own card; one alone, the current one
            multi = live or world_size > 1 or bool(coordinator)
            device = "cpu" if cpu else (f"cuda:{self.local_process_index}" if multi else None)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        if live:
            world_size, rank = dist.get_world_size(), dist.get_rank()
        elif world_size > 1 or coordinator:
            if not coordinator:
                raise RuntimeError(
                    f"{world_size} processes are asked for (WORLD_SIZE / "
                    "ACCELERATE_NUM_PROCESSES) but no rendezvous address is set: launch with "
                    "torchrun (MASTER_ADDR and MASTER_PORT) or set "
                    "ACCELERATE_COORDINATOR_ADDRESS (host:port or file:///path)")
            if timeout is None:
                timeout = parse_seconds_from_env("ACCELERATE_INITIALIZATION_TIMEOUT", 300.0)
            timeout = float(getattr(timeout, "total_seconds", lambda: timeout)())
            if backend is None:
                backend = "gloo" if self.device.type == "cpu" else "nccl"
            store = _rendezvous_store(coordinator, rank, world_size, timeout)
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                    timeout=datetime.timedelta(seconds=timeout))
        if kwargs:
            raise TypeError(f"unexpected PartialState arguments: {sorted(kwargs)}")
        self.num_processes = world_size
        self.process_index = rank
        self.num_devices = world_size  # one process per device
        self.backend = dist.get_backend() if dist.is_available() and dist.is_initialized() else None
        local_world = get_int_from_env(("LOCAL_WORLD_SIZE",), world_size)
        if world_size == 1:
            self.distributed_type = DistributedType.NO
        elif local_world >= world_size:
            self.distributed_type = DistributedType.SPMD
        else:
            self.distributed_type = DistributedType.MULTI_HOST
        self.debug = parse_flag_from_env("ACCELERATE_DEBUG_MODE")
        self.run_id = os.environ.get("ACCELERATE_RUN_ID") or f"run-{int(time.time())}-{os.getpid()}"
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["_initialized"] = value

    @property
    def use_distributed(self) -> bool:
        return self.num_processes > 1

    @property
    def distributed(self) -> bool:
        """True when a process group is running (even of one process)."""
        return self.backend is not None

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def wait_for_everyone(self) -> None:
        """A barrier across the processes; with one process (and no process
        group), nothing to wait for."""
        if self.distributed:
            _dist().barrier()

    @contextmanager
    def main_process_first(self):
        """The main process runs the body first, the others after it."""
        if not self.is_main_process:
            self.wait_for_everyone()
        try:
            yield
        finally:
            if self.is_main_process:
                self.wait_for_everyone()
            self.wait_for_everyone()

    @contextmanager
    def local_main_process_first(self):
        with self.main_process_first():
            yield

    def _on(self, predicate: Callable[[], bool], function: Callable) -> Callable:
        @wraps(function)
        def wrapper(*args, **kwargs):
            return function(*args, **kwargs) if predicate() else None

        return wrapper

    def on_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable) -> Callable:
        return self._on(lambda: self.is_last_process, function)

    def on_process(self, function: Callable = None, process_index: int = None) -> Callable:
        if function is None:
            return lambda f: self.on_process(f, process_index)
        return self._on(lambda: self.process_index == process_index, function)

    @contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's contiguous share of a list, tuple, dict (each
        value split) or array; the first ``len % n`` processes take one
        more. ``apply_padding`` repeats the last element so every process
        gets the same count."""
        if self.num_processes == 1:
            yield inputs
            return
        if isinstance(inputs, dict):
            results = {}
            for key, value in inputs.items():
                with self.split_between_processes(value, apply_padding) as v:
                    results[key] = v
            yield results
            return
        length, num = len(inputs), self.num_processes
        base, extra = divmod(length, num)
        start = self.process_index * base + min(self.process_index, extra)
        end = start + base + (1 if self.process_index < extra else 0)
        chunk = inputs[start:end]
        if apply_padding and extra != 0:
            target = base + 1
            while len(chunk) < target:
                chunk = list(chunk) + [chunk[-1] if len(chunk) else inputs[-1]]
        yield chunk

    def destroy_process_group(self) -> None:
        dist = _dist()
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        self.backend = None

    def print(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    def __repr__(self) -> str:
        return (f"PartialState(device={self.device}, backend={self.backend!r}, "
                f"distributed_type={self.distributed_type}, num_processes={self.num_processes}, "
                f"process_index={self.process_index})")

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


class AcceleratorState:
    """Adds the precision policy, the parallelism config and the
    :class:`~.parallelism_config.Mesh` on top of :class:`PartialState`. The
    config defaults to ``PARALLELISM_CONFIG_*`` from the environment, else
    pure data parallelism over every process, as in the JAX package."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None,
                 parallelism_config: Optional[ParallelismConfig] = None, **kwargs: Any):
        self.__dict__ = self._shared_state
        if self.initialized:
            if parallelism_config is not None and parallelism_config != self.parallelism_config:
                raise ValueError(
                    "AcceleratorState already initialized with a different ParallelismConfig; "
                    "call AcceleratorState._reset_state() first (tests) or construct once.")
            if (mixed_precision is not None
                    and PrecisionType(str(mixed_precision)) != self.mixed_precision):
                raise ValueError(
                    f"AcceleratorState already initialized with mixed_precision="
                    f"{self.mixed_precision}; got conflicting {mixed_precision!r}."
                )
            return
        self._partial = PartialState(cpu=cpu, device=device, **kwargs)
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
        self.mixed_precision = PrecisionType(str(mixed_precision))
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(self.mixed_precision)
        if parallelism_config is None:
            if any(k.startswith("PARALLELISM_CONFIG_") for k in os.environ):
                parallelism_config = ParallelismConfig.from_env()
            else:
                parallelism_config = ParallelismConfig(
                    dp_replicate_size=self._partial.num_devices)
        self.parallelism_config = parallelism_config
        self.mesh = parallelism_config.build_mesh(
            self._partial.num_devices, device_type=self._partial.device.type,
            rank=self._partial.process_index)
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["_initialized"] = value

    def __getattr__(self, name: str) -> Any:
        # topology attributes come from PartialState
        partial = self.__dict__.get("_partial")
        if partial is not None and hasattr(partial, name):
            return getattr(partial, name)
        raise AttributeError(f"AcceleratorState has no attribute {name!r}")

    def __repr__(self) -> str:
        return (f"AcceleratorState(mixed_precision={self.mixed_precision}, "
                f"mesh={self.parallelism_config.describe(self._partial.num_devices)}, "
                f"{self._partial!r})")

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False) -> None:
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping (the JAX package's
    ``GradientState``): ``sync_gradients`` marks an optimizer-update
    boundary; the prepared data loader being iterated registers itself as
    ``active_dataloader`` and flips its ``end_of_dataloader`` on its last
    batch, so the last, partial accumulation window still syncs. The train
    step's own boundaries come from the optimizer's micro-step count, not
    from these flags."""

    _shared_state: dict = {}

    def __init__(self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = []
            self.plugin = gradient_accumulation_plugin or GradientAccumulationPlugin()
            self.initialized = True
        elif gradient_accumulation_plugin is not None:
            self.plugin = gradient_accumulation_plugin

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["_initialized"] = value

    @property
    def num_steps(self) -> int:
        return self.plugin.num_steps

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin.adjust_scheduler

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin.sync_with_dataloader

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def end_of_dataloader(self) -> bool:
        return self.in_dataloader and self.active_dataloader.end_of_dataloader

    @property
    def remainder(self) -> int:
        return self.active_dataloader.remainder if self.in_dataloader else -1

    def _set_sync_gradients(self, sync: bool) -> None:
        self.sync_gradients = sync

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = (self.dataloader_references[-1]
                                  if self.dataloader_references else None)

    def __repr__(self) -> str:
        return (f"GradientState(sync_gradients={self.sync_gradients}, num_steps={self.num_steps}, "
                f"end_of_dataloader={self.end_of_dataloader}, remainder={self.remainder})")

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()
