"""Process state: the port of ``accelerate_tpu.state`` for one process on
one device.

``PartialState`` (topology and device), ``AcceleratorState`` (adds the
mixed-precision policy) and ``GradientState`` (accumulation bookkeeping)
are singletons sharing their state across instances, as in the JAX
package; ``_reset_state`` clears them. More than one process
(``WORLD_SIZE > 1``) is not ported yet (ROADMAP.md Queue A 6, mesh and
collectives) and raises.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from .utils.dataclasses import GradientAccumulationPlugin, MixedPrecisionPolicy, PrecisionType
from .utils.device import resolve_device

__all__ = ["AcceleratorState", "GradientState", "PartialState"]


class PartialState:
    """One process, one device: ``device`` is the CUDA device unless
    ``cpu=True`` or ``device="cpu"`` is asked for."""

    _shared_state: dict = {}

    def __init__(self, cpu: bool = False, device=None):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise NotImplementedError(
                "more than one process (WORLD_SIZE > 1) is not ported yet "
                "(ROADMAP.md Queue A 6: mesh and collectives)"
            )
        self.device = resolve_device("cpu" if cpu else device)
        self.num_processes = 1
        self.process_index = 0
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("_initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["_initialized"] = value

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    def wait_for_everyone(self) -> None:
        """A barrier across processes: with one process, nothing to wait for."""

    def print(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    def __repr__(self) -> str:
        return (f"PartialState(device={self.device}, num_processes={self.num_processes}, "
                f"process_index={self.process_index})")

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


class AcceleratorState:
    """Adds the precision policy on top of :class:`PartialState`."""

    _shared_state: dict = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False, device=None):
        self.__dict__ = self._shared_state
        if self.initialized:
            if (mixed_precision is not None
                    and PrecisionType(str(mixed_precision)) != self.mixed_precision):
                raise ValueError(
                    f"AcceleratorState already initialized with mixed_precision="
                    f"{self.mixed_precision}; got conflicting {mixed_precision!r}."
                )
            return
        self._partial = PartialState(cpu=cpu, device=device)
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
        self.mixed_precision = PrecisionType(str(mixed_precision))
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(self.mixed_precision)
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
        return f"AcceleratorState(mixed_precision={self.mixed_precision}, {self._partial!r})"

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
