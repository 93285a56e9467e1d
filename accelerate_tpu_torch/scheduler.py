"""LR scheduler wrapper: the port of ``accelerate_tpu.scheduler``.

:class:`AcceleratedScheduler` steps only when the optimizer really stepped
(``GradientState.sync_gradients``: an accumulation boundary), or on every
call with ``step_with_optimizer=False``; it advances ``num_processes``
times a call unless ``split_batches`` (with one process, once). It wraps
either a ``step -> lr`` schedule (the train step evaluates it itself, so
the wrapper only counts steps and reports ``get_last_lr``) or an object
with ``.step()``, such as a ``torch.optim.lr_scheduler`` over the bound
optimizer, which it advances.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from .state import AcceleratorState, GradientState

__all__ = ["AcceleratedScheduler"]


class AcceleratedScheduler:
    def __init__(self, schedule_fn: Union[Callable[[int], float], object], optimizer=None,
                 step_with_optimizer: bool = True, split_batches: bool = False,
                 num_processes: Optional[int] = None):
        self.scheduler = schedule_fn if hasattr(schedule_fn, "step") else None
        self.schedule_fn = None if self.scheduler is not None else schedule_fn
        self.optimizer = optimizer
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = GradientState()
        self._step_count = 0
        if num_processes is None:
            state = AcceleratorState._shared_state
            num_processes = AcceleratorState().num_processes if state.get("_initialized") else 1
        self.num_processes = num_processes

    def _advance(self, times: int) -> None:
        self._step_count += times
        if self.scheduler is not None:
            for _ in range(times):
                self.scheduler.step()

    def step(self) -> None:
        if not self.step_with_optimizer:
            self._advance(1)
            return
        if not self.gradient_state.sync_gradients:  # inside an accumulation window
            return
        self._advance(1 if self.split_batches else self.num_processes)

    @property
    def last_lr(self) -> float:
        if self.scheduler is not None:
            return float(self.scheduler.get_last_lr()[0])
        return float(self.schedule_fn(self._step_count))

    def get_last_lr(self) -> list:
        if self.scheduler is not None:
            return list(self.scheduler.get_last_lr())
        return [self.last_lr]

    def state_dict(self) -> dict:
        state = {"step_count": self._step_count}
        if self.scheduler is not None and hasattr(self.scheduler, "state_dict"):
            state["scheduler"] = self.scheduler.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self._step_count = state["step_count"]
        if self.scheduler is not None and "scheduler" in state:
            self.scheduler.load_state_dict(state["scheduler"])
