"""Optimizer wrapper: the port of ``accelerate_tpu.optimizer``.

The JAX package wraps an optax ``GradientTransformation`` whose state is a
value threaded through the step. Here the optimizer is a
``torch.optim.Optimizer`` that owns its state and updates the params in
place; :class:`AcceleratedOptimizer` keeps the JAX package's surface
(``init``, ``step``, ``zero_grad``, ``step_count``, ``state_dict``,
``opt_state``). :func:`adamw` takes ``optax.adamw``'s arguments and
defaults and gives a factory that ``init`` (or ``Accelerator.prepare``)
binds to the params.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Union

import torch

__all__ = ["AcceleratedOptimizer", "OptimizerFactory", "adamw", "param_leaves"]


def param_leaves(params) -> list:
    """The tensor leaves of a nested param dict, in insertion order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params] if isinstance(params, torch.Tensor) else []


@dataclass(frozen=True)
class OptimizerFactory:
    """``torch.optim`` class and keyword arguments, bound to params later."""

    cls: type
    kwargs: dict = field(default_factory=dict)

    def __call__(self, params: list) -> torch.optim.Optimizer:
        return self.cls(params, **self.kwargs)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> OptimizerFactory:
    """``torch.optim.AdamW`` with ``optax.adamw``'s signature and defaults
    (its weight decay default is 1e-4; torch's is 1e-2). Both apply the
    decoupled update ``p ← p − lr·(m̂ / (√v̂ + eps) + wd·p)``."""
    return OptimizerFactory(torch.optim.AdamW, dict(lr=learning_rate, betas=(b1, b2), eps=eps,
                                                    weight_decay=weight_decay))


class AcceleratedOptimizer:
    """Wraps a ``torch.optim.Optimizer``, or a factory that makes one from
    the param list (:func:`adamw`); :meth:`init` binds the factory."""

    def __init__(self, optimizer: Union[torch.optim.Optimizer, Callable],
                 accumulation_steps: int = 1):
        if accumulation_steps > 1:
            raise NotImplementedError(
                "gradient accumulation (optax.MultiSteps in the JAX package) is not ported yet "
                "(see ROADMAP.md)"
            )
        self.base_optimizer = optimizer
        self.optimizer = optimizer if isinstance(optimizer, torch.optim.Optimizer) else None
        self.accumulation_steps = accumulation_steps

    def init(self, params):
        """Bind to ``params`` (a nested dict of tensors): a factory becomes
        an optimizer over its leaves. Returns :attr:`opt_state`."""
        if self.optimizer is None:
            self.optimizer = self.base_optimizer(param_leaves(params))
        return self.opt_state

    @property
    def opt_state(self):
        """The torch optimizer's per-param state (updated in place), or
        ``None`` before :meth:`init`."""
        return None if self.optimizer is None else self.optimizer.state

    @property
    def params(self) -> list:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def step(self, grads=None, params=None):
        """Apply one update in place. ``grads`` (a tree like ``params``)
        become the params' ``.grad`` first when given; otherwise the grads
        left by ``backward`` are used. Returns ``params``."""
        if self.optimizer is None:
            self.init(params)
        if grads is not None:
            for p, g in zip(self.params, param_leaves(grads)):
                p.grad = g.to(p.dtype)
        self.optimizer.step()
        return params

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    @property
    def step_count(self) -> int:
        """Optimizer steps taken (the ``step`` entry torch keeps per param)."""
        state = self.opt_state
        if not state:
            return 0
        return int(next(iter(state.values()))["step"])

    def state_dict(self) -> dict:
        return {"opt_state": self.optimizer.state_dict(),
                "accumulation_steps": self.accumulation_steps}

    def load_state_dict(self, state_dict: dict) -> None:
        self.optimizer.load_state_dict(state_dict["opt_state"])
