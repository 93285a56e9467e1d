"""Optimizer wrapper and learning-rate schedules: the port of
``accelerate_tpu.optimizer`` and of the optax pieces it uses.

The JAX package wraps an optax ``GradientTransformation`` whose state is a
value threaded through the step. Here the optimizer is a
``torch.optim.Optimizer`` that owns its state and updates the params in
place; :class:`AcceleratedOptimizer` keeps the JAX package's surface
(``init``, ``step``, ``zero_grad``, ``step_count``,
``is_accumulation_boundary``, ``state_dict``, ``opt_state``).
:func:`adamw` takes ``optax.adamw``'s arguments and defaults, a float or a
``step -> lr`` schedule as its learning rate, and gives a factory that
``init`` (or ``Accelerator.prepare``) binds to the params.

Gradient accumulation repeats ``optax.MultiSteps``: each micro-step's
gradients enter an f32 buffer as a running mean, ``acc += (g - acc) /
(mini_step + 1)``; the inner AdamW step runs on the mean when ``mini_step
== k - 1`` and the buffer goes back to 0; between those the params are
not touched. Its counters are host integers, so choosing the boundary
reads nothing from the device. Under ``mixed_precision="fp16"`` the
optimizer also holds the dynamic loss scale and its growth count, as
device scalars (the JAX package extends its opt_state to ``(inner,
scale, growth_count)``; here ``opt_state`` stays the torch optimizer's
own state, and ``state_dict`` carries all of them).

The schedules are the port's copies of optax's ``constant_schedule``,
``linear_schedule``, ``cosine_decay_schedule`` and
``warmup_cosine_decay_schedule``: ``step -> lr`` in f32 (numpy
``float32``), evaluated where optax's ``scale_by_schedule`` evaluates them,
at the count of inner updates taken before this one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Union

import numpy as np
import torch

__all__ = [
    "AcceleratedOptimizer",
    "OptimizerFactory",
    "adamw",
    "constant_schedule",
    "cosine_decay_schedule",
    "linear_schedule",
    "param_leaves",
    "warmup_cosine_decay_schedule",
]

_f32 = np.float32


def constant_schedule(value: float) -> Callable:
    """``optax.constant_schedule``: ``value`` at every step."""
    return lambda count: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0) -> Callable:
    """``optax.linear_schedule``: ``init_value`` until ``transition_begin``,
    then linear to ``end_value`` over ``transition_steps``; constant at
    ``init_value`` when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)

    def schedule(count):
        c = min(max(int(count) - transition_begin, 0), transition_steps)
        frac = _f32(1) - _f32(c) / _f32(transition_steps)
        return _f32(init_value - end_value) * frac + _f32(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Callable:
    """``optax.cosine_decay_schedule``: ``init_value · ((1 - alpha) ·
    (½(1 + cos(π t / T)))^exponent + alpha)``, t held at T past it."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps}.")

    def schedule(count):
        c = np.minimum(_f32(count), _f32(decay_steps))
        cosine = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c / _f32(decay_steps)))
        return _f32(init_value) * (_f32(1 - alpha) * cosine ** _f32(exponent) + _f32(alpha))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine decay to ``end_value``
    at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha, exponent)

    def schedule(count):
        return warm(count) if count < warmup_steps else decay(count - warmup_steps)

    return schedule


def param_leaves(params) -> list:
    """The tensor leaves of a nested param dict, in insertion order."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    return [params] if isinstance(params, torch.Tensor) else []


@dataclass(frozen=True)
class OptimizerFactory:
    """``torch.optim`` class and keyword arguments, bound to params later;
    ``schedule`` (``step -> lr``) sets the lr before each update."""

    cls: type
    kwargs: dict = field(default_factory=dict)
    schedule: Optional[Callable] = None

    def __call__(self, params: list) -> torch.optim.Optimizer:
        return self.cls(params, **self.kwargs)


def adamw(learning_rate: Union[float, Callable], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> OptimizerFactory:
    """``torch.optim.AdamW`` with ``optax.adamw``'s signature and defaults
    (its weight decay default is 1e-4; torch's is 1e-2). Both apply the
    decoupled update ``p ← p − lr·(m̂ / (√v̂ + eps) + wd·p)``. A callable
    ``learning_rate`` is a schedule, read at the count of updates taken."""
    schedule = learning_rate if callable(learning_rate) else None
    lr = float(schedule(0)) if schedule is not None else learning_rate
    return OptimizerFactory(torch.optim.AdamW, dict(lr=lr, betas=(b1, b2), eps=eps,
                                                    weight_decay=weight_decay), schedule)


class AcceleratedOptimizer:
    """Wraps a ``torch.optim.Optimizer``, or a factory that makes one from
    the param list (:func:`adamw`); :meth:`init` binds the factory. With
    ``accumulation_steps = k > 1`` every ``k``-th micro-step updates, on the
    mean of the window's gradients (``optax.MultiSteps``)."""

    def __init__(self, optimizer: Union[torch.optim.Optimizer, Callable],
                 accumulation_steps: int = 1):
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
        self.base_optimizer = optimizer
        self.optimizer = optimizer if isinstance(optimizer, torch.optim.Optimizer) else None
        self.accumulation_steps = accumulation_steps
        self.schedule = getattr(optimizer, "schedule", None)
        self.mini_step = 0  # micro-steps into the current window
        self.gradient_step = 0  # inner updates taken
        self.acc_grads: Optional[torch.Tensor] = None  # flat running mean of the window
        self.scaler_config = None  # fp16: the GradScalerConfig of the loss scale below
        self.loss_scale: Optional[torch.Tensor] = None  # fp16: f32 scalar on the device
        self.growth_count: Optional[torch.Tensor] = None  # fp16: int32 scalar on the device

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

    # ------------------------------------------------------------ updates --
    def flat_grads(self) -> torch.Tensor:
        """The params' ``.grad`` (zeros where a param has none, as JAX's
        gradient of an unused leaf) concatenated into one flat tensor."""
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in self.params])

    def _set_grads(self, flat: torch.Tensor) -> None:
        offset = 0
        for p in self.params:
            p.grad = flat[offset:offset + p.numel()].view_as(p).to(p.dtype)
            offset += p.numel()

    def _inner_step(self) -> None:
        if self.schedule is not None:  # optax reads the count before its increment
            lr = float(self.schedule(self.gradient_step))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.gradient_step += 1

    def micro_step(self, flat: Optional[torch.Tensor] = None) -> None:
        """One micro-step on ``flat`` gradients (:meth:`flat_grads`'s
        layout), or on the params' ``.grad`` when ``None``."""
        k = self.accumulation_steps
        if k == 1:
            if flat is not None:
                self._set_grads(flat)
            self._inner_step()
            return
        if flat is None:
            flat = self.flat_grads()
        if self.acc_grads is None:
            self.acc_grads = torch.zeros_like(flat)
        acc = self.acc_grads
        acc.add_((flat - acc) / (self.mini_step + 1))
        if self.mini_step == k - 1:
            self._set_grads(acc)
            self._inner_step()
            self.optimizer.zero_grad(set_to_none=True)  # no .grad may alias the buffer
            acc.zero_()
        self.mini_step = (self.mini_step + 1) % k

    def step(self, grads=None, params=None):
        """One micro-step in place (an update unless it falls inside an
        accumulation window). ``grads`` (a tree like ``params``) are used
        when given; otherwise the grads left by ``backward``. Returns
        ``params``."""
        if self.optimizer is None:
            self.init(params)
        flat = None
        if grads is not None:
            flat = torch.cat([g.reshape(-1).to(p.dtype)
                              for p, g in zip(self.params, param_leaves(grads))])
        self.micro_step(flat)
        return params

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=set_to_none)

    # ------------------------------------------------------- loss scaling --
    def init_loss_scale(self, config, device) -> None:
        """Start the fp16 loss scale at ``config.init_scale`` (once: a scale
        already running, or loaded by :meth:`load_state_dict`, is kept)."""
        self.scaler_config = config
        if self.loss_scale is None:
            self.loss_scale = torch.tensor(float(config.init_scale), dtype=torch.float32,
                                           device=device)
            self.growth_count = torch.zeros((), dtype=torch.int32, device=device)

    def update_loss_scale(self, finite: torch.Tensor) -> torch.Tensor:
        """The JAX package's rule, on the device: back off (never below 1)
        when ``finite`` is false, grow after ``growth_interval`` finite
        micro-steps in a row. Updates the state in place and returns the
        new scale as a fresh tensor."""
        cfg, scale, growth = self.scaler_config, self.loss_scale, self.growth_count
        grown = torch.where(growth + 1 >= cfg.growth_interval, scale * cfg.growth_factor, scale)
        new_scale = torch.where(finite, grown, torch.clamp_min(scale * cfg.backoff_factor, 1.0))
        new_growth = torch.where(finite, (growth + 1) % cfg.growth_interval, 0)
        scale.copy_(new_scale)
        growth.copy_(new_growth)
        return new_scale

    # -------------------------------------------------------------- state --
    @property
    def step_count(self) -> int:
        """Optimizer (boundary) steps taken."""
        return self.gradient_step

    @property
    def is_accumulation_boundary(self) -> bool:
        """True when no micro-step of a window is pending."""
        return self.accumulation_steps <= 1 or self.mini_step == 0

    def state_dict(self) -> dict:
        """``opt_state`` holds the torch optimizer's state dict (``inner``),
        the accumulation counters and buffer, and the fp16 loss scale and
        growth count, as the JAX package's opt_state tree holds them."""
        def copy(t):
            return None if t is None else t.detach().clone()

        return {"opt_state": {"inner": self.optimizer.state_dict(), "mini_step": self.mini_step,
                              "gradient_step": self.gradient_step,
                              "acc_grads": copy(self.acc_grads),
                              "loss_scale": copy(self.loss_scale),
                              "growth_count": copy(self.growth_count)},
                "accumulation_steps": self.accumulation_steps}

    def load_state_dict(self, state_dict: dict) -> None:
        state = state_dict["opt_state"]
        self.optimizer.load_state_dict(state["inner"])
        self.mini_step, self.gradient_step = state["mini_step"], state["gradient_step"]
        for name in ("acc_grads", "loss_scale", "growth_count"):
            value = state[name]
            setattr(self, name, None if value is None else value.clone())
