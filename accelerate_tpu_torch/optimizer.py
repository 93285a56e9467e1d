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

:func:`adam` is :func:`adamw` with no weight decay, as ``optax.adam``;
:func:`sgd` is ``optax.sgd``'s chain as one optimizer (:class:`SGD`), with
optax's roundings. :func:`adafactor` is ``optax.adafactor``'s chain as one
optimizer (:class:`Adafactor`): factored second moments, block-RMS
clipping, the learning rate, the parameter-scale multiply, optional
momentum and weight decay, each at optax's dtype. :func:`chain` puts gradient transforms such
as :func:`clip_by_global_norm` before an optimizer factory, as
``optax.chain(optax.clip_by_global_norm(...), tx)`` does.

The schedules are the port's copies of optax's ``constant_schedule``,
``linear_schedule``, ``cosine_decay_schedule`` and
``warmup_cosine_decay_schedule``: ``step -> lr`` in f32 (numpy
``float32``), evaluated where optax's ``scale_by_schedule`` evaluates them,
at the count of inner updates taken before this one.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

__all__ = [
    "AcceleratedOptimizer",
    "Adafactor",
    "AnnotatedZero1",
    "OptimizerFactory",
    "SGD",
    "adafactor",
    "adam",
    "adamw",
    "chain",
    "clip_by_global_norm",
    "constant_schedule",
    "cosine_decay_schedule",
    "linear_schedule",
    "param_leaves",
    "sgd",
    "state_bytes",
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
    """The tensor leaves of a nested param dict/list/tuple: dict keys in
    insertion order, list and tuple items by index. (``jax.tree_util``
    sorts dict keys; the leaves are the same, and the order of a list's
    items is the same.) A ``QuantizedArray`` is one leaf."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    if isinstance(params, torch.Tensor):
        return [params]
    from .ops.quantization import QuantizedArray

    return [params] if isinstance(params, QuantizedArray) else []


@dataclass(frozen=True)
class OptimizerFactory:
    """``torch.optim`` class and keyword arguments, bound to params later;
    ``schedule`` (``step -> lr``) sets the lr before each update;
    ``transforms`` (``(grads, leaf_sumsq) -> grads`` on the list of
    gradients, in order; ``leaf_sumsq(grads)`` gives each gradient's
    whole-param sum of squares, across ranks when the params are split)
    run on the gradients before each update."""

    cls: type
    kwargs: dict = field(default_factory=dict)
    schedule: Optional[Callable] = None
    transforms: tuple = ()

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


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (through f32), as JAX casts a Python scalar
    to the dtype of the array it multiplies or adds."""
    return torch.tensor(float(np.float32(x))).to(dtype).item()


def _pow(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent`` in f32, rounded to ``x``'s dtype once, as XLA
    computes a bf16 power or root (torch's bf16 CPU kernels for these are
    an ulp off in a few percent of elements)."""
    return x.float().pow(exponent).to(x.dtype)


def _local_leaf_sumsq(grads: list) -> list:
    """Each gradient's sum of squares (f32), of the tensors as they are."""
    return [torch.sum(g * g, dtype=torch.float32) for g in grads]


def clip_by_global_norm(max_norm: float) -> Callable[[list], list]:
    """``optax.clip_by_global_norm``: when the global L2 norm of the
    gradients reaches ``max_norm``, every gradient becomes ``g / norm ·
    max_norm``; below it they pass unchanged. Each leaf's sum of squares is
    in its dtype, as optax's; the choice stays on the device. Bound to split
    params, each leaf's sum is that of the whole param (``leaf_sumsq``: the
    blocks' sums added over the axes that split it, once a block)."""

    def clip(grads: list, leaf_sumsq: Callable = _local_leaf_sumsq) -> list:
        norm = _pow(sum(s.to(g.dtype) for s, g in zip(leaf_sumsq(grads), grads)), 0.5)
        keep = norm < max_norm
        return [torch.where(keep, g, g / norm.to(g.dtype) * _scalar(max_norm, g.dtype))
                for g in grads]

    return clip


def chain(*stages) -> OptimizerFactory:
    """``optax.chain`` for the port: gradient transforms (such as
    :func:`clip_by_global_norm`) followed by one optimizer factory (such as
    :func:`adamw` or :func:`adafactor`); the transforms run in order on the
    gradients before each update."""
    *transforms, factory = stages
    if not isinstance(factory, OptimizerFactory) or any(
            isinstance(t, OptimizerFactory) or not callable(t) for t in transforms):
        raise ValueError("chain takes gradient transforms followed by one optimizer factory")
    return replace(factory, transforms=(*transforms, *factory.transforms))


def _factored_dims(shape: Sequence[int], factored: bool, min_dim_size_to_factor: int):
    """optax's ``_factored_dims``: the two largest dims ``(d1, d0)`` by
    ``np.argsort`` (so ties break as optax's do), or None when the second
    largest is under ``min_dim_size_to_factor`` or the leaf has one dim."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor`` (optax 0.2.6, ``_src/alias.py:225``) as one
    ``torch.optim.Optimizer``, optax's chain in its order on each leaf:

    1. ``scale_by_factored_rms``: second moments with decay ``1 - (t+1)^-0.8``
       (t = updates taken less ``decay_offset``), kept as a row and a column
       mean over the two largest dims when both reach
       ``min_dim_size_to_factor``, else whole; the update is ``g`` over
       their square root;
    2. ``clip_by_block_rms(clipping_threshold)``: the update divided by
       ``max(1, rms / threshold)``, the RMS over the whole leaf;
    3. ``scale_by_learning_rate``: times ``lr`` (None: skipped);
    4. ``scale_by_param_block_rms``: times ``max(rms(param), 1e-3)``;
    5. ``ema(momentum, debias=False)`` in ``dtype_momentum`` (None: skipped);
    6. ``add_decayed_weights(weight_decay_rate)``: plus ``rate · param``,
       after the learning rate, so not scaled by it (None: skipped);
    7. ``scale(-1)``, then ``param + update`` cast to the param's dtype.

    The block of steps 2 and 4 is the whole leaf: a stacked ``[L, ...]``
    leaf takes one RMS over all its layers, as in the JAX package. The
    second-moment state is in the param's dtype and each moving average
    runs in f32 before it is cast back (optax's f32 decay promotes it);
    every other step runs in the dtype optax's promotion gives, a Python
    scalar taking the array's dtype. :meth:`step` reads ``grads`` when
    given (the update may then see f32 gradients of bf16 params, as the
    JAX package's precision policy hands them), else each ``.grad``; a
    param without one steps on zeros, as JAX's gradient of an unused leaf.

    Bound to blocks of params split over a mesh (:meth:`shard`), every
    statistic is the whole param's: the factored dims come from its global
    shape, each row or column mean and each RMS is the blocks' sum
    all-reduced over the axes that split the reduced dims, over the global
    count, and ``v_row``/``v_col`` are split as the param's spec implies
    (its spec without the reduced dim). Under ZeRO-1 by annotation a rank
    owns dim-0 rows of each param that ``zero1_state_specs`` splits, and
    the rows are such a block, split over the ZeRO-1 axis: the moment that
    keeps dim 0 holds the rank's rows, the one reduced over dim 0 is whole
    (the same on every rank), and the column statistics, the block RMS of
    the update and the param's RMS are summed over the axis.
    """

    takes_grads = True

    def __init__(self, params, lr: Optional[float] = None, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
                 dtype_momentum: torch.dtype = torch.float32,
                 weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
                 factored: bool = True):
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            dtype_momentum=dtype_momentum, weight_decay_rate=weight_decay_rate, eps=eps,
            factored=factored))
        self.split: dict = {}  # param -> _Split of a param split over a mesh

    def shard(self, params: list, shapes: list, dim_axes: list, mesh) -> None:
        """Read ``params`` (blocks) as parts of params of global ``shapes``,
        dim ``d`` of each split over the mesh axes ``dim_axes[i][d]``."""
        for p, shape, axes in zip(params, shapes, dim_axes):
            if any(axes):
                self.split[p] = _Split(tuple(shape), tuple(axes), mesh)

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[list] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = None if grads is None else iter(grads)
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if grads is None else next(grads)
                p.add_(self._update(p, torch.zeros_like(p) if g is None else g, group))
        return loss

    def _update(self, p: torch.Tensor, g: torch.Tensor, group: dict) -> torch.Tensor:
        f32, dtype = torch.float32, p.dtype
        state = self.state[p]
        split = self.split.get(p)
        shape = p.shape if split is None else split.shape
        dims = _factored_dims(shape, group["factored"], group["min_dim_size_to_factor"])
        if not state:
            state["step"] = 0
            if dims is not None:
                d1, d0 = dims
                state["v_row"] = torch.zeros(np.delete(p.shape, d0).tolist(), dtype=dtype,
                                             device=p.device)
                state["v_col"] = torch.zeros(np.delete(p.shape, d1).tolist(), dtype=dtype,
                                             device=p.device)
            else:
                state["v"] = torch.zeros_like(p)
            if group["momentum"] is not None:
                state["ema"] = torch.zeros_like(p, dtype=group["dtype_momentum"])
        t = np.float32(state["step"] - group["decay_offset"] + 1)
        decay = np.float32(1) - t ** np.float32(-group["decay_rate"])
        keep, take = float(decay), float(np.float32(1) - decay)

        def average(v, x):  # f32, then back to the state's dtype
            return (keep * v.float() + take * x.float()).to(dtype)

        def mean(x, dim, param_dim, keepdim=False):  # over the whole param's dim
            if split is None or not split.axes[param_dim]:
                return x.mean(dim, keepdim=keepdim, dtype=f32)
            return split.sum(x.sum(dim, keepdim=keepdim, dtype=f32),
                             split.axes[param_dim]) / shape[param_dim]

        def mean_all(x):  # over the whole param
            if split is None:
                return torch.mean(x, dtype=f32)
            return split.sum(torch.sum(x, dtype=f32), split.all_axes) / split.numel

        grad_sqr = g * g + _scalar(group["eps"], g.dtype)
        if dims is not None:
            d1, d0 = dims
            state["v_row"] = v_row = average(
                state["v_row"], mean(grad_sqr, d0, d0).to(grad_sqr.dtype))
            state["v_col"] = v_col = average(
                state["v_col"], mean(grad_sqr, d1, d1).to(grad_sqr.dtype))
            row_col_mean = mean(v_row, d1 - 1 if d1 > d0 else d1, d1, keepdim=True).to(dtype)
            u = g * _pow(v_row / row_col_mean, -0.5).unsqueeze(d0) * _pow(v_col, -0.5).unsqueeze(d1)
        else:
            state["v"] = v = average(state["v"], grad_sqr)
            u = g * _pow(v, -0.5)
        state["step"] += 1
        if group["clipping_threshold"] is not None:
            rms = _pow(mean_all(u * u).to(u.dtype), 0.5)
            u = u / torch.clamp_min(rms / _scalar(group["clipping_threshold"], u.dtype), 1.0)
        if group["lr"] is not None:
            u = u * _scalar(group["lr"], u.dtype)
        if group["multiply_by_parameter_scale"]:
            rms = _pow(mean_all(p * p).to(dtype), 0.5)
            u = u * torch.clamp_min(rms, _scalar(1e-3, dtype))
        if group["momentum"] is not None:
            m = group["momentum"]
            u = u * _scalar(1 - m, u.dtype) + m * state["ema"]
            state["ema"] = u.to(group["dtype_momentum"])
        if group["weight_decay_rate"] is not None:
            u = u + p * _scalar(group["weight_decay_rate"], dtype)
        return u.neg()


@dataclass(frozen=True)
class _Split:
    """A param split over a mesh: its global shape and the axes that split
    each dim."""

    shape: tuple
    axes: tuple  # per dim: the mesh axes that split it
    mesh: object

    @property
    def all_axes(self) -> tuple:
        return tuple(a for axes in self.axes for a in axes)

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))

    def sum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """``x`` (a block's partial sum) summed over the mesh ``axes``."""
        from .parallel.sharding import all_reduce_axes

        return all_reduce_axes(x.contiguous(), self.mesh, axes)


def adafactor(learning_rate: Union[None, float, Callable] = None,
              min_dim_size_to_factor: int = 128, decay_rate: float = 0.8,
              decay_offset: int = 0, multiply_by_parameter_scale: bool = True,
              clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
              dtype_momentum: torch.dtype = torch.float32,
              weight_decay_rate: Optional[float] = None, eps: float = 1e-30,
              factored: bool = True) -> OptimizerFactory:
    """:class:`Adafactor` with ``optax.adafactor``'s signature and defaults
    (``weight_decay_mask`` is not ported). A callable ``learning_rate`` is a
    schedule, read at the count of updates taken."""
    schedule = learning_rate if callable(learning_rate) else None
    lr = float(schedule(0)) if schedule is not None else learning_rate
    return OptimizerFactory(Adafactor, dict(
        lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
        decay_offset=decay_offset, multiply_by_parameter_scale=multiply_by_parameter_scale,
        clipping_threshold=clipping_threshold, momentum=momentum, dtype_momentum=dtype_momentum,
        weight_decay_rate=weight_decay_rate, eps=eps, factored=factored), schedule)


class SGD(torch.optim.Optimizer):
    """``optax.sgd`` (optax 0.2.6, ``_src/alias.py``) as one
    ``torch.optim.Optimizer``, optax's chain on each leaf:

    1. ``trace(momentum, nesterov)`` when ``momentum`` is not None: the
       buffer ``mu = g + momentum · mu`` (zeros in the param's dtype at the
       start; the sum takes the dtype of ``g`` and ``mu`` promoted, and is
       kept so, as optax keeps it with ``accumulator_dtype=None``); the
       update is ``mu``, or ``g + momentum · mu`` with ``nesterov``;
    2. ``scale_by_learning_rate``: times ``-lr``;
    3. ``apply_updates``: ``param + update`` cast to the param's dtype.

    Each step rounds where optax's does (a Python scalar takes the array's
    dtype first), so a bf16 step rounds the update to bf16 before it is
    added: ``torch.optim.SGD``'s fused ``p.add_(buf, alpha=-lr)`` rounds
    once and is not optax's step in bf16. :meth:`step` reads ``grads`` when
    given, else each ``.grad``; a param without one steps on zeros."""

    takes_grads = True

    def __init__(self, params, lr: float, momentum: Optional[float] = None,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None, grads: Optional[list] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        grads = None if grads is None else iter(grads)
        for group in self.param_groups:
            for p in group["params"]:
                g = p.grad if grads is None else next(grads)
                g = torch.zeros_like(p) if g is None else g
                m = group["momentum"]
                if m is not None:
                    state = self.state[p]
                    mu = state.get("trace")
                    if mu is None:
                        mu = torch.zeros_like(p)
                    mu = g + mu * _scalar(m, mu.dtype)
                    state["trace"] = mu
                    g = g + mu * _scalar(m, mu.dtype) if group["nesterov"] else mu
                # the sum in the promoted dtype, rounded once to the param's
                p.add_(g * _scalar(-group["lr"], g.dtype))
        return loss


def sgd(learning_rate: Union[float, Callable], momentum: Optional[float] = None,
        nesterov: bool = False) -> OptimizerFactory:
    """:class:`SGD` with ``optax.sgd``'s signature and defaults. A callable
    ``learning_rate`` is a schedule, read at the count of updates taken."""
    schedule = learning_rate if callable(learning_rate) else None
    lr = float(schedule(0)) if schedule is not None else learning_rate
    return OptimizerFactory(SGD, dict(lr=lr, momentum=momentum, nesterov=nesterov), schedule)


def adam(learning_rate: Union[float, Callable], b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> OptimizerFactory:
    """``optax.adam``: :func:`adamw` with no weight decay (the update
    ``p ← p − lr·m̂ / (√v̂ + eps)`` is the same; held to ``optax.adam`` in
    ``tests/test_torch_t5.py``)."""
    return adamw(learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of a torch optimizer's array state (scalars such as the step
    counts left out)."""
    return sum(v.numel() * v.element_size() for s in optimizer.state.values()
               for v in s.values() if isinstance(v, torch.Tensor) and v.dim() > 0)


class AnnotatedZero1:
    """ZeRO-1 by annotation, the JAX package's ``zero1_state_specs``: a
    floating param that no mesh axis splits, and whose dim 0 divides by the
    ``axis`` size, has its optimizer state split over ``axis`` on dim 0.
    This rank's optimizer owns rows ``[r·n, (r+1)·n)`` of such a param (a
    copy, :attr:`owned`) and updates them from those rows of the summed
    gradient; :meth:`all_gather` then writes every rank's rows back into
    the params, one all-gather a dtype. Other params are updated whole, as
    without ZeRO-1."""

    def __init__(self, params: list, specs: list, mesh, axis: str):
        self.params, self.mesh, self.axis = params, mesh, axis
        size, me = mesh.shape[axis], mesh.coords[axis]
        self.rows, self.owned = [], []
        for p, spec in zip(params, specs):
            rows = None
            if (p.is_floating_point() and not any(d is not None for d in spec) and p.dim() >= 1
                    and p.shape[0] > 0 and p.shape[0] % size == 0):
                n = p.shape[0] // size
                rows = slice(me * n, (me + 1) * n)
            self.rows.append(rows)
            self.owned.append(p if rows is None else p.detach()[rows].clone())

    def owned_grads(self, grads: list) -> list:
        """The gradients of :attr:`owned`: this rank's rows where split."""
        return [g if rows is None else g[rows] for g, rows in zip(grads, self.rows)]

    @torch.no_grad()
    def all_gather(self) -> None:
        import torch.distributed as dist

        from .utils.operations import record_collective

        size, group = self.mesh.shape[self.axis], self.mesh.group(self.axis)
        by_dtype: dict = {}
        for i, rows in enumerate(self.rows):
            if rows is not None:
                by_dtype.setdefault(self.owned[i].dtype, []).append(i)
        for idx in by_dtype.values():
            mine = torch.cat([self.owned[i].reshape(-1) for i in idx])
            full = mine.new_empty(size * mine.numel())
            dist.all_gather_into_tensor(full, mine, group=group)
            record_collective("step:all_gather", full.numel() * full.element_size())
            full = full.view(size, -1)
            offset = 0
            for i in idx:
                n = self.owned[i].numel()
                self.params[i].detach().view(size, n).copy_(full[:, offset:offset + n])
                offset += n


class AcceleratedOptimizer:
    """Wraps a ``torch.optim.Optimizer``, or a factory that makes one from
    the param list (:func:`adamw`); :meth:`init` binds the factory. With
    ``accumulation_steps = k > 1`` every ``k``-th micro-step updates, on the
    mean of the window's gradients (``optax.MultiSteps``).

    ``fp8_partition`` is the JAX package's fp8 optimizer partition: the
    fp8 delayed-scaling meta leaves of the params (:attr:`meta`) stay out
    of the torch optimizer, of the flat gradients and of the accumulation
    window, and each micro-step replaces each of them by its gradient (its
    new histories), as ``old + (new - old)``. Under fused ZeRO-1 the meta
    leaves are the bucket plan's passthrough slots, partition or not, and
    take their gradient verbatim, as the JAX package's fused update does."""

    def __init__(self, optimizer: Union[torch.optim.Optimizer, Callable],
                 accumulation_steps: int = 1, fp8_partition: bool = False):
        if accumulation_steps < 1:
            raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
        self.base_optimizer = optimizer
        self.optimizer = optimizer if isinstance(optimizer, torch.optim.Optimizer) else None
        self.accumulation_steps = accumulation_steps
        self.schedule = getattr(optimizer, "schedule", None)
        self.transforms = getattr(optimizer, "transforms", ())
        self.mini_step = 0  # micro-steps into the current window
        self.gradient_step = 0  # inner updates taken
        self.acc_grads: Optional[torch.Tensor] = None  # flat running mean of the window
        self.scaler_config = None  # fp16: the GradScalerConfig of the loss scale below
        self.loss_scale: Optional[torch.Tensor] = None  # fp16: f32 scalar on the device
        self.growth_count: Optional[torch.Tensor] = None  # fp16: int32 scalar on the device
        self.plan = None  # the ShardingPlan of the params it was bound to under a mesh
        self.zero1 = None  # FusedZero1Update when the fused ZeRO-1 path is on
        self.zero1_rows: Optional[AnnotatedZero1] = None  # ZeRO-1 by annotation
        self.offload = None  # OptimizerOffload when the state lives on the host
        self.fp8_partition = fp8_partition
        self.meta_mask: list = []  # per param leaf (tree order): under an fp8_meta key
        self.meta: list = []  # the meta leaves replaced by their gradient, when split out
        self._meta_copy = False  # install the gradient verbatim (fused ZeRO-1)

    def init(self, params, plan=None):
        """Bind to ``params`` (a nested dict of tensors): a factory becomes
        an optimizer over its leaves. Under a ``plan`` with fused ZeRO-1
        (:mod:`.parallel.weight_update`) it is made over this rank's chunks
        of the param buckets instead, and every update ends with their
        all-gather into the params; with ZeRO-1 on another mesh (or the
        fused path off) over :class:`AnnotatedZero1`'s rows. On split params
        an :class:`Adafactor` reads whole params (:meth:`Adafactor.shard`).
        Returns :attr:`opt_state`."""
        if self.optimizer is None:
            from .ops.fp8 import fp8_meta_mask

            self.plan = plan
            self.meta_mask = fp8_meta_mask(params)
            zero1 = (plan is not None and plan.zero1_axis is not None
                     and plan.mesh.shape.get(plan.zero1_axis, 1) > 1)
            is_adafactor = getattr(self.base_optimizer, "cls", None) is Adafactor
            if plan is not None and plan.fused_zero1 and is_adafactor:
                # the fused update refuses adafactor (its statistics span a
                # whole param), as the JAX package's does: by annotation
                plan.zero1 = None
            passthrough = plan is not None and plan.fused_zero1 and bool(
                plan.zero1.passthrough_indices)
            leaves = param_leaves(params)
            if any(self.meta_mask) and (self.fp8_partition or passthrough):
                self._meta_copy = passthrough
                self.meta = [t for t, m in zip(leaves, self.meta_mask) if m]
                leaves = [t for t, m in zip(leaves, self.meta_mask) if not m]
                if plan is not None:
                    plan.meta_indices = tuple(i for i, m in enumerate(self.meta_mask) if m)
            if plan is not None and plan.fused_zero1:
                from .parallel.weight_update import init_bucketed_opt_state

                self.optimizer, self.zero1 = init_bucketed_opt_state(
                    self.base_optimizer, leaves, plan.zero1, plan.mesh)
                return self.opt_state
            if zero1:
                self.zero1_rows = AnnotatedZero1(leaves, plan.bound_specs(), plan.mesh,
                                                 plan.zero1_axis)
                self.optimizer = self.base_optimizer(self.zero1_rows.owned)
                if isinstance(self.optimizer, Adafactor):
                    # a rank's rows are a block of the param split on dim 0
                    # over the ZeRO-1 axis: every statistic stays the whole
                    # param's (the blocks' sums all-reduced over the axis)
                    shapes, dim_axes = plan.leaf_splits(leaves)
                    for j, rows in enumerate(self.zero1_rows.rows):
                        if rows is not None:
                            dim_axes[j] = ((plan.zero1_axis,), *dim_axes[j][1:])
                    self.optimizer.shard(self.zero1_rows.owned, shapes, dim_axes, plan.mesh)
                return self.opt_state
            self.optimizer = self.base_optimizer(leaves)
            if plan is not None and plan.sharded and isinstance(self.optimizer, Adafactor):
                self.optimizer.shard(leaves, *plan.leaf_splits(leaves), plan.mesh)
        return self.opt_state

    def split_leaves(self, leaves: list) -> tuple:
        """``(params, meta)``: the leaves the optimizer updates and the fp8
        meta leaves it replaces (none unless the meta was split out)."""
        if not self.meta:
            return leaves, []
        return ([t for t, m in zip(leaves, self.meta_mask) if not m],
                [t for t, m in zip(leaves, self.meta_mask) if m])

    @torch.no_grad()
    def install_meta(self, grads: Optional[list] = None) -> None:
        """Each meta leaf replaced by its gradient (``grads``, or its
        ``.grad``; zeros without one, as JAX's cotangent of an unused leaf),
        which is then cleared."""
        if grads is None:
            grads = [m.grad if m.grad is not None else torch.zeros_like(m) for m in self.meta]
        for m, g in zip(self.meta, grads):
            if self._meta_copy:
                m.copy_(g)
            else:  # optax's apply_updates of the partition's update, new - old
                m.add_(g - m)
            m.grad = None

    @property
    def opt_state(self):
        """The torch optimizer's per-param state (updated in place), or
        ``None`` before :meth:`init`."""
        return None if self.optimizer is None else self.optimizer.state

    @property
    def params(self) -> list:
        """The tensors the torch optimizer updates: the param leaves, this
        rank's bucket chunks under fused ZeRO-1, or its rows under ZeRO-1 by
        annotation."""
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    @property
    def model_params(self) -> list:
        """The param leaves it was bound to (this rank's blocks under a
        sharded plan)."""
        if self.zero1 is not None:
            return self.zero1.params
        if self.zero1_rows is not None:
            return self.zero1_rows.params
        return self.params

    @property
    def _grad_layout(self) -> list:
        """The tensors a flat gradient is laid out as: the chunks under fused
        ZeRO-1, else the param leaves."""
        return self.params if self.zero1 is not None else self.model_params

    def state_bytes(self) -> int:
        """Bytes of this rank's optimizer array state (scalars such as the
        step counts left out), wherever it lives."""
        return state_bytes(self.optimizer)

    def device_state_bytes(self) -> int:
        """Bytes of that state on the device (0 between steps when it is
        offloaded)."""
        return sum(v.numel() * v.element_size() for s in self.optimizer.state.values()
                   for v in s.values() if isinstance(v, torch.Tensor) and v.dim() > 0
                   and v.device.type != "cpu")

    def offload_state(self, enable: bool = True) -> None:
        """Keep the optimizer state in pinned host memory between updates
        and stage it onto the device group by group inside each one
        (:class:`~.parallel.sharding.OptimizerOffload`); ``enable=False``
        brings it back to the device. AdamW, Adam and SGD are elementwise:
        their params may be staged in blocks of rows."""
        if self.optimizer is None:
            raise ValueError("offload_optimizer needs the live optimizer state — call "
                             "prepare(params, optimizer) first")
        if not enable:
            if self.offload is not None:
                device = self.offload.device
                with torch.no_grad():
                    for st in self.optimizer.state.values():
                        for k, v in st.items():
                            if isinstance(v, torch.Tensor) and v.dim() > 0:
                                st[k] = v.to(device)
                self.offload = None
            return
        if self.offload is None:
            from .parallel.sharding import OptimizerOffload

            elementwise = isinstance(self.optimizer, (torch.optim.Adam, torch.optim.AdamW,
                                                      torch.optim.SGD, SGD))
            self.offload = OptimizerOffload(self.optimizer, self.params[0].device, elementwise)

    # ------------------------------------------------------------ updates --
    def _grads(self) -> list:
        """The ``.grad`` of the tensors a flat gradient is laid out as,
        zeros where one has none (as JAX's gradient of an unused leaf)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self._grad_layout]

    def flat_grads(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """:meth:`_grads` concatenated into one flat tensor, cast to
        ``dtype`` when given."""
        return torch.cat([g.reshape(-1).to(dtype or g.dtype) for g in self._grads()])

    def _split(self, flat: torch.Tensor) -> list:
        """Views of ``flat`` shaped as :attr:`_grad_layout`, in ``flat``'s
        dtype."""
        layout = self._grad_layout
        return [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in layout]), layout)]

    def _leaf_sumsq(self, grads: list) -> list:
        """Each gradient's whole-param sum of squares (f32)."""
        if self.plan is not None and self.plan.sharded and self.zero1 is None:
            return self.plan.leaf_sumsq(grads)
        return _local_leaf_sumsq(grads)

    def _inner_step(self, grads: Optional[list] = None) -> None:
        """One update from ``grads`` (one per param) or, when ``None``, from
        the params' ``.grad``. An optimizer that ``takes_grads`` gets them
        in their own dtype; any other reads them from ``.grad``, in the
        param's dtype."""
        if self.schedule is not None:  # optax reads the count before its increment
            lr = float(self.schedule(self.gradient_step))
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        if self.transforms or self.zero1_rows is not None:
            grads = self._grads() if grads is None else grads
        for transform in self.transforms:
            grads = transform(grads, self._leaf_sumsq)
        if self.zero1_rows is not None:
            grads = self.zero1_rows.owned_grads(grads)
        update = self.optimizer.step if self.offload is None else self.offload.step
        if getattr(self.optimizer, "takes_grads", False):
            update(grads=grads)
        else:
            for p, g in zip(self.params, grads or ()):
                if p.is_floating_point():  # a non-floating leaf has no gradient
                    p.grad = g.to(p.dtype)
            update()
        if self.zero1 is not None:
            self.zero1.all_gather()
        if self.zero1_rows is not None:
            self.zero1_rows.all_gather()
        self.gradient_step += 1

    def micro_step(self, flat: Optional[torch.Tensor] = None,
                   meta_grads: Optional[list] = None) -> None:
        """One micro-step on ``flat`` gradients (:meth:`flat_grads`'s
        layout), or on the params' ``.grad`` when ``None``; the fp8 meta
        takes ``meta_grads`` (or its ``.grad``) on every micro-step."""
        if self.meta:
            self.install_meta(meta_grads)
        k = self.accumulation_steps
        if k == 1:
            self._inner_step(None if flat is None else self._split(flat))
            return
        if flat is None:
            flat = self.flat_grads()
        if self.acc_grads is None:
            self.acc_grads = torch.zeros_like(flat)
        acc = self.acc_grads
        acc.add_((flat - acc) / (self.mini_step + 1))
        if self.mini_step == k - 1:
            self._inner_step(self._split(acc))
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
        flat = meta_grads = None
        if grads is not None:
            real, meta_grads = self.split_leaves(param_leaves(grads))
            flat = torch.cat([g.reshape(-1).to(p.dtype)
                              for p, g in zip(self._grad_layout, real)])
        self.micro_step(flat, meta_grads or None)
        return params

    def zero_grad(self, set_to_none: bool = True) -> None:
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=set_to_none)
        for m in self.meta:
            m.grad = None

    def update(self, grads, opt_state, params):
        """The JAX package's pure ``update``: ``(updates, new_state)`` for
        one update from ``grads`` (a tree like ``params``), leaving
        ``params`` and ``opt_state`` (:attr:`opt_state`) untouched. The
        step runs on copies of the params and of the torch optimizer;
        ``updates`` is the new copy less ``params`` in each param's dtype
        (what ``optax.apply_updates`` adds: exact whenever the two lie
        within a factor of two of each other, as one step's do), and
        ``new_state`` the copy's ``state_dict()``. One process's unsharded
        state, one update a call (no accumulation window)."""
        import copy

        from .utils.operations import _tree_map

        if self.optimizer is None:
            raise ValueError("the optimizer is not bound to params: prepare it with them")
        if opt_state is not self.opt_state:
            raise ValueError("opt_state is not this optimizer's state")
        if (self.zero1 is not None or self.zero1_rows is not None or self.offload is not None
                or (self.plan is not None and self.plan.distributed)
                or self.accumulation_steps > 1 or self.meta):
            raise NotImplementedError("update() takes one process's unsharded, on-device state, "
                                      "no accumulation window and no fp8 partition; the "
                                      "prepared step updates the others")
        bound = self.params
        leaves = param_leaves(params)
        if len(leaves) != len(bound) or any(a is not b for a, b in zip(leaves, bound)):
            raise ValueError("params are not the tensors the optimizer was prepared with")
        with torch.no_grad():
            clones = [p.detach().clone() for p in bound]
            opt = copy.deepcopy(self.optimizer, {id(p): c for p, c in zip(bound, clones)})
            if self.schedule is not None:
                lr = float(self.schedule(self.gradient_step))
                for group in opt.param_groups:
                    group["lr"] = lr
            grads = [g.detach() for g in param_leaves(grads)]
            for transform in self.transforms:
                grads = transform(grads, _local_leaf_sumsq)
            if getattr(opt, "takes_grads", False):
                opt.step(grads=grads)
            else:
                for c, g in zip(clones, grads):
                    if c.is_floating_point():
                        c.grad = g.to(c.dtype)
                opt.step()
            deltas = iter([c - p.detach() for c, p in zip(clones, bound)])
        return _tree_map(lambda _: next(deltas), params), opt.state_dict()

    def sync_from_params(self) -> None:
        """Refresh the copies of the params the optimizer owns (the fused
        ZeRO-1 chunks, the annotated ZeRO-1 rows) from the params, after
        the params were written in place (a checkpoint load)."""
        if self.optimizer is None:
            return
        with torch.no_grad():
            if self.zero1 is not None:
                z = self.zero1
                buckets = z.plan.bucket_tree([p.detach() for p in z.params])
                for chunk, name in zip(z.chunks, z.plan.bucket_names):
                    chunk.copy_(z._my_chunk(buckets[name], name))
            if self.zero1_rows is not None:
                z = self.zero1_rows
                for p, rows, owned in zip(z.params, z.rows, z.owned):
                    if rows is not None:
                        owned.copy_(p.detach()[rows])

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
