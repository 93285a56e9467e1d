"""Settings: the port of the precision, loss-scaling, accumulation and
placeholder-optimizer parts of ``accelerate_tpu.utils.dataclasses``.

The policy casts at well-defined boundaries, as the JAX package does,
rather than through ``torch.autocast``: under bf16 the whole param tree is
cast to bf16 once per step, and the model code alone decides where f32 is
used (norm statistics, logits, softmax). Autocast would instead pick a
dtype per operator from its own lists.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional, Union

import torch

__all__ = [
    "DataLoaderConfiguration",
    "DeepSpeedPlugin",
    "DistributedType",
    "DummyOptim",
    "DummyScheduler",
    "GradScalerConfig",
    "GradientAccumulationPlugin",
    "MixedPrecisionPolicy",
    "PrecisionType",
    "RNGType",
]


class DistributedType(str, Enum):
    """How this process takes part in a run (the JAX package's values; see
    :mod:`..state` for how the port's one process per device maps onto
    them)."""

    NO = "NO"
    SPMD = "SPMD"
    MULTI_HOST = "MULTI_HOST"

    def __str__(self) -> str:
        return self.value


class PrecisionType(str, Enum):
    """Mixed-precision modes (the JAX package's ``PrecisionType``)."""

    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8 = "fp8"

    def __str__(self) -> str:
        return self.value


class RNGType(str, Enum):
    """The host random streams a prepared loader synchronizes (the JAX
    package's names; its ``jax`` stream is the global key, which the port
    does not keep)."""

    JAX = "jax"
    NUMPY = "numpy"
    PYTHON = "python"
    TORCH = "torch"
    GENERATOR = "generator"

    def __str__(self) -> str:
        return self.value


@dataclass
class DataLoaderConfiguration:
    """How :meth:`~..accelerator.Accelerator.prepare_data_loader` prepares a
    loader (the JAX package's fields): ``dispatch_batches`` reads on rank 0
    and broadcasts, ``even_batches`` wraps the last round around,
    ``data_seed`` seeds the shuffle of a rebuilt torch loader,
    ``use_stateful_dataloader`` asks for a loader with state of its own,
    ``prefetch_depth`` is how many batches the producer thread reads ahead
    (0: synchronous) and ``non_blocking`` makes its device copies
    asynchronous."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    non_blocking: bool = True
    use_stateful_dataloader: bool = False
    data_seed: Optional[int] = None
    prefetch_depth: int = 2


def _map_floats(tree, fn):
    """``fn`` on every floating tensor leaf of a nested dict/list/tuple;
    integer leaves and non-tensors pass through."""
    if isinstance(tree, dict):
        return type(tree)((k, _map_floats(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, fn) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


@dataclass(frozen=True)
class MixedPrecisionPolicy:
    """dtype policy for params / compute / output; ``None`` leaves a dtype
    untouched."""

    param_dtype: Optional[torch.dtype] = None
    compute_dtype: Optional[torch.dtype] = None
    output_dtype: Optional[torch.dtype] = None

    @classmethod
    def from_precision(cls, precision: Union[str, PrecisionType]) -> "MixedPrecisionPolicy":
        precision = PrecisionType(str(precision))
        if precision == PrecisionType.NO:
            return cls(None, None, None)
        if precision == PrecisionType.BF16:
            return cls(torch.float32, torch.bfloat16, torch.float32)
        if precision == PrecisionType.FP16:
            return cls(torch.float32, torch.float16, torch.float32)
        # fp8 applies per matmul; activations stay bf16
        return cls(torch.float32, torch.bfloat16, torch.float32)

    @staticmethod
    def _cast(tree, dtype):
        if dtype is None:
            return tree
        return _map_floats(tree, lambda t: t.to(dtype))

    def cast_to_compute(self, tree):
        """Floating leaves to the compute dtype. On tensors that require
        grad this is an autograd op: gradients flow back through it to the
        param dtype, which is :meth:`cast_to_param` of the gradients."""
        return self._cast(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return self._cast(tree, self.param_dtype)


@dataclass
class GradientAccumulationPlugin:
    """How micro-steps group into optimizer updates (the JAX package's
    ``GradientAccumulationPlugin``): ``num_steps`` micro-steps an update;
    ``sync_with_dataloader`` forces an update on a loader's last batch;
    ``sync_each_batch`` marks every micro-step as a sync step;
    ``adjust_scheduler`` is kept for the surface (the scheduler steps on
    sync steps only)."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"gradient accumulation steps must be >= 1, got {self.num_steps}")


@dataclass
class GradScalerConfig:
    """fp16 dynamic loss scaling (the JAX package's ``GradScalerConfig``):
    the loss is multiplied by the scale before the backward; a micro-step
    whose unscaled gradients are not all finite backs the scale off by
    ``backoff_factor`` (never below 1), ``growth_interval`` finite
    micro-steps in a row grow it by ``growth_factor``. ``enabled`` is kept
    for the surface; as in the JAX package, ``mixed_precision="fp16"``
    always scales."""

    init_scale: float = 2.0 ** 15
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


class DummyOptim:
    """Placeholder optimizer (the JAX package's ``DummyOptim``):
    ``Accelerator.prepare`` makes it an AdamW from the recorded
    hyperparameters. ``weight_decay`` defaults to 0.0, not :func:`adamw`'s
    1e-4; ``betas`` and ``eps`` carry over."""

    def __init__(self, params=None, lr: float = 1e-3, weight_decay: float = 0.0, **kwargs):
        self.params = params
        self.lr = lr
        self.weight_decay = weight_decay
        self.kwargs = kwargs

    def to_adamw(self, learning_rate: Optional[Union[float, Callable]] = None):
        """The AdamW factory (the JAX package's ``to_optax``); a
        ``learning_rate`` schedule overrides the constant ``lr``."""
        from ..optimizer import adamw

        kwargs = dict(self.kwargs)
        b1, b2 = kwargs.pop("betas", (0.9, 0.999))
        eps = kwargs.pop("eps", 1e-8)
        kwargs.pop("params", None)
        if kwargs:
            warnings.warn(f"DummyOptim: ignoring unsupported hyperparameters {sorted(kwargs)}",
                          stacklevel=2)
        return adamw(learning_rate if learning_rate is not None else self.lr, b1=b1, b2=b2,
                     eps=eps, weight_decay=self.weight_decay)


class DummyScheduler:
    """Placeholder scheduler (the JAX package's ``DummyScheduler``):
    ``Accelerator.prepare`` makes it a linear warmup over
    ``warmup_num_steps`` then a linear decay to 0 at ``total_num_steps``
    (held when that is ``None``) around the paired optimizer's lr, or the
    scheduler ``lr_scheduler_callable(optimizer)`` returns."""

    def __init__(self, optimizer=None, total_num_steps: Optional[int] = None,
                 warmup_num_steps: int = 0, lr_scheduler_callable=None, **kwargs):
        self.optimizer = optimizer
        self.total_num_steps = total_num_steps
        self.warmup_num_steps = warmup_num_steps
        self.lr_scheduler_callable = lr_scheduler_callable
        self.kwargs = kwargs


@dataclass
class DeepSpeedPlugin:
    """The ZeRO stage of the JAX package's ``DeepSpeedPlugin``, the only
    field of it the port reads: stage 1 keeps the params replicated and
    shards the optimizer state over ``dp_replicate`` (the fused ZeRO-1
    update of :mod:`..parallel.weight_update`, on a pure data-parallel mesh
    of floating params; the ``Accelerator`` raises on any other); stages 2
    and 3 are FSDP over ``dp_shard``; stage 0 is plain replication."""

    zero_stage: int = 2

    def __post_init__(self):
        if not 0 <= self.zero_stage <= 3:
            raise ValueError(f"zero_stage must be 0-3, got {self.zero_stage}")

    def to_parallelism_config(self, num_devices: int):
        from ..parallelism_config import ParallelismConfig

        if self.zero_stage in (0, 1):
            return ParallelismConfig(dp_replicate_size=num_devices)
        return ParallelismConfig(dp_shard_size=-1)
