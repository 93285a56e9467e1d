"""Settings: the port of the precision, loss-scaling, accumulation,
placeholder-optimizer, kwargs-handler and plugin parts of
``accelerate_tpu.utils.dataclasses``.

The policy casts at well-defined boundaries, as the JAX package does,
rather than through ``torch.autocast``: under bf16 the whole param tree is
cast to bf16 once per step, and the model code alone decides where f32 is
used (norm statistics, logits, softmax). Autocast would instead pick a
dtype per operator from its own lists.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Optional, Union

import torch

__all__ = [
    "AORecipeKwargs",
    "AutocastConfig",
    "AutocastKwargs",
    "CheckpointConfig",
    "DDPCommunicationHookType",
    "DataLoaderConfiguration",
    "DeepSpeedPlugin",
    "DeepSpeedSequenceParallelConfig",
    "DistributedDataParallelKwargs",
    "DistributedType",
    "DummyOptim",
    "DummyScheduler",
    "FP8RecipeKwargs",
    "FullyShardedDataParallelPlugin",
    "GradScalerConfig",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "HfDeepSpeedConfig",
    "InitProcessGroupKwargs",
    "KwargsHandler",
    "LoggerType",
    "MSAMPRecipeKwargs",
    "MegatronLMPlugin",
    "MixedPrecisionPolicy",
    "PrecisionType",
    "ProjectConfiguration",
    "RNGType",
    "SaveFormat",
    "TERecipeKwargs",
    "TorchContextParallelConfig",
    "TorchTensorParallelConfig",
    "TorchTensorParallelPlugin",
    "deepspeed_required",
    "disable_fsdp_ram_efficient_loading",
    "enable_fsdp_ram_efficient_loading",
    "get_active_deepspeed_plugin",
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


class LoggerType(str, Enum):
    """The trackers by name (the JAX package's ``LoggerType``)."""

    ALL = "all"
    TENSORBOARD = "tensorboard"
    WANDB = "wandb"
    MLFLOW = "mlflow"
    COMETML = "comet_ml"
    AIM = "aim"
    CLEARML = "clearml"
    DVCLIVE = "dvclive"
    SWANLAB = "swanlab"
    TRACKIO = "trackio"
    JSONL = "jsonl"

    def __str__(self) -> str:
        return self.value


class SaveFormat(str, Enum):
    """The JAX package's ``SaveFormat`` names (the port writes ``npz`` and
    ``safetensors``)."""

    MSGPACK = "msgpack"
    SAFETENSORS = "safetensors"
    NUMPY = "npz"
    ORBAX = "orbax"

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


def _map_floats(tree, fn, skip_meta: bool = False):
    """``fn`` on every floating tensor leaf of a nested dict/list/tuple;
    integer leaves and non-tensors (a ``QuantizedArray`` among them) pass
    through, and with ``skip_meta`` so does every subtree under an
    ``"fp8_meta"`` key."""
    if isinstance(tree, dict):
        return type(tree)((k, v if skip_meta and k == "fp8_meta" else
                           _map_floats(v, fn, skip_meta)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_floats(v, fn, skip_meta) for v in tree)
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
    def _cast(tree, dtype, skip_meta: bool = False):
        if dtype is None:
            return tree
        return _map_floats(tree, lambda t: t.to(dtype), skip_meta)

    def cast_to_compute(self, tree):
        """Floating leaves to the compute dtype. On tensors that require
        grad this is an autograd op: gradients flow back through it to the
        param dtype, which is :meth:`cast_to_param` of the gradients. fp8
        delayed-scaling meta and ``QuantizedArray`` leaves pass through
        untouched, as in the JAX package (bf16 histories and scales would
        lose their precision)."""
        return self._cast(tree, self.compute_dtype, skip_meta=True)

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




# ---------------------------------------------------------------------------
# The kwargs handlers and plugins of the JAX package. Each translates a
# reference spelling into the port's own configuration: a mesh
# (ParallelismConfig), a precision, a clip chained ahead of the optimizer,
# the optimizer state offloaded to pinned host memory.


class KwargsHandler:
    """Base of the kwargs handlers (the JAX package's): ``to_dict`` gives
    every field, ``to_kwargs`` the fields that differ from the defaults."""

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    def to_kwargs(self) -> dict:
        from dataclasses import fields

        default = self.__class__()
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) != getattr(default, f.name)}


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Where checkpoints and logs go (the JAX package's): ``project_dir``,
    ``logging_dir`` (the project dir unless given), automatic
    ``checkpoint_<i>`` naming with its ``iteration`` counter, and the
    ``total_limit`` of automatically named checkpoints kept."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False

    def set_directories(self, project_dir: Optional[str] = None) -> None:
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir


@dataclass
class CheckpointConfig(KwargsHandler):
    """Asynchronous checkpointing (the JAX package's). ``async_save``: the
    default of ``Accelerator.save_state``'s ``blocking`` (``blocking=not
    async_save``), seeded from ``ACCELERATE_ASYNC_CHECKPOINT``; an async
    save returns after the snapshot to host memory and one writer thread
    writes and commits it. ``max_in_flight``: how many snapshots may be
    queued or writing at once (a further save waits for a slot).
    ``save_on_each_node``: the default of ``save_state``'s keyword."""

    async_save: bool = field(
        default_factory=lambda: _env_flag("ACCELERATE_ASYNC_CHECKPOINT"))
    max_in_flight: int = 1
    save_on_each_node: bool = False

    def __post_init__(self):
        if self.max_in_flight < 1:
            raise ValueError(f"max_in_flight must be >= 1, got {self.max_in_flight}")


@dataclass
class AutocastConfig(KwargsHandler):
    """Scoped opt-out of the compute policy (the JAX package's): train
    steps built inside ``Accelerator.autocast(AutocastConfig(enabled=
    False))`` compute in the param dtype; steps built before keep theirs."""

    enabled: bool = True
    cache_enabled: bool = True


#: the JAX package's spellings of the same handlers
AutocastKwargs = AutocastConfig


def _env_flag(key: str) -> bool:
    from .environment import parse_flag_from_env

    return parse_flag_from_env(key, False)


def _num_processes() -> int:
    """The processes of the run: the process group's size when one is up,
    else the launcher's ``WORLD_SIZE`` (or ``ACCELERATE_NUM_PROCESSES``). The
    port runs one process per device, so this is its device count."""
    import torch.distributed as dist

    from .environment import get_int_from_env

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return get_int_from_env(("ACCELERATE_NUM_PROCESSES", "WORLD_SIZE"), 1)


@dataclass
class InitProcessGroupKwargs(KwargsHandler):
    """Options of the process group (the JAX package's fields):
    ``coordinator_address`` (``host:port`` or ``file:///path``),
    ``num_processes``, ``process_id``, and ``initialization_timeout``, which
    bounds the rendezvous and is the timeout of ``init_process_group``.
    ``local_device_ids`` is accepted for the surface: a process drives one
    device, so at most one id may be given."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[list] = None
    initialization_timeout: timedelta = field(default_factory=lambda: timedelta(seconds=300))


class DDPCommunicationHookType(str, Enum):
    """Gradient-compression choices (the JAX package's)."""

    NO = "no"
    FP16 = "fp16"
    BF16 = "bf16"
    POWER_SGD = "power_sgd"
    BATCHED_POWER_SGD = "batched_power_sgd"

    def __str__(self) -> str:
        return self.value


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """The JAX package's ``DistributedDataParallelKwargs``: the bucket and
    graph fields are accepted and have no effect; ``comm_hook`` selects
    :meth:`gradient_compression_dtype`, which the train step applies to the
    gradient: cast to that dtype and back, after the reduction over the
    batch ranks and before the fp16 unscale (the JAX package's arithmetic;
    the wire itself still carries the gradient's own dtype)."""

    bucket_cap_mb: int = 25
    find_unused_parameters: bool = False
    gradient_as_bucket_view: bool = False
    static_graph: bool = False
    comm_hook: DDPCommunicationHookType = DDPCommunicationHookType.NO

    def __post_init__(self):
        self.comm_hook = DDPCommunicationHookType(str(self.comm_hook))

    def gradient_compression_dtype(self) -> Optional[torch.dtype]:
        """The dtype the gradient is bounded to, or None. PowerSGD has no
        counterpart: it warns and gives bf16, as in the JAX package."""
        if self.comm_hook == DDPCommunicationHookType.FP16:
            return torch.float16
        if self.comm_hook == DDPCommunicationHookType.BF16:
            return torch.bfloat16
        if self.comm_hook in (DDPCommunicationHookType.POWER_SGD,
                              DDPCommunicationHookType.BATCHED_POWER_SGD):
            warnings.warn("PowerSGD low-rank gradient compression has no XLA counterpart; "
                          "falling back to a bf16 cast of the gradient signal.")
            return torch.bfloat16
        return None


@dataclass
class FullyShardedDataParallelPlugin(KwargsHandler):
    """The JAX package's FSDP plugin: FSDP is the ``dp_shard`` mesh axis, so
    the plugin's job is :meth:`to_parallelism_config`. ``sharding_strategy``
    takes the reference spellings (``FULL_SHARD``, ``SHARD_GRAD_OP``,
    ``NO_SHARD``, ``HYBRID_SHARD``, their codes 1–4, or
    ``ShardingStrategy.X``); ``cpu_offload`` offloads the optimizer state to
    pinned host memory (``Accelerator.prepare_train_step``);
    ``activation_checkpointing`` is :attr:`remat`;
    ``cpu_ram_efficient_loading`` defaults to ``FSDP_CPU_RAM_EFFICIENT_LOADING``
    (true when unset), an explicit value wins."""

    sharding_strategy: Any = "FULL_SHARD"
    cpu_offload: bool = False
    activation_checkpointing: bool = False
    state_dict_type: str = "SHARDED_STATE_DICT"
    cpu_ram_efficient_loading: Optional[bool] = None

    _STRATEGIES = {1: "FULL_SHARD", 2: "SHARD_GRAD_OP", 3: "NO_SHARD", 4: "HYBRID_SHARD"}

    def __post_init__(self):
        if self.cpu_ram_efficient_loading is None:
            flag = os.environ.get("FSDP_CPU_RAM_EFFICIENT_LOADING", "true")
            self.cpu_ram_efficient_loading = flag.strip().lower() in ("1", "true", "yes")
        s = self.sharding_strategy
        if isinstance(s, int):
            if s not in self._STRATEGIES:
                raise ValueError(f"unknown sharding_strategy code {s} "
                                 f"(valid: {sorted(self._STRATEGIES)})")
            s = self._STRATEGIES[s]
        s = str(s).rsplit(".", 1)[-1].upper()
        if s not in self._STRATEGIES.values():
            raise ValueError(f"unknown sharding_strategy {self.sharding_strategy!r}")
        self.sharding_strategy = s

    @property
    def remat(self) -> Union[bool, str]:
        """``activation_checkpointing`` as a forward's ``remat=``: the
        ``"dots_no_batch"`` policy, or False."""
        return "dots_no_batch" if self.activation_checkpointing else False

    def to_parallelism_config(self, num_devices: Optional[int] = None,
                              dp_replicate_size: int = 1):
        """The mesh config: ``NO_SHARD`` replicates over ``num_devices`` (the
        process count by default; one process per device), the others shard
        over ``dp_shard``; ``HYBRID_SHARD`` needs ``dp_replicate_size > 1``."""
        from ..parallelism_config import ParallelismConfig

        if self.sharding_strategy == "NO_SHARD":
            return ParallelismConfig(dp_replicate_size=num_devices or _num_processes())
        if self.sharding_strategy == "HYBRID_SHARD" and dp_replicate_size == 1:
            raise ValueError("HYBRID_SHARD requires dp_replicate_size > 1")
        return ParallelismConfig(dp_replicate_size=dp_replicate_size, dp_shard_size=-1)


def _is_auto(v) -> bool:
    return isinstance(v, str) and v == "auto"


@dataclass
class DeepSpeedPlugin(KwargsHandler):
    """The JAX package's DeepSpeed plugin. ZeRO stages are meshes: stage 0
    replicates; stage 1 keeps the params replicated and shards the optimizer
    state over ``dp_replicate`` (the fused ZeRO-1 update of
    :mod:`..parallel.weight_update` on a pure data-parallel mesh of floating
    params, by annotation elsewhere); stages 2 and 3 are FSDP over
    ``dp_shard``. ``gradient_clipping`` is chained ahead of the optimizer as
    ``clip_by_global_norm``; ``offload_optimizer_device`` ``"cpu"`` (or
    ``"nvme"``, which warns and means host memory) offloads the optimizer
    state to pinned host memory. ``hf_ds_config`` (a dict) fills each field
    still at its default (an explicit value wins, with a warning when they
    differ; ``"auto"`` fills nothing), and gives :attr:`mixed_precision`,
    :meth:`dummy_optim_kwargs` and :meth:`dummy_scheduler_kwargs`.
    ``offload_param_device``, ``zero3_init_flag`` and ``zero3_save_16bit_model``
    are kept for the surface."""

    zero_stage: int = 2
    gradient_accumulation_steps: int = 1
    gradient_clipping: Optional[float] = None
    offload_optimizer_device: Optional[str] = None
    offload_param_device: Optional[str] = None
    zero3_init_flag: bool = False
    zero3_save_16bit_model: bool = False
    hf_ds_config: Optional[dict] = None

    def __post_init__(self):
        cfg = self.hf_ds_config or {}
        zero = cfg.get("zero_optimization", {})

        def fill(attr, value, cast):
            if value is None or _is_auto(value):
                return
            value = cast(value)
            current = getattr(self, attr)
            if current == type(self).__dataclass_fields__[attr].default:
                setattr(self, attr, value)
            elif current != value:
                warnings.warn(f"DeepSpeedPlugin.{attr}={current!r} (explicit) disagrees with "
                              f"hf_ds_config value {value!r}; keeping the explicit value")

        fill("zero_stage", zero.get("stage"), int)
        fill("gradient_accumulation_steps", cfg.get("gradient_accumulation_steps"), int)
        fill("gradient_clipping", cfg.get("gradient_clipping"), float)
        for src, attr in (("offload_optimizer", "offload_optimizer_device"),
                          ("offload_param", "offload_param_device")):
            dev = zero.get(src, {}).get("device")
            if dev and dev != "none":
                fill(attr, dev, str)
        if not 0 <= self.zero_stage <= 3:
            raise ValueError(f"zero_stage must be 0-3, got {self.zero_stage}")

    @classmethod
    def from_env(cls) -> "DeepSpeedPlugin":
        """From the launcher's environment: ``ACCELERATE_DEEPSPEED_ZERO_STAGE``,
        ``ACCELERATE_GRADIENT_CLIPPING``, the offload devices
        (``ACCELERATE_DEEPSPEED_OFFLOAD_{OPTIMIZER,PARAM}_DEVICE``),
        ``ACCELERATE_DEEPSPEED_CONFIG_FILE`` (a JSON file read into
        ``hf_ds_config``) and ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``."""
        kwargs: dict = {}
        stage = os.environ.get("ACCELERATE_DEEPSPEED_ZERO_STAGE")
        if stage is not None and not _is_auto(stage):
            kwargs["zero_stage"] = int(stage)
        clip = os.environ.get("ACCELERATE_GRADIENT_CLIPPING")
        if clip is not None and not _is_auto(clip):
            kwargs["gradient_clipping"] = float(clip)
        for env, attr in (("ACCELERATE_DEEPSPEED_OFFLOAD_OPTIMIZER_DEVICE",
                           "offload_optimizer_device"),
                          ("ACCELERATE_DEEPSPEED_OFFLOAD_PARAM_DEVICE", "offload_param_device")):
            dev = os.environ.get(env)
            if dev and dev != "none":
                kwargs[attr] = dev
        config_file = os.environ.get("ACCELERATE_DEEPSPEED_CONFIG_FILE")
        if config_file:
            with open(config_file) as f:
                kwargs["hf_ds_config"] = json.load(f)
        accum = os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS")
        if accum is not None and not _is_auto(accum):
            kwargs["gradient_accumulation_steps"] = int(accum)
        return cls(**kwargs)

    def to_parallelism_config(self, num_devices: Optional[int] = None):
        """Stages 0 and 1 replicate over ``num_devices`` (the process count
        by default); stages 2 and 3 shard over ``dp_shard``."""
        from ..parallelism_config import ParallelismConfig

        if self.zero_stage in (0, 1):
            return ParallelismConfig(dp_replicate_size=num_devices or _num_processes())
        return ParallelismConfig(dp_shard_size=-1)

    @property
    def mixed_precision(self) -> Optional[str]:
        """``"bf16"`` or ``"fp16"`` when the ds config enables that section,
        else None."""
        cfg = self.hf_ds_config or {}
        if cfg.get("bf16", {}).get("enabled") is True:
            return "bf16"
        if cfg.get("fp16", {}).get("enabled") is True:
            return "fp16"
        return None

    def dummy_optim_kwargs(self) -> dict:
        """``DummyOptim`` keyword arguments from the ds config's optimizer
        params (``lr``, ``weight_decay``, ``betas``, ``eps``; ``"auto"``
        left out)."""
        params = (self.hf_ds_config or {}).get("optimizer", {}).get("params", {})
        out: dict = {}
        for key, cast in (("lr", float), ("weight_decay", float), ("betas", tuple),
                          ("eps", float)):
            v = params.get(key)
            if v is not None and not _is_auto(v):
                out[key] = cast(v)
        return out

    def dummy_scheduler_kwargs(self) -> dict:
        """``DummyScheduler`` fields from the ds config's scheduler params
        (``total_num_steps``, ``warmup_num_steps``)."""
        params = (self.hf_ds_config or {}).get("scheduler", {}).get("params", {})
        out: dict = {}
        for key in ("total_num_steps", "warmup_num_steps"):
            v = params.get(key)
            if v is not None and not _is_auto(v):
                out[key] = int(v)
        return out


@dataclass
class MegatronLMPlugin(KwargsHandler):
    """The JAX package's Megatron-LM plugin: its degrees are the mesh
    (:meth:`to_parallelism_config`; ``dp_shard`` takes the rest).
    ``num_micro_batches`` becomes the accumulation steps,
    ``gradient_clipping`` a clip chained ahead of the optimizer,
    ``recompute_activations`` :attr:`remat`; ``sequence_parallelism`` maps to
    nothing (a flag on the ``tp`` group, not an axis). A ``pp`` degree
    above 1 raises when the step is built (ROADMAP.md Queue A item 11b)."""

    tp_degree: int = 1
    pp_degree: int = 1
    num_micro_batches: int = 1
    expert_model_parallel_size: int = 1
    context_parallel_size: int = 1
    sequence_parallelism: bool = False
    gradient_clipping: Optional[float] = None
    use_distributed_optimizer: bool = False
    recompute_activations: bool = False
    other_megatron_args: Optional[dict] = None

    @property
    def remat(self) -> Union[bool, str]:
        return "dots_no_batch" if self.recompute_activations else False

    def to_parallelism_config(self):
        from ..parallelism_config import ParallelismConfig

        return ParallelismConfig(tp_size=self.tp_degree, pp_size=self.pp_degree,
                                 ep_size=self.expert_model_parallel_size,
                                 cp_size=self.context_parallel_size, dp_shard_size=-1)


@dataclass
class TorchContextParallelConfig(KwargsHandler):
    """The JAX package's migration shim for the reference's context
    parallel config: ``cp_comm_strategy`` (``PARALLELISM_CONFIG_CP_COMM_
    STRATEGY``, default ``"allgather"``) maps onto ``cp_rotate_method``:
    ``allgather`` to the all-gather rotation, ``alltoall`` to the zig-zag
    load-balanced ring."""

    cp_comm_strategy: Optional[str] = None

    def __post_init__(self):
        if self.cp_comm_strategy is None:
            self.cp_comm_strategy = os.environ.get("PARALLELISM_CONFIG_CP_COMM_STRATEGY",
                                                   "allgather")
        if self.cp_comm_strategy not in ("allgather", "alltoall"):
            raise ValueError(f"cp_comm_strategy must be 'allgather' or 'alltoall', got "
                             f"{self.cp_comm_strategy!r}")

    @property
    def cp_rotate_method(self) -> str:
        return "allgather" if self.cp_comm_strategy == "allgather" else "zigzag"


@dataclass
class TorchTensorParallelConfig(KwargsHandler):
    """The JAX package's migration shim for the reference's tensor parallel
    config: ``enable_async_tp`` is accepted and ignored, with a warning (the
    sharded step's collectives are the port's own)."""

    enable_async_tp: bool = False

    def __post_init__(self):
        if self.enable_async_tp:
            warnings.warn("async tensor parallelism is not a knob of the sharded step; "
                          "ignoring enable_async_tp", stacklevel=2)


@dataclass
class TorchTensorParallelPlugin(KwargsHandler):
    """The JAX package's migration shim: a TP plugin is the ``tp`` axis
    size, ``dp_shard`` takes the rest."""

    tp_size: int = 1
    torch_device_mesh: Any = None  # accepted for signature parity

    def to_parallelism_config(self):
        from ..parallelism_config import ParallelismConfig

        return ParallelismConfig(tp_size=self.tp_size, dp_shard_size=-1)


@dataclass
class DeepSpeedSequenceParallelConfig(KwargsHandler):
    """The JAX package's migration shim for the reference's Ulysses
    config: the sequence-length knobs are accepted (Ulysses runs at any
    length that divides over ``sp``); ``sp_attn_implementation`` maps onto
    ``attention_impl``. Defaults from ``PARALLELISM_CONFIG_SP_SEQ_LENGTH_IS_
    VARIABLE`` (``"true"``) and ``PARALLELISM_CONFIG_SP_ATTN_
    IMPLEMENTATION``."""

    sp_seq_length: Optional[int] = None
    sp_seq_length_is_variable: Optional[bool] = None
    sp_attn_implementation: Optional[str] = None

    def __post_init__(self):
        if self.sp_seq_length_is_variable is None:
            self.sp_seq_length_is_variable = os.environ.get(
                "PARALLELISM_CONFIG_SP_SEQ_LENGTH_IS_VARIABLE", "true").lower() == "true"
        if self.sp_attn_implementation is None:
            self.sp_attn_implementation = os.environ.get(
                "PARALLELISM_CONFIG_SP_ATTN_IMPLEMENTATION", None)
        if self.sp_attn_implementation is not None and self.sp_attn_implementation not in (
                "flash_attention_2", "flash_attention_3", "sdpa"):
            raise ValueError(f"invalid sp_attn_implementation {self.sp_attn_implementation!r}")

    @property
    def attention_impl(self) -> str:
        """The ``attention_impl`` of the model forward."""
        if self.sp_attn_implementation in ("flash_attention_2", "flash_attention_3"):
            return "flash"
        return "xla"


@dataclass
class FP8RecipeKwargs(KwargsHandler):
    """The JAX package's ``FP8RecipeKwargs``: every backend spelling maps
    onto the one delayed-scaling recipe of :mod:`..ops.fp8`
    (:meth:`to_native`). ``interval``, ``override_linear_precision`` and
    ``use_autocast_during_eval`` are accepted for the surface."""

    backend: Optional[str] = None
    margin: int = 0
    interval: int = 1
    fp8_format: str = "HYBRID"
    amax_history_len: int = 16
    amax_compute_algo: str = "max"
    override_linear_precision: Any = None
    use_autocast_during_eval: bool = False

    def __post_init__(self):
        if self.backend is not None:
            self.backend = str(self.backend).upper()
            if self.backend not in ("TE", "MSAMP", "AO"):
                raise ValueError(f"unknown fp8 backend {self.backend!r}")
        self.fp8_format = str(self.fp8_format).upper()
        if self.fp8_format not in ("HYBRID", "E4M3"):
            raise ValueError(f"unknown fp8_format {self.fp8_format!r} (valid: HYBRID, E4M3)")

    def to_native(self):
        from ..ops.fp8 import FP8Recipe

        return FP8Recipe(margin=self.margin, amax_history_len=self.amax_history_len,
                         amax_compute_algo=self.amax_compute_algo, fp8_format=self.fp8_format)


@dataclass
class TERecipeKwargs(FP8RecipeKwargs):
    """The TransformerEngine spelling of :class:`FP8RecipeKwargs`."""

    def __post_init__(self):
        self.backend = "TE"
        super().__post_init__()


@dataclass
class AORecipeKwargs(FP8RecipeKwargs):
    """The torchao spelling; ``config`` and ``module_filter_func`` are
    accepted for the surface."""

    config: Any = None
    module_filter_func: Any = None

    def __post_init__(self):
        self.backend = "AO"
        super().__post_init__()


@dataclass
class MSAMPRecipeKwargs(FP8RecipeKwargs):
    """The MS-AMP spelling; ``opt_level`` is accepted for the surface."""

    opt_level: str = "O2"

    def __post_init__(self):
        self.backend = "MSAMP"
        super().__post_init__()


class HfDeepSpeedConfig:
    """A ds config (a dict, or the path of a JSON file) with dotted-path
    access and the stage probes (the JAX package's)."""

    def __init__(self, config_file_or_dict):
        if isinstance(config_file_or_dict, dict):
            self.config = dict(config_file_or_dict)
        else:
            with open(config_file_or_dict) as f:
                self.config = json.load(f)

    def get_value(self, ds_key_long: str, default=None):
        node = self.config
        for part in ds_key_long.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def is_true(self, ds_key_long: str) -> bool:
        return bool(self.get_value(ds_key_long))

    def is_false(self, ds_key_long: str) -> bool:
        value = self.get_value(ds_key_long)
        return value is not None and not bool(value)

    def is_zero2(self) -> bool:
        return self.get_value("zero_optimization.stage") == 2

    def is_zero3(self) -> bool:
        return self.get_value("zero_optimization.stage") == 3

    def is_offload(self) -> bool:
        return any(self.get_value(f"zero_optimization.{key}.device") not in (None, "none")
                   for key in ("offload_optimizer", "offload_param"))


def get_active_deepspeed_plugin(state_or_accelerator):
    """The active :class:`DeepSpeedPlugin` of an ``Accelerator`` (or anything
    with ``deepspeed_plugin``; of a dict of them, the ``selected`` one);
    raises when there is none."""
    plugin = getattr(state_or_accelerator, "deepspeed_plugin", None)
    if isinstance(plugin, dict):
        for p in plugin.values():
            if getattr(p, "selected", False):
                return p
        raise ValueError("no DeepSpeedPlugin in the dict is selected")
    if plugin is None:
        raise ValueError("no DeepSpeedPlugin is active; pass deepspeed_plugin= to Accelerator")
    return plugin


def deepspeed_required(func):
    """Decorator: the method needs an active :class:`DeepSpeedPlugin`."""
    import functools

    @functools.wraps(func)
    def wrapper(self, *args, **kwargs):
        get_active_deepspeed_plugin(self)
        return func(self, *args, **kwargs)

    return wrapper


def enable_fsdp_ram_efficient_loading() -> None:
    """Make :class:`FullyShardedDataParallelPlugin` default to
    ``cpu_ram_efficient_loading=True`` (``FSDP_CPU_RAM_EFFICIENT_LOADING``)."""
    os.environ["FSDP_CPU_RAM_EFFICIENT_LOADING"] = "true"


def disable_fsdp_ram_efficient_loading() -> None:
    os.environ["FSDP_CPU_RAM_EFFICIENT_LOADING"] = "false"


GradScalerKwargs = GradScalerConfig
