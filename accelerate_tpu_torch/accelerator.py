"""The training entry point: the port of ``accelerate_tpu.accelerator``.

``Accelerator.prepare`` places params, binds optimizers (``DummyOptim`` /
``DummyScheduler`` included), wraps schedulers and data loaders;
``prepare_train_step`` / ``prepare_train_loop`` build the step the JAX
package compiles in ``_build_train_step``: cast params and batch to the
compute dtype, ``loss_fn``, loss to f32 (times the loss scale under fp16),
backward (gradients come back through the cast in the param dtype), under
fp16 the gradients unscaled and zeroed when any is not finite, the
optimizer's micro-step (an update at each accumulation boundary),
``metrics = {"loss", ["grad_norm"], ["aux"], ["grads_finite",
"loss_scale"]}``.

The signatures stay functional — ``step(params, opt_state, batch)`` and
``loop(params, opt_state, batches)`` return ``(params, opt_state,
metrics)`` — but the params and the optimizer state are updated **in
place** and the same objects are returned. The loop's K micro-steps run as
a Python loop with no host sync inside it: accumulation boundaries are a
host count, the loss scale, its growth count and the finite flag stay on
the device, and the metrics stay there until the caller reads them.

Clipping inside the step is the optimizer's: ``chain(clip_by_global_norm(
...), tx)`` (:mod:`.optimizer`).

Under a mesh (``parallelism_config=``; one process per device, see
:mod:`.state`), ``prepare_model`` places each rank's block of every param
through one :func:`~.parallel.sharding.make_sharding_plan` call,
``prepare_optimizer`` binds the optimizer to those blocks (or, with
``DeepSpeedPlugin(zero_stage=1)`` on a pure data-parallel mesh, to this
rank's chunks of the fused ZeRO-1 buckets), and ``prepare_data_loader``
gives each rank its data-parallel row's batches (as
``dataloader_config`` says: prefetch depth, seeding, dispatch, stateful
loaders; ``rng_types`` are synchronized each epoch). The same step then
gathers the params, runs ``loss_fn`` on the rank's rows, sums the gradients
over the batch ranks and divides by their count (the mean over the global
batch when every rank's loss is the mean over its rows; ``llama_loss(mesh=)``
makes that exact with masks too), and reports the loss averaged over the
batch ranks. A plan whose axes all have size 1 runs the plain step. The
stacked layers are gathered one at a time inside the forward
(:class:`~.parallel.sharding.LayerStack`), so ``dp_shard`` (FSDP) cuts the
peak within a step as well as what params, gradients and optimizer state
hold between steps. ZeRO-1 where the fused update cannot run shards the
optimizer state by annotation (:class:`~.optimizer.AnnotatedZero1`);
adafactor and a global-norm clip read whole params on split blocks; under
fp16 every rank takes the same finite decision; ``gradient_fn`` gives each
rank its blocks of the global gradient.

The kwargs handlers and plugins are the JAX package's:
``DistributedDataParallelKwargs(comm_hook=)`` bounds the (reduced,
still loss-scaled) gradient to fp16 or bf16; ``InitProcessGroupKwargs``
reaches the process group; ``DeepSpeedPlugin`` (with its ``hf_ds_config``),
``FullyShardedDataParallelPlugin`` and ``MegatronLMPlugin`` set the mesh,
the accumulation steps, the precision, a clip chained ahead of the
optimizer and the optimizer state's offload to pinned host memory
(``prepare_train_step(offload_optimizer=)``). :meth:`Accelerator.
lomo_backward` fuses the SGD update into the backward.

Checkpoints and trackers are the JAX package's: ``save_state`` (blocking,
or ``blocking=False`` with one writer thread, :mod:`.checkpoint_async`),
``load_state`` (``"latest"`` committed, elastic across ``dp_replicate``
widths), sharded saves under a mesh of more than one process
(:mod:`.sharded_checkpoint`), ``save_model`` / ``get_state_dict``, custom
objects and save/load pre-hooks (:mod:`.checkpointing`), and
``init_trackers`` / ``log`` over :mod:`.tracking`. A load writes into the
prepared tensors in place, so prepared steps keep running on them.

``mixed_precision="fp8"`` computes in bf16 with f32 masters, as "bf16"
does, and partitions the optimizer of a model whose params carry fp8
delayed-scaling meta (``dtype_recipe="fp8"``, :mod:`.ops.fp8`): the torch
optimizer owns the real params, and each meta leaf is replaced by its
gradient (its rolled amax histories) every micro-step. Meta gradients are
values: they stay out of the accumulation window, the loss scale and
every sum over ranks, which takes their MAX instead. One fp8 recipe
handler at most (``FP8RecipeKwargs`` or its TE/AO/MS-AMP spellings) is
kept as :attr:`fp8_recipe`, and, as in the JAX package, nothing reads it.
A mesh that splits the sequence over ``cp`` or ``sp`` trains through
:meth:`Accelerator.context_parallel_attention` (the model's
``attention_fn``), the prepared loader's sequence split and the step's
sums over those axes. Not ported yet (see ROADMAP.md): a ``pp`` axis
(item 11b), the telemetry, profiler and watchdog parts of the JAX
package's ``Accelerator`` (item 12).
"""

from __future__ import annotations

import contextlib
import os
import random
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .data_loader import DataLoader, DataLoaderShard, prepare_data_loader, skip_first_batches
from .optimizer import (
    AcceleratedOptimizer,
    OptimizerFactory,
    clip_by_global_norm,
    param_leaves,
)
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    AutocastConfig,
    CheckpointConfig,
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    DummyOptim,
    DummyScheduler,
    FP8RecipeKwargs,
    FullyShardedDataParallelPlugin,
    GradientAccumulationPlugin,
    GradScalerConfig,
    InitProcessGroupKwargs,
    MegatronLMPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
    ProjectConfiguration,
)
from .parallel.sharding import (
    GRAD_SUM_AXES,
    ShardingRules,
    all_reduce_axes,
    make_sharding_plan,
    shard_index,
)
from .parallelism_config import ParallelismConfig
from .state import PartialState
from .utils import operations as ops
from .utils.dataclasses import DeepSpeedPlugin
from .utils.environment import parse_flag_from_env
from .utils.operations import _tree_map, stack_batches

__all__ = ["Accelerator", "RemovableHandle", "set_seed"]

#: kwargs handlers of the JAX package that later items of ROADMAP.md Queue A
#: port: the class name -> the item
_LATER_HANDLERS = {"ProfileConfig": "12"}


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (every device) and the
    global key (``jax.random.PRNGKey(seed)``, :func:`~.utils.random.
    get_rng_key`)."""
    from .utils.random import set_global_key

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    set_global_key(seed)


class RemovableHandle:
    """What the state-hook registrars return: ``remove()`` (or leaving a
    ``with`` block) unregisters the hook."""

    _next_id = 0

    def __init__(self, registry: dict):
        self._registry = registry
        self.id = RemovableHandle._next_id
        RemovableHandle._next_id += 1

    def remove(self) -> None:
        self._registry.pop(self.id, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()


def _children(node) -> list:
    """The children of a dict, list or tuple node (else none)."""
    if isinstance(node, dict):
        return list(node.values())
    return list(node) if isinstance(node, (list, tuple)) else []


def _is_param_tree(obj) -> bool:
    """A nested dict (with dict, list or tuple nodes below it) holding a
    tensor or array leaf."""

    def has_leaf(node):
        return isinstance(node, (torch.Tensor, np.ndarray)) or any(
            has_leaf(v) for v in _children(node))

    return isinstance(obj, dict) and has_leaf(obj)


def _leaves_of(tree) -> list:
    """The leaves of a spec tree (dicts, lists and tuples; a spec is a
    leaf), in tree order."""
    from .parallel.sharding import _leaves

    return _leaves(tree)


def _step_slice(tree, k: int):
    return _tree_map(lambda x: x[k], tree)


def _leading_dim(tree) -> int:
    while isinstance(tree, (dict, list, tuple)):
        children = _children(tree)
        if not children:
            raise ValueError("the batches hold no leaf to read the micro-step count from")
        tree = children[0]
    return tree.shape[0]


def _detach(tree):
    return _tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, tree)


class Accelerator:
    """One process per device: the CUDA device of this process unless
    ``cpu=True`` or ``device="cpu"``; without a GPU and without either,
    construction raises. ``parallelism_config`` lays the processes out on
    the mesh (pure data parallelism over all of them by default);
    ``deepspeed_plugin=DeepSpeedPlugin(zero_stage=1)`` shards the optimizer
    state over ``dp_replicate`` through the fused ZeRO-1 update (on a pure
    data-parallel mesh of floating params, by annotation elsewhere);
    ``shard_rules`` (such as :func:`~.models.transformer.llama_shard_rules`)
    are the TP table, which ``prepare(..., shard_rules=)`` overrides;
    ``dataloader_config`` (:class:`~.utils.dataclasses.
    DataLoaderConfiguration`) and ``rng_types`` (``["numpy"]`` by default,
    synchronized from rank 0 at each epoch under more than one process)
    set how loaders are prepared."""

    def __init__(self, mixed_precision: Optional[str] = None, rng_seed: Optional[int] = None,
                 cpu: bool = False, device_placement: bool = True,
                 gradient_accumulation_steps: int = 1, device=None,
                 gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
                 grad_scaler_config: Optional[GradScalerConfig] = None,
                 step_scheduler_with_optimizer: bool = True,
                 kwargs_handlers: Optional[Sequence] = None,
                 parallelism_config: Optional[ParallelismConfig] = None,
                 deepspeed_plugin: Optional[DeepSpeedPlugin] = None,
                 shard_rules: Optional[ShardingRules] = None,
                 dataloader_config: Optional[DataLoaderConfiguration] = None,
                 rng_types: Optional[Sequence[str]] = None,
                 fsdp_plugin: Optional[FullyShardedDataParallelPlugin] = None,
                 megatron_lm_plugin: Optional[MegatronLMPlugin] = None,
                 project_dir: Optional[str] = None,
                 project_config: Optional[ProjectConfiguration] = None,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 log_with=None):
        # the kwargs handlers: one a class, each steering one part
        self.ddp_handler: Optional[DistributedDataParallelKwargs] = None
        self.autocast_handler: Optional[AutocastConfig] = None
        self.fp8_recipe_handler: Optional[FP8RecipeKwargs] = None
        self.fp8_recipe = None
        init_pg_kwargs: dict = {}
        seen: set = set()
        for handler in kwargs_handlers or ():
            if type(handler) in seen:
                raise ValueError(f"duplicate kwargs handler of type {type(handler).__name__}")
            seen.add(type(handler))
            if isinstance(handler, InitProcessGroupKwargs):
                init_pg_kwargs = {k: v for k, v in handler.to_dict().items() if v is not None}
                ids = init_pg_kwargs.pop("local_device_ids", None)
                if ids is not None and len(ids) > 1:
                    raise ValueError(f"local_device_ids={ids}: a process of the port drives "
                                     "one device")
            elif isinstance(handler, GradScalerConfig):
                if grad_scaler_config is not None:
                    raise ValueError("grad_scaler_config given both directly and as a handler")
                grad_scaler_config = handler
            elif isinstance(handler, DistributedDataParallelKwargs):
                self.ddp_handler = handler
            elif isinstance(handler, CheckpointConfig):
                if checkpoint_config is not None:
                    raise ValueError("checkpoint_config given both directly and as a handler")
                checkpoint_config = handler
            elif isinstance(handler, AutocastConfig):
                self.autocast_handler = handler
            elif isinstance(handler, FP8RecipeKwargs):
                # the spellings are subclasses: two different ones conflict too
                if self.fp8_recipe_handler is not None:
                    raise ValueError(
                        "multiple fp8 recipe handlers given "
                        f"({type(self.fp8_recipe_handler).__name__} and "
                        f"{type(handler).__name__}); pass exactly one")
                self.fp8_recipe_handler = handler
                self.fp8_recipe = handler.to_native()
            elif type(handler).__name__ in _LATER_HANDLERS:
                raise NotImplementedError(
                    f"{type(handler).__name__} is not ported yet (ROADMAP.md Queue A item "
                    f"{_LATER_HANDLERS[type(handler).__name__]})")
            else:
                raise ValueError(f"unsupported kwargs handler: {handler!r}")

        # the plugins: each is an intent for the mesh, the precision, the
        # clip and the optimizer state's placement
        if fsdp_plugin is not None and deepspeed_plugin is not None:
            raise ValueError("pass fsdp_plugin or deepspeed_plugin, not both")
        if deepspeed_plugin is None and fsdp_plugin is None and parse_flag_from_env(
                "ACCELERATE_USE_DEEPSPEED"):
            deepspeed_plugin = DeepSpeedPlugin.from_env()
        plugin = fsdp_plugin or deepspeed_plugin
        self.deepspeed_plugin = deepspeed_plugin
        self.fsdp_plugin = fsdp_plugin
        self.megatron_lm_plugin = megatron_lm_plugin
        if megatron_lm_plugin is not None:
            if plugin is not None:
                raise ValueError("megatron_lm_plugin cannot be combined with fsdp_plugin/"
                                 "deepspeed_plugin")
            if parallelism_config is not None:
                raise ValueError("pass megatron_lm_plugin OR parallelism_config, not both — the "
                                 "plugin's tp/pp/ep/cp degrees define the mesh")
            parallelism_config = megatron_lm_plugin.to_parallelism_config()
            if gradient_accumulation_steps == 1 and megatron_lm_plugin.num_micro_batches > 1:
                gradient_accumulation_steps = megatron_lm_plugin.num_micro_batches
        plugin_mp = getattr(deepspeed_plugin, "mixed_precision", None)
        if plugin_mp is not None:
            # the ds config's precision wins over the launcher's environment;
            # a constructor value that disagrees is an error
            if mixed_precision is not None and str(mixed_precision) != plugin_mp:
                raise ValueError(f"mixed_precision={mixed_precision!r} disagrees with the ds "
                                 f"config's {plugin_mp!r} section; align them")
            env_mp = os.environ.get("ACCELERATE_MIXED_PRECISION")
            if env_mp and env_mp != plugin_mp:
                warnings.warn(f"launcher mixed precision {env_mp!r} differs from the ds config's "
                              f"{plugin_mp!r} section; the ds config wins")
            mixed_precision = plugin_mp
        self._plugin_grad_clip = getattr(deepspeed_plugin, "gradient_clipping", None)
        if self._plugin_grad_clip is None:
            self._plugin_grad_clip = getattr(megatron_lm_plugin, "gradient_clipping", None)
        offload_dev = getattr(deepspeed_plugin, "offload_optimizer_device", None)
        if offload_dev == "nvme":
            warnings.warn("offload_optimizer_device='nvme' degrades to HOST RAM here (pinned "
                          "host memory) — there is no disk tier; make sure the optimizer state "
                          "fits host memory")
        self._offload_optimizer = bool(offload_dev in ("cpu", "nvme")
                                       or getattr(fsdp_plugin, "cpu_offload", False))
        if plugin is not None:
            if not hasattr(plugin, "to_parallelism_config"):
                raise TypeError(f"{type(plugin).__name__} is not a FullyShardedDataParallelPlugin/"
                                "DeepSpeedPlugin (missing to_parallelism_config)")
            if parallelism_config is None:
                parallelism_config = plugin.to_parallelism_config(
                    PartialState(cpu=cpu, device=device, **init_pg_kwargs).num_devices)
            if (deepspeed_plugin is not None and gradient_accumulation_steps == 1
                    and deepspeed_plugin.gradient_accumulation_steps > 1):
                gradient_accumulation_steps = deepspeed_plugin.gradient_accumulation_steps

        precision = PrecisionType(str(mixed_precision if mixed_precision is not None
                                      else os.environ.get("ACCELERATE_MIXED_PRECISION", "no")))
        if gradient_accumulation_plugin is None:
            env_steps = int(os.environ.get("ACCELERATE_GRADIENT_ACCUMULATION_STEPS", 1))
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps if gradient_accumulation_steps != 1
                else env_steps)
        self._zero1_axis = ("dp_replicate" if getattr(deepspeed_plugin, "zero_stage", None) == 1
                            else None)
        self.shard_rules = shard_rules
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        self.rng_types = list(rng_types) if rng_types is not None else ["numpy"]
        self._sharding_plan = None
        self.state = AcceleratorState(mixed_precision=precision.value, cpu=cpu, device=device,
                                      parallelism_config=parallelism_config, **init_pg_kwargs)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.grad_scaler_config = grad_scaler_config or GradScalerConfig()
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.device_placement = device_placement
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
        self.checkpoint_config = checkpoint_config or CheckpointConfig()
        self._checkpoint_manager = None  # the writer of async saves, made at the first
        self.last_checkpoint = None  # the CheckpointSnapshot of the last save (its timings)
        # what save_state / load_state cover, in prepare order (the JAX package's lists);
        # _plans[i] is the sharding plan _models[i] was placed by
        self._models: list = []
        self._plans: list = []
        self._optimizers: list = []
        self._schedulers: list = []
        self._dataloaders: list = []
        self._custom_objects: list = []
        self._save_state_pre_hooks: dict = {}
        self._load_state_pre_hooks: dict = {}
        self._autocast_enabled = True
        self.flag_tensor = None
        self.trackers: list = []
        self.log_with = log_with
        self._accum_count = 0
        # lomo_backward's dynamic loss scale under fp16 (host values)
        self._lomo_scale = float(self.grad_scaler_config.init_scale)
        self._lomo_scale_growth = 0
        self.lomo_stats: dict = {}
        if rng_seed is not None:
            set_seed(rng_seed)

    # ------------------------------------------------------------ properties --
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision.value

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def partial_state(self) -> PartialState:
        return self.state._partial

    @property
    def mesh(self):
        return self.state.mesh

    @property
    def parallelism_config(self) -> ParallelismConfig:
        return self.state.parallelism_config

    @property
    def distributed_type(self):
        return self.partial_state.distributed_type

    @property
    def local_process_index(self) -> int:
        return self.partial_state.local_process_index

    @property
    def is_local_main_process(self) -> bool:
        return self.partial_state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.partial_state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.partial_state.use_distributed

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    @property
    def sharding_plan(self):
        """The :class:`~.parallel.sharding.ShardingPlan` of the params
        prepared last."""
        return self._sharding_plan

    @property
    def param_specs(self):
        return None if self._sharding_plan is None else self._sharding_plan.param_specs

    # -------------------------------------------------------- process control --
    def wait_for_everyone(self) -> None:
        self.partial_state.wait_for_everyone()

    def print(self, *args, **kwargs) -> None:
        self.partial_state.print(*args, **kwargs)

    def on_main_process(self, function):
        return self.partial_state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.partial_state.on_local_main_process(function)

    def on_last_process(self, function):
        return self.partial_state.on_last_process(function)

    def on_process(self, function=None, process_index=None):
        return self.partial_state.on_process(function, process_index)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.partial_state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.partial_state.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.partial_state.split_between_processes(inputs, apply_padding=apply_padding)

    # ------------------------------------------------------------- gathering --
    def gather(self, tree):
        return ops.gather(tree)

    def gather_for_metrics(self, data, use_gather_object: bool = False):
        """:func:`~.utils.operations.gather`, then the rows ``even_batches``
        (or the dispatcher's padding) repeated in the last global batch
        dropped, as the prepared loader's ``remainder`` says."""
        if use_gather_object:
            return ops.gather_object(data)
        gathered = ops.gather(data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:
            gathered = ops.recursively_apply(
                lambda x: x[:remainder] if getattr(x, "ndim", 0) >= 1 else x, gathered)
        return gathered

    def reduce(self, tree, reduction: str = "mean", scale: float = 1.0):
        return ops.reduce(tree, reduction=reduction, scale=scale)

    def pad_across_processes(self, tree, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        return ops.pad_across_processes(tree, dim=dim, pad_index=pad_index, pad_first=pad_first)

    # --------------------------------------------------------------- prepare --
    def prepare(self, *args, shard_rules: Optional[ShardingRules] = None):
        """Prepare each argument by type: a param dict is placed on the
        device (:meth:`prepare_model`, with ``shard_rules`` when given, else
        the ``Accelerator``'s), an optimizer or a factory such as
        :func:`~accelerate_tpu_torch.optimizer.adamw` becomes an
        :class:`AcceleratedOptimizer` over those params, a :class:`DataLoader`
        yields batches on the device, a ``torch`` lr scheduler becomes an
        :class:`AcceleratedScheduler` (:meth:`prepare_scheduler`; wrap a
        ``step -> lr`` schedule there). A ``DummyOptim`` becomes an
        AdamW; prepared together with a ``DummyScheduler``, the scheduler's
        warmup/decay schedule is that AdamW's learning rate. Anything else
        passes through."""
        results = list(args)
        params_seen = None
        placed = set()
        for i, obj in enumerate(args):  # params first: the optimizers bind to them
            if _is_param_tree(obj):
                results[i] = params_seen = self.prepare_model(obj, shard_rules=shard_rules)
                placed.add(i)
        dummy_scheds = [o for o in args if isinstance(o, DummyScheduler)]
        dummy_optims = [o for o in args if isinstance(o, DummyOptim)]
        schedule_fn = None
        if dummy_scheds:
            lead = dummy_scheds[0]
            if lead.optimizer is None and dummy_optims:
                lead.optimizer = dummy_optims[0]  # base_lr is its lr
            if lead.lr_scheduler_callable is None:
                schedule_fn = self._dummy_schedule_fn(lead)
            if not dummy_optims:
                warnings.warn("DummyScheduler prepared without a DummyOptim in the same prepare() "
                              "call: get_last_lr() reports the schedule, but updates keep the "
                              "optimizer's own learning rate. Prepare them together.",
                              stacklevel=2)
        for i, obj in enumerate(args):
            if i in placed:
                continue
            if isinstance(obj, DummyOptim):
                if dummy_scheds and dummy_scheds[0].lr_scheduler_callable is not None:
                    warnings.warn("DummyScheduler.lr_scheduler_callable does not set the "
                                  "DummyOptim's learning rate; it keeps its constant lr",
                                  stacklevel=2)
                results[i] = self.prepare_optimizer(obj.to_adamw(learning_rate=schedule_fn))
            elif isinstance(obj, (DataLoader, DataLoaderShard, torch.utils.data.DataLoader)):
                results[i] = self.prepare_data_loader(obj)
            elif isinstance(obj, (AcceleratedOptimizer, torch.optim.Optimizer, OptimizerFactory)):
                results[i] = self.prepare_optimizer(obj)
            elif isinstance(obj, DummyScheduler):
                # steps once per optimizer step: the schedule counts optimizer steps
                if obj.lr_scheduler_callable is not None:
                    underlying = obj.lr_scheduler_callable(obj.optimizer)
                elif obj is dummy_scheds[0] and schedule_fn is not None:
                    underlying = schedule_fn
                else:
                    underlying = self._dummy_schedule_fn(obj)
                results[i] = AcceleratedScheduler(
                    underlying, step_with_optimizer=self.step_scheduler_with_optimizer,
                    num_processes=1)
                self._schedulers.append(results[i])
            elif isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)):
                results[i] = self.prepare_scheduler(obj)
        if params_seen is not None:
            # fp8 models: the optimizer is partitioned (meta leaves replaced by
            # their gradient), whichever order the two were prepared in
            from .ops.fp8 import has_fp8_meta

            partition = (self.state.mixed_precision == PrecisionType.FP8
                         and has_fp8_meta(params_seen))
            for opt in self._optimizers:
                if opt.optimizer is None:
                    opt.fp8_partition = opt.fp8_partition or partition
                    opt.init(params_seen, plan=self._sharding_plan)
        return results[0] if len(results) == 1 else tuple(results)

    def prepare_model(self, params: dict, shard_rules: Optional[ShardingRules] = None,
                      specs=None) -> dict:
        """Fresh leaf tensors on the device (copies: the caller's tensors or
        arrays are never updated), floating ones with ``requires_grad``, in
        the same tree of dicts, lists and tuples. The dtypes are kept: f32
        params are the masters of mixed precision. Every spec decision comes
        from one :func:`~.parallel.sharding.make_sharding_plan` call (kept as
        :attr:`sharding_plan`); under a mesh each leaf is this rank's block
        of the param, and every rank must pass the same params."""
        plan = make_sharding_plan(params, self.mesh, self.parallelism_config,
                                  rules=shard_rules or self.shard_rules,
                                  zero1_axis=self._zero1_axis, param_specs=specs)
        if plan.distributed:
            plan.check_supported()
        specs = iter(_leaves_of(plan.param_specs))

        def place(x):
            t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            spec = next(specs)
            if plan.distributed:
                t = t[shard_index(spec, tuple(t.shape), self.mesh)]
            t = t.to(self.device if self.device_placement else t.device, copy=True).contiguous()
            return t.requires_grad_(True) if t.is_floating_point() else t

        self._sharding_plan = plan
        placed = _tree_map(place, params)
        self._models.append(placed)
        self._plans.append(plan)
        return placed

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        """An :class:`AcceleratedOptimizer` over ``optimizer`` (bound to the
        params by :meth:`prepare`); a plugin's ``gradient_clipping`` is
        chained ahead of it as :func:`~.optimizer.clip_by_global_norm`."""
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(
                optimizer, accumulation_steps=self.gradient_accumulation_steps)
            if self._plugin_grad_clip is not None:
                optimizer.transforms = (clip_by_global_norm(self._plugin_grad_clip),
                                        *optimizer.transforms)
        self._optimizers.append(optimizer)
        return optimizer

    @staticmethod
    def _dummy_schedule_fn(dummy) -> Callable:
        """The ``DummyScheduler`` schedule of the JAX package, in f32: linear
        warmup ``base_lr·(step+1)/warmup`` over ``warmup_num_steps``, then
        linear decay to 0 at ``total_num_steps`` (or ``base_lr`` held when
        the total is ``None``), around the paired optimizer's lr (1e-3 when
        it has none)."""
        base_lr = getattr(getattr(dummy, "optimizer", None), "lr", None)
        base = np.float32(1e-3 if base_lr is None else base_lr)
        total = dummy.total_num_steps
        warmup = dummy.warmup_num_steps if total is None else min(dummy.warmup_num_steps, total)

        def schedule_fn(step):
            step = np.float32(step)
            warm = base * (step + np.float32(1)) / np.float32(max(warmup, 1))
            if total is not None and total > warmup:
                frac = (step - np.float32(warmup)) / np.float32(total - warmup)
                after = base * np.maximum(np.float32(0), np.float32(1) - frac)
            else:
                after = base
            return (warm if step < warmup else after) if warmup else after

        return schedule_fn

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        if not isinstance(scheduler, AcceleratedScheduler):
            scheduler = AcceleratedScheduler(
                scheduler, step_with_optimizer=self.step_scheduler_with_optimizer)
        if not any(s is scheduler for s in self._schedulers):
            self._schedulers.append(scheduler)
        return scheduler

    def prepare_data_loader(self, dataloader) -> DataLoaderShard:
        """This rank's batches on its device: the loader resharded over the
        mesh's data-parallel rows (:func:`~.data_loader.prepare_data_loader`)
        as :attr:`dataloader_config` says. With ``use_stateful_dataloader``
        a plain torch loader is rebuilt as torchdata's
        ``StatefulDataLoader``; without torchdata that raises ``ImportError``
        (``TypeError`` for a loader that cannot be rebuilt), as in the JAX
        package."""
        if isinstance(dataloader, DataLoaderShard):
            if not any(d is dataloader for d in self._dataloaders):
                self._dataloaders.append(dataloader)
            return dataloader
        cfg = self.dataloader_config
        if cfg.use_stateful_dataloader and not isinstance(dataloader, DataLoader) and not (
                hasattr(dataloader, "state_dict") and hasattr(dataloader, "load_state_dict")):
            from .data_loader import as_stateful_dataloader, stateful_dataloader_available

            rebuilt = as_stateful_dataloader(dataloader)
            if rebuilt is None:
                if stateful_dataloader_available():
                    raise TypeError(
                        "use_stateful_dataloader=True: "
                        f"{type(dataloader).__name__} cannot be rebuilt as a torchdata "
                        "StatefulDataLoader (only plain torch DataLoaders are rebuildable). "
                        "Pass a StatefulDataLoader directly, or use the native DataLoader "
                        "(stateful out of the box).")
                raise ImportError(
                    "use_stateful_dataloader=True but this loader has no "
                    "state_dict/load_state_dict and torchdata>=0.8.0 is not installed to "
                    "rebuild it. Install torchdata>=0.8.0, or use the native DataLoader "
                    "(stateful out of the box).")
            dataloader = rebuilt
        prepared = prepare_data_loader(
            dataloader, self.device, mesh=self.mesh, device_placement=self.device_placement,
            split_batches=cfg.split_batches, even_batches=cfg.even_batches,
            dispatch_batches=cfg.dispatch_batches,
            rng_types=self.rng_types if self.num_processes > 1 else None,
            data_seed=cfg.data_seed, use_seedable_sampler=cfg.use_seedable_sampler,
            prefetch_depth=cfg.prefetch_depth, non_blocking=cfg.non_blocking)
        self._dataloaders.append(prepared)
        return prepared

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        """The loader resuming ``num_batches`` into its next epoch
        (:func:`~.data_loader.skip_first_batches`)."""
        return skip_first_batches(dataloader, num_batches)

    # ------------------------------------------------------------ train step --
    def _resolve_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if optimizer is None:
            if not self._optimizers:
                raise ValueError("prepare an optimizer first or pass one explicitly")
            optimizer = self._optimizers[-1]
        if optimizer.optimizer is None:
            raise ValueError("the optimizer is not bound to params: prepare it with them")
        return optimizer

    def _build_train_step(self, loss_fn: Callable, optimizer: AcceleratedOptimizer,
                          has_aux: bool, compute_grad_norm: bool) -> Callable:
        from .ops import fp8

        policy = self.state.mixed_precision_policy
        if not self._autocast_enabled:  # built inside autocast(AutocastConfig(enabled=False))
            policy = MixedPrecisionPolicy.from_precision(PrecisionType.NO)
        fp16 = self.state.mixed_precision == PrecisionType.FP16
        plan = optimizer.plan
        # a plan that communicates (see the module docstring); otherwise the plain step
        meshed = plan is not None and plan.distributed
        if meshed:
            plan.check_supported()
        torch_opt = optimizer.optimizer
        zero1 = optimizer.zero1
        bound = optimizer.model_params
        # the batch ranks the gradients are summed over, and the axes the
        # fused ZeRO-1 update sums over before its reduce-scatter
        n = plan.batch_ranks if meshed else 1
        other_axes = () if zero1 is None else tuple(
            a for a in GRAD_SUM_AXES if a != plan.zero1_axis and plan.mesh.shape[a] > 1)
        # autograd hands each gradient in its param's dtype; the JAX step casts
        # them to the policy's param dtype before the update (f32 gradients
        # for bf16 params under "bf16"), which the flat path does here
        cast = policy.param_dtype is not None and any(p.dtype != policy.param_dtype
                                                      for p in bound)
        # DistributedDataParallelKwargs(comm_hook=): the gradient bounded to
        # the compressed dtype, as the JAX package does it: on the global
        # (reduced) gradient, still loss-scaled, so that under fp16 a small
        # gradient rides the scale above fp16's subnormal floor
        compress = (self.ddp_handler.gradient_compression_dtype()
                    if self.ddp_handler is not None else None)
        # the gradients as one flat tensor: one op each for the cast, the
        # sum over the batch ranks, the compression, the unscale, the finite
        # check, the zeroing, the norm and the accumulation
        flat_path = (meshed or fp16 or compute_grad_norm or optimizer.accumulation_steps > 1
                     or cast or compress is not None)
        if fp16:
            optimizer.init_loss_scale(self.grad_scaler_config, bound[0].device)
        # fp8 meta replaced by its gradient (the partition, or the fused
        # ZeRO-1 path's passthrough slots); outside those its gradient would
        # be summed over the ranks like a param's
        meta = optimizer.meta
        if meshed and not meta and any(optimizer.meta_mask):
            raise NotImplementedError(
                "fp8 meta on a mesh needs mixed_precision='fp8' (or the fused ZeRO-1 path): its "
                "gradients are new histories, which a sum over the ranks would corrupt")
        cotangent_scale = n if meta else 1

        def flat_grads():
            if not meshed:
                return optimizer.flat_grads(policy.param_dtype)
            grads = [(p.grad if p.grad is not None else torch.zeros_like(p))
                     .to(policy.param_dtype or p.dtype) for p in bound]
            if zero1 is not None:
                return zero1.reduce_scatter(grads, other_axes) / n
            return torch.cat([g.reshape(-1) for g in plan.reduce_grads(grads)]) / n

        def sum_of_squares(flat):
            if zero1 is not None:  # each rank holds its chunks of the summed gradients
                return all_reduce_axes(torch.sum(flat.float() ** 2), plan.mesh,
                                       (plan.zero1_axis,))
            if meshed:
                return plan.global_sumsq(optimizer._split(flat))
            # torch.sum's cascade keeps f32 at the JAX package's precision;
            # the CPU's f32 vector_norm drifts by ~1e-4 at a million elements
            return torch.sum(flat * flat)

        def train_step(params, opt_state, batch):
            if opt_state is not optimizer.opt_state:
                raise ValueError("opt_state is not the state of the prepared optimizer (the port "
                                 "updates the optimizer's own state in place)")
            leaves, meta_leaves = optimizer.split_leaves(param_leaves(params))
            if (len(leaves) != len(bound) or any(a is not b for a, b in zip(leaves, bound))
                    or any(a is not b for a, b in zip(meta_leaves, meta))):
                raise ValueError("params are not the tensors the optimizer was prepared with")
            torch_opt.zero_grad(set_to_none=True)
            for p in (*bound, *meta):  # under ZeRO-1 the optimizer owns chunks or rows
                p.grad = None
            full = plan.gather_params(params, policy.compute_dtype) if meshed else params
            with fp8.cotangent_scale(cotangent_scale):
                out = loss_fn(policy.cast_to_compute(full), policy.cast_to_compute(batch))
                loss, aux = out if has_aux else (out, None)
                loss = loss.float()
                (loss * optimizer.loss_scale if fp16 else loss).backward()
            metrics = {"loss": plan.mean_over_batch(loss.detach()) if meshed else loss.detach()}
            meta_grads = None
            if meta:
                meta_grads = [m.grad if m.grad is not None else torch.zeros_like(m)
                              for m in meta]
                if meshed and n > 1:  # new histories: the MAX over the ranks, never a sum
                    flat_meta = all_reduce_axes(torch.cat([g.reshape(-1) for g in meta_grads]),
                                                plan.mesh, GRAD_SUM_AXES, op="max")
                    meta_grads = [g.view_as(m) for g, m in zip(
                        flat_meta.split([m.numel() for m in meta]), meta)]
                if compress is not None:  # the JAX package compresses the whole tree
                    meta_grads = [g.to(compress).to(g.dtype) for g in meta_grads]
            flat = None
            if flat_path:
                flat = flat_grads()
                if compress is not None:
                    flat = flat.to(compress).to(flat.dtype)
                if fp16:
                    flat = flat / optimizer.loss_scale
                    finite = torch.isfinite(flat).all()
                    if meshed:  # one decision for every rank, as JAX's one global isfinite
                        finite = all_reduce_axes(finite.float(), plan.mesh, tuple(plan.mesh.shape),
                                                 op="min") > 0
                    # an overflow feeds zeros: the update still runs, as in the JAX package
                    flat = torch.where(finite, flat, 0.0)
                    metrics["grads_finite"] = finite
                if compute_grad_norm:  # over the whole tree, meta histories included
                    sq = sum_of_squares(flat)
                    if meta_grads:
                        sq = sq + sum(torch.sum(g * g) for g in meta_grads)
                    metrics["grad_norm"] = torch.sqrt(sq)
            optimizer.micro_step(flat, meta_grads)
            if fp16:
                metrics["loss_scale"] = optimizer.update_loss_scale(finite)
            if aux is not None:
                metrics["aux"] = _detach(aux)
            return params, opt_state, metrics

        return train_step

    def prepare_train_step(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           has_aux: bool = False, compute_grad_norm: bool = False,
                           offload_optimizer: Optional[bool] = None) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
        for ``loss_fn(params, batch) -> scalar`` (``(loss, aux)`` with
        ``has_aux``); one micro-step, updating in place. ``compute_grad_norm``
        adds the global L2 norm of this micro-step's (unscaled, zeroed on
        overflow) gradients.

        ``offload_optimizer=True`` keeps the optimizer state (this rank's,
        under a mesh) in pinned host memory between steps and stages it onto
        the device group by group inside each update, double-buffered on a
        side stream (:class:`~.parallel.sharding.OptimizerOffload`): the
        ZeRO-Offload of the JAX package, whose XLA program stages the state
        inside the step. ``None`` takes it from the plugins:
        ``DeepSpeedPlugin(offload_optimizer_device="cpu"|"nvme")`` or
        ``FullyShardedDataParallelPlugin(cpu_offload=True)``; ``False`` keeps
        (or brings back) the state on the device. The arithmetic is the
        plain step's, element for element."""
        if offload_optimizer is None:
            offload_optimizer = self._offload_optimizer
        if offload_optimizer:
            live = optimizer if optimizer is not None else (
                self._optimizers[-1] if self._optimizers else None)
            if live is None or live.opt_state is None:
                raise ValueError("offload_optimizer needs the live optimizer state — call "
                                 "prepare(params, optimizer) first")
        optimizer = self._resolve_optimizer(optimizer)
        optimizer.offload_state(bool(offload_optimizer))
        return self._build_train_step(loss_fn, optimizer, has_aux, compute_grad_norm)

    def prepare_train_loop(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           has_aux: bool = False, compute_grad_norm: bool = False) -> Callable:
        """``loop(params, opt_state, batches) -> (params, opt_state, metrics)``
        where ``batches`` carries a leading ``[K, ...]`` micro-step axis (see
        :func:`~accelerate_tpu_torch.utils.operations.stack_batches`) and every
        metric is stacked ``[K]``. The same update as K calls of the
        :meth:`prepare_train_step` function, run as a Python loop with no
        host sync; params and optimizer state are updated in place. A
        plugin's optimizer offload is not applied here (as in the JAX
        package, whose scanned loop keeps the state on the device): use
        :meth:`prepare_train_step`."""
        if self._offload_optimizer:
            warnings.warn("optimizer host-offload is configured but not applied in the scanned "
                          "train loop — state must stay in HBM across the K scanned steps; use "
                          "prepare_train_step for per-step offload")
        step = self._build_train_step(loss_fn, self._resolve_optimizer(optimizer), has_aux,
                                      compute_grad_norm)

        def train_loop(params, opt_state, batches):
            metrics = []
            for k in range(_leading_dim(batches)):
                params, opt_state, m = step(params, opt_state, _step_slice(batches, k))
                metrics.append(m)
            return params, opt_state, stack_batches(metrics)

        return train_loop

    def prepare_eval_step(self, eval_fn: Callable) -> Callable:
        """``eval_step(params, batch)``: ``eval_fn`` on the compute-dtype
        casts, without autograd."""
        policy = self.state.mixed_precision_policy
        plan = self._sharding_plan
        gather = plan.gather_params_no_grad if plan is not None and plan.distributed else None

        def eval_step(params, batch):
            with torch.no_grad():
                full = params if gather is None else gather(params)
                return eval_fn(policy.cast_to_compute(full), policy.cast_to_compute(batch))

        return eval_step

    # ------------------------------------------------- imperative surface --
    def gradient_fn(self, loss_fn: Callable, has_aux: bool = False) -> Callable:
        """Eager ``(params, batch) -> (value, grads)`` with the precision
        policy applied, as the JAX package's ``jax.value_and_grad``: ``value``
        is the loss (``(loss, aux)`` with ``has_aux``), ``grads`` a tree like
        ``params`` in the param dtype. Params are not updated and their
        ``.grad`` is not touched. Under a mesh ``value`` is the loss over the
        global batch (the mean of the ranks' losses) and ``grads`` this
        rank's blocks of its gradient (summed over the batch ranks and
        divided by their count, as in the train step)."""
        policy = self.state.mixed_precision_policy
        plan = self._sharding_plan
        meshed = plan is not None and plan.distributed

        def value_and_grad(params, batch):
            def leaf(x):
                if isinstance(x, torch.Tensor) and x.is_floating_point():
                    return x if x.requires_grad else x.detach().requires_grad_(True)
                return x

            if meshed:
                return meshed_value_and_grad(params, batch)
            params = _tree_map(leaf, params)
            out = loss_fn(policy.cast_to_compute(params), policy.cast_to_compute(batch))
            loss = out[0] if has_aux else out
            diff = [t for t in param_leaves(params) if t.is_floating_point()]
            grads = iter(torch.autograd.grad(loss, diff, allow_unused=True))

            def grad(x):
                if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
                    return None
                g = next(grads)
                return torch.zeros_like(x) if g is None else g

            return _detach(out), _tree_map(grad, params)

        def meshed_value_and_grad(params, batch):
            # fresh leaves on the rank's blocks: the backward fills their .grad
            # (the per-layer gather writes there), never the params'
            params = _tree_map(lambda x: x.detach().requires_grad_(True)
                               if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
                               params)
            full = plan.gather_params(params, policy.compute_dtype)
            out = loss_fn(policy.cast_to_compute(full), policy.cast_to_compute(batch))
            loss, aux = out if has_aux else (out, None)
            loss.float().backward()
            leaves = param_leaves(params)
            diff = [t for t in leaves if t.is_floating_point()]
            summed = plan.reduce_grads([t.grad if t.grad is not None else torch.zeros_like(t)
                                        for t in diff])
            grads = iter([g / plan.batch_ranks for g in summed])
            value = plan.mean_over_batch(loss.detach().float())
            tree = _tree_map(lambda x: next(grads) if isinstance(x, torch.Tensor)
                             and x.is_floating_point() else None, params)
            return ((value, _detach(aux)) if has_aux else value), tree

        return value_and_grad

    # ------------------------------------------------------------------ lomo --
    def lomo_backward(self, loss_fn: Callable, params, *args, learning_rate: float = 1e-3):
        """LOMO (the JAX package's ``lomo_backward``): one backward of
        ``loss_fn(params, *args)`` fused with the SGD update ``p - lr * g``
        (``g`` cast to ``p``'s dtype, ``lr`` rounded to it first), so the
        whole gradient tree never exists beside the params. Returns ``(loss,
        params)``: the loss (f32, unscaled) and the same params, updated in
        place (the port's counterpart of JAX's donated buffers; nothing is
        compiled, so JAX's cache of compiled steps has none).

        The loss runs on ``policy.cast_to_compute(params)``. Each gradient is
        applied, then freed, as soon as it is complete: the leaves outside a
        stacked ``layers`` subtree (embedding, head, final norm) by their
        own post-accumulate hooks, and the stacked layers one layer at a time
        as that layer's backward ends, through the per-layer mechanism of
        :class:`~.parallel.sharding.LayerStack` (a hook on a stacked leaf
        would fire only after the last layer's backward). A model that reads
        ``layers`` whole (BERT) updates each stacked leaf when its whole
        gradient is complete.

        Under ``mixed_precision="fp16"`` the loss scale is dynamic and kept
        on the ``Accelerator`` (``grad_scaler_config``'s backoff and growth).
        An update made inside a hook cannot be taken back, so fp16 takes
        LOMO's two-pass form: a first backward only records whether every
        (unscaled) gradient is finite, freeing each one; a second backward
        applies the update, only when the first found no overflow. That
        costs a second forward and backward; an overflowed step leaves the
        params unchanged and backs the scale off. bf16 and f32 take one
        pass. Under more than one process the mesh must be pure
        ``dp_replicate``: each gradient is all-reduced (as a mean) before
        its update, and the loss is the mean over the ranks."""
        fp16 = self.state.mixed_precision == PrecisionType.FP16
        axes = self._lomo_axes()
        scale = self._lomo_scale if fp16 else 1.0
        if not fp16:
            loss, _ = self._lomo_pass(loss_fn, params, args, scale, learning_rate, axes)
            return loss, params
        loss, finite = self._lomo_pass(loss_fn, params, args, scale, None, axes)
        finite = bool(finite)
        if finite:
            self._lomo_pass(loss_fn, params, args, scale, learning_rate, axes)
        cfg = self.grad_scaler_config
        if finite:
            self._lomo_scale_growth += 1
            if self._lomo_scale_growth >= cfg.growth_interval:
                self._lomo_scale = scale * cfg.growth_factor
                self._lomo_scale_growth = 0
        else:
            self._lomo_scale = max(1.0, scale * cfg.backoff_factor)
            self._lomo_scale_growth = 0
        return loss, params

    def _lomo_axes(self) -> tuple:
        """The mesh axes LOMO averages gradients over: none on one process,
        ``dp_replicate`` on a pure data-parallel mesh; any other raises."""
        sizes = {a: n for a, n in self.mesh.shape.items() if n > 1}
        if not sizes:
            return ()
        if set(sizes) == {"dp_replicate"}:
            return ("dp_replicate",)
        raise NotImplementedError(
            f"lomo_backward on a mesh of {sizes} is not ported yet: it runs on one process or "
            "a pure dp_replicate mesh (ROADMAP.md Queue A item 11b)")

    def _lomo_pass(self, loss_fn: Callable, params, args: tuple, scale: float,
                   learning_rate: Optional[float], axes: tuple):
        """One forward and backward at loss scale ``scale``. Each gradient,
        once complete, is averaged over ``axes``, unscaled and then either
        applied (``learning_rate``) or checked for finiteness (``None``),
        and freed. Returns ``(loss, finite)``: the unscaled f32 loss (the
        mean over ``axes``) and, for the check, a device bool (None
        otherwise). :attr:`lomo_stats` holds the pass's gradient bytes:
        ``max_live_bytes``, the most that were alive at once (a gradient
        counts from its arrival until it is garbage), and ``total_bytes``."""
        import weakref

        from .optimizer import _scalar
        from .parallel.sharding import LayerStack

        policy = self.state.mixed_precision_policy
        mesh = self.mesh
        n = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
        stats = self.lomo_stats = {"live_bytes": 0, "max_live_bytes": 0, "total_bytes": 0}
        finite: list = [None]

        def freed(nbytes):
            stats["live_bytes"] -= nbytes

        @torch.no_grad()
        def take(targets: list, grads: list) -> None:
            for g in grads:
                nbytes = g.numel() * g.element_size()
                stats["live_bytes"] += nbytes
                stats["total_bytes"] += nbytes
                weakref.finalize(g, freed, nbytes)
            stats["max_live_bytes"] = max(stats["max_live_bytes"], stats["live_bytes"])
            if axes:
                flat = torch.cat([g.reshape(-1) for g in grads])
                all_reduce_axes(flat, mesh, axes)
                flat /= n
                grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]),
                                                       grads)]
                del flat
            if scale != 1.0:
                grads = [g / scale for g in grads]
            if learning_rate is None:
                ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
                finite[0] = ok if finite[0] is None else finite[0] & ok
                return
            for (p, row), g in zip(targets, grads):
                dst = p.detach() if row is None else p.detach()[row]
                dst.sub_(g.to(p.dtype) * _scalar(learning_rate, p.dtype))

        def leaf_hook(p):
            g, p.grad = p.grad, None
            if g is not None:  # a stacked leaf read per layer gets none here
                take([(p, None)], [g])

        def layer_hook(group, i, grads):
            take([(t, i) for t in group.leaves], list(grads))

        for p in param_leaves(params):
            if p.is_floating_point() and not p.requires_grad:
                p.requires_grad_(True)
        handles = [p.register_post_accumulate_grad_hook(leaf_hook)
                   for p in param_leaves(params) if p.requires_grad]
        try:
            full = params
            if isinstance(params, dict) and isinstance(params.get("layers"), dict):
                from .parallel.sharding import _map

                layers = params["layers"]
                stack = LayerStack(mesh, layers, _map(lambda _: None, layers),
                                   dtype=policy.compute_dtype, grad_hook=layer_hook)
                full = {k: stack if k == "layers" else v for k, v in params.items()}
            loss = loss_fn(policy.cast_to_compute(full), *args).float()
            scaled = loss * scale
            scaled.backward()
        finally:
            for h in handles:
                h.remove()
        loss = scaled.detach() / scale
        if axes:
            loss = all_reduce_axes(loss.clone(), mesh, axes) / n
        return loss, finite[0]

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Marks one accumulation micro-step: ``sync_gradients`` is true on
        every ``gradient_accumulation_steps``-th call, on a prepared loader's
        last batch (which also starts the count again) and always with
        ``sync_each_batch``. Bookkeeping for schedulers and user code: the
        step's own boundaries are the optimizer's."""
        self._accum_count += 1
        gs = self.gradient_state
        end = gs.end_of_dataloader and gs.sync_with_dataloader
        gs._set_sync_gradients(self._accum_count % gs.num_steps == 0 or end
                               or gs.plugin.sync_each_batch)
        try:
            yield
        finally:
            if end:
                self._accum_count = 0

    @contextlib.contextmanager
    def no_sync(self, model=None):
        """``sync_gradients`` false inside, restored after."""
        prev = self.gradient_state.sync_gradients
        self.gradient_state._set_sync_gradients(False)
        try:
            yield
        finally:
            self.gradient_state._set_sync_gradients(prev)

    def clip_grad_norm_(self, grads, max_norm: float, norm_type: int = 2):
        """``(grads · min(1, max_norm / (norm + 1e-6)), norm)`` with ``norm``
        the global L2 norm of the tree (``optax.global_norm``)."""
        if norm_type != 2:
            raise NotImplementedError("only the L2 global norm is ported")
        norm = torch.sqrt(sum(torch.sum(g * g) for g in param_leaves(grads)))
        scale = torch.clamp_max(max_norm / (norm + 1e-6), 1.0)
        return _tree_map(lambda g: g * scale, grads), norm

    def clip_grad_value_(self, grads, clip_value: float):
        """Every gradient element clipped to ``[-clip_value, clip_value]``."""
        return _tree_map(lambda g: torch.clamp(g, -clip_value, clip_value), grads)

    # ------------------------------------------------------- long context --
    def context_parallel_attention(self, strategy: Optional[str] = None):
        """The ``attention_fn`` of the mesh: over ``cp`` with ``strategy``
        (default the config's ``cp_rotate_method``), Ulysses over ``sp``,
        plain attention otherwise. Pass it to the model's ``attention_fn``."""
        from .ops.attention import dot_product_attention
        from .parallel.long_context import make_context_parallel_attention

        axis = self.mesh.sequence_axis
        if axis == "cp":
            return make_context_parallel_attention(
                self.mesh, strategy=strategy or self.parallelism_config.cp_rotate_method)
        if axis == "sp":
            return make_context_parallel_attention(self.mesh, strategy="ulysses")
        return lambda q, k, v, causal=True, scale=None: dot_product_attention(
            q, k, v, causal=causal, scale=scale)

    @contextlib.contextmanager
    def maybe_context_parallel(self, buffers=None, buffer_seq_dims=None, no_restore_buffers=None):
        """The JAX package's parity shim for the reference's per-step buffer
        sharding: the prepared loader already yields each rank's chunk of
        the sequence and :meth:`context_parallel_attention` does the rest,
        so buffer arguments are ignored, with a warning."""
        if buffers is not None or buffer_seq_dims is not None or no_restore_buffers is not None:
            warnings.warn(
                "maybe_context_parallel buffer arguments are ignored under SPMD: "
                "sequence sharding comes from the prepared dataloader (seq_dim) "
                "and the attention_fn from accelerator.get_attention_fn(); no "
                "per-step in-place buffer resharding exists or is needed",
                stacklevel=2,
            )
        yield

    # ------------------------------------------------------- small helpers --
    @contextlib.contextmanager
    def join_uneven_inputs(self, joinables=None, even_batches=None):
        """Nothing to join: a prepared loader's ``even_batches`` wraps
        around, so every rank takes the same number of steps."""
        yield

    def set_trigger(self) -> None:
        """Flag this process, for :meth:`check_trigger` on every process."""
        self.flag_tensor = True

    def check_trigger(self) -> bool:
        """True on every process when any process called
        :meth:`set_trigger` since the last check (the flags gathered over
        the process group); clears this process's flag."""
        flags = ops.gather_object(bool(self.flag_tensor))
        self.flag_tensor = False
        return any(flags)

    def unwrap_model(self, model, keep_fp32_wrapper: bool = True):
        """``model`` itself: params are never wrapped."""
        return model

    def free_memory(self, *objects):
        """Drop the prepared models, optimizers, schedulers, loaders and
        registered objects, collect garbage and empty CUDA's cache."""
        import gc

        for lst in (self._models, self._plans, self._optimizers, self._schedulers,
                    self._dataloaders, self._custom_objects):
            lst.clear()
        self._sharding_plan = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return objects

    @contextlib.contextmanager
    def autocast(self, autocast_handler: Optional[AutocastConfig] = None):
        """Train steps built inside ``autocast(AutocastConfig(enabled=
        False))`` (or under the ``AutocastConfig`` handler) compute in the
        param dtype; steps built before, or after, keep the policy they
        were built with."""
        handler = autocast_handler or self.autocast_handler
        prev = self._autocast_enabled
        if handler is not None:
            self._autocast_enabled = bool(handler.enabled)
        try:
            yield
        finally:
            self._autocast_enabled = prev

    # ------------------------------------------------------- checkpointing --
    def _plan_for(self, params):
        """The plan ``params`` were prepared with (the last plan when they
        are not a prepared tree)."""
        for model, plan in zip(self._models, self._plans):
            if model is params:
                return plan
        return self._sharding_plan

    def register_for_checkpointing(self, *objects) -> None:
        """Objects with ``state_dict``/``load_state_dict`` that
        ``save_state``/``load_state`` cover (``custom_checkpoint_<i>``)."""
        for obj in objects:
            if not (hasattr(obj, "state_dict") and hasattr(obj, "load_state_dict")):
                raise ValueError(f"{obj} lacks state_dict/load_state_dict")
            self._custom_objects.append(obj)

    def register_save_state_pre_hook(self, hook: Callable) -> RemovableHandle:
        """``hook(models, output_dir)`` runs at the start of every
        :meth:`save_state`, with the resolved directory."""
        handle = RemovableHandle(self._save_state_pre_hooks)
        self._save_state_pre_hooks[handle.id] = hook
        return handle

    def register_load_state_pre_hook(self, hook: Callable) -> RemovableHandle:
        """``hook(models, input_dir)`` runs at the start of every
        :meth:`load_state`, with the resolved directory."""
        handle = RemovableHandle(self._load_state_pre_hooks)
        self._load_state_pre_hooks[handle.id] = hook
        return handle

    def save_state(self, output_dir: Optional[str] = None, params=None, opt_state=None,
                   blocking: Optional[bool] = None, **kwargs) -> str:
        """A resumable checkpoint of the prepared state (or of ``params`` and
        the optimizer of ``opt_state``) in ``output_dir`` (``checkpoint_<i>``
        under the project dir with automatic naming). Blocking by default
        (``CheckpointConfig.async_save`` flips it): with ``blocking=False``
        it returns once every byte is on the host, and the writer thread
        writes and commits; the directory is on disk after
        :meth:`wait_for_checkpoint`. Either way the save is
        crash-consistent (see :mod:`.checkpointing`). Returns the final
        directory; :attr:`last_checkpoint` holds the save's timings."""
        from .checkpointing import save_accelerator_state, snapshot_accelerator_state

        if blocking is None:
            blocking = not self.checkpoint_config.async_save
        kwargs.setdefault("save_on_each_node", self.checkpoint_config.save_on_each_node)
        if blocking:
            if self._checkpoint_manager is not None:
                self._checkpoint_manager.drain()  # saves land in call order
            return save_accelerator_state(self, output_dir=output_dir, params=params,
                                          opt_state=opt_state, **kwargs)
        if self._checkpoint_manager is None:
            from .checkpoint_async import CheckpointManager

            self._checkpoint_manager = CheckpointManager(self.checkpoint_config.max_in_flight)
        manager = self._checkpoint_manager
        manager.check_error()
        manager.reserve_slot()
        try:
            snap = snapshot_accelerator_state(self, output_dir=output_dir, params=params,
                                              opt_state=opt_state,
                                              active_staging=manager.active_staging(), **kwargs)
            self.last_checkpoint = snap
            return manager.submit(snap)
        except BaseException:
            manager.release_slot()
            raise

    def wait_for_checkpoint(self, timeout: Optional[float] = None) -> None:
        """Wait until every async save has committed; raises the first
        writer error."""
        if self._checkpoint_manager is not None:
            self._checkpoint_manager.drain(timeout=timeout)

    @property
    def resume_from_checkpoint(self) -> Optional[str]:
        """``ACCELERATE_RESUME_FROM_CHECKPOINT`` (``"latest"`` or a
        directory), or None when no resume was asked for."""
        raw = os.environ.get("ACCELERATE_RESUME_FROM_CHECKPOINT", "").strip()
        return raw or None

    def load_state(self, input_dir: Optional[str] = None, params=None, opt_state=None,
                   **kwargs):
        """Restore a checkpoint into the prepared state in place
        (:func:`~.checkpointing.load_accelerator_state`); ``None`` or
        ``"latest"`` takes the newest committed ``checkpoint_<i>`` of the
        project dir. ``elastic=True`` re-shards across ``dp_replicate``
        widths. An async save in flight commits first."""
        from .checkpointing import load_accelerator_state

        if input_dir == "latest":
            input_dir = None
        self.wait_for_checkpoint()
        return load_accelerator_state(self, input_dir=input_dir, params=params,
                                      opt_state=opt_state, **kwargs)

    def get_state_dict(self, params, unwrap: bool = True):
        """``params`` as whole CPU tensors of their own (each gathered over
        the mesh when the plan splits it): copies, which later steps do not
        change."""
        plan = self._plan_for(params)
        if plan is not None and plan.distributed:
            params = plan.gather_params_no_grad(params)
        return _tree_map(lambda t: t.detach().to("cpu", copy=True)
                         if isinstance(t, torch.Tensor) else t, params)

    def save_model(self, params, save_directory: str, max_shard_size="10GB",
                   safe_serialization: bool = True) -> list:
        """``params`` (gathered whole) as safetensors or npz
        (:func:`~.checkpointing.save_model`), written by the main process;
        returns the files (none on the other processes)."""
        from .checkpointing import save_model

        full = self.get_state_dict(params)
        written = []
        if self.is_main_process:
            written = save_model(full, save_directory, max_shard_size=max_shard_size,
                                 safe_serialization=safe_serialization)
        self.wait_for_everyone()
        return written

    # ------------------------------------------------------------ trackers --
    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None) -> None:
        """Start the trackers of ``log_with`` (:func:`~.tracking.
        filter_trackers`), logging under the project's ``logging_dir``."""
        from .tracking import filter_trackers

        self.trackers = filter_trackers(self.log_with, project_name,
                                        self.project_configuration.logging_dir, config,
                                        init_kwargs or {})

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if getattr(tracker, "name", None) == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"no tracker named {name!r} (have {[t.name for t in self.trackers]})")

    def log(self, values: dict, step: Optional[int] = None,
            log_kwargs: Optional[dict] = None) -> None:
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log(values, step=step, **((log_kwargs or {}).get(tracker.name, {})))

    def log_images(self, values: dict, step: Optional[int] = None,
                   log_kwargs: Optional[dict] = None) -> None:
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log_images(values, step=step,
                                   **((log_kwargs or {}).get(tracker.name, {})))

    def log_table(self, table_name: str, columns: Optional[list] = None,
                  data: Optional[list] = None, dataframe=None, step: Optional[int] = None,
                  log_kwargs: Optional[dict] = None) -> None:
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.log_table(table_name, columns=columns, data=data, dataframe=dataframe,
                                  step=step, **((log_kwargs or {}).get(tracker.name, {})))

    def end_training(self) -> None:
        """Drain and stop the checkpoint writer (its errors raise here),
        finish the trackers, and wait for every process."""
        if self._checkpoint_manager is not None:
            self._checkpoint_manager.shutdown(drain=True)
            self._checkpoint_manager = None
        if self.is_main_process:
            for tracker in self.trackers:
                tracker.finish()
        self.wait_for_everyone()

    def __del__(self):
        # an interpreter exiting with an async save in flight must not tear
        # its write (the writer is a daemon thread)
        try:
            manager = getattr(self, "_checkpoint_manager", None)
            if manager is not None:
                manager.shutdown(drain=True)
        except Exception:
            pass
