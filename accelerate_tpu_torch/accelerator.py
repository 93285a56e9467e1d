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
rank its blocks of the global gradient. Not ported yet (see ROADMAP.md):
``mixed_precision="fp8"``, adafactor under ZeRO-1, cp, sp and pp axes,
optimizer offload, trackers and checkpointing.
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
from .optimizer import AcceleratedOptimizer, OptimizerFactory, param_leaves
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DummyOptim,
    DummyScheduler,
    GradientAccumulationPlugin,
    GradScalerConfig,
    PrecisionType,
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
from .utils.operations import _tree_map, stack_batches

__all__ = ["Accelerator", "set_seed"]


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


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
                 rng_types: Optional[Sequence[str]] = None):
        precision = PrecisionType(str(mixed_precision if mixed_precision is not None
                                      else os.environ.get("ACCELERATE_MIXED_PRECISION", "no")))
        if precision == PrecisionType.FP8:
            raise NotImplementedError(
                "mixed_precision='fp8' is not ported yet (it needs the JAX package's scaled fp8 "
                "matmuls; see ROADMAP.md)")
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        for handler in kwargs_handlers or ():
            if not isinstance(handler, GradScalerConfig):
                raise ValueError(f"unsupported kwargs handler: {handler!r} (the port takes "
                                 "GradScalerConfig only)")
            if grad_scaler_config is not None:
                raise ValueError("grad_scaler_config given both directly and as a handler")
            grad_scaler_config = handler
        if deepspeed_plugin is not None and parallelism_config is None:
            parallelism_config = deepspeed_plugin.to_parallelism_config(
                PartialState(cpu=cpu, device=device).num_devices)
        self.deepspeed_plugin = deepspeed_plugin
        self._zero1_axis = ("dp_replicate" if getattr(deepspeed_plugin, "zero_stage", None) == 1
                            else None)
        self.shard_rules = shard_rules
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        self.rng_types = list(rng_types) if rng_types is not None else ["numpy"]
        self._sharding_plan = None
        self.state = AcceleratorState(mixed_precision=precision.value, cpu=cpu, device=device,
                                      parallelism_config=parallelism_config)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.grad_scaler_config = grad_scaler_config or GradScalerConfig()
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.device_placement = device_placement
        self._optimizers: list = []
        self._accum_count = 0
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
            elif isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)):
                results[i] = self.prepare_scheduler(obj)
        if params_seen is not None:
            for opt in self._optimizers:
                if opt.optimizer is None:
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
        return _tree_map(place, params)

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(
                optimizer, accumulation_steps=self.gradient_accumulation_steps)
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
        return prepare_data_loader(
            dataloader, self.device, mesh=self.mesh, device_placement=self.device_placement,
            split_batches=cfg.split_batches, even_batches=cfg.even_batches,
            dispatch_batches=cfg.dispatch_batches,
            rng_types=self.rng_types if self.num_processes > 1 else None,
            data_seed=cfg.data_seed, use_seedable_sampler=cfg.use_seedable_sampler,
            prefetch_depth=cfg.prefetch_depth, non_blocking=cfg.non_blocking)

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
        policy = self.state.mixed_precision_policy
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
        # the gradients as one flat tensor: one op each for the cast, the
        # sum over the batch ranks, the unscale, the finite check, the
        # zeroing, the norm and the accumulation
        flat_path = (meshed or fp16 or compute_grad_norm or optimizer.accumulation_steps > 1
                     or cast)
        if fp16:
            optimizer.init_loss_scale(self.grad_scaler_config, bound[0].device)

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
            leaves = param_leaves(params)
            if len(leaves) != len(bound) or any(a is not b for a, b in zip(leaves, bound)):
                raise ValueError("params are not the tensors the optimizer was prepared with")
            torch_opt.zero_grad(set_to_none=True)
            for p in bound:  # under ZeRO-1 the optimizer owns chunks or rows, not the params
                p.grad = None
            full = plan.gather_params(params, policy.compute_dtype) if meshed else params
            out = loss_fn(policy.cast_to_compute(full), policy.cast_to_compute(batch))
            loss, aux = out if has_aux else (out, None)
            loss = loss.float()
            (loss * optimizer.loss_scale if fp16 else loss).backward()
            metrics = {"loss": plan.mean_over_batch(loss.detach()) if meshed else loss.detach()}
            flat = None
            if flat_path:
                flat = flat_grads()
                if fp16:
                    flat = flat / optimizer.loss_scale
                    finite = torch.isfinite(flat).all()
                    if meshed:  # one decision for every rank, as JAX's one global isfinite
                        finite = all_reduce_axes(finite.float(), plan.mesh, tuple(plan.mesh.shape),
                                                 op="min") > 0
                    # an overflow feeds zeros: the update still runs, as in the JAX package
                    flat = torch.where(finite, flat, 0.0)
                    metrics["grads_finite"] = finite
                if compute_grad_norm:
                    metrics["grad_norm"] = torch.sqrt(sum_of_squares(flat))
            optimizer.micro_step(flat)
            if fp16:
                metrics["loss_scale"] = optimizer.update_loss_scale(finite)
            if aux is not None:
                metrics["aux"] = _detach(aux)
            return params, opt_state, metrics

        return train_step

    def prepare_train_step(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           has_aux: bool = False, compute_grad_norm: bool = False) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
        for ``loss_fn(params, batch) -> scalar`` (``(loss, aux)`` with
        ``has_aux``); one micro-step, updating in place. ``compute_grad_norm``
        adds the global L2 norm of this micro-step's (unscaled, zeroed on
        overflow) gradients."""
        return self._build_train_step(loss_fn, self._resolve_optimizer(optimizer), has_aux,
                                      compute_grad_norm)

    def prepare_train_loop(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None,
                           has_aux: bool = False, compute_grad_norm: bool = False) -> Callable:
        """``loop(params, opt_state, batches) -> (params, opt_state, metrics)``
        where ``batches`` carries a leading ``[K, ...]`` micro-step axis (see
        :func:`~accelerate_tpu_torch.utils.operations.stack_batches`) and every
        metric is stacked ``[K]``. The same update as K calls of the
        :meth:`prepare_train_step` function, run as a Python loop with no
        host sync; params and optimizer state are updated in place."""
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
