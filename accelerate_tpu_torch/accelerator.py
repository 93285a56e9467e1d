"""The training entry point: the port of ``accelerate_tpu.accelerator`` for
one process on one device.

``Accelerator.prepare`` places params, binds optimizers and wraps data
loaders; ``prepare_train_step`` / ``prepare_train_loop`` build the step the
JAX package compiles in ``_build_train_step`` (its non-fp16 branch): cast
params and batch to the compute dtype, ``loss_fn``, loss to f32, backward
(gradients come back through the cast in the param dtype), optimizer step,
``metrics = {"loss": ...}``.

The signatures stay functional — ``step(params, opt_state, batch)`` and
``loop(params, opt_state, batches)`` return ``(params, opt_state,
metrics)`` — but the params and the optimizer state are updated **in
place** and the same objects are returned. The loop's K steps run as a
Python loop with no host sync inside it: the losses stay on the device
until the caller reads them.

Not ported yet (see ROADMAP.md): ``mixed_precision="fp16"`` (dynamic loss
scaling) and ``"fp8"``, gradient accumulation, the mesh and its sharded
placement, trackers, checkpointing, schedulers.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional

import numpy as np
import torch

from .data_loader import DataLoader, DataLoaderShard, prepare_data_loader
from .optimizer import AcceleratedOptimizer, OptimizerFactory, param_leaves
from .state import AcceleratorState, GradientState
from .utils.dataclasses import PrecisionType

__all__ = ["Accelerator", "set_seed"]


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's generators (every device)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _is_param_tree(obj) -> bool:
    """A nested dict with a tensor or array leaf."""
    return isinstance(obj, dict) and any(
        _is_param_tree(v) or isinstance(v, (torch.Tensor, np.ndarray)) for v in obj.values())


def _step_slice(tree, k: int):
    if isinstance(tree, dict):
        return type(tree)((key, _step_slice(v, k)) for key, v in tree.items())
    return tree[k]


def _leading_dim(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class Accelerator:
    """One process on one device: the CUDA device unless ``cpu=True`` or
    ``device="cpu"``; without a GPU and without either, construction
    raises."""

    def __init__(self, mixed_precision: Optional[str] = None, rng_seed: Optional[int] = None,
                 cpu: bool = False, device_placement: bool = True,
                 gradient_accumulation_steps: int = 1, device=None):
        precision = PrecisionType(str(mixed_precision if mixed_precision is not None
                                      else os.environ.get("ACCELERATE_MIXED_PRECISION", "no")))
        if precision in (PrecisionType.FP16, PrecisionType.FP8):
            raise NotImplementedError(
                f"mixed_precision={precision.value!r} is not ported yet (fp16 needs the dynamic "
                "loss scaling of the JAX package's train step, fp8 its scaled matmuls; see "
                "ROADMAP.md)"
            )
        if gradient_accumulation_steps > 1:
            raise NotImplementedError(
                "gradient_accumulation_steps > 1 is not ported yet (see ROADMAP.md)")
        self.state = AcceleratorState(mixed_precision=precision.value, cpu=cpu, device=device)
        self.gradient_state = GradientState(num_steps=gradient_accumulation_steps)
        self.device_placement = device_placement
        self._optimizers: list = []
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
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    def wait_for_everyone(self) -> None:
        self.state.wait_for_everyone()

    def print(self, *args, **kwargs) -> None:
        self.state.print(*args, **kwargs)

    # --------------------------------------------------------------- prepare --
    def prepare(self, *args):
        """Prepare each argument by type: a param dict is placed on the
        device (:meth:`prepare_model`), an optimizer or a factory such as
        :func:`~accelerate_tpu_torch.optimizer.adamw` becomes an
        :class:`AcceleratedOptimizer` over those params, a :class:`DataLoader`
        yields batches on the device. Anything else passes through."""
        results = list(args)
        params_seen = None
        for i, obj in enumerate(args):  # params first: the optimizers bind to them
            if _is_param_tree(obj):
                results[i] = params_seen = self.prepare_model(obj)
        for i, obj in enumerate(args):
            if isinstance(obj, (DataLoader, DataLoaderShard)):
                results[i] = self.prepare_data_loader(obj)
            elif isinstance(obj, (AcceleratedOptimizer, torch.optim.Optimizer, OptimizerFactory)):
                results[i] = self.prepare_optimizer(obj)
        if params_seen is not None:
            for opt in self._optimizers:
                if opt.optimizer is None:
                    opt.init(params_seen)
        return results[0] if len(results) == 1 else tuple(results)

    def prepare_model(self, params: dict) -> dict:
        """Fresh leaf tensors on the device (copies: the caller's tensors or
        arrays are never updated), floating ones with ``requires_grad``. The
        dtypes are kept: f32 params are the masters of mixed precision."""

        def place(x):
            t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            t = t.to(self.device if self.device_placement else t.device, copy=True)
            return t.requires_grad_(True) if t.is_floating_point() else t

        def walk(tree):
            return {k: walk(v) if isinstance(v, dict) else place(v) for k, v in tree.items()}

        return walk(params)

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(optimizer)
        self._optimizers.append(optimizer)
        return optimizer

    def prepare_data_loader(self, dataloader) -> DataLoaderShard:
        return prepare_data_loader(dataloader, self.device)

    # ------------------------------------------------------------ train step --
    def _resolve_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if optimizer is None:
            if not self._optimizers:
                raise ValueError("prepare an optimizer first or pass one explicitly")
            optimizer = self._optimizers[-1]
        if optimizer.optimizer is None:
            raise ValueError("the optimizer is not bound to params: prepare it with them")
        return optimizer

    def _build_train_step(self, loss_fn: Callable, optimizer: AcceleratedOptimizer) -> Callable:
        policy = self.state.mixed_precision_policy
        torch_opt = optimizer.optimizer
        bound = optimizer.params

        def train_step(params, opt_state, batch):
            if opt_state is not optimizer.opt_state:
                raise ValueError("opt_state is not the state of the prepared optimizer (the port "
                                 "updates the optimizer's own state in place)")
            leaves = param_leaves(params)
            if len(leaves) != len(bound) or any(a is not b for a, b in zip(leaves, bound)):
                raise ValueError("params are not the tensors the optimizer was prepared with")
            torch_opt.zero_grad(set_to_none=True)
            loss = loss_fn(policy.cast_to_compute(params), policy.cast_to_compute(batch)).float()
            loss.backward()
            torch_opt.step()
            return params, opt_state, {"loss": loss.detach()}

        return train_step

    def prepare_train_step(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None) -> Callable:
        """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
        for ``loss_fn(params, batch) -> scalar``; updates in place."""
        return self._build_train_step(loss_fn, self._resolve_optimizer(optimizer))

    def prepare_train_loop(self, loss_fn: Callable,
                           optimizer: Optional[AcceleratedOptimizer] = None) -> Callable:
        """``loop(params, opt_state, batches) -> (params, opt_state, metrics)``
        where ``batches`` carries a leading ``[K, ...]`` step axis (see
        :func:`~accelerate_tpu_torch.utils.operations.stack_batches`) and
        ``metrics["loss"]`` is stacked ``[K]``. The same update as K calls of
        the :meth:`prepare_train_step` function, run as a Python loop with
        no host sync; params and optimizer state are updated in place."""
        step = self._build_train_step(loss_fn, self._resolve_optimizer(optimizer))

        def train_loop(params, opt_state, batches):
            losses = []
            for k in range(_leading_dim(batches)):
                params, opt_state, metrics = step(params, opt_state, _step_slice(batches, k))
                losses.append(metrics["loss"])
            return params, opt_state, {"loss": torch.stack(losses)}

        return train_loop

    def prepare_eval_step(self, eval_fn: Callable) -> Callable:
        """``eval_step(params, batch)``: ``eval_fn`` on the compute-dtype
        casts, without autograd."""
        policy = self.state.mixed_precision_policy

        def eval_step(params, batch):
            with torch.no_grad():
                return eval_fn(policy.cast_to_compute(params), policy.cast_to_compute(batch))

        return eval_step
