"""``prepare_train_step(offload_optimizer=)``: the optimizer state in
(pinned) host memory between steps, staged onto the device group by group
inside each update (``parallel.sharding.OptimizerOffload``), on the CPU.

On the CPU the same staging code runs with copies from the CPU to the
CPU, so the offloaded step must be the plain step bitwise (on one thread):
AdamW (its params staged in blocks of rows: a group bound of 64 KiB
splits the embedding and the stacked leaves), adafactor (whole params),
SGD with momentum, a global-norm clip, and fp16 with its loss scale. Both
are held to the JAX package's ``prepare_train_step`` (whose CPU backend
cannot compile memory kinds, so its offloaded step is its plain step):
losses within 1e-6 relative (measured 2.3e-7) and params within 1e-5
relative L2 per leaf after 3 steps (measured 6.3e-6, AdamW's normalised
step magnifying f32 sums in another order, as ``test_torch_train.py``
explains). The JAX
package's ``ValueError`` without a live optimizer state, its warnings
(``nvme``, the scanned loop) and the plugins that turn offload on are held
too.
"""

import dataclasses
import warnings

import jax
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import adafactor, adamw, chain, clip_by_global_norm, sgd
from accelerate_tpu_torch.parallel.sharding import OptimizerOffload
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import (
    DeepSpeedPlugin,
    FullyShardedDataParallelPlugin,
    GradScalerConfig,
)
from accelerate_tpu_torch.utils.modeling import named_parameters

JCFG = dataclasses.replace(jt.LlamaConfig.tiny(), n_layers=3)
TCFG = tt.LlamaConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)
                         if f.name in tt.LlamaConfig.__dataclass_fields__})
STEPS = 3
GROUP_BYTES = 64 << 10
SCALER = dict(init_scale=2.0 ** 40, backoff_factor=2.0 ** -30, growth_factor=2.0,
              growth_interval=2)
FACTORIES = {
    "adamw": (lambda: adamw(1e-3), lambda: optax.adamw(1e-3)),
    "adafactor": (lambda: adafactor(1e-3), lambda: optax.adafactor(1e-3)),
    "sgd_momentum": (lambda: sgd(1e-2, momentum=0.9), lambda: optax.sgd(1e-2, momentum=0.9)),
    "clip_adamw": (lambda: chain(clip_by_global_norm(0.5), adamw(1e-3)),
                   lambda: optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(1e-3))),
}


@pytest.fixture(autouse=True)
def _fresh_state():
    # one thread: the embedding backward's scatter order depends on the
    # thread count, and two plain runs differ in their last bits otherwise
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    torch.set_num_threads(threads)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


@pytest.fixture(scope="module")
def setup():
    jp = jax.tree_util.tree_map(np.asarray, jt.init_llama(JCFG, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    ids = rng.integers(1, JCFG.vocab_size, (STEPS, 4, 64)).astype(np.int32)
    return jp, ids


def _port(jp, ids, factory, offload, precision="no", scaler=None, acc_kw=None):
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, mixed_precision=precision,
                      grad_scaler_config=GradScalerConfig(**scaler) if scaler else None,
                      **(acc_kw or {}))
    params, opt = acc.prepare(params_from_numpy(jp, device="cpu"), factory)
    step = acc.prepare_train_step(lambda p, b: tt.llama_loss(p, b, TCFG), opt,
                                  offload_optimizer=offload)
    if opt.offload is not None:
        opt.offload.group_bytes = GROUP_BYTES
    losses, scales = [], []
    for k in range(STEPS):
        params, _, m = step(params, opt.opt_state, {"input_ids": torch.from_numpy(ids[k])})
        losses.append(float(m["loss"]))
        if precision == "fp16":
            scales.append(float(m["loss_scale"]))
    flat = {k: v.detach().clone() for k, v in named_parameters(params).items()}
    return losses, scales, flat, opt


def _jax(jp, ids, tx, precision="no", scaler=None):
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    acc = JAccelerator(cpu=True, mixed_precision=precision,
                       grad_scaler_config=jdc.GradScalerConfig(**scaler) if scaler else None)
    params, opt = acc.prepare(jax.tree_util.tree_map(np.array, jp), tx)
    step = acc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, JCFG))
    state, losses = opt.opt_state, []
    for k in range(STEPS):
        params, state, m = step(params, state, {"input_ids": ids[k]})
        losses.append(float(m["loss"]))
    flat = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return losses, {k: v.detach() for k, v in named_parameters(flat).items()}


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


@pytest.mark.parametrize("name", list(FACTORIES))
@pytest.mark.parametrize("precision", ["no", "fp16"])
def test_offloaded_step_is_the_plain_step_bitwise_and_jax(setup, name, precision):
    jp, ids = setup
    ours, theirs = FACTORIES[name]
    scaler = SCALER if precision == "fp16" else None
    plain = _port(jp, ids, ours(), False, precision, scaler)
    off = _port(jp, ids, ours(), True, precision, scaler)
    opt = off[3]
    assert isinstance(opt.offload, OptimizerOffload) and plain[3].offload is None
    assert opt.offload.stats["groups"] > STEPS  # more than one group a step
    if name != "adafactor":  # AdamW and SGD are elementwise: rows split below the bound
        assert opt.offload.elementwise
    assert off[0] == plain[0] and off[1] == plain[1]
    for k in plain[2]:
        assert torch.equal(off[2][k], plain[2][k]), k
    # the state lives on the host between steps, every tensor with a dim
    held = [v for st in opt.optimizer.state.values() for v in st.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0]
    assert held and all(v.device.type == "cpu" for v in held)
    assert opt.offload.host_bytes() == plain[3].state_bytes()
    if precision == "fp16":
        assert off[1] == [2.0 ** 10, 2.0 ** 10, 2.0 ** 11]
        return  # the scale's first step overflows; JAX's fp16 is held in test_torch_grad_accum
    j_losses, j_params = _jax(jp, ids, theirs())
    np.testing.assert_allclose(off[0], j_losses, rtol=1e-6)
    for k, v in j_params.items():
        assert _rel_l2(off[2][k], v) <= 1e-5, (k, _rel_l2(off[2][k], v))


def test_offload_needs_a_live_optimizer_state():
    acc = Accelerator(cpu=True)
    opt = acc.prepare(adamw(0.1))
    with pytest.raises(ValueError, match="live optimizer state"):
        acc.prepare_train_step(lambda p, b: p["w"].sum(), opt, offload_optimizer=True)
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    from accelerate_tpu.parallel import sharding as jsh

    jacc = JAccelerator(cpu=True)
    jopt = jacc.prepare(optax.adam(0.1))
    jsh_support = jsh._host_offload_support
    jsh._host_offload_support = True
    try:
        with pytest.raises(ValueError, match="live optimizer state"):
            jacc.prepare_train_step(lambda p, b: 0.0, jopt, offload_optimizer=True)
    finally:
        jsh._host_offload_support = jsh_support


def test_plugins_turn_offload_on(setup):
    jp, ids = setup
    cases = [
        (dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=2, offload_optimizer_device="cpu")),
         True),
        (dict(fsdp_plugin=FullyShardedDataParallelPlugin(cpu_offload=True)), True),
        (dict(deepspeed_plugin=DeepSpeedPlugin(zero_stage=2)), False),
        ({}, False),
    ]
    for kw, on in cases:
        losses, _, _, opt = _port(jp, ids, adamw(1e-3), None, acc_kw=kw)
        assert (opt.offload is not None) == on, kw
    with pytest.warns(UserWarning, match="nvme"):
        _, _, _, opt = _port(jp, ids, adamw(1e-3), None, acc_kw=dict(
            deepspeed_plugin=DeepSpeedPlugin(zero_stage=2, offload_optimizer_device="nvme")))
    assert opt.offload is not None
    # the JAX package reads the same intents
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    assert JAccelerator(cpu=True, fsdp_plugin=jdc.FullyShardedDataParallelPlugin(
        cpu_offload=True))._offload_optimizer


def test_offload_false_brings_the_state_back(setup):
    jp, ids = setup
    _, _, _, opt = _port(jp, ids, adamw(1e-3), True)
    assert opt.offload is not None
    opt.offload_state(False)
    assert opt.offload is None


def test_train_loop_warns_when_offload_is_configured():
    acc = Accelerator(cpu=True, deepspeed_plugin=DeepSpeedPlugin(
        zero_stage=2, offload_optimizer_device="cpu"))
    params, opt = acc.prepare({"w": torch.ones(2)}, sgd(0.1))
    with pytest.warns(UserWarning, match="scanned train loop"):
        acc.prepare_train_loop(lambda p, b: (p["w"] * b).sum(), opt)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        acc = Accelerator(cpu=True)
        params, opt = acc.prepare({"w": torch.ones(2)}, sgd(0.1))
        acc.prepare_train_loop(lambda p, b: (p["w"] * b).sum(), opt)
