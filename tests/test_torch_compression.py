"""Gradient compression (``DistributedDataParallelKwargs(comm_hook=)``) and
the kwargs handlers, against the JAX package's ``prepare_train_step`` at
one process, on the CPU.

The hook bounds the gradient to fp16 or bf16 (a cast and back) while it is
still loss-scaled, after the reduction over the batch ranks and before the
unscale, as JAX casts its global gradient. Three SGD steps of the tiny
Llama (f32) with each hook, whose update is the compressed gradient times
the learning rate: losses within 1e-6 relative and each leaf's 3-step
update within ``UPDATE_TOL`` relative L2 of JAX's. Both sides' f32
gradients differ in the order of their sums, and an element whose sum
lands on the other side of a rounding boundary of the compressed dtype
moves by one unit of it: the worst leaf measured 9.7e-5 (fp16) and 4.4e-4
(bf16). The port's step without the hook is 2.1e-4 and 1.6e-3 from JAX's
compressed one at its closest leaf, so each bar sits between the two, and
the test checks that the uncompressed step misses it. PowerSGD warns and casts to bf16, as
JAX's does. A gradient of about 1e-8 under fp16 with a scale of 2^16
survives, because the cast is made before the unscale: after it the value
would lie below fp16's smallest subnormal (6e-8) and vanish.
"""

import contextlib
import dataclasses
from datetime import timedelta

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
from accelerate_tpu_torch.optimizer import sgd
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils.modeling import named_parameters

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
STEPS = 3
LR = 0.5
UPDATE_TOL = {"fp16": 1.5e-4, "bf16": 8e-4, "power_sgd": 8e-4}


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (lambda: AcceleratorState._reset_state(reset_partial_state=True),
                  GradientState._reset_state, JAcceleratorState._reset_state,
                  JGradientState._reset_state, JPartialState._reset_state):
        reset()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("hook", ["no", "fp16", "bf16", "power_sgd"])
def test_dtype_of_each_hook_matches_jax(hook):
    ours = tdc.DistributedDataParallelKwargs(comm_hook=hook)
    theirs = jdc.DistributedDataParallelKwargs(comm_hook=hook)
    if hook == "power_sgd":
        with pytest.warns(UserWarning, match="PowerSGD"):
            got = ours.gradient_compression_dtype()
        with pytest.warns(UserWarning, match="PowerSGD"):
            want = theirs.gradient_compression_dtype()
    else:
        got, want = ours.gradient_compression_dtype(), theirs.gradient_compression_dtype()
    assert (None if got is None else str(got).split(".")[-1]) == want
    assert ours.to_dict().keys() == theirs.to_dict().keys()
    assert str(ours.comm_hook) == str(theirs.comm_hook) == hook


@pytest.mark.parametrize("hook", ["fp16", "bf16", "power_sgd"])
def test_comm_hook_step_matches_jax(hook):
    jp = jax.tree_util.tree_map(np.asarray, jt.init_llama(JCFG, jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(1, JCFG.vocab_size, (STEPS, 4, 64)).astype(np.int32)
    jacc = JAccelerator(cpu=True, kwargs_handlers=[jdc.DistributedDataParallelKwargs(
        comm_hook=hook)])
    jparams, jopt = jacc.prepare(jax.tree_util.tree_map(np.array, jp), optax.sgd(LR))
    with pytest.warns(UserWarning) if hook == "power_sgd" else contextlib.nullcontext():
        jstep = jacc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, JCFG))
    state, jl = jopt.opt_state, []
    for k in range(STEPS):
        jparams, state, m = jstep(jparams, state, {"input_ids": ids[k]})
        jl.append(float(m["loss"]))
    start = named_parameters(params_from_numpy(jp, device="cpu"))
    want = named_parameters(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                              device="cpu"))
    worst = {}
    for with_hook in (True, False):
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        acc = Accelerator(cpu=True, kwargs_handlers=[tdc.DistributedDataParallelKwargs(
            comm_hook=hook if with_hook else "no")])
        params, opt = acc.prepare(params_from_numpy(jp, device="cpu"), sgd(LR))
        with (pytest.warns(UserWarning) if hook == "power_sgd" and with_hook
              else contextlib.nullcontext()):
            step = acc.prepare_train_step(lambda p, b: tt.llama_loss(p, b, TCFG), opt)
        tl = []
        for k in range(STEPS):
            params, _, m = step(params, opt.opt_state, {"input_ids": torch.from_numpy(ids[k])})
            tl.append(float(m["loss"]))
        if with_hook:
            np.testing.assert_allclose(tl, jl, rtol=1e-6)
        errs = []
        for k, v in named_parameters(params).items():
            moved = (want[k] - start[k]).detach()
            if float(moved.abs().max()) >= 1e-9:  # skip a zero gradient
                errs.append(_rel_l2((v - start[k]).detach(), moved))
        worst[with_hook] = max(errs) if with_hook else min(errs)
    assert worst[True] <= UPDATE_TOL[hook], worst
    assert worst[False] > UPDATE_TOL[hook], worst  # the bar sees an uncompressed step


def test_small_gradient_survives_fp16_because_the_cast_precedes_the_unscale():
    """A gradient of 1e-8 at a loss scale of 2**16 is 6.6e-4 when the fp16
    hook casts it (a normal fp16 number); unscaled first, it would be 1e-8,
    under fp16's smallest subnormal, and cast to 0. SGD(1) from zeros makes
    the update the gradient itself: held to JAX's."""
    n = 64
    scaler = dict(init_scale=2.0 ** 16)

    def tloss(p, b):
        return p["w"].float().sum() * 1e-8

    def jloss(p, b):
        return p["w"].astype(np.float32).sum() * 1e-8

    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      grad_scaler_config=tdc.GradScalerConfig(**scaler),
                      kwargs_handlers=[tdc.DistributedDataParallelKwargs(comm_hook="fp16")])
    params, opt = acc.prepare({"w": torch.zeros(n)}, sgd(1.0))
    params, _, m = acc.prepare_train_step(tloss, opt)(params, opt.opt_state, {})
    got = params["w"].detach().numpy()
    jacc = JAccelerator(cpu=True, mixed_precision="fp16",
                        grad_scaler_config=jdc.GradScalerConfig(**scaler),
                        kwargs_handlers=[jdc.DistributedDataParallelKwargs(comm_hook="fp16")])
    jparams, jopt = jacc.prepare({"w": np.zeros(n, np.float32)}, optax.sgd(1.0))
    jparams, _, _ = jacc.prepare_train_step(jloss, jopt)(jparams, jopt.opt_state, {})
    assert bool(m["grads_finite"])
    np.testing.assert_allclose(got, -1e-8, rtol=1e-3)
    np.testing.assert_array_equal(got, np.asarray(jparams["w"]))
    # the other order loses it: 1e-8 is below fp16's smallest subnormal
    assert float(torch.tensor(1e-8).to(torch.float16)) == 0.0


def test_kwargs_handlers_route_as_in_jax():
    with pytest.raises(ValueError, match="duplicate kwargs handler"):
        Accelerator(cpu=True, kwargs_handlers=[tdc.DistributedDataParallelKwargs(),
                                               tdc.DistributedDataParallelKwargs()])
    with pytest.raises(ValueError, match="duplicate kwargs handler"):
        JAccelerator(cpu=True, kwargs_handlers=[jdc.DistributedDataParallelKwargs(),
                                                jdc.DistributedDataParallelKwargs()])
    with pytest.raises(ValueError, match="given both"):
        Accelerator(cpu=True, grad_scaler_config=tdc.GradScalerConfig(),
                    kwargs_handlers=[tdc.GradScalerConfig()])
    with pytest.raises(ValueError, match="unsupported kwargs handler"):
        Accelerator(cpu=True, kwargs_handlers=[object()])
    acc = Accelerator(cpu=True, kwargs_handlers=[
        tdc.DistributedDataParallelKwargs(comm_hook="bf16", bucket_cap_mb=50),
        tdc.GradScalerConfig(init_scale=8.0),
        tdc.InitProcessGroupKwargs(initialization_timeout=timedelta(seconds=30))])
    assert acc.ddp_handler.comm_hook == "bf16" and acc.grad_scaler_config.init_scale == 8.0


@pytest.mark.parametrize("name,item", [("CheckpointConfig", "7"), ("AutocastConfig", "14"),
                                       ("ProfileConfig", "12"), ("FP8RecipeKwargs", "8")])
def test_handlers_of_later_items_raise_naming_the_item(name, item):
    """A handler of an item still to port raises naming the item; one of
    an item ported since (7, 14, 8) is taken as the port's own class, and
    the JAX package's object of it is refused like any foreign handler."""
    handler = getattr(jdc, name)()  # the JAX package's own object
    if item in ("7", "14", "8"):
        Accelerator(cpu=True, kwargs_handlers=[getattr(tdc, name)()])
        with pytest.raises(ValueError, match="unsupported kwargs handler"):
            Accelerator(cpu=True, kwargs_handlers=[handler])
        return
    with pytest.raises(NotImplementedError, match=f"item {item}\\b"):
        Accelerator(cpu=True, kwargs_handlers=[handler])


def test_init_process_group_kwargs_fields_match_jax():
    ours, theirs = tdc.InitProcessGroupKwargs(), jdc.InitProcessGroupKwargs()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in
                                                          dataclasses.fields(theirs)]
    assert ours.initialization_timeout == theirs.initialization_timeout
    with pytest.raises(ValueError, match="one device"):
        Accelerator(cpu=True, kwargs_handlers=[tdc.InitProcessGroupKwargs(
            local_device_ids=[0, 1])])
