"""The port's training-loop options against the JAX package's, on the CPU.

- ``mixed_precision="fp16"`` with dynamic loss scaling, with and without
  accumulation, against the JAX fp16 step: a forced overflow with a short
  ``growth_interval`` (the accumulation legs in f32 and bf16 and the fp16
  default scaler are in ``tests/test_torch_grad_accum_steps.py``, a file of
  its own so that the test runner can spread the two; it shares this
  file's helpers and bars);
- an overflowed step feeds zeros to AdamW rather than skipping it;
- the optax schedules, the ``DummyScheduler`` schedule, ``adamw(schedule)``
  under accumulation against ``optax.MultiSteps(optax.adamw(schedule), 4)``;
- ``AcceleratedScheduler``, ``accumulate()`` over a prepared loader whose
  length is not a multiple of 4, ``no_sync()``;
- ``has_aux``, ``compute_grad_norm``, ``gradient_fn``, ``clip_grad_norm_``,
  ``clip_grad_value_`` and ``DummyOptim`` + ``DummyScheduler``.

Off a TPU, the JAX package's fused attention takes its einsum path (scores,
softmax and the value product in f32, one rounding at the output), so that
is the reference on this side; the port runs the fused kernels' plain
versions, which round p and ds to the compute dtype as the TPU kernels do.

Tolerances. f32: the two sides differ in the order of their f32 sums:
per-micro-step losses within 1e-5 relative (measured 7e-7), updates within
2e-4 relative L2 per leaf (measured 7.3e-5), gradient norms within 2e-4
relative (measured 4e-5), as in ``test_torch_train.py`` (whose docstring
says why updates and not params are compared, and why the key bias, whose
gradient is exactly zero, is held to the most its steps can move it).
bf16 and fp16: the frameworks round matmul outputs and activations at
different places, and AdamW turns those differences into the sign of small
steps: losses within 2e-3 relative (measured 4e-4 in bf16, 9e-5 in fp16),
updates within 0.3 relative L2 (measured at most 0.21 in bf16, 0.10 in
fp16), gradient norms within 2e-2 (measured 2e-3 in bf16 and 1e-3 in
fp16). The loss-scale and finite-flag sequences are decisions, not
roundings: they must equal JAX's exactly. The forced-overflow scaler makes
every decision clear-cut (a scale of 2**40 overflows fp16 by orders of
magnitude, 2**10 is far inside it), so no micro-step sits on the edge.
Schedules: f32 on both sides, the same operations; equal within four f32
steps (the two ``cos`` implementations round apart by an ulp, which the
products after it carry; measured 3 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import DataLoader as JDataLoader
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu.scheduler import AcceleratedScheduler as JScheduler
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu.utils.operations import stack_batches as jstack
import accelerate_tpu_torch as tpt
from accelerate_tpu_torch import (
    AcceleratedScheduler,
    Accelerator,
    BertConfig,
    DataLoader,
    DummyOptim,
    DummyScheduler,
    GradientAccumulationPlugin,
    GradScalerConfig,
    bert_loss,
)
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, adamw, param_leaves
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.operations import send_to_device, stack_batches
from accelerate_tpu_torch.utils.synthetic import DictDataset, make_synthetic_mrpc

LR = 1e-3
MICRO = 12  # micro-steps per run: 3 boundaries at accumulation 4
ACCUM = 4
LOSS_RTOL = {"no": 1e-5, "bf16": 2e-3, "fp16": 2e-3}
UPDATE_RTOL = {"no": 2e-4, "bf16": 0.3, "fp16": 0.3}
NORM_RTOL = {"no": 2e-4, "bf16": 2e-2, "fp16": 2e-2}
ZERO_GRAD = "layers/wk/bias"
# every decision clear-cut: overflow at 2**40, none at 2**10
FORCED = dict(init_scale=2.0 ** 40, growth_factor=2.0 ** 30, backoff_factor=2.0 ** -30,
              growth_interval=2)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()

@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this module's CPU-bound steps, restored
    after it: the suite runs several test workers on one machine, and a
    worker whose every op spreads over all the cores slows the others
    several times over. Every bar here is a tolerance or a decision, so
    the thread count (the order of a few CPU sums) cannot move a result
    past it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _named(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", v


def _bert():
    jcfg = jt.BertConfig(**{**jt.BertConfig.tiny().__dict__, "attn_impl": "fused"})
    tcfg = BertConfig(**{**BertConfig.tiny().__dict__, "attn_impl": "fused"})
    jparams = jt.init_bert(jcfg, jax.random.PRNGKey(0))
    data = make_synthetic_mrpc(64, 128, jcfg.vocab_size, seed=0)
    batches = [send_to_device(b, "cpu") for b in DataLoader(DictDataset(data), batch_size=16)]
    batches = [batches[i % len(batches)] for i in range(MICRO)]
    return jcfg, tcfg, jparams, batches


def _jax_loop(jparams, batches, jcfg, precision, accum, scaler=None, **kw):
    JAcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    acc = JAccelerator(mixed_precision=precision, gradient_accumulation_steps=accum,
                       grad_scaler_config=None if scaler is None else jdc.GradScalerConfig(**scaler))
    params, opt = acc.prepare(jparams, optax.adamw(LR))
    loop = acc.prepare_train_loop(lambda p, b: jt.bert_loss(p, b, jcfg), opt, **kw)
    params, _, metrics = loop(params, opt.opt_state, jstack(batches))
    assert opt.step_count == MICRO // accum
    return ({k: np.asarray(v) for k, v in metrics.items()},
            dict(_named(jax.tree_util.tree_map(np.asarray, params))))


def _port_acc(precision, accum, scaler=None, **kw):
    return Accelerator(mixed_precision=precision, cpu=True, gradient_accumulation_steps=accum,
                       grad_scaler_config=None if scaler is None else GradScalerConfig(**scaler),
                       **kw)


def _check_updates(t_params, j_flat, init, precision, steps):
    for name, t in _named(t_params):
        t_upd = t.detach().float().numpy() - init[name]
        j_upd = j_flat[name].astype(np.float32) - init[name]
        if name == ZERO_GRAD:  # zero gradient: noise, bounded by the AdamW steps taken
            assert np.abs(t_upd - j_upd).max() <= steps * LR
            continue
        rel = np.linalg.norm(t_upd - j_upd) / np.linalg.norm(j_upd)
        assert rel <= UPDATE_RTOL[precision], f"{name}: update rel L2 err {rel}"


def _fp16_run(accum, scaler):
    jcfg, tcfg, jparams, batches = _bert()
    init = dict(_named(jax.tree_util.tree_map(np.asarray, jparams)))
    acc = _port_acc("fp16", accum, scaler)
    params, opt = acc.prepare(jax.tree_util.tree_map(np.asarray, jparams), adamw(LR))
    loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, tcfg), opt, compute_grad_norm=True)
    out, state, metrics = loop(params, opt.opt_state, stack_batches(batches))
    assert out is params and state is opt.opt_state  # in place, identity kept
    assert opt.step_count == MICRO // accum
    assert {k: tuple(v.shape) for k, v in metrics.items()} == {
        k: (MICRO,) for k in ("loss", "grad_norm", "grads_finite", "loss_scale")}
    np_batches = [{k: v.numpy() for k, v in b.items()} for b in batches]
    j_metrics, j_flat = _jax_loop(jparams, np_batches, jcfg, "fp16", accum, scaler,
                                  compute_grad_norm=True)
    t_metrics = {k: v.numpy() for k, v in metrics.items()}
    np.testing.assert_array_equal(t_metrics["grads_finite"], j_metrics["grads_finite"])
    np.testing.assert_array_equal(t_metrics["loss_scale"], j_metrics["loss_scale"])
    np.testing.assert_allclose(t_metrics["loss"], j_metrics["loss"], rtol=LOSS_RTOL["fp16"])
    np.testing.assert_allclose(t_metrics["grad_norm"], j_metrics["grad_norm"],
                               rtol=NORM_RTOL["fp16"])
    _check_updates(params, j_flat, init, "fp16", MICRO // accum)
    # the scale lives on the optimizer, and state_dict carries it
    sd = opt.state_dict()["opt_state"]
    assert float(sd["loss_scale"]) == float(t_metrics["loss_scale"][-1])
    return t_metrics


@pytest.mark.parametrize("accum", [1, ACCUM])
def test_fp16_forced_overflow_matches_the_jax_step(accum):
    """Overflow at 2**40, back off to 2**10, grow to 2**40 after 2 finite
    micro-steps, overflow again: the same flags and scales as JAX on every
    micro-step, the updates within the fp16 envelope."""
    m = _fp16_run(accum, FORCED)
    assert list(m["grads_finite"]) == [False, True, True] * (MICRO // 3)
    assert list(m["loss_scale"]) == [2.0 ** 10, 2.0 ** 10, 2.0 ** 40] * (MICRO // 3)
    assert (m["grad_norm"][~m["grads_finite"]] == 0).all()


def test_overflow_feeds_zero_grads_to_adamw_and_does_not_skip_the_step():
    """An overflowed step: the params equal one AdamW step on zero
    gradients (moments decay, the count rises, weight decay moves the
    params), not the params before it, as torch's ``GradScaler`` would
    leave them."""
    _, tcfg, jparams, batches = _bert()
    init = jax.tree_util.tree_map(np.asarray, jparams)
    acc = _port_acc("fp16", 1, dict(init_scale=2.0 ** 40, backoff_factor=2.0 ** -50))
    params, opt = acc.prepare(init, adamw(LR, weight_decay=0.1))
    before = [t.detach().clone() for t in param_leaves(params)]
    step = acc.prepare_train_step(lambda p, b: bert_loss(p, b, tcfg), opt)
    params, _, m = step(params, opt.opt_state, batches[0])
    assert not bool(m["grads_finite"]) and float(m["loss_scale"]) == 1.0
    assert opt.step_count == 1

    ref = acc.prepare_model(init)
    ref_opt = AcceleratedOptimizer(adamw(LR, weight_decay=0.1))
    ref_opt.init(ref)
    ref_opt.step(jax.tree_util.tree_map(lambda x: torch.zeros(x.shape), init), ref)
    for got, want, old in zip(param_leaves(params), param_leaves(ref), before):
        assert torch.equal(got, want)
    assert any(not torch.equal(got, old) for got, old in zip(param_leaves(params), before))


SCHEDULES = [
    ("constant_schedule", dict(value=3e-4)),
    ("linear_schedule", dict(init_value=1e-3, end_value=1e-5, transition_steps=7)),
    ("linear_schedule", dict(init_value=0.0, end_value=2e-3, transition_steps=5,
                             transition_begin=3)),
    ("linear_schedule", dict(init_value=1e-3, end_value=0.0, transition_steps=0)),
    ("cosine_decay_schedule", dict(init_value=1e-3, decay_steps=9)),
    ("cosine_decay_schedule", dict(init_value=5e-4, decay_steps=6, alpha=0.1, exponent=2.0)),
    ("warmup_cosine_decay_schedule", dict(init_value=0.0, peak_value=1e-3, warmup_steps=4,
                                          decay_steps=15, end_value=1e-5)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedules_match_optax(name, kwargs):
    ours, theirs = getattr(tpt, name)(**kwargs), getattr(optax, name)(**kwargs)
    for step in range(20):
        got, want = ours(step), np.float32(theirs(jnp.int32(step)))
        np.testing.assert_allclose(np.float32(got), want, rtol=2 ** -21, atol=0)


@pytest.mark.parametrize("warmup,total", [(3, 10), (3, None), (0, 8), (12, 10), (0, None)])
def test_dummy_schedule_matches_jax(warmup, total):
    dummy = DummyScheduler(optimizer=DummyOptim(lr=2e-3), total_num_steps=total,
                           warmup_num_steps=warmup)
    jdummy = jdc.DummyScheduler(optimizer=jdc.DummyOptim(lr=2e-3), total_num_steps=total,
                                warmup_num_steps=warmup)
    ours, theirs = Accelerator._dummy_schedule_fn(dummy), JAccelerator._dummy_schedule_fn(jdummy)
    for step in range(14):
        np.testing.assert_allclose(np.float32(ours(step)), np.float32(theirs(step)),
                                   rtol=2 ** -23, atol=0)


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def test_scheduled_adamw_under_accumulation_matches_optax_multisteps():
    """``adamw(schedule)`` at accumulation 4 over 6 boundaries (warmup 4 +
    2) against ``optax.MultiSteps(optax.adamw(schedule), 4)`` on the same
    24 micro-step gradients: the schedule is read at the boundary count,
    the update uses the window's mean."""
    shapes = {"w": (6, 5), "b": (5,)}
    params = _tree(0, shapes)
    schedule_kw = dict(init_value=0.0, peak_value=1e-2, warmup_steps=4, decay_steps=10)
    tx = optax.MultiSteps(optax.adamw(optax.warmup_cosine_decay_schedule(**schedule_kw)), ACCUM)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    opt = AcceleratedOptimizer(adamw(tpt.warmup_cosine_decay_schedule(**schedule_kw)),
                               accumulation_steps=ACCUM)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt.init(tp)
    for i in range(6 * ACCUM):
        g = _tree(i + 1, shapes)
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()}, tp)
        assert opt.step_count == int(state.gradient_step)
        assert opt.mini_step == int(state.mini_step)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert opt.step_count == 6
    # the schedule moved the lr: warmup from 0, then decay
    assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(tpt.warmup_cosine_decay_schedule(**schedule_kw)(5)))
    sd = opt.state_dict()
    restored = AcceleratedOptimizer(adamw(1.0), accumulation_steps=ACCUM)
    restored.init({k: torch.zeros(s, requires_grad=True) for k, s in shapes.items()})
    restored.load_state_dict(sd)
    assert (restored.mini_step, restored.gradient_step) == (opt.mini_step, opt.gradient_step)
    assert torch.equal(restored.acc_grads, opt.acc_grads)


def test_scheduler_steps_only_on_sync_like_jax():
    sched = tpt.linear_schedule(1e-3, 1e-4, 6)
    ours = AcceleratedScheduler(sched, num_processes=1)
    theirs = JScheduler(optax.linear_schedule(1e-3, 1e-4, 6), num_processes=1)
    always = AcceleratedScheduler(sched, step_with_optimizer=False, num_processes=1)
    gs, jgs = GradientState(), JGradientState()
    for i in range(10):
        sync = i % 3 == 2
        gs._set_sync_gradients(sync)
        jgs._set_sync_gradients(sync)
        ours.step()
        theirs.step()
        always.step()
        np.testing.assert_allclose(ours.get_last_lr(), theirs.get_last_lr(), rtol=2 ** -23)
    assert ours.state_dict() == {"step_count": 3} and always.state_dict() == {"step_count": 10}
    # a torch scheduler object is advanced on sync steps only
    param = torch.zeros(2, requires_grad=True)
    torch_opt = torch.optim.SGD([param], lr=1.0)
    wrapped = Accelerator(cpu=True).prepare(torch.optim.lr_scheduler.StepLR(torch_opt, 1, 0.5))
    assert isinstance(wrapped, AcceleratedScheduler)
    for sync in (False, True, False, True):
        gs._set_sync_gradients(sync)
        torch_opt.step()
        wrapped.step()
    assert wrapped.get_last_lr() == [0.25]
    state = wrapped.state_dict()
    wrapped.load_state_dict(state)
    assert wrapped.state_dict()["step_count"] == 2


def test_accumulate_sync_pattern_matches_jax_over_a_prepared_loader():
    """10 batches a loader (not a multiple of 4), 2 epochs: every 4th
    micro-step syncs, and so does each epoch's last batch, which also
    starts the count again (the end-of-dataloader re-alignment)."""
    data = make_synthetic_mrpc(80, 16, 1024, seed=1)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=ACCUM)
    dl = acc.prepare(DataLoader(DictDataset(data), batch_size=8))
    JAcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    # one device, as the port: the JAX loader keeps its 10 batches of 8
    jacc = JAccelerator(gradient_accumulation_steps=ACCUM,
                        parallelism_config=ParallelismConfig(dp_shard_size=1))
    jdl = jacc.prepare(JDataLoader(DictDataset(data), batch_size=8))
    assert len(dl) == len(jdl) == 10
    got, want, ends = [], [], []
    for _ in range(2):
        for _ in dl:
            with acc.accumulate():
                got.append(acc.sync_gradients)
                ends.append(acc.gradient_state.end_of_dataloader)
        for _ in jdl:
            with jacc.accumulate():
                want.append(jacc.sync_gradients)
    assert got == want
    assert got[:10] == [False, False, False, True] * 2 + [False, True]
    assert ends == ([False] * 9 + [True]) * 2
    assert not acc.gradient_state.in_dataloader and acc.gradient_state.remainder == -1
    with acc.no_sync():
        assert not acc.sync_gradients
    assert acc.sync_gradients == want[-1]


def test_has_aux_and_grad_norm_match_the_jax_step():
    jcfg, tcfg, jparams, batches = _bert()

    def t_loss(p, b):
        loss = bert_loss(p, b, tcfg)
        return loss, {"twice": 2 * loss}

    def j_loss(p, b):
        loss = jt.bert_loss(p, b, jcfg)
        return loss, {"twice": 2 * loss}

    acc = _port_acc("no", 1)
    params, opt = acc.prepare(jax.tree_util.tree_map(np.asarray, jparams), adamw(LR))
    step = acc.prepare_train_step(t_loss, opt, has_aux=True, compute_grad_norm=True)
    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator()
    jp, jopt = jacc.prepare(jparams, optax.adamw(LR))
    jstep = jacc.prepare_train_step(j_loss, jopt, has_aux=True, compute_grad_norm=True)
    for batch in batches[:2]:
        params, _, m = step(params, opt.opt_state, batch)
        jp, _, jm = jstep(jp, jopt.opt_state, {k: v.numpy() for k, v in batch.items()})
        assert set(m) == set(jm) == {"loss", "aux", "grad_norm"}
        assert not m["aux"]["twice"].requires_grad
        np.testing.assert_allclose(float(m["aux"]["twice"]), float(jm["aux"]["twice"]),
                                   rtol=LOSS_RTOL["no"])
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL["no"])


def test_gradient_fn_and_clips_match_jax():
    jcfg, tcfg, jparams, batches = _bert()
    acc = _port_acc("no", 1)
    params = acc.prepare(jax.tree_util.tree_map(np.asarray, jparams))
    batch = batches[0]
    (loss, aux), grads = acc.gradient_fn(lambda p, b: (bert_loss(p, b, tcfg), b["labels"]),
                                         has_aux=True)(params, batch)
    assert all(t.grad is None for t in param_leaves(params))  # params untouched
    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator()
    jbatch = {k: v.numpy() for k, v in batch.items()}
    (jloss, jaux), jgrads = jacc.gradient_fn(lambda p, b: (jt.bert_loss(p, b, jcfg), b["labels"]),
                                             has_aux=True)(jparams, jbatch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_array_equal(aux.numpy(), np.asarray(jaux))
    def check(tree, jtree, rtol):
        jflat = dict(_named(jax.tree_util.tree_map(np.asarray, jtree)))
        for name, g in _named(tree):
            if name != ZERO_GRAD:  # exactly zero: rounding noise on both sides
                want = jflat[name]
                err = np.linalg.norm(g.numpy() - want)
                assert err <= rtol * np.linalg.norm(want), f"{name}: {err}"

    check(grads, jgrads, NORM_RTOL["no"])
    for max_norm in (1e-3, 1e3):  # clipped, and left alone
        clipped, norm = acc.clip_grad_norm_(grads, max_norm)
        jclipped, jnorm = jacc.clip_grad_norm_(jgrads, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=NORM_RTOL["no"])
        check(clipped, jclipped, NORM_RTOL["no"])
    clipped, norm = acc.clip_grad_norm_(grads, 1e-3)
    total = float(torch.sqrt(sum(torch.sum(g * g) for g in param_leaves(clipped))))
    assert total == pytest.approx(1e-3, rel=1e-3)
    with pytest.raises(NotImplementedError, match="L2"):
        acc.clip_grad_norm_(grads, 1.0, norm_type=1)
    vclipped = acc.clip_grad_value_(grads, 1e-3)
    assert max(float(g.abs().max()) for g in param_leaves(vclipped)) == np.float32(1e-3)
    check(vclipped, jacc.clip_grad_value_(jgrads, 1e-3), NORM_RTOL["no"])


def test_dummy_optim_and_scheduler_train_like_jax():
    """``DummyOptim`` + ``DummyScheduler`` prepared together: the
    scheduler's warmup/decay is the AdamW's learning rate (weight decay
    0.0, betas carried over); 6 steps against the JAX flow."""
    jcfg, tcfg, jparams, batches = _bert()
    init = dict(_named(jax.tree_util.tree_map(np.asarray, jparams)))
    kw = dict(total_num_steps=6, warmup_num_steps=2)
    acc = _port_acc("no", 1)
    params, opt, sched = acc.prepare(jax.tree_util.tree_map(np.asarray, jparams),
                                     DummyOptim(lr=LR, betas=(0.8, 0.99)), DummyScheduler(**kw))
    group = opt.optimizer.param_groups[0]
    assert group["weight_decay"] == 0.0 and group["betas"] == (0.8, 0.99)
    step = acc.prepare_train_step(lambda p, b: bert_loss(p, b, tcfg), opt)
    JAcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    jacc = JAccelerator()
    jp, jopt, jsched = jacc.prepare(jparams, jdc.DummyOptim(lr=LR, betas=(0.8, 0.99)),
                                    jdc.DummyScheduler(**kw))
    jstep = jacc.prepare_train_step(lambda p, b: jt.bert_loss(p, b, jcfg), jopt)
    lrs = []
    for batch in batches[:6]:
        params, _, m = step(params, opt.opt_state, batch)
        lrs.append(group["lr"])
        sched.step()
        jp, _, jm = jstep(jp, jopt.opt_state, {k: v.numpy() for k, v in batch.items()})
        jsched.step()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL["no"])
        np.testing.assert_allclose(sched.get_last_lr(), jsched.get_last_lr(), rtol=2 ** -23)
    # warmup lr·(step+1)/2, then linear to 0 at step 6
    np.testing.assert_allclose(lrs, [5e-4, 1e-3, 1e-3, 7.5e-4, 5e-4, 2.5e-4], rtol=1e-6)
    _check_updates(params, dict(_named(jax.tree_util.tree_map(np.asarray, jp))), init, "no", 6)


def test_accelerator_options_and_handlers():
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=3, sync_each_batch=True), kwargs_handlers=[GradScalerConfig(init_scale=8.0)])
    assert acc.gradient_accumulation_steps == 3 and acc.grad_scaler_config.init_scale == 8.0
    with acc.accumulate():
        assert acc.sync_gradients  # sync_each_batch
    with pytest.raises(ValueError, match="both"):
        Accelerator(cpu=True, grad_scaler_config=GradScalerConfig(),
                    kwargs_handlers=[GradScalerConfig()])
    with pytest.raises(ValueError, match=">= 1"):
        GradientAccumulationPlugin(num_steps=0)
    with pytest.raises(ValueError, match=">= 1"):
        AcceleratedOptimizer(adamw(LR), accumulation_steps=0)
