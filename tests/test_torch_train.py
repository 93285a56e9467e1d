"""The port's training path against the JAX package's, on the CPU.

- ``DataLoader`` gives the JAX loader's batch order and contents;
- one and two ``adamw`` steps against ``optax.adamw`` on the same grads;
- 10 steps of ``Accelerator.prepare_train_loop`` on bert-tiny and synthetic
  MRPC against the JAX ``prepare_train_loop`` with ``optax.adamw`` — the
  same JAX-made weights and numpy-made batches, lr raised to 1e-3 so that
  the trajectory moves — in f32 and in bf16.

Tolerances. f32: the two sides differ only in the order of their sums.
Per-step losses within 1e-5 relative (measured 4e-7). Params are compared
through their 10-step updates, each leaf within 2e-4 of the JAX update in
relative L2 norm (measured at most 6.5e-5, on the norm scales, whose
updates of ~1e-2 sit on values near 1 and keep fewer f32 bits). Not the
params alone: AdamW's step g / (|g| + eps) turns the rounding noise of a
gradient element near zero into a visible share of lr, so single elements
differ by more, while a wrong gradient would move every element's step.
The key projection's bias gets an exactly zero gradient (softmax ignores a
constant added to a row's scores): its update is all such noise, held to
the most 10 steps can move it, 10·lr. bf16: the two frameworks round
matmul outputs and activations to bf16 at different places (XLA's CPU
backend fuses elementwise chains in f32), and AdamW carries those
differences into the sign of small steps: losses within 2e-3 relative
(measured 3.1e-4), updates within 0.3 relative L2 (measured at most 0.17);
a wrong gradient moves updates by O(1).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import DataLoader as JDataLoader
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.utils.operations import stack_batches as jstack
from accelerate_tpu_torch import Accelerator, BertConfig, DataLoader, bert_loss
from accelerate_tpu_torch.data_loader import prepare_data_loader
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, adamw, param_leaves
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils.operations import stack_batches
from accelerate_tpu_torch.utils.synthetic import DictDataset, make_synthetic_mrpc

LR = 1e-3
STEPS = 10


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
    several times over. Every bar here is a tolerance, or an equality
    between two runs of this module (one thread count), so the order of a
    few CPU sums cannot move a result past it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def test_synthetic_mrpc_is_the_examples_copy(monkeypatch):
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent / "examples"))
    from nlp_example import make_synthetic_mrpc as jmake

    ours, theirs = make_synthetic_mrpc(64, 128, 1024, seed=3), jmake(64, 128, 1024, seed=3)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True), (False, False)])
def test_dataloader_order_and_contents_match_jax(seed, shuffle, drop_last):
    data = make_synthetic_mrpc(37, 16, 1024, seed=seed)
    ours = DataLoader(DictDataset(data), batch_size=8, shuffle=shuffle, seed=seed,
                      drop_last=drop_last)
    theirs = JDataLoader(DictDataset(data), batch_size=8, shuffle=shuffle, seed=seed,
                         drop_last=drop_last)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            for key in x:
                np.testing.assert_array_equal(x[key], y[key])


def test_prepared_loader_keeps_the_short_last_batch_like_jax_prepare_data_loader():
    """One process on one device: the port's prepared loader against the JAX
    ``prepare_data_loader`` on a one-device mesh (data axis of one shard, so
    it keeps the loader as it is): 21 samples in batches of 8 give a last
    batch of 5 rows on both sides, with the same samples in every batch."""
    from accelerate_tpu.data_loader import prepare_data_loader as jprepare_data_loader
    from accelerate_tpu.parallelism_config import ParallelismConfig

    data = make_synthetic_mrpc(21, 16, 1024, seed=1)
    data["idx"] = np.arange(21)
    dl = DataLoader(DictDataset(data), batch_size=8, shuffle=True, seed=2)
    got = list(prepare_data_loader(dl, torch.device("cpu")))
    pc = ParallelismConfig(dp_shard_size=1)
    want = list(jprepare_data_loader(
        JDataLoader(DictDataset(data), batch_size=8, shuffle=True, seed=2),
        mesh=pc.build_mesh(), parallelism_config=pc))
    assert [len(b["idx"]) for b in got] == [len(b["idx"]) for b in want] == [8, 8, 5]
    np.testing.assert_array_equal(got[-1]["idx"].numpy(), [5, 3, 4, 8, 1])
    for x, y in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in x.values())
        assert x.keys() == y.keys()
        for key in x:
            np.testing.assert_array_equal(x[key].numpy(), np.asarray(y[key]))


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def test_adamw_matches_optax():
    shapes = {"w": (6, 5), "b": (5,)}
    params = _tree(0, shapes)
    grads = [_tree(1, shapes), _tree(2, shapes)]
    tx = optax.adamw(LR)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    opt = AcceleratedOptimizer(adamw(LR))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in params.items()}
    opt.init(tp)
    assert opt.optimizer.defaults["weight_decay"] == 1e-4  # optax's default, not torch's
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()}, tp)
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert opt.step_count == 2
    assert set(opt.state_dict()) == {"opt_state", "accumulation_steps"}


def _jax_run(jparams, batches, config, precision):
    JAcceleratorState._reset_state(reset_partial_state=True)
    acc = JAccelerator(mixed_precision=precision)
    params, opt = acc.prepare(jparams, optax.adamw(LR))
    loop = acc.prepare_train_loop(lambda p, b: jt.bert_loss(p, b, config), opt)
    params, _, metrics = loop(params, opt.opt_state, jstack(batches))
    return np.asarray(metrics["loss"]), jax.tree_util.tree_map(np.asarray, params)


def _port_run(np_params, data, config, precision):
    acc = Accelerator(mixed_precision=precision, cpu=True)
    params, opt, dl = acc.prepare(np_params, adamw(LR), DataLoader(DictDataset(data),
                                                                   batch_size=16))
    batches = list(dl)
    assert all(t.device.type == "cpu" for t in param_leaves(params))
    loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, config), opt)
    out_params, state, metrics = loop(params, opt.opt_state,
                                      stack_batches([batches[i % len(batches)]
                                                     for i in range(STEPS)]))
    assert out_params is params and state is opt.opt_state and opt.step_count == STEPS
    assert metrics["loss"].shape == (STEPS,)
    return metrics["loss"].numpy(), params, batches


@pytest.mark.parametrize("precision", ["no", "bf16"])
def test_ten_training_steps_match_the_jax_loop(precision):
    jcfg = jt.BertConfig(**{**jt.BertConfig.tiny().__dict__, "attn_impl": "fused"})
    tcfg = BertConfig(**{**BertConfig.tiny().__dict__, "attn_impl": "fused"})
    jparams = jt.init_bert(jcfg, jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, jparams)
    data = make_synthetic_mrpc(64, 128, jcfg.vocab_size, seed=0)
    t_loss, t_params, batches = _port_run(init, data, tcfg, precision)
    np_batches = [{k: v.numpy() for k, v in b.items()} for b in batches]
    j_loss, j_params = _jax_run(jparams, [np_batches[i % len(np_batches)] for i in range(STEPS)],
                                jcfg, precision)
    assert np.isfinite(t_loss).all() and np.isfinite(j_loss).all()
    f32 = precision == "no"
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5 if f32 else 2e-3)
    assert float(np.ptp(j_loss)) > 1e-2  # the trajectory moves

    def named(tree, prefix=""):
        for key, v in tree.items():
            if isinstance(v, dict):
                yield from named(v, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", v

    jflat, iflat = dict(named(j_params)), dict(named(init))
    for name, t in named(t_params):
        t_upd = t.detach().float().numpy() - iflat[name]
        j_upd = jflat[name].astype(np.float32) - iflat[name]
        if name == "layers/wk/bias":  # zero gradient: noise, bounded by 10 AdamW steps
            assert np.abs(t_upd - j_upd).max() <= STEPS * LR
            continue
        rel = np.linalg.norm(t_upd - j_upd) / np.linalg.norm(j_upd)
        assert rel <= (2e-4 if f32 else 0.3), f"{name}: update rel L2 err {rel}"


def test_train_step_equals_one_loop_step_and_eval_step():
    cfg = BertConfig.tiny()
    data = make_synthetic_mrpc(32, 128, cfg.vocab_size, seed=4)
    init = jax.tree_util.tree_map(np.asarray, jt.init_bert(jt.BertConfig.tiny(),
                                                           jax.random.PRNGKey(1)))
    results = []
    for use_loop in (False, True):
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True)
        params, opt, dl = acc.prepare(init, adamw(LR), DataLoader(DictDataset(data),
                                                                  batch_size=16))
        batch = next(iter(dl))
        if use_loop:
            loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, cfg))
            params, _, m = loop(params, opt.opt_state, stack_batches([batch]))
            loss = m["loss"][0]
        else:
            step = acc.prepare_train_step(lambda p, b: bert_loss(p, b, cfg))
            params, _, m = step(params, opt.opt_state, batch)
            loss = m["loss"]
        ev = acc.prepare_eval_step(lambda p, b: bert_loss(p, b, cfg))(params, batch)
        assert not ev.requires_grad
        results.append((float(loss), float(ev)))
        with pytest.raises(ValueError, match="opt_state"):
            acc.prepare_train_step(lambda p, b: bert_loss(p, b, cfg))(params, {}, batch)
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6)


def test_precision_policy_casts_floats_only():
    from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy

    policy = MixedPrecisionPolicy.from_precision("bf16")
    tree = {"w": torch.ones(2, requires_grad=True), "ids": torch.ones(2, dtype=torch.int32)}
    out = policy.cast_to_compute(tree)
    assert out["w"].dtype == torch.bfloat16 and out["ids"].dtype == torch.int32
    assert out["w"].requires_grad  # an autograd op: grads come back in the param dtype
    assert policy.cast_to_param(out)["w"].dtype == torch.float32
    assert MixedPrecisionPolicy.from_precision("no").cast_to_compute(tree) is tree


def test_unported_modes_raise():
    """The name is older than the fp8 port: ``mixed_precision="fp8"`` now
    builds as in the JAX package (bf16 compute over f32 masters, one fp8
    recipe handler kept and never read; ``tests/test_torch_fp8.py`` trains
    with it), and an unsupported handler still raises."""
    from accelerate_tpu_torch.ops.fp8 import FP8Recipe
    from accelerate_tpu_torch.utils.dataclasses import AORecipeKwargs, TERecipeKwargs

    acc = Accelerator(mixed_precision="fp8", cpu=True,
                      kwargs_handlers=[TERecipeKwargs(amax_history_len=8)])
    assert acc.mixed_precision == "fp8"
    assert acc.state.mixed_precision_policy.compute_dtype == torch.bfloat16
    assert acc.fp8_recipe == FP8Recipe(amax_history_len=8)
    AcceleratorState._reset_state(reset_partial_state=True)
    with pytest.raises(ValueError, match="multiple fp8 recipe handlers"):
        Accelerator(cpu=True, kwargs_handlers=[TERecipeKwargs(), AORecipeKwargs()])
    with pytest.raises(ValueError, match="unsupported kwargs handler"):
        Accelerator(cpu=True, kwargs_handlers=[object()])


def test_one_process_state(monkeypatch):
    acc = Accelerator(cpu=True, mixed_precision="bf16", rng_seed=3)
    assert (acc.device.type, acc.num_processes, acc.process_index) == ("cpu", 1, 0)
    assert acc.is_main_process and acc.mixed_precision == "bf16"
    acc.wait_for_everyone()
    assert PartialState().device.type == "cpu"
    with pytest.raises(ValueError, match="conflicting"):
        Accelerator(mixed_precision="no", cpu=True)
    AcceleratorState._reset_state(reset_partial_state=True)
    # two processes asked for with no rendezvous address: a clear error at
    # once, not a wait on a store nobody serves
    monkeypatch.setenv("WORLD_SIZE", "2")
    for var in ("MASTER_ADDR", "MASTER_PORT", "ACCELERATE_COORDINATOR_ADDRESS",
                "ACCELERATE_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="no rendezvous address"):
        Accelerator(cpu=True)
    assert time.monotonic() - start < 5.0
