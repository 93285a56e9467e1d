"""Sharded Llama training in the port, over 4 processes, against the JAX
package on 4 virtual CPU devices and against the port's own one-process
run.

One launch of 4 ``gloo`` processes (:mod:`accelerate_tpu_torch.test_utils.
scripts.multihost_script`, scenario ``mesh_train``) runs Llama at tiny
widths and 4 layers (f32, plain attention, global batch 8 × 64, a random
``loss_mask`` so that the ranks' rows count different numbers of
positions) on many meshes; the JAX package runs the same steps through its
``Accelerator`` with the same ``ParallelismConfig``, rules, optimizer and
``DeepSpeedPlugin(zero_stage=1)``; the port's one-process run is the plain
step on the whole batch. Params come from the JAX initializer, token ids
from a seeded numpy generator. The depth is 4, not tiny's 2, because
``llama_tp_rules`` put ``tp`` on dim 0 of the stacked tree, the layer
axis, and the JAX package refuses to split 2 layers 4 ways. Every step
gathers the stacked layers one at a time (``LayerStack``).

- ``adamw(1e-3)``, 5 steps, on (dp_replicate 2, dp_shard 2), (dp_shard 2,
  tp 2) and (tp 4) with ``llama_tp_rules`` on the two with ``tp``, and
  (dp_replicate 4) with fused ZeRO-1, which holds a quarter of the AdamW
  moments on each rank.
- 3 steps each: ``adafactor(1e-3)`` and ``chain(clip_by_global_norm(1.0),
  adafactor(1e-3))`` (the gradient norm is about 1.75, so the clip acts)
  under (dp_shard 2, tp 2) with ``llama_tp_rules`` and under dp_shard 4
  (the JAX package cannot place adafactor's factored state on split params
  — its ``tree_specs_like`` hands the moments' ``(1,)`` placeholders the
  params' specs — so its run of the same global function is on
  dp_replicate 4);
  fp16 under dp_shard 4 with a scaler whose first step overflows (a scale
  of 2**40; backoff 2**-30, growth 2**30 every 2 finite steps, so every
  decision is clear-cut); ZeRO-1 where the fused update cannot run —
  (dp_replicate 2, tp 2), ``ACCELERATE_ZERO1_FUSED=0``, and a non-floating
  leaf — which shards the optimizer state by annotation, as JAX's
  ``zero1_state_specs`` says.
- one step at each remat policy (``False``, ``True``, ``"dots_no_batch"``)
  under dp_shard 4 (each rank holds one whole layer: a gather is a
  broadcast) and (dp_shard 2, tp 2): at most 2 layers' gathered params
  alive at once on every rank, through forward, backward and recompute.
- ``gradient_fn`` under (dp_shard 2, tp 2): each rank's blocks of JAX's
  ``jax.value_and_grad`` of the global loss.
- fp16 under dp_shard 4 with an infinity planted in one rank's block of
  one gradient: every rank takes the same decision.
- fp8 (``dtype_recipe="fp8"``, ``mixed_precision="fp8"``, ``sgd(1e-2)``,
  2 steps) under dp_replicate 4 with fused ZeRO-1 (the meta as passthrough
  slots) and under (dp_replicate 2, dp_shard 2) (its layers through
  ``LayerStack``), held to the JAX package's run under dp_replicate 4 with
  fused ZeRO-1 (the same global function): every rank's
  meta bitwise equal, the passthrough count the meta leaf count, and a
  planted fault (the meta gradients summed over the ranks, not MAX-reduced)
  failing the meta bar.
- sharded checkpoints in the same launch (scenario ``mesh_ckpt``): 4
  steps with a ``save_state`` after 2, under (dp_replicate 2, dp_shard 2)
  with adafactor and under dp_replicate 4 with fused ZeRO-1 and AdamW;
  a fresh ``Accelerator`` on zeroed params loads it and takes steps 3-4
  with the uninterrupted run's losses bitwise. The shard set (each rank
  its replica-0 blocks) loads into the JAX package on 4 virtual devices
  and consolidates there to the params at the save, bitwise.

Tolerances, f32 on every side with the sums in another order: losses and
the global gradient norms (which a gradient summed over the wrong axes
moves, where AdamW's normalised step hides it) within 1e-5 relative of
both references; final params within 1e-5 relative in L2 per leaf of the
port's one-process run, and within 2e-5 of the JAX package's run on the
same mesh. AdamW's g / (|g| + eps) turns the rounding noise of near-zero
gradient elements into parts of lr, so each of two correct runs sits about
1e-5 from a common reference, in opposite directions: measured on
``layers/wk/kernel``, the JAX package's tp 4 run is 6.7e-6 from its own
one-device run, and the port's one-process run 5.7e-6 from that same JAX
run. Adafactor divides by the root of its second moments as AdamW does:
the same bars. ``gradient_fn``'s blocks within 1e-5 of the largest
magnitude of JAX's gradient leaf (f32 sums in another order). fp16: the
frameworks round matmul outputs at different places, so losses within
2e-3 relative and params within 2e-2 relative L2 (the bars of
``tests/test_torch_grad_accum.py`` for fp16, whose docstring gives the
measurements), while the loss-scale and finite-flag sequences are
decisions and must equal JAX's exactly. fp8: bf16 compute, where XLA's
CPU backend fuses elementwise chains in f32 and torch rounds each op, and
an amax is the largest of those roundings, which the fp8 casts then carry
on: losses within 1e-3 relative (measured 1.7e-4 over 3 steps), the
histories within 0.25 of each leaf's largest value (measured 0.17; the
planted sum over the ranks moves them by 63x), kernels within 2e-3
relative L2 (measured 1.7e-4).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.parallel.sharding import llama_tp_rules as j_llama_tp_rules
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.utils.dataclasses import DeepSpeedPlugin as JDeepSpeedPlugin
from accelerate_tpu.utils.dataclasses import GradScalerConfig as JGradScalerConfig
from accelerate_tpu_torch.parallel.sharding import infer_param_specs, llama_tp_rules, local_shard
from accelerate_tpu_torch.parallelism_config import ParallelismConfig
from accelerate_tpu_torch.utils.environment import patch_environment
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.scripts import multihost_script as ms
from accelerate_tpu_torch.test_utils.testing import execute_multiprocess

SCRIPT = ["-m", "accelerate_tpu_torch.test_utils.scripts.multihost_script"]
LEGS = {name: (pc, zero1, tp) for name, pc, zero1, tp in ms.MESH_LEGS}
OPTIONS = {name: (pc, tp, opts) for name, pc, tp, opts in ms.OPTION_LEGS}
REMATS = {name: (pc, tp, opts) for name, pc, tp, opts in ms.REMAT_LEGS}
FP8 = {name: (pc, zero1, fault) for name, pc, zero1, fault in ms.FP8_LEGS}
B, S = 8, 64
CFG = dataclasses.replace(jt.LlamaConfig.tiny(), n_layers=4)
FP8_CFG = dataclasses.replace(CFG, dtype_recipe="fp8")
# context and sequence parallelism (scenario long_context): the Llama of the
# JAX package's test_zigzag_in_llama_end_to_end, Ulysses' 4 kv heads
LC_CFG = jt.LlamaConfig(vocab_size=128, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                        max_seq_len=64)
KV4_CFG = dataclasses.replace(CFG, n_kv_heads=4)
LC_CASES = {name: (strategy, pc, causal, shape, grads)
            for name, strategy, pc, causal, shape, grads in ms.LC_ATTENTION_CASES}
LC_LEGS = {name: (pc, params_file, opts) for name, pc, params_file, opts in ms.LC_LEGS}
LC_LEG_NAMES = [*LC_LEGS, *(f"{ms.LC_LEGS[0][0]}_{fault}" for fault in ms.LC_FAULTS)]


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _flat(tree) -> dict:
    return {_path(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reset_jax():
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()


def _write_long_context_inputs(tmp):
    """The long_context scenario's params (from the JAX initializer) and
    token ids (a seeded numpy generator)."""
    np.savez(tmp / "llama_kv4_params.npz", **_flat(jt.init_llama(KV4_CFG, jax.random.PRNGKey(0))))
    np.savez(tmp / "lc_llama_params.npz", **_flat(jt.init_llama(LC_CFG, jax.random.PRNGKey(0))))
    np.save(tmp / "lc_llama_ids.npy",
            np.random.default_rng(0).integers(0, 128, (2, 64)).astype(np.int32))
    ex = ms.LC_EXAMPLE
    np.savez(tmp / "lc_example_params.npz",
             **_flat(jt.init_llama(_example_config(), jax.random.PRNGKey(ex["seed"]))))


def _example_config():
    """``examples/sequence_parallelism.py``'s model at ``--sp 4``."""
    return dataclasses.replace(jt.LlamaConfig.tiny(), max_seq_len=ms.LC_EXAMPLE["seq_len"],
                               n_heads=4, n_kv_heads=4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-process launch: params and batches in, the report and each
    leg's final params out."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jparams = jt.init_llama(CFG, jax.random.PRNGKey(0))
    np.savez(tmp / "llama_params.npz", **_flat(jparams))
    np.savez(tmp / "fp8_params.npz", **_flat(jt.init_llama(FP8_CFG, jax.random.PRNGKey(0))))
    vocab = CFG.vocab_size
    rng = np.random.default_rng(0)
    batches = {"input_ids": rng.integers(1, vocab, size=(ms.MESH_STEPS, B, S), dtype=np.int32),
               "loss_mask": (rng.random((ms.MESH_STEPS, B, S)) < 0.7).astype(np.int32)}
    np.savez(tmp / "llama_batches.npz", **batches)
    _write_long_context_inputs(tmp)
    outs = execute_multiprocess(SCRIPT + ["--scenario", "mesh_train,mesh_ckpt,long_context",
                                          "--tmpdir", str(tmp)], num_processes=4, timeout=300)
    for out in outs:
        assert "ALL OK" in out, out[-2000:]
    with open(tmp / "mesh_train.json") as f:
        report = json.load(f)
    with open(tmp / "mesh_ckpt.json") as f:
        report["ckpt"] = json.load(f)
    for name in report["ckpt"]:
        with np.load(tmp / f"ckpt_{name}_saved.npz") as f:
            report["ckpt"][name]["saved"] = {k: f[k] for k in f.files}
        report["ckpt"][name]["dir"] = str(tmp / f"ckpt_{name}")
    legs = {}
    for name in [*LEGS, *OPTIONS, *REMATS, *FP8]:
        with np.load(tmp / f"mesh_{name}.npz") as f:
            legs[name] = {k: f[k] for k in f.files}
    for i in range(4):
        with np.load(tmp / f"grads_rank{i}.npz") as f:
            legs[f"grads_rank{i}"] = {k: f[k] for k in f.files}
    with open(tmp / "long_context.json") as f:
        report["lc"] = json.load(f)
    for i in range(4):
        with np.load(tmp / f"lc_rank{i}.npz") as f:
            legs[f"lc_rank{i}"] = {k: f[k] for k in f.files}
    for name in LC_LEG_NAMES:
        with np.load(tmp / f"lc_{name}.npz") as f:
            legs[f"lc_{name}"] = {k: f[k] for k in f.files}
    return jparams, batches, report, legs


@pytest.fixture(scope="module")
def world1(run):
    """The port's one-process run: the plain step on the whole batch."""
    jparams, batches, _, _ = run
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    try:
        return ms.mesh_train_leg(params_np, batches, {}, False, False, device="cpu")
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


def _jax_optimizer(factory: str):
    if factory == "sgd":
        return optax.sgd(ms.FP8_LR)
    if factory == "adamw":
        return optax.adamw(ms.MESH_LR)
    if factory == "adafactor":
        return optax.adafactor(ms.MESH_LR)
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(ms.MESH_LR))


def _jax_leg(jparams, batches, pc_kwargs, zero1, tp, factory="adamw", precision="no",
             scaler=None, steps=None, env=None, comm_hook=None, lomo=False):
    _reset_jax()
    # host copies: the JAX step donates the params it is given
    jparams = jax.tree_util.tree_map(np.array, jparams)
    try:
        with patch_environment(**(env or {})):
            return _jax_steps(jparams, batches, pc_kwargs, zero1, tp, factory, precision, scaler,
                              steps, comm_hook, lomo)
    finally:
        _reset_jax()


def _jax_steps(jparams, batches, pc_kwargs, zero1, tp, factory, precision, scaler, steps,
               comm_hook=None, lomo=False):
    from accelerate_tpu.utils.dataclasses import DistributedDataParallelKwargs as JDDP

    acc = JAccelerator(parallelism_config=JParallelismConfig(**pc_kwargs),
                       mixed_precision=precision,
                       deepspeed_plugin=JDeepSpeedPlugin(zero_stage=1) if zero1 else None,
                       shard_rules=j_llama_tp_rules() if tp else None,
                       kwargs_handlers=[JDDP(comm_hook=comm_hook)] if comm_hook else None,
                       grad_scaler_config=JGradScalerConfig(**scaler) if scaler else None)
    cfg = CFG
    params, opt = acc.prepare(jparams, _jax_optimizer(factory))
    if lomo:
        out = {"losses": [], "grad_norms": []}
        for k in range(batches["input_ids"].shape[0] if steps is None else steps):
            loss, params = acc.lomo_backward(
                lambda p, b: jt.llama_loss(p, b, cfg, mesh=acc.mesh), params,
                {n: b[k] for n, b in batches.items()}, learning_rate=ms.MESH_LR)
            out["losses"].append(float(loss))
        out["params"] = _flat(params)
        return out
    step = acc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, cfg, mesh=acc.mesh),
                                  compute_grad_norm=True)
    state, out = opt.opt_state, {"losses": [], "grad_norms": [], "loss_scale": [],
                                 "grads_finite": []}
    for k in range(batches["input_ids"].shape[0] if steps is None else steps):
        params, state, metrics = step(params, state, {n: b[k] for n, b in batches.items()})
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if precision == "fp16":
            out["loss_scale"].append(float(metrics["loss_scale"]))
            out["grads_finite"].append(bool(metrics["grads_finite"]))
    out["params"] = _flat(params)
    return out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("leg", list(LEGS))
def test_mesh_leg_matches_jax_and_one_process(run, world1, leg):
    jparams, batches, report, legs = run
    pc, zero1, tp = LEGS[leg]
    jax_leg = _jax_leg(jparams, batches, pc, zero1, tp)
    j_losses, j_norms, j_params = jax_leg["losses"], jax_leg["grad_norms"], jax_leg["params"]
    losses = report[leg]["losses"]
    assert report[leg]["fused_zero1"] == zero1
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, world1["losses"], rtol=1e-5)
    np.testing.assert_allclose(report[leg]["grad_norms"], j_norms, rtol=1e-5)
    np.testing.assert_allclose(report[leg]["grad_norms"], world1["grad_norms"], rtol=1e-5)
    assert losses[-1] < losses[0]
    assert sorted(legs[leg]) == sorted(j_params) == sorted(world1["params"])
    for path, got in legs[leg].items():
        assert got.shape == j_params[path].shape, path
        assert _rel_l2(got, world1["params"][path]) <= 1e-5, (
            path, _rel_l2(got, world1["params"][path]))
        assert _rel_l2(got, j_params[path]) <= 2e-5, (path, _rel_l2(got, j_params[path]))


def _hold(got: dict, want: dict, loss_rtol: float, param_rtol: float, norm_rtol=None):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=loss_rtol if norm_rtol is None else norm_rtol)
    assert sorted(got["params"]) == sorted(want["params"])
    for path, value in got["params"].items():
        assert value.shape == want["params"][path].shape, path
        err = _rel_l2(value, want["params"][path])
        assert err <= param_rtol, (path, err)


def _option_leg(run, name, adafactor_refs):
    jparams, batches, report, legs = run
    pc, tp, opts = OPTIONS[name]
    steps = {n: b[:ms.OPTION_STEPS] for n, b in batches.items()}
    factory = opts.get("factory", "adamw")
    if "adafactor" in factory:
        # the JAX package cannot place adafactor's state on split params (its
        # tree_specs_like hands the factored moments' placeholders the
        # params' specs): the same global function on dp_replicate 4, run
        # once for both meshes
        if factory not in adafactor_refs:
            adafactor_refs[factory] = _jax_leg(jparams, steps, {"dp_replicate_size": 4}, False,
                                               False, factory=factory)
        return {**report[name], "params": legs[name]}, adafactor_refs[factory]
    jax_leg = _jax_leg(jparams, steps, pc, opts.get("zero1", False), tp, factory=factory,
                       precision=opts.get("precision", "no"), scaler=opts.get("scaler"))
    return {**report[name], "params": legs[name]}, jax_leg


@pytest.fixture(scope="module")
def adafactor_refs():
    """The JAX adafactor runs, by factory, shared by the legs of both meshes."""
    return {}


ZERO1_CASES = {"dp_replicate2_tp2": "zero1_dp_replicate2_tp2", "fused_off": "zero1_fused_off",
               "int_leaf": "zero1_int_leaf"}


@pytest.mark.parametrize("case", list(ZERO1_CASES))
def test_zero1_without_the_fused_path_raises(run, world1, case):
    """ZeRO-1 on a composite mesh, with ``ACCELERATE_ZERO1_FUSED=0`` or
    with a non-floating leaf, where the fused update cannot run. These
    raised until the annotation path was ported; the name is kept, and the
    case now runs: the optimizer state is sharded by annotation (each rank
    owns dim-0 rows of the moments of every param no other axis splits,
    updates them and all-gathers them), held to the JAX package's
    annotation run and to one process. The JAX package refuses to step
    with an int leaf (``jax.grad`` takes no integer input), so that case is
    held to its run without the leaf, whose float leaves are the same
    function; the port keeps no state for the int leaf, which has no
    gradient. Per-rank state bytes: AdamW's two moments of each rank's
    block, halved again over ``dp_replicate`` where JAX's
    ``zero1_state_specs`` splits a leaf."""
    jparams, batches, report, legs = run
    name = ZERO1_CASES[case]
    pc, tp, opts = OPTIONS[name]
    leg = report[name]
    assert leg["zero1_rows"] and not leg["fused_zero1"]
    steps = {n: b[:ms.OPTION_STEPS] for n, b in batches.items()}
    jax_leg = _jax_leg(jparams, steps, pc, True, tp, env=opts.get("env"))
    got = {**leg, "params": {k: v for k, v in legs[name].items() if k != "step/count"}}
    _hold(got, jax_leg, 1e-5, 2e-5)
    if opts.get("int_leaf"):
        np.testing.assert_array_equal(legs[name]["step/count"], np.zeros(4, np.int32))
    np.testing.assert_allclose(leg["losses"], world1["losses"][:ms.OPTION_STEPS], rtol=1e-5)
    sizes = {"dp_replicate": pc.get("dp_replicate_size", 1), "tp": pc.get("tp_size", 1)}
    specs = infer_param_specs(jparams, sizes, None, llama_tp_rules() if tp else None)
    want = 0
    for x, spec in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(
            specs, is_leaf=lambda t: isinstance(t, tuple))):
        n = int(np.prod(np.shape(local_shard(np.asarray(x), spec, sizes,
                                             {"dp_replicate": 0, "tp": 0}))))
        if not any(d is not None for d in spec) and x.shape[0] % sizes["dp_replicate"] == 0:
            n //= sizes["dp_replicate"]
        want += 2 * n * 4
    assert leg["opt_state_bytes"] == [want] * 4, (leg["opt_state_bytes"], want)
    assert want < world1["opt_state_bytes"]


NEW_LEGS = ("zero1_adafactor", "comm_", "offload_", "lomo_", "multinode_")


@pytest.mark.parametrize("leg", [n for n in OPTIONS if not n.startswith("zero1")
                                 and not n.startswith(NEW_LEGS)])
def test_option_leg_matches_jax(run, world1, adafactor_refs, leg):
    """adafactor, a global-norm clip before it, and fp16 on split params."""
    got, jax_leg = _option_leg(run, leg, adafactor_refs)
    if OPTIONS[leg][2].get("precision") == "fp16":
        for rank_scales, rank_finite in zip(got["loss_scale"], got["grads_finite"]):
            assert rank_scales == jax_leg["loss_scale"]
            assert rank_finite == jax_leg["grads_finite"]
        assert jax_leg["grads_finite"][0] is False and all(jax_leg["grads_finite"][1:])
        _hold(got, jax_leg, 2e-3, 2e-2, norm_rtol=2e-2)
        return
    _hold(got, jax_leg, 1e-5, 2e-5)
    if "clip" in leg:  # the clip acted
        plain = run[2][leg.replace("clip_", "")]
        assert min(got["grad_norms"]) > 1.0
        assert plain["losses"][-1] != got["losses"][-1]


@pytest.mark.parametrize("leg", list(REMATS))
def test_live_gathered_layers_stay_within_two(run, world1, leg):
    """Through the forward (with the next layer's gather in flight), the
    backward and the recompute, no rank holds more than two layers'
    gathered params at once; every layer was gathered at least twice (the
    forward, and the backward or the recompute), and the step's numbers
    are the one-process step's."""
    _, _, report, legs = run
    got = report[leg]
    n_layers = CFG.n_layers
    for stats in got["layer_stats"]:
        assert 1 <= stats["max_live_layers"] <= 2, stats
        assert stats["gathers"] >= 2 * n_layers, stats
    np.testing.assert_allclose(got["losses"], world1["losses"][:1], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], world1["grad_norms"][:1], rtol=1e-5)


def test_gradient_fn_gives_each_rank_its_blocks_of_jax_gradient(run):
    jparams, batches, report, legs = run
    batch = {n: jnp.asarray(b[0]) for n, b in batches.items()}
    value, grads = jax.jit(jax.value_and_grad(lambda p: jt.llama_loss(p, batch, CFG)))(jparams)
    want = _flat(grads)
    sizes = {"dp_shard": 2, "tp": 2}
    specs = _flat_specs(infer_param_specs(
        jax.tree_util.tree_map(np.asarray, jparams), sizes,
        ParallelismConfig(dp_shard_size=2, tp_size=2), llama_tp_rules()))
    for i, rank in enumerate(report["gradient_fn"]):
        assert rank["params_grad_untouched"]
        np.testing.assert_allclose(rank["value"], float(value), rtol=1e-5)
        got = legs[f"grads_rank{i}"]
        assert sorted(got) == sorted(want)
        for path, g in got.items():
            block = local_shard(want[path], specs[path], sizes, rank["coords"])
            assert g.shape == block.shape, path
            np.testing.assert_allclose(g, block, rtol=0, atol=1e-5 * np.abs(want[path]).max(),
                                       err_msg=path)


def _flat_specs(specs) -> dict:
    from accelerate_tpu_torch.parallel.sharding import _map_with_path

    out = {}
    _map_with_path(lambda path, s: out.__setitem__(path, s), specs)
    return out


def test_fp16_overflow_on_one_rank_is_every_ranks_decision(run):
    got = run[2]["fp16_local_overflow"]
    assert [r["grads_finite"] for r in got] == [[True, False, True]] * 4
    assert len({tuple(r["loss_scale"]) for r in got}) == 1


def test_fused_zero1_holds_a_quarter_of_the_optimizer_state(run, world1):
    _, _, report, _ = run
    per_rank = report["dp_replicate4_zero1"]["opt_state_bytes"]
    assert len(per_rank) == 4
    assert all(b * 4 == world1["opt_state_bytes"] for b in per_rank), (
        per_rank, world1["opt_state_bytes"])
    # the other legs keep whole moments for each rank's blocks
    assert report["tp4"]["opt_state_bytes"][0] < world1["opt_state_bytes"]


# -- adafactor under ZeRO-1, gradient compression, offload, LOMO, multi-node --

def _steps(batches):
    return {n: b[:ms.OPTION_STEPS] for n, b in batches.items()}


def _got(run, name):
    return {**run[2][name], "params": run[3][name]}


def _fails(hold, *args) -> bool:
    try:
        hold(*args)
    except AssertionError:
        return True
    return False


@pytest.fixture(scope="module")
def adafactor_zero1_jax(run):
    """JAX's adafactor under ZeRO-1 on dp_replicate 4 (it falls back from
    its fused update to the annotation path, as the port does)."""
    jparams, batches, _, _ = run
    return _jax_leg(jparams, _steps(batches), {"dp_replicate_size": 4}, True, False,
                    factory="adafactor")


@pytest.mark.parametrize("leg", ["zero1_adafactor_dp_replicate4",
                                 "zero1_adafactor_dp_replicate2_tp2"])
def test_adafactor_under_zero1_matches_jax(run, adafactor_refs, adafactor_zero1_jax, leg):
    """Adafactor under ZeRO-1 by annotation: each rank owns 1/N of the rows
    of every param ``zero1_state_specs`` splits, and of the moment that
    keeps dim 0; the column statistics and both RMS are summed over the
    axis, so the result is the unsplit adafactor's. On dp_replicate 4 it
    is held to JAX's ZeRO-1 adafactor; JAX cannot place that state on
    (dp_replicate 2, tp 2) (its device_put of the factored moments refuses
    the tp spec), so that leg is held to JAX's dp_replicate 4 run without
    ZeRO-1, the same global function. The planted fault (a block's sums
    never summed over the axis) fails the bar."""
    jparams, batches, report, _ = run
    got = _got(run, leg)
    assert got["zero1_rows"] and not got["fused_zero1"]
    if leg.endswith("dp_replicate4"):
        want = adafactor_zero1_jax
    else:
        want = adafactor_refs.get("adafactor") or _jax_leg(
            jparams, _steps(batches), {"dp_replicate_size": 4}, False, False,
            factory="adafactor")
        adafactor_refs["adafactor"] = want
    _hold(got, want, 1e-5, 2e-5)
    # a rank holds its rows of every moment that keeps dim 0: under half of
    # the unsplit adafactor's state on 4 ranks, less than all of it beside tp
    whole = _adafactor_state_bytes(jparams)
    bound = 0.5 * whole if leg.endswith("dp_replicate4") else whole
    assert all(b < bound for b in got["opt_state_bytes"]), (got["opt_state_bytes"], whole)
    if leg.endswith("dp_replicate4"):
        assert _fails(_hold, _got(run, leg + "_fault"), want, 1e-5, 2e-5)


def _adafactor_state_bytes(jparams) -> int:
    """The port's unsplit adafactor state of the whole params, in bytes."""
    import torch

    from accelerate_tpu_torch.optimizer import Adafactor, state_bytes

    ps = [torch.from_numpy(np.array(x)) for x in jax.tree_util.tree_leaves(jparams)]
    opt = Adafactor(ps, lr=ms.MESH_LR)
    opt.step(grads=[torch.ones_like(p) for p in ps])
    return state_bytes(opt)


def test_comm_hook_bf16_matches_jax(run):
    """``DistributedDataParallelKwargs(comm_hook="bf16")`` under dp_shard 4:
    the reduced gradient cast to bf16 and back before the update, as JAX
    casts its global gradient. Casting each rank's gradient before the
    reduction (the planted fault) fails the bar."""
    jparams, batches, _, _ = run
    want = _jax_leg(jparams, _steps(batches), {"dp_shard_size": 4}, False, False,
                    comm_hook="bf16")
    _hold(_got(run, "comm_bf16_dp_shard4"), want, 1e-5, 2e-5)
    assert _fails(_hold, _got(run, "comm_bf16_dp_shard4_fault"), want, 1e-5, 2e-5)


def test_offload_under_dp_shard4_matches_jax(run):
    """The optimizer state of each rank's blocks in host memory between
    steps, staged group by group (several groups a rank, the embedding's
    rows split), held to JAX's dp_shard 4 AdamW run (whose CPU backend
    keeps the state in device memory: the same arithmetic). A group whose
    write-back is lost (the planted fault) fails the bar."""
    jparams, batches, report, _ = run
    got = _got(run, "offload_dp_shard4")
    for rank in got["offload"]:
        assert rank["device_state_bytes"] == 0 and rank["host_state_bytes"] > 0
        assert rank["groups"] >= 3 * ms.OPTION_STEPS
    want = _jax_leg(jparams, _steps(batches), {"dp_shard_size": 4}, False, False)
    _hold(got, want, 1e-5, 2e-5)
    assert _fails(_hold, _got(run, "offload_dp_shard4_fault"), want, 1e-5, 2e-5)


def _hold_lomo(got, want, start, tol):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for path, value in got["params"].items():
        moved = want["params"][path] - start[path]
        err = _rel_l2(value - start[path], moved) if np.abs(moved).max() > 1e-8 else \
            float(np.abs(value - start[path]).max())
        assert err <= tol, (path, err)


def test_lomo_under_dp_replicate4_matches_jax(run):
    """``lomo_backward`` on dp_replicate 4: each gradient averaged over the
    ranks before its update. Held to JAX's ``lomo_backward`` on the same
    mesh: losses within 1e-5 and the 3-step updates (params less the start)
    within 2e-4 relative L2 per leaf: JAX's own one-device and dp_replicate
    4 updates are 9.3e-5 apart on ``layers/w1/kernel`` (f32 sums in
    another order, measured); the port's largest distance to JAX's run is
    1.5e-5, on the embedding. Without the mean over the ranks (the planted
    fault) each rank steps on its own rows' gradient and fails the bar."""
    jparams, batches, _, _ = run
    want = _jax_leg(jparams, _steps(batches), {"dp_replicate_size": 4}, False, False, lomo=True)
    start = _flat(jparams)
    _hold_lomo(_got(run, "lomo_dp_replicate4"), want, start, 2e-4)
    assert _fails(_hold_lomo, _got(run, "lomo_dp_replicate4_fault"), want, start, 2e-4)


def _hybrid_grid(pc, env):
    """JAX's device-id grid of ``pc`` over 4 fake devices in 2 slices under
    ``env`` (the layout a node-aware port mesh must match)."""
    from accelerate_tpu.test_utils import fake_slice_devices

    with patch_environment(**{k: v for k, v in env.items() if k != "LOCAL_WORLD_SIZE"}):
        mesh = JParallelismConfig(**pc).build_mesh(devices=fake_slice_devices(4, 2))
    return np.vectorize(lambda d: d.id)(mesh.devices).ravel().tolist()


@pytest.mark.parametrize("leg", ["multinode_dp_replicate2_dp_shard2", "multinode_dcn_dp_shard"])
def test_multi_node_mesh_matches_one_node(run, leg):
    """Two "nodes" of two ranks (``LOCAL_WORLD_SIZE=2``) under (dp_replicate
    2, dp_shard 2): the rank grid is JAX's hybrid grid over two fake
    slices; by default every dp_replicate row lies inside one node, and
    with ``ACCELERATE_DCN_MESH_SHAPE`` putting dp_shard across the nodes the
    grid is transposed. The collectives give the one-node leg's losses
    within f32 1e-6 (its sums may run in another order) and its params
    within 1e-5. The planted fault (the grid flattened, the nodes ignored)
    fails the placement bar."""
    _, _, report, legs = run
    pc, _, opts = OPTIONS[leg]
    got = report[leg]
    grid = np.asarray(got["mesh_grid"]).reshape(ms.pc_kwargs_shape(pc))
    assert got["mesh_grid"] == _hybrid_grid(pc, opts["env"])
    assert got["node"] == [0, 0, 1, 1]
    node = grid // 2
    if "dcn" in leg:
        assert [len(set(node[0, r].ravel())) for r in range(2)] == [2, 2]  # dp_shard spans
        assert not np.array_equal(grid.ravel(), np.arange(4))
        fault = report[leg + "_fault"]["mesh_grid"]
        assert fault != _hybrid_grid(pc, opts["env"])
    else:
        for r in range(2):
            assert len(set(node[0, r].ravel())) == 1, grid
    one = report["dp_replicate2_dp_shard2"]
    np.testing.assert_allclose(got["losses"], one["losses"][:ms.OPTION_STEPS], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norms"], one["grad_norms"][:ms.OPTION_STEPS],
                               rtol=1e-6)


CKPT_LEGS = [name for name, *_ in ms.CKPT_LEGS]


@pytest.mark.parametrize("leg", CKPT_LEGS)
def test_sharded_checkpoint_resumes_bitwise(run, leg):
    """Steps 3-4 after a load of the sharded save equal the uninterrupted
    run's losses bitwise; every rank wrote its part."""
    rec = run[2]["ckpt"][leg]
    assert rec["sharded"] and all(b > 0 for b in rec["bytes"])
    assert rec["resumed"] == rec["losses"][ms.CKPT_SAVE_AT:]


@pytest.mark.parametrize("leg", CKPT_LEGS)
def test_sharded_checkpoint_loads_in_jax(run, leg):
    """The port's shard set of the model loads into the JAX package on 4
    virtual devices (split on the first dim where it divides) and
    consolidates there: the params at the save, bitwise."""
    from accelerate_tpu import sharded_checkpoint as jsc
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    rec = run[2]["ckpt"][leg]
    saved = rec["saved"]
    merged = jsc.consolidate_sharded(rec["dir"], "model")
    assert merged.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(merged[k], v, err_msg=k)
    mesh = JMesh(np.array(jax.devices()[:4]), ("fsdp",))
    template = {k: jax.device_put(jnp.zeros_like(v), NamedSharding(
        mesh, JP("fsdp") if v.shape[0] % 4 == 0 else JP())) for k, v in saved.items()}
    nested: dict = {}
    for k, v in template.items():
        node = nested
        *head, last = k.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = v
    got = _flat(jsc.load_sharded_pytree(nested, rec["dir"], prefix="model"))
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# -- fp8 --

@pytest.fixture(scope="module")
def fp8_jax(run):
    """The JAX package's fp8 run under dp_replicate 4 with fused ZeRO-1: the
    global function both fp8 legs compute (its run on dp_replicate 2 ×
    dp_shard 2 gives the same numbers to the bars' precision)."""
    _, batches, _, _ = run
    jparams = jt.init_llama(FP8_CFG, jax.random.PRNGKey(0))
    steps = {n: b[:ms.FP8_STEPS] for n, b in batches.items()}
    return _jax_leg(jparams, steps, {"dp_replicate_size": 4}, True, False, factory="sgd",
                    precision="fp8")


def _hold_fp8(got: dict, want: dict):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    assert sorted(got["params"]) == sorted(want["params"])
    for path, value in got["params"].items():
        ref = want["params"][path]
        if "fp8_meta" in path:
            assert np.abs(value - ref).max() <= 0.25 * np.abs(ref).max(), path
        elif path.endswith("kernel"):
            assert _rel_l2(value, ref) <= 2e-3, (path, _rel_l2(value, ref))


@pytest.mark.parametrize("leg", [name for name, (_, _, fault) in FP8.items() if fault is None])
def test_fp8_leg_matches_jax_and_its_fault_fails(run, fp8_jax, leg):
    """The meta's gradients MAX-reduced over the batch ranks reproduce
    JAX's global amax; every rank holds the same meta, bitwise; under
    fused ZeRO-1 the meta leaves are the plan's passthrough slots and the
    fused path stays engaged."""
    got = _got(run, leg)
    pc, zero1, _ = FP8[leg]
    assert got["fused_zero1"] == zero1
    assert got["fp8"]["meta_leaves"] == 7 * 3  # 7 product sites, 3 histories each
    if zero1:
        assert got["fp8"]["passthrough"] == got["fp8"]["meta_leaves"]
    assert got["meta_ranks_equal"] and run[2][leg + "_fault"]["meta_ranks_equal"]
    assert any(v.max() > 0 for k, v in got["params"].items() if k.endswith("g_hist"))
    _hold_fp8(got, fp8_jax)
    assert _fails(_hold_fp8, _got(run, leg + "_fault"), fp8_jax)


# -- context and sequence parallelism --
#
# The long_context scenario runs every strategy of
# ``make_context_parallel_attention`` on 4 gloo ranks (ring, zig-zag and
# all-gather over cp 4, Ulysses over sp 4, GQA 8/2 and 8/1 under cp 2 ×
# dp_shard 2), the Llama forward through the ring and the zig-zag ring, 3
# training steps under (cp 2, dp_shard 2) with zig-zag and
# ``llama_shard_rules`` and under sp 4, the three planted faults (one step
# each), and examples/sequence_parallelism.py's recipe at sp 4. Each is
# held to the JAX package's same function on 4 virtual devices and to one
# process of the port. Tolerances are the JAX package's own
# (tests/test_long_context.py): 2e-4 relative / 2e-5 absolute on outputs,
# 5e-4 / 5e-5 on gradients, 5e-4 / 5e-4 on the Llama logits; the training
# legs take the mesh legs' bars above (losses and gradient norms 1e-5,
# params 2e-5 of JAX and 1e-5 of one process in relative L2).


def _lc_assemble(blocks: list, pc: dict, axis: str) -> np.ndarray:
    """The global array from the 4 ranks' blocks: each rank's rows of the
    data-parallel axes and its chunk of ``axis``, by its mesh coordinates."""
    from accelerate_tpu_torch.parallelism_config import Mesh

    meshes = [Mesh(ms.pc_kwargs_shape(pc), rank=r) for r in range(4)]
    dp = meshes[0].shape["dp_replicate"] * meshes[0].shape["dp_shard"]
    b, s = blocks[0].shape[:2]
    out = np.zeros((b * dp, s * meshes[0].shape[axis]) + blocks[0].shape[2:], blocks[0].dtype)
    for mesh, x in zip(meshes, blocks):
        row = mesh.coords["dp_replicate"] * mesh.shape["dp_shard"] + mesh.coords["dp_shard"]
        c = mesh.coords[axis]
        out[row * b:(row + 1) * b, c * s:(c + 1) * s] = x
    return out


def _jax_cp_attention(case: str) -> dict:
    """The JAX package's ``make_context_parallel_attention`` of a case on
    4 virtual devices: the output and, where asked, ``jax.grad`` of
    ``sum(out ** 2)``."""
    from accelerate_tpu.parallel.long_context import make_context_parallel_attention
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    strategy, pc, causal, shape, grads = LC_CASES[case]
    axis = "sp" if strategy == "ulysses" else "cp"
    mesh = JParallelismConfig(**pc).build_mesh()
    attn = make_context_parallel_attention(mesh, strategy=strategy)
    spec = NamedSharding(mesh, JP(("dp_replicate", "dp_shard"), axis, None, None))
    q, k, v = (jax.device_put(jnp.asarray(x), spec) for x in ms.lc_qkv(*shape))
    out = {"out": np.asarray(jax.jit(lambda a, b, c: attn(a, b, c, causal=causal))(q, k, v))}
    if grads:
        g = jax.jit(jax.grad(lambda a, b, c: jnp.sum(attn(a, b, c, causal=causal) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
        out.update(zip(("dq", "dk", "dv"), (np.asarray(x) for x in g)))
    return out


def _port_attention(case: str) -> dict:
    """The port's plain attention of a case in one process, and autograd's
    gradients of ``sum(out ** 2)``."""
    import torch
    from accelerate_tpu_torch.ops.attention import dot_product_attention

    _, _, causal, shape, grads = LC_CASES[case]
    q, k, v = (torch.from_numpy(x).requires_grad_(grads) for x in ms.lc_qkv(*shape))
    out = dot_product_attention(q, k, v, causal=causal)
    res = {"out": out.detach().numpy()}
    if grads:
        (out ** 2).sum().backward()
        res.update(dq=q.grad.numpy(), dk=k.grad.numpy(), dv=v.grad.numpy())
    return res


@pytest.mark.parametrize("case", list(LC_CASES))
def test_cp_sp_attention_matches_jax_and_one_process(run, case):
    """Each strategy's output blocks (and ``dq``, ``dk``, ``dv`` separately
    for the gradient cases: a k/v gradient not rotated home shows only
    there), assembled from the 4 ranks, against JAX's
    ``make_context_parallel_attention`` on 4 virtual devices and against
    the port's plain attention in one process."""
    strategy, pc, causal, shape, grads = LC_CASES[case]
    axis = "sp" if strategy == "ulysses" else "cp"
    legs = run[3]
    keys = ("out", "dq", "dk", "dv") if grads else ("out",)
    got = {key: _lc_assemble([legs[f"lc_rank{r}"][f"{case}/{key}"] for r in range(4)], pc, axis)
           for key in keys}
    for want in (_jax_cp_attention(case), _port_attention(case)):
        for key in keys:
            tol = dict(rtol=2e-4, atol=2e-5) if key == "out" else dict(rtol=5e-4, atol=5e-5)
            np.testing.assert_allclose(got[key], want[key], err_msg=key, **tol)


@pytest.mark.parametrize("strategy", ms.LC_LLAMA_FORWARD)
def test_llama_forward_through_cp_attention_matches_jax(run, strategy):
    """``llama_forward(attention_fn=)`` with the ring or the zig-zag ring
    over cp 2 × dp_shard 2 (the RoPE positions global): the ranks' logits
    against JAX's forward with its attention_fn on 4 virtual devices, and
    against the port's plain forward in one process (the JAX package's
    test_zigzag_in_llama_end_to_end / test_cp_in_llama_end_to_end)."""
    import torch
    from accelerate_tpu.parallel.long_context import make_context_parallel_attention
    from accelerate_tpu.parallel.sharding import replicate
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.models.convert import params_from_numpy
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    legs = run[3]
    got = _lc_assemble([legs[f"lc_rank{r}"][f"llama_{strategy}/logits"] for r in range(4)],
                       ms.LC_PC, "cp")
    jparams = jt.init_llama(LC_CFG, jax.random.PRNGKey(0))
    ids = np.random.default_rng(0).integers(0, 128, (2, 64)).astype(np.int32)
    mesh = JParallelismConfig(**ms.LC_PC).build_mesh()
    attn = make_context_parallel_attention(mesh, strategy=strategy)
    ids_s = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, JP(("dp_replicate", "dp_shard"),
                                                                   "cp")))
    want = jax.jit(lambda p, i: jt.llama_forward(p, i, LC_CFG, attention_fn=attn))(
        replicate(jparams, mesh), ids_s)
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-4)
    cfg = tt.LlamaConfig(**dataclasses.asdict(LC_CFG))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        one = tt.llama_forward(params, torch.from_numpy(ids), cfg).numpy()
    np.testing.assert_allclose(got, one, rtol=5e-4, atol=5e-4)


def _jax_lc_leg(name: str, batches: dict, steps: int) -> dict:
    """The JAX package's run of a long-context leg: its ``Accelerator`` on
    the same mesh with ``llama_shard_rules`` and the loss's ``attention_fn``
    from ``context_parallel_attention()``. A cp leg's run takes the
    all-gather rotation, the same global function as the zig-zag ring at
    less than half its compile time here (the port's zig-zag is held to
    JAX's zig-zag itself, forward and gradients, in the attention cases)."""
    from accelerate_tpu.models.transformer import llama_shard_rules as j_rules

    pc, params_file, _ = LC_LEGS[name]
    if "cp_rotate_method" in pc:
        pc = dict(pc, cp_rotate_method="allgather")
    cfg = KV4_CFG if "kv4" in params_file else CFG
    _reset_jax()
    try:
        acc = JAccelerator(parallelism_config=JParallelismConfig(**pc))
        params, opt = acc.prepare(jt.init_llama(cfg, jax.random.PRNGKey(0)),
                                  optax.adamw(ms.MESH_LR), shard_rules=j_rules())
        attn = acc.context_parallel_attention()
        step = acc.prepare_train_step(
            lambda p, b: jt.llama_loss(p, b, cfg, attention_fn=attn, mesh=acc.mesh),
            compute_grad_norm=True)
        state, out = opt.opt_state, {"losses": [], "grad_norms": []}
        for k in range(steps):
            params, state, metrics = step(params, state, {n: b[k] for n, b in batches.items()})
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
        out["params"] = _flat(params)
        return out
    finally:
        _reset_jax()


@pytest.fixture(scope="module")
def lc_one_process(run):
    """The port's one-process runs of the long-context legs' steps (the
    plain step, plain attention, whole sequences), by params file."""
    import torch

    _, batches, _, _ = run
    steps = {n: b[:ms.LC_STEPS] for n, b in batches.items()}
    out, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    try:
        for params_file, cfg in (("llama_params.npz", CFG), ("llama_kv4_params.npz", KV4_CFG)):
            params_np = jax.tree_util.tree_map(np.asarray,
                                               jt.init_llama(cfg, jax.random.PRNGKey(0)))
            out[params_file] = ms.mesh_train_leg(params_np, steps, {}, False, False,
                                                 device="cpu", prepare_rules="llama")
    finally:
        torch.set_num_threads(threads)
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return out


@pytest.mark.parametrize("leg", list(LC_LEGS))
def test_cp_sp_training_matches_jax_and_one_process(run, lc_one_process, leg):
    """3 AdamW steps under (cp 2, dp_shard 2) with ``cp_rotate_method=
    "zigzag"`` and ``llama_shard_rules`` (the FSDP dim split over
    ``(dp_shard, cp)``, so each layer's gather and gradient reduce span
    both) and under sp 4 (Ulysses), the prepared batches' sequence split
    over the axis, a random ``loss_mask``: losses, gradient norms and final
    params against JAX's run on the same mesh and against one process."""
    from accelerate_tpu_torch.models.transformer import llama_shard_rules
    from accelerate_tpu_torch.parallel.sharding import _leaves
    from accelerate_tpu_torch.parallelism_config import MESH_AXIS_NAMES

    _, batches, report, legs = run
    steps = {n: b[:ms.LC_STEPS] for n, b in batches.items()}
    got = {**report["lc"][leg], "params": legs[f"lc_{leg}"]}
    _hold(got, _jax_lc_leg(leg, steps, ms.LC_STEPS), 1e-5, 2e-5)
    _hold(got, lc_one_process[LC_LEGS[leg][1]], 1e-5, 1e-5)
    pc = LC_LEGS[leg][0]
    if pc.get("dp_shard_size", 1) > 1:  # FSDP over (dp_shard, cp): the layers gathered per layer
        sizes = dict(zip(MESH_AXIS_NAMES, ms.pc_kwargs_shape(pc)))
        specs = infer_param_specs(jax.tree_util.tree_map(np.asarray, run[0]), sizes,
                                  ParallelismConfig(**pc), llama_shard_rules())
        assert any(("dp_shard", "cp") in tuple(spec) for spec in _leaves(specs["layers"]))
        assert all(stats["gathers"] > 0 for stats in got["layer_stats"])


@pytest.mark.parametrize("fault", ms.LC_FAULTS)
def test_cp_planted_fault_fails_a_bar(run, lc_one_process, fault):
    """Each planted fault, one step under (cp 2, dp_shard 2) zig-zag: RoPE
    positions local to each chunk, each chunk's targets rolled within the
    chunk, or the gradients not summed over cp. Its loss or gradient norm
    must miss the one-process step by more than the leg's 1e-5 bar."""
    base = ms.LC_LEGS[0][0]
    got = run[2]["lc"][f"{base}_{fault}"]
    want = lc_one_process[LC_LEGS[base][1]]
    errs = [abs(got[key][0] - want[key][0]) / abs(want[key][0])
            for key in ("losses", "grad_norms")]
    assert max(errs) > 1e-5, (fault, errs)
    sound = run[2]["lc"][base]
    assert max(abs(sound[key][0] - want[key][0]) / abs(want[key][0])
               for key in ("losses", "grad_norms")) <= 1e-5


def test_sequence_parallelism_example_matches_jax(run):
    """examples/sequence_parallelism.py's recipe at ``--sp 4 --dp-shard 1``
    (f32, adam, the prepared loader's sequence split, Ulysses through
    ``sequence_parallel_attention``): the port's first and last step
    losses against the JAX example's ``training_function`` on 4 virtual
    devices."""
    import argparse
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "examples" / "sequence_parallelism.py"
    spec = importlib.util.spec_from_file_location("sequence_parallelism_example", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ex = ms.LC_EXAMPLE
    args = argparse.Namespace(sp=4, dp_shard=1, mixed_precision="no", cpu=True, seed=ex["seed"],
                              seq_len=ex["seq_len"], train_size=ex["train_size"],
                              batch_size=ex["batch_size"], lr=ex["lr"], epochs=1)
    _reset_jax()
    try:
        want = example.training_function(args)
    finally:
        _reset_jax()
    losses = run[2]["lc"]["example"]
    assert len(losses) == ex["train_size"] // ex["batch_size"]
    np.testing.assert_allclose([losses[0], losses[-1]], [want["first_loss"], want["train_loss"]],
                               rtol=1e-5)
