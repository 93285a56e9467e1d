"""Sharded Llama training in the port, over 4 processes, against the JAX
package on 4 virtual CPU devices and against the port's own one-process
run.

One launch of 4 ``gloo`` processes (:mod:`accelerate_tpu_torch.test_utils.
scripts.multihost_script`, scenario ``mesh_train``) runs Llama at tiny
widths and 4 layers (f32, plain attention, global batch 8 × 64,
``adamw(1e-3)``, 5 steps, a random ``loss_mask`` so that the ranks' rows
count different numbers of positions) on four meshes: (dp_replicate 2, dp_shard 2), (dp_shard 2, tp 2) and (tp 4) with
``llama_tp_rules`` on the two with ``tp``, and (dp_replicate 4) with fused
ZeRO-1. The JAX package runs the same steps through its ``Accelerator``
with the same ``ParallelismConfig``, rules and ``DeepSpeedPlugin
(zero_stage=1)``; the port's one-process run is the plain step on the whole
batch. Params come from the JAX initializer, token ids from a seeded
numpy generator. The depth is 4, not tiny's 2, because ``llama_tp_rules``
put ``tp`` on dim 0 of the stacked tree, the layer axis, and the JAX
package refuses to split 2 layers 4 ways.

Tolerances, f32 on every side with the sums in another order: losses and
the global gradient norms (which a gradient summed over the wrong axes
moves, where AdamW's normalised step hides it) within 1e-5 relative of
both references; final params within 1e-5 relative
in L2 per leaf of the port's one-process run, and within 2e-5 of the JAX
package's run on the same mesh. AdamW's g / (|g| + eps) turns the rounding
noise of near-zero gradient elements into parts of lr, so each of two
correct runs sits about 1e-5 from a common reference, in opposite
directions: measured on ``layers/wk/kernel``, the JAX package's tp 4 run is
6.7e-6 from its own one-device run, and the port's one-process run 5.7e-6
from that same JAX run. The fused ZeRO-1 leg holds a quarter of the AdamW
moments on each rank. The same launch asks for ZeRO-1 where the fused
update cannot run, which must raise.
"""

import dataclasses
import json

import jax
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
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.scripts import multihost_script as ms
from accelerate_tpu_torch.test_utils.testing import execute_multiprocess

SCRIPT = ["-m", "accelerate_tpu_torch.test_utils.scripts.multihost_script"]
LEGS = {name: (pc, zero1, tp) for name, pc, zero1, tp in ms.MESH_LEGS}
B, S = 8, 64
CFG = dataclasses.replace(jt.LlamaConfig.tiny(), n_layers=4)


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _flat(tree) -> dict:
    return {_path(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reset_jax():
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The 4-process launch: params and batches in, the report and each
    leg's final params out."""
    tmp = tmp_path_factory.mktemp("mesh_train")
    jparams = jt.init_llama(CFG, jax.random.PRNGKey(0))
    np.savez(tmp / "llama_params.npz", **_flat(jparams))
    vocab = CFG.vocab_size
    rng = np.random.default_rng(0)
    batches = {"input_ids": rng.integers(1, vocab, size=(ms.MESH_STEPS, B, S), dtype=np.int32),
               "loss_mask": (rng.random((ms.MESH_STEPS, B, S)) < 0.7).astype(np.int32)}
    np.savez(tmp / "llama_batches.npz", **batches)
    outs = execute_multiprocess(SCRIPT + ["--scenario", "mesh_train", "--tmpdir", str(tmp)],
                                num_processes=4, timeout=120)
    for out in outs:
        assert "ALL OK" in out, out[-2000:]
    with open(tmp / "mesh_train.json") as f:
        report = json.load(f)
    legs = {}
    for name in LEGS:
        with np.load(tmp / f"mesh_{name}.npz") as f:
            legs[name] = {k: f[k] for k in f.files}
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


def _jax_leg(jparams, batches, pc_kwargs, zero1, tp):
    _reset_jax()
    # host copies: the JAX step donates the params it is given
    jparams = jax.tree_util.tree_map(np.array, jparams)
    try:
        acc = JAccelerator(parallelism_config=JParallelismConfig(**pc_kwargs),
                           deepspeed_plugin=JDeepSpeedPlugin(zero_stage=1) if zero1 else None,
                           shard_rules=j_llama_tp_rules() if tp else None)
        cfg = CFG
        params, opt = acc.prepare(jparams, optax.adamw(ms.MESH_LR))
        step = acc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, cfg, mesh=acc.mesh),
                                      compute_grad_norm=True)
        state, losses, norms = opt.opt_state, [], []
        for k in range(batches["input_ids"].shape[0]):
            params, state, metrics = step(params, state, {n: b[k] for n, b in batches.items()})
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        return losses, norms, _flat(params)
    finally:
        _reset_jax()


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("leg", list(LEGS))
def test_mesh_leg_matches_jax_and_one_process(run, world1, leg):
    jparams, batches, report, legs = run
    pc, zero1, tp = LEGS[leg]
    j_losses, j_norms, j_params = _jax_leg(jparams, batches, pc, zero1, tp)
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


@pytest.mark.parametrize("case", [c[0] for c in ms.ZERO1_REFUSALS])
def test_zero1_without_the_fused_path_raises(run, case):
    """ZeRO-1 on a composite mesh, with ``ACCELERATE_ZERO1_FUSED=0`` or
    with a non-floating leaf: the JAX package shards the optimizer state by
    annotation there, which the port has not ported, so ``prepare`` raises
    rather than keep the whole state on every rank."""
    got = run[2]["zero1_refusals"][case]
    assert got is not None and got.startswith("NotImplementedError"), got
    assert "Queue A item 6" in got


def test_fused_zero1_holds_a_quarter_of_the_optimizer_state(run, world1):
    _, _, report, _ = run
    per_rank = report["dp_replicate4_zero1"]["opt_state_bytes"]
    assert len(per_rank) == 4
    assert all(b * 4 == world1["opt_state_bytes"] for b in per_rank), (
        per_rank, world1["opt_state_bytes"])
    # the other legs keep whole moments for each rank's blocks
    assert report["tp4"]["opt_state_bytes"][0] < world1["opt_state_bytes"]
