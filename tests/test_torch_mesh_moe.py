"""The MoE Llama trained over a mesh in the port, over 4 processes, against
the JAX package on 4 virtual CPU devices and against the port's own
one-process run.

One launch of 4 ``gloo`` processes (:mod:`accelerate_tpu_torch.test_utils.
scripts.multihost_script`, scenario ``mesh_moe``) trains the MoE Llama at
``tests/test_torch_moe.py``'s widths (``LlamaConfig.tiny()`` with 4
experts, top-2, capacity factor 1.25; params from the JAX initializer,
f32, plain attention) for 2 ``adamw(1e-3)`` steps on a global batch of
8 × 64 token ids from a seeded numpy generator, with ``moe_shard_rules``,
on four legs: dp_shard 2 (the 512 tokens are one routing group, which
straddles both ranks: each rank's capacity slots count the other rank's
tokens), ep 2 (each rank computes 2 of the 4 experts of the same rows;
the rules split the stacked layer axis over ``ep``, so each rank holds
half the expert bytes), ep 2 × dp_shard 2, and ep 2 without
``moe_shard_rules`` (every rank holds the whole experts and keeps their
whole gradient). A mesh that needs only 2 ranks takes tp 2 with no tp
rules as its other axis (its ranks compute the same rows alike). The JAX package runs the same steps through its
``Accelerator`` with the same ``ParallelismConfig`` and rules.

Tolerances, f32 with the sums in another order: losses and gradient norms
within 1e-5 relative of JAX's on the same mesh and of one process; final
params within 1e-5 relative L2 per leaf of the port's one process and 2e-5
of JAX's one-device run (the bars of ``tests/test_torch_mesh_train.py``,
whose docstring gives the reason: AdamW turns the rounding noise of
near-zero gradient elements into parts of lr), and within 1e-4 of JAX's
run on the same mesh, which is itself 6.7e-5 from JAX's one-device run on
``embed_tokens/embedding`` under dp_shard 2 (measured; the port's legs lie
within 1.0e-5 of one process and 1.4e-5 of JAX's one device); the
aux loss of the first forward within 1e-6 relative of JAX's on every rank;
the token-choices the first step's forward drops by capacity (the batch
ranks' counts summed) equal JAX's dispatch, counted on its forward of the
same params and batch. The same launch checks that the loader gives every
rank of an ``ep`` group the same rows.
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
from accelerate_tpu.parallel import moe as jm
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.scripts import multihost_script as ms
from accelerate_tpu_torch.test_utils.testing import execute_multiprocess

SCRIPT = ["-m", "accelerate_tpu_torch.test_utils.scripts.multihost_script"]
LEGS = {name: pc for name, pc, _, _ in ms.MOE_LEGS}
RULES = {name: options.get("moe_rules", True) for name, _, _, options in ms.MOE_LEGS}
CFG = dataclasses.replace(jt.LlamaConfig.tiny(), moe_experts=4, moe_top_k=2)
STEPS, B, S = 2, 8, 64


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
    tmp = tmp_path_factory.mktemp("mesh_moe")
    jparams = jt.init_llama(CFG, jax.random.PRNGKey(0))
    np.savez(tmp / "moe_params.npz", **_flat(jparams))
    rng = np.random.default_rng(0)
    batches = {"input_ids": rng.integers(1, CFG.vocab_size, size=(STEPS, B, S), dtype=np.int32)}
    np.savez(tmp / "moe_batches.npz", **batches)
    outs = execute_multiprocess(SCRIPT + ["--scenario", "mesh_moe", "--tmpdir", str(tmp)],
                                num_processes=4, timeout=240)
    for out in outs:
        assert "ALL OK" in out, out[-2000:]
    with open(tmp / "mesh_moe.json") as f:
        report = json.load(f)
    legs = {}
    for name in LEGS:
        with np.load(tmp / f"moe_{name}.npz") as f:
            legs[name] = {k: f[k] for k in f.files}
    return jparams, batches, report, legs


@pytest.fixture(scope="module")
def world1(run):
    jparams, batches, _, _ = run
    try:
        return ms.mesh_train_leg(jax.tree_util.tree_map(np.asarray, jparams), batches, {}, False,
                                 False, moe=True)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


@pytest.fixture(scope="module")
def jax_one_device(run):
    jparams, batches, _, _ = run
    return _jax_leg(jparams, batches, {"dp_replicate_size": 1})[2]


@pytest.fixture(scope="module")
def jax_first_forward(run):
    """JAX's aux loss and dropped token-choices on the first batch at the
    initial params: the dispatch tensors of its forward, run eagerly."""
    jparams, batches, _, _ = run
    captured = []
    real_einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "gnec,gnd->egcd":
            captured.append(float(np.asarray(ops[0]).sum()))
        return real_einsum(spec, *ops, **kw)

    jnp.einsum = spy
    try:
        with jax.disable_jit():
            _, aux = jt.llama_forward(jparams, jnp.asarray(batches["input_ids"][0]), CFG,
                                      with_aux=True)
    finally:
        jnp.einsum = real_einsum
    routed = B * S * CFG.moe_top_k * CFG.n_layers
    assert len(captured) == CFG.n_layers
    return float(aux), routed - int(sum(captured)), routed


def _jax_leg(jparams, batches, pc_kwargs, rules: bool = True):
    _reset_jax()
    jparams = jax.tree_util.tree_map(np.array, jparams)
    try:
        acc = JAccelerator(parallelism_config=JParallelismConfig(**pc_kwargs),
                           shard_rules=jm.moe_shard_rules() if rules else None)
        params, opt = acc.prepare(jparams, optax.adamw(ms.MESH_LR))
        step = acc.prepare_train_step(lambda p, b: jt.llama_loss(p, b, CFG, mesh=acc.mesh),
                                      compute_grad_norm=True)
        state, losses, norms = opt.opt_state, [], []
        for k in range(STEPS):
            params, state, metrics = step(params, state, {n: b[k] for n, b in batches.items()})
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        return losses, norms, _flat(params)
    finally:
        _reset_jax()


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("leg", list(LEGS))
def test_moe_leg_matches_jax_and_one_process(run, world1, jax_one_device, jax_first_forward,
                                             leg):
    jparams, batches, report, legs = run
    got = report[leg]
    j_losses, j_norms, j_params = _jax_leg(jparams, batches, LEGS[leg], RULES[leg])
    np.testing.assert_allclose(got["losses"], j_losses, rtol=1e-5)
    np.testing.assert_allclose(got["losses"], world1["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], j_norms, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], world1["grad_norms"], rtol=1e-5)
    assert sorted(legs[leg]) == sorted(j_params) == sorted(world1["params"])
    for path, value in legs[leg].items():
        assert _rel_l2(value, world1["params"][path]) <= 1e-5, path
        assert _rel_l2(value, jax_one_device[path]) <= 2e-5, path
        assert _rel_l2(value, j_params[path]) <= 1e-4, path
    j_aux, j_dropped, routed = jax_first_forward
    np.testing.assert_allclose(got["aux"], [j_aux] * 4, rtol=1e-6)
    # each batch row's drops once: the ranks of an ep (or the filler tp)
    # group count the same rows
    pc = LEGS[leg]
    copies = pc.get("ep_size", 1) * pc.get("tp_size", 1)
    assert sum(d["routed"] for d in got["drops"]) == routed * copies
    assert sum(d["dropped"] for d in got["drops"]) == j_dropped * copies
    assert j_dropped > 0 and world1["drops"] == {"routed": routed, "dropped": j_dropped}
    for stats in got["layer_stats"]:  # none where no param is split
        assert 1 <= stats["max_live_layers"] <= 2 if RULES[leg] else not stats, stats
    ep = pc.get("ep_size", 1) > 1
    if ep and RULES[leg]:  # each rank holds half of every expert weight's bytes
        assert all(b < world1["opt_state_bytes"] for b in got["opt_state_bytes"])
    # each layer's gradient goes to the rank that keeps it: a reduce over
    # the batch axes, a gather of the experts' parts over ep; whole experts
    # on every rank take an all-gather of those parts
    for ops in got["comm"]:
        assert ("step:gather" in ops) == (ep and RULES[leg]), ops
        assert ("layer:reduce" in ops) == (pc.get("dp_shard_size", 1) > 1), ops
        if ep and not RULES[leg]:
            assert "step:all_gather" in ops, ops


def test_loader_gives_an_ep_group_the_same_rows(run):
    ranks = run[2]["loader_rows"]
    by_row: dict = {}
    for r in ranks:
        by_row.setdefault(r["coords"]["dp_shard"], []).append(r["rows"])
    assert sorted(by_row) == [0, 1]
    for rows in by_row.values():
        assert len(rows) == 2 and rows[0] == rows[1]
    assert by_row[0] != by_row[1]
