"""Sharded decode, the sharded serving engine and the models' shard rules
through ``prepare(..., shard_rules=)``, over 4 processes, against the JAX
package on 4 virtual CPU devices and against the port's own one-process
runs.

One launch of 4 ``gloo`` processes (:mod:`accelerate_tpu_torch.test_utils.
scripts.multihost_script`, scenario ``mesh_decode``) runs every leg; the JAX
package runs the same calls here. The meshes are ``ParallelismConfig``
meshes: the JAX tests' ``("dp", "tp")`` 2 x 2 mesh is (dp_shard 2, tp 2)
(the port's mesh has no ``dp`` axis; the placement reads both alike).

- ``generation_shardings`` / ``serving_shardings`` decisions against JAX's
  (batch 4, 3 and 2; divisible and indivisible kv heads; joint data axes),
  with no processes.
- f32 decode of ``tests/test_generation_sharded.py``'s tiny config (vocab
  256, dim 64, 2 layers, 4/2 heads) under (dp_shard 2, tp 2), params placed
  by ``shard_params(..., rules=llama_shard_rules())``: greedy, beam (tokens
  equal, scores within 1e-4 relative) and eos-freeze tokens equal to JAX's
  meshed run, to JAX's one-device run and to the port's one-process run;
  greedy from the ``Accelerator``'s FSDP placement (``param_specs``); greedy
  under tp 4, where the 2 kv heads do not divide and the cache stays whole;
  MoE greedy under (ep 2, tp 2); sampled decode equal to JAX's one-device
  tokens at the same key except at a named near-tie (as
  ``tests/test_torch_generation.py`` names one).
- ``ServingEngine(mesh=)`` under (dp_replicate 2, tp 2) (tp 2: the data
  axis does nothing in serving, where every rank runs every request) and
  (dp_shard 2, tp 2), on ``test_zero_recompiles_through_churn_on_multidevice
  _mesh``'s requests (its recompile check is item 12): every output equal to
  JAX's one-device ``greedy_generate`` token for token and to the port's
  one-process engine, ``stats()`` equal to that engine's, the pool a rank
  holds exactly half of it.
- Per-rank param bytes under (dp_shard 2, tp 2) equal to the sum of the
  rank's blocks under ``llama_shard_rules``.
- Two planted faults, each of which must fail a bar: no sum over ``tp``
  after ``wo`` (greedy tokens part from the reference) and each rank's pool
  written with the next rank's heads (engine outputs part).
- A Llama step (3 steps, ``adamw(1e-3)``, tiny, loss mask) and a BERT step
  (3 steps, tiny) under (dp_shard 2, tp 2) through ``prepare(...,
  shard_rules=llama_shard_rules() / bert_shard_rules())``, held to the JAX
  package's ``Accelerator`` with the same rules: losses and global gradient
  norms within 1e-5 relative, final params within 2e-5 relative L2 per
  leaf (the bars of ``tests/test_torch_mesh_train.py``, f32 sums in
  another order).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import generation as jg
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.parallel.sharding import shard_params as j_shard_params
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu_torch import generation as tg
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.parallel.sharding import infer_param_specs, local_shard
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.test_utils.scripts import multihost_script as ms
from accelerate_tpu_torch.test_utils.testing import execute_multiprocess
from accelerate_tpu_torch.utils import random as tr

SCRIPT = ["-m", "accelerate_tpu_torch.test_utils.scripts.multihost_script"]
CFG = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=128)
MOE_CFG = dict(vocab_size=128, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64,
               moe_experts=4, moe_top_k=2, moe_capacity_factor=8.0)
ENGINE_REQS = [(9, 4), (45, 6), (30, 4), (5, 8)]
TRAIN_STEPS, B, S = 3, 8, 64
NEW = ms.DECODE_NEW
CPU = {"device": "cpu"}


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32)
                                  if np.issubdtype(np.asarray(x).dtype, np.floating)
                                  else np.asarray(x), tree)


def _flat(tree) -> dict:
    return {_path(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _reset():
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _jmesh(pc_kwargs):
    pc = JParallelismConfig(**pc_kwargs)
    return pc.build_mesh(jax.devices()[:pc.total_size()])


@pytest.fixture(scope="module")
def inputs():
    key = jax.random.PRNGKey(0)
    cfg, moe_cfg = jt.LlamaConfig(**CFG), jt.LlamaConfig(**MOE_CFG)
    tiny = jt.LlamaConfig.tiny()
    rng = np.random.default_rng(21)
    eng_prompts = [(rng.integers(0, tiny.vocab_size, (n,)).astype(np.int32), new)
                   for n, new in ENGINE_REQS]
    rng = np.random.default_rng(0)
    llama_batches = {
        "input_ids": rng.integers(1, tiny.vocab_size, (TRAIN_STEPS, B, S), dtype=np.int32),
        "loss_mask": (rng.random((TRAIN_STEPS, B, S)) < 0.7).astype(np.int32)}
    bcfg = jt.BertConfig.tiny()
    bert_batches = {
        "input_ids": rng.integers(1, bcfg.vocab_size, (TRAIN_STEPS, B, 32), dtype=np.int32),
        "attention_mask": (np.arange(32)[None, None] < rng.integers(
            12, 33, (TRAIN_STEPS, B, 1))).astype(np.int32),
        "token_type_ids": (np.arange(32)[None, None] >= 16).repeat(B, 1).repeat(
            TRAIN_STEPS, 0).astype(np.int32),
        "labels": rng.integers(0, 2, (TRAIN_STEPS, B)).astype(np.int32)}
    return {
        "config": CFG, "params": _np(jt.init_llama(cfg, key)),
        "prompt": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0,
                                                cfg.vocab_size), np.int32),
        "moe_config": MOE_CFG, "moe_params": _np(jt.init_llama(moe_cfg, key)),
        "moe_prompt": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 6), 0,
                                                    moe_cfg.vocab_size), np.int32),
        "engine_config": dataclasses.asdict(tiny), "engine_params": _np(jt.init_llama(tiny, key)),
        "engine_prompts": eng_prompts,
        "llama_params": _np(jt.init_llama(tiny, key)), "llama_batches": llama_batches,
        "bert_params": _np(jt.init_bert(bcfg, key)), "bert_batches": bert_batches,
    }


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_decode")
    with open(tmp / "decode_inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    outs = execute_multiprocess(SCRIPT + ["--scenario", "mesh_decode", "--tmpdir", str(tmp)],
                                num_processes=4, timeout=240)
    for out in outs:
        assert "ALL OK" in out, out[-3000:]
    with open(tmp / "decode_results.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """The JAX package's one-device and meshed decode of the same calls."""
    cfg = jt.LlamaConfig(**CFG)
    params, prompt = inputs["params"], inputs["prompt"]
    kw = dict(cache_dtype=jnp.float32)
    out = {"greedy": jg.greedy_generate(params, prompt, cfg, max_new_tokens=NEW, **kw),
           "eos": jg.greedy_generate(params, prompt, cfg, max_new_tokens=NEW, eos_token_id=5,
                                     **kw),
           "sampled": jg.sample_generate(params, prompt, cfg, max_new_tokens=NEW,
                                         temperature=0.7, top_k=8,
                                         rng_key=jax.random.PRNGKey(7), **kw)}
    out["beam"], out["beam_scores"] = jg.beam_generate(params, prompt, cfg, num_beams=2,
                                                       max_new_tokens=5, return_scores=True, **kw)
    mesh = _jmesh(ms.DECODE_MESHES["dp_shard2_tp2"])
    sharded, _ = j_shard_params(params, mesh, rules=jt.llama_shard_rules())
    out["mesh_greedy"] = jg.greedy_generate(sharded, prompt, cfg, max_new_tokens=NEW, mesh=mesh,
                                            **kw)
    out["mesh_eos"] = jg.greedy_generate(sharded, prompt, cfg, max_new_tokens=NEW,
                                         eos_token_id=5, mesh=mesh, **kw)
    out["mesh_beam"], out["mesh_beam_scores"] = jg.beam_generate(
        sharded, prompt, cfg, num_beams=2, max_new_tokens=5, return_scores=True, mesh=mesh, **kw)
    mesh4 = _jmesh(ms.DECODE_MESHES["tp4"])
    sharded4, _ = j_shard_params(params, mesh4, rules=jt.llama_shard_rules())
    out["mesh_greedy_tp4"] = jg.greedy_generate(sharded4, prompt, cfg, max_new_tokens=NEW,
                                                mesh=mesh4, **kw)
    moe_cfg = jt.LlamaConfig(**MOE_CFG)
    out["moe_greedy"] = jg.greedy_generate(inputs["moe_params"], inputs["moe_prompt"], moe_cfg,
                                           max_new_tokens=5, **kw)
    mesh_ep = _jmesh(ms.DECODE_MESHES["ep2_tp2"])
    moe_sharded, _ = j_shard_params(inputs["moe_params"], mesh_ep, rules=jt.llama_shard_rules())
    out["mesh_moe_greedy"] = jg.greedy_generate(moe_sharded, inputs["moe_prompt"], moe_cfg,
                                                max_new_tokens=5, mesh=mesh_ep, **kw)
    tiny = jt.LlamaConfig.tiny()
    out["engine"] = [np.asarray(jg.greedy_generate(inputs["engine_params"], p[None], tiny,
                                                   max_new_tokens=new, **kw))[0].tolist()
                     for p, new in inputs["engine_prompts"]]
    return {k: np.asarray(v) if not isinstance(v, list) else v for k, v in out.items()}


@pytest.fixture(scope="module")
def one_process(inputs):
    """The port's own one-process runs of the same calls."""
    _reset()
    cfg = tt.LlamaConfig(**CFG)
    params = params_from_numpy(inputs["params"], device="cpu")
    prompt = inputs["prompt"]
    kw = dict(cache_dtype=torch.float32, **CPU)
    out = {"greedy": tg.greedy_generate(params, prompt, cfg, max_new_tokens=NEW, **kw),
           "eos": tg.greedy_generate(params, prompt, cfg, max_new_tokens=NEW, eos_token_id=5,
                                     **kw)}
    out["beam"], out["beam_scores"] = tg.beam_generate(params, prompt, cfg, num_beams=2,
                                                       max_new_tokens=5, return_scores=True, **kw)
    out["moe_greedy"] = tg.greedy_generate(
        params_from_numpy(inputs["moe_params"], device="cpu"), inputs["moe_prompt"],
        tt.LlamaConfig(**MOE_CFG), max_new_tokens=5, **kw)
    out["engine"] = ms.decode_engine_run(
        params_from_numpy(inputs["engine_params"], device="cpu"),
        tt.LlamaConfig(**inputs["engine_config"]), inputs["engine_prompts"])
    return out


# -- placement decisions (no processes) --

PLACEMENTS = [  # (mesh kwargs, batch, n_kv_heads)
    ({"dp_shard_size": 2, "tp_size": 2}, 4, 2),
    ({"dp_shard_size": 2, "tp_size": 2}, 3, 2),
    ({"tp_size": 4}, 4, 2),
    ({"dp_replicate_size": 2, "dp_shard_size": 2, "tp_size": 2}, 2, 2),
    ({"dp_replicate_size": 2, "dp_shard_size": 2, "tp_size": 2}, 4, 2),
    ({"dp_replicate_size": 2, "dp_shard_size": 2, "tp_size": 2}, 4, 4),
    ({"ep_size": 2, "tp_size": 4}, 8, 4),
]


@pytest.mark.parametrize("pc_kwargs,batch,kv_heads", PLACEMENTS)
def test_generation_and_serving_shardings_match_jax(pc_kwargs, batch, kv_heads):
    jcfg = dataclasses.replace(jt.LlamaConfig(**CFG), n_heads=8, n_kv_heads=kv_heads)
    tcfg = dataclasses.replace(tt.LlamaConfig(**CFG), n_heads=8, n_kv_heads=kv_heads)
    jmesh = _jmesh(pc_kwargs)
    j_prompt, j_cache = jg.generation_shardings(jmesh, batch, jcfg)
    sizes = dict(jmesh.shape)
    t_prompt, t_cache = tg.generation_shardings(sizes, batch, tcfg)
    assert tuple(t_prompt) == tuple(j_prompt.spec)
    assert tuple(t_cache) == tuple(j_cache.spec)
    assert tuple(tg.serving_shardings(sizes, tcfg)) == tuple(
        jg.serving_shardings(jmesh, jcfg).spec)


# -- the launch --


def _first_parted_on_a_near_tie(got, want, params, prompt, cfg, key_seed, knobs):
    """Each row's first parted token sits on a named near-tie of that step's
    one-key draw (the rows agree before it; after it they may part)."""
    s = prompt.shape[1]
    assert (got[:, :s] == want[:, :s]).all()
    for r in np.flatnonzero((got != want).any(axis=1)):
        t = int(np.flatnonzero(got[r] != want[r])[0])
        logits = tt.llama_forward(params, torch.from_numpy(got[r:r + 1, :t]).long(), cfg)[0, -1]
        key = tr.fold_in(tr.prng_key(key_seed)[None], t - s)[0]
        noise = tr.gumbel(key[None], got.shape[0] * cfg.vocab_size).reshape(
            got.shape[0], cfg.vocab_size)[r]
        x = logits.float() / torch.tensor(knobs["temperature"])
        kth = torch.topk(x, knobs["top_k"]).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x) + noise
        top2 = torch.topk(x, 2).values
        assert float(top2[0] - top2[1]) <= 1e-5, (r, t, got[r, t], want[r, t])


@pytest.mark.parametrize("leg", ["greedy", "eos", "beam"])
def test_sharded_decode_matches_jax_and_one_process(run, jax_runs, one_process, leg):
    got = run[leg]
    np.testing.assert_array_equal(got, jax_runs[f"mesh_{leg}"])
    np.testing.assert_array_equal(got, jax_runs[leg])
    np.testing.assert_array_equal(got, one_process[leg])
    if leg == "beam":
        np.testing.assert_allclose(run["beam_scores"], jax_runs["mesh_beam_scores"], rtol=1e-4)
        np.testing.assert_allclose(run["beam_scores"], one_process["beam_scores"], rtol=1e-4)
    if leg == "eos":  # a row that emitted eos keeps emitting it
        for row in got[:, -NEW:]:
            hits = np.flatnonzero(row == 5)
            if hits.size:
                assert (row[hits[0]:] == 5).all()


def test_sharded_decode_from_other_placements(run, jax_runs):
    """Greedy from the ``Accelerator``'s FSDP placement (the layer axis
    over dp_shard, gathered per layer on use) and under tp 4, where the 2
    kv heads do not divide: the cache stays whole, as JAX places it."""
    assert "dp_shard" in run["fsdp_layer_specs"], run["fsdp_layer_specs"]
    np.testing.assert_array_equal(run["greedy_fsdp"], jax_runs["greedy"])
    assert run["tp4_cache_heads"] == (False, 2)
    np.testing.assert_array_equal(run["greedy_tp4"], jax_runs["mesh_greedy_tp4"])
    np.testing.assert_array_equal(run["greedy_tp4"], jax_runs["greedy"])


def test_moe_decode_under_ep_and_tp_matches_jax(run, jax_runs, one_process):
    assert run["moe_wi_block"] == [2, 2, 32, jt.LlamaConfig(**MOE_CFG).hidden_dim // 2]
    np.testing.assert_array_equal(run["moe_greedy"], jax_runs["mesh_moe_greedy"])
    np.testing.assert_array_equal(run["moe_greedy"], jax_runs["moe_greedy"])
    np.testing.assert_array_equal(run["moe_greedy"], one_process["moe_greedy"])


def test_sampled_decode_draws_jax_tokens(run, jax_runs, inputs):
    params = params_from_numpy(inputs["params"], device="cpu")
    _first_parted_on_a_near_tie(run["sampled"], jax_runs["sampled"], params, inputs["prompt"],
                                tt.LlamaConfig(**CFG), 7, {"temperature": 0.7, "top_k": 8})


def test_param_bytes_are_the_ranks_blocks(run, inputs):
    sizes = {"dp_shard": 2, "tp": 2}
    specs = infer_param_specs(inputs["params"], sizes, None, tt.llama_shard_rules())
    whole = sum(x.nbytes for x in jax.tree_util.tree_leaves(inputs["params"]))
    for coords, got in zip(run["coords"], run["param_bytes"]):
        want = sum(local_shard(x, s, sizes, coords).nbytes for x, s in zip(
            jax.tree_util.tree_leaves(inputs["params"]),
            jax.tree_util.tree_leaves(specs, is_leaf=lambda t: isinstance(t, tuple))))
        assert got == want, (coords, got, want)
        assert got < 0.55 * whole


@pytest.mark.parametrize("mesh", ["dp_replicate2_tp2", "dp_shard2_tp2"])
def test_sharded_engine_matches_jax_and_one_process(run, jax_runs, one_process, mesh):
    got = run[f"engine_{mesh}"]
    assert got["outputs"] == jax_runs["engine"]
    assert got["outputs"] == one_process["engine"]["outputs"]
    assert got["stats"] == one_process["engine"]["stats"]
    whole = one_process["engine"]["pool_bytes"]
    assert got["pool_bytes"] == [whole // 2] * 4


def test_planted_faults_fail_their_bars(run, jax_runs):
    assert not np.array_equal(run["fault_no_wo_sum"], jax_runs["greedy"])
    assert run["fault_pool_heads"] != jax_runs["engine"]


def _jax_train(params, batches, loss_fn, rules):
    _reset()
    try:
        acc = JAccelerator(parallelism_config=JParallelismConfig(dp_shard_size=2, tp_size=2))
        p, opt = acc.prepare(jax.tree_util.tree_map(np.array, params),
                             optax.adamw(ms.MESH_LR), shard_rules=rules)
        step = acc.prepare_train_step(lambda q, b: loss_fn(q, b, acc.mesh),
                                      compute_grad_norm=True)
        state, losses, norms = opt.opt_state, [], []
        for k in range(TRAIN_STEPS):
            p, state, m = step(p, state, {n: b[k] for n, b in batches.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        specs = {n: acc.param_specs["layers"][n]["kernel"] for n in ("wq", "wo")}
        return losses, norms, _flat(p), specs
    finally:
        _reset()


@pytest.mark.parametrize("model", ["llama", "bert"])
def test_training_through_prepare_shard_rules_matches_jax(run, inputs, model):
    """BERT's key bias gets an exactly zero gradient (softmax ignores a
    constant added to a row's scores), so AdamW's step there is rounding
    noise on both sides: it is held to the most the steps can move it,
    ``steps · lr``, as ``tests/test_torch_train.py`` holds it."""
    if model == "llama":
        cfg = jt.LlamaConfig.tiny()
        want = _jax_train(inputs["llama_params"], inputs["llama_batches"],
                          lambda p, b, mesh: jt.llama_loss(p, b, cfg, mesh=mesh),
                          jt.llama_shard_rules())
        got, got_params = run["llama_shard_rules"], run["llama_params"]
    else:
        cfg = jt.BertConfig.tiny()
        want = _jax_train(inputs["bert_params"], inputs["bert_batches"],
                          lambda p, b, mesh: jt.bert_loss(p, b, cfg), jt.bert_shard_rules())
        got, got_params = run["bert_shard_rules"], run["bert_params"]
        assert got["specs"] == {"wq": "PartitionSpec('dp_shard', None, 'tp')",
                                "wo": "PartitionSpec('dp_shard', 'tp')"}, got["specs"]
    losses, norms, params, specs = want
    assert tuple(specs["wq"]) == ("dp_shard", None, "tp"), specs
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)
    assert sorted(got_params) == sorted(params)
    for path, value in got_params.items():
        if path == "layers/wk/bias":
            bound = TRAIN_STEPS * ms.MESH_LR * (1 + 1e-5)
            assert np.abs(value).max() <= bound and np.abs(params[path]).max() <= bound
            continue
        err = np.linalg.norm(value - params[path]) / max(np.linalg.norm(params[path]), 1e-30)
        assert err <= 2e-5, (path, err)
