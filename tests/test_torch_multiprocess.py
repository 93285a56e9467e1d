"""The port's multi-process scenarios over ``gloo`` on the CPU, at 1, 2 and
3 processes: the JAX package's ``topology``, ``ops``, ``dataloader``,
``dispatcher``, ``dispatcher_ragged`` and ``training`` scenarios with their
assertions, and ``rng_sync`` (a prepared loader's ``rng_types`` give every
rank rank 0's host streams at each epoch) (:mod:`accelerate_tpu_torch.test_utils.scripts.
multihost_script`), each process count launched once for the module.

The ``training`` scenario's loss trajectory (data-parallel SGD, global
batch 8) at 1 and 2 processes is held to the JAX package's
``check_training``, run here in the test process on one device, within
1e-5 relative (f32, the batch sums in another order). The 2-process
launch also runs ``zoo_train``: tiny ResNet (``sgd(0.1, momentum=0.9)``,
``resnet_shard_rules``) and tiny T5 (``adam(1e-3)``, ``t5_shard_rules``,
labels with ``-100`` at a different count in each row) for 2 steps under
dp_replicate 2 and dp_shard 2, held to the JAX package's ``Accelerator``
on 2 virtual devices: losses and gradient norms within 1e-5 relative,
final params within 1e-5 relative L2 per leaf (f32, other sums). The index math
each process's loader runs (``BatchSamplerShard``,
``IterableDatasetShard``) is held to the JAX package's in this process,
index for index, over a table of lengths, batch sizes and shard counts.
"""

import itertools
import json
import pickle

import jax
import numpy as np
import optax
import pytest

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import data_loader as jdl
from accelerate_tpu.models import resnet as jresnet
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.state import PartialState as JPartialState
from accelerate_tpu.test_utils.scripts.multihost_script import check_training as j_check_training
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.test_utils.scripts import multihost_script as ms
from accelerate_tpu_torch.test_utils.testing import execute_multiprocess

SCRIPT = ["-m", "accelerate_tpu_torch.test_utils.scripts.multihost_script"]
SCENARIOS = "topology,ops,dataloader,dispatcher,dispatcher_ragged,rng_sync,training"


def _path(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def _zoo_inputs() -> dict:
    """Params from the JAX initializers (numpy) and 2 global batches of 4 rows
    a model, from seeded numpy."""
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    t5 = jt5.T5Config.tiny()
    labels = rng.integers(1, t5.vocab_size, (ms.ZOO_STEPS, 4, 8)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -100
    return {
        "resnet": {
            "params": jax.tree_util.tree_map(np.asarray, jresnet.init_resnet(
                jresnet.ResNetConfig.tiny(), key)),
            "batches": {"pixels": rng.normal(size=(ms.ZOO_STEPS, 4, 16, 16, 3)).astype(np.float32),
                        "labels": rng.integers(0, 4, (ms.ZOO_STEPS, 4)).astype(np.int32)}},
        "t5": {
            "params": jax.tree_util.tree_map(np.asarray, jt5.init_t5(t5, key)),
            "batches": {"input_ids": rng.integers(1, t5.vocab_size, (ms.ZOO_STEPS, 4, 16)
                                                  ).astype(np.int32),
                        "decoder_input_ids": rng.integers(1, t5.vocab_size, (ms.ZOO_STEPS, 4, 8)
                                                          ).astype(np.int32),
                        "labels": labels}},
    }


def _jax_zoo_leg(model, inputs, pc_kwargs):
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    try:
        if model == "resnet":
            cfg, rules, tx = jresnet.ResNetConfig.tiny(), jresnet.resnet_shard_rules(), optax.sgd(
                0.1, momentum=0.9)
            loss_fn = lambda p, b: jresnet.resnet_loss(p, b, cfg)  # noqa: E731
        else:
            cfg, rules, tx = jt5.T5Config.tiny(), jt5.t5_shard_rules(), optax.adam(1e-3)
            loss_fn = lambda p, b: jt5.t5_loss(p, b, cfg)  # noqa: E731
        acc = JAccelerator(parallelism_config=JParallelismConfig(**pc_kwargs), shard_rules=rules)
        params, opt = acc.prepare(jax.tree_util.tree_map(np.array, inputs["params"]), tx)
        step = acc.prepare_train_step(loss_fn, opt, compute_grad_norm=True)
        state, losses, norms = opt.opt_state, [], []
        for k in range(ms.ZOO_STEPS):
            params, state, m = step(params, state, {n: b[k] for n, b in inputs["batches"].items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        flat = {_path(p): np.asarray(x)
                for p, x in jax.tree_util.tree_flatten_with_path(params)[0]}
        return losses, norms, flat
    finally:
        for cls in (JAcceleratorState, JGradientState, JPartialState):
            cls._reset_state()


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """``launch(n)``: the outputs and directory of the module's one launch
    of ``n`` processes."""
    runs = {}

    def run(n):
        if n not in runs:
            tmp = tmp_path_factory.mktemp(f"np{n}")
            scenarios = "training" if n == 1 else SCENARIOS
            if n == 2:
                with open(tmp / "zoo_inputs.pkl", "wb") as f:
                    pickle.dump(_zoo_inputs(), f)
                scenarios += ",zoo_train"
            outs = execute_multiprocess(SCRIPT + ["--scenario", scenarios, "--tmpdir", str(tmp)],
                                        num_processes=n, timeout=120)
            runs[n] = (outs, tmp)
        return runs[n]

    return run


@pytest.fixture(scope="module")
def jax_losses(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_training")
    for cls in (JAcceleratorState, JGradientState, JPartialState):
        cls._reset_state()
    try:
        acc = JAccelerator(mixed_precision="no", rng_seed=0,
                           parallelism_config=JParallelismConfig())
        j_check_training(acc, str(tmp))
    finally:
        for cls in (JAcceleratorState, JGradientState, JPartialState):
            cls._reset_state()
    with open(tmp / "losses_np1.json") as f:
        return json.load(f)


@pytest.mark.parametrize("n", [2, 3])
def test_scenarios_pass(launch, n):
    outs, _ = launch(n)
    assert len(outs) == n
    for i, out in enumerate(outs):
        for scenario in SCENARIOS.split(","):
            assert f"[proc {i}] scenario {scenario}: OK" in out, out[-2000:]
        assert f"ALL OK proc={i}/{n}" in out, out[-2000:]


@pytest.mark.parametrize("n", [1, 2])
def test_training_trajectory_matches_jax(launch, jax_losses, n):
    _, tmp = launch(n)
    with open(tmp / f"losses_np{n}.json") as f:
        losses = json.load(f)
    assert len(losses) == len(jax_losses) == 12
    assert losses == pytest.approx(jax_losses, rel=1e-5)


SHARD_CASES = list(itertools.product((7, 16, 21), (2, 4), (2, 3), (False, True), (False, True),
                                     (False, True)))


@pytest.mark.parametrize("n,bs,shards,split,even,drop", SHARD_CASES)
def test_batch_sampler_shard_matches_jax(n, bs, shards, split, even, drop):
    if split and bs % shards:
        for mod in (jdl, tdl):
            with pytest.raises(ValueError):
                mod.BatchSamplerShard(mod.BatchSampler(mod.SequentialSampler(n), bs, drop),
                                      shards, 0, split_batches=True)
        return
    for index in range(shards):
        got, want = (
            mod.BatchSamplerShard(mod.BatchSampler(mod.SequentialSampler(n), bs, drop), shards,
                                  index, split_batches=split, even_batches=even)
            for mod in (tdl, jdl))
        assert list(got) == list(want) and len(got) == len(want), (index, list(got), list(want))


@pytest.mark.parametrize("n,bs,shards,even,drop", sorted(
    {(n, bs, shards, even, drop) for n, bs, shards, _, even, drop in SHARD_CASES}))
def test_iterable_dataset_shard_matches_jax(n, bs, shards, even, drop):
    for index in range(shards):
        got, want = (list(mod.IterableDatasetShard(range(n), bs, shards, index, drop_last=drop,
                                                   even_batches=even))
                     for mod in (tdl, jdl))
        assert got == want, (index, got, want)


@pytest.mark.parametrize("model,mesh_name,pc_kwargs", ms.ZOO_LEGS)
def test_zoo_steps_under_dp_and_fsdp_match_jax(launch, model, mesh_name, pc_kwargs):
    _, tmp = launch(2)
    with open(tmp / "zoo_inputs.pkl", "rb") as f:
        inputs = pickle.load(f)
    with open(tmp / "zoo_results.pkl", "rb") as f:
        got = pickle.load(f)[(model, mesh_name)]
    losses, norms, params = _jax_zoo_leg(model, inputs[model], pc_kwargs)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)
    assert sorted(got["params"]) == sorted(params)
    for path, want in params.items():
        err = np.linalg.norm(got["params"][path] - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-5, (path, err)
