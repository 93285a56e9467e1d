"""The port's checkpoints against the JAX package's, on the CPU.

- Model files both ways: a JAX ``save_state`` of tiny Llama and tiny BERT
  (``init_*(..., PRNGKey(0))``, Llama's final norm in bf16) loads into the
  port's prepared params bitwise; the port's ``model.npz`` loads into the
  JAX package bitwise. The JAX package's own loader cannot read a bf16 leaf
  of an npz (numpy has no cast from ``|V2`` to ``ml_dtypes.bfloat16``, for
  its own files too), so that direction runs on f32 params, and the bf16
  leaf is held to the bytes the JAX package's ``np.savez`` writes for it.
- A mid-epoch resume (loader position, an lr schedule and an
  ``AcceleratedScheduler``, the host random streams, an accumulation
  window left half full, under fp16 the loss scale) gives the losses of
  the uninterrupted run bitwise; in f32 the uninterrupted run is also held
  to the JAX package's (``optax.adamw`` over ``MultiSteps``, the same
  batches and the same host draws) within 1e-5 relative, the f32 bar of
  ``tests/test_torch_train.py`` (the two differ in the order of their
  sums).
- ``tests/test_accelerator.py``'s checkpoint cases (triggers, save/load,
  ``save_model`` safetensors, rotation, custom objects) and
  ``tests/test_utils_other.py``'s ``save``/``load`` cases, on the port.
- Planted faults that fail on the port as on the JAX package: a torn npz
  and a manifest size mismatch raise ``CheckpointCorruptError`` on both,
  the JAX checkpoint and the port's alike; a changed ``dp_replicate``
  width raises ``CheckpointTopologyError`` without ``elastic``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import DataLoader as JDataLoader
from accelerate_tpu import checkpointing as jck
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu_torch import Accelerator, BertConfig, DataLoader, LlamaConfig
from accelerate_tpu_torch import checkpointing as ck
from accelerate_tpu_torch import init_bert, init_llama
from accelerate_tpu_torch.optimizer import adamw, linear_schedule
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.sharded_checkpoint import flatten_with_path
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import other
from accelerate_tpu_torch.utils.dataclasses import GradScalerConfig, ProjectConfiguration
from accelerate_tpu_torch.utils.synthetic import DictDataset

F32_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_state():
    def reset():
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        JAcceleratorState._reset_state(reset_partial_state=True)
        JGradientState._reset_state()

    reset()
    yield
    reset()


def _jflat(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


_MODELS = {
    "llama": (jt.init_llama, jt.LlamaConfig.tiny, init_llama, LlamaConfig.tiny, "final_norm"),
    "bert": (jt.init_bert, jt.BertConfig.tiny, init_bert, BertConfig.tiny, "pooler"),
}


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_jax_save_state_loads_into_port_bitwise(model, tmp_path):
    """The JAX package's ``model.npz`` (one bf16 subtree, stored as
    ``|V2``) read into the port's prepared params, in place, bitwise."""
    jinit, jcfg, tinit, tcfg, bf16_key = _MODELS[model]
    jp = dict(jinit(jcfg(), jax.random.PRNGKey(0)))
    jp[bf16_key] = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp[bf16_key])
    out = JAccelerator().save_state(str(tmp_path / "j"), params=jp)
    with np.load(os.path.join(out, "model.npz")) as f:
        assert any(f[k].dtype == np.dtype("V2") for k in f.files)
    tp = tinit(tcfg(), torch.Generator().manual_seed(1), device="cpu")
    tp[bf16_key] = {k: v.bfloat16() for k, v in tp[bf16_key].items()}
    acc = Accelerator(cpu=True)
    params = acc.prepare(tp)
    leaves = [t for _, t in flatten_with_path(params)]
    # saved on 8 virtual devices (dp_replicate 8), loaded at one process
    restored = acc.load_state(out, elastic=True)[0]
    assert [t for _, t in flatten_with_path(restored)] == leaves  # the same tensors
    want = _jflat(jp)
    got = dict(flatten_with_path(params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert (got[k].dtype == torch.bfloat16) == (v.dtype == jnp.bfloat16), k
        np.testing.assert_array_equal(_as_f32(got[k]), _as_f32(v), err_msg=k)


@pytest.mark.parametrize("model", sorted(_MODELS))
def test_port_model_npz_loads_into_jax_bitwise(model, tmp_path):
    """The port's ``model.npz`` of f32 params into the JAX package's
    ``load_state`` bitwise; a bf16 leaf's ``|V2`` bytes equal the bytes the
    JAX package's ``np.savez`` writes for the same values."""
    jinit, jcfg, tinit, tcfg, bf16_key = _MODELS[model]
    tp = tinit(tcfg(), torch.Generator().manual_seed(3), device="cpu")
    acc = Accelerator(cpu=True)
    params = acc.prepare(tp)
    out = acc.save_state(str(tmp_path / "p"))
    template = jax.tree_util.tree_map(jnp.zeros_like, jinit(jcfg(), jax.random.PRNGKey(0)))
    restored = JAccelerator().load_state(out, params=template, elastic=True)
    got = _jflat(restored)
    for k, t in flatten_with_path(params):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], t.detach().numpy(), err_msg=k)
    bf = {k: v.bfloat16() for k, v in dict(flatten_with_path(tp[bf16_key])).items()}
    port = ck.flatten_pytree(bf)
    jax_path = tmp_path / "jax_bf16.npz"
    np.savez(jax_path, **{k: np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16))
                          for k, v in bf.items()})
    with np.load(jax_path) as f:
        for k in bf:
            assert f[k].dtype == port[k].dtype and f[k].tobytes() == port[k].tobytes(), k


# ---------------------------------------------------------- mid-epoch resume --
ROWS, BATCH, ACCUM, TOTAL, CUT = 64, 8, 2, 12, 5


def _regression():
    rng = np.random.default_rng(0)
    data = {"x": rng.normal(size=(ROWS, 4)).astype(np.float32),
            "labels": rng.normal(size=(ROWS, 2)).astype(np.float32)}
    init = {"w": rng.normal(size=(4, 2)).astype(np.float32),
            "b": np.zeros(2, np.float32)}
    return data, init


def _loss(p, b):
    return ((b["x"] @ p["w"] + p["b"] - b["labels"]) ** 2).mean()


def _noise(batch):
    """A host draw per step, so the numpy stream's position matters."""
    return dict(batch, x=batch["x"] * np.float32(1 + 0.01 * np.random.rand()))


def _port_run(precision, steps, init=None, resume=None, save=None):
    """The port's run of ``steps`` micro-steps from the start of the
    loader (or from ``resume``); saves after the last when ``save``."""
    data, params0 = _regression()
    acc = Accelerator(cpu=True, mixed_precision=precision, rng_seed=0,
                      gradient_accumulation_steps=ACCUM,
                      grad_scaler_config=GradScalerConfig(init_scale=2.0 ** 12, growth_interval=3))
    params, opt, dl = acc.prepare(init or params0, adamw(linear_schedule(1e-2, 1e-3, 8)),
                                  DataLoader(DictDataset(data), batch_size=BATCH, shuffle=True,
                                             seed=3))
    sched = acc.prepare_scheduler(AcceleratedScheduler(lambda s: 0.1 * (s + 1)))
    step = acc.prepare_train_step(_loss, opt)
    if resume is not None:
        acc.load_state(resume)
    losses, it = [], iter(dl)
    for _ in range(steps):
        batch = next(it, None)
        if batch is None:
            it = iter(dl)
            batch = next(it)
        batch = {k: v.numpy() for k, v in batch.items()}
        batch = {k: torch.from_numpy(v) for k, v in _noise(batch).items()}
        params, _, m = step(params, opt.opt_state, batch)
        with acc.accumulate():
            if acc.sync_gradients:
                sched.step()
        losses.append(float(m["loss"]))
    out = acc.save_state(save) if save else None
    return losses, out, {"lr": sched.get_last_lr(), "scale": opt.loss_scale,
                         "draw": np.random.rand(), "torch": float(torch.rand(()))}


@pytest.mark.parametrize("precision", ["no", "fp16"])
def test_mid_epoch_resume_is_bitwise(precision, tmp_path):
    """A save after 5 micro-steps (mid-epoch, mid accumulation window),
    loaded by a fresh ``Accelerator`` on zeroed params: the remaining
    losses, the scheduler, the loss scale and the next host draws are the
    uninterrupted run's, bitwise."""
    full, _, end_full = _port_run(precision, TOTAL)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    head, out, _ = _port_run(precision, CUT, save=str(tmp_path / "ck"))
    assert head == full[:CUT]
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    np.random.seed(123)
    torch.manual_seed(123)
    zeros = {"w": np.zeros((4, 2), np.float32), "b": np.zeros(2, np.float32)}
    tail, _, end_tail = _port_run(precision, TOTAL - CUT, init=zeros, resume=out)
    assert tail == full[CUT:]
    assert end_tail["lr"] == end_full["lr"]
    assert end_tail["draw"] == end_full["draw"] and end_tail["torch"] == end_full["torch"]
    if precision == "fp16":
        assert torch.equal(end_tail["scale"], end_full["scale"])


def test_uninterrupted_run_matches_jax():
    """The port's uninterrupted f32 run against the JAX package's: the same
    batches in the same order, the same host draws, ``optax.adamw`` on
    ``optax.linear_schedule`` under ``MultiSteps`` (through
    ``gradient_accumulation_steps``)."""
    full, _, _ = _port_run("no", TOTAL)
    data, params0 = _regression()
    from accelerate_tpu.parallelism_config import ParallelismConfig

    # a one-device mesh: the loader keeps its batches of 8, as the port's
    acc = JAccelerator(rng_seed=0, gradient_accumulation_steps=ACCUM,
                       parallelism_config=ParallelismConfig(dp_shard_size=1))
    params, opt, dl = acc.prepare(params0, optax.adamw(optax.linear_schedule(1e-2, 1e-3, 8)),
                                  JDataLoader(DictDataset(data), batch_size=BATCH, shuffle=True,
                                              seed=3))
    step = acc.prepare_train_step(_loss, opt)
    np.random.seed(0)
    losses, state, it = [], opt.opt_state, iter(dl)
    for _ in range(TOTAL):
        batch = next(it, None)
        if batch is None:
            it = iter(dl)
            batch = next(it)
        params, state, m = step(params, state, _noise({k: np.asarray(v)
                                                       for k, v in batch.items()}))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(full, losses, rtol=F32_RTOL)


# ------------------------------------------- the JAX package's accelerator cases --
def test_trigger_roundtrip():
    acc = Accelerator(cpu=True)
    assert acc.check_trigger() is False
    acc.set_trigger()
    assert acc.check_trigger() is True
    assert acc.check_trigger() is False


def test_save_load_state_roundtrip(tmp_path):
    acc = Accelerator(cpu=True)
    params, opt = acc.prepare({"w": torch.ones(8, 2)}, adamw(1e-2))
    step = acc.prepare_train_step(lambda p, b: (p["w"] * b).sum(), opt)
    for _ in range(3):
        step(params, opt.opt_state, torch.arange(16.0).reshape(8, 2))
    saved_w = params["w"].detach().clone()
    out = acc.save_state(str(tmp_path / "ckpt"), params=params)
    with torch.no_grad():
        params["w"].fill_(1.0)
    restored = acc.load_state(out, params=params)
    assert restored is params and torch.equal(params["w"], saved_w)
    mu = opt.opt_state[params["w"]]["exp_avg"]
    assert torch.isfinite(mu).all()


def test_save_model_safetensors(tmp_path):
    acc = Accelerator(cpu=True)
    params = {"layer": {"kernel": np.ones((8, 4), np.float32)}}
    files = acc.save_model(params, str(tmp_path / "export"))
    assert any(f.endswith(".safetensors") for f in files)
    loaded = ck.load_checkpoint_in_model({"layer": {"kernel": np.zeros((8, 4), np.float32)}},
                                         str(tmp_path / "export"))
    np.testing.assert_array_equal(loaded["layer"]["kernel"], params["layer"]["kernel"])
    # the JAX package reads the port's export (safetensors, bf16 written as f32)
    bf = {"layer": {"kernel": torch.full((8, 4), 1.5, dtype=torch.bfloat16)}}
    acc.save_model(bf, str(tmp_path / "bf16"), max_shard_size="64B")
    jloaded = jck.load_checkpoint_in_model({"layer": {"kernel": np.zeros((8, 4), np.float32)}},
                                           str(tmp_path / "bf16"))
    np.testing.assert_array_equal(np.asarray(jloaded["layer"]["kernel"]), 1.5)


def test_checkpoint_rotation(tmp_path):
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=2))
    params = {"w": np.zeros(4, np.float32)}
    for _ in range(4):
        acc.save_state(params=params)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_2", "checkpoint_3"]


def test_custom_object_checkpointing(tmp_path):
    class Counter:
        def __init__(self):
            self.n = 0

        def state_dict(self):
            return {"n": np.int64(self.n)}

        def load_state_dict(self, sd):
            self.n = int(sd["n"])

    acc = Accelerator(cpu=True)
    c = Counter()
    c.n = 7
    acc.register_for_checkpointing(c)
    out = acc.save_state(str(tmp_path / "ck"), params={"w": np.zeros(2, np.float32)})
    c.n = 0
    acc.load_state(out, params={"w": np.zeros(2, np.float32)})
    assert c.n == 7
    with pytest.raises(ValueError):
        acc.register_for_checkpointing(object())


def test_state_pre_hooks_see_resolved_dirs(tmp_path):
    acc = Accelerator(cpu=True, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True))
    seen = []
    handle = acc.register_save_state_pre_hook(lambda models, d: seen.append(("save", d)))
    acc.register_load_state_pre_hook(lambda models, d: seen.append(("load", d)))
    out = acc.save_state(params={"w": np.zeros(2, np.float32)})
    acc.load_state("latest", params={"w": np.zeros(2, np.float32)})
    handle.remove()
    acc.save_state(params={"w": np.zeros(2, np.float32)})
    assert seen == [("save", out), ("load", out)]


# -------------------------------------------------- utils.other save / load --
def test_clean_state_dict_dedups_tied():
    w = np.ones((2, 2), np.float32)
    clean = other.clean_state_dict_for_safetensors({"w": w, "tied": w, "other": np.zeros(2)})
    assert len(clean) == 2


def test_save_load_round_trip(tmp_path):
    tree = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "h": torch.arange(4, dtype=torch.float32).bfloat16()}}
    npz = str(tmp_path / "s.npz")
    other.save(tree, npz)
    back = other.load(npz)
    np.testing.assert_array_equal(back["layer/w"], tree["layer"]["w"])
    st = str(tmp_path / "s.safetensors")
    other.save(tree, st, safe_serialization=True)
    loaded = other.load(st)
    np.testing.assert_array_equal(loaded["layer/w"], tree["layer"]["w"])
    assert loaded["layer/h"].tobytes() == back["layer/h"].tobytes()
    from safetensors.numpy import load_file  # the safetensors package reads the port's file

    np.testing.assert_array_equal(load_file(st)["layer/w"], tree["layer"]["w"])


def test_save_respects_exact_path_without_npz_extension(tmp_path):
    tree = {"w": np.arange(4, dtype=np.float32)}
    path = str(tmp_path / "model.bin")
    other.save(tree, path)
    assert os.path.exists(path) and not os.path.exists(path + ".npz")
    np.testing.assert_array_equal(other.load(path)["w"], tree["w"])


# ------------------------------------------------------------ planted faults --
def _tear(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\x00" * (size - size // 2))


def _append(path):
    with open(path, "ab") as f:
        f.write(b"junk")


@pytest.mark.parametrize("fault", [_tear, _append], ids=["torn_npz", "manifest_size"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_planted_faults_fail_on_both(fault, writer, tmp_path):
    """A torn ``model.npz`` (same size, zeros over its tail) and one that
    no longer has the size its manifest records: ``CheckpointCorruptError``
    from the port's load and from the JAX package's, whichever wrote it."""
    params = {"w": np.full((32, 4), 1.0, np.float32)}
    if writer == "port":
        out = Accelerator(cpu=True).save_state(str(tmp_path / "ck"), params=params)
    else:
        out = JAccelerator().save_state(str(tmp_path / "ck"), params=params)
    fault(os.path.join(out, "model.npz"))
    with pytest.raises(ck.CheckpointCorruptError):
        Accelerator(cpu=True).load_state(out, params={"w": np.zeros((32, 4), np.float32)},
                                         elastic=True)
    with pytest.raises(jck.CheckpointCorruptError):
        JAccelerator().load_state(out, params={"w": np.zeros((32, 4), np.float32)},
                                  elastic=True)


def test_topology_change_needs_elastic(tmp_path):
    """The JAX package's save on its 8 virtual devices (dp_replicate 8)
    into the port at one process: ``CheckpointTopologyError`` naming both
    shapes unless ``elastic``."""
    out = JAccelerator().save_state(str(tmp_path / "j"), params={"w": np.ones(4, np.float32)})
    acc = Accelerator(cpu=True)
    with pytest.raises(ck.CheckpointTopologyError) as exc:
        acc.load_state(out, params={"w": np.zeros(4, np.float32)})
    assert exc.value.saved["dp_replicate"] == 8 and exc.value.current["dp_replicate"] == 1
    got = acc.load_state(out, params={"w": np.zeros(4, np.float32)}, elastic=True)
    np.testing.assert_array_equal(got["w"], 1.0)
