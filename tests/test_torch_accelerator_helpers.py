"""The port's small eager helpers of the ``Accelerator`` and the random
streams a checkpoint carries, against the JAX package where it has them.

- ``free_memory``, ``join_uneven_inputs``, ``unwrap_model``, the kwargs
  handlers ``CheckpointConfig`` and ``AutocastConfig`` (accepted now),
  ``project_dir`` and ``get_state_dict``;
- ``autocast``: a step built inside ``autocast(AutocastConfig(enabled=
  False))`` under bf16 computes in f32, bitwise the step of
  ``mixed_precision="no"``; a step built before keeps bf16;
- ``AcceleratedOptimizer.update`` against ``optax.adamw(...).update``:
  params and state untouched, ``params + updates`` exactly the port's own
  step, and the updates within 2 f32 ulps of the largest param plus 1e-6
  of the largest update of optax's: the port's updates are the difference
  of two f32 params, exact to the params' last bit (about 1e-7 here, 1e-5
  of an update of 1e-2 on params near 1), and the two AdamWs order their
  f32 operations differently;
- ``capture_rng_states``: the JAX package's pickle restores in the port
  and the port's in the JAX package (the streams continue alike, the
  global key is the same ``PRNGKey(seed)``), and neither pickle holds an
  object of ``jax`` or ``ml_dtypes``.
"""

import pickle
import random

import jax
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.utils import random as jrandom
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.accelerator import set_seed
from accelerate_tpu_torch.optimizer import adamw
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import random as trandom
from accelerate_tpu_torch.utils.dataclasses import AutocastConfig, CheckpointConfig

UPDATE_RTOL, PARAM_ULPS = 1e-6, 2


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}


def _loss(p, x):
    return ((x @ p["w"] + p["b"]) ** 2).mean()


def test_free_memory_clears_what_save_state_covers():
    acc = Accelerator(cpu=True)
    params, opt = acc.prepare(_params(), adamw(1e-3))
    sched = acc.prepare_scheduler(lambda s: 1.0)
    assert acc._models and acc._optimizers and acc._schedulers
    marker = object()
    assert acc.free_memory(marker) == (marker,)
    assert not (acc._models or acc._optimizers or acc._schedulers or acc._dataloaders)
    assert acc.sharding_plan is None and sched is not None


def test_join_uneven_inputs_and_unwrap_model():
    acc = Accelerator(cpu=True)
    params = acc.prepare(_params())
    with acc.join_uneven_inputs([params], even_batches=True):
        pass
    assert acc.unwrap_model(params) is params


def test_handlers_and_project_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("ACCELERATE_ASYNC_CHECKPOINT", "1")
    assert CheckpointConfig().async_save is True
    acc = Accelerator(cpu=True, project_dir=str(tmp_path),
                      kwargs_handlers=[CheckpointConfig(max_in_flight=2),
                                       AutocastConfig(enabled=False)])
    assert acc.checkpoint_config.max_in_flight == 2 and acc.checkpoint_config.async_save
    assert acc.autocast_handler.enabled is False
    assert acc.project_dir == acc.project_configuration.logging_dir == str(tmp_path)
    with pytest.raises(ValueError, match="both"):
        Accelerator(cpu=True, checkpoint_config=CheckpointConfig(),
                    kwargs_handlers=[CheckpointConfig()])
    with pytest.raises(ValueError):
        CheckpointConfig(max_in_flight=0)


def test_get_state_dict_gives_cpu_tensors():
    acc = Accelerator(cpu=True)
    params = acc.prepare(_params())
    state = acc.get_state_dict(params)
    assert all(not t.requires_grad and t.device.type == "cpu" for t in state.values())
    assert torch.equal(state["w"], params["w"].detach())
    with torch.no_grad():
        params["w"].add_(1.0)
    assert not torch.equal(state["w"], params["w"].detach())  # a copy, not a view


def _one_step_loss(acc, params, opt, x, build=None):
    step = (build or acc.prepare_train_step)(_loss, opt)
    _, _, m = step(params, opt.opt_state, x)
    return m["loss"]


def test_autocast_builds_full_precision_steps():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32))

    def run(precision, inside=None, handler_ctx=False):
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        handlers = [AutocastConfig(enabled=False)] if handler_ctx else None
        acc = Accelerator(cpu=True, mixed_precision=precision, kwargs_handlers=handlers)
        params, opt = acc.prepare(_params(), adamw(1e-3))
        if inside is None and not handler_ctx:
            return float(_one_step_loss(acc, params, opt, x))
        with acc.autocast(inside):
            step = acc.prepare_train_step(_loss, opt)
        _, _, m = step(params, opt.opt_state, x)
        return float(m["loss"])

    f32 = run("no")
    bf16 = run("bf16")
    assert bf16 != f32
    assert run("bf16", AutocastConfig(enabled=False)) == f32
    assert run("bf16", handler_ctx=True) == f32
    assert run("bf16", AutocastConfig(enabled=True)) == bf16


def test_optimizer_update_matches_optax():
    acc = Accelerator(cpu=True)
    params, opt = acc.prepare(_params(), adamw(1e-2))
    step = acc.prepare_train_step(_loss, opt)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(16, 8)).astype(np.float32))
    for _ in range(2):  # state that is not the initial one
        step(params, opt.opt_state, x)
    grads = {k: torch.from_numpy(np.random.default_rng(3 + i).normal(size=v.shape)
                                 .astype(np.float32)) for i, (k, v) in enumerate(params.items())}
    before = {k: v.detach().clone() for k, v in params.items()}
    state_before = {id(p): {k: v.clone() for k, v in s.items()}
                    for p, s in opt.opt_state.items()}
    updates, new_state = opt.update(grads, opt.opt_state, params)
    for k in params:
        assert torch.equal(params[k], before[k])
    for p, s in opt.opt_state.items():
        assert all(torch.equal(v, state_before[id(p)][k]) for k, v in s.items())
    assert set(new_state) == {"state", "param_groups"}

    # optax from the same state: its moments are the port's, its count 2
    jparams = {k: np.asarray(v.detach()) for k, v in before.items()}
    tx = optax.adamw(1e-2)
    jstate = tx.init(jparams)
    st = {k: opt.opt_state[params[k]] for k in params}
    adam = jstate[0]._replace(count=np.int32(2),
                              mu={k: st[k]["exp_avg"].numpy() for k in params},
                              nu={k: st[k]["exp_avg_sq"].numpy() for k in params})
    jupdates, _ = tx.update({k: v.numpy() for k, v in grads.items()}, (adam, *jstate[1:]),
                            jparams)
    for k in params:
        ref = np.asarray(jupdates[k])
        bar = (PARAM_ULPS * np.spacing(np.abs(jparams[k]).max())
               + UPDATE_RTOL * np.abs(ref).max())
        assert np.abs(updates[k].numpy() - ref).max() <= bar, k
    # applied, the updates are the port's own step
    for k, p in params.items():
        p.grad = grads[k]
    opt.step(grads=grads, params=params)
    for k in params:
        assert torch.equal(before[k] + updates[k], params[k].detach()), k


def _no_jax_objects(obj) -> bool:
    """True when nothing in ``obj`` (walked through containers) comes from
    ``jax`` or ``ml_dtypes``."""
    if isinstance(obj, dict):
        return all(_no_jax_objects(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return all(_no_jax_objects(v) for v in obj)
    mod = type(obj).__module__ or ""
    dtype_mod = type(getattr(obj, "dtype", None)).__module__ or ""
    return not any(m.startswith(("jax", "jaxlib", "ml_dtypes")) for m in (mod, dtype_mod))


def test_rng_states_cross_the_packages():
    jrandom.set_seed(7)
    jpickle = pickle.dumps(jrandom.capture_rng_states())
    j_next = (random.random(), float(np.random.rand()), float(torch.rand(())))
    set_seed(99)
    loaded = pickle.loads(jpickle)
    assert _no_jax_objects(loaded)
    trandom.restore_rng_states(loaded)
    assert (random.random(), float(np.random.rand()), float(torch.rand(()))) == j_next
    np.testing.assert_array_equal(trandom.get_rng_key(), np.asarray(jax.random.PRNGKey(7)))

    set_seed(11)
    tpickle = pickle.dumps(trandom.capture_rng_states())
    t_next = (random.random(), float(np.random.rand()), float(torch.rand(())))
    assert _no_jax_objects(pickle.loads(tpickle))
    jrandom.set_seed(0)
    jrandom.restore_rng_states(pickle.loads(tpickle))
    assert (random.random(), float(np.random.rand()), float(torch.rand(()))) == t_next
    np.testing.assert_array_equal(np.asarray(jrandom.get_rng_key()),
                                  np.asarray(jax.random.PRNGKey(11)))
