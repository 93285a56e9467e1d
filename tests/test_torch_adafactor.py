"""The port's ``adafactor``, ``clip_by_global_norm`` and ``chain`` against
optax 0.2.6 on the CPU: the same numpy params and gradients (from a seed)
go through ``optax.adafactor`` / ``optax.chain`` and through the port's
optimizer for 5 steps.

Leaves: stacked ``[L, 256, 256]`` (tied largest dims: factored over dims 1
and 2 as ``np.argsort`` orders them) and ``[L, 256, 128]`` (untied), a
``[300, 128]`` matrix, a ``[L, 100, 64]`` leaf and a ``[L, 64]`` norm
(second-largest dim under 128: not factored) and a 1-D leaf. The gradients'
scales differ by up to 10**3 between leaves and steps.

Tolerances. f32: each step's update (optax's ``updates``, the port's
before it is added) within 1e-6 of the leaf's largest update: the two
differ in the order of f32 sums and in ``x ** -0.5`` against XLA's
lowering of it, a few f32 ulps. The params after each step within 1e-6
relative: both round ``p + u`` in f32. bf16: optax rounds at every op to
bf16 and so does the port, but XLA's CPU backend may keep a fused chain of
ops in f32 (excess precision), so a value near a rounding boundary can land
one bf16 step away: every update element within one bf16 ulp of its own
magnitude (2**-8 relative), every param within one bf16 ulp, and at least
99 % of each leaf's param elements bitwise equal. The port takes every
power and root in f32 and rounds once, as XLA does (torch's bf16 CPU
kernels for them are an ulp off in ~3 % of elements). Measured on this
suite: f32 updates within 5.8e-7 of the leaf's largest; bf16 updates and
params bitwise equal in every case.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu_torch.optimizer import (
    Adafactor,
    AcceleratedOptimizer,
    _factored_dims,
    adafactor,
    adamw,
    chain,
    clip_by_global_norm,
    linear_schedule,
)

L = 3
SHAPES = {"tied": (L, 256, 256), "untied": (L, 256, 128), "mat": (300, 128),
          "small": (L, 100, 64), "norm": (L, 64), "vec": (64,)}
STEPS = 5
LR = 1e-2
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0 ** -8


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 0)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, what, dtype):
    got, want = _f32(got), _f32(want)
    if dtype == "f32":
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-6, f"{what}: rel err {err}"
        return
    assert (np.abs(got - want) <= BF16_ULP * np.abs(want)).all(), f"{what}: past one bf16 ulp"
    same = (got == want).mean()
    assert same >= 0.99, f"{what}: {same:.4f} bitwise"


def _run_adafactor(dtype, kwargs, monkeypatch, learning_rate=LR):
    """5 steps on both sides; asserts each step's updates and params."""
    jdt, tdt = DTYPES[dtype]
    p0, grads = _data()
    jp = {k: jnp.asarray(v, jdt) for k, v in p0.items()}
    tx = optax.adafactor(learning_rate, **kwargs)
    st = tx.init(jp)
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p0.items()}
    opt = AcceleratedOptimizer(adafactor(learning_rate, **{
        k: (torch.float32 if k == "dtype_momentum" else v) for k, v in kwargs.items()}))
    opt.init(tp)
    seen = []
    real = Adafactor._update
    monkeypatch.setattr(Adafactor, "_update",
                        lambda self, p, g, group: seen.append(real(self, p, g, group)) or seen[-1])
    for step, g in enumerate(grads):
        up, st = tx.update({k: jnp.asarray(v, jdt) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        seen.clear()
        opt.step({k: torch.from_numpy(v).to(tdt) for k, v in g.items()}, tp)
        for k, ut in zip(tp, seen):  # the port's leaves in insertion order
            u = up[k]
            assert ut.dtype == {"float32": torch.float32,
                                "bfloat16": torch.bfloat16}[str(np.asarray(u).dtype)]
            _close(ut, u, f"step {step} update {k}", dtype)
            _close(tp[k], jp[k], f"step {step} param {k}", dtype)
            assert tp[k].dtype == tdt
    return opt


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["defaults", "momentum_decay", "unfactored_no_clip",
                                  "no_lr_scale"])
def test_adafactor_matches_optax(dtype, case, monkeypatch):
    kwargs = {"defaults": {},
              "momentum_decay": dict(momentum=0.9, weight_decay_rate=1e-3),
              "unfactored_no_clip": dict(factored=False, clipping_threshold=None, decay_offset=-2),
              "no_lr_scale": dict(multiply_by_parameter_scale=False, min_dim_size_to_factor=64,
                                  decay_rate=0.5)}[case]
    if case == "momentum_decay":
        kwargs["dtype_momentum"] = jnp.float32
    _run_adafactor(dtype, kwargs, monkeypatch)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adafactor_schedule_matches_optax(dtype, monkeypatch):
    """A ``step -> lr`` schedule, read at the count of updates taken."""
    opt = _run_adafactor(dtype, {}, monkeypatch, learning_rate=linear_schedule(1e-2, 1e-3, 4))
    assert opt.step_count == STEPS


def test_factored_dims_and_state_dtypes_follow_optax():
    """The dims optax factors, and the state in the param's dtype."""
    for shape in [(36, 1280, 1280), (36, 1280, 3584), (36, 3584, 1280), (50257, 1280),
                  (1280, 50257), (36, 1280), (1280,), *SHAPES.values()]:
        want = optax._src.factorized._factored_dims(shape, True, 128)
        assert _factored_dims(shape, True, 128) == want, shape
    p = torch.zeros(36, 1280, 1280, dtype=torch.bfloat16)
    opt = Adafactor([p], lr=1e-4)
    opt.step(grads=[torch.ones_like(p)])
    state = opt.state[p]
    assert state["v_row"].shape == (36, 1280) and state["v_col"].shape == (36, 1280)
    assert state["v_row"].dtype == state["v_col"].dtype == torch.bfloat16
    jstate = optax.adafactor(1e-4).init(jnp.zeros((36, 1280, 1280), jnp.bfloat16))
    assert jstate[0].v_row.shape == state["v_row"].shape


def test_bf16_params_with_f32_grads_match_optax(monkeypatch):
    """bf16 params stepped on f32 gradients (the JAX package's precision
    policy under ``mixed_precision="bf16"``): the factored statistics are
    bf16 state, the update is f32, and ``p + u`` rounds to bf16."""
    p0, grads = _data(1)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p0.items()}
    tx = optax.adafactor(LR)
    st = tx.init(jp)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p0.items()}
    opt = Adafactor(list(tp.values()), lr=LR)
    for step, g in enumerate(grads):
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        opt.step(grads=[torch.from_numpy(g[k]) for k in tp])
        for k in tp:
            assert np.asarray(up[k]).dtype == np.float32
            _close(tp[k], jp[k], f"step {step} param {k}", "bf16")
            assert tp[k].dtype == torch.bfloat16


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("inner", ["adafactor", "adamw"])
def test_chain_clip_by_global_norm_matches_optax(max_norm, inner):
    """``chain(clip_by_global_norm(max_norm), tx)``: with a small bar every
    step clips (the gradients' norm is ~1-1000), with a large one none
    does. Each leaf's 5-step update (params after less before) within 2e-5
    relative L2, f32: both sides round ``p + u`` to f32 at every step, an
    error of half an ulp of a param near 0.1 (~4e-9) against steps of
    ~5e-4; AdamW's update also differs from optax's by where the two put
    eps and the decay (measured 8.6e-6; adafactor 2.5e-6). Dropping the
    clip moves the clipped case's updates by 0.36."""
    p0, grads = _data(2)
    jtx = optax.chain(optax.clip_by_global_norm(max_norm),
                      optax.adafactor(LR) if inner == "adafactor" else optax.adamw(1e-3))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = jtx.init(jp)
    factory = adafactor(LR) if inner == "adafactor" else adamw(1e-3)
    opt = AcceleratedOptimizer(chain(clip_by_global_norm(max_norm), factory))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt.init(tp)
    for g in grads:
        up, st = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()}, tp)
    for k in tp:
        t_upd, j_upd = tp[k].numpy() - p0[k], np.asarray(jp[k]) - p0[k]
        rel = np.linalg.norm(t_upd - j_upd) / np.linalg.norm(j_upd)
        assert rel <= 2e-5, f"{k}: update rel L2 err {rel}"


def test_clip_by_global_norm_alone_matches_optax():
    _, grads = _data(3)
    for max_norm in (0.5, 1e3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            {k: jnp.asarray(v) for k, v in grads[0].items()}, optax.EmptyState())
        got = clip_by_global_norm(max_norm)([torch.from_numpy(v) for v in grads[0].values()])
        for k, t in zip(grads[0], got):
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)


def test_chain_rejects_a_misplaced_factory():
    with pytest.raises(ValueError, match="optimizer factory"):
        chain(adafactor(LR), clip_by_global_norm(1.0))
    with pytest.raises(ValueError, match="optimizer factory"):
        chain(clip_by_global_norm(1.0))
