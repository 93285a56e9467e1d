"""The port's ResNet against ``accelerate_tpu.models.resnet`` on the CPU,
with params from the JAX ``init_resnet(PRNGKey(0))`` crossed through
``models.convert.params_from_numpy`` and images from numpy seeds.

- forward logits at ``tiny`` and ``resnet18_ish`` on sides 32, 33 and 17,
  so that XLA's asymmetric ``"SAME"`` padding shows on even and odd sides
  (stem, stride-2 convs and the max-pool): f32 within 2e-5 absolute and
  1e-5 relative (another convolution algorithm, another order of f32
  sums; measured up to 2.7e-6 on logits up to 1.8). bf16 at ``tiny``:
  within 2 bf16 steps (2^-7 relative) of the logits' largest magnitude —
  the activations round at every conv, norm and residual on both sides,
  and XLA may skip an intermediate rounding that torch makes;
- a padding of ``(k-1)//2`` on both sides (``conv2d(padding=3)``,
  ``max_pool2d(padding=1)``) keeps every shape and misses the f32 bar;
- ``resnet_loss`` and its gradients against ``jax.value_and_grad``: loss
  within 1e-6 relative, each gradient leaf within 1e-4 of its largest
  magnitude;
- 3 steps of ``sgd(0.1, momentum=0.9)`` through the port's
  ``Accelerator.prepare_train_step`` against the same steps of
  ``optax.sgd`` (``bench.py``'s config #2 step), in f32 (params within
  1e-5 of each leaf's largest magnitude) and with bf16 params (within an
  envelope set by JAX's own bf16-to-f32 distance, at that test);
- ``optax.sgd``'s roundings, fed identical gradients: bitwise in bf16,
  within an f32 fused multiply-add in f32;
- the bf16 kernel gradient of a 3×3 stride-2 conv on a 1×1 input (the
  last stage at small sides) against ``jax.grad``: the eight taps that
  meet only padding exactly zero, the centre within bf16 rounding;
- config #2's recipe on one fixed batch: ``tests/test_torch_resnet_recipe.py``
  (a file of its own, so that the test runner can spread the two);
- the ResNet-50 param count (25.56 M, as ``tests/test_models.py``) and the
  device rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.models import resnet as jr
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import resnet as tr
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import SGD, param_leaves, sgd
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.modeling import abstract_params, named_parameters

CONFIGS = ("tiny", "resnet18_ish")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in CONFIGS:
        jc, tc = getattr(jr.ResNetConfig, name)(), getattr(tr.ResNetConfig, name)()
        jp = jr.init_resnet(jc, jax.random.PRNGKey(0))
        out[name] = (jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _pixels(side, seed=0, batch=2):
    return np.random.default_rng(seed).normal(size=(batch, side, side, 3)).astype(np.float32)


def _jax_logits(jc, jp, x):
    return np.asarray(jax.jit(lambda p, x: jr.resnet_forward(p, x, jc))(jp, jnp.asarray(x)),
                      np.float32)


@pytest.mark.parametrize("side", [32, 33, 17])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(models, name, side):
    jc, tc, jp, npp = models[name]
    x = _pixels(side, seed=side)
    want = _jax_logits(jc, jp, x)
    got = tr.resnet_forward(params_from_numpy(npp, device="cpu"), torch.from_numpy(x), tc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("side", [32, 17])
def test_bf16_forward_within_envelope(models, side):
    jc, tc, jp, npp = models["tiny"]
    x = _pixels(side, seed=side)
    jp16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    want = _jax_logits(jc, jp16, x.astype(jnp.bfloat16))
    got = tr.resnet_forward(params_from_numpy(npp, device="cpu", dtype=torch.bfloat16),
                            torch.from_numpy(x).to(torch.bfloat16), tc).float().numpy()
    assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * np.abs(want).max()


def test_symmetric_padding_would_miss_the_bar(models, monkeypatch):
    jc, tc, jp, npp = models["tiny"]
    x = _pixels(32, seed=32)
    want = _jax_logits(jc, jp, x)
    assert tr.same_pads(32, 7, 2) == (2, 3) and tr.same_pads(16, 3, 2) == (0, 1)
    monkeypatch.setattr(tr, "same_pads", lambda n, k, s: ((k - 1) // 2, (k - 1) // 2))
    got = tr.resnet_forward(params_from_numpy(npp, device="cpu"), torch.from_numpy(x),
                            tc).detach().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() > 2e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("side", [32, 17])
def test_loss_and_grads_match_jax(models, side):
    jc, tc, jp, npp = models["tiny"]
    x = _pixels(side, seed=7)
    labels = np.array([1, 3], np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jr.resnet_loss(
        p, {"pixels": jnp.asarray(x), "labels": jnp.asarray(labels)}, jc)))(jp)
    tp = params_from_numpy(npp, device="cpu")
    for t in param_leaves(tp):
        t.requires_grad_(True)
    loss = tr.resnet_loss(tp, {"pixels": torch.from_numpy(x), "labels": torch.from_numpy(labels)},
                          tc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = named_parameters(jax.tree_util.tree_map(np.asarray, jg))
    got = named_parameters(tp)
    assert list(want) == list(got)
    for name, w in want.items():
        g = got[name].grad.numpy()
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


def _jax_sgd_steps(jc, jp, batch, n):
    opt = optax.sgd(0.1, momentum=0.9)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(lambda p: jr.resnet_loss(p, batch, jc))(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    state, losses = opt.init(jp), []
    for _ in range(n):
        jp, state, loss = step(jp, state)
        losses.append(float(loss))
    return jp, np.array(losses)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sgd_steps_match_optax(models, dtype):
    """``bench.py`` config #2's step (value_and_grad, ``optax.sgd(0.1,
    momentum=0.9)``, ``apply_updates``) at ``tiny``, side 32, batch 4.

    f32: losses within 1e-5 relative, params within 1e-5 of each leaf's
    largest magnitude. bf16 params and pixels: the bf16 roundings of three
    forward/backward passes compound, and JAX's own bf16 steps move
    0.07-1.7 relative L2 away from its f32 steps from the same start. So
    each leaf's 3-step change must lie within 1.5x that distance of JAX's
    bf16 change, and within 1.5x of it from JAX's f32 change (measured:
    ratios up to 1.25 and 1.23), with losses within 2e-3 relative of
    JAX's bf16 losses (measured 1.1e-3)."""
    jc, tc, jp, _ = models["tiny"]
    bf16 = dtype == "bf16"
    x = _pixels(32, seed=11, batch=4)
    labels = np.array([0, 1, 2, 3], np.int32)
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    start = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jdtype), np.float32), jp)

    def jax_steps(dt):
        return _jax_sgd_steps(jc, jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), start),
                              {"pixels": jnp.asarray(x, dt), "labels": jnp.asarray(labels)}, 3)

    jfinal, jlosses = jax_steps(jdtype)
    acc = Accelerator(cpu=True)
    tdtype = torch.bfloat16 if bf16 else torch.float32
    tparams, opt = acc.prepare(params_from_numpy(start, device="cpu", dtype=tdtype),
                               sgd(0.1, momentum=0.9))
    step = acc.prepare_train_step(lambda p, b: tr.resnet_loss(p, b, tc), opt)
    tbatch = {"pixels": torch.from_numpy(x).to(tdtype), "labels": torch.from_numpy(labels)}
    state, tlosses = opt.opt_state, []
    for _ in range(3):
        tparams, state, m = step(tparams, state, tbatch)
        tlosses.append(float(m["loss"]))
    assert tlosses[-1] < tlosses[0]

    def flat(tree):
        return {k: np.asarray(v.detach().float() if isinstance(v, torch.Tensor) else v,
                              np.float32) for k, v in named_parameters(tree).items()}

    want, got, x0 = flat(jfinal), flat(tparams), flat(start)
    if not bf16:
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, atol=1e-5 * np.abs(w).max(), rtol=0,
                                       err_msg=name)
        return
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    f32 = flat(jax_steps(jnp.float32)[0])
    for name, w in want.items():
        d_port, d_bf16, d_f32 = got[name] - x0[name], w - x0[name], f32[name] - x0[name]
        bf16_gap = np.linalg.norm(d_bf16 - d_f32)
        if bf16_gap == 0:  # a step under half an ulp of every element
            np.testing.assert_array_equal(got[name], w, err_msg=name)
            continue
        assert np.linalg.norm(d_port - d_bf16) <= 1.5 * bf16_gap, name
        assert np.linalg.norm(d_port - d_f32) <= 1.5 * bf16_gap, name


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_sgd_rounds_as_optax(dtype, nesterov):
    """Identical gradients into ``optax.sgd`` (its update jitted, as in a
    train step) and the port's :class:`SGD` for 4 steps. bf16: every param
    and momentum buffer bitwise equal — the update is rounded to bf16
    before it is added, two roundings a step. f32: within 2^-22 of each
    tensor's largest magnitude, as XLA contracts ``g + m·mu`` into one
    fused multiply-add under jit where torch rounds the product first
    (measured 2.4e-7 on values up to 4)."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(64, 48)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) * 10.0 ** -k for k in range(4)]
    opt = optax.sgd(0.05, momentum=0.9, nesterov=nesterov)
    jp = jnp.asarray(p0, dtype)
    state = opt.init(jp)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    # a copy: jnp.asarray may alias p0's buffer, which the in-place step writes
    tp = torch.from_numpy(p0.copy()).to(tdtype)
    topt = SGD([tp], lr=0.05, momentum=0.9, nesterov=nesterov)
    for g in grads:
        jg = jnp.asarray(g, dtype)
        updates, state = jax.jit(opt.update)(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.step(grads=[torch.from_numpy(g).to(tdtype)])
        for got, want in ((tp, jp), (topt.state[tp]["trace"], state[0].trace)):
            want = np.asarray(want, np.float32)
            atol = 0.0 if dtype == jnp.bfloat16 else 2.0 ** -22 * np.abs(want).max()
            np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_bf16_conv_grad_on_a_one_pixel_input():
    """A 1×1 input padded 1 on each side, the eight outer taps of the 3×3
    kernel meet only zeros: their gradient is exactly 0 in JAX, and must be
    in the port (PyTorch's CPU bf16 backward of ``conv2d(padding=1,
    stride=2)`` leaves them unwritten). The centre tap's gradient, a sum
    over the batch of bf16 products, within 2 bf16 steps of JAX's."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 1, 1, 64)).astype(np.float32)
    k = rng.normal(size=(3, 3, 64, 32)).astype(np.float32)
    jg = jax.grad(lambda k: jr._conv(jnp.asarray(x, jnp.bfloat16), k, 2).astype(
        jnp.float32).sum())(jnp.asarray(k, jnp.bfloat16))
    want = np.asarray(jg, np.float32)
    assert (want[[0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2, 0, 2, 0, 1, 2]] == 0).all()
    for _ in range(4):
        tk = torch.from_numpy(k).to(torch.bfloat16).requires_grad_(True)
        tx = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
        tr._conv(tx, tk, 2).float().sum().backward()
        got = tk.grad.float().numpy()
        np.testing.assert_array_equal(got[[0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2, 0, 2, 0, 1, 2]], 0)
        assert np.abs(got[1, 1] - want[1, 1]).max() <= 2 * 2.0 ** -7 * np.abs(want[1, 1]).max()


def test_resnet50_param_count_and_device_rule(monkeypatch):
    tree = abstract_params(tr.init_resnet, tr.ResNetConfig.resnet50(), device="cpu")
    n = sum(t.numel() for t in param_leaves(tree))
    assert abs(n - 25_557_032) < 60_000, n
    jshapes = jax.eval_shape(lambda: jr.init_resnet(jr.ResNetConfig.resnet50(),
                                                    jax.random.PRNGKey(0)))
    assert n == sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jshapes))
    assert isinstance(tree["stage_3"], list) and len(tree["stage_3"]) == 3
    assert tuple(tree["stem"]["conv"]["kernel"].shape) == (7, 7, 3, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.init_resnet(tr.ResNetConfig.tiny())
