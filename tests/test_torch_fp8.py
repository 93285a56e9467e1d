"""fp8 delayed scaling of the port against ``accelerate_tpu.ops.fp8`` on the
CPU, where ``fp8_dot``'s products take their plain version (f32 matmuls of
the upcast fp8 values). Inputs come from ``np.random.default_rng``; model
params from the JAX ``init_*(..., PRNGKey(0))`` through
``params_from_numpy``.

Tolerances, each with its reason:

- quantized operands and scales: bitwise (the f32 scale arithmetic and the
  fp8 casts agree in the two frameworks);
- ``fp8_dot``'s out, dx and dw: 1e-5 relative to the largest element — the
  products of fp8 values are exact in f32 and only the order of the f32
  sums differs;
- the rolled histories: bitwise, except ``g_hist``'s new slot, the amax of
  the same cotangent (bitwise too);
- training through ``Accelerator(mixed_precision="fp8")`` with f32 compute
  (both packages' fp8 policy patched to f32): the first two micro-steps see
  the same params, so their losses agree to 1e-6 and their histories to
  1e-5 relative; after the first update, a parameter a few f32 ulps apart
  flips the fp8 rounding of single elements (e4m3 keeps 3 mantissa bits,
  e5m2 2), so the third step's loss is held to 1e-4 and its amaxes to 0.1;
- the same in the real policy (bf16 compute): XLA's CPU backend fuses
  elementwise chains in f32 and torch rounds each op to bf16, and an
  amax is the largest of those roundings: losses within 1e-3, gradient
  norms within 2e-2 (meta histories of magnitude ~10 dominate them, as in
  ``optax.global_norm`` over the whole tree) and amaxes within 0.15.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.ops import fp8 as J
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.ops import fp8 as T
from accelerate_tpu_torch.optimizer import adam, sgd
from accelerate_tpu_torch.parallel.weight_update import build_bucket_plan
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils.modeling import named_parameters
from accelerate_tpu_torch.utils.synthetic import make_synthetic_mrpc

CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's small CPU ops, restored after
    it: the suite runs several test workers on one machine, and a worker
    whose every op spreads over all the cores slows the others. Every bar
    here is bitwise where the arithmetic is order-free, else a tolerance
    the order of a few CPU sums cannot cross."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _dense_pair(seed, in_dim, out_dim):
    w = _rand((in_dim, out_dim), seed, 1.0 / np.sqrt(in_dim))
    return ({"kernel": jnp.asarray(w), "bias": jnp.zeros(out_dim), J.META_KEY: J.init_fp8_meta()},
            {"kernel": _t(w), "bias": torch.zeros(out_dim), T.META_KEY: T.init_fp8_meta(**CPU)})


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), (
        np.abs(got - want).max(), np.abs(want).max())


# ------------------------------------------------------------- fp8_dot --
class TestFp8Dot:
    def test_forward_close_to_dense(self):
        x, w = _rand((16, 64), 0), _rand((64, 32), 1)
        out = T.fp8_dot(_t(x), _t(w), T.init_fp8_meta(**CPU))
        ref = x @ w
        rel = np.linalg.norm(out.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 0.06, rel
        _close(out, J.fp8_dot(jnp.asarray(x), jnp.asarray(w), J.init_fp8_meta()), 1e-5)

    def test_batched_input(self):
        x, w = _rand((4, 8, 64)), _rand((64, 16), 1)
        out = T.fp8_dot(_t(x), _t(w), T.init_fp8_meta(**CPU))
        assert out.shape == (4, 8, 16)
        _close(out, J.fp8_dot(jnp.asarray(x), jnp.asarray(w), J.init_fp8_meta()), 1e-5)

    def test_gradients_close_to_dense(self):
        x, w = _rand((16, 64), 2), _rand((64, 32), 3)
        tx, tw = _t(x, True), _t(w, True)
        meta = {k: v.requires_grad_(True) for k, v in T.init_fp8_meta(**CPU).items()}
        (T.fp8_dot(tx, tw, meta) ** 2).sum().backward()
        dx_ref = 2 * (x @ w) @ w.T
        dw_ref = x.T @ (2 * (x @ w))
        assert np.linalg.norm(tx.grad.numpy() - dx_ref) / np.linalg.norm(dx_ref) < 0.15
        assert np.linalg.norm(tw.grad.numpy() - dw_ref) / np.linalg.norm(dw_ref) < 0.15
        # the meta's gradient is the rolled history: slot 0 holds this step's amax
        assert float(meta["x_hist"].grad[0]) == float(np.abs(x).max())
        assert float(meta["w_hist"].grad[0]) == float(np.abs(w).max())
        assert float(meta["g_hist"].grad[0]) > 0

    def test_scale_uses_history(self):
        x, w = _rand((16, 64), 4) * 0.01, _rand((64, 32), 5) * 0.01
        meta = T.init_fp8_meta(**CPU)
        cold = T.fp8_dot(_t(x), _t(w), meta).numpy()
        primed = {"x_hist": meta["x_hist"].clone(), "w_hist": meta["w_hist"].clone(),
                  "g_hist": meta["g_hist"]}
        primed["x_hist"][0] = float(np.abs(x).max())
        primed["w_hist"][0] = float(np.abs(w).max())
        warm = T.fp8_dot(_t(x), _t(w), primed).numpy()
        ref = x @ w
        assert np.linalg.norm(warm - ref) < np.linalg.norm(cold - ref)

    def test_most_recent_algo_and_e4m3_format(self):
        recipe = T.FP8Recipe(amax_compute_algo="most_recent", fp8_format="E4M3")
        assert recipe.grad_dtype == torch.float8_e4m3fn and recipe.grad_max == T.E4M3_MAX
        out = T.fp8_dot(_t(_rand((8, 32))), _t(_rand((32, 8), 1)),
                        T.init_fp8_meta(recipe, **CPU), recipe)
        assert out.shape == (8, 8)
        with pytest.raises(ValueError):
            T.FP8Recipe(amax_compute_algo="bogus")
        with pytest.raises(ValueError):
            T.FP8Recipe(fp8_format="E5M2")

    @pytest.mark.parametrize("fmt", ["HYBRID", "E4M3"])
    @pytest.mark.parametrize("algo", ["max", "most_recent"])
    def test_operands_scales_products_and_meta_match_jax(self, fmt, algo):
        """Primed histories (so every scale is a real one), a cotangent
        through the backward, a K that is not a multiple of 16."""
        jr, tr = J.FP8Recipe(fp8_format=fmt, amax_compute_algo=algo), T.FP8Recipe(
            fp8_format=fmt, amax_compute_algo=algo)
        rng = np.random.default_rng(7)
        x, w, g = _rand((3, 8, 40), 8), _rand((40, 24), 9, 0.1), _rand((3, 8, 24), 10, 1e-3)
        hist = {k: rng.uniform(0.01, 4.0, 16).astype(np.float32)
                for k in ("x_hist", "w_hist", "g_hist")}
        for role, fp8_max in (("x_hist", J.E4M3_MAX), ("g_hist", jr.grad_max)):
            js = J._scale_from_history(jnp.asarray(hist[role]), fp8_max, jr)
            ts = T._scale_from_history(_t(hist[role]), fp8_max, tr)
            assert np.float32(js) == ts.numpy()
            src = x if role == "x_hist" else g
            jq = J._quantize(jnp.asarray(src), js, fp8_max,
                             jr.grad_dtype if role == "g_hist" else jnp.float8_e4m3fn)
            tq = T._quantize(_t(src), ts, fp8_max,
                             tr.grad_dtype if role == "g_hist" else torch.float8_e4m3fn)
            np.testing.assert_array_equal(np.asarray(jq).view(np.uint8),
                                          tq.view(torch.uint8).numpy())
        jm = {k: jnp.asarray(v) for k, v in hist.items()}
        out, vjp = jax.vjp(lambda a, b, m: J.fp8_dot(a, b, m, jr), jnp.asarray(x), jnp.asarray(w),
                           jm)
        dx, dw, dmeta = vjp(jnp.asarray(g))
        tx, tw = _t(x, True), _t(w, True)
        tm = {k: _t(v, True) for k, v in hist.items()}
        tout = T.fp8_dot(tx, tw, tm, tr)
        tout.backward(_t(g))
        _close(tout.detach(), out, 1e-5)
        _close(tx.grad, dx, 1e-5)
        _close(tw.grad, dw, 1e-5)
        for k in hist:
            np.testing.assert_array_equal(tm[k].grad.numpy(), np.asarray(dmeta[k]))

    def test_cotangent_scale_reproduces_the_unscaled_backward(self):
        """A sharded step hands each rank n times JAX's cotangent: under
        ``cotangent_scale(n)`` the histories record the unscaled amax and
        dx, dw come back n times the unscaled ones, exactly (n = 4)."""
        x, w, g = _rand((8, 32), 11), _rand((32, 16), 12, 0.2), _rand((8, 16), 13, 1e-2)
        hist = {k: np.full(16, 0.5, np.float32) for k in ("x_hist", "w_hist", "g_hist")}

        def run(scale, cot):
            tx, tw = _t(x, True), _t(w, True)
            tm = {k: _t(v, True) for k, v in hist.items()}
            with T.cotangent_scale(scale):
                T.fp8_dot(tx, tw, tm).backward(_t(cot))
            return tx.grad, tw.grad, {k: v.grad for k, v in tm.items()}

        dx1, dw1, m1 = run(1, g)
        dx4, dw4, m4 = run(4, 4 * g)
        assert torch.equal(dx4, 4 * dx1) and torch.equal(dw4, 4 * dw1)
        for k in m1:
            assert torch.equal(m4[k], m1[k])


# ------------------------------------------------------- meta threading --
class TestMetaThreading:
    def test_labels(self):
        jp = {"dense": J.fp8_dense_init(jax.random.PRNGKey(0), 8, 4),
              "head": {"kernel": jnp.ones((4, 2))}}
        tp = {"dense": T.fp8_dense_init(8, 4, **CPU), "head": {"kernel": torch.ones(4, 2)}}
        assert T.fp8_param_labels(tp) == J.fp8_param_labels(jp)
        assert T.fp8_param_labels(tp)["dense"][T.META_KEY]["x_hist"] == "fp8_meta"
        assert T.has_fp8_meta(tp) and not T.has_fp8_meta({"a": torch.ones(1)})
        assert T.fp8_meta_mask(tp) == [False, False, True, True, True, False]

    def test_training_updates_meta_and_converges(self):
        """The 2-layer fp8 MLP of the JAX test through the port's partition
        (``make_fp8_optimizer``), 200 adam steps: the loss falls below 5 %
        of its first value, histories fill and slot 0 holds the real amax."""
        p1, p2 = _dense_pair(0, 16, 32)[1], _dense_pair(1, 32, 1)[1]
        params = {"l1": {k: (v.requires_grad_(True) if k != T.META_KEY else
                             {n: h.requires_grad_(True) for n, h in v.items()})
                         for k, v in p1.items()},
                  "l2": {k: (v.requires_grad_(True) if k != T.META_KEY else
                             {n: h.requires_grad_(True) for n, h in v.items()})
                         for k, v in p2.items()}}
        X, W = _t(_rand((256, 16), 8)), _t(_rand((16, 1), 7))
        Y = X @ W
        opt = T.make_fp8_optimizer(adam(1e-2), params)
        assert len(opt.meta) == 6 and len(opt.params) == 4
        first = None
        for _ in range(200):
            h = torch.relu(T.fp8_dense_apply(params["l1"], X))
            loss = torch.mean((T.fp8_dense_apply(params["l2"], h) - Y) ** 2)
            loss.backward()
            opt.step()
            opt.zero_grad()
            first = float(loss.detach()) if first is None else first
        assert float(loss) < first * 0.05, (first, float(loss))
        meta = params["l1"][T.META_KEY]
        assert float(meta["x_hist"].max()) > 0 and float(meta["g_hist"].max()) > 0
        assert float(meta["x_hist"][0]) == float(X.abs().max())

    def test_meta_under_scan(self):
        """Stacked fp8 layers, one slice a layer (the port's loop over
        ``unbind``): the stacked meta's gradient is the per-layer rolled
        histories, as JAX's under ``lax.scan``."""
        L, D = 3, 16
        kernels = np.stack([_rand((D, D), i) for i in range(L)])
        x = _rand((4, D), 9)

        def jloss(p, x):
            def layer(h, lp):
                return jax.nn.relu(J.fp8_dot(h, lp["kernel"], lp[J.META_KEY])), None
            h, _ = jax.lax.scan(layer, x, p)
            return jnp.sum(h ** 2)

        jstacked = {"kernel": jnp.asarray(kernels),
                    J.META_KEY: {k: jnp.zeros((L, 16)) for k in ("x_hist", "w_hist", "g_hist")}}
        jl, jg = jax.value_and_grad(jloss)(jstacked, jnp.asarray(x))
        tk = _t(kernels, True)
        tm = {k: torch.zeros(L, 16, requires_grad=True) for k in ("x_hist", "w_hist", "g_hist")}
        h = _t(x)
        for i, (k, *hists) in enumerate(zip(tk.unbind(0), *(tm[n].unbind(0) for n in tm))):
            h = torch.relu(T.fp8_dot(h, k, dict(zip(tm, hists))))
        loss = (h ** 2).sum()
        loss.backward()
        _close(loss.detach(), jl, 1e-5)
        for n in tm:
            assert tm[n].grad.shape == (L, 16)
            _close(tm[n].grad, jg[J.META_KEY][n], 1e-5)


# ------------------------------------------------------------ the Accelerator --
def _jax_acc(accum=1, **kw):
    JAcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    return JAccelerator(mixed_precision="fp8", gradient_accumulation_steps=accum, **kw)


class TestAcceleratorIntegration:
    def test_fp8_mixed_precision_training(self):
        """The JAX test's regression through ``Accelerator(mixed_precision=
        "fp8")``: the optimizer is partitioned, the loss falls below 10 %
        of its first value in 150 steps, and the histories stay f32 under
        the bf16 compute cast."""
        acc = Accelerator(mixed_precision="fp8", cpu=True)
        params = {"l1": _dense_pair(0, 16, 32)[1], "l2": _dense_pair(1, 32, 1)[1]}
        params, opt = acc.prepare(params, adam(1e-2))
        assert opt.fp8_partition and len(opt.meta) == 6
        X, W = _t(_rand((256, 16), 8)), _t(_rand((16, 1), 7))
        batch = {"x": X, "y": X @ W}

        def loss_fn(p, b):
            h = torch.relu(T.fp8_dense_apply(p["l1"], b["x"]))
            return torch.mean((T.fp8_dense_apply(p["l2"], h) - b["y"]) ** 2)

        step = acc.prepare_train_step(loss_fn, opt)
        first = None
        for _ in range(150):
            params, _, m = step(params, opt.opt_state, batch)
            first = float(m["loss"]) if first is None else first
        assert float(m["loss"]) < first * 0.1, (first, float(m["loss"]))
        meta = params["l1"][T.META_KEY]
        assert meta["x_hist"].dtype == torch.float32
        assert float(meta["x_hist"].max()) > 0 and float(meta["g_hist"].max()) > 0

    def test_fp8_wrap_when_optimizer_prepared_first(self):
        """``prepare(optimizer, params)``: the partition is installed too, so
        slot 0 holds this step's amax (the bf16-cast input's) as JAX's."""
        x = _rand((32, 16))
        jacc = _jax_acc()
        jpair, tpair = _dense_pair(0, 16, 8)
        jopt, jparams = jacc.prepare(optax.adam(1e-2), {"l1": jpair})
        jstep = jacc.prepare_train_step(
            lambda p, b: jnp.mean(J.fp8_dense_apply(p["l1"], b) ** 2), jopt)
        jparams, _, _ = jstep(jparams, jopt.opt_state, jnp.asarray(x))
        acc = Accelerator(mixed_precision="fp8", cpu=True)
        opt, params = acc.prepare(adam(1e-2), {"l1": tpair})
        step = acc.prepare_train_step(
            lambda p, b: torch.mean(T.fp8_dense_apply(p["l1"], b) ** 2), opt)
        params, _, _ = step(params, opt.opt_state, _t(x))
        got = float(params["l1"][T.META_KEY]["x_hist"][0])
        assert got == float(jparams["l1"][J.META_KEY]["x_hist"][0])
        np.testing.assert_allclose(got, np.abs(x).max(), rtol=1e-2)  # the bf16 cast of x


class TestFp8GradAccumulation:
    def _setup(self, accum):
        acc = Accelerator(mixed_precision="fp8", cpu=True, gradient_accumulation_steps=accum)
        params, opt = acc.prepare({"l1": _dense_pair(0, 16, 8)[1]}, sgd(1e-2))
        step = acc.prepare_train_step(
            lambda p, b: torch.mean(T.fp8_dense_apply(p["l1"], b["x"]) ** 2), opt)
        return params, opt, step

    def test_meta_rolls_every_microstep_params_on_boundary(self):
        params, opt, step = self._setup(accum=2)
        batches = [{"x": _t(_rand((8, 16), seed) * (seed + 1.0))} for seed in range(4)]
        hists = [params["l1"][T.META_KEY]["x_hist"].clone()]
        kernels = [params["l1"]["kernel"].detach().clone()]
        for b in batches:
            params, _, _ = step(params, opt.opt_state, b)
            hists.append(params["l1"][T.META_KEY]["x_hist"].clone())
            kernels.append(params["l1"]["kernel"].detach().clone())
        for i in range(1, len(hists)):
            assert not torch.equal(hists[i], hists[i - 1]), f"history stale at step {i}"
            expected = float(batches[i - 1]["x"].abs().max())
            assert abs(float(hists[i][0]) - expected) < 1e-2 * expected
        assert torch.equal(kernels[1], kernels[0]), "params moved mid-accumulation"
        assert not torch.equal(kernels[2], kernels[1]), "no update on boundary"
        assert torch.equal(kernels[3], kernels[2]), "params moved mid-accumulation"
        assert not torch.equal(kernels[4], kernels[3]), "no update on boundary"

    def test_boundary_bookkeeping_with_nested_multisteps(self):
        params, opt, step = self._setup(accum=2)
        assert opt.is_accumulation_boundary
        params, _, _ = step(params, opt.opt_state, {"x": _t(_rand((8, 16), 1))})
        assert not opt.is_accumulation_boundary and opt.step_count == 0
        params, _, _ = step(params, opt.opt_state, {"x": _t(_rand((8, 16), 2))})
        assert opt.is_accumulation_boundary and opt.step_count == 1


def test_meta_rides_the_fused_zero1_plan_as_passthrough_slots():
    """The bucket plan keeps every meta leaf out of its buckets (as the JAX
    package's ``passthrough_indices``), and its slots index the others."""
    params = {"l1": _dense_pair(0, 16, 8)[1], "l2": _dense_pair(1, 8, 4)[1]}
    plan = build_bucket_plan(params, "dp_replicate", 4, passthrough=lambda p: T.META_KEY in p)
    mask = T.fp8_meta_mask(params)
    assert plan.passthrough_indices == tuple(i for i, m in enumerate(mask) if m)
    assert len(plan.passthrough_indices) == 6
    assert sorted(s.leaf_index for s in plan.slots) == list(range(4))
    assert plan.n_elements == 16 * 8 + 8 + 8 * 4 + 4


# ------------------------------------------------- Llama and BERT, 3 steps --
def _f32_fp8_policy(monkeypatch):
    """Both packages' fp8 policy with f32 compute (see the module
    docstring): the entry points stay ``mixed_precision="fp8"``."""
    jorig = jdc.MixedPrecisionPolicy.from_precision.__func__
    torig = tdc.MixedPrecisionPolicy.from_precision.__func__
    monkeypatch.setattr(jdc.MixedPrecisionPolicy, "from_precision", classmethod(
        lambda cls, p: cls(jnp.float32, jnp.float32, jnp.float32) if str(p) == "fp8"
        else jorig(cls, p)))
    monkeypatch.setattr(tdc.MixedPrecisionPolicy, "from_precision", classmethod(
        lambda cls, p: cls(torch.float32, torch.float32, torch.float32) if str(p) == "fp8"
        else torig(cls, p)))


def _three_steps(jloss, tloss, jparams, batches):
    """3 micro-steps under accumulation 2 with ``sgd(1e-2)`` through both
    Accelerators: per-step losses and grad norms, the params after each
    step (named), and the port optimizer's meta count."""
    jacc = _jax_acc(accum=2)
    jp, jopt = jacc.prepare(jparams, optax.sgd(1e-2))
    jstep = jacc.prepare_train_step(jloss, jopt, compute_grad_norm=True)
    acc = Accelerator(mixed_precision="fp8", cpu=True, gradient_accumulation_steps=2)
    tp, opt = acc.prepare(params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), **CPU),
                          sgd(1e-2))
    step = acc.prepare_train_step(tloss, opt, compute_grad_norm=True)
    js, out = jopt.opt_state, []
    for b in batches:
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, _, tm = step(tp, opt.opt_state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append(((float(jm["loss"]), float(tm["loss"])),
                    (float(jm["grad_norm"]), float(tm["grad_norm"])),
                    dict(named_parameters(jax.tree_util.tree_map(np.asarray, jp))),
                    {k: v.detach().float().numpy().copy()
                     for k, v in named_parameters(tp).items()}))
    return out, opt


def _check_steps(out, tight):
    for i, ((jl, tl), (jn, tn), jflat, tflat) in enumerate(out):
        before_update = i < 2
        loss_tol = (1e-6 if before_update else 1e-4) if tight else 1e-3
        assert abs(tl - jl) <= loss_tol * abs(jl), (i, jl, tl)
        assert abs(tn - jn) <= (1e-5 if tight and before_update else 2e-2) * jn, (i, jn, tn)
        for name, j in jflat.items():
            if "fp8_meta" not in name:
                continue
            # slots filled so far; slot 0 is this step's amax
            filled, t = j[..., :i + 1], tflat[name][..., :i + 1]
            tol = (1e-5 if before_update else 0.1) if tight else 0.15
            assert np.abs(t - filled).max() <= tol * np.abs(filled).max(), (i, name)
            assert np.all(t[..., i + 1:] == 0) if t.shape[-1] > i + 1 else True


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_llama_fp8_three_steps_match_jax(compute, monkeypatch):
    if compute == "f32":
        _f32_fp8_policy(monkeypatch)
    jcfg = dataclasses.replace(jt.LlamaConfig.tiny(), dtype_recipe="fp8")
    tcfg = dataclasses.replace(tt.LlamaConfig.tiny(), dtype_recipe="fp8")
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(1, jcfg.vocab_size, (8, 32)).astype(np.int32)}
               for _ in range(3)]
    out, opt = _three_steps(lambda p, b: jt.llama_loss(p, b, jcfg, attention_impl="xla"),
                            lambda p, b: tt.llama_loss(p, b, tcfg, attention_impl="xla"),
                            jt.init_llama(jcfg, jax.random.PRNGKey(0)), batches)
    assert len(opt.meta) == 3 * 7 and opt.step_count == 1
    _check_steps(out, tight=compute == "f32")


def test_bert_fp8_three_steps_match_jax():
    jcfg = dataclasses.replace(jt.BertConfig.tiny(), dtype_recipe="fp8")
    tcfg = dataclasses.replace(tt.BertConfig.tiny(), dtype_recipe="fp8")
    data = make_synthetic_mrpc(24, 64, jcfg.vocab_size, seed=0)
    batches = [{k: np.asarray(v[i * 8:(i + 1) * 8]) for k, v in data.items()} for i in range(3)]
    out, opt = _three_steps(lambda p, b: jt.bert_loss(p, b, jcfg, attention_impl="xla"),
                            lambda p, b: tt.bert_loss(p, b, tcfg, attention_impl="xla"),
                            jt.init_bert(jcfg, jax.random.PRNGKey(0)), batches)
    assert len(opt.meta) == 3 * 6
    _check_steps(out, tight=False)


@pytest.mark.parametrize("quirk", ["no_partition", "comm_bf16"])
def test_reference_quirks_of_the_jax_step_are_reproduced(quirk):
    """Two of the JAX step's behaviours, each against the JAX package on
    one SGD step of the fp8 MLP: under ``mixed_precision="bf16"`` a model
    with fp8 meta gets no partition, so SGD updates its histories as params
    (``old - lr * new``); under ``"fp8"`` with the bf16 comm hook the
    compression casts the meta gradients too, so the installed histories
    are bf16 values. f32 on both sides but for the casts: 1e-6."""
    from accelerate_tpu.utils.dataclasses import DistributedDataParallelKwargs as JDDP
    from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs

    x = _rand((32, 16), 3) * 3.0
    precision = "bf16" if quirk == "no_partition" else "fp8"
    jhandlers = [JDDP(comm_hook="bf16")] if quirk == "comm_bf16" else None
    thandlers = [DistributedDataParallelKwargs(comm_hook="bf16")] if quirk == "comm_bf16" else None
    jpair, tpair = _dense_pair(0, 16, 8)
    JAcceleratorState._reset_state(reset_partial_state=True)
    JGradientState._reset_state()
    jacc = JAccelerator(mixed_precision=precision, kwargs_handlers=jhandlers)
    jparams, jopt = jacc.prepare({"l1": jpair}, optax.sgd(1e-2))
    jstep = jacc.prepare_train_step(
        lambda p, b: jnp.mean(J.fp8_dense_apply(p["l1"], b) ** 2), jopt, compute_grad_norm=True)
    jparams, _, jm = jstep(jparams, jopt.opt_state, jnp.asarray(x))
    acc = Accelerator(mixed_precision=precision, cpu=True, kwargs_handlers=thandlers)
    params, opt = acc.prepare({"l1": tpair}, sgd(1e-2))
    assert bool(opt.meta) == (quirk == "comm_bf16")
    step = acc.prepare_train_step(
        lambda p, b: torch.mean(T.fp8_dense_apply(p["l1"], b) ** 2), opt, compute_grad_norm=True)
    params, _, tm = step(params, opt.opt_state, _t(x))
    for name in ("x_hist", "w_hist", "g_hist"):
        got = params["l1"][T.META_KEY][name].detach().numpy()
        want = np.asarray(jparams["l1"][J.META_KEY][name])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    slot0 = float(params["l1"][T.META_KEY]["x_hist"][0])
    if quirk == "no_partition":  # an SGD step on the new history: -lr times it
        np.testing.assert_allclose(slot0, -1e-2 * float(np.abs(x).astype(np.float32).max()),
                                   rtol=1e-2)
    else:  # the installed history is the bf16 cast of the amax
        assert slot0 == float(torch.tensor(slot0).bfloat16().float())
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
