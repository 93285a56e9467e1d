"""``Accelerator.lomo_backward`` against the JAX package's, on the CPU.

The tiny Llama (its stacked layers go through the per-layer update) and
the BERT tree (which reads its stacked layers whole: each stacked leaf is
updated when its gradient is complete), 4 LOMO steps of ``p - lr * g`` at
``mixed_precision`` "no", "bf16" and "fp16", params from the JAX
initializers and ids from a numpy seed, compared with JAX's steps from the
same params.

Tolerances. f32 ("no"): the sides differ in the order of their f32 sums
only: losses within 1e-6 relative and params within 1e-6 relative L2 per
leaf after 4 steps (measured 1.5e-7 and 6.8e-7). bf16 and fp16 compute:
the frameworks round matmul outputs and activations at different places,
so losses within 2e-3 relative (measured 1.4e-4) and the 4-step update
(params minus the start) per leaf within 0.1 relative L2 in bf16
(measured 0.054, BERT's embedding-norm bias: a norm's few elements carry
bf16's 2^-8 rounding straight into SGD) and 2e-2 in fp16 (measured 5.9e-3). BERT's key bias has
an exactly zero gradient (softmax does not see a shift of the keys): its
rounding noise moves it by under 1e-8 on both sides, which is held
instead. The fp16 scale
trajectory is a sequence of decisions and must equal JAX's; a scale of
2**40 overflows fp16 by orders of magnitude and 2**10 is far inside it, so
no step sits on the edge; the overflowed step leaves the params bitwise
unchanged on both sides.

The live-gradient test tracks every gradient tensor from its arrival at
an update until it is garbage (``lomo_stats``) and finds at no point more
than two layers' worth alive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.state import GradientState as JGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.parallelism_config import Mesh
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import GradScalerConfig
from accelerate_tpu_torch.utils.modeling import named_parameters

LR = 1e-2
STEPS = 4
UPDATE_TOL = {"bf16": 0.1, "fp16": 2e-2}
NOISE = 1e-8  # the most 4 steps move a param whose gradient is zero but for rounding
OVERFLOW = dict(init_scale=2.0 ** 40, backoff_factor=2.0 ** -30, growth_factor=2.0,
                growth_interval=2)


@pytest.fixture(autouse=True)
def _fresh_state():
    for reset in (lambda: AcceleratorState._reset_state(reset_partial_state=True),
                  GradientState._reset_state,
                  lambda: JAcceleratorState._reset_state(reset_partial_state=True),
                  JGradientState._reset_state):
        reset()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _llama(n_layers=2):
    import dataclasses

    jcfg = dataclasses.replace(jt.LlamaConfig.tiny(), n_layers=n_layers)
    tcfg = tt.LlamaConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
                             if f.name in tt.LlamaConfig.__dataclass_fields__})
    jp = jax.tree_util.tree_map(np.asarray, jt.init_llama(jcfg, jax.random.PRNGKey(0)))
    ids = [np.random.default_rng(s).integers(1, jcfg.vocab_size, (2, 64)).astype(np.int32)
           for s in range(STEPS)]
    jloss = lambda p, i: jt.llama_loss(p, {"input_ids": i}, jcfg)  # noqa: E731
    tloss = lambda p, i: tt.llama_loss(p, {"input_ids": i}, tcfg)  # noqa: E731
    return jp, [(i,) for i in ids], [(torch.from_numpy(i),) for i in ids], jloss, tloss


def _bert():
    jcfg, tcfg = jt.BertConfig.tiny(), tt.BertConfig.tiny()
    jp = jax.tree_util.tree_map(np.asarray, jt.init_bert(jcfg, jax.random.PRNGKey(1)))
    batches = []
    for s in range(STEPS):
        rng = np.random.default_rng(10 + s)
        batches.append({"input_ids": rng.integers(1, jcfg.vocab_size, (4, 32)).astype(np.int32),
                        "attention_mask": np.ones((4, 32), np.int32),
                        "token_type_ids": np.zeros((4, 32), np.int32),
                        "labels": rng.integers(0, 2, (4,)).astype(np.int32)})
    jloss = lambda p, b: jt.bert_loss(p, b, jcfg)  # noqa: E731
    tloss = lambda p, b: tt.bert_loss(p, b, tcfg)  # noqa: E731
    return (jp, [(b,) for b in batches],
            [({k: torch.from_numpy(v) for k, v in b.items()},) for b in batches], jloss, tloss)


def _run_jax(jp, args, loss_fn, precision, scaler=None):
    acc = JAccelerator(mixed_precision=precision, cpu=True,
                       grad_scaler_config=jdc.GradScalerConfig(**scaler) if scaler else None)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    losses, scales, trees = [], [], []
    for a in args:
        loss, params = acc.lomo_backward(loss_fn, params, *a, learning_rate=LR)
        losses.append(float(loss))
        scales.append(acc._lomo_scale)
        trees.append(jax.tree_util.tree_map(np.asarray, params))
    return losses, scales, trees


def _run_port(jp, args, loss_fn, precision, scaler=None):
    acc = Accelerator(mixed_precision=precision, cpu=True,
                      grad_scaler_config=GradScalerConfig(**scaler) if scaler else None)
    params = params_from_numpy(jp, device="cpu")
    losses, scales, trees = [], [], []
    for a in args:
        loss, params = acc.lomo_backward(loss_fn, params, *a, learning_rate=LR)
        losses.append(float(loss))
        scales.append(acc._lomo_scale)
        trees.append({k: v.detach().clone().numpy() for k, v in named_parameters(params).items()})
    return losses, scales, trees, acc


def _by_name(tree):
    return {k: np.asarray(v.detach()) for k, v in named_parameters(params_from_numpy(tree,
                                                                            device="cpu")).items()}


def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel()) / max(np.linalg.norm(b.ravel()), 1e-30))


@pytest.mark.parametrize("model", ["llama", "bert"])
@pytest.mark.parametrize("precision", ["no", "bf16", "fp16"])
def test_lomo_matches_jax(model, precision):
    jp, jargs, targs, jloss, tloss = (_llama if model == "llama" else _bert)()
    scaler = OVERFLOW if precision == "fp16" else None
    jl, js, jtrees = _run_jax(jp, jargs, jloss, precision, scaler)
    tl, ts, ttrees, _ = _run_port(jp, targs, tloss, precision, scaler)
    start = _by_name(jp)
    want, got = _by_name(jtrees[-1]), ttrees[-1]
    assert set(want) == set(got)
    for k in want:
        moved = want[k].astype(np.float64) - start[k]
        if np.abs(moved).max() < NOISE:  # an exactly zero gradient (BERT's key bias)
            assert np.abs(got[k].astype(np.float64) - start[k]).max() < NOISE, k
        elif precision == "no":
            assert _rel_l2(got[k], want[k]) <= 1e-6, k
        else:
            assert _rel_l2(got[k].astype(np.float64) - start[k], moved) <= UPDATE_TOL[precision], k
    np.testing.assert_allclose(tl, jl, rtol=1e-6 if precision == "no" else 2e-3)
    if precision == "fp16":
        # the scale trajectory: overflow (2**40 -> 2**10), then growth after 2
        assert ts == js == [2.0 ** 10, 2.0 ** 10, 2.0 ** 11, 2.0 ** 11]
        # the overflowed first step left every param bitwise unchanged
        first = ttrees[0]
        for k in want:
            np.testing.assert_array_equal(first[k], start[k].astype(first[k].dtype))
            np.testing.assert_array_equal(_by_name(jtrees[0])[k], start[k])


def test_lomo_returns_the_same_params_updated_in_place():
    jp, _, targs, _, tloss = _llama()
    acc = Accelerator(cpu=True)
    params = params_from_numpy(jp, device="cpu")
    before = params["layers"]["wq"]["kernel"].detach().clone()
    loss, out = acc.lomo_backward(tloss, params, *targs[0], learning_rate=LR)
    assert out is params and loss.dtype == torch.float32 and loss.dim() == 0
    assert not torch.equal(params["layers"]["wq"]["kernel"], before)
    assert all(t.grad is None for t in named_parameters(params).values())


def test_lomo_live_gradients_stay_within_two_layers():
    """At no point of the backward are more than two layers' gradients
    alive; every gradient arrives once (their bytes sum to the tree's)."""
    jp, _, targs, _, tloss = _llama(n_layers=6)
    acc = Accelerator(cpu=True)
    params = params_from_numpy(jp, device="cpu")
    acc.lomo_backward(tloss, params, *targs[0], learning_rate=LR)
    stats = acc.lomo_stats
    leaves = dict(named_parameters(params))
    tree = sum(t.numel() * t.element_size() for t in leaves.values())
    layer = sum(t[0].numel() * t.element_size() for k, t in leaves.items()
                if k.startswith("layers/"))
    outside = max(t.numel() * t.element_size() for k, t in leaves.items()
                  if not k.startswith("layers/"))
    assert stats["total_bytes"] == tree
    assert stats["live_bytes"] == 0
    assert stats["max_live_bytes"] <= 2 * max(layer, outside), stats
    # far below the whole tree: six layers and the embedding and head
    assert stats["max_live_bytes"] < 0.5 * tree


def test_lomo_under_another_mesh_raises(monkeypatch):
    acc = Accelerator(cpu=True)
    monkeypatch.setattr(Accelerator, "mesh", property(lambda self: Mesh((1, 2, 2, 1, 1, 1, 1))))
    jp, _, targs, _, tloss = _llama()
    with pytest.raises(NotImplementedError, match="item 11"):
        acc.lomo_backward(tloss, params_from_numpy(jp, device="cpu"), *targs[0])
