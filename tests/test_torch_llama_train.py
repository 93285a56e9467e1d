"""The port's Llama training path against the JAX package's, on the CPU, at
``LlamaConfig.tiny()`` (2 layers, dim 128, 4 heads over 2 kv heads).

- ``llama_forward`` with ``attention_impl`` "xla" and "flash", plain and on
  packed rows (``segment_ids``, per-segment RoPE positions), and with
  explicit ``positions``;
- ``llama_loss`` and its gradients: on the JAX einsum path, plus one packed
  case through the JAX interpreted flash kernels;
- ``config.attn_impl`` reaching the attention call;
- 3 steps of ``Accelerator.prepare_train_loop`` through the port's flash
  path against the JAX loop on its einsum path;
- ``pack_sequences`` / ``unpack_logits`` against the JAX copies.

Params come from the JAX initializer and cross through
``params_from_numpy``; token ids and document lengths are numpy from a
seed. Tolerances, all f32, where the two sides differ only in the order of
their sums: logits within 1e-5 (relative and absolute: logits near 0 have
no meaningful relative error); losses within 1e-5 relative; gradients
within 1e-4 of each leaf's largest magnitude (they sum over every token
and both layers). The training loop is compared through per-leaf 3-step
updates within 2e-4 relative L2, as ``tests/test_torch_train.py`` does, for
the reason written there (AdamW's g / (|g| + eps) magnifies the rounding
noise of near-zero gradient elements).
"""

import importlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu.utils import packing as jpacking
from accelerate_tpu.utils.operations import stack_batches as jstack
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
tfa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
from accelerate_tpu_torch.optimizer import adamw
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import packing as tpacking
from accelerate_tpu_torch.utils.operations import stack_batches

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
B, S = 2, 256
LR = 1e-3


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _packed(seed, rows=B, seq=S):
    """``rows`` packed rows of documents with seeded lengths (padding tail
    in most rows): ``(input_ids, segment_ids)`` int32 numpy."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, JCFG.vocab_size, n) for n in rng.integers(seq // 8, seq // 2, 6 * rows)]
    ids, seg = tpacking.pack_sequences(docs, seq)
    assert ids.shape[0] >= rows
    return ids[:rows], seg[:rows]


def _ids(seed, rows=B, seq=S):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, (rows, seq)).astype(np.int32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("packed", [False, True])
def test_llama_forward_matches_jax(params, impl, packed, monkeypatch):
    jp, np_params = params
    ids, seg = _packed(1) if packed else (_ids(1), None)
    kw = {} if seg is None else {"segment_ids": seg}
    monkeypatch.setenv("ACCELERATE_FLASH_KERNEL", "interpret")  # JAX's flash kernels
    want = jt.llama_forward(jp, jnp.asarray(ids), JCFG, attention_impl=impl,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    tp = params_from_numpy(np_params, device="cpu")
    got = tt.llama_forward(tp, torch.from_numpy(ids), TCFG, attention_impl=impl,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_llama_forward_explicit_positions(params):
    jp, np_params = params
    ids, seg = _packed(2)
    pos = np.random.default_rng(3).integers(0, JCFG.max_seq_len, ids.shape).astype(np.int32)
    want = jt.llama_forward(jp, jnp.asarray(ids), JCFG, attention_impl="xla",
                            segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos))
    got = tt.llama_forward(params_from_numpy(np_params, device="cpu"), torch.from_numpy(ids),
                           TCFG, attention_impl="xla", segment_ids=torch.from_numpy(seg),
                           positions=torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_segment_positions_restart_per_document():
    seg = torch.tensor([[1, 1, 1, 2, 2, 0, 0], [3, 3, 3, 3, 1, 1, 2]])
    want = [[0, 1, 2, 0, 1, 0, 1], [0, 1, 2, 3, 0, 1, 0]]
    assert tt.segment_positions(seg).tolist() == want


LOSS_CASES = {  # name: (attention impl, where the segment ids go, loss mask)
    "plain": ("xla", None, False),
    "packed_in_batch": ("xla", "batch", False),
    "packed_as_kwarg": ("xla", "kwarg", False),
    "loss_mask": ("xla", None, True),
    "flash_packed_masked": ("flash", "batch", True),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_llama_loss_and_grads_match_jax(params, name, monkeypatch):
    impl, seg_at, masked = LOSS_CASES[name]
    jp, np_params = params
    ids, seg = _packed(4) if seg_at else (_ids(4), None)
    batch = {"input_ids": ids}
    kw = {"attention_impl": impl}
    if seg_at == "batch":
        batch["segment_ids"] = seg
    elif seg_at == "kwarg":
        kw["segment_ids"] = seg
    if masked:
        batch["loss_mask"] = (np.random.default_rng(5).random(ids.shape) < 0.7).astype(np.int32)

    def jconv(tree):
        return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}

    monkeypatch.setenv("ACCELERATE_FLASH_KERNEL", "interpret")  # JAX's flash kernels
    j_loss, j_grads = jax.value_and_grad(
        lambda p: jt.llama_loss(p, jconv(batch), JCFG, **jconv(kw)))(jp)
    tp = params_from_numpy(np_params, device="cpu")
    leaves = jax.tree_util.tree_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)

    def tconv(tree):
        return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in tree.items()}

    t_loss = tt.llama_loss(tp, tconv(batch), TCFG, **tconv(kw))
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss), rtol=1e-5)
    for (path, jg), t in zip(jax.tree_util.tree_leaves_with_path(j_grads), leaves):
        jg = np.asarray(jg)
        err = float(np.abs(t.grad.numpy() - jg).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(jg).max())), f"{path}: grad err {err}"


def test_config_attn_impl_is_honoured(params, monkeypatch):
    """``llama_forward`` follows ``config.attn_impl`` when no
    ``attention_impl`` is passed: "flash" reaches ``flash_attention`` once a
    layer, "auto" never; an explicit ``attention_impl`` overrides it."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    tp = params_from_numpy(params[1], device="cpu")
    ids, seg = _packed(6)
    args = (tp, torch.from_numpy(ids))
    flash_cfg = dataclasses.replace(TCFG, attn_impl="flash")
    flash = tt.llama_forward(*args, flash_cfg, segment_ids=torch.from_numpy(seg))
    assert len(calls) == TCFG.n_layers
    auto = tt.llama_forward(*args, TCFG, segment_ids=torch.from_numpy(seg))
    tt.llama_forward(*args, flash_cfg, attention_impl="xla", segment_ids=torch.from_numpy(seg))
    assert len(calls) == TCFG.n_layers
    np.testing.assert_allclose(_np(flash), _np(auto), rtol=1e-5, atol=1e-5)


def test_three_training_steps_match_the_jax_loop(params):
    """``prepare_train_loop`` through the port's flash path (its plain
    versions on the CPU) against the JAX loop on its einsum path: the same
    JAX-made weights, the same packed batches, f32, ``adamw(1e-3)``."""
    jp, np_params = params
    batches = []
    for step in range(3):
        ids, seg = _packed(10 + step, rows=8)
        batches.append({"input_ids": ids, "segment_ids": seg})

    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator()
    jparams, jopt = jacc.prepare(jp, optax.adamw(LR))
    jloop = jacc.prepare_train_loop(lambda p, b: jt.llama_loss(p, b, JCFG, attention_impl="xla"),
                                    jopt)
    jparams, _, jm = jloop(jparams, jopt.opt_state, jstack(batches))
    j_loss = np.asarray(jm["loss"])

    acc = Accelerator(cpu=True)
    tparams, opt = acc.prepare(np_params, adamw(LR))
    loop = acc.prepare_train_loop(
        lambda p, b: tt.llama_loss(p, b, dataclasses.replace(TCFG, attn_impl="flash")), opt)
    tbatches = stack_batches([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    tparams, _, tm = loop(tparams, opt.opt_state, tbatches)
    t_loss = tm["loss"].numpy()

    assert np.isfinite(t_loss).all() and np.isfinite(j_loss).all()
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    init = jax.tree_util.tree_leaves_with_path(np_params)
    j_after = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    for (path, x0), t, j in zip(init, jax.tree_util.tree_leaves(tparams), j_after):
        t_upd, j_upd = t.detach().numpy() - x0, j - x0
        rel = np.linalg.norm(t_upd - j_upd) / np.linalg.norm(j_upd)
        assert rel <= 2e-4, f"{path}: update rel L2 err {rel}"


def test_pack_sequences_and_unpack_match_jax():
    rng = np.random.default_rng(7)
    docs = [rng.integers(1, 100, n).tolist() for n in rng.integers(1, 40, 23)] + [[5] * 70]
    for split_long in (True, False):
        if not split_long:
            with pytest.raises(ValueError, match="exceeds"):
                tpacking.pack_sequences(docs, 64, split_long=False)
            continue
        ours = tpacking.pack_sequences(docs, 64, pad_id=3)
        theirs = jpacking.pack_sequences(docs, 64, pad_id=3)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    logits = rng.standard_normal(ours[0].shape + (5,)).astype(np.float32)
    mine, ref = tpacking.unpack_logits(logits, ours[1]), jpacking.unpack_logits(logits, ours[1])
    assert len(mine) == len(ref) == len(docs) + 1  # the 70-token document is cut in two
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="empty"):
        tpacking.pack_sequences([[1], []], 8)


def test_unported_forward_options_raise(params):
    """``attention_fn`` raised until context parallelism was ported; the
    name is kept, and the forward now runs the callback in place of the
    attention, as JAX's does (here the plain attention, scaled by a half
    so that a forward that ignored it would show)."""
    from accelerate_tpu.ops.attention import dot_product_attention as j_dpa
    from accelerate_tpu_torch.ops.attention import dot_product_attention as t_dpa

    tp = params_from_numpy(params[1], device="cpu")
    ids = torch.from_numpy(_ids(8, rows=1, seq=16))
    got = tt.llama_forward(tp, ids, TCFG,
                           attention_fn=lambda q, k, v, causal: 0.5 * t_dpa(q, k, v, causal=causal))
    want = jt.llama_forward(params[0], jnp.asarray(ids.numpy()), JCFG,
                            attention_fn=lambda q, k, v, causal: 0.5 * j_dpa(q, k, v,
                                                                             causal=causal))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    plain = tt.llama_forward(tp, ids, TCFG)
    assert not torch.allclose(got, plain, rtol=1e-3, atol=1e-3)
    # MoE is ported: the loss adds the aux term, as JAX's does
    jmoe, moe = (dataclasses.replace(c, moe_experts=2) for c in (JCFG, TCFG))
    jp = jt.init_llama(jmoe, jax.random.PRNGKey(0))
    want = jt.llama_loss(jp, {"input_ids": jnp.asarray(ids.numpy())}, jmoe)
    got = tt.llama_loss(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                          device="cpu"), {"input_ids": ids}, moe)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
