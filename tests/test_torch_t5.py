"""The port's T5 against ``accelerate_tpu.models.t5`` on the CPU, at
``T5Config.tiny()`` (2+2 layers, dim 64, 4 heads of 16, 8 buckets over a
max distance of 32, vocab 512) with params from the JAX ``init_t5(
PRNGKey(0))`` crossed through ``models.convert.params_from_numpy``,
token ids from numpy seeds.

- ``_relative_position_bucket`` equal as integers over every relative
  position in ±300, both directions, at tiny's and t5-small's bucket
  settings (the large-distance branch takes an f32 ``log`` and truncates);
- ``t5_encode``, ``t5_decode`` and ``t5_forward`` with and without an
  ``attention_mask``, tied and untied heads: f32 within 1e-5 absolute and
  relative (another order of f32 sums);
- ``t5_loss`` with ``-100`` labels and its gradients against
  ``jax.value_and_grad``: loss within 1e-6 relative, each gradient leaf
  within 1e-4 of its largest magnitude;
- ``t5_greedy_generate`` tokens equal, with and without ``eos_token_id``
  and a mask, on the untied head (the tied random model repeats its
  input token: every greedy token is the start token);
- ``optax.adam`` as the port's ``adam`` (AdamW with no weight decay): 3
  steps through ``Accelerator.prepare_train_step`` against JAX's
  ``prepare_train_step``, losses within 1e-5 relative and each leaf's
  3-step update within 1e-3 relative L2 of JAX's (measured at most
  3.4e-4, on the cross-attention ``wq``; 2.5e-5 or less on 21 of the 26
  leaves). Adam's ``m / sqrt(v)`` turns the f32 noise of a gradient
  element near zero (the smallest are ~6e-8, the noise ~5e-7) into a
  different step of that element, so elementwise bars do not hold;
- the device rule of the new entry points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.state import AcceleratorState as JAcceleratorState
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.models import t5 as tt5
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import adam, param_leaves
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.modeling import named_parameters

B, SE, ST = 3, 12, 7


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _configs(tied):
    jc, tc = jt5.T5Config.tiny(), tt5.T5Config.tiny()
    return (dataclasses.replace(jc, tie_word_embeddings=tied),
            dataclasses.replace(tc, tie_word_embeddings=tied))


@pytest.fixture(scope="module")
def models():
    out = {}
    for tied in (True, False):
        jc, tc = _configs(tied)
        jp = jt5.init_t5(jc, jax.random.PRNGKey(0))
        out[tied] = (jc, tc, jp, jax.tree_util.tree_map(np.asarray, jp))
    return out


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, SE), np.int32)
    mask[1, 8:] = 0
    mask[2, 5:] = 0
    labels = rng.integers(0, vocab, (B, ST)).astype(np.int32)
    labels[0, 5:] = -100
    labels[2, 2:] = -100
    return {"input_ids": rng.integers(0, vocab, (B, SE)).astype(np.int32),
            "decoder_input_ids": rng.integers(0, vocab, (B, ST)).astype(np.int32),
            "attention_mask": mask, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("buckets,max_distance", [(8, 32), (32, 128)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_bucket_function_equal_as_integers(bidirectional, buckets, max_distance):
    rel = np.arange(-300, 301, dtype=np.int32)
    want = np.asarray(jt5._relative_position_bucket(jnp.asarray(rel), bidirectional, buckets,
                                                    max_distance))
    got = tt5._relative_position_bucket(torch.from_numpy(rel).long(), bidirectional, buckets,
                                        max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    # every bucket is reached (bidirectional: all but the upper half's 0)
    assert len(np.unique(want)) == (buckets - 1 if bidirectional else buckets)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_encode_decode_forward_match_jax(models, tied, with_mask):
    jc, tc, jp, npp = models[tied]
    tp = params_from_numpy(npp, device="cpu")
    batch = _batch(1, jc.vocab_size)
    if not with_mask:
        del batch["attention_mask"]
    mask = batch.get("attention_mask")
    jenc = np.asarray(jt5.t5_encode(jp, jnp.asarray(batch["input_ids"]), jc,
                                    None if mask is None else jnp.asarray(mask)))
    tmask = None if mask is None else torch.from_numpy(mask)
    tenc = tt5.t5_encode(tp, torch.from_numpy(batch["input_ids"]), tc, tmask)
    np.testing.assert_allclose(tenc.numpy(), jenc, atol=1e-5, rtol=1e-5)
    jdec = np.asarray(jt5.t5_decode(jp, jnp.asarray(batch["decoder_input_ids"]),
                                    jnp.asarray(jenc), jc,
                                    None if mask is None else jnp.asarray(mask)))
    tdec = tt5.t5_decode(tp, torch.from_numpy(batch["decoder_input_ids"]),
                         torch.from_numpy(np.array(jenc)), tc, tmask)
    np.testing.assert_allclose(tdec.numpy(), jdec, atol=1e-5, rtol=1e-5)
    jlog = np.asarray(jax.jit(lambda p, b: jt5.t5_forward(p, b, jc))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    tlog = tt5.t5_forward(tp, _t(batch), tc)
    np.testing.assert_allclose(tlog.detach().numpy(), jlog, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_loss_and_grads_match_jax(models, tied):
    jc, tc, jp, npp = models[tied]
    batch = _batch(2, jc.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jt5.t5_loss(p, b, jc)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(npp, device="cpu")
    for t in param_leaves(tp):
        t.requires_grad_(True)
    loss = tt5.t5_loss(tp, _t(batch), tc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    want = named_parameters(jax.tree_util.tree_map(np.asarray, jg))
    got = named_parameters(tp)
    assert sorted(want) == sorted(got)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w, atol=1e-4 * np.abs(w).max(),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("eos,with_mask", [(None, False), (None, True), ("mid", True)],
                         ids=["plain", "mask", "eos"])
def test_greedy_generate_tokens_equal(models, eos, with_mask):
    jc, tc, jp, npp = models[False]
    tp = params_from_numpy(npp, device="cpu")
    batch = _batch(3, jc.vocab_size)
    mask = batch["attention_mask"] if with_mask else None
    kw = dict(max_new_tokens=6, decoder_start_token_id=0)
    want = np.asarray(jt5.t5_greedy_generate(
        jp, batch["input_ids"], jc, enc_mask=None if mask is None else jnp.asarray(mask), **kw))
    if eos == "mid":  # a token row 0 first emits mid-stream
        step = next(t for t in range(2, 6) if want[0, 1 + t] not in want[0, :1 + t])
        eos = int(want[0, 1 + step])
        want = np.asarray(jt5.t5_greedy_generate(jp, batch["input_ids"], jc, eos_token_id=eos,
                                                 enc_mask=jnp.asarray(mask), **kw))
        assert (want[0, 1 + step:] == eos).all()
    got = tt5.t5_greedy_generate(tp, batch["input_ids"], tc, eos_token_id=eos, enc_mask=mask,
                                 **kw)
    assert got.shape == (B, 1 + kw["max_new_tokens"])
    assert len(np.unique(want[:, 1:])) > 3  # the tokens vary
    np.testing.assert_array_equal(got.numpy(), want)


def test_adam_steps_through_prepare_train_step_match_jax(models):
    jc, tc, jp, npp = models[True]
    batches = [_batch(10 + k, jc.vocab_size) for k in range(3)]
    JAcceleratorState._reset_state(reset_partial_state=True)
    jacc = JAccelerator()
    jparams, jopt = jacc.prepare(jp, optax.adam(1e-3))
    jstep = jacc.prepare_train_step(lambda p, b: jt5.t5_loss(p, b, jc), jopt)
    state, jlosses = jopt.opt_state, []
    for b in batches:
        jparams, state, m = jstep(jparams, state, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))
    acc = Accelerator(cpu=True)
    tparams, opt = acc.prepare(params_from_numpy(npp, device="cpu"), adam(1e-3))
    step = acc.prepare_train_step(lambda p, b: tt5.t5_loss(p, b, tc), opt)
    state, tlosses = opt.opt_state, []
    for b in batches:
        tparams, state, m = step(tparams, state, _t(b))
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    want = named_parameters(jax.tree_util.tree_map(np.asarray, jparams))
    got, x0 = named_parameters(tparams), named_parameters(npp)
    for name, w in want.items():
        d_port, d_jax = got[name].detach().numpy() - x0[name], w - x0[name]
        rel = np.linalg.norm(d_port - d_jax) / np.linalg.norm(d_jax)
        assert rel <= 1e-3, f"{name}: update rel L2 err {rel}"


def test_init_layout_and_device_rule(models, monkeypatch):
    for tied in (True, False):
        jc, tc, _, npp = models[tied]
        tp = tt5.init_t5(tc, torch.Generator().manual_seed(0), device="cpu")
        assert jax.tree_util.tree_map(np.shape, npp) == jax.tree_util.tree_map(
            lambda t: tuple(t.shape), tp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt5.init_t5(tt5.T5Config.tiny())
