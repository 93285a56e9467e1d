"""The port's BERT against the JAX package's, at ``BertConfig.tiny()``.

Params come from the JAX initializer (``init_bert(config, PRNGKey(0))``)
and cross through ``params_from_numpy(device="cpu")``; batches are numpy
arrays from a seed, with padded rows of different lengths. Everything is
f32 on the CPU, so the two sides differ only in the order of their sums:
logits, loss and every gradient leaf are held within 1e-5 of the largest
magnitude of the JAX value (at least 1e-2 for the gradients, which are
small: an absolute 1e-7 floor).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy, params_to_numpy

JCFG = jt.BertConfig.tiny()
TCFG = tt.BertConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jp = jt.init_bert(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _batch(seed=0, B=4, S=128):
    rng = np.random.default_rng(seed)
    lens = rng.integers(S // 3, S + 1, B)
    lens[0] = S
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return {
        "input_ids": rng.integers(0, JCFG.vocab_size, (B, S)).astype(np.int32),
        "token_type_ids": (np.arange(S)[None] >= S // 2).repeat(B, 0).astype(np.int32),
        "attention_mask": mask,
        "labels": rng.integers(0, 2, B).astype(np.int32),
    }


def _close(got, want, floor):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * max(floor, float(np.abs(want).max())), err


def test_config_fields_match():
    j_fields = {f.name: f.default for f in dataclasses.fields(jt.BertConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(tt.BertConfig)}
    assert j_fields == t_fields
    for j, t in ((JCFG, TCFG), (jt.BertConfig.base(), tt.BertConfig.base())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t) and j.head_dim == t.head_dim
    base = tt.BertConfig.base()
    assert (base.vocab_size, base.dim, base.n_layers, base.n_heads, base.head_dim,
            base.ffn_dim) == (30522, 768, 12, 12, 64, 3072)


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 128)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal((2, 128)).astype(np.float32)
    want = jt.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-12)
    got = tt.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-12)
    _close(got, want, 1.0)
    # bf16 input: statistics in f32, the normalised value rounded to bf16
    xb = torch.from_numpy(x).bfloat16()
    got_b = tt.layer_norm(xb, torch.from_numpy(s).bfloat16(), torch.from_numpy(b).bfloat16())
    want_b = jt.layer_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(s).astype(jnp.bfloat16),
                           jnp.asarray(b).astype(jnp.bfloat16))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(got_b.float().numpy(), np.asarray(want_b.astype(jnp.float32)),
                               atol=2 ** -5, rtol=2 ** -6)


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_bert_logits_loss_and_grads_match(params, impl):
    jp, tp = params
    batch = _batch(2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(tt.bert_forward(tp, tbatch, TCFG, attention_impl=impl),
           jt.bert_forward(jp, jbatch, JCFG, attention_impl=impl), 1.0)

    j_loss, j_grads = jax.value_and_grad(
        lambda p: jt.bert_loss(p, jbatch, JCFG, attention_impl=impl))(jp)
    # leaves in JAX's tree order (sorted keys) on both sides
    tp = jax.tree_util.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    t_loss = tt.bert_loss(tp, tbatch, TCFG, attention_impl=impl)
    grads = torch.autograd.grad(t_loss, jax.tree_util.tree_leaves(tp))
    _close(t_loss, j_loss, 1.0)
    j_leaves = jax.tree_util.tree_leaves_with_path(j_grads)
    assert len(j_leaves) == len(grads)
    for (path, jg), tg in zip(j_leaves, grads):
        assert tuple(tg.shape) == jg.shape, path
        _close(tg, jg, 1e-2)


def test_init_bert_layout_matches_jax():
    """Same tree, shapes and scales as the JAX initializer (the draws
    differ: torch's generator is not threefry)."""
    tp = tt.init_bert(TCFG, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax.eval_shape(lambda: jt.init_bert(JCFG, jax.random.PRNGKey(0)))
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), jparams)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), tp) == jshapes
    assert abs(float(tp["layers"]["fc1"]["kernel"].std()) - 0.02) < 0.002
    assert float(tp["layers"]["wq"]["bias"].abs().max()) == 0.0
    assert torch.equal(tp["layers"]["mlp_norm"]["scale"], torch.ones(2, 128))
    again = tt.init_bert(TCFG, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embeddings"]["word"]["embedding"],
                       tp["embeddings"]["word"]["embedding"])
    back = params_to_numpy(tp)
    assert back["classifier"]["kernel"].shape == (128, 2)


def test_fp8_recipe_is_not_ported():
    """The name is older than the port of the recipe: BERT's fp8 init now
    carries the JAX package's meta tree (a zero f32 history of 16 per role
    and layer on each of the six projections)."""
    tp = tt.init_bert(dataclasses.replace(TCFG, dtype_recipe="fp8"), device="cpu",
                      dtype=torch.bfloat16)
    jp = jax.eval_shape(lambda: jt.init_bert(dataclasses.replace(JCFG, dtype_recipe="fp8"),
                                             jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), jp) == jax.tree_util.tree_map(
        lambda x: tuple(x.shape), tp)
    for name in ("wq", "wk", "wv", "wo", "fc1", "fc2"):
        for hist in tp["layers"][name]["fp8_meta"].values():
            assert hist.dtype == torch.float32 and not hist.any()
    assert "fp8_meta" not in tp["pooler"]
