"""The port's Llama pieces against the JAX package's, at ``LlamaConfig.tiny()``.

Params come from the JAX initializer (``init_llama(config, PRNGKey(0))``)
and cross through :func:`params_from_numpy`; inputs are numpy arrays from a
seed. Everything is f32 on the CPU, so the two sides differ only in the
order of their sums: elementwise pieces are held at atol 1e-6, the full
forward's logits at rtol 1e-5 with atol 1e-5 (logits near 0 have no
meaningful relative error).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy, params_to_numpy

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _layer(jp, tp, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], jp["layers"]), tt.layer_params(tp, i)


def test_config_fields_and_derived_sizes_match():
    import dataclasses

    j_fields = {f.name: f.default for f in dataclasses.fields(jt.LlamaConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(tt.LlamaConfig)}
    assert j_fields == t_fields
    big = dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8, max_seq_len=512)
    for j, t in ((JCFG, TCFG), (jt.LlamaConfig(**big), tt.LlamaConfig(**big))):
        assert (j.head_dim, j.hidden_dim) == (t.head_dim, t.hidden_dim)
    assert tt.LlamaConfig(**big).hidden_dim == 5632 and tt.LlamaConfig(**big).head_dim == 64


def test_rms_norm():
    x = _rng(0).standard_normal((2, 5, 128)).astype(np.float32)
    s = _rng(1).standard_normal(128).astype(np.float32)
    ref = jt.rms_norm(jnp.asarray(x), jnp.asarray(s))
    ours = tt.rms_norm(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("with_positions", [False, True])
def test_apply_rope_half_split(with_positions):
    x = _rng(2).standard_normal((2, 6, 4, 32)).astype(np.float32)
    cos, sin = jt.rope_frequencies(32, 64)
    tcos, tsin = tt.rope_frequencies(32, 64)
    np.testing.assert_array_equal(cos, tcos)
    pos = _rng(3).integers(0, 64, (2, 6)) if with_positions else None
    ref = jt.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin),
                        positions=None if pos is None else jnp.asarray(pos))
    ours = tt.apply_rope(torch.from_numpy(x), torch.from_numpy(tcos), torch.from_numpy(tsin),
                         positions=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6, rtol=0)


def test_project_qkv(params):
    jp, tp = params
    jl, tl = _layer(jp, tp, 1)
    x = _rng(4).standard_normal((2, 5, JCFG.dim)).astype(np.float32)
    pos = _rng(5).integers(0, 200, (2, 5))
    cos, sin = jt.rope_frequencies(JCFG.head_dim, JCFG.max_seq_len)
    ref = jgen._project_qkv(jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(cos),
                            jnp.asarray(sin), JCFG)
    ours = tgen._project_qkv(tl, torch.from_numpy(x), torch.from_numpy(pos),
                             torch.from_numpy(cos), torch.from_numpy(sin), TCFG)
    for a, b in zip(ours, ref):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5, rtol=0)


def test_llama_ffn(params):
    jp, tp = params
    jl, tl = _layer(jp, tp, 0)
    x = _rng(6).standard_normal((2, 3, JCFG.dim)).astype(np.float32)
    ref, ref_aux = jt.llama_ffn(jl, jnp.asarray(x), JCFG)
    ours, aux = tt.llama_ffn(tl, torch.from_numpy(x), TCFG)  # (y, aux), as JAX's
    np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-5, rtol=1e-5)
    assert float(aux) == float(ref_aux) == 0.0


def test_masked_attention_core():
    rng = _rng(7)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    allow = rng.random((2, 1, 3, 9)) < 0.6
    allow[..., 0] = True
    ref = jgen._masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(allow))
    ours = tgen._masked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(allow))
    np.testing.assert_allclose(_np(ours), _np(ref), atol=1e-6, rtol=0)


def test_llama_forward_logits(params):
    jp, tp = params
    ids = _rng(8).integers(0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    ref = jt.llama_forward(jp, jnp.asarray(ids), JCFG, attention_impl="xla")
    ours = tt.llama_forward(tp, torch.from_numpy(ids).long(), TCFG)
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-5, atol=1e-5)


def test_params_roundtrip_and_layout(params):
    jp, tp = params
    back = params_to_numpy(tp)
    j_leaves = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jp))
    b_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in j_leaves] == [p for p, _ in b_leaves]
    for (_, a), (_, b) in zip(j_leaves, b_leaves):
        np.testing.assert_array_equal(a, b)
    bf = params_from_numpy(jax.tree_util.tree_map(lambda x: np.asarray(x.astype(jnp.bfloat16)), jp),
                           device="cpu")
    assert bf["layers"]["wq"]["kernel"].dtype == torch.bfloat16


def test_init_llama_layout_matches_jax():
    """Same tree, shapes and scales as the JAX initializer (the draws
    differ: torch's generator is not threefry)."""
    tp = tt.init_llama(TCFG, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                     jax.eval_shape(lambda: jt.init_llama(JCFG, jax.random.PRNGKey(0))))
    tshapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), tp)
    assert jshapes == tshapes
    wq = tp["layers"]["wq"]["kernel"]
    assert abs(float(wq.std()) - 1 / np.sqrt(TCFG.dim)) < 0.01
    assert abs(float(tp["lm_head"]["kernel"].std()) - 0.02) < 0.002
    again = tt.init_llama(TCFG, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["w2"]["kernel"], tp["layers"]["w2"]["kernel"])


def test_unported_features_raise():
    # MoE is ported: the init's tree is JAX's, and the forward equals JAX's
    jmoe = jt.LlamaConfig(vocab_size=64, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,
                          moe_experts=4)
    moe = tt.LlamaConfig(vocab_size=64, dim=64, n_layers=1, n_heads=2, n_kv_heads=1,
                         moe_experts=4)
    tp = tt.init_llama(moe, torch.Generator().manual_seed(0), device="cpu")
    jp = jt.init_llama(jmoe, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), jp) == jax.tree_util.tree_map(
        lambda x: tuple(x.shape), tp)
    ids = np.random.default_rng(0).integers(0, 64, (2, 8)).astype(np.int32)
    want = np.asarray(jt.llama_forward(jp, jnp.asarray(ids), jmoe))
    got = tt.llama_forward(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                             device="cpu"), torch.from_numpy(ids), moe)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # fp8 with MoE layers raises ValueError in both packages' init
    with pytest.raises(ValueError, match="MoE"):
        jt.init_llama(dataclasses.replace(jmoe, dtype_recipe="fp8"), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="MoE"):
        tt.init_llama(dataclasses.replace(moe, dtype_recipe="fp8"), device="cpu")
