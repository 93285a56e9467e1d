"""Weight quantization of the port against ``accelerate_tpu.ops.
quantization`` on the CPU. Inputs come from ``np.random.default_rng``; the
Llama params from the JAX ``init_llama(..., PRNGKey(0))``, quantized by the
port and rebuilt as the JAX package's ``QuantizedArray`` from the same
codes and scales, so both sides run the same quantized weights;
``params_from_numpy`` carrying JAX's ``QuantizedArray`` into the port is
held bitwise in ``test_params_from_numpy_carries_jax_quantized_leaves``.

Tolerances: codes, scales and every dequantized tensor are bitwise (the
absmax and the divisions are f32 on both sides, both round half to even,
the NF4 search takes the first minimum on both). The int8 block partials
are exact int32 on both sides, so bitwise too; their f32 rescale and sum
over blocks run in another order, within 1e-6 relative. Forwards over
quantized params: f32 activations against bf16-dequantized weights, the
sums in another order, within 1e-5 of the largest logit. Greedy tokens and
the engine's streams are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jg
from accelerate_tpu.checkpointing import save_model as jsave_model
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.ops import quantization as JQ
from accelerate_tpu.serving import BucketLattice as JLattice
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.utils.modeling import total_byte_size as jtotal_byte_size
from accelerate_tpu_torch import generation as tg
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.ops import quantization as TQ
from accelerate_tpu_torch.optimizer import param_leaves
from accelerate_tpu_torch.serving import BucketLattice as TLattice
from accelerate_tpu_torch.serving import ServingEngine as TEngine
from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy
from accelerate_tpu_torch.utils.modeling import named_parameters, total_byte_size
from accelerate_tpu_torch.utils.quantization import load_and_quantize_model

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
INT8, NF4, FP4 = (dict(load_in_8bit=True), dict(load_in_4bit=True),
                  dict(load_in_4bit=True, quant_type="fp4"))


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(w, **kw):
    """(JAX QuantizedArray, port QuantizedArray) of the same numpy array."""
    return (JQ.quantize(jnp.asarray(w), JQ.QuantizationConfig(**kw)),
            TQ.quantize(torch.from_numpy(w), TQ.QuantizationConfig(**kw)))


def _same(jq, tq):
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    np.testing.assert_array_equal(tq.dequantize(torch.float32).numpy(),
                                  np.asarray(jq.dequantize(jnp.float32)))
    assert tq.shape == jq.shape and tq.bits == jq.bits and tq.quant_type == jq.quant_type


class TestBlockwise:
    @pytest.mark.parametrize("kind", ["int8", "nf4"])
    def test_zero_blocks_stay_finite(self, kind):
        kw = INT8 if kind == "int8" else NF4
        _same(*_both(np.zeros((64, 128), np.float32), **kw))
        mixed = np.concatenate([np.zeros((64, 64)), np.ones((64, 64))], axis=1).astype(np.float32)
        jq, tq = _both(mixed, **kw)
        _same(jq, tq)
        back = tq.dequantize(torch.float32)
        assert torch.isfinite(back).all() and float((back[:, 64:] - 1).abs().max()) < 0.1

    def test_non_divisible_block_size(self):
        jq, tq = _both(np.full((10, 100), 0.5, np.float32), **INT8)
        _same(jq, tq)
        assert float((tq.dequantize(torch.float32) - 0.5).abs().max()) < 1e-2

    def test_int8_roundtrip_error(self):
        w = _rand((128, 256))
        jq, tq = _both(w, **INT8)
        _same(jq, tq)
        err = np.abs(tq.dequantize(torch.float32).numpy() - w)
        assert err.max() < np.abs(w).max() / 100
        assert np.linalg.norm(err) / np.linalg.norm(w) < 0.01

    def test_nf4_roundtrip_error(self):
        w = _rand((128, 256))
        jq, tq = _both(w, **NF4)
        _same(jq, tq)
        assert np.linalg.norm(tq.dequantize(torch.float32).numpy() - w) / np.linalg.norm(w) < 0.12

    def test_nf4_beats_fp4_on_gaussian(self):
        w = _rand((256, 256))
        errs = {}
        for name, kw in (("nf4", NF4), ("fp4", FP4)):
            jq, tq = _both(w, **kw)
            _same(jq, tq)
            errs[name] = np.linalg.norm(tq.dequantize(torch.float32).numpy() - w)
        assert errs["nf4"] < errs["fp4"]

    def test_non_divisible_block(self):
        jq, tq = _both(_rand((7, 9)), **INT8, min_size=1)
        _same(jq, tq)
        assert tq.dequantize().shape == (7, 9) and tq.dequantize().dtype == torch.bfloat16

    def test_exact_zero_block(self):
        codes, scales = TQ.quantize_blockwise_int8(torch.zeros(64), 64)
        assert int(codes.abs().max()) == 0
        jpacked, jscales = JQ.quantize_blockwise_4bit(jnp.zeros((64,)), 64)
        packed, scales4 = TQ.quantize_blockwise_4bit(torch.zeros(64), 64)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
        assert torch.isfinite(scales4).all()


class TestQuantizedArray:
    def test_footprint(self):
        w = _rand((256, 256))
        for kw, share in ((INT8, 3), (NF4, 6)):
            jq, tq = _both(w, **kw)
            assert tq.nbytes_quantized == jq.nbytes_quantized < 256 * 256 * 4 / share

    def test_torch_function_protocol(self):
        """``x @ q`` and torch functions on a quantized leaf see its dequantized
        tensor, promoted as JAX promotes (f32 activations, bf16 weights →
        f32), equal to JAX's ``x @ q``."""
        w, x = _rand((64, 32)), _rand((8, 64), 1)
        jq, tq = _both(w, **INT8)
        out = torch.from_numpy(x) @ tq
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(jnp.asarray(x) @ jq), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out.numpy(), x @ w, atol=0.1, rtol=0.1)
        assert torch.equal(torch.matmul(torch.from_numpy(x), tq), out)
        assert torch.equal(torch.t(tq), tq.dequantize().t())
        assert (torch.from_numpy(x).bfloat16() @ tq).dtype == torch.bfloat16

    def test_leaf_moves_slices_and_counts_once(self):
        """The port's stand-in for the JAX test of a pytree through jit: the
        quantized leaf keeps int8 codes through ``.to``, is one leaf of
        ``param_leaves`` and ``named_parameters``, and ``q[i]``/``unbind``
        give the sliced-layer view that dequantizes to layer ``i``."""
        w = _rand((3, 64, 64))
        jq, tq = _both(w, **INT8, min_size=1)
        moved = tq.to("cpu")
        assert moved.codes.dtype == torch.int8 and moved.scales.dtype == torch.float32
        tree = {"a": {"w": tq}, "b": torch.ones(2)}
        assert len(param_leaves(tree)) == 2 and param_leaves(tree)[0] is tq
        assert list(named_parameters(tree)) == ["a/w", "b"]
        for i, layer in enumerate(tq.unbind(0)):
            assert layer.codes.dim() == 1 and layer.shape == (3, 64, 64)
            np.testing.assert_array_equal(layer.dequantize(torch.float32).numpy(),
                                          np.asarray(jq.dequantize(jnp.float32))[i])
            assert torch.equal(tq[i].dequantize(), layer.dequantize())
        assert tq[:2].dequantize().shape == (2, 64, 64)


class TestQuantizeParams:
    def _params(self):
        return {"embed": {"embedding": _rand((512, 64))},
                "layer": {"wq": {"kernel": _rand((64, 64), 1)},
                          "norm": {"scale": np.ones((64,), np.float32)}},
                "lm_head": {"kernel": _rand((64, 512), 2)}}

    def _pair(self, **kw):
        p = self._params()
        jp = JQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, p),
                                JQ.QuantizationConfig(**kw))
        tp = TQ.quantize_params(jax.tree_util.tree_map(torch.from_numpy, p),
                                TQ.QuantizationConfig(**kw))
        return p, jp, tp

    def test_skip_modules_and_small_leaves(self):
        _, jp, tp = self._pair(**INT8, min_size=1024)
        assert isinstance(tp["layer"]["wq"]["kernel"], TQ.QuantizedArray)
        _same(jp["layer"]["wq"]["kernel"], tp["layer"]["wq"]["kernel"])
        for path in (("embed", "embedding"), ("lm_head", "kernel"), ("layer", "norm", "scale")):
            node = tp
            for k in path:
                node = node[k]
            assert isinstance(node, torch.Tensor)

    def test_dequantize_params_roundtrip(self):
        p, jp, tp = self._pair(**INT8, min_size=1024)
        back = TQ.dequantize_params(tp, torch.float32)
        np.testing.assert_array_equal(back["layer"]["wq"]["kernel"].numpy(), np.asarray(
            JQ.dequantize_params(jp, jnp.float32)["layer"]["wq"]["kernel"]))
        np.testing.assert_allclose(back["layer"]["wq"]["kernel"].numpy(),
                                   p["layer"]["wq"]["kernel"], atol=0.05)

    def test_nothing_quantized_raises(self):
        with pytest.raises(ValueError, match="nothing was quantized"):
            TQ.quantize_params({"w": torch.ones(64, 64)},
                               TQ.QuantizationConfig(**INT8, min_size=10 ** 9))

    def test_byte_size_accounting(self):
        p, jp, tp = self._pair(**INT8, min_size=1024)
        assert TQ.quantized_byte_size(tp) == JQ.quantized_byte_size(jp)
        dense = jax.tree_util.tree_map(torch.from_numpy, p)
        assert total_byte_size(dense) == jtotal_byte_size(p)
        assert TQ.quantized_byte_size(tp) < total_byte_size(dense)
        # a quantized leaf counts as one leaf of its dense shape and dtype, as in JAX
        assert total_byte_size(tp) == jtotal_byte_size(jp)


class TestInt8Matmul:
    def test_kblock_matmul_close_to_dense(self):
        w, x = _rand((256, 128)), _rand((16, 256), 3)
        jw = JQ.quantize_int8_matmul_weight(jnp.asarray(w), block_size=64)
        tw = TQ.quantize_int8_matmul_weight(torch.from_numpy(w), block_size=64)
        _same(jw, tw)
        partials, x_scale = TQ.int8_block_partials(torch.from_numpy(x), tw)
        x_q = np.clip(np.round(x / np.asarray(x_scale)), -127, 127).astype(np.int8)
        want = np.einsum("rbk,bkn->brn", x_q.reshape(16, 4, 64).astype(np.int64),
                         np.asarray(jw.codes).astype(np.int64))
        np.testing.assert_array_equal(partials.numpy(), want)
        out = TQ.int8_dynamic_matmul(torch.from_numpy(x), tw, preferred_dtype=torch.float32)
        jout = JQ.int8_dynamic_matmul(jnp.asarray(x), jw, preferred_dtype=jnp.float32)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
        assert np.linalg.norm(out.numpy() - x @ w) / np.linalg.norm(x @ w) < 0.02

    def test_kblock_dequantize(self):
        w = _rand((100, 40))
        jw = JQ.quantize_int8_matmul_weight(jnp.asarray(w), block_size=64)
        tw = TQ.quantize_int8_matmul_weight(torch.from_numpy(w), block_size=64)
        _same(jw, tw)
        assert np.linalg.norm(tw.dequantize(torch.float32).numpy() - w) / np.linalg.norm(w) < 0.01

    def test_fallback_for_flat_layout(self):
        """A weight in the flat layout is dequantized and multiplied, the
        JAX function's own semantics."""
        w, x = _rand((64, 32)), _rand((4, 64), 5)
        jq, tq = _both(w, **INT8)
        out = TQ.int8_dynamic_matmul(torch.from_numpy(x), tq)
        assert out.shape == (4, 32)
        np.testing.assert_allclose(out.float().numpy(), np.asarray(
            JQ.int8_dynamic_matmul(jnp.asarray(x), jq), np.float32), rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ Llama ends --
JCFG, TCFG = jt.LlamaConfig.tiny(), tt.LlamaConfig.tiny()


def _to_jax(tree):
    """The port's tree as the JAX package's: each ``QuantizedArray`` rebuilt
    from its codes and scales (bitwise JAX's own, the tests above), each
    tensor as an array."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, TQ.QuantizedArray):
        return JQ.QuantizedArray(jnp.asarray(tree.codes.numpy()), jnp.asarray(tree.scales.numpy()),
                                 tree.shape, jnp.bfloat16, tree.bits, tree.block_size,
                                 tree.quant_type)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def quantized_llama():
    """The JAX-made tiny Llama quantized by the port, and the same leaves
    as the JAX package's ``QuantizedArray``s."""
    tp = params_from_numpy(jt.init_llama(JCFG, jax.random.PRNGKey(0)), **CPU)
    out = {}
    for name, kw in (("int8", INT8), ("nf4", NF4)):
        tq = TQ.quantize_params(tp, TQ.QuantizationConfig(**kw))
        out[name] = (_to_jax(tq), tq)
    return out


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_quantized_llama_forward(quantized_llama, kind):
    jq, tq = quantized_llama[kind]
    assert isinstance(tq["layers"]["wq"]["kernel"], TQ.QuantizedArray)
    ids = np.random.default_rng(0).integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    want = np.asarray(jt.llama_forward(jq, jnp.asarray(ids), JCFG, attention_impl="xla"),
                      np.float32)
    got = tt.llama_forward(tq, torch.from_numpy(ids), TCFG, attention_impl="xla")
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_quantized_generate_and_engine_match_jax(quantized_llama):
    """``greedy_generate`` and the serving engine over NF4 params, token for
    token the JAX package's with the same quantized leaves (f32 cache); the
    int8 leaves take the same code path (``test_quantized_llama_forward``
    holds both kinds)."""
    prompt = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 8)).astype(np.int32)
    jq, tq = quantized_llama["nf4"]
    want = jg.greedy_generate(jq, prompt, JCFG, max_new_tokens=6, cache_dtype=jnp.float32)
    got = tg.greedy_generate(tq, prompt, TCFG, max_new_tokens=6, cache_dtype=torch.float32, **CPU)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    kw = dict(num_blocks=16, block_size=8, max_slots=2)
    buckets = dict(slot_buckets=(2,), block_buckets=(4,), prefill_buckets=(16,))
    je = JEngine(jq, JCFG, cache_dtype=jnp.float32, lattice=JLattice(**buckets), **kw)
    te = TEngine(tq, TCFG, cache_dtype=torch.float32, lattice=TLattice(**buckets), **CPU, **kw)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, JCFG.vocab_size, n) for n in (5, 11, 7)]
    jr, tr = [je.submit(p, 6) for p in prompts], [te.submit(p, 6) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(b.output_ids(), a.output_ids())


def test_load_and_quantize_model(tmp_path):
    """A checkpoint written by the JAX package's ``save_model`` loads and
    quantizes into the JAX package's codes and scales."""
    params = {"blk": {"w": jnp.asarray(_rand((128, 128)))}, "norm": {"s": jnp.ones((8,))}}
    jsave_model(params, str(tmp_path))
    cfg = dict(**INT8, min_size=1024)
    jq, jindex = JQ.quantize_params(params, JQ.QuantizationConfig(**cfg)), {}
    template = {"blk": {"w": torch.empty(128, 128)}, "norm": {"s": torch.empty(8)}}
    tq, index = load_and_quantize_model(template, TQ.QuantizationConfig(**cfg),
                                        checkpoint=str(tmp_path), execution_device="cpu")
    assert index == jindex == {}
    _same(jq["blk"]["w"], tq["blk"]["w"])
    assert torch.equal(tq["norm"]["s"], torch.ones(8))
    unloaded, none_index = load_and_quantize_model(
        {"w": torch.from_numpy(_rand((64, 64)))}, TQ.QuantizationConfig(**cfg))
    assert none_index == {} and isinstance(unloaded["w"], TQ.QuantizedArray)


class TestStackedLeaves:
    def test_stacked_2d_vector_scan(self):
        L, D = 4, 2048
        stacked = {"kern": _rand((L, 64, 64)), "vec": _rand((L, D), 9)}
        jq = JQ.quantize_params({"layers": jax.tree_util.tree_map(jnp.asarray, stacked)},
                                JQ.QuantizationConfig(**INT8, min_size=1024))["layers"]
        tq = TQ.quantize_params({"layers": jax.tree_util.tree_map(torch.from_numpy, stacked)},
                                TQ.QuantizationConfig(**INT8, min_size=1024))["layers"]
        assert isinstance(tq["vec"], TQ.QuantizedArray)
        _same(jq["vec"], tq["vec"])
        total = sum(float(layer["vec"].dequantize(torch.float32).sum()
                          + layer["kern"].dequantize(torch.float32).sum())
                    for layer in tt._layer_trees(tq, L))
        ref = float(stacked["vec"].sum() + stacked["kern"].sum())
        np.testing.assert_allclose(total, ref, rtol=0.02)

    def test_stacked_4d_scan_dequant(self):
        L, w = 3, _rand((3, 8, 16, 33))
        jq, tq = _both(w, **INT8, min_size=1024)
        _same(jq, tq)
        per_layer = [layer.dequantize(torch.float32).numpy() for layer in tq.unbind(0)]
        np.testing.assert_allclose(np.stack(per_layer), w, atol=0.05)
        assert len(per_layer) == L

    def test_none_and_host_leaves_pass_through(self):
        host = np.zeros((8, 8), np.float32)
        q = TQ.quantize_params({"a": {"w": torch.from_numpy(_rand((128, 128)))},
                                "disk": {"w": None}, "host": {"w": host}},
                               TQ.QuantizationConfig(**INT8, min_size=1024))
        assert q["disk"]["w"] is None and q["host"]["w"] is host
        assert isinstance(q["a"]["w"], TQ.QuantizedArray)


class TestStructurePreservation:
    def test_list_nodes_survive(self):
        q = TQ.quantize_params({"layers": [torch.from_numpy(_rand((64, 64), i)) for i in (0, 1)]},
                               TQ.QuantizationConfig(**INT8, min_size=1024))
        assert isinstance(q["layers"], list) and isinstance(q["layers"][0], TQ.QuantizedArray)

    def test_single_layer_stack_scans(self):
        w = _rand((1, 64, 64))
        jq, tq = _both(w, **INT8, min_size=1024)
        _same(jq, tq)
        (only,) = tq.unbind(0)
        np.testing.assert_allclose(float(only.dequantize(torch.float32).sum()), float(w.sum()),
                                   rtol=0.02)

    def test_cast_to_compute_preserves_scales(self):
        q = TQ.quantize_params({"w": torch.from_numpy(_rand((64, 64))),
                                "fp8_meta": {"x_hist": torch.ones(16)}},
                               TQ.QuantizationConfig(**INT8, min_size=1024))
        cast = MixedPrecisionPolicy.from_precision("bf16").cast_to_compute(q)
        assert cast["w"] is q["w"] and cast["w"].scales.dtype == torch.float32
        assert cast["fp8_meta"]["x_hist"].dtype == torch.float32


def test_params_from_numpy_carries_jax_quantized_leaves():
    """A JAX ``QuantizedArray`` leaf crosses into the port's class with its
    codes, scales and fields, and fp8 meta keeps f32 under a ``dtype``."""
    jq = JQ.quantize_params({"w": jnp.asarray(_rand((3, 64, 64))), "fp8_meta": {
        "x_hist": jnp.ones(16)}}, JQ.QuantizationConfig(**NF4, min_size=1024))
    tq = params_from_numpy(jq, dtype=torch.bfloat16, **CPU)
    _same(jq["w"], tq["w"])
    assert tq["w"].dtype == torch.bfloat16 and tq["fp8_meta"]["x_hist"].dtype == torch.float32
