"""The port's HF checkpoint converters against the JAX package's, bitwise.

State dicts with HF's names and shapes are made from
``np.random.default_rng`` for Llama (tied and untied heads), BERT and T5
(tied, whose untied target folds HF's ``d ** -0.5`` rescale into the head,
and untied). Each goes through the JAX package's converter as numpy and
through the port's from four sources: the numpy dict, a dict of tensors, a
``.safetensors`` file written by the port's writer and read by its reader,
and an ``nn.Module`` holding the weights as parameters. Every leaf must
equal JAX's exactly: a converter transposes, stacks and, for the T5 head,
multiplies by one f32 scalar, all exact or rounded alike.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from accelerate_tpu.models import convert as jconvert
from accelerate_tpu.models import t5 as jt5
from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch.models import convert
from accelerate_tpu_torch.sharded_checkpoint import flatten_with_path
from accelerate_tpu_torch.utils.modeling import save_safetensors


def _llama_sd(cfg, rng, head: bool):
    D, F, hd = cfg.dim, cfg.hidden_dim, cfg.head_dim
    sd = {"model.embed_tokens.weight": (cfg.vocab_size, D), "model.norm.weight": (D,)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": (D,), p + "post_attention_layernorm.weight": (D,),
                   p + "self_attn.q_proj.weight": (cfg.n_heads * hd, D),
                   p + "self_attn.k_proj.weight": (cfg.n_kv_heads * hd, D),
                   p + "self_attn.v_proj.weight": (cfg.n_kv_heads * hd, D),
                   p + "self_attn.o_proj.weight": (D, cfg.n_heads * hd),
                   p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D),
                   p + "mlp.down_proj.weight": (D, F)})
    if head:
        sd["lm_head.weight"] = (cfg.vocab_size, D)
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def _bert_sd(cfg, rng):
    D, F = cfg.dim, cfg.ffn_dim
    sd = {"bert.embeddings.word_embeddings.weight": (cfg.vocab_size, D),
          "bert.embeddings.position_embeddings.weight": (cfg.max_seq_len, D),
          "bert.embeddings.token_type_embeddings.weight": (cfg.type_vocab_size, D),
          "bert.embeddings.LayerNorm.weight": (D,), "bert.embeddings.LayerNorm.bias": (D,),
          "bert.pooler.dense.weight": (D, D), "bert.pooler.dense.bias": (D,),
          "classifier.weight": (cfg.num_labels, D), "classifier.bias": (cfg.num_labels,)}
    for i in range(cfg.n_layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[p + f"attention.self.{name}.weight"] = (D, D)
            sd[p + f"attention.self.{name}.bias"] = (D,)
        sd.update({p + "attention.output.dense.weight": (D, D),
                   p + "attention.output.dense.bias": (D,),
                   p + "attention.output.LayerNorm.weight": (D,),
                   p + "attention.output.LayerNorm.bias": (D,),
                   p + "intermediate.dense.weight": (F, D), p + "intermediate.dense.bias": (F,),
                   p + "output.dense.weight": (D, F), p + "output.dense.bias": (D,),
                   p + "output.LayerNorm.weight": (D,), p + "output.LayerNorm.bias": (D,)})
    return {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}


def _t5_sd(cfg, rng, head: str):
    D, F, inner = cfg.dim, cfg.ffn_dim, cfg.n_heads * cfg.head_dim
    sd = {"shared.weight": (cfg.vocab_size, D), "encoder.final_layer_norm.weight": (D,),
          "decoder.final_layer_norm.weight": (D,)}
    for stack, blocks in (("encoder", (("SelfAttention", 0),)),
                          ("decoder", (("SelfAttention", 0), ("EncDecAttention", 1)))):
        sd[f"{stack}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            cfg.rel_pos_buckets, cfg.n_heads)
        for i in range(cfg.n_layers):
            for attn, j in blocks:
                p = f"{stack}.block.{i}.layer.{j}."
                sd[p + "layer_norm.weight"] = (D,)
                for w in ("q", "k", "v"):
                    sd[p + f"{attn}.{w}.weight"] = (inner, D)
                sd[p + f"{attn}.o.weight"] = (D, inner)
            j = len(blocks)
            p = f"{stack}.block.{i}.layer.{j}."
            sd.update({p + "layer_norm.weight": (D,), p + "DenseReluDense.wi.weight": (F, D),
                       p + "DenseReluDense.wo.weight": (D, F)})
    out = {k: rng.normal(size=s).astype(np.float32) for k, s in sd.items()}
    if head == "duplicate":  # a state_dict of a tied model: the head is shared's copy
        out["lm_head.weight"] = out["shared.weight"].copy()
    elif head == "distinct":
        out["lm_head.weight"] = rng.normal(size=(cfg.vocab_size, D)).astype(np.float32)
    return out


class _Weights(torch.nn.Module):
    """An ``nn.Module`` whose parameters carry the dotted names of ``sd``."""

    def __init__(self, sd):
        super().__init__()
        for name, value in sd.items():
            *path, leaf = name.split(".")
            node = self
            for part in path:
                if not hasattr(node, part):
                    node.add_module(part, torch.nn.Module())
                node = getattr(node, part)
            node.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(value.copy())))


def _sources(sd, tmp_path):
    path = str(tmp_path / "weights.safetensors")
    save_safetensors(sd, path)
    return {"numpy": sd, "tensors": {k: torch.from_numpy(v.copy()) for k, v in sd.items()},
            "safetensors": path, "module": _Weights(sd)}


def _assert_same(got, want):
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    got = dict(flatten_with_path(got))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].is_contiguous()
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


SOURCES = ["numpy", "tensors", "safetensors", "module"]


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_llama_params_from_hf(source, tied, tmp_path):
    jcfg = dataclasses.replace(jt.LlamaConfig.tiny(), tie_embeddings=tied)
    sd = _llama_sd(jcfg, np.random.default_rng(0), head=not tied)
    want = jconvert.llama_params_from_hf(sd, jcfg)
    got = convert.llama_params_from_hf(_sources(sd, tmp_path)[source], jcfg, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("source", SOURCES)
def test_bert_params_from_hf(source, tmp_path):
    jcfg = jt.BertConfig.tiny()
    sd = _bert_sd(jcfg, np.random.default_rng(1))
    want = jconvert.bert_params_from_hf(sd, jcfg)
    got = convert.bert_params_from_hf(_sources(sd, tmp_path)[source], jcfg, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("case", [(False, "missing"), (False, "duplicate"), (False, "distinct"),
                                  (True, "missing")],
                         ids=["untied-rescaled", "untied-duplicate", "untied-own-head", "tied"])
def test_t5_params_from_hf(source, case, tmp_path):
    tied, head = case
    jcfg = dataclasses.replace(jt5.T5Config.tiny(), tie_word_embeddings=tied)
    sd = _t5_sd(jcfg, np.random.default_rng(2), head)
    want = jconvert.t5_params_from_hf(sd, jcfg)
    got = convert.t5_params_from_hf(_sources(sd, tmp_path)[source], jcfg, device="cpu")
    _assert_same(got, want)


def test_tied_config_refuses_a_distinct_head(tmp_path):
    jcfg = dataclasses.replace(jt.LlamaConfig.tiny(), tie_embeddings=True)
    sd = _llama_sd(jcfg, np.random.default_rng(0), head=True)
    with pytest.raises(ValueError, match="distinct lm_head.weight"):
        jconvert.llama_params_from_hf(sd, jcfg)
    with pytest.raises(ValueError, match="distinct lm_head.weight"):
        convert.llama_params_from_hf(sd, jcfg, device="cpu")
