"""Weights across the two packages: the JAX param pytree (every leaf as a
numpy array) to the port's tree of tensors, and back. Dicts, lists and
tuples are nodes, as in a JAX pytree, and keep their container type.
Layouts are the same on both sides — stacked layers, ``[in, out]``
kernels — so conversion only changes the container, never the semantics
of an axis."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.operations import _tree_map

__all__ = ["bert_params_from_hf", "llama_params_from_hf", "params_from_numpy", "params_to_numpy",
           "t5_params_from_hf"]


def _torch_dtype(dtype) -> torch.dtype:
    """A numpy or ml_dtypes dtype (or scalar type) as the torch dtype of
    the same name."""
    return getattr(torch, np.dtype(dtype).name)


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict/list/tuple of array-likes → the same nesting (same
    container types) of tensors on ``device`` (the CUDA device when omitted;
    raises without a GPU unless ``device="cpu"``), cast to ``dtype`` when
    given. fp8 meta (under an ``fp8_meta`` key) keeps its f32 whatever
    ``dtype`` says, and a JAX ``QuantizedArray`` leaf (codes, scales and its
    static fields) becomes the port's
    :class:`~..ops.quantization.QuantizedArray`, its codes and scales
    unchanged."""
    from ..ops.quantization import QuantizedArray

    dev = resolve_device(device)

    def leaf(x, cast):
        arr = np.array(x, copy=True)
        # numpy has no native bf16: such leaves arrive as an extension
        # dtype torch cannot wrap, so they cross as (exact) f32
        native = torch.bfloat16 if arr.dtype.name == "bfloat16" else None
        if native is not None:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(arr)
        return t.to(device=dev, dtype=cast or native or t.dtype)

    def walk(node, in_meta):
        if isinstance(node, dict):
            return type(node)((k, walk(v, in_meta or k == "fp8_meta")) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            mapped = [walk(v, in_meta) for v in node]
            return type(node)(*mapped) if hasattr(node, "_fields") else type(node)(mapped)
        if all(hasattr(node, a) for a in ("codes", "scales", "bits", "block_size",
                                          "quant_type")):
            return QuantizedArray(leaf(node.codes, None), leaf(node.scales, None), node.shape,
                                  _torch_dtype(node.dtype), node.bits, node.block_size,
                                  node.quant_type)
        return leaf(node, None if in_meta else dtype)

    return walk(tree, False)


def params_to_numpy(params):
    """Inverse of :func:`params_from_numpy`: every tensor to a host numpy
    array (bf16 goes through f32, which numpy can hold exactly)."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _tree_map(leaf, params)


# ---------------------------------------------------- HF checkpoints --
# The JAX package's converters of HF checkpoints to the native trees: torch
# ``[out, in]`` linears transposed to ``[in, out]``, per-layer tensors
# stacked on a leading ``[L, ...]`` axis. Each takes an ``nn.Module``, a
# mapping of tensors or arrays, or a ``.safetensors`` path (read by the
# port's own reader, one tensor at a time over a memmap). Values keep their
# dtype; only the tied T5 head is rescaled (by ``dim ** -0.5``, in its
# dtype), as in the JAX package.


def _getter(source):
    """``(keys, get, close)`` of a weight source; ``get(name)`` is a CPU
    tensor."""
    if isinstance(source, str):
        from ..utils.modeling import load_safetensors

        tensors = load_safetensors(source)
        return list(tensors), tensors.__getitem__, lambda: None
    if hasattr(source, "state_dict") and callable(source.state_dict):
        source = source.state_dict()
    if isinstance(source, Mapping):
        def get(k):
            v = source[k]
            if isinstance(v, torch.Tensor):
                return v.detach().cpu()
            arr = np.asarray(v)
            if arr.dtype == np.dtype("V2") or arr.dtype.name == "bfloat16":
                return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            return torch.from_numpy(np.array(arr))

        return list(source.keys()), get, lambda: None
    raise TypeError(f"unsupported weight source: {type(source)!r}")


def _stack_t(get, fmt: str, L: int) -> torch.Tensor:
    """L per-layer torch ``[out, in]`` linears → ``[L, in, out]``."""
    return torch.stack([get(fmt.format(i)).T for i in range(L)])


def _stack_raw(get, fmt: str, L: int) -> torch.Tensor:
    """L per-layer tensors stacked on a leading ``[L, ...]`` axis."""
    return torch.stack([get(fmt.format(i)) for i in range(L)])


def _placed(tree, device):
    dev = resolve_device(device)
    return _tree_map(lambda t: t.contiguous().to(dev), tree)


def _assert_not_dropping_head(keys, get, embedding, head_key: str, what: str):
    """Tied config + checkpoint carrying a DISTINCT head: refuse to silently
    discard the head weights (the reverse direction is handled by folding)."""
    if head_key not in keys:
        return
    head = get(head_key)
    if head.shape == embedding.shape and torch.equal(head, embedding):
        return  # materialized tied duplicate — nothing lost
    raise ValueError(
        f"checkpoint has a distinct {head_key} but the target {what} config is "
        "tied (tie embeddings=False to keep the checkpoint's head)"
    )


def llama_params_from_hf(source, config, device=None) -> dict:
    """HF ``LlamaForCausalLM`` weights → an ``init_llama`` tree on ``device``."""
    keys, get, close = _getter(source)
    try:
        return _placed(_llama_params(keys, get, config), device)
    finally:
        close()


def _llama_params(keys, get, config) -> dict:
    prefix = "model." if any(k.startswith("model.") for k in keys) else ""
    L = config.n_layers

    def stack_t(fmt):
        return _stack_t(get, fmt, L)

    def stack_raw(fmt):
        return _stack_raw(get, fmt, L)

    p = prefix
    params = {
        "embed_tokens": {"embedding": get(f"{p}embed_tokens.weight")},
        "layers": {
            "attn_norm": {"scale": stack_raw(p + "layers.{}.input_layernorm.weight")},
            "wq": {"kernel": stack_t(p + "layers.{}.self_attn.q_proj.weight")},
            "wk": {"kernel": stack_t(p + "layers.{}.self_attn.k_proj.weight")},
            "wv": {"kernel": stack_t(p + "layers.{}.self_attn.v_proj.weight")},
            "wo": {"kernel": stack_t(p + "layers.{}.self_attn.o_proj.weight")},
            "mlp_norm": {"scale": stack_raw(p + "layers.{}.post_attention_layernorm.weight")},
            "w1": {"kernel": stack_t(p + "layers.{}.mlp.gate_proj.weight")},
            "w3": {"kernel": stack_t(p + "layers.{}.mlp.up_proj.weight")},
            "w2": {"kernel": stack_t(p + "layers.{}.mlp.down_proj.weight")},
        },
        "final_norm": {"scale": get(f"{p}norm.weight")},
    }
    if not config.tie_embeddings:
        head_key = "lm_head.weight"
        if head_key in keys:
            params["lm_head"] = {"kernel": get(head_key).T}
        else:  # HF tied checkpoint loaded into an untied config
            params["lm_head"] = {"kernel": params["embed_tokens"]["embedding"].T}
    else:
        _assert_not_dropping_head(
            keys, get, params["embed_tokens"]["embedding"], "lm_head.weight", "Llama"
        )
    return params


def bert_params_from_hf(source, config, device=None) -> dict:
    """HF ``BertForSequenceClassification`` weights → an ``init_bert`` tree
    on ``device``."""
    keys, get, close = _getter(source)
    try:
        return _placed(_bert_params(keys, get, config), device)
    finally:
        close()


def _bert_params(keys, get, config) -> dict:
    prefix = "bert." if any(k.startswith("bert.") for k in keys) else ""
    L = config.n_layers
    p = prefix

    def stack_t(fmt):
        return _stack_t(get, fmt, L)

    def stack_raw(fmt):
        return _stack_raw(get, fmt, L)

    enc = p + "encoder.layer.{}."
    return {
        "embeddings": {
            "word": {"embedding": get(f"{p}embeddings.word_embeddings.weight")},
            "position": {"embedding": get(f"{p}embeddings.position_embeddings.weight")},
            "token_type": {"embedding": get(f"{p}embeddings.token_type_embeddings.weight")},
            "norm": {"scale": get(f"{p}embeddings.LayerNorm.weight"),
                     "bias": get(f"{p}embeddings.LayerNorm.bias")},
        },
        "layers": {
            "wq": {"kernel": stack_t(enc + "attention.self.query.weight"),
                   "bias": stack_raw(enc + "attention.self.query.bias")},
            "wk": {"kernel": stack_t(enc + "attention.self.key.weight"),
                   "bias": stack_raw(enc + "attention.self.key.bias")},
            "wv": {"kernel": stack_t(enc + "attention.self.value.weight"),
                   "bias": stack_raw(enc + "attention.self.value.bias")},
            "wo": {"kernel": stack_t(enc + "attention.output.dense.weight"),
                   "bias": stack_raw(enc + "attention.output.dense.bias")},
            "attn_norm": {"scale": stack_raw(enc + "attention.output.LayerNorm.weight"),
                          "bias": stack_raw(enc + "attention.output.LayerNorm.bias")},
            "fc1": {"kernel": stack_t(enc + "intermediate.dense.weight"),
                    "bias": stack_raw(enc + "intermediate.dense.bias")},
            "fc2": {"kernel": stack_t(enc + "output.dense.weight"),
                    "bias": stack_raw(enc + "output.dense.bias")},
            "mlp_norm": {"scale": stack_raw(enc + "output.LayerNorm.weight"),
                         "bias": stack_raw(enc + "output.LayerNorm.bias")},
        },
        "pooler": {"kernel": get(f"{p}pooler.dense.weight").T,
                   "bias": get(f"{p}pooler.dense.bias")},
        "classifier": {"kernel": get("classifier.weight").T,
                       "bias": get("classifier.bias")},
    }


def t5_params_from_hf(source, config, device=None) -> dict:
    """HF ``T5ForConditionalGeneration`` weights → an ``init_t5`` tree on
    ``device``."""
    keys, get, close = _getter(source)
    try:
        return _placed(_t5_params(keys, get, config), device)
    finally:
        close()


def _t5_params(keys, get, config) -> dict:
    L = config.n_layers

    def stack_t(fmt):
        return _stack_t(get, fmt, L)

    def stack_raw(fmt):
        return _stack_raw(get, fmt, L)

    def attn_block(stem, hf_attn):
        return {
            "wq": {"kernel": stack_t(f"{stem}.{hf_attn}.q.weight")},
            "wk": {"kernel": stack_t(f"{stem}.{hf_attn}.k.weight")},
            "wv": {"kernel": stack_t(f"{stem}.{hf_attn}.v.weight")},
            "wo": {"kernel": stack_t(f"{stem}.{hf_attn}.o.weight")},
        }

    params = {
        "shared_embedding": {"embedding": get("shared.weight")},
        "encoder": {
            "rel_pos": {"embedding": get(
                "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
            )},
            "layers": {
                "attn_norm": {"scale": stack_raw("encoder.block.{}.layer.0.layer_norm.weight")},
                "attn": attn_block("encoder.block.{}.layer.0", "SelfAttention"),
                "mlp_norm": {"scale": stack_raw("encoder.block.{}.layer.1.layer_norm.weight")},
                "wi": {"kernel": stack_t("encoder.block.{}.layer.1.DenseReluDense.wi.weight")},
                "wo": {"kernel": stack_t("encoder.block.{}.layer.1.DenseReluDense.wo.weight")},
            },
            "final_norm": {"scale": get("encoder.final_layer_norm.weight")},
        },
        "decoder": {
            "rel_pos": {"embedding": get(
                "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
            )},
            "layers": {
                "self_norm": {"scale": stack_raw("decoder.block.{}.layer.0.layer_norm.weight")},
                "self_attn": attn_block("decoder.block.{}.layer.0", "SelfAttention"),
                "cross_norm": {"scale": stack_raw("decoder.block.{}.layer.1.layer_norm.weight")},
                "cross_attn": attn_block("decoder.block.{}.layer.1", "EncDecAttention"),
                "mlp_norm": {"scale": stack_raw("decoder.block.{}.layer.2.layer_norm.weight")},
                "wi": {"kernel": stack_t("decoder.block.{}.layer.2.DenseReluDense.wi.weight")},
                "wo": {"kernel": stack_t("decoder.block.{}.layer.2.DenseReluDense.wo.weight")},
            },
            "final_norm": {"scale": get("decoder.final_layer_norm.weight")},
        },
    }
    if not config.tie_word_embeddings:
        # tied HF checkpoints into an untied config: HF's tied forward rescales
        # hidden states by d^-0.5 before the shared projection; our untied
        # forward does not, so the rescale folds into the kernel. A tied
        # checkpoint shows up either as a MISSING lm_head tensor (safetensors
        # drops shared storage) or as a byte-identical duplicate of shared
        # (state_dict materializes both names).
        shared = params["shared_embedding"]["embedding"]
        if "lm_head.weight" in keys:
            head = get("lm_head.weight")
            kernel = head.T
            if head.shape == shared.shape and torch.equal(head, shared):
                kernel = kernel * (config.dim ** -0.5)
            params["lm_head"] = {"kernel": kernel}
        else:
            params["lm_head"] = {"kernel": shared.T * (config.dim ** -0.5)}
    else:
        _assert_not_dropping_head(
            keys, get, params["shared_embedding"]["embedding"], "lm_head.weight", "T5"
        )
    return params
