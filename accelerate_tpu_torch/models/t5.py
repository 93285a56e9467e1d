"""T5-style encoder-decoder in PyTorch: the port of
``accelerate_tpu.models.t5``.

Params keep the JAX layout: per-layer tensors stacked on a leading layer
axis, one relative-position bucket table per stack (``[buckets, heads]``)
outside the layer stack, and the shared embedding, so weights made by the
JAX initializer load unchanged through :mod:`.convert`.

The arithmetic follows the JAX package's: T5LayerNorm is :func:`rms_norm`;
attention (:func:`_attn`) has no ``1/sqrt(d)`` scale, adds the f32 bias to
the logits in f32, fills masked slots with ``-1e9``, takes the softmax in
f32 and casts the probabilities to ``q``'s dtype before the value product.
The products are plain ``einsum``s, as JAX computes this attention outside
any Pallas kernel (SDPA would move where the mask and the rounding fall).
The bucket function takes its ``log`` in f32 and truncates toward zero, as
``astype(int32)`` does. The FFN is ``relu``; the tied head rescales the
hidden state by ``dim ** -0.5`` before the shared-embedding product.

:func:`t5_greedy_generate` runs the encoder once and the decoder over the
whole target prefix each step (the JAX package's full-forward semantics,
exact under causal masking), with no host read until the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .transformer import _layer_trees, rms_norm

__all__ = [
    "T5Config",
    "init_t5",
    "relative_position_bias",
    "t5_decode",
    "t5_encode",
    "t5_forward",
    "t5_greedy_generate",
    "t5_loss",
    "t5_shard_rules",
]


@dataclass(frozen=True)
class T5Config:
    """Same fields and defaults as the JAX package's ``T5Config``
    (``unroll_layers`` is carried for parity and ignored)."""

    vocab_size: int = 32128
    dim: int = 512
    n_layers: int = 6  # per stack (encoder and decoder)
    n_heads: int = 8
    ffn_dim: int = 2048
    head_dim: int = 64
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    unroll_layers: bool = True

    @classmethod
    def small(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, ffn_dim=128,
                   head_dim=16, rel_pos_buckets=8, rel_pos_max_distance=32)


def _relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """T5's log-bucketed relative positions, as int64. The large-distance
    branch is computed in f32 (constants rounded to f32, as JAX takes
    them) and truncated toward zero."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = torch.float32
    scaled = (torch.log(n.clamp(min=1).to(f32) / torch.tensor(max_exact, dtype=f32))
              / torch.tensor(float(np.float32(np.log(max_distance / max_exact))), dtype=f32)
              * torch.tensor(num_buckets - max_exact, dtype=f32))
    val_if_large = (max_exact + scaled.to(torch.int32).long()).clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def relative_position_bias(table: torch.Tensor, sq: int, sk: int, *, bidirectional: bool,
                           config: T5Config, q_offset: int = 0) -> torch.Tensor:
    """``[1, H, sq, sk]`` additive bias from the bucket table ``[buckets,
    H]``; ``q_offset`` positions the query block."""
    ctx = torch.arange(sq, device=table.device)[:, None] + q_offset
    mem = torch.arange(sk, device=table.device)[None, :]
    buckets = _relative_position_bucket(mem - ctx, bidirectional, config.rel_pos_buckets,
                                        config.rel_pos_max_distance)
    # F.embedding, not indexing: the backward of [sq, sk] lookups into a
    # table of a few dozen rows is one segmented sum, where indexing's
    # accumulating backward serialises on each row
    return torch.nn.functional.embedding(buckets, table).permute(2, 0, 1)[None]


def init_t5(config: T5Config, generator: Optional[torch.Generator] = None, device=None,
            dtype: torch.dtype = torch.float32) -> dict:
    """Params with the JAX ``init_t5`` tree and scales: stacked projections
    ``N(0, 1/in_dim)``, embedding and bucket tables ``N(0, 1)``, the untied
    head ``N(0, 1/dim)``, norm scales one. Draws come from ``generator`` (a
    fresh one seeded 0 on the target device when omitted), so they differ
    from JAX's threefry draws."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, F = config.n_layers, config.dim, config.ffn_dim
    H = config.n_heads * config.head_dim

    def dense(*shape, scale):
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def stack(a, b):
        return {"kernel": dense(L, a, b, scale=a ** -0.5)}

    def ones(*shape):
        return {"scale": torch.ones(*shape, device=dev, dtype=dtype)}

    def block():
        return {"wq": stack(D, H), "wk": stack(D, H), "wv": stack(D, H), "wo": stack(H, D)}

    def rel_pos():
        return {"embedding": dense(config.rel_pos_buckets, config.n_heads, scale=1.0)}

    params = {
        "shared_embedding": {"embedding": dense(config.vocab_size, D, scale=1.0)},
        "encoder": {
            "rel_pos": rel_pos(),
            "layers": {"attn_norm": ones(L, D), "attn": block(), "mlp_norm": ones(L, D),
                       "wi": stack(D, F), "wo": stack(F, D)},
            "final_norm": ones(D),
        },
        "decoder": {
            "rel_pos": rel_pos(),
            "layers": {"self_norm": ones(L, D), "self_attn": block(), "cross_norm": ones(L, D),
                       "cross_attn": block(), "mlp_norm": ones(L, D), "wi": stack(D, F),
                       "wo": stack(F, D)},
            "final_norm": ones(D),
        },
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(D, config.vocab_size, scale=D ** -0.5)}
    return params


def _heads(x: torch.Tensor, config: T5Config) -> torch.Tensor:
    return x.reshape(*x.shape[:2], config.n_heads, config.head_dim)


def _attn(q, k, v, bias: Optional[torch.Tensor], mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Bias-additive attention with no ``1/sqrt(d)`` scale: ``bias``
    ``[1, H, Sq, Sk]`` (None adds nothing), ``mask`` a boolean keep-mask
    broadcastable to ``[B, H, Sq, Sk]`` or None."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _keep(enc_mask) -> Optional[torch.Tensor]:
    return None if enc_mask is None else (enc_mask[:, None, None, :] > 0)


def _proj(x, entry):
    return x @ entry["kernel"]


def _embed(params: dict, ids: torch.Tensor) -> torch.Tensor:
    """The shared-embedding lookup. ``F.embedding``'s backward sums each
    token's rows in one segmented reduction, where indexing's backward
    accumulates through a sort of every index."""
    return torch.nn.functional.embedding(ids.long(), params["shared_embedding"]["embedding"])


def t5_encode(params: dict, input_ids: torch.Tensor, config: T5Config,
              enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder stack → hidden states ``[B, S, D]``."""
    S = input_ids.shape[1]
    enc = params["encoder"]
    h = _embed(params, input_ids)
    bias = relative_position_bias(enc["rel_pos"]["embedding"], S, S, bidirectional=True,
                                  config=config)
    keep = _keep(enc_mask)
    for lp in _layer_trees(enc["layers"], config.n_layers):
        x = rms_norm(h, lp["attn_norm"]["scale"], config.norm_eps)
        a = lp["attn"]
        q, k, v = (_heads(_proj(x, a[n]), config) for n in ("wq", "wk", "wv"))
        h = h + _proj(_attn(q, k, v, bias, keep).flatten(2), a["wo"])
        x = rms_norm(h, lp["mlp_norm"]["scale"], config.norm_eps)
        h = h + _proj(torch.relu(_proj(x, lp["wi"])), lp["wo"])
    return rms_norm(h, enc["final_norm"]["scale"], config.norm_eps)


def t5_decode(params: dict, decoder_ids: torch.Tensor, enc_out: torch.Tensor, config: T5Config,
              enc_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decoder stack over the whole target sequence → logits ``[B, St,
    vocab]``. The cross-attention has no bias (JAX adds zeros)."""
    St = decoder_ids.shape[1]
    dec = params["decoder"]
    h = _embed(params, decoder_ids)
    self_bias = relative_position_bias(dec["rel_pos"]["embedding"], St, St, bidirectional=False,
                                       config=config)
    causal = torch.ones((St, St), dtype=torch.bool, device=h.device).tril()[None, None]
    cross_keep = _keep(enc_mask)
    for lp in _layer_trees(dec["layers"], config.n_layers):
        x = rms_norm(h, lp["self_norm"]["scale"], config.norm_eps)
        a = lp["self_attn"]
        q, k, v = (_heads(_proj(x, a[n]), config) for n in ("wq", "wk", "wv"))
        h = h + _proj(_attn(q, k, v, self_bias, causal).flatten(2), a["wo"])
        x = rms_norm(h, lp["cross_norm"]["scale"], config.norm_eps)
        c = lp["cross_attn"]
        q = _heads(_proj(x, c["wq"]), config)
        k, v = (_heads(_proj(enc_out, c[n]), config) for n in ("wk", "wv"))
        h = h + _proj(_attn(q, k, v, None, cross_keep).flatten(2), c["wo"])
        x = rms_norm(h, lp["mlp_norm"]["scale"], config.norm_eps)
        h = h + _proj(torch.relu(_proj(x, lp["wi"])), lp["wo"])
    h = rms_norm(h, dec["final_norm"]["scale"], config.norm_eps)
    if config.tie_word_embeddings:
        # the scalar takes h's dtype first, as JAX's weak-typed multiply
        scale = torch.tensor(config.dim ** -0.5, dtype=h.dtype, device=h.device)
        return (h * scale) @ params["shared_embedding"]["embedding"].T
    return h @ params["lm_head"]["kernel"]


def t5_forward(params: dict, batch: dict, config: T5Config) -> torch.Tensor:
    """``batch``: ``input_ids [B, Se]``, ``decoder_input_ids [B, St]``,
    optional ``attention_mask [B, Se]`` → logits ``[B, St, vocab]``."""
    enc_mask = batch.get("attention_mask")
    enc_out = t5_encode(params, batch["input_ids"], config, enc_mask)
    return t5_decode(params, batch["decoder_input_ids"], enc_out, config, enc_mask)


def t5_loss(params: dict, batch: dict, config: T5Config, mesh=None) -> torch.Tensor:
    """Seq2seq cross entropy over ``labels [B, St]`` (``-100`` ignored),
    log-softmax in f32, divided by ``max(valid count, 1)``. With ``mesh``
    the rows are one rank's and the count is the global batch's
    (:func:`~..parallel.sharding.global_mean`), as the JAX package's loss
    over its global batch counts it."""
    logits = t5_forward(params, batch, config)
    labels = batch["labels"].long()
    valid = (labels != -100).float()
    safe = torch.where(labels == -100, 0, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    from ..parallel.sharding import global_mean

    return global_mean((nll * valid).sum(), valid.sum(), mesh)


@torch.no_grad()
def t5_greedy_generate(params: dict, input_ids, config: T5Config, max_new_tokens: int = 32,
                       decoder_start_token_id: int = 0, eos_token_id: Optional[int] = None,
                       enc_mask=None) -> torch.Tensor:
    """Greedy seq2seq decoding: decoder ids ``[B, 1 + max_new_tokens]`` (the
    start token first) on the params' device; host arrays go there too.
    Step i runs the decoder over the prefix ``ids[:, :i+1]`` and writes the
    argmax (first index on ties) at ``i+1``; with ``eos_token_id`` a row
    that emitted it keeps emitting it."""
    dev = params["shared_embedding"]["embedding"].device

    def place(a):
        return a.to(dev) if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a).astype(np.int64)).to(dev)

    input_ids = place(input_ids)
    enc_mask = None if enc_mask is None else place(enc_mask)
    enc_out = t5_encode(params, input_ids, config, enc_mask)
    B = input_ids.shape[0]
    ids = torch.full((B, 1 + max_new_tokens), decoder_start_token_id, dtype=torch.long,
                     device=dev)
    finished = torch.zeros(B, dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        logits = t5_decode(params, ids[:, :i + 1], enc_out, config, enc_mask)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        if eos_token_id is not None:
            nxt = torch.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        ids[:, i + 1] = nxt
    return ids


def t5_shard_rules():
    """The JAX package's TP rules for the stacked layout (dim 0 is the
    layer stack)."""
    from ..parallel.sharding import PartitionSpec as P
    from ..parallel.sharding import ShardingRules

    return ShardingRules([
        (r"(attn|self_attn|cross_attn)/(wq|wk|wv)/kernel", P(None, None, "tp")),
        (r"(attn|self_attn|cross_attn)/wo/kernel", P(None, "tp", None)),
        (r"layers/wi/kernel", P(None, None, "tp")),
        (r"layers/wo/kernel", P(None, "tp", None)),
        (r"shared_embedding/embedding", P("tp", None)),
        (r"lm_head/kernel", P(None, "tp")),
        (r"(norm|rel_pos)", P()),
    ])
