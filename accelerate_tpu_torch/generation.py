"""KV-cache decoding: the port of ``accelerate_tpu.generation``.

Two paths, after the two ways params can live:

- :func:`greedy_generate`, :func:`sample_generate`, :func:`beam_generate` —
  resident params: the cache is a stacked ``[L, B, max_len, Hkv, D]`` pair
  written in place, and the whole decode loop runs on the device with no
  host read per token (the tokens are read once at the end). As in the JAX
  package there is no early exit: a row that emitted ``eos_token_id`` keeps
  emitting it.
- :func:`generate_dispatched` — offloaded params (a
  :class:`~accelerate_tpu_torch.big_modeling.DispatchedParams` over
  :func:`unstack_layer_params`'s stages): each forward pages the layers
  through the execution device, prefetching one layer ahead, with a cache
  per layer; the greedy token is read each step, so decoding stops when
  every row has finished.

The attention is the plain einsum core :func:`_masked_attention`, shared
with the serving engine's plain paged path — the JAX package's generation
path reaches no Pallas kernel either. Greedy selection is a plain
``torch.argmax`` (first index on ties, as ``jnp.argmax``);
:func:`sample_token_logits` samples from the threefry streams of
:mod:`.utils.random`, which reproduce ``jax.random``'s bits exactly, so a
sampled stream draws the JAX package's tokens from the same key (up to the
last bit of ``log`` in the Gumbel noise: a near-tie of two perturbed logits
can break the other way). Multi-device decode (``mesh=``) is not ported.
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import Optional

import numpy as np
import torch

from .models.transformer import (
    LlamaConfig,
    _check_supported,
    apply_rope,
    layer_params,
    llama_ffn,
    lm_logits,
    rms_norm,
    rope_frequencies,
)
from .utils.device import resolve_device
from .utils.random import fold_in, gumbel

__all__ = [
    "beam_generate",
    "generate_dispatched",
    "generation_shardings",
    "greedy_generate",
    "init_kv_cache",
    "sample_generate",
    "sample_token_logits",
    "serving_shardings",
    "unstack_layer_params",
]

_MESH_NOT_PORTED = ("multi-device decode (mesh=, generation_shardings, serving_shardings) is "
                    "not ported yet: it comes with ROADMAP.md Queue A item 6")


def init_kv_cache(config: LlamaConfig, batch_size: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Stacked cache ``{"k", "v"}: [L, B, max_len, Hkv, D]`` of zeros on
    ``device`` (the CUDA device when omitted)."""
    shape = (config.n_layers, batch_size, max_len, config.n_kv_heads, config.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def generation_shardings(mesh, batch_size: int, config: LlamaConfig):
    raise NotImplementedError(_MESH_NOT_PORTED)


def serving_shardings(mesh, config: LlamaConfig):
    raise NotImplementedError(_MESH_NOT_PORTED)


def _masked_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      allow: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, S, H, D]`` against caches ``[B, T, Hkv, D]`` under a boolean
    ``allow`` mask broadcastable to ``[B, H, S, T]``. Scores and softmax are
    f32; masked slots get the ``finfo(f32).min`` fill, which underflows to an
    exact 0 weight after the max-subtraction. Probabilities are cast to
    ``q.dtype`` before the value product, as in the reference."""
    B, S, H, D = q.shape
    hkv = k_cache.shape[2]
    if hkv != H:
        rep = H // hkv
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    logits = logits.masked_fill(~allow, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache.to(q.dtype))


def _project_qkv(layer: dict, x: torch.Tensor, positions: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, config: LlamaConfig):
    """x ``[B, S, dim]`` at per-row ``positions [B, S]`` → ``(q, k, v)`` in
    BSHD with RoPE applied to q and k."""
    B, S, _ = x.shape
    q = (x @ layer["wq"]["kernel"]).reshape(B, S, config.n_heads, config.head_dim)
    k = (x @ layer["wk"]["kernel"]).reshape(B, S, config.n_kv_heads, config.head_dim)
    v = (x @ layer["wv"]["kernel"]).reshape(B, S, config.n_kv_heads, config.head_dim)
    q = apply_rope(q, cos, sin, positions=positions)
    k = apply_rope(k, cos, sin, positions=positions)
    return q, k, v


def _cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      q_positions: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """q ``[B, S, H, D]`` against caches ``[B, max_len, Hkv, D]``, each query
    at ``q_positions [S]`` attending causally to every cache slot at or
    before its position."""
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    allow = kv_pos[None, :] <= q_positions[:, None]  # [S, max_len]
    return _masked_attention(q, k_cache, v_cache, allow[None, None], scale)


def _rope(config: LlamaConfig, device):
    return tuple(torch.from_numpy(t).to(device) for t in
                 rope_frequencies(config.head_dim, config.max_seq_len, config.rope_theta))


def _layer_step(layer: dict, h: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                start: int, cos: torch.Tensor, sin: torch.Tensor, config: LlamaConfig):
    """One decoder layer over the S tokens of ``h [B, S, dim]`` at positions
    ``start .. start+S-1``, writing their k/v into the caches ``[B, max_len,
    Hkv, D]`` in place; returns the new ``h``. ``start`` is a host int (the JAX step takes a
    traced position; here the host knows every position, so no value is
    read back). ``jax.lax.dynamic_update_slice`` would clamp a start that
    overruns ``max_len``, where this slice assignment raises; no call of
    this module reaches that case, since every cache is sized to the prompt
    plus the new tokens."""
    B, S, _ = h.shape
    positions = torch.arange(start, start + S, device=h.device)
    x = rms_norm(h, layer["attn_norm"]["scale"], config.norm_eps)
    q, k, v = _project_qkv(layer, x, positions[None].expand(B, S), cos, sin, config)
    k_cache[:, start:start + S] = k.to(k_cache.dtype)
    v_cache[:, start:start + S] = v.to(v_cache.dtype)
    attn = _cached_attention(q, k_cache, v_cache, positions)
    h = h + attn.reshape(B, S, -1) @ layer["wo"]["kernel"]
    x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
    y, _ = llama_ffn(layer, x, config, capacity_factor=decode_capacity(config, S))
    return h + y


def decode_capacity(config: LlamaConfig, S: int) -> Optional[float]:
    """The MoE capacity factor of a cached step over ``S`` tokens, as the
    JAX package sets it: a decode step (``S == 1``) routes only its B new
    tokens as one small group, where the training factor would drop tokens
    the full forward keeps, so the factor is floored at ``E / top_k``
    (every token fits); a prefill keeps the config's factor (None)."""
    if config.moe_experts > 0 and S == 1:
        return max(config.moe_capacity_factor, config.moe_experts / config.moe_top_k)
    return None


def _forward_cached(params: dict, ids: torch.Tensor, cache: dict, start_pos: int,
                    config: LlamaConfig, rope=None, layers=None) -> torch.Tensor:
    """Forward the S tokens of ``ids [B, S]`` from ``start_pos`` against the
    stacked cache (written in place): logits ``[B, S, vocab]``. ``rope``
    (the cos/sin tables on the device) and ``layers`` (each layer's views)
    may be passed in to build them once per generation call."""
    cos, sin = rope if rope is not None else _rope(config, ids.device)
    if layers is None:
        layers = [layer_params(params, i) for i in range(config.n_layers)]
    h = params["embed_tokens"]["embedding"][ids]
    for i, layer in enumerate(layers):
        h = _layer_step(layer, h, cache["k"][i], cache["v"][i], start_pos, cos, sin, config)
    return lm_logits(params, h, config)


def sample_token_logits(logits: torch.Tensor, keys: torch.Tensor, *, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """One sampling step over ``logits [B, V]`` with one threefry key per
    row (``keys [B, 2]``, :mod:`.utils.random`): temperature scaling, then
    top-k truncation, then nucleus (top-p), then the Gumbel-max draw of
    ``jax.random.categorical``, in the JAX package's order.
    ``temperature == 0`` is greedy argmax. Returns int64 ``[B]``; no value
    is read back to the host.

    ``keys`` of shape ``[2]`` is one key for the whole ``[B, V]`` draw, as
    the JAX package's generation loop passes it: under
    ``jax_threefry_partitionable`` the noise of shape ``(B, V)`` is the
    flat counter ``0 .. B*V-1`` through that key, row-major."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    # a device tensor, not a Python scalar: CUDA divides by a host scalar
    # through its reciprocal, which rounds differently from a division
    logits = logits.float() / torch.tensor(temperature, dtype=torch.float32,
                                           device=logits.device)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=logits.device)
    if top_k and top_k > 0:
        k = min(top_k, logits.shape[-1])  # HF clamps an oversize top_k
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # the smallest prefix reaching mass >= top_p (always keeps a token);
        # past the end, JAX's gather fills NaN and keeps every value, as the
        # last (smallest) value does here
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    B, V = logits.shape
    noise = gumbel(keys[None], B * V).reshape(B, V) if keys.dim() == 1 else gumbel(keys, V)
    return torch.argmax(logits + noise, dim=-1)


def _prompt_tensor(prompt_ids, device):
    """``(prompt on the device, prompt on the host as numpy)``."""
    if isinstance(prompt_ids, torch.Tensor):
        host = prompt_ids.detach().cpu().numpy()
    else:
        host = np.asarray(prompt_ids)
    if host.ndim != 2:
        raise ValueError(f"prompt_ids must be [batch, seq], got shape {host.shape}")
    return torch.from_numpy(host.astype(np.int64)).to(device), host


def _as_key(rng_key, device) -> torch.Tensor:
    """A threefry key (``utils.random.prng_key``, or the two uint32 words of
    a ``jax.random.PRNGKey`` as any array) as an int64 tensor ``[2]``."""
    if rng_key is None:
        return torch.tensor([0, 0], dtype=torch.int64, device=device)  # PRNGKey(0)
    if isinstance(rng_key, torch.Tensor):
        return rng_key.to(device=device, dtype=torch.int64).reshape(2)
    return torch.from_numpy(np.asarray(rng_key).astype(np.int64).reshape(2)).to(device)


def _stats(prefill_s: float, decode_s: float, n_decoded: int, batch: int) -> dict:
    n_decoded = max(n_decoded, 1)
    return {
        "prefill_seconds": prefill_s,
        "decode_tokens_per_sec": n_decoded * batch / max(decode_s, 1e-9),
        "seconds_per_token": decode_s / n_decoded,
    }


@torch.no_grad()
def _cached_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens: int,
                     eos_token_id: Optional[int], cache_dtype, return_stats: bool, warmup: bool,
                     select, rng_key, mesh=None, device=None):
    """The shared KV-cache decode: one prefill, then the decode loop on the
    device. ``select(logits [B, V], key [2]) -> [B]`` picks each token; the
    key of step i is ``fold_in(rng_key, i)`` (step 0 the prefill's), all
    folded at once on the device, so no step waits on the host. The
    tokens are read back once, after the loop."""
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    _check_supported(config)
    dev = resolve_device(device)
    prompt, prompt_host = _prompt_tensor(prompt_ids, dev)
    B, S = prompt.shape
    max_len = S + max_new_tokens
    rope = _rope(config, dev)
    layers = [layer_params(params, i) for i in range(config.n_layers)]
    key = _as_key(rng_key, dev)
    keys = fold_in(key[None].expand(max_new_tokens, 2),
                   torch.arange(max_new_tokens, device=dev))  # [max_new, 2]

    def prefill(cache):
        logits = _forward_cached(params, prompt, cache, 0, config, rope, layers)
        return select(logits[:, -1], keys[0])

    def decode_all(cache, first_tok):
        tok = first_tok
        finished = (first_tok == eos_token_id if eos_token_id is not None
                    else torch.zeros(B, dtype=torch.bool, device=dev))
        toks = []
        for i in range(1, max_new_tokens):
            logits = _forward_cached(params, tok[:, None], cache, S + i - 1, config, rope, layers)
            nxt = select(logits[:, -1], keys[i])
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished = finished | (nxt == eos_token_id)
            toks.append(nxt)
            tok = nxt
        if not toks:
            return torch.zeros((B, 0), dtype=torch.int64, device=dev)
        return torch.stack(toks, dim=1)  # [B, max_new_tokens-1]

    if warmup and max_new_tokens > 1:
        cache_w = init_kv_cache(config, B, max_len, cache_dtype, dev)
        decode_all(cache_w, prefill(cache_w)).cpu()
        del cache_w

    cache = init_kv_cache(config, B, max_len, cache_dtype, dev)
    t0 = time.perf_counter()
    first_tok = prefill(cache)
    first_host = first_tok.cpu().numpy()  # waits for the prefill, for its time
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    rest = decode_all(cache, first_tok).cpu().numpy()
    decode_s = time.perf_counter() - t0
    generated = np.concatenate([prompt_host, first_host[:, None].astype(prompt_host.dtype),
                                rest.astype(prompt_host.dtype)], axis=1)
    if return_stats:
        return generated, _stats(prefill_s, decode_s, max_new_tokens - 1, B)
    return generated


def _greedy(logits: torch.Tensor, key) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def greedy_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens: int = 32,
                    eos_token_id: Optional[int] = None, cache_dtype: torch.dtype = torch.bfloat16,
                    return_stats: bool = False, warmup: bool = False, mesh=None, device=None):
    """KV-cache greedy decoding of resident params on ``device`` (the CUDA
    device when omitted). Returns the ids ``[B, S_prompt + max_new_tokens]``
    as a numpy array of the prompt's dtype, with a stats dict (prefill
    seconds, decode tokens/s, seconds/token) when ``return_stats``;
    ``warmup`` runs the whole decode once first, so the timed run starts
    warm."""
    return _cached_generate(params, prompt_ids, config, max_new_tokens, eos_token_id,
                            cache_dtype, return_stats, warmup, select=_greedy, rng_key=None,
                            mesh=mesh, device=device)


def sample_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens: int = 32,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0, rng_key=None,
                    eos_token_id: Optional[int] = None, cache_dtype: torch.dtype = torch.bfloat16,
                    return_stats: bool = False, warmup: bool = False, mesh=None, device=None):
    """KV-cache sampled decoding (temperature, then top-k, then nucleus
    top-p): step i draws with one key, ``fold_in(rng_key, i)``, for the
    whole batch, as the JAX package does, so the same key, prompt and knobs
    give the JAX package's tokens. ``rng_key`` is ``utils.random.
    prng_key(seed)`` or a ``jax.random.PRNGKey``'s two words (``PRNGKey(0)``
    when omitted); ``temperature=0`` is greedy."""
    return _cached_generate(params, prompt_ids, config, max_new_tokens, eos_token_id,
                            cache_dtype, return_stats, warmup,
                            select=partial(sample_token_logits, temperature=temperature,
                                           top_k=top_k, top_p=top_p),
                            rng_key=rng_key, mesh=mesh, device=device)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest values of the last axis, ties to the
    lower index. ``torch.topk`` promises no order among ties, and a frozen
    beam's row of ``-inf`` makes ties certain, so this takes the first k of
    a stable descending sort."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


@torch.no_grad()
def beam_generate(params, prompt_ids, config: LlamaConfig, num_beams: int = 4,
                  max_new_tokens: int = 32, eos_token_id: Optional[int] = None,
                  length_penalty: float = 1.0, cache_dtype: torch.dtype = torch.bfloat16,
                  return_scores: bool = False, mesh=None, device=None):
    """KV-cache beam search, the JAX package's algorithm: prefill at batch B,
    tile the cache to ``B * num_beams``, then each step extends every live
    beam over the vocab, keeps the best ``num_beams`` of ``num_beams * V``
    candidates and reorders the cache by the survivors' parents. A beam
    that emitted ``eos_token_id`` is frozen (its only continuation is eos
    at log-prob 0). The final ranking divides each score by its generated
    length to the power ``length_penalty``. Returns the best beam's ids
    ``[B, S_prompt + max_new_tokens]`` (numpy, the prompt's dtype), and its
    normalised score ``[B]`` with ``return_scores``."""
    if mesh is not None:
        raise NotImplementedError(_MESH_NOT_PORTED)
    _check_supported(config)
    dev = resolve_device(device)
    prompt, prompt_host = _prompt_tensor(prompt_ids, dev)
    B, S = prompt.shape
    K, V = num_beams, config.vocab_size
    rope = _rope(config, dev)
    layers = [layer_params(params, i) for i in range(config.n_layers)]

    cache = init_kv_cache(config, B, S + max_new_tokens, cache_dtype, dev)
    logits = _forward_cached(params, prompt, cache, 0, config, rope, layers)[:, -1]
    cache = {name: c.repeat_interleave(K, dim=1) for name, c in cache.items()}
    logp0 = torch.log_softmax(logits.float(), dim=-1)  # [B, V]
    scores, tok0 = _top_k(logp0, K)  # [B, K]
    finished = (tok0 == eos_token_id if eos_token_id is not None
                else torch.zeros((B, K), dtype=torch.bool, device=dev))
    # the generated length only (HF >= 4.35)
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, K, max_new_tokens), dtype=torch.int64, device=dev)
    tokens[:, :, 0] = tok0
    rows = (torch.arange(B, device=dev) * K)[:, None]
    if eos_token_id is not None:
        frozen = torch.full((V,), float("-inf"), device=dev)
        frozen[eos_token_id] = 0.0

    for i in range(1, max_new_tokens):
        last = tokens[:, :, i - 1].reshape(B * K, 1)
        logits = _forward_cached(params, last, cache, S + i - 1, config, rope, layers)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)
        if eos_token_id is not None:
            logp = torch.where(finished[:, :, None], frozen, logp)
        cand = scores[:, :, None] + logp  # [B, K, V]
        scores, flat_idx = _top_k(cand.reshape(B, K * V), K)
        parent = flat_idx // V  # [B, K]
        tok = flat_idx % V
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand(B, K, max_new_tokens))
        tokens[:, :, i] = tok
        finished = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent)
        lengths = torch.where(finished, lengths, lengths + 1)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        order = (rows + parent).reshape(-1)  # [B*K] parents' rows in the tiled batch
        cache = {name: c.index_select(1, order) for name, c in cache.items()}

    norm = scores / torch.pow(lengths.float(), length_penalty)
    best = torch.argmax(norm, dim=1)  # [B]
    best_tokens = tokens[torch.arange(B, device=dev), best].cpu().numpy()
    best_score = norm[torch.arange(B, device=dev), best].cpu().numpy()
    out = np.concatenate([prompt_host, best_tokens.astype(prompt_host.dtype)], axis=1)
    if return_scores:
        return out, best_score
    return out


# ---------------------------------------------------------------------------
# dispatched (offloaded) decoding


def unstack_layer_params(params: dict, config: LlamaConfig) -> dict:
    """Re-stage stacked-layer params into per-layer stages (views), so that
    device-map dispatch pages one layer at a time; ``layer_007`` etc. sort
    in layer order."""
    stages = {"embed_tokens": params["embed_tokens"]}
    for i in range(config.n_layers):
        stages[f"layer_{i:03d}"] = layer_params(params, i)
    stages["final_norm"] = params["final_norm"]
    if not config.tie_embeddings:
        stages["lm_head"] = params["lm_head"]
    return stages


@torch.no_grad()
def generate_dispatched(dispatched, prompt_ids, config: LlamaConfig, max_new_tokens: int = 32,
                        eos_token_id: Optional[int] = None,
                        cache_dtype: torch.dtype = torch.bfloat16, return_stats: bool = False,
                        warmup: bool = False):
    """Greedy decoding with per-layer paged params (cpu/disk offload) on
    ``dispatched.execution_device``. Each forward is :func:`_forward_cached`
    over the store, with the layers paged through the device by
    :meth:`~.big_modeling.DispatchedParams.paged` (layer i+1's copies
    queued before layer i computes, layer i's dropped after), so the two
    greedy paths run the same code and give the same tokens. The token is
    read each step, and decoding stops once every row has emitted
    ``eos_token_id``. ``warmup`` repeats the first decode step before
    timing (greedy decoding rewrites the same cache values)."""
    _check_supported(config)
    dev = dispatched.execution_device
    prompt, prompt_host = _prompt_tensor(prompt_ids, dev)
    B, S = prompt.shape
    cache = init_kv_cache(config, B, S + max_new_tokens, cache_dtype, dev)
    rope = _rope(config, dev)
    layer_names = [f"layer_{i:03d}" for i in range(config.n_layers)]

    def step(ids, start_pos):
        logits = _forward_cached(dispatched, ids, cache, start_pos, config, rope,
                                 dispatched.paged(layer_names))
        return torch.argmax(logits[:, -1], dim=-1).cpu().numpy()

    def decode(tok_host, start_pos):
        return step(torch.from_numpy(tok_host[:, None]).to(dev), start_pos)

    t0 = time.perf_counter()
    next_tok = step(prompt, 0)
    prefill_s = time.perf_counter() - t0

    tokens = [next_tok]
    finished = np.zeros((B,), bool)
    if eos_token_id is not None:
        finished |= next_tok == eos_token_id
    if warmup and max_new_tokens > 1:
        decode(tokens[-1], S)
    t0 = time.perf_counter()
    for i in range(1, max_new_tokens):
        tok = decode(tokens[-1], S + i - 1)
        if eos_token_id is not None:
            tok = np.where(finished, eos_token_id, tok)
            finished |= tok == eos_token_id
        tokens.append(tok)
        if eos_token_id is not None and finished.all():
            break
    decode_s = time.perf_counter() - t0
    generated = np.concatenate(
        [prompt_host] + [t[:, None].astype(prompt_host.dtype) for t in tokens], axis=1)
    if return_stats:
        return generated, _stats(prefill_s, decode_s, len(tokens) - 1, B)
    return generated
