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
can break the other way).

``mesh=`` decodes on one rank of a process group, as the JAX package's
GSPMD decode does over its devices (the Megatron dataflow of
:func:`generation_shardings`): every rank passes the same global prompt and
its blocks of the params (``parallel.sharding.shard_params`` with
:func:`~.models.transformer.llama_shard_rules`, or any placement named by
``param_specs``), and each keeps its block of the cache, ``[L, B/dp, T,
Hkv/tp, D]``. Column-parallel ``wq``/``wk``/``wv`` give the rank's heads and
attention runs on them; row-parallel ``wo`` is followed by a sum over
``tp``, and so are ``w1``/``w3`` (column) and ``w2`` (row); the embedding is
a masked lookup of the rank's vocab rows, summed over ``tp``; the head's
vocab columns are gathered over ``tp`` (and the rows over the data axes)
before selection, which every rank makes on the whole ``[B, V]`` and takes
from rank 0. A param split where the dataflow does not split it (FSDP, or
heads that do not divide over ``tp``) is gathered for its layer on use.
The MoE FFN runs the rank's ``ep`` experts over its ``tp`` slice of their
hidden dim. Every rank returns the whole output.
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
    apply_rope,
    layer_params,
    llama_ffn,
    lm_logits,
    rms_norm,
    rope_frequencies,
)
from .parallel.sharding import (
    PartitionSpec,
    _all_gather_dim,
    _broadcast,
    _dim_axes,
    _map,
    _map_with_path,
    all_reduce_axes,
    canonicalize_spec,
    infer_param_specs,
)
from .parallelism_config import axis_sizes
from .utils.device import resolve_device
from .utils.operations import record_collective
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

def init_kv_cache(config: LlamaConfig, batch_size: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Stacked cache ``{"k", "v"}: [L, B, max_len, Hkv, D]`` of zeros on
    ``device`` (the CUDA device when omitted)."""
    shape = (config.n_layers, batch_size, max_len, config.n_kv_heads, config.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _tp_heads(sizes: dict, config: LlamaConfig) -> Optional[str]:
    tp = sizes.get("tp", 1)
    return "tp" if tp > 1 and config.n_kv_heads % tp == 0 else None


def generation_shardings(mesh, batch_size: int, config: LlamaConfig):
    """``(prompt spec, cache spec)`` of decoding over ``mesh`` (a
    :class:`~.parallelism_config.Mesh` or ``{axis: size}``), the JAX
    package's placement: the batch over the data axes (``dp_replicate``,
    ``dp_shard``), each claimed in turn while the joint count still divides
    the batch; the KV heads of the cache ``[L, B, T, Hkv, D]`` over ``tp``
    where ``tp`` divides them. Anything else stays whole."""
    sizes = axis_sizes(mesh)
    used, used_size = [], 1
    for a in ("dp_replicate", "dp_shard", "dp"):
        size = sizes.get(a, 1)
        if size > 1 and batch_size % (used_size * size) == 0:
            used.append(a)
            used_size *= size
    batch = None if not used else (used[0] if len(used) == 1 else tuple(used))
    return (PartitionSpec(batch, None),
            PartitionSpec(None, batch, None, _tp_heads(sizes, config), None))


def serving_shardings(mesh, config: LlamaConfig):
    """The canonical spec of the serving engine's block pool ``[L,
    num_blocks, block_size, Hkv, D]``: KV heads over ``tp`` where it divides
    them; the block axis whole (any sequence may hold any block: batch
    parallelism in serving is the scheduler's)."""
    sizes = axis_sizes(mesh)
    return canonicalize_spec(PartitionSpec(None, None, None, _tp_heads(sizes, config), None),
                             sizes)


def _placement(params, config: LlamaConfig, mesh, rules):
    """The specs of ``params`` when the caller named none: ``rules``' blocks
    (``shard_params(..., rules=rules)``), or whole params on every rank,
    whichever the blocks' shapes are; anything else raises."""
    from .models.transformer import init_llama
    from .parallel.sharding import shard_index
    from .utils.modeling import abstract_params

    shapes = abstract_params(init_llama, config, None, device="cpu")
    specs = infer_param_specs(shapes, mesh, None, rules)
    local, whole, ruled = {}, {}, {}
    _map_with_path(lambda path, x: local.__setitem__(path, tuple(x.shape)), params)
    _map_with_path(lambda path, x: whole.__setitem__(path, tuple(x.shape)), shapes)
    _map_with_path(lambda path, s: ruled.__setitem__(path, tuple(
        sl.stop - sl.start for sl in shard_index(s, whole[path], mesh))), specs)
    if local == ruled:  # the rules read paths only: the same specs, in the params' order
        return infer_param_specs(params, mesh, None, rules)
    if local == whole:
        return _map(lambda x: PartitionSpec(), params)
    raise ValueError("the params are neither whole nor placed by llama_shard_rules(): pass "
                     "their param_specs")


class MeshDecode:
    """One rank's view of a decode over ``mesh``: which dims of each param
    the Megatron dataflow splits over ``tp`` (and the MoE experts over
    ``ep``), the rank's rows of the batch (``batch_axes``), and the
    collectives of a cached forward (see the module docstring). ``params``
    are the rank's blocks under ``param_specs`` (inferred from
    ``llama_shard_rules`` when the blocks are split and omitted; whole
    params when they are whole)."""

    def __init__(self, params, config: LlamaConfig, mesh, param_specs=None,
                 batch_axes: tuple = ()):
        from .models.transformer import llama_shard_rules

        self.mesh, self.config, self.params = mesh, config, params
        sizes = axis_sizes(mesh)
        self.sizes = sizes
        self.tp, self.tc = sizes.get("tp", 1), mesh.coords.get("tp", 0)
        self.batch_axes = tuple(batch_axes)
        self.attn_tp = _tp_heads(sizes, config) is not None
        moe = config.moe_experts > 0
        hidden = config.hidden_dim
        self.ffn_tp = self.tp > 1 and hidden % self.tp == 0
        self.vocab_tp = self.tp > 1 and config.vocab_size % self.tp == 0
        ep = sizes.get("ep", 1)
        self.ep_split = moe and ep > 1 and config.moe_experts % ep == 0
        if param_specs is None:
            param_specs = _placement(params, config, mesh, llama_shard_rules())
        self.specs = _map(lambda s: canonicalize_spec(s, sizes), param_specs)
        # by path: each param's spec, the dims the dataflow splits, its whole shape
        self._spec, self._whole = {}, {}
        _map_with_path(lambda path, s: self._spec.__setitem__(path, list(s)), self.specs)
        self._wants = {path: self._want(path) for path in self._spec}
        _map_with_path(lambda path, x: self._whole.__setitem__(path, tuple(
            n * int(np.prod([sizes[a] for a in _dim_axes(self._spec[path][d])]))
            if d < len(self._spec[path]) else n for d, n in enumerate(x.shape))), params)
        # layers whose blocks need no collective are views, made once
        self._layers = None
        if not any(self._needs_comm(path) for path in self._spec if path.startswith("layers/")):
            self._layers = [self._layer(i) for i in range(config.n_layers)]
        self._top = {k: _map_with_path(lambda path, x: self._block(x, path), v, k)
                     for k, v in params.items() if k != "layers"}

    def _want(self, path: str) -> dict:
        """``{dim: axis}`` the dataflow splits (per-layer dims for a layer)."""
        name = path.split("/")
        if name[0] == "layers":
            leaf = name[-2]
            if "moe" in name:
                split = {}
                if self.ep_split:
                    split[0] = "ep"
                if self.ffn_tp and leaf in ("wi", "wo"):
                    split[2 if leaf == "wi" else 1] = "tp"
                return split if leaf != "router" else {}
            if leaf in ("wq", "wk", "wv"):
                return {1: "tp"} if self.attn_tp else {}
            if leaf == "wo":
                return {0: "tp"} if self.attn_tp else {}
            if leaf in ("w1", "w3"):
                return {1: "tp"} if self.ffn_tp else {}
            if leaf == "w2":
                return {0: "tp"} if self.ffn_tp else {}
            return {}
        if path == "embed_tokens/embedding":
            return {0: "tp"} if self.vocab_tp else {}
        if path == "lm_head/kernel":
            return {1: "tp"} if self.vocab_tp else {}
        return {}

    def _needs_comm(self, path: str) -> bool:
        dims = self._spec[path]
        offset = 1 if path.startswith("layers/") else 0
        if offset and dims and _dim_axes(dims[0]):
            return True
        want = self._wants[path]
        return any(axes and tuple(axes) != (want.get(d - offset),)
                   for d, axes in enumerate(_dim_axes(e) for e in dims) if d >= offset)

    def _block(self, x: torch.Tensor, path: str, layer: Optional[int] = None) -> torch.Tensor:
        """This rank's block of one param (layer ``layer`` of a stacked one)
        in the dataflow's layout: split dims the dataflow keeps stay as they
        are, others are gathered, and dims it splits that are whole are
        narrowed to the rank's block."""
        spec, want, whole = self._spec[path], self._wants[path], self._whole[path]
        if layer is not None:
            axes0 = _dim_axes(spec[0]) if spec else ()
            x = self._layer_row(x, axes0, layer)
            spec, whole = spec[1:], whole[1:]
        for d, entry in enumerate(spec):
            axes = _dim_axes(entry)
            if axes and tuple(axes) != (want.get(d),):
                for a in reversed(axes):  # minor axis first
                    x = _all_gather_dim(x, d, self.mesh.group(a))
        for d, a in want.items():
            if x.shape[d] == whole[d]:  # whole here: narrow to the rank's block
                size = x.shape[d] // self.sizes[a]
                x = x.narrow(d, self.mesh.coords[a] * size, size)
        return x

    def _layer_row(self, x: torch.Tensor, axes0: tuple, i: int) -> torch.Tensor:
        """Layer ``i`` of a stacked leaf whose layer axis ``axes0`` may
        split: broadcast from the rank that holds it (minor axis first)."""
        if not axes0:
            return x[i]
        n_local = x.shape[0]
        b, row = divmod(i, n_local)
        owner = {}
        for a in reversed(axes0):
            b, owner[a] = divmod(b, self.sizes[a])
        mine = all(self.mesh.coords[a] == c for a, c in owner.items())
        buf = x[row].clone() if mine else x.new_empty(x.shape[1:])
        for a in reversed(axes0):
            _broadcast(buf, owner[a], self.mesh.group(a))
        return buf

    def _layer(self, i: int) -> dict:
        return _map_with_path(lambda path, x: self._block(x, path, layer=i),
                              self.params["layers"], "layers")

    def layer(self, i: int) -> dict:
        """Layer ``i``'s blocks in the dataflow's layout (gathered on use
        where a collective is needed)."""
        return self._layers[i] if self._layers is not None else self._layer(i)

    @property
    def kv_heads(self) -> int:
        return self.config.n_kv_heads // self.tp if self.attn_tp else self.config.n_kv_heads

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        index, count = 0, 1
        for a in self.batch_axes:
            index, count = index * self.sizes[a] + self.mesh.coords[a], count * self.sizes[a]
        per = batch // count
        return slice(index * per, (index + 1) * per)

    # -- the collectives of a forward --
    def sum_tp(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_axes(x, self.mesh, ("tp",)) if self.tp > 1 else x

    def attn_out(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel ``wo`` product's partial sums, summed over ``tp``."""
        return self.sum_tp(x) if self.attn_tp else x

    def ffn_out(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_tp(x) if self.ffn_tp else x

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self._top["embed_tokens"]["embedding"]
        if not self.vocab_tp:
            return emb[ids]
        rows = emb.shape[0]
        local = ids - self.tc * rows
        inside = (local >= 0) & (local < rows)
        h = torch.where(inside[..., None], emb[local.clamp(0, rows - 1)], 0)
        return self.sum_tp(h)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Logits ``[B, S, V]`` of the whole batch from the rank's rows of
        the final hidden states: the head's vocab columns gathered over
        ``tp``, the rows over the data axes."""
        top = self._top
        h = rms_norm(h, top["final_norm"]["scale"], self.config.norm_eps)
        w = (top["embed_tokens"]["embedding"].T if self.config.tie_embeddings
             else top["lm_head"]["kernel"])
        out = h @ w
        if self.vocab_tp:
            out = _all_gather_dim(out, 2, self.mesh.group("tp"))
        for a in reversed(self.batch_axes):
            out = _all_gather_dim(out, 0, self.mesh.group(a))
        return out

    def ffn(self, layer: dict, x: torch.Tensor, S: int) -> torch.Tensor:
        config = self.config
        if config.moe_experts > 0:
            from .parallel.moe import moe_ffn

            y, _ = moe_ffn(layer["moe"], x, top_k=config.moe_top_k,
                           capacity_factor=(decode_capacity(config, S)
                                            or config.moe_capacity_factor),
                           mesh=self.mesh, batch_axes=self.batch_axes)
            return self.ffn_out(y)
        from .models.transformer import _proj

        gate = torch.nn.functional.silu(_proj(layer["w1"], x))
        return self.ffn_out(_proj(layer["w2"], gate * _proj(layer["w3"], x)))

    def agree(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank takes rank 0's ``t`` (the selected tokens: the ranks
        must decode the same stream)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast(t, src=0)
            record_collective("decode:broadcast", t.numel() * t.element_size())
        return t

    def block_bytes(self) -> int:
        """Bytes of the param blocks this rank holds."""
        out = []
        _map(lambda x: out.append(x.numel() * x.element_size()), self.params)
        return int(sum(out))


def _rank_cache(config: LlamaConfig, batch: int, max_len: int, dtype, device,
                mesh: Optional[MeshDecode] = None) -> dict:
    """:func:`init_kv_cache`, or under ``mesh`` the rank's block of it: its
    rows of ``batch`` and its kv heads."""
    if mesh is None:
        return init_kv_cache(config, batch, max_len, dtype, device)
    rows = mesh.rows(batch)
    shape = (config.n_layers, rows.stop - rows.start, max_len, mesh.kv_heads, config.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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


def _dense(entry: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ entry["kernel"]


def _project_qkv(layer: dict, x: torch.Tensor, positions: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor, config: LlamaConfig, proj=_dense):
    """x ``[B, S, dim]`` at per-row ``positions [B, S]`` → ``(q, k, v)`` in
    BSHD with RoPE applied to q and k. ``proj(entry, x)`` is each product:
    plain on the decode paths, as the JAX package's decode computes them
    (an fp8 model's attention projections included); the training forward
    passes ``transformer._proj``."""
    B, S, _ = x.shape  # the heads a rank holds under tp: the product's width says
    q = proj(layer["wq"], x).reshape(B, S, -1, config.head_dim)
    k = proj(layer["wk"], x).reshape(B, S, -1, config.head_dim)
    v = proj(layer["wv"], x).reshape(B, S, -1, config.head_dim)
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
                start: int, cos: torch.Tensor, sin: torch.Tensor, config: LlamaConfig,
                mesh: Optional[MeshDecode] = None):
    """One decoder layer over the S tokens of ``h [B, S, dim]`` at positions
    ``start .. start+S-1``, writing their k/v into the caches ``[B, max_len,
    Hkv, D]`` in place; returns the new ``h``. ``start`` is a host int (the JAX step takes a
    traced position; here the host knows every position, so no value is
    read back). ``jax.lax.dynamic_update_slice`` would clamp a start that
    overruns ``max_len``, where this slice assignment raises; no call of
    this module reaches that case, since every cache is sized to the prompt
    plus the new tokens. Under ``mesh`` (a :class:`MeshDecode`) the layer
    runs on the rank's heads and rows, with the sums over ``tp``."""
    B, S, _ = h.shape
    positions = torch.arange(start, start + S, device=h.device)
    x = rms_norm(h, layer["attn_norm"]["scale"], config.norm_eps)
    q, k, v = _project_qkv(layer, x, positions[None].expand(B, S), cos, sin, config)
    k_cache[:, start:start + S] = k.to(k_cache.dtype)
    v_cache[:, start:start + S] = v.to(v_cache.dtype)
    attn = _cached_attention(q, k_cache, v_cache, positions)
    out = attn.reshape(B, S, -1) @ layer["wo"]["kernel"]
    h = h + (out if mesh is None else mesh.attn_out(out))
    x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
    if mesh is not None:
        return h + mesh.ffn(layer, x, S)
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
                    config: LlamaConfig, rope=None, layers=None,
                    mesh: Optional[MeshDecode] = None) -> torch.Tensor:
    """Forward the S tokens of ``ids [B, S]`` from ``start_pos`` against the
    stacked cache (written in place): logits ``[B, S, vocab]``. ``rope``
    (the cos/sin tables on the device) and ``layers`` (each layer's views)
    may be passed in to build them once per generation call. Under
    ``mesh`` ``ids`` and the cache are the rank's rows, and the logits are
    the whole batch's last position ``[B, 1, vocab]``."""
    cos, sin = rope if rope is not None else _rope(config, ids.device)
    if mesh is not None:
        h = mesh.embed(ids)
        for i in range(config.n_layers):
            h = _layer_step(mesh.layer(i), h, cache["k"][i], cache["v"][i], start_pos, cos, sin,
                            config, mesh)
        return mesh.logits(h[:, -1:])
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
                     select, rng_key, mesh=None, device=None, param_specs=None):
    """The shared KV-cache decode: one prefill, then the decode loop on the
    device. ``select(logits [B, V], key [2]) -> [B]`` picks each token; the
    key of step i is ``fold_in(rng_key, i)`` (step 0 the prefill's), all
    folded at once on the device, so no step waits on the host. The
    tokens are read back once, after the loop. Under ``mesh`` each rank
    runs its rows and heads, and selects on the whole batch's logits."""
    dev = resolve_device(device)
    prompt, prompt_host = _prompt_tensor(prompt_ids, dev)
    B, S = prompt.shape
    max_len = S + max_new_tokens
    rope = _rope(config, dev)
    key = _as_key(rng_key, dev)
    keys = fold_in(key[None].expand(max_new_tokens, 2),
                   torch.arange(max_new_tokens, device=dev))  # [max_new, 2]
    md, rows, layers = None, slice(None), None
    if mesh is not None:
        md = MeshDecode(params, config, mesh, param_specs,
                        batch_axes=_dim_axes(generation_shardings(mesh, B, config)[0][0]))
        rows = md.rows(B)
    else:
        layers = [layer_params(params, i) for i in range(config.n_layers)]

    def new_cache():
        return _rank_cache(config, B, max_len, cache_dtype, dev, md)

    def pick(logits, key):
        tok = select(logits[:, -1], key)
        return tok if md is None else md.agree(tok)

    def prefill(cache):
        return pick(_forward_cached(params, prompt[rows], cache, 0, config, rope, layers, md),
                    keys[0])

    def decode_all(cache, first_tok):
        tok = first_tok
        finished = (first_tok == eos_token_id if eos_token_id is not None
                    else torch.zeros(B, dtype=torch.bool, device=dev))
        toks = []
        for i in range(1, max_new_tokens):
            logits = _forward_cached(params, tok[rows, None], cache, S + i - 1, config, rope,
                                     layers, md)
            nxt = pick(logits, keys[i])
            if eos_token_id is not None:
                nxt = torch.where(finished, eos_token_id, nxt)
                finished = finished | (nxt == eos_token_id)
            toks.append(nxt)
            tok = nxt
        if not toks:
            return torch.zeros((B, 0), dtype=torch.int64, device=dev)
        return torch.stack(toks, dim=1)  # [B, max_new_tokens-1]

    if warmup and max_new_tokens > 1:
        cache_w = new_cache()
        decode_all(cache_w, prefill(cache_w)).cpu()
        del cache_w

    cache = new_cache()
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
                    return_stats: bool = False, warmup: bool = False, mesh=None, device=None,
                    param_specs=None):
    """KV-cache greedy decoding of resident params on ``device`` (the CUDA
    device when omitted). Returns the ids ``[B, S_prompt + max_new_tokens]``
    as a numpy array of the prompt's dtype, with a stats dict (prefill
    seconds, decode tokens/s, seconds/token) when ``return_stats``;
    ``warmup`` runs the whole decode once first, so the timed run starts
    warm. ``mesh``: one rank of a sharded decode (the module docstring);
    ``param_specs`` name the params' placement when it is not
    ``llama_shard_rules``'."""
    return _cached_generate(params, prompt_ids, config, max_new_tokens, eos_token_id,
                            cache_dtype, return_stats, warmup, select=_greedy, rng_key=None,
                            mesh=mesh, device=device, param_specs=param_specs)


def sample_generate(params, prompt_ids, config: LlamaConfig, max_new_tokens: int = 32,
                    temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0, rng_key=None,
                    eos_token_id: Optional[int] = None, cache_dtype: torch.dtype = torch.bfloat16,
                    return_stats: bool = False, warmup: bool = False, mesh=None, device=None,
                    param_specs=None):
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
                            rng_key=rng_key, mesh=mesh, device=device, param_specs=param_specs)


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
                  return_scores: bool = False, mesh=None, device=None, param_specs=None):
    """KV-cache beam search, the JAX package's algorithm: prefill at batch B,
    tile the cache to ``B * num_beams``, then each step extends every live
    beam over the vocab, keeps the best ``num_beams`` of ``num_beams * V``
    candidates and reorders the cache by the survivors' parents. A beam
    that emitted ``eos_token_id`` is frozen (its only continuation is eos
    at log-prob 0). The final ranking divides each score by its generated
    length to the power ``length_penalty``. Returns the best beam's ids
    ``[B, S_prompt + max_new_tokens]`` (numpy, the prompt's dtype), and its
    normalised score ``[B]`` with ``return_scores``. Under ``mesh`` each
    rank holds its rows' beams and heads, and every rank ranks the whole
    batch's candidates (rank 0's choice is taken)."""
    dev = resolve_device(device)
    prompt, prompt_host = _prompt_tensor(prompt_ids, dev)
    B, S = prompt.shape
    K, V = num_beams, config.vocab_size
    rope = _rope(config, dev)
    md, rows, layers = None, slice(0, B), None
    if mesh is not None:
        md = MeshDecode(params, config, mesh, param_specs,
                        batch_axes=_dim_axes(generation_shardings(mesh, B, config)[0][0]))
        rows = md.rows(B)
    else:
        layers = [layer_params(params, i) for i in range(config.n_layers)]
    cache = _rank_cache(config, B, S + max_new_tokens, cache_dtype, dev, md)
    logits = _forward_cached(params, prompt[rows], cache, 0, config, rope, layers, md)[:, -1]
    cache = {name: c.repeat_interleave(K, dim=1) for name, c in cache.items()}
    logp0 = torch.log_softmax(logits.float(), dim=-1)  # [B, V]
    scores, tok0 = _top_k(logp0, K)  # [B, K]
    if md is not None:  # every rank goes on from rank 0's choice, exactly
        both = md.agree(torch.stack([scores.double(), tok0.double()]))
        scores, tok0 = both[0].float(), both[1].long()
    finished = (tok0 == eos_token_id if eos_token_id is not None
                else torch.zeros((B, K), dtype=torch.bool, device=dev))
    # the generated length only (HF >= 4.35)
    lengths = torch.ones((B, K), dtype=torch.int32, device=dev)
    tokens = torch.zeros((B, K, max_new_tokens), dtype=torch.int64, device=dev)
    tokens[:, :, 0] = tok0
    local = (torch.arange(rows.stop - rows.start, device=dev) * K)[:, None]
    if eos_token_id is not None:
        frozen = torch.full((V,), float("-inf"), device=dev)
        frozen[eos_token_id] = 0.0

    for i in range(1, max_new_tokens):
        last = tokens[rows, :, i - 1].reshape(-1, 1)
        logits = _forward_cached(params, last, cache, S + i - 1, config, rope, layers, md)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1).reshape(B, K, V)
        if eos_token_id is not None:
            logp = torch.where(finished[:, :, None], frozen, logp)
        cand = scores[:, :, None] + logp  # [B, K, V]
        scores, flat_idx = _top_k(cand.reshape(B, K * V), K)
        if md is not None:  # one choice for every rank: rank 0's, exactly
            both = md.agree(torch.stack([scores.double(), flat_idx.double()]))
            scores, flat_idx = both[0].float(), both[1].long()
        parent = flat_idx // V  # [B, K]
        tok = flat_idx % V
        tokens = torch.gather(tokens, 1, parent[:, :, None].expand(B, K, max_new_tokens))
        tokens[:, :, i] = tok
        finished = torch.gather(finished, 1, parent)
        lengths = torch.gather(lengths, 1, parent)
        lengths = torch.where(finished, lengths, lengths + 1)
        if eos_token_id is not None:
            finished = finished | (tok == eos_token_id)
        order = (local + parent[rows]).reshape(-1)  # the parents' rows in the rank's beams
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
