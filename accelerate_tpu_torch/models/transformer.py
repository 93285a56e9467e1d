"""Llama decoder and BERT encoder in PyTorch: the port of
``accelerate_tpu.models.transformer``.

Params keep the JAX package's layout — a nested dict whose per-layer
tensors are stacked on a leading layer axis (``params["layers"]["wq"]
["kernel"]`` is ``[L, dim, n_heads*head_dim]``) — so weights made by the
JAX initializer load unchanged through :mod:`.convert`. Matmuls are
``x @ kernel`` with ``kernel`` stored ``[in, out]``, as in the reference.

``moe_experts > 0`` swaps each layer's dense SwiGLU FFN for the MoE FFN
of :mod:`..parallel.moe` (``params["layers"]["moe"]``, stacked ``[L,
...]``), as in the JAX package. ``dtype_recipe="fp8"`` adds a stacked
``fp8_meta`` (:func:`~..ops.fp8.init_fp8_meta`) to every projection entry,
and the training forwards run those products through
:func:`~..ops.fp8.fp8_dot` (:func:`_proj`); the cached decode paths run
the attention projections as plain products and the FFN through
:func:`_proj`, from the frozen histories, as the JAX package's do.
``llama_forward``'s ``attention_fn`` replaces the attention (context and
sequence parallelism plug in there, :mod:`..parallel.long_context`); with
a sequence split over ``cp`` or ``sp`` the RoPE positions and the loss's
next-token targets are global (``Mesh.sequence_span``, :func:`_roll_left`).
"""

from __future__ import annotations

import collections
import collections.abc
import contextlib
import functools
import math
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..parallel import moe
from ..parallel.sharding import LayerStack
from ..utils.device import resolve_device
from ..utils.operations import _tree_map

__all__ = [
    "BertConfig",
    "LlamaConfig",
    "apply_rope",
    "bert_forward",
    "bert_loss",
    "bert_shard_rules",
    "draft_config",
    "draft_params",
    "init_bert",
    "init_llama",
    "layer_norm",
    "llama_ffn",
    "llama_forward",
    "llama_loss",
    "llama_shard_rules",
    "rms_norm",
    "rope_frequencies",
    "segment_positions",
]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Mean and variance in f32, the normalised value cast back to
    ``x.dtype`` before ``* scale + bias``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0):
    """``(cos, sin)`` numpy tables ``[max_seq, head_dim/2]`` in f32."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_seq), inv)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x ``[B, S, H, D]``; cos/sin ``[max_seq, D/2]``; half-split layout
    (the first and second halves of ``D`` are the rotated pair). Positions
    past the table read its last row, as JAX's clamping gather does: a
    serving prefill chunk padded to its bucket can reach past
    ``max_seq_len``, and those padded rows are thrown away."""
    seq = x.shape[1]
    if positions is None:
        cos_s = cos[:seq][None, :, None, :]
        sin_s = sin[:seq][None, :, None, :]
    else:
        positions = positions.clamp(max=cos.shape[0] - 1)
        cos_s = cos[positions][:, :, None, :]
        sin_s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    cos_s = cos_s.to(x.dtype)
    sin_s = sin_s.to(x.dtype)
    return torch.cat([x1 * cos_s - x2 * sin_s, x2 * cos_s + x1 * sin_s], dim=-1)


@dataclass(frozen=True)
class LlamaConfig:
    """Same fields and defaults as the JAX package's ``LlamaConfig``.
    ``attn_impl`` picks :func:`llama_forward`'s attention implementation
    (``"auto"`` is the einsum path, ``"flash"`` the blocked kernels);
    ``unroll_layers`` selects JAX-only machinery and is carried for parity
    and ignored; ``moe_experts > 0`` gives every layer a top-``moe_top_k``
    MoE FFN; ``dtype_recipe="fp8"`` runs the QKV/O and SwiGLU projections
    through :func:`~..ops.fp8.fp8_dot` (not with MoE)."""

    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    ffn_dim: Optional[int] = None  # default 8/3 * dim rounded to 256
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    unroll_layers: bool = True
    attn_impl: str = "auto"
    dtype_recipe: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def hidden_dim(self) -> int:
        if self.ffn_dim is not None:
            return self.ffn_dim
        return int(np.ceil(self.dim * 8 / 3 / 256) * 256)

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=256)


META_KEY = "fp8_meta"  # ops.fp8.META_KEY (ops is imported late: it imports this module)


def _check_dtype_recipe(recipe) -> None:
    if recipe not in (None, "fp8"):
        raise ValueError(f"dtype_recipe must be None or 'fp8', got {recipe!r}")


def _stacked_fp8_meta(n_layers: int, device) -> dict:
    """Per-layer fp8 meta stacked on the layer axis (f32 whatever the
    params' dtype), so it is sliced per layer with the kernels."""
    from ..ops.fp8 import init_fp8_meta

    return {k: v[None].repeat(n_layers, 1) for k, v in init_fp8_meta(device=device).items()}


def _proj(entry: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ entry["kernel"]``, through :func:`~..ops.fp8.fp8_dot` when the
    entry carries fp8 meta."""
    if META_KEY in entry:
        from ..ops.fp8 import fp8_dot

        return fp8_dot(x, entry["kernel"], entry[META_KEY])
    return x @ entry["kernel"]


def init_llama(config: LlamaConfig, generator: Optional[torch.Generator] = None,
               device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Stacked-layer params with the JAX ``init_llama`` layout and scales:
    projections ``N(0, 1/in_dim)``, embedding and head ``N(0, 0.02^2)``, norm
    scales one; with ``moe_experts > 0`` the layers hold ``moe.{router, wi,
    wo}`` (:func:`~..parallel.moe.init_moe_ffn`'s scales) in place of
    ``w1``/``w3``/``w2``. Draws come from ``generator`` (a fresh one seeded
    0 on the target device when omitted), so they differ from JAX's
    threefry draws — parity tests load JAX-made weights through
    :mod:`.convert` instead. ``dtype_recipe="fp8"`` adds a stacked
    ``fp8_meta`` to ``wq``/``wk``/``wv``/``wo``/``w1``/``w3``/``w2``; with MoE
    it raises ``ValueError``, as in the JAX package."""
    _check_dtype_recipe(config.dtype_recipe)
    if config.dtype_recipe == "fp8" and config.moe_experts > 0:
        raise ValueError("dtype_recipe='fp8' does not support MoE layers yet")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, Hd = config.n_layers, config.dim, config.hidden_dim
    Dq = config.n_heads * config.head_dim
    Dkv = config.n_kv_heads * config.head_dim

    def dense(*shape, scale=None):
        in_dim = shape[-2]
        scale = 1.0 / math.sqrt(in_dim) if scale is None else scale
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * scale).to(device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(*shape, device=dev, dtype=dtype)

    if config.moe_experts > 0:
        E = config.moe_experts
        ffn = {"moe": {"router": {"kernel": dense(L, D, E)},
                       "wi": {"kernel": dense(L, E, D, Hd, scale=1.0 / math.sqrt(D))},
                       "wo": {"kernel": dense(L, E, Hd, D)}}}
    else:
        ffn = {"w1": {"kernel": dense(L, D, Hd)}, "w3": {"kernel": dense(L, D, Hd)},
               "w2": {"kernel": dense(L, Hd, D)}}
    params = {
        "embed_tokens": {"embedding": dense(config.vocab_size, D, scale=0.02)},
        "layers": {
            "attn_norm": {"scale": ones(L, D)},
            "wq": {"kernel": dense(L, D, Dq)},
            "wk": {"kernel": dense(L, D, Dkv)},
            "wv": {"kernel": dense(L, D, Dkv)},
            "wo": {"kernel": dense(L, Dq, D)},
            "mlp_norm": {"scale": ones(L, D)},
            **ffn,
        },
        "final_norm": {"scale": ones(D)},
    }
    if config.dtype_recipe == "fp8":
        for name in ("wq", "wk", "wv", "wo", "w1", "w3", "w2"):
            params["layers"][name][META_KEY] = _stacked_fp8_meta(L, dev)
    if not config.tie_embeddings:
        params["lm_head"] = {"kernel": dense(D, config.vocab_size, scale=0.02)}
    return params


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""
    return _tree_map(lambda v: v[i], params["layers"])


def _layer_trees(layers: dict, n_layers: int) -> list:
    """The ``n_layers`` per-layer trees of a stacked layer tree, made with
    one ``unbind`` per stacked leaf: its backward is a single stack, where
    indexing each layer would scatter into a full-size zero tensor per
    layer."""

    def split(node):
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: part[i] for k, part in parts.items()} for i in range(n_layers)]
        return node.unbind(0)

    return split(layers)


def llama_shard_rules():
    """The JAX package's TP rules for the stacked layout: dim 0 is the
    layer axis, so ``tp`` splits the out dim (dim 2) of the column-parallel
    ``wq``/``wk``/``wv``/``w1``/``w3`` and the in dim (dim 1) of the
    row-parallel ``wo``/``w2``; the MoE experts go over ``ep`` and their
    matmul dims over ``tp``; the embedding and head are vocab-parallel;
    norms, the router and fp8 metadata stay whole. (``parallel.sharding.
    llama_tp_rules``, written for ``[in, out]`` kernels, lands one dim to
    the left on this tree.)"""
    from ..parallel.sharding import PartitionSpec as P
    from ..parallel.sharding import ShardingRules

    return ShardingRules([
        (r"fp8_meta", P()),
        (r"layers/(wq|wk|wv|w1|w3)/kernel", P(None, None, "tp")),  # column-parallel
        (r"layers/(wo|w2)/kernel", P(None, "tp", None)),  # row-parallel
        (r"layers/moe/router/kernel", P()),
        (r"layers/moe/wi/kernel", P(None, "ep", None, "tp")),
        (r"layers/moe/wo/kernel", P(None, "ep", "tp", None)),
        (r"embed_tokens/embedding", P("tp", None)),  # vocab-parallel
        (r"lm_head/kernel", P(None, "tp")),
        (r"norm", P()),
    ])


def draft_config(config: LlamaConfig, n_layers: int) -> LlamaConfig:
    """The config of a truncated-layer self-draft: ``config`` with only its
    first ``n_layers`` decoder layers, so the draft reads and writes the
    same paged KV layout as the verifier's first ``n_layers`` layers."""
    if not (0 < n_layers <= config.n_layers):
        raise ValueError(
            f"draft_layers must be in 1..{config.n_layers}, got {n_layers}"
        )
    return replace(config, n_layers=n_layers)


def draft_params(params: dict, n_layers: int) -> dict:
    """Self-draft params: the stacked layers sliced to views of their first
    ``n_layers`` (``v[:n]``); embeddings, final norm and head are the
    verifier's own tensors. Draft layer i *is* verifier layer i, so the KV
    the verifier writes into the paged pool is valid draft KV."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = _tree_map(lambda v: v[:n_layers], params["layers"])
    return out


def llama_ffn(layer: dict, x: torch.Tensor, config: LlamaConfig, mesh=None,
              capacity_factor: Optional[float] = None):
    """The FFN block of one layer (``layer`` from :func:`layer_params`),
    shared by the training forward and both cached decode paths:
    ``(y, aux)``. Dense SwiGLU gives ``aux = 0.0`` (a float: no device
    work); MoE gives :func:`~..parallel.moe.moe_ffn`'s f32 aux tensor.
    ``capacity_factor`` overrides the config's (decode floors it); ``mesh``
    routes the MoE FFN over the rank's rows of the global batch and its
    ``ep`` experts."""
    if config.moe_experts > 0:
        return moe.moe_ffn(
            layer["moe"], x, top_k=config.moe_top_k, mesh=mesh,
            capacity_factor=(config.moe_capacity_factor if capacity_factor is None
                             else capacity_factor))
    gate = torch.nn.functional.silu(_proj(layer["w1"], x))
    up = _proj(layer["w3"], x)
    return _proj(layer["w2"], gate * up), 0.0


def lm_logits(params: dict, h: torch.Tensor, config: LlamaConfig) -> torch.Tensor:
    """Final norm and output projection shared by every forward."""
    h = rms_norm(h, params["final_norm"]["scale"], config.norm_eps)
    if config.tie_embeddings:
        return h @ params["embed_tokens"]["embedding"].T
    return h @ params["lm_head"]["kernel"]


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-segment RoPE positions of packed rows ``[B, S]``: each index minus
    the index where its segment starts (a start is where the id differs
    from the previous token's, and position 0)."""
    S = segment_ids.shape[1]
    seq_idx = torch.arange(S, device=segment_ids.device)[None, :]
    is_start = torch.roll(segment_ids, 1, dims=1) != segment_ids
    is_start[:, 0] = True
    starts = torch.where(is_start, seq_idx, 0).cummax(dim=1).values
    return seq_idx - starts


_MM_OPS = ("mm", "addmm")  # x @ W: products with no batch dims


class _HostSaveMode(TorchDispatchMode):
    """The forward side of ``remat="offload_dots"``: runs every op and
    copies the output of each op in ``saved`` to host memory (pinned when
    it lives on a CUDA device: the copy is queued on the current stream
    and the host buffer is read back only after it), appended to
    ``store[op]`` in call order."""

    def __init__(self, saved, store):
        super().__init__()
        self.saved, self.store = saved, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.saved:
            host = torch.empty(out.shape, dtype=out.dtype, device="cpu",
                               pin_memory=out.is_cuda)
            host.copy_(out.detach(), non_blocking=True)
            self.store[func].append((host, out.device))
        return out


class _HostRestoreMode(TorchDispatchMode):
    """The recompute side: an op in ``saved`` is not run again; its output
    is the next host copy from ``store[op]``, copied back to the device the
    forward ran on (on that device's current stream, so it is there before
    the recomputed layer reads it). Every other op is recomputed."""

    def __init__(self, saved, store):
        super().__init__()
        self.saved, self.store = saved, store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.saved:
            host, device = self.store[func].pop(0)
            return host.to(device, non_blocking=True)
        return func(*args, **(kwargs or {}))


def _offload_dots_context(saved):
    """``context_fn`` of ``remat="offload_dots"``: a fresh store per
    checkpointed call, filled by the forward and drained by the recompute.
    ``create_selective_checkpoint_contexts`` keeps its ``MUST_SAVE`` outputs
    in a cache of its own, which an outer ``saved_tensors_hooks`` pair
    cannot see, so the move to the host happens where the saved outputs
    are taken and handed back."""
    store = collections.defaultdict(list)
    return _HostSaveMode(saved, store), _HostRestoreMode(saved, store)


def _remat_context(remat):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a ``remat`` name,
    after JAX's ``_remat_policy``: ``True``/``"nothing"`` save nothing
    (plain checkpointing); ``"dots"`` saves every matmul's output
    (``checkpoint_dots``); ``"dots_no_batch"`` only those of ``x @ W`` with
    no batch dims (``dots_with_no_batch_dims_saveable``), so the attention
    products and kernels are recomputed; ``"offload_dots"`` the same set as
    ``"dots_no_batch"`` held in pinned host memory between the forward and
    the backward (``offload_dot_with_no_batch_dims("device",
    "pinned_host")``). Everything else, the buffers a ctypes-launched
    kernel writes into included, is recomputed: the dispatcher never sees
    those kernels, so it may not hold their ``aten.empty``."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    if remat is True or remat == "nothing":
        return noop_context_fn
    names = {"dots": (*_MM_OPS, "bmm"), "dots_no_batch": _MM_OPS,
             "offload_dots": _MM_OPS}.get(remat)
    if names is None:
        raise ValueError(
            f"remat must be bool, 'nothing', 'dots', 'dots_no_batch' or "
            f"'offload_dots'; got {remat!r}")
    saved = {getattr(torch.ops.aten, name).default for name in names}
    if remat == "offload_dots":
        return functools.partial(_offload_dots_context, saved)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _layer_at(decoder_layer, layer_at, i: int, h: torch.Tensor):
    """Layer ``i`` on ``h``, its params fetched inside (a
    :class:`~..parallel.sharding.LayerStack` gathers them there, so a
    checkpoint around this gathers them again in its recompute instead of
    keeping them)."""
    return decoder_layer(h, layer_at(i))


def _activation_spec(mesh, *logical):
    """The JAX package's activation spec from logical dim names: each entry
    ``None``, an axis or a tuple of axes, with axes of size 1 (or absent
    from the mesh) dropped."""
    from ..parallel.sharding import PartitionSpec

    def present(axis):
        if axis is None:
            return None
        if isinstance(axis, (tuple, list)):
            kept = tuple(a for a in axis if mesh.shape.get(a, 1) > 1)
            return kept if kept else None
        return axis if mesh.shape.get(axis, 1) > 1 else None

    return PartitionSpec(*(present(ax) for ax in logical))


def _constrain(x: torch.Tensor, mesh, *logical) -> torch.Tensor:
    """Where the JAX package pins an activation's sharding, the port holds
    the rank's block already: the rows of its batch axes, its chunk of the
    sequence axis (``cp`` or ``sp``) on dim 1, every other dim whole (a
    ``tp`` split of the vocab is computed whole on every ``tp`` rank, the
    same values). Any other split raises, so a layout this forward does not
    compute cannot pass unnoticed."""
    if mesh is None:
        return x
    spec = _activation_spec(mesh, *logical)
    for d, axes in enumerate(spec):
        if axes is None or (d == 0 and set(axes if isinstance(axes, tuple) else (axes,))
                            <= {"dp_replicate", "dp_shard"}) or axes == "tp" or (
                d == 1 and axes in ("cp", "sp")):
            continue
        raise NotImplementedError(f"an activation split over {axes} on dim {d} is not ported")
    return x


def _sequence_axis(mesh) -> Optional[str]:
    return None if mesh is None else mesh.sequence_axis


def _sequence_span(S: int, mesh) -> tuple:
    return (0, S) if mesh is None else mesh.sequence_span(S)


def _chunk_positions(S: int, mesh, device) -> torch.Tensor:
    """The global positions ``[S]`` of this rank's chunk of the sequence:
    ``arange(S)`` offset by the chunk's start on the sequence axis."""
    start = _sequence_span(S, mesh)[0]
    return torch.arange(start, start + S, device=device)


def _roll_left(x: torch.Tensor, mesh) -> torch.Tensor:
    """``roll(x, -1)`` along the global sequence of this rank's ``[B,
    S_loc]`` chunk: the chunk's last column takes the next sequence rank's
    first (the last rank's, rank 0's), as the JAX package's ``jnp.roll``
    over the whole split sequence gives it."""
    rolled = torch.roll(x, -1, dims=1)
    axis = _sequence_axis(mesh)
    if axis is None:
        return rolled
    from ..parallel.long_context import _ppermute

    n = mesh.shape[axis]
    first = _ppermute(x[:, :1].contiguous(), mesh, axis, [(i, (i - 1) % n) for i in range(n)])
    return torch.cat([rolled[:, :-1], first], dim=1)


def llama_forward(params: dict, input_ids: torch.Tensor, config: LlamaConfig,
                  attention_impl: Optional[str] = None,
                  segment_ids: Optional[torch.Tensor] = None,
                  positions: Optional[torch.Tensor] = None,
                  attention_fn=None, remat=False, with_aux: bool = False, mesh=None):
    """Full-sequence causal forward: logits ``[B, S, vocab]``, no cache;
    with ``with_aux`` ``(logits, aux)``, ``aux`` the mean over layers of the
    MoE load-balance loss (an f32 zero for dense configs).

    ``attention_impl`` (default ``config.attn_impl``) picks the
    :func:`~accelerate_tpu_torch.ops.attention.dot_product_attention`
    implementation: ``"auto"``/``"xla"`` is the plain einsum path the cached
    serving path is held to, ``"flash"`` the blocked kernels. ``segment_ids``
    packs documents into a row (``[B, S]``, 0 = padding): tokens attend only
    within their segment, causally, and RoPE positions restart per segment
    unless ``positions`` is given. ``attention_fn(q, k, v, causal=True)``
    replaces the attention (context parallelism:
    :func:`~..parallel.long_context.make_context_parallel_attention`); it
    cannot take ``segment_ids``.

    ``remat`` (JAX's knob) recomputes each decoder layer in the backward
    (``torch.utils.checkpoint``, non-reentrant); the embedding and the head
    stay outside, as JAX's layer ``scan`` leaves them. ``False`` saves
    everything, ``True`` or ``"nothing"`` nothing inside a layer, ``"dots"``
    every matmul output, ``"dots_no_batch"`` only the ``x @ W``
    projections and ``"offload_dots"`` those projections in pinned host
    memory. A kernel in the layer (flash attention) then runs its forward
    twice a step. The MoE expert products are batched (``bmm``), so
    ``"dots"`` saves them and ``"dots_no_batch"`` recomputes them, as
    JAX's policies treat their batched einsums; the router's product has
    no batch dims and is saved by both.

    ``mesh`` (a :class:`~accelerate_tpu_torch.parallelism_config.Mesh`)
    says the forward runs on one rank of it: ``input_ids`` are the rank's
    rows, split over ``(dp_replicate, dp_shard)`` as the JAX package's
    activation constraints split them, and ``params`` are full, or their
    ``layers`` a :class:`~..parallel.sharding.LayerStack` that the loop
    gathers one layer at a time (the sharded train step hands it so).
    Every rank of a ``tp`` group computes the same rows with all heads; the
    MoE FFN routes over the global batch and computes the rank's ``ep``
    experts. With the sequence split over ``cp`` or ``sp`` the ids are the
    rank's chunk of it, the RoPE positions the chunk's global ones, and the
    attention must come from an ``attention_fn`` over that axis (the plain
    attention of a chunk would miss the others; it raises). MoE routing
    does not cover a sequence split yet and raises there."""
    from ..generation import _project_qkv
    from ..ops.attention import dot_product_attention

    if segment_ids is not None and attention_fn is not None:
        raise ValueError("segment_ids (packing) cannot combine with attention_fn (CP/SP)")
    seq_axis = _sequence_axis(mesh)
    if seq_axis is not None and attention_fn is None:
        raise ValueError(f"a sequence split over {seq_axis} needs an attention_fn over that axis "
                         "(parallel.long_context.make_context_parallel_attention)")
    context_fn = _remat_context(remat) if remat else None
    impl = config.attn_impl if attention_impl is None else attention_impl
    dev = input_ids.device
    cos, sin = (torch.from_numpy(t).to(dev) for t in
                rope_frequencies(config.head_dim, config.max_seq_len, config.rope_theta))
    B, S = input_ids.shape
    if positions is None:
        positions = (segment_positions(segment_ids) if segment_ids is not None
                     else _chunk_positions(S, mesh, dev)[None].expand(B, S))
    positions = positions.long()
    batch_axes = ("dp_replicate", "dp_shard")
    # the table is whole here: the step gathered it (the JAX package gathers
    # its FSDP dim on use and keeps vocab over tp, the same values)
    h = params["embed_tokens"]["embedding"][input_ids.long()]
    h = _constrain(h, mesh, batch_axes, "cp", None)

    def decoder_layer(h, layer):
        x = rms_norm(h, layer["attn_norm"]["scale"], config.norm_eps)
        q, k, v = _project_qkv(layer, x, positions, cos, sin, config, proj=_proj)
        if attention_fn is not None:
            attn = attention_fn(q, k, v, causal=True)
        else:
            attn = dot_product_attention(q, k, v, causal=True, segment_ids=segment_ids,
                                         impl=impl)
        h = h + _proj(layer["wo"], attn.reshape(B, S, -1))
        x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
        y, aux = llama_ffn(layer, x, config, mesh=mesh)
        return h + y, aux

    auxes = []
    stack = params["layers"]
    # a sharded step's layers come as a LayerStack, gathered one at a time:
    # layer i+1's gather is in flight while layer i computes, and the
    # gathered params are gathered again in the backward (by the recompute
    # with remat, else through the stack's saved-tensor hooks)
    sharded = isinstance(stack, LayerStack)
    layer_at = stack.layer if sharded else _layer_trees(stack, config.n_layers).__getitem__
    hooks = stack.saved_tensors_hooks() if sharded and not remat else contextlib.nullcontext()
    with hooks:
        for i in range(config.n_layers):
            if sharded:
                stack.prefetch(i + 1)
            run = functools.partial(_layer_at, decoder_layer, layer_at, i)
            if remat:
                h, aux = torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False,
                                                           context_fn=context_fn)
            else:
                h, aux = run(h)
            auxes.append(aux)
    logits = _constrain(lm_logits(params, h, config), mesh, batch_axes, "cp", "tp")
    if not with_aux:
        return logits
    if config.moe_experts > 0:
        return logits, torch.stack(auxes).mean()
    return logits, torch.zeros((), dtype=torch.float32, device=dev)


def llama_loss(params: dict, batch: dict, config: LlamaConfig, **fwd_kwargs) -> torch.Tensor:
    """Next-token cross entropy of :func:`llama_forward`, log-softmax in f32.
    ``batch``: ``input_ids [B, S]``, optional ``segment_ids`` (or the
    forward kwarg of that name) and ``loss_mask`` ``[B, S]``. Targets come
    from rolling the ids left by one; the last position, segment
    boundaries, padding (id 0) and masked positions do not count. MoE
    configs add ``moe_aux_weight`` times the forward's aux loss.

    With ``mesh`` (a forward kwarg) the rows are one rank's (and under a
    sequence split over ``cp`` or ``sp``, its chunk of the sequence: the
    targets, the mask and the last position are the global sequence's):
    the count of positions that count is summed over the batch ranks (those
    axes and the data-parallel ones), and the value is ``n · (this rank's
    sum) / (global count)`` for ``n`` batch ranks, so
    that its mean over the ranks (what the sharded train step reports, and
    the mean of whose gradients it takes) is the JAX package's loss over the
    global batch, masks and packing included."""
    ids = batch["input_ids"].long()
    seq_len = ids.shape[1]
    segment_ids = batch.get("segment_ids")
    if segment_ids is None:
        segment_ids = fwd_kwargs.get("segment_ids")
    elif "segment_ids" not in fwd_kwargs:
        fwd_kwargs = {**fwd_kwargs, "segment_ids": segment_ids}
    moe = config.moe_experts > 0
    logits = llama_forward(params, ids, config, with_aux=moe, **fwd_kwargs)
    if moe:
        logits, moe_aux = logits
    mesh = fwd_kwargs.get("mesh")
    targets = _roll_left(ids, mesh)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]  # [B, S]
    # the global last position has no next token; its rolled target is
    # position 0. Under a sequence split the rank's chunk starts at `start`
    start, total = _sequence_span(seq_len, mesh)
    pos = torch.arange(start, start + seq_len, device=ids.device)
    valid = (pos < total - 1).float()[None].expand_as(nll)
    if segment_ids is not None:
        same_seg = _roll_left(segment_ids, mesh) == segment_ids
        valid = valid * same_seg.float() * (segment_ids > 0).float()
    mask = batch.get("loss_mask")
    if mask is not None:
        valid = valid * _roll_left(mask, mesh).float()
    from ..parallel.sharding import global_mean

    loss = global_mean((nll * valid).sum(), valid.sum(), mesh)
    return loss + config.moe_aux_weight * moe_aux if moe else loss


@dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as the JAX package's ``BertConfig``.
    ``unroll_layers`` is carried for parity and ignored; ``attn_impl`` picks
    the :func:`~accelerate_tpu_torch.ops.attention.dot_product_attention`
    implementation; ``dtype_recipe="fp8"`` runs the attention and FFN
    projections through :func:`~..ops.fp8.fp8_dot` (the pooler and the
    classifier stay plain)."""

    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    num_labels: int = 2
    norm_eps: float = 1e-12
    unroll_layers: bool = True
    attn_impl: str = "auto"
    dtype_recipe: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=1024, dim=128, n_layers=2, n_heads=4, ffn_dim=256, max_seq_len=128)


def init_bert(config: BertConfig, generator: Optional[torch.Generator] = None,
              device=None, dtype: torch.dtype = torch.float32) -> dict:
    """Params with the JAX ``init_bert`` tree and key names: embeddings,
    per-layer projections stacked on a leading layer axis, pooler and
    classifier; kernels ``N(0, 0.02^2)``, biases zero, norm scales one.
    Draws come from ``generator`` (a fresh one seeded 0 on the target
    device when omitted), so they differ from JAX's threefry draws.
    ``dtype_recipe="fp8"`` adds a stacked ``fp8_meta`` to ``wq``/``wk``/
    ``wv``/``wo``/``fc1``/``fc2``."""
    _check_dtype_recipe(config.dtype_recipe)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, D, F = config.n_layers, config.dim, config.ffn_dim

    def normal(*shape):
        w = torch.randn(*shape, generator=generator, device=generator.device)
        return (w * 0.02).to(device=dev, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(*shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(*shape, device=dev, dtype=dtype)

    def norm(*lead):
        return {"scale": ones(*lead, D), "bias": zeros(*lead, D)}

    def dense(a, b):
        return {"kernel": normal(L, a, b), "bias": zeros(L, b)}

    params = {
        "embeddings": {
            "word": {"embedding": normal(config.vocab_size, D)},
            "position": {"embedding": normal(config.max_seq_len, D)},
            "token_type": {"embedding": normal(config.type_vocab_size, D)},
            "norm": norm(),
        },
        "layers": {
            "wq": dense(D, D),
            "wk": dense(D, D),
            "wv": dense(D, D),
            "wo": dense(D, D),
            "attn_norm": norm(L),
            "fc1": dense(D, F),
            "fc2": dense(F, D),
            "mlp_norm": norm(L),
        },
        "pooler": {"kernel": normal(D, D), "bias": zeros(D)},
        "classifier": {"kernel": normal(D, config.num_labels), "bias": zeros(config.num_labels)},
    }
    if config.dtype_recipe == "fp8":
        for name in ("wq", "wk", "wv", "wo", "fc1", "fc2"):
            params["layers"][name][META_KEY] = _stacked_fp8_meta(L, dev)
    return params


def bert_forward(params: dict, batch: dict, config: BertConfig,
                 attention_impl: Optional[str] = None) -> torch.Tensor:
    """Classification logits ``[B, num_labels]``. ``batch`` holds
    ``input_ids``, ``attention_mask`` and ``token_type_ids`` (all ``[B, S]``);
    padding reaches attention as ``segment_ids = attention_mask`` (pad 0,
    real 1), so the fused kernels take padded batches. ``attention_impl``
    defaults to ``config.attn_impl``."""
    from ..ops.attention import dot_product_attention

    impl = config.attn_impl if attention_impl is None else attention_impl
    ids = batch["input_ids"].long()
    B, S = ids.shape
    emb = params["embeddings"]
    token_type = batch.get("token_type_ids")
    token_type = torch.zeros_like(ids) if token_type is None else token_type.long()
    h = (emb["word"]["embedding"][ids] + emb["position"]["embedding"][:S][None]
         + emb["token_type"]["embedding"][token_type])
    h = layer_norm(h, emb["norm"]["scale"], emb["norm"]["bias"], config.norm_eps)
    mask = batch.get("attention_mask")
    seg_ids = None if mask is None else mask.to(torch.int32)
    # one unbind per stacked leaf: its backward is a single stack, where
    # indexing each layer would scatter into a full-size zero tensor per layer
    def unbind(node):
        if isinstance(node, collections.abc.Mapping):
            return {k: unbind(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, i):
        return {k: pick(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]

    layers = unbind(params["layers"])
    heads = (B, S, config.n_heads, config.head_dim)

    def dense(name, i, x):  # the bias add stays outside fp8_dot, as in the JAX package
        entry = pick(layers[name], i)
        return _proj(entry, x) + entry["bias"]

    def norm(name, i, x):
        return layer_norm(x, layers[name]["scale"][i], layers[name]["bias"][i], config.norm_eps)

    for i in range(config.n_layers):
        q, k, v = (dense(n, i, h).reshape(heads) for n in ("wq", "wk", "wv"))
        attn = dot_product_attention(q, k, v, segment_ids=seg_ids, impl=impl).reshape(B, S, -1)
        h = norm("attn_norm", i, h + dense("wo", i, attn))
        x = torch.nn.functional.gelu(dense("fc1", i, h), approximate="tanh")  # jax.nn.gelu
        h = norm("mlp_norm", i, h + dense("fc2", i, x))
    pooled = torch.tanh(h[:, 0] @ params["pooler"]["kernel"] + params["pooler"]["bias"])
    return pooled @ params["classifier"]["kernel"] + params["classifier"]["bias"]


def bert_loss(params: dict, batch: dict, config: BertConfig, **kwargs) -> torch.Tensor:
    """Mean cross-entropy of :func:`bert_forward` against ``batch["labels"]``,
    log-softmax in f32."""
    logits = bert_forward(params, batch, config, **kwargs)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, batch["labels"].long()[:, None]).mean()


def bert_shard_rules():
    """The JAX package's TP rules for BERT's stacked layers: ``tp`` splits
    the out dim of ``wq``/``wk``/``wv``/``fc1`` and the in dim of
    ``wo``/``fc2``, and the word embedding's vocab; norms, biases, the
    pooler, the classifier and fp8 metadata stay whole."""
    from ..parallel.sharding import PartitionSpec as P
    from ..parallel.sharding import ShardingRules

    return ShardingRules([
        (r"fp8_meta", P()),
        (r"layers/(wq|wk|wv|fc1)/kernel", P(None, None, "tp")),
        (r"layers/(wo|fc2)/kernel", P(None, "tp", None)),
        (r"embeddings/word/embedding", P("tp", None)),
        (r"(norm|bias|pooler|classifier)", P()),
    ])
