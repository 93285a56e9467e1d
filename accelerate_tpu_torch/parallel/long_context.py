"""Context and sequence parallel attention: the port of
``accelerate_tpu.parallel.long_context``.

The sequence dim is split over the ``cp`` mesh axis (the ring, the zig-zag
ring and the all-gather strategies) or the ``sp`` axis (Ulysses), and the
attention of :func:`make_context_parallel_attention` runs on one rank's
blocks ``[B_loc, S_loc, H, D]`` of q, k and v, where the JAX package's
takes global arrays inside ``shard_map``. Its collectives are
differentiable ``torch.distributed`` calls over the mesh axis's process
group (:func:`ppermute`, :func:`all_gather`, :func:`all_to_all`), staged
through the host for a CUDA tensor on a ``gloo`` group.

- **ring**: each rank keeps its q block and passes its k/v block round the
  ring, ``cp - 1`` rotations; a block runs through the flash kernels
  (:func:`~..ops.flash_attention.flash_attention_lse`, which returns the
  rows' log-sum-exp as well), and the blocks merge by their ``(out, lse)``.
  A block the causal mask hides entirely (a kv chunk after the q chunk)
  adds exactly 0 to the JAX package's merge (``exp(-1e30 - m)`` is 0 in
  f32): its launch is skipped, its rotation is not.
- **zigzag**: the ranks first trade half-chunks so that rank ``i`` holds
  global half-chunks ``i`` and ``2cp-1-i``; then every rotation needs two
  unmasked half-blocks on every rank, and the resident step two causal
  half-blocks and one full one. The output is traded back to contiguous
  order. Without ``causal`` it is the ring.
- **allgather**: k and v are gathered whole once; the rank's q rows attend
  them in one plain block (:func:`_block_attn`), whose ``Sq != Skv`` the
  flash kernels cannot tile.
- **ulysses**: an all-to-all trades the sequence split for a head split,
  each rank runs the plain attention (``ops.attention._xla_attention``) on
  the whole sequence for its heads, and a second all-to-all trades back.

Every rank runs the same collectives in the same order, forward and
backward: the rotated k/v of every step stays in the autograd graph (a
skipped block leaves it to the next rotation, and the last rotation's is
held by :class:`_KeepInGraph`), so each rank's backward sends every
gradient home along the inverse permutation.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch

from ..parallelism_config import DP_AXES
from ..utils.operations import record_collective

__all__ = ["all_gather", "all_to_all", "make_context_parallel_attention", "ppermute",
           "sequence_parallel_attention"]

NEG_INF = -1e30


def _dist():
    import torch.distributed as dist

    return dist


def _rank_at(mesh, axis: str, coord: int) -> int:
    """The global rank at ``coord`` on ``axis``, this rank's elsewhere."""
    where = dict(mesh.coords, **{axis: coord})
    return int(mesh.devices[tuple(where[a] for a in mesh.axis_names)])


def _wire(x: torch.Tensor, group):
    """``(tensor to send, back)``: a CUDA tensor on a ``gloo`` group goes
    through the host; 2-byte floats travel as their bytes (no arithmetic
    touches them, and every backend moves bytes)."""
    back_dtype = x.dtype if x.dtype in (torch.bfloat16, torch.float16) else None
    dev = x.device if x.is_cuda and _dist().get_backend(group) == "gloo" else None
    t = x.contiguous()
    if dev is not None:
        t = t.cpu()
    if back_dtype is not None:
        t = t.view(torch.uint8)

    def back(y):
        if back_dtype is not None:
            y = y.view(back_dtype)
        return y.to(dev) if dev is not None else y

    return t, back


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``x`` sent along ``perm`` (``(src, dst)`` coordinates on ``axis``):
    what this rank receives, zeros if no rank sends to it. A self-pair is a
    local copy; the sends and receives of a rank go out together."""
    idx = mesh.coords[axis]
    dst = next((d for s, d in perm if s == idx), None)
    src = next((s for s, d in perm if d == idx), None)
    if dst == idx:  # a permutation's self-pair: this rank also receives from itself
        return torch.empty_like(x, memory_format=torch.contiguous_format).copy_(x)
    dist = _dist()
    group = mesh.group(axis)
    t, back = _wire(x, group)
    buf = torch.zeros_like(t) if src is None else torch.empty_like(t)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, t, _rank_at(mesh, axis, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, buf, _rank_at(mesh, axis, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    record_collective("cp:ppermute", t.numel() * t.element_size())
    return back(buf)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute`` over the mesh ``axis``: each rank sends ``x`` to
    its destination in ``perm`` and returns what it receives; the backward
    sends the gradient along the inverse permutation."""
    return _PPermute.apply(x, mesh, axis, tuple(perm))


def _all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    from .sharding import _all_gather_dim

    group = mesh.group(axis)
    t, back = _wire(x.movedim(dim, 0), group)
    return back(_all_gather_dim(t, 0, group)).movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The sum over the ``axis`` ranks of ``x``, each rank its block of
    ``dim`` (summed in f32, through the host for a CUDA tensor on
    ``gloo``)."""
    from .sharding import _reduce_scatter_dim

    group = mesh.group(axis)
    xt = x.float()
    if xt.is_cuda and _dist().get_backend(group) == "gloo":
        return _reduce_scatter_dim(xt.cpu(), dim, group).to(x.device, x.dtype)
    return _reduce_scatter_dim(xt, dim, group).to(x.dtype)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` over the mesh ``axis`` along
    ``dim``; the backward is the matching reduce-scatter (a sum)."""
    return _AllGather.apply(x, mesh, axis, dim)


def _all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    dist = _dist()
    group = mesh.group(axis)
    n = mesh.shape[axis]
    chunks = x.unflatten(split_dim, (n, -1)).movedim(split_dim, 0)  # [n, ...]: chunk j to rank j
    t, back = _wire(chunks, group)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    record_collective("cp:all_to_all", t.numel() * t.element_size())
    # out[i] came from rank i: its block of the concat dim
    return back(out).movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int):
    """``lax.all_to_all(..., tiled=True)`` over the mesh ``axis``: ``x``
    split into ``n`` blocks of ``split_dim``, block ``j`` to rank ``j``, the
    blocks received concatenated along ``concat_dim`` in rank order; the
    backward is the inverse all-to-all."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


class _KeepInGraph(torch.autograd.Function):
    """``x`` unchanged, with ``dep`` in its graph: the backward hands
    ``dep`` a zero gradient, so the collectives that made ``dep`` run their
    backward on every rank, whether or not a block read it."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _block_attn(q, k, v, mask, scale):
    """One plain block: ``(unnormalised out, row max, row sumexp)``.
    ``q [B, Hq, Sq, D]``, ``k, v [B, Hq, Skv, D]``, ``mask [Sq, Skv]`` bool
    or None; the scores in f32, ``p`` rounded to ``v``'s dtype before the
    value product, as the JAX package's."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)  # noqa: E741
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
    return o, m, l


def _merge_blocks(o, m, l, o_new, m_new, l_new):
    """Online-softmax merge of two partial results of :func:`_block_attn`."""
    m_tot = torch.maximum(m, m_new)
    c_old = torch.exp(m - m_tot)
    c_new = torch.exp(m_new - m_tot)
    o = o * c_old[..., None].to(o.dtype) + o_new * c_new[..., None].to(o.dtype)
    return o, m_tot, l * c_old + l_new * c_new


def _flash_block(q, k, v, causal: bool, scale: float):
    """One square block through kernels #1-#3: ``(out [B, S, H, D] in f32,
    lse [B, H, S])``."""
    from ..ops.flash_attention import flash_attention_lse

    out, lse = flash_attention_lse(q, k, v, causal=causal, scale=scale)
    return out.float(), lse


def _merge_lse(acc, block):
    """Merge two blocks of one softmax by their ``(out, lse)``: ``lse =
    logaddexp(lse₁, lse₂)``, ``out = Σ exp(lseᵢ − lse) · outᵢ``."""
    (o, lse), (o_new, lse_new) = acc, block
    tot = torch.logaddexp(lse, lse_new)
    w_old = torch.exp(lse - tot).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_new - tot).transpose(1, 2)[..., None]
    return o * w_old + o_new * w_new, tot


def _heads_major(x, n_heads):
    """``[B, S, Hkv, D]`` → ``[B, n_heads, S, D]`` (the kv heads repeated
    for GQA)."""
    x = x.transpose(1, 2)
    if x.shape[1] != n_heads:
        x = x.repeat_interleave(n_heads // x.shape[1], dim=1)
    return x


def _local_ring_attention(q, k, v, *, mesh, axis_name: str, axis_size: int, causal: bool,
                          scale: float):
    """The ring on this rank's ``[B, S_loc, H, D]`` blocks: its resident
    block, then ``cp - 1`` rotations of k and v (one tensor), each followed
    by the full block of the kv chunk now held, where the causal mask shows
    any of it."""
    cp, idx = axis_size, mesh.coords[axis_name]
    acc = _flash_block(q, k, v, causal, scale)
    if cp > 1:
        shift = [(i, (i + 1) % cp) for i in range(cp)]
        kv = torch.stack([k, v])
        for step in range(1, cp):
            kv = ppermute(kv, mesh, axis_name, shift)
            src = (idx - step) % cp  # the global chunk held after `step` rotations
            if causal and src > idx:  # every key after every query: adds exactly 0
                continue
            acc = _merge_lse(acc, _flash_block(q, kv[0], kv[1], False, scale))
        acc = (_KeepInGraph.apply(acc[0], kv), acc[1])
    return acc[0].to(q.dtype)


def _zigzag_perms(cp: int):
    """The lane permutations of the zig-zag exchange, as the JAX package's:
    global half-chunks ``0..2cp-1``, contiguous layout ``(2i, 2i+1)`` on
    rank ``i``, zig-zag layout ``(i, 2cp-1-i)``. Lane A (each rank's first
    half) and lane B (its second) are each a bijection on the ranks.
    Returns ``(perm_a, perm_b, inv_a, inv_b, lane_a_chunk,
    lane_b_chunk)``, the last two the chunk arriving in each lane at each
    rank."""
    def home(c):
        return c if c < cp else 2 * cp - 1 - c

    perm_a = [(i, home(2 * i)) for i in range(cp)]
    perm_b = [(i, home(2 * i + 1)) for i in range(cp)]
    inv_a = [(dst, src) for src, dst in perm_a]
    inv_b = [(dst, src) for src, dst in perm_b]
    lane_a_chunk = [0] * cp
    lane_b_chunk = [0] * cp
    for i in range(cp):
        lane_a_chunk[home(2 * i)] = 2 * i
        lane_b_chunk[home(2 * i + 1)] = 2 * i + 1
    return perm_a, perm_b, inv_a, inv_b, lane_a_chunk, lane_b_chunk


def _local_zigzag_attention(q, k, v, *, mesh, axis_name: str, axis_size: int, causal: bool,
                            scale: float):
    """The load-balanced causal ring: the exchange into zig-zag lanes, the
    resident step (``q_lo × kv_lo`` and ``q_hi × kv_hi`` causal, ``q_hi ×
    kv_lo`` full), then per rotation of the kv pair two full half-blocks,
    ``(q_lo, kv_lo)`` and ``(q_hi, kv_lo)`` when the pair's low chunk ``j``
    is below this rank's, else ``(q_hi, kv_lo)`` and ``(q_hi, kv_hi)``; the
    rank index is known, so each step computes only its own pair. Then the
    inverse exchange back to contiguous order."""
    cp, idx = axis_size, mesh.coords[axis_name]
    S = q.shape[1]
    if S % 2 != 0:
        raise ValueError(f"zigzag CP needs an even local sequence shard, got {S}")
    half = S // 2
    perm_a, perm_b, inv_a, inv_b, lane_a_chunk, lane_b_chunk = _zigzag_perms(cp)
    kv = torch.stack([k, v])
    qa = ppermute(q[:, :half], mesh, axis_name, perm_a)
    qb = ppermute(q[:, half:], mesh, axis_name, perm_b)
    kva = ppermute(kv[:, :, :half], mesh, axis_name, perm_a)
    kvb = ppermute(kv[:, :, half:], mesh, axis_name, perm_b)
    a_is_low = lane_a_chunk[idx] < lane_b_chunk[idx]
    q_lo, q_hi = (qa, qb) if a_is_low else (qb, qa)
    kv_lo, kv_hi = (kva, kvb) if a_is_low else (kvb, kva)
    lo = _flash_block(q_lo, kv_lo[0], kv_lo[1], True, scale)
    hi = _flash_block(q_hi, kv_hi[0], kv_hi[1], True, scale)
    hi = _merge_lse(hi, _flash_block(q_hi, kv_lo[0], kv_lo[1], False, scale))
    if cp > 1:
        shift = [(i, (i + 1) % cp) for i in range(cp)]
        pair = torch.stack([kv_lo, kv_hi])  # [lo/hi, k/v, B, half, Hkv, D]
        for step in range(1, cp):
            pair = ppermute(pair, mesh, axis_name, shift)
            j = (idx - step) % cp  # the low chunk of the pair now held
            if j < idx:
                lo = _merge_lse(lo, _flash_block(q_lo, pair[0, 0], pair[0, 1], False, scale))
                hi = _merge_lse(hi, _flash_block(q_hi, pair[0, 0], pair[0, 1], False, scale))
            else:
                hi = _merge_lse(hi, _flash_block(q_hi, pair[0, 0], pair[0, 1], False, scale))
                hi = _merge_lse(hi, _flash_block(q_hi, pair[1, 0], pair[1, 1], False, scale))
        hi = (_KeepInGraph.apply(hi[0], pair), hi[1])
    out_lo, out_hi = lo[0].to(q.dtype), hi[0].to(q.dtype)
    lane_a, lane_b = (out_lo, out_hi) if a_is_low else (out_hi, out_lo)
    return _zigzag_unexchange(lane_a, lane_b, mesh, axis_name, inv_a, inv_b)


def _zigzag_unexchange(lane_a, lane_b, mesh, axis_name: str, inv_a, inv_b):
    """The lanes back to their contiguous homes: this rank's chunk of the
    output, ``[first half, second half]`` of its sequence."""
    first = ppermute(lane_a, mesh, axis_name, inv_a)
    second = ppermute(lane_b, mesh, axis_name, inv_b)
    return torch.cat([first, second], dim=1)


def _local_allgather_attention(q, k, v, *, mesh, axis_name: str, axis_size: int, causal: bool,
                               scale: float):
    """k and v gathered whole over the axis once (the reference's
    ``rotate_method='allgather'``), then one plain block of this rank's
    query rows against every key."""
    cp, idx = axis_size, mesh.coords[axis_name]
    S, H = q.shape[1], q.shape[2]
    k_full = all_gather(k, mesh, axis_name, 1)  # [B, S * cp, Hkv, D]
    v_full = all_gather(v, mesh, axis_name, 1)
    mask = None
    if causal:
        q_pos = idx * S + torch.arange(S, device=q.device)[:, None]
        mask = q_pos >= torch.arange(S * cp, device=q.device)[None, :]
    o, _, l = _block_attn(q.transpose(1, 2), _heads_major(k_full, H), _heads_major(v_full, H),
                          mask, scale)
    out = o / l.clamp(min=1e-30)[..., None].to(o.dtype)
    return out.transpose(1, 2).to(q.dtype)


def _local_ulysses_attention(q, k, v, *, mesh, axis_name: str, axis_size: int, causal: bool,
                             scale: float):
    """Ulysses on this rank's ``[B, S_loc, H, D]`` blocks: an all-to-all
    to ``[B, S, H/sp, D]`` (the whole sequence, this rank's heads), the
    plain attention, and the all-to-all back."""
    from ..ops.attention import _xla_attention

    q_h, k_h, v_h = (all_to_all(x, mesh, axis_name, 2, 1) for x in (q, k, v))
    out = _xla_attention(q_h, k_h, v_h, causal=causal, mask=None, scale=scale)
    return all_to_all(out, mesh, axis_name, 1, 2)


def make_context_parallel_attention(mesh, strategy: str = "ring", axis_name: Optional[str] = None,
                                    batch_axes: tuple = DP_AXES, head_axis: str = "tp"):
    """An ``attention_fn(q, k, v, causal=True, scale=None)`` that splits the
    sequence over ``cp`` (``strategy`` ``"ring"``, ``"zigzag"`` or
    ``"allgather"``) or ``sp`` (``"ulysses"``) of ``mesh`` (a
    :class:`~..parallelism_config.Mesh` over the running processes).

    It takes this rank's blocks ``[B_loc, S_loc, H, D]`` (its rows of the
    ``batch_axes``, its chunk of the sequence axis; ``k, v`` with ``Hkv``
    heads) and returns the rank's block of the output. ``batch_axes`` and
    ``head_axis`` are accepted for the JAX package's signature: the rank's
    rows are its own already, and every ``tp`` rank holds every head (the
    port's training forward keeps them whole), so each runs the attention
    over all heads, with the same values. On an axis of size 1 it is plain
    :func:`~..ops.attention.dot_product_attention`; zig-zag without
    ``causal`` is the ring."""
    if axis_name is None:
        axis_name = "sp" if strategy == "ulysses" else "cp"
    axis_size = mesh.shape.get(axis_name, 1)
    local_fn = {
        "ring": _local_ring_attention,
        "zigzag": _local_zigzag_attention,
        "allgather": _local_allgather_attention,
        "ulysses": _local_ulysses_attention,
    }[strategy]

    def attention_fn(q, k, v, causal: bool = True, scale: Optional[float] = None):
        if axis_size <= 1:
            from ..ops.attention import dot_product_attention

            return dot_product_attention(q, k, v, causal=causal, scale=scale)
        fn_local = local_fn
        if strategy == "zigzag" and not causal:
            fn_local = _local_ring_attention
        scale_v = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        if strategy == "ulysses" and (q.shape[2] % axis_size != 0
                                      or k.shape[2] % axis_size != 0):
            raise ValueError(
                f"Ulysses SP needs q heads ({q.shape[2]}) and kv heads ({k.shape[2]}) "
                f"divisible by sp size ({axis_size}); use ring CP for more chips than heads")
        return partial(fn_local, mesh=mesh, axis_name=axis_name, axis_size=axis_size,
                       causal=causal, scale=scale_v)(q, k, v)

    return attention_fn


def sequence_parallel_attention(mesh, **kwargs):
    """Ulysses ``attention_fn`` (the reference's ALST / UlyssesSP path)."""
    return make_context_parallel_attention(mesh, strategy="ulysses", **kwargs)
