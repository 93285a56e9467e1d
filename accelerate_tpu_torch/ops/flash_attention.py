"""Blocked flash attention and paged attention: the port of
``accelerate_tpu.ops.flash_attention``.

Five kernels, each a thin wrapper over a hand-written Hopper CUDA kernel
with its plain PyTorch version beside it:

- :func:`flash_attention_fwd` (``csrc/flash_fwd.cu``), :func:`flash_attention_dq`
  (``csrc/flash_dq.cu``) and :func:`flash_attention_dkdv` (``csrc/flash_dkdv.cu``)
  — the block-sparse streaming forward, dq and dk/dv passes, held together
  by one ``torch.autograd.Function`` behind :func:`flash_attention`;
- :func:`paged_attention_decode` — S=1 queries, ragged per-row ``kv_lens``;
- :func:`paged_attention_prefill` — S>1 chunks, per-query ``q_positions``.

The rule for every wrapper: tensors on the CPU go to the plain version;
tensors on a CUDA device launch the kernel or raise — there is no switch
and no fallback. Each wrapper counts its kernel launches in a plain integer
attribute (``paged_attention_decode.launches``), so a run can show that its
path went through the kernel; the count is taken under a lock, since thread
replicas of the serving fleet launch from several threads at once.

The flash kernels' bf16 variants at head dims 64 and 128 (every training
path) run their products on Hopper's tensor cores (``wgmma``, with tiles
fed by ``cp.async``; ``csrc/flash_tc.cuh``); f32 and head dim 256 run on
CUDA-core f32 FMA. The launcher picks by dtype and head dim; both take
every block pair :func:`_check_flash` lets through.

Flash attention walks the JAX package's block lattice (:func:`_block_lattice`:
per batch row and q block, the ascending list of kv blocks that causal,
sliding-window and segment masks leave active), so a fully masked block is
never read. Its plain versions walk the same lattice block by block,
vectorised over batch, heads and q blocks, and round where the TPU kernels
round: ``p`` to the value dtype before ``PV`` against the running max; ``ds``
to the key dtype before ``ds K`` with the scale applied after the product;
``p`` and ``ds`` to the input dtype in dk/dv, the GQA group summed in f32
before one cast; ``δ = Σ dO·O`` in f32. Where the JAX wrapper drops to its
einsum path (``Sq != Skv``, or S not a multiple of the block) the port
raises, naming ``impl='xla'``.

The paged plain versions compute what the TPU kernels compute: f32 scores,
softmax and value product over the gathered blocks, masked by position,
cast to ``q.dtype`` at the end.
"""

from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from ..generation import _masked_attention
from ..serving.kv_pager import gather_blocks
from . import _build

__all__ = [
    "flash_attention",
    "flash_attention_dkdv",
    "flash_attention_dkdv_reference",
    "flash_attention_dq",
    "flash_attention_dq_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_reference",
    "flash_attention_lse",
    "paged_attention",
    "paged_attention_decode",
    "paged_attention_decode_plain",
    "paged_attention_prefill",
    "paged_attention_prefill_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (q dtype, pool dtype) pairs the kernels are instantiated for
_SUPPORTED = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16)}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUPS = 16  # query heads per kv head the decode block holds
# keys per split of the decode kernel's walk, largest first, and the share
# of the SMs a grid must fill before a larger split is taken
_DECODE_SPLIT_KEYS = (128, 64, 32)
_DECODE_SM_SHARE = 4  # at least one block for every fourth SM
# per (device, stream): the decode kernel's scratch (partials, tickets)
_DECODE_SCRATCH: "dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]]" = {}


def _plain(q, k_pool, v_pool, block_tables, q_positions, scale):
    k = gather_blocks(k_pool, block_tables).float()
    v = gather_blocks(v_pool, block_tables).float()
    kv_pos = torch.arange(k.shape[1], device=q.device)
    allow = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, S, T]
    return _masked_attention(q.float(), k, v, allow[:, None], scale).to(q.dtype)


def paged_attention_decode_plain(q, k_pool, v_pool, block_tables, kv_lens, scale=None):
    """Plain version of the decode kernel: q ``[B, 1, H, D]``, key position
    ``t`` of row ``b`` attended iff ``t < kv_lens[b]``."""
    return _plain(q, k_pool, v_pool, block_tables, (kv_lens.long() - 1)[:, None], scale)


def paged_attention_prefill_plain(q, k_pool, v_pool, block_tables, q_positions, scale=None):
    """Plain version of the prefill kernel: query ``i`` of row ``b`` attends
    key position ``t`` iff ``t <= q_positions[b, i]``."""
    return _plain(q, k_pool, v_pool, block_tables, q_positions.long(), scale)


def _check_launch(q, k_pool, v_pool, block_tables, index):
    """Validate what the kernels take; raise on anything else."""
    if (q.dtype, k_pool.dtype) not in _SUPPORTED or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"paged kernels take (q, pool) dtypes {sorted((str(a), str(b)) for a, b in _SUPPORTED)}; "
            f"got q {q.dtype}, k {k_pool.dtype}, v {v_pool.dtype}"
        )
    tensors = (q, k_pool, v_pool, block_tables, index)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged kernels need every tensor on one device")
    if block_tables.dtype != torch.int32 or index.dtype != torch.int32:
        raise TypeError("block tables and lengths/positions must be int32")
    if not (k_pool.is_contiguous() and v_pool.is_contiguous()):
        raise ValueError("pools must be contiguous [num_blocks, block_size, Hkv, D]")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must share one [N, bs, Hkv, D] shape, got "
                         f"{tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    B, S, H, D = q.shape
    Hkv = k_pool.shape[2]
    if D not in _HEAD_DIMS or k_pool.shape[3] != D:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS} and match the pool, got {D}")
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if block_tables.shape[0] != B:
        raise ValueError("block_tables must have one row per batch row")


def _launch_error(lib, err: int, name: str) -> RuntimeError:
    return RuntimeError(f"{name} launch failed: {lib.kernel_error_string(err).decode()} ({err})")


def _decode_split_keys(B, Hkv, keys, n_sms):
    """Keys per split of the decode kernel's walk over a ``keys``-long
    table (``W * block_size``), from shapes alone: the largest of
    ``_DECODE_SPLIT_KEYS`` whose grid ``(B, Hkv, ceil(keys / C))`` has a
    block for every ``_DECODE_SM_SHARE``-th of the ``n_sms`` SMs, else the
    smallest. Larger splits mean fewer partials to merge, and the kernel's
    time is latency, not work (``chip_smoke.py`` ``phase_decode_splits``
    times each split on the card)."""
    for c in _DECODE_SPLIT_KEYS:
        if _DECODE_SM_SHARE * B * Hkv * -(-keys // c) >= n_sms:
            return c
    return _DECODE_SPLIT_KEYS[-1]


_COUNT_LOCK = threading.Lock()


def _count(wrapper) -> None:
    """One more launch on ``wrapper.launches`` (atomic across threads)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _decode_scratch(stream, n_partials, n_tickets):
    """The decode kernel's scratch for launches on ``stream``: at least
    ``n_partials`` f32 split partials and ``n_tickets`` int32 tickets (one
    per row and kv head), kept between calls and grown when a call needs
    more. Tickets are zeroed once, when allocated; every launch leaves them
    at 0. Launches on one stream run one after another, so they may share
    it; each stream has its own."""
    key = (stream.device, stream.cuda_stream)
    partials, tickets = _DECODE_SCRATCH.get(key, (None, None))
    if partials is None or partials.numel() < n_partials:
        partials = torch.empty(n_partials, dtype=torch.float32, device=stream.device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=stream.device)
    _DECODE_SCRATCH[key] = (partials, tickets)
    return partials, tickets


def paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, scale=None):
    """q ``[B, 1, H, D]`` against one layer's pools ``[num_blocks,
    block_size, Hkv, D]`` through ``block_tables [B, W]`` (int32), with live
    lengths ``kv_lens [B]`` (int32). Returns ``[B, 1, H, D]`` in
    ``q.dtype``.

    On the card each row's keys are split over blocks of
    :func:`_decode_split_keys` keys, merged in the same launch through the
    current stream's scratch (:func:`_decode_scratch`)."""
    B, S, H, D = q.shape
    if S != 1:
        raise ValueError(f"decode kernel wants S=1 queries, got S={S}")
    if not q.is_cuda:
        return paged_attention_decode_plain(q, k_pool, v_pool, block_tables, kv_lens, scale)
    _check_launch(q, k_pool, v_pool, block_tables, kv_lens)
    _, bs, Hkv, _ = k_pool.shape
    if H // Hkv > _MAX_GROUPS:
        raise ValueError(f"decode kernel holds at most {_MAX_GROUPS} q heads per kv head")
    lib = _build.load("paged_decode")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("decode kernel copies the pools in 16-byte chunks: they must be "
                         "16-byte aligned")
    q = q.contiguous()
    if q.data_ptr() % 16:  # the kernel reads q in 16-byte vectors
        q = q.clone()
    tables = block_tables.contiguous()
    lens = kv_lens.contiguous()
    out = torch.empty_like(q)
    sm_scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    W = tables.shape[1]
    split_keys = _decode_split_keys(B, Hkv, W * bs, _sm_count(q.device))
    stream = torch.cuda.current_stream(q.device)
    partials, tickets = _decode_scratch(
        stream, B * Hkv * -(-W * bs // split_keys) * (H // Hkv) * (D + 2), B * Hkv)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        out.data_ptr(), partials.data_ptr(), tickets.data_ptr(),
        B, H, Hkv, D, bs, W, split_keys, _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype],
        sm_scale, stream.cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "paged_decode")
    _count(paged_attention_decode)
    return out


paged_attention_decode.launches = 0


def paged_attention_prefill(q, k_pool, v_pool, block_tables, q_positions, scale=None):
    """q ``[B, S, H, D]`` (S > 1) against one layer's pools through
    ``block_tables [B, W]`` (int32), with per-query absolute positions
    ``q_positions [B, S]`` (int32). The chunk's own KV is already in the
    pool. Returns ``[B, S, H, D]`` in ``q.dtype``."""
    B, S, H, D = q.shape
    if S < 2:
        raise ValueError(f"prefill kernel wants S>1 queries, got S={S}")
    if not q.is_cuda:
        return paged_attention_prefill_plain(q, k_pool, v_pool, block_tables, q_positions, scale)
    _check_launch(q, k_pool, v_pool, block_tables, q_positions)
    lib = _build.load("paged_prefill")
    q = q.contiguous()
    tables = block_tables.contiguous()
    qpos = q_positions.contiguous()
    out = torch.empty_like(q)
    sm_scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    err = lib.paged_prefill_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(), qpos.data_ptr(),
        out.data_ptr(), B, S, H, k_pool.shape[2], D, k_pool.shape[1], tables.shape[1],
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_pool.dtype], sm_scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise _launch_error(lib, err, "paged_prefill")
    _count(paged_attention_prefill)
    return out


paged_attention_prefill.launches = 0


def paged_attention(q, k_pool, v_pool, block_tables, q_positions,
                    scale: Optional[float] = None):
    """The engine's dispatch point: S == 1 goes to the decode kernel with
    ``kv_lens = q_positions[:, 0] + 1``, S > 1 to the prefill kernel."""
    if q.shape[1] == 1:
        kv_lens = (q_positions[:, 0] + 1).to(torch.int32)
        return paged_attention_decode(q, k_pool, v_pool, block_tables, kv_lens, scale)
    return paged_attention_prefill(q, k_pool, v_pool, block_tables,
                                   q_positions.to(torch.int32), scale)


# --------------------------------------------------------------------------
# Blocked flash attention (kernels #1-#3)

_FLASH_HEAD_DIMS = (64, 128, 256)  # the JAX package's _flash_supported head dims
# the CUDA-core variants keep one kv block's scores in shared memory, the
# tensor-core ones its K and V (as one pipeline stage) and sub-tiles of up
# to 128 keys' scores in registers
_FLASH_MAX_BLOCK = 256


@dataclass(frozen=True)
class _FlashConfig:
    """Static configuration of one flash call: the fields of the JAX
    package's ``_FlashConfig``. ``interpret`` is carried for parity and
    read by nothing (the port has no interpreter mode)."""

    scale: float
    causal: bool
    window: Optional[int]
    block_q: int
    block_kv: int
    h: int
    hkv: int
    use_seg: bool
    interpret: bool = False

    @property
    def groups(self) -> int:
        return self.h // self.hkv


def _block_lattice(seg: torch.Tensor, cfg: _FlashConfig):
    """Per-``(q_block, kv_block)`` active map → ``(ids, counts, idsT,
    countsT)``, int32 on ``seg``'s device; the JAX ``_block_lattice``.

    ``ids[b, qi, :counts[b, qi]]`` lists the kv blocks q block ``qi`` of row
    ``b`` streams, in ascending order (the order of the online-softmax sums);
    the transposed pair drives the dk/dv pass. Causal and window activity are
    block-coordinate bands; segment activity is interval overlap of per-block
    id min/max, exact only with the element mask beside it. The diagonal
    block is active under every mask, so every count is at least 1."""
    B, S = seg.shape
    dev = seg.device
    nq, nkv = S // cfg.block_q, S // cfg.block_kv
    qlo = torch.arange(nq, device=dev) * cfg.block_q
    qhi = qlo + cfg.block_q - 1
    klo = torch.arange(nkv, device=dev) * cfg.block_kv
    khi = klo + cfg.block_kv - 1
    active = torch.ones(B, nq, nkv, dtype=torch.bool, device=dev)
    if cfg.causal:
        active = active & (klo[None, None, :] <= qhi[None, :, None])
    if cfg.window is not None:
        active = active & (qlo[None, :, None] - khi[None, None, :] < cfg.window)
    if cfg.use_seg:
        sq = seg.reshape(B, nq, cfg.block_q)
        skv = seg.reshape(B, nkv, cfg.block_kv)
        qmin, qmax = sq.amin(-1), sq.amax(-1)
        kmin, kmax = skv.amin(-1), skv.amax(-1)
        active = active & (qmin[:, :, None] <= kmax[:, None, :]) & (
            kmin[:, None, :] <= qmax[:, :, None])

    def order(act):
        # actives first, each side ascending: inactive keys sit past every active one
        n = act.shape[-1]
        key = torch.where(act, 0, n) + torch.arange(n, device=dev)
        return torch.argsort(key, dim=-1).to(torch.int32)

    activeT = active.transpose(1, 2).contiguous()  # the kernels read rows of the lattice
    return (order(active), active.sum(-1, dtype=torch.int32),
            order(activeT), activeT.sum(-1, dtype=torch.int32))


def _allow_mask(cfg: _FlashConfig, seg, qblk, kblk):
    """Element mask of the score tiles of q blocks ``qblk`` against kv blocks
    ``kblk`` (both ``[B, n]`` block indices): ``[B, n, bq, bkv]`` bool, or
    None when every pair is allowed (the JAX ``_allow_mask``)."""
    bq, bkv = cfg.block_q, cfg.block_kv
    preds = []
    if cfg.causal or cfg.window is not None:
        qpos = qblk[..., None] * bq + torch.arange(bq, device=seg.device)
        kpos = kblk[..., None] * bkv + torch.arange(bkv, device=seg.device)
        diff = qpos[..., :, None] - kpos[..., None, :]
        if cfg.causal:
            preds.append(diff >= 0)
        if cfg.window is not None:
            preds.append(diff < cfg.window)
    if cfg.use_seg:
        B, S = seg.shape
        rows = torch.arange(B, device=seg.device)[:, None]
        segq = seg.reshape(B, S // bq, bq)[rows, qblk]
        segk = seg.reshape(B, S // bkv, bkv)[rows, kblk]
        preds.append(segq[..., :, None] == segk[..., None, :])
    if not preds:
        return None
    allow = preds[0]
    for p in preds[1:]:
        allow = allow & p
    return allow


def _blocks(x, idx, blk, groups=1):
    """Blocks ``idx [B, n]`` (of ``blk`` rows) of a BSHD tensor as ``[B,
    Hkv, groups, n, blk, D]`` in x's dtype, heads split into kv head × group
    member (``groups=1`` for k and v: a size-1 axis that broadcasts over
    the group)."""
    B, S, Hx, D = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    g = x.reshape(B, S // blk, blk, Hx, D)[rows, idx]  # [B, n, blk, Hx, D]
    return g.reshape(B, idx.shape[1], blk, Hx // groups, groups, D).permute(0, 3, 4, 1, 2, 5)


def _row_blocks(x, idx, blk, hkv):
    """Blocks ``idx [B, n]`` of a ``[B, H, S]`` row statistic as ``[B, Hkv,
    groups, n, blk]``."""
    B, H, S = x.shape
    rows = torch.arange(B, device=x.device)[:, None]
    g = x.reshape(B, H, S // blk, blk).permute(0, 2, 1, 3)[rows, idx]  # [B, n, H, blk]
    return g.reshape(B, idx.shape[1], hkv, H // hkv, blk).permute(0, 2, 3, 1, 4)


def _step_blocks(ids, counts, t):
    """Step ``t`` of a lattice walk: ``(blocks [B, n] long, active [B, n])``,
    the block index clamped onto the last active one past a row's count, as
    the JAX index maps do (its data is never used: ``active`` is false).
    The plain versions take every step up to the lattice's width, so that
    no count is read back to the host and they never synchronise with the
    device."""
    pos = (counts.long() - 1).clamp(min=0, max=t)
    return ids.long().gather(-1, pos[..., None])[..., 0], t < counts


def _masked(s, allow):
    return s if allow is None else s.masked_fill(~allow[:, None, None], -math.inf)


def _heads_out(x, S):
    """``[B, Hkv, groups, n, blk, D]`` → BSHD ``[B, S, Hkv·groups, D]``."""
    B, Hkv, G, n, blk, D = x.shape
    return x.permute(0, 3, 4, 1, 2, 5).reshape(B, S, Hkv * G, D)


def flash_attention_fwd_reference(q, k, v, seg, ids, counts, cfg: _FlashConfig):
    """Plain version of kernel #1: ``(out [B, S, H, D] in q.dtype, lse [B,
    H, S] f32)``. Walks each q block's active kv blocks in lattice order
    with the f32 online softmax of ``_flash_fwd_kernel``."""
    B, S, H, D = q.shape
    bq, bkv, G, Hkv = cfg.block_q, cfg.block_kv, cfg.groups, cfg.hkv
    nq = S // bq
    qblk = torch.arange(nq, device=q.device).expand(B, nq)
    qb = _blocks(q, qblk, bq, G).float()                      # [B, Hkv, G, nq, bq, D]
    m = torch.full((B, Hkv, G, nq, bq), -math.inf, device=q.device)
    l = torch.zeros_like(m)  # noqa: E741 - the TPU kernel's name
    acc = torch.zeros_like(qb)
    for t in range(ids.shape[-1]):
        blk, active = _step_blocks(ids, counts, t)
        kt = _blocks(k, blk, bkv).float()                     # [B, Hkv, 1, nq, bkv, D]
        vt = _blocks(v, blk, bkv)
        s = _masked((qb @ kt.transpose(-1, -2)) * cfg.scale, _allow_mask(cfg, seg, qblk, blk))
        m_new = torch.maximum(m, s.amax(-1))
        # a fully masked prefix keeps m at -inf: clamp the shift, or exp(-inf - -inf) is NaN
        shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.exp(m - shift)
        p = torch.exp(s - shift[..., None])
        l_new = l * alpha + p.sum(-1)
        acc_new = acc * alpha[..., None] + p.to(v.dtype).float() @ vt.float()
        a = active[:, None, None, :, None]
        m, l, acc = (torch.where(a, m_new, m), torch.where(a, l_new, l),
                     torch.where(a[..., None], acc_new, acc))
    out = _heads_out(acc / l[..., None], S).to(q.dtype)
    return out, (m + torch.log(l)).reshape(B, H, S)


def flash_attention_dq_reference(q, k, v, seg, lse, delta, do, ids, counts, cfg: _FlashConfig):
    """Plain version of kernel #2: dq ``[B, S, H, D]`` in q.dtype, from the
    saved ``lse`` and ``delta = Σ dO·O`` (both ``[B, H, S]`` f32); the same
    walk as the forward with ``p = exp(s - lse)`` (``_flash_dq_kernel``)."""
    B, S, H, D = q.shape
    bq, bkv, G, Hkv = cfg.block_q, cfg.block_kv, cfg.groups, cfg.hkv
    nq = S // bq
    qblk = torch.arange(nq, device=q.device).expand(B, nq)
    qb = _blocks(q, qblk, bq, G).float()
    dob = _blocks(do, qblk, bq, G).float()
    lse_b = _row_blocks(lse, qblk, bq, Hkv)[..., None]        # [B, Hkv, G, nq, bq, 1]
    delta_b = _row_blocks(delta, qblk, bq, Hkv)[..., None]
    dq = torch.zeros_like(qb)
    for t in range(ids.shape[-1]):
        blk, active = _step_blocks(ids, counts, t)
        kt = _blocks(k, blk, bkv)
        vt = _blocks(v, blk, bkv).float()
        s = _masked((qb @ kt.float().transpose(-1, -2)) * cfg.scale,
                    _allow_mask(cfg, seg, qblk, blk))
        p = torch.exp(s - lse_b)
        ds = p * (dob @ vt.transpose(-1, -2) - delta_b)
        upd = (ds.to(k.dtype).float() @ kt.float()) * cfg.scale
        dq = torch.where(active[:, None, None, :, None, None], dq + upd, dq)
    return _heads_out(dq, S).to(q.dtype)


def flash_attention_dkdv_reference(q, k, v, seg, lse, delta, do, idsT, countsT,
                                   cfg: _FlashConfig):
    """Plain version of kernel #3: ``(dk, dv)`` ``[B, S, Hkv, D]`` in k's and
    v's dtype. Each kv block walks its active q blocks (the transposed
    lattice) for every q head of its GQA group, summing the group in f32
    before one cast (``_flash_dkdv_kernel``)."""
    B, S, H, D = q.shape
    bq, bkv, G, Hkv = cfg.block_q, cfg.block_kv, cfg.groups, cfg.hkv
    nkv = S // bkv
    kblk = torch.arange(nkv, device=q.device).expand(B, nkv)
    kb = _blocks(k, kblk, bkv).float()                        # [B, Hkv, 1, nkv, bkv, D]
    vb = _blocks(v, kblk, bkv).float()
    dk = torch.zeros(B, Hkv, nkv, bkv, D, device=q.device)
    dv = torch.zeros_like(dk)
    for t in range(idsT.shape[-1]):
        qblk, active = _step_blocks(idsT, countsT, t)
        qt = _blocks(q, qblk, bq, G).float()                  # [B, Hkv, G, nkv, bq, D]
        dot = _blocks(do, qblk, bq, G)
        lse_t = _row_blocks(lse, qblk, bq, Hkv)[..., None]
        delta_t = _row_blocks(delta, qblk, bq, Hkv)[..., None]
        s = _masked((qt @ kb.transpose(-1, -2)) * cfg.scale, _allow_mask(cfg, seg, qblk, kblk))
        p = torch.exp(s - lse_t)                              # [B, Hkv, G, nkv, bq, bkv]
        dv_upd = p.to(do.dtype).float().transpose(-1, -2) @ dot.float()
        ds = p * (dot.float() @ vb.transpose(-1, -2) - delta_t)
        dk_upd = (ds.to(q.dtype).float().transpose(-1, -2) @ qt) * cfg.scale
        a = active[:, None, :, None, None]
        dk = torch.where(a, dk + dk_upd.sum(2), dk)
        dv = torch.where(a, dv + dv_upd.sum(2), dv)

    def out(x, dtype):  # [B, Hkv, nkv, bkv, D] → [B, S, Hkv, D]
        return x.permute(0, 2, 3, 1, 4).reshape(B, S, Hkv, D).to(dtype)

    return out(dk, k.dtype), out(dv, v.dtype)


def _check_flash(q, k, v, seg, cfg: _FlashConfig, lattice, *rows):
    """Validate what the flash kernels take; raise on anything else."""
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take q, k, v of one dtype among "
                        f"{sorted(map(str, _DTYPE_CODES))}; got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, H, D = q.shape
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or k.shape[:2] != (B, S)
            or k.shape[3] != D or (H, k.shape[2]) != (cfg.h, cfg.hkv) or H % cfg.hkv):
        raise ValueError(f"flash kernels take q [B, S, H, D] and k, v [B, S, Hkv, D] with H a "
                         f"multiple of Hkv; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if D not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {_FLASH_HEAD_DIMS}, got {D}")
    for blk in (cfg.block_q, cfg.block_kv):
        if blk % 64 or blk > _FLASH_MAX_BLOCK or S % blk:
            raise ValueError(f"flash kernels take blocks that are multiples of 64, at most "
                             f"{_FLASH_MAX_BLOCK} and dividing S={S}; got ({cfg.block_q}, "
                             f"{cfg.block_kv})")
    tensors = [q, k, v, seg, *lattice, *rows]
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash kernels need every tensor on one device")
    # the allocator aligns storage; an offset view may break the 16-byte loads
    if any(not t.is_contiguous() or t.storage_offset() * t.element_size() % 16 for t in tensors):
        raise ValueError("flash kernels need contiguous, 16-byte aligned tensors")
    if seg.dtype != torch.int32 or tuple(seg.shape) != (B, S):
        raise TypeError(f"segment ids must be int32 [B, S], got {seg.dtype} {tuple(seg.shape)}")
    ids, counts = lattice
    n_rows = ids.shape[1]
    if (ids.dtype != torch.int32 or counts.dtype != torch.int32 or ids.dim() != 3
            or tuple(counts.shape) != (B, n_rows) or ids.shape[0] != B):
        raise TypeError("the lattice must be int32 ids [B, n, m] and counts [B, n]")
    for x in rows:  # lse, delta
        if x.dtype != torch.float32 or tuple(x.shape) != (B, H, S):
            raise ValueError(f"lse and delta must be f32 [B, H, S], got {x.dtype} "
                             f"{tuple(x.shape)}")


def _flash_common_args(q, k, cfg: _FlashConfig):
    B, S, H, D = q.shape
    return (B, S, H, k.shape[2], D, _DTYPE_CODES[q.dtype], int(cfg.causal),
            int(cfg.window or 0), cfg.block_q, cfg.block_kv, float(cfg.scale),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_attention_fwd(q, k, v, seg, ids, counts, cfg: _FlashConfig):
    """Kernel #1 on a CUDA tensor, its plain version on a CPU one: ``(out,
    lse)`` as :func:`flash_attention_fwd_reference`."""
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, seg, ids, counts, cfg)
    _check_flash(q, k, v, seg, cfg, (ids, counts))
    lib = _build.load("flash_fwd")
    B, S, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr() if cfg.use_seg else None,
        ids.data_ptr(), counts.data_ptr(), out.data_ptr(), lse.data_ptr(),
        *_flash_common_args(q, k, cfg),
    )
    if err:
        raise _launch_error(lib, err, "flash_fwd")
    _count(flash_attention_fwd)
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_dq(q, k, v, seg, lse, delta, do, ids, counts, cfg: _FlashConfig):
    """Kernel #2 on a CUDA tensor, its plain version on a CPU one: dq as
    :func:`flash_attention_dq_reference`."""
    if not q.is_cuda:
        return flash_attention_dq_reference(q, k, v, seg, lse, delta, do, ids, counts, cfg)
    _check_flash(q, k, v, seg, cfg, (ids, counts), lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be contiguous and match q's shape and dtype")
    lib = _build.load("flash_dq")
    dq = torch.empty_like(q)
    err = lib.flash_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr() if cfg.use_seg else None,
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(), ids.data_ptr(), counts.data_ptr(),
        dq.data_ptr(), *_flash_common_args(q, k, cfg),
    )
    if err:
        raise _launch_error(lib, err, "flash_dq")
    _count(flash_attention_dq)
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkdv(q, k, v, seg, lse, delta, do, idsT, countsT, cfg: _FlashConfig):
    """Kernel #3 on a CUDA tensor, its plain version on a CPU one: ``(dk,
    dv)`` as :func:`flash_attention_dkdv_reference`."""
    if not q.is_cuda:
        return flash_attention_dkdv_reference(q, k, v, seg, lse, delta, do, idsT, countsT, cfg)
    _check_flash(q, k, v, seg, cfg, (idsT, countsT), lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError("do must be contiguous and match q's shape and dtype")
    lib = _build.load("flash_dkdv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = lib.flash_dkdv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr() if cfg.use_seg else None,
        lse.data_ptr(), delta.data_ptr(), do.data_ptr(), idsT.data_ptr(), countsT.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), *_flash_common_args(q, k, cfg),
    )
    if err:
        raise _launch_error(lib, err, "flash_dkdv")
    _count(flash_attention_dkdv)
    return dk, dv


flash_attention_dkdv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward through kernel #1, returning ``(out, lse)`` with ``lse [B,
    H, S]`` (f32) and saving both and the lattice; backward through kernel
    #2 then kernel #3, with ``δ = Σ dO·O`` formed in f32 between them — on
    the CPU, through their plain versions, so the split is the same on both
    devices. Both outputs are differentiable, for a caller that merges
    blocks of one softmax (the ring's blocks of
    :mod:`..parallel.long_context`).

    A gradient on ``lse`` runs kernels #2 and #3 unchanged, with ``δ −
    dlse`` in place of ``δ``: with ``P = exp(S − lse)`` and a loss on ``out
    = P V`` and on ``lse``, the gradient of the scores is ``dS = P ⊙ (dP −
    δ) + dlse · P = P ⊙ (dP − (δ − dlse))`` (``dP = dO Vᵀ``, ``δ = Σ dO ⊙ O``
    over the head dim, since ``∂lse/∂S = P``), and ``dV = Pᵀ dO`` does not
    see ``lse``. Where ``lse`` is unused its gradient is None (grads are
    not materialised) and ``δ`` is left as it is."""

    @staticmethod
    def forward(ctx, q, k, v, seg, cfg):
        ctx.set_materialize_grads(False)
        ids, counts, idsT, countsT = _block_lattice(seg, cfg)
        out, lse = flash_attention_fwd(q, k, v, seg, ids, counts, cfg)
        ctx.save_for_backward(q, k, v, seg, lse, out, ids, counts, idsT, countsT)
        ctx.cfg = cfg
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, seg, lse, out, ids, counts, idsT, countsT = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, S]
        if dlse is not None:
            delta = delta - dlse.float()
        delta = delta.contiguous()
        dq = flash_attention_dq(q, k, v, seg, lse, delta, do, ids, counts, ctx.cfg)
        dk, dv = flash_attention_dkdv(q, k, v, seg, lse, delta, do, idsT, countsT, ctx.cfg)
        return dq, dk, dv, None, None


def _flash_config(q, k, causal, scale, window, block_q, block_kv, use_seg) -> _FlashConfig:
    """The config of one flash call; raises where the blocked walk cannot
    tile the shapes (it needs ``Sq == Skv``, a multiple of both blocks)."""
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True (the sliding window is a causal band)")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    if not (Sq == Skv and Sq % bq == 0 and Skv % bkv == 0):
        raise ValueError(
            f"flash attention cannot tile q={tuple(q.shape)} k={tuple(k.shape)} with blocks "
            f"({bq}, {bkv}): it needs Sq == Skv, a multiple of both blocks; use impl='xla'")
    return _FlashConfig(scale=1.0 / math.sqrt(D) if scale is None else float(scale),
                        causal=bool(causal), window=window, block_q=bq, block_kv=bkv, h=H,
                        hkv=Hkv, use_seg=use_seg)


def flash_attention_lse(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
                        block_q: int = 128, block_kv: int = 128):
    """:func:`flash_attention` without segments or a window, returning
    ``(out, lse)``: ``out [B, S, H, D]`` and the rows' log-sum-exp of the
    scaled scores, ``lse [B, H, S]`` (f32), both differentiable. Blocks of
    one softmax split over keys merge from these: ``lse = logaddexp(lse₁,
    lse₂)``, ``out = Σ exp(lseᵢ − lse) · outᵢ``."""
    cfg = _flash_config(q, k, causal, scale, None, block_q, block_kv, False)
    seg = torch.zeros(q.shape[0], q.shape[1], dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(q, k, v, seg, cfg)


def flash_attention(q, k, v, *, causal: bool = False, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None, window: Optional[int] = None,
                    block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """Blocked streaming flash attention (BSHD in and out), forward and
    backward: ``q [B, S, H, D]``, ``k, v [B, S, Hkv, D]``, ``segment_ids [B,
    S]`` (padding = 0; position ``i`` attends ``j`` iff their ids match),
    ``window`` a causal sliding band (attend iff ``0 <= i - j < window``).
    Shapes the blocked walk cannot tile (``Sq != Skv``, S not a multiple of
    the block) raise: the JAX package drops to its einsum path there, the
    port leaves that choice to the caller (``impl='xla'``)."""
    cfg = _flash_config(q, k, causal, scale, window, block_q, block_kv, segment_ids is not None)
    B, Sq = q.shape[:2]
    seg = (segment_ids.to(torch.int32).contiguous() if segment_ids is not None
           else torch.zeros(B, Sq, dtype=torch.int32, device=q.device))
    return _FlashAttention.apply(q, k, v, seg, cfg)[0]
