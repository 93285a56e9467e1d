"""Paged KV cache: the port of ``accelerate_tpu.serving.kv_pager``.

One preallocated device pool ``{"k","v"}: [L, num_blocks, block_size, Hkv,
D]`` is carved into fixed-size blocks; :class:`BlockAllocator` is the
host-side bookkeeping (free list, per-sequence block tables, and, with
``prefix_caching=True``, automatic prefix caching with copy-on-write), pure
Python/numpy/hashlib and copied from the reference so that the two engines
make identical decisions.
Physical block 0 is the **null block**: inactive batch slots and padded
table entries point at it, so their writes never touch a live sequence.

:func:`paged_attention` is the gather reference: collect each row's blocks
through its table and run the shared masked-attention core. The CUDA
kernels behind ``ops.flash_attention.paged_attention`` replace the gather
with a walk over the table; this function stays the reference semantics.

``chain_hashes`` and ``adopt_block`` are the two halves of a KV handoff's
addressing (``serving/disagg.py``): the content addresses of a prefilled
sequence's full blocks, and a handed-off block parked in the LRU pool.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..generation import _masked_attention
from ..models.transformer import LlamaConfig
from ..utils.device import resolve_device

__all__ = [
    "NULL_BLOCK",
    "BlockPoolExhausted",
    "BlockAllocatorError",
    "BlockAllocator",
    "PrefixPlan",
    "PrefixAllocation",
    "gather_blocks",
    "init_block_pool",
    "paged_attention",
]

#: physical block index reserved for inactive/padded writes (never allocated)
NULL_BLOCK = 0


class BlockAllocatorError(RuntimeError):
    """Misuse of the allocator: double-free, append/lookup after free."""


class BlockPoolExhausted(RuntimeError):
    """No free block available — the scheduler should preempt or defer."""


def init_block_pool(config: LlamaConfig, num_blocks: int, block_size: int,
                    dtype: torch.dtype = torch.bfloat16, device=None, mesh=None) -> dict:
    """Device pool ``{"k","v"}: [L, num_blocks, block_size, Hkv, D]``
    (``num_blocks`` INCLUDES the reserved null block 0), zero-filled, on
    ``device`` (``None``: the CUDA device, raising without one). Under
    ``mesh`` (one rank of a sharded engine) the rank's block of it under
    ``generation.serving_shardings``: its ``Hkv/tp`` heads."""
    shape = (config.n_layers, num_blocks, block_size, config.n_kv_heads, config.head_dim)
    if mesh is not None:
        from ..generation import serving_shardings
        from ..parallel.sharding import shard_index

        shape = tuple(s.stop - s.start for s in shard_index(
            serving_shardings(mesh, config), shape, mesh))
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _chain_hash(prev: bytes, block_tokens: np.ndarray) -> bytes:
    """Hash of one full block chained over everything before it, so a
    single-block match IS a whole-prefix match (blake2b-128)."""
    return hashlib.blake2b(
        prev + np.asarray(block_tokens, np.int32).tobytes(), digest_size=16
    ).digest()


@dataclass(frozen=True)
class PrefixPlan:
    """Read-only admission plan for one token prefix (``plan_prefix``):
    the cached blocks covering the longest cached block-aligned prefix,
    how many leading tokens need no prefill, whether the last matched block
    must be copied on write, the fresh blocks allocation will take, and how
    many matched blocks sit in the reclaimable LRU pool (admission charges
    ``fresh_blocks + lru_pinned``)."""

    matched: "tuple[int, ...]"
    hashes: "tuple[bytes, ...]"
    cached_tokens: int
    cow: bool
    fresh_blocks: int
    lru_pinned: int = 0


@dataclass(frozen=True)
class PrefixAllocation:
    """Result of :meth:`BlockAllocator.allocate_with_prefix`: the block
    table, how many leading tokens are already cached, and the
    copy-on-write pair ``(src, dst)`` the engine applies to the pool before
    any write (``None`` when no COW)."""

    table: "list[int]"
    cached_tokens: int
    cow: "Optional[tuple[int, int]]"


class BlockAllocator:
    """Host-side block bookkeeping for one device pool.

    Free blocks live on a LIFO free list. Per-sequence state is a block
    table plus the token count; ``append`` grows the table only when the
    count crosses a block boundary. With ``prefix_caching=True`` blocks are
    reference counted and full blocks content-addressed, cached blocks map
    into new tables, and zero-reference cached blocks park in an LRU pool
    that is reclaimed before any exhaustion error. ``prefix_caching=False``
    (the reference's default) takes every legacy path: no hashing, no
    sharing, every reference count exactly one."""

    def __init__(self, num_blocks: int, block_size: int, *, prefix_caching: bool = False):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved null block)")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.prefix_caching = prefix_caching
        # LIFO: lowest ids are handed out first at start, re-frees come back
        # on top. Block 0 is never on the list (reserved null block).
        self._free: "list[int]" = list(range(num_blocks - 1, 0, -1))
        self._tables: "dict[object, list[int]]" = {}
        self._tokens: "dict[object, int]" = {}
        self._ref: "dict[int, int]" = {}  # physical block -> reference count
        self._cached: "dict[bytes, int]" = {}  # chain hash -> physical block
        self._block_hash: "dict[int, bytes]" = {}  # physical block -> chain hash
        #: cached blocks with zero references, oldest-unreferenced first
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        #: per-sequence chain hashes of its full blocks registered so far
        self._chain: "dict[object, list[bytes]]" = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.reclaimed_blocks = 0

    # -- capacity ------------------------------------------------------------

    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks (pool minus the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def reclaimable_blocks(self) -> int:
        return len(self._lru)

    @property
    def available_blocks(self) -> int:
        """Truly free blocks plus the reclaimable LRU pool: the admission
        accounting number."""
        return len(self._free) + len(self._lru)

    @property
    def used_blocks(self) -> int:
        return self.usable_blocks - self.available_blocks

    def blocks_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.block_size))

    def can_allocate(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.available_blocks

    # -- prefix cache internals ----------------------------------------------

    def _take_block(self) -> int:
        """Pop a free block, reclaiming the least-recently-unreferenced
        cached block when the free list is dry. Caller checked capacity."""
        if self._free:
            return self._free.pop()
        blk, _ = self._lru.popitem(last=False)
        h = self._block_hash.pop(blk)
        del self._cached[h]
        self.reclaimed_blocks += 1
        return blk

    def _unref(self, blk: int) -> None:
        self._ref[blk] = self._ref.get(blk, 1) - 1
        if self._ref[blk] > 0:
            return
        del self._ref[blk]
        if blk in self._block_hash:
            self._lru[blk] = None
        else:
            self._free.append(blk)

    def _match_chain(self, token_ids: np.ndarray) -> "tuple[list[int], list[bytes]]":
        blocks: "list[int]" = []
        hashes: "list[bytes]" = []
        prev = b""
        for i in range(len(token_ids) // self.block_size):
            h = _chain_hash(prev, token_ids[i * self.block_size : (i + 1) * self.block_size])
            blk = self._cached.get(h)
            if blk is None:
                break
            blocks.append(blk)
            hashes.append(h)
            prev = h
        return blocks, hashes

    def plan_prefix(self, token_ids) -> PrefixPlan:
        """Read-only: what ``allocate_with_prefix`` would reuse and take."""
        token_ids = np.asarray(token_ids, np.int32).reshape(-1)
        n = int(token_ids.size)
        total = self.blocks_for(n)
        if not self.prefix_caching:
            return PrefixPlan((), (), 0, False, total)
        matched, hashes = self._match_chain(token_ids)
        pinned = sum(1 for b in matched if b in self._lru)
        if matched and len(matched) * self.block_size == n:
            # whole prefix cached — COW the last matched block so the engine
            # can recompute the final position's logits in a private block
            return PrefixPlan(
                tuple(matched), tuple(hashes), n - 1, True,
                total - len(matched) + 1, pinned,
            )
        return PrefixPlan(
            tuple(matched), tuple(hashes),
            len(matched) * self.block_size, False, total - len(matched), pinned,
        )

    # -- lifecycle -----------------------------------------------------------

    def allocate(self, seq_id, n_tokens: int) -> "list[int]":
        """Create a sequence holding ``n_tokens`` from fresh blocks only;
        returns the block table. All-or-nothing on exhaustion."""
        if seq_id in self._tables:
            raise BlockAllocatorError(f"sequence {seq_id!r} already allocated")
        need = self.blocks_for(n_tokens)
        if need > self.available_blocks:
            raise BlockPoolExhausted(
                f"need {need} block(s) for {n_tokens} token(s), "
                f"only {self.available_blocks} free"
            )
        table = [self._take_block() for _ in range(need)]
        for blk in table:
            self._ref[blk] = 1
        self._tables[seq_id] = table
        self._tokens[seq_id] = n_tokens
        self._chain[seq_id] = []
        return list(table)

    def allocate_with_prefix(self, seq_id, token_ids,
                             plan: "Optional[PrefixPlan]" = None) -> PrefixAllocation:
        """Create a sequence for ``token_ids``, mapping the longest cached
        block-aligned prefix into its table and taking fresh blocks only
        for the uncached tail. ``plan`` must be a fresh
        :meth:`plan_prefix` of the same tokens. With caching off this is
        :meth:`allocate`."""
        token_ids = np.asarray(token_ids, np.int32).reshape(-1)
        n = int(token_ids.size)
        if not self.prefix_caching:
            return PrefixAllocation(self.allocate(seq_id, n), 0, None)
        if seq_id in self._tables:
            raise BlockAllocatorError(f"sequence {seq_id!r} already allocated")
        if plan is None:
            plan = self.plan_prefix(token_ids)
        if plan.fresh_blocks > self.available_blocks - plan.lru_pinned:
            raise BlockPoolExhausted(
                f"need {plan.fresh_blocks} fresh block(s) for {n} token(s) "
                f"({len(plan.matched)} cached), only "
                f"{self.available_blocks - plan.lru_pinned} available"
            )
        for blk in plan.matched:
            self._ref[blk] = self._ref.get(blk, 0) + 1
            self._lru.pop(blk, None)
        table = list(plan.matched)
        cow: "Optional[tuple[int, int]]" = None
        if plan.cow:
            dst = self._take_block()
            self._ref[dst] = 1
            src = table[-1]
            table[-1] = dst
            # src keeps its reference until the engine has issued the copy
            # (:meth:`cow_done`), so no admission in between can reclaim it
            cow = (src, dst)
        for _ in range(self.blocks_for(n) - len(table)):
            blk = self._take_block()
            self._ref[blk] = 1
            table.append(blk)
        self._tables[seq_id] = table
        self._tokens[seq_id] = n
        self._chain[seq_id] = list(plan.hashes)
        # index the uncached tail's full blocks now: admission order is
        # prefill order, so a later admission in the same step may map them
        self.register_full_blocks(seq_id, token_ids)
        self.prefix_lookups += 1
        if plan.cached_tokens:
            self.prefix_hits += 1
            self.prefix_hit_tokens += plan.cached_tokens
        if cow is not None:
            self.cow_copies += 1
        return PrefixAllocation(list(table), plan.cached_tokens, cow)

    def cow_done(self, blk: int) -> None:
        """Release the copy-on-write pin on ``blk`` after the device copy."""
        self._unref(blk)

    def register_full_blocks(self, seq_id, written_token_ids) -> int:
        """Content-index every full block of ``seq_id`` not yet registered
        (incremental; first writer wins; a no-op with caching off). Returns
        how many were indexed."""
        if not self.prefix_caching:
            return 0
        if seq_id not in self._tables:
            raise BlockAllocatorError(
                f"register on unknown/freed sequence {seq_id!r} (use-after-free?)"
            )
        written = np.asarray(written_token_ids, np.int32).reshape(-1)
        table = self._tables[seq_id]
        chain = self._chain[seq_id]
        n_full = min(int(written.size) // self.block_size, len(table))
        new = 0
        while len(chain) < n_full:
            i = len(chain)
            h = _chain_hash(
                chain[-1] if chain else b"",
                written[i * self.block_size : (i + 1) * self.block_size],
            )
            chain.append(h)
            blk = table[i]
            if h not in self._cached and blk not in self._block_hash and blk != NULL_BLOCK:
                self._cached[h] = blk
                self._block_hash[blk] = h
                new += 1
        return new

    def chain_hashes(self, seq_id) -> "list[bytes]":
        """The sequence's registered full-block chain hashes, oldest first:
        the content addresses a KV handoff ships. Raises on an unknown or
        freed sequence like every other lookup."""
        if seq_id not in self._tables:
            raise BlockAllocatorError(
                f"chain_hashes of unknown/freed sequence {seq_id!r} (use-after-free?)"
            )
        return list(self._chain.get(seq_id, []))

    def adopt_block(self, chain_hash: bytes) -> Optional[int]:
        """Content-index one externally produced full block (the decode side
        of a KV handoff): take a block, register it under ``chain_hash`` and
        park it unreferenced in the LRU pool, where the next admission's
        :meth:`plan_prefix` can match it and pressure can reclaim it. The
        caller writes the block's content at the returned index. ``None``
        when the hash is already cached (nothing to copy)."""
        if not self.prefix_caching:
            raise BlockAllocatorError("adopt_block requires prefix_caching=True")
        if chain_hash in self._cached:
            return None
        if self.available_blocks < 1:
            raise BlockPoolExhausted("no block available to adopt a handed-off KV block")
        blk = self._take_block()
        self._cached[chain_hash] = blk
        self._block_hash[blk] = chain_hash
        self._lru[blk] = None
        return blk

    def append(self, seq_id, n_tokens: int = 1) -> "list[int]":
        """Grow a sequence by ``n_tokens``; on exhaustion the sequence is
        left unchanged and :class:`BlockPoolExhausted` propagates."""
        if seq_id not in self._tables:
            raise BlockAllocatorError(
                f"append on unknown/freed sequence {seq_id!r} (use-after-free?)"
            )
        have = len(self._tables[seq_id])
        need = self.blocks_for(self._tokens[seq_id] + n_tokens) - have
        if need > self.available_blocks:
            raise BlockPoolExhausted(
                f"sequence {seq_id!r} needs {need} more block(s), "
                f"only {self.available_blocks} free"
            )
        new = [self._take_block() for _ in range(max(0, need))]
        for blk in new:
            self._ref[blk] = 1
        self._tables[seq_id].extend(new)
        self._tokens[seq_id] += n_tokens
        return new

    def free(self, seq_id) -> int:
        """Drop all of a sequence's references; returns how many blocks it
        held. Double-free raises :class:`BlockAllocatorError`."""
        if seq_id not in self._tables:
            raise BlockAllocatorError(f"double free of sequence {seq_id!r}")
        table = self._tables.pop(seq_id)
        del self._tokens[seq_id]
        self._chain.pop(seq_id, None)
        for blk in reversed(table):  # LIFO: first-allocated reused last
            self._unref(blk)
        return len(table)

    # -- views ---------------------------------------------------------------

    def block_table(self, seq_id, pad_to: Optional[int] = None) -> np.ndarray:
        """Physical block ids (logical order) as int32, null-padded to
        ``pad_to``."""
        if seq_id not in self._tables:
            raise BlockAllocatorError(
                f"block_table of unknown/freed sequence {seq_id!r} (use-after-free?)"
            )
        table = self._tables[seq_id]
        width = len(table) if pad_to is None else pad_to
        if len(table) > width:
            raise ValueError(f"table of {len(table)} block(s) does not fit pad_to={pad_to}")
        out = np.full((width,), NULL_BLOCK, np.int32)
        out[: len(table)] = table
        return out

    def tokens(self, seq_id) -> int:
        """Tokens the sequence holds room for (its reservation)."""
        if seq_id not in self._tokens:
            raise BlockAllocatorError(f"tokens of unknown/freed sequence {seq_id!r}")
        return self._tokens[seq_id]

    def num_seq_blocks(self, seq_id) -> int:
        if seq_id not in self._tables:
            raise BlockAllocatorError(f"blocks of unknown/freed sequence {seq_id!r}")
        return len(self._tables[seq_id])

    def live_sequences(self) -> list:
        return list(self._tables)

    def occupancy(self) -> float:
        return self.used_blocks / self.usable_blocks

    def fragmentation(self) -> float:
        """Fraction of allocated slots holding no token (the unwritten tails
        of last blocks); 0.0 when nothing is allocated. Shared blocks can
        push the logical token count past the physical slots: clamped at 0."""
        allocated_slots = self.used_blocks * self.block_size
        if not allocated_slots:
            return 0.0
        live_tokens = sum(self._tokens.values())
        return max(0.0, (allocated_slots - live_tokens) / allocated_slots)

    def shared_blocks(self) -> int:
        return sum(1 for c in self._ref.values() if c > 1)

    def stats(self) -> dict:
        out = {
            "block_size": self.block_size,
            "usable_blocks": self.usable_blocks,
            "free_blocks": self.free_blocks,
            "used_blocks": self.used_blocks,
            "sequences": len(self._tables),
            "live_tokens": sum(self._tokens.values()),
            "occupancy": round(self.occupancy(), 6),
            "fragmentation": round(self.fragmentation(), 6),
        }
        if self.prefix_caching:
            out.update(
                cached_blocks=len(self._block_hash),
                reclaimable_blocks=self.reclaimable_blocks,
                shared_blocks=self.shared_blocks(),
                prefix_lookups=self.prefix_lookups,
                prefix_hits=self.prefix_hits,
                prefix_hit_tokens=self.prefix_hit_tokens,
                cow_copies=self.cow_copies,
                reclaimed_blocks=self.reclaimed_blocks,
            )
        return out


def gather_blocks(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """One layer's pool ``[num_blocks, bs, Hkv, D]`` gathered through
    ``block_tables [B, W]`` into contiguous ``[B, W*bs, Hkv, D]``: gathered
    slot ``t`` holds logical token ``t`` of the row's sequence."""
    B = block_tables.shape[0]
    return pool[block_tables.long()].reshape(B, -1, pool.shape[2], pool.shape[3])


def paged_attention(q, k_pool, v_pool, block_tables, q_positions, scale=None):
    """Gather reference: q ``[B, S, H, D]``; per-layer pools ``[num_blocks,
    block_size, Hkv, D]``; ``block_tables [B, W]``; ``q_positions [B, S]``.
    Only gathered slots ``t <= q_position`` are attended, so null and stale
    slots contribute an exact 0."""
    k_cache = gather_blocks(k_pool, block_tables)
    v_cache = gather_blocks(v_pool, block_tables)
    kv_pos = torch.arange(k_cache.shape[1], device=q.device)
    allow = kv_pos[None, None, :] <= q_positions[:, :, None]  # [B, S, T]
    return _masked_attention(q, k_cache, v_cache, allow[:, None], scale)
