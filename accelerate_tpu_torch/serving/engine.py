"""The serving engine: continuous batching over a paged KV cache — the port
of ``accelerate_tpu.serving.engine``.

One :class:`ServingEngine` owns the params and the paged block pool. Each
:meth:`~ServingEngine.step` admits what fits and prefills it in chunks
padded to the lattice's prefill buckets, then decodes one token for every
live slot in one batched paged forward at the bucketed (slots, table width)
shape, and completes and frees finished sequences. Selection is greedy
(``temperature=0``); prefix caching is always on.

The port runs eagerly: the reference's jit/AOT machinery (``warmup``, the
compile cache) has no counterpart, and the layer loop is a Python loop in
place of ``lax.scan``. Sampling, speculative decoding, mesh placement,
static batching, the admission watermark, resume-from-``generated``, chaos
hooks, telemetry and the watchdog are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..generation import _project_qkv
from ..models.transformer import (
    LlamaConfig,
    layer_params,
    llama_ffn,
    lm_logits,
    rms_norm,
    rope_frequencies,
)
from ..ops.flash_attention import paged_attention
from ..utils.device import resolve_device
from .buckets import BucketLattice
from .kv_pager import NULL_BLOCK, BlockAllocator, init_block_pool
from .scheduler import Request, Scheduler

__all__ = ["ServingEngine", "paged_forward"]


def rope_tables(config: LlamaConfig, device) -> "tuple[torch.Tensor, torch.Tensor]":
    cos, sin = rope_frequencies(config.head_dim, config.max_seq_len, config.rope_theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _paged_layer_step(layer, h, k_pool, v_pool, block_tables, positions, cos, sin,
                      config: LlamaConfig, block_size: int):
    """One decoder layer over per-row ``positions [B, S]``: write this
    step's K/V into the layer's pools at ``(block_tables[b, pos //
    block_size], pos % block_size)``, then attend through the tables."""
    B, S, _ = h.shape
    x = rms_norm(h, layer["attn_norm"]["scale"], config.norm_eps)
    q, k, v = _project_qkv(layer, x, positions, cos, sin, config)
    W = block_tables.shape[1]
    logical = positions // block_size
    phys = torch.gather(block_tables.long(), 1, logical.clamp(max=W - 1))
    # positions past the table (padded prefill tail) and inactive slots write
    # to the null block — a pad write may never land in a live block
    phys = torch.where(logical < W, phys, NULL_BLOCK)
    off = positions % block_size
    # the pool is written in place (index_put_), where the reference's
    # functional .at[].set returns a new pool
    k_pool.index_put_((phys, off), k.to(k_pool.dtype))
    v_pool.index_put_((phys, off), v.to(v_pool.dtype))
    attn = paged_attention(q, k_pool, v_pool, block_tables, positions)
    h = h + attn.reshape(B, S, -1) @ layer["wo"]["kernel"]
    x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
    return h + llama_ffn(layer, x, config)


def paged_forward(params, ids, pool, block_tables, positions, config: LlamaConfig,
                  block_size: int, rope=None):
    """Forward ``ids [B, S]`` at per-row ``positions [B, S]`` against the
    paged pool, writing their KV into it in place. Returns ``(logits [B, S,
    vocab], pool)``; ``rope`` is an optional precomputed ``(cos, sin)``."""
    cos, sin = rope if rope is not None else rope_tables(config, ids.device)
    h = params["embed_tokens"]["embedding"][ids]
    for i in range(config.n_layers):
        h = _paged_layer_step(
            layer_params(params, i), h, pool["k"][i], pool["v"][i], block_tables, positions,
            cos, sin, config, block_size,
        )
    return lm_logits(params, h, config), pool


class ServingEngine:
    """Continuous-batching serving engine over a paged KV cache.

    ``submit`` enqueues requests; each ``step`` admits what fits (prefill in
    bucketed chunks, skipping prefix-cached tokens), decodes one token for
    every live slot, completes/frees finished sequences and backfills their
    slots. Pool pressure preempts the youngest request, which later resumes
    with identical output. ``device`` defaults to ``"cuda"``; the params
    must already live there."""

    def __init__(self, params, config: LlamaConfig, *, num_blocks: int = 64,
                 block_size: int = 16, max_slots: int = 4,
                 max_prefill_len: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 lattice: Optional[BucketLattice] = None, device=None):
        self.device = resolve_device(device)
        emb = params["embed_tokens"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine device is {self.device}")
        self.params = params
        self.config = config
        self.block_size = block_size
        self.allocator = BlockAllocator(num_blocks, block_size)
        if max_blocks_per_seq is None:
            max_blocks_per_seq = self.allocator.usable_blocks
        max_prefill_len = max_prefill_len or min(
            config.max_seq_len, max_blocks_per_seq * block_size
        )
        if max_prefill_len > max_blocks_per_seq * block_size:
            raise ValueError(
                f"max_prefill_len={max_prefill_len} exceeds "
                f"{max_blocks_per_seq} block(s) x {block_size} slots"
            )
        self.lattice = lattice or BucketLattice.from_limits(
            max_slots, max_blocks_per_seq, max_prefill_len
        )
        self.scheduler = Scheduler(
            self.allocator, max_slots,
            max_seq_blocks=self.lattice.block_buckets[-1],
            max_seq_tokens=config.max_seq_len,
        )
        self.pool = init_block_pool(config, num_blocks, block_size, cache_dtype, self.device)
        self.rope = rope_tables(config, self.device)

        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        #: paged forwards run: one per prefill chunk, one per decode batch
        self.prefill_chunks = 0
        self.decode_steps = 0
        #: prompt tokens whose KV came from the prefix cache (prefill not done)
        self.prefix_cached_tokens = 0
        #: host wall seconds in prefill and in decode, each ending in the
        #: device→host read of the selected tokens
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- lifecycle -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *,
               eos_token_id: Optional[int] = None) -> Request:
        """Enqueue one request and return its live :class:`Request` handle;
        it finishes after ``max_new_tokens`` tokens or at ``eos_token_id``."""
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, arrival_t=time.monotonic())
        self.scheduler.submit(req)
        return req

    def step(self, now: Optional[float] = None) -> "list[Request]":
        """One engine iteration: admit + prefill, decode one token for every
        live slot, complete finished sequences. Returns the requests that
        left the engine this step (FINISHED, or REJECTED with ``error``)."""
        now = time.monotonic() if now is None else now
        finished: "list[Request]" = []
        admitted = self.scheduler.admissions()
        while self.scheduler.rejected:
            req = self.scheduler.rejected.pop()
            req.finish_t = now
            finished.append(req)
        for req in admitted:
            self._prefill_request(req, now)
            if req.done:
                self.scheduler.complete(req, now)
                finished.append(req)

        running = self.scheduler.running()
        if running:
            # reserve every live sequence's next KV slot first: a grow may
            # preempt the youngest, and the batch is built from survivors
            for req in list(running):
                if req.slot is not None:
                    self.scheduler.grow(req)
            running = self.scheduler.running()
        if running:
            self._decode_batch(running)
            for req in running:
                if req.done:
                    self.scheduler.complete(req, now)
                    finished.append(req)
        self.steps += 1
        return finished

    def run(self, max_steps: int = 100_000) -> "list[Request]":
        """Step until idle; returns all completions in finish order."""
        done: "list[Request]" = []
        for _ in range(max_steps):
            if self.scheduler.idle():
                return done
            done.extend(self.step())
        raise RuntimeError(f"engine not idle after {max_steps} steps")

    # -- internals -----------------------------------------------------------

    def _prefill_request(self, req: Request, now: float) -> None:
        """Prefill the request's uncached prefix tail in chunks of at most
        the largest prefill bucket, each padded to its smallest covering
        bucket; only the final chunk's selected token is kept. A pending
        copy-on-write pair is applied to the pool first."""
        t0 = time.perf_counter()
        prefix = req.output_ids()
        if req.cow_block is not None:
            src, dst = req.cow_block
            for name in ("k", "v"):
                self.pool[name][:, dst] = self.pool[name][:, src]
            self.allocator.cow_done(src)
            req.cow_block = None
        W = self.lattice.block_buckets[-1]  # a prefill runs at the widest table
        table = self._to_device(self.allocator.block_table(req.rid, pad_to=W)[None])
        chunk_cap = self.lattice.prefill_buckets[-1]
        start = int(req.cached_tokens)
        self.prefix_cached_tokens += start
        self.prefill_tokens += int(prefix.size) - start
        tok = None
        while start < prefix.size:
            chunk = prefix[start : start + chunk_cap]
            Sb = self.lattice.prefill_bucket(chunk.size)
            ids = np.zeros((1, Sb), np.int64)
            ids[0, : chunk.size] = chunk
            positions = start + torch.arange(Sb, device=self.device)[None]
            logits, self.pool = paged_forward(
                self.params, self._to_device(ids), self.pool, table, positions,
                self.config, self.block_size, rope=self.rope,
            )
            tok = torch.argmax(logits[0, chunk.size - 1])
            start += chunk.size
            self.prefill_chunks += 1
        req.generated.append(int(tok))
        if req.first_token_t is None:
            req.first_token_t = now
        self.prefill_seconds += time.perf_counter() - t0

    def _decode_batch(self, running: "list[Request]") -> None:
        t0 = time.perf_counter()
        Bb = self.lattice.slot_bucket(len(running))
        W = self.lattice.block_bucket(
            max(self.allocator.num_seq_blocks(r.rid) for r in running)
        )
        last = np.zeros((Bb, 1), np.int64)
        tables = np.full((Bb, W), NULL_BLOCK, np.int32)
        positions = np.zeros((Bb, 1), np.int64)
        for i, req in enumerate(running):
            last[i] = req.generated[-1]
            tables[i] = self.allocator.block_table(req.rid, pad_to=W)
            positions[i] = req.prefix_len - 1
        logits, self.pool = paged_forward(
            self.params, self._to_device(last), self.pool, self._to_device(tables),
            self._to_device(positions), self.config, self.block_size, rope=self.rope,
        )
        toks = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        for i, req in enumerate(running):
            req.generated.append(int(toks[i]))
            # this decode wrote the previous token's KV: once the written
            # count fills a block, that block becomes content-indexable
            written = req.prefix_len - 1
            if written > 0 and written % self.block_size == 0:
                self.allocator.register_full_blocks(req.rid, req.output_ids()[:-1])
        self.decode_tokens += len(running)
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "preemptions": self.scheduler.preemption_count,
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            **self.allocator.stats(),
        }
