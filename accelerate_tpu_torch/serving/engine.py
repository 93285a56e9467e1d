"""The serving engine: continuous batching over a paged KV cache — the port
of ``accelerate_tpu.serving.engine``.

One :class:`ServingEngine` owns the params and the paged block pool. Each
:meth:`~ServingEngine.step` admits what fits and prefills it in chunks
padded to the lattice's prefill buckets, then decodes one token for every
live slot in one batched paged forward at the bucketed (slots, table width)
shape, and completes and frees finished sequences.

Selection is greedy at ``temperature=0``; otherwise each request samples
from its own threefry stream (``prng_key(rng_seed)`` folded with the index
of the token in ``generated``, :mod:`..utils.random`), which draws the JAX
engine's tokens. ``spec_tokens=k`` with ``draft_layers=n`` turns on
speculative decoding: the verifier's first n layers propose k tokens a step
and one S=k+1 verify forward accepts the longest prefix that matches the
verifier's own selections, so the stream is the non-speculative one.
``continuous=False`` (static batching), ``admit_watermark_blocks``,
``prefix_cache=False`` and resuming from ``generated`` tokens behave as in
the reference.

``mesh=`` serves on one rank of a process group, as the reference's engine
serves over its devices: every rank builds the engine with its blocks of
the params (``parallel.sharding.shard_params`` with ``llama_shard_rules``)
and runs the same scheduler and allocator on the same requests; its pool is
its block under :func:`~..generation.serving_shardings`, ``[L, num_blocks,
block_size, Hkv/tp, D]``, and every paged forward is the Megatron layer of
:class:`~..generation.MeshDecode` with the paged kernels on the rank's
heads. The selected tokens are rank 0's on every rank, so the schedulers
never part.

The port runs eagerly: the reference's jit/AOT machinery (``warmup``, the
compile cache) has no counterpart, and the layer loop is a Python loop in
place of ``lax.scan``. Chaos hooks, telemetry, tracing and the watchdog
are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..generation import MeshDecode, _project_qkv, decode_capacity, sample_token_logits
from ..models.transformer import (
    LlamaConfig,
    draft_config,
    draft_params,
    layer_params,
    llama_ffn,
    lm_logits,
    rms_norm,
    rope_frequencies,
)
from ..ops.flash_attention import paged_attention
from ..utils.device import resolve_device
from ..utils.random import fold_in, prng_key
from .buckets import BucketLattice
from .kv_pager import NULL_BLOCK, BlockAllocator, init_block_pool
from .scheduler import Request, Scheduler

__all__ = ["ServingEngine", "paged_forward"]


def rope_tables(config: LlamaConfig, device) -> "tuple[torch.Tensor, torch.Tensor]":
    cos, sin = rope_frequencies(config.head_dim, config.max_seq_len, config.rope_theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _write_kv(k_pool, v_pool, phys, off, k, v) -> None:
    """This step's K/V into the layer's pools (the rank's heads under a
    mesh), in place (``index_put_``), where the reference's functional
    ``.at[].set`` returns a new pool."""
    k_pool.index_put_((phys, off), k.to(k_pool.dtype))
    v_pool.index_put_((phys, off), v.to(v_pool.dtype))


def _paged_layer_step(layer, h, k_pool, v_pool, block_tables, positions, cos, sin,
                      config: LlamaConfig, block_size: int, mesh: Optional[MeshDecode] = None):
    """One decoder layer over per-row ``positions [B, S]``: write this
    step's K/V into the layer's pools at ``(block_tables[b, pos //
    block_size], pos % block_size)``, then attend through the tables.
    Under ``mesh`` the rank's heads, with the sums over ``tp``."""
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
    _write_kv(k_pool, v_pool, phys, off, k, v)
    attn = paged_attention(q, k_pool, v_pool, block_tables, positions)
    out = attn.reshape(B, S, -1) @ layer["wo"]["kernel"]
    h = h + (out if mesh is None else mesh.attn_out(out))
    x = rms_norm(h, layer["mlp_norm"]["scale"], config.norm_eps)
    if mesh is not None:
        return h + mesh.ffn(layer, x, S)
    # MoE: every row of the [B, S] call, padding included, is routed and
    # competes for capacity, as in the JAX engine; S == 1 steps (decode,
    # drafts) get the decode floor, a prefill chunk or verify step does not
    y, _ = llama_ffn(layer, x, config, capacity_factor=decode_capacity(config, S))
    return h + y


def paged_forward(params, ids, pool, block_tables, positions, config: LlamaConfig,
                  block_size: int, rope=None, mesh: Optional[MeshDecode] = None):
    """Forward ``ids [B, S]`` at per-row ``positions [B, S]`` against the
    paged pool, writing their KV into it in place. Returns ``(logits [B, S,
    vocab], pool)``; ``rope`` is an optional precomputed ``(cos, sin)``.
    ``mesh`` (a :class:`~..generation.MeshDecode` over ``params``): one
    rank's forward, with the whole logits on every rank."""
    cos, sin = rope if rope is not None else rope_tables(config, ids.device)
    if mesh is not None:
        h = mesh.embed(ids)
        for i in range(config.n_layers):
            h = _paged_layer_step(mesh.layer(i), h, pool["k"][i], pool["v"][i], block_tables,
                                  positions, cos, sin, config, block_size, mesh)
        return mesh.logits(h), pool
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
    every live slot (or, with ``spec_tokens > 0``, up to k+1 through a
    self-draft and one verify forward), completes/frees finished sequences
    and backfills their slots. Pool pressure preempts the youngest request,
    which later resumes with identical output. Sampling knobs are
    engine-level, as in the reference; ``temperature=0`` is greedy.
    ``device`` defaults to ``"cuda"``; the params must already live there.
    ``mesh``: this rank's engine of a sharded one (the module docstring);
    ``param_specs`` name the params' placement when it is not
    ``llama_shard_rules``'."""

    def __init__(self, params, config: LlamaConfig, *, num_blocks: int = 64,
                 block_size: int = 16, max_slots: int = 4,
                 max_prefill_len: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 continuous: bool = True, admit_watermark_blocks: int = 0,
                 lattice: Optional[BucketLattice] = None, prefix_cache: bool = True,
                 spec_tokens: int = 0, draft_layers: Optional[int] = None, device=None,
                 mesh=None, param_specs=None):
        self.device = resolve_device(device)
        emb = params["embed_tokens"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine device is {self.device}")
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        self.spec_tokens = int(spec_tokens)
        self.draft_layers = draft_layers
        if self.spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if self.spec_tokens > 0 and draft_layers is None:
            raise ValueError("spec_tokens > 0 requires draft_layers (the self-draft depth)")
        self.params = params
        self.config = config
        self.block_size = block_size
        self.max_slots = max_slots
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.prefix_cache = prefix_cache
        self.allocator = BlockAllocator(num_blocks, block_size, prefix_caching=prefix_cache)
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
            continuous=continuous, admit_watermark_blocks=admit_watermark_blocks,
            max_seq_blocks=self.lattice.block_buckets[-1],
            max_seq_tokens=config.max_seq_len,
        )
        self.mesh = mesh
        self._md = self._draft_md = None
        if mesh is not None:
            self._md = MeshDecode(params, config, mesh, param_specs)
        self.pool = init_block_pool(config, num_blocks, block_size, cache_dtype, self.device,
                                    mesh=mesh)
        self.rope = rope_tables(config, self.device)
        if self.spec_tokens > 0:
            # truncated-layer self-draft: its layer i is verifier layer i
            # (views, no copy) and it runs over the first n layers of the
            # shared pool, written in place, so it needs no pool of its own
            self.draft_config = draft_config(config, int(draft_layers))
            self.draft_params = draft_params(params, int(draft_layers))
            if mesh is not None:
                self._draft_md = MeshDecode(self.draft_params, self.draft_config, mesh,
                                            self._md.specs)

        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        #: paged forwards run: one per prefill chunk, one per plain decode
        #: batch; with speculation, k draft steps and one verify a step
        self.prefill_chunks = 0
        self.prefill_calls = 0
        self.decode_steps = 0
        self.draft_steps = 0
        self.verify_steps = 0
        #: prompt tokens whose KV came from the prefix cache (prefill not done)
        self.prefix_cached_tokens = 0
        #: re-prefilled tokens: after a preemption, and of a request resumed
        #: from ``generated`` tokens another engine produced
        self.preempt_prefill_tokens = 0
        self.resume_prefill_tokens = 0
        self.max_running = 0
        self._occupancy_sum = 0.0
        self._occupancy_steps = 0
        #: speculative decoding: draft tokens proposed / accepted, and the
        #: accepted-per-slot-step histogram (index = tokens accepted, 0..k)
        self.draft_proposed_tokens = 0
        self.draft_accepted_tokens = 0
        self.spec_accept_hist = np.zeros(self.spec_tokens + 1, np.int64)
        #: host wall seconds in prefill and in decode, each ending in the
        #: device→host read of the selected tokens
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # -- lifecycle -----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, eos_token_id: Optional[int] = None,
               rng_seed: int = 0, arrival_t: Optional[float] = None,
               generated: Optional["list[int]"] = None) -> Request:
        """Enqueue one request and return its live :class:`Request` handle;
        it finishes after ``max_new_tokens`` tokens or at ``eos_token_id``.

        ``generated`` seeds the request with tokens another engine already
        produced: the prefill covers ``prompt + generated`` and sampling
        continues at fold index ``len(generated)``, so the continuation is
        the unbroken run's. ``max_new_tokens`` stays the total budget."""
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, rng_seed=rng_seed,
                      arrival_t=time.monotonic() if arrival_t is None else arrival_t)
        if generated:
            if len(generated) >= max_new_tokens:
                raise ValueError(
                    f"resume with {len(generated)} generated token(s) >= "
                    f"max_new_tokens={max_new_tokens}: nothing left to decode"
                )
            req.generated = [int(t) for t in generated]
        self.scheduler.submit(req)
        return req

    def step(self, now: Optional[float] = None) -> "list[Request]":
        """One engine iteration: admit + prefill, decode for every live
        slot, complete finished sequences. Returns the requests that left
        the engine this step (FINISHED, or REJECTED with ``error``)."""
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
            # reserve every live sequence's next KV slot(s) first: a grow may
            # preempt the youngest, and the batch is built from survivors.
            # Speculation reserves the verify's write span, up to k+1
            # positions clamped to the request's remaining budget (so
            # admission's worst case still covers it); a short accept's
            # leftover reservation is reused next step.
            for req in list(running):
                if req.slot is None:
                    continue
                if self.spec_tokens > 0:
                    remaining = req.max_new_tokens - len(req.generated)
                    target = (req.prefix_len - 1) + min(self.spec_tokens + 1, remaining)
                    self.scheduler.grow(req, target - self.allocator.tokens(req.rid))
                else:
                    self.scheduler.grow(req)
            running = self.scheduler.running()
        if running:
            if self.spec_tokens > 0:
                self._spec_decode_batch(running)
            else:
                self._decode_batch(running)
            for req in running:
                if req.done:
                    self.scheduler.complete(req, now)
                    finished.append(req)
        self.steps += 1
        self.max_running = max(self.max_running, len(running))
        self._occupancy_sum += len(running) / self.max_slots
        self._occupancy_steps += 1
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

    def _request_key(self, req: Request) -> "tuple[int, int]":
        # cached: the key is a pure function of rng_seed
        if req._key is None:
            req._key = tuple(prng_key(req.rng_seed).tolist())
        return req._key

    def _key_rows(self, reqs: "list[Request]", rows: int) -> Optional[torch.Tensor]:
        """Per-row ``(key word 0, key word 1, fold index)`` of ``reqs``,
        padded to ``rows``, as one int64 device tensor; None when greedy
        (no key is read)."""
        if self.temperature == 0.0:
            return None
        out = np.zeros((rows, 3), np.int64)
        for i, req in enumerate(reqs):
            out[i, :2] = self._request_key(req)
            out[i, 2] = len(req.generated)
        return self._to_device(out)

    def _select(self, logits: torch.Tensor, key_rows: Optional[torch.Tensor],
                offset=0) -> torch.Tensor:
        """Tokens ``[N]`` (on the device) from ``logits [N, V]``: argmax when
        greedy, else a draw from each row's key folded with its fold index
        plus ``offset``."""
        if key_rows is None:
            tok = torch.argmax(logits, dim=-1)
        else:
            keys = fold_in(key_rows[:, :2], key_rows[:, 2] + offset)
            tok = sample_token_logits(logits, keys, temperature=self.temperature,
                                      top_k=self.top_k, top_p=self.top_p)
        return tok if self._md is None else self._md.agree(tok)

    def _prefill_request(self, req: Request, now: float) -> None:
        """Prefill the request's uncached prefix tail in chunks of at most
        the largest prefill bucket, each padded to its smallest covering
        bucket; the token is selected from the final chunk's last real row.
        A pending copy-on-write pair is applied to the pool first."""
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
        if req.preemptions > 0:
            self.preempt_prefill_tokens += int(prefix.size) - start
        elif req.generated:
            self.resume_prefill_tokens += int(prefix.size) - start
        last = None
        while start < prefix.size:
            chunk = prefix[start : start + chunk_cap]
            Sb = self.lattice.prefill_bucket(chunk.size)
            ids = np.zeros((1, Sb), np.int64)
            ids[0, : chunk.size] = chunk
            # the padded rows' positions may pass max_seq_len: the RoPE
            # lookup clamps them and their KV writes past the table go to the
            # null block, as in the JAX engine
            positions = start + torch.arange(Sb, device=self.device)[None]
            logits, self.pool = paged_forward(
                self.params, self._to_device(ids), self.pool, table, positions,
                self.config, self.block_size, rope=self.rope, mesh=self._md,
            )
            last = logits[0, chunk.size - 1 : chunk.size]
            start += chunk.size
            self.prefill_chunks += 1
        req.generated.append(int(self._select(last, self._key_rows([req], 1))[0]))
        if req.first_token_t is None:
            req.first_token_t = now
        self.prefill_calls += 1
        self.prefill_seconds += time.perf_counter() - t0

    def _batch(self, running: "list[Request]"):
        """The bucketed decode batch of ``running``: (rows, last tokens
        [Bb], tables [Bb, W], positions [Bb]) on the host, padded rows on
        the null block at position 0."""
        Bb = self.lattice.slot_bucket(len(running))
        W = self.lattice.block_bucket(
            max(self.allocator.num_seq_blocks(r.rid) for r in running)
        )
        last = np.zeros((Bb,), np.int64)
        tables = np.full((Bb, W), NULL_BLOCK, np.int32)
        positions = np.zeros((Bb,), np.int64)
        for i, req in enumerate(running):
            last[i] = req.generated[-1]
            tables[i] = self.allocator.block_table(req.rid, pad_to=W)
            positions[i] = req.prefix_len - 1
        return Bb, last, tables, positions

    def _register_written(self, req: Request, before: int) -> None:
        """Content-index the blocks this step filled: the KV written so far
        covers ``prefix_len - 1`` tokens, ``before`` before the step."""
        written = req.prefix_len - 1
        if self.prefix_cache and written // self.block_size > before // self.block_size:
            # registration is incremental: one call covers every boundary a
            # multi-token accept crossed
            self.allocator.register_full_blocks(req.rid, req.output_ids()[:-1])

    def _decode_batch(self, running: "list[Request]") -> None:
        t0 = time.perf_counter()
        Bb, last, tables, positions = self._batch(running)
        logits, self.pool = paged_forward(
            self.params, self._to_device(last[:, None]), self.pool, self._to_device(tables),
            self._to_device(positions[:, None]), self.config, self.block_size, rope=self.rope,
            mesh=self._md,
        )
        toks = self._select(logits[:, -1], self._key_rows(running, Bb)).cpu().numpy()
        for i, req in enumerate(running):
            req.generated.append(int(toks[i]))
            # this decode wrote the previous token's KV
            self._register_written(req, req.prefix_len - 2)
        self.decode_tokens += len(running)
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0

    def _spec_decode_batch(self, running: "list[Request]") -> None:
        """One speculative round for every live slot: k S=1 steps of the
        self-draft over the first ``draft_layers`` layers of the shared pool
        propose candidates (kept on the device), one S=k+1 verify forward
        (the paged prefill kernel) writes their KV and selects, per (row,
        column j), the token the non-speculative stream emits at fold index
        ``len(generated) + j``; the host reads candidates and selections
        once and accepts the longest candidate prefix that matches them.

        Every request emits at least the verifier's own token (column 0), so
        a 0 % accept rate degrades to one token a step. Rejected columns'
        KV sits past the emitted prefix, masked by position from every read
        until a later step overwrites it."""
        t0 = time.perf_counter()
        k = self.spec_tokens
        Bb, last, tables, positions = self._batch(running)
        # emit at most as many tokens as the grow phase reserved KV room for
        rows = [self.allocator.tokens(r.rid) - (r.prefix_len - 1) for r in running]
        key_rows = self._key_rows(running, Bb)
        tables_d = self._to_device(tables)
        pos_d = self._to_device(positions[:, None])
        cand = torch.empty((Bb, k + 1), dtype=torch.int64, device=self.device)
        cand[:, 0] = self._to_device(last)
        for j in range(k):
            logits, self.pool = paged_forward(
                self.draft_params, cand[:, j : j + 1], self.pool, tables_d, pos_d + j,
                self.draft_config, self.block_size, rope=self.rope, mesh=self._draft_md,
            )
            cand[:, j + 1] = self._select(logits[:, -1], key_rows, j)
        cols = torch.arange(k + 1, device=self.device)
        logits, self.pool = paged_forward(
            self.params, cand, self.pool, tables_d, pos_d + cols[None], self.config,
            self.block_size, rope=self.rope, mesh=self._md,
        )
        sel = self._select(
            logits.reshape(Bb * (k + 1), -1),
            None if key_rows is None else key_rows.repeat_interleave(k + 1, dim=0),
            cols.repeat(Bb),
        ).reshape(Bb, k + 1)
        cand, sel = torch.stack([cand, sel]).cpu().numpy()
        emitted = 0
        for i, req in enumerate(running):
            r_i = min(rows[i], k + 1)
            before = req.prefix_len - 1
            n_acc = 0
            for j in range(r_i):
                tok = int(sel[i, j])
                req.generated.append(tok)
                emitted += 1
                if req.done:
                    break
                if j + 1 < r_i and int(cand[i, j + 1]) == tok:
                    n_acc += 1
                    continue
                break
            self.draft_proposed_tokens += max(r_i - 1, 0)
            self.draft_accepted_tokens += n_acc
            self.spec_accept_hist[n_acc] += 1
            self._register_written(req, before)
        self.decode_tokens += emitted
        self.draft_steps += k
        self.verify_steps += 1
        self.decode_seconds += time.perf_counter() - t0

    def stats(self) -> dict:
        out = {
            "steps": self.steps,
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "prefill_calls": self.prefill_calls,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "draft_steps": self.draft_steps,
            "verify_steps": self.verify_steps,
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "preempt_prefill_tokens": self.preempt_prefill_tokens,
            "resume_prefill_tokens": self.resume_prefill_tokens,
            "preemptions": self.scheduler.preemption_count,
            "max_running": self.max_running,
            "mean_occupancy": round(self._occupancy_sum / max(self._occupancy_steps, 1), 6),
            "prefill_seconds": self.prefill_seconds,
            "decode_seconds": self.decode_seconds,
            **self.allocator.stats(),
        }
        if self.spec_tokens > 0:
            out.update(
                spec_tokens=self.spec_tokens,
                draft_layers=self.draft_layers,
                draft_proposed_tokens=self.draft_proposed_tokens,
                draft_accepted_tokens=self.draft_accepted_tokens,
                draft_rejected_tokens=self.draft_proposed_tokens - self.draft_accepted_tokens,
                spec_accept_rate=round(
                    self.draft_accepted_tokens / self.draft_proposed_tokens, 6
                ) if self.draft_proposed_tokens else 0.0,
                spec_accept_hist=self.spec_accept_hist.tolist(),
            )
        if self.prefix_cache:
            # hit rate over prompt tokens: cached / (cached + prefilled)
            total = self.prefix_cached_tokens + self.prefill_tokens
            out.update(
                prefill_tokens_saved=self.prefix_cached_tokens,
                prefix_hit_rate=round(self.prefix_cached_tokens / total, 6) if total else 0.0,
            )
        return out
