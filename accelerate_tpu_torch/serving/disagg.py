"""Disaggregated prefill/decode serving: the port of
``accelerate_tpu.serving.disagg``.

The monolithic :class:`~.engine.ServingEngine` runs chunked prefill and
batched decode in one loop, so a long prompt stalls every decode slot
behind it. The split:

- :class:`PrefillEngine` — chunked prefill only. Each admitted request is
  prefilled (its first token selected at fold index 0, as in the
  monolith), then leaves as a **content-addressed KV handoff**: the
  prompt's full blocks, named by the prefix-cache chain hashes
  (``h_i = H(h_{i-1}, tokens_i)``) and carried with their pool content.
  The freed blocks stay registered in the engine's own LRU pool.
- :class:`DecodeEngine` — batched decode only. A handoff **lands** by
  adopting each block into the pool's content index
  (:meth:`~.kv_pager.BlockAllocator.adopt_block`) and writing its content;
  the request's admission is gated until then, and prefix-cache admission
  then maps the landed blocks and re-prefills only the sub-block tail,
  through the resume path failover uses.
- :class:`KVTransport` — how handoff bytes move.
  :class:`LocalBlockCopyTransport` goes through host memory (one
  device-to-host copy of the blocks on the prefill side, one host-to-device
  copy and one indexed write on the decode side).
- :class:`DisaggRouter` — two-tier dispatch over one fleet: requests with
  no progress go to the prefill tier, requests with progress or a verified
  handoff to the decode tier. The handoff is CRC- and chain-hash-verified
  at the router; a corrupt one re-runs prefill from scratch.

Wire format: the reference's, a JSON-able dict (tokens, hex chain hashes,
base64 float32 blocks ``[n, L, block_size, Hkv, D]``, ``crc32`` chained
over k then v), on both transports. bf16 → f32 widening is exact and f32 →
bf16 restores the original bits, so the f32 wire keeps parity. The
reference's chaos point ``kv_handoff``, metrics, ``kv_handoff`` records
and trace spans go with the telemetry (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

import base64
import time
import zlib
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .engine import ServingEngine
from .kv_pager import NULL_BLOCK, BlockPoolExhausted, _chain_hash
from .replica import ReplicaState
from .router import RouterRequestStatus, ServingRouter
from .scheduler import Request

__all__ = [
    "KVHandoff",
    "KVTransport",
    "LocalBlockCopyTransport",
    "PrefillEngine",
    "DecodeEngine",
    "DisaggRouter",
]


# ---------------------------------------------------------------------------
# the transfer unit


@dataclass(eq=False)
class KVHandoff:
    """One request's prefilled KV, content-addressed and self-verifying.

    Covers the PROMPT's full blocks only (``P // block_size`` of them — the
    prefill engine writes KV for prompt positions, and partial tail blocks
    are cheaper to re-prefill than to ship sub-block state). ``hashes`` are
    the prefix-cache chain hashes, recomputable from ``prompt`` alone, so
    the receiver can prove the payload describes this exact prompt; ``crc``
    covers the block content bytes. ``first_token`` is the token the prefill
    engine sampled at fold index 0 — the decode side resumes with
    ``generated=[first_token]`` and samples fold 1 next, exactly the
    monolith's schedule."""

    prompt: np.ndarray            # int32 [P]
    first_token: int
    block_size: int
    hashes: "tuple[bytes, ...]"   # chain hashes over prompt full blocks
    k: np.ndarray                 # float32 [n_blocks, L, block_size, Hkv, D]
    v: np.ndarray
    crc: int
    src_replica: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)

    @property
    def n_blocks(self) -> int:
        return len(self.hashes)

    @property
    def nbytes(self) -> int:
        return int(self.k.nbytes) + int(self.v.nbytes)

    @classmethod
    def capture(cls, engine, req, src_replica: Optional[str] = None) -> "KVHandoff":
        """Gather the request's prompt full blocks out of ``engine``'s pool
        (one device-to-host copy each of k and v). Must run before
        ``scheduler.complete`` releases the sequence (the block table
        lookup raises after the free)."""
        alloc = engine.allocator
        n_full = int(req.prompt.size) // engine.block_size
        hashes = tuple(alloc.chain_hashes(req.rid)[:n_full])
        shape = engine.pool["k"].shape  # [L, num_blocks, B, Hkv, D]
        if hashes:
            idx = torch.as_tensor(alloc.block_table(req.rid)[: len(hashes)],
                                  dtype=torch.long, device=engine.pool["k"].device)
            # [L, n, B, Hkv, D] -> [n, L, B, Hkv, D]; bf16 -> f32 is exact
            k, v = (engine.pool[name][:, idx].to(torch.float32).transpose(0, 1)
                    .contiguous().cpu().numpy() for name in ("k", "v"))
        else:  # prompt shorter than one block: the handoff carries only tok0
            k = np.zeros((0, shape[0], shape[2], shape[3], shape[4]), np.float32)
            v = np.zeros_like(k)
        crc = zlib.crc32(v.tobytes(), zlib.crc32(k.tobytes()))
        return cls(
            prompt=req.prompt,
            first_token=int(req.generated[0]),
            block_size=engine.block_size,
            hashes=hashes,
            k=k,
            v=v,
            crc=crc,
            src_replica=src_replica,
        )

    def verify(self) -> "list[str]":
        """Every way this payload can be wrong, as human-readable problems
        (empty list == intact): CRC over the content bytes, shape/hash-count
        consistency, and the chain hashes recomputed from the prompt — a
        payload claiming blocks the prompt doesn't have cannot pass."""
        problems: "list[str]" = []
        crc = zlib.crc32(self.v.tobytes(), zlib.crc32(self.k.tobytes()))
        if crc != self.crc:
            problems.append(
                f"payload checksum mismatch (got {crc:#010x}, "
                f"declared {self.crc:#010x})"
            )
        if self.k.shape != self.v.shape or self.k.shape[0] != len(self.hashes):
            problems.append(
                f"shape mismatch: k{self.k.shape} v{self.v.shape} "
                f"vs {len(self.hashes)} hash(es)"
            )
        if len(self.hashes) > int(self.prompt.size) // self.block_size:
            problems.append(
                f"{len(self.hashes)} block(s) exceed the prompt's "
                f"{int(self.prompt.size) // self.block_size} full block(s)"
            )
            return problems
        prev = b""
        for i, h in enumerate(self.hashes):
            expect = _chain_hash(
                prev, self.prompt[i * self.block_size : (i + 1) * self.block_size]
            )
            if h != expect:
                problems.append(f"chain hash {i} does not match the prompt")
                break
            prev = h
        return problems

    def to_wire(self) -> dict:
        """JSON-able dict, the form a handoff always travels in, so thread
        and process transports take one path; byte for byte the
        reference's, so either package reads the other's."""
        return {
            "prompt": [int(t) for t in self.prompt],
            "first_token": int(self.first_token),
            "block_size": int(self.block_size),
            "hashes": [h.hex() for h in self.hashes],
            "shape": [int(s) for s in self.k.shape],
            "k": base64.b64encode(self.k.tobytes()).decode("ascii"),
            "v": base64.b64encode(self.v.tobytes()).decode("ascii"),
            "crc": int(self.crc),
            "src": self.src_replica,
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "KVHandoff":
        shape = tuple(int(s) for s in wire["shape"])
        k = np.frombuffer(base64.b64decode(wire["k"]), np.float32).reshape(shape)
        v = np.frombuffer(base64.b64decode(wire["v"]), np.float32).reshape(shape)
        return cls(
            prompt=np.asarray(wire["prompt"], np.int32),
            first_token=int(wire["first_token"]),
            block_size=int(wire["block_size"]),
            hashes=tuple(bytes.fromhex(h) for h in wire["hashes"]),
            k=k,
            v=v,
            crc=int(wire["crc"]),
            src_replica=wire.get("src"),
        )

    @classmethod
    def verify_wire(
        cls, wire: dict, prompt=None
    ) -> "tuple[Optional[KVHandoff], list[str]]":
        """Decode + verify in one step, never raising: an undecodable wire
        dict is just another corruption verdict (the router re-runs
        prefill either way)."""
        try:
            h = cls.from_wire(wire)
        except Exception as exc:
            return None, [f"undecodable handoff: {type(exc).__name__}: {exc}"]
        problems = h.verify()
        if prompt is not None and not np.array_equal(
            h.prompt, np.asarray(prompt, np.int32).reshape(-1)
        ):
            problems.append("handoff prompt differs from the request's prompt")
        return h, problems


def corrupt_wire(wire: dict) -> dict:
    """Damage a wire-form handoff IN TRANSIT (after its CRC was computed) —
    the ``corrupt`` chaos fault's payload model. Flips one content byte, or
    the CRC itself when the payload is empty, so verification always
    catches it."""
    if wire.get("k"):
        raw = bytearray(base64.b64decode(wire["k"]))
        raw[0] ^= 0xFF
        wire["k"] = base64.b64encode(bytes(raw)).decode("ascii")
    else:
        wire["crc"] = int(wire["crc"]) ^ 1
    return wire


# ---------------------------------------------------------------------------
# transports


class KVTransport:
    """How handoff bytes move from a prefill pool to a decode pool. Two
    methods; ``pack`` snapshots before the source sequence is freed and
    ``deliver`` is idempotent per chain hash (re-delivery after a decode
    failover must not duplicate blocks)."""

    def pack(self, engine: ServingEngine, req: Request) -> dict:
        """Snapshot ``req``'s prompt KV out of ``engine`` as a wire dict."""
        raise NotImplementedError

    def deliver(self, handoff: KVHandoff, engine: ServingEngine) -> dict:
        """Land ``handoff`` into ``engine``'s pool; returns ``landed`` /
        ``dedup`` block counts. Raises :class:`~.kv_pager.BlockPoolExhausted`
        when the pool cannot take a block now (the caller retries later;
        adopted blocks dedup on retry)."""
        raise NotImplementedError


class LocalBlockCopyTransport(KVTransport):
    """Host-memory block copy: gather on the prefill side, one write of
    the adopted blocks on the decode side."""

    def pack(self, engine: ServingEngine, req: Request) -> dict:
        name = getattr(engine, "heartbeat_name", None)
        return KVHandoff.capture(engine, req, src_replica=name).to_wire()

    def deliver(self, handoff: KVHandoff, engine: "DecodeEngine") -> dict:
        # a later adoption may reclaim a block adopted earlier in this loop
        # (the LRU's oldest): the block then holds the later content, as
        # the reference's block-at-a-time writes leave it
        rows: "dict[int, int]" = {}  # physical block -> handoff row
        dedup = 0
        try:
            for i, h in enumerate(handoff.hashes):
                blk = engine.allocator.adopt_block(h)
                if blk is None:
                    dedup += 1  # content-addressed: this block is already here
                    continue
                rows[blk] = i
        finally:
            # what was adopted before an exhaustion is indexed: write it
            if rows:
                sel = list(rows.values())
                engine.land_blocks(list(rows), handoff.k[sel], handoff.v[sel])
        return {"landed": len(rows), "dedup": dedup}


# ---------------------------------------------------------------------------
# role-split engines


class PrefillEngine(ServingEngine):
    """Chunked prefill only: every admitted request is prefilled (first
    token at fold 0, the monolith's schedule), packed into a KV handoff,
    and released — the engine never decodes. Completed sequences'
    registered blocks park in this engine's LRU pool."""

    def __init__(self, *args, transport: Optional[KVTransport] = None, **kwargs):
        kwargs.setdefault("prefix_cache", True)
        super().__init__(*args, **kwargs)
        if not self.prefix_cache:
            raise ValueError("PrefillEngine requires prefix_cache=True "
                             "(chain hashes ARE the handoff addresses)")
        self.transport = transport or LocalBlockCopyTransport()
        self._handoffs: "list[tuple[Request, dict]]" = []
        self.handoffs_packed = 0
        self.handoffs_corrupted = 0
        #: host seconds in ``transport.pack``: the device-to-host copy (which
        #: first waits for every kernel queued before it on the stream,
        #: another engine's too), CRC, base64
        self.pack_seconds = 0.0

    def pop_handoffs(self) -> "list[tuple[Request, dict]]":
        """Drain the handoffs packed since the last call (the replica worker
        turns each into a ``handoff`` event)."""
        out, self._handoffs = self._handoffs, []
        return out

    def step(self, now: Optional[float] = None) -> "list[Request]":
        now = time.monotonic() if now is None else now
        finished: "list[Request]" = []
        admitted = self.scheduler.admissions()
        while self.scheduler.rejected:
            req = self.scheduler.rejected.pop()
            req.finish_t = now
            finished.append(req)
        for req in admitted:
            self._prefill_request(req, now)
            t0 = time.perf_counter()
            wire = self.transport.pack(self, req)
            self.pack_seconds += time.perf_counter() - t0
            # complete before shipping: frees the sequence, parking its
            # registered blocks in this engine's LRU; the wire dict already
            # holds the content
            self.scheduler.complete(req, now)
            self.handoffs_packed += 1
            self._handoffs.append((req, wire))
        self.steps += 1
        return finished

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            handoffs_packed=self.handoffs_packed,
            handoffs_corrupted=self.handoffs_corrupted,
            pack_seconds=self.pack_seconds,
        )
        return out


class DecodeEngine(ServingEngine):
    """Batched decode only, fed by landed KV handoffs. A handed-off request
    is admission-gated until its blocks are in the pool's content index;
    prefix-cache admission then maps them and the engine re-prefills only
    the sub-block prompt tail, through the resume path failover uses."""

    def __init__(self, *args, transport: Optional[KVTransport] = None, **kwargs):
        kwargs.setdefault("prefix_cache", True)
        super().__init__(*args, **kwargs)
        if not self.prefix_cache:
            raise ValueError("DecodeEngine requires prefix_cache=True "
                             "(handoffs land through the content index)")
        self.transport = transport or LocalBlockCopyTransport()
        #: engine rid -> handoff not yet landed; membership IS the admission
        #: gate (scheduler.admission_gate below)
        self._awaiting: "dict[Any, KVHandoff]" = {}
        self.handoffs_landed = 0
        self.handoff_blocks = 0
        self.handoff_dedup_blocks = 0
        #: host seconds in ``transport.deliver``: adoption, the host-to-device
        #: copy, and queuing the pool write (which runs on the device later)
        self.land_seconds = 0.0
        self._shapes["land"] = set()
        self.scheduler.admission_gate = lambda r: r.rid not in self._awaiting

    def land_blocks(self, blocks: "list[int]", k: np.ndarray, v: np.ndarray) -> None:
        """Write handed-off content ``k``/``v`` (f32 ``[n, L, block_size,
        Hkv, D]``) into physical ``blocks`` of every layer's pools; the f32
        content casts back to the pool dtype bit-exactly."""
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for name, content in (("k", k), ("v", v)):
            pool = self.pool[name]
            pool[:, idx] = torch.from_numpy(np.ascontiguousarray(content)).to(
                self.device).transpose(0, 1).to(pool.dtype)
        self._shapes["land"].add(())

    def submit(self, *args, handoff: Optional[dict] = None, **kwargs) -> Request:
        req = super().submit(*args, **kwargs)
        if handoff is not None:
            self._awaiting[req.rid] = (
                handoff if isinstance(handoff, KVHandoff)
                else KVHandoff.from_wire(handoff)
            )
        return req

    def warmup(self) -> dict:
        # the landing write first, so the base warmup's returned counts
        # (through the jit_cache_sizes override) include it
        L, _, B, Hkv, D = self.pool["k"].shape
        content = np.zeros((1, L, B, Hkv, D), np.float32)
        self.land_blocks([NULL_BLOCK], content, content)
        return super().warmup()

    def jit_cache_sizes(self) -> dict:
        out = super().jit_cache_sizes()
        out["land_compiles"] = len(self._shapes["land"])
        return out

    def step(self, now: Optional[float] = None) -> "list[Request]":
        self._land_pending()
        return super().step(now)

    def _land_pending(self) -> None:
        """Land every awaiting handoff that fits, in arrival order. A full
        pool defers the rest to the next step (running sequences drain and
        free blocks); if nothing is running the wait could never end, so the
        gate opens instead — normal admission re-prefills the whole prompt
        (or rejects it): slower, still bitwise-correct."""
        for rid in list(self._awaiting):
            h = self._awaiting[rid]
            t0 = time.perf_counter()
            try:
                st = self.transport.deliver(h, self)
            except BlockPoolExhausted:
                if not self.scheduler.running():
                    del self._awaiting[rid]
                break
            finally:
                self.land_seconds += time.perf_counter() - t0
            self.handoffs_landed += 1
            self.handoff_blocks += int(st.get("landed", 0))
            self.handoff_dedup_blocks += int(st.get("dedup", 0))
            del self._awaiting[rid]

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            handoffs_landed=self.handoffs_landed,
            handoff_blocks=self.handoff_blocks,
            handoff_dedup_blocks=self.handoff_dedup_blocks,
            handoffs_awaiting=len(self._awaiting),
            land_seconds=self.land_seconds,
        )
        return out


# ---------------------------------------------------------------------------
# the two-tier router


class DisaggRouter(ServingRouter):
    """Role-aware dispatch over a prefill tier + a decode tier.

    A fresh request's first hop goes to the prefill tier; its ``handoff``
    event comes back through :meth:`_on_handoff`, is verified (CRC + chain
    hashes recomputed from the prompt), and the request re-queues toward
    the decode tier carrying the wire-form handoff. Every base-router
    invariant survives the extra hop:

    - **exactly-once**: the handoff event is consumed with the same
      stale-replica dedup as ``done`` events; terminal finalize still
      happens exactly once.
    - **failover**: a prefill replica dying mid-hop clears the request's
      progress (its first token must be re-sampled at fold 0 by the re-run)
      and requeues it to the surviving prefill tier; a decode replica dying
      requeues with progress + handoff intact (re-delivery dedups by chain
      hash). A handoff failing verification counts as a retry and re-runs
      prefill from scratch.

    Correctness canaries (serving/canary.py) target only unified
    ``serving``-role replicas: a tier member runs half a request by
    construction, so on a pure disaggregated fleet the canary plane is a
    no-op.
    """

    def __init__(self, prefill_replicas: "list", decode_replicas: "list",
                 **kwargs):
        if not prefill_replicas or not decode_replicas:
            raise ValueError("need at least one replica per tier")
        super().__init__(list(prefill_replicas) + list(decode_replicas), **kwargs)
        self.handoffs = 0
        self.handoff_corrupt = 0

    # -- tier views ----------------------------------------------------------

    def tier(self, role: str) -> "list":
        want_prefill = role == "prefill"
        return [
            r for r in self.replicas.values()
            if (getattr(r, "role", "serving") == "prefill") == want_prefill
        ]

    def _pending_prompt_tokens(self, name: str) -> int:
        return sum(int(r.prompt.size) for r in self._outstanding(name))

    # -- the handoff hop -----------------------------------------------------

    def _on_handoff(self, name: str, rep, ev: dict, now: float) -> bool:
        req = self._inflight.get(ev.get("rid"))
        if req is None or req.replica != name:
            return False  # stale: this request was failed over already
        del self._inflight[req.rid]
        wire = ev.get("handoff") or {}
        handoff, problems = KVHandoff.verify_wire(wire, prompt=req.prompt)
        if problems:
            # delivered but damaged in transit: burn a retry and re-run
            # prefill from scratch — progress cleared so the re-run samples
            # fold 0 again
            self.handoff_corrupt += 1
            req.replica = None
            req.retries += 1
            req.generated = []
            req.first_token_t = None
            req._handoff = None
            req.prefill_replica = None
            if req.retries > self.max_retries:
                self._finalize(
                    req, RouterRequestStatus.FAILED, now,
                    error=f"failed: handoff corrupt x{req.retries} "
                          f"({problems[0]})",
                )
            else:
                req.status = RouterRequestStatus.QUEUED
                self.admission.requeue_front(req)
            return True
        self.handoffs += 1
        per = self._per_replica[name]
        per["handoffs"] = per.get("handoffs", 0) + 1
        req.prefill_replica = name
        req.prefill_s = now - req._dispatch_t
        req.handoff_t = now
        if not req.generated:
            # the step event normally delivered tok0 already; the handoff's
            # copy is authoritative when it didn't (e.g. event coalescing)
            req.generated = [int(handoff.first_token)]
        if req.first_token_t is None:
            req.first_token_t = now
        if req.done_decoding:
            # max_new_tokens == 1: the prefill hop produced everything
            self.completed += 1
            per["completed"] += 1
            self._finalize(req, RouterRequestStatus.FINISHED, now, count=False)
        else:
            req._handoff = wire
            req.status = RouterRequestStatus.QUEUED
            self.admission.requeue_front(req)
        return True

    # -- failover ------------------------------------------------------------

    def _fail_replica(self, rep, reason: str, now: float) -> None:
        if getattr(rep, "role", "serving") == "prefill":
            for req in self._outstanding(rep.name):
                if not req.done_decoding:
                    # tok0 may have streamed back as progress, but the handoff
                    # died with the replica: the re-run must sample at fold 0
                    # again, so the resume state is wiped (keeping generated
                    # would make the prefill re-run resume at fold 1 with no
                    # KV — wrong tokens, silently)
                    req.generated = []
                    req.first_token_t = None
                    req._handoff = None
                    req.prefill_replica = None
        super()._fail_replica(rep, reason, now)

    # -- two-tier dispatch ---------------------------------------------------

    def _dispatch(self, now: float) -> bool:
        live_p = [
            r for r in self.tier("prefill")
            if r.state in (ReplicaState.STARTING, ReplicaState.HEALTHY)
        ]
        live_d = [
            r for r in self.tier("decode")
            if r.state in (ReplicaState.STARTING, ReplicaState.HEALTHY)
        ]
        activity = False
        stash: "list" = []  # popped but undispatchable NOW (tier busy)
        while True:
            req = self.admission.pop_next()
            if req is None:
                break
            if req.deadline_t is not None and req.deadline_t < now:
                self._finalize(
                    req, RouterRequestStatus.EXPIRED, now,
                    error="expired: deadline passed before dispatch",
                )
                activity = True
                continue
            # progress or a verified handoff binds the request to the decode
            # tier (resume must not re-run prefill); a clean request starts
            # at the prefill tier
            decode_bound = bool(req.generated) or req._handoff is not None
            live = live_d if decode_bound else live_p
            hop = "decode" if decode_bound else "prefill"
            if not live:
                if self._heal_pending():
                    stash.append(req)  # a respawn is coming: wait for it
                    continue
                self._finalize(
                    req, RouterRequestStatus.FAILED, now,
                    error=f"failed: no live {hop} replicas",
                )
                activity = True
                continue
            ready = [
                r for r in live
                if r.state is ReplicaState.HEALTHY
                and len(self._outstanding(r.name)) < self._replica_capacity(r)
            ]
            if not ready:
                # this tier is saturated/warming — park the request and keep
                # draining the queue so the OTHER tier is never head-of-line
                # blocked behind it
                stash.append(req)
                continue
            if decode_bound:
                # the base policy: least outstanding tokens, burning replicas
                # lose ties (SLO pressure leans dispatch away from them)
                target = min(
                    ready,
                    key=lambda r: (
                        r.name in self._burning_replicas,
                        self.outstanding_tokens(r.name),
                    ),
                )
            else:
                # prefill cost is prompt-length-proportional: fewest queued
                # requests first, pending prompt tokens as the tiebreak
                target = min(
                    ready,
                    key=lambda r: (
                        len(self._outstanding(r.name)),
                        self._pending_prompt_tokens(r.name),
                    ),
                )
            self._send(req, target, now, hop)
            activity = True
        for req in reversed(stash):  # restore original queue order
            self.admission.requeue_front(req)
        return activity

    def _send(self, req, target, now: float, hop: str) -> None:
        req.replica = target.name
        req._resume_from = len(req.generated)
        req._dispatch_t = now
        req.status = RouterRequestStatus.DISPATCHED
        self._inflight[req.rid] = req
        self.dispatched += 1
        self._per_replica[target.name]["dispatched"] += 1
        payload = {
            "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new": req.max_new_tokens,
            "eos": req.eos_token_id,
            "rng_seed": req.rng_seed,
            "generated": list(req.generated),
        }
        if hop == "decode" and req._handoff is not None:
            payload["handoff"] = req._handoff
        target.submit(payload)

    # -- views ---------------------------------------------------------------

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            handoffs=self.handoffs,
            handoff_corrupt=self.handoff_corrupt,
            tiers={
                "prefill": sorted(r.name for r in self.tier("prefill")),
                "decode": sorted(r.name for r in self.tier("decode")),
            },
        )
        return out
