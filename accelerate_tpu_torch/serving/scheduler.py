"""Continuous-batching scheduler: the port of
``accelerate_tpu.serving.scheduler`` (admission, slot placement, growth,
preemption, completion), host-side and framework-free.

- **admission** happens at step granularity: whenever a batch slot is free
  and the pool can hold the prompt's uncached blocks, the next queued
  request is admitted and prefilled;
- **completion** frees a sequence's blocks at once; the slot is backfilled
  on the next step;
- **preemption**: when a running sequence needs a block and none is free,
  the most recently admitted OTHER sequence is evicted and requeued at the
  front with its prompt + generated tokens, so resume re-prefills the full
  prefix and continues with identical output.

The reference's static-batching mode (``continuous=False``), admission
watermark, admission gate and metrics calls are left out.
"""

from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .kv_pager import BlockAllocator, BlockPoolExhausted

__all__ = ["RequestStatus", "Request", "Scheduler", "SchedulingError"]

_rid_counter = itertools.count()


class SchedulingError(RuntimeError):
    """A request that can never be scheduled (e.g. larger than the pool)."""


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"
    REJECTED = "rejected"  # can never run on this engine; see Request.error


@dataclass(eq=False)  # identity equality: requests are stateful handles
class Request:
    """One generation request plus its persisted progress: ``prompt`` +
    ``generated`` are all a preempted request needs to resume."""

    prompt: np.ndarray  # int32 [S]
    max_new_tokens: int
    rid: int = field(default_factory=lambda: next(_rid_counter))
    eos_token_id: Optional[int] = None
    arrival_t: float = 0.0

    status: RequestStatus = RequestStatus.QUEUED
    generated: "list[int]" = field(default_factory=list)
    slot: Optional[int] = None
    preemptions: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    error: Optional[str] = None  # set when REJECTED
    # prefix-cache admission state, overwritten on every admission: leading
    # prefix tokens already cached, and the pending copy-on-write pair
    cached_tokens: int = 0
    cow_block: "Optional[tuple[int, int]]" = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {self.max_new_tokens}")

    @property
    def prefix_len(self) -> int:
        """Tokens the model has consumed so far: prompt + generated."""
        return int(self.prompt.size) + len(self.generated)

    @property
    def done(self) -> bool:
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (
            self.eos_token_id is not None
            and bool(self.generated)
            and self.generated[-1] == self.eos_token_id
        )

    def output_ids(self) -> np.ndarray:
        """prompt + generated."""
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])


class Scheduler:
    """Admission queue + batch-slot table over one :class:`BlockAllocator`."""

    def __init__(self, allocator: BlockAllocator, max_slots: int, *,
                 max_seq_blocks: Optional[int] = None, max_seq_tokens: Optional[int] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.allocator = allocator
        self.max_slots = max_slots
        # hard per-sequence caps, enforced at admission on the worst case
        # (prefix + max_new): the widest block table, and the RoPE table
        self.max_seq_blocks = (
            allocator.usable_blocks if max_seq_blocks is None
            else min(max_seq_blocks, allocator.usable_blocks)
        )
        self.max_seq_tokens = max_seq_tokens
        self.queue: "deque[Request]" = deque()
        self.slots: "list[Optional[Request]]" = [None] * max_slots
        self._admission_order: "list[Request]" = []  # oldest first
        self.preemption_count = 0
        #: requests that can never run on this engine, rejected at admission
        self.rejected: "list[Request]" = []

    def running(self) -> "list[Request]":
        return [r for r in self.slots if r is not None]

    def idle(self) -> bool:
        return not self.queue and not self.running()

    def submit(self, request: Request) -> Request:
        request.status = RequestStatus.QUEUED
        self.queue.append(request)
        return request

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    def admissions(self) -> "list[Request]":
        """Pop and place every request admissible now (the engine prefills
        each, in this order)."""
        admitted = []
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue[0]
            prefix_tokens = req.output_ids()
            # admission charges only uncached blocks, plus LRU-parked
            # matched blocks this mapping will pin
            plan = self.allocator.plan_prefix(prefix_tokens)
            need = plan.fresh_blocks + plan.lru_pinned
            remaining = max(0, req.max_new_tokens - len(req.generated))
            worst_tokens = req.prefix_len + remaining
            worst = self.allocator.blocks_for(worst_tokens)
            reason = None
            if self.max_seq_tokens is not None and worst_tokens > self.max_seq_tokens:
                reason = (
                    f"worst case {worst_tokens} tokens (prefix {req.prefix_len} "
                    f"+ up to {remaining} new) exceeds the model's "
                    f"max_seq_len of {self.max_seq_tokens}"
                )
            elif worst > self.max_seq_blocks:
                reason = (
                    f"worst case {worst} block(s) (prefix {req.prefix_len} + "
                    f"up to {remaining} new tokens) exceeds the per-sequence "
                    f"cap of {self.max_seq_blocks}"
                )
            if reason is not None:
                self.queue.popleft()
                req.status = RequestStatus.REJECTED
                req.error = "rejected: " + reason
                self.rejected.append(req)
                continue
            if need > self.allocator.available_blocks:
                break  # pool pressure: let running sequences drain first
            self.queue.popleft()
            alloc = self.allocator.allocate_with_prefix(req.rid, prefix_tokens, plan=plan)
            req.cached_tokens = alloc.cached_tokens
            req.cow_block = alloc.cow
            req.status = RequestStatus.RUNNING
            req.slot = slot
            self.slots[slot] = req
            self._admission_order.append(req)
            admitted.append(req)
        return admitted

    def grow(self, request: Request) -> None:
        """Reserve pool room for the request's next token, preempting other
        sequences (LIFO) if the pool is dry."""
        while True:
            try:
                self.allocator.append(request.rid, 1)
                return
            except BlockPoolExhausted:
                if not self._preempt_one(exclude=request):
                    raise SchedulingError(
                        f"request {request.rid} exhausted the pool with no "
                        "other sequence left to evict — the pool is smaller "
                        "than one request's worst case"
                    ) from None

    def _preempt_one(self, exclude: Request) -> bool:
        """Evict the most recently admitted running request other than
        ``exclude`` and requeue it at the front. False when none is left."""
        for req in reversed(self._admission_order):
            if req is exclude or req.status is not RequestStatus.RUNNING:
                continue
            self._release(req)
            req.status = RequestStatus.PREEMPTED
            req.preemptions += 1
            self.preemption_count += 1
            self.queue.appendleft(req)
            return True
        return False

    def complete(self, request: Request, now: float) -> None:
        self._release(request)
        request.status = RequestStatus.FINISHED
        request.finish_t = now

    def _release(self, request: Request) -> None:
        self.allocator.free(request.rid)
        if request.slot is not None:
            self.slots[request.slot] = None
            request.slot = None
        self._admission_order.remove(request)
