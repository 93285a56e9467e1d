"""Overload control for the serving router: the port of
``accelerate_tpu.serving.admission``.

Three answers to more traffic than the fleet can decode, as one
:class:`AdmissionController` the router consults on every submit:

- **token bucket** — admission is charged the request's worst-case token
  cost (prompt + ``max_new_tokens``), refilled at ``rate_tokens_per_s`` up
  to ``burst_tokens``; a request the bucket cannot cover is shed
  (``"rate-limited"``);
- **bounded priority queues** — one FIFO per priority class (lower =
  more important), ``max_queue`` entries in all;
- **priority shedding** — a newcomer that finds the queue full evicts the
  newest request of a strictly lower class, or is shed itself
  (``"queue-full"``).

Failover re-queues bypass the bucket and the bound
(:meth:`AdmissionController.requeue_front`): they already paid admission.
The clock is injectable. The reference's shed counters and queue-depth
histogram go with the metrics registry (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

__all__ = [
    "PRIORITY_INTERACTIVE",
    "PRIORITY_BATCH",
    "TokenBucket",
    "AdmissionVerdict",
    "AdmissionController",
]

#: conventional priority classes (any int works: lower = more important)
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1


class TokenBucket:
    """Classic token bucket: ``rate_per_s`` refill, ``burst`` cap.

    ``take(n)`` is all-or-nothing — a request is either fully admitted or
    fully shed; partial admission would decode a truncated reply."""

    def __init__(self, rate_per_s: float, burst: float, clock: Callable[[], float] = time.monotonic):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError(
                f"rate_per_s and burst must be > 0, got {rate_per_s}/{burst}"
            )
        self.rate_per_s = float(rate_per_s)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)  # a fresh bucket starts full
        self._last = clock()

    def _refill(self, now: float) -> None:
        # monotone: a backdated `now` (replayed arrival_t) must not rewind
        # _last — that would re-credit an interval already spent
        if now > self._last:
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate_per_s)
            self._last = now

    def available(self, now: Optional[float] = None) -> float:
        self._refill(self._clock() if now is None else now)
        return self._tokens

    def take(self, n: float, now: Optional[float] = None) -> bool:
        self._refill(self._clock() if now is None else now)
        if n > self._tokens:
            return False
        self._tokens -= n
        return True


@dataclass
class AdmissionVerdict:
    """Outcome of one admission decision. ``evicted`` lists queued requests
    displaced by a higher-priority newcomer — the ROUTER marks them shed (it
    owns request status; the controller only owns the queues)."""

    admitted: bool
    reason: Optional[str] = None  # "rate-limited" | "queue-full" when shed
    evicted: "list" = field(default_factory=list)


class AdmissionController:
    """Bounded priority queues behind an optional token bucket."""

    def __init__(
        self,
        *,
        max_queue: int = 64,
        rate_tokens_per_s: Optional[float] = None,
        burst_tokens: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.clock = clock
        self.bucket = (
            TokenBucket(rate_tokens_per_s, burst_tokens or 2 * rate_tokens_per_s, clock)
            if rate_tokens_per_s
            else None
        )
        self._queues: "dict[int, deque]" = {}
        self.shed_count = 0
        self.evicted_count = 0

    # -- views ---------------------------------------------------------------

    @property
    def depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def depth_by_priority(self) -> "dict[int, int]":
        return {p: len(q) for p, q in sorted(self._queues.items()) if q}

    def queued(self) -> "list":
        """All queued requests in pop order (priority, then FIFO)."""
        return [r for _, q in sorted(self._queues.items()) for r in q]

    # -- admission -----------------------------------------------------------

    def try_admit(self, request: Any, cost: float, now: Optional[float] = None) -> AdmissionVerdict:
        """Admit ``request`` (anything with a ``priority`` int attribute) at
        worst-case token ``cost``, or shed — possibly by evicting strictly
        lower-priority queued work instead of the newcomer."""
        now = self.clock() if now is None else now
        # probe the bucket first but CHARGE it last: a request shed for a
        # full queue must not also drain rate budget other traffic could use
        if self.bucket is not None and self.bucket.available(now) < cost:
            self.shed_count += 1
            return AdmissionVerdict(False, reason="rate-limited")
        evicted = []
        if self.depth >= self.max_queue:
            victim = self._evict_below(request.priority)
            if victim is None:
                self.shed_count += 1
                return AdmissionVerdict(False, reason="queue-full")
            evicted.append(victim)
        if self.bucket is not None:
            self.bucket.take(cost, now)  # same `now` as the probe: cannot fail
        self._queues.setdefault(request.priority, deque()).append(request)
        return AdmissionVerdict(True, evicted=evicted)

    def _evict_below(self, priority: int):
        """Pop the most recently queued request of the LOWEST priority class
        strictly below ``priority`` (highest int). Failover re-queues
        (``retries > 0`` — already admitted AND already decoded on some
        replica) are never victims: shedding one would lose an admitted
        request, the invariant this whole module exists to keep. None when
        nothing evictable is queued — the newcomer must be shed instead."""
        for p in sorted(self._queues, reverse=True):
            if p <= priority:
                break
            q = self._queues[p]
            for i in range(len(q) - 1, -1, -1):  # newest evictable first
                if getattr(q[i], "retries", 0) == 0:
                    victim = q[i]
                    del q[i]
                    self.evicted_count += 1
                    self.shed_count += 1
                    return victim
        return None

    def requeue_front(self, request: Any) -> None:
        """Failover path: put a previously admitted request back at the FRONT
        of its class. No rate charge, no bound — it already paid admission,
        and dropping it would lose a request the router promised to finish."""
        self._queues.setdefault(request.priority, deque()).appendleft(request)

    # -- dispatch side -------------------------------------------------------

    def pop_next(self):
        """Next request to dispatch: highest-priority class first, FIFO
        within a class. None when everything is drained."""
        for p in sorted(self._queues):
            if self._queues[p]:
                return self._queues[p].popleft()
        return None

    def expire(self, now: float) -> "list":
        """Remove and return every queued request whose ``deadline_t`` has
        passed — work that would miss its deadline anyway must not occupy a
        decode slot that live work could use."""
        expired = []
        for q in self._queues.values():
            keep = deque()
            while q:
                r = q.popleft()
                if getattr(r, "deadline_t", None) is not None and r.deadline_t < now:
                    expired.append(r)
                else:
                    keep.append(r)
            q.extend(keep)
        return expired
