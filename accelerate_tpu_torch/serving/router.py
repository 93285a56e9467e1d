"""The serving router: the port of ``accelerate_tpu.serving.router``.

N replicated engines behind one front door, with no lost work:

- **dispatch** — queued requests go to the HEALTHY replica with the fewest
  outstanding tokens (prompt + remaining budget of everything in flight
  there), bounded per replica;
- **health** — every replica event refreshes a heartbeat; a replica whose
  process or thread died, whose worker reported ``fatal``, or whose
  heartbeat went stale while it held work is marked DEAD (and killed).
  ``drain()`` marks a replica DRAINING: in-flight work finishes, nothing
  new is dispatched; a replica burning its fast ttft window
  (``slo_monitor``) or failing a canary counts toward that pressure;
- **failover** — a DEAD replica's in-flight requests re-queue at the front
  with their ``generated``-so-far and resume on a survivor through
  ``ServingEngine.submit(generated=...)``; terminal dedup (a request
  finalizes once, stale events are ignored) makes retry exactly-once;
  ``self_heal`` respawns dead replicas from their specs under a budget
  with exponential backoff;
- **overload** — :class:`~.admission.AdmissionController`: token-bucket
  rate limiting, bounded priority queues, shedding with a distinct
  :attr:`RouterRequestStatus.SHED`, and deadlines (``EXPIRED``).

The reference's telemetry records, metrics, trace spans (its requests'
``trace`` context), goodput notes and watchdog registration are not ported
yet (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from .admission import PRIORITY_BATCH, AdmissionController
from .replica import ReplicaState

__all__ = ["RouterRequestStatus", "RouterRequest", "ServingRouter"]


class RouterRequestStatus(enum.Enum):
    QUEUED = "queued"        # admitted, waiting for a replica
    DISPATCHED = "dispatched"  # in flight on a replica
    FINISHED = "finished"    # completed exactly once; ``generated`` is final
    SHED = "shed"            # refused by overload control (rate/queue/displaced)
    EXPIRED = "expired"      # deadline passed before dispatch
    FAILED = "failed"        # retries exhausted / engine rejection / no replicas

    @property
    def terminal(self) -> bool:
        return self not in (RouterRequestStatus.QUEUED, RouterRequestStatus.DISPATCHED)


_rid_counter = itertools.count()


@dataclass(eq=False)  # identity equality: requests are stateful handles
class RouterRequest:
    """One routed request plus its durable progress. ``generated`` is kept
    current from the worker's per-step progress events, which is exactly the
    state failover resume needs."""

    prompt: np.ndarray
    max_new_tokens: int
    rid: str = field(default_factory=lambda: f"q{next(_rid_counter)}")
    eos_token_id: Optional[int] = None
    rng_seed: int = 0
    priority: int = PRIORITY_BATCH
    deadline_t: Optional[float] = None  # absolute, in router-clock time
    arrival_t: float = 0.0

    status: RouterRequestStatus = RouterRequestStatus.QUEUED
    generated: "list[int]" = field(default_factory=list)
    replica: Optional[str] = None
    retries: int = 0  # failover re-dispatches survived
    # len(generated) at the moment of the CURRENT dispatch: until progress
    # moves past it, the new replica still owes the (re-)prefill of
    # prompt + generated — the load metric must count that work
    _resume_from: int = field(default=0, repr=False)
    preemptions: int = 0
    error: Optional[str] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    # disaggregated serving (serving/disagg.py): which prefill replica ran
    # the prefill hop, how long that hop took, when its KV handoff landed at
    # the router, and the verified wire-form handoff awaiting (re-)dispatch
    # to the decode tier (kept until FINISHED so a decode-replica death can
    # re-deliver it — adopt_block dedup makes re-delivery idempotent)
    prefill_replica: Optional[str] = None
    prefill_s: Optional[float] = None
    handoff_t: Optional[float] = None
    _handoff: Optional[dict] = field(default=None, repr=False)
    _dispatch_t: float = field(default=0.0, repr=False)
    # correctness canary (serving/canary.py): probe requests bypass
    # admission, SLO observation, failover, and every user-facing counter —
    # their only job is the bitwise verdict on ONE replica
    canary: bool = False
    _golden: Optional[Any] = field(default=None, repr=False)

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)

    @property
    def cost_tokens(self) -> int:
        """Worst-case token cost, what admission charges."""
        return int(self.prompt.size) + self.max_new_tokens

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.max_new_tokens - len(self.generated))

    @property
    def done_decoding(self) -> bool:
        """All tokens already streamed back — nothing left to resume."""
        if len(self.generated) >= self.max_new_tokens:
            return True
        return (
            self.eos_token_id is not None
            and bool(self.generated)
            and self.generated[-1] == self.eos_token_id
        )

    def output_ids(self) -> np.ndarray:
        """prompt + generated, the ``greedy_generate`` layout."""
        return np.concatenate([self.prompt, np.asarray(self.generated, np.int32)])


class ServingRouter:
    """Health-checked dispatch over replicated serving engines."""

    def __init__(
        self,
        replicas: "list",
        *,
        admission: Optional[AdmissionController] = None,
        health_timeout_s: float = 5.0,
        max_retries: int = 3,
        max_outstanding_per_replica: Optional[int] = None,
        clock: Callable[[], float] = time.monotonic,
        self_heal: bool = False,
        max_respawns_per_replica: int = 2,
        respawn_backoff_base_s: float = 0.1,
        respawn_backoff_max_s: float = 30.0,
        slo_monitor: Optional[Any] = None,
        slo_eval_interval_s: float = 1.0,
        autoscaler: Optional[Any] = None,
        canary: Optional[Any] = None,
    ):
        if not replicas:
            raise ValueError("need at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self.replicas: "dict[str, Any]" = {r.name: r for r in replicas}
        self.clock = clock
        self.admission = admission or AdmissionController(clock=clock)
        self.health_timeout_s = float(health_timeout_s)
        self.max_retries = int(max_retries)
        self.max_outstanding_per_replica = max_outstanding_per_replica
        now = clock()
        self._last_event: "dict[str, float]" = {n: now for n in self.replicas}
        self._inflight: "dict[str, RouterRequest]" = {}
        # cumulative counters (the telemetry records carry these, so the
        # report section can take a max instead of re-summing)
        self.dispatched = 0
        self.completed = 0
        self.failed = 0
        self.expired = 0
        self.shed = 0
        self.failovers = 0
        self.shed_by_reason: "dict[str, int]" = {}
        self._per_replica: "dict[str, dict]" = {
            n: {"dispatched": 0, "completed": 0, "failovers": 0, "respawns": 0}
            for n in self.replicas
        }
        # Self-healing (supervisor semantics at router scope): a DEAD replica
        # with a stored spec is respawned under a bounded per-replica budget
        # with exponential backoff, so a chaos-killed fleet heals back to N
        # instead of shrinking. Respawned engines warm-boot from the
        # persistent compile cache when ReplicaSpec.compile_cache_dir is set.
        self.self_heal = bool(self_heal)
        self.max_respawns_per_replica = int(max_respawns_per_replica)
        self.respawn_backoff_base_s = float(respawn_backoff_base_s)
        self.respawn_backoff_max_s = float(respawn_backoff_max_s)
        self.respawns = 0
        self._respawn_not_before: "dict[str, float]" = {}
        # replicas the operator put in DRAINING before they died: a requested
        # scale-down must never be undone by a self-heal respawn
        self._decommissioned: "set[str]" = set()
        # an optional telemetry.slo.SLOMonitor turns per-request outcomes
        # into burn-rate evaluation, and a replica BURNING its fast ttft
        # window counts toward DRAINING pressure in _dispatch
        self.slo_monitor = slo_monitor
        self.slo_eval_interval_s = float(slo_eval_interval_s)
        self._last_slo_eval = float("-inf")
        self._burning_replicas: "set[str]" = set()
        #: the most recent burn-rate evaluation (list of per-objective
        #: records) — the autoscaler's trigger input
        self.last_slo_results: "list[dict]" = []
        # optional serving/autoscaler.py policy, consulted once per poll
        # right after the burn-rate evaluation it keys off
        self.autoscaler = autoscaler
        # optional serving/canary.py probe: periodic golden requests whose
        # bitwise verdict feeds the same DRAINING pressure as SLO burn
        self.canary = canary
        self._canary_failed: "set[str]" = set()
        self._canary_cursor = 0
        self.canary_inconclusive = 0

    # -- submission ----------------------------------------------------------

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        *,
        eos_token_id: Optional[int] = None,
        rng_seed: int = 0,
        priority: int = PRIORITY_BATCH,
        deadline_s: Optional[float] = None,
        arrival_t: Optional[float] = None,
    ) -> RouterRequest:
        """Admit-or-shed one request. Always returns the handle — check
        ``status``: SHED means overload control refused it NOW (distinct
        from any failure), QUEUED means the router owns it until a terminal
        state."""
        now = self.clock() if arrival_t is None else arrival_t
        req = RouterRequest(
            prompt=prompt,
            max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            rng_seed=rng_seed,
            priority=priority,
            deadline_t=(now + deadline_s) if deadline_s is not None else None,
            arrival_t=now,
        )
        verdict = self.admission.try_admit(req, cost=req.cost_tokens, now=now)
        for victim in verdict.evicted:
            self._finalize(
                victim, RouterRequestStatus.SHED, now,
                error="shed: displaced by higher-priority admission",
            )
        if not verdict.admitted:
            self._finalize(req, RouterRequestStatus.SHED, now, error=f"shed: {verdict.reason}")
        return req

    # -- the poll loop -------------------------------------------------------

    def poll(self, now: Optional[float] = None) -> "list[RouterRequest]":
        """One router iteration: drain replica events, health-check, heal,
        expire deadlines, evaluate the SLOs, let the autoscaler and the
        canary act, dispatch. Returns the requests that reached a terminal
        state during this poll."""
        now = self.clock() if now is None else now
        self._terminal_this_poll: "list[RouterRequest]" = []
        self._drain_events(now)
        self._check_health(now)
        if self.self_heal:
            self._heal(now)
        for req in self.admission.expire(now):
            self._finalize(
                req, RouterRequestStatus.EXPIRED, now,
                error="expired: deadline passed before dispatch",
            )
        if (
            self.slo_monitor is not None
            and now - self._last_slo_eval >= self.slo_eval_interval_s
        ):
            # burn-rate evaluation (throttled): refreshes the burning-replica
            # set the dispatch loop treats as DRAINING pressure
            self._last_slo_eval = now
            self.last_slo_results = self.slo_monitor.evaluate(now=now)
            if "ttft" in getattr(self.slo_monitor, "objectives", {}):
                self._burning_replicas = set(
                    self.slo_monitor.burning_sources("ttft", now=now)
                )
        if self.autoscaler is not None:
            self.autoscaler.maybe_act(self, now)
        if self.canary is not None:
            self._canary_tick(now)
        self._dispatch(now)
        return self._terminal_this_poll

    def run(
        self, *, timeout_s: float = 300.0, poll_interval_s: float = 0.002
    ) -> "list[RouterRequest]":
        """Poll until every admitted request is terminal; returns them in
        finish order. Raises RuntimeError on wall-clock timeout (the router
        must never wedge silently)."""
        done: "list[RouterRequest]" = []
        deadline = time.monotonic() + timeout_s
        while True:
            done.extend(self.poll())
            if not self._inflight and self.admission.depth == 0:
                return done
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"router not idle after {timeout_s}s: "
                    f"{len(self._inflight)} in flight, {self.admission.depth} queued"
                )
            time.sleep(poll_interval_s)

    def wait_ready(self, timeout_s: float = 300.0, poll_interval_s: float = 0.01) -> None:
        """Block until no replica is STARTING (each is HEALTHY — warmed and
        compiled — or already DEAD). Benchmarks and tests call this so the
        measured window never includes warmup, and so load balancing sees
        the whole fleet instead of whichever replica compiled first."""
        deadline = time.monotonic() + timeout_s
        while any(r.state is ReplicaState.STARTING for r in self.replicas.values()):
            self.poll()
            if time.monotonic() > deadline:
                starting = [
                    n for n, r in self.replicas.items()
                    if r.state is ReplicaState.STARTING
                ]
                raise RuntimeError(f"replicas never became ready: {starting}")
            time.sleep(poll_interval_s)

    # -- lifecycle -----------------------------------------------------------

    def drain(self, name: str) -> None:
        """Stop dispatching to ``name``; its in-flight work finishes."""
        rep = self.replicas[name]
        if rep.state in (ReplicaState.STARTING, ReplicaState.HEALTHY):
            rep.state = ReplicaState.DRAINING

    def add_replica(self, replica) -> None:
        """Register a freshly spawned replica mid-flight (the autoscaler's
        scale-up path): it joins STARTING, becomes dispatchable at its ready
        event, and participates in health/heal/telemetry like a founding
        member. Re-adding a name revives a decommissioned slot."""
        name = replica.name
        if name in self.replicas and self.replicas[name].state is not ReplicaState.DEAD:
            raise ValueError(f"replica {name!r} is already registered and live")
        self.replicas[name] = replica
        self._last_event[name] = self.clock()  # warmup counts as liveness
        self._per_replica.setdefault(
            name, {"dispatched": 0, "completed": 0, "failovers": 0, "respawns": 0}
        )
        self._decommissioned.discard(name)

    def close(self) -> None:
        for rep in self.replicas.values():
            try:
                rep.close()
            except Exception:
                rep.kill()

    # -- internals -----------------------------------------------------------

    def _outstanding(self, name: str) -> "list[RouterRequest]":
        return [r for r in self._inflight.values() if r.replica == name]

    def outstanding_tokens(self, name: str) -> int:
        """The dispatch-balancing load metric: remaining new-token budget of
        everything in flight on ``name``, plus the (re-)prefill still owed —
        ``prompt + generated-at-dispatch`` for any request that has not yet
        produced a token on THIS replica (a failover resume re-prefills its
        whole prefix, which is exactly why a freshly burdened survivor must
        not look light)."""
        total = 0
        for r in self._outstanding(name):
            total += r.remaining_tokens
            if len(r.generated) == r._resume_from:
                total += int(r.prompt.size) + r._resume_from
        return total

    def _drain_events(self, now: float) -> bool:
        activity = False
        for name, rep in self.replicas.items():
            events = rep.drain_events()
            if rep.state is ReplicaState.DEAD:
                continue  # drained to drop: a zombie's late results must not
                # double-complete work a survivor now owns
            for ev in events:
                self._last_event[name] = now
                kind = ev.get("event")
                if kind == "ready" and rep.state is ReplicaState.STARTING:
                    rep.state = ReplicaState.HEALTHY
                    # warmup compile/cache counts: the autoscaler's warm-join
                    # assertion (join_compiles == 0) reads these
                    rep.ready_info = {k: v for k, v in ev.items() if k != "event"}
                    activity = True
                elif kind == "step":
                    for rid, toks in (ev.get("progress") or {}).items():
                        req = self._inflight.get(rid)
                        if req is None or req.replica != name:
                            continue
                        if req.first_token_t is None:
                            req.first_token_t = now
                        req.generated.extend(int(t) for t in toks)
                elif kind == "done":
                    req = self._inflight.get(ev.get("rid"))
                    if req is None or req.replica != name:
                        continue  # stale: this request was failed over already
                    del self._inflight[req.rid]
                    if req.canary:
                        # probe verdict path: no counters, no SLO — only the
                        # bitwise comparison against the golden
                        self._canary_result(req, ev, now)
                        activity = True
                        continue
                    if ev.get("status") == "finished":
                        req.generated = [int(t) for t in ev.get("tokens", [])]
                        req.preemptions = int(ev.get("preemptions", 0))
                        self.completed += 1
                        self._per_replica[name]["completed"] += 1
                        self._finalize(req, RouterRequestStatus.FINISHED, now, count=False)
                    else:  # the engine itself rejected it (pool/lattice cap):
                        # no replica can run it — a retry would reject again
                        self._finalize(
                            req, RouterRequestStatus.FAILED, now,
                            error=ev.get("error") or "rejected by engine",
                        )
                    activity = True
                elif kind == "handoff":
                    activity |= self._on_handoff(name, rep, ev, now)
                elif kind == "fatal":
                    self._fail_replica(rep, f"worker died: {ev.get('error')}", now)
                    activity = True
                    break  # remaining events are from a dead worker
        return activity

    def _on_handoff(self, name: str, rep, ev: dict, now: float) -> bool:
        """A prefill-tier worker finished a request's prefill hop and shipped
        its KV. The base router runs no prefill tier — DisaggRouter
        (serving/disagg.py) overrides this with verify + requeue-to-decode;
        here a stray handoff event is dropped like any stale event."""
        return False

    def _check_health(self, now: float) -> bool:
        activity = False
        for name, rep in self.replicas.items():
            if rep.state is ReplicaState.DEAD:
                continue
            if not rep.alive():
                self._fail_replica(rep, "replica process/thread died", now)
                activity = True
                continue
            age = now - self._last_event[name]
            if self._outstanding(name) and age > self.health_timeout_s:
                self._fail_replica(
                    rep, f"heartbeat stale for {age:.1f}s with work in flight", now
                )
                activity = True
        return activity

    def _heal_pending(self) -> bool:
        """True while some DEAD replica can still be respawned — queued work
        must WAIT for the heal instead of being failed loudly."""
        if not self.self_heal:
            return False
        return any(
            rep.state is ReplicaState.DEAD
            and hasattr(rep, "respawn")
            and name not in self._decommissioned
            and self._per_replica[name]["respawns"] < self.max_respawns_per_replica
            for name, rep in self.replicas.items()
        )

    def _heal(self, now: float) -> bool:
        """Respawn DEAD replicas from their stored specs, bounded by
        ``max_respawns_per_replica`` with exponential backoff (the
        supervisor's restart semantics at router scope)."""
        activity = False
        for name, rep in list(self.replicas.items()):
            if rep.state is not ReplicaState.DEAD or not hasattr(rep, "respawn"):
                continue
            if name in self._decommissioned:
                continue  # the operator drained it: its death is a shutdown
            used = self._per_replica[name]["respawns"]
            if used >= self.max_respawns_per_replica:
                continue
            if now < self._respawn_not_before.get(name, 0.0):
                continue
            try:
                fresh = rep.respawn()
            except Exception:
                # an unspawnable replica burns budget too — otherwise a sick
                # host would be retried forever with zero backpressure
                self._per_replica[name]["respawns"] = used + 1
                self._respawn_not_before[name] = now + self._respawn_backoff(used + 1)
                continue
            self.replicas[name] = fresh
            self._per_replica[name]["respawns"] = used + 1
            self.respawns += 1
            self._respawn_not_before[name] = now + self._respawn_backoff(used + 1)
            self._last_event[name] = now  # STARTING: warmup counts as liveness
            activity = True
        return activity

    def _respawn_backoff(self, attempt: int) -> float:
        return min(
            self.respawn_backoff_max_s,
            self.respawn_backoff_base_s * (2.0 ** max(0, attempt - 1)),
        )

    def _fail_replica(self, rep, reason: str, now: float) -> None:
        """DEAD transition + failover of everything in flight there."""
        if rep.state is ReplicaState.DRAINING:
            # dying while drained is the tail end of a requested scale-down —
            # remember that so self-heal never resurrects it
            self._decommissioned.add(rep.name)
        rep.state = ReplicaState.DEAD
        rep.reason = reason
        try:
            rep.kill()  # reap a wedged child; harmless if already gone
        except Exception:
            pass
        for req in self._outstanding(rep.name):
            del self._inflight[req.rid]
            if req.canary:
                # a probe's job was to test THIS replica — never failed over
                # (retrying elsewhere would launder the evidence), and a
                # death before the verdict is inconclusive, not a mismatch
                req.status = RouterRequestStatus.FAILED
                req.error = f"canary dropped: {reason}"
                req.finish_t = now
                self.canary_inconclusive += 1
                continue
            req.replica = None
            req.retries += 1
            self.failovers += 1
            self._per_replica[rep.name]["failovers"] += 1
            if req.done_decoding:
                # every token was already streamed back before the death —
                # the work is done, only the done event was lost
                self.completed += 1
                self._finalize(req, RouterRequestStatus.FINISHED, now, count=False)
            elif req.retries > self.max_retries:
                self._finalize(
                    req, RouterRequestStatus.FAILED, now,
                    error=f"failed: {req.retries} replica deaths (last: {reason})",
                )
            else:
                req.status = RouterRequestStatus.QUEUED
                self.admission.requeue_front(req)

    # -- correctness canaries (serving/canary.py) ----------------------------

    def _canary_tick(self, now: float) -> bool:
        """Inject the next due golden probe into one healthy replica.

        Probes round-robin across the dispatchable fleet so every replica
        gets its turn under the bitwise lens. They bypass admission (a
        saturated queue must not starve correctness checking) but respect
        replica capacity — a probe that has to wait simply retries next
        poll, with the schedule advancing only on injection."""
        probe = self.canary
        if not probe.due(now):
            return False
        # probes only target unified "serving"-role replicas: a disaggregated
        # tier member runs half a request by construction (prefill-only or
        # handoff-fed decode), so a direct golden submit is not well-formed
        # there — on a pure disagg fleet the canary plane is a no-op
        # (see DisaggRouter's docstring)
        targets = sorted(
            r.name for r in self.replicas.values()
            if r.state is ReplicaState.HEALTHY
            and getattr(r, "role", "serving") == "serving"
            and len(self._outstanding(r.name)) < self._replica_capacity(r)
        )
        if not targets:
            return False
        name = targets[self._canary_cursor % len(targets)]
        self._canary_cursor += 1
        probe.schedule(now)
        golden = probe.next_golden()
        req = RouterRequest(
            prompt=np.asarray(golden.prompt, np.int32),
            max_new_tokens=golden.max_new_tokens,
            rid=f"canary-{self._canary_cursor}",
            rng_seed=golden.rng_seed,
            arrival_t=now,
        )
        req.canary = True
        req._golden = golden
        req.replica = name
        req._dispatch_t = now
        req.status = RouterRequestStatus.DISPATCHED
        self._inflight[req.rid] = req
        self.replicas[name].submit({
            "rid": req.rid,
            "prompt": [int(t) for t in req.prompt],
            "max_new": req.max_new_tokens,
            "eos": req.eos_token_id,
            "rng_seed": req.rng_seed,
            "generated": [],
        })
        return True

    def _canary_result(self, req: RouterRequest, ev: dict, now: float) -> None:
        """Bitwise verdict on a returned probe. A mismatch joins the
        DRAINING-pressure set and (by default) drains the replica outright —
        wrong tokens are a harder failure than a burning SLO. (The
        reference's ``canary`` and ``canary_failure`` records go with item
        12.)"""
        probe = self.canary
        golden = req._golden
        name = req.replica
        req.finish_t = now
        if ev.get("status") != "finished":
            # the engine rejected the probe (pool/lattice cap): that says
            # nothing about token correctness — inconclusive, no verdict
            self.canary_inconclusive += 1
            req.status = RouterRequestStatus.FAILED
            req.error = str(ev.get("error") or "rejected by engine")
            return
        tokens = [int(t) for t in ev.get("tokens", [])]
        req.generated = tokens
        req.status = RouterRequestStatus.FINISHED
        ok = probe.check(golden, tokens) is None
        probe.record_result(name, ok)
        if ok:
            return
        self._canary_failed.add(name)
        rep = self.replicas.get(name)
        if probe.drain_on_failure and rep is not None:
            if rep.state in (ReplicaState.STARTING, ReplicaState.HEALTHY):
                self.drain(name)

    def _replica_capacity(self, rep) -> int:
        if self.max_outstanding_per_replica is not None:
            return self.max_outstanding_per_replica
        max_slots = getattr(getattr(rep, "spec", None), "max_slots", 4)
        return 2 * max_slots  # slots busy + one queued wave behind them

    def _dispatch(self, now: float) -> bool:
        # prefill-role replicas never take plain dispatches: they belong to
        # DisaggRouter's two-tier _dispatch override — the filter keeps a
        # mixed fleet safe even if someone hands one to the base router
        live = [
            r for r in self.replicas.values()
            if r.state in (ReplicaState.STARTING, ReplicaState.HEALTHY)
            and getattr(r, "role", "serving") != "prefill"
        ]
        if not live:
            if self._heal_pending():
                # a respawn is coming (budget remains): queued work waits for
                # the healed replica instead of failing
                return False
            # every replica is DEAD or DRAINING — and DRAINING never returns
            # to HEALTHY, so queued work can never run. Fail it loudly (the
            # in-flight work on DRAINING replicas still finishes normally);
            # the alternative is wedging until run()'s timeout.
            draining = any(
                r.state is ReplicaState.DRAINING for r in self.replicas.values()
            )
            reason = (
                "failed: no dispatchable replicas (all draining or dead)"
                if draining else "failed: no live replicas"
            )
            failed_any = False
            while True:
                req = self.admission.pop_next()
                if req is None:
                    return failed_any
                self._finalize(req, RouterRequestStatus.FAILED, now, error=reason)
                failed_any = True
        activity = False
        while True:
            ready = [
                r for r in live
                if r.state is ReplicaState.HEALTHY
                and len(self._outstanding(r.name)) < self._replica_capacity(r)
            ]
            if not ready:
                return activity
            req = self.admission.pop_next()
            if req is None:
                return activity
            if req.deadline_t is not None and req.deadline_t < now:
                self._finalize(
                    req, RouterRequestStatus.EXPIRED, now,
                    error="expired: deadline passed before dispatch",
                )
                activity = True
                continue
            # a replica burning its fast SLO window (self._burning_replicas)
            # or carrying a canary mismatch (self._canary_failed) counts
            # toward DRAINING pressure: it loses ties and is only chosen
            # when every ready replica is suspect — never a deadlock,
            # always a lean away from the replica under a cloud
            target = min(
                ready,
                key=lambda r: (
                    r.name in self._burning_replicas
                    or r.name in self._canary_failed,
                    self.outstanding_tokens(r.name),
                ),
            )
            req.replica = target.name
            req._resume_from = len(req.generated)
            req._dispatch_t = now
            req.status = RouterRequestStatus.DISPATCHED
            self._inflight[req.rid] = req
            self.dispatched += 1
            self._per_replica[target.name]["dispatched"] += 1
            target.submit({
                "rid": req.rid,
                "prompt": [int(t) for t in req.prompt],
                "max_new": req.max_new_tokens,
                "eos": req.eos_token_id,
                "rng_seed": req.rng_seed,
                "generated": list(req.generated),
            })
            activity = True

    def _finalize(
        self,
        req: RouterRequest,
        status: RouterRequestStatus,
        now: float,
        error: Optional[str] = None,
        count: bool = True,
    ) -> None:
        req.status = status
        req.finish_t = now
        if error is not None:
            req.error = error
        if count:
            if status is RouterRequestStatus.SHED:
                self.shed += 1
                reason = (error or "shed: ?").split("shed: ", 1)[-1]
                self.shed_by_reason[reason] = self.shed_by_reason.get(reason, 0) + 1
            elif status is RouterRequestStatus.EXPIRED:
                self.expired += 1
            elif status is RouterRequestStatus.FAILED:
                self.failed += 1
        if self.slo_monitor is not None:
            self._observe_slo(req, status, now)
        terminal = getattr(self, "_terminal_this_poll", None)
        if terminal is not None and status is not RouterRequestStatus.SHED:
            terminal.append(req)

    def _observe_slo(self, req: RouterRequest, status: RouterRequestStatus,
                     now: float) -> None:
        """Feed one terminal outcome into the SLO monitor (only objectives
        the monitor actually declares): ``shed_rate`` sees every submission,
        ``availability`` and ``ttft`` see admitted work (a request that died
        without a first token is an over-threshold ttft by definition)."""
        objectives = getattr(self.slo_monitor, "objectives", {})
        shed = status is RouterRequestStatus.SHED
        if "shed_rate" in objectives:
            self.slo_monitor.observe("shed_rate", good=not shed, now=now)
        if shed:
            return
        # per-replica attribution only for requests that lived on ONE
        # replica: a failover survivor's ttft/latency was inflated by the
        # DEAD replica (death detection + re-prefill), and blaming the
        # healthy survivor would drain exactly the replica that absorbed
        # the work — retried requests count toward the GLOBAL burn only
        source = req.replica if req.retries == 0 else None
        if "availability" in objectives:
            self.slo_monitor.observe(
                "availability",
                good=status is RouterRequestStatus.FINISHED,
                source=source,
                now=now,
            )
        if "ttft" in objectives:
            ttft = (
                req.first_token_t - req.arrival_t
                if req.first_token_t is not None
                else float("inf")
            )
            self.slo_monitor.observe("ttft", value=ttft, source=source, now=now)

    def stats(self) -> dict:
        return {
            "replicas": {n: r.state.value for n, r in self.replicas.items()},
            "queued": self.admission.depth,
            "inflight": len(self._inflight),
            "dispatched": self.dispatched,
            "completed": self.completed,
            "failed": self.failed,
            "expired": self.expired,
            "shed": self.shed,
            "shed_by_reason": dict(self.shed_by_reason),
            "failovers": self.failovers,
            "respawns": self.respawns,
            "per_replica": {n: dict(v) for n, v in self._per_replica.items()},
            "canary": (
                dict(self.canary.stats(),
                     inconclusive=self.canary_inconclusive,
                     failed_replicas=sorted(self._canary_failed))
                if self.canary is not None
                else None
            ),
        }
