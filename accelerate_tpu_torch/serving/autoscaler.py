"""SLO-driven autoscaling of the decode tier: the port of
``accelerate_tpu.serving.autoscaler``.

An :class:`AutoscalerPolicy` plugged into the router
(``ServingRouter(autoscaler=...)``, consulted once per poll right after
the SLO evaluation it keys off) grows the decode tier while the ``ttft``
objective is burning and shrinks it after sustained idleness, through the
replica machinery self-heal uses (spawn from a spec,
``router.add_replica``, drain to decommission). Hysteresis, on an
injectable clock:

- grow only while ``ttft`` is violating, one pending join at a time,
  never past ``max_decode``;
- shrink only after ``idle_shrink_after_s`` of empty queue and nothing in
  flight, never below ``min_decode``;
- every action arms ``cooldown_s`` before the next.

The reference pre-ships compile-cache entries so a joiner boots warm
(``source_cache_dir``, ``joiner_cache_dir``); the port has no compile
cache yet (ROADMAP.md, Queue A item 12) and raises when they are given, so
a join's ``join_compiles`` is 0 by construction. The ``autoscale`` records
and metrics go with the telemetry.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from .replica import ReplicaState, ReplicaSpec

__all__ = ["AutoscalerPolicy", "lattice_fns"]


def lattice_fns(spec: ReplicaSpec) -> "set[str]":
    """The names of the points a replica built from ``spec`` warms (the
    reference's compile-cache ``fn`` names, its pre-ship set). Mirrors the
    engine's lattice derivation, including the default power-of-two
    lattice when the spec pins no buckets."""
    lat = spec.lattice()
    if lat is None:
        from .buckets import BucketLattice

        config = spec.config()
        mbps = spec.max_blocks_per_seq
        if mbps is None:
            mbps = spec.num_blocks - 1  # allocator.usable_blocks
        max_prefill = min(config.max_seq_len, mbps * spec.block_size)
        lat = BucketLattice.from_limits(spec.max_slots, mbps, max_prefill)
    fns = {f"serving_prefill[{S}x{W}]" for S, W in lat.prefill_points()}
    fns |= {f"serving_decode[{B}x{W}]" for B, W in lat.decode_points()}
    fns |= {"serving_cow", "serving_land"}
    return fns


class AutoscalerPolicy:
    """Grow/shrink the decode tier off the router's burn-rate signal.

    ``template_spec`` is the recipe for joiners (its ``role`` is forced to
    ``"decode"``); ``spawn(name, spec)`` builds the replica (defaults to
    :class:`~.replica.LocalReplica`). ``source_cache_dir`` and
    ``joiner_cache_dir`` (the reference's compile-cache pre-ship) raise
    :class:`NotImplementedError` until the compile cache is ported."""

    def __init__(
        self,
        template_spec: ReplicaSpec,
        *,
        spawn: Optional[Callable[[str, ReplicaSpec], Any]] = None,
        min_decode: int = 1,
        max_decode: int = 4,
        cooldown_s: float = 30.0,
        idle_shrink_after_s: float = 60.0,
        source_cache_dir: Optional[str] = None,
        joiner_cache_dir: Optional[Callable[[str], str]] = None,
        clock: Callable[[], float] = time.monotonic,
        name_prefix: str = "scale",
    ):
        if min_decode < 1:
            raise ValueError(f"min_decode must be >= 1, got {min_decode}")
        if max_decode < min_decode:
            raise ValueError(f"max_decode={max_decode} < min_decode={min_decode}")
        if source_cache_dir is not None or joiner_cache_dir is not None:
            raise NotImplementedError(
                "AutoscalerPolicy(source_cache_dir=, joiner_cache_dir=): compile-cache "
                "pre-shipping is not ported yet (ROADMAP.md, Queue A item 12)"
            )
        self.template_spec = template_spec
        self.spawn = spawn or self._default_spawn
        self.min_decode = int(min_decode)
        self.max_decode = int(max_decode)
        self.cooldown_s = float(cooldown_s)
        self.idle_shrink_after_s = float(idle_shrink_after_s)
        self.source_cache_dir = source_cache_dir
        self.joiner_cache_dir = joiner_cache_dir
        self.clock = clock
        self.name_prefix = name_prefix
        #: every decision, in order — the bench payload and tests read this
        self.events: "list[dict]" = []
        self.scale_ups = 0
        self.scale_downs = 0
        self._counter = 0
        self._cooldown_until = float("-inf")
        self._idle_since: Optional[float] = None
        #: joiner name -> spawn time, while its warmup is still running
        self._pending: "dict[str, float]" = {}

    @staticmethod
    def _default_spawn(name: str, spec: ReplicaSpec):
        from .replica import LocalReplica

        return LocalReplica(name, spec)

    # -- the per-poll hook ---------------------------------------------------

    def maybe_act(self, router, now: Optional[float] = None) -> bool:
        """One autoscaling decision against ``router``'s current state.
        Called by the router's poll loop; safe to call every poll — all the
        hysteresis lives here. Returns True when anything happened."""
        now = self.clock() if now is None else now
        acted = self._note_joins(router, now)
        decode_live = [
            r for r in router.replicas.values()
            if getattr(r, "role", "serving") != "prefill"
            and r.state in (ReplicaState.STARTING, ReplicaState.HEALTHY)
        ]
        # -- grow: the ttft objective is in a burn episode -------------------
        burn = next(
            (
                rec for rec in getattr(router, "last_slo_results", [])
                if rec.get("slo") == "ttft" and rec.get("violating")
            ),
            None,
        )
        if (
            burn is not None
            and now >= self._cooldown_until
            and not self._pending
            and len(decode_live) < self.max_decode
        ):
            self._scale_up(router, now, burn)
            return True
        # -- shrink: sustained idleness --------------------------------------
        idle = router.admission.depth == 0 and not router._inflight
        if not idle:
            self._idle_since = None
            return acted
        if self._idle_since is None:
            self._idle_since = now
            return acted
        if (
            now - self._idle_since >= self.idle_shrink_after_s
            and now >= self._cooldown_until
            and not self._pending
            and len(decode_live) > self.min_decode
        ):
            self._scale_down(router, now, decode_live)
            return True
        return acted

    # -- internals -----------------------------------------------------------

    def _record(self, router, now: float, **fields) -> dict:
        rec = {"t": now, **fields}
        self.events.append(rec)
        return rec

    def _note_joins(self, router, now: float) -> bool:
        """Resolve pending joins: a joiner that reached HEALTHY reports its
        time-to-ready and whether the join was warm (zero compiles — every
        warmup point was a cache hit); one that died reports the failure
        and releases the pending slot so the next burn can retry."""
        acted = False
        for name in list(self._pending):
            rep = router.replicas.get(name)
            if rep is None or rep.state is ReplicaState.DEAD:
                self._pending.pop(name)
                self._record(router, now, action="join_failed", replica=name,
                             reason=getattr(rep, "reason", "replica missing"))
                acted = True
                continue
            if rep.state is not ReplicaState.HEALTHY:
                continue  # still warming
            spawned = self._pending.pop(name)
            info = getattr(rep, "ready_info", None) or {}
            join_compiles = sum(
                int(info.get(k, 0))
                for k in ("cache_miss", "cache_uncached", "cache_error")
            )
            self._record(
                router, now,
                action="join_ready",
                replica=name,
                time_to_ready_s=round(now - spawned, 6),
                join_compiles=join_compiles,
                warm=join_compiles == 0,
            )
            acted = True
        return acted

    def _scale_up(self, router, now: float, burn: dict) -> None:
        self._counter += 1
        name = f"{self.name_prefix}{self._counter}"
        spec = dataclasses.replace(self.template_spec, role="decode")
        preshipped = None  # the reference's compile-cache pre-ship
        replica = self.spawn(name, spec)
        router.add_replica(replica)
        self._pending[name] = now
        self._cooldown_until = now + self.cooldown_s
        self.scale_ups += 1
        self._record(
            router, now,
            action="scale_up",
            replica=name,
            trigger="ttft_burn",
            fast_burn=burn.get("fast_burn"),
            burn_threshold=burn.get("burn_threshold"),
            preshipped=preshipped,
        )

    def _scale_down(self, router, now: float, decode_live: "list") -> None:
        """Retire one decode replica: newest joiner first (founding members
        are the steady-state fleet), least-loaded as the tiebreak. Drain +
        stop — the worker exits once told, the router's health check books
        the death as a decommission (DRAINING death never self-heals)."""
        victim = max(
            decode_live,
            key=lambda r: (
                r.name.startswith(self.name_prefix),
                -len(router._outstanding(r.name)),
                r.name,
            ),
        )
        idle_s = now - (self._idle_since if self._idle_since is not None else now)
        router.drain(victim.name)
        victim.stop()
        self._idle_since = None
        self._cooldown_until = now + self.cooldown_s
        self.scale_downs += 1
        self._record(
            router, now,
            action="scale_down",
            replica=victim.name,
            trigger="sustained_idle",
            idle_s=round(idle_s, 6),
        )

    def stats(self) -> dict:
        return {
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "pending_joins": sorted(self._pending),
            "events": list(self.events),
        }
