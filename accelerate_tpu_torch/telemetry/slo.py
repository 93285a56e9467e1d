"""SLO burn-rate monitoring: the port of ``accelerate_tpu.telemetry.slo``.

An SLO is a target fraction of good events ("99% of requests get their
first token within 250 ms"), an error budget of ``1 - target``, and a
**burn rate**: the observed bad fraction over the budget. A violation
needs a fast window (default 5 m) and a slow one (default 1 h) over the
threshold at once.

- :class:`SLObjective` — one objective: name, target, how an event is
  classified (``latency`` against a threshold, or ``availability``),
  windows and burn threshold;
- :class:`SLOMonitor` — :meth:`~SLOMonitor.observe` events,
  :meth:`~SLOMonitor.evaluate` per-objective fast/slow burn rates with
  hysteresis (``entered`` is true once per episode), and
  :meth:`~SLOMonitor.burning_sources`, the replicas the router treats as
  DRAINING pressure. The clock is injectable;
- :func:`serving_slos` — the stock serving objectives (ttft, availability,
  shed rate), tunable from ``ACCELERATE_SLO_*``.

``evaluate`` returns the reference's records; the reference also emits an
``slo_violation`` event and counter on each episode's entry, which go with
the rest of the telemetry (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from ..utils.environment import parse_optional_float_from_env

SLO_TTFT_ENV_VAR = "ACCELERATE_SLO_TTFT_S"
SLO_TTFT_TARGET_ENV_VAR = "ACCELERATE_SLO_TTFT_TARGET"
SLO_AVAILABILITY_TARGET_ENV_VAR = "ACCELERATE_SLO_AVAILABILITY_TARGET"
SLO_SHED_TARGET_ENV_VAR = "ACCELERATE_SLO_SHED_TARGET"
SLO_STEP_LATENCY_ENV_VAR = "ACCELERATE_SLO_STEP_LATENCY_S"
SLO_RESTART_DOWNTIME_ENV_VAR = "ACCELERATE_SLO_RESTART_DOWNTIME_S"

#: default multi-window pair (seconds): fast pages promptly, slow keeps a
#: blip from paging
FAST_WINDOW_S = 300.0
SLOW_WINDOW_S = 3600.0
#: default page-level burn threshold (Google SRE workbook: 14.4x spends a
#: 30-day budget in 2 days)
BURN_THRESHOLD = 14.4


@dataclass(frozen=True)
class SLObjective:
    """One declarative objective.

    ``kind``:

    - ``"latency"`` — an event is GOOD when its measured value is
      ``<= threshold`` (ttft, step wall time, restart downtime…);
    - ``"availability"`` — the caller classifies good/bad directly
      (finished vs failed, served vs shed).

    ``target`` is the good fraction promised (0.99 = "99% good"); the error
    budget is ``1 - target``.
    """

    name: str
    kind: str = "availability"  # "latency" | "availability"
    target: float = 0.99
    threshold_s: Optional[float] = None  # latency objectives only
    fast_window_s: float = FAST_WINDOW_S
    slow_window_s: float = SLOW_WINDOW_S
    burn_threshold: float = BURN_THRESHOLD
    description: str = ""

    def __post_init__(self):
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "latency" and self.threshold_s is None:
            raise ValueError(f"latency objective {self.name!r} needs threshold_s")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError(
                f"fast window ({self.fast_window_s}s) must be shorter than the "
                f"slow window ({self.slow_window_s}s)"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.target


@dataclass
class _WindowState:
    """Per-objective event ring: (t, bad, source) tuples bounded by the slow
    window (the fast window is a suffix of it). ``window_bad`` is the
    rolling bad count over the CURRENT ring (maintained by observe/trim),
    so the slow-window burn is O(1) instead of a full-ring rescan on every
    evaluate — at serving rates the ring holds 10^5-10^6 events."""

    events: "deque[tuple[float, bool, Optional[str]]]" = field(default_factory=deque)
    total: int = 0
    bad_total: int = 0
    window_bad: int = 0
    violating: bool = False
    violations: int = 0


class SLOMonitor:
    """Multi-window burn-rate evaluation over a set of objectives."""

    def __init__(
        self,
        objectives: Iterable[SLObjective],
        *,
        clock: Callable[[], float] = time.monotonic,
        min_events: int = 10,
    ):
        objectives = list(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"objective names must be unique: {names}")
        self.objectives: "dict[str, SLObjective]" = {o.name: o for o in objectives}
        self.clock = clock
        #: below this many slow-window events a burn rate is noise, not a
        #: signal — no violation fires (a single bad first request must not
        #: page at burn rate 1/budget)
        self.min_events = int(min_events)
        self._state: "dict[str, _WindowState]" = {n: _WindowState() for n in names}
        self._lock = threading.Lock()

    # -- feeding -------------------------------------------------------------

    def observe(
        self,
        name: str,
        *,
        value: Optional[float] = None,
        good: Optional[bool] = None,
        source: Optional[str] = None,
        now: Optional[float] = None,
    ) -> bool:
        """Record one event for objective ``name``: a measured ``value`` for
        latency objectives, a ``good`` verdict for availability ones.
        ``source`` attributes the event (a replica name) for
        :meth:`burning_sources`. Returns the event's good/bad verdict."""
        slo = self.objectives[name]
        if slo.kind == "latency":
            if value is None:
                raise ValueError(f"latency objective {name!r} needs value=")
            good = float(value) <= float(slo.threshold_s)
        elif good is None:
            raise ValueError(f"availability objective {name!r} needs good=")
        now = self.clock() if now is None else now
        state = self._state[name]
        with self._lock:
            state.events.append((now, not good, source))
            state.total += 1
            if not good:
                state.bad_total += 1
                state.window_bad += 1
            self._trim(state, slo, now)
        return bool(good)

    def _trim(self, state: _WindowState, slo: SLObjective, now: float) -> None:
        horizon = now - slo.slow_window_s
        events = state.events
        while events and events[0][0] < horizon:
            _, was_bad, _ = events.popleft()
            if was_bad:
                state.window_bad -= 1

    # -- evaluation ----------------------------------------------------------

    def _burn(self, slo: SLObjective, state: _WindowState, now: float,
              window_s: float, source: Optional[str] = None) -> "tuple[float, int, int]":
        """(burn rate, events, bad) over the trailing window. The unsourced
        slow window is O(1) off the rolling counters (the ring IS the slow
        window after trim); fast/per-source reads scan only the window's
        suffix (the reversed walk breaks at the horizon)."""
        if source is None and window_s >= slo.slow_window_s:
            total, bad = len(state.events), state.window_bad
            if total == 0:
                return 0.0, 0, 0
            return (bad / total) / slo.budget, total, bad
        horizon = now - window_s
        total = bad = 0
        for t, is_bad, src in reversed(state.events):
            if t < horizon:
                break
            if source is not None and src != source:
                continue
            total += 1
            if is_bad:
                bad += 1
        if total == 0:
            return 0.0, 0, 0
        return (bad / total) / slo.budget, total, bad

    def evaluate(self, now: Optional[float] = None, emit: bool = True) -> "list[dict]":
        """Per-objective burn status. A VIOLATION needs both windows over
        the objective's threshold (and ``min_events`` slow-window events);
        each episode's record has ``entered`` true once, on entry
        (hysteresis: re-armed once the fast window drops back under
        threshold). ``emit`` is the reference's switch for its
        ``slo_violation`` event, which the port does not emit yet."""
        now = self.clock() if now is None else now
        results = []
        for name, slo in self.objectives.items():
            state = self._state[name]
            with self._lock:
                self._trim(state, slo, now)
                fast, fast_n, fast_bad = self._burn(slo, state, now, slo.fast_window_s)
                slow, slow_n, slow_bad = self._burn(slo, state, now, slo.slow_window_s)
            burning = (
                slow_n >= self.min_events
                and fast >= slo.burn_threshold
                and slow >= slo.burn_threshold
            )
            entered = burning and not state.violating
            if not burning and state.violating and fast < slo.burn_threshold:
                state.violating = False  # fast-window recovery re-arms the episode
            rec = {
                "slo": name,
                # "slo_kind", not "kind": events.emit reserves the record kind
                "slo_kind": slo.kind,
                "target": slo.target,
                "threshold_s": slo.threshold_s,
                "fast_burn": round(fast, 4),
                "slow_burn": round(slow, 4),
                "fast_window_s": slo.fast_window_s,
                "slow_window_s": slo.slow_window_s,
                "burn_threshold": slo.burn_threshold,
                "fast_events": fast_n,
                "fast_bad": fast_bad,
                "slow_events": slow_n,
                "slow_bad": slow_bad,
                "violating": burning,
                # True exactly once per episode — callers that write their
                # own record stream (the supervisor) key off this
                "entered": entered,
            }
            if entered:
                state.violating = True
                state.violations += 1
            results.append(rec)
        return results

    def burning_sources(self, name: str, now: Optional[float] = None) -> "list[str]":
        """Sources (replicas) whose FAST-window burn for ``name`` is over the
        threshold — the router's DRAINING-pressure signal. Per-source burn
        needs at least ``min_events`` fast-window events from that source to
        count (one slow request out of one must not drain a replica)."""
        slo = self.objectives[name]
        state = self._state[name]
        now = self.clock() if now is None else now
        with self._lock:
            sources = {
                src for t, _, src in state.events
                if src is not None and t >= now - slo.fast_window_s
            }
            burning = []
            for src in sorted(sources):
                burn, n, _ = self._burn(slo, state, now, slo.fast_window_s, source=src)
                if n >= self.min_events and burn >= slo.burn_threshold:
                    burning.append(src)
        return burning

    def stats(self) -> dict:
        return {
            name: {
                "events": s.total,
                "bad": s.bad_total,
                "violations": s.violations,
                "violating": s.violating,
            }
            for name, s in sorted(self._state.items())
        }


# ---------------------------------------------------------------------------
# stock objective sets


def _env_float(key: str, default: float) -> float:
    """The repo's defensive env parse (utils.environment), with a required
    default — garbage/unset never crashes an SLO-armed process."""
    value = parse_optional_float_from_env(key)
    return default if value is None else value


def serving_slos(
    *,
    ttft_threshold_s: Optional[float] = None,
    ttft_target: Optional[float] = None,
    availability_target: Optional[float] = None,
    shed_target: Optional[float] = None,
    fast_window_s: float = FAST_WINDOW_S,
    slow_window_s: float = SLOW_WINDOW_S,
    burn_threshold: float = BURN_THRESHOLD,
) -> "list[SLObjective]":
    """The stock serving objectives (env-tunable): ttft latency,
    availability (admitted requests finish), shed rate."""
    kw = dict(fast_window_s=fast_window_s, slow_window_s=slow_window_s,
              burn_threshold=burn_threshold)
    return [
        SLObjective(
            name="ttft",
            kind="latency",
            threshold_s=(
                ttft_threshold_s if ttft_threshold_s is not None
                else _env_float(SLO_TTFT_ENV_VAR, 1.0)
            ),
            target=(
                ttft_target if ttft_target is not None
                else _env_float(SLO_TTFT_TARGET_ENV_VAR, 0.99)
            ),
            description="first token within threshold",
            **kw,
        ),
        SLObjective(
            name="availability",
            kind="availability",
            target=(
                availability_target if availability_target is not None
                else _env_float(SLO_AVAILABILITY_TARGET_ENV_VAR, 0.999)
            ),
            description="admitted requests finish (failed/expired = bad)",
            **kw,
        ),
        SLObjective(
            name="shed_rate",
            kind="availability",
            target=(
                shed_target if shed_target is not None
                else _env_float(SLO_SHED_TARGET_ENV_VAR, 0.99)
            ),
            description="submitted requests admitted (shed = bad)",
            **kw,
        ),
    ]


def step_latency_slo_from_env() -> Optional[SLObjective]:
    """Training-side: ``ACCELERATE_SLO_STEP_LATENCY_S=<seconds>`` arms a
    step-wall-time objective (target tunable via
    ``ACCELERATE_SLO_STEP_LATENCY_TARGET``, default 0.99). None when unset —
    the Accelerator's hot path stays a single ``is None`` check."""
    threshold = parse_optional_float_from_env(SLO_STEP_LATENCY_ENV_VAR)
    if threshold is None:
        return None
    return SLObjective(
        name="step_latency",
        kind="latency",
        threshold_s=threshold,
        target=_env_float("ACCELERATE_SLO_STEP_LATENCY_TARGET", 0.99),
        description="train step wall time within threshold",
    )


def restart_downtime_slo_from_env() -> Optional[SLObjective]:
    """Supervisor-side: ``ACCELERATE_SLO_RESTART_DOWNTIME_S=<seconds>`` arms
    a restart-downtime objective (every restart is one event; default
    target 0.9 — restarts are rare, so the budget math runs on small
    counts and ``min_events=1`` at the caller)."""
    threshold = parse_optional_float_from_env(SLO_RESTART_DOWNTIME_ENV_VAR)
    if threshold is None:
        return None
    return SLObjective(
        name="restart_downtime",
        kind="latency",
        threshold_s=threshold,
        target=_env_float("ACCELERATE_SLO_RESTART_DOWNTIME_TARGET", 0.9),
        # restarts are RARE events: one over-budget restart must already
        # page (burn 1/(1-0.9) = 10 from a single bad event), so the
        # threshold is "any budget burn", not the page-level 14.4 that
        # high-volume request objectives use
        burn_threshold=1.0,
        description="restart downtime within threshold",
    )
