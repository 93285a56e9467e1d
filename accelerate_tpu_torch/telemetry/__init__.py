"""Telemetry: the port of ``accelerate_tpu.telemetry``.

Only the SLO burn-rate monitor (:mod:`.slo`) is ported so far: the serving
router drains a replica that burns its ttft window and the autoscaler grows
the decode tier on a burn. Events, metrics, tracing spans, the watchdog and
the goodput ledger are not ported yet (ROADMAP.md, Queue A item 12a).
"""

from .slo import SLObjective, SLOMonitor, serving_slos

__all__ = ["SLObjective", "SLOMonitor", "serving_slos"]
