"""Engine replicas: the port of ``accelerate_tpu.serving.replica``.

One warmed :class:`~.engine.ServingEngine` per unit of failure, behind a
transport the :class:`~.router.ServingRouter` can watch. Two transports
give one replica surface:

- :class:`LocalReplica` — the engine loop in a daemon thread of this
  process. A thread cannot be SIGKILLed, so abrupt death is
  :meth:`~LocalReplica.kill` (the loop exits without reporting in-flight
  work). Thread replicas share the GIL and the card's default stream, so
  their device work runs one after another.
- :class:`ProcessReplica` — the engine loop in a child process speaking
  JSON lines over stdin/stdout; :meth:`~ProcessReplica.kill` is a real
  SIGKILL. The child loads the kernel libraries the parent built
  (``ops/_build.py``); it builds them only when none are there.

Both run :class:`_EngineWorker`: drain submit commands, step the engine,
and stream one ``step`` event per engine step with each request's new
tokens. Those deltas make failover token-exact: the router holds every
in-flight request's ``generated``-so-far, and a survivor resumes through
``ServingEngine.submit(generated=...)``.

:class:`ReplicaSpec` keeps the reference's fields and adds ``device`` (the
engine's device, ``"cuda"`` unless the caller asks for the CPU) and
``cache_dtype`` (the pool's dtype, the engine's bf16 by default). Chaos
schedules, the watchdog heartbeat, goodput notes and trace spans are not
ported yet (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import queue
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = [
    "REPLICA_SPEC_ENV_VAR",
    "ReplicaState",
    "ReplicaSpec",
    "LocalReplica",
    "ProcessReplica",
]

REPLICA_SPEC_ENV_VAR = "ACCELERATE_REPLICA_SPEC"


class ReplicaState(enum.Enum):
    STARTING = "starting"  # spawned, engine still building/warming
    HEALTHY = "healthy"    # ready event seen, heartbeats fresh
    DRAINING = "draining"  # no new dispatch; in-flight work finishes
    DEAD = "dead"          # crashed or stalled; in-flight work failed over


@dataclass(frozen=True)
class ReplicaSpec:
    """A serializable engine recipe, so every replica — thread or child
    process — builds the same engine over the same params, which is what
    makes cross-replica retry bitwise-safe. ``model`` holds ``LlamaConfig``
    field overrides; bucket tuples of ``None`` fall back to the engine's
    power-of-two lattice. ``role`` picks the engine: ``"serving"`` (the
    monolith), ``"prefill"`` (:class:`~.disagg.PrefillEngine`) or
    ``"decode"`` (:class:`~.disagg.DecodeEngine`); ``spec_tokens`` and
    ``draft_layers`` apply to the monolith only."""

    model: "dict[str, Any]"
    param_seed: int = 0
    num_blocks: int = 49
    block_size: int = 8
    max_slots: int = 4
    max_blocks_per_seq: Optional[int] = None
    slot_buckets: Optional["tuple[int, ...]"] = None
    block_buckets: Optional["tuple[int, ...]"] = None
    prefill_buckets: Optional["tuple[int, ...]"] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    param_dtype: str = "bfloat16"
    compile_cache_dir: Optional[str] = None
    role: str = "serving"
    spec_tokens: int = 0
    draft_layers: Optional[int] = None
    device: str = "cuda"
    cache_dtype: str = "bfloat16"

    def config(self):
        from ..models.transformer import LlamaConfig

        return LlamaConfig(**self.model)

    def build_params(self):
        """``init_llama`` drawn from a CPU generator seeded ``param_seed``,
        cast to ``param_dtype``, then moved to ``device``: the same tensors
        in every replica and process, whatever the card."""
        import torch

        from ..models.transformer import init_llama
        from ..utils.device import resolve_device
        from ..utils.operations import _tree_map

        device = resolve_device(self.device)
        dtype = getattr(torch, self.param_dtype)
        params = init_llama(self.config(), torch.Generator().manual_seed(self.param_seed),
                            device="cpu")
        return _tree_map(lambda t: t.to(dtype=dtype).to(device), params)

    def lattice(self):
        from .buckets import BucketLattice

        if self.slot_buckets is None:
            return None
        return BucketLattice(
            slot_buckets=tuple(self.slot_buckets),
            block_buckets=tuple(self.block_buckets),
            prefill_buckets=tuple(self.prefill_buckets),
        )

    def build_engine(self, heartbeat_name: str = "serving_decode"):
        import torch

        if self.role == "prefill":
            from .disagg import PrefillEngine as engine_cls
        elif self.role == "decode":
            from .disagg import DecodeEngine as engine_cls
        else:
            from .engine import ServingEngine as engine_cls

        extra = {}
        if self.role not in ("prefill", "decode") and self.spec_tokens:
            extra = dict(spec_tokens=self.spec_tokens, draft_layers=self.draft_layers)
        return engine_cls(
            self.build_params(),
            self.config(),
            num_blocks=self.num_blocks,
            block_size=self.block_size,
            max_slots=self.max_slots,
            max_blocks_per_seq=self.max_blocks_per_seq,
            lattice=self.lattice(),
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            heartbeat_name=heartbeat_name,
            compile_cache_dir=self.compile_cache_dir,
            cache_dtype=getattr(torch, self.cache_dtype),
            device=self.device,
            **extra,
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, payload: str) -> "ReplicaSpec":
        return cls(**json.loads(payload))


# ---------------------------------------------------------------------------
# the worker loop (shared by both transports)


class _EngineWorker:
    """Drive one engine from a command stream, emitting an event stream.

    Commands: ``{"cmd": "submit", "rid", "prompt", "max_new", "eos",
    "rng_seed", "generated"[, "handoff"]}``, ``{"cmd": "stats"}`` and
    ``{"cmd": "stop"}``. Events: ``ready`` (the warm-up's point counts),
    ``step`` (per engine step: progress deltas per request), ``done``
    (terminal status + the full token list), ``handoff`` (a prefill
    engine's KV handoff in wire form), ``beat`` (throttled idle liveness),
    ``stats`` (the engine's ``stats()`` and this process's kernel launch
    counts) and ``fatal`` (the loop died on an exception)."""

    def __init__(
        self,
        engine,
        recv: Callable[[float], Optional[dict]],
        send: Callable[[dict], None],
        killed: Optional[threading.Event] = None,
        idle_beat_s: float = 0.1,
    ):
        self.engine = engine
        self.recv = recv
        self.send = send
        self.killed = killed or threading.Event()
        self.idle_beat_s = idle_beat_s

    def _stats_event(self) -> dict:
        from ..ops.flash_attention import paged_attention_decode, paged_attention_prefill

        return {
            "event": "stats",
            "engine": self.engine.stats(),
            "launches": {
                "paged_attention_decode": paged_attention_decode.launches,
                "paged_attention_prefill": paged_attention_prefill.launches,
            },
        }

    def run(self) -> None:
        import numpy as np

        from .scheduler import RequestStatus

        try:
            self.send({"event": "ready", **self.engine.warmup()})
            handles: "dict[str, Any]" = {}  # router rid -> engine Request
            sent: "dict[str, int]" = {}  # router rid -> tokens already reported
            last_beat = 0.0
            while not self.killed.is_set():
                cmd = self.recv(self.idle_beat_s if self.engine.scheduler.idle() else 0.0)
                while cmd is not None:
                    if cmd.get("cmd") == "stop":
                        return
                    if cmd.get("cmd") == "stats":
                        self.send(self._stats_event())
                    if cmd.get("cmd") == "submit":
                        extra = {}
                        if cmd.get("handoff") is not None:
                            # disaggregated decode dispatch: DecodeEngine.submit
                            # gates the request's admission on landing it
                            extra["handoff"] = cmd["handoff"]
                        req = self.engine.submit(
                            np.asarray(cmd["prompt"], np.int32),
                            int(cmd["max_new"]),
                            eos_token_id=cmd.get("eos"),
                            rng_seed=int(cmd.get("rng_seed", 0)),
                            generated=cmd.get("generated") or None,
                            **extra,
                        )
                        handles[cmd["rid"]] = req
                        sent[cmd["rid"]] = len(req.generated)
                    cmd = self.recv(0.0)
                if self.engine.scheduler.idle():
                    now = time.monotonic()
                    if now - last_beat >= self.idle_beat_s:
                        last_beat = now
                        self.send({"event": "beat"})
                    continue
                finished = self.engine.step()
                progress = {}
                for rid, req in handles.items():
                    n = len(req.generated)
                    if n > sent[rid]:
                        progress[rid] = [int(t) for t in req.generated[sent[rid]:]]
                        sent[rid] = n
                self.send(
                    {
                        "event": "step",
                        "step": self.engine.steps,
                        "running": len(self.engine.scheduler.running()),
                        "queued": self.engine.scheduler.queue_depth,
                        "progress": progress,
                    }
                )
                for req in finished:
                    rid = next(k for k, v in handles.items() if v is req)
                    self.send(
                        {
                            "event": "done",
                            "rid": rid,
                            "status": "finished"
                            if req.status is RequestStatus.FINISHED
                            else "rejected",
                            "tokens": [int(t) for t in req.generated],
                            "error": req.error,
                            "preemptions": req.preemptions,
                        }
                    )
                    handles.pop(rid)
                    sent.pop(rid)
                pop = getattr(self.engine, "pop_handoffs", None)
                if pop is not None:
                    # PrefillEngine: each prefilled request leaves as a KV
                    # handoff event; the step event above already reported
                    # its first token, and both transports keep event order
                    for req, wire in pop():
                        rid = next(k for k, v in handles.items() if v is req)
                        self.send({"event": "handoff", "rid": rid, "handoff": wire})
                        handles.pop(rid, None)
                        sent.pop(rid, None)
        except BaseException as exc:  # the router must hear about ANY death
            try:
                self.send({"event": "fatal", "error": f"{type(exc).__name__}: {exc}"})
            except Exception:
                pass  # transport already gone: the health check catches it


# ---------------------------------------------------------------------------
# transports


class LocalReplica:
    """The worker loop in a daemon thread of this process."""

    transport = "thread"

    def __init__(self, name: str, spec: ReplicaSpec, *, idle_beat_s: float = 0.05):
        self.name = name
        self.spec = spec
        self._idle_beat_s = idle_beat_s
        self.state = ReplicaState.STARTING
        self._inbox: "queue.Queue[dict]" = queue.Queue()
        self._outbox: "queue.Queue[dict]" = queue.Queue()
        self._killed = threading.Event()
        self._worker: Optional[_EngineWorker] = None

        def _run():
            engine = spec.build_engine(heartbeat_name=f"serving_decode:{name}")
            self._worker = _EngineWorker(
                engine,
                recv=self._recv,
                send=self._outbox.put,
                killed=self._killed,
                idle_beat_s=idle_beat_s,
            )
            self._worker.run()

        self._thread = threading.Thread(
            target=_run, name=f"serving-replica-{name}", daemon=True
        )
        self._thread.start()

    def _recv(self, timeout: float) -> Optional[dict]:
        try:
            return self._inbox.get(timeout=timeout) if timeout > 0 else self._inbox.get_nowait()
        except queue.Empty:
            return None

    @property
    def role(self) -> str:
        return getattr(self.spec, "role", "serving")

    # -- router surface ------------------------------------------------------

    def submit(self, payload: dict) -> None:
        self._inbox.put(dict(payload, cmd="submit"))

    def drain_events(self) -> "list[dict]":
        events = []
        while True:
            try:
                events.append(self._outbox.get_nowait())
            except queue.Empty:
                return events

    def alive(self) -> bool:
        return self._thread.is_alive()

    def kill(self) -> None:
        """Abrupt death: the loop exits at its next check without reporting
        in-flight work (a hung loop never reaches the check — the heartbeat
        watch handles that, as for a real process)."""
        self._killed.set()

    def request_stats(self) -> None:
        """Ask the worker for a ``stats`` event (read by ``drain_events``)."""
        self._inbox.put({"cmd": "stats"})

    def stop(self) -> None:
        self._inbox.put({"cmd": "stop"})

    def close(self, timeout: float = 5.0) -> None:
        self.stop()
        self._killed.set()
        self._thread.join(timeout=timeout)

    def respawn(self) -> "LocalReplica":
        """A fresh incarnation from the stored spec (the router's self-heal
        path)."""
        return LocalReplica(self.name, self.spec, idle_beat_s=self._idle_beat_s)


class ProcessReplica:
    """The worker loop in a child process, JSON lines over stdin/stdout.

    The child inherits the parent's environment (or ``env``) with the spec
    and the repository on ``PYTHONPATH``. ``chaos_schedule`` (the
    reference's fault injection in the child) is not ported yet and
    raises."""

    transport = "process"

    def __init__(
        self,
        name: str,
        spec: ReplicaSpec,
        *,
        chaos_schedule: Optional[str] = None,
        env: Optional[dict] = None,
        idle_beat_s: float = 0.05,
    ):
        if chaos_schedule is not None:
            raise NotImplementedError(
                "ProcessReplica(chaos_schedule=): chaos injection is not ported yet "
                "(ROADMAP.md, Queue A item 12)"
            )
        self.name = name
        self.spec = spec
        self._idle_beat_s = idle_beat_s
        self._base_env = None if env is None else dict(env)
        self.state = ReplicaState.STARTING
        self._outbox: "queue.Queue[dict]" = queue.Queue()
        child_env = dict(os.environ if env is None else env)
        child_env[REPLICA_SPEC_ENV_VAR] = spec.to_json()
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, child_env.get("PYTHONPATH")) if p
        )
        # -c instead of -m: runpy would re-execute a module the package
        # __init__ already imported and warn about it
        worker = (
            "import sys; from accelerate_tpu_torch.serving.replica import _worker_main; "
            "sys.exit(_worker_main(sys.argv[1:]))"
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-c", worker, "--name", name, "--idle-beat-s", str(idle_beat_s)],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=None,  # pass through: replica tracebacks stay debuggable
            text=True,
            bufsize=1,
            env=child_env,
        )
        self._reader = threading.Thread(
            target=self._pump, name=f"serving-replica-{name}-reader", daemon=True
        )
        self._reader.start()

    def _pump(self) -> None:
        for line in self.proc.stdout:
            line = line.strip()
            if not line:
                continue
            try:
                self._outbox.put(json.loads(line))
            except ValueError:
                pass  # stray non-protocol output: never fatal

    @property
    def role(self) -> str:
        return getattr(self.spec, "role", "serving")

    # -- router surface ------------------------------------------------------

    def _write(self, command: dict) -> None:
        try:
            self.proc.stdin.write(json.dumps(command) + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            pass  # child died: the router's liveness check fails it over

    def submit(self, payload: dict) -> None:
        self._write(dict(payload, cmd="submit"))

    def drain_events(self) -> "list[dict]":
        events = []
        while True:
            try:
                events.append(self._outbox.get_nowait())
            except queue.Empty:
                return events

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()

    def request_stats(self) -> None:
        """Ask the worker for a ``stats`` event (read by ``drain_events``)."""
        self._write({"cmd": "stats"})

    def stop(self) -> None:
        self._write({"cmd": "stop"})

    def close(self, timeout: float = 10.0) -> None:
        self.stop()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)

    def respawn(self) -> "ProcessReplica":
        """A fresh child from the stored spec (the router's self-heal
        path)."""
        return ProcessReplica(
            self.name, self.spec, env=self._base_env, idle_beat_s=self._idle_beat_s
        )


# ---------------------------------------------------------------------------
# child entry point


def _worker_main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="accelerate_tpu_torch.serving.replica")
    parser.add_argument("--name", default="replica")
    parser.add_argument("--idle-beat-s", type=float, default=0.05)
    args = parser.parse_args(argv)

    payload = os.environ.get(REPLICA_SPEC_ENV_VAR, "").strip()
    if not payload:
        print(f"{REPLICA_SPEC_ENV_VAR} not set", file=sys.stderr)
        return 2
    spec = ReplicaSpec.from_json(payload)
    engine = spec.build_engine(heartbeat_name=f"serving_decode:{args.name}")
    inbox: "queue.Queue[dict]" = queue.Queue()

    def _pump_stdin():
        for line in sys.stdin:
            line = line.strip()
            if line:
                try:
                    inbox.put(json.loads(line))
                except ValueError:
                    pass
        inbox.put({"cmd": "stop"})  # router closed the pipe: shut down

    threading.Thread(target=_pump_stdin, daemon=True).start()

    def _recv(timeout: float) -> Optional[dict]:
        try:
            return inbox.get(timeout=timeout) if timeout > 0 else inbox.get_nowait()
        except queue.Empty:
            return None

    def _send(event: dict) -> None:
        sys.stdout.write(json.dumps(event) + "\n")
        sys.stdout.flush()

    _EngineWorker(engine, recv=_recv, send=_send, idle_beat_s=args.idle_beat_s).run()
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
