"""The background checkpoint writer: the port of
``accelerate_tpu.checkpoint_async``.

``Accelerator.save_state(blocking=False)`` splits a save in two: the
snapshot (:func:`~.checkpointing.snapshot_accelerator_state`: every byte
copied to the host, the train loop waits only for that) and the write and
commit (:func:`~.checkpointing.write_and_commit`), which
:class:`CheckpointManager` runs on one daemon thread.

Back-pressure: at most ``CheckpointConfig.max_in_flight`` snapshots are
queued or writing (one by default: one extra host copy of the state); a
further ``save_state`` waits in :meth:`CheckpointManager.reserve_slot`
until a slot frees, and that wait is stall. The JAX package's watchdog
heartbeat and flight-recorder phases around the write are ROADMAP.md Queue
A item 12.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

__all__ = ["CheckpointManager"]


class _Job:
    __slots__ = ("snapshot", "done", "result", "error")

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.done = threading.Event()
        self.result: Optional[str] = None
        self.error: Optional[BaseException] = None


class CheckpointManager:
    """The writer thread and the in-flight accounting of one
    ``Accelerator``: started at the first :meth:`submit`; :meth:`drain`
    waits until every queued save has committed and raises the first
    writer error; :meth:`shutdown` drains and stops the thread
    (``Accelerator.end_training`` and ``__del__`` call it, so a clean exit
    never tears a write)."""

    def __init__(self, max_in_flight: int = 1):
        self.max_in_flight = max(1, int(max_in_flight))
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._slots = threading.BoundedSemaphore(self.max_in_flight)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._jobs: list = []  # submitted, not yet harvested
        self._active_staging: set = set()

    def active_staging(self) -> set:
        """Staging dirs of queued or writing saves (cleanup leaves them)."""
        with self._lock:
            return set(self._active_staging)

    def reserve_slot(self) -> float:
        """Take a slot before the snapshot is built (this bounds the host
        copies); returns the seconds waited."""
        t0 = time.monotonic()
        if self._slots.acquire(blocking=False):
            return 0.0
        self._slots.acquire()
        return time.monotonic() - t0

    def release_slot(self) -> None:
        """Give back a slot whose save was never submitted."""
        self._slots.release()

    def submit(self, snapshot) -> str:
        """Queue a snapshot for the writer (the caller holds a slot);
        returns the directory it will land in."""
        self.check_error()
        job = _Job(snapshot)
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(target=self._run, name="checkpoint-writer",
                                                daemon=True)
                self._thread.start()
            self._queue.append(job)
            self._jobs.append(job)
            self._active_staging.add(snapshot.staging_dir)
            self._wake.notify_all()
        return snapshot.final_dir

    def pending(self) -> int:
        """Saves not yet committed (queued or writing)."""
        with self._lock:
            return sum(1 for j in self._jobs if not j.done.is_set())

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait until every submitted save has committed; raise the first
        writer error (``TimeoutError`` past ``timeout`` seconds)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                jobs = list(self._jobs)
            if not jobs:
                break
            for job in jobs:
                remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                if not job.done.wait(remaining):
                    raise TimeoutError(f"checkpoint writer did not finish within {timeout}s "
                                       f"(writing {job.snapshot.final_dir})")
            with self._lock:
                self._jobs = [j for j in self._jobs if j not in jobs]
            for job in jobs:
                if job.error is not None:
                    raise RuntimeError(f"background checkpoint save to "
                                       f"{job.snapshot.final_dir} failed") from job.error
        self.check_error()

    def check_error(self) -> None:
        """Raise the first unharvested writer error, without waiting (and
        let go of saves that committed)."""
        with self._lock:
            failed = next((j for j in self._jobs if j.done.is_set() and j.error), None)
            self._jobs = [j for j in self._jobs
                          if j is not failed and not (j.done.is_set() and j.error is None)]
        if failed is not None:
            raise RuntimeError(f"background checkpoint save to {failed.snapshot.final_dir} "
                               "failed") from failed.error

    def shutdown(self, drain: bool = True) -> None:
        thread = self._thread
        if thread is None:
            return
        try:
            if drain:
                self.drain()
        finally:
            with self._lock:
                self._stop = True
                self._wake.notify_all()
            thread.join(timeout=30.0)
            self._thread = None

    def _run(self) -> None:
        from . import checkpointing  # late: tests replace write_and_commit

        while True:
            with self._lock:
                while not self._queue and not self._stop:
                    self._wake.wait()
                if self._stop and not self._queue:
                    return
                job = self._queue.popleft()
            snap = job.snapshot
            try:
                job.result = checkpointing.write_and_commit(snap)
            except BaseException as e:  # surfaced at the next drain or submit
                job.error = e
                logger.error("background checkpoint save to %s failed: %s", snap.final_dir, e)
                if not isinstance(e, Exception):  # an exit or interrupt ends the thread
                    raise
            finally:
                with self._lock:
                    self._active_staging.discard(snap.staging_dir)
                self._slots.release()
                job.done.set()
