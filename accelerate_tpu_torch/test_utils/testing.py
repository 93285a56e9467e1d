"""Launching several processes of the port: the counterpart of
``accelerate_tpu.test_utils.testing.execute_multiprocess``.

The processes meet through a ``FileStore`` in a fresh temporary directory
(``ACCELERATE_COORDINATOR_ADDRESS=file:///...``), so concurrent launches,
such as those of parallel test workers, never compete for a port. They run
on the CPU over ``gloo`` unless ``env_extra`` says otherwise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from typing import Optional

__all__ = ["execute_multiprocess"]


def execute_multiprocess(script_args: list, num_processes: int = 2,
                         env_extra: Optional[dict] = None, timeout: float = 120.0) -> list:
    """Run ``python <script_args>`` as ``num_processes`` processes under the
    launcher protocol (``ACCELERATE_COORDINATOR_ADDRESS``,
    ``ACCELERATE_NUM_PROCESSES``, ``ACCELERATE_PROCESS_ID``,
    ``ACCELERATE_LOCAL_PROCESS_INDEX``), one thread each; wait for all of
    them at most ``timeout`` seconds in all, kill every one still running
    when that passes, and raise unless each exited with 0. Returns each
    process's output (stdout and stderr together)."""
    import time

    store_dir = tempfile.mkdtemp(prefix="accelerate_torch_store_")
    procs = []
    try:
        for i in range(num_processes):
            env = os.environ.copy()
            env.update({
                "ACCELERATE_USE_CPU": "true",
                "ACCELERATE_COORDINATOR_ADDRESS": f"file://{store_dir}/store",
                "ACCELERATE_NUM_PROCESSES": str(num_processes),
                "ACCELERATE_PROCESS_ID": str(i),
                "ACCELERATE_LOCAL_PROCESS_INDEX": str(i),
                "ACCELERATE_INITIALIZATION_TIMEOUT": str(int(timeout)),
                "OMP_NUM_THREADS": "1",
            })
            env.update(env_extra or {})
            procs.append(subprocess.Popen([sys.executable, *script_args], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        deadline = time.monotonic() + timeout
        outputs, failed = [], []
        for i, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multiprocess run timed out after {timeout}s (process {i})")
            outputs.append(out)
            if proc.returncode != 0:
                failed.append((i, proc.returncode, out))
        if failed:
            report = "\n".join(f"--- process {i} rc={rc} ---\n{out[-4000:]}"
                               for i, rc, out in failed)
            raise AssertionError(f"{len(failed)}/{num_processes} processes failed:\n{report}")
        return outputs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(store_dir, ignore_errors=True)
