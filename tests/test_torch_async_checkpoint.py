"""The port's asynchronous checkpointing, case for case the JAX package's
``tests/test_async_checkpoint.py``: the snapshot / writer-thread split,
the commit protocol (staging, fsync, the ``_COMMITTED`` marker, the atomic
rename), back-pressure, rotation after the commit, a kill at each crash
point, and corruption caught on load. Numpy param trees and one process on
the CPU, as the JAX cases take; the mid-epoch resume runs the port's loader
at one process (the JAX case's 8-device mesh has no one-process
counterpart). Every case compares exactly: the values saved are the values
loaded."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch

from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.checkpointing import (
    COMMITTED_MARKER,
    CheckpointCorruptError,
    find_latest_checkpoint,
    is_committed_checkpoint,
)
from accelerate_tpu_torch.data_loader import DataLoader
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import CheckpointConfig, ProjectConfiguration

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _auto_acc(tmp_path, total_limit=None, **ckpt_kwargs):
    return Accelerator(
        cpu=True,
        project_config=ProjectConfiguration(
            project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=total_limit
        ),
        checkpoint_config=CheckpointConfig(**ckpt_kwargs) if ckpt_kwargs else None,
    )


def _params(value=1.0):
    return {"w": np.full((32, 4), value, np.float32), "b": np.zeros(4, np.float32)}


# ---------------------------------------------------------------------------
# async semantics


@pytest.mark.smoke
def test_async_save_roundtrip_and_commit_marker(tmp_path):
    acc = _auto_acc(tmp_path)
    out = acc.save_state(params=_params(3.0), blocking=False)
    acc.wait_for_checkpoint()
    assert is_committed_checkpoint(out)
    manifest = json.load(open(os.path.join(out, COMMITTED_MARKER)))
    assert manifest["schema"] == 1 and manifest["files"]
    # every listed file exists with the recorded size
    for name, rec in manifest["files"].items():
        assert os.path.getsize(os.path.join(out, name)) == rec["bytes"]
    restored = acc.load_state(out, params=_params(0.0))
    np.testing.assert_allclose(np.asarray(restored["w"]), 3.0)
    acc.end_training()


def test_async_save_returns_before_write_finishes(tmp_path, monkeypatch):
    """The zero-stall property: save_state(blocking=False) returns after the
    snapshot; a deliberately slowed writer runs in the background."""
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit
    started = threading.Event()

    def slow(snap, heartbeat=None):
        started.set()
        time.sleep(0.5)
        return real(snap, heartbeat=heartbeat)

    monkeypatch.setattr(checkpointing, "write_and_commit", slow)
    acc = _auto_acc(tmp_path)
    t0 = time.monotonic()
    out = acc.save_state(params=_params(), blocking=False)
    returned_after = time.monotonic() - t0
    assert started.wait(5.0)
    assert returned_after < 0.5  # did not wait out the 0.5s writer
    assert not is_committed_checkpoint(out)  # still in flight
    acc.wait_for_checkpoint()
    assert is_committed_checkpoint(out)
    acc.end_training()


def test_backpressure_blocks_second_save_until_commit(tmp_path, monkeypatch):
    """max_in_flight=1: a second async save_state blocks until the first
    commits (bounding host RAM to one extra state copy), then proceeds."""
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit
    delay = 0.4

    def slow(snap, heartbeat=None):
        time.sleep(delay)
        return real(snap, heartbeat=heartbeat)

    monkeypatch.setattr(checkpointing, "write_and_commit", slow)
    acc = _auto_acc(tmp_path, max_in_flight=1)
    out1 = acc.save_state(params=_params(1.0), blocking=False)
    t0 = time.monotonic()
    out2 = acc.save_state(params=_params(2.0), blocking=False)
    blocked = time.monotonic() - t0
    # the second call waited out (most of) the first write
    assert blocked > delay * 0.5
    assert is_committed_checkpoint(out1)  # first committed before second ran
    acc.wait_for_checkpoint()
    assert is_committed_checkpoint(out2)
    acc.end_training()


def test_blocking_save_drains_pending_async_saves(tmp_path, monkeypatch):
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit

    def slow(snap, heartbeat=None):
        time.sleep(0.3)
        return real(snap, heartbeat=heartbeat)

    monkeypatch.setattr(checkpointing, "write_and_commit", slow)
    acc = _auto_acc(tmp_path)
    out1 = acc.save_state(params=_params(1.0), blocking=False)
    out2 = acc.save_state(params=_params(2.0), blocking=True)
    # call order == commit order, both durable when the blocking call returns
    assert is_committed_checkpoint(out1) and is_committed_checkpoint(out2)
    acc.end_training()


def test_writer_error_surfaces_on_wait(tmp_path, monkeypatch):
    from accelerate_tpu_torch import checkpointing

    def boom(snap, heartbeat=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(checkpointing, "write_and_commit", boom)
    acc = _auto_acc(tmp_path)
    acc.save_state(params=_params(), blocking=False)
    with pytest.raises(RuntimeError, match="background checkpoint save") as exc:
        acc.wait_for_checkpoint()
    assert isinstance(exc.value.__cause__, OSError)
    # manager is usable again afterwards
    monkeypatch.undo()
    out = acc.save_state(params=_params(5.0), blocking=False)
    acc.wait_for_checkpoint()
    assert is_committed_checkpoint(out)
    acc.end_training()


def test_writer_error_does_not_leak_backpressure_slot(tmp_path, monkeypatch):
    """A parked writer error raised out of save_state must give the
    back-pressure slot back — with max_in_flight=1 a leaked slot deadlocks
    every later async save."""
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit

    def boom(snap, heartbeat=None):
        raise OSError("disk on fire")

    monkeypatch.setattr(checkpointing, "write_and_commit", boom)
    acc = _auto_acc(tmp_path, max_in_flight=1)
    acc.save_state(params=_params(), blocking=False)
    # wait for the failure to park, then the error surfaces from save_state
    deadline = time.monotonic() + 5.0
    while acc._checkpoint_manager.pending() and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        acc.save_state(params=_params(2.0), blocking=False)
    # the slot came back: a healthy writer saves without blocking forever
    monkeypatch.setattr(checkpointing, "write_and_commit", real)
    out = acc.save_state(params=_params(3.0), blocking=False)
    acc.wait_for_checkpoint(timeout=10.0)
    assert is_committed_checkpoint(out)
    acc.end_training()


def test_end_training_drains_inflight_save(tmp_path, monkeypatch):
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit

    def slow(snap, heartbeat=None):
        time.sleep(0.3)
        return real(snap, heartbeat=heartbeat)

    monkeypatch.setattr(checkpointing, "write_and_commit", slow)
    acc = _auto_acc(tmp_path)
    out = acc.save_state(params=_params(), blocking=False)
    acc.end_training()
    assert is_committed_checkpoint(out)


def test_async_mid_epoch_resume_matches_sync(tmp_path):
    """An async save at step k must reproduce the exact batch stream a sync
    save at step k reproduces: the dataloader snapshot is taken at call time,
    not at write time."""

    class RangeDS:
        def __len__(self):
            return 128  # 8 steps

        def __getitem__(self, i):
            return {"x": np.full((4,), i, np.float32)}

    def run(blocking):
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True)
        dl = acc.prepare(DataLoader(RangeDS(), batch_size=16, shuffle=True, seed=11))
        it = iter(dl)
        for _ in range(3):
            next(it)
        out = acc.save_state(
            str(tmp_path / f"ck_{blocking}"), params=_params(), blocking=blocking
        )
        acc.wait_for_checkpoint()
        tail_live = [np.asarray(b["x"]).copy() for b in it]
        acc.end_training()
        # fresh process-alike: new accelerator + loader, restore, replay
        AcceleratorState._reset_state(reset_partial_state=True)
        acc2 = Accelerator(cpu=True)
        dl2 = acc2.prepare(DataLoader(RangeDS(), batch_size=16, shuffle=True, seed=11))
        acc2.load_state(out, params=_params())
        tail_resumed = [np.asarray(b["x"]).copy() for b in dl2]
        acc2.end_training()
        return tail_live, tail_resumed

    sync_live, sync_resumed = run(blocking=True)
    async_live, async_resumed = run(blocking=False)
    assert len(sync_resumed) == len(async_resumed) == len(sync_live)
    for a, b in zip(sync_resumed, async_resumed):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(async_live, async_resumed):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# rotation


def test_rotation_runs_post_commit_and_skips_staging(tmp_path):
    acc = _auto_acc(tmp_path, total_limit=2, async_save=True)
    root = tmp_path / "checkpoints"
    # a leftover staging dir from a crashed run must neither count toward the
    # limit nor survive the next save (it is torn, uncommitted garbage)
    (root / "checkpoint_90.tmp").mkdir(parents=True)
    (root / "checkpoint_90.tmp" / "model.npz").write_bytes(b"torn")
    for i in range(4):
        acc.save_state(params=_params(float(i)))
    acc.wait_for_checkpoint()
    acc.end_training()
    assert sorted(os.listdir(root)) == ["checkpoint_2", "checkpoint_3"]


def test_rotation_never_deletes_last_committed(tmp_path):
    acc = _auto_acc(tmp_path, total_limit=1)
    root = tmp_path / "checkpoints"
    acc.save_state(params=_params(1.0))
    acc.save_state(params=_params(2.0))
    # simulate checkpoint_1 torn post-commit (marker gone): rotation for the
    # next save must still keep the newest COMMITTED dir available
    os.remove(root / "checkpoint_1" / COMMITTED_MARKER)
    acc.save_state(params=_params(3.0))
    survivors = sorted(os.listdir(root))
    assert "checkpoint_2" in survivors
    assert is_committed_checkpoint(str(root / "checkpoint_2"))
    acc.end_training()


# ---------------------------------------------------------------------------
# crash consistency


def test_load_ignores_uncommitted_newest_dir(tmp_path):
    acc = _auto_acc(tmp_path)
    acc.save_state(params=_params(1.0))
    out2 = acc.save_state(params=_params(2.0))
    os.remove(os.path.join(out2, COMMITTED_MARKER))  # torn newest
    restored = acc.load_state(params=_params(0.0))
    np.testing.assert_allclose(np.asarray(restored["w"]), 1.0)
    acc.end_training()


_CRASH_SCRIPT = """
import os, sys
import numpy as np
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration

d = sys.argv[1]
acc = Accelerator(
    cpu=True,
    project_config=ProjectConfiguration(project_dir=d, automatic_checkpoint_naming=True),
)
params = {"w": np.full((64, 8), 1.0, np.float32)}
acc.save_state(params=params)  # checkpoint_0: committed
os.environ["ACCELERATE_CKPT_CRASH_POINT"] = sys.argv[2]
acc.save_state(params={"w": np.full((64, 8), 2.0, np.float32)}, blocking=False)
acc.wait_for_checkpoint()  # killed before this returns
print("UNREACHABLE")
"""


def _run_crash_child(tmp_path, point):
    script = tmp_path / "crash_child.py"
    script.write_text(_CRASH_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("ACCELERATE_CKPT_CRASH_POINT", None)
    res = subprocess.run(
        [sys.executable, str(script), str(tmp_path), point],
        capture_output=True, text=True, timeout=240, env=env,
    )
    assert res.returncode == -9, (res.returncode, res.stdout, res.stderr[-2000:])
    assert "UNREACHABLE" not in res.stdout


def test_kill9_mid_write_resumes_from_previous_commit(tmp_path):
    """kill -9 while the background writer is mid-file: the torn save is
    invisible to load_state (resumes from the previous committed dir) and the
    partial .tmp staging dir is cleaned up by the next save."""
    _run_crash_child(tmp_path, "mid_write")
    root = tmp_path / "checkpoints"
    assert (root / "checkpoint_1.tmp").is_dir()  # partial staging left behind
    assert not (root / "checkpoint_1.tmp" / COMMITTED_MARKER).exists()

    acc = _auto_acc(tmp_path)
    restored = acc.load_state(params={"w": np.zeros((64, 8), np.float32)})
    np.testing.assert_allclose(np.asarray(restored["w"]), 1.0)  # checkpoint_0
    # next save sweeps the torn staging dir
    acc.save_state(params={"w": np.full((64, 8), 3.0, np.float32)})
    assert not (root / "checkpoint_1.tmp").exists()
    acc.end_training()


def test_kill9_between_marker_and_rename_repairs_on_load(tmp_path):
    """kill -9 after the _COMMITTED manifest but before the atomic rename:
    the staging dir is fully durable — the next load finishes the rename and
    resumes from the NEW checkpoint."""
    _run_crash_child(tmp_path, "before_replace")
    root = tmp_path / "checkpoints"
    assert (root / "checkpoint_1.tmp" / COMMITTED_MARKER).exists()

    acc = _auto_acc(tmp_path)
    restored = acc.load_state(params={"w": np.zeros((64, 8), np.float32)})
    np.testing.assert_allclose(np.asarray(restored["w"]), 2.0)  # repaired ckpt_1
    assert (root / "checkpoint_1").is_dir()
    assert not (root / "checkpoint_1.tmp").exists()
    acc.end_training()


# ---------------------------------------------------------------------------
# corruption detection


def test_corrupt_bin_chunk_raises_with_filename(tmp_path):
    acc = Accelerator(cpu=True)
    params = {"w": torch.arange(64, dtype=torch.float32).reshape(16, 4)}
    out = acc.save_state(str(tmp_path / "ck"), params=params, sharded=True)
    index_file = next(
        os.path.join(out, n)
        for n in os.listdir(out)
        if n.startswith("model-shard-") and n.endswith(".index.json")
    )
    index = json.load(open(index_file))
    chunk = max(
        (c for meta in index["leaves"].values() for c in meta["chunks"]),
        key=lambda c: c["nbytes"],
    )
    bin_file = index_file[: -len(".index.json")] + ".bin"
    # flip a byte INSIDE a recorded chunk (not alignment padding)
    with open(bin_file, "r+b") as f:
        f.seek(chunk["offset"] + 1)
        byte = f.read(1)
        f.seek(chunk["offset"] + 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError) as exc:
        acc.load_state(out, params=params)
    assert exc.value.path == bin_file
    acc.end_training()


def test_torn_npz_raises_corrupt_error(tmp_path):
    acc = Accelerator(cpu=True)
    out = acc.save_state(str(tmp_path / "ck"), params=_params(1.0))
    npz = os.path.join(out, "model.npz")
    size = os.path.getsize(npz)
    # torn write: same-length zeros over the tail (manifest size still matches)
    with open(npz, "r+b") as f:
        f.seek(size // 2)
        f.write(b"\x00" * (size - size // 2))
    with pytest.raises(CheckpointCorruptError) as exc:
        acc.load_state(out, params=_params(0.0))
    assert exc.value.path == npz
    acc.end_training()


def test_manifest_size_mismatch_raises(tmp_path):
    acc = Accelerator(cpu=True)
    out = acc.save_state(str(tmp_path / "ck"), params=_params(1.0))
    npz = os.path.join(out, "model.npz")
    with open(npz, "ab") as f:
        f.write(b"junk")  # post-commit truncation/append tampering
    with pytest.raises(CheckpointCorruptError):
        acc.load_state(out, params=_params(0.0))
    acc.end_training()


def test_find_latest_checkpoint_repairs_and_prefers_committed(tmp_path):
    acc = _auto_acc(tmp_path)
    out0 = acc.save_state(params=_params(1.0))
    # fabricate an interrupted commit for checkpoint_1: committed staging dir
    root = str(tmp_path / "checkpoints")
    import shutil

    shutil.copytree(out0, os.path.join(root, "checkpoint_1.tmp"))
    latest = find_latest_checkpoint(root)
    assert latest == os.path.join(root, "checkpoint_1")  # repair finished it
    assert is_committed_checkpoint(latest)
    acc.end_training()


def test_async_save_holds_the_values_at_the_call(tmp_path, monkeypatch):
    """The port's step updates params in place: an async save returns with
    its own host copy, so params changed right after it (while the writer
    is still held back) do not reach the committed file."""
    from accelerate_tpu_torch import checkpointing

    real = checkpointing.write_and_commit
    gate = threading.Event()

    def held(snap, heartbeat=None):
        gate.wait(5.0)
        return real(snap, heartbeat=heartbeat)

    monkeypatch.setattr(checkpointing, "write_and_commit", held)
    acc = Accelerator(cpu=True)
    params = acc.prepare({"w": torch.arange(64, dtype=torch.float32).reshape(16, 4)})
    out = acc.save_state(str(tmp_path / "ck"), blocking=False)
    with torch.no_grad():
        params["w"].mul_(-1.0)
    gate.set()
    acc.wait_for_checkpoint()
    with np.load(os.path.join(out, "model.npz")) as f:
        np.testing.assert_array_equal(f["w"], np.arange(64, dtype=np.float32).reshape(16, 4))
    acc.end_training()
