"""The port's trackers, case for case the JAX package's
``tests/test_tracking.py`` (the JSONL tracker is the offline one; the
integrations whose client packages are not installed are checked for their
surface and skipped by ``filter_trackers``), and the JSONL files of the two
packages compared line for line, timestamps aside."""

import json
import os

import pytest

from accelerate_tpu_torch.tracking import (
    _AVAILABILITY,
    LOGGER_TYPE_TO_CLASS,
    GeneralTracker,
    JSONLTracker,
    filter_trackers,
)


def test_registry_covers_reference_integrations():
    """The reference ships 9 integrations (tracking.py:182-1226); all must have
    a counterpart class + availability probe here."""
    expected = {
        "tensorboard", "wandb", "mlflow", "comet_ml", "aim", "clearml",
        "dvclive", "swanlab", "trackio",
    }
    assert expected <= set(LOGGER_TYPE_TO_CLASS)
    assert expected <= set(_AVAILABILITY)
    for name, cls in LOGGER_TYPE_TO_CLASS.items():
        assert issubclass(cls, GeneralTracker)
        assert cls.name == name
        # the full API surface (reference GeneralTracker:143-181)
        for method in ("store_init_configuration", "log", "finish"):
            assert callable(getattr(cls, method)), (name, method)


def test_filter_trackers_skips_unavailable(caplog):
    # none of the heavy integrations are installed in this image — requesting
    # one must warn-and-skip, not raise (reference filter_trackers:1262)
    unavailable = [n for n in LOGGER_TYPE_TO_CLASS if not _AVAILABILITY[n]()]
    if not unavailable:  # pragma: no cover - all libs present
        return
    got = filter_trackers([unavailable[0]], project_name="run")
    assert got == []


def test_filter_trackers_unknown_name_raises(tmp_path):
    import pytest

    with pytest.raises(ValueError):
        filter_trackers(["definitely_not_a_tracker"], project_name="run")


@pytest.mark.smoke
def test_jsonl_tracker_roundtrip(tmp_path):
    tracker = JSONLTracker("run", logging_dir=str(tmp_path))
    tracker.store_init_configuration({"lr": 1e-3, "nested": {"bs": 8}})
    tracker.log({"loss": 1.5}, step=0)
    tracker.log({"loss": 0.5}, step=1)
    tracker.finish()
    lines = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    assert lines[0]["_type"] == "config" and lines[0]["lr"] == 1e-3
    assert [entry["loss"] for entry in lines[1:]] == [1.5, 0.5]
    assert [entry["step"] for entry in lines[1:]] == [0, 1]


def test_deferred_start_lifecycle(tmp_path):
    """Two-phase init (reference GeneralTracker.start tracking.py:142):
    construction is side-effect free; start() creates the run; logging before
    start() lazily starts."""
    tracker = JSONLTracker("run", logging_dir=str(tmp_path))
    assert not (tmp_path / "run.jsonl").exists()  # __init__ wrote nothing
    tracker.start()
    assert (tmp_path / "run.jsonl").exists()
    tracker.start()  # idempotent
    tracker.log({"a": 1}, step=0)
    tracker.finish()
    # lazy-start path: no explicit start() before log
    lazy = JSONLTracker("lazy", logging_dir=str(tmp_path))
    lazy.log({"b": 2})
    lazy.finish()
    assert (tmp_path / "lazy.jsonl").exists()
    # finish() on a never-started tracker is a harmless no-op
    JSONLTracker("unused", logging_dir=str(tmp_path)).finish()
    assert not (tmp_path / "unused.jsonl").exists()


def test_api_surface_includes_media_methods():
    for name, cls in LOGGER_TYPE_TO_CLASS.items():
        for method in ("start", "log_images", "log_table"):
            assert callable(getattr(cls, method)), (name, method)


def test_jsonl_log_images_writes_sidecars(tmp_path):
    import numpy as np

    tracker = JSONLTracker("run", logging_dir=str(tmp_path))
    imgs = [np.zeros((4, 4, 3), np.uint8), np.ones((4, 4, 3), np.uint8)]
    tracker.log_images({"samples": imgs}, step=3)
    tracker.finish()
    lines = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    entry = next(e for e in lines if e["_type"] == "images")
    assert entry["step"] == 3 and len(entry["samples"]) == 2
    back = np.load(entry["samples"][1]["path"])
    np.testing.assert_array_equal(back, imgs[1])


def test_jsonl_log_table_rows_and_dataframe(tmp_path):
    tracker = JSONLTracker("run", logging_dir=str(tmp_path))
    tracker.log_table("preds", columns=["text", "label"],
                      data=[["a", 0], ["b", 1]], step=1)
    tracker.finish()
    lines = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
    entry = next(e for e in lines if e["_type"] == "table")
    assert entry["name"] == "preds"
    assert entry["columns"] == ["text", "label"]
    assert entry["rows"] == [["a", 0], ["b", 1]]


def test_tensorboard_log_images(tmp_path):
    import numpy as np
    import pytest

    from accelerate_tpu_torch.tracking import _AVAILABILITY, TensorBoardTracker

    if not _AVAILABILITY["tensorboard"]():
        pytest.skip("tensorboard unavailable")
    tracker = TensorBoardTracker("run", logging_dir=str(tmp_path))
    tracker.start()
    imgs = np.random.default_rng(0).integers(0, 255, (2, 8, 8, 3)).astype(np.uint8)
    tracker.log_images({"samples": imgs}, step=0)
    tracker.log({"loss": 1.0}, step=0)
    tracker.finish()
    event_files = list((tmp_path / "run").glob("events*"))
    assert event_files and event_files[0].stat().st_size > 0


def test_base_tracker_media_methods_warn_not_raise():
    t = GeneralTracker("run")
    t.start()
    t.log_images({"x": []})  # warns, must not raise
    t.log_table("t", columns=["a"], data=[[1]])


def test_accelerator_log_images_and_table(tmp_path):
    import numpy as np

    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, log_with="jsonl", project_dir=str(tmp_path))
    acc.init_trackers("proj")
    acc.log_images({"img": [np.zeros((2, 2), np.uint8)]}, step=0)
    acc.log_table("tbl", columns=["k"], data=[["v"]], step=0)
    acc.end_training()
    text = (tmp_path / "proj.jsonl").read_text()
    assert '"_type": "images"' in text and '"_type": "table"' in text


def test_all_resolves_to_available_only():
    from accelerate_tpu_torch.utils.dataclasses import LoggerType

    got = filter_trackers(LoggerType.ALL, project_name="run", logging_dir="/tmp")
    names = {t.name for t in got}
    assert "jsonl" in names
    for t in got:
        t.finish()
    for name in names:
        assert _AVAILABILITY[name]()


def _lines(path, drop=("_time",)):
    return [{k: v for k, v in json.loads(line).items() if k not in drop}
            for line in path.read_text().splitlines()]


def test_jsonl_files_equal_the_jax_packages(tmp_path):
    """The same calls through both packages' JSONL trackers write the same
    lines, timestamps aside: the config (nested), scalar logs of Python,
    numpy and 0-d tensor values, images (the sidecar paths differ only in
    their directory) and a table."""
    import numpy as np
    import torch

    from accelerate_tpu.tracking import JSONLTracker as JJSONLTracker

    def drive(cls, directory, scalar):
        tracker = cls("run", logging_dir=str(directory))
        tracker.store_init_configuration({"lr": 1e-3, "nested": {"bs": 8}, "name": "x"})
        tracker.log({"loss": scalar(1.5), "acc": 0.25, "n": 3}, step=0)
        tracker.log({"loss": scalar(0.5)}, step=1)
        tracker.log_images({"samples": [np.arange(12, dtype=np.uint8).reshape(2, 2, 3)]},
                           step=1)
        tracker.log_table("preds", columns=["text", "label"], data=[["a", 0], ["b", 1]], step=2)
        tracker.finish()

    drive(JJSONLTracker, tmp_path / "jax", lambda v: np.float32(v))
    drive(JSONLTracker, tmp_path / "port", lambda v: torch.tensor(v))
    jax_lines, port_lines = _lines(tmp_path / "jax" / "run.jsonl"), \
        _lines(tmp_path / "port" / "run.jsonl")
    for entry in jax_lines + port_lines:
        for images in (v for v in entry.values() if isinstance(v, list) and v
                       and isinstance(v[0], dict) and "path" in v[0]):
            for image in images:
                image["path"] = os.path.basename(image["path"])
    assert port_lines == jax_lines
