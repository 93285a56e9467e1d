"""Experiment trackers: the port of ``accelerate_tpu.tracking``.

:class:`JSONLTracker` needs nothing beyond the standard library: one JSON
object a line in ``<logging_dir>/<run>.jsonl`` (``log``, the init
``config``, ``log_images`` as ``.npy`` sidecars, ``log_table`` rows),
line for line the JAX package's. :class:`TensorBoardTracker` writes
through ``torch.utils.tensorboard`` (or ``tensorboardX``) where one is
installed. The other integrations (WandB, MLflow, CometML, Aim, ClearML,
DVCLive, SwanLab, Trackio) are the JAX package's classes over their client
packages; :func:`filter_trackers` skips, with a warning, every tracker
whose package is not installed, as the JAX package does.
"""

from __future__ import annotations

import importlib.util
import json
import logging
import os
import time
from functools import wraps
from typing import Any, Optional

from .utils.dataclasses import LoggerType

logger = logging.getLogger(__name__)

__all__ = [
    "AimTracker",
    "ClearMLTracker",
    "CometMLTracker",
    "DVCLiveTracker",
    "GeneralTracker",
    "JSONLTracker",
    "LOGGER_TYPE_TO_CLASS",
    "MLflowTracker",
    "SwanLabTracker",
    "TensorBoardTracker",
    "TrackioTracker",
    "WandBTracker",
    "filter_trackers",
    "get_available_trackers",
    "on_main_process",
]


def _is_main_process() -> bool:
    """The running state's main-process flag (rank 0 of a process group
    that no state joined; True alone), without making a state."""
    from .state import PartialState

    if PartialState._shared_state.get("initialized"):
        return PartialState().is_main_process
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _package_available(name: str) -> bool:
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def on_main_process(function):
    """Run only on the main process (HF accelerate ``tracking.py:77``)."""

    @wraps(function)
    def execute_on_main_process(self, *args, **kwargs):
        if _is_main_process():
            return function(self, *args, **kwargs)

    return execute_on_main_process


class GeneralTracker:
    """Base tracker API (HF accelerate ``GeneralTracker tracking.py:101``).

    Two-phase lifecycle (HF accelerate ``start:142``): ``__init__`` only records
    configuration; :meth:`start` performs the SDK/run initialization. The
    ``Accelerator`` calls ``start()`` from ``init_trackers``; direct users may
    skip it — every logging method lazily starts on first use."""

    main_process_only = True

    name: str = "general"
    requires_logging_directory: bool = False

    def __init__(self, run_name: str, **kwargs):
        self.run_name = run_name
        self._started = False

    def start(self) -> None:
        """Deferred (idempotent) initialization — the heavy SDK setup lives in
        ``_do_start`` so constructing a tracker stays side-effect free."""
        if getattr(self, "_started", False):
            return
        self._started = True
        if _is_main_process():
            self._do_start()

    def _do_start(self) -> None:
        pass

    def _ensure_started(self) -> None:
        self.start()

    @property
    def tracker(self):
        raise NotImplementedError

    def store_init_configuration(self, values: dict) -> None:
        pass

    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        pass

    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """Log named images/image-lists (HF accelerate e.g. ``tracking.py:272``).
        Trackers without image support warn and skip."""
        logger.warning(f"tracker {self.name!r} does not support log_images; skipping")

    def log_table(
        self,
        table_name: str,
        columns: Optional[list] = None,
        data: Optional[list] = None,
        dataframe: Any = None,
        step: Optional[int] = None,
        **kwargs,
    ) -> None:
        """Log a table by columns+data or dataframe (HF accelerate
        ``tracking.py:383``). Trackers without table support warn and skip."""
        logger.warning(f"tracker {self.name!r} does not support log_table; skipping")

    def finish(self) -> None:
        pass


def _table_rows(columns, data, dataframe):
    """Normalize (columns, data) | dataframe to (columns, rows-of-lists)."""
    if dataframe is not None:
        cols = [str(c) for c in dataframe.columns]
        return cols, dataframe.values.tolist()
    return list(columns or []), [list(r) for r in (data or [])]


class JSONLTracker(GeneralTracker):
    """Dependency-free tracker: one JSON object per line in ``<dir>/<run>.jsonl``."""

    name = "jsonl"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__(run_name)
        self._logging_dir = logging_dir

    def _do_start(self) -> None:
        os.makedirs(self._logging_dir, exist_ok=True)
        self.path = os.path.join(self._logging_dir, f"{self.run_name}.jsonl")
        self._file = open(self.path, "a")

    @property
    def tracker(self):
        self._ensure_started()
        return self._file

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self._write({"_type": "config", **_jsonable(values)})

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        entry = {"_type": "log", "_time": time.time(), **_jsonable(values)}
        if step is not None:
            entry["step"] = step
        self._write(entry)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """Images go to ``<dir>/<run>_media/*.npy`` sidecars; the jsonl records
        their paths and shapes (dependency-free — no image codec needed)."""
        import numpy as np

        self._ensure_started()
        media_dir = os.path.join(self._logging_dir, f"{self.run_name}_media")
        os.makedirs(media_dir, exist_ok=True)
        entry = {"_type": "images", "_time": time.time()}
        if step is not None:
            entry["step"] = step
        for k, imgs in values.items():
            paths = []
            for i, img in enumerate(imgs):
                arr = np.asarray(img)
                fname = f"{k.replace('/', '_')}_{step if step is not None else 'x'}_{i}.npy"
                np.save(os.path.join(media_dir, fname), arr)
                paths.append({"path": os.path.join(media_dir, fname), "shape": list(arr.shape)})
            entry[k] = paths
        self._write(entry)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None,
                  step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        cols, rows = _table_rows(columns, data, dataframe)
        entry = {"_type": "table", "name": table_name,
                 "columns": cols, "rows": _jsonable({"r": rows})["r"]}
        if step is not None:
            entry["step"] = step
        self._write(entry)

    def _write(self, obj: dict) -> None:
        self._file.write(json.dumps(obj) + "\n")
        self._file.flush()

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "_file", None):
            self._file.close()


class TensorBoardTracker(GeneralTracker):
    """HF accelerate ``tracking.py:182``."""

    name = "tensorboard"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__(run_name)
        self._logging_dir = logging_dir
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        try:
            from torch.utils import tensorboard

            self.writer = tensorboard.SummaryWriter(
                os.path.join(self._logging_dir, self.run_name), **self._init_kwargs
            )
        except ImportError:
            from tensorboardX import SummaryWriter

            self.writer = SummaryWriter(
                os.path.join(self._logging_dir, self.run_name), **self._init_kwargs
            )

    @property
    def tracker(self):
        self._ensure_started()
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.writer.add_hparams(_flatten_scalars(values), metric_dict={})
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        for k, v in _flatten_scalars(values).items():
            if isinstance(v, str):
                self.writer.add_text(k, v, global_step=step)
            else:
                self.writer.add_scalar(k, v, global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:272`` — ``SummaryWriter.add_images``;
        NHWC is detected and passed as ``dataformats`` unless given."""
        import numpy as np

        self._ensure_started()
        for k, v in values.items():
            arr = np.asarray(v)
            kw = dict(kwargs)
            if "dataformats" not in kw and arr.ndim == 4 and arr.shape[-1] in (1, 3, 4):
                kw["dataformats"] = "NHWC"
            self.writer.add_images(k, arr, global_step=step, **kw)
        self.writer.flush()

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "writer", None):
            self.writer.close()


class WandBTracker(GeneralTracker):
    """HF accelerate ``tracking.py:297``."""

    name = "wandb"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        import wandb

        self.run = wandb.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import wandb

        self._ensure_started()
        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:364`` — each value list becomes wandb.Image s."""
        import wandb

        self._ensure_started()
        for k, v in values.items():
            self.run.log({k: [wandb.Image(img) for img in v]}, step=step, **kwargs)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None,
                  step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:383`` — wandb.Table by columns+data or df."""
        import wandb

        self._ensure_started()
        table = wandb.Table(columns=columns, data=data, dataframe=dataframe)
        self.run.log({table_name: table}, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "run", None):
            self.run.finish()


class MLflowTracker(GeneralTracker):
    """HF accelerate ``tracking.py:696``."""

    name = "mlflow"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        import mlflow

        mlflow.set_experiment(self.run_name)
        self.run = mlflow.start_run(**self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import mlflow

        self._ensure_started()
        for k, v in _flatten_scalars(values).items():
            mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        import mlflow

        self._ensure_started()
        mlflow.log_metrics(
            {k: v for k, v in _flatten_scalars(values).items() if not isinstance(v, str)}, step=step
        )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """``mlflow.log_image`` per image, named ``<key>_<step>_<i>.png``."""
        import mlflow
        import numpy as np

        self._ensure_started()
        for k, v in values.items():
            for i, img in enumerate(v):
                fname = f"{k.replace('/', '_')}_{step if step is not None else 'x'}_{i}.png"
                mlflow.log_image(np.asarray(img), fname)

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None,
                  step: Optional[int] = None, **kwargs) -> None:
        """``mlflow.log_table`` from a dict or dataframe."""
        import mlflow

        self._ensure_started()
        if dataframe is not None:
            mlflow.log_table(dataframe, artifact_file=f"{table_name}.json")
        else:
            cols, rows = _table_rows(columns, data, None)
            payload = {c: [r[i] for r in rows] for i, c in enumerate(cols)}
            mlflow.log_table(payload, artifact_file=f"{table_name}.json")

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False):
            import mlflow

            mlflow.end_run()


class CometMLTracker(GeneralTracker):
    """HF accelerate ``tracking.py:499``."""

    name = "comet_ml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        from comet_ml import start

        self.experiment = start(project_name=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.experiment

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.experiment.log_parameters(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        if step is not None:
            self.experiment.set_step(step)
        for k, v in _flatten_scalars(values).items():
            if isinstance(v, str):
                self.experiment.log_other(k, v)
            else:
                self.experiment.log_metric(k, v, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        for k, v in values.items():
            for i, img in enumerate(v):
                self.experiment.log_image(img, name=f"{k}_{i}", step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "experiment", None):
            self.experiment.end()


class AimTracker(GeneralTracker):
    """HF accelerate ``tracking.py:593``."""

    name = "aim"
    requires_logging_directory = True

    @on_main_process
    def __init__(self, run_name: str, logging_dir: str = ".", **kwargs):
        super().__init__(run_name)
        self._logging_dir = logging_dir
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        from aim import Run

        self.writer = Run(repo=self._logging_dir, **self._init_kwargs)
        self.writer.name = self.run_name

    @property
    def tracker(self):
        self._ensure_started()
        return self.writer

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.writer["hparams"] = _jsonable(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        for k, v in _flatten_scalars(values).items():
            self.writer.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:657`` — aim.Image per value. Optional
        ``aim_image``/``track`` sub-dicts route kwargs to the Image ctor and
        ``Run.track`` respectively (same split HF accelerate exposes)."""
        import aim

        self._ensure_started()
        aim_image_kw = kwargs.pop("aim_image", {})
        track_kw = kwargs.pop("track", {})
        for k, v in values.items():
            self.writer.track(aim.Image(v, **aim_image_kw), name=k, step=step, **track_kw)

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "writer", None):
            self.writer.close()


class ClearMLTracker(GeneralTracker):
    """HF accelerate ``tracking.py:903``."""

    name = "clearml"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        from clearml import Task

        self.task = Task.init(project_name=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.task

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.task.connect_configuration(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        clearml_logger = self.task.get_logger()
        for k, v in _flatten_scalars(values).items():
            if isinstance(v, str):
                clearml_logger.report_text(f"{k}: {v}")
            elif step is None:
                clearml_logger.report_single_value(name=k, value=v, **kwargs)
            else:
                title, _, series = k.rpartition("/")
                clearml_logger.report_scalar(
                    title=title or k, series=series or k, value=v, iteration=step, **kwargs
                )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:989`` — ``Logger.report_image``."""
        self._ensure_started()
        clearml_logger = self.task.get_logger()
        for k, v in values.items():
            title, _, series = k.rpartition("/")
            for i, img in enumerate(v):
                clearml_logger.report_image(
                    title=title or k, series=f"{series or k}_{i}",
                    iteration=step, image=img, **kwargs
                )

    @on_main_process
    def log_table(self, table_name, columns=None, data=None, dataframe=None,
                  step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:1007`` — ``Logger.report_table``."""
        self._ensure_started()
        clearml_logger = self.task.get_logger()
        if dataframe is not None:
            payload = dataframe
        else:
            cols, rows = _table_rows(columns, data, None)
            payload = [cols] + rows  # first row = header, clearml convention
        title, _, series = table_name.rpartition("/")
        clearml_logger.report_table(
            title=title or table_name, series=series or table_name,
            iteration=step, table_plot=payload, **kwargs,
        )

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "task", None):
            self.task.close()


class DVCLiveTracker(GeneralTracker):
    """HF accelerate ``tracking.py:1061``."""

    name = "dvclive"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, live=None, **kwargs):
        super().__init__(run_name)
        self._live_arg = live
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        from dvclive import Live

        self.live = self._live_arg if self._live_arg is not None else Live(**self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.live

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.live.log_params(_flatten_scalars(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        if step is not None:
            self.live.step = step
        for k, v in _flatten_scalars(values).items():
            self.live.log_metric(k, v, **kwargs)
        self.live.next_step()

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            for i, img in enumerate(v):
                self.live.log_image(f"{k}_{i}.png", img, **kwargs)

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "live", None):
            self.live.end()


class SwanLabTracker(GeneralTracker):
    """HF accelerate ``tracking.py:1149``."""

    name = "swanlab"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        import swanlab

        self.run = swanlab.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        import swanlab

        self._ensure_started()
        swanlab.config.update(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        self._ensure_started()
        self.run.log(
            {k: v for k, v in _flatten_scalars(values).items() if not isinstance(v, str)},
            step=step,
        )

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """HF accelerate ``tracking.py:1220`` — swanlab.Image per value."""
        import swanlab

        self._ensure_started()
        for k, v in values.items():
            self.run.log({k: [swanlab.Image(img) for img in v]}, step=step, **kwargs)

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False):
            import swanlab

            swanlab.finish()


class TrackioTracker(GeneralTracker):
    """HF accelerate ``tracking.py:422``."""

    name = "trackio"
    requires_logging_directory = False

    @on_main_process
    def __init__(self, run_name: str, **kwargs):
        super().__init__(run_name)
        self._init_kwargs = kwargs

    def _do_start(self) -> None:
        import trackio

        self.run = trackio.init(project=self.run_name, **self._init_kwargs)

    @property
    def tracker(self):
        self._ensure_started()
        return self.run

    @on_main_process
    def store_init_configuration(self, values: dict) -> None:
        self._ensure_started()
        self.run.config.update(_jsonable(values))

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        # trackio's run.log has no step parameter (auto-incremented internally)
        # — HF accelerate drops it too (tracking.py:487)
        self._ensure_started()
        self.run.log(
            {k: v for k, v in _flatten_scalars(values).items() if not isinstance(v, str)},
            **kwargs,
        )

    @on_main_process
    def finish(self) -> None:
        if getattr(self, "_started", False) and getattr(self, "run", None):
            self.run.finish()


LOGGER_TYPE_TO_CLASS = {
    "jsonl": JSONLTracker,
    "tensorboard": TensorBoardTracker,
    "wandb": WandBTracker,
    "mlflow": MLflowTracker,
    "comet_ml": CometMLTracker,
    "aim": AimTracker,
    "clearml": ClearMLTracker,
    "dvclive": DVCLiveTracker,
    "swanlab": SwanLabTracker,
    "trackio": TrackioTracker,
}

_AVAILABILITY = {
    "jsonl": lambda: True,
    "tensorboard": lambda: _package_available("tensorboard") or _package_available("tensorboardX"),
    "wandb": lambda: _package_available("wandb"),
    "mlflow": lambda: _package_available("mlflow"),
    "comet_ml": lambda: _package_available("comet_ml"),
    "aim": lambda: _package_available("aim"),
    "clearml": lambda: _package_available("clearml"),
    "dvclive": lambda: _package_available("dvclive"),
    "swanlab": lambda: _package_available("swanlab"),
    "trackio": lambda: _package_available("trackio"),
}


def filter_trackers(
    log_with,
    project_name: str,
    logging_dir: Optional[str] = None,
    config: Optional[dict] = None,
    init_kwargs: Optional[dict] = None,
) -> list[GeneralTracker]:
    """Resolve requested trackers to available instances (HF accelerate
    ``filter_trackers:1262``)."""
    if log_with is None:
        return []
    if not isinstance(log_with, (list, tuple)):
        log_with = [log_with]
    names: list[str] = []
    instances: list[GeneralTracker] = []
    for entry in log_with:
        if isinstance(entry, GeneralTracker):
            entry.start()  # two-phase init; idempotent for pre-started ones
            instances.append(entry)
            continue
        value = str(entry)
        if value == str(LoggerType.ALL):
            names.extend(get_available_trackers())
        else:
            names.append(value)
    for name in dict.fromkeys(names):
        if name not in LOGGER_TYPE_TO_CLASS:
            raise ValueError(f"unknown tracker {name!r}; options: {sorted(LOGGER_TYPE_TO_CLASS)}")
        if not _AVAILABILITY[name]():
            logger.warning(f"tracker {name!r} requested but its library is unavailable; skipping")
            continue
        cls = LOGGER_TYPE_TO_CLASS[name]
        kwargs = dict((init_kwargs or {}).get(name, {}))
        if cls.requires_logging_directory:
            kwargs.setdefault("logging_dir", logging_dir or ".")
        tracker = cls(project_name, **kwargs)
        tracker.start()  # two-phase init (HF accelerate Accelerator calls start())
        if config:
            tracker.store_init_configuration(config)
        instances.append(tracker)
    return instances


def _jsonable(values: dict) -> dict:
    import numpy as np

    def conv(v):
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()
        if isinstance(v, (np.floating, np.integer)):
            return v.item()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        return str(v)

    return {k: conv(v) for k, v in values.items()}


def _flatten_scalars(values: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in values.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_scalars(v, prefix=f"{key}/"))
        else:
            v = v.item() if hasattr(v, "item") and getattr(v, "ndim", 1) == 0 else v
            if isinstance(v, (int, float, str, bool)):
                flat[key] = v
    return flat


def get_available_trackers() -> list[str]:
    """Names of tracker integrations whose libraries are importable
    (HF accelerate ``get_available_trackers``)."""
    return [name for name in LOGGER_TYPE_TO_CLASS if _AVAILABILITY[name]()]
