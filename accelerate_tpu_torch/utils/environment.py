"""Environment-variable parsing and process-environment helpers: the port
of ``accelerate_tpu.utils.environment`` (the ``parse_*_from_env`` helpers,
``get_int_from_env``, ``patch_environment``, ``get_current_device_type``
and ``get_cpu_distributed_information``).

A launcher configures a run through environment variables. The port reads
both torchrun's (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and the JAX package's (``ACCELERATE_COORDINATOR_ADDRESS``,
``ACCELERATE_NUM_PROCESSES``, ``ACCELERATE_PROCESS_ID``,
``ACCELERATE_LOCAL_PROCESS_INDEX``), so one launcher drives either package.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Any, Optional

__all__ = [
    "get_cpu_distributed_information",
    "get_current_device_type",
    "get_int_from_env",
    "parse_choice_from_env",
    "parse_flag_from_env",
    "parse_int_from_env",
    "parse_optional_float_from_env",
    "parse_optional_int_from_env",
    "parse_seconds_from_env",
    "patch_environment",
    "str_to_bool",
]

_TRUE = {"1", "true", "yes", "y", "on"}
_FALSE = {"0", "false", "no", "n", "off", ""}


def str_to_bool(value: str) -> int:
    """A string as 1 or 0; raises on an unrecognised value."""
    value = value.lower().strip()
    if value in _TRUE:
        return 1
    if value in _FALSE:
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key)
    if value is None:
        return default
    try:
        return bool(str_to_bool(value))
    except ValueError:
        raise ValueError(f"If set, {key} must be yes or no, got {value!r}.")


def parse_choice_from_env(key: str, default: str = "no") -> str:
    return os.environ.get(key, str(default))


def parse_seconds_from_env(key: str, default: float = 0.0) -> float:
    """A duration as non-negative seconds; ``default`` when unset, blank or
    malformed."""
    raw = os.environ.get(key, "").strip()
    if not raw:
        return default
    try:
        return max(0.0, float(raw))
    except ValueError:
        return default


def parse_optional_int_from_env(key: str, default: Optional[int] = None) -> Optional[int]:
    """An integer; ``default`` (which may be ``None``) when unset, blank or
    malformed."""
    raw = os.environ.get(key, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def parse_int_from_env(key: str, default: int = 0) -> int:
    return parse_optional_int_from_env(key, default)


def parse_optional_float_from_env(key: str, default: Optional[float] = None) -> Optional[float]:
    raw = os.environ.get(key, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def get_int_from_env(keys, default: int) -> int:
    """The first of ``keys`` that is set, as an int."""
    if isinstance(keys, str):
        keys = [keys]
    for key in keys:
        value = os.environ.get(key)
        if value is not None:
            return int(value)
    return default


@contextmanager
def patch_environment(**kwargs: Any):
    """Set environment variables (keys upper-cased; ``None`` unsets) for the
    body, and restore the previous values after it."""
    saved: dict = {}
    for key, value in kwargs.items():
        key = key.upper()
        saved[key] = os.environ.get(key)
        if value is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = str(value)
    try:
        yield
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def get_current_device_type() -> str:
    """``"gpu"`` when CUDA is available, else ``"cpu"`` (the JAX package
    returns its backend's name: ``"tpu"``, ``"gpu"`` or ``"cpu"``)."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def get_cpu_distributed_information() -> dict:
    """``rank``, ``world_size``, ``local_rank`` and ``local_world_size``
    from the launcher's environment (the JAX package's names first, then
    torchrun's), or from the live :class:`~..state.PartialState` when one
    exists."""
    info = {
        "rank": get_int_from_env(("ACCELERATE_PROCESS_ID", "RANK"), 0),
        "world_size": get_int_from_env(("ACCELERATE_NUM_PROCESSES", "WORLD_SIZE"), 1),
        "local_rank": get_int_from_env(("ACCELERATE_LOCAL_PROCESS_INDEX", "LOCAL_RANK"), 0),
        "local_world_size": get_int_from_env(("LOCAL_WORLD_SIZE",), 1),
    }
    from ..state import PartialState

    if PartialState._shared_state:
        state = PartialState()
        info["rank"] = state.process_index
        info["world_size"] = state.num_processes
        info["local_rank"] = state.local_process_index
        if state.num_processes == 1:
            info["local_world_size"] = 1
        else:
            info["local_world_size"] = min(info["local_world_size"], state.num_processes)
    return info
