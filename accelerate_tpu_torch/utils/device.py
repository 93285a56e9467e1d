"""Device resolution for the port's entry points.

Entry points default to the CUDA device and never drop to the CPU on their
own: a caller that wants the CPU (the CPU tests) says ``device="cpu"``.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch

__all__ = ["resolve_device", "gpu_info"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device with no GPU present raises
    :class:`RuntimeError`; ``"cpu"`` is honoured only when asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU "
            "(the port never falls back to it on its own)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def gpu_info() -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` reports them (first card), plus the
    raw line. Raises when ``nvidia-smi`` is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    res = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    line = res.stdout.strip().splitlines()[0]
    name, _, power = line.rpartition(",")
    return {"name": name.strip(), "power_limit": power.strip(), "line": line}
