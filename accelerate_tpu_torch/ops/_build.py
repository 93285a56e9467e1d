"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, named by a hash of its sources and flags
so that a stale library is rebuilt, inside ``accelerate_tpu_torch/_build/``
(ignored by git). Sources are compiled in parallel, one ``nvcc`` each.
Libraries are loaded with ``ctypes`` and every exported function gets
explicit ``argtypes``: ``c_void_p`` for each pointer and the stream, so no
pointer is cut to 32 bits. Importing this module needs no ``nvcc``; using a
kernel without one raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNELS", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: kernel source name -> {exported C function: argtypes}; every launcher
#: returns the ``cudaError_t`` of its launch as an int
KERNELS = {
    "paged_decode": {
        # q, k_pool, v_pool, tables, kv_lens, out,
        # B, H, Hkv, D, block_size, W, q_dtype, kv_dtype, scale, stream
        "paged_decode_launch": [_P] * 6 + [_I] * 8 + [_F, _P],
    },
    "paged_prefill": {
        # q, k_pool, v_pool, tables, q_positions, out,
        # B, S, H, Hkv, D, block_size, W, q_dtype, kv_dtype, scale, stream
        "paged_prefill_launch": [_P] * 6 + [_I] * 9 + [_F, _P],
    },
}

_LIBS: "dict[str, ctypes.CDLL]" = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, /usr/local/cuda and PATH): "
            "the CUDA kernels cannot be built on this machine"
        )
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> "dict[str, dict]":
    """Compile the named kernels (all by default) that have no up-to-date
    library, one ``nvcc`` per source, all started together. Returns
    ``{name: {"path", "seconds", "ptxas"}}`` (``seconds`` 0 and ``ptxas``
    empty when the library was already there). Raises on any failure."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    out: "dict[str, dict]" = {}
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "ptxas": ""}
            continue
        nvcc = nvcc or nvcc_path()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, path, time.perf_counter())
    failures = []
    for name, (proc, tmp, path, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": time.perf_counter() - t0, "ptxas": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it first if needed),
    with ``argtypes``/``restype`` declared for every launcher."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]["path"]))
        for fn, argtypes in KERNELS[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib
