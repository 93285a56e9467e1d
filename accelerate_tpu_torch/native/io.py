"""Chunked file IO in C++ (through ``ctypes``): the byte-moving layer under
sharded checkpoints, the port of ``accelerate_tpu.native.io``.

``src/io.cc`` is the JAX package's source, unchanged: a team of threads
``pwrite``s (or ``pread``s) a list of chunks at given offsets of one file
with the GIL released, with a CRC32 (zlib's) of each chunk. It is built at
first use by :func:`~accelerate_tpu_torch.ops._build.build_host` beside
the pipeline library. The JAX package falls back to Python file IO when no
compiler is there; the port does not: a failed build raises with the
compiler's output.

The format belongs to the caller (:mod:`~accelerate_tpu_torch.
sharded_checkpoint`): one flat file per process, chunks at 64-byte-aligned
offsets, the layout in the caller's JSON index.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["ALIGN", "plan_layout", "read_chunks", "write_chunks"]

ALIGN = 64

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _default_threads() -> int:
    """The thread team's size: ``ACCELERATE_TPU_IO_THREADS``, 1 by default
    (concurrent writes to one local disk at different offsets thrash; a
    parallel filesystem scales with threads)."""
    try:
        return max(1, int(os.environ.get("ACCELERATE_TPU_IO_THREADS", "1")))
    except ValueError:
        return 1


def _load() -> ctypes.CDLL:
    """The IO library, built and loaded once a process; raises with the
    compiler's output when it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops._build import build_host

            lib = ctypes.CDLL(str(build_host("io")["path"]))
            P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            for fn in (lib.atpu_io_write_chunks, lib.atpu_io_read_chunks):
                fn.restype = I32
                fn.argtypes = [ctypes.c_char_p, I64, ctypes.POINTER(P), ctypes.POINTER(I64),
                               ctypes.POINTER(I64), ctypes.POINTER(ctypes.c_uint32), I32]
            _lib = lib
        return _lib


def plan_layout(nbytes_list: Sequence[int]) -> tuple:
    """64-byte-aligned offsets of a chunk sequence: ``(offsets, total)``."""
    offsets, pos = [], 0
    for nb in nbytes_list:
        offsets.append(pos)
        pos += int(nb)
        pos = (pos + ALIGN - 1) // ALIGN * ALIGN
    return offsets, pos


def write_chunks(path: str, arrays: Sequence[np.ndarray],
                 num_threads: Optional[int] = None) -> tuple:
    """Write ``arrays`` as raw chunks into ``path`` (created or truncated,
    then fsync'd); returns ``(offsets, nbytes, crc32s)``."""
    lib = _load()
    num_threads = _default_threads() if num_threads is None else num_threads
    arrays = [np.ascontiguousarray(a) for a in arrays]
    sizes = [a.nbytes for a in arrays]
    offsets, _ = plan_layout(sizes)
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    c_sizes = (ctypes.c_int64 * n)(*sizes)
    c_offsets = (ctypes.c_int64 * n)(*offsets)
    crcs = (ctypes.c_uint32 * n)()
    rc = lib.atpu_io_write_chunks(os.fsencode(path), n, srcs, c_sizes, c_offsets, crcs,
                                  num_threads)
    if rc != 0:
        raise OSError(f"native chunk write to {path} failed (open, ftruncate, pwrite or fsync)")
    return offsets, sizes, list(crcs)


def read_chunks(path: str, offsets: Sequence[int], nbytes: Sequence[int],
                crcs: Optional[Sequence[int]] = None,
                num_threads: Optional[int] = None) -> list:
    """Read raw chunks back as uint8 arrays, each checked against its CRC32
    when ``crcs`` is given: ``ValueError`` on a mismatch, ``OSError`` on a
    short read or a file that cannot be opened."""
    lib = _load()
    num_threads = _default_threads() if num_threads is None else num_threads
    n = len(offsets)
    bufs = [np.empty(int(nb), dtype=np.uint8) for nb in nbytes]
    dsts = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    c_sizes = (ctypes.c_int64 * n)(*[int(x) for x in nbytes])
    c_offsets = (ctypes.c_int64 * n)(*[int(x) for x in offsets])
    c_crcs = (ctypes.c_uint32 * n)(*[int(c) for c in crcs]) if crcs is not None else None
    rc = lib.atpu_io_read_chunks(os.fsencode(path), n, dsts, c_sizes, c_offsets, c_crcs,
                                 num_threads)
    if rc == -2:
        raise ValueError(f"checkpoint chunk CRC mismatch in {path} (corrupt file?)")
    if rc != 0:
        raise OSError(f"short read or open failure in {path}")
    return bufs
