"""The host-side data pipeline in C++ (through ``ctypes``): the port of
``accelerate_tpu.native``.

``src/pipeline.cc`` is the JAX package's source, unchanged; it is built at
first use by :func:`~accelerate_tpu_torch.ops._build.build_host` (``$CXX``
or ``g++``, ``-O3 -std=c++17 -shared -fPIC -pthread``) into the package's
ignored ``_build/``, here and on the GPU hosts alike.

- :func:`parallel_collate` stacks N same-shape, same-dtype samples with a
  memcpy team (mixed shapes or dtypes take ``np.stack``'s promotion, as in
  the JAX package); ``out=`` writes into a given array, such as the numpy
  view of a pinned CPU tensor.
- :func:`gather_rows` is ``src[indices]`` by strided memcpy (empty,
  negative or out-of-range indices take numpy's indexing and its
  ``IndexError``, as in the JAX package).
- :class:`TokenDataset` mmaps a flat file of fixed-length token records.
- :class:`NativeDataLoader` assembles batches of it on C++ worker threads;
  the shuffle is the C++ loader's (``mt19937_64`` of ``seed + epoch``), so a
  seed gives the JAX package's order, and the epoch advances when an
  iterator starts.

The JAX package falls back to numpy when the library cannot be built. The
port does not: :func:`parallel_collate`, :func:`gather_rows`,
:class:`TokenDataset` and :class:`NativeDataLoader` raise with the
compiler's output. Only the loader's ``default_collate`` keeps the JAX
package's rule of never compiling on the hot path: it takes the library
once :func:`warm_build` has it loaded, ``np.stack`` (the same bytes) until
then.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

__all__ = [
    "NativeDataLoader",
    "TokenDataset",
    "gather_rows",
    "is_native_available",
    "is_native_ready",
    "parallel_collate",
    "warm_build",
]

_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None
_lock = threading.Lock()


def _declare(lib: ctypes.CDLL) -> None:
    P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.atpu_abi_version.restype = I32
    lib.atpu_collate.argtypes = [ctypes.POINTER(P), I64, I64, P, I32]
    lib.atpu_gather_rows.argtypes = [P, ctypes.POINTER(I64), I64, I64, P]
    lib.atpu_dataset_open.restype = P
    lib.atpu_dataset_open.argtypes = [ctypes.c_char_p, I64]
    lib.atpu_dataset_len.restype = I64
    lib.atpu_dataset_len.argtypes = [P]
    lib.atpu_dataset_close.argtypes = [P]
    lib.atpu_loader_new.restype = P
    lib.atpu_loader_new.argtypes = [P, I64, I32, ctypes.c_uint64, I32, I32, I32]
    lib.atpu_loader_num_batches.restype = I64
    lib.atpu_loader_num_batches.argtypes = [P]
    lib.atpu_loader_next.restype = I64
    lib.atpu_loader_next.argtypes = [P, P]
    lib.atpu_loader_next_epoch.argtypes = [P]
    lib.atpu_loader_free.argtypes = [P]


def _load() -> ctypes.CDLL:
    """The pipeline library, built and loaded once a process; raises (the
    same error on every later call) when it cannot be."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is None:
            try:
                from ..ops._build import build_host

                lib = ctypes.CDLL(str(build_host("pipeline")["path"]))
                _declare(lib)
                if lib.atpu_abi_version() != 1:
                    raise RuntimeError(f"pipeline library ABI {lib.atpu_abi_version()}, want 1")
                _lib = lib
                return lib
            except (OSError, RuntimeError) as e:
                _error = e
        raise RuntimeError(f"the native pipeline library is not available: {_error}") from _error


def is_native_available() -> bool:
    """True when the library builds and loads (building it if needed)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def is_native_ready() -> bool:
    """True only if the library is already loaded: never builds."""
    return _lib is not None


def warm_build() -> None:
    """Build and load the library on a background thread (once), so that a
    hot path finds it ready instead of compiling inline."""
    if _lib is not None or _error is not None:
        return
    threading.Thread(target=is_native_available, name="atpu-native-build", daemon=True).start()


def parallel_collate(samples: list, num_threads: int = 4,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Stack N same-shape, same-dtype arrays into ``(N, *shape)`` by the
    native memcpy team (into ``out`` when given: C-contiguous, of that shape
    and dtype). Mixed shapes or dtypes take ``np.stack``."""
    lib = _load()
    arrs = [np.ascontiguousarray(s) for s in samples]
    first = arrs[0]
    if any(a.shape != first.shape or a.dtype != first.dtype for a in arrs):
        return np.stack(arrs)
    shape = (len(arrs),) + first.shape
    if out is None:
        out = np.empty(shape, dtype=first.dtype)
    elif out.shape != shape or out.dtype != first.dtype or not out.flags.c_contiguous:
        raise ValueError(f"out is {out.shape} {out.dtype}, want a contiguous {shape} "
                         f"{first.dtype}")
    ptrs = (ctypes.c_void_p * len(arrs))(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrs])
    lib.atpu_collate(ptrs, len(arrs), first.nbytes, out.ctypes.data_as(ctypes.c_void_p),
                     num_threads)
    return out


def gather_rows(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``src[indices]`` for a C-contiguous ``src`` of one or more dims, by
    strided memcpy."""
    lib = _load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    # numpy gives empty, negative and out-of-range indices their meaning and
    # its IndexError; the memcpy would read outside src
    if len(src) == 0 or len(idx) == 0 or idx.min() < 0 or idx.max() >= len(src):
        return src[idx]
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    lib.atpu_gather_rows(src.ctypes.data_as(ctypes.c_void_p),
                         idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
                         src[0].nbytes, out.ctypes.data_as(ctypes.c_void_p))
    return out


class TokenDataset:
    """A memory-mapped file of fixed-length token records: ``seq_len``
    tokens of ``dtype`` a record, records back to back (a trailing partial
    record is not counted)."""

    def __init__(self, path: str, seq_len: int, dtype=np.uint16):
        self.path = path
        self.seq_len = int(seq_len)
        self.dtype = np.dtype(dtype)
        self.record_bytes = self.seq_len * self.dtype.itemsize
        self._lib = _load()
        self._handle = self._lib.atpu_dataset_open(str(path).encode(), self.record_bytes)
        if not self._handle:
            raise OSError(f"cannot memory-map {path!r} (missing, unreadable or empty)")
        self._len = int(self._lib.atpu_dataset_len(self._handle))
        self._mm = None

    def __len__(self) -> int:
        return self._len

    def _view(self) -> np.ndarray:
        """A numpy view of the records, for random access (the C++ side
        maps the file for the loader)."""
        if self._mm is None:
            mm = np.memmap(self.path, dtype=self.dtype, mode="r")
            self._mm = mm[: self._len * self.seq_len].reshape(self._len, self.seq_len)
        return self._mm

    def __getitem__(self, i: int) -> np.ndarray:
        return np.asarray(self._view()[i])

    def close(self) -> None:
        if self._handle:
            self._lib.atpu_dataset_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


class NativeDataLoader:
    """Batches of a :class:`TokenDataset` assembled by C++ worker threads:
    ``np.ndarray`` of ``(batch_size, seq_len)`` in an order fixed by
    ``seed`` (shuffled with ``shuffle``; without ``drop_last`` the last
    batch wraps around to the first records). Each ``iter()`` after the
    first starts the next epoch, even when the previous iterator was not
    run to its end."""

    def __init__(self, dataset: TokenDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, num_workers: int = 2,
                 prefetch_depth: int = 4):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self._lib = _load()
        self._epoch = 0
        self._started = False
        self._loader = self._lib.atpu_loader_new(
            dataset._handle, self.batch_size, int(shuffle), seed, int(drop_last), num_workers,
            prefetch_depth)
        if not self._loader:
            raise ValueError(f"cannot make a loader of batch {batch_size} over "
                             f"{len(dataset)} records")

    def __len__(self) -> int:
        return int(self._lib.atpu_loader_num_batches(self._loader))

    def __iter__(self):
        # the epoch advances when an iterator starts, so an iterator left
        # half read does not carry its position into the next epoch
        if self._started:
            self._epoch += 1
            self._lib.atpu_loader_next_epoch(self._loader)
        self._started = True
        out = np.empty((self.batch_size, self.dataset.seq_len), self.dataset.dtype)
        for _ in range(len(self)):
            if self._lib.atpu_loader_next(self._loader, out.ctypes.data_as(ctypes.c_void_p)) < 0:
                break
            yield out.copy()

    def close(self) -> None:
        if self._loader:
            self._lib.atpu_loader_free(self._loader)
            self._loader = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass
