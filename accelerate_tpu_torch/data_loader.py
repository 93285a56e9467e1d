"""Reproducible data loading across processes: the port of
``accelerate_tpu.data_loader``.

The samplers are the JAX package's index math, written again for this
package: a shuffled epoch is ``numpy.random.default_rng(seed +
epoch).permutation``, so the batch order is identical to the JAX
package's. ``DataLoader`` collates map-style samples into numpy batches:
a leaf of ``_PIN_MIN_BYTES`` (1 MiB) or more through the native memcpy
team (:func:`~.native.parallel_collate`) once the library is loaded (the
loader warms its build at construction), on a CUDA host straight into
pinned memory, which the prepared loader's copy to the card then reads
without pinning again; smaller leaves through ``np.stack``, the same
bytes.

:func:`prepare_data_loader` shards the loader over the mesh's
data-parallel rows (``dp_replicate × dp_shard``; ranks that differ only
in ``tp`` or ``ep`` read the same rows). The JAX package gives each host a
block of rows for each of its devices and assembles a global array; the
port runs one process per device, so each process reads the rows of its
own data-parallel row (:class:`BatchSamplerShard`, with ``split_batches``
and ``even_batches``) and that block is the rank's ``Shard(0)`` of the
global batch (:class:`GlobalBatchAssembler`), on the rank's device.
:class:`DataLoaderDispatcher` reads on rank 0 only and broadcasts: the
first batch of a structure as an object, every later one as one raw byte
tensor, a short final batch padded to the signature's rows and trimmed by
``gather_for_metrics``. A ``torch.utils.data.DataLoader`` is treated as the
JAX package treats it: a plain map-style one is rebuilt as this module's
loader (its ``RandomSampler`` as a :class:`SeedableRandomSampler` of
``data_seed``) and resharded, a stateful one is kept (and dispatched from
rank 0 under data parallelism), and one with a custom sampler or an
iterable dataset is iterated as it is.

A prepared loader resumes (``state_dict``/``load_state_dict``,
:func:`skip_first_batches`, :class:`SkipDataLoader`), keeps the state of a
stateful inner loader, synchronizes the host generators named in
``rng_types`` at the start of each epoch, and reads ``prefetch_depth``
batches ahead (2 by default) on a producer thread; on a CUDA device that
thread copies each batch on the loader's side stream (a leaf of
``_PIN_MIN_BYTES`` or more from pinned memory), and the batch is made
ready (an event) when it is yielded. ``prefetch_depth=0`` is
the synchronous path.
"""

from __future__ import annotations

import math
import queue as _queue
import threading
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from .utils import operations
from .utils.operations import find_batch_size, recursively_apply, send_to_device

__all__ = [
    "BatchSampler",
    "BatchSamplerShard",
    "DataLoader",
    "DataLoaderAdapter",
    "DataLoaderDispatcher",
    "DataLoaderShard",
    "DataLoaderStateMixin",
    "GlobalBatchAssembler",
    "IterableDatasetShard",
    "SeedableRandomSampler",
    "SequentialSampler",
    "SkipBatchSampler",
    "SkipDataLoader",
    "as_stateful_dataloader",
    "default_collate",
    "get_sampler",
    "prepare_data_loader",
    "skip_first_batches",
    "stateful_dataloader_available",
]


# a leaf this large goes to the card from pinned memory; a smaller one is
# copied from pageable memory, which CUDA stages at once (pinning it
# would add an allocation and a host copy and hide nothing)
_PIN_MIN_BYTES = 1 << 20


def _pop_next(q: "_queue.Queue", thread: threading.Thread):
    """The producer's next item; raises if the producer died without one."""
    while True:
        try:
            return q.get(timeout=1.0)
        except _queue.Empty:
            if not thread.is_alive():
                try:  # its last item may have landed just after the timeout
                    return q.get_nowait()
                except _queue.Empty:
                    raise RuntimeError(
                        "prefetch producer thread died without a final item") from None


class SeedableRandomSampler:
    """Deterministic shuffling: permutation = f(seed, epoch)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()

    def state_dict(self) -> dict:
        return {"seed": self.seed, "epoch": self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.seed = state["seed"]
        self.epoch = state["epoch"]


class SequentialSampler:
    def __init__(self, data_source_len: int):
        self.data_source_len = data_source_len

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        yield from range(self.data_source_len)


class BatchSampler:
    """Group sample indices into batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[list]:
        batch: list = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


class BatchSamplerShard:
    """The batches (or batch slices) of shard ``shard_index`` of
    ``num_shards``. Without ``split_batches`` shard ``i`` takes batches
    ``i, i+n, …``; with ``even_batches`` the last round is completed from
    the epoch's first batches (and a short batch topped up from its first
    samples) so every shard yields as many equal batches. With
    ``split_batches`` every shard takes ``1/n`` of each batch."""

    def __init__(self, batch_sampler, num_shards: int, shard_index: int,
                 split_batches: bool = False, even_batches: bool = True):
        if split_batches and getattr(batch_sampler, "batch_size", None) is not None:
            if batch_sampler.batch_size % num_shards != 0:
                raise ValueError(
                    f"split_batches=True requires batch_size ({batch_sampler.batch_size}) "
                    f"divisible by num_shards ({num_shards})")
        self.batch_sampler = batch_sampler
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def _tail_size(self) -> Optional[int]:
        sampler = getattr(self.batch_sampler, "sampler", None)
        if sampler is None or self.batch_size is None:
            return None
        try:
            n = len(sampler)
        except TypeError:
            return None
        return n % self.batch_size

    def __len__(self) -> int:
        length = len(self.batch_sampler)
        if self.split_batches:
            if self.even_batches or self.drop_last:
                return length
            tail = self._tail_size()
            if tail is None or tail == 0 or self.batch_size is None:
                return length
            size = self.batch_size // self.num_shards
            return length - 1 + int(tail > size * self.shard_index)
        if self.drop_last:
            return length // self.num_shards
        if self.even_batches:
            return math.ceil(length / self.num_shards)
        return length // self.num_shards + int(self.shard_index < length % self.num_shards)

    def __iter__(self) -> Iterator[list]:
        if self.split_batches:
            yield from self._iter_with_split()
        else:
            yield from self._iter_with_no_split()

    def _iter_with_split(self) -> Iterator[list]:
        first_batch = None
        size = None
        for batch in self.batch_sampler:
            if first_batch is None:
                first_batch = batch
                size = (self.batch_size // self.num_shards if self.batch_size
                        else len(batch) // self.num_shards)
            chunk = batch[self.shard_index * size:(self.shard_index + 1) * size]
            if len(chunk) < size:
                if not self.even_batches:
                    if chunk:
                        yield chunk
                    continue
                while len(chunk) < size and first_batch:
                    chunk = (chunk + first_batch)[:size]
            if chunk:
                yield chunk

    def _iter_with_no_split(self) -> Iterator[list]:
        initial_batches: list = []
        window: list = []
        full_size: Optional[int] = None
        for batch in self.batch_sampler:
            if full_size is None:
                full_size = len(batch)
            if len(initial_batches) < self.num_shards:
                initial_batches.append(batch)
            if len(batch) < full_size:
                if self.drop_last:
                    break
                if self.even_batches:
                    pool = [i for b in initial_batches for i in b]
                    batch = (batch + pool * math.ceil(full_size / len(pool)))[:full_size]
            window.append(batch)
            if len(window) == self.num_shards:
                yield window[self.shard_index]
                window = []
        if not window or self.drop_last:
            return
        if not self.even_batches:
            if self.shard_index < len(window):
                yield window[self.shard_index]
            return
        pool = [i for b in initial_batches for i in b]
        i = 0
        while len(window) < self.num_shards:
            recycled = initial_batches[i % len(initial_batches)]
            if full_size and len(recycled) < full_size and pool:
                recycled = (recycled + pool * math.ceil(full_size / len(pool)))[:full_size]
            window.append(recycled[:full_size] if full_size else recycled)
            i += 1
        yield window[self.shard_index]


class IterableDatasetShard:
    """Round-robin sharding of an iterable dataset: of every
    ``batch_size * num_shards`` items, shard ``i`` takes the ``i``-th run of
    ``batch_size``; a short tail is dropped (``drop_last``), completed from
    the first window (``even_batches``) or cut."""

    def __init__(self, dataset: Iterable, batch_size: int, num_shards: int, shard_index: int,
                 drop_last: bool = False, even_batches: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.even_batches = even_batches

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        real_batch_size = self.batch_size * self.num_shards
        start = self.shard_index * self.batch_size
        first_window: Optional[list] = None
        window: list = []
        for item in self.dataset:
            window.append(item)
            if len(window) == real_batch_size:
                if first_window is None:
                    first_window = list(window)
                yield from window[start:start + self.batch_size]
                window = []
        if not window or self.drop_last:
            return
        if first_window is None:
            first_window = list(window)
        if self.even_batches:
            while len(window) < real_batch_size:
                window += first_window[:real_batch_size - len(window)]
        yield from window[start:start + self.batch_size]


def _pinned_out(shape: tuple, dtype: np.dtype) -> Optional[np.ndarray]:
    """The numpy view of a new pinned CPU tensor of ``shape`` and ``dtype``
    on a CUDA host (None elsewhere, or for a dtype torch does not hold)."""
    if not torch.cuda.is_available():
        return None
    try:
        torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None
    return torch.empty(shape, dtype=torch_dtype, pin_memory=True).numpy()


def default_collate(samples: list) -> Any:
    """Stack a list of samples (dicts, tuples, arrays, scalars) into a
    batch. A leaf of ``_PIN_MIN_BYTES`` or more in all goes through the
    native memcpy team once its library is loaded (never built here: the
    hot path does not compile), into pinned memory on a CUDA host; every
    other leaf through ``np.stack``, which gives the same bytes."""
    first = samples[0]
    if isinstance(first, dict):
        return type(first)((k, default_collate([s[k] for s in samples])) for k in first)
    if isinstance(first, (list, tuple)) and not isinstance(first, str):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    arrs = [np.asarray(s) for s in samples]
    a0 = arrs[0]
    if a0.nbytes * len(arrs) >= _PIN_MIN_BYTES:
        from .native import is_native_ready, parallel_collate

        if is_native_ready():
            out = None
            if all(a.shape == a0.shape and a.dtype == a0.dtype for a in arrs):
                out = _pinned_out((len(arrs),) + a0.shape, a0.dtype)
            return parallel_collate(arrs, out=out)
    return np.stack(arrs)


class DataLoader:
    """Map-style loader: ``dataset[i]`` → sample; batches collated to numpy.
    ``dataset`` needs ``__len__`` and ``__getitem__``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 batch_sampler=None, sampler=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate
        from .native import warm_build

        # the native library is built off this thread (once), so that the
        # first large collate finds it ready
        warm_build()
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
        else:
            if sampler is None:
                sampler = (SeedableRandomSampler(len(dataset), seed=seed) if shuffle
                           else SequentialSampler(len(dataset)))
            self.batch_sampler = BatchSampler(sampler, batch_size, drop_last)
            self.batch_size = batch_size

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def __iter__(self):
        for indices in self.batch_sampler:
            yield self.collate_fn([self.dataset[i] for i in indices])


_END = object()  # no batch left


class GlobalBatchAssembler:
    """The batch layout over the mesh: dim 0 split over ``(dp_replicate,
    dp_shard)``, the sequence dim (``seq_dim``) of every leaf of more dims
    than ``seq_dim`` over ``cp`` when that axis is split, else over ``sp``,
    and replicated over ``tp`` and ``ep``. Each process holds the rows of
    its own data-parallel row and its own chunk of the sequence: the rank's
    block of the global batch."""

    def __init__(self, mesh, device=None, seq_dim: int = 1):
        self.mesh = mesh
        self.device = device
        self.seq_dim = seq_dim
        sizes = dict(mesh.shape)
        self._seq_axis = mesh.sequence_axis
        self._dp_size = sizes.get("dp_replicate", 1) * sizes.get("dp_shard", 1)

    @property
    def dp_size(self) -> int:
        return self._dp_size

    def _dp_row(self, coords: dict) -> int:
        return coords.get("dp_replicate", 0) * self.mesh.shape.get("dp_shard", 1) + coords.get(
            "dp_shard", 0)

    def local_dp_rows(self) -> list:
        """The data-parallel rows this process reads: its own."""
        return [self._dp_row(self.mesh.coords)]

    def _seq_chunk(self, x):
        """This rank's chunk of ``x``'s sequence dim (``x`` whole when the
        sequence is not split or ``x`` has no such dim)."""
        if self._seq_axis is None or getattr(x, "ndim", 0) <= self.seq_dim:
            return x
        n, length = self.mesh.shape[self._seq_axis], x.shape[self.seq_dim]
        if length % n != 0:
            raise ValueError(f"sequence dim ({length}) not divisible by {self._seq_axis} "
                             f"size {n}")
        chunk = length // n
        start = self.mesh.sequence_span(chunk)[0]
        index = [slice(None)] * x.ndim
        index[self.seq_dim] = slice(start, start + chunk)
        return x[tuple(index)]

    def to_global(self, local_block):
        """The rank's block (its rows, and its chunk of the sequence when
        that is split) as tensors on the device."""
        if self._seq_axis is not None:
            local_block = recursively_apply(self._seq_chunk, local_block)
        return send_to_device(local_block, self.device)

    def local_block(self, global_batch):
        """This rank's rows of a whole global batch (every rank passes the
        same one)."""
        row = self.local_dp_rows()[0]

        def take(x):
            if getattr(x, "ndim", 0) == 0:
                return x
            if x.shape[0] % self._dp_size:
                raise ValueError(f"a global batch of {x.shape[0]} rows does not split over "
                                 f"{self._dp_size} data-parallel rows")
            per_row = x.shape[0] // self._dp_size
            return x[row * per_row:(row + 1) * per_row]

        return recursively_apply(take, global_batch)


def _to_numpy_batch(batch):
    def conv(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x

    return recursively_apply(conv, batch, test_type=lambda x: isinstance(x, torch.Tensor))


class DataLoaderShard:
    """A prepared loader: this process's batches, as tensors on ``device``.

    While it is iterated it is the :class:`~accelerate_tpu_torch.state.
    GradientState`'s active loader; it reads one batch ahead so that
    ``end_of_dataloader`` is already true while the last batch is in use,
    and ``remainder`` is then the real rows of the last global batch (the
    dataset's length modulo the global batch size) so that
    ``gather_for_metrics`` can drop the rows ``even_batches`` repeated.

    ``rng_types`` are synchronized from rank 0 at the start of each epoch;
    ``skip_batches`` skips the first batches of the next epoch only (a
    resume). ``state_dict`` is ``batches_seen``, ``iteration`` and the state
    of the innermost stateful sampler, or, when the wrapped loader keeps
    state of its own (``state_dict``/``load_state_dict``), that loader's
    state as it was after the batch last yielded, tagged with
    ``_iterator_finished``. With ``prefetch_depth > 0`` a producer thread
    fetches, processes and (on CUDA, on the loader's side stream) copies
    up to that many batches ahead; each item carries the snapshot
    taken after its fetch, and the flags are applied when it is yielded, so
    the batches, flags and states are those of ``prefetch_depth=0``."""

    def __init__(self, dataloader, device=None, assembler: Optional[GlobalBatchAssembler] = None,
                 total_dataset_length: Optional[int] = None,
                 global_batch_size: Optional[int] = None,
                 rng_types: Optional[Sequence[str]] = None, synchronized_generator=None,
                 skip_batches: int = 0, prefetch_depth: int = 2, non_blocking: bool = True):
        from .state import GradientState

        self.base_dataloader = dataloader
        self.device = device
        self.assembler = assembler
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self.skip_batches = skip_batches
        self.prefetch_depth = max(0, int(prefetch_depth))
        self.non_blocking = non_blocking
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1
        self.iteration = 0  # the epoch counter
        self._batches_seen = 0
        if total_dataset_length is None:
            dataset = getattr(dataloader, "dataset", None)
            if dataset is not None and hasattr(dataset, "__len__"):
                total_dataset_length = len(dataset)
        self.total_dataset_length = total_dataset_length
        if global_batch_size is None:
            global_batch_size = getattr(dataloader, "batch_size", None)
        self.global_batch_size = global_batch_size
        # a wrapped loader with state of its own keeps it: state_dict serves a
        # snapshot taken at the right yield, load_state_dict hands it inward
        self._stateful_inner = (hasattr(dataloader, "state_dict")
                                and hasattr(dataloader, "load_state_dict"))
        self._inner_snapshot: Optional[dict] = None
        self._inner_finished = False
        self._side_stream = None  # made on the first CUDA epoch, kept for the next

    @property
    def batch_size(self):
        return getattr(self.base_dataloader, "batch_size", None)

    @property
    def dataset(self):
        return getattr(self.base_dataloader, "dataset", None)

    def set_epoch(self, epoch: int) -> None:
        self.iteration = epoch
        if hasattr(self.base_dataloader, "set_epoch"):
            self.base_dataloader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base_dataloader) - self.skip_batches

    # -- resume --
    def _find_stateful_sampler(self):
        """The innermost object of the sampler chain with a ``state_dict``."""
        seen = set()
        node = getattr(self.base_dataloader, "batch_sampler", None)
        while node is not None and id(node) not in seen:
            seen.add(id(node))
            if hasattr(node, "state_dict"):
                return node
            node = next((getattr(node, a) for a in ("sampler", "batch_sampler")
                         if getattr(node, a, None) is not None), None)
        return None

    def state_dict(self) -> dict:
        if self._stateful_inner and self._snapshots_inner():
            snap = self._inner_snapshot
            if snap is None:  # not iterated yet: the inner loader's fresh state
                snap = self.base_dataloader.state_dict()
            state = dict(snap)
            state["_iterator_finished"] = self._inner_finished or self.end_of_dataloader
            return state
        state = {"batches_seen": self._batches_seen, "iteration": self.iteration}
        sampler = self._find_stateful_sampler()
        if sampler is not None:
            state["sampler"] = sampler.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        if self._stateful_inner and self._snapshots_inner():
            self._inner_finished = bool(state.get("_iterator_finished", False))
            self.end_of_dataloader = False
            # handed through whole: ``_iterator_finished`` is the inner
            # loader's own field (it starts the next epoch afresh)
            self.base_dataloader.load_state_dict(dict(state))
            snap = dict(state)
            snap.pop("_iterator_finished", None)  # tagged again when served
            self._inner_snapshot = snap
            return
        self.skip_batches = state.get("batches_seen", 0)
        self.iteration = state.get("iteration", 0)
        sampler = self._find_stateful_sampler()
        if sampler is not None and "sampler" in state:
            sampler.load_state_dict(state["sampler"])

    def _sync_rng(self) -> None:
        if self.rng_types:
            from .utils.random import synchronize_rng_states

            synchronize_rng_states(self.rng_types, self.synchronized_generator)

    # -- iteration hooks (the dispatcher overrides them) --
    def _iter_base(self):
        return iter(self.base_dataloader)

    def _fetch_batch(self, base_iter):
        return next(base_iter, _END)

    def _snapshots_inner(self) -> bool:
        """Whether this process may read the inner loader's state."""
        return self._stateful_inner

    def _effective_prefetch_depth(self) -> int:
        return self.prefetch_depth

    def _final_remainder(self, batch) -> int:
        if self.total_dataset_length is None:
            return -1
        global_bs = self.global_batch_size
        if not global_bs:
            rows = self.assembler.dp_size if self.assembler is not None else 1
            global_bs = (find_batch_size(batch) or 0) * rows
        return self.total_dataset_length % global_bs if global_bs else -1

    def _target_device(self):
        if self.assembler is not None:
            return self.assembler.device
        return self.device

    def _process(self, batch):
        if self.assembler is not None:
            return self.assembler.to_global(batch)
        return send_to_device(batch, self.device)

    def _stage(self, batch, stream):
        """``(batch on the device, event)``: on a CUDA side ``stream`` the
        arrays are copied there (pinned first from ``_PIN_MIN_BYTES``), and
        the event follows the copies; elsewhere :meth:`_process` and no
        event."""
        if stream is None:
            return self._process(batch), None
        from .hooks import _queue_copies

        dev = self._target_device()

        def put(x):
            if isinstance(x, torch.Tensor):
                t = x
            else:
                arr = np.asarray(x)
                if arr.dtype.kind not in "biuf":
                    return x
                t = torch.from_numpy(np.ascontiguousarray(arr))
            if t.device.type == "cpu" and t.nbytes >= _PIN_MIN_BYTES and not t.is_pinned():
                t = t.pin_memory()
            return t.to(dev, non_blocking=self.non_blocking)

        return _queue_copies(lambda: operations._tree_map(put, batch), stream)

    @staticmethod
    def _make_ready(placed, event, device):
        if event is None:
            return placed
        from .hooks import _ready

        leaves, _ = _flatten(placed)
        _ready({i: t for i, t in enumerate(leaves) if isinstance(t, torch.Tensor)}, event,
               device)
        return placed

    def __iter__(self):
        self._sync_rng()
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        self.remainder = -1
        self._inner_finished = False
        try:
            if self._effective_prefetch_depth() > 0:
                yield from self._iter_async()
            else:
                yield from self._iter_sync()
        finally:
            self.gradient_state._remove_dataloader(self)
            self.iteration += 1
            self.skip_batches = 0  # a resume skips in its first epoch only
            if self.end_of_dataloader:
                # a state saved after a finished epoch resumes at the next
                # epoch's first batch
                self._batches_seen = 0

    def _iter_sync(self):
        base_iter = self._iter_base()
        snapshots = self._snapshots_inner()
        current = self._fetch_batch(base_iter)
        n = 0
        while current is not _END:
            if snapshots:  # after `current` was read, before `nxt` is
                self._inner_snapshot = self.base_dataloader.state_dict()
            nxt = self._fetch_batch(base_iter)
            if n >= self.skip_batches:
                if nxt is _END:
                    self.end_of_dataloader = True
                    self.remainder = self._final_remainder(current)
                self._batches_seen = n + 1
                yield self._process(current)
            current = nxt
            n += 1

    def _iter_async(self):
        depth = self._effective_prefetch_depth()
        q: _queue.Queue = _queue.Queue(maxsize=depth)
        stop = threading.Event()
        skip = self.skip_batches
        snapshots = self._snapshots_inner()
        dev = self._target_device()
        dev = torch.device(dev) if dev is not None else None
        stream = None
        if dev is not None and dev.type == "cuda":
            if self._side_stream is None or self._side_stream.device != dev:
                self._side_stream = torch.cuda.Stream(dev)
            stream = self._side_stream

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _queue.Full:
                    continue
            return False

        def snap():
            return self.base_dataloader.state_dict() if snapshots else None

        def produce():
            try:
                base_iter = self._iter_base()
                current = self._fetch_batch(base_iter)
                current_snap = snap() if current is not _END else None
                n = 0
                while current is not _END and not stop.is_set():
                    nxt = self._fetch_batch(base_iter)
                    nxt_snap = snap() if nxt is not _END else None
                    if n >= skip:
                        last = nxt is _END
                        rem = self._final_remainder(current) if last else None
                        staged = self._stage(current, stream)
                        if not put(("batch", (n, staged, current_snap, last, rem))):
                            return
                    current, current_snap = nxt, nxt_snap
                    n += 1
                if not stop.is_set():
                    put(("end", None))
            except BaseException as exc:  # raised again on the consumer's thread
                put(("exc", exc))

        thread = threading.Thread(target=produce, name="accelerate-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                kind, payload = _pop_next(q, thread)
                if kind == "end":
                    return
                if kind == "exc":
                    raise payload
                n, (placed, event), current_snap, last, rem = payload
                if snapshots and current_snap is not None:
                    self._inner_snapshot = current_snap
                if last:
                    self.end_of_dataloader = True
                    self.remainder = rem
                self._batches_seen = n + 1
                yield self._make_ready(placed, event, dev)
        finally:
            stop.set()
            while True:  # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            thread.join(timeout=5.0)


def _flatten(tree):
    """``(leaves, structure)``: the leaves of nested dicts, lists and
    tuples in order, and the tree with each leaf replaced by its index."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return type(node)((k, walk(v)) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        leaves.append(node)
        return len(leaves) - 1

    return leaves, walk(tree)


def _unflatten(structure, leaves):
    if isinstance(structure, dict):
        return type(structure)((k, _unflatten(v, leaves)) for k, v in structure.items())
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(v, leaves) for v in structure)
    return leaves[structure]


class DataLoaderDispatcher(DataLoaderShard):
    """Only process 0 reads the base loader; the others receive each global
    batch and keep their rows. The first batch of a structure goes over the
    object channel and every rank derives its signature (structure, shapes,
    dtypes, rows) from it; later batches go as a 3-int header and one raw
    byte tensor. A short final batch is padded to the signature's rows by
    repeating its last row, and the header carries the real rows, so
    ``remainder`` lets ``gather_for_metrics`` drop the copies. A batch with
    object leaves (strings) always takes the object channel. One process:
    the plain :class:`DataLoaderShard`."""

    _H_END, _H_DATA, _H_NEW_SIG, _H_OBJECT = 0, 1, 2, 3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._sigs: list = []
        self._sig_keys: dict = {}
        self._last_real = None
        self._last_full = None

    def _iter_base(self):
        from .state import PartialState

        self._fetched_rows = 0
        return iter(self.base_dataloader) if PartialState().is_main_process else iter(())

    def _snapshots_inner(self) -> bool:
        # the other ranks never iterate the base loader: only rank 0 holds
        # its position
        from .state import PartialState

        return self._stateful_inner and PartialState().is_main_process

    def _effective_prefetch_depth(self) -> int:
        # each batch is a collective: issued from a producer thread while the
        # caller runs collectives of its own, the ranks could order them
        # differently, so the dispatcher reads synchronously across processes
        from .state import PartialState

        if PartialState().num_processes > 1:
            return 0
        return super()._effective_prefetch_depth()

    @staticmethod
    def _leaf_meta(leaf, bs):
        batched = leaf.ndim > 0 and leaf.shape[:1] == (bs,)
        return (leaf.shape[1:] if batched else leaf.shape, leaf.dtype.str, batched)

    def _register_sig(self, batch) -> None:
        leaves, structure = _flatten(batch)
        leaves = [np.asarray(x) for x in leaves]
        bs = find_batch_size(batch) or 0
        metas = [self._leaf_meta(x, bs) for x in leaves]
        shapes = [((bs,) + m[0] if m[2] else m[0]) for m in metas]
        dtypes = [np.dtype(m[1]) for m in metas]
        sizes = [int(np.prod(s, dtype=np.int64)) * d.itemsize for s, d in zip(shapes, dtypes)]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self._sigs.append({"structure": structure, "shapes": shapes, "dtypes": dtypes,
                           "offsets": offsets, "nbytes": int(offsets[-1]), "bs": bs})
        self._sig_keys[(repr(structure), tuple(metas))] = len(self._sigs) - 1

    @staticmethod
    def _pad_rows(leaf, real_bs: int, target_bs: int):
        if leaf.ndim == 0 or leaf.shape[0] != real_bs or real_bs == target_bs:
            return leaf
        return np.concatenate([leaf, np.repeat(leaf[-1:], target_bs - real_bs, axis=0)], axis=0)

    def _bcast_tensor(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        dist.broadcast(t, src=0)
        operations.record_collective("broadcast", t.numel() * t.element_size())
        return t

    def _fetch_batch(self, base_iter):
        from .state import PartialState

        state = PartialState()
        if state.num_processes == 1:
            batch = next(base_iter, _END)
            return batch if batch is _END else _to_numpy_batch(batch)
        dev = state.device

        def header(vals):
            return [int(v) for v in self._bcast_tensor(
                torch.tensor(vals, dtype=torch.int64, device=dev)).tolist()]

        def objects(batch, kind, real_bs):
            header([kind, 0, real_bs])
            operations.broadcast_object_list([batch])
            self._last_real = self._last_full = real_bs
            return batch

        if state.is_main_process:
            batch = next(base_iter, _END)
            if batch is _END:
                header([self._H_END, 0, 0])
                return _END
            batch = _to_numpy_batch(batch)
            leaves, structure = _flatten(batch)
            leaves = [np.asarray(x) for x in leaves]
            real_bs = find_batch_size(batch) or 0
            if any(x.dtype.hasobject for x in leaves):
                return objects(batch, self._H_OBJECT, real_bs)
            key = (repr(structure), tuple(self._leaf_meta(x, real_bs) for x in leaves))
            sig_id = self._sig_keys.get(key)
            rows_before = self._fetched_rows
            self._fetched_rows = rows_before + real_bs
            is_final = (self.total_dataset_length is not None
                        and rows_before + real_bs >= self.total_dataset_length)
            if sig_id is not None and real_bs < self._sigs[sig_id]["bs"] and not is_final:
                return objects(batch, self._H_OBJECT, real_bs)
            if sig_id is None or real_bs > self._sigs[sig_id]["bs"]:
                header([self._H_NEW_SIG, 0, real_bs])
                operations.broadcast_object_list([batch])
                self._register_sig(batch)
                self._last_real = self._last_full = real_bs
                return batch
            sig = self._sigs[sig_id]
            if real_bs < sig["bs"]:
                leaves = [self._pad_rows(x, real_bs, sig["bs"]) for x in leaves]
            header([self._H_DATA, sig_id, real_bs])
            payload = np.frombuffer(b"".join(np.ascontiguousarray(x).tobytes() for x in leaves),
                                    np.uint8)
            self._bcast_tensor(torch.from_numpy(payload.copy()).to(dev))
            self._last_real, self._last_full = real_bs, sig["bs"]
            return _unflatten(structure, leaves)

        kind, sig_id, real_bs = header([0, 0, 0])
        if kind == self._H_END:
            return _END
        if kind in (self._H_NEW_SIG, self._H_OBJECT):
            batch = operations.broadcast_object_list([None])[0]
            if kind == self._H_NEW_SIG:
                self._register_sig(batch)
            self._last_real = real_bs
            self._last_full = find_batch_size(batch) or 0
            return batch
        sig = self._sigs[sig_id]
        buf = self._bcast_tensor(torch.empty(sig["nbytes"], dtype=torch.uint8, device=dev))
        payload = bytearray(buf.cpu().numpy().tobytes())  # writable: torch wraps it later
        leaves = [np.frombuffer(payload, dtype=sig["dtypes"][i],
                                count=int(np.prod(sig["shapes"][i], dtype=np.int64)),
                                offset=int(sig["offsets"][i])).reshape(sig["shapes"][i])
                  for i in range(len(sig["shapes"]))]
        self._last_real, self._last_full = real_bs, sig["bs"]
        return _unflatten(sig["structure"], leaves)

    def _final_remainder(self, batch) -> int:
        if self.total_dataset_length is not None:
            bs = find_batch_size(batch) or 0
            return self.total_dataset_length % bs if bs else -1
        if self._last_real is not None and self._last_full and self._last_real < self._last_full:
            return self._last_real
        return -1

    def _process(self, batch):
        from .state import PartialState

        if PartialState().num_processes > 1 and self.assembler is not None:
            batch = self.assembler.local_block(batch)
        return super()._process(batch)




# ---------------------------------------------------------------------------
# Skip and resume


class SkipBatchSampler:
    """The batches of ``batch_sampler`` after its first ``skip_batches``."""

    def __init__(self, batch_sampler, skip_batches: int = 0):
        self.batch_sampler = batch_sampler
        self.skip_batches = skip_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.batch_sampler) - self.skip_batches

    def __iter__(self):
        for i, batch in enumerate(self.batch_sampler):
            if i >= self.skip_batches:
                yield batch


def skip_first_batches(dataloader, num_batches: int = 0):
    """The loader resuming ``num_batches`` into its next epoch (one shot): a
    prepared loader is set to skip them, anything else is wrapped."""
    if isinstance(dataloader, DataLoaderShard):
        dataloader.skip_batches = num_batches
        if isinstance(dataloader, SkipDataLoader):
            # the resume wins over the every-epoch skip for one epoch
            dataloader._resume_pending = True
        return dataloader
    return DataLoaderShard(dataloader, skip_batches=num_batches)


class SkipDataLoader(DataLoaderShard):
    """Skips its first ``skip_batches`` batches in every epoch. A resume
    (``load_state_dict``, :func:`skip_first_batches`) takes precedence for
    its one epoch (the larger of the two skips), then the every-epoch skip
    applies again."""

    def __init__(self, dataloader, skip_batches: int = 0, **kwargs):
        super().__init__(dataloader, skip_batches=skip_batches, **kwargs)
        self._persistent_skip = skip_batches
        self._resume_pending = False

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)
        self._resume_pending = True

    def _effective_skip(self) -> int:
        if self._resume_pending:
            return max(self.skip_batches, self._persistent_skip)
        return self._persistent_skip

    def __len__(self) -> int:
        return len(self.base_dataloader) - self._effective_skip()

    def __iter__(self):
        self.skip_batches = self._effective_skip()
        self._resume_pending = False
        yield from super().__iter__()


# ---------------------------------------------------------------------------
# Stateful torch loaders


def _stateful_dataloader_cls():
    """torchdata's ``StatefulDataLoader`` when torchdata >= 0.8.0 imports,
    else None."""
    try:
        import torchdata
        from torchdata.stateful_dataloader import StatefulDataLoader
    except ImportError:
        return None
    try:
        major, minor = (int(p) for p in getattr(torchdata, "__version__", "0.0").split(".")[:2])
    except ValueError:
        return None
    return StatefulDataLoader if (major, minor) >= (0, 8) else None


def stateful_dataloader_available() -> bool:
    return _stateful_dataloader_cls() is not None


def as_stateful_dataloader(dataloader):
    """A plain ``torch.utils.data.DataLoader`` rebuilt as torchdata's
    ``StatefulDataLoader`` over the same dataset, sampler and collate; None
    when torchdata >= 0.8.0 is absent or ``dataloader`` is not a torch
    loader (the caller decides which error that is)."""
    StatefulDataLoader = _stateful_dataloader_cls()
    if StatefulDataLoader is None:
        return None
    import torch.utils.data as tud

    if not isinstance(dataloader, tud.DataLoader):
        return None
    if type(dataloader) is not tud.DataLoader:
        warnings.warn(f"rebuilding {type(dataloader).__name__} as a StatefulDataLoader keeps its "
                      "dataset, sampler and collate but drops any overridden loader behavior",
                      stacklevel=3)
    common = dict(num_workers=dataloader.num_workers, collate_fn=dataloader.collate_fn,
                  pin_memory=dataloader.pin_memory, timeout=dataloader.timeout,
                  worker_init_fn=dataloader.worker_init_fn,
                  generator=getattr(dataloader, "generator", None),
                  persistent_workers=getattr(dataloader, "persistent_workers", False),
                  multiprocessing_context=getattr(dataloader, "multiprocessing_context", None))
    if dataloader.num_workers > 0 and getattr(dataloader, "prefetch_factor", None) is not None:
        common["prefetch_factor"] = dataloader.prefetch_factor
    if getattr(dataloader, "pin_memory_device", ""):
        common["pin_memory_device"] = dataloader.pin_memory_device
    if dataloader.batch_size is None and dataloader.batch_sampler is not None:
        return StatefulDataLoader(dataloader.dataset, batch_sampler=dataloader.batch_sampler,
                                  **common)
    if isinstance(dataloader.dataset, tud.IterableDataset):
        return StatefulDataLoader(
            dataloader.dataset, batch_size=dataloader.batch_size,
            drop_last=dataloader.drop_last if dataloader.batch_size is not None else False,
            **common)
    if dataloader.batch_size is None:
        return StatefulDataLoader(dataloader.dataset, batch_size=None,
                                  sampler=dataloader.sampler, **common)
    return StatefulDataLoader(dataloader.dataset, batch_size=dataloader.batch_size,
                              sampler=dataloader.sampler, drop_last=dataloader.drop_last,
                              **common)


# the reference's base-class names: every prepared loader is a
# DataLoaderShard with the same surface
DataLoaderStateMixin = DataLoaderShard
DataLoaderAdapter = DataLoaderShard


def get_sampler(dataloader):
    """The innermost stateful sampler behind a prepared loader, else the
    innermost sampler of the loader's chain."""
    if isinstance(dataloader, DataLoaderShard):
        inner = dataloader._find_stateful_sampler()
        if inner is not None:
            return inner
    base = getattr(dataloader, "base_dataloader", dataloader)
    sampler = getattr(base, "batch_sampler", None)
    if sampler is None:
        sampler = getattr(base, "sampler", None)
    seen = set()
    while sampler is not None and id(sampler) not in seen:
        seen.add(id(sampler))
        child = getattr(sampler, "sampler", None)
        if child is None:
            break
        sampler = child
    return sampler


# ---------------------------------------------------------------------------
# The entry point


def _torch_collate_to_numpy(collate_fn):
    def collate(samples):
        return _to_numpy_batch(collate_fn(samples))

    return collate


def prepare_data_loader(dataloader, device=None, state=None, mesh=None,
                        device_placement: bool = True, split_batches: bool = False,
                        even_batches: bool = True,
                        dispatch_batches: Optional[bool] = None,
                        rng_types: Optional[Sequence[str]] = None,
                        data_seed: Optional[int] = None, use_seedable_sampler: bool = True,
                        prefetch_depth: int = 2, non_blocking: bool = True,
                        seq_dim: int = 1) -> DataLoaderShard:
    """Wrap ``dataloader`` for the mesh (the :class:`~.state.
    AcceleratorState`'s by default): a :class:`DataLoader` is resharded so
    this process reads its data-parallel row's batches (``batch_size``
    rows a row, or ``1/n`` of each batch with ``split_batches``); with
    ``dispatch_batches`` rank 0 reads and broadcasts each global batch. A
    ``torch.utils.data.DataLoader`` is handled as the JAX package handles
    it (see the module docstring; a shuffled one is rebuilt with
    ``SeedableRandomSampler(seed=data_seed or 0)`` whatever
    ``use_seedable_sampler`` says, as there). Another iterable of batches
    is taken as this process's already. With ``device_placement=False``
    the batches stay numpy. Under a mesh that splits ``cp`` (else ``sp``),
    dim ``seq_dim`` of every leaf with more dims is split over it too, as
    the JAX package's loader does; a length it does not divide raises."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    from .state import AcceleratorState, PartialState

    if mesh is None and (state is not None or AcceleratorState._shared_state.get("_initialized")):
        mesh = (state or AcceleratorState()).mesh
    if device is None:
        device = PartialState().device
    assembler = None
    if mesh is not None:
        assembler = GlobalBatchAssembler(mesh, device=device if device_placement else None,
                                         seq_dim=seq_dim)
    dp_size = assembler.dp_size if assembler else 1
    cls = DataLoaderDispatcher if dispatch_batches else DataLoaderShard
    place = device if device_placement else None
    common = dict(assembler=assembler if device_placement else None, rng_types=rng_types,
                  prefetch_depth=prefetch_depth, non_blocking=non_blocking)
    if isinstance(dataloader, DataLoader):
        total_len = len(dataloader.dataset) if hasattr(dataloader.dataset, "__len__") else None
        if dp_size > 1 and not dispatch_batches:
            shard = BatchSamplerShard(dataloader.batch_sampler, dp_size,
                                      assembler.local_dp_rows()[0], split_batches=split_batches,
                                      even_batches=even_batches)
            new_dl = DataLoader(dataloader.dataset, batch_sampler=shard,
                                collate_fn=dataloader.collate_fn)
            bs = dataloader.batch_size
            global_bs = None if bs is None else (bs if split_batches else bs * dp_size)
            return cls(new_dl, place, total_dataset_length=total_len, global_batch_size=global_bs,
                       **common)
        return cls(dataloader, place, total_dataset_length=total_len, **common)
    import torch.utils.data as tud

    if isinstance(dataloader, tud.DataLoader):
        if hasattr(dataloader, "state_dict") and hasattr(dataloader, "load_state_dict"):
            # a stateful loader keeps its state machinery; every rank reading
            # it would repeat its rows on each data-parallel row, so under
            # data parallelism rank 0 reads and broadcasts
            if dp_size > 1 and not dispatch_batches:
                if dispatch_batches is False:
                    raise ValueError(
                        "a stateful torch DataLoader cannot be resharded (its state machinery "
                        "would be orphaned) and iterating it on every rank would silently "
                        "duplicate data across dp replicas. Drop dispatch_batches=False (the "
                        "dispatcher route is the default for stateful loaders) or use the "
                        "native DataLoader.")
                warnings.warn("stateful torch DataLoader under data parallelism: routing through "
                              "DataLoaderDispatcher (process 0 reads and broadcasts) so ranks do "
                              "not duplicate data; each yielded batch is treated as the GLOBAL "
                              "batch", stacklevel=2)
                cls = DataLoaderDispatcher
            return cls(dataloader, place, **common)
        dataset = dataloader.dataset
        sampler = getattr(dataloader, "sampler", None)
        custom_sampler = sampler is not None and not isinstance(
            sampler, (tud.RandomSampler, tud.SequentialSampler))
        if (dataloader.batch_size is None or custom_sampler
                or not (hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"))):
            warnings.warn("torch DataLoader with a custom sampler/batch_sampler or iterable "
                          "dataset cannot be resharded; iterating it as-is. Each yielded batch "
                          "is treated as the per-host block.", stacklevel=2)
            return cls(dataloader, place, **common)
        rebuilt = DataLoader(dataset, batch_size=dataloader.batch_size,
                             shuffle=isinstance(sampler, tud.RandomSampler), seed=data_seed or 0,
                             drop_last=getattr(dataloader, "drop_last", False),
                             collate_fn=_torch_collate_to_numpy(dataloader.collate_fn))
        return prepare_data_loader(rebuilt, device=device, state=state, mesh=mesh,
                                   device_placement=device_placement,
                                   split_batches=split_batches, even_batches=even_batches,
                                   dispatch_batches=dispatch_batches, rng_types=rng_types,
                                   prefetch_depth=prefetch_depth, non_blocking=non_blocking,
                                   seq_dim=seq_dim)
    return cls(dataloader, place, **common)
