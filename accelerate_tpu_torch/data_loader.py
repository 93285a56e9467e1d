"""Reproducible data loading: the port of ``accelerate_tpu.data_loader`` for
one process on one device.

The samplers are the JAX package's index math, written again for this
package: a shuffled epoch is ``numpy.random.default_rng(seed +
epoch).permutation``, so the batch order is identical to the JAX
package's. ``DataLoader`` collates map-style samples into numpy batches
(``np.stack``); :func:`prepare_data_loader` wraps it so that it yields
batches of tensors on the accelerator's device, topping up a short last
batch from the epoch's first samples (the JAX package's ``even_batches``)
so every step has the same shapes.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional

import numpy as np

from .utils.operations import send_to_device

__all__ = [
    "BatchSampler",
    "DataLoader",
    "DataLoaderShard",
    "SeedableRandomSampler",
    "SequentialSampler",
    "default_collate",
    "prepare_data_loader",
]


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


def default_collate(samples: list) -> Any:
    """Stack a list of samples (dicts, tuples, arrays, scalars) into a batch
    with ``np.stack``."""
    first = samples[0]
    if isinstance(first, dict):
        return type(first)((k, default_collate([s[k] for s in samples])) for k in first)
    if isinstance(first, (list, tuple)) and not isinstance(first, str):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DataLoader:
    """Map-style loader: ``dataset[i]`` → sample; batches collated to numpy.
    ``dataset`` needs ``__len__`` and ``__getitem__``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 batch_sampler=None, sampler=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate
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


class DataLoaderShard:
    """A prepared :class:`DataLoader`: batches of tensors on ``device``.
    One process on one device reads the loader as it is, a short last batch
    included: the JAX package's ``prepare_data_loader`` wraps the sampler in
    ``BatchSamplerShard`` (whose ``even_batches`` top-up pads that batch)
    only when its data axis has more than one shard.

    While it is iterated it is the :class:`~accelerate_tpu_torch.state.
    GradientState`'s active loader; it reads one batch ahead so that
    ``end_of_dataloader`` is already true while the last batch is in use
    (``remainder``: the last batch's rows when the dataset's length is not
    a multiple of the batch size), as the JAX package's loader does."""

    def __init__(self, dataloader: DataLoader, device):
        from .state import GradientState

        self.base_dataloader = dataloader
        self.device = device
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1

    def set_epoch(self, epoch: int) -> None:
        self.base_dataloader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.base_dataloader)

    def _final_remainder(self) -> int:
        dataset = getattr(self.base_dataloader, "dataset", None)
        batch_size = getattr(self.base_dataloader, "batch_size", None)
        if dataset is None or not batch_size or not hasattr(dataset, "__len__"):
            return -1
        return len(dataset) % batch_size

    def __iter__(self):
        self.gradient_state._add_dataloader(self)
        self.end_of_dataloader = False
        self.remainder = -1
        try:
            it = iter(self.base_dataloader)
            current = next(it, _END)
            while current is not _END:
                nxt = next(it, _END)
                if nxt is _END:
                    self.end_of_dataloader = True
                    self.remainder = self._final_remainder()
                yield send_to_device(current, self.device)
                current = nxt
        finally:
            self.gradient_state._remove_dataloader(self)


def prepare_data_loader(dataloader: DataLoader, device) -> DataLoaderShard:
    """Wrap ``dataloader`` so that it yields batches of tensors on
    ``device`` (one process, one device: no sharding)."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    return DataLoaderShard(dataloader, device)
