"""Batch helpers: the port of ``stack_batches`` and ``send_to_device`` from
``accelerate_tpu.utils.operations``."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["send_to_device", "stack_batches"]


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return type(first)((k, _tree_map(fn, *(t[k] for t in trees))) for k in first)
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def stack_batches(batches: list):
    """Stack same-structure batches along a new leading step axis ``[K,
    ...]`` — the input of ``Accelerator.prepare_train_loop``. Tensor leaves
    stack with ``torch.stack`` (on their device), array leaves with
    ``np.stack``."""

    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack(leaves)

    return _tree_map(stack, *batches)


def send_to_device(tree, device):
    """Every tensor or numeric array leaf onto ``device`` as a tensor
    (arrays keep their dtype); strings and other objects pass through."""

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        arr = np.asarray(x)
        if arr.dtype.kind not in "biuf":
            return x
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)

    return _tree_map(put, tree)
