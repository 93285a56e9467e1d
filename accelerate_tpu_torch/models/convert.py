"""Weights across the two packages: the JAX param pytree (every leaf as a
numpy array) to the port's tree of tensors, and back. Dicts, lists and
tuples are nodes, as in a JAX pytree, and keep their container type.
Layouts are the same on both sides — stacked layers, ``[in, out]``
kernels — so conversion only changes the container, never the semantics
of an axis."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.operations import _tree_map

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dict/list/tuple of array-likes → the same nesting (same
    container types) of tensors on ``device`` (the CUDA device when omitted;
    raises without a GPU unless ``device="cpu"``), cast to ``dtype`` when
    given."""
    dev = resolve_device(device)

    def leaf(x):
        arr = np.array(x, copy=True)
        # numpy has no native bf16: such leaves arrive as an extension
        # dtype torch cannot wrap, so they cross as (exact) f32
        native = torch.bfloat16 if arr.dtype.name == "bfloat16" else None
        if native is not None:
            arr = arr.astype(np.float32)
        t = torch.from_numpy(arr)
        return t.to(device=dev, dtype=dtype or native or t.dtype)

    return _tree_map(leaf, tree)


def params_to_numpy(params):
    """Inverse of :func:`params_from_numpy`: every tensor to a host numpy
    array (bf16 goes through f32, which numpy can hold exactly)."""

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _tree_map(leaf, params)
