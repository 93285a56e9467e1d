"""Weights across the two packages: the JAX param pytree (every leaf as a
numpy array) to the port's dict of tensors, and back. Layouts are the same
on both sides — stacked layers, ``[in, out]`` kernels — so conversion only
changes the container, never the semantics of an axis."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(tree: dict, device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """Nested dict of array-likes → the same nesting of tensors on
    ``device`` (the CUDA device when omitted; raises without a GPU unless
    ``device="cpu"``), cast to ``dtype`` when given."""
    dev = resolve_device(device)
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_numpy(leaf, device=dev, dtype=dtype)
        else:
            arr = np.array(leaf, copy=True)
            # numpy has no native bf16: such leaves arrive as an extension
            # dtype torch cannot wrap, so they cross as (exact) f32
            native = torch.bfloat16 if arr.dtype.name == "bfloat16" else None
            if native is not None:
                arr = arr.astype(np.float32)
            t = torch.from_numpy(arr)
            out[name] = t.to(device=dev, dtype=dtype or native or t.dtype)
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`: every tensor to a host numpy
    array (bf16 goes through f32, which numpy can hold exactly)."""
    out = {}
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            out[name] = params_to_numpy(leaf)
        else:
            t = leaf.detach().cpu()
            out[name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return out
