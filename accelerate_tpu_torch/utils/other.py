"""Saving a state dict to a file and reading it back: the port of ``save``,
``load`` and ``clean_state_dict_for_safetensors`` of
``accelerate_tpu.utils.other``. A state dict is a nested tree of tensors
or arrays, named by its ``/``-joined paths; files are ``.npz`` (bf16 as
the ``|V2`` view of its bits, as ``np.savez`` keeps the JAX package's) or
``.safetensors`` (the port's own writer and reader,
:func:`~.modeling.save_safetensors`)."""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["clean_state_dict_for_safetensors", "load", "save"]


def _host(value) -> np.ndarray:
    from ..sharded_checkpoint import host_arrays

    return host_arrays([value])[0]


def clean_state_dict_for_safetensors(state_dict: Mapping[str, Any]) -> dict:
    """The entries of ``state_dict`` in name order, each value once (a
    later name for the same object, a tied weight, is dropped: safetensors
    refuses aliases), as host numpy arrays."""
    seen: set = set()
    out: dict = {}
    for key in sorted(state_dict):
        value = state_dict[key]
        if id(value) in seen:
            continue
        seen.add(id(value))
        out[key] = _host(value)
    return out


def save(obj, f: str, save_on_each_node: bool = False, safe_serialization: bool = False) -> None:
    """Write a tree of tensors or arrays to ``f`` from the main process (from
    every node's with ``save_on_each_node``): safetensors with
    ``safe_serialization``, else an npz at exactly the path given."""
    from ..tracking import _is_main_process
    from .modeling import named_parameters, save_safetensors

    if not (_is_main_process() or save_on_each_node):
        return
    flat = {k: v for k, v in named_parameters(obj).items() if v is not None}
    if safe_serialization:
        save_safetensors(clean_state_dict_for_safetensors(flat), f)
        return
    with open(f, "wb") as fh:  # np.savez on a path would append ".npz"
        np.savez(fh, **{k: _host(v) for k, v in flat.items()})


def load(f: str) -> dict:
    """A flat state dict written by :func:`save`: ``{name: numpy}``, bf16
    as ``|V2`` bits."""
    if str(f).endswith(".safetensors"):
        from .modeling import load_safetensors

        return {k: v.view(torch.int16).numpy().view("V2") if v.dtype == torch.bfloat16
                else v.numpy() for k, v in load_safetensors(f).items()}
    with np.load(f, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
