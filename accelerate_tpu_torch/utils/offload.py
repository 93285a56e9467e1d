"""Disk-offload storage: one raw memmap per tensor plus ``index.json``, the
port of ``accelerate_tpu.utils.offload``.

The on-disk format is the JAX package's: ``<folder>/<name>.dat`` holds the
tensor's bytes (a scalar as one element), ``index.json`` maps each name to
``{"dtype", "shape"}`` with numpy dtype names, and bf16 is stored as its
int16 bits under the logical dtype ``"bfloat16"``. A folder written by
either package loads in the other. bf16 is read back through
``torch.from_numpy(a).view(torch.bfloat16)``, so neither ``ml_dtypes`` nor
``safetensors`` is needed; weights come back as CPU tensors over a
copy-on-write memmap (no read until used, the file never written).
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

__all__ = [
    "OffloadedWeightsLoader",
    "PrefixedDataset",
    "load_offload_index",
    "load_offloaded_weight",
    "offload_state_dict",
    "offload_weight",
    "save_offload_index",
]


def _to_numpy(weight):
    """``(array, logical dtype or None)``: a tensor or array-like as a host
    numpy array, bf16 as its int16 bits with the logical dtype
    ``"bfloat16"`` (a JAX bf16 array arrives as numpy's ``bfloat16``
    extension dtype, whose bits are read the same way)."""
    if isinstance(weight, torch.Tensor):
        t = weight.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), None
    array = np.asarray(weight)
    if array.dtype.name == "bfloat16":
        return array.view(np.int16), "bfloat16"
    return array, None


def offload_weight(weight, weight_name: str, offload_folder: str, index: Optional[dict] = None) -> dict:
    """Spill one tensor to ``<offload_folder>/<weight_name>.dat`` and record
    its shape and dtype in ``index`` (returned)."""
    array, logical = _to_numpy(weight)
    if index is None:
        index = {}
    tensor_file = os.path.join(offload_folder, f"{weight_name}.dat")
    # param paths are '/'-joined: keep the hierarchy on disk
    os.makedirs(os.path.dirname(tensor_file), exist_ok=True)
    index[weight_name] = {"dtype": logical or str(array.dtype), "shape": list(array.shape)}
    if array.ndim == 0:
        array = array[None]
    file_array = np.memmap(tensor_file, dtype=array.dtype, mode="w+", shape=array.shape)
    file_array[:] = array[:]
    file_array.flush()
    return index


def load_offloaded_weight(weight_file: str, weight_info: dict) -> torch.Tensor:
    """One spilled tensor back as a CPU tensor over the file (copy-on-write
    memmap: reading it pages the file in, writing to it never reaches the
    file)."""
    shape = tuple(weight_info["shape"])
    dtype = weight_info["dtype"]
    logical_bf16 = dtype == "bfloat16"
    array = np.memmap(weight_file, dtype="int16" if logical_bf16 else dtype,
                      shape=shape or (1,), mode="c")
    weight = torch.from_numpy(array)
    if logical_bf16:
        weight = weight.view(torch.bfloat16)
    return weight.reshape(shape) if shape == () else weight


def save_offload_index(index: dict, offload_folder: str) -> None:
    if index is None or len(index) == 0:
        return
    offload_index_file = os.path.join(offload_folder, "index.json")
    current_index = {}
    if os.path.isfile(offload_index_file):
        with open(offload_index_file, encoding="utf-8") as f:
            current_index = json.load(f)
    current_index.update(index)
    with open(offload_index_file, "w", encoding="utf-8") as f:
        json.dump(current_index, f, indent=2)


def load_offload_index(offload_folder: str) -> dict:
    offload_index_file = os.path.join(offload_folder, "index.json")
    if not os.path.isfile(offload_index_file):
        return {}
    with open(offload_index_file, encoding="utf-8") as f:
        return json.load(f)


def offload_state_dict(save_dir: str, state_dict: Mapping) -> None:
    """Spill a flat ``{name: tensor}`` dict and write its index."""
    os.makedirs(save_dir, exist_ok=True)
    index = {}
    for name, parameter in state_dict.items():
        index = offload_weight(parameter, name, save_dir, index=index)
    save_offload_index(index, save_dir)


class PrefixedDataset(Mapping):
    """View of a mapping keyed under a prefix."""

    def __init__(self, dataset: Mapping, prefix: str):
        self.dataset = dataset
        self.prefix = prefix

    def __getitem__(self, key):
        return self.dataset[f"{self.prefix}{key}"]

    def __iter__(self):
        return iter([key for key in self.dataset if key.startswith(self.prefix)])

    def __len__(self):
        return len([key for key in self.dataset if key.startswith(self.prefix)])


class OffloadedWeightsLoader(Mapping):
    """Lazy mapping over in-memory tensors and a disk-offload folder. An
    index entry with a ``safetensors_file`` is read from that file by the
    port's own reader (:func:`~.modeling.load_safetensors`)."""

    def __init__(
        self,
        state_dict: Optional[Mapping] = None,
        save_folder: Optional[str] = None,
        index: Optional[Mapping] = None,
    ):
        if state_dict is None and save_folder is None and index is None:
            raise ValueError("need either a state_dict, a save_folder or an index")
        self.state_dict = dict(state_dict) if state_dict is not None else {}
        if index is None and save_folder is not None:
            index = load_offload_index(save_folder)
        self.index = dict(index) if index is not None else {}
        self.save_folder = save_folder
        self.all_keys = list(self.state_dict.keys())
        self.all_keys.extend([key for key in self.index if key not in self.all_keys])

    def __getitem__(self, key: str):
        if key in self.state_dict:
            return self.state_dict[key]
        weight_info = self.index[key]
        if weight_info.get("safetensors_file") is not None:
            from .modeling import load_safetensors

            name = weight_info.get("weight_name", key)
            return load_safetensors(weight_info["safetensors_file"], names=[name])[name]
        weight_file = os.path.join(self.save_folder, f"{key}.dat")
        return load_offloaded_weight(weight_file, weight_info)

    def __iter__(self):
        return iter(self.all_keys)

    def __len__(self):
        return len(self.all_keys)
