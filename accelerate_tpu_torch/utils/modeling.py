"""Param-tree sizes, device maps and checkpoint loading: the param-tree half
of ``accelerate_tpu.utils.modeling``.

A model is a nested dict of tensors (the JAX package's pytree layout); a
*module* is a subtree, named by its '/'-joined path. Device-map values are
an ``int`` (the index of a CUDA device: ``cuda:<i>``; when the caller asks
for the CPU as the execution device, index 0 is the CPU, as the JAX
package's CPU backend has it), ``"cpu"`` (host memory, paged to the device
per use) or ``"disk"`` (memmaps, :mod:`.offload`). The greedy placement,
its reserve for the largest layer and its tied-weight rule are the JAX
package's, so the same tree and budgets give the same map.

The zero-memory tree of :func:`abstract_params` holds ``meta`` tensors.
Checkpoints are ``.npz`` or ``.safetensors`` files (single, sharded with an
index, or a directory), the latter read by :func:`load_safetensors`, this
module's own reader: no ``safetensors`` package is needed.
"""

from __future__ import annotations

import json
import os
import re
import struct
from collections import OrderedDict, defaultdict
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve_device
from .offload import load_offload_index, offload_weight, save_offload_index

__all__ = [
    "WEIGHTS_INDEX_NAME",
    "WEIGHTS_NAME",
    "abstract_params",
    "calculate_maximum_sizes",
    "check_device_map",
    "check_tied_parameters_in_config",
    "check_tied_parameters_on_same_device",
    "clean_device_map",
    "compute_module_sizes",
    "compute_parameter_sizes",
    "convert_file_size_to_int",
    "dtype_byte_size",
    "ensure_weights_retied",
    "extract_submodules_state_dict",
    "find_tied_parameters",
    "get_balanced_memory",
    "get_max_layer_size",
    "get_max_memory",
    "infer_auto_device_map",
    "load_checkpoint_in_params",
    "load_safetensors",
    "load_state_dict",
    "lookup_device",
    "named_parameters",
    "retie_parameters",
    "save_safetensors",
    "total_byte_size",
    "unflatten_parameters",
]

WEIGHTS_NAME = "model.safetensors"
WEIGHTS_INDEX_NAME = "model.safetensors.index.json"


# ------------------------------------------------------------------ pytrees --
def named_parameters(tree, prefix: str = "", sep: str = "/") -> "OrderedDict[str, Any]":
    """Flatten a nested param tree to ``{'a/b/c': leaf}`` (insertion order)."""
    out: OrderedDict[str, Any] = OrderedDict()

    def _walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                _walk(v, f"{path}{sep}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                _walk(v, f"{path}{sep}{i}" if path else str(i))
        else:
            out[path] = node

    _walk(tree, prefix)
    return out


def unflatten_parameters(flat: Mapping[str, Any], sep: str = "/") -> dict:
    """Inverse of :func:`named_parameters` (lists come back as dicts with
    stringified integer keys)."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def abstract_params(init_fn, *args, **kwargs):
    """Zero-memory model construction: ``init_fn(*args, **kwargs)`` runs
    under ``FakeTensorMode``, where tensors carry shapes and dtypes and own
    no storage, and every tensor of the result becomes a ``meta`` tensor of
    the same shape and dtype (the counterpart of ``jax.eval_shape``). Random
    draws, moves and casts inside ``init_fn`` allocate nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        tree = init_fn(*args, **kwargs)

    def to_meta(node):
        if isinstance(node, Mapping):
            return {k: to_meta(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(to_meta(v) for v in node)
        if isinstance(node, torch.Tensor):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return node

    return to_meta(tree)


# -------------------------------------------------------------------- sizes --
def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch or numpy dtype or a dtype name,
    fractional for the sub-byte names ``"int4"``/``"int2"``."""
    if dtype.__class__.__name__ == "CustomDtype":  # enum marker (fp8/int4/int2)
        dtype = dtype.value
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    name = name.replace("jax.numpy.", "").replace("torch.", "")
    if name == "int2":
        return 0.25
    if name in ("int4", "uint4"):
        return 0.5
    if name == "fp8":
        return 1
    if "float8" in name or name in ("int8", "uint8", "bool"):
        return 1
    bits = re.search(r"[^\d](\d+)(_.*)?$", name)
    if bits is None:
        raise ValueError(f"`dtype` is not a valid dtype: {name}")
    return int(bits.group(1)) // 8


def convert_file_size_to_int(size: Union[int, str]) -> int:
    """``"6GB"``/``"200MiB"``/int → bytes."""
    if isinstance(size, int):
        return size
    mem_size = str(size).upper().strip()
    units = [("GIB", 2**30), ("MIB", 2**20), ("KIB", 2**10), ("GB", 10**9), ("MB", 10**6), ("KB", 10**3)]
    for suffix, mult in units:
        if mem_size.endswith(suffix):
            return int(float(mem_size[: -len(suffix)]) * mult)
    if mem_size.isdigit():
        return int(mem_size)
    raise ValueError(f"size {size!r} is not in a valid format (e.g. '6GB', '200MiB', 4096)")


def _leaf_size(leaf, dtype=None, path: str = "", special_dtypes: Optional[dict] = None) -> int:
    shape = getattr(leaf, "shape", ())
    numel = int(np.prod(shape)) if shape else 1
    leaf_dtype = getattr(leaf, "dtype", np.float32)
    if special_dtypes is not None and path in special_dtypes:
        leaf_dtype = special_dtypes[path]
    elif dtype is not None:
        # a loading dtype never upcasts storage
        leaf_dtype = dtype if dtype_byte_size(dtype) < dtype_byte_size(leaf_dtype) else leaf_dtype
    return int(np.ceil(numel * dtype_byte_size(leaf_dtype)))


def compute_parameter_sizes(tree, dtype=None, special_dtypes=None) -> "OrderedDict[str, int]":
    return OrderedDict(
        (path, _leaf_size(leaf, dtype, path, special_dtypes))
        for path, leaf in named_parameters(tree).items()
    )


def compute_module_sizes(tree, dtype=None, special_dtypes=None) -> dict[str, int]:
    """Size in bytes of every subtree prefix, ``""`` being the whole model."""
    sizes: dict[str, int] = defaultdict(int)
    for path, size in compute_parameter_sizes(tree, dtype, special_dtypes).items():
        parts = path.split("/")
        for i in range(len(parts) + 1):
            sizes["/".join(parts[:i])] += size
    return dict(sizes)


def total_byte_size(tree, dtype=None) -> int:
    return compute_module_sizes(tree, dtype)[""]


def find_tied_parameters(tree) -> list[list[str]]:
    """Groups of param paths that hold the same tensor object."""
    by_id: dict[int, list[str]] = defaultdict(list)
    for path, leaf in named_parameters(tree).items():
        if leaf is not None and not np.isscalar(leaf):
            by_id[id(leaf)].append(path)
    return sorted(group for group in by_id.values() if len(group) > 1)


def retie_parameters(tree, tied_groups: list[list[str]]):
    """A new tree whose every tied group points at one shared tensor (the
    first of the group that is not ``None``)."""
    flat = named_parameters(tree)
    for group in tied_groups:
        sources = [p for p in group if flat.get(p) is not None]
        if not sources:
            continue
        src = flat[sources[0]]
        for path in group:
            flat[path] = src
    return unflatten_parameters(flat)


# ------------------------------------------------------------------- memory --
def get_max_memory(max_memory: Optional[dict] = None) -> "OrderedDict[Union[int, str], int]":
    """Per-device budgets in bytes: a given ``max_memory`` with its sizes
    converted, else 90 % of each CUDA device's free memory
    (``torch.cuda.mem_get_info``) and the host's available RAM under
    ``"cpu"``. With no CUDA device there is only the ``"cpu"`` entry."""
    if max_memory is not None:
        out: OrderedDict = OrderedDict()
        for key, val in max_memory.items():
            out[key] = convert_file_size_to_int(val) if not isinstance(val, int) else val
        return out
    out = OrderedDict()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            free, _ = torch.cuda.mem_get_info(i)
            out[i] = int(0.9 * free)
    out["cpu"] = _host_ram_bytes()
    return out


def _host_ram_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 * 2**30


def get_balanced_memory(
    tree,
    max_memory: Optional[dict] = None,
    no_split_module_patterns: Optional[list[str]] = None,
    dtype=None,
    special_dtypes=None,
    low_zero: bool = False,
) -> "OrderedDict[Union[int, str], int]":
    """Cap the device budgets so layers spread evenly over the devices
    instead of filling device 0 first (``low_zero`` leaves device 0 room for
    generation's buffers)."""
    max_memory = get_max_memory(max_memory)
    num_devices = len([d for d in max_memory if isinstance(d, int) and max_memory[d] > 0])
    if num_devices == 0:
        return max_memory
    if num_devices == 1:
        if low_zero:
            raise ValueError("low_zero requires at least 2 accelerator devices")
        return max_memory

    module_sizes = compute_module_sizes(tree, dtype, special_dtypes)
    per_device = module_sizes[""] // (num_devices - 1 if low_zero else num_devices)

    # buffer: mean + stddev of the leaf-module sizes, so the last device
    # absorbs rounding without spilling to the host
    leaves = [
        size
        for name, size in module_sizes.items()
        if name and not any(other.startswith(name + "/") for other in module_sizes)
    ]
    buffer = int(np.mean(leaves) + np.std(leaves)) if leaves else 0
    no_split = no_split_module_patterns or []
    if no_split:
        split_caps = [
            size for name, size in module_sizes.items() if name and _matches_any(name, no_split)
        ]
        buffer = max(buffer, max(split_caps) if split_caps else 0)
    per_device += buffer

    out = OrderedDict()
    for key, val in max_memory.items():
        if isinstance(key, int):
            cap = per_device if not (low_zero and key == 0) else per_device // 4
            out[key] = min(val, cap)
        else:
            out[key] = val
    return out


def _matches_any(name: str, patterns: list[str]) -> bool:
    tail = name.split("/")[-1]
    return any(re.search(p, name) or re.search(p, tail) for p in patterns)


# ------------------------------------------------------- device-map inference --
def infer_auto_device_map(
    tree,
    max_memory: Optional[dict] = None,
    no_split_module_patterns: Optional[list[str]] = None,
    dtype=None,
    special_dtypes=None,
    clean_result: bool = True,
    verbose: bool = False,
) -> "OrderedDict[str, Union[int, str]]":
    """Greedy module → device placement, devices first, then ``"cpu"``, then
    ``"disk"``. No budget is exceeded; a main device (the first device, and
    the host) keeps room for the largest unsplittable layer still to place,
    so an offloaded layer can always be paged in; modules holding tied
    weights go together; a module that does not fit is split into its
    children unless it matches ``no_split_module_patterns``."""
    max_memory = get_max_memory(max_memory)
    # a map that omits "cpu" still caps the host tier at real RAM, so an
    # oversized model spills to disk instead of exhausting memory
    max_memory.setdefault("cpu", _host_ram_bytes())
    no_split = no_split_module_patterns or []
    devices = [d for d in max_memory if isinstance(d, int)] + ["cpu", "disk"]
    main_devices = [devices[0]] if devices else []
    if "cpu" in max_memory and devices[0] != "cpu":
        main_devices.append("cpu")

    module_sizes = compute_module_sizes(tree, dtype, special_dtypes)
    tied_parameters = find_tied_parameters(tree)

    if not isinstance(tree, Mapping):
        raise TypeError("infer_auto_device_map expects a nested dict param tree")
    modules_to_treat: list[str] = list(tree.keys())
    flat_tree = named_parameters(tree)
    children_of: dict[str, list[str]] = defaultdict(list)
    for name in module_sizes:
        if name:
            parent = "/".join(name.split("/")[:-1])
            children_of[parent].append(name)

    def _is_leaf_module(name: str) -> bool:
        return name in flat_tree or not children_of.get(name)

    def _max_layer_size(queue: list[str]) -> int:
        """Largest unsplittable unit still to place."""
        best = 0
        for name in queue:
            if _is_leaf_module(name) or _matches_any(name, no_split):
                best = max(best, module_sizes[name])
            else:
                best = max(best, _max_layer_size(children_of[name]))
        return best

    device_map: OrderedDict[str, Union[int, str]] = OrderedDict()
    current_device = 0
    used = {device: 0 for device in devices}

    def _tied_companions(name: str) -> list[str]:
        """Unplaced top-level queue entries tied to params inside ``name``."""
        inside = {p for p in flat_tree if p == name or p.startswith(name + "/")}
        out = []
        for group in tied_parameters:
            group_in = [p for p in group if p in inside]
            group_out = [p for p in group if p not in inside]
            if group_in and group_out:
                for p in group_out:
                    for queued in modules_to_treat:
                        if (p == queued or p.startswith(queued + "/")) and queued not in out:
                            out.append(queued)
        return out

    while modules_to_treat:
        name = modules_to_treat.pop(0)
        module_size = module_sizes[name]
        device = devices[current_device]
        budget = max_memory.get(device) if device != "disk" else None

        reserve = _max_layer_size(modules_to_treat) if device in main_devices else 0
        companions = _tied_companions(name)
        size_with_ties = module_size + sum(module_sizes[c] for c in companions)

        fits = budget is None or used[device] + size_with_ties + reserve <= budget
        if fits:
            if verbose:
                print(f"putting {name} (+{companions}) size={size_with_ties} on {device}")
            device_map[name] = device
            used[device] += size_with_ties
            for c in companions:
                device_map[c] = device
                modules_to_treat.remove(c)
            continue

        kids = children_of.get(name, [])
        splittable = kids and not _matches_any(name, no_split) and not companions
        if splittable:
            if verbose:
                print(f"splitting {name} into {len(kids)} children")
            modules_to_treat[0:0] = kids
        else:
            if verbose:
                print(f"{name} does not fit on {device}, advancing")
            modules_to_treat.insert(0, name)
            current_device += 1
            if current_device >= len(devices):
                raise RuntimeError(f"module {name} fits nowhere — even disk failed?")

    if clean_result:
        device_map = clean_device_map(device_map)
    return device_map


def clean_device_map(device_map: "OrderedDict[str, Union[int, str]]", module_prefix: str = "") -> OrderedDict:
    """Collapse children that share a device onto their top-level prefix."""
    prefixes = sorted({k.split("/")[0] if not module_prefix else k for k in device_map})
    values = set(device_map.values())
    if module_prefix == "" and len(values) == 1:
        return OrderedDict({"": device_map[next(iter(device_map))]})
    out: OrderedDict = OrderedDict()
    for prefix in prefixes:
        sub = OrderedDict(
            (k, v) for k, v in device_map.items() if k == prefix or k.startswith(prefix + "/")
        )
        if len(set(sub.values())) == 1:
            out[prefix] = next(iter(sub.values()))
        else:
            out.update(sub)
    return out


def lookup_device(device_map: Mapping[str, Any], path: str):
    """Most specific device-map entry covering ``path``."""
    if path in device_map:
        return device_map[path]
    parts = path.split("/")
    for i in range(len(parts) - 1, -1, -1):
        prefix = "/".join(parts[:i])
        if prefix in device_map:
            return device_map[prefix]
    raise KeyError(f"{path} not covered by device_map (keys={list(device_map)[:8]}…)")


def _devices_for_index(execution_device: torch.device) -> list:
    """What an integer device-map value indexes: the CUDA devices, or, when
    the caller runs on the CPU, the CPU alone as device 0."""
    if execution_device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _indexed_device(devices: list, target, path: str) -> torch.device:
    if int(target) >= len(devices):
        raise ValueError(
            f"device_map places {path!r} on device {target} but only "
            f"{len(devices)} local devices exist"
        )
    return devices[int(target)]


# -------------------------------------------------------- checkpoint loading --
# safetensors dtype names → (numpy storage dtype, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8), "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool), "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2), "U16": (np.uint16, torch.uint16),
    "U32": (np.uint32, torch.uint32), "U64": (np.uint64, torch.uint64),
}


def load_safetensors(path: str, names=None) -> dict:
    """Read a ``.safetensors`` file: an 8-byte little-endian header length,
    a JSON header ``{name: {"dtype", "shape", "data_offsets"}}``, then the
    raw little-endian data. Returns ``{name: CPU tensor}`` (only ``names``
    when given), each over a copy-on-write memmap of the file; BF16 and the
    fp8 formats are read as integers and viewed as their torch dtype."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    base = 8 + header_len
    out = {}
    for name, info in header.items():
        if name == "__metadata__" or (names is not None and name not in names):
            continue
        np_dtype, torch_dtype = _ST_DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end == begin:
            out[name] = torch.empty(shape, dtype=torch_dtype)
            continue
        array = np.memmap(path, dtype=np.dtype(np_dtype).newbyteorder("<"), mode="c",
                          offset=base + begin, shape=shape or (1,))
        t = torch.from_numpy(array).reshape(shape)
        out[name] = t.view(torch_dtype) if t.dtype != torch_dtype else t
    if names is not None:
        missing = [n for n in names if n not in out]
        if missing:
            raise KeyError(f"{path} holds no tensor {missing[0]!r}")
    return out


# numpy dtype → safetensors dtype name (torch bf16 and the fp8 formats are
# taken by their torch dtype below)
_ST_NAMES = {np.dtype(np.float64): "F64", np.dtype(np.float32): "F32",
             np.dtype(np.float16): "F16", np.dtype(np.int64): "I64", np.dtype(np.int32): "I32",
             np.dtype(np.int16): "I16", np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
             np.dtype(np.bool_): "BOOL", np.dtype(np.uint16): "U16",
             np.dtype(np.uint32): "U32", np.dtype(np.uint64): "U64"}
_ST_TORCH_NAMES = {torch.bfloat16: "BF16", torch.float8_e4m3fn: "F8_E4M3",
                   torch.float8_e5m2: "F8_E5M2"}


def _st_bytes(value) -> tuple:
    """``(dtype name, shape, little-endian bytes)`` of a tensor or array."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        name = _ST_TORCH_NAMES.get(t.dtype)
        if name is not None:
            return name, list(t.shape), t.view(torch.uint8).numpy().tobytes()
        value = t.numpy()
    arr = np.asarray(value)
    if arr.dtype == np.dtype("V2"):  # bf16 bits, as np.savez keeps them
        return "BF16", list(arr.shape), np.ascontiguousarray(arr).tobytes()
    if arr.dtype not in _ST_NAMES:
        raise ValueError(f"safetensors cannot hold dtype {arr.dtype}")
    le = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<"))
    return _ST_NAMES[arr.dtype], list(arr.shape), le.tobytes()


def save_safetensors(tensors: Mapping[str, Any], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``{name: tensor or array}`` as a ``.safetensors`` file (the
    writer beside :func:`load_safetensors`, so no ``safetensors`` package is
    needed): an 8-byte little-endian header length, the JSON header padded
    with spaces to a multiple of 8, then each tensor's little-endian bytes
    back to back, in name order. A bf16 tensor (or ``|V2`` array) is
    written as BF16."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs, offset = [], 0
    for name in sorted(tensors):
        dtype, shape, data = _st_bytes(tensors[name])
        header[name] = {"dtype": dtype, "shape": shape,
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def load_state_dict(checkpoint_file: str, device_map: Optional[dict] = None) -> dict:
    """A ``.safetensors`` or ``.npz``/``.npy`` file as a flat ``{name: CPU
    tensor}``."""
    if checkpoint_file.endswith(".safetensors"):
        return load_safetensors(checkpoint_file)
    if checkpoint_file.endswith((".npz", ".npy")):
        with np.load(checkpoint_file, allow_pickle=False) as data:
            return {k: torch.from_numpy(data[k]) for k in data.files}
    raise ValueError(f"unsupported checkpoint format: {checkpoint_file}")


def load_checkpoint_in_params(
    abstract_tree,
    checkpoint: str,
    device_map: Optional[Mapping[str, Any]] = None,
    offload_folder: Optional[str] = None,
    dtype=None,
    strict: bool = True,
    execution_device=None,
):
    """Stream a (possibly sharded) checkpoint into a placed param tree: each
    tensor goes straight to its mapped place — a device (``.to``), host
    memory, or a memmap in ``offload_folder`` (its leaf is then ``None``) —
    without holding the whole model in host memory. ``execution_device``
    (the CUDA device when omitted) says what an integer in ``device_map``
    indexes. ``checkpoint`` is a file, an index json, or a directory holding
    either. Returns ``(tree, offload_index)``."""
    shard_files = _resolve_checkpoint_files(checkpoint)
    expected = named_parameters(abstract_tree)
    device_map = device_map or {"": 0}
    disk_index: dict = {}
    devices = _devices_for_index(resolve_device(execution_device))

    flat_out: dict[str, Any] = {}
    for shard in shard_files:
        state = load_state_dict(shard)
        for name, value in state.items():
            if name not in expected:
                if strict:
                    raise KeyError(f"checkpoint tensor {name!r} not in model")
                continue
            if dtype is not None:
                value = value.to(dtype)
            target = lookup_device(device_map, name)
            if target == "disk":
                if offload_folder is None:
                    raise ValueError("device_map contains 'disk' but no offload_folder given")
                os.makedirs(offload_folder, exist_ok=True)
                disk_index = offload_weight(value, name, offload_folder, disk_index)
                flat_out[name] = None
            elif target == "cpu":
                flat_out[name] = value
            else:
                flat_out[name] = value.to(_indexed_device(devices, target, name))
    if offload_folder and disk_index:
        save_offload_index(disk_index, offload_folder)
    missing = [k for k in expected if k not in flat_out]
    if missing and strict:
        raise KeyError(f"checkpoint is missing tensors: {missing[:5]}…")
    return unflatten_parameters(flat_out), (load_offload_index(offload_folder) if offload_folder else {})


def _resolve_checkpoint_files(checkpoint: str) -> list[str]:
    if os.path.isdir(checkpoint):
        index = os.path.join(checkpoint, WEIGHTS_INDEX_NAME)
        single = os.path.join(checkpoint, WEIGHTS_NAME)
        if os.path.isfile(index):
            checkpoint = index
        elif os.path.isfile(single):
            return [single]
        else:
            shards = sorted(
                os.path.join(checkpoint, f)
                for f in os.listdir(checkpoint)
                if f.endswith((".safetensors", ".npz"))
            )
            if not shards:
                raise FileNotFoundError(f"no checkpoint files under {checkpoint}")
            return shards
    if checkpoint.endswith("index.json"):
        folder = os.path.dirname(checkpoint)
        with open(checkpoint) as f:
            index_data = json.load(f)
        files = sorted(set(index_data["weight_map"].values()))
        return [os.path.join(folder, f) for f in files]
    return [checkpoint]


# --------------------------------------------------------- sizing and checks --
def get_max_layer_size(
    tree, no_split_module_patterns: Optional[list[str]] = None
) -> "tuple[int, list[str]]":
    """``(size_bytes, [names])`` of the largest unsplittable layer: a
    depth-1 subtree, except that a subtree whose leaves all share one
    leading axis of length L (stacked layers) counts one slice of it.
    ``no_split_module_patterns`` makes matching subtrees count whole."""
    no_split = no_split_module_patterns or []
    sizes = compute_module_sizes(tree)
    flat = named_parameters(tree)
    best, names = 0, []

    def _stack_depth(prefix: str) -> int:
        """Leading-axis length if every leaf under prefix shares one, else 0
        (a single matrix trivially shares its own first dim and does not
        count as stacked)."""
        leaves = [
            leaf for path, leaf in flat.items()
            if path.startswith(prefix + "/") or path == prefix
        ]
        if len(leaves) < 2:
            return 0
        dims = {
            getattr(leaf, "shape", (0,))[0] if getattr(leaf, "ndim", 0) > 0 else 0
            for leaf in leaves
        }
        return dims.pop() if len(dims) == 1 and 0 not in dims else 0

    top_level = {path.split("/")[0] for path in flat}
    for name in sorted(top_level):
        size = sizes.get(name, 0)
        stack = 0 if _matches_any(name, no_split) else _stack_depth(name)
        if stack > 1:
            size //= stack
        if size > best:
            best, names = size, [name]
        elif size == best and size > 0:
            names.append(name)
    return best, names


def calculate_maximum_sizes(tree) -> "tuple[int, tuple[int, list[str]]]":
    """``(total_bytes, (largest_layer_bytes, [names]))``."""
    return total_byte_size(tree), get_max_layer_size(tree)


def check_device_map(tree, device_map: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` listing the params no device-map prefix covers."""
    if "" in device_map:
        return
    uncovered = [
        path
        for path in named_parameters(tree)
        if not any(path == k or path.startswith(k + "/") for k in device_map)
    ]
    if uncovered:
        raise ValueError(
            f"device_map does not cover these parameters: {uncovered[:10]}"
            + (f" (+{len(uncovered) - 10} more)" if len(uncovered) > 10 else "")
        )


def check_tied_parameters_in_config(model) -> list[list[str]]:
    """Tied groups a config declares (``tie_word_embeddings``), else those
    found by object identity in a param tree."""
    config = getattr(model, "config", model)
    tie = getattr(config, "tie_word_embeddings", None)
    if tie is None and isinstance(config, Mapping):
        tie = config.get("tie_word_embeddings")
    if tie:
        return [["embed_tokens", "lm_head"]]
    if hasattr(model, "items") or not hasattr(model, "config"):
        try:
            return find_tied_parameters(model)
        except Exception:
            return []
    return []


def check_tied_parameters_on_same_device(
    tied_groups: list[list[str]], device_map: Mapping[str, Any]
) -> None:
    """Warn when a tied group is split across devices: offloading it would
    then untie it."""
    import warnings

    for group in tied_groups:
        devices = {lookup_device(device_map, path) for path in group}
        devices.discard(None)
        if len(devices) > 1:
            warnings.warn(
                f"tied parameters {group} are placed on multiple devices "
                f"{sorted(map(str, devices))}; they will be materialized as "
                "separate arrays and silently un-tied"
            )


def ensure_weights_retied(tree, tied_groups: Optional[list[list[str]]] = None):
    """Re-point tied groups (default: those found by identity) at one
    shared tensor."""
    return retie_parameters(tree, tied_groups or find_tied_parameters(tree))


def extract_submodules_state_dict(state_dict: Mapping[str, Any], submodule_names: list[str]) -> dict:
    """The entries of ``state_dict`` under any of ``submodule_names``, keys
    re-rooted at the submodule ('/' or '.' separated)."""
    out = {}
    for name in submodule_names:
        for key, value in state_dict.items():
            for sep in ("/", "."):
                if key.startswith(name + sep):
                    out[key[len(name + sep):]] = value
    return out
