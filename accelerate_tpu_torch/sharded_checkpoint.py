"""Sharded (per-process) checkpoint IO: the port of
``accelerate_tpu.sharded_checkpoint``, in its file format.

- **Save**: every process writes exactly the blocks it holds as replica 0
  (its coordinate is 0 on every mesh axis that does not split the leaf), so
  each region of each global array is written once, by the process that
  holds it. The blocks are those of the port's sharding plan
  (:func:`~accelerate_tpu_torch.parallel.sharding.shard_index` of the
  leaf's spec). One ``{prefix}-shard-{proc:05d}.bin`` (raw chunks at
  64-byte-aligned offsets, written by :mod:`.native.io` with a CRC32 each)
  and one ``.index.json`` per process: for each leaf its global shape,
  dtype and spec (the JAX package's ``_spec_to_json`` spelling), and for
  each chunk its global ``start``/``stop`` and its offset, size, CRC32,
  dtype and shape in the file. bf16 chunks are written as f32 and the leaf
  records ``"dtype": "bfloat16"``, as the JAX package does.
- **Load**: the indices of every process are read, and each leaf of the
  template gets this rank's block (or the whole array) assembled from
  whichever chunks intersect it, so a save under one mesh loads under
  another (and into the JAX package, and back).
- **Consolidate**: the whole arrays of a shard set as one dict, offline.

Trees are nested dicts (keys sorted), lists, tuples and namedtuples, named
by the ``/``-joined path that ``jax.tree_util.tree_flatten_with_path``
gives the same structure; ``None`` is no leaf.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointTopologyError",
    "ShardedTreeSnapshot",
    "consolidate_sharded",
    "flatten_with_path",
    "host_arrays",
    "is_sharded_checkpoint",
    "load_fsdp_model",
    "load_fsdp_optimizer",
    "load_sharded_pytree",
    "map_with_path",
    "merge_sharded_checkpoint",
    "read_saved_mesh",
    "resize_padded_bucket",
    "save_fsdp_model",
    "save_fsdp_optimizer",
    "save_sharded_pytree",
    "snapshot_sharded_pytree",
    "write_sharded_snapshot",
]

_SHARD_RE = re.compile(r"(?P<prefix>.+)-shard-(?P<proc>\d{5})\.index\.json")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed validation (CRC mismatch, short read, torn
    container, unparseable index); ``path`` names the file."""

    def __init__(self, message: str, path: Optional[str] = None):
        super().__init__(message)
        self.path = path


class CheckpointTopologyError(RuntimeError):
    """A checkpoint written under another mesh, loaded without an elastic
    re-shard; ``saved``/``current`` are the two ``{axis: size}`` maps."""

    def __init__(self, message: str, saved: Optional[dict] = None,
                 current: Optional[dict] = None):
        super().__init__(message)
        self.saved = saved
        self.current = current


def resize_padded_bucket(value: np.ndarray, target_len: int, key: str = "?") -> np.ndarray:
    """Re-pad a 1-D fused ZeRO-1 bucket for another replicate width: keep
    the common prefix, zero the new tail; raise when the cut would drop a
    nonzero element (the leaf was not a padded bucket)."""
    n = int(value.shape[0])
    target_len = int(target_len)
    if target_len == n:
        return value
    if target_len < n and np.any(value[target_len:]):
        raise ValueError(
            f"cannot elastically resize leaf {key!r} from {n} to {target_len}: the would-be-"
            "dropped tail contains nonzero elements, so this is not ZeRO-1 bucket padding "
            "(topology change touched a non-bucket leaf)")
    out = np.zeros((target_len,), dtype=value.dtype)
    out[:min(n, target_len)] = value[:min(n, target_len)]
    return out


# ------------------------------------------------------------------ trees --
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``[(key, child)]`` of a node in JAX's flatten order, or None for a
    leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_path(tree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in JAX's flatten order; ``None`` is no leaf. The
    root leaf's path is ``_root``."""
    out: list = []

    def visit(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append((path or "_root", node))
            return
        for k, v in kids:
            visit(v, f"{path}/{k}" if path else str(k))

    visit(tree, prefix)
    return out


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over ``tree``, keeping its containers (``None``
    stays ``None``)."""
    if tree is None:
        return None
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return type(tree)((k, map_with_path(fn, v, join(k))) for k, v in tree.items())
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, join(k)) for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    return fn(path or "_root", tree)


# --------------------------------------------------------- host copies --
def host_arrays(leaves: list, upcast_bf16: bool = False) -> list:
    """Owned host numpy copies of ``leaves`` (tensors, arrays or Python
    scalars). Device tensors go into pinned buffers with copies queued on
    the current stream behind the work that wrote them, then one
    synchronize: when this returns, every byte is on the host and the
    tensors may change. A CPU tensor (offloaded optimizer state too) is
    copied on the host. bf16 is kept as the ``|V2`` view of its bits, as
    ``np.savez`` writes the JAX package's bf16 leaves, or made f32 with
    ``upcast_bf16``."""
    out: list = [None] * len(leaves)
    pending = []
    for i, x in enumerate(leaves):
        if not isinstance(x, torch.Tensor):
            out[i] = np.array(x, copy=True)
            continue
        t = x.detach()
        if t.dtype == torch.bfloat16 and upcast_bf16:
            t = t.float()
        if t.device.type == "cuda":
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            pending.append(t.device)
        else:
            buf = t.clone(memory_format=torch.contiguous_format)
        out[i] = buf
    for dev in set(pending):
        torch.cuda.current_stream(dev).synchronize()
    for i, buf in enumerate(out):
        if isinstance(buf, torch.Tensor):
            out[i] = (buf.view(torch.int16).numpy().view("V2") if buf.dtype == torch.bfloat16
                      else buf.numpy())
    return out


def to_tensor(arr: np.ndarray, like=None, dtype=None, device=None) -> torch.Tensor:
    """A host array as a tensor of ``like``'s dtype and device (or
    ``dtype``/``device``): ``|V2`` arrays are bf16 bits."""
    arr = np.array(arr, order="C")  # an owned copy; a 0-d array stays 0-d
    if arr.dtype == np.dtype("V2") or arr.dtype.name == "bfloat16":  # bf16 bits (ml_dtypes too)
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    dtype = like.dtype if like is not None else dtype
    device = like.device if like is not None else device
    return t.to(device=device or "cpu", dtype=dtype or t.dtype)


# ------------------------------------------------------------- specs --
def _dim_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _spec_to_json(spec) -> Optional[list]:
    if spec is None:
        return None
    return [None if a is None else (list(a) if isinstance(a, (tuple, list)) else str(a))
            for a in spec]


def _spec_of(specs: dict, key: str):
    spec = specs.get(key) if specs else None
    return () if spec is None else tuple(spec)


def _global_shape(local_shape, spec, sizes: dict) -> list:
    out = []
    for d, n in enumerate(local_shape):
        axes = _dim_axes(spec[d]) if d < len(spec) else ()
        out.append(int(n) * int(np.prod([sizes[a] for a in axes])) if axes else int(n))
    return out


def _replica0(spec, mesh) -> bool:
    """True when this rank holds replica 0 of a leaf of ``spec``: its
    coordinate is 0 on every axis that does not split the leaf."""
    if mesh is None:
        return True
    used = {a for d in spec for a in _dim_axes(d)}
    return all(c == 0 for a, c in mesh.coords.items() if a not in used)


def _block(spec, shape, mesh) -> tuple:
    """This rank's region ``(start, stop)`` of a leaf of global ``shape``."""
    if mesh is None or not spec:
        return [0] * len(shape), list(shape)
    from .parallel.sharding import shard_index

    index = shard_index(spec, tuple(shape), mesh)
    return [s.start for s in index], [s.stop for s in index]


def _flat_specs(specs) -> dict:
    """A spec tree (parallel to a value tree) as ``{path: spec}``."""
    if specs is None:
        return {}
    from .parallel.sharding import PartitionSpec

    out: dict = {}

    def visit(node, path):
        if node is None or isinstance(node, PartitionSpec):
            out[path or "_root"] = node
            return
        kids = _children(node)
        if kids is None:
            out[path or "_root"] = node
            return
        for k, v in kids:
            visit(v, f"{path}/{k}" if path else str(k))

    visit(specs, "")
    return out


# ---------------------------------------------------------------- save --
@dataclass
class ShardedTreeSnapshot:
    """Host copies of one process's replica-0 chunks of a tree, with the
    index metadata. Nothing in it refers to device memory or to the live
    tensors: it can be written later, on another thread."""

    process_index: int
    num_processes: int
    chunks: dict = field(default_factory=dict)
    leaves_meta: dict = field(default_factory=dict)
    mesh_shape: Optional[dict] = None

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.chunks.values())


def _process(mesh) -> tuple:
    if mesh is not None:
        return mesh.rank, mesh.size
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def snapshot_sharded_pytree(tree, specs=None, mesh=None) -> ShardedTreeSnapshot:
    """The replica-0 chunks of ``tree`` this process writes (called on every
    process), copied to the host. ``specs`` is a tree of
    :class:`~accelerate_tpu_torch.parallel.sharding.PartitionSpec` (or
    ``{path: spec}``) naming how each leaf of ``tree`` (this rank's block)
    splits over ``mesh``; a leaf without one is replicated. No collective
    and no file IO."""
    from .resilience.reshard import mesh_shape_dict

    proc, nproc = _process(mesh)
    snap = ShardedTreeSnapshot(proc, nproc, mesh_shape=mesh_shape_dict(mesh))
    flat_specs = _flat_specs(specs)
    sizes = dict(mesh.shape) if mesh is not None else {}
    picked, metas = [], []
    for key, leaf in flatten_with_path(tree):
        spec = _spec_of(flat_specs, key)
        if not _replica0(spec, mesh):
            continue
        shape = list(leaf.shape) if hasattr(leaf, "shape") else []
        global_shape = _global_shape(shape, spec, sizes)
        start, stop = _block(spec, global_shape, mesh)
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtype = "bfloat16"
        else:
            dtype = str(np.asarray(leaf).dtype) if not isinstance(leaf, torch.Tensor) else str(
                torch.empty((), dtype=leaf.dtype).numpy().dtype)
        picked.append(leaf)
        metas.append((key, {"shape": global_shape, "dtype": dtype,
                            "spec": _spec_to_json(spec) if isinstance(leaf, torch.Tensor)
                            else None, "chunks": []}, start, stop))
    for i, (arr, (key, meta, start, stop)) in enumerate(
            zip(host_arrays(picked, upcast_bf16=True), metas)):
        ckey = f"c{i:07d}"
        snap.chunks[ckey] = arr
        meta["chunks"].append({"key": ckey, "start": start, "stop": stop})
        snap.leaves_meta[key] = meta
    return snap


def write_sharded_snapshot(snap: ShardedTreeSnapshot, directory: str, prefix: str = "model",
                           heartbeat=None) -> dict:
    """Write a snapshot as ``{prefix}-shard-{proc}.bin`` and its
    ``.index.json`` (file IO only; safe on a writer thread). Returns
    ``{filename: {"bytes": n}}`` for the commit manifest."""
    from .native import io as native_io

    os.makedirs(directory, exist_ok=True)
    proc = snap.process_index
    shard_file = os.path.join(directory, f"{prefix}-shard-{proc:05d}.bin")
    index_file = os.path.join(directory, f"{prefix}-shard-{proc:05d}.index.json")
    keys = list(snap.chunks)
    arrays = [snap.chunks[k] for k in keys]
    offsets, sizes, crcs = native_io.write_chunks(shard_file, arrays)
    layout = {k: {"offset": o, "nbytes": s, "crc32": c, "dtype": str(a.dtype),
                  "shape": list(a.shape)}
              for k, o, s, c, a in zip(keys, offsets, sizes, crcs, arrays)}
    for meta in snap.leaves_meta.values():
        for chunk in meta["chunks"]:
            chunk.update(layout[chunk["key"]])
    if heartbeat is not None:
        heartbeat(os.path.basename(shard_file))
    with open(index_file, "w") as f:
        json.dump({"process_index": proc, "num_processes": snap.num_processes,
                   "mesh": snap.mesh_shape, "leaves": snap.leaves_meta}, f)
        f.flush()
        os.fsync(f.fileno())
    if heartbeat is not None:
        heartbeat(os.path.basename(index_file))
    return {os.path.basename(shard_file): {"bytes": os.path.getsize(shard_file)},
            os.path.basename(index_file): {"bytes": os.path.getsize(index_file)}}


def save_sharded_pytree(tree, directory: str, prefix: str = "model", specs=None,
                        mesh=None) -> str:
    """:func:`snapshot_sharded_pytree` then :func:`write_sharded_snapshot`
    (on every process); returns this process's ``.bin`` path."""
    written = write_sharded_snapshot(snapshot_sharded_pytree(tree, specs, mesh), directory,
                                     prefix=prefix)
    return os.path.join(directory, next(n for n in written if n.endswith(".bin")))


# ---------------------------------------------------------------- load --
def read_saved_mesh(directory: str, prefix: str = "model") -> Optional[dict]:
    """The ``{axis: size}`` a shard set's indices recorded (None when none
    did)."""
    if not os.path.isdir(directory):
        return None
    for name in sorted(os.listdir(directory)):
        m = _SHARD_RE.fullmatch(name)
        if not m or m.group("prefix") != prefix:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                mesh = json.load(f).get("mesh")
        except (OSError, ValueError):
            continue
        if mesh:
            return {str(k): int(v) for k, v in mesh.items()}
    return None


def is_sharded_checkpoint(directory: str, prefix: str = "model") -> bool:
    return os.path.isdir(directory) and any(
        m and m.group("prefix") == prefix
        for m in (_SHARD_RE.fullmatch(name) for name in os.listdir(directory)))


def _read_indices(directory: str, prefix: str) -> dict:
    """Every process's index merged: ``{leaf: {shape, dtype, spec, chunks
    (each with its file)}}``."""
    merged: dict = {}
    found = False
    for name in sorted(os.listdir(directory)):
        m = _SHARD_RE.fullmatch(name)
        if not m or m.group("prefix") != prefix:
            continue
        found = True
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                index = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"unparseable shard index {path}: {e} (torn write? delete this checkpoint and "
                "resume from an older one)", path=path) from e
        stem = os.path.join(directory, name[:-len(".index.json")])
        for key, meta in index["leaves"].items():
            entry = merged.setdefault(key, {"shape": meta["shape"], "dtype": meta["dtype"],
                                            "spec": meta.get("spec"), "chunks": []})
            if entry["shape"] != meta["shape"]:
                raise ValueError(f"inconsistent shapes for {key!r} across shard indices: "
                                 f"{entry['shape']} vs {meta['shape']}")
            for chunk in meta["chunks"]:
                # a byte offset marks the raw .bin container, else a legacy npz entry
                entry["chunks"].append({**chunk, "file": stem + (".bin" if "offset" in chunk
                                                                 else ".npz")})
    if not found:
        raise FileNotFoundError(f"no '{prefix}-shard-*.index.json' under {directory}")
    return merged


class _ChunkReader:
    """Reads the requested chunks, one batched native call per file, each
    CRC-checked once and cached (legacy npz containers by ``np.load``)."""

    def __init__(self):
        self._open: dict = {}
        self._bin: dict = {}

    def read_many(self, chunks: list) -> None:
        from .native import io as native_io

        by_file: dict = {}
        for c in chunks:
            if "offset" in c and (c["file"], c["offset"]) not in self._bin:
                by_file.setdefault(c["file"], {})[c["offset"]] = c
        for file, want in by_file.items():
            want = list(want.values())
            try:
                bufs = native_io.read_chunks(
                    file, [c["offset"] for c in want], [c["nbytes"] for c in want],
                    [c["crc32"] for c in want] if all("crc32" in c for c in want) else None)
            except (ValueError, OSError) as e:
                raise CheckpointCorruptError(f"corrupt checkpoint chunk file {file}: {e}",
                                             path=file) from e
            for c, buf in zip(want, bufs):
                self._bin[(file, c["offset"])] = np.frombuffer(
                    buf, dtype=np.dtype(c["dtype"])).reshape(c["shape"])

    def read(self, chunk: dict) -> np.ndarray:
        file = chunk["file"]
        if "offset" in chunk:
            if (file, chunk["offset"]) not in self._bin:
                self.read_many([chunk])
            return self._bin[(file, chunk["offset"])]
        if file not in self._open:
            try:
                self._open[file] = np.load(file, allow_pickle=False)
            except Exception as e:  # a torn zip container
                raise CheckpointCorruptError(f"corrupt checkpoint shard file {file}: {e}",
                                             path=file) from e
        return self._open[file][chunk["key"]]

    def close(self) -> None:
        for handle in self._open.values():
            handle.close()
        self._open.clear()
        self._bin.clear()


def _assemble_region(meta: dict, start: list, stop: list, reader: _ChunkReader,
                     dtype) -> np.ndarray:
    """Region ``[start, stop)`` of a leaf from the chunks that intersect
    it; a gap or an overlap raises."""
    out_shape = [e - s for s, e in zip(start, stop)]
    out = np.empty(out_shape, dtype=dtype)
    hits = []
    for c in meta["chunks"]:
        lo = [max(a, b) for a, b in zip(start, c["start"])]
        hi = [min(a, b) for a, b in zip(stop, c["stop"])]
        if all(a < b for a, b in zip(lo, hi)):
            hits.append((c, lo, hi))
    reader.read_many([c for c, _, _ in hits])
    filled = 0
    for c, lo, hi in hits:
        data = reader.read(c)
        src = tuple(slice(a - cs, b - cs) for a, b, cs in zip(lo, hi, c["start"]))
        dst = tuple(slice(a - s, b - s) for a, b, s in zip(lo, hi, start))
        out[dst] = data[src]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    expected = int(np.prod(out_shape)) if out_shape else 1
    if not meta["chunks"] and expected == 0:
        return out
    if filled != expected:
        kind = "incomplete (gap)" if filled < expected else (
            "over-covered (overlapping chunks — stale shard files from a previous save with "
            "a different process count/mesh in this dir?)")
        raise ValueError(f"sharded checkpoint {kind}: region {start}..{stop} has "
                         f"{filled}/{expected} elements covered")
    return out


def _host_dtype(meta: dict):
    return np.float32 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"])


def load_sharded_pytree(template, directory: str, prefix: str = "model", specs=None,
                        mesh=None, elastic: bool = False):
    """A tree like ``template`` read from a shard set: each tensor leaf
    gets this rank's block under its spec (``specs`` as in
    :func:`snapshot_sharded_pytree`) in the template leaf's dtype and on
    its device, assembled from the chunks that intersect it, whatever mesh
    wrote them; any other leaf is read whole, as its type. ``elastic``
    re-pads 1-D leaves whose saved length differs (the fused ZeRO-1
    buckets, :func:`resize_padded_bucket`)."""
    merged = _read_indices(directory, prefix)
    flat_specs = _flat_specs(specs)
    reader = _ChunkReader()

    def restore(key, leaf):
        if key not in merged:
            raise KeyError(f"sharded checkpoint missing leaf {key!r}")
        meta = merged[key]
        shape = list(meta["shape"])
        if not isinstance(leaf, torch.Tensor):
            value = _assemble_region(meta, [0] * len(shape), shape, reader, _host_dtype(meta))
            if isinstance(leaf, np.ndarray):
                return value.astype(leaf.dtype)
            return type(leaf)(value.item()) if isinstance(leaf, (bool, int, float)) else value
        spec = _spec_of(flat_specs, key)
        want = _global_shape(list(leaf.shape), spec, dict(mesh.shape) if mesh else {})
        if want != shape:
            if not (elastic and len(shape) == 1 and leaf.dim() == 1):
                raise ValueError(f"shape mismatch for {key!r}: live {want} vs saved {shape}"
                                 + ("" if elastic else " (a topology change? an elastic load "
                                    "re-pads 1-D ZeRO-1 buckets)"))
            full = resize_padded_bucket(
                _assemble_region(meta, [0], shape, reader, _host_dtype(meta)), want[0], key)
            start, stop = _block(spec, want, mesh)
            return to_tensor(full[start[0]:stop[0]], like=leaf)
        start, stop = _block(spec, shape, mesh)
        return to_tensor(_assemble_region(meta, start, stop, reader, _host_dtype(meta)),
                         like=leaf)

    try:
        return map_with_path(restore, template)
    finally:
        reader.close()


def consolidate_sharded(directory: str, prefix: str = "model") -> dict:
    """The whole arrays of a shard set, ``{path: numpy}`` (bf16 leaves as
    f32, as the JAX package gives them)."""
    merged = _read_indices(directory, prefix)
    reader = _ChunkReader()
    try:
        return {key: _assemble_region(meta, [0] * len(meta["shape"]), meta["shape"], reader,
                                      _host_dtype(meta))
                for key, meta in merged.items()}
    finally:
        reader.close()


def merge_sharded_checkpoint(directory: str, output_path: str, prefix: str = "model",
                             safe_serialization: bool = True) -> str:
    """A shard set consolidated into one ``.safetensors`` (the port's own
    writer) or ``.npz`` file."""
    flat = consolidate_sharded(directory, prefix)
    if safe_serialization and not output_path.endswith(".npz"):
        from .utils.modeling import save_safetensors

        if not output_path.endswith(".safetensors"):
            output_path += ".safetensors"
        save_safetensors(flat, output_path)
    else:
        if not output_path.endswith(".npz"):
            output_path += ".npz"
        with open(output_path, "wb") as f:
            np.savez(f, **flat)
    logger.info("consolidated %d leaves into %s", len(flat), output_path)
    return output_path


# ------------------------------------------- the reference's FSDP spellings --
def _fsdp_prefix(base: str, index: int) -> str:
    return base if index == 0 else f"{base}_{index}"


def _plan_of(accelerator):
    plan = getattr(accelerator, "sharding_plan", None)
    return (None, None) if plan is None else (plan.param_specs, plan.mesh)


def save_fsdp_model(fsdp_plugin, accelerator, model, output_dir: str, model_index: int = 0,
                    adapter_only: bool = False) -> str:
    """A sharded save of a prepared param tree (each rank its blocks, under
    the accelerator's plan)."""
    specs, mesh = _plan_of(accelerator)
    return save_sharded_pytree(model, output_dir, _fsdp_prefix("model", model_index), specs,
                               mesh)


def load_fsdp_model(fsdp_plugin, accelerator, model, input_dir: str, model_index: int = 0,
                    adapter_only: bool = False):
    """The prepared param tree read back (each rank its blocks, from
    whatever mesh wrote it)."""
    specs, mesh = _plan_of(accelerator)
    return load_sharded_pytree(model, input_dir, _fsdp_prefix("model", model_index), specs,
                               mesh)


def save_fsdp_optimizer(fsdp_plugin, accelerator, optimizer, model, output_dir: str,
                        optimizer_index: int = 0) -> str:
    """A sharded save of a prepared optimizer's state (its tree of
    :func:`~accelerate_tpu_torch.checkpointing.optimizer_state_tree`)."""
    from .checkpointing import optimizer_state_tree

    tree, specs = optimizer_state_tree(optimizer)
    return save_sharded_pytree(tree, output_dir, _fsdp_prefix("optimizer", optimizer_index),
                               specs, _plan_of(accelerator)[1])


def load_fsdp_optimizer(fsdp_plugin, accelerator, optimizer, model, input_dir: str,
                        optimizer_index: int = 0, adapter_only: bool = False):
    """A prepared optimizer's state read back into it, in place."""
    from .checkpointing import load_optimizer_state

    return load_optimizer_state(optimizer, input_dir,
                                _fsdp_prefix("optimizer", optimizer_index),
                                mesh=_plan_of(accelerator)[1])
