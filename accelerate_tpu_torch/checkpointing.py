"""Checkpoint save and load: the port of ``accelerate_tpu.checkpointing``, in
its directory layout and file formats.

A checkpoint directory holds ``model.npz`` (or the sharded
``model-shard-<proc>.bin`` + ``.index.json`` of :mod:`.sharded_checkpoint`),
``optimizer.npz`` (or its shard set), ``scheduler.json``,
``dataloader.json`` (``.pkl`` when its state does not survive JSON),
``random_states_<rank>.pkl``, ``custom_checkpoint_<i>.npz`` with its
``.meta.json``, one ``_DONE.rank<k>.json`` per process and the
``_COMMITTED`` manifest, written last. Arrays are named by their
``/``-joined tree path (:func:`~.sharded_checkpoint.flatten_with_path`,
the path ``jax.tree_util`` gives), and a bf16 leaf is stored as the
``|V2`` view of its bits, as ``np.savez`` stores the JAX package's, so
each side loads the other's model files. The optimizer file holds the
port's own tree (:func:`optimizer_state_tree`): the torch optimizer's state
and hyperparameters, the accumulation counters and buffer, and the fp16
loss scale, as ``AcceleratedOptimizer.state_dict`` defines them.

The port's step updates params and optimizer state in place, so a save
first copies every byte it writes to the host (pinned buffers, copies
queued on the current stream, one synchronize): when ``save_state`` (or
its snapshot phase, for an async save) returns, the snapshot owns its
bytes. A load writes into the live tensors in place, so prepared steps,
which hold those tensors, stay valid.

The commit protocol is the JAX package's: every save writes into
``<dir>.tmp``, fsyncs each file, drops a fsync'd ``_DONE.rank<k>.json``,
and the main process (after every rank's marker) writes ``_COMMITTED``
and ``os.replace``s the staging directory onto the final name. A directory
without the marker is never loaded by ``"latest"``; a staging directory
with the marker was crashed between marker and rename, and is repaired.
``ACCELERATE_CKPT_CRASH_POINT`` (``mid_write``, ``before_replace``)
kills the process there, for crash tests; ``ACCELERATE_CKPT_COMMIT_TIMEOUT``
bounds the wait for the ranks' markers.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import re
import shutil
import signal
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from .sharded_checkpoint import (  # noqa: F401  (public re-exports)
    CheckpointCorruptError,
    CheckpointTopologyError,
    _assemble_region,
    _ChunkReader,
    _global_shape,
    _host_dtype,
    _read_indices,
    flatten_with_path,
    host_arrays,
    is_sharded_checkpoint,
    map_with_path,
    resize_padded_bucket,
    to_tensor,
)

logger = logging.getLogger(__name__)

__all__ = [
    "COMMITTED_MARKER",
    "CheckpointCorruptError",
    "CheckpointSnapshot",
    "CheckpointTopologyError",
    "clean_stale_staging",
    "commit_snapshot",
    "find_latest_checkpoint",
    "flatten_pytree",
    "is_committed_checkpoint",
    "load_accelerator_state",
    "load_checkpoint_in_model",
    "load_flat",
    "load_optimizer_state",
    "optimizer_state_tree",
    "repair_interrupted_commit",
    "resize_padded_bucket",
    "rotate_checkpoints",
    "save_accelerator_state",
    "save_model",
    "save_pytree",
    "snapshot_accelerator_state",
    "unflatten_into",
    "write_and_commit",
    "write_snapshot",
]

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "dataloader"
RNG_NAME = "random_states"
CUSTOM_NAME = "custom_checkpoint"
SAFE_MODEL_NAME = MODEL_NAME
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
SAFE_WEIGHTS_PATTERN_NAME = "model{suffix}.safetensors"
WEIGHTS_NAME = "model.npz"
WEIGHTS_INDEX_NAME = "model.npz.index.json"
WEIGHTS_PATTERN_NAME = "model{suffix}.npz"
RNG_STATE_NAME = RNG_NAME
SCALER_NAME = "scaler"  # the fp16 scale state lives inside the optimizer state
PROFILE_PATTERN_NAME = "profile_{suffix}.json"

COMMITTED_MARKER = "_COMMITTED"
STAGING_SUFFIX = ".tmp"
_TRASH_SUFFIX = ".trash"
_DONE_RE = re.compile(r"_DONE\.rank(\d{5})\.json")
_AUTO_DIR_RE = re.compile(r"checkpoint_(\d+)")


def _maybe_crash(point: str) -> None:
    """SIGKILL this process when ``ACCELERATE_CKPT_CRASH_POINT`` names
    ``point`` (crash-consistency tests; one environment lookup otherwise)."""
    if os.environ.get("ACCELERATE_CKPT_CRASH_POINT") == point:
        os.kill(os.getpid(), signal.SIGKILL)


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


def is_committed_checkpoint(directory: str) -> bool:
    """True when ``directory`` finished its save (its marker is there)."""
    return os.path.isfile(os.path.join(directory, COMMITTED_MARKER))


# ---------------------------------------------------------- tree <-> flat --
def flatten_pytree(tree) -> dict:
    """``{path: numpy}`` of every leaf, as owned host copies (bf16 leaves
    as ``|V2``)."""
    items = flatten_with_path(tree)
    return dict(zip((k for k, _ in items), host_arrays([v for _, v in items])))


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a saved array's numpy dtype (``|V2``: bf16)."""
    if dtype == np.dtype("V2"):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _FlatSource:
    """Arrays of an npz (or any ``{path: array}``): the whole of each."""

    def __init__(self, flat: dict):
        self.flat = flat
        self._shapes = {k: list(np.shape(v)) for k, v in flat.items()}

    def shapes(self) -> dict:
        return self._shapes

    def dtype(self, key: str) -> torch.dtype:
        return _torch_dtype(np.asarray(self.flat[key]).dtype)

    def block(self, key: str, spec, mesh, want: Optional[list] = None) -> np.ndarray:
        value = np.asarray(self.flat[key])
        if want is not None and list(value.shape) != list(want):
            value = resize_padded_bucket(value, want[0], key)
        if mesh is None or not spec:
            return value
        from .parallel.sharding import shard_index

        return value[shard_index(spec, value.shape, mesh)]


class _ShardedSource:
    """A shard set: each block assembled from the chunks that meet it."""

    def __init__(self, directory: str, prefix: str):
        self.merged = _read_indices(directory, prefix)
        self.reader = _ChunkReader()
        self._shapes = {k: list(m["shape"]) for k, m in self.merged.items()}

    def shapes(self) -> dict:
        return self._shapes

    def dtype(self, key: str) -> torch.dtype:
        name = self.merged[key]["dtype"]
        return _torch_dtype(np.dtype("V2") if name == "bfloat16" else np.dtype(name))

    def block(self, key: str, spec, mesh, want: Optional[list] = None) -> np.ndarray:
        from .sharded_checkpoint import _block

        meta = self.merged[key]
        shape = list(meta["shape"])
        if want is not None and shape != list(want):
            full = resize_padded_bucket(
                _assemble_region(meta, [0], shape, self.reader, _host_dtype(meta)), want[0], key)
            start, stop = _block(spec, list(want), mesh)
            return full[start[0]:stop[0]]
        start, stop = _block(spec, shape, mesh)
        return _assemble_region(meta, start, stop, self.reader, _host_dtype(meta))

    def close(self) -> None:
        self.reader.close()


def _want(key: str, leaf, spec, mesh, saved: list, elastic: bool) -> Optional[list]:
    """The live global shape of a leaf when it differs from the saved one
    and the load may re-pad it (a 1-D leaf under ``elastic``); None when
    they agree; raises otherwise."""
    sizes = dict(mesh.shape) if mesh is not None else {}
    live = _global_shape(list(leaf.shape), spec, sizes)
    if live == list(saved):
        return None
    if elastic and len(saved) == 1 and len(live) == 1:
        return live
    raise ValueError(f"shape mismatch for {key!r}: live {live} vs saved {list(saved)}"
                     + ("" if elastic else " (a topology change? an elastic load re-pads 1-D "
                        "ZeRO-1 buckets)"))


def _restore_leaf(key: str, leaf, source, spec, mesh, elastic: bool):
    """The value of one leaf like ``leaf``: a tensor of its dtype on its
    device (this rank's block under ``spec``), a numpy array or a Python
    scalar of its type."""
    shapes = source.shapes()
    if key not in shapes:
        raise KeyError(f"checkpoint missing key {key!r}")
    if isinstance(leaf, torch.Tensor):
        want = _want(key, leaf, spec, mesh, shapes[key], elastic)
        return to_tensor(source.block(key, spec, mesh, want), like=leaf)
    value = source.block(key, (), None)
    if isinstance(leaf, np.ndarray):
        return np.asarray(value, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(np.asarray(value).item())
    return value


def unflatten_into(template, flat: dict, elastic: bool = False, specs=None, mesh=None):
    """A tree like ``template`` with the values of ``flat`` (``{path:
    array}``): each tensor leaf a new tensor of the template leaf's dtype
    on its device (under ``specs`` and ``mesh``, this rank's block of the
    saved array), numpy and Python leaves as their type. ``elastic``
    re-pads a 1-D leaf whose saved length differs (a fused ZeRO-1
    bucket)."""
    from .sharded_checkpoint import _flat_specs

    source = _FlatSource(flat)
    spec_of = _flat_specs(specs)
    return map_with_path(lambda k, leaf: _restore_leaf(
        k, leaf, source, tuple(spec_of.get(k) or ()), mesh, elastic), template)


def save_pytree(tree, path: str) -> None:
    """``tree`` as an npz of its paths."""
    with open(path, "wb") as f:
        np.savez(f, **flatten_pytree(tree))


def load_flat(path: str) -> dict:
    """An npz as ``{path: array}``; a torn container raises
    :class:`CheckpointCorruptError` naming the file."""
    try:
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as e:  # a torn zip container, a truncated header, ...
        raise CheckpointCorruptError(f"corrupt checkpoint file {path}: {e} (torn write? resume "
                                     "from an older committed checkpoint)", path=path) from e


# ------------------------------------------------------- optimizer state --
def _opt_param_specs(opt) -> list:
    """The spec of each tensor the torch optimizer owns, over the plan's
    mesh: the param's, a fused ZeRO-1 chunk's ``(axis,)``, or an
    annotated ZeRO-1 rank's rows ``(axis,)``."""
    from .parallel.sharding import PartitionSpec, _leaves

    plan = opt.plan
    n = len(opt.params)
    if plan is None or not plan.distributed:
        return [PartitionSpec()] * n
    if opt.zero1 is not None:
        return [PartitionSpec(plan.zero1_axis)] * n
    specs = [PartitionSpec(*s) for s in _leaves(plan.param_specs)]
    if opt.zero1_rows is not None:
        return [PartitionSpec(plan.zero1_axis) if rows is not None else s
                for s, rows in zip(specs, opt.zero1_rows.rows)]
    return specs


def _layout_specs(opt) -> list:
    """The spec of each piece of the flat gradient layout (the
    accumulation buffer's): the chunks' under fused ZeRO-1, else the
    params'."""
    from .parallel.sharding import PartitionSpec, _leaves

    if opt.zero1 is not None:
        return _opt_param_specs(opt)
    plan = opt.plan
    if plan is None or not plan.distributed:
        return [PartitionSpec()] * len(opt._grad_layout)
    return [PartitionSpec(*s) for s in _leaves(plan.param_specs)]


def _reduced_dim(opt, p, name: str, full: list, reduced: list) -> int:
    """Which dim of a param of shape ``full`` a state of shape ``reduced``
    (one dim fewer) drops: adafactor's ``v_row``/``v_col`` by its factored
    dims, else the first dim whose removal gives the shape."""
    from .optimizer import Adafactor, _factored_dims

    torch_opt = opt.optimizer
    if isinstance(torch_opt, Adafactor) and name in ("v_row", "v_col"):
        split = torch_opt.split.get(p)
        group = next(g for g in torch_opt.param_groups if any(q is p for q in g["params"]))
        dims = _factored_dims(split.shape if split is not None else tuple(p.shape),
                              group["factored"], group["min_dim_size_to_factor"])
        if dims is not None:
            d1, d0 = dims
            return d0 if name == "v_row" else d1
    for d in range(len(full)):
        if full[:d] + full[d + 1:] == list(reduced):
            return d
    raise NotImplementedError(f"optimizer state {name!r} of shape {reduced} is not a param of "
                              f"shape {full} less one dim")


def _state_spec(opt, p, pspec, name: str, state_shape: list, param_shape: list):
    """The spec of a state tensor from its param's: the same for the same
    rank, ``()`` for a scalar, the param's less the dropped dim for one dim
    fewer (shapes both local or both global)."""
    from .parallel.sharding import PartitionSpec

    if len(state_shape) == 0:
        return PartitionSpec()
    if len(state_shape) == len(param_shape):
        return pspec
    if len(state_shape) == len(param_shape) - 1:
        d = _reduced_dim(opt, p, name, list(param_shape), list(state_shape))
        entries = list(pspec) + [None] * (len(param_shape) - len(pspec))
        return PartitionSpec(*(entries[:d] + entries[d + 1:]))
    raise NotImplementedError(f"optimizer state {name!r} of shape {state_shape} beside a param "
                              f"of shape {param_shape}")


def _numeric(v) -> bool:
    if isinstance(v, (list, tuple)):
        return all(isinstance(x, (bool, int, float)) for x in v)
    return isinstance(v, (bool, int, float))


def optimizer_state_tree(opt) -> tuple:
    """``(tree, specs)`` of a prepared :class:`~.optimizer.
    AcceleratedOptimizer`: the tree of ``state_dict()["opt_state"]`` —
    ``inner`` (the torch optimizer's ``state`` by param index and its
    numeric ``param_groups`` hyperparameters), ``mini_step``,
    ``gradient_step``, ``acc_grads`` (one piece per tensor of the flat
    gradient layout), ``loss_scale`` and ``growth_count`` — with the live
    tensors as leaves, and the spec tree of its sharded save."""
    from .parallel.sharding import PartitionSpec

    torch_opt = opt.optimizer
    pspecs = _opt_param_specs(opt)
    state, state_specs = {}, {}
    for i, p in enumerate(opt.params):
        st = torch_opt.state.get(p)
        if not st:
            continue
        state[i] = dict(st)
        state_specs[i] = {name: _state_spec(opt, p, pspecs[i], name, list(np.shape(v)),
                                            list(p.shape)) for name, v in st.items()}
    groups = [{k: v for k, v in g.items() if k != "params" and _numeric(v)}
              for g in torch_opt.param_groups]
    acc = acc_specs = None
    if opt.acc_grads is not None:
        layout = opt._grad_layout
        acc = list(opt.acc_grads.split([t.numel() for t in layout]))
        acc = [a.view_as(t) for a, t in zip(acc, layout)]
        acc_specs = _layout_specs(opt)
    tree = {"inner": {"state": state, "param_groups": groups}, "mini_step": opt.mini_step,
            "gradient_step": opt.gradient_step, "acc_grads": acc,
            "loss_scale": opt.loss_scale, "growth_count": opt.growth_count}
    specs = {"inner": {"state": state_specs}, "acc_grads": acc_specs}
    return tree, specs


def load_optimizer_state(opt, source, prefix: str = OPTIMIZER_NAME, mesh=None,
                         elastic: bool = False) -> Any:
    """Restore a prepared optimizer from ``source`` (a ``{path: array}``
    of an npz, or a directory holding the ``prefix`` shard set) into its
    live state, in place where the live tensor has the shape: each state
    tensor becomes this rank's block (under the spec of
    :func:`optimizer_state_tree`) in the live dtype, on the device (or the
    pinned host, when offloaded) where the live one is. State the
    optimizer has not made yet (no step taken) is made in the saved dtype;
    a scalar count becomes a Python int, or torch's CPU float32 ``step``.
    Returns ``opt.opt_state`` (the same object)."""
    src = (_ShardedSource(source, prefix) if isinstance(source, str) else _FlatSource(source))
    try:
        _load_optimizer(opt, src, mesh, elastic)
    finally:
        if isinstance(src, _ShardedSource):
            src.close()
    return opt.opt_state


def _load_optimizer(opt, src, mesh, elastic: bool) -> None:
    torch_opt = opt.optimizer
    shapes = src.shapes()
    sizes = dict(mesh.shape) if mesh is not None else {}
    params = opt.params
    pspecs = _opt_param_specs(opt)
    by_index: dict = {}
    for key in shapes:
        if key.startswith("inner/state/"):
            _, _, i, name = key.split("/", 3)
            by_index.setdefault(int(i), {})[name] = key
    extra = sorted(set(by_index) - set(range(len(params))))
    if extra:
        raise ValueError(f"the checkpoint holds optimizer state for params {extra}, but the "
                         f"optimizer owns {len(params)} tensors")
    host = opt.offload is not None
    with torch.no_grad():
        for i, p in enumerate(params):
            if i not in by_index:
                continue
            st = torch_opt.state[p]
            pglobal = _global_shape(list(p.shape), pspecs[i], sizes)
            for name, key in by_index[i].items():
                saved = shapes[key]
                spec = _state_spec(opt, p, pspecs[i], name, saved, pglobal)
                want = None
                if len(saved) == len(pglobal) and saved != pglobal:
                    if not (elastic and len(saved) == 1):
                        raise ValueError(f"shape mismatch for {key!r}: live {pglobal} vs saved "
                                         f"{saved}")
                    want = pglobal
                arr = src.block(key, spec, mesh, want)
                cur = st.get(name)
                if isinstance(cur, torch.Tensor):
                    value = to_tensor(arr, dtype=cur.dtype, device=cur.device)
                    if cur.shape == value.shape:
                        cur.copy_(value)
                    else:
                        st[name] = value
                elif isinstance(cur, (bool, int, float)):
                    st[name] = type(cur)(np.asarray(arr).item())
                elif np.ndim(arr) == 0 and np.asarray(arr).dtype.kind in "iub":
                    st[name] = int(np.asarray(arr).item())
                elif np.ndim(arr) == 0:  # torch's CPU float32 ``step``
                    st[name] = torch.tensor(float(np.asarray(arr).item()), dtype=torch.float32)
                else:
                    value = to_tensor(arr, dtype=src.dtype(key), device="cpu" if host else p.device)
                    st[name] = value.pin_memory() if host and p.is_cuda else value
        for g, group in enumerate(torch_opt.param_groups):
            for hyper, cur in list(group.items()):
                if hyper == "params" or not _numeric(cur):
                    continue
                if isinstance(cur, (list, tuple)):
                    keys = [f"inner/param_groups/{g}/{hyper}/{j}" for j in range(len(cur))]
                    if all(k in shapes for k in keys):
                        group[hyper] = type(cur)(type(c)(np.asarray(src.block(k, (), None)).item())
                                                 for c, k in zip(cur, keys))
                elif f"inner/param_groups/{g}/{hyper}" in shapes:
                    value = np.asarray(src.block(f"inner/param_groups/{g}/{hyper}", (), None))
                    group[hyper] = type(cur)(value.item())
        opt.mini_step = int(np.asarray(src.block("mini_step", (), None)).item())
        opt.gradient_step = int(np.asarray(src.block("gradient_step", (), None)).item())
        layout = opt._grad_layout
        acc_keys = [f"acc_grads/{j}" for j in range(len(layout))]
        if all(k in shapes for k in acc_keys):
            lspecs = _layout_specs(opt)
            pieces = []
            for t, k, spec in zip(layout, acc_keys, lspecs):
                live = _global_shape(list(t.shape), spec, sizes)
                want = live if (elastic and live != shapes[k] and len(live) == 1) else None
                pieces.append(to_tensor(src.block(k, spec, mesh, want), dtype=src.dtype(k),
                                        device=t.device).reshape(-1))
            opt.acc_grads = torch.cat(pieces)
        else:
            opt.acc_grads = None
        device = params[0].device
        for name in ("loss_scale", "growth_count"):
            setattr(opt, name, to_tensor(src.block(name, (), None), dtype=src.dtype(name),
                                         device=device) if name in shapes else None)


# -------------------------------------------------------- commit protocol --
def _checkpoint_dir(accelerator, output_dir: Optional[str]) -> str:
    """The final directory (automatic ``checkpoint_<i>`` naming under
    ``<output_dir or project_dir/checkpoints>``); rotation runs after the
    commit, never here."""
    pc = accelerator.project_configuration
    if output_dir is None:
        if not pc.automatic_checkpoint_naming:
            raise ValueError("pass output_dir or enable automatic_checkpoint_naming")
        output_dir = os.path.join(accelerator.project_dir or ".", "checkpoints")
    if pc.automatic_checkpoint_naming:
        folder = os.path.join(output_dir, f"checkpoint_{pc.iteration}")
        if os.path.isdir(folder):
            raise FileExistsError(f"Checkpoint {folder} already exists — iteration was not "
                                  "advanced")
        output_dir = folder
    return output_dir


def repair_interrupted_commit(final_dir: str) -> bool:
    """Finish a commit that crashed between its marker and its rename (a
    ``<final>.tmp`` holding the marker). True when it repaired one."""
    tmp = final_dir + STAGING_SUFFIX
    if not (os.path.isdir(tmp) and is_committed_checkpoint(tmp)):
        return False
    trash = final_dir + _TRASH_SUFFIX
    shutil.rmtree(trash, ignore_errors=True)
    if os.path.isdir(final_dir):
        os.replace(final_dir, trash)
    os.replace(tmp, final_dir)
    shutil.rmtree(trash, ignore_errors=True)
    parent = os.path.dirname(os.path.abspath(final_dir))
    if os.path.isdir(parent):
        _fsync_path(parent)
    logger.warning("repaired interrupted checkpoint commit: %s -> %s", tmp, final_dir)
    return True


def clean_stale_staging(final_dir: str, active: Optional[set] = None) -> None:
    """Remove the partial ``.tmp``/``.trash`` a crashed save left (repairing
    committed ones first), the sibling ``checkpoint_*`` ones too under
    automatic naming; ``active`` staging dirs (in-flight async saves) are
    left alone."""
    active = active or set()
    candidates = {final_dir}
    parent = os.path.dirname(os.path.abspath(final_dir))
    if _AUTO_DIR_RE.fullmatch(os.path.basename(final_dir)) and os.path.isdir(parent):
        for name in os.listdir(parent):
            if _AUTO_DIR_RE.fullmatch(name.removesuffix(STAGING_SUFFIX)):
                candidates.add(os.path.join(parent, name.removesuffix(STAGING_SUFFIX)))
    for final in sorted(candidates):
        tmp = final + STAGING_SUFFIX
        if tmp in active or repair_interrupted_commit(final):
            continue
        if os.path.isdir(tmp):
            logger.warning("removing partial checkpoint staging dir %s", tmp)
            shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(final + _TRASH_SUFFIX, ignore_errors=True)


def rotate_checkpoints(root: str, total_limit: int, just_committed: str) -> None:
    """Keep the ``total_limit`` newest ``checkpoint_<i>`` dirs, after a
    commit; the one just committed and the newest committed one are never
    removed."""
    if total_limit is None or not os.path.isdir(root):
        return
    existing = sorted((d for d in os.listdir(root) if _AUTO_DIR_RE.fullmatch(d)),
                      key=lambda d: int(d.split("_")[1]))
    committed = [d for d in existing if is_committed_checkpoint(os.path.join(root, d))]
    protect = {os.path.basename(os.path.normpath(just_committed))}
    if committed:
        protect.add(committed[-1])
    for victim in existing[:max(0, len(existing) - max(1, int(total_limit)))]:
        if victim not in protect:
            shutil.rmtree(os.path.join(root, victim), ignore_errors=True)


@dataclass
class _Artifact:
    """One file-to-be: ``npz`` (payload ``{path: array}``), ``sharded``
    (a :class:`~.sharded_checkpoint.ShardedTreeSnapshot`, ``name`` the
    prefix), ``text`` or ``bytes``."""

    kind: str
    name: str
    payload: Any


@dataclass
class CheckpointSnapshot:
    """Everything one process writes for a save, on the host and detached
    from the live state, and the save's timings: ``snapshot_s`` (the copy
    to the host, what the train loop waits for), then ``write_s`` and
    ``commit_s`` (the writer's, on the caller's thread or the writer
    thread). Its array payloads are dropped once written."""

    final_dir: str
    artifacts: list
    process_index: int
    num_processes: int
    is_main: bool
    sharded: bool
    save_on_each_node: bool = False
    is_local_main: bool = False
    rotation: Optional[tuple] = None
    iteration: Optional[int] = None
    nbytes: int = 0
    snapshot_s: float = 0.0
    write_s: float = 0.0
    commit_s: float = 0.0
    mesh_shape: Optional[dict] = None

    @property
    def staging_dir(self) -> str:
        return self.final_dir + STAGING_SUFFIX

    @property
    def is_committer(self) -> bool:
        return self.is_main or (self.save_on_each_node and self.is_local_main)


def _encode_small_states(accelerator) -> list:
    """Scheduler, loader and custom-object states, encoded at snapshot
    time so the writer never touches a live object."""
    artifacts = []
    for i, sched in enumerate(accelerator._schedulers):
        suffix = "" if i == 0 else f"_{i}"
        artifacts.append(_Artifact("text", f"{SCHEDULER_NAME}{suffix}.json",
                                   json.dumps(sched.state_dict())))
    for i, dl in enumerate(accelerator._dataloaders):
        base = f"{SAMPLER_NAME}{'' if i == 0 else f'_{i}'}"
        state = dl.state_dict()
        payload = None
        if not getattr(dl, "_stateful_inner", False):
            try:
                payload = json.dumps(state)
                if json.loads(payload) != state:  # a lossy round trip takes the pickle
                    payload = None
            except (TypeError, ValueError):
                payload = None
        if payload is None:
            artifacts.append(_Artifact("bytes", base + ".pkl", pickle.dumps(state)))
        else:
            artifacts.append(_Artifact("text", base + ".json", payload))
    for i, obj in enumerate(accelerator._custom_objects):
        flat = flatten_pytree(obj.state_dict())
        name = f"{CUSTOM_NAME}_{i}.npz"
        artifacts.append(_Artifact("npz", name, flat))
        artifacts.append(_Artifact("text", name + ".meta.json", json.dumps({"keys": sorted(flat)})))
    return artifacts


def _trees_to_save(accelerator, params, opt_state) -> tuple:
    """``(models, model_specs, optimizers)`` a save writes: the given
    params (with the plan they were prepared under) or every prepared
    model; the optimizer whose state ``opt_state`` is, or every one."""
    if params is not None:
        plans = [accelerator._plan_for(params)]
        models = [params]
    else:
        models, plans = list(accelerator._models), list(accelerator._plans)
    optimizers = list(accelerator._optimizers)
    if opt_state is not None:
        optimizers = [o for o in optimizers if o.opt_state is opt_state]
        if not optimizers:
            raise ValueError("opt_state is not the state of a prepared optimizer (the port's "
                             "optimizers own their state: pass the one prepare returned)")
    return models, plans, [o for o in optimizers if o.optimizer is not None]


def snapshot_accelerator_state(accelerator, output_dir: Optional[str] = None, params=None,
                               opt_state=None, save_on_each_node: bool = False,
                               sharded: Optional[bool] = None,
                               active_staging: Optional[set] = None) -> CheckpointSnapshot:
    """The fast phase of a save: resolve the directory, copy this process's
    arrays (its replica-0 blocks, when sharded) to the host, encode the
    small states, advance the iteration counter. When it returns the
    snapshot owns every byte; the live state may change. ``sharded=None``
    shards when more than one process runs a plan that splits or buckets
    the state."""
    from .resilience.reshard import mesh_shape_dict
    from .sharded_checkpoint import snapshot_sharded_pytree
    from .utils.random import capture_rng_states

    t0 = time.monotonic()
    output_dir = _checkpoint_dir(accelerator, output_dir)
    pc = accelerator.project_configuration
    is_writer = accelerator.is_main_process or save_on_each_node
    models, plans, optimizers = _trees_to_save(accelerator, params, opt_state)
    for hook in accelerator._save_state_pre_hooks.values():
        hook(models, output_dir)
    if sharded is None:
        sharded = accelerator.num_processes > 1 and any(
            p is not None and p.distributed for p in plans)
    if accelerator.is_main_process or (save_on_each_node and accelerator.is_local_main_process):
        clean_stale_staging(output_dir, active=active_staging)

    artifacts = []
    mesh = accelerator.mesh
    for i, (model, plan) in enumerate(zip(models, plans)):
        suffix = "" if i == 0 else f"_{i}"
        if sharded:
            artifacts.append(_Artifact("sharded", f"{MODEL_NAME}{suffix}", snapshot_sharded_pytree(
                model, None if plan is None else plan.param_specs, mesh)))
        elif is_writer:
            artifacts.append(_Artifact("npz", f"{MODEL_NAME}{suffix}.npz", flatten_pytree(model)))
    for i, opt in enumerate(optimizers):
        suffix = "" if i == 0 else f"_{i}"
        tree, specs = optimizer_state_tree(opt)
        if sharded:
            artifacts.append(_Artifact("sharded", f"{OPTIMIZER_NAME}{suffix}",
                                       snapshot_sharded_pytree(tree, specs, mesh)))
        elif is_writer:
            artifacts.append(_Artifact("npz", f"{OPTIMIZER_NAME}{suffix}.npz",
                                       flatten_pytree(tree)))
    if is_writer:
        artifacts.extend(_encode_small_states(accelerator))
    artifacts.append(_Artifact("bytes", f"{RNG_NAME}_{accelerator.process_index}.pkl",
                               pickle.dumps(capture_rng_states())))
    # every rank's copies are done past this barrier, and the iteration
    # counter advances alike on every process
    accelerator.wait_for_everyone()
    iteration = pc.iteration if pc.automatic_checkpoint_naming else None
    rotation = None
    if pc.automatic_checkpoint_naming:
        if pc.total_limit is not None:
            rotation = (os.path.dirname(output_dir), int(pc.total_limit))
        pc.iteration += 1
    nbytes = 0
    for art in artifacts:
        if art.kind == "sharded":
            nbytes += art.payload.nbytes
        elif art.kind == "npz":
            nbytes += sum(a.nbytes for a in art.payload.values())
        else:
            nbytes += len(art.payload)
    return CheckpointSnapshot(
        final_dir=output_dir, artifacts=artifacts, process_index=accelerator.process_index,
        num_processes=accelerator.num_processes, is_main=accelerator.is_main_process,
        sharded=bool(sharded), save_on_each_node=save_on_each_node,
        is_local_main=accelerator.is_local_main_process, rotation=rotation, iteration=iteration,
        nbytes=nbytes, snapshot_s=time.monotonic() - t0,
        mesh_shape=mesh_shape_dict(mesh))


def write_snapshot(snap: CheckpointSnapshot, directory: Optional[str] = None,
                   heartbeat: Optional[Callable[..., None]] = None) -> tuple:
    """Write every artifact into ``directory`` (the staging dir by default),
    fsync each file and the directory: file IO only, safe on a writer
    thread. Returns ``(files, timings)``: each file's bytes and CRC32 for
    the manifest, and the serialize/write seconds."""
    from .sharded_checkpoint import write_sharded_snapshot

    directory = directory or snap.staging_dir
    os.makedirs(directory, exist_ok=True)
    files: dict = {}
    serialize_s = write_s = 0.0
    first = True
    for art in snap.artifacts:
        if heartbeat is not None:
            heartbeat(file=art.name)
        t0 = time.monotonic()
        if art.kind == "sharded":
            files.update(write_sharded_snapshot(art.payload, directory, prefix=art.name,
                                                heartbeat=heartbeat))
            write_s += time.monotonic() - t0
        elif art.kind == "npz":
            path = os.path.join(directory, art.name)
            with open(path, "wb") as f:
                np.savez(f, **art.payload)
                f.flush()
                os.fsync(f.fileno())
            write_s += time.monotonic() - t0
            files[art.name] = {"bytes": os.path.getsize(path), "crc32": _file_crc32(path)}
        else:
            data = art.payload.encode("utf-8") if art.kind == "text" else art.payload
            serialize_s += time.monotonic() - t0
            t0 = time.monotonic()
            path = os.path.join(directory, art.name)
            with open(path, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            write_s += time.monotonic() - t0
            files[art.name] = {"bytes": len(data), "crc32": zlib.crc32(data) & 0xFFFFFFFF}
        if first:
            first = False
            _maybe_crash("mid_write")
    _fsync_path(directory)
    return files, {"serialize_s": serialize_s, "write_s": write_s}


def _commit_timeout() -> float:
    try:
        return float(os.environ.get("ACCELERATE_CKPT_COMMIT_TIMEOUT", "600"))
    except ValueError:
        return 600.0


def commit_snapshot(snap: CheckpointSnapshot, files: dict,
                    heartbeat: Optional[Callable[..., None]] = None) -> str:
    """Make the staged save durable and visible: this rank's fsync'd
    ``_DONE`` marker; then, on the committer, every rank's marker awaited
    (a shared filesystem), the merged ``_COMMITTED`` manifest written
    last, and the staging dir renamed onto the final name."""
    staging = snap.staging_dir
    done_name = f"_DONE.rank{snap.process_index:05d}.json"
    done_path = os.path.join(staging, done_name)
    with open(done_path + ".tmp", "w") as f:
        json.dump({"process_index": snap.process_index, "files": files, "bytes": snap.nbytes}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(done_path + ".tmp", done_path)
    _fsync_path(staging)
    if not snap.is_committer:
        return snap.final_dir
    merged = dict(files)
    if snap.num_processes > 1:
        deadline = time.monotonic() + _commit_timeout()
        want = snap.num_processes
        if snap.save_on_each_node:
            local = os.environ.get("LOCAL_WORLD_SIZE", "")
            if local.strip().isdigit():
                want = max(1, min(want, int(local)))
        while True:
            done = [n for n in os.listdir(staging) if _DONE_RE.fullmatch(n)]
            if heartbeat is not None:
                heartbeat(waiting_ranks=want - len(done))
            if len(done) >= want:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"checkpoint commit timed out waiting for rank done-markers in {staging} "
                    f"({len(done)}/{want} present). On a node-local filesystem use "
                    "save_on_each_node (and declare LOCAL_WORLD_SIZE); raise "
                    "ACCELERATE_CKPT_COMMIT_TIMEOUT for slow filesystems.")
            time.sleep(0.05)
        for name in done:
            with open(os.path.join(staging, name)) as f:
                merged.update(json.load(f).get("files", {}))
    manifest = {"schema": 1, "iteration": snap.iteration, "num_processes": snap.num_processes,
                "sharded": snap.sharded, "mesh": snap.mesh_shape, "total_bytes": snap.nbytes,
                "committed_at_unix": round(time.time(), 3), "files": merged}
    marker = os.path.join(staging, COMMITTED_MARKER)
    with open(marker, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(staging)
    _maybe_crash("before_replace")
    final = snap.final_dir
    trash = final + _TRASH_SUFFIX
    try:
        if os.path.isdir(final):
            shutil.rmtree(trash, ignore_errors=True)
            os.replace(final, trash)
        os.replace(staging, final)
    except FileNotFoundError:
        if not os.path.isdir(final):  # a peer committer won the race otherwise
            raise
    shutil.rmtree(trash, ignore_errors=True)
    parent = os.path.dirname(os.path.abspath(final))
    if os.path.isdir(parent):
        _fsync_path(parent)
    return final


def write_and_commit(snap: CheckpointSnapshot,
                     heartbeat: Optional[Callable[..., None]] = None) -> str:
    """The writer's side: write, fsync, commit, rotate; records
    ``write_s``/``commit_s`` on the snapshot and drops its payloads."""
    t0 = time.monotonic()
    files, _ = write_snapshot(snap, heartbeat=heartbeat)
    snap.write_s = time.monotonic() - t0
    t0 = time.monotonic()
    final = commit_snapshot(snap, files, heartbeat=heartbeat)
    snap.commit_s = time.monotonic() - t0
    if snap.is_committer and snap.rotation is not None:
        rotate_checkpoints(snap.rotation[0], snap.rotation[1], final)
    snap.artifacts = []
    logger.info("saved state to %s", final)
    return final


def save_accelerator_state(accelerator, output_dir: Optional[str] = None, params=None,
                           opt_state=None, save_on_each_node: bool = False,
                           sharded: Optional[bool] = None) -> str:
    """A blocking save: snapshot, write and commit on the caller's thread,
    then a barrier (no process reads a checkpoint before it is committed)."""
    snap = snapshot_accelerator_state(accelerator, output_dir=output_dir, params=params,
                                      opt_state=opt_state, save_on_each_node=save_on_each_node,
                                      sharded=sharded)
    accelerator.last_checkpoint = snap
    final = write_and_commit(snap)
    accelerator.wait_for_everyone()
    return final


def find_latest_checkpoint(base: str) -> str:
    """The newest committed ``checkpoint_<i>`` under ``base`` (interrupted
    commits repaired first; a newer uncommitted dir is skipped); a dir with
    no marker only when none is committed."""
    if not os.path.isdir(base):
        raise FileNotFoundError(f"no checkpoints under {base}")
    for name in sorted(os.listdir(base)):
        stem = name.removesuffix(STAGING_SUFFIX)
        if name.endswith(STAGING_SUFFIX) and _AUTO_DIR_RE.fullmatch(stem):
            repair_interrupted_commit(os.path.join(base, stem))
    candidates = sorted((d for d in os.listdir(base) if _AUTO_DIR_RE.fullmatch(d)),
                        key=lambda d: int(d.split("_")[1]))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints under {base}")
    committed = [d for d in candidates if is_committed_checkpoint(os.path.join(base, d))]
    if committed:
        skipped = [d for d in candidates
                   if int(d.split("_")[1]) > int(committed[-1].split("_")[1])]
        if skipped:
            logger.warning("ignoring uncommitted checkpoint dir(s) %s (torn save?); resuming "
                           "from %s", skipped, committed[-1])
        return os.path.join(base, committed[-1])
    logger.warning("no committed checkpoints under %s; falling back to newest dir %s",
                   base, candidates[-1])
    return os.path.join(base, candidates[-1])


def _validate_manifest(input_dir: str) -> None:
    """Every file the manifest lists is there with its size (and, with
    ``ACCELERATE_CKPT_VERIFY=crc``, its CRC32)."""
    marker = os.path.join(input_dir, COMMITTED_MARKER)
    if not os.path.isfile(marker):
        return
    try:
        with open(marker) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(f"unparseable commit manifest {marker}: {e}",
                                     path=marker) from e
    check_crc = os.environ.get("ACCELERATE_CKPT_VERIFY", "size").strip().lower() == "crc"
    for name, rec in (manifest.get("files") or {}).items():
        path = os.path.join(input_dir, name)
        if not os.path.isfile(path):
            if name.startswith(RNG_NAME):  # per-node under save_on_each_node
                continue
            raise CheckpointCorruptError(f"checkpoint {input_dir} is missing {name} listed in "
                                         "its commit manifest", path=path)
        size = os.path.getsize(path)
        if rec.get("bytes") is not None and size != int(rec["bytes"]):
            raise CheckpointCorruptError(f"checkpoint file {path} has {size} bytes, manifest "
                                         f"says {rec['bytes']} (torn/tampered write)", path=path)
        if check_crc and rec.get("crc32") is not None:
            crc = _file_crc32(path)
            if crc != int(rec["crc32"]):
                raise CheckpointCorruptError(f"checkpoint file {path} fails manifest CRC32 "
                                             f"({crc:#010x} != {int(rec['crc32']):#010x})",
                                             path=path)


def _load_tree_into(tree, specs, mesh, input_dir: str, prefix: str, elastic: bool):
    """Read the ``prefix`` tree (npz or shard set) into ``tree``: its
    tensors written in place, and returned; any other leaf returned new.
    None when the directory holds neither format."""
    from .sharded_checkpoint import _flat_specs

    npz = os.path.join(input_dir, f"{prefix}.npz")
    if os.path.exists(npz):
        source = _FlatSource(load_flat(npz))
    elif is_sharded_checkpoint(input_dir, prefix):
        source = _ShardedSource(input_dir, prefix)
    else:
        return None
    spec_of = _flat_specs(specs)

    def restore(key, leaf):
        value = _restore_leaf(key, leaf, source, tuple(spec_of.get(key) or ()), mesh, elastic)
        if not isinstance(leaf, torch.Tensor):
            return value
        with torch.no_grad():
            leaf.copy_(value)
        return leaf

    try:
        return map_with_path(restore, tree)
    finally:
        if isinstance(source, _ShardedSource):
            source.close()


def load_accelerator_state(accelerator, input_dir: Optional[str] = None, params=None,
                           opt_state=None, load_kwargs: Optional[dict] = None,
                           elastic: Optional[bool] = None):
    """Restore a checkpoint into the prepared state, in place: the params
    (each rank its block under its plan, from whatever mesh and format
    wrote them), the optimizers, schedulers, loaders, custom objects, the
    iteration counter and this process's random streams. Returns the
    params (the list of prepared models, or the given ``params``) and,
    with ``opt_state``, ``(params, opt_state)``.

    The saved mesh is held to the live one
    (:func:`~.resilience.reshard.check_topology`): a changed
    ``dp_replicate`` width raises :class:`CheckpointTopologyError` unless
    ``elastic`` (default: ``ACCELERATE_ELASTIC_RESUME``), which re-pads the
    fused ZeRO-1 buckets."""
    from .resilience.reshard import check_topology, mesh_shape_dict, saved_topology
    from .utils.environment import parse_flag_from_env
    from .utils.random import restore_rng_states

    if elastic is None:
        elastic = parse_flag_from_env("ACCELERATE_ELASTIC_RESUME")
    if input_dir is None:
        input_dir = find_latest_checkpoint(
            os.path.join(accelerator.project_dir or ".", "checkpoints"))
    else:
        if not os.path.isdir(input_dir):
            repair_interrupted_commit(input_dir)
        if os.path.isdir(input_dir) and not is_committed_checkpoint(input_dir):
            logger.warning("loading %s without a %s manifest (a save torn mid-write?)",
                           input_dir, COMMITTED_MARKER)
    _validate_manifest(input_dir)
    saved_mesh = saved_topology(input_dir)
    current_mesh = mesh_shape_dict(accelerator.mesh)
    resharding = check_topology(saved_mesh, current_mesh, elastic=bool(elastic))
    if resharding:
        logger.warning("elastic resume: re-sharding checkpoint %s (%s -> %s)", input_dir,
                       saved_mesh, current_mesh)
    models, plans, optimizers = _trees_to_save(accelerator, params, opt_state)
    for hook in accelerator._load_state_pre_hooks.values():
        hook(models, input_dir)
    mesh = accelerator.mesh
    restored = []
    for i, (model, plan) in enumerate(zip(models, plans)):
        suffix = "" if i == 0 else f"_{i}"
        value = _load_tree_into(model, None if plan is None else plan.param_specs, mesh,
                                input_dir, f"{MODEL_NAME}{suffix}", resharding)
        if value is None:
            raise FileNotFoundError(f"no {MODEL_NAME}{suffix} checkpoint in {input_dir}")
        # a tree of tensors was written in place: the caller's tree itself
        in_place = all(isinstance(v, torch.Tensor) for _, v in flatten_with_path(model))
        restored.append(model if in_place else value)
    for opt in accelerator._optimizers:
        opt.sync_from_params()
    for i, opt in enumerate(optimizers):
        suffix = "" if i == 0 else f"_{i}"
        prefix = f"{OPTIMIZER_NAME}{suffix}"
        npz = os.path.join(input_dir, f"{prefix}.npz")
        if os.path.exists(npz):
            load_optimizer_state(opt, load_flat(npz), mesh=mesh, elastic=resharding)
        elif is_sharded_checkpoint(input_dir, prefix):
            load_optimizer_state(opt, input_dir, prefix, mesh=mesh, elastic=resharding)
    for i, sched in enumerate(accelerator._schedulers):
        path = os.path.join(input_dir, f"{SCHEDULER_NAME}{'' if i == 0 else f'_{i}'}.json")
        if os.path.exists(path):
            with open(path) as f:
                sched.load_state_dict(json.load(f))
    for i, dl in enumerate(accelerator._dataloaders):
        base = os.path.join(input_dir, f"{SAMPLER_NAME}{'' if i == 0 else f'_{i}'}")
        if os.path.exists(base + ".json"):
            with open(base + ".json") as f:
                dl.load_state_dict(json.load(f))
        elif os.path.exists(base + ".pkl"):
            with open(base + ".pkl", "rb") as f:
                dl.load_state_dict(pickle.load(f))
    for i, obj in enumerate(accelerator._custom_objects):
        state = obj.state_dict()
        obj.load_state_dict(unflatten_into(
            state, load_flat(os.path.join(input_dir, f"{CUSTOM_NAME}_{i}.npz"))))
    match = re.fullmatch(r"checkpoint_(\d+)", os.path.basename(os.path.normpath(input_dir)))
    if match:
        accelerator.project_configuration.iteration = int(match.group(1)) + 1
    rng_file = os.path.join(input_dir, f"{RNG_NAME}_{accelerator.process_index}.pkl")
    if os.path.exists(rng_file):
        with open(rng_file, "rb") as f:
            try:
                restore_rng_states(pickle.load(f))
            except Exception as e:  # drift in a host RNG format is not fatal
                logger.warning("could not restore RNG states: %s", e)
    logger.info("loaded state from %s", input_dir)
    out = restored[0] if params is not None else restored
    if opt_state is not None:
        return out, optimizers[0].opt_state
    return out


# ------------------------------------------------------------ model export --
def _parse_size(size) -> int:
    if isinstance(size, int):
        return size
    match = re.fullmatch(r"(\d+)\s*([KMGT]?B)", size.strip(), re.IGNORECASE)
    if not match:
        raise ValueError(f"cannot parse size {size!r}")
    mult = {"B": 1, "KB": 2 ** 10, "MB": 2 ** 20, "GB": 2 ** 30, "TB": 2 ** 40}
    return int(match.group(1)) * mult[match.group(2).upper()]


def _safetensors_compat(shard: dict) -> dict:
    """bf16 (``|V2``) and any dtype safetensors cannot take, as f32 (the
    JAX package's ``_safetensors_compat``)."""
    out = {}
    for k, v in shard.items():
        if v.dtype == np.dtype("V2"):
            v = to_tensor(v).float().numpy()
        elif v.dtype.kind not in "fiub" or str(v.dtype) == "bfloat16":
            v = v.astype(np.float32)
        out[k] = v
    return out


def save_model(params, save_directory: str, max_shard_size="10GB",
               safe_serialization: bool = True) -> list:
    """``params`` as ``model.safetensors`` (split at ``max_shard_size`` into
    ``model-<i>-of-<n>.safetensors`` with ``model.safetensors.index.json``)
    or ``model.npz``, named by tree path; bf16 is written as f32, as the
    JAX package writes it. Returns the files written."""
    from .utils.modeling import save_safetensors

    os.makedirs(save_directory, exist_ok=True)
    flat = flatten_pytree(params)
    limit = _parse_size(max_shard_size)
    shards, sizes = [{}], [0]
    for key in sorted(flat):
        arr = flat[key]
        if sizes[-1] + arr.nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = arr
        sizes[-1] += arr.nbytes
    written = []
    if not safe_serialization:
        path = os.path.join(save_directory, WEIGHTS_NAME)
        with open(path, "wb") as f:
            np.savez(f, **flat)
        return [path]
    if len(shards) == 1:
        path = os.path.join(save_directory, SAFE_WEIGHTS_NAME)
        save_safetensors(_safetensors_compat(shards[0]), path)
        return [path]
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_safetensors(_safetensors_compat(shard), os.path.join(save_directory, name))
        written.append(os.path.join(save_directory, name))
        index["weight_map"].update(dict.fromkeys(shard, name))
    with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return written


def _read_safetensors(path: str) -> dict:
    from .utils.modeling import load_safetensors

    return {k: (v.view(torch.int16).numpy().view("V2") if v.dtype == torch.bfloat16
                else v.numpy()) for k, v in load_safetensors(path).items()}


def load_checkpoint_in_model(params_template, checkpoint_path: str):
    """A safetensors (single, or split with its index) or npz checkpoint
    read into a tree like ``params_template`` (each leaf in the template's
    dtype, on its device)."""
    if os.path.isdir(checkpoint_path):
        index_file = os.path.join(checkpoint_path, SAFE_WEIGHTS_INDEX_NAME)
        single = os.path.join(checkpoint_path, SAFE_WEIGHTS_NAME)
        npz = os.path.join(checkpoint_path, WEIGHTS_NAME)
        if os.path.exists(index_file):
            with open(index_file) as f:
                index = json.load(f)
            flat = {}
            for name in sorted(set(index["weight_map"].values())):
                flat.update(_read_safetensors(os.path.join(checkpoint_path, name)))
        elif os.path.exists(single):
            flat = _read_safetensors(single)
        elif os.path.exists(npz):
            flat = load_flat(npz)
        else:
            raise FileNotFoundError(f"no model checkpoint in {checkpoint_path}")
    elif checkpoint_path.endswith(".safetensors"):
        flat = _read_safetensors(checkpoint_path)
    else:
        flat = load_flat(checkpoint_path)
    return unflatten_into(params_template, flat)
