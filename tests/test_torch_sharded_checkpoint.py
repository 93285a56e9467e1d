"""The port's sharded checkpoints, case for case the JAX package's
``tests/test_sharded_checkpoint.py``, and across the two packages.

The JAX cases save from 8 virtual devices of one process; the port runs one
process per device, so each rank here is the port's :class:`Mesh` at that
rank (no process group: a snapshot and a load read only the rank's
coordinates) and every rank of a mesh writes into the same directory, as
the ranks of a launch do. ``fsdp`` is the port's (and the JAX package's
``ParallelismConfig``'s) ``dp_shard`` axis. Across packages: a shard set the
JAX package writes on 4 virtual devices loads into the port at one process
and, rank by rank, at dp_shard 2; one the port writes at dp_shard 2 loads
into the JAX package on 4 virtual devices and consolidates there; the
fused ZeRO-1 buckets of a dp_replicate 4 save load elastically at
dp_replicate 2. Every comparison is exact: a checkpoint moves bytes (bf16
through f32, exactly).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from accelerate_tpu import sharded_checkpoint as jsc
from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.checkpointing import load_optimizer_state, optimizer_state_tree
from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, adamw
from accelerate_tpu_torch.parallel.sharding import (
    PartitionSpec as P,
    infer_param_specs,
    local_shard,
    make_sharding_plan,
)
from accelerate_tpu_torch.parallelism_config import MESH_AXIS_NAMES, Mesh, ParallelismConfig
from accelerate_tpu_torch.sharded_checkpoint import (
    CheckpointCorruptError,
    consolidate_sharded,
    flatten_with_path,
    is_sharded_checkpoint,
    load_sharded_pytree,
    merge_sharded_checkpoint,
    save_sharded_pytree,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.modeling import load_safetensors


@pytest.fixture(autouse=True)
def _fresh_port_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _mesh(rank=0, **sizes):
    return Mesh(tuple(sizes.get(a, 1) for a in MESH_AXIS_NAMES), rank=rank)


@pytest.fixture
def params():
    rng = np.random.default_rng(0)
    return {
        "layer": {"w": rng.normal(size=(16, 8)).astype(np.float32),
                  "b": rng.normal(size=(8,)).astype(np.float32)},
        "head": rng.normal(size=(8, 4)).astype(np.float32),
        "step": np.int32(7),
    }


def _specs(w, b, head):
    return {"layer": {"w": w, "b": b}, "head": head, "step": None}


def _blocks(params, specs, mesh):
    """Rank ``mesh.rank``'s blocks of ``params`` as tensors (the numpy
    leaf stays numpy)."""
    def block(x, spec):
        if not isinstance(x, np.ndarray) or x.ndim == 0:
            return x
        return torch.from_numpy(np.ascontiguousarray(local_shard(x, spec or P(), mesh)))

    return {"layer": {k: block(params["layer"][k], specs["layer"][k]) for k in ("w", "b")},
            "head": block(params["head"], specs["head"]), "step": params["step"]}


def _save_all(params, specs, directory, **sizes):
    n = int(np.prod(list(sizes.values())))
    for r in range(n):
        mesh = _mesh(r, **sizes)
        save_sharded_pytree(_blocks(params, specs, mesh), str(directory), "model", specs, mesh)


def _load_each(params, specs, directory, **sizes):
    """Every rank's load against its blocks of ``params``."""
    n = int(np.prod(list(sizes.values())))
    for r in range(n):
        mesh = _mesh(r, **sizes)
        want = _blocks(params, specs, mesh)
        template = {"layer": {k: torch.zeros_like(v) for k, v in want["layer"].items()},
                    "head": torch.zeros_like(want["head"]), "step": np.int32(0)}
        got = load_sharded_pytree(template, str(directory), "model", specs, mesh)
        for k in ("w", "b"):
            assert torch.equal(got["layer"][k], want["layer"][k]), (r, k)
        assert torch.equal(got["head"], want["head"]), r
        assert int(got["step"]) == 7


class TestShardedSaveLoad:
    def test_roundtrip_same_mesh(self, params, tmp_path):
        specs = _specs(P("dp_shard"), P(), P("dp_shard"))
        _save_all(params, specs, tmp_path, dp_shard=8)
        assert is_sharded_checkpoint(str(tmp_path), "model")
        _load_each(params, specs, tmp_path, dp_shard=8)

    def test_reload_on_refactored_mesh(self, params, tmp_path):
        """Saved at dp_shard 8, loaded at dp_shard 4 x tp 2 with 2-D specs:
        each rank assembles its block from the chunks that meet it."""
        _save_all(params, _specs(P("dp_shard"), P(), P("dp_shard")), tmp_path, dp_shard=8)
        _load_each(params, _specs(P("dp_shard", "tp"), P("tp"), P(None, "tp")), tmp_path,
                   dp_shard=4, tp=2)

    def test_each_region_written_once(self, params, tmp_path):
        """Replicated blocks are written by their replica 0 alone: the
        elements the indices record, and the bytes on disk, are the
        model's."""
        _save_all(params, _specs(P("dp_shard", "tp"), P(), P(None, "tp")), tmp_path,
                  dp_shard=4, tp=2)
        stored = n_chunks = 0
        for name in os.listdir(tmp_path):
            if name.endswith(".index.json"):
                with open(tmp_path / name) as f:
                    index = json.load(f)
                for meta in index["leaves"].values():
                    n_chunks += len(meta["chunks"])
                    for chunk in meta["chunks"]:
                        stored += int(np.prod([e - s for s, e in
                                               zip(chunk["start"], chunk["stop"])] or [1]))
        expected = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
        assert stored == expected, (stored, expected)
        disk = sum(os.path.getsize(tmp_path / n) for n in os.listdir(tmp_path)
                   if n.endswith((".bin", ".npz")))
        assert disk <= expected * 4 + n_chunks * 64 + 1024, (disk, expected * 4, n_chunks)

    def test_consolidate_and_merge(self, params, tmp_path):
        _save_all(params, _specs(P("dp_shard"), P(), P("dp_shard")), tmp_path / "s", dp_shard=8)
        flat = consolidate_sharded(str(tmp_path / "s"), "model")
        np.testing.assert_array_equal(flat["layer/w"], params["layer"]["w"])
        np.testing.assert_array_equal(flat["head"], params["head"])
        out = merge_sharded_checkpoint(str(tmp_path / "s"), str(tmp_path / "merged"))
        merged = load_safetensors(out)
        np.testing.assert_array_equal(merged["layer/w"].numpy(), params["layer"]["w"])
        # the port's safetensors writer, read by the safetensors package too
        from safetensors.numpy import load_file

        np.testing.assert_array_equal(load_file(out)["head"], params["head"])

    def test_missing_leaf_raises(self, params, tmp_path):
        specs = _specs(P("dp_shard"), P(), P("dp_shard"))
        _save_all(params, specs, tmp_path, dp_shard=8)
        template = dict(_blocks(params, specs, _mesh(0, dp_shard=8)), extra=torch.zeros(3))
        with pytest.raises(KeyError):
            load_sharded_pytree(template, str(tmp_path), "model", specs, _mesh(0, dp_shard=8))


class TestAcceleratorShardedState:
    def test_save_state_sharded_roundtrip(self, tmp_path):
        """save_state(sharded=True) writes shard sets (no model.npz), and
        load_state restores params and AdamW moments through them."""
        acc = Accelerator(cpu=True)
        params, opt = acc.prepare({"w": torch.arange(32, dtype=torch.float32).reshape(16, 2)},
                                  adamw(1e-3))
        step = acc.prepare_train_step(lambda p, b: (p["w"] * b).sum(), opt)
        step(params, opt.opt_state, torch.ones(16, 2))
        ckpt = str(tmp_path / "ckpt")
        acc.save_state(ckpt, sharded=True)
        assert not os.path.exists(os.path.join(ckpt, "model.npz"))
        assert is_sharded_checkpoint(ckpt, "model") and is_sharded_checkpoint(ckpt, "optimizer")
        saved_w = params["w"].detach().clone()
        saved_state = {k: v.clone() for k, v in opt.opt_state[params["w"]].items()}
        AcceleratorState._reset_state(reset_partial_state=True)
        acc2 = Accelerator(cpu=True)
        params2, opt2 = acc2.prepare({"w": torch.zeros(16, 2)}, adamw(1e-3))
        acc2.load_state(ckpt)
        assert torch.equal(params2["w"], saved_w)
        for k, v in saved_state.items():
            assert torch.equal(opt2.opt_state[params2["w"]][k], v), k


@pytest.mark.smoke
def test_checkpoint_dir_reuse_scrubs_stale_format(tmp_path):
    """A sharded save over an npz save in the same directory leaves no
    stale ``model.npz`` (the commit replaces the directory whole), and the
    load restores the new values."""
    acc = Accelerator(cpu=True)
    ckpt = str(tmp_path / "reused")
    acc.save_state(ckpt, params={"w": np.full((16, 2), 1.0, np.float32)})
    assert os.path.exists(os.path.join(ckpt, "model.npz"))
    acc.save_state(ckpt, params={"w": torch.full((16, 2), 2.0)}, sharded=True)
    assert not os.path.exists(os.path.join(ckpt, "model.npz"))
    restored = acc.load_state(ckpt, params={"w": torch.zeros(16, 2)})
    assert torch.equal(restored["w"], torch.full((16, 2), 2.0))


def _jmesh(n, names=("fsdp",)):
    return JMesh(np.array(jax.devices()[:n]).reshape((n,)), names)


def _jshard(params, mesh, w_spec, head_spec):
    return {"layer": {"w": jax.device_put(params["layer"]["w"], NamedSharding(mesh, w_spec)),
                      "b": jax.device_put(params["layer"]["b"], NamedSharding(mesh, JP()))},
            "head": jax.device_put(params["head"], NamedSharding(mesh, head_spec)),
            "step": params["step"]}


def test_legacy_npz_shard_set_still_loads(params, tmp_path, monkeypatch):
    """A shard set the JAX package wrote in its legacy npz container
    (``ACCELERATE_TPU_CKPT_FORMAT=npz``) loads through the port's reader."""
    live = _jshard(params, _jmesh(8), JP("fsdp"), JP("fsdp"))
    monkeypatch.setenv("ACCELERATE_TPU_CKPT_FORMAT", "npz")
    jsc.save_sharded_pytree(live, str(tmp_path), prefix="model")
    monkeypatch.delenv("ACCELERATE_TPU_CKPT_FORMAT")
    assert any(n.endswith(".npz") for n in os.listdir(tmp_path))
    _load_each(params, _specs(P("dp_shard"), P(), P("dp_shard")), tmp_path, dp_shard=2)


def test_stale_other_format_file_does_not_misroute(params, tmp_path, monkeypatch):
    """A stale ``.bin`` of the port's one-process save beside a fresh
    npz-container index over it (the JAX package's legacy format) does not
    hijack the routing: each chunk names its container."""
    specs = _specs(P("dp_shard"), P(), P("dp_shard"))
    _save_all(params, specs, tmp_path)
    assert any(n.endswith(".bin") for n in os.listdir(tmp_path))
    live = _jshard(params, _jmesh(8), JP("fsdp"), JP("fsdp"))
    monkeypatch.setenv("ACCELERATE_TPU_CKPT_FORMAT", "npz")
    jsc.save_sharded_pytree(live, str(tmp_path), prefix="model")
    monkeypatch.delenv("ACCELERATE_TPU_CKPT_FORMAT")
    _load_each(params, specs, tmp_path, dp_shard=8)


# ------------------------------------------------------------ across packages --
def _jax_llama():
    """Tiny Llama from the JAX initializer, its final norm in bf16 (the
    sharded format writes bf16 as f32 and records ``bfloat16``)."""
    p = jt.init_llama(jt.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    p = dict(p, final_norm=jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                                  p["final_norm"]))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(p)[0]}


def _nest(flat: dict, fn=lambda x: x) -> dict:
    root: dict = {}
    for path, v in flat.items():
        node = root
        *head, last = path.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = fn(v)
    return root


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(x))


def test_jax_sharded_save_loads_into_port(tmp_path):
    """The JAX package's shard set of tiny Llama (4 virtual devices, FSDP on
    the largest dim of each big leaf) loads into the port at one process
    and, rank by rank, at dp_shard 2: every block bitwise, bf16 included."""
    flat = _jax_llama()
    jmesh = _jmesh(4, ("dp_shard",))
    jspecs = jax.tree_util.tree_map(
        lambda x: JP(*[("dp_shard" if d == int(np.argmax(x.shape)) and x.size >= 1024
                        else None) for d in range(x.ndim)]), _nest(flat))
    live = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, NamedSharding(jmesh, s)),
                                  _nest(flat), jspecs)
    jsc.save_sharded_pytree(live, str(tmp_path), prefix="model")
    whole = load_sharded_pytree(_nest(flat, lambda x: torch.zeros_like(_torch(x))),
                                str(tmp_path))
    for k, t in flatten_with_path(whole):
        assert t.dtype == _torch(flat[k]).dtype and torch.equal(t, _torch(flat[k])), k
    tree = _nest(flat, _torch)
    specs = infer_param_specs(tree, {"dp_shard": 2},
                              ParallelismConfig(dp_shard_size=2))
    for r in range(2):
        mesh = _mesh(r, dp_shard=2)
        template = jax.tree_util.tree_map(lambda x, s: torch.zeros_like(local_shard(x, s, mesh)),
                                          tree, specs, is_leaf=lambda x: isinstance(x, P))
        got = load_sharded_pytree(template, str(tmp_path), "model", specs, mesh)
        want = jax.tree_util.tree_map(lambda x, s: local_shard(x, s, mesh), tree, specs,
                                      is_leaf=lambda x: isinstance(x, P))
        for (k, a), (_, b) in zip(flatten_with_path(got), flatten_with_path(want)):
            assert torch.equal(a, b), (r, k)


def test_port_sharded_save_loads_into_jax(tmp_path):
    """The port's shard set of tiny Llama at dp_shard 2 (each rank its
    blocks) loads into the JAX package on 4 virtual devices and
    consolidates there to the same arrays, bf16 leaves as their f32."""
    flat = _jax_llama()
    tree = _nest(flat, _torch)
    specs = infer_param_specs(tree, {"dp_shard": 2}, ParallelismConfig(dp_shard_size=2))
    for r in range(2):
        mesh = _mesh(r, dp_shard=2)
        blocks = jax.tree_util.tree_map(lambda x, s: local_shard(x, s, mesh).contiguous(), tree,
                                        specs, is_leaf=lambda x: isinstance(x, P))
        save_sharded_pytree(blocks, str(tmp_path), "model", specs, mesh)
    merged = jsc.consolidate_sharded(str(tmp_path), "model")
    assert merged.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(merged[k], v.astype(np.float32), err_msg=k)
    jmesh = _jmesh(4, ("fsdp",))
    template = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.zeros_like(x), NamedSharding(
            jmesh, JP("fsdp") if x.shape[0] % 4 == 0 else JP())), _nest(flat))
    restored = jsc.load_sharded_pytree(template, str(tmp_path), prefix="model")
    got = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
           for path, x in jax.tree_util.tree_flatten_with_path(restored)[0]}
    for k, v in flat.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_corrupt_chunk_names_file(params, tmp_path):
    """A flipped byte inside a chunk fails its CRC32: the load raises
    :class:`CheckpointCorruptError` naming the ``.bin`` (as the JAX
    package's reader does on the same file)."""
    specs = _specs(P("dp_shard"), P(), P("dp_shard"))
    _save_all(params, specs, tmp_path, dp_shard=2)
    index_file = tmp_path / "model-shard-00001.index.json"
    chunk = max((c for meta in json.load(open(index_file))["leaves"].values()
                 for c in meta["chunks"]), key=lambda c: c["nbytes"])
    bin_file = str(index_file)[:-len(".index.json")] + ".bin"
    with open(bin_file, "r+b") as f:
        f.seek(chunk["offset"] + 1)
        byte = f.read(1)
        f.seek(chunk["offset"] + 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(CheckpointCorruptError) as exc:
        consolidate_sharded(str(tmp_path), "model")
    assert exc.value.path == bin_file
    with pytest.raises(jsc.CheckpointCorruptError) as jexc:
        jsc.consolidate_sharded(str(tmp_path), "model")
    assert jexc.value.path == bin_file


def _fused_optimizer(params, rank, n):
    """An AdamW on rank ``rank``'s chunks of the fused ZeRO-1 buckets of
    ``params`` at dp_replicate ``n`` (a bucket of 1 KiB, so there are
    several), its moments filled from the global bucket coordinates
    (``value = 1 + index``, zero in the padding, as a run keeps it)."""
    mesh = _mesh(rank, dp_replicate=n)
    plan = make_sharding_plan(params, mesh, zero1_axis="dp_replicate", zero1_bucket_bytes=1024)
    assert plan.fused_zero1
    opt = AcceleratedOptimizer(adamw(1e-3))
    opt.init(params, plan)
    fill = {}
    for slot in plan.zero1.slots:
        fill[slot.bucket] = fill.get(slot.bucket, 0) + slot.size
    for chunk, name in zip(opt.params, plan.zero1.bucket_names):
        c = plan.zero1.chunk_size(name)
        index = torch.arange(rank * c, (rank + 1) * c, dtype=torch.float32)
        value = torch.where(index < fill[name], 1 + index, 0.0)
        opt.opt_state[chunk].update(step=torch.tensor(3.0), exp_avg=value.clone(),
                                    exp_avg_sq=value * 2)
    return opt, mesh, fill


def test_fused_zero1_buckets_resume_elastically(tmp_path):
    """The optimizer state of fused ZeRO-1 saved at dp_replicate 4 loads at
    dp_replicate 2 with ``elastic=True``: each bucket is re-padded
    (``ceil(fill/2)*2``) and each rank gets its new chunk; without
    ``elastic`` the changed bucket length raises."""
    rng = np.random.default_rng(0)
    params = {"a": torch.from_numpy(rng.normal(size=(7, 9)).astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)),
              "c": torch.from_numpy(rng.normal(size=(301,)).astype(np.float32))}
    for r in range(4):
        opt, mesh, fill = _fused_optimizer(params, r, 4)
        tree, specs = optimizer_state_tree(opt)
        save_sharded_pytree(tree, str(tmp_path), "optimizer", specs, mesh)
    for r in range(2):
        opt, mesh, _ = _fused_optimizer(params, r, 2)
        for st in opt.opt_state.values():
            st.clear()
        with pytest.raises(ValueError, match="shape mismatch"):
            load_optimizer_state(opt, str(tmp_path), "optimizer", mesh=mesh)
        load_optimizer_state(opt, str(tmp_path), "optimizer", mesh=mesh, elastic=True)
        for chunk, name in zip(opt.params, opt.zero1.plan.bucket_names):
            c = opt.zero1.plan.chunk_size(name)
            index = torch.arange(r * c, (r + 1) * c, dtype=torch.float32)
            want = torch.where(index < fill[name], 1 + index, 0.0)
            st = opt.opt_state[chunk]
            assert torch.equal(st["exp_avg"], want) and torch.equal(st["exp_avg_sq"], want * 2)
            assert float(st["step"]) == 3.0


def test_native_io_is_zlibs_crc_and_raises_on_a_failed_build(tmp_path, monkeypatch):
    """The port's chunk writer (``native/src/io.cc``, the JAX package's
    source): 64-byte-aligned offsets and zlib's CRC32, as the JAX package's
    writer records them; a compiler that fails raises with its output (no
    Python fallback)."""
    import zlib

    from accelerate_tpu.native import io as jio
    from accelerate_tpu_torch.native import io as tio

    arrays = [np.arange(10, dtype=np.float32), np.ones(3, np.int8), np.zeros((2, 5), np.float64)]
    offsets, sizes, crcs = tio.write_chunks(str(tmp_path / "t.bin"), arrays)
    j_offsets, j_sizes, j_crcs = jio.write_chunks(str(tmp_path / "j.bin"), arrays)
    assert (offsets, sizes, crcs) == (j_offsets, j_sizes, j_crcs)
    assert crcs == [zlib.crc32(a.tobytes()) & 0xFFFFFFFF for a in arrays]
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    back = tio.read_chunks(str(tmp_path / "j.bin"), offsets, sizes, crcs)
    assert all(b.tobytes() == a.tobytes() for a, b in zip(arrays, back))
    with pytest.raises(ValueError, match="CRC"):
        tio.read_chunks(str(tmp_path / "j.bin"), offsets, sizes, [c ^ 1 for c in crcs])
    monkeypatch.setattr(tio, "_lib", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tio.write_chunks(str(tmp_path / "u.bin"), arrays)
