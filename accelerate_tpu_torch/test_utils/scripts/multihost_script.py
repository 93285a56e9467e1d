"""Multi-process assertion script of the port: the counterpart of
``accelerate_tpu.test_utils.scripts.multihost_script``, with its
``topology``, ``ops``, ``dataloader``, ``dispatcher``,
``dispatcher_ragged`` and ``training`` scenarios and their assertions, and
the port's own: ``rng_sync`` (a loader's ``rng_types``), ``mesh_train`` (a
few Llama training steps on each of several meshes and with each option of a sharded step: adafactor,
a global-norm clip, fp16, ZeRO-1 by annotation, every remat policy,
``gradient_fn``), ``mesh_moe`` (the MoE Llama under dp_shard, ep and both),
``long_context`` (context and sequence parallel attention alone, in the
Llama forward and in training) and ``zoo_train`` (ResNet and T5 under
data parallelism and FSDP), whose
losses, gradient norms, final params and optimizer-state bytes they write
for the caller to compare.

Run N copies under the launcher protocol (see :func:`~accelerate_tpu_torch.
test_utils.testing.execute_multiprocess`)::

    python -m accelerate_tpu_torch.test_utils.scripts.multihost_script \\
        --scenario topology,ops --tmpdir /tmp/xyz

Each process uses one CPU thread and imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os

import numpy as np
import torch


def check_topology(accelerator, expect_n):
    assert accelerator.num_processes == expect_n, (accelerator.num_processes, expect_n)
    assert accelerator.process_index == int(os.environ["ACCELERATE_PROCESS_ID"])
    assert accelerator.is_last_process == (accelerator.process_index == expect_n - 1)
    assert accelerator.partial_state.backend == "gloo"
    accelerator.wait_for_everyone()


def check_ops(accelerator):
    from accelerate_tpu_torch.utils import operations as ops

    n = accelerator.num_processes
    me = accelerator.process_index

    objs = ops.gather_object(("proc", me))
    assert objs == [("proc", i) for i in range(n)], objs

    payload = [{"value": 42, "blob": np.arange(3)}] if me == 0 else [None]
    out = ops.broadcast_object_list(payload)[0]
    assert out["value"] == 42 and out["blob"].tolist() == [0, 1, 2], out

    g = ops.gather(np.array([me], dtype=np.int32))
    assert np.asarray(g).reshape(-1).tolist() == list(range(n)), g

    r = ops.reduce(np.array([float(me + 1)]), "mean")
    expected = sum(range(1, n + 1)) / n
    assert abs(float(np.asarray(r).reshape(-1)[0]) - expected) < 1e-6, r

    r = ops.reduce(np.array([float(me + 1)]), "sum")
    assert abs(float(np.asarray(r).reshape(-1)[0]) - sum(range(1, n + 1))) < 1e-6, r

    # divergent per-process tensors must truly average
    r = ops.reduce({"p": torch.full((3,), float(me + 1))}, "mean")
    assert torch.allclose(r["p"], torch.full((3,), expected)), r
    r = ops.reduce(torch.full((2,), float(me + 1)), "sum")
    assert torch.allclose(r, torch.full((2,), float(sum(range(1, n + 1))))), r

    padded = ops.pad_across_processes(np.ones((2 + me, 3)), dim=0)
    assert np.asarray(padded).shape == (2 + (n - 1), 3), np.asarray(padded).shape

    b = ops.broadcast(np.array([me * 100 + 7]))
    assert int(np.asarray(b).reshape(-1)[0]) == 7, b

    with accelerator.split_between_processes(list(range(2 * n + 1))) as mine:
        sizes = ops.gather_object(len(mine))
        assert sum(sizes) == 2 * n + 1, sizes

    accelerator.wait_for_everyone()


def _row_dataset(n_rows):
    class DS:
        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            return {"x": np.full((4,), float(i), dtype=np.float32), "idx": np.int32(i)}

    return DS()


def check_dataloader(accelerator):
    from accelerate_tpu_torch import DataLoader

    n_rows = 16
    per_proc_bs = 4 // accelerator.num_processes if accelerator.num_processes <= 4 else 1
    prepared = accelerator.prepare_data_loader(DataLoader(_row_dataset(n_rows),
                                                          batch_size=per_proc_bs))
    seen = []
    for batch in prepared:
        # gather_for_metrics drops the rows even_batches repeats in the last
        # global batch (none at 2 processes, where it is plain gather)
        g = accelerator.gather_for_metrics(batch)
        idx = g["idx"].reshape(-1).numpy()
        x0 = g["x"][:, 0].numpy()
        assert np.allclose(x0, idx.astype(np.float32)), (x0, idx)
        seen.extend(idx.tolist())
    assert sorted(seen) == list(range(n_rows)), sorted(seen)
    accelerator.wait_for_everyone()


def check_rng_sync(accelerator):
    """``rng_types``: each rank seeds its host streams differently; a loader
    prepared with ``rng_types`` gives every rank rank 0's python, numpy,
    torch and generator states at the start of each epoch, so the draws
    after it agree; the JAX package's ``jax`` stream raises."""
    import random

    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.data_loader import prepare_data_loader
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.random import synchronize_rng_state

    me = accelerator.process_index
    gen = torch.Generator().manual_seed(100 + me)
    loader = prepare_data_loader(DataLoader(_row_dataset(8), batch_size=2),
                                 torch.device("cpu"), mesh=accelerator.mesh,
                                 rng_types=["python", "numpy", "torch", "generator"],
                                 prefetch_depth=2)
    loader.synchronized_generator = gen
    for epoch in range(2):
        random.seed(10 + me)
        np.random.seed(20 + me)
        torch.manual_seed(30 + me)
        gen.manual_seed(40 + me)
        assert len(set(ops.gather_object(float(np.random.rand())))) == accelerator.num_processes
        batches = [b["idx"].tolist() for b in loader]
        assert batches, batches
        draws = (random.random(), float(np.random.rand()), float(torch.rand(())),
                 float(torch.rand((), generator=gen)))
        every = ops.gather_object(draws)
        # the draw before the epoch differed; the sync made these equal
        assert all(d == every[0] for d in every), (epoch, every)
    try:
        synchronize_rng_state("jax")
    except ValueError as err:
        assert "'jax'" in str(err), err
    else:
        raise AssertionError("the jax stream did not raise")
    accelerator.wait_for_everyone()


def check_dispatcher(accelerator):
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.data_loader import prepare_data_loader

    # the dispatcher's batch is global and splits over the processes: at 2
    # processes 8 rows in batches of 2, as the JAX scenario; at n, 4n rows in
    # batches of n
    n = accelerator.num_processes
    n_rows = 4 * n
    per_proc_bs = n * max(4 // n // n, 1)
    me = accelerator.process_index

    class RankZeroOnlyDS:
        """A source only rank 0 can read: a read anywhere else fails."""

        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            if me != 0:
                raise RuntimeError(f"dataset read on non-main rank {me}")
            return {"x": np.full((4,), float(i), dtype=np.float32), "idx": np.int32(i)}

    prepared = prepare_data_loader(DataLoader(RankZeroOnlyDS(), batch_size=per_proc_bs),
                                   mesh=accelerator.mesh, dispatch_batches=True)
    seen = []
    for batch in prepared:
        seen.extend(accelerator.gather(batch)["idx"].reshape(-1).tolist())
    assert sorted(seen) == list(range(n_rows)), sorted(seen)
    accelerator.wait_for_everyone()


def check_dispatcher_ragged(accelerator):
    """After the first batch, payloads take the raw tensor channel (one
    object broadcast in all), and the padded final batch is trimmed by
    ``gather_for_metrics`` so every row appears once."""
    import accelerate_tpu_torch.utils.operations as ops
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.data_loader import prepare_data_loader

    global_bs = 2 * accelerator.num_processes
    n_rows = global_bs * 2 + global_bs // 2
    me = accelerator.process_index

    class RankZeroOnlyDS:
        def __len__(self):
            return n_rows

        def __getitem__(self, i):
            if me != 0:
                raise RuntimeError(f"dataset read on non-main rank {me}")
            return {"x": np.full((4,), float(i), dtype=np.float32), "idx": np.int32(i)}

    object_casts = {"n": 0}
    real_bcast = ops.broadcast_object_list

    def counting_bcast(object_list, from_process=0):
        object_casts["n"] += 1
        return real_bcast(object_list, from_process)

    ops.broadcast_object_list = counting_bcast
    try:
        prepared = prepare_data_loader(
            DataLoader(RankZeroOnlyDS(), batch_size=global_bs, drop_last=False),
            mesh=accelerator.mesh, dispatch_batches=True)
        seen = []
        n_batches = 0
        for batch in prepared:
            n_batches += 1
            g = accelerator.gather_for_metrics({"idx": batch["idx"]})
            seen.extend(g["idx"].reshape(-1).tolist())
    finally:
        ops.broadcast_object_list = real_bcast
    assert n_batches == 3, n_batches
    assert sorted(seen) == list(range(n_rows)), sorted(seen)
    if accelerator.num_processes > 1:
        assert object_casts["n"] == 1, object_casts["n"]

    n_str = 2 * accelerator.num_processes

    class StringDS:
        def __len__(self):
            return n_str

        def __getitem__(self, i):
            if me != 0:
                raise RuntimeError(f"dataset read on non-main rank {me}")
            return {"text": f"doc-{i}", "idx": np.int32(i)}

    prepared2 = prepare_data_loader(
        DataLoader(StringDS(), batch_size=accelerator.num_processes), mesh=accelerator.mesh,
        dispatch_batches=True, device_placement=False)
    texts = []
    for batch in prepared2:
        assert len(batch["text"]) == accelerator.num_processes
        texts.extend(str(t) for t in np.asarray(batch["text"]).tolist())
    assert sorted(texts) == sorted(f"doc-{i}" for i in range(n_str)), texts
    accelerator.wait_for_everyone()


def check_training(accelerator, tmpdir: str):
    """Data-parallel SGD across processes; the main process writes the loss
    trajectory so that the caller can compare process counts."""
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.optimizer import sgd

    rng = np.random.default_rng(0)
    X = rng.normal(size=(32, 8)).astype(np.float32)
    W_true = rng.normal(size=(8, 1)).astype(np.float32)
    Y = X @ W_true

    class DS:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return {"x": X[i], "y": Y[i]}

    per_proc = 8 // accelerator.num_processes
    params = {"w": np.zeros((8, 1), np.float32), "b": np.zeros((1,), np.float32)}
    params, opt, dl = accelerator.prepare(params, sgd(0.1), DataLoader(DS(), batch_size=per_proc))

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return torch.mean((pred - batch["y"]) ** 2)

    step = accelerator.prepare_train_step(loss_fn, opt)
    opt_state = opt.opt_state
    losses = []
    for _ in range(3):
        for batch in dl:
            params, opt_state, metrics = step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    # the params are replicated: every process must hold the same values
    w_all = accelerator.gather_for_metrics(params["w"].detach().reshape(-1).tolist(),
                                           use_gather_object=True)
    assert all(w == w_all[0] for w in w_all), w_all
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, f"losses_np{accelerator.num_processes}.json"), "w") as f:
            json.dump(losses, f)
    accelerator.wait_for_everyone()


# (name, ParallelismConfig kwargs, fused ZeRO-1, TP rules) of the mesh_train legs at 4 ranks
MESH_LEGS = (
    ("dp_replicate2_dp_shard2", {"dp_replicate_size": 2, "dp_shard_size": 2}, False, False),
    ("dp_shard2_tp2", {"dp_shard_size": 2, "tp_size": 2}, False, True),
    ("tp4", {"tp_size": 4}, False, True),
    ("dp_replicate4_zero1", {"dp_replicate_size": 4}, True, False),
)
MESH_STEPS, MESH_LR = 5, 1e-3
# the legs of the options a sharded step takes, at 4 ranks and 3 steps:
# (name, ParallelismConfig kwargs, llama_tp_rules, leg options)
OPTION_STEPS = 3
# small enough that the offload leg stages every rank's AdamW state in
# several groups and splits the embedding's rows
OFFLOAD_GROUP_BYTES = 64 << 10
DCN_DP_SHARD_ENV = {"LOCAL_WORLD_SIZE": "2", "ACCELERATE_DCN_MESH_SHAPE": "1,1,2,1,1,1,1"}
FP16_SCALER = dict(init_scale=2.0 ** 40, growth_factor=2.0 ** 30, backoff_factor=2.0 ** -30,
                   growth_interval=2)
OPTION_LEGS = (
    ("adafactor_dp_shard2_tp2", {"dp_shard_size": 2, "tp_size": 2}, True,
     {"factory": "adafactor"}),
    ("clip_adafactor_dp_shard2_tp2", {"dp_shard_size": 2, "tp_size": 2}, True,
     {"factory": "clip_adafactor"}),
    ("adafactor_dp_shard4", {"dp_shard_size": 4}, False, {"factory": "adafactor"}),
    ("clip_adafactor_dp_shard4", {"dp_shard_size": 4}, False, {"factory": "clip_adafactor"}),
    ("fp16_dp_shard4", {"dp_shard_size": 4}, False,
     {"precision": "fp16", "scaler": FP16_SCALER}),
    # ZeRO-1 where the fused update cannot run: by annotation
    ("zero1_dp_replicate2_tp2", {"dp_replicate_size": 2, "tp_size": 2}, True, {"zero1": True}),
    ("zero1_fused_off", {"dp_replicate_size": 4}, False,
     {"zero1": True, "env": {"ACCELERATE_ZERO1_FUSED": "0"}}),
    ("zero1_int_leaf", {"dp_replicate_size": 4}, False, {"zero1": True, "int_leaf": True}),
    # adafactor under ZeRO-1 (by annotation: the fused update refuses it)
    ("zero1_adafactor_dp_replicate4", {"dp_replicate_size": 4}, False,
     {"zero1": True, "factory": "adafactor"}),
    ("zero1_adafactor_dp_replicate2_tp2", {"dp_replicate_size": 2, "tp_size": 2}, True,
     {"zero1": True, "factory": "adafactor"}),
    ("comm_bf16_dp_shard4", {"dp_shard_size": 4}, False, {"comm_hook": "bf16"}),
    ("offload_dp_shard4", {"dp_shard_size": 4}, False,
     {"offload": True, "offload_group_bytes": OFFLOAD_GROUP_BYTES}),
    ("lomo_dp_replicate4", {"dp_replicate_size": 4}, False, {"lomo": True}),
    # two "nodes" of two ranks: dp_replicate across them, dp_shard inside;
    # then dp_shard placed across them by ACCELERATE_DCN_MESH_SHAPE
    ("multinode_dp_replicate2_dp_shard2", {"dp_replicate_size": 2, "dp_shard_size": 2}, False,
     {"env": {"LOCAL_WORLD_SIZE": "2"}}),
    ("multinode_dcn_dp_shard", {"dp_replicate_size": 2, "dp_shard_size": 2}, False,
     {"env": DCN_DP_SHARD_ENV}),
)
# each new leg's planted fault, which must fail the leg's bar: the leg's
# options with ``fault`` set (see ``_fault``)
FAULT_LEGS = (
    ("zero1_adafactor_dp_replicate4_fault", "zero1_adafactor_dp_replicate4",
     "adafactor_local_stats"),
    ("comm_bf16_dp_shard4_fault", "comm_bf16_dp_shard4", "compress_before_reduce"),
    ("offload_dp_shard4_fault", "offload_dp_shard4", "offload_lost_write_back"),
    ("lomo_dp_replicate4_fault", "lomo_dp_replicate4", "lomo_local_gradients"),
    ("multinode_dcn_dp_shard_fault", "multinode_dcn_dp_shard", "flattened_grid"),
)
OPTION_LEGS = OPTION_LEGS + tuple(
    (name, *next((pc, tp, dict(opts, fault=fault))
                 for leg, pc, tp, opts in OPTION_LEGS if leg == base))
    for name, base, fault in FAULT_LEGS)
# one step at each remat policy (the live gathered layers counted) under
# dp_shard 4 (each rank holds one whole layer: a gather is a broadcast) and
# dp_shard 2 x tp 2 with llama_tp_rules (tp on the layer axis of wo and w2)
REMAT_LEGS = tuple((f"{mesh}_{remat}", pc, tp, {"remat": remat, "steps": 1})
                   for mesh, pc, tp in (("dp_shard4", {"dp_shard_size": 4}, False),
                                        ("dp_shard2_tp2", {"dp_shard_size": 2, "tp_size": 2}, True))
                   for remat in (False, True, "dots_no_batch"))


# fp8 training (the tiny Llama with dtype_recipe="fp8") at 4 ranks and
# FP8_STEPS steps of sgd(FP8_LR) under mixed_precision="fp8" (the second
# step's quantization reads the first step's histories): (name,
# ParallelismConfig kwargs, fused ZeRO-1, planted fault); each fault leg
# sums the meta gradients over the ranks where their MAX is taken
FP8_STEPS, FP8_LR = 2, 1e-2
FP8_LEGS = (
    ("fp8_dp_replicate4_zero1", {"dp_replicate_size": 4}, True, None),
    ("fp8_dp_replicate2_dp_shard2", {"dp_replicate_size": 2, "dp_shard_size": 2}, False, None),
)
FP8_LEGS = FP8_LEGS + tuple((f"{name}_fault", pc, zero1, "fp8_meta_summed")
                            for name, pc, zero1, _ in FP8_LEGS)


def _factory(name: str):
    from accelerate_tpu_torch.optimizer import adafactor, adamw, chain, clip_by_global_norm, sgd

    if name == "sgd":
        return sgd(FP8_LR)
    if name == "adamw":
        return adamw(MESH_LR)
    if name == "adafactor":
        return adafactor(MESH_LR)
    if name == "clip_adafactor":
        return chain(clip_by_global_norm(1.0), adafactor(MESH_LR))
    raise ValueError(name)


@contextlib.contextmanager
def _fault(name):
    """A planted fault of one of the ``FAULT_LEGS`` (none for ``None``);
    ``chip_smoke.py`` plants ``"offload_lost_write_back"`` on the card."""
    from accelerate_tpu_torch import accelerator as acc_mod
    from accelerate_tpu_torch import optimizer as opt_mod
    from accelerate_tpu_torch import parallelism_config as pc_mod
    from accelerate_tpu_torch.parallel import sharding as sh
    from accelerate_tpu_torch.utils import dataclasses as dc

    with contextlib.ExitStack() as stack:
        if name == "adafactor_local_stats":  # a block's sums never summed over the axis
            stack.enter_context(_planted(opt_mod._Split, "sum", lambda self, x, axes: x))
        elif name == "compress_before_reduce":  # each rank's own gradient cast to bf16
            bf = lambda g: g.to(torch.bfloat16).to(g.dtype)  # noqa: E731
            for target, attr, wrap in (
                    (sh._Layout, "scatter_grad", lambda f: lambda self, g: f(self, bf(g))),
                    (sh._LayerGroup, "reduce",
                     lambda f: lambda self, i, grads: f(self, i, [bf(g) for g in grads])),
                    (sh.ShardingPlan, "reduce_grads",
                     lambda f: lambda self, grads: f(self, [bf(g) for g in grads])),
                    (dc.DistributedDataParallelKwargs, "gradient_compression_dtype",
                     lambda f: lambda self: None)):
                stack.enter_context(_planted(target, attr, wrap(getattr(target, attr))))
        elif name == "offload_lost_write_back":  # the first group's update never lands
            real_stage, real_back = sh.OptimizerOffload._stage, sh.OptimizerOffload._write_back

            def stage(self, params, grads, group, slot, before):
                pieces, event = real_stage(self, params, grads, group, slot, before)
                if group[0][0] == 0:
                    self._lost = [(v, v.clone()) for piece in pieces for v in piece[5].values()]
                return pieces, event

            def write_back(self, params, pieces):
                real_back(self, params, pieces)
                if pieces[0][0] == 0:
                    if self.stream is not None:  # the copy back runs on it
                        self.stream.synchronize()
                    for ref, old in self._lost:
                        ref.copy_(old)

            stack.enter_context(_planted(sh.OptimizerOffload, "_stage", stage))
            stack.enter_context(_planted(sh.OptimizerOffload, "_write_back", write_back))
        elif name == "lomo_local_gradients":  # no mean over the ranks
            stack.enter_context(_planted(acc_mod, "all_reduce_axes", lambda x, *a, **k: x))
        elif name == "fp8_meta_summed":  # the meta gradients' MAX over the ranks a sum
            real = acc_mod.all_reduce_axes
            stack.enter_context(_planted(acc_mod, "all_reduce_axes", lambda x, mesh, axes, op="sum":
                                         real(x, mesh, axes, "sum" if op == "max" else op)))
        elif name == "flattened_grid":  # the ranks in row-major order, nodes ignored
            stack.enter_context(_planted(pc_mod.ParallelismConfig, "rank_grid",
                                         lambda self, n: np.arange(n).reshape(
                                             self.mesh_shape(n))))
        elif name == "cp_local_positions":  # each sequence chunk's RoPE from position 0
            from accelerate_tpu_torch.models import transformer as tt

            stack.enter_context(_planted(tt, "_chunk_positions", lambda S, mesh, device:
                                         torch.arange(S, device=device)))
        elif name == "cp_local_roll":  # each chunk's targets rolled within the chunk
            from accelerate_tpu_torch.models import transformer as tt

            stack.enter_context(_planted(tt, "_roll_left",
                                         lambda x, mesh: torch.roll(x, -1, dims=1)))
        elif name == "cp_grads_not_summed":  # the tokens' split over cp left out of the sums
            stack.enter_context(_planted(sh, "GRAD_SUM_AXES",
                                         tuple(a for a in sh.GRAD_SUM_AXES if a != "cp")))
        elif name is not None:
            raise ValueError(f"unknown fault {name}")
        yield


def mesh_train_leg(params_np: dict, batches: dict, pc_kwargs: dict, zero1: bool,
                   tp_rules: bool, device="cpu", factory: str = "adamw",
                   precision: str = "no", scaler: dict = None, remat=False,
                   steps: int = None, env: dict = None, int_leaf: bool = False,
                   moe: bool = False, moe_rules: bool = True,
                   prepare_rules: str = None, comm_hook: str = None, offload: bool = False,
                   offload_group_bytes: int = None, lomo: bool = False,
                   attention: bool = False, fault: str = None) -> dict:
    """``steps`` (all of ``batches`` by default) training steps of Llama at
    tiny widths (f32 params, plain attention) on one mesh, one step for each
    ``[K, ...]`` slice of ``batches`` (global ``input_ids`` and
    ``loss_mask``): the losses and gradient norms (under fp16 the loss scale
    and finite flag too), the full final params (numpy, ``/``-joined paths),
    this rank's optimizer array-state bytes and the step's per-layer gather
    counts. ``moe`` takes the MoE Llama of the params given with
    ``moe_shard_rules`` (whole experts on every rank without ``moe_rules``)
    and the first step's routed and dropped token-choices of this rank's
    rows; ``int_leaf`` adds an int32 leaf; ``prepare_rules="llama"`` passes
    ``llama_shard_rules()`` to ``prepare(..., shard_rules=)``; ``comm_hook``
    passes ``DistributedDataParallelKwargs(comm_hook=)``; ``offload`` keeps
    the optimizer state on the host (``offload_group_bytes`` a group);
    ``lomo`` takes ``lomo_backward`` steps of ``sgd(MESH_LR)`` instead (no
    gradient norms); ``fault`` plants one of ``_fault``'s faults. The
    mesh's rank grid and this rank's node (``rank // LOCAL_WORLD_SIZE``)
    are in ``mesh_grid`` and ``node``. Params with fp8 meta train the
    ``dtype_recipe="fp8"`` config; ``meta`` is this rank's meta leaves
    after the steps (``/``-joined paths), ``fp8`` the optimizer's meta and
    passthrough counts. ``attention`` runs the model's attention through
    ``Accelerator.context_parallel_attention()`` (the mesh's ``cp`` or
    ``sp`` split of the sequence)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.parallel import moe as tmoe
    from accelerate_tpu_torch.parallel.sharding import ShardingRules, _map_with_path, llama_tp_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin, GradScalerConfig
    from accelerate_tpu_torch.utils.environment import patch_environment
    from accelerate_tpu_torch.utils.operations import _tree_map

    AcceleratorState._reset_state()
    GradientState._reset_state()
    cfg = _llama_config(params_np)
    rules = llama_tp_rules() if tp_rules else None
    if moe and moe_rules:
        rules = tmoe.moe_shard_rules() + (rules or ShardingRules())
    if int_leaf:
        params_np = dict(params_np, step={"count": np.zeros(4, np.int32)})
    from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs

    handlers = [DistributedDataParallelKwargs(comm_hook=comm_hook)] if comm_hook else None
    with contextlib.ExitStack() as stack:
        stack.enter_context(_fault(fault))
        with patch_environment(**(env or {})):
            acc = Accelerator(device=device, mixed_precision=precision,
                              parallelism_config=ParallelismConfig(**pc_kwargs),
                              deepspeed_plugin=DeepSpeedPlugin(zero_stage=1) if zero1 else None,
                              shard_rules=rules, kwargs_handlers=handlers,
                              grad_scaler_config=GradScalerConfig(**scaler) if scaler else None)
            params, opt = acc.prepare(params_np, _factory(factory), shard_rules=(
                tt.llama_shard_rules() if prepare_rules == "llama" else None))
            node = acc.process_index // int(os.environ.get("LOCAL_WORLD_SIZE",
                                                           acc.num_processes))

        attention_fn = acc.context_parallel_attention() if attention else None

        def loss_fn(p, b):
            return tt.llama_loss(p, b, cfg, mesh=acc.mesh, remat=remat,
                                 attention_fn=attention_fn)

        step = None if lomo else acc.prepare_train_step(
            loss_fn, compute_grad_norm=True, offload_optimizer=offload)
        if offload and offload_group_bytes:
            opt.offload.group_bytes = offload_group_bytes
        assembler = GlobalBatchAssembler(acc.mesh, device=acc.device)
        out = {"losses": [], "grad_norms": [], "loss_scale": [], "grads_finite": [],
               "mesh_grid": acc.mesh.devices.ravel().tolist(), "node": node}
        n_steps = batches["input_ids"].shape[0] if steps is None else steps
        for k in range(n_steps):
            batch = assembler.to_global(assembler.local_block(
                {n: b[k] for n, b in batches.items()}))
            if lomo:
                loss, params = acc.lomo_backward(loss_fn, params, batch, learning_rate=MESH_LR)
                out["losses"].append(float(loss))
                continue
            drops = {} if moe and k == 0 else None
            with _count_drops(drops):
                params, _, metrics = step(params, opt.opt_state, batch)
            if drops is not None:
                out["drops"] = {key: int(v) for key, v in drops.items()}
            out["losses"].append(float(metrics["loss"]))
            out["grad_norms"].append(float(metrics["grad_norm"]))
            if precision == "fp16":
                out["loss_scale"].append(float(metrics["loss_scale"]))
                out["grads_finite"].append(bool(metrics["grads_finite"]))
    out["offload"] = None if opt.offload is None else {
        "groups": opt.offload.stats["groups"], "device_state_bytes": opt.device_state_bytes(),
        "host_state_bytes": opt.offload.host_bytes()}
    full = acc.sharding_plan.gather_params_no_grad(params)
    flat = {}
    _map_with_path(lambda path, x: flat.__setitem__(path, x.detach().cpu().numpy()), full)
    from accelerate_tpu_torch.ops.fp8 import fp8_meta_mask
    from accelerate_tpu_torch.optimizer import param_leaves

    paths = []
    _map_with_path(lambda path, x: paths.append(path), params)
    out["meta"] = {path: x.detach().cpu().numpy()
                   for path, x, m in zip(paths, param_leaves(params), fp8_meta_mask(params)) if m}
    out["fp8"] = {"meta_leaves": len(opt.meta), "passthrough": len(
        opt.zero1.plan.passthrough_indices) if opt.zero1 is not None else None}
    out.update(params=flat, opt_state_bytes=opt.state_bytes(), fused_zero1=opt.zero1 is not None,
               zero1_rows=opt.zero1_rows is not None,
               layer_stats=dict(acc.sharding_plan.layer_stats))
    if moe:  # the first forward's aux loss, at the initial (whole) params
        with torch.no_grad():
            _, aux = tt.llama_forward(
                _tree_map(lambda x: torch.from_numpy(np.asarray(x)), params_np),
                assembler.to_global(assembler.local_block(
                    {"input_ids": batches["input_ids"][0]}))["input_ids"],
                cfg, mesh=acc.mesh, with_aux=True)
        out["aux"] = float(aux)
    return out


@contextlib.contextmanager
def _count_drops(store):
    """Count into ``store`` the token-choices every MoE call routes and
    drops by capacity (this rank's rows), from the routing each call
    computes; nothing with ``store=None``."""
    from accelerate_tpu_torch.parallel import moe

    if store is None:
        yield
        return
    real = moe.route

    def route(*args, **kwargs):
        r = real(*args, **kwargs)
        store["routed"] = store.get("routed", 0) + r.keep.numel()
        store["dropped"] = store.get("dropped", 0) + int((~r.keep).sum())
        return r

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def _llama_config(params_np: dict):
    """Tiny widths at the depth of the params given (with their experts)."""
    from accelerate_tpu_torch.models import transformer as tt

    layers = params_np["layers"]
    n_layers = int(layers["wq"]["kernel"].shape[0])
    moe = layers.get("moe")
    experts = dict(moe_experts=int(moe["router"]["kernel"].shape[-1])) if moe else {}
    recipe = "fp8" if "fp8_meta" in layers["wq"] else None
    tiny = tt.LlamaConfig.tiny()
    n_kv_heads = int(layers["wk"]["kernel"].shape[-1]) // tiny.head_dim
    return dataclasses.replace(tiny, n_layers=n_layers, n_kv_heads=n_kv_heads,
                               dtype_recipe=recipe, **experts)


def gradient_fn_leg(params_np: dict, batch: dict, pc_kwargs: dict, tp_rules: bool,
                    device="cpu") -> dict:
    """``Accelerator.gradient_fn`` of the tiny Llama's loss on one global
    batch: the value and this rank's block of every gradient (``/``-joined
    paths)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import param_leaves
    from accelerate_tpu_torch.parallel.sharding import _map_with_path, llama_tp_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    cfg = _llama_config(params_np)
    acc = Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs),
                      shard_rules=llama_tp_rules() if tp_rules else None)
    params = acc.prepare_model(params_np)
    assembler = GlobalBatchAssembler(acc.mesh, device=acc.device)
    value, grads = acc.gradient_fn(lambda p, b: tt.llama_loss(p, b, cfg, mesh=acc.mesh))(
        params, assembler.to_global(assembler.local_block(batch)))
    flat = {}
    _map_with_path(lambda path, x: flat.__setitem__(path, x.detach().cpu().numpy()), grads)
    untouched = all(p.grad is None for p in param_leaves(params))
    return {"value": float(value), "grads": flat, "coords": dict(acc.mesh.coords),
            "params_grad_untouched": untouched}


def fp16_local_overflow_leg(params_np: dict, batches: dict, device="cpu") -> dict:
    """fp16 under dp_shard 4 with a non-finite value planted in one rank's
    block of one gradient at the second step (rank 1, the first split
    leaf): every rank must take the same decision. Each rank's finite flags
    and loss scales."""
    from accelerate_tpu_torch.parallel import sharding

    real = sharding.ShardingPlan.reduce_grads
    calls = {"n": 0}

    def planted(self, grads):
        out = real(self, grads)
        calls["n"] += 1
        if calls["n"] == 2 and self.mesh.rank == 1:
            split = next(i for i, s in enumerate(sharding._leaves(self.param_specs)) if len(s))
            out[split] = out[split].clone()
            out[split].view(-1)[0] = float("inf")
        return out

    sharding.ShardingPlan.reduce_grads = planted
    try:
        leg = mesh_train_leg(params_np, batches, {"dp_shard_size": 4}, False, False, device,
                             precision="fp16", scaler=dict(init_scale=2.0 ** 4))
    finally:
        sharding.ShardingPlan.reduce_grads = real
    return {"grads_finite": leg["grads_finite"], "loss_scale": leg["loss_scale"]}


# (model, mesh name, ParallelismConfig kwargs) of the zoo_train legs at 2 ranks
ZOO_LEGS = tuple((model, name, pc) for model in ("resnet", "t5") for name, pc in (
    ("dp_replicate2", {"dp_replicate_size": 2}), ("dp_shard2", {"dp_shard_size": 2})))
ZOO_STEPS = 2


def zoo_train_leg(model: str, params_np: dict, batches: dict, pc_kwargs: dict,
                  device="cpu") -> dict:
    """``ZOO_STEPS`` steps of tiny ResNet (``sgd(0.1, momentum=0.9)``) or
    tiny T5 (``adam(1e-3)``) with the model's shard rules on one mesh: the
    losses, gradient norms and full final params (``/``-joined paths)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import resnet as tresnet
    from accelerate_tpu_torch.models import t5 as tt5
    from accelerate_tpu_torch.optimizer import adam, sgd
    from accelerate_tpu_torch.parallel.sharding import _map_with_path
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    if model == "resnet":
        cfg, rules, factory = tresnet.ResNetConfig.tiny(), tresnet.resnet_shard_rules(), sgd(
            0.1, momentum=0.9)
    else:
        cfg, rules, factory = tt5.T5Config.tiny(), tt5.t5_shard_rules(), adam(1e-3)
    acc = Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs),
                      shard_rules=rules)
    params, opt = acc.prepare(params_np, factory)
    if model == "resnet":
        loss_fn = lambda p, b: tresnet.resnet_loss(p, b, cfg)  # noqa: E731
    else:
        loss_fn = lambda p, b: tt5.t5_loss(p, b, cfg, mesh=acc.mesh)  # noqa: E731
    step = acc.prepare_train_step(loss_fn, compute_grad_norm=True)
    assembler = GlobalBatchAssembler(acc.mesh, device=acc.device)
    losses, norms = [], []
    for k in range(ZOO_STEPS):
        batch = assembler.to_global(assembler.local_block({n: b[k] for n, b in batches.items()}))
        params, _, metrics = step(params, opt.opt_state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    flat = {}
    _map_with_path(lambda path, x: flat.__setitem__(path, x.detach().cpu().numpy()),
                   acc.sharding_plan.gather_params_no_grad(params))
    return {"losses": losses, "grad_norms": norms, "params": flat}


def check_zoo_train(accelerator, tmpdir: str):
    """The ``ZOO_LEGS`` on the params and batches the caller pickled to
    ``tmpdir/zoo_inputs.pkl``; the main process pickles the results to
    ``zoo_results.pkl``."""
    import pickle

    with open(os.path.join(tmpdir, "zoo_inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)  # written by the caller of this script
    results = {}
    for model, name, pc_kwargs in ZOO_LEGS:
        results[(model, name)] = zoo_train_leg(model, inputs[model]["params"],
                                               inputs[model]["batches"], pc_kwargs)
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "zoo_results.pkl"), "wb") as f:
            pickle.dump(results, f)
    accelerator.wait_for_everyone()


def _read_tree(path: str) -> dict:
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def pc_kwargs_shape(pc_kwargs: dict) -> tuple:
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    pc = ParallelismConfig(**pc_kwargs)
    return (pc.pp_size, pc.dp_replicate_size, pc.dp_shard_size, pc.cp_size, pc.sp_size,
            pc.tp_size, pc.ep_size)


def _run_legs(accelerator, tmpdir: str, params_np: dict, batches: dict, legs, report: dict,
              prefix: str = "mesh") -> None:
    """Each of ``legs`` (``(name, ParallelismConfig kwargs, llama_tp_rules,
    options)``): its numbers into ``report`` (per-rank state bytes, finite
    flags, loss scales and gather counts gathered to every rank) and, from
    the main process, its final params into ``<prefix>_<name>.npz``; the
    collectives each rank ran, by op (``comm``)."""
    from accelerate_tpu_torch.utils import operations as ops

    for name, pc_kwargs, tp_rules, options in legs:
        options = dict(options)
        zero1 = options.pop("zero1", False)
        ops.reset_comm_counters()
        out = mesh_train_leg(params_np, batches, pc_kwargs, zero1, tp_rules, **options)
        comm = sorted(ops.get_comm_counters())
        report[name] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                        "fused_zero1": out["fused_zero1"], "zero1_rows": out["zero1_rows"],
                        "comm": ops.gather_object(comm), "mesh_grid": out["mesh_grid"],
                        **{key: ops.gather_object(out[key])
                           for key in ("opt_state_bytes", "loss_scale", "grads_finite",
                                       "layer_stats", "node", "offload")}}
        if accelerator.is_main_process and "multinode" in name:
            print(f"[{name}] rank grid {out['mesh_grid']} (pp, dp_replicate, dp_shard, cp, sp, "
                  f"tp, ep = {[int(v) for v in pc_kwargs_shape(pc_kwargs)]}), nodes by rank "
                  f"{report[name]['node']}", flush=True)
        for key in ("aux", "drops"):
            if key in out:
                report[name][key] = ops.gather_object(out[key])
        if accelerator.is_main_process:
            np.savez(os.path.join(tmpdir, f"{prefix}_{name}.npz"), **out["params"])


def check_mesh_train(accelerator, tmpdir: str):
    """The ``MESH_LEGS``, ``OPTION_LEGS`` and ``REMAT_LEGS``, ``gradient_fn``
    under dp_shard 2 x tp 2 and the planted one-rank overflow, on the
    params and batches the caller wrote to ``tmpdir`` (``llama_params.npz``,
    ``llama_batches.npz``); the main process writes ``mesh_<leg>.npz``,
    ``grads_rank<i>.npz`` and ``mesh_train.json``."""
    from accelerate_tpu_torch.utils import operations as ops

    params_np = _read_tree(os.path.join(tmpdir, "llama_params.npz"))
    with np.load(os.path.join(tmpdir, "llama_batches.npz")) as f:
        batches = {k: f[k] for k in f.files}
    report = {}
    _run_legs(accelerator, tmpdir, params_np, batches,
              [(name, pc, tp, {"zero1": zero1}) for name, pc, zero1, tp in MESH_LEGS], report)
    _run_legs(accelerator, tmpdir, params_np, {n: b[:OPTION_STEPS] for n, b in batches.items()},
              OPTION_LEGS + REMAT_LEGS, report)
    grad = gradient_fn_leg(params_np, {n: b[0] for n, b in batches.items()},
                           {"dp_shard_size": 2, "tp_size": 2}, True)
    np.savez(os.path.join(tmpdir, f"grads_rank{accelerator.process_index}.npz"), **grad["grads"])
    report["gradient_fn"] = ops.gather_object({k: grad[k] for k in (
        "value", "coords", "params_grad_untouched")})
    report["fp16_local_overflow"] = ops.gather_object(
        fp16_local_overflow_leg(params_np, {n: b[:OPTION_STEPS] for n, b in batches.items()}))
    check_fp8_legs(accelerator, tmpdir, {n: b[:FP8_STEPS] for n, b in batches.items()}, report)
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "mesh_train.json"), "w") as f:
            json.dump(report, f)
    accelerator.wait_for_everyone()


def check_fp8_legs(accelerator, tmpdir: str, batches: dict, report: dict) -> None:
    """The ``FP8_LEGS`` on ``fp8_params.npz``: each leg's numbers into
    ``report`` with every rank's meta gathered (``meta_ranks``), its final
    params (meta included) into ``mesh_<leg>.npz``."""
    from accelerate_tpu_torch.utils import operations as ops

    params_np = _read_tree(os.path.join(tmpdir, "fp8_params.npz"))
    for name, pc_kwargs, zero1, fault in FP8_LEGS:
        out = mesh_train_leg(params_np, batches, pc_kwargs, zero1, False, factory="sgd",
                             precision="fp8", fault=fault)
        metas = ops.gather_object({k: v.tolist() for k, v in out["meta"].items()})
        report[name] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                        "fused_zero1": out["fused_zero1"], "fp8": out["fp8"],
                        "meta_ranks_equal": all(m == metas[0] for m in metas[1:])}
        if accelerator.is_main_process:
            np.savez(os.path.join(tmpdir, f"mesh_{name}.npz"), **out["params"])


# Context and sequence parallelism at 4 ranks (scenario "long_context").
# The attention alone, as the JAX package's tests/test_long_context.py at 4
# ranks, on q, k, v of _make_qkv's draws (np.random.default_rng(0), f32):
# (name, strategy, ParallelismConfig kwargs, causal, (B, S, H, Hkv, D),
# gradients of sum(out ** 2) too)
LC_ATTENTION_CASES = tuple(
    (f"{strategy}_{'causal' if causal else 'full'}", strategy,
     {"sp_size": 4} if strategy == "ulysses" else {"cp_size": 4}, causal, (2, 64, 4, 4, 16), False)
    for strategy in ("ring", "zigzag", "allgather", "ulysses") for causal in (True, False)
) + tuple(
    (f"{strategy}_gqa8_{hkv}", strategy, {"cp_size": 2, "dp_shard_size": 2}, False,
     (4 if hkv == 2 else 2, 32, 8, hkv, 16), False)
    for strategy in ("ring", "zigzag", "allgather") for hkv in (2, 1)
) + tuple(
    (f"{strategy}_grads", strategy, {"sp_size": 4} if strategy == "ulysses" else {"cp_size": 4},
     True, (2, 32, 4, 4, 16), True)
    for strategy in ("ring", "zigzag", "ulysses"))
# Llama forward (lc_llama_params.npz, ids [2, 64] of lc_llama_ids.npy)
# through each strategy under (cp 2, dp_shard 2)
LC_LLAMA_FORWARD = ("ring", "zigzag")
LC_PC = {"cp_size": 2, "dp_shard_size": 2}
# training on llama_params.npz (Hkv 2) and llama_kv4_params.npz (Hkv 4, for
# Ulysses over 4 ranks), LC_STEPS steps of the mesh_train batches: (name,
# ParallelismConfig kwargs, params file, leg options); each planted fault
# runs one step and must fail the leg's bars
LC_STEPS = 3
LC_LEGS = (
    ("cp2_dp_shard2_zigzag", dict(LC_PC, cp_rotate_method="zigzag"), "llama_params.npz",
     {"prepare_rules": "llama", "attention": True}),
    ("sp4", {"sp_size": 4}, "llama_kv4_params.npz", {"prepare_rules": "llama", "attention": True}),
)
LC_FAULTS = ("cp_local_positions", "cp_local_roll", "cp_grads_not_summed")
# examples/sequence_parallelism.py's recipe at --sp 4 --dp-shard 1 (f32,
# train-size 16, batch 4, 1 epoch, seq-len 128, adam(1e-3), seed 0) on
# lc_example_params.npz
LC_EXAMPLE = dict(train_size=16, batch_size=4, seq_len=128, lr=1e-3, seed=0)


def lc_qkv(B, S, H, Hkv, D, seed=0):
    """q, k, v as the JAX package's ``tests/test_long_context._make_qkv``."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def lc_block(x, mesh, axis: str):
    """This rank's block of a global ``[B, S, ...]`` array: its rows of the
    data-parallel axes, its chunk of ``axis``."""
    dp = mesh.shape["dp_replicate"] * mesh.shape["dp_shard"]
    row = mesh.coords["dp_replicate"] * mesh.shape["dp_shard"] + mesh.coords["dp_shard"]
    n, c = mesh.shape[axis], mesh.coords[axis]
    B, S = x.shape[:2]
    return x[row * B // dp:(row + 1) * B // dp, c * S // n:(c + 1) * S // n]


def _lc_example(accelerator_cls, params_np: dict) -> list:
    """``examples/sequence_parallelism.py``'s training loop in the port at
    ``sp 4`` (``LC_EXAMPLE``): the loss of each step."""
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import adam
    from accelerate_tpu_torch.parallel.long_context import sequence_parallel_attention
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    class _Dataset:
        def __init__(self, data):
            self.data = data

        def __len__(self):
            return len(next(iter(self.data.values())))

        def __getitem__(self, i):
            return {k: v[i] for k, v in self.data.items()}

    AcceleratorState._reset_state()
    GradientState._reset_state()
    ex = LC_EXAMPLE
    acc = accelerator_cls(mixed_precision="no", cpu=True, rng_seed=ex["seed"],
                          parallelism_config=ParallelismConfig(sp_size=4, dp_shard_size=1))
    config = dataclasses.replace(tt.LlamaConfig.tiny(), max_seq_len=ex["seq_len"], n_heads=4,
                                 n_kv_heads=4)
    # make_synthetic_lm(train_size, seq_len, vocab, seed=0) of examples/example_utils.py
    rng = np.random.default_rng(0)
    motif = rng.integers(2, config.vocab_size, size=(ex["train_size"], 4), dtype=np.int32)
    ids = np.tile(motif, (1, -(-ex["seq_len"] // 4)))[:, :ex["seq_len"]]
    dl = DataLoader(_Dataset({"input_ids": ids}), batch_size=ex["batch_size"], shuffle=True,
                    seed=ex["seed"])
    params, opt, dl = acc.prepare(params_np, adam(ex["lr"]), dl,
                                  shard_rules=tt.llama_shard_rules())
    attn = sequence_parallel_attention(acc.mesh)
    step = acc.prepare_train_step(
        lambda p, b: tt.llama_loss(p, b, config, attention_fn=attn, mesh=acc.mesh), opt)
    state, losses = opt.opt_state, []
    for batch in dl:
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
    return losses


def check_long_context(accelerator, tmpdir: str):
    """The ``LC_ATTENTION_CASES`` (each rank's output block, and of ``dq``,
    ``dk``, ``dv`` where asked), the Llama forward through each of
    ``LC_LLAMA_FORWARD`` (each rank's logits block), the ``LC_LEGS`` with
    the planted ``LC_FAULTS`` on the first, and ``LC_EXAMPLE``: every rank
    writes ``lc_rank<i>.npz``, the main process ``long_context.json`` and
    ``lc_<leg>.npz`` (the legs' final params)."""
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.parallel.long_context import make_context_parallel_attention
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils import operations as ops

    blocks, meshes = {}, {}
    for name, strategy, pc_kwargs, causal, shape, grads in LC_ATTENTION_CASES:
        key = tuple(sorted(pc_kwargs.items()))
        mesh = meshes.get(key) or meshes.setdefault(
            key, ParallelismConfig(**pc_kwargs).build_mesh(device_type="cpu"))
        axis = "sp" if strategy == "ulysses" else "cp"
        q, k, v = (torch.from_numpy(np.ascontiguousarray(lc_block(x, mesh, axis)))
                   .requires_grad_(grads) for x in lc_qkv(*shape))
        out = make_context_parallel_attention(mesh, strategy)(q, k, v, causal=causal)
        blocks[f"{name}/out"] = out.detach().numpy()
        if grads:
            (out ** 2).sum().backward()
            for key, x in zip(("dq", "dk", "dv"), (q, k, v)):
                blocks[f"{name}/{key}"] = x.grad.numpy()
    params_np = _read_tree(os.path.join(tmpdir, "lc_llama_params.npz"))
    ids = np.load(os.path.join(tmpdir, "lc_llama_ids.npy"))
    mesh = meshes[tuple(sorted(LC_PC.items()))]
    cfg = dataclasses.replace(tt.LlamaConfig.tiny(), vocab_size=128, dim=64, n_heads=4,
                              n_kv_heads=2, max_seq_len=64)
    params = _torch_tree(params_np)
    for strategy in LC_LLAMA_FORWARD:
        with torch.no_grad():
            logits = tt.llama_forward(params, torch.from_numpy(
                np.ascontiguousarray(lc_block(ids, mesh, "cp"))), cfg, mesh=mesh,
                attention_fn=make_context_parallel_attention(mesh, strategy))
        blocks[f"llama_{strategy}/logits"] = logits.numpy()
    np.savez(os.path.join(tmpdir, f"lc_rank{accelerator.process_index}.npz"), **blocks)

    with np.load(os.path.join(tmpdir, "llama_batches.npz")) as f:
        batches = {k: f[k][:LC_STEPS] for k in f.files}
    report = {}
    for name, pc_kwargs, params_file, options in LC_LEGS:
        leg_params = _read_tree(os.path.join(tmpdir, params_file))
        _run_legs(accelerator, tmpdir, leg_params, batches, [(name, pc_kwargs, False, options)],
                  report, prefix="lc")
        if name == LC_LEGS[0][0]:
            _run_legs(accelerator, tmpdir, leg_params, {n: b[:1] for n, b in batches.items()},
                      [(f"{name}_{fault}", pc_kwargs, False, dict(options, fault=fault))
                       for fault in LC_FAULTS], report, prefix="lc")
    report["example"] = _lc_example(Accelerator, _read_tree(
        os.path.join(tmpdir, "lc_example_params.npz")))
    report["coords"] = ops.gather_object(mesh.coords)
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "long_context.json"), "w") as f:
            json.dump(report, f)
    accelerator.wait_for_everyone()


# the sharded checkpoint legs at 4 ranks: (name, ParallelismConfig kwargs,
# fused ZeRO-1, optimizer); CKPT_STEPS steps with a save after CKPT_SAVE_AT
CKPT_LEGS = (
    ("dp2_shard2", {"dp_replicate_size": 2, "dp_shard_size": 2}, False, "adafactor"),
    ("zero1_dp4", {"dp_replicate_size": 4}, True, "adamw"),
)
CKPT_STEPS, CKPT_SAVE_AT = 4, 2


def _ckpt_setup(params_np: dict, pc_kwargs: dict, zero1: bool, factory: str, device="cpu"):
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin

    AcceleratorState._reset_state()
    GradientState._reset_state()
    cfg = _llama_config(params_np)
    acc = Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs),
                      deepspeed_plugin=DeepSpeedPlugin(zero_stage=1) if zero1 else None)
    params, opt = acc.prepare(params_np, _factory(factory))
    step = acc.prepare_train_step(lambda p, b: tt.llama_loss(p, b, cfg, mesh=acc.mesh))
    return acc, params, opt, step, GlobalBatchAssembler(acc.mesh, device=acc.device)


def ckpt_leg(params_np: dict, batches: dict, pc_kwargs: dict, zero1: bool, factory: str,
             ckpt_dir: str, device="cpu") -> dict:
    """``CKPT_STEPS`` steps of tiny Llama with a ``save_state`` into
    ``ckpt_dir`` after ``CKPT_SAVE_AT`` (sharded: each rank its blocks);
    then a fresh ``Accelerator`` on zeroed params loads it and takes the
    steps after the save. Returns both runs' losses, the whole params at
    the save (``saved``), the bytes this rank wrote and whether the save
    was sharded."""
    from accelerate_tpu_torch.parallel.sharding import _map_with_path

    acc, params, opt, step, assembler = _ckpt_setup(params_np, pc_kwargs, zero1, factory,
                                                    device)

    def batch(k):
        return assembler.to_global(assembler.local_block({n: b[k] for n, b in batches.items()}))

    out = {"losses": [], "resumed": []}
    for k in range(CKPT_STEPS):
        if k == CKPT_SAVE_AT:
            acc.save_state(ckpt_dir)
            out["bytes"] = acc.last_checkpoint.nbytes
            out["sharded"] = acc.last_checkpoint.sharded
            saved = {}
            _map_with_path(lambda path, x: saved.__setitem__(path, x.numpy()),
                           acc.get_state_dict(params))
            out["saved"] = saved
        params, _, metrics = step(params, opt.opt_state, batch(k))
        out["losses"].append(float(metrics["loss"]))
    from accelerate_tpu_torch.utils.operations import _tree_map

    acc, params, opt, step, assembler = _ckpt_setup(_tree_map(np.zeros_like, params_np),
                                                    pc_kwargs, zero1, factory, device)
    acc.load_state(ckpt_dir)
    for k in range(CKPT_SAVE_AT, CKPT_STEPS):
        params, _, metrics = step(params, opt.opt_state, batch(k))
        out["resumed"].append(float(metrics["loss"]))
    return out


def check_mesh_ckpt(accelerator, tmpdir: str):
    """The ``CKPT_LEGS`` on ``llama_params.npz`` and ``llama_batches.npz``,
    each into ``ckpt_<leg>``; the main process writes each leg's params at
    the save into ``ckpt_<leg>_saved.npz`` and ``mesh_ckpt.json``."""
    from accelerate_tpu_torch.utils import operations as ops

    params_np = _read_tree(os.path.join(tmpdir, "llama_params.npz"))
    with np.load(os.path.join(tmpdir, "llama_batches.npz")) as f:
        batches = {k: f[k][:CKPT_STEPS] for k in f.files}
    report = {}
    for name, pc_kwargs, zero1, factory in CKPT_LEGS:
        out = ckpt_leg(params_np, batches, pc_kwargs, zero1, factory,
                       os.path.join(tmpdir, f"ckpt_{name}"))
        report[name] = {"losses": out["losses"], "resumed": out["resumed"],
                        "sharded": out["sharded"], "bytes": ops.gather_object(out["bytes"])}
        if accelerator.is_main_process:
            np.savez(os.path.join(tmpdir, f"ckpt_{name}_saved.npz"), **out["saved"])
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "mesh_ckpt.json"), "w") as f:
            json.dump(report, f)
    accelerator.wait_for_everyone()


# the MoE Llama's legs at 4 ranks (tp 2 with no tp rules fills a mesh that
# needs only 2: its ranks compute the same rows alike), with moe_shard_rules
MOE_LEGS = (
    ("dp_shard2", {"dp_shard_size": 2, "tp_size": 2}, False, {"moe": True}),
    ("ep2", {"ep_size": 2, "tp_size": 2}, False, {"moe": True}),
    ("ep2_dp_shard2", {"ep_size": 2, "dp_shard_size": 2}, False, {"moe": True}),
    ("ep2_whole_experts", {"ep_size": 2, "tp_size": 2}, False,
     {"moe": True, "moe_rules": False}),
)


def check_mesh_moe(accelerator, tmpdir: str):
    """The ``MOE_LEGS`` on ``moe_params.npz`` and ``moe_batches.npz``; the
    main process writes ``moe_<leg>.npz`` and ``mesh_moe.json``. Also
    checks that the loader gives every rank of an ``ep`` group the same
    rows."""
    from accelerate_tpu_torch import DataLoader
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import operations as ops

    params_np = _read_tree(os.path.join(tmpdir, "moe_params.npz"))
    with np.load(os.path.join(tmpdir, "moe_batches.npz")) as f:
        batches = {k: f[k] for k in f.files}
    report = {}
    _run_legs(accelerator, tmpdir, params_np, batches, MOE_LEGS, report, prefix="moe")
    AcceleratorState._reset_state()
    GradientState._reset_state()
    from accelerate_tpu_torch import Accelerator

    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(ep_size=2, dp_shard_size=2))
    loader = acc.prepare_data_loader(DataLoader(_row_dataset(16), batch_size=2))
    rows = [b["idx"].tolist() for b in loader]
    report["loader_rows"] = ops.gather_object({"coords": dict(acc.mesh.coords), "rows": rows})
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "mesh_moe.json"), "w") as f:
            json.dump(report, f)
    accelerator.wait_for_everyone()


# the sharded decode and serving legs at 4 ranks: (name, ParallelismConfig kwargs)
DECODE_MESHES = {"dp_shard2_tp2": {"dp_shard_size": 2, "tp_size": 2}, "tp4": {"tp_size": 4},
                 "ep2_tp2": {"ep_size": 2, "tp_size": 2},
                 # tp 2 for the engine, whose every rank serves every request
                 "dp_replicate2_tp2": {"dp_replicate_size": 2, "tp_size": 2}}
DECODE_ENGINE_KW = dict(num_blocks=33, block_size=8, max_slots=4)
DECODE_NEW = 6


def _decode_acc(pc_kwargs: dict, device="cpu"):
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    return Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs))


def _torch_tree(tree):
    from accelerate_tpu_torch.utils.operations import _tree_map

    return _tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def decode_engine_run(params, config, prompts, mesh=None, device="cpu", engine_kw=None,
                      cache_dtype=torch.float32):
    """The engine over ``prompts`` (``(prompt, max_new_tokens)``, each
    submitted with a step between): each request's ``output_ids()``, the
    ``stats()`` without the two timings, and this rank's pool bytes."""
    from accelerate_tpu_torch.serving.buckets import BucketLattice
    from accelerate_tpu_torch.serving.engine import ServingEngine

    kw = dict(DECODE_ENGINE_KW, lattice=BucketLattice(slot_buckets=(2, 4), block_buckets=(8,),
                                                      prefill_buckets=(16, 32)))
    kw.update(engine_kw or {})
    engine = ServingEngine(params, config, cache_dtype=cache_dtype, device=device, mesh=mesh,
                           **kw)
    reqs = []
    for i, (prompt, new) in enumerate(prompts):
        reqs.append(engine.submit(np.asarray(prompt), new, rng_seed=i))
        engine.step()
    engine.run()
    stats = {k: v for k, v in engine.stats().items() if not k.endswith("_seconds")}
    pool = sum(t.numel() * t.element_size() for t in engine.pool.values())
    return {"outputs": [r.output_ids().tolist() for r in reqs], "stats": stats,
            "pool_bytes": int(pool)}


def _pool_on_the_other_ranks_heads(mesh):
    """A planted fault: each rank of ``mesh`` writes the K/V of the next
    ``tp`` rank's heads into its pool."""
    from accelerate_tpu_torch.parallel.sharding import _all_gather_dim
    from accelerate_tpu_torch.parallelism_config import axis_sizes
    from accelerate_tpu_torch.serving import engine as engine_mod

    real = engine_mod._write_kv
    tp = axis_sizes(mesh).get("tp", 1)
    other = (mesh.coords.get("tp", 0) + 1) % tp

    def swapped(k_pool, v_pool, phys, off, k, v):
        n = k.shape[2]
        k, v = (_all_gather_dim(t.contiguous(), 2, mesh.group("tp")).narrow(2, other * n, n)
                for t in (k, v))
        real(k_pool, v_pool, phys, off, k, v)

    return engine_mod, "_write_kv", swapped


@contextlib.contextmanager
def _planted(target, name, value):
    real = getattr(target, name)
    setattr(target, name, value)
    try:
        yield
    finally:
        setattr(target, name, real)


def check_mesh_decode(accelerator, tmpdir: str):
    """Sharded decode and serving on the inputs the caller pickled to
    ``tmpdir/decode_inputs.pkl`` (params, prompts, configs): greedy, beam,
    eos and sampled decode under (dp_shard 2, tp 2), greedy from the
    ``Accelerator``'s FSDP placement there, greedy under tp 4 (heads that
    do not divide), MoE greedy under (ep 2, tp 2), the engine under
    (dp_replicate 2, tp 2) and (dp_shard 2, tp 2), a planted fault for each
    of the two paths, and the Llama and BERT training steps under
    (dp_shard 2, tp 2) through ``prepare(..., shard_rules=)``. The main
    process pickles the results to ``decode_results.pkl``."""
    import pickle

    from accelerate_tpu_torch.generation import (
        MeshDecode,
        beam_generate,
        greedy_generate,
        sample_generate,
    )
    from accelerate_tpu_torch.models.transformer import LlamaConfig, llama_shard_rules
    from accelerate_tpu_torch.parallel.sharding import shard_params
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.random import prng_key

    with open(os.path.join(tmpdir, "decode_inputs.pkl"), "rb") as f:
        inp = pickle.load(f)  # written by the caller of this script
    res = {}
    cfg = LlamaConfig(**inp["config"])
    params = _torch_tree(inp["params"])
    prompt = inp["prompt"]
    kw = dict(cache_dtype=torch.float32, device="cpu")

    acc = _decode_acc(DECODE_MESHES["dp_shard2_tp2"])
    sharded, specs = shard_params(params, acc.mesh, rules=llama_shard_rules())
    kw["mesh"] = acc.mesh
    res["greedy"] = greedy_generate(sharded, prompt, cfg, max_new_tokens=DECODE_NEW, **kw)
    res["beam"], res["beam_scores"] = beam_generate(sharded, prompt, cfg, num_beams=2,
                                                    max_new_tokens=5, return_scores=True, **kw)
    res["eos"] = greedy_generate(sharded, prompt, cfg, max_new_tokens=DECODE_NEW,
                                 eos_token_id=5, **kw)
    res["sampled"] = sample_generate(sharded, prompt, cfg, max_new_tokens=DECODE_NEW,
                                     temperature=0.7, top_k=8, rng_key=prng_key(7), **kw)
    res["param_bytes"] = ops.gather_object(MeshDecode(sharded, cfg, acc.mesh).block_bytes())
    res["coords"] = ops.gather_object(dict(acc.mesh.coords))
    with _planted(MeshDecode, "attn_out", lambda self, x: x):  # no sum over tp after wo
        res["fault_no_wo_sum"] = greedy_generate(sharded, prompt, cfg,
                                                 max_new_tokens=DECODE_NEW, **kw)
    prepared = acc.prepare_model(inp["params"], shard_rules=llama_shard_rules())
    res["greedy_fsdp"] = greedy_generate(prepared, prompt, cfg, max_new_tokens=DECODE_NEW,
                                         param_specs=acc.param_specs, **kw)
    res["fsdp_layer_specs"] = str(acc.param_specs["layers"]["wq"]["kernel"])

    acc = _decode_acc(DECODE_MESHES["tp4"])
    sharded, _ = shard_params(params, acc.mesh, rules=llama_shard_rules())
    res["greedy_tp4"] = greedy_generate(sharded, prompt, cfg, max_new_tokens=DECODE_NEW,
                                        **dict(kw, mesh=acc.mesh))
    md = MeshDecode(sharded, cfg, acc.mesh)
    res["tp4_cache_heads"] = (md.attn_tp, md.kv_heads)

    moe_cfg = LlamaConfig(**inp["moe_config"])
    acc = _decode_acc(DECODE_MESHES["ep2_tp2"])
    moe_sharded, _ = shard_params(_torch_tree(inp["moe_params"]), acc.mesh,
                                  rules=llama_shard_rules())
    res["moe_greedy"] = greedy_generate(moe_sharded, inp["moe_prompt"], moe_cfg,
                                        max_new_tokens=5, **dict(kw, mesh=acc.mesh))
    res["moe_wi_block"] = list(moe_sharded["layers"]["moe"]["wi"]["kernel"].shape)

    eng_cfg = LlamaConfig(**inp["engine_config"])
    eng_params = _torch_tree(inp["engine_params"])
    for name in ("dp_replicate2_tp2", "dp_shard2_tp2"):
        acc = _decode_acc(DECODE_MESHES[name])
        eng_sharded, _ = shard_params(eng_params, acc.mesh, rules=llama_shard_rules())
        run = decode_engine_run(eng_sharded, eng_cfg, inp["engine_prompts"], mesh=acc.mesh)
        run["pool_bytes"] = ops.gather_object(run["pool_bytes"])
        res[f"engine_{name}"] = run
    with _planted(*_pool_on_the_other_ranks_heads(acc.mesh)):
        res["fault_pool_heads"] = decode_engine_run(eng_sharded, eng_cfg, inp["engine_prompts"],
                                                    mesh=acc.mesh)["outputs"]

    # training through prepare(..., shard_rules=): Llama, then BERT
    report = {}
    _run_legs(accelerator, tmpdir, inp["llama_params"], inp["llama_batches"],
              [("llama_shard_rules", DECODE_MESHES["dp_shard2_tp2"], False,
                {"prepare_rules": "llama"})], report, prefix="shard")
    res["llama_shard_rules"] = report["llama_shard_rules"]
    bert = bert_shard_leg(inp["bert_params"], inp["bert_batches"],
                          DECODE_MESHES["dp_shard2_tp2"])
    res["bert_shard_rules"] = {k: v for k, v in bert.items() if k != "params"}
    if accelerator.is_main_process:
        res["bert_params"] = bert["params"]
        with np.load(os.path.join(tmpdir, "shard_llama_shard_rules.npz")) as f:
            res["llama_params"] = {k: f[k] for k in f.files}
        with open(os.path.join(tmpdir, "decode_results.pkl"), "wb") as f:
            pickle.dump(res, f)
    accelerator.wait_for_everyone()


def bert_shard_leg(params_np: dict, batches: dict, pc_kwargs: dict, device="cpu") -> dict:
    """``adamw(1e-3)`` steps of tiny BERT prepared with
    ``prepare(..., shard_rules=bert_shard_rules())`` on one mesh: losses,
    gradient norms, full final params (``/``-joined paths) and the specs of
    the split kernels."""
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.parallel.sharding import _map_with_path

    acc = _decode_acc(pc_kwargs, device)
    cfg = tt.BertConfig.tiny()
    params, opt = acc.prepare(params_np, adamw(MESH_LR), shard_rules=tt.bert_shard_rules())
    step = acc.prepare_train_step(lambda p, b: tt.bert_loss(p, b, cfg),
                                  compute_grad_norm=True)
    assembler = GlobalBatchAssembler(acc.mesh, device=acc.device)
    losses, norms = [], []
    for k in range(batches["labels"].shape[0]):
        batch = assembler.to_global(assembler.local_block({n: b[k] for n, b in batches.items()}))
        params, _, metrics = step(params, opt.opt_state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    flat = {}
    _map_with_path(lambda path, x: flat.__setitem__(path, x.detach().cpu().numpy()),
                   acc.sharding_plan.gather_params_no_grad(params))
    specs = {name: str(acc.param_specs["layers"][name]["kernel"]) for name in ("wq", "wo")}
    return {"losses": losses, "grad_norms": norms, "params": flat, "specs": specs}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scenario", default="all")
    parser.add_argument("--tmpdir", default="/tmp")
    args = parser.parse_args()
    torch.set_num_threads(1)

    from accelerate_tpu_torch import Accelerator

    expect_n = int(os.environ.get("ACCELERATE_NUM_PROCESSES", 1))
    accelerator = Accelerator(mixed_precision="no", rng_seed=0, cpu=True)
    scenarios = args.scenario.split(",") if args.scenario != "all" else [
        "topology", "ops", "dataloader", "dispatcher", "dispatcher_ragged", "training"]
    for scenario in scenarios:
        if scenario == "topology":
            check_topology(accelerator, expect_n)
        elif scenario == "ops":
            check_ops(accelerator)
        elif scenario == "dataloader":
            check_dataloader(accelerator)
        elif scenario == "dispatcher":
            check_dispatcher(accelerator)
        elif scenario == "rng_sync":
            check_rng_sync(accelerator)
        elif scenario == "dispatcher_ragged":
            check_dispatcher_ragged(accelerator)
        elif scenario == "training":
            check_training(accelerator, args.tmpdir)
        elif scenario == "mesh_train":
            check_mesh_train(accelerator, args.tmpdir)
        elif scenario == "long_context":
            check_long_context(accelerator, args.tmpdir)
        elif scenario == "mesh_ckpt":
            check_mesh_ckpt(accelerator, args.tmpdir)
        elif scenario == "mesh_moe":
            check_mesh_moe(accelerator, args.tmpdir)
        elif scenario == "zoo_train":
            check_zoo_train(accelerator, args.tmpdir)
        elif scenario == "mesh_decode":
            check_mesh_decode(accelerator, args.tmpdir)
        else:
            raise ValueError(f"unknown scenario {scenario}")
        print(f"[proc {accelerator.process_index}] scenario {scenario}: OK", flush=True)
    print(f"ALL OK proc={accelerator.process_index}/{accelerator.num_processes}", flush=True)
    accelerator.partial_state.destroy_process_group()


if __name__ == "__main__":
    main()
