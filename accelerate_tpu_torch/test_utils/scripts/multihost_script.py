"""Multi-process assertion script of the port: the counterpart of
``accelerate_tpu.test_utils.scripts.multihost_script``, with its
``topology``, ``ops``, ``dataloader``, ``dispatcher``,
``dispatcher_ragged`` and ``training`` scenarios and their assertions, and
two of the port's own, ``mesh_train`` (a few Llama training steps on each
of several meshes) and ``zoo_train`` (ResNet and T5 under data
parallelism and FSDP), whose losses, gradient norms, final params and
optimizer-state bytes they write for the caller to compare.

Run N copies under the launcher protocol (see :func:`~accelerate_tpu_torch.
test_utils.testing.execute_multiprocess`)::

    python -m accelerate_tpu_torch.test_utils.scripts.multihost_script \\
        --scenario topology,ops --tmpdir /tmp/xyz

Each process uses one CPU thread and imports no JAX.
"""

from __future__ import annotations

import argparse
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


def mesh_train_leg(params_np: dict, batches: dict, pc_kwargs: dict, zero1: bool,
                   tp_rules: bool, device="cpu") -> dict:
    """``MESH_STEPS`` AdamW steps of Llama at tiny widths (f32, plain attention) on
    one mesh, one step for each ``[K, ...]`` slice of ``batches`` (global
    ``input_ids`` and ``loss_mask``): the losses and gradient norms, the
    full final params (numpy, ``/``-joined paths) and this rank's optimizer
    array-state bytes."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.parallel.sharding import _map_with_path, llama_tp_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin

    AcceleratorState._reset_state()
    GradientState._reset_state()
    # tiny widths at the depth of the params given
    cfg = dataclasses.replace(tt.LlamaConfig.tiny(),
                              n_layers=int(params_np["layers"]["wq"]["kernel"].shape[0]))
    acc = Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs),
                      deepspeed_plugin=DeepSpeedPlugin(zero_stage=1) if zero1 else None,
                      shard_rules=llama_tp_rules() if tp_rules else None)
    params, opt = acc.prepare(params_np, adamw(MESH_LR))
    step = acc.prepare_train_step(lambda p, b: tt.llama_loss(p, b, cfg, mesh=acc.mesh),
                                  compute_grad_norm=True)
    assembler = GlobalBatchAssembler(acc.mesh, device=acc.device)
    losses, norms = [], []
    for k in range(batches["input_ids"].shape[0]):
        batch = assembler.to_global(assembler.local_block({n: b[k] for n, b in batches.items()}))
        params, _, metrics = step(params, opt.opt_state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    full = acc.sharding_plan.gather_params_no_grad(params)
    flat = {}
    _map_with_path(lambda path, x: flat.__setitem__(path, x.detach().cpu().numpy()), full)
    return {"losses": losses, "grad_norms": norms, "params": flat,
            "opt_state_bytes": opt.state_bytes(),
            "fused_zero1": opt.zero1 is not None}


# ZeRO-1 where the fused update cannot run, at 4 ranks: (name,
# ParallelismConfig kwargs, llama_tp_rules, environment, an int32 leaf added)
ZERO1_REFUSALS = (
    ("dp_replicate2_tp2", {"dp_replicate_size": 2, "tp_size": 2}, True, {}, False),
    ("fused_off", {"dp_replicate_size": 4}, False, {"ACCELERATE_ZERO1_FUSED": "0"}, False),
    ("int_leaf", {"dp_replicate_size": 4}, False, {}, True),
)


def zero1_refusals(params_np: dict, device="cpu") -> dict:
    """What ``Accelerator(deepspeed_plugin=DeepSpeedPlugin(zero_stage=1))``
    and ``prepare(params, adamw(...))`` do in each of ``ZERO1_REFUSALS``:
    the name of the exception raised, or ``None`` when it returned."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.parallel.sharding import llama_tp_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin
    from accelerate_tpu_torch.utils.environment import patch_environment

    out = {}
    for name, pc_kwargs, tp_rules, env, int_leaf in ZERO1_REFUSALS:
        AcceleratorState._reset_state()
        GradientState._reset_state()
        params = dict(params_np, step={"count": np.zeros(4, np.int32)}) if int_leaf else params_np
        with patch_environment(**env):
            try:
                acc = Accelerator(device=device, parallelism_config=ParallelismConfig(**pc_kwargs),
                                  deepspeed_plugin=DeepSpeedPlugin(zero_stage=1),
                                  shard_rules=llama_tp_rules() if tp_rules else None)
                acc.prepare(params, adamw(MESH_LR))
                out[name] = None
            except NotImplementedError as e:
                out[name] = f"{type(e).__name__}: {e}"
    return out


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


def check_mesh_train(accelerator, tmpdir: str):
    """The ``MESH_LEGS`` on the params and batches the caller wrote to
    ``tmpdir`` (``llama_params.npz``, ``llama_batches.npz``); the main
    process writes ``mesh_<leg>.npz`` and ``mesh_train.json``."""
    from accelerate_tpu_torch.utils import operations as ops

    with np.load(os.path.join(tmpdir, "llama_params.npz")) as f:
        flat = {k: f[k] for k in f.files}
    params_np: dict = {}
    for path, value in flat.items():
        node = params_np
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    with np.load(os.path.join(tmpdir, "llama_batches.npz")) as f:
        batches = {k: f[k] for k in f.files}
    report = {}
    for name, pc_kwargs, zero1, tp_rules in MESH_LEGS:
        out = mesh_train_leg(params_np, batches, pc_kwargs, zero1, tp_rules)
        state_bytes = ops.gather_object(out["opt_state_bytes"])
        report[name] = {"losses": out["losses"], "grad_norms": out["grad_norms"],
                        "opt_state_bytes": state_bytes,
                        "fused_zero1": out["fused_zero1"]}
        if accelerator.is_main_process:
            np.savez(os.path.join(tmpdir, f"mesh_{name}.npz"), **out["params"])
    report["zero1_refusals"] = zero1_refusals(params_np)
    if accelerator.is_main_process:
        with open(os.path.join(tmpdir, "mesh_train.json"), "w") as f:
            json.dump(report, f)
    accelerator.wait_for_everyone()


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
        elif scenario == "dispatcher_ragged":
            check_dispatcher_ragged(accelerator)
        elif scenario == "training":
            check_training(accelerator, args.tmpdir)
        elif scenario == "mesh_train":
            check_mesh_train(accelerator, args.tmpdir)
        elif scenario == "zoo_train":
            check_zoo_train(accelerator, args.tmpdir)
        else:
            raise ValueError(f"unknown scenario {scenario}")
        print(f"[proc {accelerator.process_index}] scenario {scenario}: OK", flush=True)
    print(f"ALL OK proc={accelerator.process_index}/{accelerator.num_processes}", flush=True)
    accelerator.partial_state.destroy_process_group()


if __name__ == "__main__":
    main()
