"""Context and sequence parallelism in one process, against the JAX package
(the multi-process legs run in ``tests/test_torch_mesh_train.py``'s launch,
scenario ``long_context``).

- The lse-returning flash function (``ops.flash_attention.
  flash_attention_lse``, kernels #1-#3 through their plain versions on the
  CPU): ``out`` and ``lse`` and the gradients of a loss on both against
  torch autograd of the plain attention (f32: 1e-5, the blocked online
  softmax sums in another order; measured below 1e-6).
- ``_zigzag_perms`` equal to JAX's at cp 2, 4 and 8; ``_block_attn`` and
  ``_merge_blocks`` against JAX's (f32 1e-6; bf16 within 2**-7 relative of
  the largest value: p rounded to bf16 before the value product on both
  sides, XLA and torch summing in their own order).
- ``TorchContextParallelConfig``, ``TorchTensorParallelConfig``,
  ``TorchTensorParallelPlugin`` and ``DeepSpeedSequenceParallelConfig``:
  defaults (environment set and unset) and errors as JAX's.
- The prepared loader's sequence split against JAX's
  ``GlobalBatchAssembler`` on 4 virtual devices: each rank's block equal to
  the JAX shard at its mesh coordinates, and the same ``ValueError`` where
  the length does not divide.
- ``Accelerator.context_parallel_attention`` picks JAX's strategy for each
  config, and ``maybe_context_parallel`` warns on buffer arguments as
  JAX's does; ``make_context_parallel_attention`` on an axis of size 1 is
  the plain attention, and Ulysses raises JAX's ``ValueError`` when the
  heads do not divide.
- ``llama_forward`` raises JAX's ``ValueError`` for ``segment_ids`` with
  an ``attention_fn``, and the sharded step runs cp and sp meshes (only
  ``pp`` raises); MoE routing raises under a sequence split.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.data_loader import GlobalBatchAssembler as JAssembler
from accelerate_tpu.ops.attention import make_padding_mask as j_make_padding_mask
from accelerate_tpu.parallel import long_context as jlc
from accelerate_tpu.parallelism_config import ParallelismConfig as JParallelismConfig
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import Accelerator
from accelerate_tpu_torch.data_loader import GlobalBatchAssembler, prepare_data_loader
from accelerate_tpu_torch.ops.attention import make_padding_mask
from accelerate_tpu_torch.ops.flash_attention import flash_attention_lse
from accelerate_tpu_torch.parallel import long_context as tlc
from accelerate_tpu_torch.parallelism_config import Mesh, ParallelismConfig
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils.environment import patch_environment


def _plain(q, k, v, causal):
    """Plain attention and its log-sum-exp in f32 autograd: ``(out [B, S,
    H, D], lse [B, H, S])``."""
    H, D = q.shape[2], q.shape[3]
    k, v = (x.repeat_interleave(H // x.shape[2], dim=2) for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / D ** 0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v), torch.logsumexp(s, -1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_flash_lse_gradients_of_out_and_lse(causal, hkv):
    rng = np.random.default_rng(hkv)
    B, S, H, D = 2, 64, 4, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = t(B, S, H, D).requires_grad_(), t(B, S, hkv, D).requires_grad_(), \
        t(B, S, hkv, D).requires_grad_()
    w_out, w_lse = t(B, S, H, D), t(B, H, S)
    got = flash_attention_lse(q, k, v, causal=causal, block_q=32, block_kv=32)
    (got[0] * w_out).sum().add((got[1] * w_lse).sum()).backward()
    got_grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    want = _plain(q, k, v, causal)
    (want[0] * w_out).sum().add((want[1] * w_lse).sum()).backward()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-5)
    for name, a, x in zip(("dq", "dk", "dv"), got_grads, (q, k, v)):
        np.testing.assert_allclose(a.numpy(), x.grad.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("cp", [2, 4, 8])
def test_zigzag_perms_equal_jax(cp):
    assert tlc._zigzag_perms(cp) == jlc._zigzag_perms(cp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_attn_and_merge_equal_jax(dtype):
    rng = np.random.default_rng(0)
    q, k, v, k2, v2 = (rng.standard_normal((2, 4, 16, 8)).astype(np.float32) for _ in range(5))
    mask = np.tril(np.ones((16, 16), bool))
    jt_ = getattr(jnp, dtype)
    tt_ = getattr(torch, dtype)

    def both(fn_j, fn_t, *xs, m=None):
        j = fn_j(*(jnp.asarray(x, jt_) for x in xs), None if m is None else jnp.asarray(m),
                 0.25)
        t = fn_t(*(torch.from_numpy(x).to(tt_) for x in xs),
                 None if m is None else torch.from_numpy(m), 0.25)
        return j, t

    (jo, jm, jl), (to, tm, tl) = both(jlc._block_attn, tlc._block_attn, q, k, v, m=mask)
    (jo2, jm2, jl2), (to2, tm2, tl2) = both(jlc._block_attn, tlc._block_attn, q, k2, v2)
    jmerged = jlc._merge_blocks(jo, jm, jl, jo2, jm2, jl2)
    tmerged = tlc._merge_blocks(to, tm, tl, to2, tm2, tl2)
    for a, b in zip((jo, jm, jl, *jmerged), (to, tm, tl, *tmerged)):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        tol = 1e-6 if dtype == "float32" else 2 ** -7 * np.abs(a).max()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=tol)


def test_make_padding_mask_equals_jax():
    mask = (np.random.default_rng(0).random((3, 7)) < 0.6).astype(np.int32)
    np.testing.assert_array_equal(make_padding_mask(torch.from_numpy(mask), 5).numpy(),
                                  np.asarray(j_make_padding_mask(jnp.asarray(mask), 5)))


# -- the configs --

_ENV = {"PARALLELISM_CONFIG_CP_COMM_STRATEGY": "alltoall",
        "PARALLELISM_CONFIG_SP_SEQ_LENGTH_IS_VARIABLE": "false",
        "PARALLELISM_CONFIG_SP_ATTN_IMPLEMENTATION": "flash_attention_2"}
_CONFIG_CASES = [
    ("TorchContextParallelConfig", {}, ("cp_comm_strategy", "cp_rotate_method")),
    ("TorchContextParallelConfig", {"cp_comm_strategy": "alltoall"},
     ("cp_comm_strategy", "cp_rotate_method")),
    ("DeepSpeedSequenceParallelConfig", {},
     ("sp_seq_length", "sp_seq_length_is_variable", "sp_attn_implementation", "attention_impl")),
    ("DeepSpeedSequenceParallelConfig", {"sp_seq_length": 4096, "sp_attn_implementation": "sdpa"},
     ("sp_seq_length", "sp_seq_length_is_variable", "sp_attn_implementation", "attention_impl")),
    ("TorchTensorParallelConfig", {}, ("enable_async_tp",)),
    ("TorchTensorParallelPlugin", {"tp_size": 2}, ("tp_size",)),
]


@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("cls,kwargs,fields", _CONFIG_CASES)
def test_config_defaults_equal_jax(cls, kwargs, fields, env):
    with patch_environment(**(_ENV if env else {})):
        j, t = getattr(jdc, cls)(**kwargs), getattr(tdc, cls)(**kwargs)
    for name in fields:
        assert getattr(t, name) == getattr(j, name), name
    if cls == "TorchTensorParallelPlugin":
        jpc, tpc = j.to_parallelism_config(), t.to_parallelism_config()
        assert (tpc.tp_size, tpc.dp_shard_size) == (jpc.tp_size, jpc.dp_shard_size)


@pytest.mark.parametrize("cls,kwargs", [
    ("TorchContextParallelConfig", {"cp_comm_strategy": "ring"}),
    ("DeepSpeedSequenceParallelConfig", {"sp_attn_implementation": "eager"}),
])
def test_config_errors_equal_jax(cls, kwargs):
    with pytest.raises(ValueError) as jerr:
        getattr(jdc, cls)(**kwargs)
    with pytest.raises(ValueError) as terr:
        getattr(tdc, cls)(**kwargs)
    assert str(terr.value) == str(jerr.value)


def test_async_tp_warns_like_jax():
    with pytest.warns(UserWarning):
        jdc.TorchTensorParallelConfig(enable_async_tp=True)
    with pytest.warns(UserWarning, match="enable_async_tp"):
        tdc.TorchTensorParallelConfig(enable_async_tp=True)


# -- the loader's sequence split --

_SPLITS = {"cp2_dp_shard2": {"cp_size": 2, "dp_shard_size": 2}, "sp4": {"sp_size": 4},
           "dp_replicate2_sp2": {"dp_replicate_size": 2, "sp_size": 2}}


def _shape(pc_kwargs):
    pc = ParallelismConfig(**pc_kwargs)
    return (pc.pp_size, pc.dp_replicate_size, pc.dp_shard_size, pc.cp_size, pc.sp_size,
            pc.tp_size, pc.ep_size)


@pytest.mark.parametrize("seq_dim", [1, 2])
@pytest.mark.parametrize("mesh_name", list(_SPLITS))
def test_loader_sequence_split_equals_jax(mesh_name, seq_dim):
    pc_kwargs = _SPLITS[mesh_name]
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 100, (4, 16), dtype=np.int32),
             "embeds": rng.standard_normal((4, 8, 16)).astype(np.float32),
             "labels": rng.integers(0, 2, (4,), dtype=np.int32)}
    jpc = JParallelismConfig(**pc_kwargs)
    jmesh = jpc.build_mesh()
    jglobal = JAssembler(jmesh, jpc, seq_dim=seq_dim).to_global(batch)
    coords = {d: dict(zip(jmesh.axis_names, c))
              for c, d in zip(np.ndindex(*jmesh.devices.shape), jmesh.devices.flat)}
    for rank in range(4):
        mesh = Mesh(_shape(pc_kwargs), rank=rank)
        got = GlobalBatchAssembler(mesh, device="cpu", seq_dim=seq_dim).to_global(
            GlobalBatchAssembler(mesh, seq_dim=seq_dim).local_block(batch))
        for key, arr in jglobal.items():
            shard = next(s for s in arr.addressable_shards if coords[s.device] == mesh.coords)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(shard.data),
                                          err_msg=f"{key} rank {rank}")


def test_loader_sequence_split_raises_like_jax():
    batch = {"input_ids": np.zeros((4, 10), np.int32)}
    jpc = JParallelismConfig(cp_size=4)
    with pytest.raises(ValueError) as jerr:
        JAssembler(jpc.build_mesh(), jpc).to_global(batch)
    with pytest.raises(ValueError) as terr:
        GlobalBatchAssembler(Mesh(_shape({"cp_size": 4}), rank=1), device="cpu").to_global(batch)
    assert str(terr.value) == str(jerr.value)


def test_prepare_data_loader_takes_seq_dim_like_jax():
    import inspect

    from accelerate_tpu.data_loader import prepare_data_loader as j_prepare

    assert inspect.signature(prepare_data_loader).parameters["seq_dim"].default == \
        inspect.signature(j_prepare).parameters["seq_dim"].default == 1


# -- the Accelerator's hooks --

@pytest.mark.parametrize("pc_kwargs,strategy", [
    ({"cp_size": 2}, None), ({"cp_size": 2, "cp_rotate_method": "ring"}, None),
    ({"cp_size": 2, "cp_rotate_method": "zigzag"}, None),
    ({"cp_size": 2, "cp_rotate_method": "zigzag"}, "ring"), ({"sp_size": 2}, None),
    ({"sp_size": 2}, "ring"), ({}, None)])
def test_context_parallel_attention_picks_jax_strategy(monkeypatch, pc_kwargs, strategy):
    """Each package's ``context_parallel_attention`` (called on a stand-in
    holding the config and a mesh) hands its ``make_context_parallel_
    attention`` the same strategy; without cp or sp both return plain
    attention, with the same values."""
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jlc, "make_context_parallel_attention",
                        lambda mesh, strategy: calls["jax"].append(strategy))
    monkeypatch.setattr(tlc, "make_context_parallel_attention",
                        lambda mesh, strategy: calls["torch"].append(strategy))
    jattn = JAccelerator.context_parallel_attention(types.SimpleNamespace(
        parallelism_config=JParallelismConfig(**pc_kwargs), mesh=None), strategy)
    tattn = Accelerator.context_parallel_attention(types.SimpleNamespace(
        parallelism_config=ParallelismConfig(**pc_kwargs), mesh=Mesh(_shape(pc_kwargs))),
        strategy)
    assert calls["torch"] == calls["jax"]
    if not pc_kwargs:
        q, k, v = (np.random.default_rng(i).standard_normal((1, 8, 2, 4)).astype(np.float32)
                   for i in range(3))
        np.testing.assert_allclose(
            tattn(*(torch.from_numpy(x) for x in (q, k, v))).numpy(),
            np.asarray(jattn(*(jnp.asarray(x) for x in (q, k, v)))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kwargs", [{}, {"buffers": [np.zeros(2)], "buffer_seq_dims": [0]},
                                    {"no_restore_buffers": set()}])
def test_maybe_context_parallel_warns_like_jax(kwargs):
    def warned(cls):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with cls.maybe_context_parallel(types.SimpleNamespace(), **kwargs):
                pass
        return [str(w.message) for w in caught]

    assert warned(Accelerator) == warned(JAccelerator)
    assert bool(warned(Accelerator)) == bool(kwargs)


def test_axis_of_one_is_plain_attention_and_ulysses_checks_heads():
    q, k, v = (np.random.default_rng(i).standard_normal((2, 8, 4, 8)).astype(np.float32)
               for i in range(3))
    for causal in (True, False):
        jattn = jlc.make_context_parallel_attention(JParallelismConfig().build_mesh(), "ring")
        tattn = tlc.make_context_parallel_attention(Mesh(_shape({}), rank=0), "ring")
        np.testing.assert_allclose(
            tattn(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal).numpy(),
            np.asarray(jattn(*(jnp.asarray(x) for x in (q, k, v)), causal=causal)),
            rtol=1e-6, atol=1e-6)
    q3 = np.zeros((2, 8, 3, 8), np.float32)
    with pytest.raises(ValueError) as jerr:
        jlc.sequence_parallel_attention(JParallelismConfig(sp_size=2).build_mesh())(
            jnp.asarray(q3), jnp.asarray(q3), jnp.asarray(q3))
    with pytest.raises(ValueError) as terr:
        tlc.sequence_parallel_attention(Mesh(_shape({"sp_size": 2}), rank=0))(
            *(torch.from_numpy(q3[:, :4]) for _ in range(3)))
    assert str(terr.value) == str(jerr.value)


def test_segment_ids_with_attention_fn_raise_like_jax():
    from accelerate_tpu.models import transformer as jt
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.models.convert import params_from_numpy

    cfg = jt.LlamaConfig.tiny()
    jparams = jt.init_llama(cfg, jax.random.PRNGKey(0))
    ids, seg = np.ones((1, 8), np.int32), np.ones((1, 8), np.int32)
    with pytest.raises(ValueError) as jerr:
        jt.llama_forward(jparams, jnp.asarray(ids), cfg, segment_ids=jnp.asarray(seg),
                         attention_fn=lambda q, k, v, causal: q)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with pytest.raises(ValueError) as terr:
        tt.llama_forward(params, torch.from_numpy(ids), tt.LlamaConfig(**vars(cfg)),
                         segment_ids=torch.from_numpy(seg),
                         attention_fn=lambda q, k, v, causal: q)
    assert str(terr.value) == str(jerr.value)


def test_sharded_step_runs_cp_and_sp_and_raises_for_pp():
    from accelerate_tpu_torch.parallel.sharding import ShardingPlan

    for pc_kwargs in ({"cp_size": 2}, {"sp_size": 2}, {"cp_size": 2, "dp_shard_size": 2}):
        ShardingPlan(mesh=Mesh(_shape(pc_kwargs), rank=0), parallelism_config=None, rules=None,
                     param_specs={}).check_supported()
    with pytest.raises(NotImplementedError, match="11b"):
        ShardingPlan(mesh=Mesh(_shape({"pp_size": 2}), rank=0), parallelism_config=None,
                     rules=None, param_specs={}).check_supported()


@pytest.mark.parametrize("pc_kwargs", [{"cp_size": 2}, {"sp_size": 2},
                                       {"cp_size": 2, "dp_shard_size": 2}])
def test_moe_routing_raises_under_a_sequence_split(pc_kwargs):
    """MoE routing covers the batch ranks only: a sequence split over cp or
    sp raises rather than route each chunk as a run of the global order."""
    from accelerate_tpu_torch.parallel.moe import init_moe_ffn, moe_ffn

    params = init_moe_ffn(torch.Generator().manual_seed(0), 8, 16, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="sequence split"):
        moe_ffn(params, torch.zeros(1, 4, 8), mesh=Mesh(_shape(pc_kwargs), rank=0))
