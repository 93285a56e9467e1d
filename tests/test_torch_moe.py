"""The port's MoE FFN and the MoE Llama against the JAX package on the CPU,
with params from the JAX initializers (``init_moe_ffn`` /
``init_llama(PRNGKey(0))``) crossed through
``models.convert.params_from_numpy``, inputs from numpy seeds, f32.

- ``moe_ffn`` at ``top_k`` 1 and 2, on shapes with several routing groups
  and a group size lowered to a divisor that is no power of two, at
  capacity factors 1.25, 0.5 (tokens dropped) and 8.0 (none dropped):
  outputs within 1e-6 absolute (products of the same f32 values; the
  combine's two terms may be fused on one side), the aux loss within 1e-6
  relative, and the gradients of ``sum(y · w) + aux`` with respect to the
  input and every param, router included, within 1e-5 of each tensor's
  largest magnitude (the router's at top-1 within 1e-4: its output path
  is the gradient of ``v / v``, rounding noise on both sides);
- the routing itself: which tokens each choice keeps equals JAX's
  dispatch tensor;
- ``llama_forward(with_aux=True)`` and ``llama_loss`` with their gradients
  on ``LlamaConfig.tiny()`` with 4 experts, top-2;
- ``greedy_generate``, ``sample_generate``, ``beam_generate`` and
  ``generate_dispatched`` tokens equal to JAX's on that config (the
  decode capacity floor; without it the greedy tokens part from JAX's);
- the ``ServingEngine`` token for token with the JAX engine: a prompt
  whose last prefill chunk is padded (every padded row is routed), prefix
  cache on and off, speculation on;
- each remat policy's gradients equal the no-remat ones bitwise (one
  thread); ``"dots"`` alone saves the batched expert products, and every
  named policy saves the router's product, as JAX's policies do;
- ``moe_shard_rules`` is the JAX package's table, and ``mesh=`` on a mesh
  of one rank is the plain function (the meshed function over 4 processes
  is held to JAX in ``tests/test_torch_mesh_moe.py``); the device rule of
  ``init_moe_ffn``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu import generation as jg
from accelerate_tpu.models import transformer as jt
from accelerate_tpu.parallel import moe as jm
from accelerate_tpu.serving import BucketLattice as JLattice
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch import generation as tg
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.optimizer import param_leaves
from accelerate_tpu_torch.parallel import moe as tm
from accelerate_tpu_torch.serving import BucketLattice as TLattice
from accelerate_tpu_torch.serving import ServingEngine as TEngine
from accelerate_tpu_torch.serving import scheduler as tsched
from accelerate_tpu_torch.utils import random as trand
from accelerate_tpu_torch.utils.modeling import named_parameters

D, F, E = 32, 64, 6
MOE = dict(moe_experts=4, moe_top_k=2)
JCFG = dataclasses.replace(jt.LlamaConfig.tiny(), **MOE)
TCFG = dataclasses.replace(tt.LlamaConfig.tiny(), **MOE)
B, S, NEW = 3, 8, 8
CPU = dict(device="cpu")

# (B, S, group_size, top_k, capacity_factor): G = 3 groups of 8; 30 tokens
# in groups of 6 (7 lowered to 6); one group of 16 that drops nothing; 8
# groups of 4 (5 lowered to 4) at half capacity
FFN_CASES = [(2, 12, 8, 2, 1.25), (3, 10, 7, 1, 0.5), (2, 8, 4096, 2, 8.0), (2, 16, 5, 2, 0.5),
             (2, 12, 8, 1, 1.25)]


@pytest.fixture(scope="module")
def ffn_params():
    jp = jm.init_moe_ffn(jax.random.PRNGKey(0), D, F, E)
    return jp, jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), **CPU)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("b,s,group_size,top_k,cf", FFN_CASES,
                         ids=[f"B{b}S{s}-g{g}-k{k}-cf{cf}" for b, s, g, k, cf in FFN_CASES])
def test_moe_ffn_matches_jax(ffn_params, b, s, group_size, top_k, cf):
    jp, npp = ffn_params
    rng = np.random.default_rng(b * 100 + s)
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    w = rng.normal(size=(b, s, D)).astype(np.float32)
    kw = dict(top_k=top_k, capacity_factor=cf, group_size=group_size)

    def jloss(p, x):
        y, aux = jm.moe_ffn(p, x, **kw)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, jnp.asarray(x))
    tp = params_from_numpy(npp, **CPU)
    for t in param_leaves(tp):
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tm.moe_ffn(tp, tx, **kw)
    ((ty * torch.from_numpy(w)).sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=1e-6)
    grads = {"x": (tx.grad, jgx), **{name: (t.grad, named_parameters(jgp)[name])
                                     for name, t in named_parameters(tp).items()}}
    for name, (got, want) in grads.items():
        want = np.asarray(want)
        assert np.abs(want).max() > 0, name
        # top-1: the renormalised gate is v / v, whose gradient is zero but
        # computes as rounding noise of 1/v - v/v^2 on each side
        bar = 1e-4 if (top_k == 1 and name == "router/kernel") else 1e-5
        np.testing.assert_allclose(got.numpy(), want, atol=bar * np.abs(want).max(), rtol=0,
                                   err_msg=name)
    r = tm.route(tp["router"]["kernel"], tx.detach(), top_k, cf, group_size)
    dropped = int((~r.keep).sum())
    assert dropped > 0 if cf == 0.5 else cf < 8.0 or dropped == 0, dropped
    assert r.G * r.g == b * s and (group_size >= b * s or r.G > 1)


def test_routing_keeps_the_tokens_jax_dispatches(ffn_params):
    """JAX's dispatch tensor ``[G, g, E, C]`` rebuilt from the port's
    (expert, slot, keep) of each choice: equal, at a factor that drops."""
    jp, npp = ffn_params
    x = np.random.default_rng(9).normal(size=(2, 12, D)).astype(np.float32)
    captured = {}
    real_einsum = jnp.einsum

    def spy(spec, *ops, **kw):
        if spec == "gnec,gnd->egcd":
            captured["dispatch"] = np.asarray(ops[0])
        return real_einsum(spec, *ops, **kw)

    jnp.einsum = spy
    try:
        jm.moe_ffn(jp, jnp.asarray(x), top_k=2, capacity_factor=0.75, group_size=8)
    finally:
        jnp.einsum = real_einsum
    r = tm.route(torch.from_numpy(npp["router"]["kernel"]), torch.from_numpy(x), 2, 0.75, 8)
    mine = np.zeros_like(captured["dispatch"])
    for t, k in np.ndindex(*r.idx.shape):
        if r.keep[t, k]:
            gi, n = divmod(t, r.g)
            mine[gi, n, int(r.idx[t, k]), int(r.pos[t, k])] = 1.0
    assert (~r.keep).any()
    np.testing.assert_array_equal(mine, captured["dispatch"])


def test_llama_forward_loss_and_grads_match_jax(params):
    jp, tp = params
    ids = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 16)).astype(np.int32)
    jlogits, jaux = jt.llama_forward(jp, jnp.asarray(ids), JCFG, with_aux=True)
    tlogits, taux = tt.llama_forward(tp, torch.from_numpy(ids), TCFG, with_aux=True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    jl, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.llama_loss(p, {"input_ids": jnp.asarray(ids)}, JCFG)))(jp)
    leaves = param_leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss = tt.llama_loss(tp, {"input_ids": torch.from_numpy(ids)}, TCFG)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        want = named_parameters(jax.tree_util.tree_map(np.asarray, jgrads))
        for name, t in named_parameters(tp).items():
            np.testing.assert_allclose(t.grad.numpy(), want[name],
                                       atol=1e-4 * np.abs(want[name]).max(), rtol=0,
                                       err_msg=name)
        assert np.abs(want["layers/moe/router/kernel"]).max() > 0
    finally:
        for t in leaves:
            t.requires_grad_(False)
            t.grad = None


def test_generation_tokens_match_jax(params, prompt, monkeypatch):
    jp, tp = params
    kw = dict(max_new_tokens=NEW, cache_dtype=jnp.float32)
    tkw = dict(max_new_tokens=NEW, cache_dtype=torch.float32)
    greedy = np.asarray(jg.greedy_generate(jp, prompt, JCFG, **kw))
    np.testing.assert_array_equal(tg.greedy_generate(tp, prompt, TCFG, **tkw, **CPU), greedy)
    sampled = np.asarray(jg.sample_generate(jp, prompt, JCFG, rng_key=jax.random.PRNGKey(5),
                                            temperature=0.8, top_k=20, **kw))
    np.testing.assert_array_equal(
        tg.sample_generate(tp, prompt, TCFG, rng_key=trand.prng_key(5), temperature=0.8,
                           top_k=20, **tkw, **CPU), sampled)
    beams = np.asarray(jg.beam_generate(jp, prompt, JCFG, num_beams=2, **kw))
    np.testing.assert_array_equal(tg.beam_generate(tp, prompt, TCFG, num_beams=2, **tkw, **CPU),
                                  beams)
    dispatched = tg.generate_dispatched(tbm.cpu_offload(tg.unstack_layer_params(tp, TCFG), "cpu"),
                                        prompt, TCFG, **tkw)
    np.testing.assert_array_equal(dispatched, greedy)
    # the floor is what makes decode steps drop nothing: without it, 3 rows
    # of 2 choices over 4 experts get 2 slots an expert and part from JAX
    monkeypatch.setattr(tg, "decode_capacity", lambda config, S: None)
    assert not np.array_equal(tg.greedy_generate(tp, prompt, TCFG, **tkw, **CPU), greedy)


@pytest.mark.parametrize("spec", [{}, dict(spec_tokens=3, draft_layers=1)], ids=["plain", "spec"])
@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix_on", "prefix_off"])
def test_engine_equals_jax_engine(params, prefix_cache, spec):
    """Four greedy requests, two sharing a 16-token prefix and one of 27
    tokens, whose second 16-token prefill chunk holds 11 real tokens and
    5 padded ones that are routed beside them."""
    jp, tp = params
    rng = np.random.default_rng(5)
    shared = rng.integers(0, JCFG.vocab_size, 16)
    prompts = [np.concatenate([shared, rng.integers(0, JCFG.vocab_size, 3)]),
               np.concatenate([shared, rng.integers(0, JCFG.vocab_size, 6)]),
               rng.integers(0, JCFG.vocab_size, 27), rng.integers(0, JCFG.vocab_size, 9)]
    buckets = dict(slot_buckets=(2, 4), block_buckets=(8,), prefill_buckets=(16,))
    kw = dict(num_blocks=24, block_size=8, max_slots=4, prefix_cache=prefix_cache, **spec)
    je = JEngine(jp, JCFG, cache_dtype=jnp.float32, lattice=JLattice(**buckets), **kw)
    te = TEngine(tp, TCFG, cache_dtype=torch.float32, lattice=TLattice(**buckets), **kw, **CPU)
    jr = [je.submit(p, 10) for p in prompts]
    tr = [te.submit(p, 10) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.status is tsched.RequestStatus.FINISHED
        np.testing.assert_array_equal(b.output_ids(), a.output_ids())
    js, ts = je.stats(), te.stats()
    assert ts["prefill_tokens"] == js["prefill_tokens"]
    saved = ts.get("prefill_tokens_saved", 0)
    assert saved == js.get("prefill_tokens_saved", 0)
    assert (saved > 0) == prefix_cache


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [True, "nothing", "dots", "dots_no_batch", "offload_dots"])
def test_remat_policies_equal_no_remat(params, remat, one_thread):
    _, tp = params
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, JCFG.vocab_size, (2, 16)))

    def grads(**kw):
        leaves = param_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss = tt.llama_loss(tp, {"input_ids": ids}, TCFG, **kw)
            mode = _CountMM()
            with mode:
                loss.backward()
            return loss.detach(), [t.grad for t in leaves], mode.counts
        finally:
            for t in leaves:
                t.requires_grad_(False)
                t.grad = None

    base_loss, base, base_counts = grads()
    loss, got, counts = grads(remat=remat)
    assert torch.equal(loss, base_loss)
    for a, b in zip(got, base):
        assert torch.equal(a, b)
    # recomputed in the backward, a layer: the 2 attention and 2 expert
    # products (batched: "dots" alone saves them) and the 4 projections and
    # the router's product (no batch dims: every named policy saves them)
    extra = {k: counts[k] - base_counts[k] for k in counts}
    named = remat not in (True, "nothing")
    assert extra == {"bmm": 0 if remat == "dots" else 4 * TCFG.n_layers,
                     "mm": 0 if named else 5 * TCFG.n_layers}, (remat, extra)


def test_mesh_raises_and_device_rule(ffn_params, monkeypatch):
    """(The name is from when ``mesh=`` and ``moe_shard_rules`` raised; they
    are ported now and held to the JAX package here.)"""
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    jp, npp = ffn_params
    tp = params_from_numpy(npp, **CPU)
    x = np.random.default_rng(3).normal(size=(2, 12, D)).astype(np.float32)
    jy, jaux = jm.moe_ffn(jp, jnp.asarray(x), top_k=2, capacity_factor=0.75, group_size=8)
    ty, taux = tm.moe_ffn(tp, torch.from_numpy(x), top_k=2, capacity_factor=0.75, group_size=8,
                          mesh=ParallelismConfig().build_mesh(1))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    rules = [(pat.pattern, tuple(spec)) for pat, spec in tm.moe_shard_rules().rules]
    assert rules == [(pat.pattern, tuple(spec)) for pat, spec in jm.moe_shard_rules().rules]
    # fp8 is ported (Queue A item 8), and with MoE layers it raises ValueError
    # in both packages' init
    with pytest.raises(ValueError, match="MoE"):
        jt.init_llama(dataclasses.replace(JCFG, dtype_recipe="fp8"), jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="MoE"):
        tt.init_llama(dataclasses.replace(TCFG, dtype_recipe="fp8"), **CPU)
    got = tm.init_moe_ffn(torch.Generator().manual_seed(0), D, F, E, **CPU)
    assert jax.tree_util.tree_map(np.shape, npp) == jax.tree_util.tree_map(
        lambda t: tuple(t.shape), got)
    assert abs(float(got["wo"]["kernel"].std()) - 1 / np.sqrt(F)) < 0.01
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_moe_ffn(None, D, F, E)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_llama(TCFG)
