"""Disaggregated prefill/decode of the port on the CPU, held to the JAX
package and to the port's own monolith, at ``LlamaConfig.tiny()`` with the
JAX package's weights (``params_from_numpy``), f32 params and cache:

- the reference is the JAX package's monolithic ``ServingEngine`` over the
  same weights, prompts, budgets and ``rng_seed``s (the JAX package's own
  tests hold its greedy streams to ``greedy_generate``);
- one prefill engine's handoff, captured from the port's pool, verifies
  under JAX's ``KVHandoff.verify_wire`` and lands in the port's
  ``DecodeEngine``, whose output equals the JAX engine's; the decode
  engine gates the request until the landing and maps the landed blocks;
  a handoff that can never land is dropped and the request re-prefilled,
  with the same tokens; re-delivery dedups by hash;
- a ``DisaggRouter`` (1 prefill + 2 decode ``LocalReplica``s), greedy, and
  (1 + 1) sampled at temperature 0.8, top-k 4: every stream equals the JAX
  engine's;
- a decode replica killed after the first completion fails its requests
  over across the handoff, with the same outputs;
- a transport whose first wire is damaged in transit (``corrupt_wire``):
  the router counts it, re-runs the prefill and finishes with the same
  outputs;
- a planted fault (the decode side lands the first handed-off block's
  content in every adopted place) must fail the output bar.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import transformer as jt
from accelerate_tpu.serving import BucketLattice as JLattice
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.serving.disagg import KVHandoff as JHandoff
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import (
    BlockPoolExhausted,
    BucketLattice,
    DecodeEngine,
    DisaggRouter,
    KVHandoff,
    LocalReplica,
    PrefillEngine,
    ReplicaSpec,
    RouterRequestStatus,
)
from accelerate_tpu_torch.serving import disagg as tdisagg

MODEL = dataclasses.asdict(tt.LlamaConfig.tiny())
SPEC_KW = dict(model=MODEL, num_blocks=33, block_size=8, max_slots=2, slot_buckets=(2,),
               block_buckets=(4,), prefill_buckets=(32,), device="cpu",
               param_dtype="float32", cache_dtype="float32")
ENGINE_KW = dict(num_blocks=33, block_size=8, max_slots=2, device="cpu",
                 cache_dtype=torch.float32)
SAMPLE = dict(temperature=0.8, top_k=4)
# three lengths (one and two full blocks of 8 with tails, and a sub-block
# prompt), each twice: one batched JAX call a length
LENGTHS = (20, 11, 4, 20, 11, 4)
NEW = (6, 3, 7, 2, 5, 4)
_NUMPY: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops, restored after
    it: the suite runs several test workers on one machine, and a worker
    whose every op spreads over all the cores slows the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_numpy_params() -> dict:
    if not _NUMPY:
        jp = jt.init_llama(jt.LlamaConfig(**MODEL), jax.random.PRNGKey(0))
        _NUMPY.update(jax.tree_util.tree_map(np.asarray, jp))
    return _NUMPY


class JaxInitSpec(ReplicaSpec):
    """The JAX package's ``init_llama(PRNGKey(0))`` weights on the CPU."""

    def build_params(self):
        return params_from_numpy(_jax_numpy_params(), device="cpu",
                                 dtype=getattr(torch, self.param_dtype))


SPEC = JaxInitSpec(**SPEC_KW)


def _prompts(seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], (n,)).astype(np.int32) for n in LENGTHS]


def _jax_engine_outputs(**sample) -> list:
    """The JAX package's monolithic ``ServingEngine`` (f32 params and cache,
    the fleet's lattice and pool) over every prompt at its budget,
    ``rng_seed`` = its index as the router submits it."""
    params = jax.tree_util.tree_map(jnp.asarray, _jax_numpy_params())
    eng = JEngine(params, jt.LlamaConfig(**MODEL), cache_dtype=jnp.float32,
                  lattice=JLattice(slot_buckets=(2,), block_buckets=(4,), prefill_buckets=(32,)),
                  **{k: v for k, v in ENGINE_KW.items() if k not in ("device", "cache_dtype")},
                  **sample)
    reqs = [eng.submit(p, n, rng_seed=i) for i, (p, n) in enumerate(zip(_prompts(), NEW))]
    eng.run()
    return [np.asarray(r.output_ids()) for r in reqs]


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX engine's greedy outputs."""
    return _jax_engine_outputs()


def _lattice():
    return BucketLattice(slot_buckets=(2,), block_buckets=(4,), prefill_buckets=(32,))


def _pack_one(prompt, max_new):
    eng = PrefillEngine(SPEC.build_params(), SPEC.config(), lattice=_lattice(), **ENGINE_KW)
    eng.warmup()
    req = eng.submit(prompt, max_new)
    eng.step()
    ((got, wire),) = eng.pop_handoffs()
    assert got is req and eng.handoffs_packed == 1
    return wire


def test_handoff_lands_and_decodes_like_jax(jax_refs):
    prompt, new = _prompts()[0], NEW[0]
    wire = _pack_one(prompt, new)
    ho, problems = JHandoff.verify_wire(wire, prompt=prompt)  # JAX reads the port's wire
    assert problems == [] and ho.n_blocks == 2
    dec = DecodeEngine(SPEC.build_params(), SPEC.config(), lattice=_lattice(), **ENGINE_KW)
    dec.warmup()
    req = dec.submit(prompt, new, generated=[int(wire["first_token"])], handoff=wire)
    assert req.rid in dec._awaiting  # gated until the blocks land
    dec.run()
    assert dec.handoffs_landed == 1 and dec.handoff_blocks == 2 and not dec._awaiting
    assert req.cached_tokens >= 8  # the landed blocks were mapped, not re-prefilled
    assert np.array_equal(req.output_ids(), jax_refs[0])
    # re-delivery dedups on the content hash
    again = dec.transport.deliver(KVHandoff.from_wire(wire), dec)
    assert again == {"landed": 0, "dedup": 2}

    class NeverLands(tdisagg.KVTransport):
        def deliver(self, handoff, engine):
            raise BlockPoolExhausted("no room, ever")

    dec2 = DecodeEngine(SPEC.build_params(), SPEC.config(), lattice=_lattice(),
                        transport=NeverLands(), **ENGINE_KW)
    req2 = dec2.submit(prompt, new, generated=[int(wire["first_token"])], handoff=wire)
    dec2.run()
    assert dec2.handoffs_landed == 0 and not dec2._awaiting  # dropped, not wedged
    assert np.array_equal(req2.output_ids(), jax_refs[0])


def _drain(router, prompts, kill_when=None, timeout_s=120.0):
    router.wait_ready(timeout_s=timeout_s)
    reqs = [router.submit(p, n, rng_seed=i) for i, (p, n) in enumerate(zip(prompts, NEW))]
    killed = False
    deadline = time.monotonic() + timeout_s
    while not all(r.status.terminal for r in reqs):
        router.poll()
        if kill_when is not None and not killed and kill_when(reqs):
            router.replicas["d0"].kill()
            killed = True
        assert time.monotonic() < deadline, "fleet wedged"
        time.sleep(0.001)
    return reqs, killed


def _disagg(spec, n_decode=1, **kw):
    return DisaggRouter([LocalReplica("p0", dataclasses.replace(spec, role="prefill"))],
                        [LocalReplica(f"d{i}", dataclasses.replace(spec, role="decode"))
                         for i in range(n_decode)], **kw)


def _run_disagg(spec, n_decode=2, kill_when=None, **kw):
    router = _disagg(spec, n_decode=n_decode, health_timeout_s=10.0, **kw)
    try:
        reqs, killed = _drain(router, _prompts(), kill_when=kill_when)
    finally:
        router.close()
    return router, reqs, killed


def _same_as(reqs, refs):
    return [bool(np.array_equal(r.output_ids(), ref)) for r, ref in zip(reqs, refs)]


def test_disagg_greedy_equals_jax(jax_refs):
    router, reqs, _ = _run_disagg(SPEC)
    assert all(r.status is RouterRequestStatus.FINISHED for r in reqs), [r.error for r in reqs]
    assert _same_as(reqs, jax_refs) == [True] * len(reqs)
    stats = router.stats()
    assert stats["handoffs"] == len(reqs) and stats["handoff_corrupt"] == 0
    assert stats["completed"] == len(reqs) and stats["tiers"] == {"prefill": ["p0"],
                                                                  "decode": ["d0", "d1"]}


def test_disagg_sampled_equals_the_monolith(jax_refs):
    """Sampled streams of the 1 + 1 fleet equal the JAX monolithic engine's
    on the same ``rng_seed``s (and are not the greedy streams)."""
    want = _jax_engine_outputs(**SAMPLE)
    _, got, _ = _run_disagg(dataclasses.replace(SPEC, **SAMPLE), n_decode=1)
    assert all(r.status is RouterRequestStatus.FINISHED for r in got), [r.error for r in got]
    assert _same_as(got, want) == [True] * len(got)
    assert not all(_same_as(got, jax_refs))


def test_disagg_decode_death_fails_over_across_the_handoff(jax_refs):
    def first_done(reqs):
        return any(r.status is RouterRequestStatus.FINISHED for r in reqs)

    router, reqs, killed = _run_disagg(SPEC, kill_when=first_done)
    assert killed and router.replicas["d0"].state.value == "dead"
    assert _same_as(reqs, jax_refs) == [True] * len(reqs)
    assert router.completed == len(reqs)


class _CorruptFirst(tdisagg.LocalBlockCopyTransport):
    """Damages the first wire it packs, after its CRC was computed."""

    packed = 0

    def pack(self, engine, req):
        wire = super().pack(engine, req)
        type(self).packed += 1
        return tdisagg.corrupt_wire(wire) if type(self).packed == 1 else wire


def test_disagg_corrupt_handoff_is_caught_and_rerun(jax_refs, monkeypatch):
    monkeypatch.setattr(tdisagg, "LocalBlockCopyTransport", _CorruptFirst)
    router, reqs, _ = _run_disagg(SPEC)
    assert _CorruptFirst.packed > len(reqs)  # the damaged one was packed again
    assert router.handoff_corrupt == 1 and router.handoffs == len(reqs)
    assert _same_as(reqs, jax_refs) == [True] * len(reqs)


def test_disagg_planted_fault_fails_the_bar(jax_refs, monkeypatch):
    """Planted: the decode side lands the first handed-off block's content
    in every adopted place (swapping whole blocks would not show: attention
    over a set of keys is blind to their order)."""
    real = DecodeEngine.land_blocks

    def land_blocks(self, blocks, k, v):
        first = [0] * len(blocks)
        real(self, blocks, k[first], v[first])

    monkeypatch.setattr(DecodeEngine, "land_blocks", land_blocks)
    _, reqs, _ = _run_disagg(SPEC)
    assert not all(_same_as(reqs, jax_refs))
