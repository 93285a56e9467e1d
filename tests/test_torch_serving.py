"""The port's serving slice against the JAX package's, at ``LlamaConfig.tiny()``.

- ``paged_forward`` logits for one prefill chunk and then decode steps, on
  the same params, pool and block tables (f32 everywhere: the sides differ
  only in summation order, so logits are held at atol 1e-5 and the pools
  they wrote at atol 1e-5);
- the host-side ``BlockAllocator`` and ``Scheduler`` driven by one op
  script, which must give identical tables, preemptions and prefix hits;
- the whole engine, greedy, f32 params and an f32 cache, through a shared
  prefix, a copy-on-write full match, preemption under a small pool and a
  prompt longer than the largest prefill bucket: the port's
  ``output_ids()`` must equal the JAX engine's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import transformer as jt
from accelerate_tpu.serving import BucketLattice as JLattice
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu.serving import engine as jengine
from accelerate_tpu.serving import kv_pager as jpager
from accelerate_tpu.serving import scheduler as jsched
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import BucketLattice as TLattice
from accelerate_tpu_torch.serving import ServingEngine as TEngine
from accelerate_tpu_torch.serving import engine as tengine
from accelerate_tpu_torch.serving import kv_pager as tpager
from accelerate_tpu_torch.serving import scheduler as tsched

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
VOCAB = JCFG.vocab_size


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def test_paged_forward_prefill_then_decode(params):
    jp, tp = params
    bs, nb, W = 8, 16, 6
    rng = np.random.default_rng(0)
    tables = np.full((2, W), tpager.NULL_BLOCK, np.int32)
    tables[0, :5] = rng.permutation(np.arange(1, nb))[:5]
    tables[1, :3] = tables[0, :3]  # row 1 aliases row 0's leading blocks
    tables[1, 3:5] = [b for b in range(1, nb) if b not in tables[0]][:2]
    jpool = jpager.init_block_pool(JCFG, nb, bs, jnp.float32)
    tpool = tpager.init_block_pool(TCFG, nb, bs, torch.float32, "cpu")

    # one prefill chunk of 20 tokens for row 0 (through the S>1 path)
    ids = rng.integers(0, VOCAB, (1, 20)).astype(np.int32)
    pos = np.arange(20, dtype=np.int32)[None]
    jl, jpool = jengine.paged_forward(jp, jnp.asarray(ids), jpool, jnp.asarray(tables[:1]),
                                      jnp.asarray(pos), JCFG, bs)
    tl, tpool = tengine.paged_forward(tp, torch.from_numpy(ids).long(), tpool,
                                      torch.from_numpy(tables[:1]), torch.from_numpy(pos).long(),
                                      TCFG, bs)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # then batched decode steps for both rows at ragged positions
    for step in range(4):
        last = rng.integers(0, VOCAB, (2, 1)).astype(np.int32)
        pos = np.array([[20 + step], [30 + step]], np.int32)
        jl, jpool = jengine.paged_forward(jp, jnp.asarray(last), jpool, jnp.asarray(tables),
                                          jnp.asarray(pos), JCFG, bs)
        tl, tpool = tengine.paged_forward(tp, torch.from_numpy(last).long(), tpool,
                                          torch.from_numpy(tables), torch.from_numpy(pos).long(),
                                          TCFG, bs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy(), np.asarray(jpool[name]), atol=1e-5)


_ALLOC_KEYS = ("free_blocks", "used_blocks", "live_tokens", "cached_blocks",
               "reclaimable_blocks", "shared_blocks", "prefix_hits", "prefix_hit_tokens",
               "cow_copies", "reclaimed_blocks")


def _drive(pager, sched, script):
    """Run one op script on a (pager, scheduler) pair; returns a trace of
    every decision the two modules made."""
    alloc = (pager.BlockAllocator(13, 4) if pager is tpager
             else pager.BlockAllocator(13, 4, prefix_caching=True))
    s = sched.Scheduler(alloc, 3, max_seq_blocks=8)
    reqs, trace = {}, []
    for op, *args in script:
        if op == "submit":
            name, prompt, new = args
            reqs[name] = s.submit(sched.Request(prompt=prompt, max_new_tokens=new))
        elif op == "admit":
            admitted = s.admissions()
            trace.append(("admit", [(n, r.cached_tokens, r.cow_block) for n, r in reqs.items()
                                    if r in admitted]))
            for r in admitted:
                if r.cow_block is not None:
                    alloc.cow_done(r.cow_block[0])
                    r.cow_block = None
        elif op == "grow":
            for r in list(s.running()):
                if r.slot is not None:
                    s.grow(r)
                    r.generated.append(7)
                    alloc.register_full_blocks(r.rid, r.output_ids()[:-1])
        elif op == "complete":
            s.complete(reqs[args[0]], 0.0)
        trace.append((op, {n: (r.status.value, r.preemptions,
                               alloc.block_table(r.rid).tolist() if r.slot is not None else None)
                           for n, r in reqs.items()},
                      {k: alloc.stats()[k] for k in _ALLOC_KEYS}))
    return trace


def test_allocator_and_scheduler_follow_the_same_script():
    rng = np.random.default_rng(1)
    shared = rng.integers(0, VOCAB, 8)
    script = [
        ("submit", "a", np.concatenate([shared, rng.integers(0, VOCAB, 3)]), 6),
        ("submit", "b", np.concatenate([shared, rng.integers(0, VOCAB, 5)]), 6),
        ("admit",),
        ("submit", "c", rng.integers(0, VOCAB, 9), 6),
        ("submit", "d", shared.copy(), 4),  # whole prefix cached: copy-on-write
        ("admit",),
        *[("grow",)] * 6,
        ("complete", "a"),
        ("admit",),
        *[("grow",)] * 3,
    ]
    ours = _drive(tpager, tsched, script)
    ref = _drive(jpager, jsched, script)
    assert ours == ref
    final = ours[-1][2]
    assert final["prefix_hits"] >= 2 and final["cow_copies"] == 1
    assert any(p > 0 for _, (_, p, _) in ours[-1][1].items())  # someone was preempted


def test_bucket_lattice_matches():
    for limits in [(8, 32, 256), (3, 5, 100), (1, 1, 8)]:
        j = JLattice.from_limits(*limits)
        t = TLattice.from_limits(*limits)
        assert (j.slot_buckets, j.block_buckets, j.prefill_buckets) == \
               (t.slot_buckets, t.block_buckets, t.prefill_buckets)
        assert t.prefill_bucket(limits[2]) == limits[2]
    with pytest.raises(ValueError):
        TLattice.from_limits(2, 2, 16).prefill_bucket(17)


def test_engine_greedy_outputs_equal_jax_engine(params):
    """Same greedy requests through both engines: a shared prefix, a
    copy-on-write full match, preemption under a 15-block pool, and a
    40-token prompt that prefills in three 16-token-bucket chunks."""
    jp, tp = params
    rng = np.random.default_rng(2)
    shared = rng.integers(0, VOCAB, 16)
    prompts = [
        np.concatenate([shared, rng.integers(0, VOCAB, 5)]),
        np.concatenate([shared, rng.integers(0, VOCAB, 9)]),
        rng.integers(0, VOCAB, 40),
        shared.copy(),
        rng.integers(0, VOCAB, 12),
    ]
    kw = dict(num_blocks=16, block_size=8, max_slots=4)
    buckets = dict(slot_buckets=(2, 4), block_buckets=(8,), prefill_buckets=(16,))
    je = JEngine(jp, JCFG, cache_dtype=jnp.float32, lattice=JLattice(**buckets), **kw)
    te = TEngine(tp, TCFG, cache_dtype=torch.float32, lattice=TLattice(**buckets),
                 device="cpu", **kw)
    jr = [je.submit(p, 14) for p in prompts]
    tr = [te.submit(p, 14) for p in prompts]
    je.run()
    te.run()
    for a, b in zip(jr, tr):
        assert b.status is tsched.RequestStatus.FINISHED
        np.testing.assert_array_equal(b.output_ids(), a.output_ids())
        assert a.preemptions == b.preemptions
    js, ts = je.stats(), te.stats()
    assert ts["preemptions"] == js["preemptions"] >= 1
    assert ts["cow_copies"] == js["cow_copies"] >= 1
    assert ts["prefix_hit_tokens"] == js["prefix_hit_tokens"] > 0
    assert ts["prefill_tokens"] == js["prefill_tokens"]
    assert ts["decode_tokens"] == js["decode_tokens"]


def test_engine_rejects_impossible_requests():
    tp = tt.init_llama(TCFG, torch.Generator().manual_seed(0), device="cpu")
    te = TEngine(tp, TCFG, num_blocks=8, block_size=8, max_slots=2, max_blocks_per_seq=4,
                 max_prefill_len=32, cache_dtype=torch.float32, device="cpu")
    too_long = te.submit(np.arange(30), 8)  # 38 tokens > 4 blocks x 8
    ok = te.submit(np.arange(10), 3)
    done = te.run()
    assert too_long.status is tsched.RequestStatus.REJECTED and "per-sequence cap" in too_long.error
    assert ok.status is tsched.RequestStatus.FINISHED and len(ok.generated) == 3
    assert set(map(id, done)) == {id(too_long), id(ok)}


def test_engine_stops_at_eos(params):
    """A request ends at its eos token (the third token a free run makes),
    frees its slot, and the one queued behind it is admitted."""
    _, tp = params
    prompt = np.arange(5, 25)
    kw = dict(num_blocks=8, block_size=8, max_slots=1, cache_dtype=torch.float32, device="cpu")
    free = TEngine(tp, TCFG, **kw)
    free_req = free.submit(prompt, 6)
    free.run()
    eos = free_req.generated[2]
    stop = free_req.generated.index(eos) + 1
    te = TEngine(tp, TCFG, **kw)
    first = te.submit(prompt, 6, eos_token_id=eos)
    second = te.submit(prompt[::-1].copy(), 2)
    te.run()
    assert first.generated == free_req.generated[:stop]
    assert second.status is tsched.RequestStatus.FINISHED and len(second.generated) == 2
