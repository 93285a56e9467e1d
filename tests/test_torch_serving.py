"""The port's serving slice against the JAX package's, at ``LlamaConfig.tiny()``.

- ``paged_forward`` logits for one prefill chunk and then decode steps, on
  the same params, pool and block tables (f32 everywhere: the sides differ
  only in summation order, so logits are held at atol 1e-5 and the pools
  they wrote at atol 1e-5);
- the host-side ``BlockAllocator`` and ``Scheduler`` driven by one op
  script, which must give identical tables, reservations, preemptions and
  prefix hits, with prefix caching on and off, in static batching and
  under an admission watermark;
- the whole engine, greedy, f32 params and an f32 cache, through a shared
  prefix, a copy-on-write full match, preemption under a small pool and a
  prompt longer than the largest prefill bucket: the port's
  ``output_ids()`` must equal the JAX engine's exactly;
- a prompt whose last prefill chunk is padded past ``max_seq_len``: the
  same tokens as the JAX engine, and no pad write in another block;
- the engine's options against the JAX engine's: sampling (top-k and
  top-p, one request preempted), ``continuous=False`` on a seeded open-loop
  arrival script, ``admit_watermark_blocks``, ``prefix_cache=False`` and
  ``submit(generated=...)``, outputs token for token (the port's threefry
  streams draw JAX's bits, ``tests/test_torch_sampling.py``).
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
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


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


def _drive(pager, sched, script, prefix_caching=True, **sched_kw):
    """Run one op script on a (pager, scheduler) pair; returns a trace of
    every decision the two modules made."""
    alloc = pager.BlockAllocator(13, 4, prefix_caching=prefix_caching)
    s = sched.Scheduler(alloc, 3, max_seq_blocks=8, **sched_kw)
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
                               alloc.block_table(r.rid).tolist() if r.slot is not None else None,
                               alloc.tokens(r.rid) if r.slot is not None else None)
                           for n, r in reqs.items()},
                      {k: alloc.stats().get(k) for k in _ALLOC_KEYS},
                      alloc.can_allocate(9), s.queue_depth))
    return trace


def _script():
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
    return script


def test_allocator_and_scheduler_follow_the_same_script():
    script = _script()
    ours = _drive(tpager, tsched, script)
    ref = _drive(jpager, jsched, script)
    assert ours == ref
    final = ours[-1][2]
    assert final["prefix_hits"] >= 2 and final["cow_copies"] == 1
    assert any(p > 0 for _, (_, p, _, _) in ours[-1][1].items())  # someone was preempted


@pytest.mark.parametrize("opts", [
    dict(prefix_caching=False),
    dict(continuous=False),
    dict(admit_watermark_blocks=3),
    dict(prefix_caching=False, continuous=False, admit_watermark_blocks=2),
], ids=["no_prefix_cache", "static", "watermark", "all"])
def test_allocator_and_scheduler_options_follow_the_same_script(opts):
    """The same script with the reference's options: caching off (no
    hashing, no sharing, no prefix fields in the stats), gang admission
    into an idle scheduler only, and an admission watermark."""
    script = _script()
    ours = _drive(tpager, tsched, script, **opts)
    assert ours == _drive(jpager, jsched, script, **opts)
    if not opts.get("prefix_caching", True):
        assert all(t[2]["prefix_hits"] is None for t in ours if len(t) > 2)
    if not opts.get("continuous", True):
        # no admission while anything runs: the second admit finds a, b busy
        admits = [t[1] for t in ours if t[0] == "admit" and isinstance(t[1], list)]
        assert [n for n, *_ in admits[1]] == []


def test_scheduler_grows_by_several_tokens_and_gates_admission():
    """``grow(request, n)`` reserves n tokens at once (preempting if it must)
    and ``admission_gate`` holds the queue head and everything behind it,
    as in the reference."""
    for pager, sched in ((tpager, tsched), (jpager, jsched)):
        alloc = pager.BlockAllocator(6, 4)
        held = set()
        s = sched.Scheduler(alloc, 3, admission_gate=lambda r: r.rid not in held)
        a = s.submit(sched.Request(prompt=np.arange(4), max_new_tokens=8))
        b = s.submit(sched.Request(prompt=np.arange(4), max_new_tokens=8))
        held.add(b.rid)
        assert s.admissions() == [a] and s.queue_depth == 1
        s.grow(a, 7)
        assert alloc.tokens(a.rid) == 11 and alloc.num_seq_blocks(a.rid) == 3
        s.grow(a, 0)
        assert alloc.tokens(a.rid) == 11
        held.clear()
        assert s.admissions() == [b]
        s.grow(a, 9)  # 20 tokens = 5 blocks: b is evicted
        assert b.status is sched.RequestStatus.PREEMPTED and alloc.num_seq_blocks(a.rid) == 5


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


def test_engine_prefill_padded_past_max_seq_len_matches_jax_engine(params):
    """A 250-token prompt at max_seq_len 256 with prefill buckets up to 100:
    the chunks are 0-99, 100-199 and 200-249, the last padded to its bucket
    of 64, so its padded rows sit at positions up to 263. Both engines clamp
    the RoPE lookup of those rows and throw them away; their KV writes past
    the 16-block table go to the null block. The port must give the JAX
    engine's tokens and write no block but the request's own and the null
    block."""
    jp, tp = params
    prompt = np.random.default_rng(0).integers(1, VOCAB, 250)
    kw = dict(num_blocks=40, block_size=16, max_slots=2, max_prefill_len=100,
              max_blocks_per_seq=16)
    je = JEngine(jp, JCFG, cache_dtype=jnp.float32, **kw)
    te = TEngine(tp, TCFG, cache_dtype=torch.float32, device="cpu", **kw)
    jr, tr = je.submit(prompt, 4), te.submit(prompt, 4)
    je.run()
    te.run()
    assert te.stats()["prefill_chunks"] == 3
    assert tr.status is tsched.RequestStatus.FINISHED
    assert jr.generated == [396, 436, 308, 42]
    assert tr.generated == jr.generated
    written = (te.pool["k"].abs().amax(dim=(0, 2, 3, 4)) > 0).nonzero().flatten().tolist()
    assert written == list(range(17))  # the null block and the request's 16 blocks


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


def _engines(params, buckets, **kw):
    """A JAX engine and a port engine with the same options, f32 params and
    cache."""
    jp, tp = params
    je = JEngine(jp, JCFG, cache_dtype=jnp.float32, lattice=JLattice(**buckets), **kw)
    te = TEngine(tp, TCFG, cache_dtype=torch.float32, lattice=TLattice(**buckets),
                 device="cpu", **kw)
    return je, te


def _build_workload(n_requests, seed, prompt_lens, new_tokens, rate):
    """``benchmarks/serving/run.py``'s seeded open-loop arrival script:
    ``[(arrival_step, prompt, max_new)]`` with exponential gaps of mean
    ``1 / rate`` engine steps."""
    rng = np.random.default_rng(seed)
    t, workload = 0.0, []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        prompt = rng.integers(0, VOCAB, (int(rng.integers(*prompt_lens)),)).astype(np.int32)
        workload.append((int(t), prompt, int(rng.integers(*new_tokens))))
    return workload


def _open_loop(engine, workload):
    """Submit each request at its arrival step (``rng_seed`` = its index),
    step while work is live, idle-tick otherwise; returns the requests and
    the per-step list of running request indices."""
    reqs, trace, nxt, step = [], [], 0, 0
    while nxt < len(workload) or not engine.scheduler.idle():
        while nxt < len(workload) and workload[nxt][0] <= step:
            _, prompt, new = workload[nxt]
            reqs.append(engine.submit(prompt, new, rng_seed=nxt))
            nxt += 1
        step += 1
        if engine.scheduler.idle():
            continue
        engine.step()
        trace.append(sorted(reqs.index(r) for r in engine.scheduler.running()))
    return reqs, trace


def _same_outputs(jreqs, treqs):
    for a, b in zip(jreqs, treqs):
        assert b.status is tsched.RequestStatus.FINISHED
        np.testing.assert_array_equal(b.output_ids(), a.output_ids())
        assert b.preemptions == a.preemptions


@pytest.mark.parametrize("sample", [dict(temperature=0.8, top_k=20),
                                    dict(temperature=0.8, top_p=0.9)], ids=["top_k", "top_p"])
def test_sampled_engine_equals_jax_engine(params, sample):
    """Four sampled requests with distinct ``rng_seed``s through both
    engines; a 10-block pool preempts one, which resumes at its fold index.
    Tokens equal the JAX engine's one for one."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, VOCAB, n) for n in (11, 19, 7, 15)]
    buckets = dict(slot_buckets=(2, 4), block_buckets=(6,), prefill_buckets=(16,))
    je, te = _engines(params, buckets, num_blocks=10, block_size=8, max_slots=4, **sample)
    jr = [je.submit(p, 16, rng_seed=s) for p, s in zip(prompts, (3, 77, 2**31 - 1, 12345))]
    tr = [te.submit(p, 16, rng_seed=s) for p, s in zip(prompts, (3, 77, 2**31 - 1, 12345))]
    je.run()
    te.run()
    _same_outputs(jr, tr)
    assert te.stats()["preemptions"] == je.stats()["preemptions"] >= 1
    # a sampled run is not the greedy one: the draws did something
    greedy = TEngine(params[1], TCFG, cache_dtype=torch.float32, lattice=TLattice(**buckets),
                     device="cpu", num_blocks=10, block_size=8, max_slots=4)
    gr = [greedy.submit(p, 16) for p in prompts]
    greedy.run()
    assert any(g.generated != t.generated for g, t in zip(gr, tr))


def test_static_batching_equals_jax_engine(params):
    """``continuous=False`` on a seeded open-loop arrival script: gang
    admission into an idle engine only, no backfill. The same running set
    every step, the same step count and occupancy, the same tokens; and
    more steps than the continuous engine on the same script."""
    workload = _build_workload(10, 0, (4, 24), (2, 20), 2.0)
    buckets = dict(slot_buckets=(2, 4), block_buckets=(6,), prefill_buckets=(32,))
    kw = dict(num_blocks=33, block_size=8, max_slots=4)
    je, te = _engines(params, buckets, continuous=False, **kw)
    jreqs, jtrace = _open_loop(je, workload)
    treqs, ttrace = _open_loop(te, workload)
    _same_outputs(jreqs, treqs)
    assert ttrace == jtrace and te.steps == je.steps
    js, ts = je.stats(), te.stats()
    assert ts["mean_occupancy"] == js["mean_occupancy"]
    assert ts["max_running"] == js["max_running"]
    # a gang never takes a newcomer: each step's running set is a subset of
    # the step before it unless the engine was idle in between
    for before, after in zip(ttrace, ttrace[1:]):
        assert set(after) <= set(before) or not set(after) & set(before)
    _, cont = _engines(params, buckets, **kw)
    creqs, _ = _open_loop(cont, workload)
    _same_outputs(jreqs, creqs)  # greedy: the same tokens in either mode
    assert cont.steps < te.steps


def test_admission_watermark_holds_admission_like_jax(params):
    """``admit_watermark_blocks=4`` keeps 4 blocks free at admission: a
    request the pool could hold waits, exactly where the JAX engine's
    waits."""
    workload = _build_workload(8, 3, (8, 30), (4, 16), 3.0)
    buckets = dict(slot_buckets=(2, 4), block_buckets=(8,), prefill_buckets=(32,))
    kw = dict(num_blocks=17, block_size=8, max_slots=4)
    je, te = _engines(params, buckets, admit_watermark_blocks=4, **kw)
    jreqs, jtrace = _open_loop(je, workload)
    treqs, ttrace = _open_loop(te, workload)
    _same_outputs(jreqs, treqs)
    assert ttrace == jtrace
    _, free = _engines(params, buckets, **kw)
    _, free_trace = _open_loop(free, workload)
    assert free_trace != ttrace  # the watermark changed when requests ran


def test_prefix_cache_off_equals_jax_engine(params):
    """``prefix_cache=False``: a shared prefix and a whole-prompt repeat are
    prefilled again, never mapped — the JAX engine's tokens, no prefix-cached
    token, and no prefix-cache fields in the stats (as the reference)."""
    rng = np.random.default_rng(2)
    shared = rng.integers(0, VOCAB, 16)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, 5)]), shared.copy(),
               np.concatenate([shared, rng.integers(0, VOCAB, 9)])]
    buckets = dict(slot_buckets=(2, 4), block_buckets=(8,), prefill_buckets=(16,))
    je, te = _engines(params, buckets, num_blocks=16, block_size=8, max_slots=4,
                      prefix_cache=False)
    jr = [je.submit(p, 10) for p in prompts]
    tr = [te.submit(p, 10) for p in prompts]
    je.run()
    te.run()
    _same_outputs(jr, tr)
    ts = te.stats()
    assert ts["prefix_cached_tokens"] == 0
    assert ts["prefill_tokens"] == je.stats()["prefill_tokens"] == sum(p.size for p in prompts)
    assert "prefix_hits" not in ts and "cached_blocks" not in ts


@pytest.mark.parametrize("sample", [{}, dict(temperature=1.1, top_k=50, top_p=0.95)],
                         ids=["greedy", "sampled"])
def test_resume_from_generated_continues_the_unbroken_run(params, sample):
    """A request resumed with ``generated=`` tokens another engine produced
    prefills ``prompt + generated`` and continues at fold index
    ``len(generated)``: bitwise the unbroken run, and the JAX engine's
    resume. ``len(generated) >= max_new_tokens`` raises on both sides."""
    prompt = np.random.default_rng(6).integers(0, VOCAB, 13)
    buckets = dict(slot_buckets=(2,), block_buckets=(6,), prefill_buckets=(32,))
    kw = dict(num_blocks=12, block_size=8, max_slots=2, **sample)
    je, te = _engines(params, buckets, **kw)
    full = te.submit(prompt, 12, rng_seed=5)
    te.run()
    head = full.generated[:5]
    je2, te2 = _engines(params, buckets, **kw)
    jres = je2.submit(prompt, 12, rng_seed=5, generated=head)
    tres = te2.submit(prompt, 12, rng_seed=5, generated=head)
    je2.run()
    te2.run()
    assert tres.generated == full.generated
    assert tres.generated == jres.generated
    assert te2.stats()["resume_prefill_tokens"] == je2.stats()["resume_prefill_tokens"] == 18
    for engine in (je, te):
        with pytest.raises(ValueError, match="nothing left to decode"):
            engine.submit(prompt, 5, generated=[1, 2, 3, 4, 5])


@pytest.mark.parametrize("spec", [{}, dict(spec_tokens=3, draft_layers=1)], ids=["plain", "spec"])
@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix_on", "prefix_off"])
def test_stats_carry_every_jax_key_with_its_value(params, prefix_cache, spec):
    """The whole ``stats()`` dict against the JAX engine's: every JAX key
    but the ``*_compiles`` counts of its compile cache is in the port's,
    with an equal value, after the first step and at the end. Three greedy
    prompts share their first 16 tokens (two full blocks of 8), 6 new
    tokens each; with the prefix cache on, JAX counts 3 prefill calls, 32
    tokens saved, a hit rate of 0.561404 and no fragmentation."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, VOCAB, 16)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, n)]).astype(np.int32)
               for n in (2, 3, 4)]
    buckets = dict(slot_buckets=(2, 4), block_buckets=(4,), prefill_buckets=(32,))
    je, te = _engines(params, buckets, num_blocks=33, block_size=8, max_slots=4,
                      prefix_cache=prefix_cache, **spec)
    jr = [je.submit(p, 6) for p in prompts]
    tr = [te.submit(p, 6) for p in prompts]

    def same_stats():
        want, got = je.stats(), te.stats()
        keys = [k for k in want if not k.endswith("_compiles")]
        assert [k for k in keys if k not in got] == []
        assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
        return want

    je.step()
    te.step()
    same_stats()
    je.run()
    te.run()
    _same_outputs(jr, tr)
    final = same_stats()
    assert te.allocator.live_sequences() == je.allocator.live_sequences() == []
    assert final["prefill_calls"] == 3 and final["fragmentation"] == 0.0
    if prefix_cache:
        assert (final["prefill_tokens_saved"], final["prefix_hit_rate"]) == (32, 0.561404)
