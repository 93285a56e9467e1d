"""Speculative decoding in the port's engine against the JAX engine's, as
``tests/test_spec_decode.py`` holds the JAX one, at ``LlamaConfig.tiny()``
with f32 params and an f32 cache.

Bitwise accept makes the comparison exact: the verify step selects, per
(row, column), the token the non-speculative stream would emit at that
fold index, so speculation may change how many steps a run takes and never
which tokens come out. On the CPU in f32 the S=k+1 verify forward and the
S=1 decode forward give the same argmax (the JAX suite relies on the same),
so every stream here is compared token for token: against the port's
non-speculative engine and against the JAX speculative engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import transformer as jt
from accelerate_tpu.serving import BucketLattice as JLattice
from accelerate_tpu.serving import ServingEngine as JEngine
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.serving import BucketLattice as TLattice
from accelerate_tpu_torch.serving import RequestStatus
from accelerate_tpu_torch.serving import ServingEngine as TEngine

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
VOCAB = JCFG.vocab_size
BUCKETS = dict(slot_buckets=(2, 4), block_buckets=(4,), prefill_buckets=(32,))
ENGINE_KW = dict(num_blocks=33, block_size=8, max_slots=4)


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _torch_engine(tp, **kw):
    kw = {**ENGINE_KW, **kw}
    return TEngine(tp, TCFG, cache_dtype=torch.float32, lattice=TLattice(**BUCKETS),
                   device="cpu", **kw)


def _jax_engine(jp, **kw):
    kw = {**ENGINE_KW, **kw}
    return JEngine(jp, JCFG, cache_dtype=jnp.float32, lattice=JLattice(**BUCKETS), **kw)


def _prompts(seed, specs):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (s,)).astype(np.int32) for s, _ in specs]


def _drive(engine, prompts, specs, seeds=None):
    reqs = [engine.submit(p, n, rng_seed=(seeds[i] if seeds else i))
            for i, (p, (_, n)) in enumerate(zip(prompts, specs))]
    engine.run()
    for r in reqs:  # a port or a JAX request: compare the enums' values
        assert r.status.value == RequestStatus.FINISHED.value
    return [r.output_ids() for r in reqs]


def _assert_same(outs_a, outs_b, what):
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}: {what}")


def test_greedy_spec_decode_equals_plain_and_jax(params):
    """Greedy ``spec_tokens=3, draft_layers=1``: the port's output equals
    its non-speculative engine's and the JAX speculative engine's, in fewer
    steps than the non-speculative run."""
    jp, tp = params
    specs = [(5, 7), (13, 11), (21, 5), (9, 9)]
    prompts = _prompts(7, specs)
    base = _torch_engine(tp)
    out_base = _drive(base, prompts, specs)
    spec = _torch_engine(tp, spec_tokens=3, draft_layers=1)
    out_spec = _drive(spec, prompts, specs)
    jspec = _jax_engine(jp, spec_tokens=3, draft_layers=1)
    out_jax = _drive(jspec, prompts, specs)
    _assert_same(out_spec, out_base, "speculative vs plain")
    _assert_same(out_spec, out_jax, "port vs JAX speculative")
    st = spec.stats()
    assert st["draft_proposed_tokens"] > 0 and st["draft_accepted_tokens"] > 0
    assert spec.steps < base.steps
    assert spec.steps == jspec.steps


def test_sampled_spec_decode_equals_plain_and_jax(params):
    """Sampled ``temperature=0.8, top_k=20``, ``spec_tokens=2`` with seeds
    11-13: the verify step folds each column's key at its own index, so the
    stream is the non-speculative one, and the JAX engine's."""
    jp, tp = params
    specs = [(7, 8), (15, 6), (4, 10)]
    prompts = _prompts(10, specs)
    sample = dict(temperature=0.8, top_k=20)
    seeds = [11, 12, 13]
    out_base = _drive(_torch_engine(tp, **sample), prompts, specs, seeds)
    out_spec = _drive(_torch_engine(tp, spec_tokens=2, draft_layers=1, **sample), prompts,
                      specs, seeds)
    out_jax = _drive(_jax_engine(jp, spec_tokens=2, draft_layers=1, **sample), prompts,
                     specs, seeds)
    _assert_same(out_spec, out_base, "sampled speculative vs plain")
    _assert_same(out_spec, out_jax, "sampled port vs JAX speculative")


def test_full_depth_draft_accepts_everything(params):
    """``draft_layers == n_layers``: the draft is the verifier, so every
    proposal is accepted — pool sharing, positions and fold indices line
    up."""
    _, tp = params
    eng = _torch_engine(tp, spec_tokens=2, draft_layers=TCFG.n_layers)
    _drive(eng, _prompts(11, [(6, 8)]), [(6, 8)])
    st = eng.stats()
    assert st["draft_proposed_tokens"] > 0
    assert st["spec_accept_rate"] == 1.0


def test_spec_accept_accounting_equals_jax(params):
    """proposed = accepted + rejected; the histogram weight-sums to the
    accepted count; every counter equals the JAX engine's on the same
    workload."""
    jp, tp = params
    k = 3
    specs = [(8, 9), (14, 12)]
    prompts = _prompts(13, specs)
    eng = _torch_engine(tp, spec_tokens=k, draft_layers=1)
    jeng = _jax_engine(jp, spec_tokens=k, draft_layers=1)
    _assert_same(_drive(eng, prompts, specs), _drive(jeng, prompts, specs), "port vs JAX")
    st, js = eng.stats(), jeng.stats()
    assert st["spec_tokens"] == k and st["draft_layers"] == 1
    assert st["draft_proposed_tokens"] == st["draft_accepted_tokens"] + st["draft_rejected_tokens"]
    hist = st["spec_accept_hist"]
    assert len(hist) == k + 1
    assert sum(i * c for i, c in enumerate(hist)) == st["draft_accepted_tokens"]
    for key in ("draft_proposed_tokens", "draft_accepted_tokens", "draft_rejected_tokens",
                "spec_accept_rate", "spec_accept_hist", "decode_tokens", "steps"):
        assert st[key] == js[key], key
    # each step ran k draft forwards and one verify, and no plain decode
    assert st["draft_steps"] == k * st["verify_steps"] and st["decode_steps"] == 0


def test_spec_config_validation(params):
    jp, tp = params
    for make in (lambda **kw: _torch_engine(tp, **kw), lambda **kw: _jax_engine(jp, **kw)):
        with pytest.raises(ValueError, match="spec_tokens must be >= 0"):
            make(spec_tokens=-1)
        with pytest.raises(ValueError, match="requires draft_layers"):
            make(spec_tokens=2)
        with pytest.raises(ValueError, match=f"draft_layers must be in 1..{TCFG.n_layers}"):
            make(spec_tokens=2, draft_layers=TCFG.n_layers + 1)


def test_draft_params_and_config_truncate_layers(params):
    jp, tp = params
    d_cfg = tt.draft_config(TCFG, 1)
    assert d_cfg.n_layers == 1 and TCFG.n_layers > 1
    assert d_cfg == tt.LlamaConfig(**{**TCFG.__dict__, "n_layers": 1})
    dp = tt.draft_params(tp, 1)
    jdp = jt.draft_params(jp, 1)
    for name, entry in tp["layers"].items():
        for key, full in entry.items():
            leaf = dp["layers"][name][key]
            assert leaf.shape[0] == 1
            assert leaf.data_ptr() == full.data_ptr()  # a view, not a copy
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jdp["layers"][name][key]))
    for name in ("embed_tokens", "final_norm", "lm_head"):
        assert dp[name] is tp[name]  # shared, not copied
    for n in (0, TCFG.n_layers + 1):
        with pytest.raises(ValueError) as ours:
            tt.draft_config(TCFG, n)
        with pytest.raises(ValueError) as theirs:
            jt.draft_config(JCFG, n)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("sample", [{}, dict(temperature=0.8, top_p=0.9)], ids=["greedy", "top_p"])
def test_spec_decode_under_pool_pressure_equals_jax(params, sample):
    """A 12-block pool forces preemption mid-speculation (a grow by up to
    k+1 evicts the youngest); the resumed requests re-prefill and go on.
    Outputs, preemptions and steps equal the JAX engine's, and the outputs
    equal the non-speculative engine's."""
    jp, tp = params
    specs = [(14, 12), (9, 14), (17, 10), (6, 13)]
    prompts = _prompts(21, specs)
    kw = dict(num_blocks=12, spec_tokens=3, draft_layers=1, **sample)
    eng = _torch_engine(tp, **kw)
    jeng = _jax_engine(jp, **kw)
    out = _drive(eng, prompts, specs)
    _assert_same(out, _drive(jeng, prompts, specs), "port vs JAX under pool pressure")
    _assert_same(out, _drive(_torch_engine(tp, **sample), prompts, specs),
                 "speculative vs plain under pool pressure")
    st, js = eng.stats(), jeng.stats()
    assert st["preemptions"] == js["preemptions"] >= 1
    assert eng.steps == jeng.steps
    assert st["draft_accepted_tokens"] == js["draft_accepted_tokens"]


def test_spec_decode_registers_blocks_a_multi_token_accept_fills(params):
    """A full-depth draft accepts k+1 tokens a step, crossing block
    boundaries inside a step: the blocks it fills are registered, so a
    later request with that prefix maps them (as many prefix-hit tokens as
    the JAX engine)."""
    jp, tp = params
    prompt = _prompts(5, [(6, 0)])[0]
    runs = []
    for make in (lambda: _torch_engine(tp, spec_tokens=3, draft_layers=TCFG.n_layers),
                 lambda: _jax_engine(jp, spec_tokens=3, draft_layers=TCFG.n_layers)):
        eng = make()
        first = eng.submit(prompt, 20)
        eng.run()
        assert first.status.value == RequestStatus.FINISHED.value
        second = eng.submit(first.output_ids()[:24], 4)
        eng.run()
        runs.append((first.output_ids(), second.output_ids(), eng.stats()["prefix_hit_tokens"]))
    (a1, a2, hits), (b1, b2, jhits) = runs
    np.testing.assert_array_equal(a1, b1)
    np.testing.assert_array_equal(a2, b2)
    assert hits == jhits >= 16


def test_spec_and_sampled_engines_refuse_to_run_without_a_gpu(params, monkeypatch):
    """No ``device``: the engine resolves to CUDA and raises without one,
    whatever its options — it never drops to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in (dict(spec_tokens=2, draft_layers=1), dict(temperature=0.7, top_p=0.9)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEngine(params[1], TCFG, **kw)
