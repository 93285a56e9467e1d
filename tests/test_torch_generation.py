"""KV-cache generation of the port against ``accelerate_tpu.generation`` on
the CPU, at ``LlamaConfig.tiny()`` (2 layers, dim 128, 4 heads over 2 kv
heads, vocab 512) with params from the JAX ``init_llama(PRNGKey(0))``
crossed through ``models.convert.params_from_numpy``, f32 params and cache.

- greedy tokens equal JAX's, with and without an ``eos_token_id`` that
  appears mid-stream;
- sampled tokens equal JAX's from the same key at two knob settings; a
  parted token is allowed only at a named near-tie (the ROADMAP parity
  rule: the two largest perturbed logits within 1e-5, or a cumulative mass
  within 1e-6 of top_p), and the rows must agree before it;
- the one-key ``(B, V)`` draw of a generation step: bits and uniforms
  bitwise equal to ``jax.random``'s, the Gumbel noise within the bar of
  ``tests/test_torch_sampling.py`` (each ``log`` within an ulp of XLA's);
- beam search at 1/2/4 beams, with and without eos, at length penalty 0.5
  and 1.0: tokens equal, scores within 1e-5 relative (f32 sums in another
  order);
- ``generate_dispatched`` over CPU offload, disk offload and a mixed map
  equals JAX's ``generate_dispatched`` over the same map and the port's
  own ``greedy_generate``, including an early exit at eos;
- ``return_stats`` has JAX's keys; ``mesh=`` of one device gives the plain
  path's tokens; an MoE config generates JAX's greedy tokens (more in ``tests/test_torch_moe.py``).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu import generation as jg
from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch import generation as tg
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy
from accelerate_tpu_torch.utils import random as tr

JCFG = jt.LlamaConfig.tiny()
TCFG = tt.LlamaConfig.tiny()
B, S, NEW = 3, 8, 8
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jt.init_llama(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, JCFG.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy_ref(params, prompt):
    return jg.greedy_generate(params[0], prompt, JCFG, max_new_tokens=NEW,
                              cache_dtype=jnp.float32)


def _mid_stream_eos(ref):
    """A token of row 0's generated part, first seen at step 3: the row
    finishes there, and other rows may or may not emit it."""
    row = ref[0, S:]
    for t in range(3, NEW - 1):
        if row[t] not in row[:t]:
            return int(row[t])
    pytest.fail("no token first seen mid-stream in row 0")


@pytest.mark.parametrize("with_eos", [False, True])
def test_greedy_matches_jax(params, prompt, greedy_ref, with_eos):
    jp, tp = params
    eos = _mid_stream_eos(greedy_ref) if with_eos else None
    want = jg.greedy_generate(jp, prompt, JCFG, max_new_tokens=NEW, eos_token_id=eos,
                              cache_dtype=jnp.float32)
    got = tg.greedy_generate(tp, prompt, TCFG, max_new_tokens=NEW, eos_token_id=eos,
                             cache_dtype=torch.float32, **CPU)
    assert got.dtype == prompt.dtype and got.shape == (B, S + NEW)
    np.testing.assert_array_equal(got, np.asarray(want))
    if with_eos:
        row = got[0, S:]
        t = int(np.flatnonzero(row == eos)[0])
        assert 0 < t < NEW - 1 and (row[t:] == eos).all()  # finished rows keep emitting eos
    else:
        np.testing.assert_array_equal(got, greedy_ref)


def test_greedy_torch_prompt_and_bf16_cache(params, prompt):
    """A torch prompt gives the same ids as its numpy copy; the default
    bf16 cache runs and matches JAX's bf16-cache tokens."""
    jp, tp = params
    a = tg.greedy_generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=4, **CPU)
    b = tg.greedy_generate(tp, prompt, TCFG, max_new_tokens=4, **CPU)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b, jg.greedy_generate(jp, prompt, JCFG, max_new_tokens=4))


def _perturbed(logits: torch.Tensor, noise: torch.Tensor, temperature, top_k, top_p):
    """The sampler's filtered, perturbed row and whether its nucleus cut
    sits within 1e-6 of top_p."""
    x = logits.float() / torch.tensor(temperature)
    if top_k:
        kth = torch.topk(x, min(top_k, x.shape[-1])).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x)
    near_mass = False
    if top_p < 1.0:
        srt = torch.sort(x, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, -1), -1)
        near_mass = bool((cum - top_p).abs().min() <= 1e-6)
        cutoff = srt.gather(-1, (cum < top_p).sum(-1, keepdim=True).clamp(max=x.shape[-1] - 1))
        x = torch.where(x < cutoff, float("-inf"), x)
    return x + noise, near_mass


SAMPLE_KNOBS = [dict(temperature=0.8, top_k=20), dict(temperature=1.0, top_p=0.9)]


@pytest.mark.parametrize("knobs", SAMPLE_KNOBS, ids=["t0.8-k20", "t1.0-p0.9"])
def test_sample_matches_jax(params, prompt, knobs):
    jp, tp = params
    want = np.asarray(jg.sample_generate(jp, prompt, JCFG, max_new_tokens=NEW,
                                         rng_key=jax.random.PRNGKey(5), cache_dtype=jnp.float32,
                                         **knobs))
    got = tg.sample_generate(tp, prompt, TCFG, max_new_tokens=NEW, rng_key=tr.prng_key(5),
                             cache_dtype=torch.float32, **knobs, **CPU)
    again = tg.sample_generate(tp, prompt, TCFG, max_new_tokens=NEW,
                               rng_key=np.asarray(jax.random.PRNGKey(5)),
                               cache_dtype=torch.float32, **knobs, **CPU)
    np.testing.assert_array_equal(got, again)  # a JAX key's words are the same key
    # each row's first parted token: the rows agree before it, and it sits on
    # a named near-tie of that step's one-key draw (a row's logits depend on
    # its own prefix only); after it the streams may part freely
    assert (got[:, :S] == want[:, :S]).all(), "the prompts differ"
    for r in np.flatnonzero((got != want).any(axis=1)):
        t = int(np.flatnonzero(got[r] != want[r])[0])
        logits = tt.llama_forward(tp, torch.from_numpy(got[r:r + 1, :t]).long(), TCFG)[0, -1]
        key = tr.fold_in(tr.prng_key(5)[None], t - S)[0]
        noise = tr.gumbel(key[None], B * TCFG.vocab_size).reshape(B, TCFG.vocab_size)[r]
        x, near_mass = _perturbed(logits, noise, **{"top_k": 0, "top_p": 1.0, **knobs})
        top2 = torch.topk(x, 2).values
        assert near_mass or float(top2[0] - top2[1]) <= 1e-5, (
            f"row {r} step {t - S}: port {got[r, t]} != JAX {want[r, t]} with no near-tie")


@pytest.mark.parametrize("seed,fold", [(0, 0), (5, 3), (2**31 - 1, 63)])
def test_one_key_batch_draw_equals_jax(seed, fold):
    """One key for the whole ``[B, V]`` draw: word i of the flat counter,
    row-major, as ``jax.random`` draws a ``(B, V)`` shape under
    ``jax_threefry_partitionable``."""
    rows, V = 4, 512
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    tkey = tr.fold_in(tr.prng_key(seed)[None], fold)[0]
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey, np.int64))
    bits = tr.random_bits(tkey[None], rows * V).reshape(rows, V)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax.random.bits(jkey, (rows, V)),
                                                           np.int64))
    tiny = np.finfo(np.float32).tiny
    u = tr.uniform(tkey[None], rows * V, tiny, 1.0).reshape(rows, V).numpy()
    ref_u = np.asarray(jax.random.uniform(jkey, (rows, V), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(u.view(np.int32), ref_u.view(np.int32))
    got = tr.gumbel(tkey[None], rows * V).reshape(rows, V).numpy()
    ref = np.asarray(jax.random.gumbel(jkey, (rows, V)))
    assert np.all(np.abs(got - ref) <= 2.0 ** -22 + np.spacing(np.abs(ref)))


BEAM_CASES = list(itertools.product([1, 2, 4], [False, True], [0.5, 1.0]))


@pytest.mark.parametrize("num_beams,with_eos,length_penalty", BEAM_CASES,
                         ids=[f"k{k}-{'eos' if e else 'noeos'}-lp{lp}" for k, e, lp in BEAM_CASES])
def test_beam_matches_jax(params, prompt, greedy_ref, num_beams, with_eos, length_penalty):
    jp, tp = params
    eos = _mid_stream_eos(greedy_ref) if with_eos else None
    want, want_scores = jg.beam_generate(jp, prompt, JCFG, num_beams=num_beams,
                                         max_new_tokens=NEW, eos_token_id=eos,
                                         length_penalty=length_penalty, cache_dtype=jnp.float32,
                                         return_scores=True)
    got, scores = tg.beam_generate(tp, prompt, TCFG, num_beams=num_beams, max_new_tokens=NEW,
                                   eos_token_id=eos, length_penalty=length_penalty,
                                   cache_dtype=torch.float32, return_scores=True, **CPU)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(scores, np.asarray(want_scores), rtol=1e-5)
    if num_beams == 1 and not with_eos:
        np.testing.assert_array_equal(got, greedy_ref)


def test_beam_ties_go_to_the_lower_index():
    """``jax.lax.top_k`` breaks ties by the lower index; the port's top-k
    keeps the first k of a stable descending sort, rows of ``-inf`` and one
    ``0.0`` (a frozen beam) included."""
    x = torch.tensor([[0.0, 1.0, 1.0, -1.0, 1.0], [-np.inf, 0.0, -np.inf, -np.inf, -np.inf],
                      [-np.inf] * 5], dtype=torch.float32)
    values, index = tg._top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    np.testing.assert_array_equal(index.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


def _maps(tmp_path):
    mixed = {"embed_tokens": 0, "layer_000": "cpu", "layer_001": "disk", "final_norm": 0,
             "lm_head": "cpu"}
    return {
        "cpu": (lambda st, tdev: tbm.cpu_offload(st, execution_device=tdev),
                lambda st: jbm.cpu_offload(st)),
        "disk": (lambda st, tdev: tbm.disk_offload(st, str(tmp_path / "t"), execution_device=tdev),
                 lambda st: jbm.disk_offload(st, str(tmp_path / "j"))),
        "mixed": (lambda st, tdev: tbm.dispatch_params(st, mixed, offload_folder=str(tmp_path / "t"),
                                                       execution_device=tdev),
                  lambda st: jbm.dispatch_params(st, mixed, offload_folder=str(tmp_path / "j"))),
    }


@pytest.mark.parametrize("kind", ["cpu", "disk", "mixed"])
def test_generate_dispatched_matches_jax_and_greedy(params, prompt, greedy_ref, kind, tmp_path):
    jp, tp = params
    port_make, jax_make = _maps(tmp_path)[kind]
    dp = port_make(tg.unstack_layer_params(tp, TCFG), "cpu")
    got, stats = tg.generate_dispatched(dp, prompt, TCFG, max_new_tokens=NEW,
                                        cache_dtype=torch.float32, return_stats=True,
                                        warmup=True)
    want = jg.generate_dispatched(jax_make(jg.unstack_layer_params(jp, JCFG)), prompt, JCFG,
                                  max_new_tokens=NEW, cache_dtype=jnp.float32)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, greedy_ref)
    assert stats["decode_tokens_per_sec"] > 0
    assert len(dp._paged_cache) <= 3  # the layers were released; embed/norm/head may stay


def test_generate_dispatched_stops_when_every_row_finishes(params, prompt, greedy_ref):
    """With eos the dispatched loop exits once every row has emitted it, as
    JAX's does: the same (shorter) ids, a prefix of greedy's."""
    jp, tp = params
    eos = int(greedy_ref[0, S + 1])
    prompt1 = prompt[:1]
    want = np.asarray(jg.generate_dispatched(
        jbm.cpu_offload(jg.unstack_layer_params(jp, JCFG)), prompt1, JCFG, max_new_tokens=NEW,
        eos_token_id=eos, cache_dtype=jnp.float32))
    got = tg.generate_dispatched(tbm.cpu_offload(tg.unstack_layer_params(tp, TCFG), "cpu"),
                                 prompt1, TCFG, max_new_tokens=NEW, eos_token_id=eos,
                                 cache_dtype=torch.float32)
    assert got.shape[1] < S + NEW
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, greedy_ref[:1, :got.shape[1]])


def test_return_stats_has_jax_keys(params, prompt):
    jp, tp = params
    _, jstats = jg.greedy_generate(jp, prompt, JCFG, max_new_tokens=3, return_stats=True,
                                   cache_dtype=jnp.float32)
    for fn in (tg.greedy_generate, tg.sample_generate):
        _, stats = fn(tp, prompt, TCFG, max_new_tokens=3, return_stats=True, warmup=True,
                      cache_dtype=torch.float32, **CPU)
        assert set(stats) == set(jstats)
        assert stats["seconds_per_token"] > 0 and stats["prefill_seconds"] > 0
    _, stats = tg.generate_dispatched(tbm.cpu_offload(tg.unstack_layer_params(tp, TCFG), "cpu"),
                                      prompt, TCFG, max_new_tokens=3, return_stats=True)
    assert set(stats) == set(jstats)


def test_mesh_and_moe_raise(params, prompt):
    """``mesh=`` raised until sharded decode was ported; the name is kept and
    the case now runs: on a mesh of one device (no process group) greedy,
    sampled and beam decode give the plain path's tokens, JAX's; the
    placements are JAX's (more in ``tests/test_torch_mesh_decode.py``)."""
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    jp, tp = params
    one = ParallelismConfig().build_mesh(1)
    for fn, jfn, kw in ((tg.greedy_generate, jg.greedy_generate, {}),
                        (tg.sample_generate, jg.sample_generate, {"top_k": 20}),
                        (tg.beam_generate, jg.beam_generate, {"num_beams": 2})):
        want = np.asarray(jfn(jp, prompt, JCFG, max_new_tokens=3, cache_dtype=jnp.float32,
                              **kw))
        got = fn(tp, prompt, TCFG, max_new_tokens=3, mesh=one, cache_dtype=torch.float32,
                 **kw, **CPU)
        np.testing.assert_array_equal(got, fn(tp, prompt, TCFG, max_new_tokens=3,
                                              cache_dtype=torch.float32, **kw, **CPU))
        np.testing.assert_array_equal(got, want)
    assert tuple(tg.generation_shardings({"tp": 2}, B, TCFG)[1]) == (None, None, None, "tp",
                                                                     None)
    assert tuple(tg.serving_shardings({"tp": 2}, TCFG)) == (None, None, None, "tp")
    # MoE configs generate (the decode capacity floor), JAX's tokens
    jmoe = jt.LlamaConfig(**{**JCFG.__dict__, "moe_experts": 4})
    moe = tt.LlamaConfig(**{**TCFG.__dict__, "moe_experts": 4})
    jp = jt.init_llama(jmoe, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    want = jg.greedy_generate(jp, prompt, jmoe, max_new_tokens=4, cache_dtype=jnp.float32)
    got = tg.greedy_generate(tp, prompt, moe, max_new_tokens=4, cache_dtype=torch.float32, **CPU)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_init_kv_cache_layout_and_device_rule(params, prompt, monkeypatch):
    """The cache layout is JAX's; every generation entry point runs on the
    CUDA device unless given the CPU, and raises without a GPU."""
    cache = tg.init_kv_cache(TCFG, 2, 16, torch.float32, device="cpu")
    assert cache["k"].shape == (TCFG.n_layers, 2, 16, TCFG.n_kv_heads, TCFG.head_dim)
    want = jg.init_kv_cache(JCFG, 2, 16, jnp.float32)
    assert tuple(want["v"].shape) == tuple(cache["v"].shape)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_kv_cache(TCFG, 2, 16)
    for fn in (tg.greedy_generate, tg.sample_generate, tg.beam_generate):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(params[1], prompt, TCFG, max_new_tokens=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbm.cpu_offload(tg.unstack_layer_params(params[1], TCFG))
