"""The port's threefry streams and sampler against ``jax.random`` and
``accelerate_tpu.generation.sample_token_logits``.

- ``prng_key``, ``fold_in`` and ``random_bits`` must equal JAX's bit for
  bit (integer arithmetic on both sides), and so must ``uniform`` (its bit
  tricks and its one multiply-add by exactly 1 are exact);
- ``gumbel`` is ``-log(-log(u))`` on the same u: torch's and XLA's ``log``
  may differ in the last bit, so each ``log`` is held within 1 ulp of
  XLA's, and the composite within what two such steps can move it;
- the sampler must draw JAX's tokens for 100 seeded rows at V = 32000 over
  temperature x top_k x top_p. A mismatch is allowed only at a near-tie
  the test names: the top two perturbed logits within 1e-5 of each other,
  or a cumulative mass within 1e-6 of top_p (the two softmax/cumsum sums
  run in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.generation import sample_token_logits as jax_sample
from accelerate_tpu_torch.generation import sample_token_logits
from accelerate_tpu_torch.utils import random as tr

SEEDS = (0, 7, 2**31 - 1, -1, 2**32 + 5)
FOLDS = (0, 1, 63, 2**31 - 1)
V = 32000


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_fold_in_and_bits_equal_jax(seed):
    jkey, tkey = jax.random.PRNGKey(seed), tr.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey, np.int64))
    for d in FOLDS:
        jf = jax.random.fold_in(jkey, d)
        tf = tr.fold_in(tkey[None], d)
        np.testing.assert_array_equal(tf[0].numpy(), np.asarray(jf, np.int64))
        for n in (1, 5, V):
            bits = tr.random_bits(tf, n)
            assert bits.shape == (1, n)
            np.testing.assert_array_equal(
                bits.numpy(), np.asarray(jax.random.bits(jf, (1, n)), np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax_bitwise(seed):
    keys = tr.fold_in(tr.prng_key(seed)[None].repeat(len(FOLDS), 1), torch.tensor(FOLDS))
    ours = tr.uniform(keys, V).numpy()
    for row, d in zip(ours, FOLDS):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        ref = np.asarray(jax.random.uniform(key, (1, V)))[0]
        np.testing.assert_array_equal(row.view(np.int32), ref.view(np.int32))
        tiny = np.finfo(np.float32).tiny
        ref = np.asarray(jax.random.uniform(key, (1, V), minval=tiny, maxval=1.0))[0]
        got = tr.uniform(tr.fold_in(tr.prng_key(seed)[None], d), V, tiny, 1.0)[0].numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_fold_in_rows_are_independent_of_the_batch():
    """One key per row: a row's draw does not depend on what else is in
    the batch (the engine pads its batches)."""
    keys = torch.stack([tr.prng_key(s) for s in (3, 4, 5)])
    data = torch.tensor([9, 2**31 + 7, 0])
    together = tr.random_bits(tr.fold_in(keys, data), 64)
    for i in range(3):
        alone = tr.random_bits(tr.fold_in(keys[i : i + 1], data[i : i + 1]), 64)
        assert torch.equal(together[i : i + 1], alone)


def test_rotation_on_words_at_and_above_2_31():
    """The int64 words of a uint32 rotate like uint32 (numpy's wrapping
    arithmetic is the reference), high bit set or not."""
    words = np.array([2**31, 2**32 - 1, 2**31 + 12345, 0x9E3779B9, 1], np.uint32)
    for r in (6, 13, 15, 16, 17, 24, 26, 29):
        want = (words << np.uint32(r)) | (words >> np.uint32(32 - r))
        got = tr._rotl(torch.from_numpy(words.astype(np.int64)), r).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_log(seed):
    tiny = np.finfo(np.float32).tiny
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 63)
    tkey = tr.fold_in(tr.prng_key(seed)[None], 63)
    u = tr.uniform(tkey, V, tiny, 1.0)[0].numpy()
    # each log: within 1 ulp of XLA's on the same input
    inner = np.asarray(jnp.log(u))
    assert _ulps(torch.log(torch.from_numpy(u)).numpy(), inner).max() <= 1
    outer_in = -inner
    assert _ulps(torch.log(torch.from_numpy(outer_in)).numpy(),
                 np.asarray(jnp.log(outer_in))).max() <= 1
    # the composite: 1 ulp of the inner log is a relative step of at most
    # 2**-23, which the outer log turns into an absolute 2**-23; plus the
    # outer log's own last bit
    ref = np.asarray(jax.random.gumbel(key, (1, V)))[0]
    got = tr.gumbel(tkey, V)[0].numpy()
    assert np.all(np.abs(got - ref) <= 2.0 ** -22 + np.spacing(np.abs(ref)))


def _near_tie(logits: np.ndarray, keys: torch.Tensor, temperature, top_k, top_p) -> bool:
    """Whether a row's draw sits on a named near-tie: its two largest
    perturbed logits within 1e-5, or a cumulative mass within 1e-6 of
    top_p."""
    x = torch.from_numpy(logits)[None].float() / torch.tensor(temperature)
    if top_k:
        kth = torch.topk(x, min(top_k, V)).values[..., -1:]
        x = torch.where(x < kth, float("-inf"), x)
    if top_p < 1.0:
        srt = torch.sort(x, descending=True).values
        cum = torch.cumsum(torch.softmax(srt, -1), -1)
        if bool((cum - top_p).abs().min() <= 1e-6):
            return True
        cutoff = srt.gather(-1, (cum < top_p).sum(-1, keepdim=True).clamp(max=V - 1))
        x = torch.where(x < cutoff, float("-inf"), x)
    top2 = torch.topk(x + tr.gumbel(keys, V), 2).values[0]
    return bool(top2[0] - top2[1] <= 1e-5)


@pytest.fixture(scope="module")
def rows():
    """100 seeded logit rows at V = 32000, each with its own folded key."""
    rng = np.random.default_rng(0)
    n = 100
    logits = (rng.standard_normal((n, V)) * 3).astype(np.float32)
    seeds, folds = np.arange(n), rng.integers(0, 2**31 - 1, n)
    jkeys = jax.vmap(jax.random.fold_in)(jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds)),
                                         jnp.asarray(folds))
    tkeys = tr.fold_in(torch.stack([tr.prng_key(int(s)) for s in seeds]), torch.from_numpy(folds))
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys, np.int64))
    return logits, jkeys, tkeys


@pytest.mark.parametrize("temperature,top_k,top_p",
                         list(itertools.product((0.7, 1.0, 1.3), (0, 1, 20, V + 5), (1.0, 0.9, 0.5))))
def test_sampler_draws_jax_tokens(rows, temperature, top_k, top_p):
    logits, jkeys, tkeys = rows
    n = len(logits)
    jax_fn = jax.jit(jax.vmap(lambda row, key: jax_sample(
        row[None], key, temperature=temperature, top_k=top_k, top_p=top_p)[0]))
    want = np.asarray(jax_fn(jnp.asarray(logits), jkeys))
    got = sample_token_logits(torch.from_numpy(logits), tkeys, temperature=temperature,
                              top_k=top_k, top_p=top_p)
    assert got.dtype == torch.int64 and got.shape == (n,)
    got = got.numpy()
    for i in np.flatnonzero(got != want):
        assert _near_tie(logits[i], tkeys[i : i + 1], temperature, top_k, top_p), (
            f"row {i}: port token {got[i]} != JAX token {want[i]} with no near-tie")
    if top_k == 1:  # one token left: the draw is the argmax
        np.testing.assert_array_equal(got, logits.argmax(-1))


def test_sampler_greedy_and_negative_temperature():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 50)).astype(np.float32)
    logits[2, [3, 7]] = logits[2].max() + 1.0  # a tie: first index, as jnp.argmax
    keys = torch.stack([tr.prng_key(s) for s in range(4)])
    got = sample_token_logits(torch.from_numpy(logits), keys, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(logits, -1)))
    assert int(got[2]) == 3
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        sample_token_logits(torch.from_numpy(logits), keys, temperature=-0.5)
    with pytest.raises(ValueError, match="temperature must be >= 0"):
        jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), temperature=-0.5)
