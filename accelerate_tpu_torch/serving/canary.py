"""Bitwise correctness canaries: the port of
``accelerate_tpu.serving.canary``.

At startup the router's caller precomputes golden token streams from the
single-stream reference (``generation.greedy_generate`` /
``sample_generate``) against the fleet's own spec
(:func:`precompute_goldens`); :class:`CanaryProbe` then has the router
inject those prompts as ordinary requests. A replica whose answer differs
in any token is wrong — not slow, wrong — and counts toward DRAINING
pressure like an SLO-burning replica.

Canary traffic bypasses admission, SLO observation and the router's
request counters, and is never failed over (a probe tests one replica).
The reference's ``canary`` and ``canary_failure`` records go with the
telemetry (ROADMAP.md, Queue A item 12).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Optional, Sequence

__all__ = ["CanaryGolden", "CanaryProbe", "precompute_goldens"]


@dataclass(frozen=True)
class CanaryGolden:
    """One golden probe: a prompt plus the token stream the single-stream
    reference produced for it. ``expected`` holds the NEW tokens only
    (the engine's done event reports generated tokens, not the prompt)."""

    name: str
    prompt: "tuple[int, ...]"
    max_new_tokens: int
    expected: "tuple[int, ...]"
    rng_seed: int = 0


def _default_prompts(vocab_size: int, count: int) -> "list[tuple[int, ...]]":
    """Deterministic synthetic prompts inside the vocabulary (token 0 is
    avoided — pad/bos conventions vary by tokenizer)."""
    span = max(2, vocab_size - 1)
    prompts = []
    for i in range(count):
        length = 5 + i
        prompts.append(tuple(1 + (3 + 7 * i + 2 * j) % span for j in range(length)))
    return prompts


def precompute_goldens(
    spec: Any,
    prompts: Optional[Iterable[Sequence[int]]] = None,
    *,
    count: int = 2,
    max_new_tokens: int = 6,
    rng_seed_base: int = 7001,
) -> "list[CanaryGolden]":
    """Run the single-stream reference over the canary prompts.

    ``spec`` is a :class:`~.replica.ReplicaSpec`: its ``build_params()`` /
    ``config()`` are deterministic, so the goldens computed here are the
    answer every correct replica of this fleet must reproduce bitwise. The
    reference runs on the spec's device with a cache of the spec's
    ``cache_dtype``. Greedy specs (temperature 0) use ``greedy_generate``;
    sampled specs use ``sample_generate`` with the rng seed the probe ships
    in its request — sampling is a pure function of (prompt, rng_seed).
    """
    import numpy as np
    import torch

    from .. import generation as _generation
    from ..utils.random import prng_key

    config = spec.config()
    params = spec.build_params()
    gen_kw = dict(cache_dtype=getattr(torch, getattr(spec, "cache_dtype", "bfloat16")),
                  device=getattr(spec, "device", None))
    if prompts is None:
        prompts = _default_prompts(int(config.vocab_size), count)
    goldens: "list[CanaryGolden]" = []
    for i, prompt in enumerate(prompts):
        prompt_t = tuple(int(t) for t in prompt)
        arr = np.asarray(prompt_t, dtype=np.int32)[None]
        seed = rng_seed_base + i
        temperature = float(getattr(spec, "temperature", 0.0) or 0.0)
        if temperature > 0.0:
            ref = _generation.sample_generate(
                params, arr, config, max_new_tokens=max_new_tokens,
                temperature=temperature,
                top_k=int(getattr(spec, "top_k", 0) or 0),
                top_p=float(getattr(spec, "top_p", 1.0) or 1.0),
                rng_key=prng_key(seed), **gen_kw,
            )
        else:
            ref = _generation.greedy_generate(
                params, arr, config, max_new_tokens=max_new_tokens, **gen_kw
            )
        expected = tuple(int(t) for t in np.asarray(ref[0])[len(prompt_t):])
        goldens.append(
            CanaryGolden(
                name=f"golden{i}",
                prompt=prompt_t,
                max_new_tokens=max_new_tokens,
                expected=expected,
                rng_seed=seed,
            )
        )
    return goldens


class CanaryProbe:
    """Schedule + verdict state for the router's canary injection.

    The router owns replica selection and request plumbing; the probe owns
    WHEN to inject (``due``/``schedule``), WHICH golden goes next
    (round-robin), and the bitwise verdict (:meth:`check` — None on an
    exact match, else a dict naming the first mismatching position)."""

    def __init__(
        self,
        goldens: "list[CanaryGolden]",
        *,
        interval_s: float = 30.0,
        drain_on_failure: bool = True,
    ):
        if not goldens:
            raise ValueError("CanaryProbe needs at least one golden")
        self.goldens = list(goldens)
        self.interval_s = float(interval_s)
        self.drain_on_failure = bool(drain_on_failure)
        self._next_due: Optional[float] = None  # None -> due immediately
        self._cursor = 0
        self.probes = 0
        self.failures = 0
        self.by_replica: "dict[str, dict]" = {}

    def due(self, now: float) -> bool:
        return self._next_due is None or now >= self._next_due

    def schedule(self, now: float) -> None:
        self._next_due = now + self.interval_s

    def next_golden(self) -> CanaryGolden:
        golden = self.goldens[self._cursor % len(self.goldens)]
        self._cursor += 1
        return golden

    @staticmethod
    def check(golden: CanaryGolden, tokens: Sequence[int]) -> Optional[dict]:
        """Bitwise verdict: None on exact match, else the first mismatch.

        A wrong length is a mismatch too — the mismatch index is the first
        position where one stream has a token the other lacks."""
        got = [int(t) for t in tokens]
        expected = list(golden.expected)
        if got == expected:
            return None
        idx = next(
            (i for i, (e, g) in enumerate(zip(expected, got)) if e != g),
            min(len(expected), len(got)),
        )
        return {
            "golden": golden.name,
            "mismatch_index": idx,
            "expected_token": expected[idx] if idx < len(expected) else None,
            "got_token": got[idx] if idx < len(got) else None,
            "expected_len": len(expected),
            "got_len": len(got),
        }

    def record_result(self, replica: str, ok: bool) -> None:
        self.probes += 1
        ent = self.by_replica.setdefault(replica, {"probes": 0, "failures": 0})
        ent["probes"] += 1
        if not ok:
            self.failures += 1
            ent["failures"] += 1

    def stats(self) -> dict:
        return {
            "probes": self.probes,
            "failures": self.failures,
            "by_replica": {k: dict(v) for k, v in sorted(self.by_replica.items())},
        }
