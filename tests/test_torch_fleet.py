"""Real tiny fleets of the port's serving engine on the CPU, held to the JAX
package: thread replicas under the router, a killed replica's failover, the
correctness canary, and child-process replicas with a real SIGKILL.

Weights come from the JAX package's ``init_llama`` through
``params_from_numpy`` (a ``ReplicaSpec`` subclass), in f32 with an f32
cache, so the port's streams are JAX's token for token (the engines'
parity tests hold the same); the canary runs the spec's default bf16
cache on both sides, as the JAX package's canaries do.

- ``LocalReplica`` x2, greedy: a run with ``r0`` killed once it holds
  partly decoded work equals the unkilled run and JAX ``greedy_generate``
  on every request, with at least one failover and nothing lost; a
  planted fault (the resume payload loses its first streamed token in
  transit) must fail that bar;
- the canary: goldens from the port's ``precompute_goldens`` equal JAX's;
  a replica of another param seed is drained with at least one failure,
  the good one has none;
- ``ProcessReplica`` x2 (children started with ``subprocess.Popen``, the
  weights from the spec's seeded CPU generator): one child SIGKILLed mid
  decode, every output equal to JAX ``greedy_generate`` on the same
  weights (``spec.build_params()`` through ``params_to_numpy``), and a
  ``stats`` event from the survivor;
- a ``ReplicaSpec`` with ``device="cuda"`` raises here: no replica runs
  the plain kernels on a card or falls back to the CPU.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import serving as jserving
from accelerate_tpu.generation import greedy_generate as jax_greedy
from accelerate_tpu.models import transformer as jt
from accelerate_tpu_torch import serving as tserving
from accelerate_tpu_torch.models import transformer as tt
from accelerate_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from accelerate_tpu_torch.serving import (
    LocalReplica,
    ProcessReplica,
    ReplicaSpec,
    ReplicaState,
    RouterRequestStatus,
    ServingRouter,
)
from accelerate_tpu_torch.serving import replica as treplica

MODEL = dataclasses.asdict(tt.LlamaConfig.tiny())
SPEC_KW = dict(model=MODEL, num_blocks=33, block_size=8, max_slots=2, slot_buckets=(2,),
               block_buckets=(4,), prefill_buckets=(32,), device="cpu")
LENGTHS = (5, 13, 9, 13, 5, 9)
PROC_LENGTHS = (9,) * 6  # one length: one batched JAX reference call
NEW = 12
_NUMPY_PARAMS: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tiny CPU ops, restored after
    it: the suite runs several test workers on one machine, and a worker
    whose every op spreads over all the cores slows the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_numpy_params(seed: int) -> dict:
    if seed not in _NUMPY_PARAMS:
        jp = jt.init_llama(jt.LlamaConfig(**MODEL), jax.random.PRNGKey(seed))
        _NUMPY_PARAMS[seed] = jax.tree_util.tree_map(np.asarray, jp)
    return _NUMPY_PARAMS[seed]


class JaxInitSpec(ReplicaSpec):
    """The JAX package's ``init_llama(PRNGKey(param_seed))`` weights, cast
    to ``param_dtype``, on the CPU."""

    def build_params(self):
        return params_from_numpy(_jax_numpy_params(self.param_seed), device="cpu",
                                 dtype=getattr(torch, self.param_dtype))


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, MODEL["vocab_size"], (n,)).astype(np.int32) for n in lengths]


@pytest.fixture(scope="module")
def jax_refs():
    """JAX ``greedy_generate`` (f32 params and cache) of every prompt,
    prompts of one length batched together."""
    params = jax.tree_util.tree_map(jnp.asarray, _jax_numpy_params(0))
    prompts = _prompts(1, LENGTHS)
    refs = {}
    for n in sorted(set(LENGTHS)):
        idx = [i for i, p in enumerate(prompts) if p.size == n]
        out = np.asarray(jax_greedy(params, np.stack([prompts[i] for i in idx]),
                                    jt.LlamaConfig(**MODEL), max_new_tokens=NEW,
                                    cache_dtype=jnp.float32))
        refs.update({i: out[j] for j, i in enumerate(idx)})
    return [refs[i] for i in range(len(prompts))]


def _drain(router, prompts, kill_when=None, timeout_s=120.0):
    """Submit every prompt (greedy, ``NEW`` tokens, rng_seed = index) as a
    backlog and poll to the end; ``kill_when(router, reqs)`` names a replica
    to kill once. Returns the requests and whether a kill happened."""
    router.wait_ready(timeout_s=timeout_s)
    reqs = [router.submit(p, NEW, rng_seed=i) for i, p in enumerate(prompts)]
    killed = False
    deadline = time.monotonic() + timeout_s
    while not all(r.status.terminal for r in reqs):
        router.poll()
        if kill_when is not None and not killed:
            name = kill_when(router, reqs)
            if name is not None:
                router.replicas[name].kill()
                killed = True
        assert time.monotonic() < deadline, "fleet wedged"
        time.sleep(0.001)
    return reqs, killed


def _r0_holds_partial_work(router, reqs):
    busy = any(r.replica == "r0" and len(r.generated) >= 2 and not r.status.terminal
               for r in reqs)
    return "r0" if busy else None


def _failover_run(spec):
    router = ServingRouter([LocalReplica(f"r{i}", spec) for i in range(2)],
                           health_timeout_s=10.0)
    try:
        reqs, killed = _drain(router, _prompts(1, LENGTHS), kill_when=_r0_holds_partial_work)
    finally:
        router.close()
    return router, reqs, killed


@pytest.fixture(scope="module")
def f32_spec():
    return JaxInitSpec(param_dtype="float32", cache_dtype="float32", **SPEC_KW)


def test_local_replica_failover_equals_unkilled_and_jax(f32_spec, jax_refs):
    plain = ServingRouter([LocalReplica(f"r{i}", f32_spec) for i in range(2)])
    try:
        unkilled, _ = _drain(plain, _prompts(1, LENGTHS))
    finally:
        plain.close()
    router, reqs, killed = _failover_run(f32_spec)
    assert killed and router.replicas["r0"].state is ReplicaState.DEAD
    assert router.failovers >= 1 and any(r.retries >= 1 for r in reqs)
    stats = router.stats()
    assert stats["completed"] == len(reqs) and stats["failed"] == stats["shed"] == 0
    for i, (u, r, ref) in enumerate(zip(unkilled, reqs, jax_refs)):
        assert u.status is r.status is RouterRequestStatus.FINISHED, (i, r.status, r.error)
        assert np.array_equal(u.output_ids(), ref), f"unkilled request {i}"
        assert np.array_equal(r.output_ids(), ref), f"failed-over request {i}"
    # the replicas warmed every lattice point before taking traffic
    ready = router.replicas["r1"].ready_info
    assert ready == {"prefill_compiles": 1, "decode_compiles": 1, "cow_compiles": 1}


def test_failover_planted_fault_fails_the_bar(f32_spec, jax_refs, monkeypatch):
    """Planted: the resume payload loses its first streamed token in
    transit, so the survivor continues from the wrong context."""
    real = LocalReplica.submit

    def submit(self, payload):
        if payload.get("generated"):
            payload = dict(payload, generated=payload["generated"][1:])
        real(self, payload)

    monkeypatch.setattr(LocalReplica, "submit", submit)
    router, reqs, killed = _failover_run(f32_spec)
    assert killed and router.failovers >= 1
    assert any(not np.array_equal(r.output_ids(), ref) for r, ref in zip(reqs, jax_refs))


def test_canary_drains_the_bad_seed_with_no_false_positive():
    prompts = [tuple(int(t) for t in p) for p in _prompts(1, LENGTHS)[:1]]
    goldens = tserving.precompute_goldens(
        JaxInitSpec(param_dtype="float32", **SPEC_KW), prompts=prompts, max_new_tokens=NEW)
    jgoldens = jserving.precompute_goldens(
        jserving.ReplicaSpec(model=MODEL, param_dtype="float32"), prompts=prompts,
        max_new_tokens=NEW)
    assert [dataclasses.astuple(g) for g in goldens] == [dataclasses.astuple(g)
                                                        for g in jgoldens]
    spec = JaxInitSpec(param_dtype="float32", **SPEC_KW)
    probe = tserving.CanaryProbe(goldens, interval_s=0.5)
    router = ServingRouter(
        [LocalReplica("good", spec),
         LocalReplica("bad", dataclasses.replace(spec, param_seed=1234))],
        canary=probe, health_timeout_s=10.0)
    try:
        router.wait_ready(timeout_s=60)
        deadline = time.monotonic() + 60
        while (probe.by_replica.get("bad", {}).get("failures", 0) < 1
               or probe.by_replica.get("good", {}).get("probes", 0) < 1
               or router._inflight):
            router.poll()
            assert time.monotonic() < deadline, f"canary probes stalled: {probe.stats()}"
            time.sleep(0.002)
    finally:
        router.close()
    assert router.replicas["bad"].state is ReplicaState.DRAINING
    assert router.replicas["good"].state is ReplicaState.HEALTHY
    assert probe.by_replica["bad"]["failures"] >= 1
    assert probe.by_replica["good"]["failures"] == 0
    stats = router.stats()
    assert stats["canary"]["failed_replicas"] == ["bad"] and stats["completed"] == 0


def test_process_replicas_sigkill_failover():
    spec = ReplicaSpec(param_dtype="float32", cache_dtype="float32", **SPEC_KW)
    prompts = _prompts(2, PROC_LENGTHS)
    # one intra-op thread a child: the suite runs beside other workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    router = ServingRouter([ProcessReplica(f"r{i}", spec, env=env) for i in range(2)],
                           health_timeout_s=30.0)
    try:
        t0 = time.monotonic()
        router.wait_ready(timeout_s=120)
        ready_s = time.monotonic() - t0
        reqs, killed = _drain(router, prompts, kill_when=_r0_holds_partial_work)
        survivor = router.replicas["r1"]
        survivor.request_stats()
        deadline = time.monotonic() + 30
        stats = []
        while not stats and time.monotonic() < deadline:
            stats = [e for e in survivor.drain_events() if e.get("event") == "stats"]
            time.sleep(0.01)
        killed_rc = router.replicas["r0"].proc.wait(timeout=10)
    finally:
        router.close()
    assert killed and killed_rc == -9  # a real SIGKILL
    assert router.failovers >= 1 and ready_s < 120
    # the children's weights, as the JAX package's tree
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(spec.build_params()))
    refs = np.asarray(jax_greedy(jparams, np.stack(prompts), jt.LlamaConfig(**MODEL),
                                 max_new_tokens=NEW, cache_dtype=jnp.float32))
    for i, (r, ref) in enumerate(zip(reqs, refs)):
        assert r.status is RouterRequestStatus.FINISHED, (i, r.error)
        assert np.array_equal(r.output_ids(), ref), f"request {i}"
    (ev,) = stats
    assert ev["engine"]["decode_tokens"] > 0 and ev["engine"]["prefill_compiles"] == 1
    # on the CPU the wrappers take the plain versions: no kernel launched
    assert ev["launches"] == {"paged_attention_decode": 0, "paged_attention_prefill": 0}


def test_cuda_spec_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = ReplicaSpec(**dict(SPEC_KW, device="cuda"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build_engine()
    with pytest.raises(NotImplementedError, match="item 12"):
        ProcessReplica("r0", spec, chaos_schedule="[]")
    assert treplica.ReplicaSpec.from_json(spec.to_json()).to_json() == spec.to_json()
