"""The fleet's host-side control plane against the JAX package's, on the
same scripted inputs (no engine, microseconds each):

- ``TokenBucket`` / ``AdmissionController``: the same verdicts, queues
  and counters;
- ``SLOMonitor`` over ``serving_slos`` and a custom objective on a fake
  clock: the same ``evaluate`` records, ``burning_sources`` and
  ``stats()``;
- ``ServingRouter`` over scriptable fake replicas (this file's copy of the
  reference suite's fakes): every scenario of the reference's router
  tests — shed, deadline, least-outstanding dispatch, exactly-once
  failover, heartbeat staleness, a death after the last token, the retry
  bound, drain, self-heal budget, backoff and decommission, and the canary
  drain, tie, drop and inconclusive cases — gives the whole ``stats()``,
  every request's status, tokens, replica, retries and error, the replica
  states and every payload a fake received equal to JAX's (request ids
  mapped to their submission index: the two packages count rids apart);
- ``AutoscalerPolicy`` over a fake router: the same ``events`` list;
- ``CanaryProbe.check`` and ``lattice_fns``: the same answers;
- ``BlockAllocator.chain_hashes`` / ``adopt_block``: the same tables,
  hashes, adoptions and stats over one operation script;
- the KV handoff's wire form: the port's ``to_wire`` is JAX's byte for
  byte on the same handoff, each side's ``verify_wire`` accepts the
  other's, and ``corrupt_wire`` or a forged hash is caught by both;
- ``ServingEngine.warmup()`` (and ``DecodeEngine``'s) returns JAX's dict on
  the same tiny spec.

Each comparison has a planted fault in the port that must make it fail.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

import accelerate_tpu.serving as jserving
import accelerate_tpu.serving.disagg as jdisagg
import accelerate_tpu.serving.kv_pager as jpager
import accelerate_tpu.telemetry.slo as jslo
import accelerate_tpu_torch.serving as tserving
import accelerate_tpu_torch.serving.disagg as tdisagg
import accelerate_tpu_torch.serving.kv_pager as tpager
import accelerate_tpu_torch.telemetry.slo as tslo

# each package's serving names, and its SLO module as ``slo``
J = SimpleNamespace(**{n: getattr(jserving, n) for n in jserving.__all__}, slo=jslo)
T = SimpleNamespace(**{n: getattr(tserving, n) for n in tserving.__all__}, slo=tslo)


def test_serving_exports_every_jax_name():
    assert [n for n in jserving.__all__ if n not in tserving.__all__] == []
    assert all(getattr(tserving, n) is not None for n in tserving.__all__)


# ---------------------------------------------------------------------------
# fakes (a copy of the reference suite's, over either package's states)


class FakeReplica:
    """Scriptable replica: the router's dispatch/health/failover logic
    without an engine."""

    transport = "fake"

    def __init__(self, states, name, max_slots=4):
        self.name = name
        self.state = states.HEALTHY
        self.spec = SimpleNamespace(max_slots=max_slots)
        self.submitted = []
        self._events = []
        self._alive = True
        self._states = states

    def submit(self, payload):
        self.submitted.append(payload)

    def drain_events(self):
        ev, self._events = self._events, []
        return ev

    def alive(self):
        return self._alive

    def kill(self):
        self._alive = False

    def stop(self):
        pass

    def close(self, timeout=0.0):
        self._alive = False

    def push(self, **ev):
        self._events.append(ev)

    def die(self):
        self._alive = False


class RespawnableFake(FakeReplica):
    def __init__(self, states, name, max_slots=4, generation=0):
        super().__init__(states, name, max_slots=max_slots)
        self.generation = generation

    def respawn(self):
        return RespawnableFake(self._states, self.name, max_slots=self.spec.max_slots,
                               generation=self.generation + 1)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# admission and the SLO monitor


def _admission_script(s):
    """Every admission path on one fake clock: the bucket's refill and
    all-or-nothing take, priority order, requeue-front, displacement,
    queue-full, never evicting a failover requeue, expiry."""
    clock = FakeClock()
    out = []
    bucket = s.TokenBucket(rate_per_s=10.0, burst=30.0, clock=clock)
    out += [bucket.take(30), bucket.take(1)]
    clock.t += 2.0
    out += [bucket.available(), bucket.take(25), bucket.take(20)]
    clock.t += 100.0
    out += [bucket.available(), bucket.take(5, now=clock.t - 50.0), bucket.available()]
    ctl = s.AdmissionController(max_queue=4, rate_tokens_per_s=20.0, burst_tokens=50.0,
                                clock=clock)
    reqs = [SimpleNamespace(priority=p, rid=i, retries=int(i == 2), deadline_t=d)
            for i, (p, d) in enumerate([(1, None), (0, 200.0), (1, None), (1, 90.0), (0, None),
                                        (1, 100.0), (0, None), (1, None), (0, None)])]
    for r, cost in zip(reqs, (10, 10, 5, 45, 5, 5, 1, 1, 1)):
        if r.retries:
            ctl.requeue_front(r)
            out.append(("requeued", r.rid))
            continue
        v = ctl.try_admit(r, cost=cost)
        out.append((v.admitted, v.reason, [e.rid for e in v.evicted], ctl.depth,
                    ctl.depth_by_priority(), [q.rid for q in ctl.queued()]))
        clock.t += 0.5
    out.append([r.rid for r in ctl.expire(clock.t + 10.0)])
    out.append([getattr(ctl.pop_next(), "rid", None) for _ in range(5)])
    out.append((ctl.shed_count, ctl.evicted_count, ctl.bucket.available()))
    return out


@pytest.mark.parametrize("fault", [None, "lifo"])
def test_admission_equals_jax(fault, monkeypatch):
    if fault:  # planted: the queue pops newest first within a class
        def pop_next(self):
            for p in sorted(self._queues):
                if self._queues[p]:
                    return self._queues[p].pop()
            return None
        monkeypatch.setattr(tserving.AdmissionController, "pop_next", pop_next)
    same = _admission_script(J) == _admission_script(T)
    assert same is (fault is None)


def _slo_script(slo):
    clock = FakeClock(0.0)
    objectives = slo.serving_slos(ttft_threshold_s=0.5, fast_window_s=10.0, slow_window_s=60.0)
    objectives.append(slo.SLObjective("steps", kind="latency", threshold_s=1.0, target=0.9,
                                      fast_window_s=5.0, slow_window_s=20.0, burn_threshold=2.0))
    mon = slo.SLOMonitor(objectives, clock=clock, min_events=3)
    rng = np.random.default_rng(0)
    out = []
    for i in range(120):
        clock.t += float(rng.exponential(0.5))
        src = f"r{i % 3}"
        bad_phase = 30 <= i < 70 and src != "r2"
        out.append(mon.observe("ttft", value=(0.9 if bad_phase else 0.1), source=src))
        out.append(mon.observe("availability", good=not (bad_phase and i % 4 == 0), source=src))
        out.append(mon.observe("shed_rate", good=i % 9 != 0))
        out.append(mon.observe("steps", value=float(rng.uniform(0.5, 1.4))))
        if i % 5 == 4:
            out.append(mon.evaluate())
            out.append({n: mon.burning_sources(n) for n in ("ttft", "availability")})
    clock.t += 500.0
    out += [mon.evaluate(), mon.burning_sources("ttft"), mon.stats()]
    for bad in ({"kind": "latency"}, {"target": 1.0}, {"fast_window_s": 10.0, "slow_window_s": 5.0}):
        try:
            slo.SLObjective("x", **{"threshold_s": None, **bad})
            out.append("no error")
        except ValueError as exc:
            out.append(str(exc))
    return out


@pytest.mark.parametrize("fault", [None, "no_hysteresis"])
def test_slo_monitor_equals_jax(fault, monkeypatch):
    if fault:  # planted: a violation re-enters on every evaluation
        real = tslo.SLOMonitor.evaluate

        def evaluate(self, now=None, emit=True):
            recs = real(self, now, emit)
            for s in self._state.values():
                s.violating = False
            return recs
        monkeypatch.setattr(tslo.SLOMonitor, "evaluate", evaluate)
    same = _slo_script(J.slo) == _slo_script(T.slo)
    assert same is (fault is None)


# ---------------------------------------------------------------------------
# the router over fakes


def _record(s, router, reqs, fakes):
    index = {r.rid: i for i, r in enumerate(reqs)}

    def norm(payload):
        return {k: (index.get(v, v) if k == "rid" else v) for k, v in payload.items()}

    return {
        "stats": router.stats(),
        "requests": [(r.status.value, list(r.generated), r.replica, r.retries, r.error)
                     for r in reqs],
        "states": {n: rep.state.value for n, rep in router.replicas.items()},
        "submitted": {f.name: [norm(p) for p in f.submitted] for f in fakes},
        "outstanding": {n: router.outstanding_tokens(n) for n in router.replicas},
    }


def _sc_shed(s):
    clock = FakeClock()
    rep = FakeReplica(s.ReplicaState, "r0")
    rep.state = s.ReplicaState.STARTING
    router = s.ServingRouter([rep], clock=clock, admission=s.AdmissionController(
        max_queue=2, rate_tokens_per_s=10.0, burst_tokens=40.0, clock=clock))
    prompt = np.arange(4, dtype=np.int32) + 1
    reqs = [router.submit(prompt, 8, priority=s.PRIORITY_BATCH),
            router.submit(prompt, 8, priority=s.PRIORITY_BATCH),
            router.submit(prompt, 16, priority=s.PRIORITY_BATCH),
            router.submit(prompt, 4, priority=s.PRIORITY_INTERACTIVE),
            router.submit(prompt, 4, priority=s.PRIORITY_BATCH)]
    router.poll()
    return router, reqs, [rep]


def _sc_deadline(s):
    clock = FakeClock()
    rep = FakeReplica(s.ReplicaState, "r0")
    rep.state = s.ReplicaState.STARTING
    router = s.ServingRouter([rep], clock=clock)
    prompt = np.arange(3, dtype=np.int32) + 1
    reqs = [router.submit(prompt, 4, deadline_s=5.0), router.submit(prompt, 4)]
    clock.t += 6.0
    done = router.poll()
    rep.state = s.ReplicaState.HEALTHY
    router.poll()
    return router, reqs + [len(done)], [rep]


def _sc_least_outstanding(s):
    r0, r1 = FakeReplica(s.ReplicaState, "r0"), FakeReplica(s.ReplicaState, "r1")
    router = s.ServingRouter([r0, r1])
    reqs = [router.submit(np.arange(10, dtype=np.int32) + 1, 10),
            router.submit(np.arange(2, dtype=np.int32) + 1, 2),
            router.submit(np.arange(2, dtype=np.int32) + 1, 2)]
    router.poll()
    r1.push(event="step", step=1, progress={reqs[1].rid: [5]})
    router.poll()
    return router, reqs, [r0, r1]


def _sc_failover(s):
    r0, r1 = FakeReplica(s.ReplicaState, "r0"), FakeReplica(s.ReplicaState, "r1")
    router = s.ServingRouter([r0, r1], max_retries=3)
    req = router.submit(np.asarray([1, 2, 3], np.int32), 5)
    router.poll()
    r0.push(event="step", step=1, progress={req.rid: [7, 8]})
    router.poll()
    r0.die()
    router.poll()
    owed = router.outstanding_tokens("r1")  # the re-prefill counts
    r0.push(event="done", rid=req.rid, status="finished", tokens=[7, 8, 0, 0, 0])
    router.poll()
    for _ in range(2):  # the duplicate is ignored
        r1.push(event="done", rid=req.rid, status="finished", tokens=[7, 8, 9, 10, 11],
                preemptions=0)
    done = router.poll()
    return router, [req, owed, len(done)], [r0, r1]


def _sc_heartbeat(s):
    clock = FakeClock()
    r0, r1 = FakeReplica(s.ReplicaState, "r0"), FakeReplica(s.ReplicaState, "r1")
    router = s.ServingRouter([r0, r1], health_timeout_s=2.0, clock=clock)
    req = router.submit(np.asarray([1, 2], np.int32), 4)
    router.poll()
    clock.t += 3.0
    router.poll()
    return router, [req, r0.alive(), getattr(r0, "reason", None)], [r0, r1]


def _sc_streamed_then_dead(s):
    r0 = FakeReplica(s.ReplicaState, "r0")
    router = s.ServingRouter([r0])
    req = router.submit(np.asarray([1, 2], np.int32), 3)
    router.poll()
    r0.push(event="step", step=1, progress={req.rid: [4, 5, 6]})
    router.poll()
    r0.die()
    done = router.poll()
    return router, [req, len(done)], [r0]


def _sc_retry_bound(s):
    r0 = FakeReplica(s.ReplicaState, "r0")
    router = s.ServingRouter([r0], max_retries=0, max_outstanding_per_replica=1)
    reqs = [router.submit(np.asarray([1, 2], np.int32), 4) for _ in range(2)]
    router.poll()
    r0.die()
    done = router.poll()
    return router, reqs + [len(done)], [r0]


def _sc_drain(s):
    r0, r1 = FakeReplica(s.ReplicaState, "r0"), FakeReplica(s.ReplicaState, "r1")
    router = s.ServingRouter([r0, r1])
    first = router.submit(np.asarray([1], np.int32), 2)
    router.poll()
    router.drain("r0")
    later = router.submit(np.asarray([1], np.int32), 2)
    router.poll()
    r0.push(event="done", rid=first.rid, status="finished", tokens=[9, 9])
    router.poll()
    router.drain("r1")
    stranded = router.submit(np.asarray([1], np.int32), 2)
    router.poll()
    r1.push(event="done", rid=later.rid, status="finished", tokens=[8, 8])
    router.poll()
    return router, [first, later, stranded], [r0, r1]


def _sc_heal_budget(s):
    clock = FakeClock()
    rep = RespawnableFake(s.ReplicaState, "r0")
    router = s.ServingRouter([rep], clock=clock, self_heal=True, max_respawns_per_replica=1,
                             respawn_backoff_base_s=0.0)
    rep.die()
    router.poll()
    healed = router.replicas["r0"]
    gen = healed.generation
    healed.die()
    router.poll()
    req = router.submit(np.arange(4, dtype=np.int32), 4)
    router.poll()
    return router, [req, gen], [rep, healed]


def _sc_heal_backoff(s):
    clock = FakeClock()
    rep = RespawnableFake(s.ReplicaState, "r0")
    router = s.ServingRouter([rep], clock=clock, self_heal=True, max_respawns_per_replica=3,
                             respawn_backoff_base_s=10.0)
    rep.die()
    router.poll()
    router.replicas["r0"].die()
    router.poll()
    req = router.submit(np.arange(4, dtype=np.int32), 4)
    router.poll()
    mid = (req.status.value, router.replicas["r0"].state.value)
    clock.t += 10.1
    router.poll()
    healed = router.replicas["r0"]
    return router, [req, mid, healed.generation], [healed]


def _sc_heal_decommissioned(s):
    clock = FakeClock()
    reps = [RespawnableFake(s.ReplicaState, "r0"), RespawnableFake(s.ReplicaState, "r1")]
    router = s.ServingRouter(reps, clock=clock, self_heal=True, max_respawns_per_replica=3,
                             respawn_backoff_base_s=0.0)
    plain = FakeReplica(s.ReplicaState, "r2")
    router.add_replica(plain)
    router.drain("r0")
    reps[0].die()
    plain.die()
    router.poll()
    reps[1].die()
    router.poll()
    req = router.submit(np.arange(4, dtype=np.int32), 4)
    router.poll()
    return router, [req, router.replicas["r0"] is reps[0],
                    router.replicas["r1"].generation], [router.replicas["r1"]]


def _golden(s):
    return s.CanaryGolden(name="g0", prompt=(1, 2, 3), max_new_tokens=3, expected=(7, 8, 9),
                          rng_seed=5)


def _sc_canary_drain(s):
    clock = FakeClock()
    bad, good = FakeReplica(s.ReplicaState, "bad"), FakeReplica(s.ReplicaState, "good")
    probe = s.CanaryProbe([_golden(s)], interval_s=1000.0)
    router = s.ServingRouter([bad, good], canary=probe, clock=clock)
    router.poll()
    bad.push(event="done", rid="canary-1", status="finished", tokens=[7, 99, 9])
    router.poll()
    clock.t += 1001.0
    router.poll()
    good.push(event="done", rid="canary-2", status="finished", tokens=[7, 8, 9])
    router.poll()
    return router, [probe.stats()], [bad, good]


def _sc_canary_ties(s):
    clock = FakeClock()
    bad, good = FakeReplica(s.ReplicaState, "a-bad"), FakeReplica(s.ReplicaState, "b-good")
    probe = s.CanaryProbe([_golden(s)], interval_s=1000.0, drain_on_failure=False)
    router = s.ServingRouter([bad, good], canary=probe, clock=clock)
    router.poll()
    bad.push(event="done", rid="canary-1", status="finished", tokens=[0, 0, 0])
    router.poll()
    req = router.submit(np.asarray([1, 2], np.int32), 2)
    router.poll()
    return router, [req], [bad, good]


def _sc_canary_drop(s):
    clock = FakeClock()
    r0, r1 = FakeReplica(s.ReplicaState, "r0"), FakeReplica(s.ReplicaState, "r1")
    probe = s.CanaryProbe([_golden(s)], interval_s=1000.0)
    router = s.ServingRouter([r0, r1], canary=probe, clock=clock)
    router.poll()
    r0.die()
    router.poll()
    return router, [router.canary_inconclusive, probe.stats()], [r0, r1]


def _sc_canary_inconclusive(s):
    clock = FakeClock()
    r0 = FakeReplica(s.ReplicaState, "r0")
    probe = s.CanaryProbe([_golden(s)], interval_s=1000.0)
    router = s.ServingRouter([r0], canary=probe, clock=clock)
    router.poll()
    r0.push(event="done", rid="canary-1", status="rejected", error="prompt too long")
    router.poll()
    return router, [router.canary_inconclusive, probe.stats()], [r0]


def _sc_slo_pressure(s):
    """A replica burning its ttft window loses dispatch ties; a fatal
    event fails its work over; the engine's rejection is final."""
    clock = FakeClock(0.0)
    slow, fast = FakeReplica(s.ReplicaState, "a-slow"), FakeReplica(s.ReplicaState, "b-fast")
    mon = s.slo.SLOMonitor(s.slo.serving_slos(ttft_threshold_s=0.5), clock=clock, min_events=2)
    router = s.ServingRouter([slow, fast], clock=clock, slo_monitor=mon,
                             slo_eval_interval_s=0.0, max_outstanding_per_replica=8)
    reqs = []
    for i in range(6):
        reqs.append(router.submit(np.asarray([1, 2, 3], np.int32), 2))
        router.poll()
        clock.t += 1.0
        for rep in (slow, fast):
            for p in rep.submitted:
                req = next(r for r in reqs if r.rid == p["rid"])
                if req.status.terminal:
                    continue
                rep.push(event="step", step=1, progress={p["rid"]: [3]})
                rep.push(event="done", rid=p["rid"], status="finished", tokens=[3, 4])
        if i < 3:
            clock.t += 1.0  # the first answers are slow
    router.poll()
    reqs.append(router.submit(np.asarray([5], np.int32), 3))
    router.poll()
    target = slow if reqs[-1].replica == "a-slow" else fast
    target.push(event="done", rid=reqs[-1].rid, status="rejected", error="too long")
    reqs.append(router.submit(np.asarray([6], np.int32), 3))
    router.poll()
    owner = slow if reqs[-1].replica == "a-slow" else fast
    owner.push(event="fatal", error="boom")
    router.poll()
    return router, reqs + [router.last_slo_results, mon.stats()], [slow, fast]


SCENARIOS = {f.__name__[4:]: f for f in (
    _sc_shed, _sc_deadline, _sc_least_outstanding, _sc_failover, _sc_heartbeat,
    _sc_streamed_then_dead, _sc_retry_bound, _sc_drain, _sc_heal_budget, _sc_heal_backoff,
    _sc_heal_decommissioned, _sc_canary_drain, _sc_canary_ties, _sc_canary_drop,
    _sc_canary_inconclusive, _sc_slo_pressure)}


def _run_scenario(s, name):
    router, items, fakes = SCENARIOS[name](s)
    reqs = [x for x in items if hasattr(x, "rid") and hasattr(x, "status")]
    extra = [x for x in items if not (hasattr(x, "rid") and hasattr(x, "status"))]
    rec = _record(s, router, reqs, fakes)
    rec["extra"] = [x.value if hasattr(x, "value") else x for x in extra]
    router.close()
    return rec


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_equals_jax(name):
    want = _run_scenario(J, name)
    got = _run_scenario(T, name)
    assert got == want


@pytest.mark.parametrize("fault", ["no_resume_prefill", "drop_progress"])
def test_router_planted_faults_fail_the_bar(fault, monkeypatch):
    if fault == "no_resume_prefill":  # a failover survivor looks light
        def outstanding_tokens(self, name):
            return sum(r.remaining_tokens for r in self._outstanding(name))
        monkeypatch.setattr(tserving.ServingRouter, "outstanding_tokens", outstanding_tokens)
    else:  # failed-over work resumes from scratch
        real = tserving.ServingRouter._fail_replica

        def _fail_replica(self, rep, reason, now):
            for req in self._outstanding(rep.name):
                req.generated = []
            real(self, rep, reason, now)
        monkeypatch.setattr(tserving.ServingRouter, "_fail_replica", _fail_replica)
    assert _run_scenario(J, "failover") != _run_scenario(T, "failover")


def test_canary_check_and_lattice_fns_equal_jax():
    def checks(s):
        g = s.CanaryGolden("g", (1,), 4, expected=(7, 8, 9, 10))
        return [s.CanaryProbe.check(g, t) for t in
                ([7, 8, 9, 10], [7, 99, 9, 10], [7, 8, 9], [7, 8, 9, 10, 11], [])]

    assert checks(T) == checks(J)
    model = dict(vocab_size=64, dim=32, n_layers=2, n_heads=4, n_kv_heads=2, max_seq_len=64)
    for kw in (dict(slot_buckets=(2,), block_buckets=(4,), prefill_buckets=(32,)),
               dict(slot_buckets=None, block_buckets=None, prefill_buckets=None)):
        specs = [s.ReplicaSpec(model=model, num_blocks=33, block_size=8, max_slots=2, **kw)
                 for s in (J, T)]
        assert T.lattice_fns(specs[1]) == J.lattice_fns(specs[0])


# ---------------------------------------------------------------------------
# the autoscaler over a fake router


class _ScaleReplica:
    def __init__(self, states, name, role="decode", state=None):
        self.name = name
        self.role = role
        self.state = states.HEALTHY if state is None else state
        self.ready_info = {}
        self.stopped = False

    def stop(self):
        self.stopped = True


class _ScaleRouter:
    def __init__(self, states, replicas):
        self.replicas = {r.name: r for r in replicas}
        self.last_slo_results = []
        self.admission = SimpleNamespace(depth=0)
        self._inflight = {}
        self.added, self.drained = [], []
        self._states = states

    def add_replica(self, rep):
        self.replicas[rep.name] = rep
        self.added.append(rep.name)

    def drain(self, name):
        self.replicas[name].state = self._states.DRAINING
        self.drained.append(name)

    def _outstanding(self, name):
        return []


_BURN = {"slo": "ttft", "violating": True, "fast_burn": 20.0, "burn_threshold": 14.4}


def _autoscale_script(s):
    st = s.ReplicaState
    spec = s.ReplicaSpec(model=dict(vocab_size=64, dim=32, n_layers=2, n_heads=4,
                                    n_kv_heads=2, max_seq_len=64))
    out = []

    def policy(**kw):
        base = dict(spawn=lambda name, sp: _ScaleReplica(st, name, state=st.STARTING),
                    min_decode=1, max_decode=3, cooldown_s=30.0, idle_shrink_after_s=10.0)
        base.update(kw)
        return s.AutoscalerPolicy(spec, **base)

    # grow on a burn once, then cool down
    router = _ScaleRouter(st, [_ScaleReplica(st, "p0", role="prefill"), _ScaleReplica(st, "d0")])
    pol = policy()
    router.last_slo_results = [_BURN]
    out += [pol.maybe_act(router, now=0.0), pol.maybe_act(router, now=1.0)]
    router.replicas["scale1"].state = st.HEALTHY
    out += [pol.maybe_act(router, now=5.0), pol.maybe_act(router, now=6.0),
            pol.maybe_act(router, now=31.0), list(router.added), pol.stats()]
    # max_decode
    router = _ScaleRouter(st, [_ScaleReplica(st, f"d{i}") for i in range(3)])
    pol = policy(max_decode=3)
    router.last_slo_results = [_BURN]
    out += [pol.maybe_act(router, now=0.0), pol.stats()]
    # sustained idle shrinks the newest joiner once; no flapping
    router = _ScaleRouter(st, [_ScaleReplica(st, "p0", role="prefill"), _ScaleReplica(st, "d0"),
                               _ScaleReplica(st, "scale9")])
    pol = policy()
    for t, inflight in ((0.0, {}), (9.0, {}), (9.5, {1: 1}), (10.0, {}), (20.5, {}), (25.0, {}),
                        (200.0, {})):
        router._inflight = inflight
        out.append(pol.maybe_act(router, now=t))
    out += [router.drained, router.replicas["scale9"].stopped, pol.stats()]
    # a burn beats a shrink; alternation respects the cooldown
    router = _ScaleRouter(st, [_ScaleReplica(st, "d0")])
    pol = policy(idle_shrink_after_s=5.0)
    router.last_slo_results = [_BURN]
    out.append(pol.maybe_act(router, now=0.0))
    router.replicas["scale1"].state = st.HEALTHY
    out.append(pol.maybe_act(router, now=1.0))
    router.last_slo_results = []
    out += [pol.maybe_act(router, now=t) for t in (2.0, 8.0, 31.0)] + [pol.stats()]
    # a failed join releases the pending slot
    router = _ScaleRouter(st, [_ScaleReplica(st, "d0")])
    pol = policy()
    router.last_slo_results = [_BURN]
    out.append(pol.maybe_act(router, now=0.0))
    router.replicas["scale1"].state = st.DEAD
    out += [pol.maybe_act(router, now=1.0), pol.maybe_act(router, now=31.0), router.added,
            pol.stats()]
    for kw in (dict(min_decode=0), dict(min_decode=3, max_decode=2)):
        try:
            policy(**kw)
            out.append("no error")
        except ValueError as exc:
            out.append(str(exc))
    return out


@pytest.mark.parametrize("fault", [None, "no_cooldown"])
def test_autoscaler_events_equal_jax(fault, monkeypatch):
    if fault:  # planted: scale actions arm no cooldown
        real = tserving.AutoscalerPolicy.__init__

        def init(self, *a, **kw):
            real(self, *a, **kw)
            self.cooldown_s = 0.0
        monkeypatch.setattr(tserving.AutoscalerPolicy, "__init__", init)
    same = _autoscale_script(J) == _autoscale_script(T)
    assert same is (fault is None)


def test_autoscaler_refuses_the_compile_cache_preship():
    spec = tserving.ReplicaSpec(model={})
    with pytest.raises(NotImplementedError, match="item 12"):
        tserving.AutoscalerPolicy(spec, source_cache_dir="/nonexistent")


# ---------------------------------------------------------------------------
# the allocator's handoff addressing and the wire form


def _pager_script(pager):
    alloc = pager.BlockAllocator(9, 4, prefix_caching=True)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 100, 11).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 100, 5)]).astype(np.int32)
    out = [alloc.allocate_with_prefix("a", a)]
    out.append(alloc.chain_hashes("a"))
    out.append(alloc.allocate_with_prefix("b", b))
    out.append(alloc.chain_hashes("b"))
    alloc.free("a")
    foreign = [pager._chain_hash(b"", np.arange(4, dtype=np.int32))]
    foreign.append(pager._chain_hash(foreign[0], np.arange(4, 8, dtype=np.int32)))
    out += [alloc.adopt_block(h) for h in foreign + out[1][:1]]
    out.append(alloc.plan_prefix(np.arange(10, dtype=np.int32)))
    out.append(alloc.stats())
    for h in [pager._chain_hash(foreign[-1], np.full(4, i, np.int32)) for i in range(8)]:
        try:
            out.append(alloc.adopt_block(h))
        except pager.BlockPoolExhausted as exc:
            out.append(str(exc))
    out.append(alloc.stats())
    for call in (lambda: alloc.chain_hashes("a"),
                 lambda: pager.BlockAllocator(4, 2).adopt_block(b"x" * 16)):
        try:
            call()
        except pager.BlockAllocatorError as exc:
            out.append(str(exc))
    return [dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x for x in out]


@pytest.mark.parametrize("fault", [None, "adopt_referenced"])
def test_chain_hashes_and_adopt_block_equal_jax(fault, monkeypatch):
    if fault:  # planted: an adopted block is pinned instead of parked in the LRU
        real = tpager.BlockAllocator.adopt_block

        def adopt_block(self, h):
            blk = real(self, h)
            if blk is not None:
                self._lru.pop(blk)
                self._ref[blk] = 1
            return blk
        monkeypatch.setattr(tpager.BlockAllocator, "adopt_block", adopt_block)
    same = _pager_script(jpager) == _pager_script(tpager)
    assert same is (fault is None)


def _handoff(mod, pager, seed=0, n_tokens=21, bs=8):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, 500, n_tokens).astype(np.int32)
    hashes, prev = [], b""
    for i in range(n_tokens // bs):
        prev = pager._chain_hash(prev, prompt[i * bs:(i + 1) * bs])
        hashes.append(prev)
    shape = (len(hashes), 2, bs, 2, 16)
    # bf16-representable f32 content, as a widened bf16 pool gives
    k = (rng.standard_normal(shape).astype(np.float32).view(np.uint32) & 0xFFFF0000).view(
        np.float32)
    v = (rng.standard_normal(shape).astype(np.float32).view(np.uint32) & 0xFFFF0000).view(
        np.float32)
    import zlib
    crc = zlib.crc32(v.tobytes(), zlib.crc32(k.tobytes()))
    return mod.KVHandoff(prompt=prompt, first_token=7, block_size=bs, hashes=tuple(hashes),
                         k=k, v=v, crc=crc, src_replica="p0")


@pytest.mark.parametrize("n_tokens", [21, 5])
def test_handoff_wire_round_trips_between_packages(n_tokens):
    jw = _handoff(jdisagg, jpager, n_tokens=n_tokens).to_wire()
    tw = _handoff(tdisagg, tpager, n_tokens=n_tokens).to_wire()
    assert tw == jw  # byte for byte, base64 and crc included
    for wire, prompt in ((tw, np.asarray(tw["prompt"], np.int32)),
                         (jw, np.asarray(jw["prompt"], np.int32))):
        for verifier in (jdisagg.KVHandoff, tdisagg.KVHandoff):
            ho, problems = verifier.verify_wire(dict(wire), prompt=prompt)
            assert problems == [] and ho.n_blocks == n_tokens // 8
            assert ho.to_wire() == jw
            # damage in transit and a forged hash are caught by both sides
            for corrupt in (jdisagg.corrupt_wire, tdisagg.corrupt_wire):
                assert verifier.verify_wire(corrupt(dict(wire)), prompt=prompt)[1]
            if wire["hashes"]:
                forged = dict(wire, hashes=["00" * 16] + wire["hashes"][1:])
                assert verifier.verify_wire(forged, prompt=prompt)[1]
            assert verifier.verify_wire(wire, prompt=np.roll(prompt, 1))[1]
            assert verifier.verify_wire({"k": "!"}, prompt=prompt)[1]
    assert tdisagg.corrupt_wire(dict(tw)) == jdisagg.corrupt_wire(dict(jw))


def test_handoff_planted_fault_fails_the_bar(monkeypatch):
    """Planted: the port's wire chains its CRC over v then k."""
    import zlib

    ho = _handoff(tdisagg, tpager)
    ho.crc = zlib.crc32(ho.k.tobytes(), zlib.crc32(ho.v.tobytes()))
    _, problems = jdisagg.KVHandoff.verify_wire(ho.to_wire(), prompt=ho.prompt)
    assert problems and "checksum" in problems[0]


# ---------------------------------------------------------------------------
# warmup


@pytest.fixture(scope="module")
def tiny_params():
    import jax

    from accelerate_tpu.models import transformer as jt
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.models.convert import params_from_numpy

    jp = jt.init_llama(jt.LlamaConfig.tiny(), jax.random.PRNGKey(0))
    return (jt.LlamaConfig.tiny(), jp, tt.LlamaConfig.tiny(),
            params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu"))


_WARM_LATTICE = dict(slot_buckets=(1, 2), block_buckets=(4,), prefill_buckets=(32,))
# the decode engine's dict adds one key (``land_compiles``): one point an axis
_DECODE_LATTICE = dict(slot_buckets=(2,), block_buckets=(4,), prefill_buckets=(32,))
_WARM_KW = dict(num_blocks=33, block_size=8, max_slots=2)


@pytest.fixture(scope="module")
def jax_warmups(tiny_params):
    """JAX's warm-up dicts: a speculating engine with the prefix cache,
    and a decode engine."""
    jcfg, jp, _, _ = tiny_params
    lat = jserving.BucketLattice(**_WARM_LATTICE)
    return (jserving.ServingEngine(jp, jcfg, lattice=lat, spec_tokens=2, draft_layers=1,
                                   **_WARM_KW).warmup(),
            jserving.DecodeEngine(jp, jcfg, lattice=jserving.BucketLattice(**_DECODE_LATTICE),
                                  **_WARM_KW).warmup())


@pytest.mark.parametrize("fault", [None, "no_verify_point"])
def test_warmup_counts_equal_jax(tiny_params, jax_warmups, fault, monkeypatch):
    """One engine with speculation and the prefix cache on a lattice of two
    slot buckets (every key of the reference's dict; two points each of
    decode, draft and verify), and a decode engine (its ``land_compiles``):
    the port's dict is JAX's, and serving afterwards adds no shape."""
    _, _, tcfg, tp = tiny_params
    want, want_decode = jax_warmups
    if fault:  # planted: warmup skips the verify points
        real = tserving.ServingEngine.warmup

        def warmup(self):
            real(self)
            self._shapes["verify"].clear()
            return self.jit_cache_sizes()
        monkeypatch.setattr(tserving.ServingEngine, "warmup", warmup)
    lat = tserving.BucketLattice(**_WARM_LATTICE)
    te = tserving.ServingEngine(tp, tcfg, lattice=lat, spec_tokens=2, draft_layers=1,
                                device="cpu", **_WARM_KW)
    got = te.warmup()
    assert (got == want) is (fault is None)
    if fault:
        return
    assert sum(got.values()) == lat.warmup_points(prefix_cache=True, spec_decode=True)
    te.submit(np.arange(1, 12, dtype=np.int32), 4)
    te.run()
    assert te.jit_cache_sizes() == want
    td = tserving.DecodeEngine(tp, tcfg, lattice=tserving.BucketLattice(**_DECODE_LATTICE),
                               device="cpu", **_WARM_KW)
    assert td.warmup() == want_decode


def test_engine_refuses_the_compile_cache(tiny_params):
    _, _, tcfg, tp = tiny_params
    with pytest.raises(NotImplementedError, match="item 12"):
        tserving.ServingEngine(tp, tcfg, device="cpu", compile_cache_dir="/nonexistent")
