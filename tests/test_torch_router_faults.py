"""The port's fault-tolerant serving (`repro_torch.serving.router`,
`repro_torch.runtime.fault_tolerance`) against the reference's, on the CPU
at smoke width (f32), on bridged parameters.

Mirrors tests/test_router_faults.py and the serving-injector tests of
tests/test_runtime_fault_tolerance.py.  A request replayed from its prompt
on a healthy replica after its replica died decodes the stream an
undisturbed engine decodes, so every failover below is held bitwise to the
reference's fault-free streams; under the lockstep executor the health
events, retries, fail log and the retry budget's outcome equal the
reference Router's on the same faults.  (The engine's eviction, reset and
abort cases are in tests/test_torch_engine_lifecycle.py.)
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

from harness import (CHUNK_AXIS, assert_streams_equal,  # noqa: E402
                     engine_spec, mixed_traffic, run_and_collect)
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FAULT_KINDS, POISON_TOKEN, InjectedFault, ReplicaFault,
    ServingFaultInjector)
from repro_torch.serving.router import (FaultToleranceConfig,  # noqa: E402
                                        as_ft_config)
from repro_torch.serving.scheduler import (EngineAborted,  # noqa: E402
                                           Request)
from repro_torch.serving.workload import (run_workload,  # noqa: E402
                                          warmup_router)
from torch_port_harness import (bridged_parts, port_request,  # noqa: E402
                                port_router, port_run)


@pytest.fixture(scope="module")
def parts():
    return bridged_parts()


@pytest.fixture(scope="module")
def ref_streams(parts):
    """The reference's undisturbed single-engine streams."""
    return run_and_collect(engine_spec(*parts[0]), mixed_traffic(parts[0][0]))


def _streams(done):
    return {u: list(r.output) for u, r in done.items()}


def _pair(parts, faults, reqs=None, max_steps=8000, **kw):
    """The same traffic and faults through the reference Router and the
    port's (sequential executor): (reference router, its results, port
    router, its results)."""
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prompt_bucket", 32)
    cfg, params, dsg = parts[0]
    jr = jrouter.Router(cfg, params, dsg, **kw)
    jinj = jft.ServingFaultInjector(
        [jft.ReplicaFault(f.replica, f.step, f.kind, f.delay_s)
         for f in faults])
    jinj.attach(jr.engines)
    pr = port_router(parts[1], **kw)
    inj = ServingFaultInjector(faults)
    inj.attach(pr.engines)
    assert kw.get("fault_tolerance") in (None, True) or isinstance(
        kw["fault_tolerance"], dict)       # a form both packages read
    reqs = reqs or (lambda: mixed_traffic(cfg))
    for r in reqs():
        jr.submit(r)
    for r in reqs():
        pr.submit(port_request(r))
    jdone = jr.run(max_steps=max_steps)
    done = pr.run(max_steps=max_steps)
    assert inj.log == jinj.log
    return jr, jdone, pr, done


def _same_outcome(jr, jdone, pr, done):
    """Health, events, retries, statuses and the fail log equal."""
    assert [(h.state, h.restarts, [e[:2] for e in h.events])
            for h in pr.health] == [
        (h.state, h.restarts, [e[:2] for e in h.events])
        for h in jr.health]
    assert {u: (r.status, r.retries) for u, r in done.items()} == {
        u: (r.status, r.retries) for u, r in jdone.items()}
    assert [(u, s) for u, s, _ in pr.fail_log] == [
        (u, s) for u, s, _ in jr.fail_log]
    assert pr.dispatch_log == jr.dispatch_log


# -- failover determinism ----------------------------------------------------------

def test_kill_failover_matches_reference(parts, ref_streams):
    """Replica 1 killed mid-decode with no restart: it stays DEAD, its
    requests replay on the survivors, and the merged streams equal the
    fault-free run; health, retries and dispatch equal the reference's."""
    jr, jdone, pr, done = _pair(
        parts, [ReplicaFault(replica=1, step=3)], n_replicas=3,
        policy="round_robin",
        fault_tolerance={"max_replica_restarts": 0, "max_retries": 3})
    assert pr.health[1].state == "dead"
    assert all(r.status == "ok" for r in done.values())
    assert any(r.retries > 0 for r in done.values())
    assert_streams_equal(ref_streams, _streams(done), "kill")
    _same_outcome(jr, jdone, pr, done)


def test_threaded_kill_failover_streams_bitwise_equal(parts, ref_streams):
    """The same kill under the threaded executor: placement follows
    timing, but the merged streams are the fault-free ones."""
    router = port_router(parts[1], n_replicas=3, policy="round_robin",
                         exec_mode="threaded",
                         fault_tolerance=FaultToleranceConfig(
                             max_replica_restarts=0, max_retries=3))
    inj = ServingFaultInjector([ReplicaFault(replica=1, step=3)])
    inj.attach(router.engines)
    for r in mixed_traffic(parts[0][0]):
        router.submit(port_request(r))
    try:
        done = router.run(max_steps=8000)
    finally:
        router.close()
    assert inj.log == [{"replica": 1, "step": 3, "kind": "kill"}]
    assert router.health[1].state == "dead"
    assert all(r.status == "ok" for r in done.values())
    assert_streams_equal(ref_streams, _streams(done), "threaded kill")


@pytest.mark.parametrize("exec_mode", ["sequential", "threaded"])
def test_poison_failover_discards_partial_output(parts, ref_streams,
                                                 exec_mode):
    """A poison fault overwrites the victims' last token before raising, so
    equal streams prove the replay starts from the prompt; the replica
    restarts within the default budget."""
    if exec_mode == "sequential":
        jr, jdone, pr, done = _pair(
            parts, [ReplicaFault(replica=1, step=3, kind="poison")],
            n_replicas=3, policy="round_robin", fault_tolerance=True)
        _same_outcome(jr, jdone, pr, done)
    else:
        pr = port_router(parts[1], n_replicas=3, policy="round_robin",
                         exec_mode=exec_mode, fault_tolerance=True)
        ServingFaultInjector([ReplicaFault(replica=1, step=3,
                                           kind="poison")]).attach(
            pr.engines)
        for r in mixed_traffic(parts[0][0]):
            pr.submit(port_request(r))
        try:
            done = pr.run(max_steps=8000)
        finally:
            pr.close()
    assert pr.health[1].restarts == 1
    assert pr.health[1].state == "healthy"
    assert POISON_TOKEN not in sum(_streams(done).values(), [])
    assert_streams_equal(ref_streams, _streams(done), f"poison {exec_mode}")


def test_restarted_replica_serves_again(parts, ref_streams):
    """Within its budget a killed replica is HEALTHY again and is routed to
    again; the restart logs one transition, as the reference's does."""
    jr, jdone, pr, done = _pair(
        parts, [ReplicaFault(replica=0, step=2)], n_replicas=2,
        policy="round_robin",
        fault_tolerance={"max_replica_restarts": 1})
    assert pr.health[0].state == "healthy" and pr.health[0].restarts == 1
    assert [ev[:2] for ev in pr.health[0].events] == [("healthy", "healthy")]
    assert not pr.fail_log
    assert_streams_equal(ref_streams, _streams(done), "restart")
    _same_outcome(jr, jdone, pr, done)


def test_threaded_stall_timeout_contains_straggler(parts, ref_streams):
    """A delayed worker (0.9 s) trips stall_timeout_s: SUSPECT, abort at the
    next step boundary, restart; the streams are the fault-free ones and
    the healthy replica is never suspected."""
    router = port_router(parts[1], n_replicas=2, policy="round_robin",
                         exec_mode="threaded",
                         fault_tolerance=FaultToleranceConfig(
                             max_replica_restarts=1, stall_timeout_s=0.2))
    warmup_router(router, parts[1][0].vocab)
    inj = ServingFaultInjector(
        [ReplicaFault(replica=1, step=2, kind="delay", delay_s=0.9)])
    inj.attach(router.engines)
    for r in mixed_traffic(parts[0][0]):
        router.submit(port_request(r))
    try:
        done = router.run(max_steps=16000)
    finally:
        router.close()
    assert [h.restarts for h in router.health] == [0, 1]
    assert [ev[1] for ev in router.health[1].events] == ["suspect",
                                                         "healthy"]
    assert any("aborted at step boundary" in f
               for f in router.health[1].failures)
    assert_streams_equal(ref_streams, _streams(done), "stall")


# -- graceful degradation -------------------------------------------------------------

def test_all_replicas_dead_fails_requests_without_hanging(parts):
    jr, jdone, pr, done = _pair(
        parts, [ReplicaFault(replica=0, step=1), ReplicaFault(replica=1,
                                                              step=1)],
        max_steps=400, n_replicas=2, policy="least_queue",
        fault_tolerance={"max_replica_restarts": 0})
    assert set(done) == set(range(6))
    assert all(h.state == "dead" for h in pr.health)
    assert any(r.status == "failed" for r in done.values())
    assert all(r.status in ("ok", "failed") for r in done.values())
    assert all(r.finished > 0 for r in done.values())
    _same_outcome(jr, jdone, pr, done)


@pytest.mark.parametrize("exec_mode", ["sequential", "threaded"])
def test_deadline_expiry_surfaces_timed_out(parts, exec_mode):
    """A queued request whose deadline passes while a long request holds
    the only lane finishes timed_out instead of hanging drain()."""
    cfg = parts[0][0]
    router = port_router(parts[1], n_replicas=1, policy="least_pages",
                         n_slots=1, exec_mode=exec_mode,
                         fault_tolerance=True)
    rng = np.random.default_rng(3)
    long_req = Request(uid=0, prompt=rng.integers(0, cfg.vocab, 8,
                                                  dtype=np.int32),
                       max_new=30)
    late = Request(uid=1, prompt=rng.integers(0, cfg.vocab, 8,
                                              dtype=np.int32),
                   max_new=4, deadline_s=1e-4)
    router.submit(long_req)
    router.submit(late)
    try:
        done = router.drain(max_steps=4000)
    finally:
        router.close()
    assert done[0].status == "ok" and len(done[0].output) == 30
    assert done[1].status == "timed_out" and done[1].output == []
    assert [(u, s) for u, s, _ in router.fail_log] == [(1, "timed_out")]


def test_retry_budget_exhaustion_fails_request(parts):
    """A request whose reservation exceeds the pool keeps crashing its
    replica; past max_retries it fails, as in the reference."""
    cfg = parts[0][0]
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, 24,
                                               dtype=np.int32)
    jr, jdone, pr, done = _pair(
        parts, [], reqs=lambda: [JRequest(uid=0, prompt=prompt, max_new=30)],
        max_steps=400, n_replicas=1, policy="round_robin",
        cache_backend="paged", page_size=8, cache_tokens=16,
        fault_tolerance={"max_replica_restarts": 5, "max_retries": 1})
    assert done[0].status == "failed"
    assert done[0].retries == 2            # initial + 1 retry, then fail
    assert pr.health[0].state == "healthy"
    _same_outcome(jr, jdone, pr, done)


def test_fault_tolerance_off_keeps_fail_fast(parts):
    """Without opting in, an engine stall still raises, with its message."""
    cfg = parts[0][0]
    router = port_router(parts[1], n_replicas=1, policy="round_robin",
                         cache_backend="paged", page_size=8, cache_tokens=16)
    router.submit(Request(uid=0, prompt=np.random.default_rng(5).integers(
        0, cfg.vocab, 24, dtype=np.int32), max_new=30))
    with pytest.raises(RuntimeError, match="engine stalled"):
        router.run(max_steps=400)


# -- health machine and policies --------------------------------------------------------

def test_policies_skip_unhealthy_replicas(parts):
    router = port_router(parts[1], n_replicas=3, policy="round_robin",
                         fault_tolerance=True)
    router._transition(1, "dead", "test")
    req = Request(uid=0, prompt=np.zeros(4, np.int32))
    assert not router.routable(1)
    assert [router.policy.select(router, req) for _ in range(4)] == [0, 2,
                                                                     0, 2]
    router._transition(0, "suspect", "test")
    assert router.policy.select(router, req) == 2
    router._transition(2, "dead", "test")
    assert router.policy.select(router, req) is None


def test_ft_config_validation():
    assert as_ft_config(None) is None
    assert as_ft_config(True) == FaultToleranceConfig()
    assert as_ft_config({"max_retries": 5}).max_retries == 5
    cfg = FaultToleranceConfig(max_replica_restarts=3)
    assert as_ft_config(cfg) is cfg
    with pytest.raises(ValueError):
        as_ft_config("yes")
    with pytest.raises(ValueError):
        FaultToleranceConfig(max_replica_restarts=-1)
    with pytest.raises(ValueError):
        FaultToleranceConfig(max_retries=-1)
    with pytest.raises(ValueError):
        FaultToleranceConfig(stall_timeout_s=0.0)
    assert vars(FaultToleranceConfig()) == vars(
        jrouter.FaultToleranceConfig())


def test_reset_health_revives_replicas(parts):
    cfg = parts[0][0]
    router = port_router(parts[1], n_replicas=2, policy="least_queue",
                         fault_tolerance=FaultToleranceConfig(
                             max_replica_restarts=0))
    inj = ServingFaultInjector([ReplicaFault(replica=0, step=1)])
    inj.attach(router.engines)
    for r in mixed_traffic(cfg):
        router.submit(port_request(r))
    router.run(max_steps=400)
    assert router.health[0].state == "dead"
    router.reset_health()
    assert all(h.state == "healthy" and h.restarts == 0
               for h in router.health)
    assert not router.failed and not router.fail_log
    inj.reset()
    inj.detach(router.engines)
    for r in mixed_traffic(cfg, seed=31):
        router.submit(port_request(r))
    done = router.run(max_steps=400)
    assert all(r.status == "ok" for r in done.values())


def test_engine_abort_names_the_replica(parts):
    router = port_router(parts[1], n_replicas=2)
    eng = router.engines[1]
    eng.abort = True
    with pytest.raises(EngineAborted, match="replica 1 aborted at step "
                                            "boundary"):
        eng.begin_step()
    assert not eng.abort


def test_injector_fires_each_fault_exactly_once(parts):
    router = port_router(parts[1], n_replicas=1)
    eng = router.engines[0]
    inj = ServingFaultInjector([ReplicaFault(replica=0, step=0)])
    inj.attach([eng])
    eng.submit(Request(uid=0, prompt=np.random.default_rng(13).integers(
        0, parts[0][0].vocab, 8, dtype=np.int32), max_new=4))
    with pytest.raises(InjectedFault):
        eng.step()
    done = eng.run(max_steps=100)          # same steps: never fires again
    assert done[0].status == "ok"
    assert len(inj.log) == 1


# -- shutdown ---------------------------------------------------------------------------

def test_threaded_close_idempotent_and_restartable(parts):
    cfg = parts[0][0]
    router = port_router(parts[1], n_replicas=2, policy="least_queue",
                         exec_mode="threaded")
    for r in mixed_traffic(cfg):
        router.submit(port_request(r))
    assert len(router.run(max_steps=8000)) == 6
    router.close()
    router.close()                         # a second close: a no-op
    for r in mixed_traffic(cfg, seed=41):
        router.submit(port_request(r))
    done = router.run(max_steps=8000)          # workers re-staffed
    assert len(done) == 6 and all(r.status == "ok" for r in done.values())
    router.close()


# -- workload integration -------------------------------------------------------------

def test_run_workload_chaos_stats(parts):
    """faults= turns on fault tolerance and the Router path and reports the
    chaos counters."""
    cfg, model, dsg = parts[1]
    reqs = [port_request(r) for r in mixed_traffic(parts[0][0])]
    stats = run_workload(cfg, model, dsg, reqs, n_slots=2, max_seq=64,
                         prompt_bucket=32, replicas=2,
                         route_policy="round_robin",
                         faults=[ReplicaFault(replica=1, step=2)])
    assert stats["faults_fired"] == 1
    assert stats["completed_ok"] == len(reqs)
    assert stats["failed"] == 0 and stats["timed_out"] == 0
    assert stats["retries"] > 0
    assert stats["replica_health"] == ["healthy", "healthy"]
    assert not stats["makespan_measured"]
    assert stats["parallel_tok_per_s"] > 0


@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_kill_failover_invariant_to_decode_chunk(parts, ref_streams, chunk):
    """A kill under fused chunks: the merged streams equal the unchunked
    fault-free reference's for every chunk."""
    streams = port_run(
        engine_spec(*parts[1], decode_chunk=chunk, n_replicas=3,
                    policy="round_robin",
                    fault_tolerance=FaultToleranceConfig(
                        max_replica_restarts=0, max_retries=3)),
        mixed_traffic(parts[0][0]), max_steps=8000,
        faults=[ReplicaFault(replica=1, step=3)])
    assert_streams_equal(ref_streams, streams, f"chaos decode_chunk={chunk}")


# -- the serving injector (tests/test_runtime_fault_tolerance.py) ----------------------

def _fake_engine(replica=0, steps=0, outputs=()):
    slots = [SimpleNamespace(req=SimpleNamespace(output=list(o))
                             if o is not None else None)
             for o in outputs]
    return SimpleNamespace(replica_index=replica, steps=steps,
                           slots=slots, fault_injector=None)


def test_replica_fault_validation():
    assert FAULT_KINDS == jft.FAULT_KINDS == ("kill", "delay", "poison")
    assert POISON_TOKEN == jft.POISON_TOKEN
    with pytest.raises(ValueError, match="unknown fault kind"):
        ReplicaFault(replica=0, step=0, kind="explode")
    with pytest.raises(ValueError, match=">= 0"):
        ReplicaFault(replica=-1, step=0)
    with pytest.raises(ValueError, match=">= 0"):
        ReplicaFault(replica=0, step=-2)
    inj = ServingFaultInjector([(1, 4), (0, 2, "delay", 0.01)])
    assert inj.faults[0] == ReplicaFault(replica=1, step=4)
    assert inj.faults[1].kind == "delay"


def test_serving_injector_keys_on_replica_and_step():
    inj = ServingFaultInjector([ReplicaFault(replica=1, step=3)])
    inj.on_step(_fake_engine(replica=0, steps=3))   # wrong replica
    inj.on_step(_fake_engine(replica=1, steps=2))   # too early
    assert inj.log == []
    with pytest.raises(InjectedFault, match="replica 1 step 3"):
        inj.on_step(_fake_engine(replica=1, steps=5))   # at or past
    assert inj.log == [{"replica": 1, "step": 3, "kind": "kill"}]
    inj.on_step(_fake_engine(replica=1, steps=3))   # exactly once
    assert len(inj.log) == 1
    inj.reset()
    with pytest.raises(InjectedFault):
        inj.on_step(_fake_engine(replica=1, steps=3))


def test_serving_injector_delay_sleeps_without_raising():
    inj = ServingFaultInjector(
        [ReplicaFault(replica=0, step=1, kind="delay", delay_s=0.05)])
    t0 = time.perf_counter()
    inj.on_step(_fake_engine(steps=1))
    assert time.perf_counter() - t0 >= 0.05
    assert inj.log[0]["kind"] == "delay"


def test_serving_injector_poison_corrupts_resident_lanes():
    inj = ServingFaultInjector(
        [ReplicaFault(replica=0, step=2, kind="poison")])
    eng = _fake_engine(steps=2, outputs=([5, 6], None, []))
    with pytest.raises(InjectedFault, match="poison"):
        inj.on_step(eng)
    assert eng.slots[0].req.output == [5, POISON_TOKEN]
    assert eng.slots[2].req.output == []


def test_serving_injector_attach_detach():
    inj = ServingFaultInjector([])
    engines = [_fake_engine(), _fake_engine()]
    inj.attach(engines)
    assert [e.replica_index for e in engines] == [0, 1]
    assert all(e.fault_injector is inj for e in engines)
    other = ServingFaultInjector([])
    other.attach([engines[1]])
    inj.detach(engines)                # only its own hookups
    assert engines[0].fault_injector is None
    assert engines[1].fault_injector is other
