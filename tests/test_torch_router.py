"""The port's front-end router (`repro_torch.serving.router`) against the
reference's, on the CPU at smoke width (f32), on bridged parameters.

Mirrors tests/test_router.py.  The same traffic goes through the
reference's Router and the port's: the merged greedy streams are equal bit
for bit for 1, 2 and 3 replicas, both backends and both load policies, and
under the lockstep executor the port's `dispatch_log` is the reference's
(the policies read the page and queue counters, which equal the
reference's on the same traffic).  least_pages never dispatches a request
its replica cannot reserve at once, and routed streams do not move with
the decode chunk.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

from harness import (CHUNK_AXIS, assert_streams_equal,  # noqa: E402
                     engine_spec, mixed_traffic, run_and_collect)
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import ServingEngine as JEngine  # noqa: E402
from repro_torch.serving import router as router_mod  # noqa: E402
from repro_torch.serving.kv_cache import DenseBackend  # noqa: E402
from repro_torch.serving.router import Router, get_policy  # noqa: E402
from repro_torch.serving.scheduler import (Request,  # noqa: E402
                                           ServingEngine)
from torch_port_harness import (bridged_parts, port_router,  # noqa: E402
                                port_run)

_BACKEND_KW = {
    "dense": {},
    # worst-case lane reservation: min(bucket 32 + max_new 8, 64) = 40
    # tokens = 5 pages of 8; 80-token pools hold two lanes per replica
    "paged": {"cache_backend": "paged", "page_size": 8, "cache_tokens": 80},
}
_ref = {}


@pytest.fixture(scope="module")
def parts():
    return bridged_parts()


def _reference(parts, backend):
    """The reference's bare-engine streams for mixed_traffic, per backend
    (once per module)."""
    if backend not in _ref:
        spec = engine_spec(*parts[0], **_BACKEND_KW[backend])
        _ref[backend] = run_and_collect(spec, mixed_traffic(parts[0][0]))
    return _ref[backend]


def _ref_router(parts, **kw):
    """The reference Router's streams and dispatch_log on mixed_traffic."""
    spec = engine_spec(*parts[0], **kw)
    out, router = run_and_collect(spec, mixed_traffic(parts[0][0]),
                                  max_steps=1000, return_engine=True)
    router.close()
    return out, list(router.dispatch_log), router.steps


# -- construction / policy guards ---------------------------------------------

def test_policy_and_constructor_guards(parts):
    cfg, model, dsg = parts[1]
    with pytest.raises(ValueError):
        get_policy("fastest")
    with pytest.raises(ValueError):
        Router(cfg, model, dsg, n_replicas=0)
    with pytest.raises(ValueError):                 # backend instances are
        Router(cfg, model, dsg, n_replicas=2,       # one-handle objects
               cache_backend=DenseBackend())
    with pytest.raises(ValueError):                 # mode names only
        Router(cfg, model, dsg, n_replicas=2, exec_mode="processes")
    assert router_mod.POLICIES == ("round_robin", "least_queue",
                                   "least_pages")
    assert router_mod.HEALTH_STATES == ("healthy", "suspect", "dead")
    policy = get_policy("least_pages")
    assert get_policy(policy) is policy


def test_replicas_share_one_model(parts):
    """One card holds one copy of the weights: every replica's engine
    reads the caller's model, and each owns its cache and seed."""
    router = port_router(parts[1], n_replicas=3)
    assert all(e.model is parts[1][1] for e in router.engines)
    assert len({id(e.cache.data["k"]) for e in router.engines}) == 3
    assert [e.seed for e in router.engines] == [0, 1, 2]
    assert [e.replica_index for e in router.engines] == [0, 1, 2]


def test_stats_raise_before_any_finish(parts):
    router = port_router(parts[1], n_replicas=2)
    with pytest.raises(ValueError):
        router.throughput()
    assert router.drain() == {}        # nothing queued: drains to nothing


def test_introspection_counters(parts):
    """The counters the policies read equal the reference engine's at every
    point of a paged request's life."""
    (cfg, params, dsg), (tcfg, model, tdsg) = parts
    kw = dict(n_slots=3, max_seq=64, prompt_bucket=32,
              cache_backend="paged", page_size=8, cache_tokens=80)
    eng, jeng = ServingEngine(tcfg, model, tdsg, **kw), JEngine(
        cfg, params, dsg, **kw)

    def counters(e):
        return (e.queue_depth(), e.free_slots(), e.busy_slots(),
                e.free_pages())
    assert counters(eng) == counters(jeng) == (0, 3, 0, 10)
    prompt = np.zeros(12, np.int32)
    req = Request(uid=0, prompt=prompt, max_new=8)
    jreq = JRequest(uid=0, prompt=prompt, max_new=8)
    eng.submit(req)
    jeng.submit(jreq)
    assert counters(eng) == counters(jeng)
    # bucket_for(12) = 16; min(16 + 8, 64) = 24 tokens -> 3 pages of 8
    assert eng.pages_needed(req) == jeng.pages_needed(jreq) == 3
    assert eng.can_admit_request(req) and jeng.can_admit_request(jreq)
    eng.step()
    jeng.step()
    assert counters(eng) == counters(jeng)
    assert len(eng.drain(max_steps=50)) == len(jeng.drain(max_steps=50))
    assert counters(eng) == counters(jeng) == (0, 3, 0, 10)
    dense = ServingEngine(tcfg, model, tdsg, n_slots=2, max_seq=64,
                          prompt_bucket=32, page_size=8)
    # dense lanes own max_seq stripes: 2 free lanes * 64 / 8 pseudo-pages
    assert dense.free_pages() == 2 * 64 // 8


# -- single-replica router == bare engine ----------------------------------------

def test_single_replica_router_bit_identical(parts):
    """One replica behind the router runs a bare engine's admissions on its
    step schedule: greedy and sampled streams equal the bare engine's (the
    sampled ones the port's own: the noise is the port's)."""
    cfg = parts[0][0]
    port = parts[1]
    bare = port_run(engine_spec(*port), mixed_traffic(cfg))
    routed = port_run(engine_spec(*port, n_replicas=1, policy="round_robin"),
                      mixed_traffic(cfg))
    assert_streams_equal(bare, routed, "1-replica router vs bare engine")
    assert_streams_equal(_reference(parts, "dense"), routed, "vs reference")
    kw = dict(n=4, temperature=0.8, top_p=0.9)
    bare_s = port_run(engine_spec(*port, seed=7), mixed_traffic(cfg, **kw))
    routed_s = port_run(engine_spec(*port, seed=7, n_replicas=1,
                                    policy="round_robin"),
                        mixed_traffic(cfg, **kw))
    assert_streams_equal(bare_s, routed_s, "sampled 1-replica router")


# -- replica-count invariance and the dispatch log -------------------------------

@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["round_robin", "least_queue"])
def test_replica_count_invariance(parts, backend, policy):
    """Merged greedy streams for 1, 2 and 3 replicas equal the reference's
    bare engine's, every request is dispatched once to a real replica, and
    the dispatch log and router step count are the reference Router's."""
    ref = _reference(parts, backend)
    for n in (1, 2, 3):
        spec = engine_spec(*parts[1], n_replicas=n, policy=policy,
                           **_BACKEND_KW[backend])
        out, router = port_run(spec, mixed_traffic(parts[0][0]),
                               max_steps=1000, return_engine=True)
        assert_streams_equal(ref, out, f"{backend}/{policy}/{n} replicas")
        uids = [u for u, _ in router.dispatch_log]
        assert sorted(uids) == sorted(ref)
        assert all(0 <= r < n for _, r in router.dispatch_log)
        if n > 1:
            jout, jlog, jsteps = _ref_router(
                parts, n_replicas=n, policy=policy, **_BACKEND_KW[backend])
            assert router.dispatch_log == jlog, (n, router.dispatch_log,
                                                 jlog)
            assert router.steps == jsteps
            assert_streams_equal(jout, out, f"reference router, n={n}")


# -- least_pages admission safety ---------------------------------------------------

def test_least_pages_never_admits_beyond_reservation(parts):
    """least_pages dispatches only to a replica that can reserve the
    request's worst-case pages now, so a dispatched request is admitted on
    the replica's next step; pools of one reservation each force deferral
    at the router.  Streams, dispatch log and steps equal the
    reference's."""
    ref = _reference(parts, "dense")
    kw = dict(n_replicas=2, policy="least_pages", n_slots=2, max_seq=64,
              prompt_bucket=32, admission="overlap", cache_backend="paged",
              page_size=8, cache_tokens=48)
    router = port_router(parts[1], **kw)
    for r in mixed_traffic(parts[0][0]):
        router.submit(Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new))
    while router._busy():
        before = len(router.dispatch_log)
        router.step()
        for uid, rep in router.dispatch_log[before:]:
            assert router.replicas[rep].queue_depth() == 0, (
                f"request {uid} sat deferred in replica {rep}'s queue")
        assert router.steps < 1000
    out = {u: list(r.output) for u, r in router.done().items()}
    assert_streams_equal(ref, out, "least_pages tiny pools")
    assert router.steps > len(router.replicas)
    _, jlog, jsteps = _ref_router(parts, **kw)
    assert router.dispatch_log == jlog
    assert router.steps == jsteps


# -- decode_chunk axis ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_routed_streams_invariant_to_decode_chunk(parts, chunk):
    """A 2-replica router of chunked engines merges the unchunked
    reference's streams, with the reference Router's dispatch log."""
    kw = dict(decode_chunk=chunk, n_replicas=2, policy="round_robin")
    out, router = port_run(engine_spec(*parts[1], **kw),
                           mixed_traffic(parts[0][0]), max_steps=1000,
                           return_engine=True)
    assert_streams_equal(_reference(parts, "dense"), out,
                         f"router decode_chunk={chunk}")
    _, jlog, jsteps = _ref_router(parts, **kw)
    assert router.dispatch_log == jlog
    assert router.steps == jsteps


# -- open-loop traffic and the CLI ---------------------------------------------------

def test_run_open_loop_drives_a_lockstep_router(parts):
    """run_open_loop submits at the arrival offsets through a sequential
    router (the reference's streams), and refuses a threaded one, whose
    drive loop cannot interleave timed submissions."""
    from repro_torch.serving import workload
    reqs = [Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
            for r in mixed_traffic(parts[0][0])]
    arrivals = workload.trace_arrivals([0.0, 0.01, 0.0, 0.02, 0.0, 0.0])
    router = port_router(parts[1], n_replicas=2)
    done = workload.run_open_loop(router, reqs, arrivals)
    assert_streams_equal(_reference(parts, "dense"),
                         {u: list(r.output) for u, r in done.items()},
                         "open loop through a router")
    threaded = port_router(parts[1], n_replicas=2, exec_mode="threaded")
    with pytest.raises(ValueError, match="lockstep"):
        workload.run_open_loop(threaded, reqs, arrivals)
    threaded.close()


@pytest.mark.parametrize("flags,says", [
    (["--replicas", "2", "--exec-mode", "threaded", "--chaos", "kill@1:6"],
     ["/2x least_queue/threaded on cpu] 16 requests",
      "measured parallel makespan", "16 ok, 0 failed",
      "replica health ['healthy', 'healthy']"]),
    (["--replicas", "2", "--route-policy", "round_robin", "--requests", "6",
      "--cache-backend", "paged", "--exec-mode", "sharded",
      "--decode-chunk", "4"],
     ["[overlap/paged/chunk4/2x round_robin/sharded on cpu] 6 requests",
      "measured parallel makespan"]),
    (["--replicas", "3", "--requests", "6", "--dsg-serving",
      "--dsg-threshold-mode", "topk", "--fault-tolerance"],
     ["/3x least_queue/sequential on cpu] 6 requests",
      "modeled parallel makespan", "6 ok, 0 failed, 0 timed out, 0 "
      "retries, 0 fault(s) fired"])])
def test_serve_cli_router_on_cpu(flags, says, capsys):
    from repro_torch.launch import serve
    stats = serve.main(["--device", "cpu", "--smoke", "--workload", "mixed",
                        *flags])
    out = capsys.readouterr().out
    for s in says:
        assert s in out, (s, out)
    assert stats["requests"] == stats["ok_requests"]
