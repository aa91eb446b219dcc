"""The port's replica executors (`repro_torch.serving.parallel_exec`)
against the reference's, on the CPU at smoke width (f32), on bridged
parameters.

Mirrors tests/test_parallel_exec.py.  How the replica group runs (stepped
in sequence, free-running worker threads, one group dispatch) decides only
when and where a request decodes, never what: {sequential, threaded,
sharded} x {dense, paged} x {1, 2, 3} replicas give the reference's bare
engine streams bit for bit, the sharded group at chunk 8 too.
`makespan_seconds()` is modeled under the sequential executor and measured
under the threaded and sharded ones; an engine stall and a router stall
raise in the caller's thread; captures are closed while threads drive; and
an idle paged replica riding a sharded tick writes only the scratch page.
Every threaded drive runs under a step budget, and `close()` joins each
worker within 5 s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

from harness import (assert_streams_equal, engine_spec,  # noqa: E402
                     mixed_traffic, run_and_collect, shared_prefix_traffic)
from repro_torch.serving import cuda_graphs  # noqa: E402
from repro_torch.serving.kv_cache import NULL_PAGE  # noqa: E402
from repro_torch.serving.parallel_exec import (  # noqa: E402
    EXEC_MODES, ReplicaProxy, SequentialExecutor, ShardedExecutor,
    ThreadedExecutor, get_executor)
from repro_torch.serving.router import Router  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402
from torch_port_harness import (bridged_parts, port_request,  # noqa: E402
                                port_router, port_run)

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
    if backend not in _ref:
        spec = engine_spec(*parts[0], **_BACKEND_KW[backend])
        _ref[backend] = run_and_collect(spec, mixed_traffic(parts[0][0]))
    return _ref[backend]


# -- guards and proxy plumbing --------------------------------------------------------

def test_exec_mode_guards(parts):
    cfg, model, dsg = parts[1]
    assert EXEC_MODES == ("sequential", "threaded", "sharded")
    with pytest.raises(ValueError):
        Router(cfg, model, dsg, exec_mode="processes")
    with pytest.raises(ValueError):
        get_executor("processes", [])
    router = port_router(parts[1], n_replicas=2, exec_mode="threaded")
    with pytest.raises(RuntimeError):        # free-running: no lockstep tick
        router.step()
    router.close()
    router.close()                           # idempotent


@pytest.mark.parametrize("mode", EXEC_MODES)
def test_mesh_raises_naming_the_roadmap(parts, mode):
    """Every replica runs on its model's one device: a replica mesh is not
    ported, and asking for one raises instead of being ignored."""
    with pytest.raises(NotImplementedError, match="item 9"):
        port_router(parts[1], n_replicas=2, exec_mode=mode, mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        ShardedExecutor([], mesh=object())


def test_replica_proxy_forwards(parts):
    """Attribute reads and writes through a proxy land on the engine, and
    submit goes through the executor."""
    router = port_router(parts[1], n_replicas=2, n_slots=3)
    proxy = router.replicas[0]
    assert isinstance(proxy, ReplicaProxy)
    assert proxy.engine is router.engines[0]
    assert proxy.n_slots == 3 and proxy.free_slots() == 3
    proxy.steps = 7                          # write-through, not shadowing
    assert router.engines[0].steps == 7
    proxy.submit(Request(uid=0, prompt=np.zeros(4, np.int32), max_new=2))
    assert router.engines[0].queue_depth() == 1
    assert "sequential" in repr(proxy)


# -- executor invariance ------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("exec_mode", EXEC_MODES)
def test_executor_invariance(parts, backend, exec_mode):
    """Merged greedy streams for 1, 2 and 3 replicas under each executor
    equal the reference's bare engine's, and every request is dispatched
    once."""
    ref = _reference(parts, backend)
    for n in (1, 2, 3):
        spec = engine_spec(*parts[1], n_replicas=n, exec_mode=exec_mode,
                           **_BACKEND_KW[backend])
        out, router = port_run(spec, mixed_traffic(parts[0][0]),
                               max_steps=100_000, return_engine=True)
        assert_streams_equal(ref, out, f"{backend}/{exec_mode}/{n} replicas")
        assert sorted(u for u, _ in router.dispatch_log) == sorted(ref)
        if exec_mode == "sharded":
            # lockstep too: the sequential router's dispatch log and steps
            # (tests/test_torch_router.py holds those to the reference's)
            _, seq = port_run(
                engine_spec(*parts[1], n_replicas=n, **_BACKEND_KW[backend]),
                mixed_traffic(parts[0][0]), return_engine=True)
            assert router.dispatch_log == seq.dispatch_log
            assert router.steps == seq.steps


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_sharded_executor_streams_at_chunk_8(parts, backend):
    """The group tick over fused chunks gives the unchunked reference's
    streams; replicas must share one decode_chunk."""
    ref = _reference(parts, backend)
    spec = engine_spec(*parts[1], n_replicas=2, exec_mode="sharded",
                       decode_chunk=8, **_BACKEND_KW[backend])
    out, router = port_run(spec, mixed_traffic(parts[0][0]),
                           max_steps=100_000, return_engine=True)
    assert_streams_equal(ref, out, f"sharded/{backend}/chunk 8")
    assert router.executor.chunk == 8
    with pytest.raises(ValueError, match="homogeneous"):
        ShardedExecutor([router.engines[0],
                         port_router(parts[1]).engines[0]])


def test_idle_paged_replica_writes_only_the_scratch_page(parts):
    """A replica with no work rides a sharded tick on a dummy plan (every
    lane done, mirroring lane 0 at position 0).  An idle paged engine's
    page-table rows are all the scratch page, which is never live and never
    in the prefix index, so across ticks that decode on its sibling every
    other page of its pool keeps its bytes, prefix-shared pages of earlier
    traffic included; the sibling's streams are the reference's."""
    kw = dict(cache_backend="paged", page_size=8, cache_tokens=160,
              prefix_sharing=True)
    router = port_router(parts[1], n_replicas=2, exec_mode="sharded", **kw)
    idle = router.engines[1]
    cfg = parts[0][0]
    for r in shared_prefix_traffic(cfg, n=2):
        idle.submit(port_request(r))
    idle.run(200)
    assert idle.queue_depth() == 0 and idle.free_slots() == idle.n_slots
    table = idle.backend._table
    assert (table == NULL_PAGE).all()
    assert idle.backend.allocator.refcount(NULL_PAGE) == 0
    assert NULL_PAGE not in idle.backend.allocator._index.values()
    pools = {k: idle.cache.data[k].clone() for k in ("pages_k", "pages_v")}
    traffic = mixed_traffic(cfg)
    for r in traffic:
        router.replicas[0].submit(port_request(r))
    while router._busy():
        router.step()
        assert router.steps < 1000
    for k, before in pools.items():
        after = idle.cache.data[k]
        assert torch.equal(after[:, NULL_PAGE + 1:],
                           before[:, NULL_PAGE + 1:]), k
    want = run_and_collect(engine_spec(*parts[0], **kw), traffic)
    got = {u: list(r.output) for u, r in router.engines[0].done.items()}
    assert_streams_equal(want, got, "busy sibling of an idle replica")


# -- measured vs modeled makespan -------------------------------------------------------------

def test_makespan_selection(parts):
    """Sequential: the makespan is modeled as the largest busy time, below
    the serial wall clock.  Threaded and sharded: the measured wall clock.
    reset_counters() zeroes the timing."""
    cfg = parts[0][0]
    spec = engine_spec(*parts[1], n_replicas=2)
    seq_out, seq = port_run(spec, mixed_traffic(cfg), return_engine=True)
    assert isinstance(seq.executor, SequentialExecutor)
    assert not seq.executor.measured
    assert seq.makespan_seconds() == max(seq.busy_seconds) > 0
    assert seq.makespan_seconds() <= seq.executor.wall_seconds
    for mode in ("threaded", "sharded"):
        spec = engine_spec(*parts[1], n_replicas=2, exec_mode=mode)
        out, run = port_run(spec, mixed_traffic(cfg), return_engine=True)
        assert run.executor.measured
        assert run.makespan_seconds() == run.executor.wall_seconds > 0
        assert_streams_equal(seq_out, out, f"makespan test streams ({mode})")
        stats = run.replica_stats()
        assert [s["replica"] for s in stats] == [0, 1]
        assert all(s["health"] == "healthy" and s["busy_s"] > 0
                   for s in stats)
    seq.reset_counters()
    assert seq.executor.wall_seconds == 0
    assert seq.busy_seconds == [0.0, 0.0]
    assert seq.steps == 0 and seq.dispatch_log == []


# -- failure propagation from worker threads ----------------------------------------------------

def test_threaded_engine_stall_surfaces(parts):
    """An engine whose paged pool cannot hold one request's reservation
    raises in its worker; the drive re-raises it in the caller's thread."""
    router = port_router(parts[1], n_replicas=2, policy="round_robin",
                         exec_mode="threaded", cache_backend="paged",
                         page_size=8, cache_tokens=16)
    router.submit(Request(uid=0, prompt=np.zeros(30, np.int32), max_new=16))
    with pytest.raises(RuntimeError, match="stalled"):
        router.run(max_steps=2_000)
    router.close()


def test_threaded_router_stall_detected(parts):
    """least_pages against an impossible reservation: every worker parks
    and the drive raises the router-stall error."""
    router = port_router(parts[1], n_replicas=2, policy="least_pages",
                         exec_mode="threaded", cache_backend="paged",
                         page_size=8, cache_tokens=16)
    router.submit(Request(uid=0, prompt=np.zeros(30, np.int32), max_new=16))
    with pytest.raises(RuntimeError, match="router stalled"):
        router.run(max_steps=2_000)
    router.close()


# -- no capture while threads drive ---------------------------------------------------------------

def test_graph_key_first_met_with_captures_closed_raises():
    """A chunk key met while captures are closed raises before anything
    is captured (a capture synchronises the whole device)."""
    cache = cuda_graphs.GraphCache.__new__(cuda_graphs.GraphCache)
    cache.graphs, cache.capture_open = {}, False
    with pytest.raises(RuntimeError, match="captures are closed"):
        cache.replay((1, 0, False, False), lambda: None)


def test_threaded_drive_closes_captures(parts):
    """The threaded drive closes every engine's graph captures while its
    workers step, and opens them again after."""
    router = port_router(parts[1], n_replicas=2, exec_mode="threaded")
    seen = []

    class Graphs:                     # a chunk-1 engine never replays
        capture_open = True

    for eng in router.engines:
        eng.graphs = Graphs()
        step = eng.step

        def recording(eng=eng, step=step):
            seen.append(eng.graphs.capture_open)
            step()
        eng.step = recording
    for r in mixed_traffic(parts[0][0]):
        router.submit(port_request(r))
    router.run(max_steps=10_000)
    router.close()
    assert seen and not any(seen)
    assert all(e.graphs.capture_open for e in router.engines)
    assert isinstance(router.executor, ThreadedExecutor)
    assert router.executor._streams == [None, None]     # CPU engines
