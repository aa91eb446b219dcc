"""The port's engine lifecycle and open-loop traffic against the
reference's, on the CPU at smoke width (f32): wave admission, eviction,
reset, deadlines, abort, the introspection and stats surface, the traffic
generators, the arrival processes and `run_open_loop`.

Mirrors the engine cases of tests/test_router_faults.py (eviction, reset,
abort, deadlines), tests/test_serving.py's stats contracts and the
reference's serving/workload.py generators on the same seeds.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from harness import (assert_streams_equal, engine_spec,  # noqa: E402
                     make_engine_parts, mixed_traffic, run_and_collect)
from repro.serving import workload as jwl  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import scheduler, workload  # noqa: E402
from repro_torch.serving.scheduler import (EngineAborted,  # noqa: E402
                                           Request, ServingEngine)

ENGINE = dict(n_slots=2, max_seq=64, prompt_bucket=32)


@pytest.fixture(scope="module")
def parts():
    """(reference cfg, params, dsg) and the port's (cfg, model, dsg) on the
    same parameters."""
    cfg, params, dsg = make_engine_parts()
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, dsg), device="cpu")
    return (cfg, params, dsg), (tcfg, model, tdsg)


def _engine(parts, **kw):
    cfg, model, dsg = parts[1]
    return ServingEngine(cfg, model, dsg, **{**ENGINE, **kw})


def _port(r):
    return Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                   eos_id=r.eos_id, temperature=r.temperature, top_p=r.top_p,
                   deadline_s=r.deadline_s)


# --- wave admission ----------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_wave_admission_streams_and_steps_match_reference(parts, backend,
                                                          chunk):
    """Wave admission refills only once every lane has drained: the streams
    are the reference's (and overlap's), and the micro-step count is the
    reference's wave count, at least overlap's."""
    cfg = parts[0][0]
    kw = (dict(cache_backend="paged", page_size=8, cache_tokens=160)
          if backend == "paged" else {})
    want, jeng = run_and_collect(
        engine_spec(*parts[0], admission="wave", decode_chunk=chunk, **kw),
        mixed_traffic(cfg), return_engine=True)
    eng = _engine(parts, admission="wave", decode_chunk=chunk, **kw)
    over = _engine(parts, decode_chunk=chunk, **kw)
    for e in (eng, over):
        for r in mixed_traffic(cfg):
            e.submit(_port(r))
        e.run(400)
    got = {u: list(r.output) for u, r in eng.done.items()}
    assert_streams_equal(want, got, f"wave {backend} chunk={chunk}")
    assert got == {u: list(r.output) for u, r in over.done.items()}
    assert eng.steps == jeng.steps >= over.steps
    if chunk == 1:          # a chunk of 8 covers these budgets whole
        assert eng.steps > over.steps


def test_unknown_admission_policy_raises(parts):
    with pytest.raises(ValueError, match="admission"):
        _engine(parts, admission="bogus")


# --- eviction, reset, abort ----------------------------------------------------

def test_evict_request_releases_pages(parts):
    """Mirror of tests/test_router_faults.py::test_evict_request_releases_
    pages: the reservation comes back whole, and the page counts are the
    reference's at every point."""
    cfg, params, dsg = parts[0]
    kw = dict(n_slots=2, max_seq=64, prompt_bucket=32, cache_backend="paged",
              page_size=8, cache_tokens=128)
    eng, jeng = _engine(parts, **kw), JEngine(cfg, params, dsg, **kw)
    pages0 = eng.free_pages()
    assert pages0 == jeng.free_pages()
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, 8, dtype=np.int32)
    req = Request(uid=0, prompt=prompt, max_new=20)
    eng.submit(req)
    jeng.submit(JRequest(uid=0, prompt=prompt, max_new=20))
    eng.step()
    jeng.step()
    assert eng.free_pages() == jeng.free_pages() < pages0
    assert eng.evict_request(0) is req
    jeng.evict_request(0)
    assert eng.free_pages() == jeng.free_pages() == pages0
    assert eng.free_slots() == eng.n_slots
    assert eng.evict_request(0) is None
    assert 0 not in eng.done and req.output      # partial output kept


def test_evict_queued_request_and_free_lane(parts):
    eng = _engine(parts, n_slots=1)
    rng = np.random.default_rng(8)
    reqs = [Request(uid=u, prompt=rng.integers(0, 50, 6, dtype=np.int32),
                    max_new=5) for u in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.queue_depth() == 1 and eng.busy_slots() == 1
    assert eng.evict_request(1) is reqs[1] and eng.queue_depth() == 0
    assert eng.evict_slot(0) is reqs[0] and eng.evict_slot(0) is None


def test_engine_reset_reclaims_in_admission_order(parts):
    eng = _engine(parts)
    rng = np.random.default_rng(9)
    reqs = [Request(uid=u, prompt=rng.integers(0, 50, 8, dtype=np.int32),
                    max_new=20) for u in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    assert eng.busy_slots() == 2 and eng.queue_depth() == 1
    eng.done[99] = Request(uid=99, prompt=np.zeros(1, np.int32))
    reclaimed = eng.reset()
    assert [r.uid for r in reclaimed] == [0, 1, 2]
    assert eng.queue_depth() == 0 and eng.free_slots() == 2
    assert 99 in eng.done


@pytest.mark.parametrize("dsg_on", [False, True], ids=["no_dsg", "dsg"])
def test_reset_engine_serves_the_same_streams(parts, dsg_on):
    """After a reset mid-run (paged, DSG serving on or off) the pool is
    full again, and replaying the reclaimed requests from their prompts
    gives the streams of an undisturbed run."""
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    cfg = parts[0][0]
    kw = dict(cache_backend="paged", page_size=8, cache_tokens=160,
              dsg_serving=DSGServingConfig(2) if dsg_on else None)
    clean = _engine(parts, **kw)
    for r in mixed_traffic(cfg):
        clean.submit(_port(r))
    want = {u: list(r.output) for u, r in clean.run(400).items()}
    eng = _engine(parts, **kw)
    for r in mixed_traffic(cfg):
        eng.submit(_port(r))
    for _ in range(5):
        eng.step()
    reclaimed = eng.reset()
    alloc = eng.backend.allocator
    assert alloc.free_pages == alloc.n_pages - alloc.reserved
    for r in reclaimed:
        r.output.clear()
        eng.submit(r)
    got = {u: list(r.output) for u, r in eng.run(400).items()}
    assert got == want


def test_engine_abort_raises_at_step_boundary(parts):
    eng = _engine(parts)
    rng = np.random.default_rng(11)
    eng.submit(Request(uid=0, prompt=rng.integers(0, 50, 8, dtype=np.int32),
                       max_new=6))
    eng.step()
    eng.abort = True
    with pytest.raises(EngineAborted):
        eng.step()
    assert not eng.abort
    eng.step()
    eng.abort = True
    eng.reset()
    assert not eng.abort


# --- deadlines ------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 8])
def test_lapsed_deadline_retires_timed_out(parts, chunk):
    """A queued request whose deadline lapses while a long request holds
    the only lane retires timed_out with no output at the admission
    boundary, as the reference's engine retires it; the long request and
    a request without a deadline still finish ok."""
    cfg, params, dsg = parts[0]
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32) for _ in range(3)]
    spec = [dict(max_new=30), dict(max_new=4, deadline_s=1e-4),
            dict(max_new=4)]

    def run(engine, req_cls):
        for u, (p, kw) in enumerate(zip(prompts, spec)):
            engine.submit(req_cls(uid=u, prompt=p, **kw))
        time.sleep(0.01)
        return engine.run(max_steps=200)

    done = run(_engine(parts, n_slots=1, decode_chunk=chunk), Request)
    jdone = run(JEngine(cfg, params, dsg, n_slots=1, max_seq=64,
                        prompt_bucket=32, decode_chunk=chunk), JRequest)
    assert {u: r.status for u, r in done.items()} == {
        u: r.status for u, r in jdone.items()} == {0: "ok", 1: "timed_out",
                                                   2: "ok"}
    assert done[1].output == [] and done[1].finished > 0
    assert done[0].output == list(jdone[0].output)
    stats = workload.latency_stats(done)
    assert stats["timed_out_requests"] == 1 and stats["ok_requests"] == 2
    assert stats["failed_requests"] == 0


def test_deadline_not_lapsed_is_admitted(parts):
    eng = _engine(parts)
    eng.submit(Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                       max_new=3, deadline_s=60.0))
    assert eng.run(50)[0].status == "ok"


# --- introspection and stats ---------------------------------------------------

def test_queue_and_slot_introspection_match_reference(parts):
    cfg, params, dsg = parts[0]
    kw = dict(n_slots=2, max_seq=64, prompt_bucket=32)
    eng, jeng = _engine(parts), JEngine(cfg, params, dsg, **kw)
    for r, j in zip(mixed_traffic(cfg, n=4), mixed_traffic(cfg, n=4)):
        eng.submit(_port(r))
        jeng.submit(j)
    seen = []
    while eng.queue_depth() or eng.busy_slots():
        assert (eng.queue_depth(), eng.free_slots(), eng.busy_slots(),
                eng.free_pages()) == (jeng.queue_depth(), jeng.free_slots(),
                                      jeng.busy_slots(), jeng.free_pages())
        seen.append(eng.busy_slots())
        eng.step()
        jeng.step()
    assert max(seen) == 2 and eng.drain() is eng.done


def test_stats_raise_before_any_request_finishes(parts):
    eng = _engine(parts, n_slots=1)
    with pytest.raises(ValueError, match="finished request"):
        eng.throughput()
    with pytest.raises(ValueError, match="decoded token"):
        eng.decode_tok_per_s()
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new=3))
    with pytest.raises(ValueError, match="finished request"):
        eng.throughput()
    eng.run(50)
    assert eng.throughput() > 0.0 and eng.decode_tok_per_s() > 0.0
    lat = eng.latencies()
    assert lat.shape == (1,) and lat[0] > 0


def test_throughput_ignores_pre_run_queue_wait(parts):
    eng = _engine(parts, n_slots=1)
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32),
                       max_new=5))
    eng.queue[0].submitted -= 100.0          # queued long before run()
    eng.run(50)
    assert eng.throughput() > 5 / 100.0


def test_latency_stats_contracts():
    with pytest.raises(ValueError, match="at least one"):
        workload.latency_stats({})
    r = Request(uid=0, prompt=np.zeros(2, np.int32))
    r.status = "timed_out"
    with pytest.raises(ValueError, match="ok"):
        workload.latency_stats({0: r})


# --- traffic and arrivals -------------------------------------------------------

@pytest.mark.parametrize("make,args", [
    ("mixed_requests", dict(temperature=0.7, top_p=0.8)),
    ("skewed_requests", dict(period=3)),
    ("mixed_tenant_requests", dict(temperature=0.5)),
    ("shared_prefix_requests", dict(prompt_len=40, prefix_len=30,
                                    max_new=6))])
def test_traffic_generators_match_reference(make, args):
    """The same seed gives the reference's requests, prompt for prompt."""
    want = getattr(jwl, make)(1000, 9, seed=4, **args)
    got = getattr(workload, make)(1000, 9, seed=4, **args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.uid, g.max_new, g.temperature, g.top_p) == (
            w.uid, w.max_new, w.temperature, w.top_p)
        np.testing.assert_array_equal(g.prompt, w.prompt)


@pytest.mark.parametrize("scenario", ["chat", "batch", "long_context"])
def test_scenario_requests_match_reference(scenario):
    want = jwl.scenario_requests(scenario, 500, 5, seed=2)
    got = workload.scenario_requests(scenario, 500, 5, seed=2)
    assert [(r.max_new, r.prompt.tolist()) for r in got] == [
        (r.max_new, r.prompt.tolist()) for r in want]
    assert workload.SCENARIOS == jwl.SCENARIOS


def test_traffic_generators_validate():
    with pytest.raises(ValueError, match="scenario"):
        workload.scenario_requests("bogus", 10, 1)
    with pytest.raises(ValueError, match="scenario"):
        workload.mixed_tenant_requests(10, 1, scenarios=("chat", "bogus"))
    with pytest.raises(ValueError, match="prefix_len"):
        workload.shared_prefix_requests(10, 1, prompt_len=4, prefix_len=8)


def test_arrivals_match_reference_and_validate():
    np.testing.assert_array_equal(workload.poisson_arrivals(20, 3.0, seed=5),
                                  jwl.poisson_arrivals(20, 3.0, seed=5))
    gaps = [0.0, 0.5, 0.25]
    np.testing.assert_array_equal(workload.trace_arrivals(gaps, start=1.0),
                                  jwl.trace_arrivals(gaps, start=1.0))
    for bad in (lambda: workload.poisson_arrivals(-1, 1.0),
                lambda: workload.poisson_arrivals(3, 0.0),
                lambda: workload.trace_arrivals([[0.1]]),
                lambda: workload.trace_arrivals([0.1, -0.2])):
        with pytest.raises(ValueError):
            bad()


def test_run_open_loop_checks_its_arguments(parts):
    eng = _engine(parts)
    reqs = [Request(uid=u, prompt=np.arange(4, dtype=np.int32), max_new=2)
            for u in range(2)]
    with pytest.raises(ValueError, match="arrival offsets"):
        workload.run_open_loop(eng, reqs, [0.0])
    with pytest.raises(ValueError, match="non-decreasing"):
        workload.run_open_loop(eng, reqs, [0.2, 0.1])
    with pytest.raises(TypeError, match="ServingEngine or a Router"):
        workload.run_open_loop(object(), reqs, [0.0, 0.1])
    eng.submit(Request(uid=9, prompt=np.arange(4, dtype=np.int32),
                       max_new=50))
    with pytest.raises(RuntimeError, match="max_steps"):
        workload.run_open_loop(eng, reqs, [0.0, 0.0], max_steps=3)


def test_run_open_loop_serves_every_request(parts):
    """Requests arrive at their offsets (the engine idles between them):
    each is submitted no earlier than its arrival, every one finishes ok
    with the stream a closed-loop run gives, and a request whose deadline
    lapsed before the engine got to it retires timed_out."""
    cfg = parts[0][0]
    closed = _engine(parts)
    for r in mixed_traffic(cfg, n=4):
        closed.submit(_port(r))
    want = {u: list(r.output) for u, r in closed.run(400).items()}
    reqs = [_port(r) for r in mixed_traffic(cfg, n=4)]
    arrivals = workload.trace_arrivals([0.0, 0.02, 0.0, 0.05])
    t0 = time.perf_counter()
    done = workload.run_open_loop(_engine(parts), reqs, arrivals)
    assert {u: list(r.output) for u, r in done.items()} == want
    assert all(r.status == "ok" for r in done.values())
    for r, at in zip(reqs, arrivals):
        assert r.submitted - t0 >= at - 1e-3
    late = Request(uid=7, prompt=np.arange(5, dtype=np.int32), max_new=3,
                   deadline_s=1e-4)
    late.submitted = time.perf_counter() - 1.0
    done = workload.run_open_loop(_engine(parts), [late], [0.0])
    assert done[7].status == "timed_out"


def test_serve_cli_wave_and_sharing_on_cpu(capsys):
    serve.main(["--device", "cpu", "--smoke", "--workload", "mixed",
                "--requests", "3", "--admission", "wave", "--cache-backend",
                "paged", "--prefix-sharing"])
    out = capsys.readouterr().out
    assert "[wave/paged/shared on cpu] 3 requests" in out
    assert "prefix sharing:" in out


def test_serve_cli_sharing_needs_paged(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--smoke", "--workload", "mixed",
                    "--prefix-sharing"])
    assert exc.value.code != 0
    assert "--cache-backend paged" in capsys.readouterr().err


def test_request_statuses():
    assert scheduler.REQUEST_STATUSES == ("pending", "ok", "failed",
                                          "timed_out")
