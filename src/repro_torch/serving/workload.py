"""Synthetic serving traffic, open-loop arrivals and the measurement
harness (`launch/serve.py --workload mixed` and `chip_smoke.py` drive the
engine and the router through here): `warmup_engine` / `warmup_router`
reach every shape first, then `run_engine` measures; `run_workload` is the
two in one, through one engine or a Router over replicas, with optional
fault tolerance and injected faults.

Open-loop evaluation: a closed-loop drain measures the engine at its own
pace, so queueing delay never shows.  `poisson_arrivals` /
`trace_arrivals` with `run_open_loop` submit requests at wall-clock
offsets whatever the engine's state, and `latency_stats` splits latency
into TTFT (submit -> first token) and TPOT (seconds per token after the
first).  SCENARIOS holds the mixed-tenant presets (chat / batch /
long_context); `shared_prefix_requests` builds the overlapping-prefix
traffic that the paged backend's prefix sharing dedupes.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.runtime.fault_tolerance import ServingFaultInjector
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import Request, ServingEngine


def mixed_requests(vocab: int, n_requests: int, *, seed: int = 0,
                   prompt_range=(8, 192), max_new_range=(8, 64),
                   eos_id=None, temperature: float = 0.0,
                   top_p: float = 1.0) -> List[Request]:
    """Mixed-length traffic: uniform prompt lengths and generation budgets
    over the given ranges, drawn in the reference's rng order."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        max_new = int(rng.integers(max_new_range[0], max_new_range[1] + 1))
        prompt = rng.integers(0, vocab, plen, dtype=np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new,
                            eos_id=eos_id, temperature=temperature,
                            top_p=top_p))
    return reqs


def skewed_requests(vocab: int, n_requests: int, *, period: int = 2,
                    seed: int = 0, heavy_prompt=(96, 160), heavy_new=(40, 56),
                    light_prompt=(8, 24), light_new=(2, 4),
                    eos_id=None) -> List[Request]:
    """Skewed traffic: every `period`-th request is heavy (long prompt,
    long generation), the rest light."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        pr, nr = ((heavy_prompt, heavy_new) if uid % period == 0
                  else (light_prompt, light_new))
        plen = int(rng.integers(pr[0], pr[1] + 1))
        reqs.append(Request(uid=uid,
                            prompt=rng.integers(0, vocab, plen,
                                                dtype=np.int32),
                            max_new=int(rng.integers(nr[0], nr[1] + 1)),
                            eos_id=eos_id))
    return reqs


#: Mixed-tenant scenario presets, in tokens, sized for the default engine
#: limits (max_seq 384, prompt_bucket 256).
SCENARIOS = {
    "chat": dict(prompt_range=(8, 48), max_new_range=(16, 48)),
    "batch": dict(prompt_range=(48, 128), max_new_range=(32, 64)),
    "long_context": dict(prompt_range=(128, 256), max_new_range=(8, 24)),
}


def scenario_requests(scenario: str, vocab: int, n_requests: int, *,
                      seed: int = 0, eos_id=None, temperature: float = 0.0,
                      top_p: float = 1.0) -> List[Request]:
    """Single-tenant traffic drawn from a SCENARIOS preset."""
    try:
        preset = SCENARIOS[scenario]
    except KeyError:
        raise ValueError(f"unknown scenario {scenario!r}; expected one of "
                         f"{sorted(SCENARIOS)}") from None
    return mixed_requests(vocab, n_requests, seed=seed, eos_id=eos_id,
                          temperature=temperature, top_p=top_p, **preset)


def mixed_tenant_requests(vocab: int, n_requests: int, *,
                          scenarios=("chat", "batch", "long_context"),
                          seed: int = 0, eos_id=None,
                          temperature: float = 0.0,
                          top_p: float = 1.0) -> List[Request]:
    """Interleaved multi-tenant traffic: request uid i takes its shape from
    scenarios[i % len(scenarios)]."""
    presets = []
    for s in scenarios:
        if s not in SCENARIOS:
            raise ValueError(f"unknown scenario {s!r}; expected one of "
                             f"{sorted(SCENARIOS)}")
        presets.append(SCENARIOS[s])
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        p = presets[uid % len(presets)]
        plen = int(rng.integers(p["prompt_range"][0],
                                p["prompt_range"][1] + 1))
        max_new = int(rng.integers(p["max_new_range"][0],
                                   p["max_new_range"][1] + 1))
        reqs.append(Request(uid=uid,
                            prompt=rng.integers(0, vocab, plen,
                                                dtype=np.int32),
                            max_new=max_new, eos_id=eos_id,
                            temperature=temperature, top_p=top_p))
    return reqs


def shared_prefix_requests(vocab: int, n_requests: int, *,
                           prompt_len: int = 24, prefix_len: int = 16,
                           max_new: int = 8, seed: int = 0, eos_id=None,
                           temperature: float = 0.0,
                           top_p: float = 1.0) -> List[Request]:
    """Overlapping-prefix traffic: every prompt is `prompt_len` tokens, the
    first `prefix_len` the same (a shared system prompt), the tail unique.
    The length is fixed because only identically padded rows give equal
    page bytes, which is what prefix sharing maps."""
    if not 0 <= prefix_len <= prompt_len:
        raise ValueError(f"need 0 <= prefix_len ({prefix_len}) <= "
                         f"prompt_len ({prompt_len})")
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len, dtype=np.int32)
    reqs = []
    for uid in range(n_requests):
        suffix = rng.integers(0, vocab, prompt_len - prefix_len,
                              dtype=np.int32)
        reqs.append(Request(uid=uid,
                            prompt=np.concatenate([prefix, suffix]),
                            max_new=max_new, eos_id=eos_id,
                            temperature=temperature, top_p=top_p))
    return reqs


# -- open-loop arrivals -------------------------------------------------------

def poisson_arrivals(n: int, rate_rps: float, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process at
    `rate_rps` requests a second."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be positive, got {rate_rps}")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / rate_rps, n))


def trace_arrivals(inter_arrival_s, *, start: float = 0.0) -> np.ndarray:
    """Cumulative arrival offsets from recorded inter-arrival gaps."""
    gaps = np.asarray(inter_arrival_s, dtype=float)
    if gaps.ndim != 1:
        raise ValueError("inter_arrival_s must be a 1-D gap sequence")
    if (gaps < 0).any():
        raise ValueError("inter-arrival gaps must be non-negative")
    return start + np.cumsum(gaps)


def run_open_loop(runner, requests: List[Request], arrivals,
                  *, max_steps: int = 200_000) -> Dict[int, Request]:
    """Drive a ServingEngine, or a Router on a lockstep executor, open-loop:
    request i is submitted at wall-clock offset arrivals[i] whether or not
    there is room, so queueing delay lands in TTFT as a user would see it.
    Between arrivals the loop steps the runner while it has work, else
    sleeps toward the next arrival.  Returns {uid: Request}.  A
    free-running (threaded) router owns its drive loop, so the ticks
    cannot interleave with timed submissions: it raises."""
    is_router = isinstance(runner, Router)
    if not (is_router or isinstance(runner, ServingEngine)):
        raise TypeError(f"run_open_loop drives a ServingEngine or a Router, "
                        f"not {type(runner).__name__}")
    arrivals = np.asarray(arrivals, dtype=float)
    if len(arrivals) != len(requests):
        raise ValueError(f"{len(requests)} requests but {len(arrivals)} "
                         f"arrival offsets")
    if len(arrivals) > 1 and (np.diff(arrivals) < 0).any():
        raise ValueError("arrival offsets must be non-decreasing")
    if is_router and not runner.executor.lockstep:
        raise ValueError(
            f"open-loop driving needs a lockstep runner; executor "
            f"{runner.executor.name!r} free-runs its replicas")

    def busy():
        if is_router:
            return runner._busy()
        return bool(runner.queue) or any(not s.free for s in runner.slots)

    t0 = time.perf_counter()
    i, steps = 0, 0
    while i < len(requests) or busy():
        now = time.perf_counter() - t0
        while i < len(requests) and arrivals[i] <= now:
            runner.submit(requests[i])
            i += 1
        if busy():
            runner.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"open-loop run exceeded max_steps={max_steps} with "
                    f"{i}/{len(requests)} submitted")
        elif i < len(requests):
            # idle: sleep toward the next arrival, polling at least every
            # 10 ms
            time.sleep(min(max(arrivals[i] - now, 0.0), 0.01))
    return runner.done() if is_router else dict(runner.done)


def latency_stats(done: Dict[int, Request]) -> Dict[str, float]:
    """p50/p95 end-to-end latency (submit -> finish) over the requests that
    finished ok, plus TTFT (submit -> first token) and TPOT (seconds per
    token after the first) percentiles where defined.  Failed and
    timed-out requests are counted, not folded into the percentiles.
    Raises when no request finished ok."""
    if not done:
        raise ValueError("latency_stats() needs at least one finished "
                         "request")
    ok = [r for r in done.values() if r.status == "ok"]
    if not ok:
        raise ValueError(f"latency_stats() needs at least one request that "
                         f"finished ok (got {len(done)}, none ok)")
    lat = np.array(sorted(r.finished - r.submitted for r in ok))
    stats = {"p50_s": float(np.percentile(lat, 50)),
             "p95_s": float(np.percentile(lat, 95)),
             "ok_requests": len(ok),
             "failed_requests": sum(r.status == "failed"
                                    for r in done.values()),
             "timed_out_requests": sum(r.status == "timed_out"
                                       for r in done.values())}
    ttft = np.array([r.first_token - r.submitted for r in ok
                     if r.first_token > 0.0])
    if len(ttft):
        stats["ttft_p50_s"] = float(np.percentile(ttft, 50))
        stats["ttft_p95_s"] = float(np.percentile(ttft, 95))
    tpot = np.array([(r.finished - r.first_token) / (len(r.output) - 1)
                     for r in ok if r.first_token > 0.0
                     and len(r.output) > 1])
    if len(tpot):
        stats["tpot_p50_s"] = float(np.percentile(tpot, 50))
        stats["tpot_p95_s"] = float(np.percentile(tpot, 95))
    return stats


def warm_temp_for(requests, warm_temp: float = 0.0) -> float:
    """The warm-up temperature a request list needs: any request that
    samples means the sampling variants must be reached (on the card, the
    sampling graphs captured) before a measured run."""
    return max((r.temperature for r in requests), default=warm_temp)


def warmup_engine(eng: ServingEngine, vocab: int, warm_temp: float = 0.0,
                  max_steps: int = 100_000, requests=None) -> None:
    """Reach every shape a measured run can hit, then reset the engine's
    counters: one throwaway request per prompt bucket (the prefill shapes,
    the decode step and CUDA's own one-time set-up; sampled at `warm_temp`
    when it is above 0, with one greedy request more), then `warm_decode`,
    which captures every fused-chunk graph of a chunked engine on the
    card, the sampling ones too when the traffic samples.  Pass the
    workload's `requests` to derive warm_temp from them (warm_temp_for).
    The engine's counters (its admission draws included), the paged pool's
    peak and its sharing counters start again from the idle state; the
    kernels' launch counters are the caller's to reset."""
    if requests is not None:
        warm_temp = warm_temp_for(requests, warm_temp)
    rng = np.random.default_rng(12345)
    for i, b in enumerate(eng.buckets):
        eng.submit(Request(uid=-1 - i,
                           prompt=rng.integers(0, vocab, b, dtype=np.int32),
                           max_new=2, temperature=warm_temp))
    if warm_temp > 0:
        eng.submit(Request(uid=-1 - len(eng.buckets),
                           prompt=rng.integers(0, vocab, eng.buckets[0],
                                               dtype=np.int32),
                           max_new=2))
    eng.run(max_steps=max_steps)
    eng.warm_decode(sample=warm_temp > 0)
    eng.done.clear()
    # the admission draws too, so that sampled streams after the warm-up
    # are a fresh engine's
    eng.steps = eng.admissions = eng.refresh_steps = eng._draws = 0
    eng.decode_seconds = 0.0
    eng.decode_tokens = 0
    eng.prefill_cache_hits = 0
    if eng.cache.kind == "paged":
        eng.backend.allocator.reset_peak()
        eng.backend.cow_copies = eng.backend.shared_page_hits = 0
    if eng.graphs is not None:
        eng.graphs.replays.clear()


def warmup_router(router: Router, vocab: int, warm_temp: float = 0.0,
                  max_steps: int = 100_000, requests=None) -> None:
    """Warm every replica (`warmup_engine`: on the card each replica
    captures its own graphs), then the executor's own graphs (the sharded
    group step, `executor.warm()`), then zero the router's counters.  The
    engines are warmed directly, which is safe while no drive is in
    flight; every key a threaded drive can meet must be captured here,
    since captures are closed during it.  Pass `requests` to derive
    warm_temp from the traffic (warm_temp_for)."""
    if requests is not None:
        warm_temp = warm_temp_for(requests, warm_temp)
    for eng in router.engines:
        warmup_engine(eng, vocab, warm_temp, max_steps=max_steps)
    router.executor.warm(sample=warm_temp > 0)
    router.reset_counters()


def run_engine(eng: ServingEngine, requests: List[Request], *,
               max_steps: int = 100_000) -> Dict[str, float]:
    """Serve the requests through `eng` and return throughput/latency
    stats; the clock stops after a device synchronisation."""
    for r in requests:
        eng.submit(r)
    t0 = time.perf_counter()
    done = eng.run(max_steps=max_steps)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    return engine_stats(eng, done, wall)


def engine_stats(eng: ServingEngine, done: Dict[int, Request],
                 wall: float) -> Dict[str, float]:
    """Throughput, latency and accounting of a finished run of `eng`."""
    toks = sum(len(r.output) for r in done.values())
    stats = {
        "admission": eng.admission,
        "requests": len(done),
        "tokens": toks,
        "truncated": sum(r.truncated for r in done.values()),
        "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        **latency_stats(done),
        "cache_backend": eng.cache.kind,
        "decode_chunk": eng.decode_chunk,
        "prefix_sharing": eng.prefix_sharing,
        "cache_bytes": int(eng.backend.resident_bytes(eng.cache)),
        "decode_tok_per_s": (eng.decode_tok_per_s()
                             if eng.decode_tokens else 0.0),
        "steps": eng.steps,
        "admissions": eng.admissions,
        "refresh_steps": eng.refresh_steps,
    }
    if eng.cache.kind == "paged":
        stats.update(peak_live_pages=eng.backend.allocator.peak_live,
                     shared_page_hits=eng.backend.shared_page_hits,
                     cow_copies=eng.backend.cow_copies,
                     prefill_cache_hits=eng.prefill_cache_hits)
    if eng.graphs is not None:
        stats.update(graph_replays=sum(eng.graphs.replays.values()),
                     graphs_captured=len(eng.graphs.graphs),
                     capture_s=eng.graphs.capture_seconds,
                     graph_pool_bytes=eng.graphs.pool_bytes)
    return stats


def run_workload(cfg, model, dsg, requests: List[Request], *,
                 admission: str = "overlap", n_slots: int = 4,
                 max_seq: int = 384, prompt_bucket: int = 256,
                 cache_backend: str = "dense", page_size: int = 16,
                 cache_tokens=None, seed: int = 0, replicas: int = 1,
                 route_policy: str = "least_queue",
                 exec_mode: str = "sequential", dsg_serving=None,
                 fault_tolerance=None, faults=None,
                 decode_chunk: int = 1, prefix_sharing: bool = False,
                 max_steps: int = 100_000) -> Dict[str, float]:
    """Run the requests through one ServingEngine (replicas=1, sequential,
    no fault tolerance) or a Router over `replicas` engines on the model's
    device, after the warm-up (sampling variants included when the
    requests sample), and return throughput/latency stats.

    Router runs add `makespan_s` (MODELED under the sequential executor,
    MEASURED under the threaded and sharded ones; `makespan_measured`
    says which), `parallel_tok_per_s` (tokens / makespan), the router's
    steps and each replica's stats.  `faults` (a ReplicaFault list or a
    ServingFaultInjector) injects deterministic faults, attached after
    the warm-up; it turns on the default fault tolerance and the Router
    path, and adds the chaos counters (completed_ok, failed, timed_out,
    retries, replica_health, faults_fired)."""
    engine_kw = dict(n_slots=n_slots, max_seq=max_seq,
                     prompt_bucket=prompt_bucket, admission=admission,
                     cache_backend=cache_backend, page_size=page_size,
                     cache_tokens=cache_tokens, dsg_serving=dsg_serving,
                     decode_chunk=decode_chunk,
                     prefix_sharing=prefix_sharing)
    if faults is not None and fault_tolerance is None:
        fault_tolerance = True
    if (replicas == 1 and exec_mode == "sequential"
            and fault_tolerance is None):
        eng = ServingEngine(cfg, model, dsg, seed=seed, **engine_kw)
        warmup_engine(eng, cfg.vocab, max_steps=max_steps,
                      requests=requests)
        return run_engine(eng, requests, max_steps=max_steps)
    router = Router(cfg, model, dsg, n_replicas=replicas,
                    policy=route_policy, exec_mode=exec_mode, seed=seed,
                    fault_tolerance=fault_tolerance, **engine_kw)
    warmup_router(router, cfg.vocab, max_steps=max_steps, requests=requests)
    injector = None
    if faults is not None:
        injector = (faults if hasattr(faults, "on_step")
                    else ServingFaultInjector(faults))
        injector.attach(router.engines)
    for r in requests:
        router.submit(r)
    try:
        t0 = time.perf_counter()
        done = router.run(max_steps=max_steps)
        if router.engines[0].device.type == "cuda":
            torch.cuda.synchronize(router.engines[0].device)
        wall = time.perf_counter() - t0
    finally:
        # release the worker threads even when the run raises
        router.close()
    return router_stats(router, done, wall, injector)


def router_stats(router: Router, done: Dict[int, Request], wall: float,
                 injector=None) -> Dict[str, float]:
    """Throughput, latency, makespan and per-replica accounting of a
    finished router run, with the chaos counters when fault tolerance is
    on."""
    toks = sum(len(r.output) for r in done.values())
    engines = router.engines
    e0 = engines[0]
    makespan = router.makespan_seconds()
    stats = {
        "admission": e0.admission,
        "cache_backend": e0.cache.kind,
        "replicas": len(engines),
        "decode_chunk": e0.decode_chunk,
        "prefix_sharing": e0.prefix_sharing,
        "requests": len(done),
        "tokens": toks,
        "truncated": sum(r.truncated for r in done.values()),
        "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        **latency_stats(done),
        "route_policy": router.policy.name,
        "exec_mode": router.executor.name,
        "cache_bytes": sum(int(e.backend.resident_bytes(e.cache))
                           for e in engines),
        "decode_tok_per_s": (sum(e.decode_tokens for e in engines)
                             / max(sum(e.decode_seconds for e in engines),
                                   1e-9)),
        # engine decode steps; one router tick steps up to every replica
        "steps": sum(e.steps for e in engines),
        "admissions": sum(e.admissions for e in engines),
        "refresh_steps": sum(e.refresh_steps for e in engines),
        "router_steps": router.steps,
        "makespan_s": makespan,
        "makespan_measured": router.executor.measured,
        "parallel_tok_per_s": toks / max(makespan, 1e-9),
        "per_replica": router.replica_stats(),
    }
    if router.ft is not None:
        stats.update({
            "completed_ok": sum(r.status == "ok" for r in done.values()),
            "failed": sum(r.status == "failed" for r in done.values()),
            "timed_out": sum(r.status == "timed_out"
                             for r in done.values()),
            "retries": sum(r.retries for r in done.values()),
            "replica_health": [h.state for h in router.health],
            "faults_fired": len(injector.log) if injector is not None else 0,
        })
    return stats
