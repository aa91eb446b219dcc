"""Synthetic mixed-length serving traffic and the single-engine measurement
harness (`launch/serve.py --workload mixed` and `chip_smoke.py` drive the
engine through here): `warmup_engine` reaches every shape first, then
`run_engine` measures; `run_workload` is the two in one."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serving.scheduler import Request, ServingEngine


def mixed_requests(vocab: int, n_requests: int, *, seed: int = 0,
                   prompt_range=(8, 192), max_new_range=(8, 64),
                   eos_id=None) -> List[Request]:
    """Mixed-length traffic: uniform prompt lengths and generation budgets
    over the given ranges, drawn in the reference's rng order."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n_requests):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        max_new = int(rng.integers(max_new_range[0], max_new_range[1] + 1))
        prompt = rng.integers(0, vocab, plen, dtype=np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new=max_new,
                            eos_id=eos_id))
    return reqs


def latency_stats(done: Dict[int, Request]) -> Dict[str, float]:
    """p50/p95 end-to-end latency (submit -> finish) over requests that
    finished ok, plus TTFT (submit -> first token) and TPOT (seconds per
    token after the first) percentiles where defined."""
    ok = [r for r in done.values() if r.status == "ok"]
    if not ok:
        raise ValueError("latency_stats() needs at least one request that "
                         "finished ok")
    lat = np.array(sorted(r.finished - r.submitted for r in ok))
    stats = {"p50_s": float(np.percentile(lat, 50)),
             "p95_s": float(np.percentile(lat, 95)),
             "ok_requests": len(ok)}
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


def warmup_engine(eng: ServingEngine, vocab: int,
                  max_steps: int = 100_000) -> None:
    """Reach every shape a measured run can hit, then reset the engine's
    counters: one throwaway request per prompt bucket (the prefill shapes,
    the decode step and CUDA's own one-time set-up), then `warm_decode`,
    which captures every fused-chunk graph of a chunked engine on the
    card.  The kernels' launch counters are the caller's to reset."""
    rng = np.random.default_rng(12345)
    for i, b in enumerate(eng.buckets):
        eng.submit(Request(uid=-1 - i,
                           prompt=rng.integers(0, vocab, b, dtype=np.int32),
                           max_new=2))
    eng.run(max_steps=max_steps)
    eng.warm_decode()
    eng.done.clear()
    eng.steps = eng.admissions = eng.refresh_steps = 0
    eng.decode_seconds = 0.0
    eng.decode_tokens = 0
    if eng.graphs is not None:
        eng.graphs.replays.clear()


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
    toks = sum(len(r.output) for r in done.values())
    stats = {
        "requests": len(done),
        "tokens": toks,
        "truncated": sum(r.truncated for r in done.values()),
        "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        **latency_stats(done),
        "cache_backend": eng.cache.kind,
        "decode_chunk": eng.decode_chunk,
        "cache_bytes": int(eng.backend.resident_bytes(eng.cache)),
        "decode_tok_per_s": (eng.decode_tok_per_s()
                             if eng.decode_tokens else 0.0),
        "steps": eng.steps,
        "admissions": eng.admissions,
        "refresh_steps": eng.refresh_steps,
    }
    if eng.graphs is not None:
        stats.update(graph_replays=sum(eng.graphs.replays.values()),
                     graphs_captured=len(eng.graphs.graphs),
                     capture_s=eng.graphs.capture_seconds,
                     graph_pool_bytes=eng.graphs.pool_bytes)
    return stats


def run_workload(cfg, model, dsg, requests: List[Request], *,
                 n_slots: int = 4, max_seq: int = 384,
                 prompt_bucket: int = 256, cache_backend: str = "dense",
                 page_size: int = 16, cache_tokens=None, dsg_serving=None,
                 decode_chunk: int = 1,
                 max_steps: int = 100_000) -> Dict[str, float]:
    """Run the requests through one ServingEngine on the model's device
    after `warmup_engine`, and return throughput/latency stats."""
    eng = ServingEngine(cfg, model, dsg, n_slots=n_slots, max_seq=max_seq,
                        prompt_bucket=prompt_bucket,
                        cache_backend=cache_backend, page_size=page_size,
                        cache_tokens=cache_tokens, dsg_serving=dsg_serving,
                        decode_chunk=decode_chunk)
    warmup_engine(eng, cfg.vocab, max_steps=max_steps)
    return run_engine(eng, requests, max_steps=max_steps)
