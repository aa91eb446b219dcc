#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. card   — the card's name and power limit from nvidia-smi.
2. build  — compile the sm_90a kernels from `src/repro_torch/csrc`.
3. serve  — internlm2-1.8b at full width (24 layers, d=2048, F=8192,
            vocab 92544, bf16) with random weights from a seeded
            torch.Generator, DSG serving on (gamma 0.5, refresh 8), paged
            KV (page 16), 4 slots, max_seq 512, prompt bucket 256, serving
            8 mixed-length requests.  The kernels' launch counters are set
            to 0 just before the run and read just after; each kernel must
            have launched once per layer per decode step (paged decode,
            group-CSR FFN) or per admission and refresh step (DRS search),
            and every launch of drs_project, drs_scores, paged decode and
            the CSR FFN must have taken the path its shape plans: at this
            width in bf16, the split paged kernel, the union CSR kernels,
            and for both DRS kernels the wgmma tiles at every admission
            and the GEMV at every refresh step.
4. profile — a short full-width serve run under torch.profiler: the
            device's busy share and device time by kernel.  The trace must
            count each serve-path kernel (split paged decode, the union CSR
            FFN's two kernels, the DRS kernels' wgmma tiles and GEMVs)
            layers x decode steps, admissions or refresh steps times.
5. check  — the smoke model's greedy streams on the card (kernels) equal
            those on the CPU (plain versions).
6. kernels — each kernel against its plain PyTorch version on inputs
            captured from the serve run, in bf16 and in f32 (the DRS kernels
            at both of their serve-path shapes: admission, M = the prompt
            bucket, and refresh, M = the lane count); device times (median
            of 30) of the kernel, the plain version and, where one PyTorch
            call computes the same function, that call; and the least time
            the card could take (bytes at 3.35 TB/s or flops at 989 TFLOP/s,
            whichever is larger).  A device time is the summed duration of
            the kernels one call launches, from torch.profiler's device
            events, which leaves out the device's idle gaps between a
            call's launches; `span_ms` is the time from the call's first
            start to its last end, gaps included; `call_ms` is the
            CUDA-event time around one call, which also holds the host's
            dispatch while the device waits.  The CSR FFN's row also
            times the dense SwiGLU at the same x through torch.matmul: not
            the same function, but the yardstick DSG decode has to beat;
            drs_scores' rows time torch.matmul(fx, fw) alone beside it.
7. dsg_ffn — the tile-masked DSG FFN through `ops.dsg_ffn_full` (DRS
            project -> scores -> per-row top-k mask -> tile-masked FFN) on
            layer 0's FFN input of one 256-token prompt with layer 0's
            weights and DRS state (gamma 0.5, block 128, bm = bf = 128):
            each of the three kernels launches once and the bf16 FFN must
            take the tensor-core path; the composition, the FFN kernel with
            the per-token, the batch-shared (row 0 for every row) and an
            all-zero mask, the tile-skip fractions of the first two (of the
            reference's cells and of the plan's), and the dense SwiGLU at
            the same x as a yardstick that is not the same function.
8. flash  — `ops.flash_attention` on layer 0's q/k/v after RoPE (kv heads
            repeated to 16, folded to (16, S, D)): (a) a 256-token prompt,
            S = T = 256, causal; (b) the last 256 queries of a 2048-token
            prompt against all 2048 keys, causal with offset 1792.  Held
            against the plain version and timed beside
            torch.nn.functional.scaled_dot_product_attention (is_causal in
            (a), the lower-right causal bias in (b)).  Both cases must take
            the tensor-core kernel in bf16.
9. splits — device times of the redesigned kernels at the split counts
            around the ones their plans pick, at the main shapes (flash
            (a) and (b), drs_project at admission; the union CSR FFN's
            gate/up cluster and slice and its down tile and splits, and
            the split paged kernel at 1, 2, 4 and 8 splits, on the serve
            run's captured inputs; the drs_scores GEMV at 1-8 column
            slices of a group and its wgmma tiles at 1, 2 and all row tiles
            a block; the tile-masked FFN at 64- and 128-row gate/up blocks
            and 1-8 F splits of the down projection, on phase 7's inputs),
            through the C entry points (no wrapper counts these launches),
            each output held against the plain version: the measurement
            behind the plans.
10. chunk — phase 3's engine and 8 requests at decode_chunk 8: each chunk
            one replay of a CUDA graph, every key captured by warmup_engine
            first.  Every request finishes ok.  A replay does not call the
            wrappers, so their counters, set to 0 before the run, hold the
            eager launches: the DRS kernels' 24 x admissions, on the wgmma
            path.  The graph cache's captured launches x replays must be
            paged decode's and the CSR FFN's 24 x 8 x replays, on the split
            and union paths, and the DRS kernels' 24 x refresh replays, on
            the GEMV path.  Prints TPOT, TTFT and decode tok/s, the
            replays, graphs, capture seconds and the graph pool's bytes,
            and how many streams equal phase 3's (lanes admit at chunk
            boundaries, and the union CSR FFN sums a lane's down
            projection in an order that depends on its co-resident lanes,
            so bf16 streams may part).
11. bitwise — 4 requests with prompts in one bucket and max_new 32, all
            admitted at step 0 (the same co-scheduling at any chunk): the
            bf16 streams of the chunk-8 graphs equal the eager chunk-1
            streams exactly.
12. dense — the dense KV backend at full width, chunk 1 and chunk 8, 8
            requests: every request ok; TPOT and the KV bytes.
13. profile chunk — phase 4 at chunk 8 with graphs: the busy share beside
            phase 4's eager one, and phase 4's kernel count, which here
            shows that the replays ran the kernels: 24 x 8 x replays for
            the decode kernels, apart from any counter.
14. check chunk — phase 5 over {dense, paged} x {chunk 1, 8} x {DSG serving
            off, on (refresh 8)}: the card's smoke-width f32 streams equal
            the CPU's.
Phases 10-14 run after phase 5; each prints its seconds.

The last line is {"ok": true, "device": {...}}.  It needs no network and
imports nothing of JAX or of the `repro` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

SEED = 0
ARCH = "internlm2-1.8b"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
CAPTURE_STEP = 12                  # decode step whose layer-0 call is kept
TIMING_REPS = 30
WARM_REPS = 10                     # profiled calls before the timed ones:
                                   # the profiler can drop the events of
                                   # the first calls after it starts (7
                                   # of 35 on an H100 80GB HBM3)
CALL_GAP_NS = 3_000_000            # idle device time that ends a call
PROFILE_TRIES = 3                  # traces device_ms takes to find a clean one
# (rtol, atol): in bf16, one ulp of the value (2^-7 relative) plus 4e-3
# for values near zero; in f32, summation order
TOL = {"torch.bfloat16": (8e-3, 4e-3), "torch.float32": (1e-4, 1e-4)}


def fail(msg: str):
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Capture:
    """Wraps an `ops` entry point: passes every call through, counts the
    calls that `when(args)` admits (all by default), tallies them by
    key(args, kwargs) and keeps a clone of the arguments of the admitted
    call number `at`."""

    def __init__(self, fn, at: int, when=None, key=None):
        self.fn, self.at, self.when, self.key = fn, at, when, key
        self.n, self.args, self.kwargs = 0, None, None
        self.tally = Counter()       # admitted calls by key(args)

    def __call__(self, *args, **kwargs):
        import torch
        if self.when is None or self.when(args):
            if self.key is not None:
                self.tally[self.key(args, kwargs)] += 1
            if self.n == self.at:
                self.args = tuple(a.clone() if torch.is_tensor(a) else a
                                  for a in args)
                self.kwargs = dict(kwargs)
            self.n += 1
        return self.fn(*args, **kwargs)


def device_ms(fn) -> tuple:
    """Device time of one call: the summed durations of the kernels and
    copies it launches, from torch.profiler's device events, median over
    the last TIMING_REPS of WARM_REPS + TIMING_REPS profiled calls.  Each
    call ends in a synchronize and 5 ms of idle host, so on the device's
    own clock a call's events form one run, separated from the next by an
    idle gap of over CALL_GAP_NS.  (The profiler's host and device clocks
    are not aligned closely enough to assign events to host-side ranges,
    and it can miss the events of the first calls after it starts, which
    the warm-up calls absorb.)  A trace is taken only if it split into more
    than TIMING_REPS and at most WARM_REPS + TIMING_REPS runs and every
    timed call has the same number of events: a call that lost events, or
    two calls merged into one run, would not.  Up to PROFILE_TRIES traces
    are taken; fails if none passes.  Returns (ms, a note: the median
    call's span from its first start to its last end, which also holds the
    device's idle gaps between its launches; the runs found; the events of
    each timed call; and the kernel names of the median call and their
    durations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(WARM_REPS + TIMING_REPS):
                fn()
                torch.cuda.synchronize()
                time.sleep(0.005)
        spans = sorted(
            (e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)())
        runs, end = [], None
        for s, e, name in spans:
            if end is None or s - end > CALL_GAP_NS:
                runs.append([])
            runs[-1].append((s, e, name))
            end = e if end is None else max(end, e)
        calls = runs[-TIMING_REPS:]
        counts = sorted({len(c) for c in calls})
        seen.append([len(runs), counts])
        if TIMING_REPS < len(runs) <= WARM_REPS + TIMING_REPS \
                and len(counts) == 1:
            break
    else:
        fail(f"no clean device trace in {PROFILE_TRIES} tries: [runs, "
             f"events per timed call] {seen}")
    times = sorted((sum(e - s for s, e, _ in c), i)
                   for i, c in enumerate(calls))
    widths = sorted(max(e for _, e, _ in c) - c[0][0] for c in calls)
    ns, mid = times[len(times) // 2]
    return ns / 1e6, {"span_ms": widths[len(widths) // 2] / 1e6,
                      "runs": len(runs), "events_per_call": counts[0],
                      "tries": len(seen),
                      "kernels": [n[:60] for _, _, n in calls[mid]][:8],
                      "kernel_ns": [e - s for s, e, _ in calls[mid]][:8]}


def time_ms(fn) -> float:
    """Median CUDA-event time around one call, over TIMING_REPS calls after
    a warm-up: the device's time plus whatever host dispatch it waits
    for."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def to_dtype(args, dtype, keep=()):
    """Cast the floating tensors of `args` to dtype, except positions in
    `keep` (masks stay f32)."""
    import torch
    return tuple(a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                 and i not in keep else a for i, a in enumerate(args))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype)]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def paged_cost(q, k_new, v_new, k_pages, v_pages, page_table, pos, *,
               window=0, num_pages=0):
    """Bytes and flops the paged step needs on these inputs: every live
    page read once (mirrored lanes share theirs), the new rows written
    once, 4 * H * D flops per attended position."""
    b, h, d = q.shape
    ps, kv = k_pages.shape[1], k_pages.shape[2]
    max_pages = page_table.shape[1]
    walk = min(num_pages, max_pages) if num_pages else max_pages
    pt, p = page_table.cpu().tolist(), pos.cpu().tolist()
    pages, rows, positions = set(), set(), 0
    for lane in range(b):
        lp = p[lane] // ps
        pages.update(pt[lane][:min(lp, walk - 1) + 1])
        if lp < walk:
            rows.add((pt[lane][lp], p[lane] % ps))
        lo = p[lane] - window + 1 if window > 0 else 0
        positions += min(p[lane], walk * ps - 1) - max(lo, 0) + 1
    el = q.element_size()
    nbytes = (el * (2 * q.numel() + k_new.numel() + v_new.numel()
                    + 2 * kv * d * (len(pages) * ps + len(rows)))
              + 4 * (page_table.numel() + pos.numel()))
    return nbytes, 4.0 * h * d * positions


def csr_cost(x, wg, wu, wd, idx, counts, *, block=128):
    """Bytes and flops of the CSR FFN step: the union of the lanes' active
    groups' weight blocks read once, 6 * d * block flops per lane-group."""
    b, d = x.shape
    ix, cn = idx.cpu().tolist(), counts.cpu().tolist()
    union = {g for lane in range(b) for g in ix[lane][:cn[lane]]}
    el = x.element_size()
    nbytes = el * (2 * x.numel() + 3 * d * block * len(union)) \
        + 4 * (idx.numel() + counts.numel())
    return nbytes, 6.0 * d * block * sum(cn)


def project_cost(x, r):
    m, d = x.shape
    k = r.shape[0]
    return x.element_size() * (m * d + k * d + m * k), 2.0 * m * d * k


def scores_cost(fx, fw, block=128):
    m, k = fx.shape
    f = fw.shape[1]
    return (fx.element_size() * (m * k + k * f) + 4 * m * (f // block),
            2.0 * m * k * f)


def dsg_tile_cost(x, wg, wu, wd, token_mask, *, block=128, bm=128, bf=128):
    """Bytes and flops of the tile-masked FFN: x and out once, the mask,
    3 * d * bf weight elements for each column block live in any row tile,
    6 * d * bm * bf flops per live (row tile, column block) cell."""
    m, d = x.shape
    f = wg.shape[1]
    tile = token_mask.reshape(m // bm, bm, f // bf, bf // block).amax(
        dim=(1, 3)) > 0
    nbytes = (x.element_size() * (2 * m * d
                                  + 3 * d * bf * int(tile.any(dim=0).sum()))
              + token_mask.element_size() * token_mask.numel())
    return nbytes, 6.0 * d * bm * bf * int(tile.sum())


def flash_cost(q, k, v, *, causal=True):
    """Bytes and flops of flash attention: q, k, v and o once, 4 * D flops
    per (query, key) pair that the causal rule leaves."""
    import torch
    bh, s, d = q.shape
    t = k.shape[1]
    pairs = s * t
    if causal:
        pairs = int(torch.ones(s, t, dtype=torch.bool).tril(t - s).sum())
    return (q.element_size() * (2 * q.numel() + k.numel() + v.numel()),
            4.0 * d * bh * pairs)


def check_kernel(name, kernel, plain, cap, cost, library=None, keep=()):
    """Hold `kernel` against `plain` on the captured inputs in bf16 and
    f32 and time both (and `library`) on the bf16 inputs, by device time
    (`ms`) and by events around one call (`call_ms`); the args at
    positions `keep` stay in their dtype."""
    import torch
    row = {}
    for dtype in (torch.bfloat16, torch.float32):
        args = to_dtype(cap.args, dtype, keep)

        def call(fn, args=args):
            fresh = tuple(a.clone() if torch.is_tensor(a) else a
                          for a in args)       # paged pools update in place
            return fn(*fresh, **cap.kwargs)

        got, want = call(kernel), call(plain)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rtol, atol = TOL[str(dtype)]
        err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        if not all(torch.isfinite(g.float()).all() for g in got):
            fail(f"{name}: non-finite output in {dtype}")
        for g, w in zip(got, want):
            if not torch.allclose(g.float(), w.float(), rtol=rtol, atol=atol):
                fail(f"{name}: kernel differs from its plain version in "
                     f"{dtype} (max abs err {err}, rtol {rtol}, atol {atol})")
        key = "max_abs_err" if dtype == torch.bfloat16 else "max_abs_err_f32"
        row[key] = err
        if dtype == torch.bfloat16:
            row["shapes"] = [list(a.shape) for a in cap.args
                             if torch.is_tensor(a)]
            row["tol_bf16"] = [rtol, atol]
            timed = {"": lambda: kernel(*args, **cap.kwargs),
                     "plain_": lambda: plain(*args, **cap.kwargs),
                     "library_": None if library is None
                     else lambda: library(*args)}
            for pre, fn in timed.items():
                if fn is None:
                    row[f"{pre}ms"] = row[f"{pre}span_ms"] = None
                    row[f"{pre}call_ms"] = None
                    continue
                row[f"{pre}ms"], note = device_ms(fn)
                row[f"{pre}span_ms"] = note["span_ms"]
                row[f"{pre}call_ms"] = time_ms(fn)
                row[f"{pre}timing"] = note
            row["bound_ms"], row["bound_by"] = bound(
                *cost(*args, **cap.kwargs), dtype)
        else:
            row["tol_f32"] = [rtol, atol]
    return row


# the kernels a serve run launches on its planned paths (phase 3 holds
# the paths), each once per wrapper call, by the calls that launch them
TRACE_KERNELS = {"paged_split_kernel": "decode",
                 "csr_gate_up_kernel": "decode", "csr_down_kernel": "decode",
                 "project_tc_kernel": "admission",
                 "scores_tc_kernel": "admission",
                 "project_gemv_kernel": "refresh",
                 "scores_gemv_kernel": "refresh"}


def kernel_id(name: str) -> str:
    """A device event's kernel name without namespace, template or
    arguments ("" where it names no `*_kernel`)."""
    import re
    m = re.search(r"\b(\w+_kernel)\b", name)
    return m.group(1) if m else ""


def profile_serve(cfg, model, dsg, eng_kw):
    """A short full-width serve run under torch.profiler, after the
    engine's warm-up outside it: the device's busy time (the union of its
    kernel and copy intervals) over the window from its first to its last
    activity, and device time by kernel name.  The trace also counts the
    serve path's kernels apart from the wrappers' counters: each must have
    run layers x decode micro-steps (chunk x replays in a chunked engine,
    whose kernels run inside graph replays), layers x admissions or
    layers x refresh dispatches times; a trace that misses events (the
    profiler can drop them) is taken again, up to PROFILE_TRIES times,
    and none that counts right is fatal.  Returns None where the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import (mixed_requests, run_engine,
                                              warmup_engine)
    counted = []
    for _ in range(PROFILE_TRIES):
        reqs = mixed_requests(cfg.vocab, 4, seed=SEED + 2,
                              prompt_range=(64, 128), max_new_range=(24, 24))
        eng = ServingEngine(cfg, model, dsg, **eng_kw)
        warmup_engine(eng, cfg.vocab)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stats = run_engine(eng, reqs)
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            return None
        micro = (eng.decode_chunk * stats["graph_replays"]
                 if eng.graphs is not None else stats["steps"])
        calls = {"decode": micro, "admission": stats["admissions"],
                 "refresh": stats["refresh_steps"]}
        want = {k: cfg.n_layers * calls[by] for k, by in TRACE_KERNELS.items()}
        got = Counter(kernel_id(name) for _, _, name in spans)
        got = {k: got[k] for k in TRACE_KERNELS}
        counted.append(got)
        if got == want:
            break
    else:
        fail(f"the device traces of the serve run ({eng_kw}) never count "
             f"the serve path's kernels as expected, {want}: {counted}")
    busy, end, by_name = 0.0, spans[0][0], {}
    for s, e, name in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, n + 1)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"busy_ms": busy / 1e3, "window_ms": window / 1e3,
            "busy_share": busy / window, "wall_s": stats["wall_s"],
            "steps": stats["steps"], "traces": len(counted),
            "trace_kernels": got, "calls": calls,
            "by_kernel": [{"name": n[:80], "ms": t / 1e3, "count": c}
                          for n, (t, c) in top]}


def smoke_streams(device, dsg_serving, cache_backend="paged",
                  decode_chunk=1):
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import mixed_requests
    cfg = configs.get_smoke_config(ARCH)
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    gen = torch.Generator().manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    model = model.to(device)
    dsg = {k: v.to(device) for k, v in dsg.items()}
    eng = ServingEngine(cfg, model, dsg, n_slots=2, max_seq=64,
                        prompt_bucket=32, page_size=8,
                        cache_backend=cache_backend, dsg_serving=dsg_serving,
                        decode_chunk=decode_chunk)
    for r in mixed_requests(cfg.vocab, 6, seed=23, prompt_range=(4, 30),
                            max_new_range=(3, 9)):
        eng.submit(r)
    return {u: r.output for u, r in eng.run(400).items()}


def serve_line(tag, stats) -> str:
    """One line of a serve run's end-to-end numbers."""
    ms = {k: 1e3 * stats[k] for k in ("tpot_p50_s", "tpot_p95_s",
                                      "ttft_p50_s", "ttft_p95_s")}
    return (f"[{tag}] {stats['ok_requests']} of {stats['requests']} ok, "
            f"{stats['tokens']} tokens, decode {stats['decode_tok_per_s']:.2f}"
            f" tok/s; TPOT p50 {ms['tpot_p50_s']:.2f} ms p95 "
            f"{ms['tpot_p95_s']:.2f} ms; TTFT p50 {ms['ttft_p50_s']:.1f} ms "
            f"p95 {ms['ttft_p95_s']:.1f} ms; {stats['steps']} micro-steps, "
            f"{stats['admissions']} admissions, {stats['refresh_steps']} "
            f"refresh dispatches; KV {stats['cache_bytes'] / 1e9:.3f} GB")


def chunked_serve(cfg, model, dsg, eng_kw, wrappers, requests):
    """Phase 10: the fused decode chunk through CUDA graphs at full width.
    warmup_engine captures every key; then the kernels' counters are set
    to 0 and the requests run.  A replay runs its kernels without calling
    the wrappers, so their counters now hold the eager launches (the DRS
    kernels' at admission, on the tc path) and what any capture made
    during the run recorded.  The graph cache's captured launches x
    replays must give paged decode and the CSR FFN layers x chunk x
    replays, on the split and union paths, and the DRS kernels layers x
    refresh replays, on the GEMV path.  Phase 13 counts the same kernels
    in a device trace, apart from any counter.  Returns (stats, launches
    by kernel, graph accounting, streams)."""
    import torch
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import run_engine, warmup_engine
    eng = ServingEngine(cfg, model, dsg, **eng_kw)
    t0 = time.perf_counter()
    warmup_engine(eng, cfg.vocab)
    warm_s = time.perf_counter() - t0
    graphs = eng.graphs
    if graphs is None:
        fail("a chunked engine on the card has no graph cache")
    warmed = set(graphs.graphs)
    paths = {"paged_decode": ("split", "decode"),
             "dsg_ffn_csr": ("union", "decode"),
             "drs_project": ("gemv", "refresh"),
             "drs_scores": ("gemv", "refresh")}
    names = ["launches"] + [f"launches_{p}" for p in ("split", "union",
                                                      "gemv", "tc")]
    for w in wrappers.values():
        for name in [n for n in vars(w) if n.startswith("launches")]:
            setattr(w, name, 0)
    stats = run_engine(eng, requests)
    torch.cuda.synchronize()
    new_keys = [k for k in graphs.graphs if k not in warmed]

    def counts(n, name):
        w = wrappers[n]
        recorded = sum(graphs.captured[k].get((w, name), 0)
                       for k in new_keys)
        return {"eager": getattr(w, name, 0) - recorded,
                "replayed": graphs.launches(w, name)}
    got = {n: {name: counts(n, name) for name in names} for n in wrappers}
    replays = sum(graphs.replays.values())
    chunk = eng_kw["decode_chunk"]
    calls = {"decode": chunk * replays, "refresh": stats["refresh_steps"]}
    admitted = cfg.n_layers * stats["admissions"]
    for n, (path, by) in paths.items():
        if n not in got:
            continue
        replayed = cfg.n_layers * calls[by]
        eager = admitted if by == "refresh" else 0
        want = {"eager": eager, "replayed": replayed}
        if got[n]["launches"] != want or replayed == 0:
            fail(f"{n}: {got[n]['launches']} launches, expected {want}: "
                 f"{cfg.n_layers} layers x {chunk} micro-steps x {replays} "
                 f"replays (decode kernels), {cfg.n_layers} x refresh "
                 f"replays replayed and {cfg.n_layers} x admissions eager "
                 f"(DRS kernels)")
        if got[n][f"launches_{path}"]["replayed"] != replayed or (
                eager and got[n]["launches_tc"]["eager"] != eager):
            fail(f"{n} took {got[n]} by path; the replays must take the "
                 f"{path} path and the admissions tc")
    launches = {n: sum(got[n]["launches"].values()) for n in got}
    acct = {"replays": replays, "graphs_captured": len(graphs.graphs),
            "captured_in_run": len(new_keys),
            "capture_s": graphs.capture_seconds,
            "warmup_s": warm_s, "pool_bytes": graphs.pool_bytes,
            "launches": launches,
            "by_path": {n: {name: c for name, c in g.items()
                            if any(c.values())} for n, g in got.items()},
            "replays_by_key": {str(k): v for k, v in graphs.replays.items()},
            "captured_by_key": {
                str(key): {w.__name__: c for (w, n), c in cap.items()
                           if n == "launches"}
                for key, cap in graphs.captured.items()}}
    if stats["requests"] != len(requests) or \
            stats["ok_requests"] != len(requests):
        fail(f"not every chunked request finished ok: {stats}")
    streams = {u: list(r.output) for u, r in eng.done.items()}
    return stats, launches, acct, streams


def fixed_lane_streams(cfg, model, dsg, eng_kw, chunk):
    """Phase 11: 4 requests whose prompts share one bucket (100-120 tokens,
    bucket 128) with max_new 32, all admitted at step 0 into 4 lanes, so
    the co-scheduling at chunk 1 and chunk `chunk` is the same."""
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import mixed_requests, run_engine
    eng = ServingEngine(cfg, model, dsg, **dict(eng_kw, decode_chunk=chunk))
    reqs = mixed_requests(cfg.vocab, 4, seed=SEED + 4,
                          prompt_range=(100, 120), max_new_range=(32, 32))
    stats = run_engine(eng, reqs)
    if stats["ok_requests"] != 4 or eng.admissions != 4:
        fail(f"the fixed-lane run at chunk {chunk} did not finish: {stats}")
    return {u: list(r.output) for u, r in eng.done.items()}


def capture_layer0(cfg, model, dsg, tokens):
    """One full-width forward over `tokens` (1, S): layer 0's FFN input
    (S, d) and its attention q, k, v after RoPE with the kv heads repeated,
    folded to (H, S, D)."""
    from repro_torch.core import dsg_linear
    from repro_torch.models import attention, transformer
    ffn = Capture(dsg_linear.swiglu_ffn, 0)
    att = Capture(attention.attend_direct, 0)
    dsg_linear.swiglu_ffn, attention.attend_direct = ffn, att
    try:
        transformer.forward(model, dsg, cfg, tokens, last_only=True)
    finally:
        dsg_linear.swiglu_ffn, attention.attend_direct = ffn.fn, att.fn
    if ffn.args is None or att.args is None:
        fail("layer 0's FFN input or attention operands were not captured")
    fold = tuple(a[0].transpose(0, 1).contiguous() for a in att.args[:3])
    return ffn.args[1][0].contiguous(), fold


class Call:
    """Arguments of one kernel call, as `check_kernel` takes them."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


def masks_agree(scores, got, want, keep, dtype) -> int:
    """Rows where the kernels' group mask `got` differs from the plain
    composition's `want`; fail unless every flipped group's plain score
    ties the row's k-th largest score to within the scores' tolerance
    (the kernels and the plain versions sum in another order)."""
    import torch
    thr = torch.topk(scores, keep, dim=-1).values[:, -1:]
    rtol, atol = TOL[str(dtype)]
    flipped = got != want
    near = (scores - thr).abs() <= atol + rtol * thr.abs()
    if bool((flipped & ~near).any()):
        fail(f"dsg_ffn_full: the kernels' mask differs from the plain "
             f"composition's away from a tie in {dtype}")
    return int(flipped.any(dim=-1).sum())


def dsg_ffn_phase(cfg, model, dsg, x):
    """Phase 7: `ops.dsg_ffn_full` at full width; returns the kernels-line
    row of the tile-masked FFN kernel and the kernels' per-token mask.
    Fails unless the bf16 FFN took the tensor-core path."""
    import torch
    from repro_torch.core import drs
    from repro_torch.kernels import drs_search, dsg_ffn, ops
    ffn = model.layers[0].ffn
    w = (ffn.w_gate.data, ffn.w_up.data, ffn.w_down.data)
    r, fw = dsg["r"], dsg["fw"][0].contiguous()
    gamma, block = 0.5, cfg.dsg.block
    drs_cfg = drs.DRSConfig(gamma=gamma, block=block, threshold_mode="topk")
    wrappers = {"drs_project": drs_search.drs_project,
                "drs_scores": drs_search.drs_scores,
                "dsg_ffn": dsg_ffn.dsg_ffn}
    tile_paths = ("tc", "simt")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for p in tile_paths:
        setattr(dsg_ffn.dsg_ffn, f"launches_{p}", 0)
    y = ops.dsg_ffn_full(x, *w, r, fw, gamma=gamma, block=block)
    torch.cuda.synchronize()
    launches = {n: wr.launches for n, wr in wrappers.items()}
    by_path = {p: getattr(dsg_ffn.dsg_ffn, f"launches_{p}")
               for p in tile_paths}
    plan = dsg_ffn.tile_plan(*x.shape, w[0].shape[1], block, x.dtype)
    print(f"[dsg_ffn] ops.dsg_ffn_full x {list(x.shape)} -> {list(y.shape)}; "
          f"launches {launches}, the FFN by path {by_path} (plan "
          f"{plan._asdict()})", flush=True)
    if any(n != 1 for n in launches.values()):
        fail(f"ops.dsg_ffn_full launched {launches}, expected one each")
    if x.dtype == torch.bfloat16 and (plan.path, by_path["tc"]) != ("tc", 1):
        fail(f"the bf16 tile-masked FFN did not take the tensor-core path: "
             f"plan {plan.path}, launches by path {by_path}")
    if y.shape != x.shape or not torch.isfinite(y.float()).all():
        fail("ops.dsg_ffn_full gave a wrong shape or non-finite values")

    keep = drs.keep_groups(fw.shape[1], drs_cfg)
    for dtype in (torch.bfloat16, torch.float32):
        xd, rd, fwd = to_dtype((x, r, fw), dtype)
        wd_ = to_dtype(w, dtype)
        got = ops.dsg_ffn_full(xd, *wd_, rd, fwd, gamma=gamma, block=block)
        mask_k = drs.select_mask(drs_search.drs_scores(
            drs_search.drs_project(xd, rd), fwd, block=block), fw.shape[1],
            drs_cfg)
        scores_p = drs_search.drs_scores_plain(
            drs_search.drs_project_plain(xd, rd), fwd, block=block)
        mask_p = drs.select_mask(scores_p, fw.shape[1], drs_cfg)
        flipped = masks_agree(scores_p, mask_k, mask_p, keep, dtype)
        want = dsg_ffn.dsg_ffn_plain(xd, *wd_, mask_p, block=block)
        same = (mask_k == mask_p).all(dim=-1)
        rtol, atol = TOL[str(dtype)]
        if not torch.allclose(got[same].float(), want[same].float(),
                              rtol=rtol, atol=atol):
            fail(f"ops.dsg_ffn_full differs from the plain composition in "
                 f"{dtype} on rows with equal masks")
        if dtype == x.dtype:
            mask = mask_k
        print(f"[dsg_ffn] {dtype}: dsg_ffn_full agrees with the plain "
              f"composition; {flipped} of {x.shape[0]} rows' masks differ at "
              f"near-ties", flush=True)
        zeros = dsg_ffn.dsg_ffn(xd, *wd_, torch.zeros_like(mask_k),
                                block=block)
        if bool(zeros.any()):
            fail(f"dsg_ffn with an all-zero mask is not exactly zero in "
                 f"{dtype}")
    shared = mask[:1].expand_as(mask).contiguous()
    skip = {n: dsg_ffn.tile_skip_fraction(mk, 128, 128, block)
            for n, mk in (("per_token", mask), ("shared", shared))}
    plan_skip = {n: dsg_ffn.cell_skip_fraction(mk, plan.cell_rows,
                                               plan.cell_cols, block)
                 for n, mk in (("per_token", mask), ("shared", shared))}
    print(f"[dsg_ffn] tile-skip fraction (bm = bf = 128): per-token mask "
          f"{skip['per_token']}, batch-shared mask {skip['shared']}; of the "
          f"plan's {plan.cell_rows} x {plan.cell_cols} cells: "
          f"{plan_skip['per_token']}, {plan_skip['shared']}", flush=True)
    rows = {}
    for n, mk in (("per_token", mask), ("shared", shared)):
        rows[n] = check_kernel(f"dsg_ffn ({n} mask)", dsg_ffn.dsg_ffn,
                               dsg_ffn.dsg_ffn_plain,
                               Call(x, *w, mk, block=block), dsg_tile_cost,
                               keep=(4,))
        print(f"[dsg_ffn] {n} mask: {rows[n]['ms']:.4f} ms on the device, "
              f"{rows[n]['call_ms']:.4f} ms a call (plain "
              f"{rows[n]['plain_ms']:.4f} ms, bound {rows[n]['bound_ms']:.4f}"
              f" ms by {rows[n]['bound_by']}), max abs err bf16 "
              f"{rows[n]['max_abs_err']:.3g} f32 "
              f"{rows[n]['max_abs_err_f32']:.3g}", flush=True)
    rows["per_token"].update(dense_ffn((x, *w)))
    print(f"[dsg_ffn] dense SwiGLU at the same x (not the same function) "
          f"{rows['per_token']['dense_ffn_ms']:.4f} ms on the device",
          flush=True)
    return {"name": "dsg_ffn", "route": "cuda",
            "source": "src/repro_torch/csrc/dsg_ffn.cu",
            "replaces": "src/repro/kernels/dsg_ffn.py:56",
            "launches": launches["dsg_ffn"], "launches_by_path": by_path,
            "path": plan.path, "plan": plan._asdict(), **rows["per_token"],
            "shared_mask": rows["shared"],
            "tile_skip_fraction": skip,
            "plan_cell_skip_fraction": plan_skip}, mask


def flash_phase(cases):
    """Phase 8: `ops.flash_attention` on each case's (q, k, v), causal;
    returns the kernels-line row (case "a" in its main keys).  Fails
    unless every bf16 case took the tensor-core kernel."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import flash_attention as fa, ops
    fa.flash_attention.launches = 0
    fa.flash_attention.launches_tc = 0
    fa.flash_attention.launches_simt = 0
    outs = {n: ops.flash_attention(*c, causal=True) for n, c in cases.items()}
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    paths = {"tc": fa.flash_attention.launches_tc,
             "simt": fa.flash_attention.launches_simt}
    print("[flash] ops.flash_attention " + ", ".join(
        f"({n}) q {list(c[0].shape)} k/v {list(c[1].shape)}"
        for n, c in cases.items()) + f"; launches {launches} {paths}",
        flush=True)
    if launches != len(cases):
        fail(f"flash_attention launched {launches} times, expected "
             f"{len(cases)}")
    if paths["tc"] != sum(c[0].dtype == torch.bfloat16
                          for c in cases.values()):
        fail(f"a bf16 flash case missed the tensor-core kernel: {paths}")
    for n, o in outs.items():
        if o.shape != cases[n][0].shape or not torch.isfinite(o.float()).all():
            fail(f"flash case ({n}) gave a wrong shape or non-finite values")
    rows = {}
    for n, (q, k, v) in cases.items():
        s_len, t_len = q.shape[1], k.shape[1]
        # SDPA's is_causal aligns the mask top-left; the suffix convention
        # is the lower-right causal bias, which its fused backends take
        # without a mask tensor.  They take (B, H, S, D): heads to dim 1.
        kw = (dict(is_causal=True) if s_len == t_len
              else dict(attn_mask=causal_lower_right(s_len, t_len)))
        rows[n] = check_kernel(
            f"flash_attention ({n})", fa.flash_attention,
            fa.flash_attention_plain, Call(q, k, v, causal=True), flash_cost,
            lambda q, k, v, kw=kw: F.scaled_dot_product_attention(
                q[None], k[None], v[None], **kw))
        p = fa.plan(q.shape[0], s_len, t_len, q.shape[2], q.dtype)
        rows[n].update(path=p.path, splits=p.splits, blocks=p.blocks)
        print(f"[flash] case ({n}): {rows[n]['ms']:.4f} ms on the device "
              f"({rows[n]['span_ms']:.4f} ms first start to last end), "
              f"{rows[n]['call_ms']:.4f} ms a call (path {p.path}, "
              f"{p.splits} key splits, {p.blocks} blocks; plain "
              f"{rows[n]['plain_ms']:.4f} ms, SDPA "
              f"{rows[n]['library_ms']:.4f} ms (span "
              f"{rows[n]['library_span_ms']:.4f} ms) / "
              f"{rows[n]['library_call_ms']:.4f} ms a call via "
              f"{rows[n]['library_timing']['kernels']}, bound "
              f"{rows[n]['bound_ms']:.4f} ms by {rows[n]['bound_by']}), max "
              f"abs err bf16 {rows[n]['max_abs_err']:.3g} f32 "
              f"{rows[n]['max_abs_err_f32']:.3g}", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:80",
            "launches": launches, "launches_by_path": paths, **rows["a"],
            "cases": {n: row for n, row in rows.items() if n != "a"}}


def split_sweep(cases, x, r) -> dict:
    """Phase 9: device time of the bf16 tensor-core kernels at other split
    counts than their plans pick: flash attention on each case, causal,
    and drs_project on the admission shape.  The output at every split
    count is held against the plain version.  Returns {shape: {"plan":
    splits, "ms_by_splits": {splits: ms}}}."""
    import math
    import torch
    from repro_torch.kernels import cuda_lib, drs_search
    from repro_torch.kernels import flash_attention as fa
    stream = cuda_lib.stream(x.device)
    f32 = dict(dtype=torch.float32, device=x.device)
    rtol, atol = TOL[str(torch.bfloat16)]
    sweep = {}

    def check(name, splits, got, want):
        if not torch.allclose(got.float(), want.float(), rtol=rtol,
                              atol=atol):
            err = float((got.float() - want.float()).abs().max())
            fail(f"{name} at {splits} splits differs from its plain version "
                 f"(max abs err {err})")

    for n, (q, k, v) in cases.items():
        (bh, s_len, d), t_len = q.shape, k.shape[1]
        n_kt = -(-t_len // fa.TC_KEYS)
        out, by = torch.empty_like(q), {}
        want = fa.flash_attention_plain(q, k, v, causal=True)
        for per in sorted({1, 2, 4, 8, 11, 16, n_kt} & set(range(1, n_kt + 1))):
            splits = -(-n_kt // per)
            acc = torch.empty((splits, bh, s_len, d), **f32)
            ml = torch.empty((splits, bh, s_len, 2), **f32)
            by[splits] = device_ms(lambda: cuda_lib.launch(
                "repro_flash_attention_tc", q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), acc.data_ptr(), ml.data_ptr(),
                bh, s_len, t_len, d, 1, t_len - s_len, 1 / math.sqrt(d), per,
                splits, stream))[0]
            check(f"flash ({n})", splits, out, want)
        sweep[f"flash ({n})"] = {
            "plan": fa.plan(bh, s_len, t_len, d, q.dtype).splits,
            "ms_by_splits": by}
    (m, d), k_ = x.shape, r.shape[0]
    chunks = -(-d // drs_search.TC_TILE)
    out, by = torch.empty((m, k_), dtype=x.dtype, device=x.device), {}
    want = drs_search.drs_project_plain(x, r)
    for per in (1, 2, 3, 4, 8, chunks):
        splits = -(-chunks // per)
        ws = torch.empty((splits, m, k_), **f32)
        by[splits] = device_ms(lambda: cuda_lib.launch(
            "repro_drs_project_tc", x.data_ptr(), r.data_ptr(),
            out.data_ptr(), ws.data_ptr(), m, k_, d, per, splits, stream))[0]
        check("drs_project", splits, out, want)
    sweep[f"drs_project x {list(x.shape)}"] = {
        "plan": drs_search.project_plan(m, k_, d, x.dtype).splits,
        "ms_by_splits": by}
    for name, row in sweep.items():
        print(f"[splits] {name}: plan {row['plan']} splits; device ms by "
              f"splits " + ", ".join(f"{sp}: {ms:.4f}" for sp, ms in
                                      sorted(row["ms_by_splits"].items())),
              flush=True)
    return sweep


def paged_plan(args, kwargs):
    """`paged_attention.plan` for one captured `paged_decode_attention`
    call."""
    from repro_torch.kernels import paged_attention
    q, k_pages, page_table = args[0], args[3], args[5]
    (b, h, d), (ps, kv) = q.shape, k_pages.shape[1:3]
    max_pages = page_table.shape[1]
    num_pages = kwargs.get("num_pages", 0)
    walk = min(num_pages, max_pages) if num_pages else max_pages
    return paged_attention.plan(b, kv, h // kv, d, ps, walk, q.dtype)


def csr_plan(args, kwargs):
    """`dsg_ffn.csr_plan` for one captured `dsg_ffn_csr` call."""
    from repro_torch.kernels import dsg_ffn
    x, wg, idx = args[0], args[1], args[4]
    return dsg_ffn.csr_plan(x.shape[0], x.shape[1], wg.shape[1],
                            idx.shape[1], kwargs.get("block", 128), x.dtype)


def scores_plan(args, kwargs):
    """`drs_search.scores_plan` for one captured `drs_scores` call."""
    from repro_torch.kernels import drs_search
    (m, k), f = args[0].shape, args[1].shape[1]
    return drs_search.scores_plan(m, k, f, kwargs.get("block", 128),
                                  args[0].dtype)


def matmul_yardstick(args) -> dict:
    """Device time of torch.matmul(fx, fw) alone on the scores' inputs:
    not the same function (no ReLU, no group sums, and it writes the
    (M, F) product), but the one library call that does its product."""
    import torch
    fx, fw = args[:2]
    ms, note = device_ms(lambda: torch.matmul(fx, fw))
    return {"matmul_ms": ms, "matmul_span_ms": note["span_ms"],
            "matmul_timing": note,
            "matmul_note": "not the same function: torch.matmul(fx, fw) "
                           "alone"}


def dense_ffn(args) -> dict:
    """Device time of the dense SwiGLU at the CSR step's x through
    torch.matmul: not the same function (every group of every lane), but
    the yardstick that the sparse decode step has to beat on this card."""
    import torch
    import torch.nn.functional as F
    x, wg, wu, wd = args[:4]

    def fn():
        return torch.matmul(F.silu(torch.matmul(x, wg))
                            * torch.matmul(x, wu), wd)
    ms, note = device_ms(fn)
    return {"dense_ffn_ms": ms, "dense_ffn_span_ms": note["span_ms"],
            "dense_ffn_call_ms": time_ms(fn), "dense_ffn_timing": note,
            "dense_ffn_note": "not the same function: the dense SwiGLU "
                              "silu(x@wg)*(x@wu)@wd through torch.matmul"}


def csr_sweep(args, kwargs) -> dict:
    """Phase 9 for the union CSR FFN on the captured bf16 step: device
    time (and the gate/up and down kernels' own times) at gate/up cluster
    sizes 1-8, the column-slice alternative (32 or 64 columns, no or a
    small cluster) and down tiles of 64 and 128 columns at 1-8 group
    splits, each output held against the plain version."""
    import torch
    from repro_torch.kernels import cuda_lib, dsg_ffn
    x, wg, wu, wd, idx, counts = args[:6]
    block = kwargs.get("block", 128)
    (b, d), f, k = x.shape, wg.shape[1], idx.shape[1]
    plan = csr_plan(args, kwargs)
    want = dsg_ffn.dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts, block=block)
    h = torch.empty((max(1, plan.max_union), b, block), dtype=x.dtype,
                    device=x.device)
    out = torch.empty_like(x)
    stream = cuda_lib.stream(x.device)
    rtol, atol = TOL[str(x.dtype)]
    configs = ({(c, plan.slice, plan.tile, plan.splits) for c in (1, 2, 4, 8)}
               | {(c, sl, plan.tile, plan.splits)
                  for c, sl in ((1, 32), (1, 64), (2, 64), (4, 32))
                  if sl <= block}
               | {(plan.cluster, plan.slice, t, sp) for t in (64, 128)
                  for sp in (1, 2, 4, 8) if d % t == 0})
    by = {}
    for c, sl, t, sp in sorted(configs):
        ms, note = device_ms(lambda: cuda_lib.launch(
            "repro_dsg_ffn_csr_union", x.data_ptr(), wg.data_ptr(),
            wu.data_ptr(), wd.data_ptr(), idx.data_ptr(), counts.data_ptr(),
            h.data_ptr(), out.data_ptr(), b, d, f, k, block, plan.lanes, c,
            sl, t, sp, stream))
        if not torch.allclose(out.float(), want.float(), rtol=rtol,
                              atol=atol):
            err = float((out.float() - want.float()).abs().max())
            fail(f"dsg_ffn_csr at cluster {c}, slice {sl}, tile {t}, "
                 f"splits {sp} differs from its plain version (max abs "
                 f"err {err})")
        by[f"cluster {c} slice {sl} tile {t} splits {sp}"] = {
            "ms": ms, "kernel_ns": note["kernel_ns"]}
    print("[splits] dsg_ffn_csr (union): plan cluster "
          f"{plan.cluster} slice {plan.slice} tile {plan.tile} splits "
          f"{plan.splits}; device ms (gate/up + down ns) by config: "
          + "; ".join(f"{n}: {r['ms']:.4f} "
                      f"({'+'.join(map(str, r['kernel_ns']))})"
                      for n, r in by.items()), flush=True)
    return {"plan": plan._asdict(), "ms_by_config": by}


def scores_sweep(refresh_args, admission_args, block) -> dict:
    """Phase 9 for drs_scores on the serve run's captured bf16 inputs:
    the GEMV at the refresh shape with 1, 2, 4 and 8 column slices of a
    group, and the wgmma tiles at the admission shape with one 64-row tile
    a block (a (row tile x group) grid that reads fw's slab once a row
    tile), two, and all of M's row tiles a block (one block a group, fw's
    slab read once); each output held against the plain version."""
    import torch
    from repro_torch.kernels import cuda_lib, drs_search
    out = {}
    for (fx, fw), path, ns in ((refresh_args[:2], "gemv", (1, 2, 4, 8)),
                               (admission_args[:2], "tc",
                                sorted({1, 2, -(-admission_args[0].shape[0]
                                                // 64)}))):
        (m, k), f = fx.shape, fw.shape[1]
        want = drs_search.drs_scores_plain(fx, fw, block=block)
        got = torch.empty_like(want)
        stream = cuda_lib.stream(fx.device)
        plan = drs_search.scores_plan(m, k, f, block, fx.dtype)
        by = {}
        for n in ns:
            by[n] = device_ms(lambda: cuda_lib.launch(
                f"repro_drs_scores_{path}", fx.data_ptr(), fw.data_ptr(),
                got.data_ptr(), m, k, f, block, n, stream))[0]
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
                fail(f"drs_scores ({path}) at {n} differs from its plain "
                     f"version (max abs err "
                     f"{float((got - want).abs().max())})")
        what = "slices a group" if path == "gemv" else "row tiles a block"
        out[f"{path} fx {[m, k]}"] = {
            "plan": plan.slices if path == "gemv" else plan.per,
            "by": what, "ms": by}
        print(f"[splits] drs_scores ({path}) fx {[m, k]}: plan "
              f"{plan._asdict()}; device ms by {what} "
              + ", ".join(f"{n}: {ms:.4f}" for n, ms in by.items()),
              flush=True)
    return out


def tile_sweep(x, wg, wu, wd, mask, block) -> dict:
    """Phase 9 for the tensor-core tile-masked FFN on phase 7's inputs and
    the kernels' per-token mask: device time (and the gate/up and down
    kernels' own times) at 64- and 128-row gate/up blocks and 1, 2, 4 and
    8 F splits of the down projection, each output held against the plain
    version."""
    import torch
    from repro_torch.kernels import cuda_lib, dsg_ffn
    (m, d), f = x.shape, wg.shape[1]
    plan = dsg_ffn.tile_plan(m, d, f, block, x.dtype)
    want = dsg_ffn.dsg_ffn_plain(x, wg, wu, wd, mask, block=block)
    mk = mask.to(torch.float32).contiguous()
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    stream = cuda_lib.stream(x.device)
    rtol, atol = TOL[str(x.dtype)]
    by = {}
    for rows in (64, 128):
        live = torch.empty((-(-m // rows), f // 128), dtype=torch.int32,
                           device=x.device)
        for splits in (1, 2, 4, 8):
            ms, note = device_ms(lambda: cuda_lib.launch(
                "repro_dsg_ffn_tile_tc", x.data_ptr(), wg.data_ptr(),
                wu.data_ptr(), wd.data_ptr(), mk.data_ptr(),
                live.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
                block, rows, splits, stream))
            if not torch.allclose(out.float(), want.float(), rtol=rtol,
                                  atol=atol):
                fail(f"dsg_ffn (tc) at {rows} rows, {splits} splits differs "
                     f"from its plain version (max abs err "
                     f"{float((out.float() - want.float()).abs().max())})")
            by[f"rows {rows} splits {splits}"] = {
                "ms": ms, "kernel_ns": note["kernel_ns"]}
    print(f"[splits] dsg_ffn (tc): plan rows {plan.rows} splits "
          f"{plan.splits}; device ms (gate/up + down ns) by config: "
          + "; ".join(f"{n}: {r['ms']:.4f} "
                      f"({'+'.join(map(str, r['kernel_ns']))})"
                      for n, r in by.items()), flush=True)
    return {"plan": plan._asdict(), "ms_by_config": by}


def paged_sweep(args, kwargs) -> dict:
    """Phase 9 for the split paged kernel on the captured bf16 step:
    device time at 1, 2, 4 and 8 splits, each output held against the
    plain version and each pool against the plain version's writes."""
    import math
    import torch
    from repro_torch.kernels import cuda_lib, paged_attention
    q, k_new, v_new, k_pages, v_pages, page_table, pos = args[:7]
    window, num_pages = kwargs.get("window", 0), kwargs.get("num_pages", 0)
    (b, h, d), (ps, kv) = q.shape, k_pages.shape[1:3]
    max_pages = page_table.shape[1]
    walk = min(num_pages, max_pages) if num_pages else max_pages
    plan = paged_plan(args, kwargs)
    want, k_want, v_want = paged_attention.paged_decode_plain(
        q, k_new, v_new, k_pages.clone(), v_pages.clone(), page_table, pos,
        window=window, num_pages=num_pages)
    rtol, atol = TOL[str(q.dtype)]
    stream = cuda_lib.stream(q.device)
    by = {}
    for splits in (1, 2, 4, 8):
        kp, vp, out = k_pages.clone(), v_pages.clone(), torch.empty_like(q)
        ms, _ = device_ms(lambda: cuda_lib.launch(
            "repro_paged_decode_split", q.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), kp.data_ptr(), vp.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kv,
            h // kv, d, ps, max_pages, walk, window, 1 / math.sqrt(d),
            splits, stream))
        if not (torch.allclose(out.float(), want.float(), rtol=rtol,
                               atol=atol)
                and torch.equal(kp, k_want) and torch.equal(vp, v_want)):
            fail(f"paged_decode at {splits} splits differs from its plain "
                 f"version")
        by[splits] = ms
    print(f"[splits] paged_decode (split): plan {plan.splits} splits "
          f"({plan.blocks} blocks); device ms by splits "
          + ", ".join(f"{sp}: {ms:.4f}" for sp, ms in by.items()),
          flush=True)
    return {"plan": plan.splits, "ms_by_splits": by}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import configs
    from repro_torch.kernels import (cuda_lib, drs_search, dsg_ffn, ops,
                                     paged_attention)
    from repro_torch.models import api
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import (mixed_requests, run_engine,
                                              warmup_engine)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # 2. build
    lib, build_s = cuda_lib.build()
    cuda_lib.library()
    print(f"[build] {lib.name} in {build_s:.2f}s", flush=True)

    # 3. serve at full width
    cfg = configs.get_config(ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] {ARCH}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"F={cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f}B params "
          f"in {cfg.dtype}, init {time.perf_counter() - t0:.2f}s",
          flush=True)
    eng_kw = dict(n_slots=4, max_seq=512, prompt_bucket=256,
                  cache_backend="paged", page_size=16,
                  dsg_serving=DSGServingConfig(refresh_interval=8))
    # every prompt bucket and CUDA's one-time set-up outside the measured run
    eng = ServingEngine(cfg, model, dsg, **eng_kw)
    warmup_engine(eng, cfg.vocab)
    kernels = {"paged_decode": (paged_attention.paged_decode,
                                "paged_decode_attention"),
               "dsg_ffn_csr": (dsg_ffn.dsg_ffn_csr, "dsg_ffn_csr"),
               "drs_project": (drs_search.drs_project, "drs_project"),
               "drs_scores": (drs_search.drs_scores, "drs_scores")}
    drs = ("drs_project", "drs_scores")
    lanes = eng_kw["n_slots"]
    captures, refresh = {}, {}

    def project_path(args, kwargs=None):
        (m, d), k = args[0].shape, args[1].shape[0]
        return drs_search.project_plan(m, k, d, args[0].dtype).path

    def scores_path(args, kwargs=None):
        return scores_plan(args, kwargs or {}).path

    def paged_path(args, kwargs):
        return paged_plan(args, kwargs).path

    def csr_path(args, kwargs):
        return csr_plan(args, kwargs).path

    paths = {"drs_project": (project_path, ("gemv", "tc", "simt")),
             "drs_scores": (scores_path, ("gemv", "tc", "simt")),
             "paged_decode": (paged_path, ("split", "serial")),
             "dsg_ffn_csr": (csr_path, ("union", "lanes"))}
    for name, (_, op) in kernels.items():
        at = cfg.n_layers * CAPTURE_STEP if name not in drs else 0
        captures[name] = Capture(getattr(ops, op), at, key=(
            paths[name][0] if name in paths else None))
        wrapped = captures[name]
        if name in drs:
            # the DRS kernels run at two shapes: M = the prompt bucket at
            # admission (call 0) and M = the lane count at refresh steps
            refresh[name] = wrapped = Capture(
                captures[name], 0, when=lambda a: a[0].shape[0] == lanes)
        setattr(ops, op, wrapped)
    try:
        for name, (wrapper, _) in kernels.items():
            wrapper.launches = 0
            for p in paths.get(name, (None, ()))[1]:
                setattr(wrapper, f"launches_{p}", 0)
        stats = run_engine(eng, mixed_requests(cfg.vocab, 8, seed=SEED))
        launches = {n: w.launches for n, (w, _) in kernels.items()}
        by_path = {n: {p: getattr(kernels[n][0], f"launches_{p}")
                       for p in ps} for n, (_, ps) in paths.items()}
    finally:
        for name, (_, op) in kernels.items():
            setattr(ops, op, captures[name].fn)
    print(f"[serve] {stats['requests']} requests, {stats['tokens']} tokens "
          f"in {stats['wall_s']:.3f}s = {stats['tok_per_s']:.2f} tok/s "
          f"(decode {stats['decode_tok_per_s']:.2f} tok/s); latency p50 "
          f"{stats['p50_s']:.3f}s p95 {stats['p95_s']:.3f}s; "
          f"{stats['steps']} decode steps, {stats['admissions']} "
          f"admissions, {stats['refresh_steps']} refresh steps; KV pool "
          f"{stats['cache_bytes'] / 1e9:.3f} GB; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    print("[serve] stats " + json.dumps(stats), flush=True)
    print(serve_line("serve", stats), flush=True)
    if stats["requests"] != 8 or stats["ok_requests"] != 8:
        fail(f"not every request finished ok: {stats}")
    streams3 = {u: list(r.output) for u, r in eng.done.items()}
    del eng
    by_shape = {"admission": cfg.n_layers * stats["admissions"],
                "refresh": cfg.n_layers * stats["refresh_steps"]}
    want = {"paged_decode": cfg.n_layers * stats["steps"],
            "dsg_ffn_csr": cfg.n_layers * stats["steps"],
            "drs_project": sum(by_shape.values()),
            "drs_scores": sum(by_shape.values())}
    print(f"[serve] launches {launches} (expected {want}); by path "
          f"{by_path}", flush=True)
    for name in kernels:
        if launches[name] != want[name] or not launches[name]:
            fail(f"{name} launched {launches[name]} times on the serve "
                 f"path, expected {want[name]}")
        if captures[name].args is None:
            fail(f"no call of {name} was captured")
    for name in drs:
        got = {"admission": launches[name] - refresh[name].n,
               "refresh": refresh[name].n}
        if got != by_shape or refresh[name].args is None:
            fail(f"{name} launched {got} times by shape, expected "
                 f"{by_shape}")
    # each call took the path its shape plans: drs_project's admission
    # shape the wgmma tiles and its refresh shape the GEMV; every paged
    # step the split kernel and every CSR FFN step the union kernels
    for name, (_, ps) in paths.items():
        planned = {p: captures[name].tally[p] for p in ps}
        if by_path[name] != planned:
            fail(f"{name} launched {by_path[name]} by path on the serve "
                 f"run, its shapes plan {planned}")
    # every admission launch of the DRS kernels took the wgmma tiles and
    # every refresh launch the GEMV
    for name, plan_path in (("drs_project", project_path),
                            ("drs_scores", scores_path)):
        for cap, path in ((captures[name], "tc"), (refresh[name], "gemv")):
            if plan_path(cap.args, cap.kwargs) != path:
                fail(f"{name} at {list(cap.args[0].shape)} plans "
                     f"{plan_path(cap.args, cap.kwargs)}, not {path}")
        want_paths = {"gemv": by_shape["refresh"],
                      "tc": by_shape["admission"], "simt": 0}
        if by_path[name] != want_paths:
            fail(f"{name} took {by_path[name]} by path on the serve run; "
                 f"admission must take tc and refresh gemv: {want_paths}")
    for name, path in (("paged_decode", "split"), ("dsg_ffn_csr", "union")):
        if by_path[name][path] != launches[name]:
            fail(f"{name} took {by_path[name]} by path on the serve run; "
                 f"every launch must take the {path} path")
    print(f"[phase 3] {time.perf_counter() - t0:.2f}s", flush=True)

    # 4. where the device time goes in a short serve run
    t0 = time.perf_counter()
    prof = profile_serve(cfg, model, dsg, eng_kw)
    if prof is None:
        print("[profile] device time not measured: the profiler recorded "
              "no device activity", flush=True)
    else:
        share = 100 * prof["busy_share"]
        print(f"[profile] device busy {prof['busy_ms']:.3f} ms of a "
              f"{prof['window_ms']:.3f} ms window ({share:.1f}%), "
              f"{prof['steps']} decode steps, wall "
              f"{prof['wall_s']:.3f} s under the profiler", flush=True)
        print("[profile] " + json.dumps(prof), flush=True)
    print(f"[phase 4] {time.perf_counter() - t0:.2f}s", flush=True)

    # 5. smoke-width streams: kernels on the card vs plain versions on CPU
    t0 = time.perf_counter()
    for scfg in (None, DSGServingConfig(refresh_interval=2)):
        on_card = smoke_streams(dev, scfg)
        if on_card != smoke_streams(torch.device("cpu"), scfg) \
                or len(on_card) != 6:
            fail(f"smoke streams on the card differ from the CPU "
                 f"(dsg_serving={scfg})")
    print(f"[check] smoke-width greedy streams on the card equal the CPU's "
          f"(DSG serving off and on); {time.perf_counter() - t0:.2f}s",
          flush=True)

    # 10-14. this slice's paths: the fused decode chunk as CUDA graph
    # replays, the dense backend, and both at smoke width against the CPU
    chunk = 8
    kw8 = dict(eng_kw, decode_chunk=chunk)
    wrappers = {n: w for n, (w, _) in kernels.items()}
    t0 = time.perf_counter()
    stats8, launches8, acct8, streams8 = chunked_serve(
        cfg, model, dsg, kw8, wrappers, mixed_requests(cfg.vocab, 8,
                                                       seed=SEED))
    same = sum(streams8[u] == streams3[u] for u in streams3)
    print(serve_line(f"chunk{chunk}/paged", stats8), flush=True)
    print(f"[chunk{chunk}/paged] {acct8['replays']} replays of "
          f"{acct8['graphs_captured']} graphs ({acct8['captured_in_run']} "
          f"captured during the run), capture {acct8['capture_s']:.2f} s in "
          f"a {acct8['warmup_s']:.2f} s warm-up, graph pool "
          f"{acct8['pool_bytes'] / 1e6:.1f} MB; launches {launches8} "
          f"(captured x replays, and the admissions' eager DRS launches); "
          f"{same} of {len(streams3)} streams equal "
          f"the eager serve's; {time.perf_counter() - t0:.2f}s", flush=True)
    print("[chunked] stats " + json.dumps(dict(stats8, **acct8)), flush=True)

    t0 = time.perf_counter()
    eager4 = fixed_lane_streams(cfg, model, dsg, eng_kw, 1)
    graph4 = fixed_lane_streams(cfg, model, dsg, eng_kw, chunk)
    if eager4 != graph4:
        fail(f"fixed-lane bf16 streams of the chunk-{chunk} graphs differ "
             f"from the eager chunk-1 streams: {eager4} vs {graph4}")
    print(f"[bitwise] 4 fixed lanes x 32 tokens: the chunk-{chunk} graphs' "
          f"bf16 streams equal the eager chunk-1 streams; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    dense_stats = {}
    for c in (1, chunk):
        t0 = time.perf_counter()
        kw = dict(eng_kw, cache_backend="dense", decode_chunk=c)
        eng_d = ServingEngine(cfg, model, dsg, **kw)
        warmup_engine(eng_d, cfg.vocab)
        st = run_engine(eng_d, mixed_requests(cfg.vocab, 8, seed=SEED))
        if st["ok_requests"] != 8:
            fail(f"dense chunk {c}: not every request finished ok: {st}")
        same = sum(list(eng_d.done[u].output) == streams3[u]
                   for u in streams3)
        dense_stats[c] = dict(st, equal_to_paged_eager=same)
        del eng_d
        print(serve_line(f"dense/chunk{c}", st) + f"; {same} of 8 streams "
              f"equal the paged eager serve's; "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    print("[dense] stats " + json.dumps(dense_stats), flush=True)

    t0 = time.perf_counter()
    prof8 = profile_serve(cfg, model, dsg, kw8)
    if prof8 is None:
        fail(f"the profiler recorded no device activity at chunk {chunk}: "
             f"the replays' kernels cannot be counted")
    eager_share = ("not measured" if prof is None
                   else f"{100 * prof['busy_share']:.1f}%")
    print(f"[profile chunk{chunk}] device busy {prof8['busy_ms']:.3f} ms "
          f"of a {prof8['window_ms']:.3f} ms window "
          f"({100 * prof8['busy_share']:.1f}%; eager chunk 1: "
          f"{eager_share}), {prof8['steps']} micro-steps, wall "
          f"{prof8['wall_s']:.3f} s; the trace ran {prof8['trace_kernels']} "
          f"for {prof8['calls']} calls x {cfg.n_layers} layers; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    print(f"[profile chunk{chunk}] " + json.dumps(prof8), flush=True)

    t0 = time.perf_counter()
    combos = 0
    for backend in ("dense", "paged"):
        for c in (1, chunk):
            for scfg in (None, DSGServingConfig(refresh_interval=8)):
                on_card = smoke_streams(dev, scfg, backend, c)
                if on_card != smoke_streams(torch.device("cpu"), scfg,
                                            backend, c) or len(on_card) != 6:
                    fail(f"smoke streams on the card differ from the CPU "
                         f"({backend}, chunk {c}, dsg_serving={scfg})")
                combos += 1
    print(f"[check] smoke-width greedy streams on the card equal the CPU's "
          f"in all {combos} of {{dense, paged}} x {{chunk 1, {chunk}}} x "
          f"{{DSG serving off, on}}; {time.perf_counter() - t0:.2f}s",
          flush=True)

    # 6. kernels against their plain versions
    t0 = time.perf_counter()
    specs = [
        ("paged_decode", paged_attention.paged_decode,
         paged_attention.paged_decode_plain, paged_cost, None,
         "src/repro_torch/csrc/paged_attention.cu",
         "src/repro/kernels/paged_attention.py:129"),
        ("dsg_ffn_csr", dsg_ffn.dsg_ffn_csr, dsg_ffn.dsg_ffn_csr_plain,
         csr_cost, None, "src/repro_torch/csrc/dsg_ffn.cu",
         "src/repro/kernels/dsg_ffn.py:120"),
        ("drs_project", drs_search.drs_project, drs_search.drs_project_plain,
         project_cost, lambda x, r: torch.matmul(x, r.t()),
         "src/repro_torch/csrc/drs_search.cu",
         "src/repro/kernels/drs_search.py:29"),
        ("drs_scores", drs_search.drs_scores, drs_search.drs_scores_plain,
         scores_cost, None, "src/repro_torch/csrc/drs_search.cu",
         "src/repro/kernels/drs_search.py:56"),
    ]
    rows = []
    for name, kernel, plain, cost, library, source, replaces in specs:
        row = check_kernel(name, kernel, plain, captures[name], cost,
                           library)
        shapes = {"": row}
        if name in drs:
            row["launches_by_shape"] = by_shape
            row["refresh"] = shapes["refresh "] = dict(
                check_kernel(name, kernel, plain, refresh[name], cost,
                             library), launches=by_shape["refresh"])
        if name == "drs_project":
            row["launches_by_path"] = by_path[name]
            row["path"] = project_path(captures[name].args)
            row["refresh"]["path"] = project_path(refresh[name].args)
        if name == "drs_scores":
            row["launches_by_path"] = by_path[name]
            for r, cap in ((row, captures[name]),
                           (row["refresh"], refresh[name])):
                args = to_dtype(cap.args, torch.bfloat16)
                plan = scores_plan(args, cap.kwargs)
                r.update(path=plan.path, plan=plan._asdict(),
                         **matmul_yardstick(args))
        if name in ("paged_decode", "dsg_ffn_csr"):
            cap = captures[name]
            plan = (paged_plan if name == "paged_decode" else csr_plan)(
                to_dtype(cap.args, torch.bfloat16), cap.kwargs)
            row.update(launches_by_path=by_path[name], plan=plan._asdict())
            row["path"] = plan.path
        if name == "dsg_ffn_csr":
            row.update(dense_ffn(to_dtype(captures[name].args,
                                          torch.bfloat16)))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     f"launches_chunk{chunk}": launches8[name], **row})
        for label, r in shapes.items():
            lib = ("" if r["library_ms"] is None else
                   f", library {r['library_ms']:.4f} ms (span "
                   f"{r['library_span_ms']:.4f} ms) / "
                   f"{r['library_call_ms']:.4f} ms a call")
            path = f" path {r['path']}," if "path" in r else ""
            if "matmul_ms" in r:
                lib += (f", torch.matmul(fx, fw) alone (not the same "
                        f"function) {r['matmul_ms']:.4f} ms (span "
                        f"{r['matmul_span_ms']:.4f} ms)")
            if "dense_ffn_ms" in r:
                lib += (f", dense SwiGLU (not the same function) "
                        f"{r['dense_ffn_ms']:.4f} ms (span "
                        f"{r['dense_ffn_span_ms']:.4f} ms) / "
                        f"{r['dense_ffn_call_ms']:.4f} ms a call")
            print(f"[kernel] {name} {label}{r['shapes']}:{path} "
                  f"{r['ms']:.4f} ms on the device ({r['span_ms']:.4f} ms "
                  f"first start to last end), {r['call_ms']:.4f} ms a "
                  f"call (plain {r['plain_ms']:.4f} ms{lib}, bound "
                  f"{r['bound_ms']:.5f} ms by {r['bound_by']}), max abs err "
                  f"bf16 {r['max_abs_err']:.3g} f32 "
                  f"{r['max_abs_err_f32']:.3g}", flush=True)
    print(f"[phase 6] {time.perf_counter() - t0:.2f}s", flush=True)

    # 7-8. the tile-masked FFN and flash attention, each through its ops
    # entry point with its own launch counts, on layer 0's operands of a
    # 256-token prompt and of a 2048-token prompt that begins with it
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=gen, device=dev)
    x_ffn, qkv_a = capture_layer0(cfg, model, dsg, tokens[:, :256])
    _, (q_long, k_b, v_b) = capture_layer0(cfg, model, dsg, tokens)
    ffn_row, ffn_mask = dsg_ffn_phase(cfg, model, dsg, x_ffn)
    rows.append(ffn_row)
    cases = {"a": qkv_a, "b": (q_long[:, -256:].contiguous(), k_b, v_b)}
    rows.append(flash_phase(cases))
    print(f"[phases 7-8] {time.perf_counter() - t0:.2f}s", flush=True)

    # 9. the split counts around the plans' choices
    t0 = time.perf_counter()
    sweep = split_sweep(cases, *captures["drs_project"].args)
    rows[-1]["split_sweep"] = {n: r for n, r in sweep.items()
                               if n.startswith("flash")}
    next(r for r in rows if r["name"] == "drs_project")["split_sweep"] = {
        n: r for n, r in sweep.items() if n.startswith("drs")}
    for name, fn in (("dsg_ffn_csr", csr_sweep),
                     ("paged_decode", paged_sweep)):
        cap = captures[name]
        next(r for r in rows if r["name"] == name)["split_sweep"] = fn(
            to_dtype(cap.args, torch.bfloat16), cap.kwargs)
    next(r for r in rows if r["name"] == "drs_scores")["split_sweep"] = \
        scores_sweep(*(to_dtype(c.args, torch.bfloat16) for c in
                       (refresh["drs_scores"], captures["drs_scores"])),
                     cfg.dsg.block)
    ffn = model.layers[0].ffn
    ffn_row["split_sweep"] = tile_sweep(
        x_ffn, ffn.w_gate.data, ffn.w_up.data, ffn.w_down.data, ffn_mask,
        cfg.dsg.block)
    print(f"[phase 9] {time.perf_counter() - t0:.2f}s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
