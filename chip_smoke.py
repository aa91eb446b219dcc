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
            replays, graphs, capture seconds and the graph pool's bytes.
            Every stream must equal phase 3's, bit for bit: lanes admit at
            chunk boundaries, so they share their steps with other lanes
            than in phase 3, and a lane's bf16 sums must not depend on
            them (the split paged step cuts a lane's walk by its own page
            count, the union CSR FFN its down projection at fixed group
            ranges).
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
            off, on (refresh 8)}, four runs with sampled lanes or prefix
            sharing on, and the deepseek-moe-16b and llava-next-34b smoke
            models (DSG on, mask mode) over {dense, paged} x {chunk 1, 8}
            (20 in all): the card's smoke-width f32 streams equal the
            CPU's.
15. solo  — each of phase 3's 8 requests served alone at chunk 8, one
            after another through one engine: each stream equals that
            request's in phase 3 and in phase 10.
16. sample — phase 3's 8 requests, the odd ones sampled at temperature 0.8,
            top_p 0.9, at chunk 1 (eager) and at chunk 8 (graphs, the
            sampling ones captured by warmup_engine) and at chunk 8 again
            in a fresh engine with the same seed: every request ok, every
            greedy stream equal to phase 3's, every sampled stream the same
            in all three runs, and the sampling graphs replayed.  Prints
            TPOT beside phase 10's.
17. prefix — 8 requests of 192 tokens sharing a 160-token prefix (max_new
            32) at chunk 8, prefix sharing off and on: the streams equal 8
            of 8, shared page hits > 0 and a lower peak of live pages with
            sharing on; prints the copy-on-write copies.
18. open-loop — 16 mixed requests submitted by `run_open_loop` at Poisson
            arrivals of half the requests a second that phase 10 completed,
            chunk 8, and a 17th whose deadline lapses in the queue: the 16
            finish ok, the 17th retires timed_out; prints TTFT and TPOT
            p50/p95.
19. train — the training path at full width, after phase 9, once the
            serve phases' model, engines and graph pools are freed and the
            peak memory counter is reset: internlm2-1.8b (24 layers, d=2048,
            F=8192, vocab 92544, bf16 with f32 master weights), random
            weights from a seeded torch.Generator, DSG mask mode (gamma 0.5,
            shared threshold, block 128) with remat, `launch.train.train`
            for 12 AdamW steps on batch 8 x seq 256 of the synthetic stream,
            f(W) refreshed every 4 steps (the config's 50 never comes in 12),
            no fault injector and no checkpoint.  Fails unless every loss is
            finite, the last is below the first, no step was retried, f(W)
            was refreshed after steps 4, 8 and 12, and the FFN took the
            masked DSG path in every layer of every step (the forward and
            the remat recompute, by `swiglu_ffn.calls`).  Prints the loss per
            step, the step ms p50/p95 of steps 2-12 (each ending in a
            read-back of its metrics), training tokens/s, the model FLOPs
            utilisation 6 x N x tokens / step / 989 TFLOP/s (N the
            non-embedding parameters plus the LM head), each layer's mean
            kept fraction, the peak allocated memory beside the stash
            model's dense and DSG totals, and the kernels' launches during
            the run (none: no kernel lies on the training path).  Then the
            smoke model's 4 training steps on the card against the CPU
            (f32, TF32 off): losses to rtol 1e-5 and every DRS mask equal.
20. router — phase 3's model behind `serving.router.Router`: 2 replicas x
            4 slots sharing the model's tensors, DSG serving on (gamma 0.5,
            refresh 8), paged (page 16), max_seq 512, bucket 256, chunk 8,
            16 `skewed_requests` (every other one heavy: prompts 96-160,
            40-56 new tokens; light 8-24, 2-4 new), fault tolerance on
            (it acts only when a replica fails), every replica warmed by
            `warmup_router`.  (a) round_robin and least_queue under the
            sequential executor; (b) least_queue under the threaded
            executor (a worker thread and a stream per replica), once plain
            and once under torch.profiler for the device's busy share;
            (c) least_queue with a kill on replica 1 at step 16 and a
            poison on replica 0 at step 32, sequential and threaded; each
            run: every request ok, every uid's stream equal to that
            request's stream from one engine (16 of 16), no graph captured
            during the run, every serve-path kernel launched (the wrappers'
            eager launches plus the graph caches' captured x replays);
            failover also needs each fault fired once, a retry and both
            replicas healthy at the end.  (d) the sharded executor with
            DSG on and DSG serving off, the DRS threshold per row (top-k:
            the config's shared threshold, row 0's, couples a lane to its
            co-resident lanes by design), chunk 1 and 8: streams equal one
            such engine's, one group-graph replay a tick, and paged
            decode's replayed launches 24 x chunk x 2 x
            replays, all split; a sharded router over DSG-serving engines
            must raise.  (e) the per-lane "ema" threshold on one engine at
            chunk 8, not warmed (the run captures the keys it meets):
            every request ok; prints the modeled FFN reduction beside
            topk's.  Prints the modeled and measured makespans,
            parallel tok/s, dispatches of heavy requests per replica,
            per-replica busy seconds, retries and health.
21. moe — deepseek-moe-16b at full width in bf16 (d 2048, 16 heads / 16
            kv of 128, 64 routed experts + 2 shared of 1408, top-6, vocab
            102400), cut to MOE_LAYERS of its 28 layers (the depth cut
            that pays for phase 26 (b)), random weights from a
            seeded torch.Generator, DSG as the config sets it (mask mode
            inside every expert and the shared experts, gamma 0.5, shared
            threshold, block 128, k 128), paged KV (page 16), 4 slots,
            max_seq 512, after phase 19's memory is freed.  (a) 4 fixed
            lanes (phase 11's prompts, 32 new tokens) at chunk 1 eager and
            chunk 8 in graphs, DSG on and DSG off: streams equal 4 of 4;
            the eager run's paged_decode launches are layers x steps, all
            split, and the graphs replay layers x 8 x replays.  (b) phase
            3's 8 mixed requests at chunk 8 after warmup_engine
            (graph_serve's accounting): every request ok, a 4 x 128-token
            forward's logits finite; TPOT, TTFT, decode tok/s.  (c)
            paged_decode against its plain version on layer 0's operands
            of decode step 12, timed.  (d) peak allocated memory.  (e) the
            device's busy share over a profiled chunk-8 run of 4 x 24
            tokens, eager prefills included (the trace counts layers x 8 x
            replays split kernels), and over 3 replays of a captured chunk
            alone, whose kernels' summed time / 24 is one decode
            micro-step's device time, printed beside its byte bound: every
            weight but the embedding (all 64 experts of every layer: the
            reference's dispatch runs every expert's capacity slots) and
            the DSG buffers at 3.35 TB/s.
22. configs — llama3.2-3b, phi3-mini-3.8b and mistral-nemo-12b in turn,
            at full width in bf16, random weights, DSG serving on (refresh
            8), paged (page 16), 4 slots, max_seq 512, each freed before
            the next: 4 fixed lanes x 16 new tokens at chunk 1 (eager, the
            four serve kernels' counters set to 0 before and read after:
            layers x steps for paged decode and the CSR FFN, layers x
            (admissions + refresh steps) for the DRS kernels, every launch
            on the path its shape plans) and chunk 8 (graphs): streams
            equal 4 of 4; each kernel held against its plain version on
            layer 0's operands (the DRS kernels at admission and refresh),
            bf16 and f32, and timed as in phase 6, with its plan's path
            printed (the serial paged
            kernel for llama3.2's 3 query heads a kv head and phi3's head
            dim 96).
23. xlstm — xlstm-350m at full width in bf16 (24 layers in 6 groups of 3
            mLSTM + 1 sLSTM, d 1024, 4 heads, vocab 50304, no cut), DSG
            mask mode as the config sets it, after phase 22's memory is
            freed.  (a) `launch.serve.generate` on 4 prompts of 128 tokens,
            32 greedy tokens, and the same loop again timed step by step:
            equal streams, finite logits; prefill ms, eager TPOT p50/p95,
            decode tok/s; 3 more decode steps under torch.profiler (after
            2 warm-up steps): launches a step, device ms a step against its
            byte bound (every weight but the embedding's unused rows, the
            DSG buffers, the decode state read and written) and the busy
            share.  (b) prefill(127) and one decode step against
            prefill(128), DSG off, in bf16 and in an f32 copy of the
            model: argmax equal wherever the top-2 margin exceeds twice
            the largest difference.  (c) the smoke model's `generate`
            (prompts 12 and 24, per-row top-k threshold) card == CPU.
            (d) 12 AdamW steps at batch 8 x 256 (f32 masters, remat,
            refresh every 4): finite losses, and step 0's batch scores
            below its first loss after the last step; step ms, tokens/s,
            MFU, peak memory; the smoke model's 4 steps card == CPU.
            None of the six kernels may lie on the path: their launches
            are printed (0).
24. zamba — zamba2-7b at full width in bf16 (13 groups of 6 Mamba2 blocks
            and one shared attention / SwiGLU block, d 3584, 32 heads of
            112, F 14336, SSM state 64, window 4096, vocab 32000): 23 (a)
            and (c), then 12 training steps at 2 of the 13 groups (12
            Mamba2 blocks, every width kept: the full model's weights,
            gradients and f32 AdamW state take ≈ 104 GB) and the smoke
            model's 4 steps card == CPU.
25. whisper — whisper-large-v3 at full width in bf16 (32 encoder + 32
            decoder layers, d 1280, 20 heads of 64, F 5120, vocab 51872,
            1.6 B parameters), random weights from a seeded
            torch.Generator, DSG as the config sets it (mask mode, shared
            threshold, gamma 0.5, block 128), after phase 24's memory is
            freed.  (a) serve: `api.make_inputs`' 4 lanes x 1500 frames
            (whisper's 30 s window) and 187 prompt tokens, the prefill
            (encoder, memory K/V and decoder prompt timed apart, and
            `api.prefill` whole) and 64 greedy `api.decode_step`s into
            `make_cache(cfg, 4, 2048)`'s 256 decoder slots, twice: equal
            streams and finite logits; TPOT p50/p95; a profiled decode
            step's device time and launches against its byte bound (the
            decoder's weights but the cross wk/wv, the LM head, f(W),
            the memory K/V and the self cache) and the busy share; the
            encoder's device time against its FLOP bound (its products at
            989 TFLOP/s, its f32 scores at 67); peak memory.  (b) DSG off,
            bf16 and an f32 model: prefill(186) + one decode step against
            prefill(187), argmax held where the top-2 margin exceeds
            twice the difference.  (d) 4 AdamW steps (bf16, f32 masters,
            remat) of `api.train_loss` through `trainer_for` on one batch
            of 4 x 1500 frames + 187 tokens: finite losses, the last below
            the first; step ms, MFU (3 x the forward's FLOPs, attention
            included, over 989 TFLOP/s), peak memory.  (c) in f32 with
            TF32 off, the prefill's last logits card against CPU at full
            width cut to 2 + 2 layers, 2 lanes, DSG on and off, within
            WHISPER_CPU_ATOL; the smoke model's 8-token greedy stream card
            == CPU.  None of the six kernels may launch in the phase.
26. plan  — `launch.dryrun`'s plan against the card, after phase 25's
            memory is freed.  The dry run (meta tensors, on the host CPU)
            of internlm2-1.8b's phase-19 step, batch 8 x seq 256, remat and
            DSG mask mode, one microbatch (the ordinary trainer takes the
            batch whole), on a 1 x 1 mesh; its traced peak is the sharded
            step's on rank 0 (DTensors), which on one device is the
            unsharded step's.  (a) The same state on the card
            (bf16 weights from a seeded torch.Generator, DSG state, AdamW
            with f32 masters) laid out as DTensors by the port's specs on
            `make_local_mesh()` of a one-rank NCCL group (a FileStore in a
            temporary directory, destroyed at the end): the shards' bytes
            must equal the dry run's params + dsg + opt, and the
            torch.cuda.memory_allocated() they add (cuBLAS workspaces
            freed around the readings) must equal those bytes with each
            shard's block as the caching allocator rounded it (read from
            its snapshot; each under its 2 MiB segment multiple); the
            rounding is printed.  (b) One step of `launch.train`'s trainer
            at the same shape: its peak allocated memory against the dry
            run's traced peak, their ratio within PLAN_PEAK_BAND.  (c) The
            dry run's FLOPs beside phase 19's 6 x N x T and the step's
            TFLOP/s by both (median of steps 2-6).  None of the six
            kernels may launch in the phase.
27. mesh  — the model's parallel parts on rank processes of this script
            on the one card (`--mesh-rank`; NCCL refuses two ranks on one
            device, so each part is a gloo group meeting at a FileStore in
            a temporary directory, removed at the end), after phase 26's
            memory is freed.  (a) internlm2-1.8b on a (data 1, model 2)
            mesh of two ranks: `launch.train.build_trainer(mesh=)` lays
            the trainer's state out (bf16 weights, DSG state, AdamW with
            f32 masters, ZeRO-1 specs); each rank's shards must equal the
            dry run's per-device params + dsg + opt on the same mesh
            (traced on the fake backend), and their allocated bytes and
            the layout's peak are printed.  Then `swiglu_dsg_gather_sharded`
            (gather_shared, n_chunks 2 = shards) forward and backward at
            full width (x 8 x 256 x 2048, F 8192, bf16) against the
            unsharded `swiglu_dsg_gather` on the card after the ranks exit,
            which selects the same groups: y, dx and each rank's dW
            within MESH_E_FACTOR x E, E the unsharded bf16 run's gap to
            the f32 FFN on the groups that run kept (ROADMAP.md §3's bf16
            rule; f32 scores would keep other groups); ms p50 of both, the
            host time of the collectives from a profiler window.  One
            more call on each rank runs under `launch.comm_analysis`'s
            counter: its collectives, kind by kind in count and bytes,
            must equal the dry run's count of the same call traced on
            meta tensors on rank 0 of a 2-rank fake group.  Then the
            vocab-parallel loss (`transformer.sharded_cross_entropy`) on
            2 x 128 tokens of bf16 logits at the full vocabulary (92544,
            split over 'model'; seeded, the labels' own logits raised,
            every shard's first and last id among the labels): the loss
            and each rank's shard of the logits' gradient against the
            unsharded f32 `cross_entropy` on the card, within
            MESH_E_FACTOR x E, E the unsharded loss's own gap between
            the bf16 logits and the f32 ones they round; the same call
            with the labels one shard on (a planted fault) must fall
            outside; one more call's collectives (three all-reduces)
            must equal its fake trace.
            (b) deepseek-moe-16b's routed experts of one layer under
            expert parallelism at full width (32 of 64 experts of 2048 x
            1408 a rank, 4 x 128 tokens, bf16), DSG on as the config sets
            it and off, against plain experts written apart from
            models.moe (`moe_reference`: torch.topk routing, each expert's
            first slots in token order, one expert at a time) on DSG's
            groups as each expert shard selects them (the shared
            threshold reads the shard's own first slot, as the
            reference's shard_map body does); within MESH_E_FACTOR x E, E
            the plain bf16 experts' gap to f32 on the same groups.  In
            (a) and (b) planted faults (the output zeroed, model shard 1's
            groups or experts dropped) must each fall outside the bound.
            The whole model under EP would hold about 16.9
            GB of bf16 weights a rank: 15.5 GB of its 31.0 GB of routed
            experts and half of the other 2.8 GB.  (c) four ranks:
            `pipeline_forward` (pipe 4) with stages of internlm2-1.8b's
            SwiGLU FFN (d 2048, F 8192, bf16, a residual) on 4
            microbatches of 2 x 256, equal to `sequential_reference`;
            `hierarchical_grad_reduce` (pod 2 x data 2) on an f32 gradient
            of w_gate's shape a rank, compress off and on, and
            `compressed_psum` over 'data', each within MESH_COLL_TOL of
            the mean and ternary decode every rank computes from all four
            ranks' seeded gradients; `make_global_batch`'s rows on each
            rank equal `batch_at`'s host slice.  The parts whose
            DTensor layouts need an all_gather, which gloo cannot do on
            CUDA tensors (MESH_CPU_ONLY), are named on a line of their own:
            they run on gloo CPU ranks only, in the tests.  None of the six
            kernels may launch in the phase.
28. replicas — phase 20 (d)'s sharded router of 2 replicas (chunk 8,
            fault tolerance on) as a replica mesh: two gloo rank
            processes of this script on the one card (`--mesh-rank`),
            one replica each (`Router(..., mesh=replica_mesh(2))`), after
            phase 27's memory is freed.  Each rank builds internlm2-1.8b
            from the seeded generator; the weights' per-leaf sums,
            gathered over the router's control group, must be equal.
            Phase 20's 16 skewed requests, fault-free and under
            kill@1:6: on every rank the merged streams, statuses,
            retries, dispatch log and steps (and the health events under
            the fault) must equal phase 20 (d)'s one-process run of the
            same (recorded there, `replica_run`); each rank one group
            replay a tick and 24 x 8 x 1 x replays split paged_decode
            launches, no eager launch of the six kernels and no capture
            during the run; the kill fired once, on replica 1's rank.
            Prints the makespans, each rank's ticks, replays and launches
            and the control group's ms a tick; adds both ranks' launches
            to the kernels line (`launches_by_phase["replica_mesh"]`).
Phases 15-18 and 20 each count the kernels' launches from 0, by the graph
caches for the chunked runs (phase 10's accounting) and by the wrappers'
counters for the eager one; each must have launched every serve-path
kernel (phase 20's sharded runs, with DSG serving off, paged decode).
Phases 10-18 and 20 run after phase 5, in the order 10, 15-18, 11-14, 20;
then 6-9, 19 and 21-28; each prints its seconds.

The last line is {"ok": true, "device": {...}}.  It needs no network and
imports nothing of JAX or of the `repro` package.

    python3 chip_smoke.py --mesh-cards

runs, on four cards and nothing else, the whole model sharded with one
card a rank over NCCL, which phase 27 cannot do on one card (see
`main_mesh_cards`); one training step's collectives on each rank must
equal the dry run's record of that step and its peak memory the traced
peak within PLAN_PEAK_BAND, and `launch.serve.generate(..., mesh=)` on
four cards must give the one card's greedy stream.  It also runs phase
28 over four ranks with a card each (8 replicas) and a threaded router
of 4 replicas placed on the four cards, timed against the same router
on one card.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

SEED = 0
ARCH = "internlm2-1.8b"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
CAPTURE_STEP = 12                  # decode step whose layer-0 call is kept
TIMING_REPS = 30
WARM_REPS = 30                     # profiled calls before the timed ones:
                                   # the profiler can drop the events of
                                   # the first calls after it starts (up
                                   # to 16 of 50 on an H100 80GB HBM3)
CALL_GAP_NS = 3_000_000            # idle device time that ends a call
PROFILE_TRIES = 5                  # traces device_ms takes to find a clean one:
                                   # a host under load can drop a trace's
                                   # events or stall a call past the gap,
                                   # so each retry doubles the gap
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
    call ends in a synchronize and CALL_GAP_NS + 2 ms of idle host, so on
    the device's own clock a call's events form one run, separated from
    the next by an idle gap of over CALL_GAP_NS.  (The profiler's host and device clocks
    are not aligned closely enough to assign events to host-side ranges,
    and it can miss the events of the first calls after it starts, which
    the warm-up calls absorb.)  A trace is taken only if it split into more
    than TIMING_REPS and at most WARM_REPS + TIMING_REPS runs and every
    timed call has the same number of events: a call that lost events, or
    two calls merged into one run, would not.  Up to PROFILE_TRIES traces
    are taken, each with twice the last one's gap and pause (a loaded
    host can stall between a call's own launches past CALL_GAP_NS); fails
    if none passes.  Returns (ms, a note: the median
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
    for k in range(PROFILE_TRIES):
        gap = CALL_GAP_NS << k
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(WARM_REPS + TIMING_REPS):
                fn()
                torch.cuda.synchronize()
                time.sleep(gap / 1e9 + 0.002)
        spans = sorted(
            (e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", lambda: False)())
        runs, end = [], None
        for s, e, name in spans:
            if end is None or s - end > gap:
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
            row["bound_ms"], row["bound_by"] = bound(
                *cost(*args, **cap.kwargs), dtype)
            fns = {"": lambda: kernel(*args, **cap.kwargs),
                   "plain_": lambda: plain(*args, **cap.kwargs),
                   "library_": None if library is None
                   else lambda: library(*args)}
            for pre, fn in fns.items():
                if fn is None:
                    row[f"{pre}ms"] = row[f"{pre}span_ms"] = None
                    row[f"{pre}call_ms"] = None
                    continue
                row[f"{pre}ms"], note = device_ms(fn)
                row[f"{pre}span_ms"] = note["span_ms"]
                row[f"{pre}call_ms"] = time_ms(fn)
                row[f"{pre}timing"] = note
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
                  decode_chunk=1, sample=False, sharing=None, arch=ARCH):
    """`arch`'s smoke model's streams (f32, DSG's per-row top-k threshold)
    over 6 requests through 2 lanes:
    mixed lengths, or with `sharing` (a prefix length) 28-token prompts
    whose first `sharing` tokens are the same, in a 28-token bucket, served
    with prefix sharing on (28 = 3.5 pages of 8, so identical prompts share
    a partial tail page and copy it on write); with `sample` the odd
    requests sample at temperature 0.8, top_p 0.9."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import (mixed_requests,
                                              shared_prefix_requests)
    cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    gen = torch.Generator().manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    model = model.to(device)
    dsg = {k: v.to(device) for k, v in dsg.items()}
    kw = {}
    if sharing is None:
        reqs = mixed_requests(cfg.vocab, 6, seed=23, prompt_range=(4, 30),
                              max_new_range=(3, 9))
    else:
        reqs = shared_prefix_requests(cfg.vocab, 6, prompt_len=28,
                                      prefix_len=sharing, max_new=7, seed=29)
        kw = dict(buckets=(28,), prefix_sharing=True)
    if sample:
        for r in reqs[1::2]:
            r.temperature, r.top_p = 0.8, 0.9
    eng = ServingEngine(cfg, model, dsg, n_slots=2, max_seq=64,
                        prompt_bucket=32, page_size=8,
                        cache_backend=cache_backend, dsg_serving=dsg_serving,
                        decode_chunk=decode_chunk, **kw)
    for r in reqs:
        eng.submit(r)
    return {u: r.output for u, r in eng.run(400).items()}


class MaskLog:
    """Wraps `dsg_linear.drs_group_mask`: passes every call through and
    keeps each mask (on the host with `keep`), or adds each forward
    mask's kept fraction to its layer's sum on the device.  Under remat a
    step calls it 2 x layers times: the forward (layers in order), then
    the backward's recompute (in reverse)."""

    def __init__(self, fn, n_layers, keep=False, device=None):
        import torch
        self.fn, self.n_layers, self.keep = fn, n_layers, keep
        self.masks, self.calls = [], 0
        self.kept = torch.zeros(n_layers, device=device)

    def __call__(self, x, state, cfg):
        m = self.fn(x, state, cfg)
        i = self.calls % (2 * self.n_layers)
        if self.keep:
            self.masks.append(m.cpu())
        elif i < self.n_layers:
            self.kept[i] += m.mean()
        self.calls += 1
        return m


def smoke_training(device, steps=4):
    """The smoke model (f32) trained `steps` steps from one CPU
    initialisation (batch 4 x seq 32, DSG mask mode with the shared
    threshold, refresh every 2): the losses and every DRS mask of the
    forward passes."""
    import torch
    from repro_torch import configs
    from repro_torch.core import dsg_linear
    from repro_torch.launch import train
    from repro_torch.models import api
    cfg = configs.get_smoke_config(ARCH)
    cfg = cfg.replace(dsg=cfg.dsg._replace(refresh_every=2))
    gen = torch.Generator().manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = {k: v.to(device) for k, v in api.init_dsg(
        model, cfg, generator=gen, device="cpu").items()}
    model = model.to(device)
    log = MaskLog(dsg_linear.drs_group_mask, cfg.n_layers, keep=True)
    dsg_linear.drs_group_mask = log
    try:
        _, hist, _ = train.train(cfg, steps=steps, global_batch=4, seq_len=32,
                                 seed=SEED, device=device, init=(model, dsg),
                                 log_every=steps)
    finally:
        dsg_linear.drs_group_mask = log.fn
    n = cfg.n_layers
    forward = [m for i, m in enumerate(log.masks) if i % (2 * n) < n]
    return [h["loss"] for h in hist], forward


def device_event(e) -> bool:
    """A kernel or copy on the device: a scheduled profile's step
    annotations ("ProfilerStep#n") show on the device timeline too."""
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep"))


def busy(prof) -> dict:
    """The device's busy time (the union of its kernel and copy intervals)
    in a profiled window, the window from its first to its last activity,
    and the 8 kernels with the most device time."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if device_event(e))
    if not spans:
        return None
    total, end, by_name = 0.0, spans[0][0], {}
    for s, e, name in spans:
        total += max(0.0, e - max(s, end))
        end = max(end, e)
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + e - s, n + 1)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"busy_ms": total / 1e3, "window_ms": window / 1e3,
            "busy_share": total / window, "kernels": len(spans),
            "by_kernel": [{"name": n[:70], "ms": t / 1e3, "count": c}
                          for n, (t, c) in top]}


def train_breakdown(state, cfg, acfg, batch) -> dict:
    """Where one more full-width training step's time goes: the loss and
    its gradients (forward, remat recompute, backward), then the AdamW
    update, each timed alone between synchronizes on the host's clock and
    once more under torch.profiler (device busy time, busy share of the
    window, the kernels with the most device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api
    from repro_torch.optim import adamw
    model = state["model"]
    params = dict(model.named_parameters())

    def grads():
        loss = api.train_loss(model, state["dsg"], cfg, batch)
        return dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))

    def update(g):
        adamw.apply_updates(params, g, state["opt"], acfg)

    out = {}
    for rep in range(2):          # the second pass is the one kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = grads()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        update(g)
        torch.cuda.synchronize()
        out = {"loss_grad_ms": 1e3 * (t1 - t0),
               "adamw_ms": 1e3 * (time.perf_counter() - t1)}
        del g
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        g = grads()
        torch.cuda.synchronize()
    out["loss_grad_device"] = busy(prof)
    with profile(activities=acts) as prof:
        update(g)
        torch.cuda.synchronize()
    out["adamw_device"] = busy(prof)
    return out


def train_phase(dev, kernels) -> dict:
    """Phase 19: internlm2-1.8b at full width in bf16 with f32 master
    weights, DSG masks and remat, trained 12 AdamW steps on batch 8 x seq
    256 of the synthetic stream; then the smoke model's 4 steps on the
    card against the CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.core import dsg_linear, stash
    from repro_torch.data import synthetic
    from repro_torch.kernels import dsg_ffn, flash_attention
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    kernels = dict(kernels, dsg_ffn=dsg_ffn.dsg_ffn,
                   flash_attention=flash_attention.flash_attention)
    steps, batch, seq, refresh = 12, 8, 256, 4
    cfg = configs.get_config(ARCH)
    # the config refreshes f(W) every 50 steps, which a 12-step run never
    # reaches: every 4 here, so the refresh runs at steps 4, 8 and 12
    cfg = cfg.replace(dsg=cfg.dsg._replace(refresh_every=refresh))
    if not (cfg.remat and cfg.dsg.enabled and cfg.dsg.mode == "mask"):
        fail(f"the training config is not DSG mask mode with remat: {cfg}")
    n = cfg.n_layers
    log = MaskLog(dsg_linear.drs_group_mask, n, device=dev)
    dsg_linear.drs_group_mask = log
    torch.cuda.reset_peak_memory_stats()
    for w in kernels.values():
        w.launches = 0
    dsg_linear.swiglu_ffn.calls.update(dict.fromkeys(dsg_linear.FFN_MODES, 0))
    t0 = time.perf_counter()
    try:
        state, hist, monitor = train.train(
            cfg, steps=steps, global_batch=batch, seq_len=seq, seed=SEED,
            device=dev, log_every=steps)
        torch.cuda.synchronize()
    finally:
        dsg_linear.drs_group_mask = log.fn
    wall = time.perf_counter() - t0
    calls = dict(dsg_linear.swiglu_ffn.calls)
    launches = {k: w.launches for k, w in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    refreshed = [h["step"] + 1 for h in hist if h["refresh"]]
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.embed.numel()
    ms = sorted(1e3 * h["seconds"] for h in hist[1:])
    p50 = ms[len(ms) // 2]
    p95 = ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))]
    tokens = batch * seq
    kept = (log.kept / steps).tolist()
    param_bytes = n_params * (2 + 2 + 12)    # bf16 w + grad, f32 m, v, master
    fp = stash.training_footprint([(batch, seq, cfg.d_ff)] * n,
                                  cfg.dsg.gamma, cfg.dsg.block, param_bytes)
    out = {"steps": len(hist), "losses": losses, "step_ms": [
        1e3 * h["seconds"] for h in hist], "step_ms_p50": p50,
        "step_ms_p95": p95, "tokens_per_s": 1e3 * tokens / p50,
        "mfu": 6 * n_matmul * tokens / (p50 / 1e3) / PEAK_FLOPS[
            "torch.bfloat16"], "n_params": n_params, "n_matmul": n_matmul,
        "refreshed_at": refreshed, "retries": len(monitor.failures),
        "ffn_calls": calls, "kernel_launches": launches,
        "kept_fraction_by_layer": kept, "peak_allocated_bytes": peak,
        "stash_model": fp, "wall_s": wall,
        "grad_norms": [h["grad_norm"] for h in hist],
        "lrs": [h["lr"] for h in hist]}
    acfg = adamw.AdamWConfig(total_steps=steps,
                             warmup=min(20, steps // 5 + 1))
    extra = {k: v.to(dev) for k, v in synthetic.batch_at(
        steps, global_batch=batch, seq_len=seq, vocab=cfg.vocab,
        seed=SEED).items()}
    out["breakdown"] = br = train_breakdown(state, cfg, acfg, extra)
    del state, model
    for h in hist:
        print(f"[train] step {h['step'] + 1}: loss {h['loss']:.4f}, "
              f"grad norm {h['grad_norm']:.4f}, lr {h['lr']:.3g}, "
              f"{1e3 * h['seconds']:.1f} ms"
              + (", f(W) refreshed" if h["refresh"] else ""), flush=True)
    print(f"[train] {ARCH} full width ({n} layers, d={cfg.d_model}, "
          f"F={cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f}B params in "
          f"{cfg.dtype} with f32 master weights), DSG mask mode gamma "
          f"{cfg.dsg.gamma} block {cfg.dsg.block} threshold "
          f"{cfg.dsg.threshold_mode}, remat on, batch {batch} x seq {seq}, "
          f"{steps} AdamW steps, refresh every {refresh} (the config's "
          f"{configs.get_config(ARCH).dsg.refresh_every} would not refresh "
          f"in {steps} steps)", flush=True)
    print(f"[train] step ms p50 {p50:.1f} p95 {p95:.1f} (steps 2-{steps}, "
          f"each ending in a read-back of its metrics); "
          f"{out['tokens_per_s']:.0f} training tokens/s; MFU "
          f"{100 * out['mfu']:.2f}% (6 x {n_matmul / 1e9:.3f}B matmul "
          f"params x {tokens} tokens / step / 989 TFLOP/s); wall "
          f"{wall:.2f}s", flush=True)
    print(f"[train] peak allocated {peak / 1e9:.2f} GB; stash model for "
          f"(B, S, F) per layer: dense {fp['dense_total'] / 1e9:.2f} GB, "
          f"DSG {fp['dsg_total'] / 1e9:.2f} GB (the port stores dense "
          f"activations, as the reference does in mask mode)", flush=True)
    def device(d):
        if d is None:
            return "device time not measured (no device events)"
        top = [(k["name"][:40], round(k["ms"], 2)) for k in d["by_kernel"][:4]]
        return (f"device busy {d['busy_ms']:.1f} ms, "
                f"{100 * d['busy_share']:.1f}% of its window, top {top}")
    print(f"[train] one more step, parts timed alone: loss + grads "
          f"{br['loss_grad_ms']:.1f} ms ({device(br['loss_grad_device'])}); "
          f"AdamW {br['adamw_ms']:.1f} ms ({device(br['adamw_device'])})",
          flush=True)
    print(f"[train] mean kept fraction by layer "
          f"{[round(k, 4) for k in kept]}; FFN calls by mode {calls}; "
          f"kernel launches {launches}; refreshed after steps {refreshed}; "
          f"retries {len(monitor.failures)}", flush=True)
    if not all(math.isfinite(x) for x in losses) or len(hist) != steps:
        fail(f"training losses are not all finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the last loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if monitor.failures:
        fail(f"training retried: {monitor.failures}")
    if refreshed != [4, 8, 12]:
        fail(f"f(W) was refreshed after steps {refreshed}, not 4, 8, 12")
    if calls != dict(dict.fromkeys(dsg_linear.FFN_MODES, 0),
                     mask=2 * n * steps):
        fail(f"the FFN did not take the masked DSG path in every layer of "
             f"every step (forward and remat): {calls}")
    # smoke width: the same 4 steps on the card and on the CPU
    t0 = time.perf_counter()
    card_losses, card_masks = smoke_training(dev)
    cpu_losses, cpu_masks = smoke_training(torch.device("cpu"))
    differ = sum(int((a != b).sum()) for a, b in zip(card_masks, cpu_masks))
    out["smoke"] = {"card_losses": card_losses, "cpu_losses": cpu_losses,
                    "masks": len(card_masks), "groups_differ": differ}
    print(f"[train] smoke width, 4 steps: losses on the card {card_losses}, "
          f"on the CPU {cpu_losses}; {len(card_masks)} masks, {differ} "
          f"groups differ; {time.perf_counter() - t0:.2f}s", flush=True)
    if len(card_losses) != 4 or len(card_masks) != len(cpu_masks) or differ \
            or any(abs(a - b) > 1e-5 * abs(b)
                   for a, b in zip(card_losses, cpu_losses)):
        fail("smoke-width training on the card differs from the CPU")
    return out


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


def graph_serve(cfg, model, dsg, eng_kw, wrappers, requests, drive=None,
                expect_ok=None):
    """A chunked engine at full width through CUDA graphs: warmup_engine
    captures every key the requests can reach (the sampling ones too when
    they sample); then the kernels' counters are set to 0 and `drive`
    (default: run_engine) serves the requests.  A replay runs its kernels
    without calling the wrappers, so their counters now hold the eager
    launches (the DRS kernels' at admission, on the tc path) and what any
    capture made during the run recorded.  The graph cache's captured
    launches x replays must give paged decode and the CSR FFN layers x
    chunk x replays, on the split and union paths, and the DRS kernels
    layers x refresh replays, on the GEMV path; the DRS kernels' eager
    launches are layers x the admissions that ran a prefill.  Every
    request must finish ok (`expect_ok` of them, when given).  Returns
    (stats, launches by kernel, graph accounting, streams)."""
    import torch
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import run_engine, warmup_engine
    eng = ServingEngine(cfg, model, dsg, **eng_kw)
    t0 = time.perf_counter()
    warmup_engine(eng, cfg.vocab, requests=requests)
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
    stats = (drive or run_engine)(eng, requests)
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
    prefills = stats["admissions"] - stats.get("prefill_cache_hits", 0)
    admitted = cfg.n_layers * prefills
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
                 f"replays replayed and {cfg.n_layers} x {prefills} "
                 f"prefills eager (DRS kernels)")
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
    ok = len(requests) if expect_ok is None else expect_ok
    if stats["requests"] != len(requests) or stats["ok_requests"] != ok:
        fail(f"{ok} of {len(requests)} requests must finish ok: {stats}")
    streams = {u: list(r.output) for u, r in eng.done.items()}
    stats["statuses"] = dict(Counter(r.status for r in eng.done.values()))
    return stats, launches, acct, streams


def eager_serve(cfg, model, dsg, eng_kw, wrappers, requests):
    """An eager (chunk 1) engine at full width after warmup_engine: the
    kernels' counters set to 0 just before the run and read just after
    must give paged decode and the CSR FFN layers x decode steps, and the
    DRS kernels layers x (prefills + refresh steps).  Every request must
    finish ok.  Returns (stats, launches by kernel, streams)."""
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import run_engine, warmup_engine
    eng = ServingEngine(cfg, model, dsg, **eng_kw)
    warmup_engine(eng, cfg.vocab, requests=requests)
    for w in wrappers.values():
        w.launches = 0
    stats = run_engine(eng, requests)
    launches = {n: w.launches for n, w in wrappers.items()}
    drs = cfg.n_layers * (stats["admissions"]
                          - stats.get("prefill_cache_hits", 0)
                          + stats["refresh_steps"])
    want = {"paged_decode": cfg.n_layers * stats["steps"],
            "dsg_ffn_csr": cfg.n_layers * stats["steps"],
            "drs_project": drs, "drs_scores": drs}
    if launches != want or not all(launches.values()):
        fail(f"the eager run launched {launches}, expected {want}")
    if stats["ok_requests"] != len(requests):
        fail(f"not every eager request finished ok: {stats}")
    return stats, launches, {u: list(r.output) for u, r in eng.done.items()}


def solo_drive(eng, requests):
    """Serve each request alone through `eng`, one after another; the
    stats of all of them together."""
    from repro_torch.serving.workload import engine_stats
    t0 = time.perf_counter()
    for r in requests:
        eng.submit(r)
        eng.run()
    return engine_stats(eng, dict(eng.done), time.perf_counter() - t0)


def fixed_lanes(cfg, model, dsg, eng_kw, chunk, max_new=32):
    """4 requests whose prompts share one bucket (100-120 tokens, bucket
    128) with `max_new` tokens each, all admitted at step 0 into 4 lanes,
    so the co-scheduling at chunk 1 and chunk `chunk` is the same:
    (streams, engine, stats)."""
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import mixed_requests, run_engine
    eng = ServingEngine(cfg, model, dsg, **dict(eng_kw, decode_chunk=chunk))
    reqs = mixed_requests(cfg.vocab, 4, seed=SEED + 4,
                          prompt_range=(100, 120),
                          max_new_range=(max_new, max_new))
    stats = run_engine(eng, reqs)
    if stats["ok_requests"] != 4 or eng.admissions != 4:
        fail(f"the fixed-lane run at chunk {chunk} did not finish: {stats}")
    return {u: list(r.output) for u, r in eng.done.items()}, eng, stats


def fixed_lane_streams(cfg, model, dsg, eng_kw, chunk):
    """Phase 11: `fixed_lanes`' streams, 32 new tokens a lane."""
    return fixed_lanes(cfg, model, dsg, eng_kw, chunk)[0]


# -- phase 20: the router ---------------------------------------------------

def one_engine(cfg, model, dsg, eng_kw, requests, warm=True):
    """One engine serving `requests`, warmed first unless `warm` is false
    (then the run captures each graph key it meets): (streams, engine,
    stats)."""
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import run_engine, warmup_engine
    eng = ServingEngine(cfg, model, dsg, **eng_kw)
    if warm:
        warmup_engine(eng, cfg.vocab)
    stats = run_engine(eng, requests)
    if stats["ok_requests"] != len(requests):
        fail(f"one engine did not finish every request ok: {stats}")
    return {u: list(r.output) for u, r in eng.done.items()}, eng, stats


def router_run(router, wrappers, requests, faults=None, profile=False):
    """Serve `requests` through a warmed router from a clean slate (the
    engines' results, counters and graph replays, the router's counters
    and health), with the kernels' counters set to 0 just before and read
    just after.  A kernel's launches are the wrappers' eager ones plus the
    graph caches' captured launches x replays (each replica's chunk graphs
    and the sharded executor's group graphs); a capture during the run
    fails the phase.  Returns (streams, stats, launches by kernel and by
    path, the injector, the profile's busy summary or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.runtime.fault_tolerance import ServingFaultInjector
    from repro_torch.serving.workload import router_stats
    for e in router.engines:
        e.done.clear()
        e.steps = e.admissions = e.refresh_steps = 0
        e.decode_seconds, e.decode_tokens = 0.0, 0
        e.fault_injector = None
        if e.graphs is not None:
            e.graphs.replays.clear()
    caches = [e.graphs for e in router.engines if e.graphs is not None]
    group = getattr(router.executor, "graphs", None)
    if group is not None:
        group.replays.clear()
        caches.append(group)
    keys = [set(c.graphs) for c in caches]
    router.reset_counters()
    router.reset_health()
    injector = None
    if faults:
        injector = ServingFaultInjector(faults)
        injector.attach(router.engines)
    for w in wrappers.values():
        for name in [n for n in vars(w) if n.startswith("launches")]:
            setattr(w, name, 0)
    for r in requests:
        router.submit(r)
    prof = None
    t0 = time.perf_counter()
    if profile:
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            done = router.run()
            torch.cuda.synchronize()
    else:
        done = router.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    router.close()
    if keys != [set(c.graphs) for c in caches]:
        fail(f"a graph was captured during the {router.executor.name} "
             f"router's run")
    launches = {}
    for n, w in wrappers.items():
        launches[n] = {name: getattr(w, name) + sum(c.launches(w, name)
                                                    for c in caches)
                       for name in vars(w) if name.startswith("launches")}
    stats = router_stats(router, done, wall, injector)
    streams = {u: list(r.output) for u, r in done.items()}
    return streams, stats, launches, injector, (busy(prof) if profile
                                                else None)


def router_phase(cfg, model, dsg, wrappers) -> dict:
    """Phase 20: the router over 2 replicas x 4 slots at full width, DSG
    serving on, paged, chunk 8, on 16 skewed requests (every other one
    heavy: prompts 96-160, 40-56 new tokens; light: 8-24, 2-4 new).  See
    the module docstring."""
    import torch
    from repro_torch.runtime.fault_tolerance import ReplicaFault
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    from repro_torch.serving.router import Router, get_policy
    from repro_torch.serving.workload import skewed_requests, warmup_router
    kw = dict(n_slots=4, max_seq=512, prompt_bucket=256,
              cache_backend="paged", page_size=16, decode_chunk=8,
              dsg_serving=DSGServingConfig(refresh_interval=8))

    def traffic():
        return skewed_requests(cfg.vocab, 16, period=2, seed=SEED)
    heavy = {r.uid for r in traffic() if r.uid % 2 == 0}
    out = {}
    torch.cuda.reset_peak_memory_stats()

    def show(line):
        print(line, flush=True)

    t0 = time.perf_counter()
    want, eng1, st1 = one_engine(cfg, model, dsg, kw, traffic())
    topk_flops = eng1.dsg_rt.flop_stats()
    out["one_engine"] = {"tokens": st1["tokens"], "wall_s": st1["wall_s"]}
    del eng1

    def check(tag, streams, stats, launches, need, ref=want):
        same = sum(streams.get(u) == ref[u] for u in ref)
        ok = stats["ok_requests"]
        per = [sum(1 for u, r in stats["dispatch_log"] if r == i and u in
                   heavy) for i in range(2)] if "dispatch_log" in stats \
            else None
        total = {n: launches[n]["launches"] for n in launches}
        show(f"[router {tag}] {ok} of 16 ok, {same} of 16 streams equal one "
             f"engine's; {stats['tokens']} tokens; "
             f"{'measured' if stats['makespan_measured'] else 'modeled'} "
             f"makespan {stats['makespan_s']:.3f} s = "
             f"{stats['parallel_tok_per_s']:.2f} tok/s (wall "
             f"{stats['wall_s']:.3f} s); heavy dispatches per replica {per}; "
             f"busy s {[round(p['busy_s'], 4) for p in stats['per_replica']]}"
             f"; launches {total}")
        if ok != 16 or same != 16:
            fail(f"router {tag}: {ok} of 16 ok and {same} of 16 streams "
                 f"equal one engine's: a replica changed a lane's stream")
        for n in need:
            if not total[n]:
                fail(f"router {tag}: {n} launched no time")
        return total

    def log_of(router, stats):
        stats["dispatch_log"] = list(router.dispatch_log)
        return stats

    # (a) round_robin and least_queue, sequential executor
    seq = Router(cfg, model, dsg, n_replicas=2, exec_mode="sequential",
                 fault_tolerance=True, **kw)
    warmup_router(seq, cfg.vocab)
    graphs_per_replica = [len(e.graphs.graphs) for e in seq.engines]
    phase = {}
    for pol in ("round_robin", "least_queue"):
        seq.policy = get_policy(pol)
        streams, st, launches, _, _ = router_run(seq, wrappers, traffic())
        st = log_of(seq, st)
        phase[f"router_seq_{pol}"] = check(f"sequential {pol}", streams, st,
                                           launches, wrappers)
        out[f"sequential_{pol}"] = st
    rr, lq = out["sequential_round_robin"], out["sequential_least_queue"]
    show(f"[router] least_queue against round_robin (modeled): makespan "
         f"{lq['makespan_s']:.3f} / {rr['makespan_s']:.3f} s = "
         f"{rr['makespan_s'] / lq['makespan_s']:.3f}x; graphs per replica "
         f"{graphs_per_replica}")

    # (b) least_queue, threaded: a worker thread and a stream per replica
    thr = Router(cfg, model, dsg, n_replicas=2, exec_mode="threaded",
                 fault_tolerance=True, **kw)
    warmup_router(thr, cfg.vocab)
    streams, st, launches, _, _ = router_run(thr, wrappers, traffic())
    phase["router_threaded"] = check("threaded least_queue", streams,
                                     log_of(thr, st), launches, wrappers)
    out["threaded_least_queue"] = st
    _, stp, _, _, prof = router_run(thr, wrappers, traffic(), profile=True)
    out["threaded_profiled"] = {"makespan_s": stp["makespan_s"],
                                "busy": prof}
    share = ("not measured" if prof is None else
             f"{100 * prof['busy_share']:.1f}% ({prof['busy_ms']:.1f} ms "
             f"of a {prof['window_ms']:.1f} ms window)")
    show(f"[router] threaded measured makespan {st['makespan_s']:.3f} s "
         f"against the sequential modeled {lq['makespan_s']:.3f} s and "
         f"wall {lq['wall_s']:.3f} s; device busy over a profiled threaded "
         f"drive {share}")

    # (c) failover: a kill on replica 1 and a poison on replica 0
    faults = [ReplicaFault(replica=1, step=16),
              ReplicaFault(replica=0, step=32, kind="poison")]
    for tag, router in (("sequential", seq), ("threaded", thr)):
        router.policy = get_policy("least_queue")
        streams, st, launches, inj, _ = router_run(router, wrappers,
                                                   traffic(), faults=faults)
        phase[f"router_failover_{tag}"] = check(
            f"failover {tag}", streams, log_of(router, st), launches,
            wrappers)
        show(f"[router failover {tag}] faults fired {inj.log}; retries "
             f"{st['retries']}; health {st['replica_health']}; restarts "
             f"{[h.restarts for h in router.health]}")
        if (len(inj.log) != 2 or st["retries"] < 1
                or st["replica_health"] != ["healthy", "healthy"]):
            fail(f"failover {tag}: every fault must fire once, a request "
                 f"retry and each replica end healthy within its budget: "
                 f"{inj.log}, {st}")
        out[f"failover_{tag}"] = st
    del seq, thr

    # (d) sharded, DSG serving off: the decode step runs DSG's masked FFN
    # with a per-row top-k threshold, so a lane's groups are its own (the
    # config's shared threshold, row 0's, couples co-resident lanes)
    cfg_rows = replica_cfg(cfg)
    kw_rows = dict(kw, dsg_serving=None)
    want_rows, eng0, _ = one_engine(cfg_rows, model, dsg, kw_rows, traffic())
    del eng0
    for chunk in (1, 8):
        # fault tolerance at chunk 8 for phase 28's failover reference (it
        # changes nothing while no replica fails)
        sh = Router(cfg_rows, model, dsg, n_replicas=2, exec_mode="sharded",
                    fault_tolerance=True if chunk == 8 else None,
                    **dict(kw_rows, decode_chunk=chunk))
        warmup_router(sh, cfg_rows.vocab)
        ex = sh.executor
        ticks = Counter()
        group = ex._group

        def counted(*a, group=group, ticks=ticks):
            ticks["groups"] += 1
            return group(*a)
        ex._group = counted
        streams, st, launches, _, _ = router_run(sh, wrappers, traffic())
        replays = sum(ex.graphs.replays.values())
        split = ex.graphs.launches(wrappers["paged_decode"],
                                   "launches_split")
        want_pd = cfg.n_layers * chunk * 2 * replays
        phase[f"router_sharded_chunk{chunk}"] = check(
            f"sharded chunk {chunk}", streams, log_of(sh, st), launches,
            ("paged_decode",), ref=want_rows)
        show(f"[router sharded chunk {chunk}] {ticks['groups']} group "
             f"ticks, {replays} replays of {len(ex.graphs.graphs)} group "
             f"graphs; paged_decode replayed {split} split launches "
             f"(expected {cfg.n_layers} x {chunk} x 2 x {replays} = "
             f"{want_pd}); group pool {ex.graphs.pool_bytes / 1e6:.1f} MB")
        if replays != ticks["groups"] or split != want_pd or not replays \
                or launches["paged_decode"]["launches"] != want_pd:
            fail(f"sharded chunk {chunk}: one replay a tick and "
                 f"{want_pd} split paged launches expected: {replays} "
                 f"replays, {ticks['groups']} ticks, {split} split, "
                 f"{launches['paged_decode']}")
        out[f"sharded_chunk{chunk}"] = dict(st, ticks=ticks["groups"],
                                            replays=replays)
        if chunk == 8:
            # phase 28's reference: the one-process group, fault-free and
            # under kill@1:6
            ex._group = group
            out["replica_ref"] = {
                "run": replica_run(sh, traffic()),
                "failover": replica_run(sh, traffic(), [REPLICA_FAULT])}
            ref = out["replica_ref"]
            retries = sum(r for _, r in ref["failover"]["status"].values())
            show(f"[router sharded chunk 8] phase 28's reference: makespan "
                 f"{ref['run']['makespan']:.3f} s, {ref['run']['ticks']} "
                 f"ticks; under kill@{REPLICA_FAULT[0]}:{REPLICA_FAULT[1]} "
                 f"health {ref['failover']['health']}, retries {retries}")
        del sh, ex
    try:
        Router(cfg, model, dsg, n_replicas=2, exec_mode="sharded", **kw)
    except NotImplementedError as e:
        show(f"[router] a sharded router over DSG-serving engines raises: "
             f"{e}")
    else:
        fail("a sharded router over DSG-serving engines did not raise")

    # (e) the per-lane EMA threshold on one engine at chunk 8
    kw_ema = dict(kw, dsg_serving=DSGServingConfig(refresh_interval=8,
                                                   threshold="ema"))
    t_ema = time.perf_counter()
    # not warmed: "ema" counts float over every CSR bucket, and warming
    # them all captures 84 graphs; the run captures the keys it meets
    _, eng_e, st_e = one_engine(cfg, model, dsg, kw_ema, traffic(),
                                warm=False)
    ema_flops = eng_e.dsg_rt.flop_stats()
    show(f"[router ema] one engine, threshold ema, chunk 8: "
         f"{st_e['ok_requests']} of 16 ok; modeled FFN reduction "
         f"{ema_flops['flop_reduction_csr']:.3f}x (CSR), "
         f"{ema_flops['flop_reduction_bound']:.3f}x (bound) against topk's "
         f"{topk_flops['flop_reduction_csr']:.3f}x / "
         f"{topk_flops['flop_reduction_bound']:.3f}x; "
         f"{len(eng_e.graphs.graphs)} graphs captured in "
         f"{eng_e.graphs.capture_seconds:.2f} s; "
         f"{time.perf_counter() - t_ema:.2f}s")
    out["ema"] = {"flop_stats": ema_flops, "topk_flop_stats": topk_flops,
                  "stats": st_e, "graphs": len(eng_e.graphs.graphs)}
    del eng_e
    # the phase's peak: the weights once, and the routers' engines (their
    # pools and graph pools) alive one router at a time
    out["memory"] = {"max_allocated_gb":
                     torch.cuda.max_memory_allocated() / 1e9}
    show(f"[router] peak allocated over the phase "
         f"{out['memory']['max_allocated_gb']:.3f} GB")
    out["seconds"] = time.perf_counter() - t0
    return out, phase


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
    device time at 1, 2, 4 and 8 splits of each lane's walk, each output
    held against the plain version and each pool against the plain
    version's writes."""
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
    print(f"[splits] paged_decode (split): plan {plan.splits} splits a "
          f"lane ({plan.blocks} blocks); device ms by splits a lane "
          + ", ".join(f"{sp}: {ms:.4f}" for sp, ms in by.items()),
          flush=True)
    return {"plan": plan.splits, "ms_by_splits": by}


# -- phases 21-22: the other decoder families at full width ----------------

MOE_ARCH = "deepseek-moe-16b"
MOE_LAYERS = 14                    # phase 21's depth of the 28 (widths kept)
DENSE_ARCHS = ("llama3.2-3b", "phi3-mini-3.8b", "mistral-nemo-12b")
SMOKE_FAMILY_ARCHS = (MOE_ARCH, "llava-next-34b")


def serve_kernels() -> dict:
    """The four serve-path kernels: name -> (wrapper, its `ops` entry
    point, plain version, cost, the paths the wrapper counts)."""
    from repro_torch.kernels import drs_search, dsg_ffn, paged_attention
    return {"paged_decode": (paged_attention.paged_decode,
                             "paged_decode_attention",
                             paged_attention.paged_decode_plain, paged_cost,
                             ("split", "serial")),
            "dsg_ffn_csr": (dsg_ffn.dsg_ffn_csr, "dsg_ffn_csr",
                            dsg_ffn.dsg_ffn_csr_plain, csr_cost,
                            ("union", "lanes")),
            "drs_project": (drs_search.drs_project, "drs_project",
                            drs_search.drs_project_plain, project_cost,
                            ("gemv", "tc", "simt")),
            "drs_scores": (drs_search.drs_scores, "drs_scores",
                           drs_search.drs_scores_plain, scores_cost,
                           ("gemv", "tc", "simt"))}


# one PyTorch call that computes the same function as the kernel, where
# there is one
LIBRARY = {"drs_project": lambda x, r: x @ r.t()}


def plan_path(name, args, kwargs) -> str:
    """The path the plan of kernel `name` picks for one captured call."""
    from repro_torch.kernels import drs_search
    if name == "paged_decode":
        return paged_plan(args, kwargs).path
    if name == "dsg_ffn_csr":
        return csr_plan(args, kwargs).path
    if name == "drs_scores":
        return scores_plan(args, kwargs).path
    (m, d), k = args[0].shape, args[1].shape[0]
    return drs_search.project_plan(m, k, d, args[0].dtype).path


def traced(cfg, names, drive, lanes):
    """drive() with the `ops` entry points of the kernels `names` wrapped
    in Captures that tally each call's planned path and keep layer 0's
    call of decode step CAPTURE_STEP (the decode kernels) or layer 0's
    first call at admission and at a refresh, M = `lanes` (the DRS
    kernels); the wrappers' counters are set to 0 just before and read
    just after.  Fails unless every kernel launched, every launch took
    the path its shape plans, and every capture was made.  Returns
    (drive's result, launches, launches by path, captures, refresh
    captures)."""
    from repro_torch.kernels import ops
    ks = serve_kernels()
    caps, refresh, outer = {}, {}, {}
    for name in names:
        _, op, _, _, _ = ks[name]
        drs = name.startswith("drs")
        caps[name] = outer[name] = Capture(
            getattr(ops, op), 0 if drs else cfg.n_layers * CAPTURE_STEP,
            key=lambda a, kw, name=name: plan_path(name, a, kw))
        if drs:
            refresh[name] = outer[name] = Capture(
                caps[name], 0, when=lambda a: a[0].shape[0] == lanes)
        setattr(ops, op, outer[name])
    try:
        for name in names:
            wrapper, _, _, _, ps = ks[name]
            wrapper.launches = 0
            for path in ps:
                setattr(wrapper, f"launches_{path}", 0)
        result = drive()
        launches = {n: ks[n][0].launches for n in names}
        by_path = {n: {p: getattr(ks[n][0], f"launches_{p}")
                       for p in ks[n][4]} for n in names}
    finally:
        for name in names:
            setattr(ops, ks[name][1], caps[name].fn)
    for name in names:
        planned = {p: caps[name].tally[p] for p in ks[name][4]}
        if by_path[name] != planned or not launches[name]:
            fail(f"{name} launched {by_path[name]} by path, its shapes plan "
                 f"{planned}")
        if caps[name].args is None or (name in refresh
                                       and refresh[name].args is None):
            fail(f"no call of {name} was captured")
    return result, launches, by_path, caps, refresh


def kernel_line(tag, name, row) -> str:
    lib = ("" if row["library_ms"] is None else
           f" library {row['library_ms']:.4f} ms,")
    timed = (f" {row['ms']:.4f} ms on the device ({row['span_ms']:.4f} ms "
             f"span), {row['call_ms']:.4f} ms a call, plain "
             f"{row['plain_ms']:.4f} ms,{lib}")
    return (f"[{tag}] {name} {row['shapes']}: path {row['path']},{timed} "
            f"bound {row['bound_ms']:.5f} ms by {row['bound_by']}; max abs "
            f"err bf16 {row['max_abs_err']:.3g} f32 "
            f"{row['max_abs_err_f32']:.3g}")


def moe_phase(dev) -> dict:
    """Phase 21: deepseek-moe-16b at full width in bf16 (MOE_LAYERS of its
    28 layers, d 2048, 16 heads / 16 kv, 64 routed experts + 2 shared of
    1408, top-6, vocab 102400) with random weights from a seeded
    torch.Generator and DSG as
    the config sets it (mask mode in every expert and the shared experts,
    gamma 0.5, shared threshold, block 128, k 128), paged (page 16), 4
    slots, max_seq 512.  See the module docstring."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import paged_attention
    from repro_torch.models import api, transformer
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import (mixed_requests, run_engine,
                                              warmup_engine)
    out = {}
    pw = paged_attention.paged_decode
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    torch.cuda.synchronize()

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    out.update(params_b=sum(p.numel() for p in model.parameters()) / 1e9,
               weights_gb=nbytes(model.parameters()) / 1e9,
               dsg_gb=nbytes(dsg.values()) / 1e9,
               init_s=time.perf_counter() - t0)
    print(f"[moe] {MOE_ARCH}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.moe_experts} + {cfg.moe_shared} experts of {cfg.moe_d_ff}, "
          f"top-{cfg.moe_topk}, vocab {cfg.vocab}, {out['params_b']:.3f}B "
          f"params = {out['weights_gb']:.3f} GB in {cfg.dtype}; DSG "
          f"{sorted(dsg)} {out['dsg_gb']:.3f} GB ({cfg.dsg.threshold_mode} "
          f"threshold, k {dsg['r'].shape[0]}); init {out['init_s']:.2f}s",
          flush=True)
    eng_kw = dict(n_slots=4, max_seq=512, prompt_bucket=256,
                  cache_backend="paged", page_size=16)
    kw8 = dict(eng_kw, decode_chunk=8)

    # (a) 4 fixed lanes, eager chunk 1 against chunk 8 graphs, DSG on/off
    t1 = time.perf_counter()
    (eager, _, st1), launches, by_path, caps, _ = traced(
        cfg, ("paged_decode",),
        lambda: fixed_lanes(cfg, model, dsg, eng_kw, 1), 4)
    want = cfg.n_layers * st1["steps"]
    if launches["paged_decode"] != want or by_path["paged_decode"] != {
            "split": want, "serial": 0}:
        fail(f"moe: paged_decode launched {by_path['paged_decode']} in "
             f"{st1['steps']} eager steps, expected {want}, all split")
    graph, eng, st8 = fixed_lanes(cfg, model, dsg, eng_kw, 8)
    replays = sum(eng.graphs.replays.values())
    replayed = eng.graphs.launches(pw, "launches_split")
    if not replays or replayed != cfg.n_layers * 8 * replays:
        fail(f"moe: {replayed} replayed split launches in {replays} "
             f"replays, expected {cfg.n_layers} x 8 x replays")
    del eng
    off1 = fixed_lanes(cfg, model, None, eng_kw, 1)[0]
    off8 = fixed_lanes(cfg, model, None, eng_kw, 8)[0]
    same = sum(eager[u] == graph[u] for u in eager)
    same_off = sum(off1[u] == off8[u] for u in off1)
    out["fixed_lanes"] = {"dsg_on_equal": same, "dsg_off_equal": same_off,
                          "eager_steps": st1["steps"],
                          "eager_tpot_p50_s": st1["tpot_p50_s"],
                          "chunk8_tpot_p50_s": st8["tpot_p50_s"],
                          "chunk8_replays": replays,
                          "dsg_changes_streams": sum(
                              eager[u] != off1[u] for u in eager)}
    print(f"[moe] (a) 4 fixed lanes x 32 tokens: chunk-8 graphs equal eager "
          f"chunk 1 in {same} of 4 (DSG on), {same_off} of 4 (DSG off); "
          f"{replays} replays; TPOT p50 eager "
          f"{1e3 * st1['tpot_p50_s']:.2f} ms, chunk 8 "
          f"{1e3 * st8['tpot_p50_s']:.2f} ms (DSG on); "
          f"{time.perf_counter() - t1:.2f}s", flush=True)
    if same != 4 or same_off != 4:
        fail(f"moe: fixed-lane bf16 streams of the chunk-8 graphs differ "
             f"from the eager chunk-1 streams (DSG on {same} of 4, off "
             f"{same_off} of 4)")

    # (b) 8 mixed requests at chunk 8 through graphs; logits finite
    t1 = time.perf_counter()
    stats, launches_b, acct, _ = graph_serve(
        cfg, model, dsg, kw8, {"paged_decode": pw},
        mixed_requests(cfg.vocab, 8, seed=SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    toks = torch.randint(0, cfg.vocab, (4, 128), generator=gen, device=dev)
    with torch.no_grad():
        logits, _ = transformer.forward(model, dsg, cfg, toks,
                                        last_only=True)
    if not bool(torch.isfinite(logits.float()).all()):
        fail("moe: non-finite logits at full width")
    out["mixed"] = dict(stats, graphs=acct["graphs_captured"],
                        replays=acct["replays"],
                        capture_s=acct["capture_s"],
                        pool_bytes=acct["pool_bytes"],
                        launches=launches_b)
    print(serve_line("moe chunk8", stats) + f"; {acct['replays']} replays of "
          f"{acct['graphs_captured']} graphs, capture {acct['capture_s']:.2f} "
          f"s, graph pool {acct['pool_bytes'] / 1e6:.1f} MB; launches "
          f"{launches_b}; {time.perf_counter() - t1:.2f}s", flush=True)

    # (c) paged_decode against its plain version on layer 0's operands
    row = check_kernel("paged_decode", pw, paged_attention.paged_decode_plain,
                       caps["paged_decode"], paged_cost)
    row.update(path=plan_path("paged_decode", caps["paged_decode"].args,
                              caps["paged_decode"].kwargs),
               launches=launches["paged_decode"],
               launches_by_path=by_path["paged_decode"],
               launches_chunk8=launches_b["paged_decode"])
    out["paged_decode"] = row
    print(kernel_line("moe", "paged_decode", row), flush=True)
    del caps

    # (e) the device's busy share over a profiled chunk-8 run, and one
    # decode micro-step's device time against its byte bound
    t1 = time.perf_counter()
    counted = []
    for _ in range(PROFILE_TRIES):
        # a trace that drops events is taken again, as in profile_serve
        eng = ServingEngine(cfg, model, dsg, **kw8)
        warmup_engine(eng, cfg.vocab)
        reqs = mixed_requests(cfg.vocab, 4, seed=SEED + 2,
                              prompt_range=(64, 128), max_new_range=(24, 24))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st = run_engine(eng, reqs)
        b = busy(prof)
        n_replays = sum(eng.graphs.replays.values())
        split = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and kernel_id(e.name) == "paged_split_kernel")
        counted.append((split, n_replays))
        if b is not None and split == cfg.n_layers * 8 * n_replays:
            break
        del eng
    else:
        fail(f"moe: the device traces of the chunk-8 run never count "
             f"{cfg.n_layers} x 8 x replays split paged kernels: (split "
             f"kernels, replays) {counted}")
    key = max(eng.graphs.replays, key=eng.graphs.replays.get)
    replay = eng.graphs.graphs[key][0].replay
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            replay()
        torch.cuda.synchronize()
    kern_ns = sum(e.time_range.end - e.time_range.start
                  for e in prof.events() if e.device_type == DeviceType.CUDA)
    step_ms = kern_ns / 1e3 / 3 / 8
    b_chunk = busy(prof)
    event_ms = time_ms(replay) / 8
    # bytes one micro-step must read: every weight but the embedding (4
    # rows of it), all 64 experts of every layer included, as the
    # reference's dispatch runs each expert's capacity slots whether a
    # token took them or not, and the DSG buffers; the KV pages (under
    # 0.05 GB at these depths) are left out
    step_bytes = (nbytes(model.parameters()) - nbytes([model.embed])
                  + nbytes(dsg.values()))
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    out["profile"] = dict(b, steps=st["steps"], replays=n_replays,
                          tpot_p50_s=st["tpot_p50_s"], key=str(key),
                          split_kernels=split)
    out["micro_step"] = {"device_ms": step_ms, "event_ms": event_ms,
                         "bound_ms": bound_ms, "bound_gb": step_bytes / 1e9,
                         "gap_x": step_ms / bound_ms,
                         "replay_busy_share": b_chunk["busy_share"],
                         "by_kernel": b_chunk["by_kernel"]}
    print(f"[moe] (e) device busy {b['busy_ms']:.3f} ms of a "
          f"{b['window_ms']:.3f} ms window ({100 * b['busy_share']:.1f}%) "
          f"over 4 x 24 tokens at chunk 8 ({n_replays} replays, {split} "
          f"split paged kernels in the trace), "
          f"{100 * b_chunk['busy_share']:.1f}% over 3 replays of a chunk "
          f"alone; one micro-step "
          f"{step_ms:.3f} ms of kernels ({event_ms:.3f} ms by events "
          f"around a replay / 8) against its byte bound {bound_ms:.3f} ms "
          f"({step_bytes / 1e9:.2f} GB at 3.35 TB/s): "
          f"{step_ms / bound_ms:.2f}x; top kernels "
          f"{[(k['name'][:40], round(k['ms'], 2)) for k in b['by_kernel'][:4]]}"
          f"; {time.perf_counter() - t1:.2f}s", flush=True)
    del eng, replay

    # (d) peak allocated memory over the phase
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"[moe] (d) peak allocated {out['peak_gb']:.3f} GB: weights "
          f"{out['weights_gb']:.3f} GB, DSG {out['dsg_gb']:.3f} GB, KV "
          f"{stats['cache_bytes'] / 1e9:.3f} GB, graph pool "
          f"{acct['pool_bytes'] / 1e9:.3f} GB", flush=True)
    return out


def dense_config_phase(dev, arch) -> dict:
    """Phase 22 for one dense config at full width in bf16, DSG serving on
    (refresh 8), paged (page 16), 4 slots, max_seq 512: 4 fixed lanes x 16
    new tokens at chunk 1 (eager, the four serve kernels traced) and chunk
    8 (graphs), streams equal; each kernel held against its plain version
    on layer 0's operands and timed, with the path its plan took."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    cfg = configs.get_config(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    eng_kw = dict(n_slots=4, max_seq=512, prompt_bucket=256,
                  cache_backend="paged", page_size=16,
                  dsg_serving=DSGServingConfig(refresh_interval=8))
    names = tuple(serve_kernels())
    (eager, _, st1), launches, by_path, caps, refresh = traced(
        cfg, names, lambda: fixed_lanes(cfg, model, dsg, eng_kw, 1, 16), 4)
    drs = cfg.n_layers * (st1["admissions"] + st1["refresh_steps"])
    want = {"paged_decode": cfg.n_layers * st1["steps"],
            "dsg_ffn_csr": cfg.n_layers * st1["steps"],
            "drs_project": drs, "drs_scores": drs}
    if launches != want:
        fail(f"{arch}: the eager run launched {launches}, expected {want}")
    graph, eng, _ = fixed_lanes(cfg, model, dsg, eng_kw, 8, 16)
    replays = sum(eng.graphs.replays.values())
    del eng
    same = sum(eager[u] == graph[u] for u in eager)
    out = {"d": cfg.d_model, "f": cfg.d_ff, "heads": cfg.n_heads,
           "kv": cfg.n_kv, "head_dim": cfg.head_dim,
           "streams_equal": same, "chunk8_replays": replays,
           "launches": launches, "by_path": by_path, "kernels": {}}
    print(f"[configs] {arch}: d {cfg.d_model}, F {cfg.d_ff} "
          f"({cfg.d_ff // cfg.dsg.block} groups), {cfg.n_heads} heads / "
          f"{cfg.n_kv} kv of {cfg.head_dim}, DSG k {dsg['r'].shape[0]}; 4 "
          f"fixed lanes x 16 tokens: chunk-8 graphs equal eager chunk 1 in "
          f"{same} of 4 ({replays} replays); launches by path {by_path}",
          flush=True)
    if same != 4:
        fail(f"{arch}: fixed-lane bf16 streams of the chunk-8 graphs differ "
             f"from the eager chunk-1 streams ({same} of 4)")
    ks = serve_kernels()
    for name in names:
        wrapper, _, plain, cost, _ = ks[name]
        for tag, cap in (("", caps[name]), ("refresh ", refresh.get(name))):
            if cap is None:
                continue
            row = check_kernel(name, wrapper, plain, cap, cost,
                               LIBRARY.get(name))
            row["path"] = plan_path(name, cap.args, cap.kwargs)
            out["kernels"][tag + name] = row
            print(kernel_line(f"configs {arch}", tag + name, row),
                  flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- phases 23-24: the recurrent families at full width --------------------

XLSTM_ARCH = "xlstm-350m"
ZAMBA_ARCH = "zamba2-7b"
# zamba2-7b trains at 2 of its 13 groups (12 Mamba2 blocks, every width
# kept): bf16 weights and grads plus f32 m, v and master weights come to
# 16 bytes a parameter, 104 GB for its 6.52 B, over the card's 80 GB
ZAMBA_TRAIN_GROUPS = 2
GEN_LANES, GEN_PROMPT, GEN_TOKENS = 4, 128, 32


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def state_leaves(state) -> list:
    """The tensors of a (nested) decode-state dict."""
    if state is None:
        return []
    out = []
    for v in state.values():
        out += state_leaves(v) if isinstance(v, dict) else [v]
    return out


def timed_generate(cfg, model, dsg, prompts, gen_tokens):
    """`launch.serve.generate`'s greedy loop through `api.prefill` and
    `api.decode_step`, each call ending in a synchronize: (tokens, prefill
    seconds, each decode step's seconds, the last state, the last
    logits)."""
    import torch
    from repro_torch.models import api
    b, p_len = prompts.shape
    cache = api.make_cache(cfg, b, p_len + gen_tokens, device=prompts.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = api.prefill(model, dsg, cfg, {"tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, steps = [], []
    for i in range(gen_tokens):
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        t0 = time.perf_counter()
        logits, state = api.decode_step(model, dsg, cfg, tok[:, None], state,
                                        p_len + i)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return torch.stack(out, dim=1), prefill_s, steps, state, logits


def profile_calls(fn, active=3, warmup=2) -> dict:
    """`warmup` calls of fn, then `active` traced ones under torch.profiler,
    each ending in a synchronize: busy() over the traced window, with the
    device events and device (busy) ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    traced = []

    def ready(prof):
        # the trace of the active calls, read when it is ready: the
        # profiler clears a cycle's events at its end
        b = busy(prof)
        if b is not None:
            traced.append(dict(b, events=sum(
                1 for e in prof.events() if device_event(e))))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=active,
                                   repeat=1), on_trace_ready=ready) as prof:
        for _ in range(warmup + active):
            fn()
            torch.cuda.synchronize()
            prof.step()
    if not traced:
        return None
    b = traced[0]
    return dict(b, events_per_call=b["events"] / active,
                device_ms_per_call=b["busy_ms"] / active)


def profile_decode(cfg, model, dsg, logits, state, pos, active=3):
    """`profile_calls` over eager decode steps from (logits, state) at
    position pos, each feeding the last step's argmax: 2 warm-up steps
    then `active` traced ones."""
    import torch
    from repro_torch.models import api
    run = {"logits": logits, "state": state, "pos": pos}

    def step():
        tok = torch.argmax(run["logits"], dim=-1)[:, None]
        run["logits"], run["state"] = api.decode_step(
            model, dsg, cfg, tok, run["state"], run["pos"])
        run["pos"] += 1
    return profile_calls(step, active=active)


def decode_bytes(model, dsg, state, lanes) -> int:
    """The bytes one decode step must move: every weight once (the
    embedding's `lanes` rows only), the DSG buffers, and the decode state
    read and written, except the K/V slots, read once (one row of them is
    written)."""
    emb = model.embed
    weights = (nbytes(model.parameters()) - nbytes([emb])
               + lanes * emb.shape[1] * emb.element_size())
    kv = [v for k, v in state.items() if k in ("k", "v")]
    rest = [t for k, v in state.items() if k not in ("k", "v")
            for t in state_leaves({k: v})]
    return (weights + (nbytes(dsg.values()) if dsg else 0) + nbytes(kv)
            + 2 * nbytes(rest))


def recurrent_smoke(device, arch, refresh=None):
    """`arch`'s smoke model (f32, DSG's per-row top-k threshold, as the
    other card == CPU checks) built on the CPU from SEED and moved to
    `device`: (cfg, model, dsg)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(dsg=cfg.dsg._replace(
        threshold_mode="topk", refresh_every=refresh or
        cfg.dsg.refresh_every))
    gen = torch.Generator().manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    return cfg, model.to(device), {k: v.to(device) for k, v in dsg.items()}


def smoke_recurrent_generate(device, arch, prompt) -> list:
    """The smoke model's `generate`: 2 prompts of `prompt` tokens, 8 greedy
    tokens each."""
    import torch
    from repro_torch.launch import serve
    cfg, model, dsg = recurrent_smoke(device, arch)
    prompts = torch.randint(0, cfg.vocab, (2, prompt),
                            generator=torch.Generator().manual_seed(
                                SEED + prompt))
    return serve.generate(cfg, model, dsg, prompts.to(device), 8).tolist()


def smoke_recurrent_training(device, arch, steps=4) -> list:
    """The smoke model's losses over `steps` training steps (batch 4 x seq
    32, refresh every 2) from one CPU initialisation."""
    from repro_torch.launch import train
    cfg, model, dsg = recurrent_smoke(device, arch, refresh=2)
    _, hist, _ = train.train(cfg, steps=steps, global_batch=4, seq_len=32,
                             seed=SEED, device=device, init=(model, dsg),
                             log_every=steps)
    return [h["loss"] for h in hist]


def recurrent_train(dev, cfg, tag, cut="", steps=12, batch=8, seq=256,
                    refresh=4) -> dict:
    """`steps` AdamW steps of cfg (bf16, f32 masters, DSG mask mode, remat)
    on batch x seq tokens of the synthetic stream, f(W) refreshed every
    `refresh` steps: the losses must be finite, and step 0's batch must
    score below its first loss once the last step is taken."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import api
    cfg = cfg.replace(dsg=cfg.dsg._replace(refresh_every=refresh))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, hist, monitor = train.train(
        cfg, steps=steps, global_batch=batch, seq_len=seq, seed=SEED,
        device=dev, log_every=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    n_matmul = n_params - model.embed.numel()
    losses = [h["loss"] for h in hist]
    ms = sorted(1e3 * h["seconds"] for h in hist[1:])
    p50 = ms[len(ms) // 2]
    p95 = ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))]
    tokens = batch * seq
    refreshed = [h["step"] + 1 for h in hist if h["refresh"]]
    # the first loss is step 0's batch on the initial weights; the same
    # batch on the trained weights is the comparison that batch-to-batch
    # noise does not decide (each batch draws its own period and tokens)
    with torch.no_grad():
        batch0 = {k: v.to(dev) for k, v in synthetic.batch_at(
            0, global_batch=batch, seq_len=seq, vocab=cfg.vocab,
            seed=SEED).items()}
        after = float(api.train_loss(model, state["dsg"], cfg, batch0))
    out = {"losses": losses, "batch0_loss_after": after,
           "step_ms_p50": p50, "step_ms_p95": p95,
           "tokens_per_s": 1e3 * tokens / p50,
           "mfu": 6 * n_matmul * tokens / (p50 / 1e3) / PEAK_FLOPS[
               "torch.bfloat16"],
           "n_params": n_params, "n_matmul": n_matmul, "cut": cut,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "refreshed_at": refreshed, "wall_s": wall}
    del state, model
    print(f"[{tag}] train {cfg.name}{cut}: {n_params / 1e9:.3f}B params in "
          f"{cfg.dtype} with f32 masters, DSG {cfg.dsg.mode} gamma "
          f"{cfg.dsg.gamma}, remat, batch {batch} x seq {seq}, {steps} "
          f"AdamW steps, refresh every {refresh}: losses "
          f"{[round(x, 4) for x in losses]}; step ms p50 {p50:.1f} p95 "
          f"{p95:.1f}; step 0's batch {losses[0]:.4f} before, {after:.4f} "
          f"after the last step; {out['tokens_per_s']:.0f} tokens/s; MFU "
          f"{100 * out['mfu']:.2f}% (6 x {n_matmul / 1e9:.3f}B x {tokens} "
          f"tokens / step / 989 TFLOP/s); peak allocated "
          f"{out['peak_gb']:.2f} GB; wall {wall:.2f}s", flush=True)
    if len(hist) != steps or not all(math.isfinite(x) for x in losses):
        fail(f"{tag}: training losses are not all finite: {losses}")
    if not after < losses[0]:
        fail(f"{tag}: step 0's batch scores {after} after the last step, not "
             f"below its first loss {losses[0]}")
    if monitor.failures or refreshed != list(range(refresh, steps + 1,
                                                   refresh)):
        fail(f"{tag}: retries {monitor.failures}, refreshed after "
             f"{refreshed}")
    return out


def logit_agreement(want, got) -> dict:
    """The largest |got - want| and whether the argmax agrees wherever
    want's top-2 margin exceeds twice it (the repo's bf16 rule: elsewhere
    rounding decides it)."""
    import torch
    top2 = torch.topk(want, 2, dim=-1).values
    diff = float((want - got).abs().max())
    equal = (want.argmax(-1) == got.argmax(-1)).tolist()
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    return {"max_abs_diff": diff, "argmax_equal": equal,
            "top2_margin": margin,
            "decided": [m > 2 * diff for m in margin],
            "decided_equal": all(e for e, m in zip(equal, margin)
                                 if m > 2 * diff)}


def continuation(cfg, model, prompts) -> dict:
    """prefill(P - 1) and one decode step against prefill(P)'s last
    logits, DSG off: the config's shared DRS threshold is row 0 of
    whatever one call holds (the first prompt token in a prefill, lane 0's
    token in a decode step), so with DSG on the two calls' masks differ by
    design, in the reference too.  The argmax is held where the top-2
    margin exceeds twice the largest difference: at full width the model
    is chaotic at its random initialisation (the reference's own 24-layer
    f32 logits move by 0.8 under a 1e-7 relative weight perturbation), and
    a prefill of 127 tokens rounds every token unlike one of 128 (the
    GEMMs' blocking follows the shape)."""
    from repro_torch.models import api
    p = prompts.shape[1]
    full, _ = api.prefill(model, None, cfg, {"tokens": prompts}, None)
    _, st = api.prefill(model, None, cfg, {"tokens": prompts[:, :-1]}, None)
    step, _ = api.decode_step(model, None, cfg, prompts[:, -1:], st, p - 1)
    return logit_agreement(full.float(), step.float())


def recurrent_phase(dev, arch) -> dict:
    """Phase 23 (xlstm-350m) or 24 (zamba2-7b) at full width in bf16 with
    random weights from SEED and DSG as the config sets it.  See the module
    docstring."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import dsg_ffn, flash_attention
    from repro_torch.launch import serve
    from repro_torch.models import api
    tag = "xlstm" if arch == XLSTM_ARCH else "zamba"
    cfg = configs.get_config(arch)
    kernels = dict({n: k[0] for n, k in serve_kernels().items()},
                   dsg_ffn=dsg_ffn.dsg_ffn,
                   flash_attention=flash_attention.flash_attention)
    for w in kernels.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    out = {"arch": arch, "params_b": sum(p.numel() for p in
                                         model.parameters()) / 1e9,
           "weights_gb": nbytes(model.parameters()) / 1e9,
           "dsg_gb": nbytes(dsg.values()) / 1e9,
           "init_s": time.perf_counter() - t0}
    print(f"[{tag}] {arch}: {cfg.n_layers} layers, d={cfg.d_model}, vocab "
          f"{cfg.vocab}, {out['params_b']:.3f}B params = "
          f"{out['weights_gb']:.3f} GB in {cfg.dtype}; DSG {sorted(dsg)} "
          f"{out['dsg_gb']:.3f} GB (k {dsg['r'].shape[0]}, "
          f"{cfg.dsg.threshold_mode} threshold); init {out['init_s']:.2f}s",
          flush=True)

    # (a) generate: 4 prompts of 128 tokens, 32 greedy tokens, twice
    t1 = time.perf_counter()
    prompts = torch.randint(0, cfg.vocab, (GEN_LANES, GEN_PROMPT),
                            generator=torch.Generator(device=dev).manual_seed(
                                SEED + 7), device=dev)
    first = serve.generate(cfg, model, dsg, prompts, GEN_TOKENS)
    second, prefill_s, steps_s, state, logits = timed_generate(
        cfg, model, dsg, prompts, GEN_TOKENS)
    equal = torch.equal(first, second)
    if not bool(torch.isfinite(logits.float()).all()):
        fail(f"{tag}: non-finite logits at full width")
    ms = sorted(1e3 * x for x in steps_s)
    prof = profile_decode(cfg, model, dsg, logits, state,
                          GEN_PROMPT + GEN_TOKENS)
    step_bytes = decode_bytes(model, dsg, state, GEN_LANES)
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    out["generate"] = {
        "streams_equal": equal, "prefill_ms": 1e3 * prefill_s,
        "tpot_p50_ms": ms[len(ms) // 2],
        "tpot_p95_ms": ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))],
        "decode_tok_per_s": GEN_LANES * GEN_TOKENS / sum(steps_s),
        "state_gb": nbytes(state_leaves(state)) / 1e9,
        "step_bound_ms": bound_ms, "step_bound_gb": step_bytes / 1e9,
        "profile": prof, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_row": first[0, :8].tolist()}
    g = out["generate"]
    dev_line = ("device time not measured (no device events)" if prof is None
                else f"{prof['events_per_call']:.0f} device events (launches) "
                     f"a step; one step {prof['device_ms_per_call']:.3f} ms "
                     f"on the device against its byte bound "
                     f"{bound_ms:.3f} ms ({step_bytes / 1e9:.3f} GB at "
                     f"3.35 TB/s): "
                     f"{prof['device_ms_per_call'] / bound_ms:.2f}x; device "
                     f"busy {100 * prof['busy_share']:.1f}% of the traced "
                     f"window; top "
                     f"{[(k['name'][:40], round(k['ms'], 2)) for k in prof['by_kernel'][:4]]}")
    print(f"[{tag}] (a) generate {GEN_LANES} x {GEN_PROMPT} prompt tokens, "
          f"{GEN_TOKENS} greedy tokens, twice: streams equal {equal}; "
          f"prefill {g['prefill_ms']:.1f} ms; eager TPOT p50 "
          f"{g['tpot_p50_ms']:.2f} ms p95 {g['tpot_p95_ms']:.2f} ms; decode "
          f"{g['decode_tok_per_s']:.1f} tok/s; state "
          f"{g['state_gb']:.3f} GB; {dev_line}; peak allocated "
          f"{g['peak_gb']:.2f} GB; {time.perf_counter() - t1:.2f}s",
          flush=True)
    if not equal:
        fail(f"{tag}: the two generate runs' streams differ")
    del first, second, state, logits

    if arch == XLSTM_ARCH:
        # (b) decode continues prefill: in the config's bf16 the argmax is
        # held where rounding cannot decide it (a top-2 margin above twice
        # the largest difference); in f32 everywhere
        t1 = time.perf_counter()
        cont = continuation(cfg, model, prompts)
        del model, dsg
        f32 = cfg.replace(dtype="float32")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        m32 = api.init_model(f32, generator=gen, device=dev)
        cont32 = continuation(f32, m32, prompts)
        del m32
        out["continuation"] = {"bf16": cont, "f32": cont32}
        print(f"[{tag}] (b) prefill({GEN_PROMPT - 1}) + one decode step "
              f"against prefill({GEN_PROMPT}), DSG off: bf16 max abs diff "
              f"{cont['max_abs_diff']:.4g}, argmax equal "
              f"{cont['argmax_equal']}, top-2 margins "
              f"{[round(m, 4) for m in cont['top2_margin']]} (decided "
              f"{cont['decided']}); f32 max abs diff "
              f"{cont32['max_abs_diff']:.3g}, argmax equal "
              f"{cont32['argmax_equal']}, top-2 margins "
              f"{[round(m, 4) for m in cont32['top2_margin']]} (decided "
              f"{cont32['decided']}); {time.perf_counter() - t1:.2f}s",
              flush=True)
        if not (cont["decided_equal"] and cont32["decided_equal"]):
            fail(f"{tag}: decode does not continue the prefill: {cont}, "
                 f"f32 {cont32}")
    else:
        del model, dsg
    del prompts
    gc.collect()
    torch.cuda.empty_cache()

    # the smoke model's generate, card == CPU
    t1 = time.perf_counter()
    smoke = {}
    for prompt in (12, 24):
        card = smoke_recurrent_generate(dev, arch, prompt)
        cpu = smoke_recurrent_generate(torch.device("cpu"), arch, prompt)
        smoke[prompt] = card == cpu
    out["smoke_generate_equal"] = smoke
    print(f"[{tag}] smoke generate card == CPU at prompts 12 and 24: "
          f"{smoke}; {time.perf_counter() - t1:.2f}s", flush=True)
    if not all(smoke.values()):
        fail(f"{tag}: smoke generate on the card differs from the CPU")

    # training at full width (zamba2-7b at its depth cut)
    if arch == ZAMBA_ARCH:
        groups = cfg.n_layers // cfg.shared_attn_every
        tcfg = cfg.replace(n_layers=ZAMBA_TRAIN_GROUPS * cfg.shared_attn_every)
        cut = (f" cut to {ZAMBA_TRAIN_GROUPS} of {groups} groups "
               f"({tcfg.n_layers} Mamba2 blocks, every width kept)")
    else:
        tcfg, cut = cfg, " (no cut)"
    out["train"] = recurrent_train(dev, tcfg, tag, cut)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    card_l = smoke_recurrent_training(dev, arch)
    cpu_l = smoke_recurrent_training(torch.device("cpu"), arch)
    out["smoke_train"] = {"card": card_l, "cpu": cpu_l}
    print(f"[{tag}] smoke width, 4 steps: losses on the card {card_l}, on "
          f"the CPU {cpu_l}; {time.perf_counter() - t1:.2f}s", flush=True)
    if len(card_l) != 4 or any(abs(a - b) > 1e-5 * abs(b)
                               for a, b in zip(card_l, cpu_l)):
        fail(f"{tag}: smoke-width training on the card differs from the CPU")
    out["kernel_launches"] = {n: w.launches for n, w in kernels.items()}
    print(f"[{tag}] the port's kernels launched in this phase: "
          f"{out['kernel_launches']} (none lies on this path)", flush=True)
    return out


# -- phase 25: the encoder-decoder family at full width ----------------------

WHISPER_ARCH = "whisper-large-v3"
# 4 lanes of whisper's 30 s window (1500 frames) and 1500 // 8 = 187 prompt
# tokens; make_cache's max_seq 2048 gives 2048 // 8 = 256 decoder slots
WHISPER_LANES, WHISPER_FRAMES, WHISPER_GEN = 4, 1500, 64
WHISPER_MAX_SEQ = 2048
# (c): 2 + 2 layers at full width, 2 lanes, card against CPU in f32 (TF32
# off).  The largest |card - CPU| of the prefill's last logits measured
# 5.96e-6 with DSG on and off (an H100 80GB HBM3); the atol is the f32
# kernels' 1e-4 (TOL), and the argmax must agree wherever the CPU's top-2
# margin exceeds twice it
WHISPER_CPU_LAYERS, WHISPER_CPU_LANES = 2, 2
WHISPER_CPU_ATOL = TOL["torch.float32"][1]


def whisper_inputs(cfg, lanes, frames, kind, device):
    """`api.make_inputs`' concrete batch (frames from default_rng(SEED +
    1), tokens from default_rng(SEED)) for `lanes` x `frames`."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    return api.make_inputs(cfg, ShapeConfig("whisper", frames, lanes, kind),
                           concrete=True, seed=SEED, device=device)


def whisper_flops(cfg, lanes, frames, tokens, slots=None, head_rows=None):
    """Forward FLOPs of the encoder over `frames`, the memory K/V and the
    decoder over `tokens` (attending `slots` cached positions, or the
    tokens causally counted in full when None), split by the type they run
    in: {'encoder': (model dtype, f32), 'memory': ..., 'decoder': ...}.
    Products in the model's dtype; attention scores and P·V in f32 (every
    whisper score is f32); the DRS search (f(x) = x R^T, f(x) f(W)) in the
    model's dtype when DSG is on.  head_rows: rows through the LM head
    (all tokens by default; the prefill's last token only)."""
    from repro_torch.core import dsg_linear as dl
    d, f, h, dh = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    hd, kvd = h * dh, cfg.n_kv * dh
    n_enc = cfg.enc_layers or cfg.n_layers
    k = dl.proj_dim(d, f, cfg.dsg) if cfg.dsg.enabled else 0
    drs = 2 * (d * k + k * f)
    per_frame = d * hd + 2 * d * kvd + hd * d + 2 * d * f
    enc = (n_enc * lanes * frames * (2 * per_frame + drs),
           n_enc * 4 * lanes * h * frames * frames * dh)
    mem = (cfg.n_layers * lanes * frames * 2 * 2 * d * kvd, 0)
    keys = tokens if slots is None else slots
    per_tok = 2 * (d * hd + 2 * d * kvd + hd * d + 2 * d * hd + 2 * d * f)
    head = 2 * d * cfg.vocab * lanes * (tokens if head_rows is None
                                        else head_rows)
    dec = (cfg.n_layers * lanes * tokens * (per_tok + drs) + head,
           cfg.n_layers * 4 * lanes * h * tokens * (keys + frames) * dh)
    return {"encoder": enc, "memory": mem, "decoder": dec}


def flops_ms(flops, dtype) -> float:
    """The least time of (model-dtype, f32) FLOPs at the card's peak rate
    for each type."""
    return 1e3 * (flops[0] / PEAK_FLOPS[str(dtype)]
                  + flops[1] / PEAK_FLOPS["torch.float32"])


def whisper_step_bytes(model, dsg, state, lanes) -> int:
    """The bytes one decode step must move: the decoder's weights but the
    cross-attention's wk and wv (the memory K/V are precomputed), ln_dec,
    the LM head and `lanes` embedding rows, R and f(W) of the decoder, the
    memory K/V, and the self cache read once (the step attends every
    slot) with one row a layer written."""
    emb = model.tok_embed
    weights = [p for n, p in model.named_parameters()
               if n.startswith(("dec_layers.", "ln_dec.", "lm_head"))
               and ".cross.wk" not in n and ".cross.wv" not in n]
    dsg_b = nbytes([dsg["r"], dsg["fw_dec"]]) if dsg else 0
    return (nbytes(weights) + lanes * emb.shape[1] * emb.element_size()
            + dsg_b + nbytes(state["memory"].values())
            + nbytes(state["self"].values()))


def whisper_generate(cfg, model, dsg, inputs, gen_tokens, max_seq):
    """Prefill (its encoder, memory K/V and decoder prompt timed apart,
    each ending in a synchronize) and `gen_tokens` greedy decode steps
    through `api.decode_step`: (tokens (B, gen), the prefill's phases in
    seconds, each step's seconds, the last logits, the state)."""
    import torch
    from repro_torch.models import api, encdec
    b, p_len = inputs["tokens"].shape
    cache = api.make_cache(cfg, b, max_seq, device=inputs["frames"].device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = encdec.encode(model, dsg, cfg, inputs["frames"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mem = encdec.build_memory_kv(model, enc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits, cache = encdec.decode(model, dsg, cfg, inputs["tokens"], mem,
                                      cache=cache, pos0=0, last_only=True)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    del enc
    logits, state = logits[:, -1], {"self": cache, "memory": mem}
    # the split prefill is api.prefill's composition, held to it below
    phases = {"encoder_s": t1 - t0, "memory_kv_s": t2 - t1,
              "decoder_prompt_s": t3 - t2}
    out, steps = [], []
    for i in range(gen_tokens):
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        t0 = time.perf_counter()
        logits, state = api.decode_step(model, dsg, cfg, tok[:, None], state,
                                        p_len + i)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    return torch.stack(out, dim=1), phases, steps, logits, state


def whisper_continuation(cfg, model, inputs, max_seq) -> dict:
    """DSG off: prefill(P - 1) and one decode step against prefill(P)'s
    last logits (the argmax held where the top-2 margin exceeds twice the
    largest difference, `continuation`'s rule)."""
    from repro_torch.models import api
    b, p = inputs["tokens"].shape
    dev = inputs["frames"].device
    full, _ = api.prefill(model, None, cfg, inputs,
                          api.make_cache(cfg, b, max_seq, device=dev))
    _, st = api.prefill(model, None, cfg, dict(
        inputs, tokens=inputs["tokens"][:, :-1]),
        api.make_cache(cfg, b, max_seq, device=dev))
    step, _ = api.decode_step(model, None, cfg, inputs["tokens"][:, -1:], st,
                              p - 1)
    return logit_agreement(full.float(), step.float())


def whisper_cpu_check(dev) -> dict:
    """(c) in f32 with TF32 off: the prefill's last logits on the card
    against the CPU at full width cut to WHISPER_CPU_LAYERS + ..., DSG on
    (the config's) and off; and the smoke model's greedy stream (per-row
    top-k threshold, as the other card == CPU checks) card == CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    full = configs.get_config(WHISPER_ARCH).replace(
        n_layers=WHISPER_CPU_LAYERS, enc_layers=WHISPER_CPU_LAYERS,
        dtype="float32")
    out = {}
    for tag, cfg in (("dsg_on", full), ("dsg_off", full.replace(
            dsg=full.dsg._replace(enabled=False)))):
        gen = torch.Generator().manual_seed(SEED)
        model = api.init_model(cfg, generator=gen, device="cpu")
        dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
        inputs = whisper_inputs(cfg, WHISPER_CPU_LANES, WHISPER_FRAMES,
                                "prefill", "cpu")
        cpu, _ = api.prefill(model, dsg, cfg, inputs, api.make_cache(
            cfg, WHISPER_CPU_LANES, WHISPER_MAX_SEQ, device="cpu"))
        model = model.to(dev)
        dsg = None if dsg is None else {k: v.to(dev) for k, v in dsg.items()}
        card, _ = api.prefill(model, dsg, cfg,
                              {k: v.to(dev) for k, v in inputs.items()},
                              api.make_cache(cfg, WHISPER_CPU_LANES,
                                             WHISPER_MAX_SEQ, device=dev))
        agree = logit_agreement(cpu, card.cpu())
        agree["argmax_held"] = all(
            e for e, m in zip(agree["argmax_equal"], agree["top2_margin"])
            if m > 2 * WHISPER_CPU_ATOL)
        out[tag] = agree
        print(f"[whisper] (c) {tag}: card against CPU {agree}", flush=True)
        del model, dsg
    smoke = {}
    for device in (dev, torch.device("cpu")):
        cfg = configs.get_smoke_config(WHISPER_ARCH)
        cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
        gen = torch.Generator().manual_seed(SEED)
        model = api.init_model(cfg, generator=gen, device="cpu")
        dsg = {k: v.to(device) for k, v in api.init_dsg(
            model, cfg, generator=gen, device="cpu").items()}
        model = model.to(device)
        inputs = whisper_inputs(cfg, 2, 64, "prefill", device)
        logits, st = api.prefill(model, dsg, cfg, inputs,
                                 api.make_cache(cfg, 2, 128, device=device))
        toks = []
        for i in range(8):
            tok = torch.argmax(logits, dim=-1)[:, None]
            toks.append(tok[:, 0].tolist())
            logits, st = api.decode_step(model, dsg, cfg, tok, st,
                                         inputs["tokens"].shape[1] + i)
        smoke[device.type] = toks
    out["smoke_streams_equal"] = smoke[dev.type] == smoke["cpu"]
    out["smoke_stream"] = smoke["cpu"]
    return out


def whisper_train(dev, cfg, model, dsg, steps=4) -> dict:
    """(d) `steps` AdamW steps (bf16 weights, f32 masters, remat) of
    `api.train_loss` through `launch.train.trainer_for` on one fixed batch
    of WHISPER_LANES x WHISPER_FRAMES frames and WHISPER_FRAMES // 8
    tokens."""
    import torch
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    batch = whisper_inputs(cfg, WHISPER_LANES, WHISPER_FRAMES, "train", dev)
    torch.cuda.reset_peak_memory_stats()
    state, step_fn, _ = train.trainer_for(
        model, dsg, cfg, adamw.AdamWConfig(warmup=2, total_steps=steps))
    losses, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))     # reads the step back
        ms.append(1e3 * (time.perf_counter() - t0))
    tokens = batch["tokens"].shape[1]
    fl = whisper_flops(cfg, WHISPER_LANES, WHISPER_FRAMES, tokens)
    model_flops = 3 * sum(sum(v) for v in fl.values())
    timed = sorted(ms[1:])
    p50 = timed[len(timed) // 2]
    return {"losses": losses, "step_ms": ms, "step_ms_p50": p50,
            "model_tflop_per_step": model_flops / 1e12,
            "mfu": model_flops / (p50 / 1e3) / PEAK_FLOPS["torch.bfloat16"],
            "master": "master" in state["opt"],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def whisper_phase(dev) -> dict:
    """Phase 25: whisper-large-v3 at full width in bf16 with random weights
    from SEED and DSG as the config sets it.  See the module docstring."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import dsg_ffn, flash_attention
    from repro_torch.models import api, encdec
    tag = "whisper"
    cfg = configs.get_config(WHISPER_ARCH)
    kernels = dict({n: k[0] for n, k in serve_kernels().items()},
                   dsg_ffn=dsg_ffn.dsg_ffn,
                   flash_attention=flash_attention.flash_attention)
    for w in kernels.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    out = {"arch": WHISPER_ARCH,
           "params_b": sum(p.numel() for p in model.parameters()) / 1e9,
           "weights_gb": nbytes(model.parameters()) / 1e9,
           "dsg_gb": nbytes(dsg.values()) / 1e9,
           "init_s": time.perf_counter() - t0}
    print(f"[{tag}] {WHISPER_ARCH}: {cfg.enc_layers} + {cfg.n_layers} "
          f"layers, d={cfg.d_model}, {cfg.n_heads} heads, F={cfg.d_ff}, "
          f"vocab {cfg.vocab}, {out['params_b']:.3f}B params = "
          f"{out['weights_gb']:.3f} GB in {cfg.dtype}; DSG {cfg.dsg.mode} "
          f"gamma {cfg.dsg.gamma} {cfg.dsg.threshold_mode} threshold, k "
          f"{dsg['r'].shape[0]}, {out['dsg_gb']:.3f} GB; init "
          f"{out['init_s']:.2f}s", flush=True)

    # (a) serve: prefill and 64 greedy tokens, twice
    t1 = time.perf_counter()
    inputs = whisper_inputs(cfg, WHISPER_LANES, WHISPER_FRAMES, "prefill",
                            dev)
    p_len = inputs["tokens"].shape[1]
    first, _, _, _, _ = whisper_generate(cfg, model, dsg, inputs,
                                         WHISPER_GEN, WHISPER_MAX_SEQ)
    second, phases, steps_s, logits, state = whisper_generate(
        cfg, model, dsg, inputs, WHISPER_GEN, WHISPER_MAX_SEQ)
    equal = torch.equal(first, second)
    finite = bool(torch.isfinite(logits.float()).all())
    # the split prefill against api.prefill's own
    whole, _ = api.prefill(model, dsg, cfg, inputs, api.make_cache(
        cfg, WHISPER_LANES, WHISPER_MAX_SEQ, device=dev))
    split_equal = torch.equal(torch.argmax(whole, -1), first[:, 0])
    ms = sorted(1e3 * x for x in steps_s)
    slots = state["self"]["k"].shape[2]
    step_bytes = whisper_step_bytes(model, dsg, state, WHISPER_LANES)
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    prof = profile_decode(cfg, model, dsg, logits, state,
                          p_len + WHISPER_GEN)
    with torch.no_grad():
        enc = encdec.encode(model, dsg, cfg, inputs["frames"])
        enc_prof = profile_calls(lambda: encdec.encode(
            model, dsg, cfg, inputs["frames"]), active=2, warmup=1)
        mem_prof = profile_calls(lambda: encdec.build_memory_kv(model, enc),
                                 active=2, warmup=1)
        del enc
    dt = next(model.parameters()).dtype
    fl = whisper_flops(cfg, WHISPER_LANES, WHISPER_FRAMES, p_len,
                       slots=slots, head_rows=1)
    enc_bound = flops_ms(fl["encoder"], dt)
    out["serve"] = {
        "streams_equal": equal, "finite": finite,
        "prefill_first_token_equal": split_equal,
        "prompt_tokens": p_len, "decoder_slots": slots,
        "prefill_ms": {k[:-2] + "_ms": 1e3 * v for k, v in phases.items()},
        "tpot_p50_ms": ms[len(ms) // 2],
        "tpot_p95_ms": ms[min(len(ms) - 1, int(round(0.95 * (len(ms) - 1))))],
        "decode_tok_per_s": WHISPER_LANES * WHISPER_GEN / sum(steps_s),
        "step_bound_gb": step_bytes / 1e9, "step_bound_ms": step_bound,
        "memory_kv_gb": nbytes(state["memory"].values()) / 1e9,
        "self_cache_gb": nbytes(state["self"].values()) / 1e9,
        "decode_profile": prof, "encoder_profile": enc_prof,
        "memory_kv_profile": mem_prof,
        "encoder_tflop": {"model_dtype": fl["encoder"][0] / 1e12,
                          "f32": fl["encoder"][1] / 1e12},
        "encoder_bound_ms": enc_bound,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_row": first[0, :8].tolist()}
    s = out["serve"]
    dev_line = ("device time not measured (no device events)" if prof is None
                else f"{prof['events_per_call']:.0f} device events "
                     f"(launches) a step; one step "
                     f"{prof['device_ms_per_call']:.3f} ms on the device "
                     f"against its byte bound {step_bound:.3f} ms "
                     f"({step_bytes / 1e9:.3f} GB at 3.35 TB/s): "
                     f"{prof['device_ms_per_call'] / step_bound:.2f}x; "
                     f"device busy {100 * prof['busy_share']:.1f}% of the "
                     f"traced window; top "
                     f"{[(k['name'][:40], round(k['ms'], 2)) for k in prof['by_kernel'][:4]]}")
    enc_line = ("encoder device time not measured" if enc_prof is None
                else f"encoder {enc_prof['device_ms_per_call']:.2f} ms on "
                     f"the device ({enc_prof['events_per_call']:.0f} "
                     f"launches, busy {100 * enc_prof['busy_share']:.1f}%) "
                     f"against its FLOP bound {enc_bound:.2f} ms "
                     f"({fl['encoder'][0] / 1e12:.2f} TFLOP in {cfg.dtype} "
                     f"at 989 TFLOP/s + {fl['encoder'][1] / 1e12:.2f} TFLOP "
                     f"of f32 scores at 67 TFLOP/s): "
                     f"{enc_prof['device_ms_per_call'] / enc_bound:.2f}x")
    pm = s["prefill_ms"]
    if mem_prof is not None:
        enc_line += (f"; memory K/V {mem_prof['device_ms_per_call']:.2f} ms "
                     f"on the device ({mem_prof['events_per_call']:.0f} "
                     f"launches) against its FLOP bound "
                     f"{flops_ms(fl['memory'], dt):.2f} ms")
    print(f"[{tag}] (a) serve {WHISPER_LANES} x {WHISPER_FRAMES} frames + "
          f"{p_len} prompt tokens, {WHISPER_GEN} greedy tokens, twice "
          f"({slots} decoder slots): streams equal {equal}, logits finite "
          f"{finite}; prefill {sum(pm.values()):.1f} ms = encoder "
          f"{pm['encoder_ms']:.1f} + memory K/V {pm['memory_kv_ms']:.1f} + "
          f"decoder prompt {pm['decoder_prompt_ms']:.1f}; {enc_line}; eager "
          f"TPOT p50 {s['tpot_p50_ms']:.2f} ms p95 {s['tpot_p95_ms']:.2f} "
          f"ms; decode {s['decode_tok_per_s']:.1f} tok/s; memory K/V "
          f"{s['memory_kv_gb']:.3f} GB, self cache {s['self_cache_gb']:.3f} "
          f"GB; {dev_line}; peak allocated {s['peak_gb']:.2f} GB; "
          f"{time.perf_counter() - t1:.2f}s", flush=True)
    if not (equal and finite and split_equal):
        fail(f"{tag}: serve: streams equal {equal}, finite {finite}, "
             f"api.prefill's first token equal {split_equal}")
    del first, second, logits, state, whole

    # (b) decode continues the prefill, DSG off, bf16 and f32
    t1 = time.perf_counter()
    cont = whisper_continuation(cfg, model, inputs, WHISPER_MAX_SEQ)
    f32 = cfg.replace(dtype="float32")
    m32 = api.init_model(f32, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    cont32 = whisper_continuation(f32, m32, {
        "frames": inputs["frames"].float(), "tokens": inputs["tokens"]},
        WHISPER_MAX_SEQ)
    del m32
    out["continuation"] = {"bf16": cont, "f32": cont32}
    print(f"[{tag}] (b) prefill({p_len - 1}) + one decode step against "
          f"prefill({p_len}), DSG off: bf16 max abs diff "
          f"{cont['max_abs_diff']:.4g}, argmax equal {cont['argmax_equal']}, "
          f"top-2 margins {[round(m, 4) for m in cont['top2_margin']]} "
          f"(decided {cont['decided']}); f32 max abs diff "
          f"{cont32['max_abs_diff']:.3g}, argmax equal "
          f"{cont32['argmax_equal']}, top-2 margins "
          f"{[round(m, 4) for m in cont32['top2_margin']]} (decided "
          f"{cont32['decided']}); {time.perf_counter() - t1:.2f}s",
          flush=True)
    if not (cont["decided_equal"] and cont32["decided_equal"]):
        fail(f"{tag}: decode does not continue the prefill: {cont}, f32 "
             f"{cont32}")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) train on the same model (its weights are not needed afterwards)
    t1 = time.perf_counter()
    tr = whisper_train(dev, cfg, model, dsg)
    out["train"] = tr
    print(f"[{tag}] (d) train: {out['params_b']:.3f}B params in bf16 with "
          f"f32 masters {tr['master']}, DSG {cfg.dsg.mode}, remat, one batch "
          f"of {WHISPER_LANES} x {WHISPER_FRAMES} frames + "
          f"{WHISPER_FRAMES // cfg.dec_ratio} tokens, 4 AdamW steps: losses "
          f"{[round(x, 4) for x in tr['losses']]}; step ms "
          f"{[round(x, 1) for x in tr['step_ms']]}, p50 of steps 2-4 "
          f"{tr['step_ms_p50']:.1f}; MFU {100 * tr['mfu']:.2f}% (3 x the "
          f"forward's {tr['model_tflop_per_step'] / 3:.2f} TFLOP, "
          f"attention included, / step / 989 TFLOP/s); peak allocated "
          f"{tr['peak_gb']:.2f} GB; {time.perf_counter() - t1:.2f}s",
          flush=True)
    if not (all(math.isfinite(x) for x in tr["losses"])
            and tr["losses"][-1] < tr["losses"][0]):
        fail(f"{tag}: training losses {tr['losses']}")
    del model, dsg
    gc.collect()
    torch.cuda.empty_cache()

    # (c) card against CPU
    t1 = time.perf_counter()
    chk = whisper_cpu_check(dev)
    out["cpu_check"] = chk
    print(f"[{tag}] (c) card against CPU in f32, TF32 off, "
          f"{WHISPER_CPU_LAYERS} + {WHISPER_CPU_LAYERS} layers at full "
          f"width, {WHISPER_CPU_LANES} x {WHISPER_FRAMES} frames: prefill "
          f"logits max abs diff DSG on {chk['dsg_on']['max_abs_diff']:.3g}, "
          f"DSG off {chk['dsg_off']['max_abs_diff']:.3g} (atol "
          f"{WHISPER_CPU_ATOL}); argmax equal "
          f"{chk['dsg_on']['argmax_equal']} / "
          f"{chk['dsg_off']['argmax_equal']}; smoke greedy stream card == "
          f"CPU {chk['smoke_streams_equal']}; "
          f"{time.perf_counter() - t1:.2f}s", flush=True)
    for k in ("dsg_on", "dsg_off"):
        if not (chk[k]["max_abs_diff"] <= WHISPER_CPU_ATOL
                and chk[k]["argmax_held"]):
            fail(f"{tag}: card against CPU {k}: {chk[k]}")
    if not chk["smoke_streams_equal"]:
        fail(f"{tag}: the smoke stream on the card differs from the CPU")
    out["kernel_launches"] = {n: w.launches for n, w in kernels.items()}
    print(f"[{tag}] the port's kernels launched in this phase: "
          f"{out['kernel_launches']} (none lies on this path)", flush=True)
    if any(out["kernel_launches"].values()):
        fail(f"{tag}: a kernel launched on a path that has none")
    return out


# -- phase 26: the dry run's plan against the card --------------------------

ALLOC_SEGMENT = 2 << 20            # the caching allocator's large segment
                                   # multiple: a block keeps the rest of
                                   # its segment when that is too small to
                                   # split off, so it rounds a tensor up by
                                   # less than this
# card peak / dry-run traced peak in phase 26 (b): 1.0013 measured on an
# H100 80GB HBM3 at 700 W (the allocator's 512-byte rounding and the
# cuBLAS workspace above the traced tensors)
PLAN_PEAK_BAND = (0.99, 1.02)
PLAN_STEPS = 6                     # training steps in (c): 1 warm-up + 5


def block_bytes() -> dict:
    """{address: bytes} of the caching allocator's live blocks."""
    import torch
    return {b["address"]: b["size"] for seg in torch.cuda.memory_snapshot()
            for b in seg["blocks"] if b["state"] == "active_allocated"}


def state_allocated() -> int:
    """torch.cuda.memory_allocated() with the cuBLAS workspaces freed
    and the collector run: the bytes of live tensors alone."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def plan_phase(dev) -> dict:
    """Phase 26: `launch.dryrun`'s plan for internlm2-1.8b's phase-19 step
    against the card.  See the module docstring."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic
    from repro_torch.kernels import dsg_ffn, flash_attention
    from repro_torch.launch import dryrun, mesh as lmesh, train
    from repro_torch.models import api, specs
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import P, axes_for_mesh, distribute
    batch, seq = 8, 256
    kernels = dict({n: k[0] for n, k in serve_kernels().items()},
                   dsg_ffn=dsg_ffn.dsg_ffn,
                   flash_attention=flash_attention.flash_attention)
    for w in kernels.values():
        w.launches = 0
    # the ordinary trainer takes the batch whole: the dry run's step too
    cfg = configs.get_config(ARCH).replace(microbatches=1)
    if not (cfg.remat and cfg.dsg.enabled and cfg.dsg.mode == "mask"):
        fail(f"the phase-19 config is not DSG mask mode with remat: {cfg}")
    shape = ShapeConfig("phase19", seq, batch, "train")
    t0 = time.perf_counter()
    rec = dryrun.run_cell(ARCH, shape, mesh="local",
                          overrides=["microbatches=1"])
    out = {"dryrun": rec, "dryrun_s": time.perf_counter() - t0}
    if rec["status"] != "ok":
        fail(f"the dry run of {ARCH} at {batch} x {seq} failed: {rec}")
    mem = rec["memory"]
    want = mem["params"] + mem["dsg"] + mem["opt"]
    print(f"[plan] dry run of {ARCH} x {batch} x {seq} (train, remat, DSG "
          f"mask, 1 x 1 mesh, meta tensors on the host CPU, "
          f"{out['dryrun_s']:.1f}s): params {mem['params']} B, DSG "
          f"{mem['dsg']} B, AdamW with f32 masters {mem['opt']} B; "
          f"{rec['flops']} FLOPs; traced peak {rec['trace_peak_bytes']} B",
          flush=True)

    # (a) the same state on the card, laid out as DTensors on a 1 x 1 mesh
    # of a one-rank NCCL group
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = lmesh.make_local_mesh()
        ax = axes_for_mesh(mesh)
        # the communicator exists before the count; the cuBLAS workspaces
        # (32 MiB a handle and stream, made by the first product that
        # needs one) are freed before each reading
        distribute(torch.ones(4, device=dev), mesh, P())
        base = state_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        model = api.init_model(cfg, generator=gen, device=dev)
        dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
        params = dict(model.named_parameters())
        opt = adamw.init_opt(params, use_master=True)
        pspecs = specs.param_specs(model, cfg, ax, 1)
        ospecs = adamw.opt_specs_with_master(pspecs, params)
        dspecs = specs.dsg_specs(dsg, cfg, ax, 1)
        laid = {"params": {n: distribute(p.detach(), mesh, pspecs[n])
                           for n, p in params.items()},
                "dsg": {k: distribute(v, mesh, dspecs[k])
                        for k, v in dsg.items()},
                "opt": {k: {n: distribute(t, mesh, ospecs[k][n])
                            for n, t in opt[k].items()}
                        for k in ("m", "v", "master")}}
        del model, dsg, params, opt
        added = state_allocated() - base
        locals_ = [t.to_local() for part in laid.values()
                   for t in state_leaves(part)]
        storages = {t.untyped_storage().data_ptr(): t for t in locals_}
        exact = {part: nbytes(t.to_local() for t in state_leaves(laid[part]))
                 for part in laid}
        blocks = block_bytes()
        # each shard's block, as the allocator rounded it
        rounding = [blocks[a] - t.untyped_storage().nbytes()
                    for a, t in storages.items()]
        rounded = sum(exact.values()) + sum(rounding)
        out["state"] = {"added_bytes": added, "local_bytes": exact,
                        "dryrun_bytes": want, "rounded_bytes": rounded,
                        "rounding_bytes": sum(rounding),
                        "max_rounding_bytes": max(rounding),
                        "rounded_tensors": sum(r > 0 for r in rounding),
                        "tensors": len(locals_),
                        "storages": len(storages)}
        print(f"[plan] (a) state on the card as DTensors: "
              f"{len(locals_)} local shards, memory_allocated() +{added} B;"
              f" their bytes {exact} = {sum(exact.values())} B against the "
              f"dry run's {want} B; the allocator's blocks round "
              f"{sum(r > 0 for r in rounding)} of them up by "
              f"{sum(rounding)} B in all (at most {max(rounding)} B one), "
              f"{rounded} B", flush=True)
        if {k: exact[k] for k in ("params", "dsg", "opt")} != {
                k: mem[k] for k in ("params", "dsg", "opt")}:
            fail(f"the card's shards {exact} are not the dry run's {mem}")
        if added != rounded or max(rounding) >= ALLOC_SEGMENT:
            fail(f"the state took {added} B on the card, not the dry run's "
                 f"{want} B in the allocator's blocks ({rounded} B)")
        del laid, locals_, storages
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) one step of the ordinary trainer at the same shape: its peak
    # against the dry run's traced peak; (c) the step's FLOPs and rate
    acfg = adamw.AdamWConfig(total_steps=PLAN_STEPS, warmup=2)
    resident = torch.cuda.memory_allocated()
    state, step_fn, _ = train.build_trainer(cfg, acfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, peak = [], None
    for step in range(PLAN_STEPS):
        b = synthetic.batch_at(step, global_batch=batch, seq_len=seq,
                               vocab=cfg.vocab, seed=SEED)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        if peak is None:
            peak = torch.cuda.max_memory_allocated() - resident
        if not math.isfinite(loss):
            fail(f"step {step} loss {loss}")
    model = state["model"]
    n_matmul = sum(p.numel() for p in model.parameters()) - \
        model.embed.numel()
    del state, model, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    ratio = peak / rec["trace_peak_bytes"]
    p50 = sorted(ms[1:])[len(ms[1:]) // 2]
    six_nt = 6 * n_matmul * batch * seq
    out.update({"peak_bytes": peak, "trace_peak_bytes":
                rec["trace_peak_bytes"], "peak_ratio": ratio,
                "peak_band": PLAN_PEAK_BAND, "step_ms": ms,
                "step_ms_p50": p50, "flops": rec["flops"],
                "flops_6nt": six_nt,
                "tflops_dryrun": rec["flops"] / (p50 / 1e3) / 1e12,
                "tflops_6nt": six_nt / (p50 / 1e3) / 1e12,
                "kernel_launches": {n: w.launches
                                    for n, w in kernels.items()}})
    print(f"[plan] (b) one step of launch.train's trainer at {batch} x "
          f"{seq}: peak {peak} B above the {resident} B resident before "
          f"it, the dry run's traced peak {rec['trace_peak_bytes']} B, "
          f"ratio {ratio:.4f} (band {PLAN_PEAK_BAND})", flush=True)
    print(f"[plan] (c) the step's FLOPs: dry run {rec['flops']}, 6 x N x T "
          f"{six_nt} (N {n_matmul} matmul parameters, T {batch * seq}); "
          f"step ms p50 {p50:.1f} of steps 2-{PLAN_STEPS} {[round(x, 1) for x in ms]}; "
          f"{out['tflops_dryrun']:.1f} TFLOP/s by the dry run's count, "
          f"{out['tflops_6nt']:.1f} by 6NT", flush=True)
    if not PLAN_PEAK_BAND[0] <= ratio <= PLAN_PEAK_BAND[1]:
        fail(f"the card's peak is {ratio:.4f} x the dry run's, outside "
             f"{PLAN_PEAK_BAND}")
    if any(out["kernel_launches"].values()):
        fail(f"a kernel launched in phase 26: {out['kernel_launches']}")
    return out


REC_GROUPS = 2                     # the recurrent training steps of
                                   # phase 26 (b) and --mesh-cards (g) run
                                   # 2 groups (phase 24's cut), every width
                                   # kept


def rec_train_overrides(arch: str, spec=None) -> list:
    """`launch.dryrun` overrides of a recurrent arch's training step in
    phase 26 (b) and `--mesh-cards` (g): REC_GROUPS groups, one
    microbatch (the ordinary trainer takes the batch whole), then
    spec's overrides."""
    from repro_torch import configs
    cfg = configs.get_config(arch)
    every = (cfg.shared_attn_every if cfg.family == "zamba"
             else cfg.slstm_every)
    over = [f"n_layers={REC_GROUPS * every}", "microbatches=1"]
    return over + [f"{k}={v!r}" for k, v in
                   (spec or {}).get("overrides", {}).get(arch, {}).items()]


def rec_train_cfg(arch: str, spec=None):
    from repro_torch import configs
    from repro_torch.launch import dryrun
    return dryrun.apply_overrides(configs.get_config(arch),
                                  rec_train_overrides(arch, spec))


def plan_recurrent(dev) -> dict:
    """Phase 26 (b): `launch.dryrun`'s record of zamba2-7b's phase-24
    training step (REC_GROUPS of its 13 groups, every width kept, batch 8
    x seq 256, bf16 with f32 masters, remat, DSG mask mode) on a 1 x 1
    mesh, against the same step of `launch.train`'s trainer on the card
    with its state laid out as DTensors on `make_local_mesh()` of a
    one-rank NCCL group: the state's shards' bytes equal to the record's
    params + dsg + opt; the peak allocated over building the trainer and
    its first step within PLAN_PEAK_BAND of the traced peak; one more
    step's FLOPs and collectives, counted at dispatch
    (`comm_analysis.analyze`), equal to the record's `analysis`.  The
    record's HBM bytes over 3.35 TB/s are printed beside a profiled
    step's device busy ms and wall ms, not held."""
    import os
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic
    from repro_torch.launch import comm_analysis, dryrun, mesh as lmesh, \
        train
    from repro_torch.models import specs
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import P, axes_for_mesh, distribute
    batch, seq = 8, 256
    over = rec_train_overrides(ZAMBA_ARCH)
    cfg = rec_train_cfg(ZAMBA_ARCH)
    t0 = time.perf_counter()
    rec = dryrun.run_cell(ZAMBA_ARCH, ShapeConfig("phase24", seq, batch,
                                                  "train"),
                          mesh="local", overrides=over)
    out = {"dryrun": rec, "dryrun_s": time.perf_counter() - t0}
    if rec["status"] != "ok":
        fail(f"the dry run of {ZAMBA_ARCH} {over} failed: {rec}")
    mem, a = rec["memory"], rec["analysis"]
    print(f"[plan-b] dry run of {ZAMBA_ARCH} ({over}) x {batch} x {seq} "
          f"(train, 1 x 1 mesh, meta tensors on the host CPU, "
          f"{out['dryrun_s']:.1f}s): params {mem['params']} B, DSG "
          f"{mem['dsg']} B, AdamW {mem['opt']} B; {rec['flops']} FLOPs "
          f"({a['flops']} on the mesh's one device); traced peak "
          f"{rec['trace_peak_bytes']} B; HBM bytes {a['bytes']}",
          flush=True)
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = lmesh.make_local_mesh()
        distribute(torch.ones(4, device=dev), mesh, P())
        base = state_allocated()
        torch.cuda.reset_peak_memory_stats()
        acfg = adamw.AdamWConfig(total_steps=4, warmup=1)
        state, step_fn, _ = train.build_trainer(cfg, acfg, seed=SEED,
                                                device=dev, mesh=mesh)
        model = state["model"]
        shards = {"params": nbytes(p.to_local() for p in model.parameters()),
                  "dsg": nbytes(t.to_local() for t in state["dsg"].values()),
                  "opt": nbytes(t.to_local() for k in ("m", "v", "master")
                                if k in state["opt"]
                                for t in state["opt"][k].values())}
        bspecs = specs.input_specs(synthetic.batch_at(
            0, global_batch=batch, seq_len=seq, vocab=cfg.vocab), cfg,
            axes_for_mesh(mesh))

        def laid(i):
            b = synthetic.batch_at(i, global_batch=batch, seq_len=seq,
                                   vocab=cfg.vocab, seed=SEED)
            return {k: distribute(v.to(dev), mesh, bspecs[k])
                    for k, v in b.items()}

        losses = []
        b = laid(0)
        t1 = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated() - base
        b = laid(1)
        (state, metrics), live = comm_analysis.analyze(
            lambda: step_fn(state, b))
        losses.append(float(metrics["loss"]))
        b = laid(2)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, metrics = step_fn(state, b)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
        prof_busy = busy(prof)
        del state, model, step_fn, b
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    ratio = peak / rec["trace_peak_bytes"]
    bound_ms = 1e3 * a["bytes"] / HBM_BYTES_PER_S
    busy_ms = None if prof_busy is None else prof_busy["busy_ms"]
    out.update({"shard_bytes": shards, "peak_bytes": peak,
                "peak_ratio": ratio, "peak_band": PLAN_PEAK_BAND,
                "losses": losses, "first_step_ms": first_ms,
                "live_analysis": live, "hbm_bytes": a["bytes"],
                "hbm_bound_ms": bound_ms, "step_device_busy_ms": busy_ms,
                "step_wall_ms": wall_ms})
    print(f"[plan-b] on the card as DTensors of a 1 x 1 mesh: shards "
          f"{shards} B against the dry run's params / dsg / opt; the "
          f"trainer's peak over building and its first step {peak} B, "
          f"ratio to the traced peak {ratio:.4f} (band {PLAN_PEAK_BAND}); "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[plan-b] one step counted at dispatch: {live['flops']} FLOPs "
          f"against the record's {a['flops']}; collectives "
          f"{coll_counts(live)} against {coll_counts(a)}; the record's "
          f"HBM bytes {a['bytes']} over 3.35 TB/s = {bound_ms:.1f} ms "
          f"beside a profiled step's device busy "
          f"{'not measured' if busy_ms is None else f'{busy_ms:.1f} ms'} "
          f"and wall {wall_ms:.1f} ms (not held)", flush=True)
    if {k: mem[k] for k in shards} != shards:
        fail(f"the card's shards {shards} are not the dry run's {mem}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"{ZAMBA_ARCH} on the 1 x 1 mesh: losses {losses}")
    if not PLAN_PEAK_BAND[0] <= ratio <= PLAN_PEAK_BAND[1]:
        fail(f"{ZAMBA_ARCH}: the card's peak is {ratio:.4f} x the dry "
             f"run's, outside {PLAN_PEAK_BAND}")
    if live["flops"] != a["flops"] or \
            live["collectives"] != a["collectives"]:
        fail(f"{ZAMBA_ARCH}: the card's step counted {live}, the dry run "
             f"{a}")
    return out


# -- phase 27: the model's parallel parts over a real multi-rank mesh ------

MESH_RANK_FLAG = "--mesh-rank"     # chip_smoke.py --mesh-rank PART RANK N DIR
MESH_RANK_TIMEOUT = 300            # seconds a part's ranks may take
# sharded against unsharded in bf16 within MESH_E_FACTOR x E, with E the
# unsharded function's own bf16-against-f32 gap on the same inputs
# (ROADMAP.md §3's bf16 rule: atol 2E-3E); the top of the band
MESH_E_FACTOR = 3.0
MESH_COLL_TOL = 1e-6               # f32 reductions: of the largest entry
# f32 logits of a whole sharded model against the unsharded ones: of the
# largest entry (ROADMAP.md §3's rule for f32 gradients, 1e-4 of a leaf's
# largest entry)
MESH_F32_TOL = 1e-4
# what gloo takes on CUDA tensors (torch 2.11+cu128, two ranks on one
# H100, by scripts/gloo_cuda_probe.py): all_reduce, broadcast, barrier,
# scatter, all_gather(_into_tensor), reduce_scatter_tensor,
# all_to_all_single and the functional all_reduce / reduce_scatter /
# permute_tensor; send/recv abort the process (gloo writes device memory
# to its socket) and the functional all_gather segfaults, which DTensor's
# Shard -> Replicate takes.  So the whole model's DTensor runs, which
# gather, run on gloo CPU ranks only (the CPU tests):
MESH_CPU_ONLY = (
    "(a) internlm2-1.8b's sharded train_loss, backward and AdamW steps and "
    "(b) deepseek-moe-16b's api.prefill under expert parallelism (the DSG "
    "threshold's row over model-sharded groups and, at decode, q's heads "
    "gather over 'model'), remesh_state and the "
    "global view of make_global_batch: DTensor's all_gather segfaults "
    "under gloo on CUDA tensors; held on gloo CPU ranks by "
    "tests/test_torch_sharded_model.py and tests/test_torch_sharded_train.py")


def mesh_spawn(part: str, n: int, tmp: Path, spec: dict) -> list:
    """Run mesh part `part` (phases 27-28, `--mesh-cards`) in n rank
    processes of this script (a group, gloo unless `spec` names another
    backend, meeting at a FileStore in tmp); returns each rank's
    result."""
    import torch
    (tmp / f"{part}.json").write_text(json.dumps(spec))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), MESH_RANK_FLAG,
         part, str(r), str(n), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    deadline = time.monotonic() + MESH_RANK_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"mesh part {part}: rank {r} exited {p.returncode}:\n"
                 f"{err[-3000:]}")
    return [torch.load(tmp / f"{part}_{r}.pt", weights_only=False)
            for r in range(n)]


def mesh_worker(argv) -> int:
    """One rank of a mesh part (a process this script starts)."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    part, rank, n, tmp = argv[0], int(argv[1]), int(argv[2]), Path(argv[3])
    spec = json.loads((tmp / f"{part}.json").read_text())
    dev = torch.device(spec["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(max(1, 8 // n))
    if dev.type == "cuda":
        torch.cuda.set_device(rank if spec.get("card_per_rank") else 0)
    dist.init_process_group(
        spec.get("backend", "gloo"),
        store=dist.FileStore(str(tmp / f"store_{part}"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=240))
    try:
        out = MESH_PARTS[part](rank, dev, spec)
        out["kernel_launches"] = mesh_launches()
        torch.save(out, tmp / f"{part}_{rank}.pt")
    finally:
        dist.destroy_process_group()
    return 0


def mesh_launches() -> dict:
    """The six kernels' wrappers' launch counts in this process."""
    return {n: getattr(w, "launches", 0) for n, w in six_kernels().items()}


def mesh_cfg(arch: str, spec: dict):
    from repro_torch import configs
    cfg = configs.get_config(arch)
    return cfg.replace(**spec.get("overrides", {}).get(arch, {}))


def host_ms(fn, reps: int = 5) -> tuple:
    """(median, all) wall ms of `fn` ending in a synchronise, after one
    warm-up call."""
    import torch
    fn()
    ms = []
    for _ in range(reps):
        sync = torch.cuda.synchronize if torch.cuda.is_available() \
            else (lambda: None)
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    return sorted(ms)[len(ms) // 2], ms


def collective_ms(fn) -> dict:
    """Host time of the process group's collectives in one call of `fn`,
    from torch.profiler's CPU events (gloo runs its CUDA collectives from
    the host), beside the call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    coll = {}
    for e in prof.key_averages():
        if e.key.startswith(("c10d::", "_c10d_functional::", "gloo:")):
            coll[e.key] = e.cpu_time_total / 1e3
    return {"wall_ms": wall, "collective_ms": coll}


def ffn_case(cfg, dev, dtype, tokens):
    """Seeded inputs of one SwiGLU FFN at cfg's width: weights, DSG state
    (R, f(W) = R W_gate), x and the output cotangent."""
    import torch
    from repro_torch.core import dsg_linear as dl
    from repro_torch.core.projection import make_projection
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)
    w = {"w_gate": normal((d, f), d ** -0.5), "w_up": normal((d, f), d ** -0.5),
         "w_down": normal((f, d), f ** -0.5)}
    r = make_projection(dl.proj_dim(d, f, cfg.dsg), d, generator=gen,
                        dtype=dtype, device=dev)
    x = normal((tokens[0], tokens[1], d), 1.0)
    gy = normal((tokens[0], tokens[1], d), 1.0)
    return w, {"r": r, "fw": r @ w["w_gate"]}, x, gy


def mesh_tp(rank, dev, spec) -> dict:
    """Part (a) on a (data 1, model 2) mesh of two ranks: internlm2-1.8b's
    trainer state laid out by `launch.train.build_trainer(mesh=)`, then the
    sharded gather FFN (`swiglu_dsg_gather_sharded`, gather_shared with
    n_chunks 2) forward and backward at full width."""
    import torch
    from repro_torch.launch import comm_analysis, mesh as lmesh, train
    from repro_torch.optim import adamw
    cfg = mesh_cfg(ARCH, spec)
    mesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
    out = {}
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    state, _, _ = train.build_trainer(cfg, adamw.AdamWConfig(), seed=SEED,
                                      device=dev, mesh=mesh)
    params = dict(state["model"].named_parameters())
    out["local_bytes"] = {
        "params": nbytes(p.to_local() for p in params.values()),
        "dsg": nbytes(t.to_local() for t in state["dsg"].values()),
        "opt": nbytes(t.to_local() for k in ("m", "v", "master")
                      for t in state["opt"][k].values())}
    if cuda:
        gc.collect()
        out["state_allocated"] = torch.cuda.memory_allocated() - base
        out["layout_peak"] = torch.cuda.max_memory_allocated() - base
    del state, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    w, st, x, gy = ffn_case(cfg, dev, torch.bfloat16, spec["ffn_tokens"])
    fwd_bwd = tp_ffn_call(cfg, mesh, w, st, x, gy)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    y, dx, grads = fwd_bwd()
    out.update({"y": y.to_local().cpu(), "dx": dx.to_local().cpu(),
                "dw": [g.to_local().cpu() for g in grads[1:]]})
    out["ms_p50"], out["ms"] = host_ms(fwd_bwd)
    out["profile"] = collective_ms(fwd_bwd)
    if cuda:
        out["ffn_peak"] = torch.cuda.max_memory_allocated()
    # one more call, its collectives counted as the dry run counts them
    out["analysis"] = comm_analysis.analyze(fwd_bwd)[1]

    # the vocab-parallel loss at the full vocabulary: the bf16 logits and
    # their gradient, the same call with every label moved one shard on
    # (a planted fault), and one more call counted
    x32, labels = loss_case(cfg, dev, spec["loss_tokens"])
    xb = x32.to(torch.bfloat16)
    del x32
    for key, lab in (("loss", labels),
                     ("loss_fault", (labels + cfg.vocab // 2) % cfg.vocab)):
        loss, grad = vp_loss_call(mesh, xb, lab)()
        out[key] = (float(loss.full_tensor()), grad.to_local().cpu())
        del loss, grad
    call = vp_loss_call(mesh, xb, labels)
    out["loss_ms_p50"] = host_ms(call)[0]
    out["loss_analysis"] = comm_analysis.analyze(call)[1]
    return out


def loss_case(cfg, dev, tokens):
    """Seeded f32 logits (B, S, vocab) of std 3, the labels' own raised by
    6 as a trained LM's favour them (so labels one shard on score far
    worse), and the labels, every vocab shard's first and last id of two
    shards among them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    b, s = tokens
    x = torch.randn((b, s, cfg.vocab), generator=gen, device=dev) * 3.0
    labels = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)
    half = cfg.vocab // 2
    labels[0, :4] = torch.tensor([0, half - 1, half, cfg.vocab - 1],
                                 device=dev)
    x.scatter_add_(-1, labels[..., None],
                   torch.full((b, s, 1), 6.0, device=dev))
    return x, labels


def vp_loss_call(mesh, logits, labels):
    """The vocab-parallel loss's forward and backward on `mesh`: logits
    laid out (batch over 'data', vocab over 'model').  Returns the call,
    which returns (the loss, the logits' gradient) as DTensors."""
    import torch
    from repro_torch.models.transformer import sharded_cross_entropy
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.sharding import P, distribute
    lg = distribute(logits, mesh, P(("data",), None, "model"))
    lg.requires_grad_(True)
    lb = distribute(labels, mesh, P(("data",), None))

    def call():
        with pctx.use_mesh(mesh):
            loss = sharded_cross_entropy(lg, lb)
            (grad,) = torch.autograd.grad(loss, [lg])
        return loss, grad

    return call


def traced_vp_loss(dev, logits, labels) -> dict:
    """The dry run's count of the loss call: traced on rank 0 of a 2-rank
    fake process group, on meta tensors of the same shapes, on a (data 1,
    model 2) mesh of the ranks' device type."""
    import torch
    from repro_torch.launch import comm_analysis, mesh as lmesh
    with lmesh.fake_world(2):
        fmesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
        call = vp_loss_call(fmesh, torch.empty_like(logits, device="meta"),
                            torch.empty_like(labels, device="meta"))
        return comm_analysis.analyze(call)[1]


def tp_ffn_call(cfg, mesh, w, st, x, gy):
    """Part (a)'s call on `mesh`: the sharded gather FFN
    (`swiglu_dsg_gather_sharded`, gather_shared with n_chunks 2) forward
    and backward of x, the weights column / row parallel over 'model',
    then dx's partial sums reduced.  Returns the call, which returns (y,
    dx, grads)."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.core import dsg_linear as dl
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.sharding import P, distribute
    dcfg = cfg.dsg._replace(mode="gather_shared", n_chunks=2)
    wd = {"w_gate": distribute(w["w_gate"], mesh, P(None, "model")),
          "w_up": distribute(w["w_up"], mesh, P(None, "model")),
          "w_down": distribute(w["w_down"], mesh, P("model", None))}
    for t in wd.values():
        t.requires_grad_(True)
    std = {"r": distribute(st["r"], mesh, P()),
           "fw": distribute(st["fw"], mesh, P(None, "model"))}
    xd = distribute(x, mesh, P(("data",), None, None)).requires_grad_(True)
    gyd = distribute(gy, mesh, P(("data",), None, None))
    ffn = type("FFN", (), wd)

    def fwd_bwd():
        with pctx.use_mesh(mesh):
            y = dl.swiglu_dsg_gather_sharded(ffn, xd, std, dcfg)
            grads = torch.autograd.grad(
                y, [xd, wd["w_gate"], wd["w_up"], wd["w_down"]],
                grad_outputs=gyd)
            # the model shards' partial sums, reduced (an all_reduce)
            dx = grads[0].redistribute(
                mesh, [grads[0].placements[0], Replicate()])
        return y, dx, grads

    return fwd_bwd


def traced_tp_ffn(cfg, dev, w, st, x, gy) -> dict:
    """The dry run's count of part (a)'s call: the same call traced on
    rank 0 of a 2-rank fake process group, on meta tensors of the same
    shapes, on a (data 1, model 2) mesh of the ranks' device type."""
    import torch
    from repro_torch.launch import comm_analysis, mesh as lmesh

    def meta(t):
        return torch.empty_like(t, device="meta")
    with lmesh.fake_world(2):
        fmesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
        call = tp_ffn_call(cfg, fmesh, {k: meta(v) for k, v in w.items()},
                           {k: meta(v) for k, v in st.items()}, meta(x),
                           meta(gy))
        return comm_analysis.analyze(call)[1]


def moe_case(cfg, dev, dtype, tokens):
    """Seeded inputs of one MoE layer's routed experts at cfg's width:
    expert weights, the f32 router, per-expert DSG state and x."""
    import torch
    from repro_torch.core import dsg_linear as dl
    from repro_torch.core.projection import make_projection
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff

    def normal(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)
    w = (normal((e, d, f), d ** -0.5), normal((e, d, f), d ** -0.5),
         normal((e, f, d), f ** -0.5))
    router = normal((d, e), d ** -0.5, torch.float32)
    r = make_projection(dl.proj_dim(d, f, cfg.dsg), d, generator=gen,
                        dtype=dtype, device=dev)
    x = normal((tokens[0] * tokens[1], d), 1.0)
    return w, router, r, torch.matmul(r, w[0]), x


def mesh_ep(rank, dev, spec) -> dict:
    """Part (b) on a (data 1, model 2) mesh of two ranks: one layer of
    deepseek-moe-16b's routed experts under expert parallelism at full
    width (`models.moe._routed_ep`: 32 of the 64 experts a rank, the
    outputs summed over 'model'), with DSG as the config sets it and
    without."""
    import torch
    from repro_torch.launch import mesh as lmesh
    from torch.distributed.tensor import DTensor
    from repro_torch.models import moe
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.sharding import P, distribute, placements
    cfg = mesh_cfg(MOE_ARCH, spec)
    mesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
    w, router, r, fw, x = moe_case(cfg, dev, torch.bfloat16,
                                   spec["moe_tokens"])
    ep = P("model", None, None)
    wd = dict(zip(("w_gate", "w_up", "w_down"),
                  (distribute(t, mesh, ep) for t in w)))
    fwd = distribute(fw, mesh, ep)
    # the rows as the model hands them over: DTensors already (this rank's
    # rows are all of them on a data axis of 1)
    rows = placements(mesh, P(("data",), None))
    logits = DTensor.from_local(x.float() @ router, mesh, rows,
                                run_check=False)
    x = DTensor.from_local(x, mesh, rows, run_check=False)
    del w, fw
    gc.collect()

    def run(dsg_on=True):
        dsg = cfg.dsg if dsg_on else cfg.dsg._replace(enabled=False)
        with pctx.use_mesh(mesh):
            return moe._routed_ep(
                x, logits, SimpleNamespace(**wd), mesh, ("data",),
                cfg.moe_experts,
                cfg.moe_topk, cfg.moe_capacity_factor,
                fwd if dsg_on else None, r if dsg_on else None, dsg)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    out = {"y": run().to_local().cpu(), "y_off": run(False).to_local().cpu(),
           "local_expert_bytes": nbytes(t.to_local() for t in wd.values())}
    out["ms_p50"], out["ms"] = host_ms(run)
    out["profile"] = collective_ms(run)
    if dev.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated()
    return out


def moe_route(cfg, logits) -> dict:
    """Plain routing, written apart from models.moe: each token's top-k
    experts by softmax probability (torch.topk) with renormalised weights
    'w' and experts 'e' (T, K), and each expert's first `cap` tokens in
    token order, `cap` from all T tokens (the rows of a data axis of 1):
    'rows' (E, cap), T where a slot is empty."""
    import torch
    t, e, k = logits.shape[0], cfg.moe_experts, cfg.moe_topk
    top_w, top_e = torch.topk(torch.softmax(logits.float(), dim=-1), k,
                              dim=-1)
    cap = max(1, int(cfg.moe_capacity_factor * t * k / e))
    rows = torch.full((e, cap), t, dtype=torch.int64, device=logits.device)
    for i in range(e):
        toks = (top_e == i).any(-1).nonzero().flatten()[:cap]
        rows[i, :toks.numel()] = toks
    return {"w": top_w / top_w.sum(-1, keepdim=True), "e": top_e,
            "rows": rows}


def moe_groups(cfg, x, route, r, fw, shards: int):
    """DSG's group mask (E, cap, G) of every expert slot, as the EP body's
    DRS step selects it: the slots' scores relu(f(x) f(W_e)) of each of
    `shards` expert slices thresholded at that slice's own first slot
    (`drs.select_mask`, the config's shared mode)."""
    import torch
    from repro_torch.core import drs
    xg = torch.cat([x, x.new_zeros(1, x.shape[1])])[route["rows"]]
    el, dcfg = cfg.moe_experts // shards, cfg.dsg.drs_cfg()
    return torch.cat([drs.select_mask(drs.group_scores(
        torch.bmm(xg[sl] @ r.t(), fw[sl]), dcfg), cfg.moe_d_ff, dcfg)
        for sl in (slice(s * el, (s + 1) * el) for s in range(shards))])


def moe_reference(cfg, x, w, route, groups=None, experts=None):
    """The routed experts written plainly, one expert at a time: its
    slots' tokens through its SwiGLU, the hidden units of the groups
    `groups` (E, cap, G) drops zeroed, each token's outputs weighted and
    added in ascending expert order from 0.0 in f32; in x's dtype.
    `experts` limits the sum (a planted fault)."""
    import torch
    import torch.nn.functional as F
    t, d = x.shape
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    for i in (range(cfg.moe_experts) if experts is None else experts):
        rows = route["rows"][i]
        xe = x_pad[rows]
        h = F.silu(xe @ w[0][i]) * (xe @ w[1][i])
        if groups is not None:
            h = h * groups[i].repeat_interleave(cfg.dsg.block, dim=-1) \
                .to(h.dtype)
        y = (h @ w[2][i]).float()
        live = rows < t
        tok = rows[live]
        wt = (route["w"][tok] * (route["e"][tok] == i)).sum(-1)
        out[tok] += y[live] * wt[:, None]
    return out.to(x.dtype)


def masked_swiglu_grads(w: dict, x, gy, keep) -> dict:
    """y, dx and dW (gate, up, down) of the SwiGLU FFN with the hidden
    units outside `keep` (F,) zeroed: the gathered FFN's function on a
    selection it is given, in the inputs' dtype."""
    import torch
    import torch.nn.functional as F
    w = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    x = x.detach().requires_grad_(True)
    h = F.silu(x @ w["w_gate"]) * (x @ w["w_up"]) * keep.to(x.dtype)
    y = h @ w["w_down"]
    g = torch.autograd.grad(y, [x, w["w_gate"], w["w_up"], w["w_down"]],
                            grad_outputs=gy)
    return {"y": y.detach(), "dx": g[0], "dw": list(g[1:])}


def planted_faults(bound: dict, gaps: dict) -> None:
    """Fail unless each planted fault's gap {name: (key, gap)} exceeds the
    check's bound for its key: a check that cannot tell them is empty."""
    for name, (key, gap) in gaps.items():
        if not gap > bound[key]:
            fail(f"phase 27's check cannot tell a planted fault ({name}): "
                 f"gap {gap} against the bound {bound[key]}")


def mesh_coll(rank, dev, spec) -> dict:
    """Part (c) on four ranks: pipeline_forward over 'pipe' 4 with stages
    of internlm2-1.8b's SwiGLU FFN in bf16; hierarchical_grad_reduce (pod
    2 x data 2) on an f32 gradient of w_gate's shape, compress on and
    off, and compressed_psum over 'data'; make_global_batch's rows.  Each
    rank holds its results against the plain computation of all four
    ranks' inputs, done on its own device."""
    import torch
    import torch.nn.functional as F
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from repro_torch.data import synthetic
    from repro_torch.optim.compress import compressed_psum, ternarize
    from repro_torch.optim.hierarchical import hierarchical_grad_reduce
    from repro_torch.parallel.collectives import shard_map
    from repro_torch.parallel.pipeline import (pipeline_forward,
                                               sequential_reference)
    from repro_torch.parallel.sharding import P, placements
    cfg = mesh_cfg(ARCH, spec)
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def normal(shape, scale, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)
    stages = {"w_gate": normal((4, d, f), d ** -0.5),
              "w_up": normal((4, d, f), d ** -0.5),
              "w_down": normal((4, f, d), f ** -0.5)}
    n_micro, mb, seq = spec["pipe_micro"]
    xm = normal((n_micro, mb, seq, d), 1.0)

    def stage(p, h):
        return h + (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]

    pmesh = DeviceMesh(dev.type, torch.arange(4), mesh_dim_names=("pipe",))

    def pipe():
        return pipeline_forward(stage, stages, xm, pmesh)

    got = pipe().to_local()
    want = sequential_reference(stage, stages, xm)
    out["pipe"] = {"equal": bool(torch.equal(got, want)),
                   "max_abs": float((got.float() - want.float()).abs()
                                    .max()),
                   "shape": list(got.shape)}
    out["pipe"]["ms_p50"], _ = host_ms(pipe)
    out["pipe"]["profile"] = collective_ms(pipe)
    del stages, xm, got, want
    gc.collect()

    mesh = DeviceMesh(dev.type, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    gs = [torch.randn((d, f), generator=torch.Generator(device=dev)
                      .manual_seed(SEED + 100 + i), device=dev)
          for i in range(4)]
    sp = P(("pod", "data"))
    shape = (4, d, f)

    def mine(t):
        return DTensor.from_local(t[None], mesh, placements(mesh, sp),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta")
                                  .stride())
    err0 = torch.zeros((d, f), device=dev)
    pods = [(gs[0] + gs[1]) / 2, (gs[2] + gs[3]) / 2]
    pod_dec = [c * s for c, s in (ternarize(p) for p in pods)]
    data_dec = [c * s for c, s in (ternarize(g) for g in gs)]
    my_pod = rank // 2
    expect = {
        "hier_off": ((pods[0] + pods[1]) / 2, err0),
        "hier_on": ((pod_dec[0] + pod_dec[1]) / 2, pods[my_pod] -
                    pod_dec[my_pod]),
        "cpsum": (data_dec[2 * my_pod] + data_dec[2 * my_pod + 1],
                  gs[rank] - data_dec[rank])}
    fns = {"hier_off": lambda g, e: hierarchical_grad_reduce(
               g, e, compress=False, mesh=mesh),
           "hier_on": lambda g, e: hierarchical_grad_reduce(g, e, mesh=mesh),
           "cpsum": lambda g, e: compressed_psum(g, "data", e, mesh=mesh)}
    for name, fn in fns.items():
        run = shard_map(fn, mesh, (sp, sp), (sp, sp))

        def call():
            return run(mine(gs[rank]), mine(err0))
        red, err = call()
        want_red, want_err = expect[name]
        scale = float(want_red.abs().max())
        out[name] = {
            "err_red": float((red.to_local()[0] - want_red).abs().max())
            / scale,
            "err_buf": float((err.to_local()[0] - want_err).abs().max())
            / max(1.0, float(want_err.abs().max())),
            "ms_p50": host_ms(call)[0]}
    del gs, pods, pod_dec, data_dec, expect
    gc.collect()

    kw = dict(global_batch=8, seq_len=256, vocab=cfg.vocab, seed=SEED)
    bspec = {"tokens": P(("pod", "data"), None),
             "labels": P(("pod", "data"), None)}
    gb = synthetic.make_global_batch(0, mesh, bspec, **kw)
    host = synthetic.batch_at(0, host_index=rank, host_count=4, **kw)
    out["global_batch"] = {
        "rows_equal": all(torch.equal(gb[k].to_local().cpu(), host[k])
                          for k in host),
        "shape": list(gb["tokens"].shape)}
    return out


MESH_PARTS = {"tp": mesh_tp, "ep": mesh_ep, "coll": mesh_coll}


# -- the whole model sharded, one card a rank (`--mesh-cards`) -------------

CARDS_FLAG = "--mesh-cards"        # chip_smoke.py --mesh-cards: 4 cards
CARDS_STEPS = 4                    # (a)'s AdamW steps, f(W) every 2
CARDS_REFRESH = 2


def tp_cfg(spec, mode: str):
    cfg = mesh_cfg(ARCH, spec)
    dsg = cfg.dsg._replace(refresh_every=CARDS_REFRESH)
    if mode == "gather":
        dsg = dsg._replace(mode="gather_shared", n_chunks=2)
    return cfg.replace(dsg=dsg)


def tp_train_run(cfg, dev, spec, mesh=None) -> dict:
    """CARDS_STEPS AdamW steps of `launch.train`'s trainer on
    `synthetic.batch_at`'s batches (seed SEED), f(W) refreshed every
    CARDS_REFRESH steps, on `mesh` or unsharded: losses, step ms, peak
    memory and, on a mesh, the shards' bytes and a profiled step's time
    in NCCL kernels."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    acfg = adamw.AdamWConfig(total_steps=CARDS_STEPS, warmup=1)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state, step_fn, refresh_fn = train.build_trainer(
        cfg, acfg, seed=SEED, device=dev, mesh=mesh)
    out = {"losses": [], "ms": []}
    if mesh is not None:
        params = dict(state["model"].named_parameters())
        out["local_bytes"] = {
            "params": nbytes(p.to_local() for p in params.values()),
            "dsg": nbytes(t.to_local() for t in state["dsg"].values()),
            "opt": nbytes(t.to_local() for k in ("m", "v", "master")
                          if k in state["opt"]
                          for t in state["opt"][k].values())}
        del params
    b, seq = spec["train_batch"]

    def one(i):
        nonlocal state
        batch = synthetic.batch_at(i, global_batch=b, seq_len=seq,
                                   vocab=cfg.vocab, seed=SEED)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["losses"].append(loss)
        if (i + 1) % CARDS_REFRESH == 0:
            state = refresh_fn(state)

    for i in range(CARDS_STEPS):
        one(i)
    if cuda:
        out["peak"] = torch.cuda.max_memory_allocated()
    if mesh is not None and cuda:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one(CARDS_STEPS)
        nccl = sum(e.device_time_total for e in prof.key_averages()
                   if "nccl" in e.key.lower())
        out["profiled_step_ms"] = out["ms"].pop()
        out["losses"].pop()
        out["nccl_device_ms"] = nccl / 1e3
    if mesh is not None:
        # one more step, its batch laid out first as the dry run's is,
        # its collectives counted as the dry run counts them, and the
        # allocator's peak over it
        from repro_torch.launch import comm_analysis
        from repro_torch.models import specs as mspecs
        from repro_torch.parallel.sharding import axes_for_mesh, distribute
        batch = synthetic.batch_at(CARDS_STEPS + 1, global_batch=b,
                                   seq_len=seq, vocab=cfg.vocab, seed=SEED)
        bspecs = mspecs.input_specs(batch, cfg, axes_for_mesh(mesh))
        batch = {k: distribute(v.to(dev), mesh, bspecs[k])
                 for k, v in batch.items()}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        (state, _), out["analysis"] = comm_analysis.analyze(
            lambda: step_fn(state, batch))
        if cuda:
            out["step_peak"] = torch.cuda.max_memory_allocated()
        del batch
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def traced_tp_train(spec, mode: str, dev) -> dict:
    """The dry run's record of (a)'s training step: internlm2-1.8b with
    (a)'s config (the batch taken whole, as the trainer takes it) at
    spec's train_batch on a (data 1, model 2) mesh of the ranks' device
    type, its sharded step traced on rank 0 of a 2-rank fake group."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, mesh as lmesh
    over = [f"{k}={v!r}" for k, v in
            spec.get("overrides", {}).get(ARCH, {}).items()]
    over.append("microbatches=1")
    if mode == "gather":
        over += ["dsg.mode='gather_shared'", "dsg.n_chunks=2"]
    b, seq = spec["train_batch"]
    with lmesh.fake_world(2):
        fmesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
        cell = dryrun.build_cell(ARCH, ShapeConfig("cards", seq, b, "train"),
                                 fmesh, overrides=over)
        args = dryrun.memory(cell)["argument_size_in_bytes"]
        analysis, peak = dryrun.trace_sharded(cell)
    return {"analysis": analysis, "peak": peak, "args": args}


def mesh_tp_train(rank, dev, spec) -> dict:
    """(a) on two cards: internlm2-1.8b trained on a (data 1, model 2)
    mesh, DSG mask mode and gather_shared with n_chunks 2."""
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
    return {mode: tp_train_run(tp_cfg(spec, mode), dev, spec, mesh)
            for mode in ("mask", "gather")}


def upcast(model, dsg):
    """The model's parameters and the DSG state in f32, in place of the
    bf16 ones one at a time (DTensors keep their layout)."""
    from torch import nn
    for name in [n for n, _ in model.named_parameters()]:
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        p = getattr(mod, leaf)
        setattr(mod, leaf, nn.Parameter(p.detach().float(),
                                        requires_grad=p.requires_grad))
        del p
    return {k: upcast_tree(v) for k, v in dsg.items()}


def upcast_tree(t):
    import torch
    if isinstance(t, dict):
        return {k: upcast_tree(v) for k, v in t.items()}
    return t.float() if torch.is_tensor(t) and t.is_floating_point() else t


def ep_prefill_run(cfg, dev, spec, mesh=None) -> dict:
    """deepseek-moe-16b's api.prefill of 4 x 128 seeded tokens, its DSG
    state on and off, on `mesh` (every weight laid out by the specs) or
    unsharded: the last logits in the config's bf16, then in f32 on the
    same weights and DSG state upcast (`upcast`), and peak memory."""
    import numpy as np
    import torch
    from repro_torch.models import api, specs
    from repro_torch.parallel.sharding import (axes_for_mesh,
                                               distribute_model,
                                               distribute_tree)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    b, p = spec["moe_tokens"]
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (b, p), dtype=np.int64)).to(dev)
    kw, out = {}, {}
    if mesh is not None:
        ax = axes_for_mesh(mesh)
        distribute_model(model, mesh, specs.param_specs(model, cfg, ax, 2))
        dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, cfg, ax, 2))
        kw = dict(mesh=mesh, batch_axes=ax.batch)
        out["local_weight_bytes"] = nbytes(
            p.to_local() for p in model.parameters())
        gc.collect()
    for dt in ("bfloat16", "float32"):
        if dt == "float32":
            dsg = upcast(model, dsg)
            gc.collect()
        run_cfg = cfg.replace(dtype=dt)
        out[dt] = {}
        for name, state in (("on", dsg), ("off", None)):
            cache = api.make_cache(run_cfg, b, p, device=dev)
            logits, _ = api.prefill(model, state, run_cfg,
                                    {"tokens": tokens}, cache, **kw)
            logits = logits.full_tensor() if mesh is not None else logits
            out[dt][name] = logits.float().cpu()
            del cache
        if cuda:
            out["peak_" + dt] = torch.cuda.max_memory_allocated()
    del model, dsg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def mesh_ep_prefill(rank, dev, spec) -> dict:
    """(b) on two cards: deepseek-moe-16b's prefill under expert
    parallelism on a (data 1, model 2) mesh."""
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_elastic_mesh(2, model=2, device_type=dev.type)
    return ep_prefill_run(mesh_cfg(MOE_ARCH, spec), dev, spec, mesh)


def mesh_remesh(rank, dev, spec) -> dict:
    """remesh_state on four cards: internlm2-1.8b's trainer state from
    (data 2, model 2) onto plan_after_loss(3, model=2)'s mesh, every leaf
    gathered before and after."""
    import torch
    from repro_torch.launch import mesh as lmesh, train
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import full_tree, placements
    from repro_torch.runtime.elastic import plan_after_loss, remesh_state
    cfg = mesh_cfg(ARCH, spec)
    mesh = lmesh.make_elastic_mesh(4, model=2, device_type=dev.type)
    state, _, _ = train.build_trainer(cfg, adamw.AdamWConfig(), seed=SEED,
                                      device=dev, mesh=mesh)
    tree = {"params": dict(state["model"].named_parameters()),
            "dsg": state["dsg"], "master": state["opt"]["master"]}
    sp = {"params": state["specs"]["params"], "dsg": state["specs"]["dsg"],
          "master": state["specs"]["opt"]["master"]}
    plan = plan_after_loss(3, model=2)
    new_mesh, moved = remesh_state(tree, sp, plan, device_type=dev.type)
    # the ranks the plan drops hold no shards: they only take part in the
    # old mesh's gathers
    inside = rank < plan.n_devices
    same, leaves, laid = True, 0, True
    for part in tree:
        for k in tree[part]:
            a = full_tree(tree[part][k].detach())
            b = full_tree(moved[part][k])
            if inside:
                same = same and bool(torch.equal(a, b))
                laid = laid and list(moved[part][k].placements) == \
                    placements(new_mesh, sp[part][k])
            leaves += 1
            del a, b
    return {"same": same if inside else None, "leaves": leaves,
            "laid": laid if inside else None,
            "plan": [plan.n_devices, plan.data, plan.model, plan.dropped]}


CARDS_GEN = (4, 8, 8)               # generate's prompts x length, tokens
# a sharded step's p50 on four H100 80GB HBM3 at 700 W with the layout
# DTensor's propagation chose for the projections (mask, gather), ms
CARDS_PROPAGATED_MS = (1168, 1028)


def generate_case(dev):
    """internlm2-1.8b's smoke model in f32, its DSG state and seeded
    prompts, made alike on every rank from one generator seed."""
    import torch
    from repro_torch import configs
    from repro_torch.models import api
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    b, p, _ = CARDS_GEN
    prompts = torch.randint(0, cfg.vocab, (b, p), generator=gen, device=dev)
    return cfg, model, dsg, prompts


def mesh_generate(rank, dev, spec) -> dict:
    """`launch.serve.generate(..., mesh=)` of `generate_case` on a (data
    2, model 2) mesh of four ranks: the greedy stream."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch.serve import generate
    cfg, model, dsg, prompts = generate_case(dev)
    mesh = lmesh.make_elastic_mesh(4, model=2, device_type=dev.type)
    t0 = time.perf_counter()
    stream = generate(cfg, model, dsg, prompts, CARDS_GEN[2], mesh=mesh)
    return {"stream": stream.cpu(), "s": time.perf_counter() - t0}


MESH_PARTS.update(tp_train=mesh_tp_train, ep_prefill=mesh_ep_prefill,
                  remesh=mesh_remesh, generate=mesh_generate)

REC_CARDS_ARCHS = (XLSTM_ARCH, ZAMBA_ARCH)    # (g)


def rec_train_run(arch, dev, spec, mesh) -> dict:
    """(g) on one rank: `launch.train`'s trainer of `arch` at REC_GROUPS
    groups on `mesh`, one AdamW step of spec's train_batch, then one more
    with its batch laid out first, counted as the dry run counts
    (`comm_analysis.analyze`)."""
    import torch
    from repro_torch.data import synthetic
    from repro_torch.launch import comm_analysis, train
    from repro_torch.models import specs as mspecs
    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import axes_for_mesh, distribute
    cfg = rec_train_cfg(arch, spec)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    acfg = adamw.AdamWConfig(total_steps=2, warmup=1)
    state, step_fn, _ = train.build_trainer(cfg, acfg, seed=SEED,
                                            device=dev, mesh=mesh)
    b, seq = spec["train_batch"]
    losses = []
    state, metrics = step_fn(state, synthetic.batch_at(
        0, global_batch=b, seq_len=seq, vocab=cfg.vocab, seed=SEED))
    losses.append(float(metrics["loss"]))
    batch = synthetic.batch_at(1, global_batch=b, seq_len=seq,
                               vocab=cfg.vocab, seed=SEED)
    bspecs = mspecs.input_specs(batch, cfg, axes_for_mesh(mesh))
    batch = {k: distribute(v.to(dev), mesh, bspecs[k])
             for k, v in batch.items()}
    t0 = time.perf_counter()
    (state, metrics), analysis = comm_analysis.analyze(
        lambda: step_fn(state, batch))
    losses.append(float(metrics["loss"]))
    out = {"losses": losses, "analysis": analysis,
           "ms": 1e3 * (time.perf_counter() - t0),
           "peak": torch.cuda.max_memory_allocated() if cuda else None}
    del state, step_fn, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def traced_rec_train(spec, arch: str, dev) -> dict:
    """The dry run's record of (g)'s step: rank 0 of a 4-rank fake group
    on a (data 2, model 2) mesh of the ranks' device type."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, mesh as lmesh
    b, seq = spec["train_batch"]
    with lmesh.fake_world(4):
        fmesh = lmesh.make_elastic_mesh(4, model=2, device_type=dev.type)
        cell = dryrun.build_cell(arch, ShapeConfig("cards", seq, b, "train"),
                                 fmesh,
                                 overrides=rec_train_overrides(arch, spec))
        analysis, peak = dryrun.trace_sharded(cell)
    return {"analysis": analysis, "peak": peak}


def mesh_rec_train(rank, dev, spec) -> dict:
    """(g) on four cards: each recurrent arch's training step on a (data
    2, model 2) mesh."""
    from repro_torch.launch import mesh as lmesh
    mesh = lmesh.make_elastic_mesh(4, model=2, device_type=dev.type)
    return {arch: rec_train_run(arch, dev, spec, mesh)
            for arch in REC_CARDS_ARCHS}


MESH_PARTS.update(rec_train=mesh_rec_train)


# -- phase 28: serving replicas across ranks ---------------------------------

# phase 20 (d)'s engines: paged, page 16, 4 slots, chunk 8, DSG serving off
REPLICA_KW = dict(n_slots=4, max_seq=512, prompt_bucket=256,
                  cache_backend="paged", page_size=16, decode_chunk=8)
REPLICA_FAULT = (1, 6)             # kill@1:6: replica 1 at its step 6


def replica_cfg(cfg):
    """Phase 20 (d)'s config: DSG in mask mode with a per-row top-k
    threshold, so that a lane's groups are its own."""
    return cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))


def six_kernels() -> dict:
    """The six kernels' wrappers, by name."""
    from repro_torch.kernels import dsg_ffn, flash_attention
    return dict({n: k[0] for n, k in serve_kernels().items()},
                dsg_ffn=dsg_ffn.dsg_ffn,
                flash_attention=flash_attention.flash_attention)


def replica_run(router, requests, faults=()) -> dict:
    """Serve `requests` through a warmed sharded router (one process, or
    this rank's part of a replica mesh, where every rank calls it) from a
    clean slate: the engines' results and counters, the graph replays,
    the router's counters and health, the control group's clock and the
    six kernels' counters, set to 0 just before the run and read just
    after.  `faults` are (replica, step) kills.  Returns the streams,
    statuses and retries, dispatch log, steps, health events, makespan,
    this process's group ticks and replays, its replayed split
    paged_decode launches, the wrappers' own (eager) launches, the
    control group's seconds and commands, the faults that fired here and
    whether the run captured a graph."""
    import torch
    from repro_torch.kernels import paged_attention
    from repro_torch.runtime.fault_tolerance import (ReplicaFault,
                                                     ServingFaultInjector)
    ex = router.executor
    for e in router.engines:
        e.done.clear()
        e.steps = e.admissions = e.refresh_steps = 0
        e.decode_seconds, e.decode_tokens = 0.0, 0
    graphs = ex.graphs
    keys = set(graphs.graphs) if graphs is not None else set()
    if graphs is not None:
        graphs.replays.clear()
    router.reset_counters()
    router.reset_health()
    control = getattr(ex, "control", None)
    if control is not None:
        control.seconds = 0.0
        control.ops.clear()
    injector = None
    if faults:
        injector = ServingFaultInjector([ReplicaFault(*f) for f in faults])
        injector.attach(router.engines)
    wrappers = six_kernels()
    for w in wrappers.values():
        for name in [n for n in vars(w) if n.startswith("launches")]:
            setattr(w, name, 0)
    ticks = [0]
    before = vars(ex).get("_group")
    group = ex._group

    def counted(*a):
        ticks[0] += 1
        return group(*a)
    ex._group = counted
    for r in requests:
        router.submit(r)
    t0 = time.perf_counter()
    try:
        done = router.run()
        if ex.device.type == "cuda":
            torch.cuda.synchronize(ex.device)
    finally:
        if before is None:
            del ex._group
        else:
            ex._group = before
        if injector is not None:
            injector.detach(router.engines)
    wall = time.perf_counter() - t0
    replays = (sum(graphs.replays.values()) if graphs is not None
               else ticks[0])
    split = (graphs.launches(paged_attention.paged_decode, "launches_split")
             if graphs is not None else None)
    return {"streams": {u: list(r.output) for u, r in done.items()},
            "status": {u: (r.status, r.retries) for u, r in done.items()},
            "log": list(router.dispatch_log), "steps": router.steps,
            "health": [[list(e[:2]) for e in h.events]
                       for h in router.health],
            "makespan": router.makespan_seconds(), "wall": wall,
            "local": list(ex.local), "ticks": ticks[0], "replays": replays,
            "split": split,
            "eager": mesh_launches(),
            "control_s": control.seconds if control is not None else 0.0,
            "ops": dict(control.ops) if control is not None else {},
            "fired": injector.log if injector is not None else [],
            "captured": (graphs is not None
                         and set(graphs.graphs) != keys)}


def weight_sums(model, dsg) -> list:
    """One f64 sum a leaf of the weights and the DSG state: equal on two
    ranks only if every leaf is."""
    leaves = list(model.parameters()) + [
        v for v in (dsg or {}).values() if hasattr(v, "double")]
    return [float(t.double().sum()) for t in leaves]


def mesh_replicas(rank, dev, spec) -> dict:
    """One rank of phase 28 (or of `--mesh-cards` (e)): internlm2-1.8b
    from the seeded generator on this rank's device, the weights' sums
    gathered over the control group, a warmed sharded Router over a
    replica mesh of every rank (`spec["replicas"]` replicas), then phase
    20's 16 skewed requests fault-free and under kill@1:6."""
    import torch
    from repro_torch.models import api
    from repro_torch.parallel.sharding import replica_mesh
    from repro_torch.serving.router import Router
    from repro_torch.serving.workload import skewed_requests, warmup_router
    from torch import distributed as dist
    cfg = mesh_cfg(ARCH, spec)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    t0 = time.perf_counter()
    router = Router(replica_cfg(cfg), model, dsg,
                    n_replicas=spec["replicas"], exec_mode="sharded",
                    mesh=replica_mesh(dist.get_world_size(), dev.type),
                    fault_tolerance=True, **REPLICA_KW)
    sums = router.executor.control.all_gather(weight_sums(model, dsg))
    warmup_router(router, cfg.vocab)
    warm_s = time.perf_counter() - t0

    def traffic():
        return skewed_requests(cfg.vocab, 16, period=2, seed=SEED)
    fault = tuple(spec.get("fault", REPLICA_FAULT))
    out = {"sums_equal": all(x == sums[0] for x in sums),
           "warm_s": warm_s, "run": replica_run(router, traffic()),
           "failover": replica_run(router, traffic(), [fault])}
    if dev.type == "cuda":
        out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


MESH_PARTS.update(replicas=mesh_replicas)


def replica_checks(tag, ranks, ref, n_layers, chunk,
                   fault=REPLICA_FAULT) -> dict:
    """Hold a replica mesh's ranks to the one-process sharded router's
    runs `ref` (fault-free and under kill@1:6): the weights' sums equal on
    every rank; on every rank the merged streams, statuses and retries,
    dispatch log and steps, and under the fault the health events, the
    one process's; one group replay a tick and `n_layers x chunk x the
    rank's replicas x replays` split paged_decode launches on each rank,
    no eager launch of the six kernels and no capture in the run; the
    fault (`fault`, a kill) fired once, on its replica's owner.  Prints
    the makespans, each rank's ticks and replays and the control group's
    ms a tick."""
    rows = []
    for k, r in enumerate(ranks):
        if not r["sums_equal"]:
            fail(f"{tag}: the ranks' weights differ (rank {k}'s gather)")
        for part in ("run", "failover"):
            got, want = r[part], ref[part]
            keys = ("streams", "status", "log", "steps") + (
                ("health",) if part == "failover" else ())
            off = [key for key in keys if got[key] != want[key]]
            if off or any(s != "ok" for s, _ in got["status"].values()):
                fail(f"{tag} {part}: rank {k}'s {off} differ from the "
                     f"one-process router's: {[got[x] for x in off]} "
                     f"against {[want[x] for x in off]}")
            want_split = n_layers * chunk * len(got["local"]) * got["replays"]
            if got["split"] is not None and (
                    got["replays"] != got["ticks"] or not got["replays"]
                    or got["split"] != want_split):
                fail(f"{tag} {part}: rank {k} replayed {got['replays']} "
                     f"times in {got['ticks']} ticks with {got['split']} "
                     f"split paged_decode launches, expected one replay a "
                     f"tick and {want_split}")
            if any(got["eager"].values()) or got["captured"]:
                fail(f"{tag} {part}: rank {k} launched {got['eager']} "
                     f"eagerly or captured a graph in the run")
            rows.append({"rank": k, "part": part, "local": got["local"],
                         "ticks": got["ticks"], "replays": got["replays"],
                         "split": got["split"], "makespan": got["makespan"],
                         "control_ms_a_tick": 1e3 * got["control_s"]
                         / max(got["ops"].get("tick", 0), 1),
                         "ops": got["ops"]})
    fired = [r["failover"]["fired"] for r in ranks]
    if sum(len(f) for f in fired) != 1:
        fail(f"{tag}: kill@{fault[0]}:{fault[1]} fired {fired} across the "
             f"ranks, not once")
    for part in ("run", "failover"):
        mine = [x for x in rows if x["part"] == part]
        retries = sum(n for _, n in ranks[0][part]["status"].values())
        print(f"[replicas {tag}] {part}: {len(ranks)} ranks x "
              f"{len(mine[0]['local'])} replicas, 16 of 16 ok, streams, "
              f"dispatch log and {ranks[0][part]['steps']} steps equal the "
              f"one-process router's (retries {retries}, health "
              f"{ranks[0][part]['health']}); measured makespan "
              f"{mine[0]['makespan']:.3f} s against the one process's "
              f"{ref[part]['makespan']:.3f} s; ticks / replays / split "
              f"paged_decode launches by rank "
              f"{[(x['ticks'], x['replays'], x['split']) for x in mine]}; "
              f"control group ms a tick "
              f"{[round(x['control_ms_a_tick'], 3) for x in mine]}, "
              f"commands {mine[0]['ops']}", flush=True)
    return {"rows": rows, "fired": fired,
            "split": sum(r["run"]["split"] or 0 for r in ranks),
            "warm_s": [r["warm_s"] for r in ranks],
            "peak": [r.get("peak") for r in ranks]}


def replica_phase(dev, ref, spec=None) -> dict:
    """Phase 28: phase 20 (d)'s sharded router of 2 replicas as a replica
    mesh of two gloo rank processes on this device, one replica a rank
    (see the module docstring).  `ref` is phase 20 (d)'s one-process run
    at chunk 8, fault-free and under kill@1:6."""
    import shutil
    import tempfile
    spec = dict({"device": dev.type, "replicas": 2}, **(spec or {}))
    tmp = Path(tempfile.mkdtemp())
    try:
        t0 = time.perf_counter()
        ranks = mesh_spawn("replicas", 2, tmp, spec)
        spawn_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = mesh_cfg(ARCH, spec)
    out = replica_checks("2 gloo ranks, one card", ranks, ref, cfg.n_layers,
                         REPLICA_KW["decode_chunk"])
    out["spawn_s"] = spawn_s
    return out


def argmax_held(got, want, tol: float) -> tuple:
    """(rows whose top-2 margin in `want` exceeds 2 x tol, of them the
    rows whose argmax `got` keeps)."""
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    same = got.argmax(-1) == want.argmax(-1)
    return int(clear.sum()), int((same & clear).sum())


CARDS_REPLICAS = 8                 # (e): 8 replicas, a block of 2 a card


def cards_replicas(dev, tmp, spec) -> dict:
    """`--mesh-cards` (e): phase 28 over four ranks with a card each (an
    NCCL group; the control group is gloo), 8 replicas, a block of two a
    rank, against the one-process sharded router of 8 replicas on card 0,
    fault-free and under kill@1:6."""
    import torch
    from repro_torch.models import api
    from repro_torch.serving.router import Router
    from repro_torch.serving.workload import skewed_requests, warmup_router
    cfg = mesh_cfg(ARCH, spec)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)
    one = Router(replica_cfg(cfg), model, dsg, n_replicas=CARDS_REPLICAS,
                 exec_mode="sharded", fault_tolerance=True, **REPLICA_KW)
    warmup_router(one, cfg.vocab)

    def traffic():
        return skewed_requests(cfg.vocab, 16, period=2, seed=SEED)
    ref = {"run": replica_run(one, traffic())}
    # the kill lands on the busiest replica outside rank 0's block, at
    # its step 6: with 8 replicas, replica 1 may never reach step 6
    busy = [e.steps for e in one.engines]
    victim = max(range(2, CARDS_REPLICAS), key=lambda i: busy[i])
    fault = (victim, min(REPLICA_FAULT[1], busy[victim] // 2))
    ref["failover"] = replica_run(one, traffic(), [fault])
    del one, model, dsg
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = mesh_spawn("replicas", 4, tmp,
                       dict(spec, replicas=CARDS_REPLICAS, fault=fault))
    spawn_s = time.perf_counter() - t0
    out = replica_checks("4 cards", ranks, ref, cfg.n_layers,
                         REPLICA_KW["decode_chunk"], fault)
    out.update(spawn_s=spawn_s, fault=fault,
               one_process_split=ref["run"]["split"],
               streams=ref["run"]["streams"])
    return out


def sync_cards(dev, count: int) -> None:
    """Wait for every card's work (nothing to wait for off CUDA)."""
    import torch
    if dev.type == "cuda":
        for d in range(count):
            torch.cuda.synchronize(d)


def cards_threaded(dev, spec) -> dict:
    """`--mesh-cards` (f): a threaded Router of 4 replicas in this process
    over the four cards (the router copies the model and the DSG state to
    card r % 4 for replica r), phase 20 (d)'s engines and traffic: the
    streams must equal one engine's on card 0, every replica's engine and
    graphs on its own card, and a profiled run must show split paged
    kernels on each card.  Then the same router with every replica on
    card 0 (`models=`) and the spread one serve the traffic in turn
    (spread, card 0, card 0, spread), and their makespans are printed
    side by side (the streams must equal one engine's).  Also prints
    whether entering
    `torch.cuda.stream` of another card's stream makes that card current
    on this torch, and checks that a launch's stream argument for
    operands on card 1 raises while card 0 is current."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import api
    from repro_torch.serving.router import Router
    from repro_torch.serving.workload import (skewed_requests, warmup_engine,
                                              warmup_router)
    cfg = replica_cfg(mesh_cfg(ARCH, spec))
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    probe = None
    if count > 1:
        with torch.cuda.device(0):
            with torch.cuda.stream(torch.cuda.Stream(device=1)):
                probe = torch.cuda.current_device()
            try:
                cuda_lib.stream(torch.device("cuda", 1))
            except RuntimeError as e:
                raised = str(e)
            else:
                fail("a launch for operands on cuda:1 while cuda:0 is "
                     "current did not raise")
        print(f"[cards] (f) inside torch.cuda.stream(a stream of cuda:1) "
              f"with cuda:0 current, torch.cuda.current_device() is "
              f"{probe}; a launch's stream argument for cuda:1 operands "
              f"with cuda:0 current raises (the wrappers launch inside "
              f"their operands' torch.cuda.device): {raised}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = api.init_model(cfg, generator=gen, device=dev)
    dsg = api.init_dsg(model, cfg, generator=gen, device=dev)

    def traffic():
        return skewed_requests(cfg.vocab, 16, period=2, seed=SEED)
    from repro_torch.serving.scheduler import ServingEngine
    eng = ServingEngine(cfg, model, dsg, **REPLICA_KW)
    warmup_engine(eng, cfg.vocab)
    for r in traffic():
        eng.submit(r)
    want = {u: list(r.output) for u, r in eng.run().items()}
    del eng
    router = Router(cfg, model, dsg, n_replicas=4, exec_mode="threaded",
                    **REPLICA_KW)
    devices = [str(e.device) for e in router.engines]
    warmup_router(router, cfg.vocab)

    def serve(router, prof=None) -> dict:
        for e in router.engines:
            e.done.clear()
            if e.graphs is not None:
                e.graphs.replays.clear()
        router.reset_counters()
        for r in traffic():
            router.submit(r)
        t0 = time.perf_counter()
        with prof or contextlib.nullcontext():
            done = router.run()
            sync_cards(dev, count)
        return {"makespan": router.makespan_seconds(),
                "wall": time.perf_counter() - t0,
                "same": sum(list(r.output) == want[u]
                            for u, r in done.items()),
                "replays": [sum(e.graphs.replays.values())
                            if e.graphs is not None else None
                            for e in router.engines],
                "log": list(router.dispatch_log)}
    prof = tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    runs = [serve(router), serve(router, prof)]
    # the same router with every replica on card 0 (`models=`), timed
    # against the spread one in turn: spread, card 0, card 0, spread
    pinned = Router(cfg, model, dsg, n_replicas=4, exec_mode="threaded",
                    models=[model] * 4, **REPLICA_KW)
    warmup_router(pinned, cfg.vocab)
    ab = [(where, serve(r)) for where, r in (
        ("4 cards", router), ("card 0", pinned), ("card 0", pinned),
        ("4 cards", router))]
    pinned.close()
    router.close()
    by_card = Counter()
    for ev in prof.events():
        if getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA") and \
                ev.name.startswith("void (anonymous namespace)::paged_split"):
            by_card[ev.device_index] += 1
    graph_cards = [str(e.graphs.device) if e.graphs is not None else None
                   for e in router.engines]
    print(f"[cards] (f) threaded Router of 4 replicas on {devices} (graphs "
          f"on {graph_cards}): {[r['same'] for r in runs]} of 16 streams "
          f"equal one engine's on card 0; measured makespan "
          f"{[round(r['makespan'], 3) for r in runs]} s (plain, profiled); "
          f"replays by replica {[r['replays'] for r in runs]}; split paged "
          f"kernels in the profiled run by card {dict(by_card)}",
          flush=True)
    spans = {where: [round(r["makespan"], 3) for w, r in ab if w == where]
             for where in ("4 cards", "card 0")}
    print(f"[cards] (f) the same threaded router, its 4 replicas on the 4 "
          f"cards against all on card 0, in turn (spread, card 0, card 0, "
          f"spread): measured makespan {spans} s; {[r['same'] for _, r in ab]}"
          f" of 16 streams equal one engine's", flush=True)
    if any(r["same"] != 16 for r in runs + [r for _, r in ab]):
        fail(f"the threaded router across cards changed a stream: "
             f"{runs}, {ab}")
    if count > 1 and (devices != [f"cuda:{r % count}" for r in range(4)]
                      or graph_cards != devices
                      or sorted(by_card) != list(range(min(4, count)))):
        fail(f"a replica ran off its card: engines {devices}, graphs "
             f"{graph_cards}, paged kernels by card {dict(by_card)}")
    return {"devices": devices, "runs": runs, "paged_by_card": dict(by_card),
            "stream_switches_device": probe,
            "one_card_ab": [(where, r["makespan"]) for where, r in ab]}


def mesh_cards_phase(dev, spec=None) -> dict:
    """The whole model sharded over NCCL, one card a rank (`--mesh-cards`,
    four cards; see main_mesh_cards).  `spec` sets the device, backend
    and shapes ({} for four cards at full width)."""
    import shutil
    import tempfile
    import torch
    spec = dict({"device": dev.type, "backend": "nccl",
                 "card_per_rank": True, "train_batch": [8, 256],
                 "moe_tokens": [4, 128], "pipe_micro": [4, 2, 256]},
                **(spec or {}))
    out = {}
    tmp = Path(tempfile.mkdtemp())
    try:
        out["replicas"] = cards_replicas(dev, tmp, spec)
        out["threaded"] = cards_threaded(dev, spec)
        # (a) internlm2-1.8b trained on (data 1, model 2), 2 cards
        t0 = time.perf_counter()
        traced = {mode: traced_tp_train(spec, mode, dev)
                  for mode in ("mask", "gather")}
        out["traced_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp = mesh_spawn("tp_train", 2, tmp, spec)
        out["tp_s"] = time.perf_counter() - t0
        rows = []
        for mode in ("mask", "gather"):
            cfg = tp_cfg(spec, mode)
            ref = {dt: tp_train_run(cfg.replace(dtype=dt), dev, spec)
                   for dt in ("bfloat16", "float32")}
            e = max(abs(a - b) for a, b in zip(ref["bfloat16"]["losses"],
                                               ref["float32"]["losses"]))
            gaps = [max(abs(a - b) for a, b in zip(
                r[mode]["losses"], ref["bfloat16"]["losses"])) for r in tp]
            row = {"mode": mode, "e": e, "gaps": gaps,
                   "losses": tp[0][mode]["losses"],
                   "unsharded": ref["bfloat16"]["losses"],
                   "f32": ref["float32"]["losses"],
                   "ms_p50": [sorted(r[mode]["ms"][1:])[
                       len(r[mode]["ms"][1:]) // 2] for r in tp],
                   "unsharded_ms_p50": sorted(
                       ref["bfloat16"]["ms"][1:])[
                           len(ref["bfloat16"]["ms"][1:]) // 2],
                   "peak": [r[mode].get("peak") for r in tp],
                   "unsharded_peak": ref["bfloat16"].get("peak"),
                   "local_bytes": tp[0][mode]["local_bytes"],
                   "profiled_step_ms": [r[mode].get("profiled_step_ms")
                                        for r in tp],
                   "nccl_device_ms": [r[mode].get("nccl_device_ms")
                                      for r in tp],
                   "analysis": [r[mode]["analysis"] for r in tp],
                   "step_peak": [r[mode].get("step_peak") for r in tp],
                   "traced": traced[mode]}
            rows.append(row)
            print(f"[cards] (a) {ARCH} {mode} on (data 1, model 2), "
                  f"{CARDS_STEPS} AdamW steps of {spec['train_batch']}: "
                  f"losses {[round(x, 5) for x in row['losses']]} against "
                  f"unsharded {[round(x, 5) for x in row['unsharded']]} "
                  f"(f32 {[round(x, 5) for x in row['f32']]}); gaps "
                  f"{[round(g, 5) for g in gaps]} against 3E = "
                  f"{3 * e:.5f}; step ms p50 {row['ms_p50']} against "
                  f"{row['unsharded_ms_p50']:.1f}; peak {row['peak']} B "
                  f"against {row['unsharded_peak']} B; shards "
                  f"{row['local_bytes']} B; NCCL device ms in a profiled "
                  f"step {row['nccl_device_ms']} of "
                  f"{row['profiled_step_ms']}", flush=True)
            tr = traced[mode]
            print(f"[cards] (a) {mode}: one step's collectives counted on "
                  f"the ranks (count, bytes by kind) "
                  f"{[coll_counts(a) for a in row['analysis']]} against the "
                  f"dry run's record for {spec['train_batch']} on (data 1, "
                  f"model 2) {coll_counts(tr['analysis'])}; each rank's "
                  f"max_memory_allocated over the step {row['step_peak']} B "
                  f"beside the traced per-device peak {tr['peak']} B",
                  flush=True)
            before = CARDS_PROPAGATED_MS[("mask", "gather").index(mode)]
            ratios = [p / tr["peak"] for p in row["step_peak"]
                      if p is not None]
            print(f"[cards] (a) {mode}: the sharded step's p50 "
                  f"{row['ms_p50']} ms beside {before} ms with the "
                  f"projections laid out by DTensor's propagation (four "
                  f"H100 80GB HBM3, 700 W); max_memory_allocated over the "
                  f"step / traced peak {[round(x, 4) for x in ratios]} "
                  f"(band {PLAN_PEAK_BAND})", flush=True)
            if not all(math.isfinite(x) for r in tp
                       for x in r[mode]["losses"]) or \
                    max(gaps) > MESH_E_FACTOR * e:
                fail(f"the sharded trainer ({mode}) is off: {row}")
            if not all(PLAN_PEAK_BAND[0] <= x <= PLAN_PEAK_BAND[1]
                       for x in ratios):
                fail(f"a rank's step peak ({mode}) is off the traced "
                     f"peak: {ratios}, band {PLAN_PEAK_BAND}")
            for a in row["analysis"]:
                if a["collectives"] != tr["analysis"]["collectives"] or \
                        a.get("unmapped") != tr["analysis"].get("unmapped"):
                    fail(f"a rank's step ({mode}) ran collectives {a}, not "
                         f"the dry run's {tr['analysis']}")
        out["tp"] = rows

        # (b) deepseek-moe-16b's prefill under EP, 2 cards
        t0 = time.perf_counter()
        ep = mesh_spawn("ep_prefill", 2, tmp, spec)
        out["ep_s"] = time.perf_counter() - t0
        ref = ep_prefill_run(mesh_cfg(MOE_ARCH, spec), dev, spec)
        ep_rows = {}
        for name in ("off", "on"):
            want, f32 = ref["bfloat16"][name], ref["float32"][name]
            got, got32 = ep[0]["bfloat16"][name], ep[0]["float32"][name]
            tol32 = MESH_F32_TOL * float(f32.abs().max())
            clear, held = argmax_held(got32, f32, tol32)
            ep_rows[name] = {
                "e": float((want - f32).abs().max()),
                "gap": float((got - want).abs().max()),
                "gap_f32": float((got32 - f32).abs().max()),
                "tol_f32": tol32, "argmax_clear": clear,
                "argmax_held": held,
                "finite": bool(torch.isfinite(got).all()
                               and torch.isfinite(got32).all())}
        out["ep"] = {"rows": ep_rows,
                     "local_weight_bytes": [r["local_weight_bytes"]
                                            for r in ep],
                     "peak": [r.get("peak_bfloat16") for r in ep],
                     "peak_f32": [r.get("peak_float32") for r in ep],
                     "unsharded_peak": ref.get("peak_bfloat16")}
        print(f"[cards] (b) {MOE_ARCH} api.prefill of "
              f"{spec['moe_tokens']} tokens under EP on (data 1, model 2), "
              f"last logits against the unsharded prefill, DSG off / on: "
              f"bf16 max gap {[(round(r['gap'], 4), round(MESH_E_FACTOR * r['e'], 4)) for r in ep_rows.values()]}"
              f" (gap, 3E); f32 on the same weights max gap "
              f"{[(r['gap_f32'], r['tol_f32']) for r in ep_rows.values()]}"
              f" (gap, {MESH_F32_TOL} of the largest logit), argmax kept "
              f"where the f32 top-2 margin passes twice that "
              f"{[(r['argmax_held'], r['argmax_clear']) for r in ep_rows.values()]}; "
              f"weights {out['ep']['local_weight_bytes']} B a rank, peak "
              f"{out['ep']['peak']} B (f32 {out['ep']['peak_f32']}) against "
              f"{out['ep']['unsharded_peak']} B unsharded", flush=True)
        off = ep_rows["off"]
        if not (off["finite"] and ep_rows["on"]["finite"]
                and off["gap"] <= MESH_E_FACTOR * off["e"]
                and off["gap_f32"] <= off["tol_f32"]
                and off["argmax_clear"] > 0
                and off["argmax_held"] == off["argmax_clear"]):
            fail(f"EP prefill (DSG off) is off the unsharded one: {off}")

        # (d) generate under a (data 2, model 2) mesh, 4 cards
        from repro_torch.launch.serve import generate
        t0 = time.perf_counter()
        gen = mesh_spawn("generate", 4, tmp, spec)
        out["gen_s"] = time.perf_counter() - t0
        cfg, model, dsg, prompts = generate_case(dev)
        one = generate(cfg, model, dsg, prompts, CARDS_GEN[2]).cpu()
        del model, dsg
        same = [bool(torch.equal(r["stream"], one)) for r in gen]
        out["generate"] = {"same": same, "stream": one.tolist(),
                           "s": [r["s"] for r in gen]}
        print(f"[cards] (d) launch.serve.generate of {ARCH}'s smoke model "
              f"(f32, DSG on), {CARDS_GEN[0]} prompts of {CARDS_GEN[1]} + "
              f"{CARDS_GEN[2]} greedy tokens, on (data 2, model 2): each "
              f"rank's stream equal to the one card's {same} "
              f"({[round(r['s'], 2) for r in gen]} s)", flush=True)
        if not all(same):
            fail(f"generate under the mesh is off the one card's stream: "
                 f"{[r['stream'].tolist() for r in gen]} against "
                 f"{one.tolist()}")

        # (c) the collectives on 4 cards, and remesh_state
        if spec.get("coll", True):
            coll = mesh_spawn("coll", 4, tmp, spec)
            rm = mesh_spawn("remesh", 4, tmp, spec)
            out["coll"], out["remesh"] = coll, rm
            print(f"[cards] (c) 4 cards: pipeline equal "
                  f"{[c['pipe']['equal'] for c in coll]}, ms p50 "
                  f"{coll[0]['pipe']['ms_p50']:.2f}; reductions "
                  f"{[[(c[k]['err_red'], c[k]['err_buf']) for k in ('hier_off', 'hier_on', 'cpsum')] for c in coll]}"
                  f", ms p50 {[round(coll[0][k]['ms_p50'], 2) for k in ('hier_off', 'hier_on', 'cpsum')]}; "
                  f"remesh_state onto {rm[0]['plan']}: {rm[0]['leaves']} "
                  f"leaves equal {[r['same'] for r in rm]}, laid by their "
                  f"specs {[r['laid'] for r in rm]}", flush=True)
            for c in coll:
                if not c["pipe"]["equal"] or any(
                        max(c[k]["err_red"], c[k]["err_buf"]) > MESH_COLL_TOL
                        for k in ("hier_off", "hier_on", "cpsum")):
                    fail(f"a collective is off on four cards: {c}")
            kept = rm[:rm[0]["plan"][0]]
            if not all(r["same"] and r["laid"] for r in kept):
                fail(f"remesh_state lost a leaf: {rm}")

        # (g) the recurrent families' training step, 4 cards
        t0 = time.perf_counter()
        traced = {arch: traced_rec_train(spec, arch, dev)
                  for arch in REC_CARDS_ARCHS}
        out["rec_traced_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rt = mesh_spawn("rec_train", 4, tmp, spec)
        out["rec_s"] = time.perf_counter() - t0
        out["rec_train"] = {}
        for arch in REC_CARDS_ARCHS:
            tr = traced[arch]
            runs = [r[arch] for r in rt]
            out["rec_train"][arch] = {
                "losses": [r["losses"] for r in runs],
                "ms": [r["ms"] for r in runs],
                "peak": [r["peak"] for r in runs],
                "analysis": [r["analysis"] for r in runs], "traced": tr}
            print(f"[cards] (g) {arch} at {REC_GROUPS} groups, "
                  f"{spec['train_batch']} on (data 2, model 2): losses "
                  f"{[[round(x, 4) for x in r['losses']] for r in runs]}; "
                  f"one step's collectives counted on each rank "
                  f"{[coll_counts(r['analysis']) for r in runs]} against "
                  f"the dry run's record {coll_counts(tr['analysis'])}; "
                  f"step ms {[round(r['ms'], 1) for r in runs]}; peak "
                  f"{[r['peak'] for r in runs]} B beside the traced "
                  f"per-device peak {tr['peak']} B", flush=True)
            for r in runs:
                if not all(math.isfinite(x) for x in r["losses"]):
                    fail(f"(g) {arch}: losses {r['losses']}")
                a = r["analysis"]
                if a["collectives"] != tr["analysis"]["collectives"] or \
                        a.get("unmapped") != tr["analysis"].get("unmapped"):
                    fail(f"(g) {arch}: a rank's step ran collectives {a}, "
                         f"not the dry run's {tr['analysis']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main_mesh_cards() -> int:
    """`python3 chip_smoke.py --mesh-cards`: the whole model sharded with
    one card a rank over NCCL, on four cards.  (a) internlm2-1.8b trains
    4 AdamW steps (batch 8 x 256 of `synthetic.batch_at`, seed 0, bf16
    with f32 masters, remat, f(W) every 2) on a (data 1, model 2) mesh,
    in DSG mask mode and in gather_shared with n_chunks 2, each against
    the same run unsharded on card 0 after the ranks exit: losses finite
    and within MESH_E_FACTOR x E of the unsharded ones, E the unsharded
    run's own bf16-against-f32 gap at the same steps (ROADMAP.md §3's
    bf16 rule); step ms p50, peak memory, the shards' bytes and the NCCL
    kernels' device time in a profiled step.  (b) deepseek-moe-16b's
    api.prefill of 4 x 128 seeded tokens under expert parallelism on (data
    1, model 2) against the unsharded prefill, DSG on and off, in bf16 and
    then in f32 on the same weights upcast.  With it off: in bf16 the last
    logits within MESH_E_FACTOR x E (E: the unsharded bf16-against-f32
    gap), a weak bound at full depth, where the random model turns
    rounding into gaps near the logits' own size; in f32 within
    MESH_F32_TOL of the largest logit, and argmax equal on every row
    whose top-2 margin exceeds twice that, at least one such row.  With
    it on the gaps are printed (each expert shard thresholds at its own
    first slot, as the reference's EP body does).  About 16.9 GB of bf16
    weights a rank: 15.5 GB of the 31.0 GB of routed experts and half of
    the other 2.8 GB (33.8 GB in f32).
    (d) `launch.serve.generate(..., mesh=)` of internlm2-1.8b's smoke
    model in f32 (DSG on), 4 prompts of 8 + 8 greedy tokens, on a (data
    2, model 2) mesh of the four cards: every rank's stream equal to the
    one card's.  (c) phase 27's collectives on four cards, and
    remesh_state of the (data 2, model 2) trainer state onto
    plan_after_loss(3, model=2)'s mesh, every leaf equal.  In (a) one
    more step on each rank, its batch laid out first, runs under
    `launch.comm_analysis`'s counter: its collectives, kind by kind in
    count and bytes, must equal the dry run's trace of that step (the
    same config, batch and mesh, on rank 0 of a 2-rank fake group), and
    each rank's max_memory_allocated over the step must be the traced
    per-device peak within PLAN_PEAK_BAND; the step's p50 is printed
    beside CARDS_PROPAGATED_MS.  (e) phase 28 on four ranks with a card
    each, 8 replicas (a block of two a rank), against the one-process
    sharded router of 8 replicas on card 0, fault-free and under a kill
    of its busiest replica outside rank 0's block (`cards_replicas`);
    (f) a threaded Router of 4 replicas placed on the four cards, timed
    against the same router on card 0 (`cards_threaded`).  Prints the
    card line and `{"ok": true}`."""
    import torch
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    if torch.cuda.device_count() < 4:
        print("chip_smoke --mesh-cards: needs four CUDA devices",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    from repro_torch.kernels import cuda_lib
    lib, build_s = cuda_lib.build()
    print(f"[build] {lib.name} in {build_s:.2f}s", flush=True)
    t0 = time.perf_counter()
    out = mesh_cards_phase(torch.device("cuda"))
    print("[cards] stats " + json.dumps(out, default=str), flush=True)
    print(f"[cards] {time.perf_counter() - t0:.2f}s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def coll_counts(analysis: dict) -> dict:
    """{kind: (count, bytes)} of the kinds a record's analysis ran."""
    return {k: (v["count"], v["bytes"])
            for k, v in analysis["collectives"].items() if v["count"]}


def rel_gap(a, b) -> float:
    """max |a - b| over max |b|, in f32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max())


def loss_check(cfg, dev, spec, tp) -> dict:
    """Phase 27 (a)'s vocab-parallel loss against the unsharded
    `cross_entropy` on this device: the loss and each rank's vocab shard
    of the logits' gradient within MESH_E_FACTOR x E, E the unsharded
    loss's own gap between the bf16 logits and the f32 ones they round;
    the planted fault (labels one shard on) outside that bound; each
    rank's counted collectives equal to the fake trace of the call."""
    import torch
    from repro_torch.models.transformer import cross_entropy
    x32, labels = loss_case(cfg, dev, spec["loss_tokens"])
    want = {}
    for dt in (torch.float32, torch.bfloat16):
        x = x32.to(dt).requires_grad_(True)
        loss = cross_entropy(x, labels)
        (grad,) = torch.autograd.grad(loss, [x])
        want[dt] = (float(loss.detach()), grad.detach())
        del x, loss, grad
    f32, bf = want[torch.float32], want[torch.bfloat16]
    e_loss, e_grad = abs(bf[0] - f32[0]), rel_gap(bf[1], f32[1])
    bound = {"loss": MESH_E_FACTOR * e_loss, "grad": MESH_E_FACTOR * e_grad}
    half = cfg.vocab // 2
    rows = []
    for r, res in enumerate(tp):
        cols = slice(r * half, (r + 1) * half)
        rows.append({
            "loss_gap": abs(res["loss"][0] - f32[0]),
            "grad_gap": rel_gap(res["loss"][1].to(dev), f32[1][..., cols]),
            "fault_loss_gap": abs(res["loss_fault"][0] - f32[0]),
            "fault_grad_gap": rel_gap(res["loss_fault"][1].to(dev),
                                      f32[1][..., cols]),
            "ms_p50": res["loss_ms_p50"], "analysis": res["loss_analysis"]})
    planted_faults(bound, {
        f"labels one shard on, rank {r}, {k}": (k, row[f"fault_{k}_gap"])
        for r, row in enumerate(rows) for k in ("loss", "grad")})
    traced = traced_vp_loss(dev, x32, labels)
    del x32, want, f32, bf
    print(f"[mesh] (a) the vocab-parallel loss (sharded_cross_entropy) "
          f"over {spec['loss_tokens']} tokens x vocab {cfg.vocab} in bf16, "
          f"split over 'model': gaps to the unsharded f32 cross_entropy "
          f"(loss, the logits' gradient) "
          f"{[(row['loss_gap'], round(row['grad_gap'], 6)) for row in rows]}"
          f" against {MESH_E_FACTOR} x E (E, the unsharded loss's own "
          f"bf16-against-f32 gap: loss {e_loss:.6g}, gradient "
          f"{e_grad:.6f}); planted fault (labels one shard on) gaps "
          f"{[(row['fault_loss_gap'], round(row['fault_grad_gap'], 6)) for row in rows]}"
          f"; ms p50 {[round(row['ms_p50'], 2) for row in rows]}; "
          f"collectives counted on the ranks "
          f"{[coll_counts(row['analysis']) for row in rows]} against the "
          f"fake trace's {coll_counts(traced)}", flush=True)
    for row in rows:
        if row["analysis"]["collectives"] != traced["collectives"] or \
                row["analysis"].get("unmapped") != traced.get("unmapped"):
            fail(f"the loss's collectives counted on a rank "
                 f"{row['analysis']} are not the fake trace's {traced}")
        if not (row["loss_gap"] <= bound["loss"]
                and row["grad_gap"] <= bound["grad"]):
            fail(f"the vocab-parallel loss is off the unsharded one: {row}")
    return {"e_loss": e_loss, "e_grad": e_grad, "ranks": rows,
            "traced": traced}


def mesh_phase(dev, spec=None) -> dict:
    """Phase 27: the model's parallel parts on rank processes of one card,
    a gloo group each part (see the module docstring).  `spec` sets the
    device and the shapes ({} for the card at full width)."""
    import shutil
    import tempfile
    import torch
    from repro_torch.core import dsg_linear as dl
    from repro_torch.launch import dryrun, mesh as lmesh
    from repro_torch.models import moe
    spec = dict({"device": dev.type, "ffn_tokens": [8, 256],
                 "loss_tokens": [2, 128], "moe_tokens": [4, 128],
                 "pipe_micro": [4, 2, 256]}, **(spec or {}))
    launches_before = mesh_launches()
    out = {"cpu_only": MESH_CPU_ONLY}
    tmp = Path(tempfile.mkdtemp())
    try:
        # the dry run's per-device bytes on (data 1, model 2)
        cfg = mesh_cfg(ARCH, spec)
        with lmesh.fake_world(2):
            fmesh = lmesh.make_elastic_mesh(2, model=2, device_type="cpu")
            over = [f"{k}={v!r}" for k, v in
                    spec.get("overrides", {}).get(ARCH, {}).items()]
            mem = dryrun.memory(dryrun.build_cell(ARCH, "train_4k", fmesh,
                                                  overrides=over))
        out["dryrun"] = {k: mem[k] for k in ("params", "dsg", "opt")}

        # (a) the trainer's layout and the sharded gather FFN, 2 ranks
        t0 = time.perf_counter()
        tp = mesh_spawn("tp", 2, tmp, spec)
        out["tp_s"] = time.perf_counter() - t0
        dcfg = cfg.dsg._replace(mode="gather_shared", n_chunks=2)
        w, st, x, gy = ffn_case(cfg, dev, torch.bfloat16, spec["ffn_tokens"])
        t0 = time.perf_counter()
        traced = traced_tp_ffn(cfg, dev, w, st, x, gy)
        out["traced_s"] = time.perf_counter() - t0
        wb = {k: v.detach().requires_grad_(True) for k, v in w.items()}
        xb = x.detach().requires_grad_(True)
        ffn = type("FFN", (), wb)

        def unsharded():
            yy = dl.swiglu_dsg_gather(ffn, xb, st, dcfg)
            return yy, torch.autograd.grad(
                yy, [xb, wb["w_gate"], wb["w_up"], wb["w_down"]],
                grad_outputs=gy)
        y, g = unsharded()
        want = {"y": y.detach(), "dx": g[0], "dw": list(g[1:])}
        unsharded_ms = host_ms(unsharded)[0]
        # E with the selection held fixed: the f32 function on the groups
        # the bf16 run kept (bf16 and f32 scores pick different groups)
        blk = dcfg.block
        keep = torch.zeros(cfg.d_ff // blk, device=dev)
        keep[dl.shared_topk_indices(x, st, dcfg, cfg.d_ff)] = 1.0
        keep = keep.repeat_interleave(blk)
        f32 = masked_swiglu_grads({k: v.float() for k, v in w.items()},
                                  x.float(), gy.float(), keep)
        e_y, e_dx = rel_gap(want["y"], f32["y"]), rel_gap(want["dx"],
                                                          f32["dx"])
        e_dw = max(rel_gap(a, b) for a, b in zip(want["dw"], f32["dw"]))
        bound = {"y": MESH_E_FACTOR * e_y, "dx": MESH_E_FACTOR * e_dx,
                 "dw": MESH_E_FACTOR * e_dw}
        # planted faults: the output zeroed, model shard 1's groups dropped
        half = cfg.d_ff // 2
        dropped = masked_swiglu_grads(
            w, x, gy, torch.cat([keep[:half], torch.zeros_like(keep[half:])]))
        faults = {"y zeroed": ("y", rel_gap(torch.zeros_like(want["y"]),
                                            want["y"])),
                  "shard 1 dropped, y": ("y", rel_gap(dropped["y"],
                                                      want["y"])),
                  "shard 1 dropped, dx": ("dx", rel_gap(dropped["dx"],
                                                        want["dx"]))}
        planted_faults(bound, faults)
        tpr = {"e_y": e_y, "e_dx": e_dx, "e_dw": e_dw, "ranks": [],
               "unsharded_ms": unsharded_ms,
               "faults": {k: v[1] for k, v in faults.items()}}
        for r, res in enumerate(tp):
            cols = slice(r * half, (r + 1) * half)
            dw_gap = max(rel_gap(res["dw"][0].to(dev), want["dw"][0][:, cols]),
                         rel_gap(res["dw"][1].to(dev), want["dw"][1][:, cols]),
                         rel_gap(res["dw"][2].to(dev), want["dw"][2][cols]))
            tpr["ranks"].append({
                "y_gap": rel_gap(res["y"].to(dev), want["y"]),
                "dx_gap": rel_gap(res["dx"].to(dev), want["dx"]),
                "dw_gap": dw_gap,
                "local_bytes": res["local_bytes"],
                "state_allocated": res.get("state_allocated"),
                "layout_peak": res.get("layout_peak"),
                "ffn_peak": res.get("ffn_peak"), "ms_p50": res["ms_p50"],
                "profile": res["profile"], "analysis": res["analysis"],
                "kernel_launches": res["kernel_launches"]})
        out["tp"] = tpr
        del want, f32, dropped, w, wb, st, x, xb, gy, g, y, ffn, keep
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[mesh] (a) internlm2-1.8b on (data 1, model 2), 2 gloo "
              f"ranks on one {dev.type} device: the trainer's state as "
              f"DTensors, rank 0 {tp[0]['local_bytes']} B against the dry "
              f"run's per-device {out['dryrun']} B; allocated "
              f"{tp[0].get('state_allocated')} B, layout peak "
              f"{tp[0].get('layout_peak')} B", flush=True)
        print(f"[mesh] (a) swiglu_dsg_gather_sharded fwd+bwd at x "
              f"{spec['ffn_tokens']} x {cfg.d_model}, F {cfg.d_ff}, bf16: "
              f"gaps to the unsharded swiglu_dsg_gather (n_chunks 2) "
              f"{[(round(t['y_gap'], 6), round(t['dx_gap'], 6), round(t['dw_gap'], 6)) for t in tpr['ranks']]} "
              f"(y, dx, dW) against {MESH_E_FACTOR} x E (E, the bf16 run's "
              f"gap to f32 on the groups it kept: y {e_y:.6f}, dx "
              f"{e_dx:.6f}, dW {e_dw:.6f}); planted faults' gaps "
              f"{ {k: round(v, 6) for k, v in tpr['faults'].items()} }; ms p50 {[round(t['ms_p50'], 2) for t in tpr['ranks']]} "
              f"(unsharded {unsharded_ms:.2f}); "
              f"collectives {tp[0]['profile']}", flush=True)
        tpr["traced"] = traced
        print(f"[mesh] (a) the call's collectives counted on the ranks "
              f"(count, bytes by kind) "
              f"{[coll_counts(t['analysis']) for t in tpr['ranks']]}, "
              f"FLOPs {[t['analysis']['flops'] for t in tpr['ranks']]}; "
              f"the dry run's trace of it on a 2-rank fake group "
              f"{coll_counts(traced)}, FLOPs {traced['flops']} "
              f"({out['traced_s']:.2f}s)", flush=True)
        for t in tpr["ranks"]:
            if t["analysis"]["collectives"] != traced["collectives"] or \
                    t["analysis"].get("unmapped") != traced.get("unmapped"):
                fail(f"the collectives counted on a rank "
                     f"{t['analysis']} are not the fake trace's {traced}")
            if t["local_bytes"] != out["dryrun"]:
                fail(f"a rank's shards {t['local_bytes']} are not the dry "
                     f"run's {out['dryrun']}")
            if (not t["y_gap"] <= bound["y"] or not t["dx_gap"] <= bound["dx"]
                    or not t["dw_gap"] <= bound["dw"]):
                fail(f"the sharded gather FFN is off the unsharded one: {t}")
        out["loss"] = loss_check(cfg, dev, spec, tp)

        # (b) one MoE layer's experts under expert parallelism, 2 ranks.
        # With DSG's shared threshold each shard thresholds at its own
        # first slot, as the reference's shard_map body does (ROADMAP.md
        # §3), so the plain computation it is held against runs the body
        # per expert slice and sums; without DSG that is the unsharded
        # body itself
        t0 = time.perf_counter()
        ep = mesh_spawn("ep", 2, tmp, spec)
        out["ep_s"] = time.perf_counter() - t0
        mcfg = mesh_cfg(MOE_ARCH, spec)
        w, router, r, fw, x = moe_case(mcfg, dev, torch.bfloat16,
                                       spec["moe_tokens"])
        logits = x.float() @ router
        route = moe_route(mcfg, logits)
        # E with DSG's selection held fixed: the f32 experts on the groups
        # the bf16 scores kept, each expert shard at its own first slot
        groups = moe_groups(mcfg, x, route, r, fw, 2)
        ref = {}
        for dt in (torch.bfloat16, torch.float32):
            wd, xd = tuple(t.to(dt) for t in w), x.to(dt)
            ref[dt] = {"on": moe_reference(mcfg, xd, wd, route, groups),
                       "off": moe_reference(mcfg, xd, wd, route)}
        bf, f32 = ref[torch.bfloat16], ref[torch.float32]
        e_on, e_off = rel_gap(bf["on"], f32["on"]), rel_gap(bf["off"],
                                                            f32["off"])
        bound = {"on": MESH_E_FACTOR * e_on, "off": MESH_E_FACTOR * e_off}
        # planted faults: the output zeroed, model shard 1's experts dropped
        first = range(mcfg.moe_experts // 2)
        faults = {"y zeroed": ("off", rel_gap(torch.zeros_like(bf["off"]),
                                              bf["off"])),
                  "shard 1 dropped, DSG off": ("off", rel_gap(moe_reference(
                      mcfg, x, w, route, experts=first), bf["off"])),
                  "shard 1 dropped, DSG on": ("on", rel_gap(moe_reference(
                      mcfg, x, w, route, groups, experts=first), bf["on"]))}
        planted_faults(bound, faults)
        gaps = [(rel_gap(res["y"].to(dev), bf["on"]),
                 rel_gap(res["y_off"].to(dev), bf["off"])) for res in ep]
        # the shard-local threshold against one over all 64 experts
        drift = rel_gap(moe_reference(mcfg, x, w, route, moe_groups(
            mcfg, x, route, r, fw, 1)), bf["on"])
        full = SimpleNamespace(w_gate=w[0], w_up=w[1], w_down=w[2])
        cap = moe.capacity(x.shape[0], mcfg.moe_experts, mcfg.moe_topk,
                           mcfg.moe_capacity_factor)
        plain_ms = host_ms(lambda: moe.routed_body(
            x, logits, full, mcfg.moe_experts, mcfg.moe_topk, cap, fw, r,
            mcfg.dsg))[0]
        out["ep"] = {"e_on": e_on, "e_off": e_off, "gaps": gaps,
                     "faults": {k: v[1] for k, v in faults.items()},
                     "dsg_shard_threshold_gap": drift,
                     "local_expert_bytes": [res["local_expert_bytes"]
                                            for res in ep],
                     "peak": [res.get("peak") for res in ep],
                     "ms_p50": [res["ms_p50"] for res in ep],
                     "unsharded_ms": plain_ms,
                     "profile": ep[0]["profile"],
                     "kernel_launches": [res["kernel_launches"]
                                         for res in ep]}
        del ref, bf, f32, w, router, r, fw, x, logits, route, groups, full
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[mesh] (b) {MOE_ARCH} one layer's routed experts under EP "
              f"({mcfg.moe_experts // 2} of {mcfg.moe_experts} a rank, "
              f"{spec['moe_tokens']} tokens, bf16): gaps (DSG on, off) to "
              f"the plain experts {[(round(a, 6), round(b, 6)) for a, b in gaps]}"
              f" against {MESH_E_FACTOR} x E (E, the plain bf16 experts' "
              f"gap to f32 on the same DSG groups: on {e_on:.6f}, off "
              f"{e_off:.6f}); planted faults' gaps "
              f"{ {k: round(v, 6) for k, v in out['ep']['faults'].items()} }"
              f"; the shard-local DSG threshold moves the plain output "
              f"{drift:.6f} from one over all experts; local expert "
              f"bytes {out['ep']['local_expert_bytes']}; ms p50 "
              f"{[round(m, 2) for m in out['ep']['ms_p50']]} (unsharded "
              f"routed_body {plain_ms:.2f}); collectives "
              f"{ep[0]['profile']}", flush=True)
        if not all(a <= bound["on"] and b <= bound["off"] for a, b in gaps):
            fail(f"expert parallelism is off the plain experts: {gaps}")

        # (c) the collectives at full-width shapes, 4 ranks
        t0 = time.perf_counter()
        coll = mesh_spawn("coll", 4, tmp, spec)
        out["coll_s"] = time.perf_counter() - t0
        out["coll"] = coll
        c0 = coll[0]
        print(f"[mesh] (c) 4 gloo ranks: pipeline_forward (pipe 4, "
              f"{spec['pipe_micro']} microbatches of SwiGLU stages, bf16) "
              f"equal to sequential_reference on every rank "
              f"{[c['pipe']['equal'] for c in coll]}, ms p50 "
              f"{c0['pipe']['ms_p50']:.2f}; hierarchical off/on and "
              f"compressed_psum gaps (reduced, buffer) "
              f"{[[(round(c[k]['err_red'], 9), round(c[k]['err_buf'], 9)) for k in ('hier_off', 'hier_on', 'cpsum')] for c in coll]}"
              f", ms p50 {[round(c0[k]['ms_p50'], 2) for k in ('hier_off', 'hier_on', 'cpsum')]}; "
              f"make_global_batch rows "
              f"{[c['global_batch']['rows_equal'] for c in coll]} of "
              f"{c0['global_batch']['shape']}", flush=True)
        for c in coll:
            if not c["pipe"]["equal"] or not c["global_batch"]["rows_equal"]:
                fail(f"pipeline or global batch off on a rank: {c}")
            for k in ("hier_off", "hier_on", "cpsum"):
                if max(c[k]["err_red"], c[k]["err_buf"]) > MESH_COLL_TOL:
                    fail(f"{k} off the plain reduction: {c[k]}")
        print(f"[mesh] on CPU ranks only: {MESH_CPU_ONLY}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launched = [t["kernel_launches"] for t in out["tp"]["ranks"]] + \
        out["ep"]["kernel_launches"] + \
        [c["kernel_launches"] for c in out["coll"]] + [mesh_launches()]
    if any(any(v for v in k.values()) for k in launched) or \
            mesh_launches() != launches_before:
        fail(f"a kernel launched in phase 27: {launched}")
    return out


def main() -> int:
    import torch
    if len(sys.argv) > 1 and sys.argv[1] == MESH_RANK_FLAG:
        return mesh_worker(sys.argv[2:])
    if len(sys.argv) > 1 and sys.argv[1] == CARDS_FLAG:
        return main_mesh_cards()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import configs
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import api
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    from repro_torch.serving.scheduler import ServingEngine
    from repro_torch.serving.workload import (
        engine_stats, mixed_requests, poisson_arrivals, run_engine,
        run_open_loop, shared_prefix_requests, warmup_engine)

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
    kernels = serve_kernels()
    drs = ("drs_project", "drs_scores")
    # the DRS kernels run at two shapes: M = the prompt bucket at admission
    # and M = the lane count at refresh steps
    stats, launches, by_path, captures, refresh = traced(
        cfg, tuple(kernels),
        lambda: run_engine(eng, mixed_requests(cfg.vocab, 8, seed=SEED)),
        eng_kw["n_slots"])
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
        if launches[name] != want[name]:
            fail(f"{name} launched {launches[name]} times on the serve "
                 f"path, expected {want[name]}")
    for name in drs:
        got = {"admission": launches[name] - refresh[name].n,
               "refresh": refresh[name].n}
        if got != by_shape:
            fail(f"{name} launched {got} times by shape, expected "
                 f"{by_shape}")
    # every call took the path its shape plans (traced holds that); at this
    # width every admission launch of the DRS kernels takes the wgmma
    # tiles and every refresh launch the GEMV
    for name in drs:
        for cap, path in ((captures[name], "tc"), (refresh[name], "gemv")):
            if plan_path(name, cap.args, cap.kwargs) != path:
                fail(f"{name} at {list(cap.args[0].shape)} plans "
                     f"{plan_path(name, cap.args, cap.kwargs)}, not {path}")
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
    wrappers = {n: v[0] for n, v in kernels.items()}
    t0 = time.perf_counter()
    reqs3 = lambda: mixed_requests(cfg.vocab, 8, seed=SEED)  # noqa: E731
    stats8, launches8, acct8, streams8 = graph_serve(
        cfg, model, dsg, kw8, wrappers, reqs3())
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
    if same != len(streams3):
        fail(f"{same} of {len(streams3)} chunk-{chunk} bf16 streams equal "
             f"the eager serve's: a lane's stream depends on its "
             f"co-resident lanes")
    phase_launches = {f"chunk{chunk}": launches8}
    print("[chunked] stats " + json.dumps(dict(stats8, **acct8)), flush=True)

    # solo: each of phase 3's requests alone at chunk 8
    t0 = time.perf_counter()
    stats_solo, phase_launches["solo"], _, solo = graph_serve(
        cfg, model, dsg, kw8, wrappers, reqs3(), drive=solo_drive)
    same = {u: (solo[u] == streams3[u], solo[u] == streams8[u])
            for u in streams3}
    print(f"[solo] each of the 8 requests alone at chunk {chunk}: "
          f"{sum(a for a, _ in same.values())} of 8 streams equal phase 3's "
          f"and {sum(b for _, b in same.values())} of 8 phase 10's; "
          f"launches {phase_launches['solo']}; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if not all(a and b for a, b in same.values()):
        fail(f"a request served alone decodes another bf16 stream than in "
             f"a batch: {same}")

    # sample: 4 greedy and 4 sampled requests at chunk 1 and chunk 8, and
    # chunk 8 again in a fresh engine with the same seed
    t0 = time.perf_counter()

    def sampled():
        reqs = reqs3()
        for r in reqs[1::2]:
            r.temperature, r.top_p = 0.8, 0.9
        return reqs
    runs = {}
    stats_s1, phase_launches["sample_chunk1"], runs["chunk 1"] = \
        eager_serve(cfg, model, dsg, eng_kw, wrappers, sampled())
    for tag in ("chunk 8", "chunk 8 again"):
        st, phase_launches["sample_" + tag.replace(" ", "_")], acct, \
            runs[tag] = graph_serve(cfg, model, dsg, kw8, wrappers, sampled())
        sample_keys = sum(v for k, v in acct["replays_by_key"].items()
                          if k.endswith("True)"))
        if tag == "chunk 8":
            stats_s8, replays_sampled = st, sample_keys
    greedy = [u for u in streams3 if u % 2 == 0]
    drawn = [u for u in streams3 if u % 2 == 1]
    kept = sum(runs[t][u] == streams3[u] for t in runs for u in greedy)
    stable = sum(runs["chunk 1"][u] == runs[t][u] for t in runs
                 for u in drawn)
    moved = sum(runs["chunk 1"][u] != streams3[u] for u in drawn)
    print(serve_line("sample/chunk1", stats_s1), flush=True)
    print(serve_line(f"sample/chunk{chunk}", stats_s8), flush=True)
    print(f"[sample] {kept} of {3 * len(greedy)} greedy streams equal phase "
          f"3's; {stable} of {3 * len(drawn)} sampled streams equal the "
          f"chunk-1 run's (chunk 1, chunk {chunk}, chunk {chunk} again), "
          f"{moved} of {len(drawn)} differ from their greedy stream; "
          f"{replays_sampled} replays of sampling graphs; TPOT p50 "
          f"{1e3 * stats_s8['tpot_p50_s']:.2f} ms at chunk {chunk} beside "
          f"phase 10's {1e3 * stats8['tpot_p50_s']:.2f} ms (chunk 1: "
          f"{1e3 * stats_s1['tpot_p50_s']:.2f} ms); "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if kept != 3 * len(greedy) or stable != 3 * len(drawn) \
            or not replays_sampled:
        fail("sampling moved a greedy lane's stream, or a sampled stream "
             "changed with the chunk or from run to run, or no sampling "
             "graph ran")
    print("[sample] stats " + json.dumps({"chunk1": stats_s1,
                                          f"chunk{chunk}": stats_s8}),
          flush=True)

    # prefix: 8 requests sharing a 160-token prefix, sharing on and off
    t0 = time.perf_counter()
    prefix = {}
    for on in (False, True):
        kw = dict(kw8, prefix_sharing=on)
        st, phase_launches[f"prefix_{'on' if on else 'off'}"], _, \
            streams = graph_serve(cfg, model, dsg, kw, wrappers,
                                  shared_prefix_requests(
                                      cfg.vocab, 8, prompt_len=192,
                                      prefix_len=160, max_new=32, seed=SEED))
        prefix[on] = (st, streams)
    (st_off, s_off), (st_on, s_on) = prefix[False], prefix[True]
    same = sum(s_on[u] == s_off[u] for u in s_off)
    print(serve_line("prefix/off", st_off), flush=True)
    print(serve_line("prefix/on", st_on), flush=True)
    print(f"[prefix] {same} of {len(s_off)} streams equal with sharing on "
          f"and off; shared page hits {st_on['shared_page_hits']}, COW "
          f"copies {st_on['cow_copies']}, prefill replays "
          f"{st_on['prefill_cache_hits']}; peak live pages "
          f"{st_on['peak_live_pages']} on, {st_off['peak_live_pages']} off; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if same != len(s_off) or not st_on["shared_page_hits"] \
            or st_on["peak_live_pages"] >= st_off["peak_live_pages"]:
        fail("prefix sharing changed a stream, shared no page or did not "
             "lower the peak of live pages")

    # open loop: Poisson arrivals at half the rate phase 10 completed, and
    # one request whose deadline lapses in the queue
    t0 = time.perf_counter()
    rate = 0.5 * stats8["requests"] / stats8["wall_s"]
    reqs_ol = mixed_requests(cfg.vocab, 17, seed=SEED + 5)
    late = reqs_ol[-1]
    late.deadline_s = 1e-6
    arrivals = list(poisson_arrivals(16, rate, seed=SEED + 5))
    arrivals.append(arrivals[len(arrivals) // 2])
    order = sorted(range(17), key=lambda i: arrivals[i])

    def open_loop(eng, reqs):
        t = time.perf_counter()
        done = run_open_loop(eng, [reqs[i] for i in order],
                             [arrivals[i] for i in order])
        torch.cuda.synchronize()
        return engine_stats(eng, done, time.perf_counter() - t)
    st_ol, phase_launches["open_loop"], _, _ = graph_serve(
        cfg, model, dsg, kw8, wrappers, reqs_ol, drive=open_loop,
        expect_ok=16)
    print(serve_line("open-loop", st_ol), flush=True)
    print(f"[open-loop] 16 requests at {rate:.3f} req/s (half of phase 10's "
          f"{2 * rate:.3f}): statuses {st_ol['statuses']}; TTFT p50 "
          f"{1e3 * st_ol['ttft_p50_s']:.1f} ms p95 "
          f"{1e3 * st_ol['ttft_p95_s']:.1f} ms, TPOT p50 "
          f"{1e3 * st_ol['tpot_p50_s']:.2f} ms p95 "
          f"{1e3 * st_ol['tpot_p95_s']:.2f} ms; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    if late.status != "timed_out" or st_ol["timed_out_requests"] != 1:
        fail(f"the request whose deadline lapsed retired {late.status!r}")
    print("[open-loop] stats " + json.dumps(st_ol), flush=True)

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
    on8 = DSGServingConfig(refresh_interval=8)
    combos = [(backend, c, scfg, {}) for backend in ("dense", "paged")
              for c in (1, chunk) for scfg in (None, on8)]
    combos += [("paged", 1, on8, dict(sample=True)),
               ("dense", chunk, None, dict(sample=True)),
               ("paged", 1, None, dict(sharing=28)),
               ("paged", chunk, on8, dict(sample=True, sharing=20))]
    # the MoE and VLM smoke models, DSG on (mask mode, no serving runtime)
    combos += [(backend, c, None, dict(arch=arch))
               for arch in SMOKE_FAMILY_ARCHS for backend in ("dense", "paged")
               for c in (1, chunk)]
    for backend, c, scfg, extra in combos:
        on_card = smoke_streams(dev, scfg, backend, c, **extra)
        if on_card != smoke_streams(torch.device("cpu"), scfg, backend, c,
                                    **extra) or len(on_card) != 6:
            fail(f"smoke streams on the card differ from the CPU "
                 f"({backend}, chunk {c}, dsg_serving={scfg}, {extra})")
    print(f"[check] smoke-width streams on the card equal the CPU's in all "
          f"{len(combos)}: {{dense, paged}} x {{chunk 1, {chunk}}} x {{DSG "
          f"serving off, on}} greedy, sampling on (paged chunk 1 DSG on, "
          f"dense chunk {chunk}), prefix sharing on (paged chunk 1 on "
          f"identical prompts, paged chunk {chunk} DSG on sampled on a "
          f"20-token prefix), and {' and '.join(SMOKE_FAMILY_ARCHS)} over "
          f"{{dense, paged}} x {{chunk 1, {chunk}}}; "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # 20. the router: 2 replicas behind one front end, each executor,
    # failover, and the EMA threshold
    t0 = time.perf_counter()
    router_out, router_launches = router_phase(cfg, model, dsg, wrappers)
    phase_launches.update(router_launches)
    print("[router] stats " + json.dumps(router_out, default=str),
          flush=True)
    print(f"[phase 20] {time.perf_counter() - t0:.2f}s", flush=True)

    # 6. kernels against their plain versions
    t0 = time.perf_counter()
    origin = {
        "paged_decode": ("src/repro_torch/csrc/paged_attention.cu",
                         "src/repro/kernels/paged_attention.py:129"),
        "dsg_ffn_csr": ("src/repro_torch/csrc/dsg_ffn.cu",
                        "src/repro/kernels/dsg_ffn.py:120"),
        "drs_project": ("src/repro_torch/csrc/drs_search.cu",
                        "src/repro/kernels/drs_search.py:29"),
        "drs_scores": ("src/repro_torch/csrc/drs_search.cu",
                       "src/repro/kernels/drs_search.py:56")}
    rows = []
    for name, (kernel, _, plain, cost, _) in kernels.items():
        source, replaces = origin[name]
        library = LIBRARY.get(name)
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
            row["path"] = plan_path(name, captures[name].args, {})
            row["refresh"]["path"] = plan_path(name, refresh[name].args, {})
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
                     f"launches_chunk{chunk}": launches8[name],
                     "launches_by_phase": {k: v[name] for k, v in
                                           phase_launches.items()}, **row})
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

    # 19. the training path at full width, on memory the serve phases gave
    # back: their model, captured operands and graph pools go first
    del model, dsg, ffn, captures, refresh, cases, x_ffn, qkv_a, q_long, \
        k_b, v_b, tokens, ffn_mask
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained = train_phase(dev, wrappers)
    print("[train] stats " + json.dumps(trained), flush=True)
    print(f"[phase 19] {time.perf_counter() - t0:.2f}s", flush=True)

    # 21. deepseek-moe-16b at full width, on memory phase 19 gave back
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe = moe_phase(dev)
    print("[moe] stats " + json.dumps(moe, default=str), flush=True)
    print(f"[phase 21] {time.perf_counter() - t0:.2f}s", flush=True)
    by_name = {r["name"]: r for r in rows}
    by_name["paged_decode"]["moe"] = moe["paged_decode"]
    by_name["paged_decode"]["launches_by_phase"]["moe"] = \
        moe["paged_decode"]["launches"] + moe["paged_decode"][
            "launches_chunk8"]

    # 22. the three other dense configs at full width, one at a time
    t0 = time.perf_counter()
    dense_cfgs = {}
    for arch in DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        dense_cfgs[arch] = dense_config_phase(dev, arch)
        for name, r in dense_cfgs[arch]["kernels"].items():
            kname = name.split()[-1]
            by_name[kname].setdefault("configs", {})[f"{arch} {name}"] = r
        for kname, n in dense_cfgs[arch]["launches"].items():
            by_name[kname]["launches_by_phase"][arch] = n
    print("[configs] stats " + json.dumps(
        {a: {k: v for k, v in o.items() if k != "kernels"}
         for a, o in dense_cfgs.items()}), flush=True)
    print(f"[phase 22] {time.perf_counter() - t0:.2f}s", flush=True)

    # 23-24. the recurrent families at full width, each on freed memory
    for phase, arch in ((23, XLSTM_ARCH), (24, ZAMBA_ARCH)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rec = recurrent_phase(dev, arch)
        print(f"[{arch}] stats " + json.dumps(rec), flush=True)
        print(f"[phase {phase}] {time.perf_counter() - t0:.2f}s", flush=True)

    # 25. the encoder-decoder family at full width, on freed memory
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper = whisper_phase(dev)
    print(f"[{WHISPER_ARCH}] stats " + json.dumps(whisper), flush=True)
    print(f"[phase 25] {time.perf_counter() - t0:.2f}s", flush=True)

    # 26. the dry run's plan against the card, on memory phase 25 gave back
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    plan = plan_phase(dev)
    print("[plan] stats " + json.dumps(plan, default=str), flush=True)
    print(f"[phase 26] (a) {time.perf_counter() - t0:.2f}s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    plan_b = plan_recurrent(dev)
    print("[plan-b] stats " + json.dumps(plan_b, default=str), flush=True)
    print(f"[phase 26] (b) {time.perf_counter() - t1:.2f}s", flush=True)
    print(f"[phase 26] {time.perf_counter() - t0:.2f}s", flush=True)

    # 27. the parallel parts on rank processes of the card
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    meshed = mesh_phase(dev)
    print("[mesh] stats " + json.dumps(meshed, default=str), flush=True)
    print(f"[phase 27] {time.perf_counter() - t0:.2f}s", flush=True)

    # 28. phase 20 (d)'s replicas as a replica mesh of two rank processes
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    replicas = replica_phase(dev, router_out["replica_ref"])
    by_name["paged_decode"]["launches_by_phase"]["replica_mesh"] = \
        replicas["split"]
    print("[replicas] stats " + json.dumps(replicas, default=str),
          flush=True)
    print(f"[phase 28] {time.perf_counter() - t0:.2f}s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
