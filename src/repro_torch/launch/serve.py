"""Serve through the port: a fixed batch (`generate`) or mixed-length
synthetic traffic through the ServingEngine, as `repro.launch.serve` does.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --workload mixed --requests 4 --cache-backend paged --dsg-serving \\
        --decode-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --workload mixed --requests 4 --temperature 0.8 --top-p 0.9 \\
        --cache-backend paged --prefix-sharing --admission wave
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --workload mixed --replicas 2 --exec-mode threaded --chaos kill@1:6
    PYTHONPATH=src python -m repro_torch.launch.serve --workload mixed \\
        --requests 8 --max-seq 512 --cache-backend paged --dsg-serving
                                             # full width, on the GPU

The defaults are the reference's: `--workload batch` (one batch of
`--batch` prompts of `--prompt-len` tokens, `--gen` greedy tokens each,
every arch but whisper-large-v3; the recurrent archs xlstm-350m and
zamba2-7b serve only so) and `--cache-backend dense` and `--admission
overlap` for `--workload mixed`, whose requests sample at `--temperature`
/ `--top-p` (0 = greedy).
`--replicas N` serves them through a Router (`--route-policy`,
`--exec-mode`); `--chaos KIND@REPLICA:STEP[:SECONDS]` injects faults and
turns on `--fault-tolerance`.  The model is initialised from a seeded
torch.Generator on --device (cuda by default) and shared by every replica.
With no GPU and no `--device cpu` the command exits non-zero; it never
falls back to the CPU.  Flags of the reference launcher outside this list
are rejected, naming ROADMAP.md, and so is `--arch whisper-large-v3`: the
encoder-decoder needs audio frames, which neither this CLI nor the
reference's gives it (the reference's crashes); it runs through the
`api` verbs.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import api
from repro_torch.parallel.sharding import axes_for_mesh
from repro_torch.runtime.fault_tolerance import ReplicaFault
from repro_torch.serving.dsg_runtime import DSGServingConfig
from repro_torch.serving.router import FaultToleranceConfig
from repro_torch.serving.workload import mixed_requests, run_workload

ENCDEC_REFUSAL = (
    "the encoder-decoder family (whisper-large-v3) runs through the "
    "repro_torch.models.api verbs on make_inputs' frames; this CLI feeds "
    "tokens only, and the reference's crashes on it with KeyError 'frames' "
    "(ROADMAP.md §3)")


def generate(cfg, model, dsg, prompts: torch.Tensor, gen_tokens: int, *,
             mesh=None, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """prompts (B, P) int -> tokens (B, gen_tokens): one batched prompt
    prefill into a dense cache of P + gen_tokens positions (for the
    recurrent families, the decode state the prefill returns), then
    token-by-token decode with the same DSG masks as the prefill, as the
    reference's `generate`.  Greedy at temperature 0; above it each
    token is `scheduler.sample_tokens` over the port's counter-hash
    Gumbel noise of (seed, lane, output index), not the reference's
    jax.random key (ROADMAP.md §3, deliberate deviations).

    mesh: run sharded over it, through the `api` verbs' `mesh=`: a model
    and DSG state whose tensors are not DTensors yet are laid out on it
    by `models.specs` in place (every rank holding the same values), the
    prompts by the batch axes, the cache by `specs.cache_specs`; each
    step's logits are gathered whole on every rank, so every rank draws
    the same token.  As the reference's `generate`, it passes the verbs
    no batch axes: an MoE's expert capacity counts the whole batch, as
    on one rank.  The recurrent families refuse a mesh (TypeError, as
    their `api`); the encoder-decoder family raises NotImplementedError:
    it needs frames."""
    if cfg.family == "encdec":
        raise NotImplementedError(f"generate: {ENCDEC_REFUSAL}")
    b, p_len = prompts.shape
    cache = api.make_cache(cfg, b, p_len + gen_tokens,
                           device=prompts.device)
    tokens, kw = prompts.long(), {}
    if mesh is not None:
        if cfg.family in api.RECURRENT_FAMILIES:
            raise TypeError(f"family {cfg.family!r} takes no mesh (the "
                            f"reference's recurrent families run unsharded)")
        tokens, cache, dsg = _lay_out(cfg, model, dsg, tokens, cache, mesh)
        kw = {"mesh": mesh}
    logits, cache = api.prefill(model, dsg, cfg, {"tokens": tokens}, cache,
                                **kw)
    from repro_torch.parallel.sharding import full_tree
    from repro_torch.serving.scheduler import gumbel_noise, sample_tokens
    lanes = torch.arange(b, device=prompts.device)
    temps = torch.full((b,), float(temperature), device=prompts.device)
    top_ps = torch.ones((b,), device=prompts.device)
    out = []
    for i in range(gen_tokens):
        logits = full_tree(logits)
        if temperature > 0:
            noise = gumbel_noise(seed, lanes, torch.full_like(lanes, i),
                                 logits.shape[-1])
            tok = sample_tokens(logits, noise, temps, top_ps).long()
        else:
            tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        logits, cache = api.decode_step(model, dsg, cfg, tok[:, None], cache,
                                        p_len + i, **kw)
    return torch.stack(out, dim=1)


def _lay_out(cfg, model, dsg, tokens, cache, mesh):
    """The model, DSG state, prompts and cache of `generate` on `mesh`,
    laid out by the reference's specs (the model in place)."""
    from repro_torch.models import specs
    from repro_torch.parallel.sharding import (distribute,
                                               distribute_model,
                                               distribute_tree, is_dtensor,
                                               model_shards)
    ax, n = axes_for_mesh(mesh), model_shards(mesh)
    if not any(is_dtensor(p) for p in model.parameters()):
        distribute_model(model, mesh, specs.param_specs(model, cfg, ax, n))
    if dsg is not None and not any(is_dtensor(v) for v in dsg.values()):
        dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, cfg, ax, n))
    tokens = distribute(tokens, mesh,
                        specs.input_specs({"tokens": tokens}, cfg,
                                          ax)["tokens"])
    cache = distribute_tree(cache, mesh,
                            specs.cache_specs(cache, cfg, ax, n))
    return tokens, cache, dsg


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        epilog="Flags of repro.launch.serve outside this list are not "
               "ported yet; see ROADMAP.md.")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workload", choices=("batch", "mixed"),
                    default="batch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=384)
    ap.add_argument("--prompt-bucket", type=int, default=256)
    ap.add_argument("--admission", choices=("overlap", "wave"),
                    default="overlap",
                    help="admit into any free lane on any step (overlap) "
                         "or only once every lane has drained (wave)")
    ap.add_argument("--cache-backend", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--cache-tokens", type=int, default=None)
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="map identical prompt prefixes onto shared "
                         "refcounted pages, copied on write (--cache-backend "
                         "paged only)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass kept when sampling")
    ap.add_argument("--decode-chunk", type=int, default=1,
                    help="decode steps fused into one dispatch (one CUDA "
                         "graph replay on the GPU); greedy streams equal "
                         "--decode-chunk 1's")
    ap.add_argument("--dsg-serving", action="store_true",
                    help="per-lane group-CSR FFN decode with DRS refresh")
    ap.add_argument("--dsg-refresh-interval", type=int, default=8)
    ap.add_argument("--gamma", type=float, default=None,
                    help="DSG sparsity: fraction of neuron groups dropped")
    ap.add_argument("--no-dsg", action="store_true")
    ap.add_argument("--dsg-threshold-mode",
                    choices=("topk", "shared", "ema"), default=None,
                    help="DRS threshold mode (DSGConfig.threshold_mode): "
                         "per-row topk, the paper's inter-sample shared "
                         "threshold, or a cross-step EMA")
    ap.add_argument("--paged-kernel", choices=("auto", "kernel"),
                    default="auto",
                    help="paged decode: auto (the CUDA kernel on CUDA, its "
                         "plain version on CPU) or kernel (CUDA only)")
    ap.add_argument("--dsg-apply", choices=("auto", "kernel"),
                    default="auto",
                    help="group-CSR FFN: auto (the CUDA kernel on CUDA, its "
                         "plain version on CPU) or kernel (CUDA only)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving replicas behind the "
                         "front-end router (serving/router.py)")
    ap.add_argument("--route-policy",
                    choices=("round_robin", "least_queue", "least_pages"),
                    default="least_queue",
                    help="replica routing policy when --replicas > 1")
    ap.add_argument("--exec-mode",
                    choices=("sequential", "threaded", "sharded"),
                    default="sequential",
                    help="replica executor (serving/parallel_exec.py): "
                         "sequential stepping (modeled makespan), a worker "
                         "thread and stream per replica, or one dispatch "
                         "for the group (both: measured makespan)")
    # fault tolerance and chaos
    ap.add_argument("--chaos", action="append", default=[],
                    metavar="KIND@REPLICA:STEP[:SECONDS]",
                    help="inject a deterministic fault: kill@1:40 raises on "
                         "replica 1 at engine step 40, delay@0:10:0.05 "
                         "sleeps 0.05 s, poison@2:9 corrupts resident "
                         "outputs then raises; repeatable; implies "
                         "--fault-tolerance")
    ap.add_argument("--fault-tolerance", action="store_true",
                    help="contain replica failures (FaultToleranceConfig); "
                         "without it a replica failure ends the run")
    ap.add_argument("--max-replica-restarts", type=int, default=1,
                    help="restarts before a failed replica is marked DEAD")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="per-request re-dispatch budget after replica "
                         "failures; beyond it the request fails")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline (submit to admission); an "
                         "expired queued request finishes timed_out")
    ap.add_argument("--stall-timeout-s", type=float, default=None,
                    help="threaded executor: seconds without step progress "
                         "before a replica is marked SUSPECT and aborted")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def parse_chaos(ap, spec: str) -> ReplicaFault:
    """KIND@REPLICA:STEP[:SECONDS] (kill@1:40, delay@0:10:0.05) -> a
    ReplicaFault; an argparse error otherwise."""
    try:
        kind, _, rest = spec.partition("@")
        replica, step, *extra = rest.split(":")
        return ReplicaFault(replica=int(replica), step=int(step), kind=kind,
                            delay_s=float(extra[0]) if extra else 0.05)
    except ValueError as e:
        ap.error(f"bad --chaos spec {spec!r} (KIND@REPLICA:STEP[:SECONDS]): "
                 f"{e}")


def main(argv=None):
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)} (not ported "
                 f"to repro_torch yet; see ROADMAP.md)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    if args.decode_chunk < 1:
        ap.error(f"--decode-chunk must be >= 1, got {args.decode_chunk}")
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch}: {ENCDEC_REFUSAL}")
    if args.no_dsg:
        if args.dsg_serving:
            ap.error("--dsg-serving needs DSG enabled (drop --no-dsg)")
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    if args.dsg_threshold_mode is not None:
        cfg = cfg.replace(dsg=cfg.dsg._replace(
            threshold_mode=args.dsg_threshold_mode))
    if cfg.family in api.RECURRENT_FAMILIES and args.workload == "mixed":
        ap.error(f"--workload mixed: the serving engine runs the decoder "
                 f"families, not {cfg.family!r} ({args.arch} serves through "
                 f"--workload batch; the reference's engine crashes on it, "
                 f"ROADMAP.md §3)")
    if args.dsg_serving and args.workload != "mixed":
        ap.error("--dsg-serving is a mixed-workload (serving engine) "
                 "feature; add --workload mixed")
    if (args.chaos or args.fault_tolerance or args.replicas != 1
            or args.exec_mode != "sequential") and args.workload != "mixed":
        ap.error("--replicas/--exec-mode/--chaos/--fault-tolerance drive "
                 "the serving engine; add --workload mixed")
    if args.replicas < 1:
        ap.error(f"--replicas must be >= 1, got {args.replicas}")
    faults = [parse_chaos(ap, c) for c in args.chaos] or None
    if (args.dsg_serving and args.decode_chunk > 1
            and args.dsg_refresh_interval % args.decode_chunk):
        ap.error(f"--decode-chunk {args.decode_chunk} must divide "
                 f"--dsg-refresh-interval {args.dsg_refresh_interval}")
    if args.prefix_sharing and args.cache_backend != "paged":
        ap.error("--prefix-sharing needs --cache-backend paged")
    if args.temperature < 0:
        ap.error(f"--temperature must be >= 0, got {args.temperature}")
    if not 0.0 <= args.top_p <= 1.0:
        ap.error(f"--top-p must be in [0, 1], got {args.top_p}")
    if args.gamma is not None:
        if not 0.0 <= args.gamma < 1.0:
            ap.error(f"--gamma must be in [0, 1), got {args.gamma}")
        cfg = cfg.replace(dsg=cfg.dsg._replace(gamma=args.gamma))
    cfg = cfg.replace(paged_attn_kernel=args.paged_kernel,
                      dsg_ffn_apply=args.dsg_apply)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = api.init_model(cfg, generator=gen, device=device)
    dsg = api.init_dsg(model, cfg, generator=gen, device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    if args.workload == "batch":
        rng = np.random.default_rng(0)
        prompts = torch.from_numpy(rng.integers(
            0, cfg.vocab, (args.batch, args.prompt_len), dtype=np.int32))
        t0 = time.perf_counter()
        toks = generate(cfg, model, dsg, prompts.to(device), args.gen).cpu()
        dt = time.perf_counter() - t0
        print(f"[batch/dense on {name}] generated {tuple(toks.shape)} in "
              f"{dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s); first "
              f"row: {toks[0, :8].tolist()}")
        return {"tokens": toks}

    reqs = mixed_requests(cfg.vocab, args.requests, seed=args.seed,
                          temperature=args.temperature, top_p=args.top_p)
    if args.deadline_s is not None:
        for r in reqs:
            r.deadline_s = args.deadline_s
    ft = (FaultToleranceConfig(
        max_replica_restarts=args.max_replica_restarts,
        max_retries=args.max_retries, stall_timeout_s=args.stall_timeout_s)
        if args.fault_tolerance or faults else None)
    stats = run_workload(
        cfg, model, dsg, reqs, admission=args.admission, n_slots=args.slots,
        max_seq=args.max_seq, prompt_bucket=args.prompt_bucket,
        cache_backend=args.cache_backend, page_size=args.page_size,
        cache_tokens=args.cache_tokens, seed=args.seed,
        dsg_serving=(DSGServingConfig(args.dsg_refresh_interval)
                     if args.dsg_serving else None),
        decode_chunk=args.decode_chunk, prefix_sharing=args.prefix_sharing,
        replicas=args.replicas, route_policy=args.route_policy,
        exec_mode=args.exec_mode, fault_tolerance=ft, faults=faults)
    tag = f"{stats['admission']}/{stats['cache_backend']}"
    if stats["prefix_sharing"]:
        tag += "/shared"
    if stats["decode_chunk"] > 1:
        tag += f"/chunk{stats['decode_chunk']}"
    if "route_policy" in stats:
        tag += (f"/{stats['replicas']}x {stats['route_policy']}"
                f"/{stats['exec_mode']}")
    print(f"[{tag} on {name}] {stats['requests']} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s = "
          f"{stats['tok_per_s']:.1f} tok/s (decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s); latency p50 "
          f"{stats['p50_s']:.2f}s p95 {stats['p95_s']:.2f}s "
          f"({stats['steps']} decode steps, cache "
          f"{stats['cache_bytes'] / 1e6:.2f} MB resident, "
          f"{stats['truncated']} truncated)")
    if "makespan_s" in stats:
        kind = "measured" if stats["makespan_measured"] else "modeled"
        print(f"  {kind} parallel makespan {stats['makespan_s']:.2f}s = "
              f"{stats['parallel_tok_per_s']:.1f} tok/s across "
              f"{stats['replicas']} replicas ({stats['exec_mode']})")
    if "replica_health" in stats:
        print(f"  fault tolerance: {stats['completed_ok']} ok, "
              f"{stats['failed']} failed, {stats['timed_out']} timed out, "
              f"{stats['retries']} retries, {stats['faults_fired']} "
              f"fault(s) fired; replica health {stats['replica_health']}")
    if stats["prefix_sharing"]:
        print(f"  prefix sharing: {stats['shared_page_hits']} page hit(s), "
              f"{stats['cow_copies']} COW cop(ies), "
              f"{stats['prefill_cache_hits']} prefill replay(s), peak "
              f"{stats['peak_live_pages']} live pages")
    return stats


if __name__ == "__main__":
    main()
