"""Serve through the port: a fixed batch (`generate`) or mixed-length
synthetic traffic through the ServingEngine, as `repro.launch.serve` does.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --workload mixed --requests 4 --cache-backend paged --dsg-serving \\
        --decode-chunk 8
    PYTHONPATH=src python -m repro_torch.launch.serve --workload mixed \\
        --requests 8 --max-seq 512 --cache-backend paged --dsg-serving
                                             # full width, on the GPU

The defaults are the reference's: `--workload batch` (one batch of
`--batch` prompts of `--prompt-len` tokens, `--gen` greedy tokens each) and
`--cache-backend dense` for `--workload mixed`.  The model is initialised
from a seeded torch.Generator on --device (cuda by default).  With no GPU
and no `--device cpu` the command exits non-zero; it never falls back to
the CPU.  Flags of the reference launcher that this port does not cover
yet (replicas, prefix sharing, chaos, sampling, wave admission) are
rejected: ROADMAP.md lists them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import api
from repro_torch.serving.dsg_runtime import DSGServingConfig
from repro_torch.serving.workload import mixed_requests, run_workload


def generate(cfg, model, dsg, prompts: torch.Tensor,
             gen_tokens: int) -> torch.Tensor:
    """prompts (B, P) int -> greedy tokens (B, gen_tokens): one batched
    prompt prefill into a dense cache of P + gen_tokens positions, then
    token-by-token decode with the same DSG masks as the prefill (the
    reference's `generate` at temperature 0; sampling is not ported)."""
    b, p_len = prompts.shape
    cache = api.make_cache(cfg, b, p_len + gen_tokens,
                           device=prompts.device)
    logits, cache = api.prefill(model, dsg, cfg, {"tokens": prompts.long()},
                                cache)
    out = []
    for i in range(gen_tokens):
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        logits, cache = api.decode_step(model, dsg, cfg, tok[:, None], cache,
                                        p_len + i)
    return torch.stack(out, dim=1)


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
    ap.add_argument("--cache-backend", choices=("dense", "paged"),
                    default="dense")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--cache-tokens", type=int, default=None)
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
    ap.add_argument("--paged-kernel", choices=("auto", "kernel"),
                    default="auto",
                    help="paged decode: auto (the CUDA kernel on CUDA, its "
                         "plain version on CPU) or kernel (CUDA only)")
    ap.add_argument("--dsg-apply", choices=("auto", "kernel"),
                    default="auto",
                    help="group-CSR FFN: auto (the CUDA kernel on CUDA, its "
                         "plain version on CPU) or kernel (CUDA only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


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
    if args.no_dsg:
        if args.dsg_serving:
            ap.error("--dsg-serving needs DSG enabled (drop --no-dsg)")
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    if args.dsg_serving and args.workload != "mixed":
        ap.error("--dsg-serving is a mixed-workload (serving engine) "
                 "feature; add --workload mixed")
    if (args.dsg_serving and args.decode_chunk > 1
            and args.dsg_refresh_interval % args.decode_chunk):
        ap.error(f"--decode-chunk {args.decode_chunk} must divide "
                 f"--dsg-refresh-interval {args.dsg_refresh_interval}")
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

    reqs = mixed_requests(cfg.vocab, args.requests, seed=args.seed)
    stats = run_workload(
        cfg, model, dsg, reqs, n_slots=args.slots, max_seq=args.max_seq,
        prompt_bucket=args.prompt_bucket, cache_backend=args.cache_backend,
        page_size=args.page_size, cache_tokens=args.cache_tokens,
        dsg_serving=(DSGServingConfig(args.dsg_refresh_interval)
                     if args.dsg_serving else None),
        decode_chunk=args.decode_chunk)
    tag = f"overlap/{stats['cache_backend']}"
    if stats["decode_chunk"] > 1:
        tag += f"/chunk{stats['decode_chunk']}"
    print(f"[{tag} on {name}] {stats['requests']} requests, "
          f"{stats['tokens']} tokens in {stats['wall_s']:.2f}s = "
          f"{stats['tok_per_s']:.1f} tok/s (decode "
          f"{stats['decode_tok_per_s']:.1f} tok/s); latency p50 "
          f"{stats['p50_s']:.2f}s p95 {stats['p95_s']:.2f}s "
          f"({stats['steps']} decode steps, cache "
          f"{stats['cache_bytes'] / 1e6:.2f} MB resident, "
          f"{stats['truncated']} truncated)")
    return stats


if __name__ == "__main__":
    main()
