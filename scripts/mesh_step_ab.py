#!/usr/bin/env python3
"""The sharded training step of `chip_smoke.py --mesh-cards` (a), timed
for two checkouts in turn, so that a change and its parent compare on
the same cards within one call.

    python3 scripts/mesh_step_ab.py PARENT_DIR CHANGE_DIR [--rounds 2]

Each checkout's own `chip_smoke.py --mesh-rank tp_train` runs as two NCCL
ranks, one card each (cards 0 and 1): internlm2-1.8b on (data 1, model
2), 4 AdamW steps of a batch of 8 x 256, in DSG mask mode and in
gather_shared.  The order is A B B A for each round (A the first
directory), so that a drift of the shared host falls on both alike.
Prints, for each run, each rank's step times (ms; the first, a warm-up,
is left out of the p50), then, as its last line, one JSON object with
every run's p50s.  Needs two CUDA devices; reads no network.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SPEC = {"device": "cuda", "backend": "nccl", "card_per_rank": True,
        "train_batch": [8, 256], "moe_tokens": [4, 128],
        "pipe_micro": [4, 2, 256]}
TIMEOUT_S = 600


def run_tree(tree: Path) -> dict:
    """Both ranks of `tree`'s tp_train part; each rank's result."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        (Path(tmp) / "tp_train.json").write_text(json.dumps(SPEC))
        procs = [subprocess.Popen(
            [sys.executable, str(tree / "chip_smoke.py"), "--mesh-rank",
             "tp_train", str(r), "2", tmp], cwd=tree,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise SystemExit(f"{tree}: rank {r} exited {p.returncode}:"
                                 f"\n{err[-3000:]}")
        return [torch.load(Path(tmp) / f"tp_train_{r}.pt",
                           weights_only=False) for r in range(2)]


def p50(ms: list) -> float:
    timed = sorted(ms[1:])
    return timed[len(timed) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < 2:
        print("mesh_step_ab: needs two CUDA devices", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    runs = []
    for _ in range(args.rounds):
        for name, tree in (("a", args.a), ("b", args.b), ("b", args.b),
                           ("a", args.a)):
            t0 = time.perf_counter()
            ranks = run_tree(tree.resolve())
            row = {"tree": name, "s": round(time.perf_counter() - t0, 1)}
            for mode in ("mask", "gather"):
                row[mode] = [p50(r[mode]["ms"]) for r in ranks]
                print(f"{name} {mode}: step ms {[r[mode]['ms'] for r in ranks]}"
                      f" p50 {row[mode]}", flush=True)
            runs.append(row)
    summary = {"card": card.strip(), "runs": runs}
    for name in ("a", "b"):
        for mode in ("mask", "gather"):
            every = sorted(x for r in runs if r["tree"] == name
                           for x in r[mode])
            summary[f"{name}_{mode}_p50s"] = every
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
