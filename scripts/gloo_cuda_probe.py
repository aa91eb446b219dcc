#!/usr/bin/env python3
"""Which collectives a gloo process group runs on CUDA tensors, with two
ranks on one card (NCCL refuses two ranks on one device, so that is how
`chip_smoke.py` phase 27 and the card twins of the mesh tests run).

    python3 scripts/gloo_cuda_probe.py

Each collective runs in a fresh pair of rank processes (this script with
`--rank`), so one that kills its process does not hide the others; a
rank that dies or hangs past the timeout is reported as such.  Prints the
card, torch's version and one line per collective: `ok`, the exception,
or how the process ended.  Needs a CUDA device; reads no network.
"""
from __future__ import annotations

import datetime
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TIMEOUT_S = 60

PROBES = (
    "all_reduce", "broadcast", "barrier", "scatter", "all_gather",
    "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
    "send_recv", "funcol_all_reduce", "funcol_reduce_scatter",
    "funcol_permute_tensor", "funcol_all_gather",
    "dtensor_partial_to_replicate", "dtensor_partial_to_shard",
    "dtensor_shard_to_replicate")


def rank_main(name: str, rank: int, store: str) -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    x = torch.full((8,), float(rank + 1), device=dev)
    w = torch.arange(64.0, device=dev).reshape(8, 8)
    mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("model",))

    def send_recv():
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)

    def dt(placement):
        return DTensor.from_local(w, mesh, [placement], run_check=False)

    run = {
        "all_reduce": lambda: dist.all_reduce(x),
        "broadcast": lambda: dist.broadcast(x, 0),
        "barrier": lambda: dist.barrier(),
        "scatter": lambda: dist.scatter(
            torch.empty(8, device=dev),
            [x.clone(), x.clone()] if rank == 0 else None, src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty(8, device=dev) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device=dev), x),
        "send_recv": send_recv,
        "funcol_all_reduce": lambda: funcol.wait_tensor(
            funcol.all_reduce(x, "sum", mesh)),
        "funcol_reduce_scatter": lambda: funcol.wait_tensor(
            funcol.reduce_scatter_tensor(x, "sum", 0, mesh)),
        "funcol_permute_tensor": lambda: funcol.wait_tensor(
            funcol.permute_tensor(x, [1, 0], mesh)),
        "funcol_all_gather": lambda: funcol.wait_tensor(
            funcol.all_gather_tensor(x, 0, mesh)),
        "dtensor_partial_to_replicate": lambda: dt(Partial()).redistribute(
            mesh, [Replicate()]).to_local(),
        "dtensor_partial_to_shard": lambda: dt(Partial()).redistribute(
            mesh, [Shard(0)]).to_local(),
        "dtensor_shard_to_replicate": lambda: dt(Shard(0)).redistribute(
            mesh, [Replicate()]).to_local(),
    }[name]
    try:
        run()
        torch.cuda.synchronize()
        print("ok", flush=True)
    except Exception as e:       # the probe's result, printed
        print(f"{type(e).__name__}: {str(e)[:160]}", flush=True)
    dist.destroy_process_group()
    return 0


def probe(name: str) -> str:
    store = str(Path(tempfile.mkdtemp()) / "store")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", name, str(r), store],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.monotonic() + TIMEOUT_S
    results = []
    for p in procs:
        try:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            lines = out.strip().splitlines()
            results.append(lines[-1] if lines and p.returncode == 0
                           else f"process ended with {p.returncode}")
        except subprocess.TimeoutExpired:
            results.append(f"no answer in {TIMEOUT_S} s")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return results[0] if results[0] == results[1] else " / ".join(results)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        return rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is available",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    for name in PROBES:
        print(f"{name}: {probe(name)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
