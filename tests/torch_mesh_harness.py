"""Set-up shared by the multi-rank parity tests (tests/test_torch_mesh_ops.py,
test_torch_sharded_model.py, test_torch_sharded_train.py).

Each test file starts its processes once: the reference's script in one
subprocess on a host mesh of N CPU devices (XLA_FLAGS forces the count,
JAX_PLATFORMS=cpu), and the port's script in n gloo ranks, one
subprocess each, meeting at a FileStore in the test's temporary
directory (`run`; `run_ranks` starts the ranks alone, for the card
twins in tests/test_torch_cuda.py).  The reference writes its inputs and
parameters (numpy) to `inputs.pkl` first, which the ranks wait for, then
its results to `ref.pkl`; rank 0 writes the port's results to
`torch.pkl`.
"""
from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def run(tmp, ref_src: str, n_devices: int, rank_src: str, n_ranks: int,
        timeout: float = 600.0):
    """Run the reference's script and the port's ranks side by side;
    returns (reference results, port results), or raises with the
    stderr of the first process that failed."""
    tmp = Path(tmp)
    ref_env = _env({"XLA_FLAGS": "--xla_force_host_platform_device_count="
                                 f"{n_devices}",
                    "JAX_PLATFORMS": "cpu"})
    procs = [("reference", subprocess.Popen(
        [sys.executable, "-c", ref_src, str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ref_env))]
    _finish(procs + _ranks(tmp, rank_src, n_ranks), timeout)
    with open(tmp / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "torch.pkl", "rb") as f:
        got = pickle.load(f)
    return ref, got


def run_ranks(tmp, rank_src: str, n_ranks: int, timeout: float = 600.0):
    """The port's ranks alone; returns rank 0's results (`torch.pkl`)."""
    tmp = Path(tmp)
    _finish(_ranks(tmp, rank_src, n_ranks), timeout)
    with open(tmp / "torch.pkl", "rb") as f:
        return pickle.load(f)


def _ranks(tmp, rank_src: str, n_ranks: int) -> list:
    procs = []
    for r in range(n_ranks):
        procs.append((f"rank {r}", subprocess.Popen(
            [sys.executable, "-c", rank_src, str(r), str(n_ranks), str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env())))
    return procs


def _finish(procs: list, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for _, p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (name, p), (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{name} failed ({p.returncode}):\n"
                                 f"{out[-2000:]}\n{err[-4000:]}")


def dump(obj, path) -> None:
    """pickle `obj` to `path` atomically (a reader never sees half)."""
    path = Path(path)
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump(obj, f)
    os.replace(path.with_suffix(".tmp"), path)


def wait_load(path, timeout: float = 180.0):
    """The pickle at `path`, once its writer has put it there."""
    path = Path(path)
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    with open(path, "rb") as f:
        return pickle.load(f)


def init_ranks(rank: int, n: int, tmp) -> None:
    """This process as rank `rank` of an n-rank gloo group on the CPU."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(Path(tmp) / "store"), n),
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=180))


def ulps(a, b) -> float:
    """|a - b| in f32 ulps of b."""
    b32 = np.float32(b)
    return float(abs(np.float32(a) - b32) / np.spacing(abs(b32)))


def leaf_err(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| over the leaf's largest |want| (ROADMAP §3's
    gradient rule)."""
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)))) / scale
