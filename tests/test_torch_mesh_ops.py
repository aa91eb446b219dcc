"""The shard_map bodies and their collectives on eight gloo CPU ranks,
held against the reference's on an eight-device host mesh:

  * `parallel.pipeline.pipeline_forward` with 4 stages (a (data 2, pipe
    4) mesh: each data row runs its own copy) of tanh(h W + b), 8
    microbatches of 2 x 16, against the reference's run and against
    `sequential_reference`;
  * `optim.hierarchical.hierarchical_grad_reduce` on a (pod 2, data 4)
    mesh, one (64,) gradient a rank, compress off, and compress on for
    three steps of error feedback (the decoded mean and every rank's
    buffer at each step);
  * `optim.compress.compressed_psum` over 'data' of the same mesh, three
    steps of error feedback.

Inputs from a numpy seed; tolerance 1e-6 of each result's largest entry
(the sums over ranks may add in another order).  The ranks and the
reference start once, in a module-scoped fixture.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

TOL = 1e-6
N_STAGES, N_MICRO, BM, D = 4, 8, 2, 16
N, DIM, STEPS = 8, 64, 3

COMMON = f"""
N_STAGES, N_MICRO, BM, D = {N_STAGES}, {N_MICRO}, {BM}, {D}
N, DIM, STEPS = {N}, {DIM}, {STEPS}
"""

REF = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.optim.compress import compressed_psum
from repro.optim.hierarchical import hierarchical_grad_reduce
from repro.parallel.pipeline import pipeline_forward, sequential_reference
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
rng = np.random.default_rng(0)
inputs = {"w": (rng.standard_normal((N_STAGES, D, D)) * 0.2)
          .astype(np.float32),
          "b": (rng.standard_normal((N_STAGES, D)) * 0.1).astype(np.float32),
          "x": rng.standard_normal((N_MICRO, BM, D)).astype(np.float32),
          "g": rng.standard_normal((N, DIM)).astype(np.float32)}
dump(inputs, tmp / "inputs.pkl")


def stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


params = {"w": jnp.asarray(inputs["w"]), "b": jnp.asarray(inputs["b"])}
x = jnp.asarray(inputs["x"])
out = {"pipe": np.asarray(pipeline_forward(
           stage, params, x, make_mesh((2, 4), ("data", "pipe")))),
       "pipe_seq": np.asarray(sequential_reference(stage, params, x)),
       "g": inputs["g"]}

mesh = make_mesh((2, 4), ("pod", "data"))
spec = P(("pod", "data"))
g = jnp.asarray(inputs["g"])


def run(fn):
    f = jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                          out_specs=(spec, spec)))
    err, steps = jnp.zeros((N, DIM)), []
    for _ in range(STEPS):
        dec, err = f(g, err)
        steps.append((np.asarray(dec), np.asarray(err)))
    return steps


out["hier_off"] = run(lambda g, e: hierarchical_grad_reduce(
    g, e, compress=False))
out["hier_on"] = run(lambda g, e: hierarchical_grad_reduce(g, e))
out["cpsum"] = run(lambda g, e: compressed_psum(g, "data", e))
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks, wait_load

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.optim.compress import compressed_psum
from repro_torch.optim.hierarchical import hierarchical_grad_reduce
from repro_torch.parallel.collectives import shard_map
from repro_torch.parallel.pipeline import pipeline_forward, sequential_reference
from repro_torch.parallel.sharding import P
try:
    inputs = wait_load(tmp / "inputs.pkl")

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    params = {"w": torch.from_numpy(inputs["w"]),
              "b": torch.from_numpy(inputs["b"])}
    x = torch.from_numpy(inputs["x"])
    pmesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                       mesh_dim_names=("data", "pipe"))
    out = {"pipe": pipeline_forward(stage, params, x, pmesh)
           .full_tensor().numpy(),
           "pipe_seq": sequential_reference(stage, params, x).numpy()}

    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                      mesh_dim_names=("pod", "data"))
    spec = P(("pod", "data"))
    g = torch.from_numpy(inputs["g"])

    def run(fn):
        f = shard_map(fn, mesh, (spec, spec), (spec, spec))
        err, steps = torch.zeros((N, DIM)), []
        for _ in range(STEPS):
            dec, err = f(g, err)
            steps.append((dec.full_tensor().numpy(),
                          err.full_tensor().numpy()))
        return steps

    out["hier_off"] = run(lambda g, e: hierarchical_grad_reduce(
        g, e, compress=False, mesh=mesh))
    out["hier_on"] = run(lambda g, e: hierarchical_grad_reduce(
        g, e, mesh=mesh))
    out["cpsum"] = run(lambda g, e: compressed_psum(g, "data", e, mesh=mesh))
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mh.run(tmp_path_factory.mktemp("mesh_ops"), REF, 8, RANKS, 8)


@pytest.mark.parametrize("against", ["pipe", "pipe_seq"])
def test_pipeline_forward_matches_the_reference(runs, against):
    ref, got = runs
    assert got["pipe"].shape == (N_MICRO, BM, D)
    assert mh.leaf_err(got["pipe"], ref[against]) <= TOL


def test_port_sequential_reference_matches(runs):
    ref, got = runs
    assert mh.leaf_err(got["pipe_seq"], ref["pipe_seq"]) <= TOL


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("kind", ["hier_off", "hier_on", "cpsum"])
def test_reductions_match_the_reference(runs, kind, step):
    ref, got = runs
    (g_dec, g_err), (r_dec, r_err) = got[kind][step], ref[kind][step]
    assert mh.leaf_err(g_dec, r_dec) <= TOL
    assert np.abs(g_err - r_err).max() <= TOL * max(1.0, np.abs(r_err).max())


def test_uncompressed_reduce_is_the_fleet_mean(runs):
    ref, got = runs
    g = np.asarray(got["hier_off"][0][0], np.float64)
    assert mh.leaf_err(g[0], ref["g"].astype(np.float64).mean(0)) <= TOL
    assert np.allclose(g, g[:1])            # every rank holds the mean


def test_error_feedback_carries_the_residual(runs):
    # the ternary codes lose something, and the buffers carry it on
    _, got = runs
    steps = got["hier_on"]
    assert np.abs(steps[0][1]).max() > 0                 # lossy codes
    assert not np.array_equal(steps[1][1], steps[0][1])  # buffers move on
