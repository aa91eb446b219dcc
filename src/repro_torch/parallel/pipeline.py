"""GPipe-style pipeline parallelism over a 'pipe' mesh axis (the port of
`repro.parallel.pipeline`: its shard_map and collective_permute become
`collectives.shard_map` and a `permute_tensor`).

Layers are grouped into n_stages contiguous stages; stage s lives on pipe
rank s (stage-stacked params sharded over the axis).  Microbatches enter
stage 0 one tick at a time and flow through the ring: at every tick each
rank applies its stage and sends the activation to rank + 1.  After
n_micro + n_stages - 1 ticks all microbatches have drained; the bubble
fraction is (n_stages - 1) / (n_micro + n_stages - 1).  Other mesh axes
(a 'data' axis beside 'pipe') each run their own copy of the pipeline.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.collectives import (axis_index, axis_size,
                                              ppermute, psum, shard_map)
from repro_torch.parallel.sharding import P


def pipeline_forward(stage_fn: Callable, stage_params: dict,
                     x_micro: torch.Tensor, mesh, axis: str = "pipe"):
    """Run microbatches through the pipeline.

    stage_fn(params_for_stage, x) -> y (x's shape); stage_params: {name:
    tensor} with a leading n_stages dim on every leaf, as DTensors sharded
    over `axis` by P(axis) (plain tensors are laid out so); x_micro
    (n_micro, micro_batch, ...), replicated.  Returns the last stage's
    outputs (n_micro, micro_batch, ...), replicated over the mesh."""
    n_stages = axis_size(axis, mesh)
    n_micro = x_micro.shape[0]
    n_ticks = n_micro + n_stages - 1
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    names = list(stage_params)

    def body(xs, *leaves):
        local = {n: t[0] for n, t in zip(names, leaves)}
        rank = axis_index(axis, mesh)
        state = torch.zeros_like(xs[0])
        outs = []
        for t in range(n_ticks):
            if rank == 0:
                cur = xs[t] if t < n_micro else torch.zeros_like(xs[0])
            else:
                cur = state
            y = stage_fn(local, cur)
            # the last stage's result for this tick (zeros elsewhere)
            outs.append(y if rank == n_stages - 1 else torch.zeros_like(y))
            state = ppermute(y, axis, perm, mesh)
        # only the last stage holds real outputs: the sum over the axis
        # gives them to every rank
        return psum(torch.stack(outs), axis, mesh)

    run = shard_map(body, mesh, (P(),) + (P(axis),) * len(names), P())
    outs = run(x_micro, *(stage_params[n] for n in names))
    # microbatch m leaves the last stage at tick m + n_stages - 1
    return outs[n_stages - 1:]


def sequential_reference(stage_fn: Callable, stage_params: dict,
                         x_micro: torch.Tensor) -> torch.Tensor:
    """Ground truth on full tensors: every stage in order on each
    microbatch."""
    n_stages = next(iter(stage_params.values())).shape[0]

    def run_one(x):
        for s in range(n_stages):
            x = stage_fn({n: t[s] for n, t in stage_params.items()}, x)
        return x

    return torch.stack([run_one(x) for x in x_micro])
