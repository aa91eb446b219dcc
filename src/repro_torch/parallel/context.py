"""The parallel context (the port of `repro.parallel.context`).

A launcher (or the dry run) installs a mesh around the step; model code
asks the context how to place its activations (`constrain`, called by the
attention layers and the loss) and which FFN path to take.  Outside a
context, or on a 1-device mesh, every helper is a no-op.

Inside a context on a mesh, DTensor meets plain tensors (positions,
masks, constants the model makes on the fly) as replicated values
(`implicit_replication`), so the same model code runs on DTensor weights.
A backward that recomputes layers (remat) runs that code again: run it
under the same context.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import NamedTuple, Optional

from repro_torch.parallel.sharding import (P, Axes, axes_for_mesh,
                                           model_shards, placements)


class ParallelCtx(NamedTuple):
    mesh: object            # torch.distributed DeviceMesh
    ax: Axes
    n_model: int


_CTX: Optional[ParallelCtx] = None


def current() -> Optional[ParallelCtx]:
    return _CTX


@contextmanager
def use_mesh(mesh, batch_shardable: bool = True):
    """Install a parallel context.  batch_shardable=False drops the batch
    axes from activation constraints (e.g. long_500k with global_batch=1,
    which cannot divide the data axes: a model-parallel-only workload)."""
    global _CTX
    prev = _CTX
    replicate = nullcontext()
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        ax = axes_for_mesh(mesh)
        if not batch_shardable:
            ax = Axes(batch=None, model=ax.model)
        _CTX = ParallelCtx(mesh, ax, model_shards(mesh))
        replicate = implicit_replication()
    else:
        _CTX = None
    try:
        with replicate:
            yield _CTX
    finally:
        _CTX = prev


def constrain(x, *spec):
    """`x` laid out by P(*spec) on the active mesh: a DTensor is
    redistributed to the spec's placements; a plain tensor, a 1-device
    mesh or no context leave `x` as it is."""
    from torch.distributed.tensor import DTensor
    ctx = _CTX
    if ctx is None or ctx.mesh.size() == 1 or not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, placements(ctx.mesh, P(*spec)))


def batch_axes():
    ctx = _CTX
    return ctx.ax.batch if ctx else None


def resolve_attn_shard(mode: str, n_heads: int) -> str:
    """'auto' -> 'head' when heads divide the model axis, else 'seq'."""
    ctx = _CTX
    if ctx is None or ctx.n_model == 1:
        return "none"
    if mode != "auto":
        return mode
    return "head" if n_heads % ctx.n_model == 0 else "seq"


def divisible(n: int) -> bool:
    ctx = _CTX
    return ctx is not None and ctx.n_model > 1 and n % ctx.n_model == 0
