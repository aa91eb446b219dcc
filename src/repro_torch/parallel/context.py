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

import torch

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


def replicated(t):
    """A plain tensor as the replicated DTensor on the active mesh, each
    rank's own copy taken as the value (no collective): a shard_map body
    that reads it by a sharded spec slices it locally.  A DTensor, or no
    context, leaves `t` as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    ctx = _CTX
    if ctx is None or isinstance(t, DTensor) or not torch.is_tensor(t):
        return t
    return DTensor.from_local(t, ctx.mesh, [Replicate()] * ctx.mesh.ndim,
                              run_check=False)


def model_sharded(t, dim: int) -> bool:
    """Whether `t` is a DTensor split over the active context's 'model'
    axis along `dim`."""
    from torch.distributed.tensor import DTensor, Shard
    ctx = _CTX
    if ctx is None or ctx.n_model == 1 or not isinstance(t, DTensor):
        return False
    i = ctx.mesh.mesh_dim_names.index(ctx.ax.model)
    p = t.placements[i]
    return isinstance(p, Shard) and p.dim == dim % t.ndim


def whole_groups(x, block: int, dim: int = -1):
    """`x` (..., G * block, ...), G groups along `dim`, laid out so that
    no rank holds part of a group: a DTensor whose `dim` is split into
    pieces that are not whole groups (deepseek-moe-16b's 22
    shared-expert groups, whisper-large-v3's 20 heads, over a model axis
    of 16) is gathered over that dim first, as the reference's
    partitioner reshards such a reshape.  Anything else is returned as
    it is."""
    if type(x) is torch.Tensor:          # unsharded: nothing to import
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    mesh, pl = x.device_mesh, x.placements
    split = [i for i, p in enumerate(pl)
             if isinstance(p, Shard) and p.dim == dim]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if (x.shape[dim] // block) % n == 0:
        return x
    return x.redistribute(mesh, [Replicate() if i in split else p
                                 for i, p in enumerate(pl)])


class _WholeGroupGrads(torch.autograd.Function):
    """The identity, whose backward lays the gradient out by
    `whole_groups`."""

    @staticmethod
    def forward(ctx, x, block):
        ctx.block = block
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return whole_groups(g, ctx.block), None


def whole_group_grads(x, block: int):
    """`x` (..., G * block), whose gradient `whole_groups` lays out before
    it reaches the group reshape that made `x` (the layer after it may
    hand back a gradient split mid-group)."""
    if type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return _WholeGroupGrads.apply(x, block)


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
