"""The reference's shard_map and its collectives over named mesh axes, on
DTensor's `local_map` and `torch.distributed._functional_collectives`.

`shard_map(body, mesh, in_specs, out_specs)` runs `body` on each rank's
local shards of its DTensor arguments (laid out, or redistributed, by
`in_specs`) and wraps its outputs by `out_specs`, as the reference's
`shard_map` does.  Inside the body, `psum`, `pmax`, `all_gather`,
`ppermute`, `axis_index` and `axis_size` act on one named axis of that
mesh, through the process group of that mesh dim, whatever its backend.

Gradients follow shard_map's rules: `psum`'s backward is the identity (its
output is replicated over the axis, so each rank's cotangent is already
the whole one), `all_gather`'s is this rank's slice of the cotangent (the
same rule), `pmax` has none (its callers use the max as a shift), and the
gradient of an input that a spec replicates over an axis is the sum of
the ranks' local gradients over that axis (DTensor's `Partial`, reduced
when it is read).
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _mesh(mesh=None):
    if mesh is not None:
        return mesh
    from repro_torch.parallel import context as pctx
    ctx = pctx.current()
    if ctx is None:
        raise RuntimeError("a collective outside a parallel context needs "
                           "its mesh")
    return ctx.mesh


def axis_size(axis: str, mesh=None) -> int:
    mesh = _mesh(mesh)
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along `axis` (lax.axis_index)."""
    return _mesh(mesh).get_local_rank(axis)


class _PSum(torch.autograd.Function):
    """all_reduce(sum) forward, identity backward (shard_map's psum)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Sum of `x` over the ranks of `axis` (lax.psum)."""
    mesh = _mesh(mesh)
    if axis_size(axis, mesh) == 1:
        return x
    return _PSum.apply(x.contiguous(), mesh[axis])


def pmax(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """Elementwise max of `x` over the ranks of `axis` (lax.pmax), with no
    gradient: an all_reduce(max) of the detached value."""
    from torch.distributed import _functional_collectives as funcol
    mesh = _mesh(mesh)
    x = x.detach()
    if axis_size(axis, mesh) == 1:
        return x
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), "max",
                                                mesh[axis]))


class _AllGather(torch.autograd.Function):
    """all_gather along `dim` forward; the backward keeps this rank's
    slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group, index, n):
        from torch.distributed import _functional_collectives as funcol
        ctx.dim, ctx.index, ctx.n = dim, index, n
        out = funcol.all_gather_tensor(x.contiguous(), dim, group)
        return funcol.wait_tensor(out)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index], None, None, None, None


def all_gather(x: torch.Tensor, axis: str, dim: int = 0, mesh=None
               ) -> torch.Tensor:
    """The ranks' `x` over `axis` joined along `dim` in rank order
    (lax.all_gather, tiled); every rank's piece has the same shape."""
    mesh = _mesh(mesh)
    n = axis_size(axis, mesh)
    if n == 1:
        return x
    return _AllGather.apply(x, dim % x.ndim, mesh[axis],
                            axis_index(axis, mesh), n)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence, mesh=None
             ) -> torch.Tensor:
    """lax.ppermute: the rank at coordinate src sends `x` to dst for each
    (src, dst) pair of `perm`, a permutation of the axis."""
    from torch.distributed import _functional_collectives as funcol
    mesh = _mesh(mesh)
    n = axis_size(axis, mesh)
    dst = dict(perm)
    if sorted(dst) != list(range(n)) or sorted(dst.values()) != list(range(n)):
        raise ValueError(f"ppermute needs a permutation of {n} ranks, got "
                         f"{perm}")
    # permute_tensor splits dim 0 by element counts: send the flat tensor
    out = funcol.wait_tensor(funcol.permute_tensor(
        x.reshape(-1).contiguous(), [dst[i] for i in range(n)], mesh[axis]))
    return out.reshape(x.shape)


class _RowMajorGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    shard_map body's input gradients become DTensor shards, which DTensor
    views by the row-major layout it assumes (an attention core's dq comes
    back transposed)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _row_major_grads(body: Callable) -> Callable:
    def run(*args):
        return body(*(_RowMajorGrad.apply(a)
                      if torch.is_tensor(a) and a.requires_grad else a
                      for a in args))
    return run


def _grad_placements(pl: list, same: tuple = ()) -> tuple:
    """An input's gradient placements: Partial on each mesh dim its
    placements replicate it over, but those in `same`."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if isinstance(p, Replicate) and i not in same
                 else p for i, p in enumerate(pl))


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs,
              redundant: Sequence = ()) -> Callable:
    """`body` over local shards, laid out by the specs (`sharding.P`).

    A DTensor argument is redistributed to its spec when it differs; a
    plain tensor is taken as the global value and laid out by its spec;
    an argument whose spec is None passes through as it is.  `out_specs`
    is one spec, or a tuple of them for a tuple of outputs.  `redundant`
    names axes over which the body computes the same outputs on every
    rank (no collective makes them): the gradient of an input
    replicated over such an axis is each rank's own, not a partial
    sum."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.parallel.sharding import P, distribute, placements

    in_pl = tuple(None if s is None else tuple(placements(mesh, s))
                  for s in in_specs)
    same = tuple(mesh.mesh_dim_names.index(a) for a in redundant)
    grad_pl = tuple(None if p is None else _grad_placements(p, same)
                    for p in in_pl)
    multi = not isinstance(out_specs, P)
    # one output's placements are a list: local_map reads a tuple as one
    # entry per output
    out_pl = (tuple(placements(mesh, s) for s in out_specs) if multi
              else placements(mesh, out_specs))
    fn = local_map(_row_major_grads(body), out_placements=out_pl, in_placements=in_pl,
                   in_grad_placements=grad_pl, device_mesh=mesh,
                   redistribute_inputs=True)

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"shard_map body takes {len(in_specs)} "
                            f"arguments, got {len(args)}")
        args = tuple(distribute(a, mesh, s)
                     if (s is not None and torch.is_tensor(a)
                         and not isinstance(a, DTensor)) else a
                     for a, s in zip(args, in_specs))
        return fn(*args)

    return run


BUCKET_BYTES = 128 << 20


def reduce_partials(tensors: dict, targets: dict) -> dict:
    """Each DTensor of `tensors` laid out by `targets[name]` (its
    placements).  The partial sums over a mesh dim whose target is not
    partial are reduced in buckets: for each such dim, one all_reduce of
    the tensors of a dtype that need it, flattened and joined up to
    BUCKET_BYTES (as DDP's buckets are), so a step's gradients take a
    few collectives, not one or two a parameter.  What differs after
    that is redistributed one tensor at a time.  `tensors` is updated in
    place, each entry as its bucket is reduced, so no tensor is held
    twice beyond one bucket; it is returned."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    out = tensors
    names = [n for n, t in out.items() if isinstance(t, DTensor)]

    def reduced(n, dim, local):
        t = out[n]
        pl = list(t.placements)
        pl[dim] = Replicate()
        return DTensor.from_local(local.view(t.to_local().shape),
                                  t.device_mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())

    for dim in range(out[names[0]].device_mesh.ndim if names else 0):
        mesh = out[names[0]].device_mesh
        todo = [n for n in names if out[n].placements[dim].is_partial()
                and not targets[n][dim].is_partial()]
        if mesh.size(dim) == 1:
            for n in todo:
                out[n] = reduced(n, dim, out[n].to_local())
            continue
        buckets, size = [], BUCKET_BYTES
        for n in todo:
            nbytes = out[n].to_local().numel() * out[n].element_size()
            if (not buckets or size + nbytes > BUCKET_BYTES
                    or out[buckets[-1][0]].dtype != out[n].dtype):
                buckets.append([])
                size = 0
            buckets[-1].append(n)
            size += nbytes
        for group in buckets:
            flat = funcol.wait_tensor(funcol.all_reduce(
                torch.cat([out[n].to_local().reshape(-1) for n in group]),
                "sum", (mesh, dim)))
            at = 0
            for n in group:
                k = out[n].to_local().numel()
                out[n] = reduced(n, dim, flat[at:at + k])
                at += k
    for n, t in out.items():
        if isinstance(t, DTensor) and tuple(t.placements) != \
                tuple(targets[n]):
            out[n] = t.redistribute(t.device_mesh, targets[n])
    return out
