"""The reference's shard_map and its collectives over named mesh axes, on
DTensor's `local_map` and `torch.distributed._functional_collectives`.

`shard_map(body, mesh, in_specs, out_specs)` runs `body` on each rank's
local shards of its DTensor arguments (laid out, or redistributed, by
`in_specs`) and wraps its outputs by `out_specs`, as the reference's
`shard_map` does.  Inside the body, `psum`, `ppermute`, `axis_index` and
`axis_size` act on one named axis of that mesh, through the process group
of that mesh dim, whatever its backend.

Gradients follow shard_map's rules: `psum`'s backward is the identity (its
output is replicated over the axis, so each rank's cotangent is already
the whole one), and the gradient of an input that a spec replicates over
an axis is the sum of the ranks' local gradients over that axis (DTensor's
`Partial`, reduced when it is read).
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


def _grad_placements(pl: list) -> tuple:
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial() if isinstance(p, Replicate) else p for p in pl)


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs,
              ) -> Callable:
    """`body` over local shards, laid out by the specs (`sharding.P`).

    A DTensor argument is redistributed to its spec when it differs; a
    plain tensor is taken as the global value and laid out by its spec;
    an argument whose spec is None passes through as it is.  `out_specs`
    is one spec, or a tuple of them for a tuple of outputs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.parallel.sharding import P, distribute, placements

    in_pl = tuple(None if s is None else tuple(placements(mesh, s))
                  for s in in_specs)
    grad_pl = tuple(None if p is None else _grad_placements(p)
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
