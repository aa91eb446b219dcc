"""Logical -> physical sharding rules for the (pod, data, model) meshes, in
the terms of torch.distributed's DeviceMesh and DTensor (the port of
`repro.parallel.sharding`).

Axis conventions:
  batch axes  - ('pod', 'data') on the multi-pod mesh, ('data',) single-pod.
  model axis  - 'model': TP for attention heads / FFN columns / vocab,
                EP for MoE experts, SP for long-context KV sequence.

A spec is a `P`: one entry per tensor dim, each None (replicated), a mesh
axis name or a tuple of names (the dim split over those axes, the first
one major), as a `jax.sharding.PartitionSpec` holds them; trailing dims
the spec leaves out are replicated.  `placements` turns a spec into the
DTensor placements of a mesh, and `distribute` lays a tensor out by it.
All spec builders take an `Axes`, so the same rules serve either
production mesh and a 1 x 1 mesh, where every placement is trivial.
`distribute_model` lays a module's parameters out in place (the sharded
model then runs through DTensor), `distribute_tree` a dict of tensors
(DSG state, optimizer state), and `full_tree` gathers one back.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch


class P(tuple):
    """A partition spec: P('data', None) shards dim 0 over 'data'."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


class Axes(NamedTuple):
    batch: Union[Tuple[str, ...], None]   # e.g. ('pod', 'data') or ('data',)
    model: Optional[str]                  # 'model' or None


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axes_for_mesh(mesh) -> Axes:
    names = mesh.mesh_dim_names
    batch = tuple(n for n in ("pod", "data") if n in names) or None
    model = "model" if "model" in names else None
    return Axes(batch=batch, model=model)


def replica_mesh(n_replicas: int, device_type: str = "cuda"):
    """1-axis `replicas` mesh over the first `n_replicas` ranks of the
    default process group, for data-parallel serving replica groups.  The
    sharded replica executor does not take a mesh yet (ROADMAP.md queue 1
    item 9c); this builds one."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch import distributed as dist
    have = dist.get_world_size()
    if have < n_replicas:
        raise ValueError(f"replica_mesh needs {n_replicas} devices, "
                         f"have {have}")
    return DeviceMesh(device_type, torch.arange(n_replicas),
                      mesh_dim_names=("replicas",))


def replica_stack_spec() -> P:
    """Spec for state stacked along a leading replica axis: shard dim 0
    over `replicas`, replicate the rest."""
    return P("replicas")


def model_shards(mesh) -> int:
    return mesh_sizes(mesh).get("model", 1)


def data_shards(mesh) -> int:
    sizes = mesh_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n


# --- activation specs -------------------------------------------------------

def act_bsd(ax: Axes) -> P:
    """(batch, seq, d_model): batch over data axes, rest replicated."""
    return P(ax.batch, None, None)


def tokens_bs(ax: Axes) -> P:
    return P(ax.batch, None)


def kv_cache_spec(ax: Axes, seq_sharded: bool) -> P:
    """KV cache (layers, batch, seq, kv_heads, head_dim).  Decode at long
    context shards the sequence dim over 'model' (SP): kv_heads is usually
    smaller than the model axis, the sequence is not."""
    if seq_sharded:
        return P(None, ax.batch, ax.model, None, None)
    return P(None, ax.batch, None, ax.model, None)


# --- parameter specs ---------------------------------------------------------

def embed_spec(ax: Axes) -> P:
    return P(ax.model, None)            # vocab-sharded embedding


def head_proj_spec(ax: Axes) -> P:
    return P(None, ax.model, None)      # (d_model, heads, head_dim): TP by head


def o_proj_spec(ax: Axes) -> P:
    return P(ax.model, None, None)      # (heads, head_dim, d_model)


def ffn_col_spec(ax: Axes) -> P:
    return P(None, ax.model)            # (d_model, d_ff): column parallel


def ffn_row_spec(ax: Axes) -> P:
    return P(ax.model, None)            # (d_ff, d_model): row parallel


def expert_col_spec(ax: Axes) -> P:
    return P(ax.model, None, None)      # (E, d_model, d_ff): EP over experts


def expert_row_spec(ax: Axes) -> P:
    return P(ax.model, None, None)      # (E, d_ff, d_model)


def replicated() -> P:
    return P()


def dsg_fw_spec(ax: Axes) -> P:
    """f(W) buffer (k, F): F follows the FFN column sharding."""
    return P(None, ax.model)


def dsg_fw_expert_spec(ax: Axes) -> P:
    return P(ax.model, None, None)      # (E, k, F): follows experts


def with_layer_dim(spec: P) -> P:
    """Prefix a replicated layer-stack dim."""
    return P(None, *spec)


# --- DTensor layout ----------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: P) -> list:
    """The DTensor placements of `spec` on `mesh`: Shard(d) on each mesh
    dim that entry d names, Replicate() on the others.  A dim split over
    several axes names them in the mesh's order (the first one major, as
    DTensor nests shards over mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    dims = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in dims]
    for d, entry in enumerate(spec):
        names = _names(entry)
        idx = []
        for n in names:
            if n not in dims:
                raise ValueError(f"spec {spec} names axis {n!r}, which the "
                                 f"mesh {tuple(dims)} lacks")
            idx.append(dims.index(n))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dim {d} over {names}, not "
                             f"in the mesh's order {tuple(dims)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names axis {dims[i]!r} twice")
            out[i] = Shard(d)
    return out


def local_shape(shape, mesh, spec: P) -> tuple:
    """The shape of the shard that this rank holds of a tensor of `shape`
    laid out by `spec` (the first shards are the larger ones, as
    torch.chunk cuts)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shp, _ = compute_local_shape_and_global_offset(
        torch.Size(shape), mesh, placements(mesh, spec))
    return tuple(shp)


def distribute(t: torch.Tensor, mesh, spec: P):
    """`t` as a DTensor laid out on `mesh` by `spec`, its shards scattered
    from rank 0's copy.  A meta tensor (the dry run) holds no data, so its
    shard is made empty at the local shape, with no collective."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    pl = placements(mesh, spec)
    if t.is_meta:
        local = t.new_empty(local_shape(t.shape, mesh, spec))
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, mesh, pl)


def distribute_model(model, mesh, specs: dict):
    """Every parameter of `model` as a DTensor laid out on `mesh` by its
    spec ({name: P}, `models.specs.param_specs`), in place: each one is
    replaced by a Parameter of the DTensor, keeping requires_grad, its
    value scattered from rank 0's copy.  Returns `model`."""
    from torch import nn
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(
            distribute(p.detach(), mesh, specs[name]),
            requires_grad=p.requires_grad))
    return model


def distribute_tree(tree, mesh, specs):
    """A nested dict of tensors laid out by the same-shaped dict of specs;
    None leaves, and leaves that are not tensors (a step count), stay."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return distribute(tree, mesh, specs)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def full_tree(tree):
    """A (nested dict of) tensor(s) with every DTensor gathered whole: a
    collective over its mesh, which every rank of it takes part in."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    return tree.full_tensor() if is_dtensor(tree) else tree
