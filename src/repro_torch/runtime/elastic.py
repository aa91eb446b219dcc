"""Elastic scaling: re-plan the mesh after node loss or a fleet resize (the
port of `repro.runtime.elastic`'s plan).

Policy: the 'model' axis is load-bearing (weights are sharded across it,
so losing a model shard loses state), so elasticity acts on the data
axes: after losing nodes, shrink 'data' to the largest power of two that
the remaining devices hold with the model axis intact, and scale the
per-step token budget with it.  `launch.mesh.make_elastic_mesh` builds the
planned mesh and `remesh_state` moves the carried state onto it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ElasticPlan:
    n_devices: int
    data: int
    model: int
    dropped: int

    @property
    def scale(self) -> float:
        return self.data * self.model / (self.data * self.model + self.dropped)


def plan_after_loss(available_devices: int, model: int = 16,
                    prev_data: Optional[int] = None) -> ElasticPlan:
    """Largest (data, model) mesh with the model axis intact."""
    data = available_devices // model
    if data < 1:
        raise RuntimeError(
            f"cannot keep model={model} with {available_devices} devices")
    # prefer powers of two on the data axis (collective efficiency)
    d = 1
    while d * 2 <= data:
        d *= 2
    used = d * model
    return ElasticPlan(n_devices=used, data=d, model=model,
                       dropped=available_devices - used)


def remesh_state(state, old_specs, plan: ElasticPlan,
                 device_type: str = "cuda"):
    """Re-shard a state tree (nested dicts of DTensors) onto the degraded
    mesh that `plan` sets out.  Specs are reused: they name axes, which
    the new mesh keeps.  Every rank of the default group takes part (the
    mesh is built over its first ranks); the ranks left out of the new
    mesh hold empty shards.  Returns (mesh, new_state), every value equal
    to the old one."""
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.parallel.sharding import distribute
    mesh = make_elastic_mesh(plan.n_devices, plan.model,
                             device_type=device_type)

    def move(x, spec):
        if isinstance(x, dict):
            return {k: move(v, spec[k]) for k, v in x.items()}
        if x is None or not torch.is_tensor(x):
            return x
        x = x.detach()
        full = x.full_tensor() if hasattr(x, "full_tensor") else x
        return distribute(full, mesh, spec)

    return mesh, move(state, old_specs)
