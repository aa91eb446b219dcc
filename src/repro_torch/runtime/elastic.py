"""Elastic scaling: re-plan the mesh after node loss or a fleet resize (the
port of `repro.runtime.elastic`'s plan).

Policy: the 'model' axis is load-bearing (weights are sharded across it,
so losing a model shard loses state), so elasticity acts on the data
axes: after losing nodes, shrink 'data' to the largest power of two that
the remaining devices hold with the model axis intact, and scale the
per-step token budget with it.  `launch.mesh.make_elastic_mesh` builds the
planned mesh.  Moving carried state onto it (`remesh_state`) comes with
the model running sharded, ROADMAP.md queue 1 item 9b.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
