"""Production mesh builders (the port of `repro.launch.mesh`).

Functions, not module constants: importing this module sets up no process
group.  Each builder lays a DeviceMesh over the first ranks of the
default group, which the caller sets up (`torch.distributed`'s
`init_process_group`, or `fake_world` for the dry run and the tests), on
the card unless `device_type` says otherwise.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
from torch import distributed as dist


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    need, have = math.prod(shape), dist.get_world_size()
    if have < need:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {need} "
                         f"ranks, the process group has {have}")
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    if multi_pod:
        return _mesh(device_type, (2, 16, 16), ("pod", "data", "model"))
    return _mesh(device_type, (16, 16), ("data", "model"))


def make_local_mesh(device_type: str = "cuda"):
    """1 x 1 (data, model) mesh on rank 0."""
    return _mesh(device_type, (1, 1), ("data", "model"))


def make_elastic_mesh(n_devices: int, model: int = 16,
                      device_type: str = "cuda"):
    """Degraded-fleet mesh: keep the model axis intact, shrink data, over
    the first data x model ranks (runtime/elastic.py plans it)."""
    data = n_devices // model
    if data < 1:
        raise ValueError(f"need >= {model} devices, have {n_devices}")
    return _mesh(device_type, (data, model), ("data", "model"))


@contextmanager
def fake_world(n: int):
    """A process group of `n` ranks on torch's "fake" backend, this
    process rank 0: its collectives move nothing, so a mesh of the
    production size can be laid out in one process with no card (the dry
    run, the tests).  Refuses to run inside a real group; destroys the
    group on exit."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already set up")
    # importing fake_pg registers the "fake" backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
