"""Deterministic, shard-aware synthetic token stream (numpy).

batch(step, host) is a pure function of (seed, step, host_index): every
host computes only its slice, and a restart replays the same stream.  The
tokens mix a per-batch periodic walk over the vocabulary (long-range
repetition a model can learn) with uniform noise tokens at a fixed rate.
The draws are the reference's, from the same
`np.random.default_rng((seed, step, host_index))`, so the tokens are equal
bit for bit.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


def _gen_tokens(rng: np.random.Generator, batch: int, seq: int,
                vocab: int, noise: float = 0.1) -> np.ndarray:
    period = rng.integers(8, 64)
    base = rng.integers(0, vocab, size=(batch, period))
    reps = seq // period + 2
    toks = np.tile(base, (1, reps))[:, :seq + 1]
    drift = rng.integers(0, vocab, size=(batch, seq + 1))
    mask = rng.random((batch, seq + 1)) < noise
    toks = np.where(mask, drift, toks)
    return toks.astype(np.int32)


def batch_at(step: int, *, global_batch: int, seq_len: int, vocab: int,
             host_index: int = 0, host_count: int = 1, seed: int = 17,
             extras: Optional[dict] = None) -> dict:
    """This host's slice of the batch for `step`: int32 'tokens' and
    'labels' (the tokens shifted by one), (global_batch / host_count,
    seq_len), as CPU tensors; `extras` {name: shape} adds f32 normal
    arrays per row."""
    if global_batch % host_count:
        raise ValueError(f"global_batch {global_batch} is not a multiple "
                         f"of host_count {host_count}")
    local = global_batch // host_count
    rng = np.random.default_rng((seed, step, host_index))
    toks = _gen_tokens(rng, local, seq_len, vocab)
    out = {"tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
           "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:]))}
    for name, shape in (extras or {}).items():
        out[name] = torch.from_numpy(
            rng.standard_normal((local,) + tuple(shape)).astype(np.float32))
    return out


def make_global_batch(step: int, mesh, batch_spec: dict, **kw) -> dict:
    """The batch for `step` as DTensors on `mesh`, each laid out by its
    spec in `batch_spec` (`models.specs.input_specs`), built the
    multi-host way: each rank makes only its own rows, as host i of n of
    `batch_at(step, host_index=i, host_count=n, **kw)`, where i is its
    coordinate over the axes that split the rows and n their product, and
    wraps them with `DTensor.from_local`.  The global batch is those hosts'
    slices in order: `batch_at`'s whole batch when nothing splits the rows
    (the reference's make_global_batch takes the host's batch as the
    global one, which is that case)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel.sharding import placements

    specs = set(map(tuple, batch_spec.values()))
    if len(specs) != 1 or any(e is not None for e in next(iter(specs))[1:]):
        raise ValueError(f"make_global_batch splits every input by its "
                         f"rows alone, got {batch_spec}")
    rows = next(iter(specs))[0]
    axes = () if rows is None else (rows if isinstance(rows, tuple)
                                    else (rows,))
    names = list(mesh.mesh_dim_names)
    host_index, host_count = 0, 1
    for a in axes:       # row-major over the axes, the first one major
        n = mesh.size(names.index(a))
        host_index = host_index * n + mesh.get_local_rank(a)
        host_count *= n
    local = batch_at(step, host_index=host_index, host_count=host_count,
                     **kw)
    device = mesh.device_type
    out = {}
    for name, t in local.items():
        shape = (t.shape[0] * host_count,) + tuple(t.shape[1:])
        out[name] = DTensor.from_local(
            t.to(device), mesh, placements(mesh, batch_spec[name]),
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())
    return out


def stream(start_step: int = 0, **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(step, **kw)
        step += 1
