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


def stream(start_step: int = 0, **kw) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_at(step, **kw)
        step += 1
