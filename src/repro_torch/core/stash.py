"""Activation-stash accounting: the paper's memory model (Fig. 6).

Training stashes every layer's activations for backward; the paper
compresses the stash to its kept values plus a group bitmask.  These
helpers give the analytic dense and DSG sizes.  The port, like the
reference in mask mode, stores dense activations, so these are a model of
what a compacted stash would hold, not what either package allocates.
"""
from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np

from repro_torch.core.masks import mask_overhead_bytes


def dense_stash_bytes(shape: Tuple[int, ...], dtype_bytes: int = 2) -> int:
    return int(np.prod(shape)) * dtype_bytes


def dsg_stash_bytes(shape: Tuple[int, ...], gamma: float, block: int,
                    dtype_bytes: int = 2) -> int:
    """Compressed stash: kept values plus the group bitmask.  `shape` is
    the dense activation shape with the neuron dim last."""
    dense = dense_stash_bytes(shape, dtype_bytes)
    return int(dense * (1.0 - gamma)) + mask_overhead_bytes(shape, block)


def training_footprint(layer_shapes: Iterable[Tuple[int, ...]], gamma: float,
                       block: int, param_bytes: int,
                       dtype_bytes: int = 2) -> dict:
    """Params plus every stashed activation, dense and DSG-compressed, and
    their ratios (the paper's Fig. 6(a) quantities)."""
    shapes = list(layer_shapes)
    dense_act = sum(dense_stash_bytes(s, dtype_bytes) for s in shapes)
    dsg_act = sum(dsg_stash_bytes(s, gamma, block, dtype_bytes)
                  for s in shapes)
    dense_total = param_bytes + dense_act
    dsg_total = param_bytes + dsg_act
    return {
        "dense_total": dense_total,
        "dsg_total": dsg_total,
        "dense_activations": dense_act,
        "dsg_activations": dsg_act,
        "ratio_total": dense_total / max(dsg_total, 1),
        "ratio_activations": dense_act / max(dsg_act, 1),
    }


def inference_footprint(layer_shapes: Iterable[Tuple[int, ...]],
                        gamma: float, block: int, param_bytes: int,
                        dtype_bytes: int = 2) -> dict:
    """Params plus the single largest layer activation (the paper's
    §3.3)."""
    shapes = list(layer_shapes)
    dense_act = max(dense_stash_bytes(s, dtype_bytes) for s in shapes)
    dsg_act = max(dsg_stash_bytes(s, gamma, block, dtype_bytes)
                  for s in shapes)
    return {
        "dense_total": param_bytes + dense_act,
        "dsg_total": param_bytes + dsg_act,
        "ratio_total": (param_bytes + dense_act)
        / max(param_bytes + dsg_act, 1),
    }
