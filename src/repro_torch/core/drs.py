"""Dimension-reduction search (DRS): score neuron groups from virtual
pre-activations f(X) @ f(W) and keep the top (1 - gamma) fraction.

Selection is per neuron group of `block` consecutive outputs; a group's
score is sum(relu(v)) over the group.  Threshold modes:
  * "topk"   — per-row k-th largest score, every group at or above it kept.
  * "shared" — the paper's inter-sample sharing: row 0 of the flattened
               batch sets the threshold for every row.
The "ema" mode and the other score kinds are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DRSConfig(NamedTuple):
    gamma: float = 0.5
    block: int = 128
    threshold_mode: str = "topk"
    ema_decay: float = 0.95
    score: str = "relu_sum"


def num_groups(n_out: int, block: int) -> int:
    if n_out % block != 0:
        raise ValueError(f"n_out={n_out} not divisible by block={block}")
    return n_out // block


def keep_groups(n_out: int, cfg: DRSConfig) -> int:
    """Number of groups kept: ceil((1-gamma) * G), at least 1."""
    g = num_groups(n_out, cfg.block)
    return max(1, int((1.0 - cfg.gamma) * g + 0.999999))


def group_scores(virtual: torch.Tensor, cfg: DRSConfig) -> torch.Tensor:
    """(..., N) virtual pre-activations -> (..., G) relu-sum group scores."""
    if cfg.score != "relu_sum":
        raise ValueError(f"score {cfg.score!r} is not ported (relu_sum only; "
                         f"see ROADMAP.md)")
    g = virtual.shape[-1] // cfg.block
    v = virtual.reshape(virtual.shape[:-1] + (g, cfg.block))
    return torch.relu(v).sum(dim=-1)


def _topk_threshold(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest score: (..., G) -> (..., 1)."""
    return torch.topk(scores, k, dim=-1).values[..., k - 1:k]


def select_mask(scores: torch.Tensor, n_out: int,
                cfg: DRSConfig) -> torch.Tensor:
    """Group scores (..., G) -> float32 {0,1} mask (..., G).  Ties at the
    threshold are all kept (`>=`), so a row may keep more than k groups."""
    k = keep_groups(n_out, cfg)
    g = scores.shape[-1]
    if k >= g:
        return torch.ones_like(scores, dtype=torch.float32)
    if cfg.threshold_mode == "topk":
        thr = _topk_threshold(scores, k)
    elif cfg.threshold_mode == "shared":
        thr = _topk_threshold(scores.reshape(-1, g)[0:1], k).reshape(
            (1,) * (scores.ndim - 1) + (1,))
    else:
        raise ValueError(f"threshold_mode {cfg.threshold_mode!r} is not "
                         f"ported (topk, shared; see ROADMAP.md)")
    return (scores >= thr).to(torch.float32)


def drs_mask(fx: torch.Tensor, fw: torch.Tensor,
             cfg: DRSConfig) -> torch.Tensor:
    """f(X) (..., k) x f(W) (k, N) -> group mask (..., G)."""
    return select_mask(group_scores(fx @ fw, cfg), fw.shape[-1], cfg)
