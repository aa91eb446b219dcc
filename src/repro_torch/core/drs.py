"""Dimension-reduction search (DRS): score neuron groups from virtual
pre-activations f(X) @ f(W) and keep the top (1 - gamma) fraction.

Selection is per neuron group of `block` consecutive outputs.  Scores:
  * "relu_sum"   — sum(relu(v)) over the group (the default);
  * "abs_sum"    — sum(|v|);
  * "signed_sum" — sum(v);
  * "max"        — the group's largest v.
Threshold modes:
  * "topk"   — per-row k-th largest score, every group at or above it kept.
  * "shared" — the paper's inter-sample sharing: row 0 of the flattened
               batch sets the threshold for every row.
  * "ema"    — a threshold carried across steps: the mask uses the carried
               value (this batch's mean top-k threshold when none is
               carried) and the decayed average toward this batch's
               threshold is returned for the next step (`select_mask_ema`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.parallel.context import whole_groups


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
    """(..., N) virtual pre-activations -> (..., G) group scores."""
    g = virtual.shape[-1] // cfg.block
    v = whole_groups(virtual, cfg.block).reshape(virtual.shape[:-1]
                                                 + (g, cfg.block))
    if cfg.score == "relu_sum":
        return torch.relu(v).sum(dim=-1)
    if cfg.score == "abs_sum":
        return v.abs().sum(dim=-1)
    if cfg.score == "signed_sum":
        return v.sum(dim=-1)
    if cfg.score == "max":
        return v.amax(dim=-1)
    raise ValueError(f"unknown score {cfg.score}")


def _topk_threshold(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row k-th largest score: (..., G) -> (..., 1)."""
    return torch.topk(scores, k, dim=-1).values[..., k - 1:k]


def select_mask_ema(scores: torch.Tensor, n_out: int, cfg: DRSConfig,
                    ema_threshold=None):
    """Group scores (..., G) -> (float32 {0,1} mask (..., G), new EMA).

    Ties at the threshold are all kept (`>=`), so a row may keep more than
    k groups.  The new EMA is a 0-dim f32 tensor in "ema" mode and
    `ema_threshold` passed through otherwise (also when every group is
    kept, as the reference does)."""
    k = keep_groups(n_out, cfg)
    g = scores.shape[-1]
    if k >= g:
        return torch.ones_like(scores, dtype=torch.float32), ema_threshold
    if cfg.threshold_mode == "topk":
        thr = _topk_threshold(scores, k)
        return (scores >= thr).to(torch.float32), ema_threshold
    if cfg.threshold_mode == "shared":
        thr = _topk_threshold(scores.reshape(-1, g)[0:1], k).reshape(
            (1,) * (scores.ndim - 1) + (1,))
        return (scores >= thr).to(torch.float32), ema_threshold
    if cfg.threshold_mode == "ema":
        thr_now = _topk_threshold(scores, k).to(torch.float32).mean()
        if ema_threshold is None:
            ema = thr_now
        else:
            ema = torch.as_tensor(ema_threshold, dtype=torch.float32,
                                  device=scores.device)
        mask = (scores >= ema).to(torch.float32)
        return mask, cfg.ema_decay * ema + (1 - cfg.ema_decay) * thr_now
    raise ValueError(f"unknown threshold_mode {cfg.threshold_mode}")


def select_mask(scores: torch.Tensor, n_out: int,
                cfg: DRSConfig) -> torch.Tensor:
    """The mask of `select_mask_ema` with no carried threshold ("ema"
    mode then thresholds at this batch's mean top-k threshold)."""
    return select_mask_ema(scores, n_out, cfg)[0]


def drs_mask(fx: torch.Tensor, fw: torch.Tensor,
             cfg: DRSConfig) -> torch.Tensor:
    """f(X) (..., k) x f(W) (k, N) -> group mask (..., G)."""
    return select_mask(group_scores(fx @ fw, cfg), fw.shape[-1], cfg)


def expand_mask(mask: torch.Tensor, block: int) -> torch.Tensor:
    """Group mask (..., G) -> neuron mask (..., G*block)."""
    return torch.repeat_interleave(mask, block, dim=-1)


def oracle_mask(pre_act: torch.Tensor, n_out: int,
                cfg: DRSConfig) -> torch.Tensor:
    """The paper's oracle baseline (Fig. 5(c)): per-row top-k on the true
    pre-activations, which needs the full products DRS avoids."""
    return select_mask(group_scores(pre_act, cfg), n_out,
                       cfg._replace(threshold_mode="topk"))


def random_mask(generator: torch.Generator, batch_shape: tuple, n_out: int,
                cfg: DRSConfig, device: Optional[torch.device] = None
                ) -> torch.Tensor:
    """The paper's random baseline (Fig. 5(c)): k uniformly random groups
    per row, drawn from `generator` (created on `device`)."""
    g = num_groups(n_out, cfg.block)
    k = keep_groups(n_out, cfg)
    scores = torch.rand(tuple(batch_shape) + (g,), generator=generator,
                        device=device)
    return (scores >= _topk_threshold(scores, k)).to(torch.float32)
