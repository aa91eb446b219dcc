"""Serving-time DSG on the LM head (the port of `repro.core.logit_dsg`).

At decode the vocab projection (d -> V) dominates a small batch's FLOPs.
Greedy and top-p sampling need only the high logits, so DRS estimates the
logit blocks from f(x) @ f(W_head), the top (1 - gamma) blocks are
gathered, and exact logits are computed for the survivors only.  Skipped
blocks read NEG (they cannot win sampling among the survivors).  Greedy
decoding is exact whenever the true argmax block is kept.  No model calls
it; the tests do.

The top blocks come from a stable descending sort, not `torch.topk`,
whose tie order is not documented: ties go to the lower block, as
`lax.top_k`'s do (`models/moe.router_topk` does the same).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import drs, projection
from repro_torch.core.dsg_linear import DSGConfig

NEG = -1e30


def init_logit_dsg(w_head: torch.Tensor, cfg: DSGConfig, *,
                   generator: torch.Generator, device=None) -> dict:
    """w_head (d, V) -> {'r': (k, d), 'fw': (k, V)}."""
    d, v = w_head.shape
    r = projection.make_projection(projection.jll_dim(d, v, cfg.eps), d,
                                   generator=generator, dtype=w_head.dtype,
                                   device=device)
    return {"r": r, "fw": projection.project(r, w_head)}


def _top_blocks(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """The `keep` best blocks of each row, ties to the lower block, in
    ascending order."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.sort(idx[..., :keep], dim=-1).values


def dsg_logits(x: torch.Tensor, w_head: torch.Tensor, state: dict,
               cfg: DSGConfig, per_request: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, d) -> (logits (B, V) with NEG on skipped blocks, f32 block
    mask (B, G)).  per_request selects each row's blocks on its own;
    otherwise one selection, by the rows' largest block scores, serves the
    batch.  A block's score is its largest estimated logit."""
    b, d = x.shape
    v = w_head.shape[1]
    blk = cfg.block
    g = v // blk
    keep = max(1, int((1.0 - cfg.gamma) * g + 0.999999))
    fx = projection.project_rows(state["r"], x)
    scores = drs.group_scores(fx @ state["fw"],
                              cfg.drs_cfg()._replace(score="max"))  # (B, G)
    w3 = w_head.reshape(d, g, blk).transpose(0, 1)                 # (G, d, blk)
    rows = torch.arange(b, device=x.device)[:, None]
    if per_request:
        idx = _top_blocks(scores, keep)                            # (B, keep)
        part = torch.einsum("bd,bkdc->bkc", x, w3[idx])
    else:
        idx = _top_blocks(scores.amax(dim=0), keep)                # (keep,)
        part = torch.einsum("bd,kdc->bkc", x, w3[idx])
        idx = idx.expand(b, keep)
    logits = torch.full((b, g, blk), NEG, dtype=part.dtype, device=x.device)
    logits[rows, idx] = part
    mask = torch.zeros((b, g), dtype=torch.float32, device=x.device)
    mask[rows, idx] = 1.0
    return logits.reshape(b, v), mask


def flops_saving(v: int, d: int, cfg: DSGConfig) -> float:
    """Fraction of head FLOPs avoided, less the DRS search's cost."""
    k = projection.jll_dim(d, v, cfg.eps)
    full = d * v
    search = k * d + k * v
    kept = (1.0 - cfg.gamma) * full
    return 1.0 - (search + kept) / full
