"""Sparse random projection (Achlioptas 2001) — the DSG dimension reducer.

One shared ternary matrix R in {-sqrt(s), 0, +sqrt(s)}^{k x d}, s=3, scaled
by 1/sqrt(k), estimates inner products in k dimensions:
<f(X), f(W_j)> ~= <X, W_j> with f(Z) = R Z.

k comes from the JLL bound k = c ln(N) / eps^2 and is rounded up to a
multiple of 128.  That rounding was chosen for the TPU's lane width, but it
defines the DSG state (k = 256 at internlm2-1.8b's full width, 64 at smoke
width), so the port keeps it to compute the same selections.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

LANE = 128


def jll_dim(d: int, n_points: int, eps: float, c: float = 4.0,
            lane: int = LANE) -> int:
    """JLL-derived projection dim: ceil(c ln(N) / eps^2) clamped to
    [lane, d] and rounded up to a multiple of `lane`, never beyond d."""
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    k = int(math.ceil(c * math.log(max(n_points, 2)) / (eps * eps)))
    k = max(lane, min(d, k))
    return min(d, ((k + lane - 1) // lane) * lane)


def make_projection(k: int, d: int, *, generator: torch.Generator,
                    s: int = 3, dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Ternary Achlioptas matrix R (k, d): P(+-sqrt(s)) = 1/(2s) each,
    P(0) = 1 - 1/s, scaled by 1/sqrt(k) so f(Z) = R @ Z directly."""
    u = torch.rand((k, d), generator=generator, device=device)
    sign = torch.where(torch.rand((k, d), generator=generator,
                                  device=device) < 0.5, 1.0, -1.0)
    r = torch.where(u < 1.0 / s, sign * math.sqrt(s), 0.0)
    return (r / math.sqrt(k)).to(dtype)


def project_rows(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """f(X) over the trailing feature dim: (..., d) -> (..., k)."""
    return x @ r.t()
