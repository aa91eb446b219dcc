"""Ternary gradient compression with error feedback.

Each gradient block is quantised to {-s, 0, +s}: entries with
|g| > threshold_frac * mean|g| keep their sign, and s is their mean
magnitude.  The quantisation error is kept in a feedback buffer and added
to the next step's gradient, so the decoded sum telescopes to the true
one.  The wire format is modelled at 2 bits an element plus one f32
scale.  Trees are dicts of tensors keyed by parameter name.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ternarize(g: torch.Tensor, threshold_frac: float = 0.7
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (f32 codes in {-1, 0, +1}, f32 scale)."""
    g32 = g.float()
    a = g32.abs()
    codes = torch.sign(g32) * (a > threshold_frac * a.mean())
    kept = torch.clamp(codes.abs().sum(), min=1.0)
    return codes, (a * codes.abs()).sum() / kept


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor,
                           threshold_frac: float = 0.7):
    """(gradient, error buffer) -> (decoded f32 gradient, new buffer)."""
    corrected = g.float() + err
    dec = decode(*ternarize(corrected, threshold_frac))
    return dec, corrected - dec


def tree_compress_with_feedback(grads: dict, errs: dict,
                                threshold_frac: float = 0.7):
    """Every leaf through `compress_with_feedback`; the decoded gradients
    keep their leaf's dtype."""
    dec, new_errs = {}, {}
    for name, g in grads.items():
        d, new_errs[name] = compress_with_feedback(g, errs[name],
                                                   threshold_frac)
        dec[name] = d.to(g.dtype)
    return dec, new_errs


def init_feedback(template: dict) -> dict:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in template.items()}


def wire_bytes(g: torch.Tensor) -> int:
    """Modelled wire bytes: 2 bits an element plus an f32 scale."""
    return (g.numel() * 2 + 7) // 8 + 4
