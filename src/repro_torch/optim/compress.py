"""Ternary gradient compression with error feedback.

Each gradient block is quantised to {-s, 0, +s}: entries with
|g| > threshold_frac * mean|g| keep their sign, and s is their mean
magnitude.  The quantisation error is kept in a feedback buffer and added
to the next step's gradient, so the decoded sum telescopes to the true
one.  The wire format is modelled at 2 bits an element plus one f32
scale.  Trees are dicts of tensors keyed by parameter name.
`compressed_psum` is the all-reduce of the decoded values over a named
mesh axis, for the body of a `parallel.collectives.shard_map`.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ternarize_group(gs: list, threshold_frac: float = 0.7
                    ) -> Tuple[list, torch.Tensor]:
    """Tensors quantised as one, without concatenating them: one mean |g|
    and one scale over all their entries -> (f32 codes in {-1, 0, +1} for
    each tensor, f32 scale)."""
    g32 = [g.float() for g in gs]
    a = [x.abs() for x in g32]
    mean = sum(x.sum() for x in a) / sum(x.numel() for x in a)
    codes = [torch.sign(x) * (y > threshold_frac * mean)
             for x, y in zip(g32, a)]
    kept = torch.clamp(sum(c.abs().sum() for c in codes), min=1.0)
    return codes, sum((y * c.abs()).sum() for y, c in zip(a, codes)) / kept


def ternarize(g: torch.Tensor, threshold_frac: float = 0.7
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (f32 codes in {-1, 0, +1}, f32 scale)."""
    (codes,), scale = ternarize_group([g], threshold_frac)
    return codes, scale


def decode(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor,
                           threshold_frac: float = 0.7):
    """(gradient, error buffer) -> (decoded f32 gradient, new buffer)."""
    corrected = g.float() + err
    dec = decode(*ternarize(corrected, threshold_frac))
    return dec, corrected - dec


def compressed_psum(g: torch.Tensor, axis: str, err: torch.Tensor,
                    threshold_frac: float = 0.7, mesh=None):
    """Ternary-compressed all-reduce over `axis` (inside a shard_map body,
    on this rank's local tensors): each rank's decoded codes, summed over
    the axis.  On the wire that is 2-bit codes plus one scale a rank; the
    sum of decoded values is what each rank reconstructs.  Returns
    (reduced, new_err)."""
    from repro_torch.parallel.collectives import psum
    dec, new_err = compress_with_feedback(g, err, threshold_frac)
    return psum(dec, axis, mesh), new_err


def tree_compress_with_feedback(grads: dict, errs: dict,
                                threshold_frac: float = 0.7, group=None):
    """Every leaf through `compress_with_feedback`; the decoded gradients
    keep their leaf's dtype.  `group(name)` -> key quantises the leaves
    that share a key as one (`ternarize_group`): the trainer groups a
    model's per-block leaves by the reference's stacked leaf
    (`bridge.reference_path`), which the reference quantises whole.  By
    default each leaf is its own group."""
    keys = {}
    for name in grads:
        keys.setdefault(group(name) if group else name, []).append(name)
    dec, new_errs = {}, {}
    for names in keys.values():
        corrected = [grads[n].float() + errs[n] for n in names]
        codes, scale = ternarize_group(corrected, threshold_frac)
        for n, c, k in zip(names, corrected, codes):
            d = decode(k, scale)
            new_errs[n] = c - d
            dec[n] = d.to(grads[n].dtype)
    return dec, new_errs


def init_feedback(template: dict) -> dict:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in template.items()}


def wire_bytes(g: torch.Tensor) -> int:
    """Modelled wire bytes: 2 bits an element plus an f32 scale."""
    return (g.numel() * 2 + 7) // 8 + 4
