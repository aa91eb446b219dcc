"""Hierarchical multi-pod gradient reduction with cross-pod compression
(the port of `repro.optim.hierarchical`).

On a (pod, data, model) fleet the data-parallel gradient reduction spans
pod x data, but the cross-pod links are the scarce ones.  The hierarchy:

    1. exact mean over the in-pod 'data' axis (fast links, full precision)
    2. ternary quantisation with error feedback (`optim.compress`)
    3. sum of the decoded values over the 'pod' axis (on the wire: 2-bit
       codes and one scale a rank), then the mean

Error feedback makes the compression unbiased over steps: the residual is
added back on the next step.  Both functions run on local tensors inside
a `parallel.collectives.shard_map` body over a mesh with both axes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.optim.compress import ternarize
from repro_torch.parallel.collectives import axis_size, psum


def hierarchical_grad_reduce(g: torch.Tensor, err: torch.Tensor,
                             pod_axis: str = "pod", data_axis: str = "data",
                             threshold_frac: float = 0.7,
                             compress: bool = True, mesh=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's gradient -> the fleet's mean gradient.

    g: this rank's local gradient (the same shape on every rank); err:
    this rank's error-feedback buffer (f32, g's shape).  Returns (mean
    gradient in g's dtype, new error buffer); without `compress` the
    buffer comes back as it went in."""
    n_data = axis_size(data_axis, mesh)
    n_pod = axis_size(pod_axis, mesh)
    g_pod = psum(g, data_axis, mesh) / n_data
    if not compress:
        return psum(g_pod, pod_axis, mesh) / n_pod, err
    corrected = g_pod.float() + err
    codes, scale = ternarize(corrected, threshold_frac)
    decoded = codes * scale
    new_err = corrected - decoded
    g_fleet = psum(decoded, pod_axis, mesh) / n_pod
    return g_fleet.to(g.dtype), new_err


def tree_hierarchical_reduce(grads: dict, errs: dict, **kw):
    """Every leaf of a {name: tensor} tree through
    `hierarchical_grad_reduce`; returns (grads, errs) trees."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        out_g[name], out_e[name] = hierarchical_grad_reduce(g, errs[name],
                                                            **kw)
    return out_g, out_e
