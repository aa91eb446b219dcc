"""AdamW with warm-up and decay schedules, global-norm clipping and f32
master weights.

Trees are dicts keyed by parameter name (`dict(model.named_parameters())`).
The state is {"step": int, "m", "v"} with f32 moments, plus "master" (f32
copies of the weights) when the parameters are bf16.  One step takes the
reference's f32 arithmetic in the reference's order: the clip scale, then
the moments, then the bias correction, then the decoupled weight decay on
the master, then a cast back to the parameter's dtype.  The step's scalars
(clip scale, learning rate, bias corrections) are f32 values computed on
the host from the global norm; the elementwise update runs as
`torch._foreach_*` passes over a few leaves at a time, updating the state
and the parameters in place.

`zero1_specs` lays the optimizer state out ZeRO-1 style: each leaf's
parameter spec plus 'data' on its first replicated dim that 16 divides,
the reference's rule applied to the port's per-block leaves (ROADMAP.md
§3: where the reference's stacked leaf has a layer dim that 16 divides,
its 'data' lands there and the port's on the leaf's own first such dim;
the bytes per device are the same).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.parallel.sharding import P

F32 = np.float32
GROUP_BYTES = 1 << 30     # f32 bytes of the leaves one set of passes takes:
                          # bounds the temporaries at full width


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"    # "cosine" | "linear" | "const"


def lr_at(cfg: AdamWConfig, step) -> np.float32:
    """The learning rate at `step`, in f32 as the reference computes it."""
    s = F32(step)
    warm = np.minimum(F32(1.0), (s + F32(1)) / F32(max(cfg.warmup, 1)))
    lr = F32(cfg.lr)
    if cfg.schedule == "const":
        return lr * warm
    frac = np.clip((s - F32(cfg.warmup))
                   / F32(max(cfg.total_steps - cfg.warmup, 1)),
                   F32(0.0), F32(1.0))
    if cfg.schedule == "linear":
        return lr * warm * (F32(1.0) - frac)
    return lr * warm * F32(0.5) * (F32(1.0) + np.cos(F32(math.pi) * frac))


def init_opt(params: dict, use_master: bool) -> dict:
    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}
    st = {"step": 0, "m": zeros(), "v": zeros()}
    if use_master:
        st["master"] = {n: p.detach().float().clone()
                        for n, p in params.items()}
    return st


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, accumulated in f32."""
    norms = torch.stack([torch.linalg.vector_norm(x, dtype=torch.float32)
                         for x in tree.values()])
    return torch.sqrt(torch.sum(norms * norms))


def _groups(names: list, params: dict):
    """Consecutive runs of leaves of about GROUP_BYTES f32 bytes each."""
    run, size = [], 0
    for n in names:
        run.append(n)
        size += 4 * params[n].numel()
        if size >= GROUP_BYTES:
            yield run
            run, size = [], 0
    if run:
        yield run


@torch.no_grad()
def apply_updates(params: dict, grads: dict, opt: dict,
                  cfg: AdamWConfig, read_norm=None) -> tuple:
    """One AdamW step, in place.  Returns (params, opt, metrics) with
    metrics {"grad_norm", "lr"} as f32 numpy scalars.  `read_norm` turns
    the global-norm tensor into a number (its `.item()` by default; the
    dry run's meta tensors hold no value to read)."""
    step = opt["step"] + 1
    norm = global_norm(grads)
    gnorm = F32(norm.item() if read_norm is None else read_norm(norm))
    scale = np.minimum(F32(1.0), F32(cfg.clip_norm)
                       / np.maximum(gnorm, F32(1e-9)))
    lr = lr_at(cfg, step)
    b1c = F32(1.0) - F32(cfg.b1) ** F32(step)
    b2c = F32(1.0) - F32(cfg.b2) ** F32(step)
    masters = opt.get("master")
    for names in _groups(list(params), params):
        g = [grads[n] for n in names]
        if all(x.dtype == torch.float32 for x in g):
            g = torch._foreach_mul(g, float(scale))
        else:                        # widen once, then scale the copies
            g = [x.float() for x in g]
            torch._foreach_mul_(g, float(scale))
        m = [opt["m"][n] for n in names]
        v = [opt["v"][n] for n in names]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        gg = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(v, gg)
        del g, gg
        # update = lr * (m_hat / (sqrt(v_hat) + eps) + wd * w32)
        den = torch._foreach_div(v, float(b2c))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        upd = torch._foreach_div(m, float(b1c))
        torch._foreach_div_(upd, den)
        del den
        w = ([masters[n] for n in names] if masters is not None
             else [params[n].data for n in names])
        torch._foreach_add_(upd, torch._foreach_mul(
            [x.float() for x in w], cfg.weight_decay))
        torch._foreach_mul_(upd, float(lr))
        if masters is not None:
            torch._foreach_sub_(w, upd)
            for n, x in zip(names, w):
                params[n].data.copy_(x)
        elif all(x.dtype == torch.float32 for x in w):
            torch._foreach_sub_(w, upd)
        else:
            for x, u in zip(w, upd):
                x.copy_(x.float() - u)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}


# --- ZeRO-1 spec derivation --------------------------------------------------

def zero1_specs(pspecs: dict, params: dict, data_axis: str = "data") -> dict:
    """Optimizer-state specs: the parameter's spec plus `data_axis` on its
    first replicated dim that 16 divides (the classic ZeRO-1 layout)."""

    def rule(spec: P, leaf) -> P:
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        for i, (e, dim) in enumerate(zip(entries, leaf.shape)):
            if e is None and dim % 16 == 0 and dim >= 16:
                entries[i] = data_axis
                return P(*entries)
        return spec

    return {n: rule(pspecs[n], p) for n, p in params.items()}


def opt_specs(pspecs: dict, params: dict, zero1: bool = True) -> dict:
    base = zero1_specs(pspecs, params) if zero1 else pspecs
    return {"step": P(), "m": base, "v": base}


def opt_specs_with_master(pspecs: dict, params: dict,
                          zero1: bool = True) -> dict:
    st = opt_specs(pspecs, params, zero1)
    st["master"] = st["m"]
    return st
