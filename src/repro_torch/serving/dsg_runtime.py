"""Serving-side DSG runtime: per-lane group-CSR patterns and DRS refresh.

Each lane holds a per-layer active-group index list (core/sparse_mask.py
form), seeded at admission from the DRS scores of the prompt's last token
and kept on the host as numpy; pattern updates are integer writes.  The
decode step contracts only the listed groups, with the row width bucketed
to a power of two.  Every `refresh_interval` emitted tokens (counted per
lane, so a stream does not depend on which lanes share its steps) the
decode step also returns the DRS group scores of its FFN inputs, and the
host rewrites the due lanes' patterns from them.

Threshold modes ("topk" | "ema") are per lane: serving lanes are unrelated
requests, so the paper's shared threshold would couple them.  "ema" carries
a per-(layer, lane) threshold, seeded at admission from the lane's top-k
threshold and blended with it at each refresh, so a lane's group count
floats with its activation mass.

`record_step` logs each decode step's modeled FFN work (dense, CSR and
padded-bound group units), and `flop_stats` sums the log.
`double_mask_csr` re-applies a CSR pattern after a norm (the paper's
double mask), for post-norm stacks.

Free lanes mirror the donor lane's pattern in the step (mirror_csr) for the
same reason they mirror its token and page-table row: a paged free lane
writes duplicate K/V into the donor's pages, which is harmless only if the
duplicate is bit-identical.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import double_mask as dm
from repro_torch.core import drs, sparse_mask


class DSGServingConfig(NamedTuple):
    refresh_interval: int = 8     # emitted tokens between DRS refreshes,
                                  # per lane (1 = re-select every step)
    threshold: str = "topk"       # "topk" | "ema" per-lane selection
    ema_decay: float = 0.95       # threshold EMA decay ("ema" mode)


def as_serving_config(value) -> Optional[DSGServingConfig]:
    """Engine-kwarg coercion: True -> defaults, None/False -> disabled."""
    if value is None or value is False:
        return None
    if value is True:
        return DSGServingConfig()
    if isinstance(value, DSGServingConfig):
        return value
    raise TypeError(f"dsg_serving must be a DSGServingConfig, True, or None; "
                    f"got {type(value).__name__}")


def mirror_csr(csr: dict, free_mask: torch.Tensor,
               donor: torch.Tensor) -> dict:
    """Overwrite free lanes' CSR rows with the donor lane's (donor a (1,)
    long tensor, so nothing is read back).
    csr = {'idx': (L, B, K), 'counts': (L, B)}."""
    idx, counts = csr["idx"], csr["counts"]
    return {"idx": torch.where(free_mask[None, :, None],
                               idx.index_select(1, donor), idx).contiguous(),
            "counts": torch.where(free_mask[None, :],
                                  counts.index_select(1, donor), counts)}


def double_mask_csr(norm_fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
                    *, block: int, n_groups: int) -> torch.Tensor:
    """Double-mask selection (core/double_mask.py) driven by a group-CSR
    pattern: y = Mask(norm(Mask(x))) with the mask expanded from the index
    list.  The decode stack is pre-norm and needs none; this is the hook
    for post-norm stacks, whose norm after the block would densify the
    zeros the CSR selection made."""
    mask = sparse_mask.csr_to_dense(idx, counts, n_groups)
    return dm.double_mask(norm_fn, x, mask, block)


class DSGRuntime:
    """Host-side per-lane DRS state for one ServingEngine.

    Patterns are kept full width on the host — idx (L, B, G) int32,
    counts (L, B) int32 — and pushed to the device sliced to the current
    pow2 bound, cached per (version, bound) until the next pattern write.
    """

    def __init__(self, cfg, scfg: DSGServingConfig, n_slots: int, device):
        if not cfg.dsg.enabled:
            raise ValueError("dsg_serving needs cfg.dsg.enabled")
        if cfg.d_ff % cfg.dsg.block:
            raise ValueError(f"d_ff={cfg.d_ff} not divisible by DSG block "
                             f"{cfg.dsg.block}")
        if scfg.threshold not in ("topk", "ema"):
            raise ValueError(f"serving threshold must be 'topk' or 'ema' "
                             f"(per-lane modes), got {scfg.threshold!r}")
        if scfg.refresh_interval < 1:
            raise ValueError("refresh_interval must be >= 1")
        self.cfg = scfg
        self.device = device
        self.n_groups = cfg.d_ff // cfg.dsg.block
        self.keep = drs.keep_groups(cfg.d_ff, cfg.dsg.drs_cfg())
        self.n_layers = cfg.n_layers
        self.n_slots = n_slots
        shape = (cfg.n_layers, n_slots)
        # every lane starts at the minimal pattern {group 0}, so a parked
        # lane never inflates the bound
        self.idx = np.zeros(shape + (self.n_groups,), np.int32)
        self.counts = np.ones(shape, np.int32)
        self.ema = np.zeros(shape, np.float32)
        self.lane_active = np.zeros(n_slots, bool)
        self.step_log: List[dict] = []    # one FLOP-model entry a step
        self._dev = {}
        self._version = 0

    def _write_rows(self, lane: int, scores: np.ndarray, seed_ema: bool):
        """scores (L, G) -> the lane's per-layer CSR rows, ascending: every
        group at or above the lane's k-th largest score ("topk", and "ema"
        at admission), or at or above the lane's EMA threshold ("ema" at a
        refresh; the top group when the threshold is above every score).
        In "ema" mode the threshold is then seeded with, or blended toward,
        the k-th score."""
        g, keep = self.n_groups, self.keep
        ema = self.cfg.threshold == "ema"
        for l in range(self.n_layers):
            s = scores[l]
            thr_topk = np.partition(s, g - keep)[g - keep]
            thr = self.ema[l, lane] if ema and not seed_ema else thr_topk
            mask = s >= thr
            if not mask.any():
                mask[int(np.argmax(s))] = True
            active = np.flatnonzero(mask).astype(np.int32)
            self.idx[l, lane] = 0
            self.idx[l, lane, :len(active)] = active
            self.counts[l, lane] = len(active)
            if ema:
                self.ema[l, lane] = (thr_topk if seed_ema else
                                     self.cfg.ema_decay * thr
                                     + (1 - self.cfg.ema_decay) * thr_topk)
        self._version += 1
        self._dev.clear()

    def set_lane_from_scores(self, lane: int, scores: np.ndarray):
        """Admission: seed the lane's pattern (and its EMA thresholds) from
        the DRS scores (L, G) of the prompt's last token; the lane decodes
        sparsely from its first step."""
        self._write_rows(lane, np.asarray(scores, np.float32),
                         seed_ema=True)
        self.lane_active[lane] = True

    def update_from_scores(self, scores: np.ndarray, lanes):
        """Refresh: scores (L, B, G) from the decode step; only the due,
        still-active lanes are rewritten."""
        scores = np.asarray(scores, np.float32)
        for i in lanes:
            if self.lane_active[i]:
                self._write_rows(i, scores[:, i], seed_ema=False)

    def reset_lane(self, lane: int):
        """Retirement: back to the minimal pattern."""
        self.idx[:, lane] = 0
        self.counts[:, lane] = 1
        self.ema[:, lane] = 0.0
        self.lane_active[lane] = False
        self._version += 1
        self._dev.clear()

    def bound(self) -> int:
        """CSR row width for this step: pow2 bucket over the active lanes'
        counts."""
        mc = (int(self.counts[:, self.lane_active].max())
              if self.lane_active.any() else 1)
        return sparse_mask.active_group_bound(mc, self.n_groups)

    def warm_bounds(self) -> tuple:
        """The CSR bounds warm_decode runs: "topk" pins every lane at `keep`
        groups (up to score ties), so one bucket suffices; under "ema" the
        counts float, so every bucket can be reached."""
        if self.cfg.threshold == "topk":
            return (sparse_mask.active_group_bound(self.keep,
                                                   self.n_groups),)
        return sparse_mask.active_group_buckets(self.n_groups)

    def device_csr(self, bound: int) -> dict:
        """The pattern state sliced to `bound` on the device, with counts
        clamped to the bound; cached per (version, bound)."""
        key = (self._version, bound)
        if key not in self._dev:
            self._dev[key] = {
                "idx": torch.from_numpy(
                    np.ascontiguousarray(self.idx[:, :, :bound])
                ).to(self.device),
                "counts": torch.from_numpy(
                    np.minimum(self.counts, bound).astype(np.int32)
                ).to(self.device),
            }
        return self._dev[key]

    # -- FLOP accounting --------------------------------------------------------

    def record_step(self, active, bound: int):
        """Log one decode step's modeled FFN group units: dense, every group
        of every active lane; csr, the lanes' counts the CSR kernel walks;
        bound, the padded width a gather at the pow2 bound contracts."""
        n = len(active)
        self.step_log.append({
            "active": n,
            "dense_units": self.n_layers * self.n_groups * n,
            "csr_units": int(self.counts[:, list(active)].sum()),
            "bound_units": self.n_layers * bound * n,
        })

    def flop_stats(self) -> dict:
        """The modeled FFN FLOP reduction over the logged steps."""
        if not self.step_log:
            raise ValueError("no decode steps recorded")
        dense = sum(e["dense_units"] for e in self.step_log)
        csr = sum(e["csr_units"] for e in self.step_log)
        bnd = sum(e["bound_units"] for e in self.step_log)
        return {"steps": len(self.step_log),
                "dense_units": dense, "csr_units": csr,
                "bound_units": bnd,
                "flop_reduction_csr": dense / max(csr, 1),
                "flop_reduction_bound": dense / max(bnd, 1),
                "overhead_bytes": sparse_mask.csr_overhead_bytes(
                    (self.n_layers, self.n_slots), self.n_groups)}
