"""Serving-side DSG runtime: per-lane group-CSR patterns and DRS refresh.

Each lane holds a per-layer active-group index list (core/sparse_mask.py
form), seeded at admission from the DRS scores of the prompt's last token
and kept on the host as numpy; pattern updates are integer writes.  The
decode step contracts only the listed groups, with the row width bucketed
to a power of two.  Every `refresh_interval` emitted tokens (counted per
lane, so a stream does not depend on which lanes share its steps) the
decode step also returns the DRS group scores of its FFN inputs, and the
host rewrites the due lanes' patterns from them.

Selection is per-lane top-k ("topk"): serving lanes are unrelated requests,
so the paper's shared threshold would couple them.  The "ema" threshold is
not ported yet (ROADMAP.md).

Free lanes mirror the donor lane's pattern in the step (mirror_csr) for the
same reason they mirror its token and page-table row: a paged free lane
writes duplicate K/V into the donor's pages, which is harmless only if the
duplicate is bit-identical.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import drs, sparse_mask


class DSGServingConfig(NamedTuple):
    refresh_interval: int = 8     # emitted tokens between DRS refreshes,
                                  # per lane (1 = re-select every step)


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
        if scfg.refresh_interval < 1:
            raise ValueError("refresh_interval must be >= 1")
        self.cfg = scfg
        self.device = device
        self.n_groups = cfg.d_ff // cfg.dsg.block
        self.keep = drs.keep_groups(cfg.d_ff, cfg.dsg.drs_cfg())
        self.n_layers = cfg.n_layers
        shape = (cfg.n_layers, n_slots)
        # every lane starts at the minimal pattern {group 0}, so a parked
        # lane never inflates the bound
        self.idx = np.zeros(shape + (self.n_groups,), np.int32)
        self.counts = np.ones(shape, np.int32)
        self.lane_active = np.zeros(n_slots, bool)
        self._dev = {}
        self._version = 0

    def _write_rows(self, lane: int, scores: np.ndarray):
        """scores (L, G) -> the lane's per-layer CSR rows: every group at or
        above the lane's k-th largest score, ascending."""
        g, keep = self.n_groups, self.keep
        for l in range(self.n_layers):
            s = scores[l]
            thr = np.partition(s, g - keep)[g - keep]
            active = np.flatnonzero(s >= thr).astype(np.int32)
            self.idx[l, lane] = 0
            self.idx[l, lane, :len(active)] = active
            self.counts[l, lane] = len(active)
        self._version += 1
        self._dev.clear()

    def set_lane_from_scores(self, lane: int, scores: np.ndarray):
        """Admission: seed the lane's pattern from the DRS scores (L, G) of
        the prompt's last token; the lane decodes sparsely from its first
        step."""
        self._write_rows(lane, np.asarray(scores, np.float32))
        self.lane_active[lane] = True

    def update_from_scores(self, scores: np.ndarray, lanes):
        """Refresh: scores (L, B, G) from the decode step; only the due,
        still-active lanes are rewritten."""
        scores = np.asarray(scores, np.float32)
        for i in lanes:
            if self.lane_active[i]:
                self._write_rows(i, scores[:, i])

    def reset_lane(self, lane: int):
        """Retirement: back to the minimal pattern."""
        self.idx[:, lane] = 0
        self.counts[:, lane] = 1
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
        """The CSR bounds warm_decode runs: per-lane top-k pins every lane
        at `keep` groups (up to score ties), so one bucket suffices."""
        return (sparse_mask.active_group_bound(self.keep, self.n_groups),)

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
