"""Continuous-batching serving engine with overlap admission (paged KV).

The engine keeps `n_slots` decode lanes and admits a queued prompt into any
free lane on any step.  Admission right-aligns the prompt into the
smallest length bucket that holds it (longer prompts keep their last
`bucket` tokens and are flagged `truncated`), prefills it against a fresh
1-lane dense cache, and splices the result into the paged pool
(serving/kv_cache.py).  Each decode step emits every active lane's pending
token, grows page tables, runs one batched decode over all lanes with
per-lane positions, takes the greedy argmax, and retires lanes on
EOS-after-emit, max_new or max_seq.

PyTorch runs eagerly, so there is nothing to compile or warm per shape.
The KV pools are updated in place where JAX donates them to its jitted
steps.  Sampling (temperature > 0), the dense backend, fused decode chunks
and prefix sharing are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import collections
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.serving import dsg_runtime, kv_cache

DEFAULT_BUCKETS = (16, 32, 64, 96, 128, 192, 256)


def bucket_sizes(prompt_bucket: int, max_seq: int) -> tuple:
    """The prompt buckets an engine uses: the default sizes capped at
    prompt_bucket and at max_seq - 1 (a prompt filling every position
    would leave no decode headroom)."""
    cap = min(prompt_bucket, max_seq - 1)
    return tuple(sorted({min(b, cap) for b in DEFAULT_BUCKETS}))


def live_page_bound(max_pos: int, page_size: int, max_pages: int) -> int:
    """Paged-decode walk bound covering a batch whose deepest lane writes
    at max_pos: pages needed, rounded up to a power of two, capped at the
    page-table width."""
    need = max_pos // page_size + 1
    return min(1 << (need - 1).bit_length(), max_pages)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0         # only 0 (greedy) is ported
    # filled by the engine (time.perf_counter() stamps):
    output: List[int] = field(default_factory=list)
    truncated: bool = False
    submitted: float = 0.0
    started: float = 0.0
    first_token: float = 0.0
    finished: float = 0.0
    status: str = "pending"          # "pending" until retired "ok"

    def __post_init__(self):
        if self.temperature > 0:
            raise NotImplementedError(
                "sampling (temperature > 0) is not ported yet; the port "
                "decodes greedily (see ROADMAP.md)")


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                      # next write position in the cache

    @property
    def free(self) -> bool:
        return self.req is None


@dataclass
class StepPlan:
    """Host-built operands for one decode step."""
    active: List[int]                 # slot indices decoding this step
    donor: int                        # active lane that free lanes mirror
    tok: np.ndarray                   # (n_slots,) int32 decode inputs
    pos: np.ndarray                   # (n_slots,) int32 write positions
    free_mask: np.ndarray             # (n_slots,) bool
    live_pages: int                   # paged walk bound


class ServingEngine:
    """Continuous batching over a fixed slot count on one device (the
    model's).  With the DSG serving runtime, lanes decode through per-lane
    group-CSR FFN patterns refreshed every `refresh_interval` tokens.

    Free lanes mirror the first active lane (its token, position, page-table
    row and CSR pattern): their writes land in the donor's pages as
    identical duplicates, and their outputs are never read.  The paged
    backend reserves a request's worst-case pages (min(bucket + max_new,
    max_seq)) at admission, so page-table growth never runs out; a pool
    too small for the next request defers its admission.
    """

    def __init__(self, cfg, model, dsg, *, n_slots: int = 4,
                 max_seq: int = 256, prompt_bucket: int = 64,
                 cache_backend="paged", page_size: int = 16,
                 cache_tokens: Optional[int] = None, dsg_serving=None):
        self.cfg = cfg
        self.model = model
        self.dsg = dsg
        self.device = model.embed.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.buckets = bucket_sizes(prompt_bucket, max_seq)
        self.queue: collections.deque = collections.deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.done: Dict[int, Request] = {}
        self.steps = 0
        self.admissions = 0
        self.refresh_steps = 0
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self._warned_truncation = False
        if cache_backend != "paged":
            raise ValueError(f"cache backend {cache_backend!r} is not ported "
                             f"(paged only; see ROADMAP.md)")
        self.backend = kv_cache.PagedBackend(page_size=page_size,
                                             total_tokens=cache_tokens)
        self.cache = self.backend.make(cfg, n_slots, max_seq, self.device)
        self._next_tok = np.zeros(n_slots, np.int32)

        scfg = dsg_runtime.as_serving_config(dsg_serving)
        self.dsg_rt = None
        if scfg is not None:
            if dsg is None or not cfg.dsg.enabled:
                raise ValueError("dsg_serving needs DSG state: "
                                 "cfg.dsg.enabled and a non-None dsg")
            if cfg.dsg.score != "relu_sum":
                raise ValueError("the decode-time refresh computes relu_sum "
                                 f"scores; cfg.dsg.score is {cfg.dsg.score!r}")
            self.dsg_rt = dsg_runtime.DSGRuntime(cfg, scfg, n_slots,
                                                 self.device)

    # -- public API ---------------------------------------------------------

    def submit(self, req: Request):
        req.submitted = req.submitted or time.perf_counter()
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        while (self.queue or any(not s.free for s in self.slots)) \
                and self.steps < max_steps:
            self.step()
        return self.done

    # -- engine internals ---------------------------------------------------

    def _bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return self.buckets[-1]

    def _admit(self):
        """Admit queued prompts into every free lane whose worst-case page
        reservation the pool can cover."""
        for i, slot in enumerate(self.slots):
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            plen = len(req.prompt)
            pb = self._bucket_for(plen)
            if plen > pb:
                req.truncated = True
                if not self._warned_truncation:
                    warnings.warn(
                        f"prompt of request {req.uid} ({plen} tokens) "
                        f"exceeds the largest bucket ({pb}); keeping the "
                        f"last {pb} tokens (warned once per engine)")
                    self._warned_truncation = True
            need = min(pb + req.max_new, self.max_seq)
            if not self.backend.can_admit(need):
                break            # retirements will free pages; retry later
            self.queue.popleft()
            toks = np.zeros((1, pb), np.int32)
            pr = req.prompt[-pb:]
            toks[0, pb - len(pr):] = pr
            toks_dev = torch.from_numpy(toks).long().to(self.device)
            lane = api.make_cache(self.cfg, 1, self.max_seq,
                                  device=self.device)
            if self.dsg_rt is not None:
                logits, lane, sc = api.prefill(
                    self.model, self.dsg, self.cfg, {"tokens": toks_dev},
                    lane, collect_drs_scores=True)
                # the lane decodes sparsely from its first step
                self.dsg_rt.set_lane_from_scores(
                    i, sc[:, 0].float().cpu().numpy())
            else:
                logits, lane = api.prefill(self.model, self.dsg, self.cfg,
                                           {"tokens": toks_dev}, lane)
            self.cache = self.backend.write(self.cache, lane, i,
                                            n_tokens=pb, reserve_tokens=need)
            self.admissions += 1
            req.started = time.perf_counter()
            slot.req = req
            slot.pos = pb
            self._next_tok[i] = int(torch.argmax(logits[0]))

    def _live_pages(self, pos: np.ndarray) -> int:
        """Walk bound for this step over the deepest lane (free lanes mirror
        an active donor, so the active maximum covers them)."""
        deepest = min(int(pos.max()), self.max_seq - 1)
        return live_page_bound(deepest, self.backend.page_size,
                               self.max_seq // self.backend.page_size)

    def begin_step(self) -> Optional[StepPlan]:
        """Host half of a decode step: admit queued prompts, emit each
        active lane's pending token, grow page tables for this step's write
        positions, and build the decode operands (None when idle)."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if not s.free]
        if not active:
            if self.queue:
                raise RuntimeError(
                    "engine stalled: queued prompts cannot be admitted — "
                    "the paged cache pool is smaller than a single "
                    "request's page reservation; raise cache_tokens or "
                    "lower max_new/prompt_bucket")
            return None
        # free lanes mirror the first active lane: under a shared DRS
        # threshold an idle row would otherwise steer every lane, and in
        # the paged pool their writes are the donor's own duplicates
        donor = active[0]
        tok = np.array(self._next_tok, np.int32)
        pos = np.empty(self.n_slots, np.int32)
        free_mask = np.zeros(self.n_slots, np.bool_)
        for i, s in enumerate(self.slots):
            if s.free:
                free_mask[i] = True
                tok[i] = self._next_tok[donor]
                pos[i] = self.slots[donor].pos
            else:
                pos[i] = s.pos
                self.cache = self.backend.ensure(self.cache, i, s.pos)
        for i in active:
            r = self.slots[i].req
            if not r.output:
                r.first_token = time.perf_counter()
            r.output.append(int(tok[i]))
        return StepPlan(active=active, donor=donor, tok=tok, pos=pos,
                        free_mask=free_mask,
                        live_pages=self._live_pages(pos))

    def _decode(self, plan: StepPlan, csr=None, refresh: bool = False):
        """Device half: one batched decode step; returns (next tokens on
        the host, DRS scores (L, B, G) or None)."""
        free_mask = torch.from_numpy(plan.free_mask).to(self.device)
        view = kv_cache.decode_view(self.cache, free_mask, plan.donor)
        if csr is not None:
            csr = dsg_runtime.mirror_csr(csr, free_mask, plan.donor)
        out = api.decode_step(
            self.model, self.dsg, self.cfg,
            torch.from_numpy(plan.tok).long().to(self.device)[:, None], view,
            torch.from_numpy(plan.pos).to(self.device), plan.live_pages,
            ffn_csr=csr, collect_drs_scores=refresh)
        logits, scores = (out[0], out[2]) if refresh else (out[0], None)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        if scores is not None:
            scores = scores.float().cpu().numpy()
        return nxt, scores

    def _dispatch_dsg(self, plan: StepPlan):
        """DSG decode: a lane is due for a refresh when its emitted-token
        count is a multiple of refresh_interval — its own history only, so
        streams do not depend on co-scheduling."""
        rt = self.dsg_rt
        due = [i for i in plan.active
               if len(self.slots[i].req.output) % rt.cfg.refresh_interval
               == 0]
        self.refresh_steps += bool(due)
        nxt, scores = self._decode(plan, rt.device_csr(rt.bound()),
                                   refresh=bool(due))
        return nxt, scores, due

    def commit_step(self, plan: StepPlan, next_tok: np.ndarray,
                    seconds: float):
        """Latch each lane's next token, account the step, and retire
        finished lanes (after the EOS token has been emitted)."""
        self._next_tok = np.array(next_tok, np.int32)
        self.decode_seconds += seconds
        self.decode_tokens += len(plan.active)
        self.steps += 1
        for i in plan.active:
            slot = self.slots[i]
            slot.pos += 1
            r = slot.req
            hit_eos = r.eos_id is not None and r.output[-1] == r.eos_id
            if hit_eos or len(r.output) >= r.max_new \
                    or slot.pos >= self.max_seq:
                r.status = "ok"
                r.finished = time.perf_counter()
                self.done[r.uid] = r
                slot.req = None
                slot.pos = 0
                self.cache = self.backend.free(self.cache, i)

    def step(self):
        """One engine step: begin (host) -> decode (device) -> commit."""
        plan = self.begin_step()
        if plan is None:
            return
        t0 = time.perf_counter()
        scores = due = None
        if self.dsg_rt is not None:
            next_tok, scores, due = self._dispatch_dsg(plan)
        else:
            next_tok, _ = self._decode(plan)
        self.commit_step(plan, next_tok, time.perf_counter() - t0)
        if self.dsg_rt is not None:
            # host pattern bookkeeping follows the step: retire first, then
            # rewrite the due lanes that are still active
            for i in plan.active:
                if self.slots[i].req is None:
                    self.dsg_rt.reset_lane(i)
            if scores is not None:
                self.dsg_rt.update_from_scores(scores, due)

    # -- stats ---------------------------------------------------------------

    def decode_tok_per_s(self) -> float:
        """Emitted tokens over the time spent inside decode steps."""
        if not self.decode_tokens:
            raise ValueError("decode_tok_per_s() needs at least one decoded "
                             "token")
        return self.decode_tokens / max(self.decode_seconds, 1e-9)
