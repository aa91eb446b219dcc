"""Continuous-batching serving engine with overlap admission.

The engine keeps `n_slots` decode lanes and admits a queued prompt into any
free lane on any step.  Admission right-aligns the prompt into the
smallest length bucket that holds it (longer prompts keep their last
`bucket` tokens and are flagged `truncated`), prefills it against a fresh
1-lane dense cache, and splices the result into the engine's cache through
a backend (serving/kv_cache.py: "dense" worst-case stripes, the
reference's default, or "paged").  Each decode step emits every active
lane's pending token, grows page tables, runs one batched decode over all
lanes with per-lane positions, takes the greedy argmax, and retires lanes
on EOS-after-emit, max_new or max_seq.

`decode_chunk > 1` fuses that many decode micro-steps into one dispatch,
as the reference's `make_chunked_decode_fns` scans them inside one jitted
call: per-lane EOS / budget / max_seq freezing runs on the device, the
host emits nothing in `begin_step` and catches up in `commit_chunk`, and
lanes admit at chunk boundaries.  On CUDA a chunk is one replay of a CUDA
graph captured once per static key (serving/cuda_graphs.py); on the CPU
the same micro-step loop runs eagerly, and is the plain version the tests
hold against the reference.  `decode_chunk=1` is the eager step.

PyTorch runs eagerly, so the caches are updated in place where JAX
donates them to its jitted steps.  Sampling (temperature > 0), wave
admission and prefix sharing are not ported yet (ROADMAP.md).
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
from repro_torch.serving import cuda_graphs, dsg_runtime, kv_cache

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


def live_page_buckets(max_pages: int) -> tuple:
    """Every bound live_page_bound can return for a table width: the walk
    bounds warm_decode captures."""
    return tuple(sorted({min(1 << i, max_pages)
                         for i in range(max_pages.bit_length() + 1)}))


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
    """Host-built operands for one decode dispatch.  A fused chunk
    (chunk > 1) emits on the device, so begin_step emits nothing and
    commit_chunk lags a full chunk behind; eos_ids uses -1 for "no stop
    token"."""
    active: List[int]                 # slot indices decoding this step
    tok: np.ndarray                   # (n_slots,) int32 decode inputs
    pos: np.ndarray                   # (n_slots,) int32 write positions
    free_mask: np.ndarray             # (n_slots,) bool
    live_pages: int                   # paged walk bound (0 = dense)
    chunk: int = 1
    eos_ids: Optional[np.ndarray] = None    # (n_slots,) int32
    emit_left: Optional[np.ndarray] = None  # (n_slots,) int32 budget
    refresh: bool = False             # DSG: collect scores at the last
                                      # micro-step


def first_live(done: torch.Tensor) -> torch.Tensor:
    """(1,) index of the first lane whose done bit is clear (0 when every
    lane is done), found on the device so that nothing is read back."""
    return torch.argmin(done.to(torch.int32)).view(1)


def decode_micro_step(model, dsg, cfg, cache: kv_cache.CacheHandle,
                      tok: torch.Tensor, pos: torch.Tensor,
                      done: torch.Tensor, live_pages: int,
                      csr: Optional[dict] = None, collect: bool = False):
    """One batched decode step.  Lanes whose done bit is set mirror the
    first live lane (the donor): its token, position, page-table row and
    CSR row, so their writes are the donor's own duplicates (paged) or land
    in a stripe the next admission overwrites (dense).  Returns the next
    tokens (B,) int32, the inputs fed (tok_in, pos_in) and the DRS scores
    (L, B, G) when `collect`.  Everything stays on the device."""
    donor = first_live(done)
    tok_in = torch.where(done, tok.index_select(0, donor), tok)
    pos_in = torch.where(done, pos.index_select(0, donor), pos)
    view = kv_cache.decode_view(cache, done, donor)
    if csr is not None:
        csr = dsg_runtime.mirror_csr(csr, done, donor)
    out = api.decode_step(model, dsg, cfg, tok_in[:, None].long(), view,
                          pos_in, live_pages=live_pages or None,
                          ffn_csr=csr, collect_drs_scores=collect)
    nxt = torch.argmax(out[0], dim=-1).to(torch.int32)
    return nxt, tok_in, pos_in, (out[2] if collect else None)


def decode_chunk_body(model, dsg, cfg, cache, tok, pos, done, left,
                      eos_ids, *, chunk: int, max_seq: int, live_pages: int,
                      csr: Optional[dict] = None, refresh: bool = False):
    """`chunk` greedy decode micro-steps with the done logic on tensors:
    the greedy bodies of the reference's make_chunked_decode_fns and
    make_chunked_dsg_decode_fns.  Each micro-step re-picks the donor (the
    first live lane can finish mid-chunk); a lane freezes after emitting
    EOS, its last budgeted token or the token at max_seq - 1.  The CSR
    pattern is constant across the chunk and, with `refresh`, the last
    micro-step also returns its DRS scores.

    Returns blk (chunk, B) int32, the token each lane emitted at each
    micro-step (its decode input), flags (chunk, B) bool marking the real
    entries (a monotone prefix per lane), the final tokens (B,) (each
    lane's pending next input) and the scores (L, B, G) or None."""
    blk, flags, scores = [], [], None
    for k in range(chunk):
        collect = refresh and k == chunk - 1
        nxt, tok_in, pos_in, sc = decode_micro_step(
            model, dsg, cfg, cache, tok, pos, done, live_pages, csr, collect)
        live = ~done
        fin = live & (((eos_ids >= 0) & (tok_in == eos_ids)) | (left <= 1)
                      | (pos_in + 1 >= max_seq))
        blk.append(tok)
        flags.append(live)
        tok = torch.where(live, nxt, tok)
        pos = torch.where(live, pos_in + 1, pos)
        done = done | fin
        left = torch.where(live, left - 1, left)
        if collect:
            scores = sc
    return torch.stack(blk), torch.stack(flags), tok, scores


class ServingEngine:
    """Continuous batching over a fixed slot count on one device (the
    model's).  With the DSG serving runtime, lanes decode through per-lane
    group-CSR FFN patterns refreshed every `refresh_interval` tokens.

    Free lanes mirror the first active lane (its token, position, page-table
    row and CSR pattern): their writes land in the donor's pages as
    identical duplicates (paged) or in their own stripe (dense), and their
    outputs are never read.  The paged backend reserves a request's
    worst-case pages (min(bucket + max_new, max_seq)) at admission, so
    page-table growth never runs out; a pool too small for the next request
    defers its admission.
    """

    def __init__(self, cfg, model, dsg, *, n_slots: int = 4,
                 max_seq: int = 256, prompt_bucket: int = 64,
                 cache_backend: str = "dense", page_size: int = 16,
                 cache_tokens: Optional[int] = None, dsg_serving=None,
                 decode_chunk: int = 1):
        if decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1 (got {decode_chunk})")
        self.cfg = cfg
        self.model = model
        self.dsg = dsg
        self.device = model.embed.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.decode_chunk = decode_chunk
        self.buckets = bucket_sizes(prompt_bucket, max_seq)
        self.queue: collections.deque = collections.deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.done: Dict[int, Request] = {}
        self.steps = 0                # decode micro-steps with a live lane
        self.admissions = 0
        self.refresh_steps = 0        # dispatches that collected scores
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self._warned_truncation = False
        self.backend = kv_cache.get_backend(cache_backend,
                                            page_size=page_size,
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
            if decode_chunk > 1 and scfg.refresh_interval % decode_chunk:
                raise ValueError(
                    f"decode_chunk ({decode_chunk}) must divide the DSG "
                    f"refresh_interval ({scfg.refresh_interval}): a lane's "
                    "refresh falls due by its emitted-token count, and a due "
                    "point inside a chunk could not rewrite the CSR pattern "
                    "the chunk already runs with")
            self.dsg_rt = dsg_runtime.DSGRuntime(cfg, scfg, n_slots,
                                                 self.device)
        # a chunked engine on the card replays CUDA graphs; the staging
        # buffer holds tok, pos, done, emit_left, eos_ids and, with DSG,
        # the full-width CSR idx and counts
        self.graphs = None
        if decode_chunk > 1 and self.device.type == "cuda":
            words = 5 * n_slots
            if self.dsg_rt is not None:
                words += cfg.n_layers * n_slots * (self.dsg_rt.n_groups + 1)
            self.graphs = cuda_graphs.GraphCache(self.device, words)

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

    def _live_pages(self, pos: np.ndarray, span: int = 1) -> int:
        """Walk bound for this dispatch over the deepest lane (free lanes
        mirror an active donor, so the active maximum covers them); `span`
        widens it to a fused chunk's deepest write.  0 for the dense
        backend."""
        if self.cache.kind != "paged":
            return 0
        deepest = min(int(pos.max()) + span - 1, self.max_seq - 1)
        return live_page_bound(deepest, self.backend.page_size,
                               self.max_seq // self.backend.page_size)

    def begin_step(self) -> Optional[StepPlan]:
        """Host half of a decode step: admit queued prompts, emit each
        active lane's pending token (chunk 1), grow page tables for this
        dispatch's write positions, and build the decode operands (None
        when idle)."""
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
        c = self.decode_chunk
        eos_ids = np.full(self.n_slots, -1, np.int32)
        emit_left = np.ones(self.n_slots, np.int32)
        for i, s in enumerate(self.slots):
            if s.free:
                free_mask[i] = True
                tok[i] = self._next_tok[donor]
                pos[i] = self.slots[donor].pos
            elif c == 1:
                pos[i] = s.pos
                self.cache = self.backend.ensure(self.cache, i, s.pos)
            else:
                pos[i] = s.pos
                r = s.req
                eos_ids[i] = -1 if r.eos_id is None else r.eos_id
                emit_left[i] = r.max_new - len(r.output)
                # the chunk cannot grow the page table mid-dispatch, so
                # every page the lane can write this chunk is mapped now,
                # clamped to its budget and to max_seq (inside its
                # admission-time reservation)
                w = min(c, int(emit_left[i]), self.max_seq - s.pos)
                self.cache = self.backend.ensure_range(self.cache, i,
                                                       s.pos, s.pos + w)
        if c == 1:
            for i in active:
                r = self.slots[i].req
                if not r.output:
                    r.first_token = time.perf_counter()
                r.output.append(int(tok[i]))
            return StepPlan(active=active, tok=tok, pos=pos,
                            free_mask=free_mask,
                            live_pages=self._live_pages(pos))
        # a refresh can fall due only on a chunk's last micro-step
        # (refresh_interval % chunk == 0 and lanes admit at chunk
        # boundaries): predict it so the dispatch collects the scores.  A
        # lane that freezes on its budget or max_seq before the last
        # micro-step never reaches its due token.
        refresh = False
        if self.dsg_rt is not None:
            r_int = self.dsg_rt.cfg.refresh_interval
            refresh = any(
                (len(self.slots[i].req.output) + c) % r_int == 0
                and int(emit_left[i]) >= c
                and self.max_seq - self.slots[i].pos >= c
                for i in active)
        return StepPlan(active=active, tok=tok, pos=pos,
                        free_mask=free_mask,
                        live_pages=self._live_pages(pos, c), chunk=c,
                        eos_ids=eos_ids, emit_left=emit_left,
                        refresh=refresh)

    def _decode(self, plan: StepPlan, csr=None, refresh: bool = False):
        """Device half of an eager step: one batched decode step; returns
        (next tokens on the host, DRS scores (L, B, G) or None)."""
        dev = self.device
        nxt, _, _, scores = decode_micro_step(
            self.model, self.dsg, self.cfg, self.cache,
            torch.from_numpy(plan.tok).to(dev),
            torch.from_numpy(plan.pos).to(dev),
            torch.from_numpy(plan.free_mask).to(dev), plan.live_pages, csr,
            refresh)
        nxt = nxt.cpu().numpy()
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

    def _chunk_fn(self, operands, live_pages: int, refresh: bool):
        """The packed chunk over `operands` (tok, pos, done, emit_left,
        eos_ids [, csr idx, csr counts], int32 tensors): one int32 tensor
        holding blk, flags and the final tokens, then the scores' f32 bits
        when `refresh`."""
        tok, pos, done, left, eos_ids = operands[:5]
        csr = ({"idx": operands[5], "counts": operands[6]}
               if self.dsg_rt is not None else None)
        blk, flags, tok_f, scores = decode_chunk_body(
            self.model, self.dsg, self.cfg, self.cache, tok, pos, done != 0,
            left, eos_ids, chunk=self.decode_chunk, max_seq=self.max_seq,
            live_pages=live_pages, csr=csr, refresh=refresh)
        parts = [blk.flatten(), flags.to(torch.int32).flatten(), tok_f]
        if scores is not None:
            parts.append(scores.float().contiguous().view(torch.int32)
                         .flatten())
        return torch.cat(parts)

    def _run_chunk(self, arrays, live_pages: int, refresh: bool):
        """Run one chunk over host int32 operand arrays: on CUDA one staged
        copy, one graph replay (captured on the key's first use) and one
        read-back; on the CPU the eager micro-step loop.  Returns host
        (blk, flags, final tokens, scores or None)."""
        c, b = self.decode_chunk, self.n_slots
        if self.graphs is None:
            out = self._chunk_fn([torch.from_numpy(np.ascontiguousarray(a))
                                  for a in arrays], live_pages, refresh)
        else:
            shapes = [a.shape for a in arrays]
            key = (live_pages, shapes[5][2] if len(shapes) > 5 else 0,
                   refresh)
            self.graphs.stage(arrays)
            out = self.graphs.replay(key, lambda: self._chunk_fn(
                self.graphs.views(shapes), live_pages, refresh))
        out = out.cpu().numpy()
        blk = out[:c * b].reshape(c, b)
        flags = out[c * b:2 * c * b].reshape(c, b).astype(bool)
        tok_f = out[2 * c * b:2 * c * b + b]
        scores = None
        if refresh:
            scores = out[2 * c * b + b:].view(np.float32).reshape(
                self.cfg.n_layers, b, -1)
        return blk, flags, tok_f, scores

    def _chunk_operands(self, tok, pos, done, left, eos_ids):
        """The chunk's int32 operand arrays, with the DSG runtime's CSR
        pattern at the current bound."""
        arrays = [np.asarray(a, np.int32) for a in (tok, pos, done, left,
                                                    eos_ids)]
        rt = self.dsg_rt
        if rt is not None:
            bound = rt.bound()
            arrays += [np.ascontiguousarray(rt.idx[:, :, :bound]),
                       np.minimum(rt.counts, bound).astype(np.int32)]
        return arrays

    def _dispatch_chunk(self, plan: StepPlan):
        """Device half of a fused chunk: host (blk, flags, next tokens,
        scores or None)."""
        self.refresh_steps += plan.refresh
        return self._run_chunk(
            self._chunk_operands(plan.tok, plan.pos, plan.free_mask,
                                 plan.emit_left, plan.eos_ids),
            plan.live_pages, plan.refresh)

    def warm_decode(self):
        """Run every static variant of the fused chunk this engine can
        reach, so that on the card each is captured before a measured run:
        every live-page bucket (paged; the dense backend has one) x the
        DSG runtime's CSR bounds x refresh on and off.  Every lane is done
        and mirrors lane 0, whose writes land in the scratch page (paged)
        or in lane bytes the next admission overwrites (dense): no later
        read observes them.  An engine at decode_chunk 1 has nothing to
        warm: eager steps compile nothing."""
        if self.decode_chunk == 1:
            return
        if self.cache.kind == "paged":
            buckets = live_page_buckets(self.max_seq // self.backend.page_size)
        else:
            buckets = (0,)
        b = self.n_slots
        zeros, ones = np.zeros(b, np.int32), np.ones(b, np.int32)
        eos = np.full(b, -1, np.int32)
        bounds = (self.dsg_rt.warm_bounds() if self.dsg_rt is not None
                  else (None,))
        for live in buckets:
            for bound in bounds:
                arrays = [zeros, zeros, ones, ones, eos]
                if bound is not None:
                    n_l = self.cfg.n_layers
                    arrays += [np.zeros((n_l, b, bound), np.int32),
                               np.ones((n_l, b), np.int32)]
                for refresh in ((False, True) if bound is not None
                                else (False,)):
                    self._run_chunk(arrays, live, refresh)

    def commit_step(self, plan: StepPlan, next_tok: np.ndarray,
                    seconds: float):
        """Latch each lane's next token, account the step, and retire
        finished lanes (after the EOS token has been emitted)."""
        self._next_tok = np.array(next_tok, np.int32)
        self.decode_seconds += seconds
        self.decode_tokens += len(plan.active)
        self.steps += 1
        for i in plan.active:
            self.slots[i].pos += 1
        self._retire(plan.active)

    def commit_chunk(self, plan: StepPlan, blk: np.ndarray,
                     flags: np.ndarray, next_tok: np.ndarray,
                     seconds: float, scores=None):
        """Record a fused chunk: append each lane's emitted tokens (a lane's
        flag column is a monotone prefix), latch the pending next tokens,
        count the micro-steps that had a live lane, and retire finished
        lanes.  Retirement re-derives the device's freeze conditions from
        the appended output (EOS == output[-1], len(output) >= max_new,
        pos >= max_seq)."""
        emitted = 0
        for i in plan.active:
            slot = self.slots[i]
            n = int(flags[:, i].sum())
            if n and not slot.req.output:
                # stamped when the host sees the token: the honest first
                # token time of a fused loop
                slot.req.first_token = time.perf_counter()
            slot.req.output.extend(int(t) for t in blk[:n, i])
            slot.pos += n
            emitted += n
        self._next_tok = np.array(next_tok, np.int32)
        self.decode_seconds += seconds
        self.decode_tokens += emitted
        self.steps += int(flags.any(axis=1).sum())
        retired = self._retire(plan.active)
        rt = self.dsg_rt
        if rt is not None:
            for i in retired:
                rt.reset_lane(i)
            if scores is not None:
                r_int = rt.cfg.refresh_interval
                due = [i for i in plan.active
                       if self.slots[i].req is not None
                       and len(self.slots[i].req.output) % r_int == 0]
                rt.update_from_scores(scores, due)

    def _retire(self, lanes) -> List[int]:
        """Retire the lanes whose request is finished; returns them."""
        retired = []
        for i in lanes:
            slot = self.slots[i]
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
                retired.append(i)
        return retired

    def step(self):
        """One engine step: begin (host) -> decode (device) -> commit."""
        plan = self.begin_step()
        if plan is None:
            return
        t0 = time.perf_counter()
        if plan.chunk > 1:
            blk, flags, tok_f, scores = self._dispatch_chunk(plan)
            self.commit_chunk(plan, blk, flags, tok_f,
                              time.perf_counter() - t0, scores=scores)
            return
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
