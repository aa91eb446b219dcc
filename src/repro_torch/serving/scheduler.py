"""Continuous-batching serving engine.

The engine keeps `n_slots` decode lanes and admits queued prompts into free
lanes: on any step (`admission="overlap"`) or only once every lane has
drained (`"wave"`, the baseline).  Admission right-aligns the prompt into
the smallest length bucket that holds it (longer prompts keep their last
`bucket` tokens and are flagged `truncated`), prefills it against a fresh
1-lane dense cache, and splices the result into the engine's cache through
a backend (serving/kv_cache.py: "dense" worst-case stripes, the
reference's default, or "paged", optionally with copy-on-write prefix
sharing).  Each decode step emits every active lane's pending token, grows
page tables for this dispatch's writes, runs one batched decode over all
lanes with per-lane positions, picks each lane's next token (the argmax
at temperature 0, else a nucleus sample) and retires lanes on
EOS-after-emit, max_new or max_seq.  A request whose `deadline_s` lapses
while it is queued retires `timed_out` at the admission boundary.

`decode_chunk > 1` fuses that many decode micro-steps into one dispatch,
as the reference's `make_chunked_decode_fns` scans them inside one jitted
call: per-lane EOS / budget / max_seq freezing runs on the device, the
host emits nothing in `begin_step` and catches up in `commit_chunk`, and
lanes admit at chunk boundaries.  On CUDA a chunk is one replay of a CUDA
graph captured once per static key (serving/cuda_graphs.py); on the CPU
the same micro-step loop runs eagerly, and is the plain version the tests
hold against the reference.  `decode_chunk=1` is the eager step.

Sampling draws its Gumbel noise from a stateless counter-based hash
(`gumbel_noise`) of (engine seed, the request's admission draw, the index
of the token being drawn) in integer tensor ops, the same on the CPU and
on the card and safe inside a graph, where the draw and the token index
are staged operands.  A sampled stream therefore depends on the seed and
the admission order alone, not on the chunk, the lane or the co-resident
lanes; the reference keys its PRNG by (seed, engine step, lane) instead.
The first token, drawn from the prefill's logits at admission, hashes
(seed ^ a salt, draw).

PyTorch runs eagerly, so the caches are updated in place where JAX
donates them to its jitted steps.
"""
from __future__ import annotations

import collections
import time
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import api
from repro_torch.serving import cuda_graphs, dsg_runtime, kv_cache

DEFAULT_BUCKETS = (16, 32, 64, 96, 128, 192, 256)


def bucket_sizes(prompt_bucket: int, max_seq: int,
                 buckets: Optional[Sequence[int]] = None) -> tuple:
    """The prompt buckets an engine uses: the candidate sizes (the default
    ones unless given) capped at prompt_bucket and at max_seq - 1 (a
    prompt filling every position would leave no decode headroom)."""
    cap = min(prompt_bucket, max_seq - 1)
    bs = buckets if buckets is not None else DEFAULT_BUCKETS
    return tuple(sorted({min(b, cap) for b in bs}))


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


_ADMIT_SALT = 0xADA117   # keeps the admission draws off the decode stream

#: Terminal request states: "ok" at retirement, "timed_out" for a deadline
#: that lapsed in a queue, "failed" for a request the router's fault
#: tolerance gave up on (serving/router.py).
REQUEST_STATUSES = ("pending", "ok", "failed", "timed_out")


class EngineAborted(RuntimeError):
    """Raised by `begin_step` of an engine whose `abort` flag was set (the
    router's stall-timeout containment): the engine abandons its step at
    the boundary, and the caller reclaims its requests (`reset`)."""


@dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (P,) int32
    max_new: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0         # 0 -> greedy argmax
    top_p: float = 1.0               # nucleus mass kept when sampling
    deadline_s: Optional[float] = None   # max submit -> admission wait
    # filled by the engine (time.perf_counter() stamps):
    output: List[int] = field(default_factory=list)
    truncated: bool = False
    submitted: float = 0.0
    started: float = 0.0
    first_token: float = 0.0
    finished: float = 0.0
    status: str = "pending"          # one of REQUEST_STATUSES
    retries: int = 0                 # failover re-dispatches consumed

    def __post_init__(self):
        if not self.temperature >= 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if not 0 <= self.top_p <= 1:
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")


@dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                      # next write position in the cache
    draw: int = 0                     # the request's admission draw

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
    temps: np.ndarray                 # (n_slots,) float32, 0 = greedy
    top_ps: np.ndarray                # (n_slots,) float32
    draws: np.ndarray                 # (n_slots,) int32 admission draws
    nth: np.ndarray                   # (n_slots,) int32 index in the
                                      # output of the token the (first
                                      # micro-)step draws
    sample: bool                      # any lane with temperature > 0
    chunk: int = 1
    eos_ids: Optional[np.ndarray] = None    # (n_slots,) int32
    emit_left: Optional[np.ndarray] = None  # (n_slots,) int32 budget
    refresh: bool = False             # DSG: collect scores at the last
                                      # micro-step


_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) (a python int or an int64 tensor),
    in 16-bit halves of c so that no product reaches 2^63."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finaliser (lowbias32) of x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: int, stream: torch.Tensor, counter: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel noise (B, vocab) f32 from a stateless counter-based
    hash of (seed, stream[b], counter[b], token id): integer tensor ops
    that give the same bits on the CPU and on the card and read nothing
    back, so a CUDA graph can draw it with stream and counter staged.
    Each hash's top 24 bits give u in (0, 1), and the noise is
    -log(-log(u))."""
    k = _mix32(torch.full_like(stream, _mix32(seed & _M32), dtype=torch.long)
               ^ stream.long())
    k = _mix32(k ^ (counter.long() & _M32))
    v = _mix32(torch.arange(vocab, device=stream.device, dtype=torch.long)
               ^ 0x9E3779B9)
    h = _mix32(k[:, None] ^ v[None, :])
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, gumbel: torch.Tensor,
                  temps: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Per-lane temperature and nucleus sampling: logits (B, V), gumbel
    (B, V) f32 noise, temps / top_ps (B,) -> (B,) int32.  Lanes at
    temperature 0 take the argmax; the rest sample, as argmax(noise +
    logits / T), from the smallest prefix of the sorted distribution whose
    mass reaches top_p (the crossing token is kept, so the top token always
    survives).  The reference draws jax.random.categorical, which is the
    same argmax over its own Gumbel noise."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / temps.float().clamp_min(1e-6)[:, None]
    srt = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_ps.float()[:, None]
    keep[:, 0] = True
    kth = torch.where(keep, srt, torch.inf).amin(dim=-1, keepdim=True)
    lg = torch.where(lg >= kth, lg, -torch.inf)
    samp = torch.argmax(gumbel + lg, dim=-1).to(torch.int32)
    return torch.where(temps > 0, samp, greedy)


class Sampling(NamedTuple):
    """A dispatch's sampling operands: the engine seed and, per lane, the
    admission draw, the output index of the token its first micro-step
    draws, the temperature and the top_p (device tensors)."""
    seed: int
    draws: torch.Tensor
    nth: torch.Tensor
    temps: torch.Tensor
    top_ps: torch.Tensor


def next_tokens(logits: torch.Tensor, sampling: Optional[Sampling],
                k: int = 0) -> torch.Tensor:
    """The next token of every lane: the argmax without `sampling`, else
    `sample_tokens` on the noise of micro-step k."""
    if sampling is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    noise = gumbel_noise(sampling.seed, sampling.draws, sampling.nth + k,
                         logits.shape[-1])
    return sample_tokens(logits, noise, sampling.temps, sampling.top_ps)


def first_live(done: torch.Tensor) -> torch.Tensor:
    """(1,) index of the first lane whose done bit is clear (0 when every
    lane is done), found on the device so that nothing is read back."""
    return torch.argmin(done.to(torch.int32)).view(1)


def decode_micro_step(model, dsg, cfg, cache: kv_cache.CacheHandle,
                      tok: torch.Tensor, pos: torch.Tensor,
                      done: torch.Tensor, live_pages: int,
                      csr: Optional[dict] = None, collect: bool = False,
                      sampling: Optional[Sampling] = None, k: int = 0):
    """One batched decode step.  Lanes whose done bit is set mirror the
    first live lane (the donor): its token, position, page-table row and
    CSR row, so their writes are the donor's own duplicates (paged) or land
    in a stripe the next admission overwrites (dense).  Returns the next
    tokens (B,) int32 (sampled with `sampling` as micro-step k), the inputs
    fed (tok_in, pos_in) and the DRS scores (L, B, G) when `collect`.
    Everything stays on the device."""
    donor = first_live(done)
    tok_in = torch.where(done, tok.index_select(0, donor), tok)
    pos_in = torch.where(done, pos.index_select(0, donor), pos)
    view = kv_cache.decode_view(cache, done, donor)
    if csr is not None:
        csr = dsg_runtime.mirror_csr(csr, done, donor)
    out = api.decode_step(model, dsg, cfg, tok_in[:, None].long(), view,
                          pos_in, live_pages=live_pages or None,
                          ffn_csr=csr, collect_drs_scores=collect)
    nxt = next_tokens(out[0], sampling, k)
    return nxt, tok_in, pos_in, (out[2] if collect else None)


def decode_chunk_body(model, dsg, cfg, cache, tok, pos, done, left,
                      eos_ids, *, chunk: int, max_seq: int, live_pages: int,
                      csr: Optional[dict] = None, refresh: bool = False,
                      sampling: Optional[Sampling] = None):
    """`chunk` decode micro-steps with the done logic on tensors: the
    bodies of the reference's make_chunked_decode_fns and
    make_chunked_dsg_decode_fns.  Each micro-step re-picks the donor (the
    first live lane can finish mid-chunk); a lane freezes after emitting
    EOS, its last budgeted token or the token at max_seq - 1.  The CSR
    pattern is constant across the chunk and, with `refresh`, the last
    micro-step also returns its DRS scores.  With `sampling`, micro-step k
    draws each lane's token at output index nth + k.

    Returns blk (chunk, B) int32, the token each lane emitted at each
    micro-step (its decode input), flags (chunk, B) bool marking the real
    entries (a monotone prefix per lane), the final tokens (B,) (each
    lane's pending next input) and the scores (L, B, G) or None."""
    blk, flags, scores = [], [], None
    for k in range(chunk):
        collect = refresh and k == chunk - 1
        nxt, tok_in, pos_in, sc = decode_micro_step(
            model, dsg, cfg, cache, tok, pos, done, live_pages, csr, collect,
            sampling, k)
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

    With `prefix_sharing` (paged only), admission hashes the bucketed
    prompt row into a prefix chain and maps the resident pages it shares
    with earlier prompts; when every prompt page is resident and the
    prompt's prefill outputs are in a small LRU, the prefill is skipped.
    """

    def __init__(self, cfg, model, dsg, *, n_slots: int = 4,
                 max_seq: int = 256, prompt_bucket: int = 64,
                 buckets: Optional[Sequence[int]] = None,
                 admission: str = "overlap", cache_backend: str = "dense",
                 page_size: int = 16, cache_tokens: Optional[int] = None,
                 seed: int = 0, dsg_serving=None, decode_chunk: int = 1,
                 prefix_sharing: bool = False):
        if cfg.family not in api.DECODER_FAMILIES:
            raise NotImplementedError(
                f"ServingEngine serves the decoder families "
                f"{api.DECODER_FAMILIES}, not {cfg.family!r}: the "
                f"reference's engine crashes on the recurrent and "
                f"encoder-decoder families (ROADMAP.md §3); the recurrent "
                f"ones serve through repro_torch.launch.serve.generate, "
                f"the encoder-decoder through the api verbs")
        if admission not in ("overlap", "wave"):
            raise ValueError(f"unknown admission policy {admission!r}")
        if decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1 (got {decode_chunk})")
        self.cfg = cfg
        self.model = model
        self.dsg = dsg
        self.device = model.embed.device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.decode_chunk = decode_chunk
        self.admission = admission
        self.seed = int(seed)
        self.buckets = bucket_sizes(prompt_bucket, max_seq, buckets)
        self.queue: collections.deque = collections.deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.done: Dict[int, Request] = {}
        self.steps = 0                # decode micro-steps with a live lane
        self.admissions = 0
        self.refresh_steps = 0        # dispatches that collected scores
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        self._draws = 0               # admission counter: a request's draw
        self._warned_truncation = False
        # set by another thread to make the next begin_step raise
        # EngineAborted; cleared by that raise and by reset()
        self.abort = False
        self.replica_index = 0        # set by the Router (attribution)
        self.fault_injector = None    # ServingFaultInjector (chaos runs)
        self.backend = kv_cache.get_backend(cache_backend,
                                            page_size=page_size,
                                            total_tokens=cache_tokens,
                                            prefix_sharing=prefix_sharing)
        self.prefix_sharing = bool(prefix_sharing)
        # LRU of full-prompt prefill outputs keyed by the chain's last key:
        # (last-token logits, DRS scores or None)
        self._prefill_cache: collections.OrderedDict = \
            collections.OrderedDict()
        self._prefill_cache_cap = 128
        self.prefill_cache_hits = 0
        self.cache = self.backend.make(cfg, n_slots, max_seq, self.device)
        self._next_tok = np.zeros(n_slots, np.int32)

        scfg = dsg_runtime.as_serving_config(dsg_serving)
        self.dsg_rt = None
        if scfg is not None:
            if dsg is None or not cfg.dsg.enabled:
                raise ValueError("dsg_serving needs DSG state: "
                                 "cfg.dsg.enabled and a non-None dsg")
            if cfg.is_moe or cfg.act != "swiglu":
                raise ValueError(
                    "dsg_serving targets the dense SwiGLU FFN family "
                    f"(got act={cfg.act!r}, moe_experts={cfg.moe_experts})")
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
        # buffer holds tok, pos, done, emit_left, eos_ids, nth, draws, the
        # temperatures' and top_ps' f32 bits and, with DSG, the full-width
        # CSR idx and counts
        self.graphs = None
        if decode_chunk > 1 and self.device.type == "cuda":
            words = 9 * n_slots
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

    def drain(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Run until every queued request is admitted, decoded and retired
        (no new submissions assumed)."""
        return self.run(max_steps=max_steps)

    # -- introspection --------------------------------------------------------

    def queue_depth(self) -> int:
        """Requests submitted but not yet admitted to a lane."""
        return len(self.queue)

    def free_slots(self) -> int:
        """Decode lanes without a resident request."""
        return sum(s.free for s in self.slots)

    def busy_slots(self) -> int:
        return self.n_slots - self.free_slots()

    def free_pages(self) -> int:
        """Unreserved free pages of the paged backend's allocator.  A dense
        engine's free lanes each own a max_seq stripe, counted in pages of
        `page_size` so that the number compares across backends."""
        if self.cache.kind == "paged":
            return (self.backend.allocator.free_pages
                    - int(self.backend._resv.sum()))
        return self.free_slots() * (self.max_seq // max(self.page_size, 1))

    def _admit_chain(self, req: Request):
        """(prefix chain, prompt bucket) that admitting `req` would use;
        the chain is None with sharing off."""
        pb = self._bucket_for(len(req.prompt))
        if not self.prefix_sharing:
            return None, pb
        return kv_cache.prefix_chain(self._padded(req, pb),
                                     self.page_size), pb

    def pages_needed(self, req: Request) -> int:
        """The worst-case page reservation admitting `req` would take now
        (min(bucket + max_new, max_seq) tokens), crediting resident prompt
        pages and charging the partial tail's copy with sharing on."""
        chain, pb = self._admit_chain(req)
        need = min(pb + req.max_new, self.max_seq)
        if self.cache.kind == "paged":
            pages = self.backend.pages_for(need)
            if chain is not None:
                pages += self.backend.sharing_adjustment(chain, pb)
            return max(pages, 0)
        return -(-need // max(self.page_size, 1))

    def can_admit_request(self, req: Request) -> bool:
        """True when `req`, submitted now to an empty queue, would be
        admitted by the next step: a lane is free and the backend covers
        its reservation."""
        chain, pb = self._admit_chain(req)
        need = min(pb + req.max_new, self.max_seq)
        return self.free_slots() > 0 and self.backend.can_admit(
            need, chain=chain, prompt_tokens=pb)

    # -- engine internals ---------------------------------------------------

    def _bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        return self.buckets[-1]

    @staticmethod
    def _padded(req: Request, pb: int) -> np.ndarray:
        """The prompt right-aligned into a row of `pb` tokens (its last pb
        tokens when longer)."""
        toks = np.zeros(pb, np.int32)
        pr = req.prompt[-pb:]
        toks[pb - len(pr):] = pr
        return toks

    def _remember_prefill(self, key: bytes, logits, scores) -> None:
        """Keep a full-prompt prefill's outputs (last-token logits, DRS
        scores) under the prompt chain's last key, LRU-bounded.  An entry
        is replayed only while every prompt page is resident, and the same
        padded tokens through the same prefill give the same outputs, so
        a replay changes no stream."""
        self._prefill_cache[key] = (logits, scores)
        self._prefill_cache.move_to_end(key)
        while len(self._prefill_cache) > self._prefill_cache_cap:
            self._prefill_cache.popitem(last=False)

    def _expire_queued(self) -> None:
        """Retire the queue's head requests whose deadline lapsed while
        they waited, as timed_out."""
        while self.queue:
            req = self.queue[0]
            if (req.deadline_s is None
                    or time.perf_counter() - req.submitted <= req.deadline_s):
                return
            self.queue.popleft()
            req.status = "timed_out"
            req.finished = time.perf_counter()
            self.done[req.uid] = req

    def _first_token(self, logits: torch.Tensor, req: Request) -> int:
        """The request's first token from its prefill logits (V,): the
        argmax, or a sample on the admission noise of its draw."""
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        lane = torch.full((1,), self._draws, dtype=torch.long,
                          device=logits.device)
        noise = gumbel_noise(self.seed ^ _ADMIT_SALT, lane,
                             torch.zeros_like(lane), logits.shape[-1])
        f32 = dict(dtype=torch.float32, device=logits.device)
        return int(sample_tokens(logits[None], noise,
                                 torch.tensor([req.temperature], **f32),
                                 torch.tensor([req.top_p], **f32))[0])

    def _admit(self):
        """Admit queued prompts into free lanes.  Overlap admission fills
        every free lane whose worst-case reservation the pool covers; wave
        admission waits until every lane has drained."""
        if self.admission == "wave" and any(not s.free for s in self.slots):
            return
        for i, slot in enumerate(self.slots):
            if not slot.free:
                continue
            self._expire_queued()
            if not self.queue:
                break
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
            toks = self._padded(req, pb)
            # the chain keys the bucketed row, padding included: page bytes
            # are a function of the padded prefix
            chain = (kv_cache.prefix_chain(toks, self.page_size)
                     if self.prefix_sharing else None)
            if not self.backend.can_admit(need, chain=chain,
                                          prompt_tokens=pb):
                break            # retirements will free pages; retry later
            self.queue.popleft()
            cached = None
            if chain is not None \
                    and self.backend.shared_hits(chain) == len(chain):
                cached = self._prefill_cache.get(chain[-1])
            lane = None
            if cached is not None:
                self._prefill_cache.move_to_end(chain[-1])
                self.prefill_cache_hits += 1
                logits, sc = cached
                if self.dsg_rt is not None:
                    self.dsg_rt.set_lane_from_scores(i, sc)
            else:
                toks_dev = torch.from_numpy(toks[None]).long().to(self.device)
                lane = api.make_cache(self.cfg, 1, self.max_seq,
                                      device=self.device)
                sc = None
                if self.dsg_rt is not None:
                    logits, lane, sc_all = api.prefill(
                        self.model, self.dsg, self.cfg, {"tokens": toks_dev},
                        lane, collect_drs_scores=True)
                    # the lane decodes sparsely from its first step
                    sc = sc_all[:, 0].float().cpu().numpy()
                    self.dsg_rt.set_lane_from_scores(i, sc)
                else:
                    logits, lane = api.prefill(self.model, self.dsg, self.cfg,
                                               {"tokens": toks_dev}, lane)
                logits = logits[0]
                if chain is not None:
                    self._remember_prefill(chain[-1], logits, sc)
            self.cache = self.backend.write(self.cache, lane, i,
                                            n_tokens=pb, reserve_tokens=need,
                                            chain=chain)
            # every admission advances the draw, greedy or not, so a
            # request's noise does not depend on the temperatures before it
            self._draws += 1
            self.admissions += 1
            req.started = time.perf_counter()
            slot.req = req
            slot.pos = pb
            slot.draw = self._draws
            self._next_tok[i] = self._first_token(logits, req)

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
        when idle).  Raises EngineAborted, once, when `abort` is set; then
        gives the fault injector, if any, its step boundary."""
        if self.abort:
            # cleared here, so that a restarted replica does not abort
            # again at once; reset() clears it too
            self.abort = False
            raise EngineAborted(
                f"replica {self.replica_index} aborted at step boundary "
                f"(stall-timeout containment)")
        if self.fault_injector is not None:
            # chaos hook: kill raises here, before this step's tokens land;
            # delay sleeps inside the step; poison corrupts the resident
            # outputs, then raises (runtime/fault_tolerance.py)
            self.fault_injector.on_step(self)
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
        b = self.n_slots
        pos = np.empty(b, np.int32)
        free_mask = np.zeros(b, np.bool_)
        temps = np.zeros(b, np.float32)
        top_ps = np.ones(b, np.float32)
        draws = np.zeros(b, np.int32)
        nth = np.zeros(b, np.int32)
        c = self.decode_chunk
        eos_ids = np.full(b, -1, np.int32)
        emit_left = np.ones(b, np.int32)
        for i, s in enumerate(self.slots):
            if s.free:
                free_mask[i] = True
                tok[i] = self._next_tok[donor]
                pos[i] = self.slots[donor].pos
                continue
            r = s.req
            pos[i] = s.pos
            temps[i], top_ps[i] = r.temperature, r.top_p
            draws[i] = s.draw
            # the output index of the token this dispatch draws first: the
            # pending token is emitted (now at chunk 1, on the device in a
            # chunk) before the next is drawn
            nth[i] = len(r.output) + 1
            if c == 1:
                self.cache = self.backend.ensure(self.cache, i, s.pos)
            else:
                eos_ids[i] = -1 if r.eos_id is None else r.eos_id
                emit_left[i] = r.max_new - len(r.output)
                # the chunk cannot grow the page table mid-dispatch, so
                # every page the lane can write this chunk is mapped (and
                # copied-on-write) now, clamped to its budget and to
                # max_seq (inside its admission-time reservation)
                w = min(c, int(emit_left[i]), self.max_seq - s.pos)
                self.cache = self.backend.ensure_range(self.cache, i,
                                                       s.pos, s.pos + w)
        sampling = dict(temps=temps, top_ps=top_ps, draws=draws, nth=nth,
                        sample=bool((temps > 0).any()))
        if c == 1:
            for i in active:
                r = self.slots[i].req
                if not r.output:
                    r.first_token = time.perf_counter()
                r.output.append(int(tok[i]))
            return StepPlan(active=active, tok=tok, pos=pos,
                            free_mask=free_mask,
                            live_pages=self._live_pages(pos), **sampling)
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
                        live_pages=self._live_pages(pos, c), **sampling,
                        chunk=c, eos_ids=eos_ids, emit_left=emit_left,
                        refresh=refresh)

    def _sampling(self, plan: StepPlan) -> Optional[Sampling]:
        """The plan's sampling operands on the device (None when every lane
        is greedy)."""
        if not plan.sample:
            return None
        dev = self.device
        return Sampling(self.seed, torch.from_numpy(plan.draws).to(dev),
                        torch.from_numpy(plan.nth).to(dev),
                        torch.from_numpy(plan.temps).to(dev),
                        torch.from_numpy(plan.top_ps).to(dev))

    def _decode(self, plan: StepPlan, csr=None, refresh: bool = False):
        """Device half of an eager step: one batched decode step; returns
        (next tokens on the host, DRS scores (L, B, G) or None)."""
        dev = self.device
        nxt, _, _, scores = decode_micro_step(
            self.model, self.dsg, self.cfg, self.cache,
            torch.from_numpy(plan.tok).to(dev),
            torch.from_numpy(plan.pos).to(dev),
            torch.from_numpy(plan.free_mask).to(dev), plan.live_pages, csr,
            refresh, self._sampling(plan))
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
        bound = rt.bound()
        rt.record_step(plan.active, bound)
        nxt, scores = self._decode(plan, rt.device_csr(bound),
                                   refresh=bool(due))
        return nxt, scores, due

    def _chunk_fn(self, operands, live_pages: int, refresh: bool,
                  sample: bool):
        """The packed chunk over `operands` (tok, pos, done, emit_left,
        eos_ids, nth, draws, temperature bits, top_p bits [, csr idx, csr
        counts], int32 tensors): one int32 tensor holding blk, flags and
        the final tokens, then the scores' f32 bits when `refresh`."""
        tok, pos, done, left, eos_ids, nth, draws, temps, top_ps = \
            operands[:9]
        csr = ({"idx": operands[9], "counts": operands[10]}
               if self.dsg_rt is not None else None)
        sampling = (Sampling(self.seed, draws, nth, temps.view(torch.float32),
                             top_ps.view(torch.float32)) if sample else None)
        blk, flags, tok_f, scores = decode_chunk_body(
            self.model, self.dsg, self.cfg, self.cache, tok, pos, done != 0,
            left, eos_ids, chunk=self.decode_chunk, max_seq=self.max_seq,
            live_pages=live_pages, csr=csr, refresh=refresh,
            sampling=sampling)
        parts = [blk.flatten(), flags.to(torch.int32).flatten(), tok_f]
        if scores is not None:
            parts.append(scores.float().contiguous().view(torch.int32)
                         .flatten())
        return torch.cat(parts)

    def _run_chunk(self, arrays, live_pages: int, refresh: bool,
                   sample: bool):
        """Run one chunk over host int32 operand arrays: on CUDA one staged
        copy, one graph replay (captured on the key's first use) and one
        read-back; on the CPU, or for an engine whose graphs a sharded
        executor dropped, the eager micro-step loop.  Returns host
        (blk, flags, final tokens, scores or None)."""
        c, b = self.decode_chunk, self.n_slots
        if self.graphs is None:
            out = self._chunk_fn([torch.from_numpy(np.ascontiguousarray(a))
                                  .to(self.device) for a in arrays],
                                 live_pages, refresh, sample)
        else:
            shapes = [a.shape for a in arrays]
            key = (live_pages, shapes[9][2] if len(shapes) > 9 else 0,
                   refresh, sample)
            self.graphs.stage(arrays)
            out = self.graphs.replay(key, lambda: self._chunk_fn(
                self.graphs.views(shapes), live_pages, refresh, sample))
        out = out.cpu().numpy()
        blk = out[:c * b].reshape(c, b)
        flags = out[c * b:2 * c * b].reshape(c, b).astype(bool)
        tok_f = out[2 * c * b:2 * c * b + b]
        scores = None
        if refresh:
            scores = out[2 * c * b + b:].view(np.float32).reshape(
                self.cfg.n_layers, b, -1)
        return blk, flags, tok_f, scores

    def _chunk_operands(self, plan: StepPlan):
        """The chunk's int32 operand arrays, with the DSG runtime's CSR
        pattern at the current bound.  A chunk-1 plan
        (the sharded executor runs it as a chunk of one) stops at no
        token and has a budget of one."""
        b = self.n_slots
        left = (plan.emit_left if plan.emit_left is not None
                else np.ones(b, np.int32))
        eos = (plan.eos_ids if plan.eos_ids is not None
               else np.full(b, -1, np.int32))
        arrays = [np.asarray(a, np.int32) for a in (
            plan.tok, plan.pos, plan.free_mask, left, eos, plan.nth,
            plan.draws)]
        arrays += [np.asarray(plan.temps, np.float32).view(np.int32),
                   np.asarray(plan.top_ps, np.float32).view(np.int32)]
        rt = self.dsg_rt
        if rt is not None:
            bound = rt.bound()
            arrays += [np.ascontiguousarray(rt.idx[:, :, :bound]),
                       np.minimum(rt.counts, bound).astype(np.int32)]
        return arrays

    def _dispatch_chunk(self, plan: StepPlan):
        """Device half of a fused chunk: host (blk, flags, next tokens,
        scores or None) and the CSR bound it ran at (None without DSG)."""
        self.refresh_steps += plan.refresh
        bound = self.dsg_rt.bound() if self.dsg_rt is not None else None
        return (*self._run_chunk(self._chunk_operands(plan), plan.live_pages,
                                 plan.refresh, plan.sample), bound)

    def warm_decode(self, sample: bool = False):
        """Run every static variant of the fused chunk this engine can
        reach, so that on the card each is captured before a measured run:
        every live-page bucket (paged; the dense backend has one) x the
        DSG runtime's CSR bounds x refresh on and off x, with `sample`,
        greedy and sampling.  Every lane is done and mirrors lane 0, whose
        writes land in the scratch page (paged) or in lane bytes the next
        admission overwrites (dense): no later read observes them.  An
        engine at decode_chunk 1 has nothing to warm: eager steps compile
        nothing."""
        if self.decode_chunk == 1:
            return
        if self.cache.kind == "paged":
            buckets = live_page_buckets(self.max_seq // self.backend.page_size)
        else:
            buckets = (0,)
        b = self.n_slots
        zeros, ones = np.zeros(b, np.int32), np.ones(b, np.int32)
        plan = StepPlan(
            active=[], tok=zeros, pos=zeros, free_mask=ones, live_pages=0,
            temps=np.full(b, 0.5, np.float32), top_ps=np.ones(b, np.float32),
            draws=zeros, nth=ones, sample=False, chunk=self.decode_chunk,
            eos_ids=np.full(b, -1, np.int32), emit_left=ones)
        arrays = self._chunk_operands(plan)[:9]
        bounds = (self.dsg_rt.warm_bounds() if self.dsg_rt is not None
                  else (None,))
        for live in buckets:
            for bound in bounds:
                ops = list(arrays)
                if bound is not None:
                    n_l = self.cfg.n_layers
                    ops += [np.zeros((n_l, b, bound), np.int32),
                            np.ones((n_l, b), np.int32)]
                for refresh in ((False, True) if bound is not None
                                else (False,)):
                    for samp in ((False, True) if sample else (False,)):
                        self._run_chunk(ops, live, refresh, samp)

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
                     seconds: float, scores=None, bound=None):
        """Record a fused chunk: append each lane's emitted tokens (a lane's
        flag column is a monotone prefix), latch the pending next tokens,
        count the micro-steps that had a live lane, and retire finished
        lanes.  Retirement re-derives the device's freeze conditions from
        the appended output (EOS == output[-1], len(output) >= max_new,
        pos >= max_seq).  With the DSG runtime and the chunk's CSR
        `bound`, each micro-step that had a live lane is one FLOP-model
        entry over the lanes live at it, as a chunk-1 run logs it."""
        rt = self.dsg_rt
        if rt is not None and bound is not None:
            for k in range(flags.shape[0]):
                live = [i for i in plan.active if flags[k, i]]
                if live:
                    rt.record_step(live, bound)
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
            blk, flags, tok_f, scores, bound = self._dispatch_chunk(plan)
            self.commit_chunk(plan, blk, flags, tok_f,
                              time.perf_counter() - t0, scores=scores,
                              bound=bound)
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

    # -- eviction -------------------------------------------------------------

    def evict_slot(self, i: int) -> Optional[Request]:
        """Release lane `i` mid-flight and return its request (None when the
        lane is free): its pages return to the pool and its DSG pattern
        resets, as at retirement, but the request does not land in `done`
        and keeps its partial output."""
        slot = self.slots[i]
        req = slot.req
        if req is None:
            return None
        slot.req = None
        slot.pos = 0
        self.cache = self.backend.free(self.cache, i)
        if self.dsg_rt is not None:
            self.dsg_rt.reset_lane(i)
        return req

    def evict_request(self, uid: int) -> Optional[Request]:
        """Evict request `uid` from its lane or from the queue; None when it
        is not on this engine."""
        for i, slot in enumerate(self.slots):
            if slot.req is not None and slot.req.uid == uid:
                return self.evict_slot(i)
        for req in self.queue:
            if req.uid == uid:
                self.queue.remove(req)
                return req
        return None

    def reset(self) -> List[Request]:
        """Reclaim every resident and queued request, in admission order
        (resident lanes by slot, then the queue), and clear `abort`.
        `done` is kept, and so is everything built (caches, graphs)."""
        reclaimed = []
        for i in range(self.n_slots):
            req = self.evict_slot(i)
            if req is not None:
                reclaimed.append(req)
        reclaimed.extend(self.queue)
        self.queue.clear()
        self._next_tok[:] = 0
        self.abort = False
        return reclaimed

    # -- stats ---------------------------------------------------------------

    def throughput(self) -> float:
        """Tokens per second over the span from the first admission to the
        last finish; raises before any request has finished."""
        if not self.done:
            raise ValueError(
                "throughput() needs at least one finished request; run the "
                "engine (or drain()) before reading stats")
        toks = sum(len(r.output) for r in self.done.values())
        t0 = min(r.started or r.submitted for r in self.done.values())
        t1 = max(r.finished for r in self.done.values())
        return toks / max(t1 - t0, 1e-9)

    def decode_tok_per_s(self) -> float:
        """Emitted tokens over the time spent inside decode steps."""
        if not self.decode_tokens:
            raise ValueError("decode_tok_per_s() needs at least one decoded "
                             "token; run the engine before reading stats")
        return self.decode_tokens / max(self.decode_seconds, 1e-9)

    def latencies(self) -> np.ndarray:
        """Per-request completion latency (submit -> finish) in seconds."""
        return np.array(sorted(r.finished - r.submitted
                               for r in self.done.values()))
