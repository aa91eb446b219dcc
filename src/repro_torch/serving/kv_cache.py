"""KV-cache backends behind a `CacheHandle`: dense and paged.

    backend = get_backend("paged", page_size=16, total_tokens=512)
    handle  = backend.make(cfg, n_slots, max_seq, device)
    handle  = backend.write(handle, lane_kv, slot, n_tokens=pb,
                            reserve_tokens=need)      # admission splice
    handle  = backend.ensure(handle, slot, pos)     # growth while decoding
    handle  = backend.ensure_range(handle, slot, start, stop)  # a chunk
    handle  = backend.free(handle, slot)            # retirement

Layouts:

    dense : k / v (L, n_slots, max_seq, Kv, D); each lane owns its stripe
    paged : pages_k / pages_v (L, n_pages, page_size, Kv, D) physical
            pools, page_table (n_slots, max_seq // page_size) int32

Every device tensor of a handle is allocated once, by `make`, and written
in place from then on (JAX donates the buffers and gets new ones back), so
a CUDA graph captured over a decode chunk keeps reading the live cache.
A host-side refcounting `BlockAllocator` hands out physical pages; page 0
is a reserved scratch page that unallocated table entries point at.  The
host numpy page table is the source of truth, and every change is copied
into the one persistent device table.

Copy-on-write prefix sharing (`PagedBackend(prefix_sharing=True)`): the
allocator keeps a prefix-hash index over prompt pages (`prefix_chain`), so
an admission whose padded prompt matches a resident prefix maps the
existing pages (a refcount bump, no copy, no fresh page).  The only
shared page a decode write can land in is a partial prompt-tail page;
writing it while another lane holds it first copies it into a private
page (`_cow`), paid for by one extra reserved page per admission with a
partial tail, so `ensure` never runs out.  The copy runs eagerly between
decode dispatches, never inside a captured graph.  `free` releases one
reference; a page returns to the free list, and its index entries drop,
only at refcount zero.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """The block allocator has fewer free pages than requested."""


@dataclass
class CacheHandle:
    """The device tensors of a cache plus its layout tag."""
    data: dict
    kind: str = "paged"
    page_size: int = 0


class BlockAllocator:
    """Refcounting free-list allocator over physical page ids
    [reserved, n_pages).  `free` has release semantics: a page returns to
    the free list only when its refcount reaches zero.  Over-allocation
    raises OutOfPages; freeing a page that is not live raises ValueError.

    The prefix-hash index (`register`/`lookup`) maps content keys to live
    pages; a page's entries drop when its refcount reaches zero, so the
    index never points at a freed page.  `peak_live` is the high-water
    mark of distinct live pages."""

    def __init__(self, n_pages: int, reserved: int = 0):
        if n_pages <= reserved:
            raise ValueError("allocator needs at least one allocatable page")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free = list(range(n_pages - 1, reserved - 1, -1))
        self._rc: dict = {}                # live page -> refcount (>= 1)
        self._index: dict = {}             # prefix key -> live page
        self._page_keys: dict = {}         # live page -> its keys
        self.peak_live = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        """Distinct pages currently allocated (refcounts ignored)."""
        return len(self._rc)

    def reset_peak(self) -> None:
        """Restart the live-page high-water mark at the current
        occupancy."""
        self.peak_live = len(self._rc)

    def refcount(self, page: int) -> int:
        return self._rc.get(page, 0)

    def alloc(self, n: int) -> list:
        if n > len(self._free):
            raise OutOfPages(
                f"requested {n} pages, only {len(self._free)} free of "
                f"{self.n_pages - self.reserved}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._rc[p] = 1
        self.peak_live = max(self.peak_live, len(self._rc))
        return out

    def share(self, page: int) -> int:
        """Add a reference to a live page; returns the new refcount."""
        if page not in self._rc:
            raise ValueError(f"page {page} is not currently allocated")
        self._rc[page] += 1
        return self._rc[page]

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"page {p} is not currently allocated")
            self._rc[p] -= 1
            if self._rc[p]:
                continue
            del self._rc[p]
            for key in self._page_keys.pop(p, ()):
                if self._index.get(key) == p:
                    del self._index[key]
            self._free.append(p)

    def register(self, key: bytes, page: int) -> None:
        """Publish a live page under a prefix content key.  The first
        writer wins: a key already registered keeps its page."""
        if page not in self._rc:
            raise ValueError(
                f"cannot register freed page {page} in the prefix index")
        if key in self._index:
            return
        self._index[key] = page
        self._page_keys.setdefault(page, []).append(key)

    def lookup(self, key: bytes) -> Optional[int]:
        """The live page registered under `key`, or None."""
        return self._index.get(key)

    @property
    def index_size(self) -> int:
        return len(self._index)


def decode_view(handle: CacheHandle, free_mask: torch.Tensor,
                donor: torch.Tensor) -> dict:
    """The decode step's view of a handle.  Paged: free lanes take the
    donor lane's page-table row, so they read the donor's K/V and write the
    donor's own new row to the donor's pages as identical duplicates —
    decode stays deterministic and never touches the scratch page.  Dense:
    the cache itself (a free lane writes into its own stripe, which the
    next admission overwrites whole).  donor is a (1,) long tensor, so the
    view reads no value back to the host."""
    if handle.kind != "paged":
        return handle.data
    pt = handle.data["page_table"]
    pt = torch.where(free_mask[:, None], pt.index_select(0, donor), pt)
    return {**handle.data, "page_table": pt}


def dense_merge(cache: dict, lane: dict, slot: int) -> None:
    """Copy a 1-lane dense cache into lane `slot` of the batched cache, in
    place.  The FULL sequence extent is written (not just the prompt), so
    stale K/V of a retired request can never reach the new occupant."""
    for name in ("k", "v"):
        cache[name][:, slot] = lane[name][:, 0].to(cache[name].dtype)


class _Backend:
    """What both layouts share."""

    def resident_bytes(self, handle: CacheHandle) -> int:
        return sum(t.numel() * t.element_size() for t in handle.data.values())


class DenseBackend(_Backend):
    """Worst-case dense layout: every cache leaf is (L, n_slots, Smax, ...).

    Admission is a lane-to-lane copy; `free`/`ensure` are no-ops (each lane
    permanently owns its Smax stripe)."""

    kind = "dense"
    page_size = 0

    def make(self, cfg, n_slots: int, max_seq: int, device,
             dtype=None) -> CacheHandle:
        return CacheHandle(transformer.init_cache(
            cfg, n_slots, max_seq, dtype or transformer.torch_dtype(cfg),
            device), "dense", 0)

    def can_admit(self, n_tokens: int, chain=None,
                  prompt_tokens: Optional[int] = None) -> bool:
        return True

    def write(self, handle: CacheHandle, slot_kv: dict, slot: int, *,
              n_tokens: Optional[int] = None,
              reserve_tokens: Optional[int] = None,
              chain=None) -> CacheHandle:
        dense_merge(handle.data, slot_kv, slot)
        return handle

    def ensure(self, handle: CacheHandle, slot: int, pos: int) -> CacheHandle:
        return handle

    def ensure_range(self, handle: CacheHandle, slot: int, start: int,
                     stop: int) -> CacheHandle:
        return handle

    def free(self, handle: CacheHandle, slot: int) -> CacheHandle:
        return handle


def prefix_chain(tokens: np.ndarray, page_size: int) -> list:
    """Chained content keys, one per page of a padded prompt row: key i
    commits to every token in positions [0, min((i + 1) page_size, len)),
    so two rows share key i exactly when they agree on the whole prefix
    through page i, which is when page i's K/V bytes are equal.  blake2b
    digests, not python's salted hash(), so keys agree across processes
    (and with the reference's)."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    if toks.ndim != 1:
        raise ValueError(f"prefix_chain wants a 1-D token row, "
                         f"got shape {toks.shape}")
    keys, prev = [], b""
    for start in range(0, len(toks), page_size):
        blk = toks[start:start + page_size].tobytes()
        prev = hashlib.blake2b(prev + blk, digest_size=16).digest()
        keys.append(prev)
    return keys


def _lane_pages(lane_leaf: torch.Tensor, n_lp: int, ps: int) -> torch.Tensor:
    """The leading n_lp pages of a 1-lane dense cache leaf (L, 1, S, Kv, D)
    as (L, n_lp, ps, Kv, D)."""
    l, _, _, kv, d = lane_leaf.shape
    return lane_leaf[:, 0, :n_lp * ps].reshape(l, n_lp, ps, kv, d)


def _paged_merge(pools: dict, lane: dict, pp: torch.Tensor) -> None:
    """Copy the leading len(pp) pages of a 1-lane dense cache into the
    physical pages pp of the pools, in place.  Fresh pages are overwritten
    whole, so a previous occupant's K/V cannot leak."""
    ps = pools["pages_k"].shape[2]
    for pool, lane_leaf in ((pools["pages_k"], lane["k"]),
                            (pools["pages_v"], lane["v"])):
        pool[:, pp] = _lane_pages(lane_leaf, pp.shape[0], ps).to(pool.dtype)


def _paged_merge_subset(pools: dict, lane: dict, pp: torch.Tensor,
                        lps: torch.Tensor, n_lp: int) -> None:
    """_paged_merge for a shared-prefix admission: copy only the logical
    pages `lps` (the ones not shared) of the lane's first n_lp pages into
    the physical pages pp.  Shared pages already hold the same bytes, and
    other lanes read them."""
    ps = pools["pages_k"].shape[2]
    for pool, lane_leaf in ((pools["pages_k"], lane["k"]),
                            (pools["pages_v"], lane["v"])):
        pool[:, pp] = _lane_pages(lane_leaf, n_lp, ps)[:, lps].to(pool.dtype)


def _page_copy(pools: dict, src: int, dst: int) -> None:
    """Copy one physical page across every layer, in place: the copy half
    of copy-on-write."""
    for name in ("pages_k", "pages_v"):
        pools[name][:, dst] = pools[name][:, src]


class PagedBackend(_Backend):
    """Fixed-size pages, a per-lane page table and a host allocator.

    The pool holds `total_tokens` worth of pages (default: the dense worst
    case n_slots * max_seq).  Admission reserves the pages a request could
    ever need, and `can_admit` gates on free-minus-reserved, so `ensure`
    (and copy-on-write) never runs out mid-decode.  One backend manages
    one live handle."""

    kind = "paged"

    def __init__(self, page_size: int = 16,
                 total_tokens: Optional[int] = None,
                 prefix_sharing: bool = False):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self.total_tokens = total_tokens
        self.prefix_sharing = bool(prefix_sharing)
        self.cow_copies = 0             # copy-on-write events
        self.shared_page_hits = 0       # pages mapped without a copy
        self.allocator: Optional[BlockAllocator] = None
        self._table: Optional[np.ndarray] = None
        self._resv: Optional[np.ndarray] = None
        self._device = None

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def make(self, cfg, n_slots: int, max_seq: int, device,
             dtype=None) -> CacheHandle:
        if self._table is not None:
            raise RuntimeError("PagedBackend manages one live handle; "
                               "create a fresh backend per engine")
        if cfg.family not in transformer.DECODER_FAMILIES:
            raise NotImplementedError(
                f"paged KV cache supports decoder families only, "
                f"not {cfg.family!r}")
        if max_seq % self.page_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"page_size={self.page_size}")
        n_pages = self.pages_for(self.total_tokens or n_slots * max_seq) + 1
        pool = transformer.init_paged_cache(
            cfg, n_pages, self.page_size,
            dtype or transformer.torch_dtype(cfg), device)
        self.allocator = BlockAllocator(n_pages, reserved=1)
        self.max_pages = max_seq // self.page_size
        self._table = np.full((n_slots, self.max_pages), NULL_PAGE, np.int32)
        self._resv = np.zeros(n_slots, np.int64)
        self._device = torch.device(device)
        self._dev_table = torch.from_numpy(self._table.copy()).to(
            self._device)
        self._pools = {"pages_k": pool["k"], "pages_v": pool["v"]}
        return CacheHandle({**self._pools, "page_table": self._dev_table},
                           "paged", self.page_size)

    def _push_table(self, handle: CacheHandle) -> CacheHandle:
        """Copy the host table into the persistent device table."""
        self._dev_table.copy_(torch.from_numpy(self._table))
        return handle

    def shared_hits(self, chain: Optional[Sequence[bytes]]) -> int:
        """The leading run of chain keys with a live indexed page: the
        pages an admission with this chain would map instead of
        allocating.  Every holder maps a contiguous leading prefix, so the
        scan stops at the first miss."""
        if not self.prefix_sharing or chain is None:
            return 0
        hits = 0
        for key in chain:
            if self.allocator.lookup(key) is None:
                break
            hits += 1
        return hits

    def sharing_adjustment(self, chain,
                           prompt_tokens: Optional[int]) -> int:
        """Page-count adjustment for a sharing admission: minus the full
        prompt pages already resident (mapped, not allocated), plus one
        copy-on-write page when the prompt's tail part-fills its page, the
        one shared page a decode write can land in.  The +1 is charged
        whether or not the tail is shared yet: a later admission can share
        it, and this lane then needs the copy for its own next write."""
        if not self.prefix_sharing or prompt_tokens is None:
            return 0
        tail = 1 if prompt_tokens % self.page_size else 0
        full = prompt_tokens // self.page_size
        saved = min(self.shared_hits(chain), full) if chain else 0
        return tail - saved

    def can_admit(self, n_tokens: int, chain=None,
                  prompt_tokens: Optional[int] = None) -> bool:
        """True when free-minus-reserved pages cover a request reserving
        n_tokens (with sharing, credited and charged as `write` will)."""
        need = (self.pages_for(n_tokens)
                + self.sharing_adjustment(chain, prompt_tokens))
        return self.allocator.free_pages - int(self._resv.sum()) >= need

    def write(self, handle: CacheHandle, slot_kv: Optional[dict], slot: int,
              *, n_tokens: int, reserve_tokens: Optional[int] = None,
              chain: Optional[Sequence[bytes]] = None) -> CacheHandle:
        """Splice a prefilled 1-lane dense cache into lane `slot`: allocate
        pages for the first n_tokens positions, copy the lane's K/V into
        them, and reserve growth pages up to reserve_tokens.  With prefix
        sharing, `chain` (one prefix_chain key per prompt page) maps the
        leading resident run by refcount bump and registers the fresh
        pages; when every prompt page is shared, slot_kv may be None (no
        prefill output is needed)."""
        if n_tokens is None:
            raise ValueError("paged write needs n_tokens (the prompt extent)")
        self._release(slot)
        n_lp = self.pages_for(n_tokens)
        need = (max(self.pages_for(reserve_tokens), n_lp)
                if reserve_tokens else n_lp)
        sharing = self.prefix_sharing and chain is not None
        hits = 0
        if sharing:
            if len(chain) != n_lp:
                raise ValueError(f"chain must carry one key per prompt page "
                                 f"({n_lp}), got {len(chain)}")
            hits = self.shared_hits(chain)
        fresh = list(range(hits, n_lp))
        if fresh and slot_kv is None:
            raise ValueError(f"write(slot_kv=None) needs every prompt page "
                             f"shared ({hits} of {n_lp} resident)")
        # allocate before sharing: a raise leaves no dangling refcounts
        pp = self.allocator.alloc(len(fresh))
        for lp in range(hits):
            pg = self.allocator.lookup(chain[lp])
            self.allocator.share(pg)
            self._table[slot, lp] = pg
        self.shared_page_hits += hits
        for lp, pg in zip(fresh, pp):
            self._table[slot, lp] = pg
            if sharing:
                self.allocator.register(chain[lp], pg)
        # growth pages past the prompt, plus the partial tail's COW page
        tail = 1 if sharing and n_tokens % self.page_size else 0
        self._resv[slot] = need - n_lp + tail
        if fresh:
            dev_pp = torch.tensor(pp, dtype=torch.long, device=self._device)
            if hits:
                _paged_merge_subset(handle.data, slot_kv, dev_pp,
                                    torch.tensor(fresh, dtype=torch.long,
                                                 device=self._device), n_lp)
            else:
                _paged_merge(handle.data, slot_kv, dev_pp)
        return self._push_table(handle)

    def _cow(self, slot: int, lp: int) -> None:
        """Copy-on-write lane `slot`'s logical page lp into a private page
        (the lane is about to write a page other lanes still read): copy
        the bytes, release this lane's reference on the shared page (never
        freeing it: other holders remain) and spend the reserved page.
        The caller pushes the table."""
        old = int(self._table[slot, lp])
        (new,) = self.allocator.alloc(1)
        self.allocator.free([old])      # rc > 1: decrements, stays live
        self._table[slot, lp] = new
        self._resv[slot] = max(int(self._resv[slot]) - 1, 0)
        self.cow_copies += 1
        _page_copy(self._pools, old, new)

    def _map(self, slot: int, lp: int) -> bool:
        """Make lane `slot`'s logical page lp writable: map a fresh page,
        or copy a shared one; returns whether the table changed."""
        pg = int(self._table[slot, lp])
        if pg != NULL_PAGE:
            if self.prefix_sharing and self.allocator.refcount(pg) > 1:
                self._cow(slot, lp)
                return True
            return False
        (pg,) = self.allocator.alloc(1)
        self._table[slot, lp] = pg
        self._resv[slot] = max(int(self._resv[slot]) - 1, 0)
        return True

    def ensure(self, handle: CacheHandle, slot: int, pos: int) -> CacheHandle:
        """Make the page covering a write at `pos` writable: a no-op when
        it is mapped and held by this lane alone."""
        if self._map(slot, pos // self.page_size):
            return self._push_table(handle)
        return handle

    def ensure_range(self, handle: CacheHandle, slot: int, start: int,
                     stop: int) -> CacheHandle:
        """Make every page covering writes in [start, stop) writable: a
        fused decode chunk's pages, mapped (and copied-on-write) ahead of
        it, since its micro-steps cannot change the table mid-dispatch,
        and pushed to the device once.  The caller clamps `stop` to the
        lane's budget, so the mapping stays inside its admission-time
        reservation."""
        grew = False
        for lp in range(start // self.page_size,
                        (stop - 1) // self.page_size + 1):
            grew |= self._map(slot, lp)
        return self._push_table(handle) if grew else handle

    def free(self, handle: CacheHandle, slot: int) -> CacheHandle:
        """Release lane `slot`'s pages (retirement)."""
        self._release(slot)
        return self._push_table(handle)

    def _release(self, slot: int) -> None:
        pages = [int(p) for p in self._table[slot] if p != NULL_PAGE]
        if pages:
            self.allocator.free(pages)
        self._table[slot] = NULL_PAGE
        self._resv[slot] = 0


def get_backend(name: str, *, page_size: int = 16,
                total_tokens: Optional[int] = None,
                prefix_sharing: bool = False):
    """Factory: "dense" -> DenseBackend, "paged" -> PagedBackend."""
    if name == "dense":
        if prefix_sharing:
            raise ValueError("prefix_sharing needs the paged backend: the "
                             "dense layout has no pages to share")
        return DenseBackend()
    if name == "paged":
        return PagedBackend(page_size=page_size, total_tokens=total_tokens,
                            prefix_sharing=prefix_sharing)
    raise ValueError(f"unknown cache backend {name!r} (dense or paged)")
