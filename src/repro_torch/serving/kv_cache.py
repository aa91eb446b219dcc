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
into the one persistent device table.  Prefix sharing is not ported yet
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
    raises OutOfPages; freeing a page that is not live raises ValueError."""

    def __init__(self, n_pages: int, reserved: int = 0):
        if n_pages <= reserved:
            raise ValueError("allocator needs at least one allocatable page")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free = list(range(n_pages - 1, reserved - 1, -1))
        self._rc: dict = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_pages(self) -> int:
        return len(self._rc)

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
        return out

    def share(self, page: int) -> int:
        if page not in self._rc:
            raise ValueError(f"page {page} is not currently allocated")
        self._rc[page] += 1
        return self._rc[page]

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._rc:
                raise ValueError(f"page {p} is not currently allocated")
            self._rc[p] -= 1
            if not self._rc[p]:
                del self._rc[p]
                self._free.append(p)


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

    def can_admit(self, n_tokens: int) -> bool:
        return True

    def write(self, handle: CacheHandle, slot_kv: dict, slot: int, *,
              n_tokens: Optional[int] = None,
              reserve_tokens: Optional[int] = None) -> CacheHandle:
        dense_merge(handle.data, slot_kv, slot)
        return handle

    def ensure(self, handle: CacheHandle, slot: int, pos: int) -> CacheHandle:
        return handle

    def ensure_range(self, handle: CacheHandle, slot: int, start: int,
                     stop: int) -> CacheHandle:
        return handle

    def free(self, handle: CacheHandle, slot: int) -> CacheHandle:
        return handle


def _paged_merge(pools: dict, lane: dict, pp: torch.Tensor) -> None:
    """Copy the leading len(pp) pages of a 1-lane dense cache into the
    physical pages pp of the pools, in place.  Fresh pages are overwritten
    whole, so a previous occupant's K/V cannot leak."""
    ps = pools["pages_k"].shape[2]
    n_lp = pp.shape[0]
    for pool, lane_leaf in ((pools["pages_k"], lane["k"]),
                            (pools["pages_v"], lane["v"])):
        l, _, _, kv, d = lane_leaf.shape
        chunks = lane_leaf[:, 0, :n_lp * ps].reshape(l, n_lp, ps, kv, d)
        pool[:, pp] = chunks.to(pool.dtype)


class PagedBackend(_Backend):
    """Fixed-size pages, a per-lane page table and a host allocator.

    The pool holds `total_tokens` worth of pages (default: the dense worst
    case n_slots * max_seq).  Admission reserves the pages a request could
    ever need, and `can_admit` gates on free-minus-reserved, so `ensure`
    never runs out mid-decode.  One backend manages one live handle."""

    kind = "paged"

    def __init__(self, page_size: int = 16,
                 total_tokens: Optional[int] = None):
        if page_size <= 0:
            raise ValueError("page_size must be positive")
        self.page_size = page_size
        self.total_tokens = total_tokens
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
        return CacheHandle({"pages_k": pool["k"], "pages_v": pool["v"],
                            "page_table": self._dev_table},
                           "paged", self.page_size)

    def _push_table(self, handle: CacheHandle) -> CacheHandle:
        """Copy the host table into the persistent device table."""
        self._dev_table.copy_(torch.from_numpy(self._table))
        return handle

    def can_admit(self, n_tokens: int) -> bool:
        return (self.allocator.free_pages - int(self._resv.sum())
                >= self.pages_for(n_tokens))

    def write(self, handle: CacheHandle, slot_kv: dict, slot: int, *,
              n_tokens: int, reserve_tokens: Optional[int] = None
              ) -> CacheHandle:
        """Splice a prefilled 1-lane dense cache into lane `slot`: allocate
        pages for the first n_tokens positions, copy the lane's K/V into
        them, and reserve growth pages up to reserve_tokens."""
        self._release(slot)
        n_lp = self.pages_for(n_tokens)
        need = (max(self.pages_for(reserve_tokens), n_lp)
                if reserve_tokens else n_lp)
        pp = self.allocator.alloc(n_lp)
        self._table[slot, :n_lp] = pp
        self._resv[slot] = need - n_lp
        _paged_merge(handle.data, slot_kv,
                     torch.tensor(pp, dtype=torch.long, device=self._device))
        return self._push_table(handle)

    def ensure(self, handle: CacheHandle, slot: int, pos: int) -> CacheHandle:
        """Map the page covering a write at `pos` (no-op when mapped)."""
        lp = pos // self.page_size
        if self._table[slot, lp] != NULL_PAGE:
            return handle
        (pg,) = self.allocator.alloc(1)
        self._table[slot, lp] = pg
        self._resv[slot] = max(int(self._resv[slot]) - 1, 0)
        return self._push_table(handle)

    def ensure_range(self, handle: CacheHandle, slot: int, start: int,
                     stop: int) -> CacheHandle:
        """Map every page covering writes in [start, stop): a fused decode
        chunk's pages, mapped ahead of it since its micro-steps cannot grow
        the table mid-dispatch, and copied to the device once.  The caller
        clamps `stop` to the lane's budget, so the mapping stays inside its
        admission-time reservation."""
        grew = False
        for lp in range(start // self.page_size,
                        (stop - 1) // self.page_size + 1):
            if self._table[slot, lp] != NULL_PAGE:
                continue
            (pg,) = self.allocator.alloc(1)
            self._table[slot, lp] = pg
            self._resv[slot] = max(int(self._resv[slot]) - 1, 0)
            grew = True
        return self._push_table(handle) if grew else handle

    def free(self, handle: CacheHandle, slot: int) -> CacheHandle:
        """Return lane `slot`'s pages to the free list (retirement)."""
        self._release(slot)
        return self._push_table(handle)

    def _release(self, slot: int) -> None:
        pages = [int(p) for p in self._table[slot] if p != NULL_PAGE]
        if pages:
            self.allocator.free(pages)
        self._table[slot] = NULL_PAGE
        self._resv[slot] = 0


def get_backend(name: str, *, page_size: int = 16,
                total_tokens: Optional[int] = None):
    """Factory: "dense" -> DenseBackend, "paged" -> PagedBackend."""
    if name == "dense":
        return DenseBackend()
    if name == "paged":
        return PagedBackend(page_size=page_size, total_tokens=total_tokens)
    raise ValueError(f"unknown cache backend {name!r} (dense or paged)")
