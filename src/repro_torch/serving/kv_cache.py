"""Paged KV-cache backend behind a `CacheHandle`.

    backend = PagedBackend(page_size=16, total_tokens=512)
    handle  = backend.make(cfg, n_slots, max_seq, device)
    handle  = backend.write(handle, lane_kv, slot, n_tokens=pb,
                            reserve_tokens=need)      # admission splice
    handle  = backend.ensure(handle, slot, pos)     # growth while decoding
    handle  = backend.free(handle, slot)            # retirement

Layout:

    pages_k / pages_v : (L, n_pages, page_size, Kv, D)   physical pools
    page_table        : (n_slots, max_seq // page_size)  int32

A host-side refcounting `BlockAllocator` hands out physical pages.  Page 0
is a reserved scratch page that unallocated table entries point at.  The
pools are written in place (JAX donates the buffers and gets new ones
back); the host numpy mirror of the page table is the source of truth and
every change pushes a fresh device copy.  Prefix sharing and the dense
backend are not ported yet (ROADMAP.md).
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
                donor: int) -> dict:
    """The decode step's view of a paged handle: free lanes take the donor
    lane's page-table row, so they read the donor's K/V and write the
    donor's own new row to the donor's pages as identical duplicates —
    decode stays deterministic and never touches the scratch page."""
    pt = handle.data["page_table"]
    pt = torch.where(free_mask[:, None], pt[donor], pt)
    return {**handle.data, "page_table": pt}


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


class PagedBackend:
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
        return CacheHandle({"pages_k": pool["k"], "pages_v": pool["v"],
                            "page_table": self._device_table()},
                           "paged", self.page_size)

    def _device_table(self) -> torch.Tensor:
        return torch.from_numpy(self._table.copy()).to(self._device)

    def _with_table(self, handle: CacheHandle) -> CacheHandle:
        return CacheHandle({**handle.data, "page_table": self._device_table()},
                           "paged", self.page_size)

    def resident_bytes(self, handle: CacheHandle) -> int:
        return sum(t.numel() * t.element_size() for t in handle.data.values())

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
        return self._with_table(handle)

    def ensure(self, handle: CacheHandle, slot: int, pos: int) -> CacheHandle:
        """Map the page covering a write at `pos` (no-op when mapped)."""
        lp = pos // self.page_size
        if self._table[slot, lp] != NULL_PAGE:
            return handle
        (pg,) = self.allocator.alloc(1)
        self._table[slot, lp] = pg
        self._resv[slot] = max(int(self._resv[slot]) - 1, 0)
        return self._with_table(handle)

    def free(self, handle: CacheHandle, slot: int) -> CacheHandle:
        """Return lane `slot`'s pages to the free list (retirement)."""
        self._release(slot)
        return self._with_table(handle)

    def _release(self, slot: int) -> None:
        pages = [int(p) for p in self._table[slot] if p != NULL_PAGE]
        if pages:
            self.allocator.free(pages)
        self._table[slot] = NULL_PAGE
        self._resv[slot] = 0
