"""CUDA graphs of the fused decode chunk: one graph per static key.

The reference runs a decode chunk as one jitted `lax.scan`, compiled once
per static shape and dispatched once per chunk.  PyTorch's counterpart of
one dispatch is a CUDA graph, so a chunked engine on the card captures the
chunk once per key (live-page bucket, CSR bound, refresh) and replays it:

    cache = GraphCache(device, words)     # one per engine
    cache.stage(arrays)                   # one copy of the host operands
    out = cache.replay(key, fn)           # capture fn() on first use

Every graph reads its operands from one int32 staging buffer on the
device: the host packs them into a pinned mirror and one non-blocking copy
moves them, so a chunk costs one copy, one replay and one read-back of the
packed output.  All keys share one graph memory pool: their replays never
overlap, and the engine reads each output before the next replay.

A capture records the kernels' launches without running them, and a
replay runs them without calling the wrappers, so the wrappers' Python
counters (`launches`, `launches_<path>`) count eager launches and the
launches a capture recorded, never a replay's.  The cache keeps what each
capture added to them as `captured[key]` and counts `replays[key]`;
`launches(wrapper)` is captured launches x replays, the launches the
replays ran.  A capture that fails raises: the engine never falls back to
the eager loop on the card.
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.kernels import drs_search, dsg_ffn, paged_attention

# the kernel wrappers a decode chunk launches
WRAPPERS = (paged_attention.paged_decode, dsg_ffn.dsg_ffn_csr,
            drs_search.drs_project, drs_search.drs_scores)


def launch_counts() -> dict:
    """Every launch counter of the kernel wrappers, by (wrapper, name)."""
    return {(fn, name): value for fn in WRAPPERS
            for name, value in vars(fn).items()
            if name.startswith("launches")}


class GraphCache:
    """The captured chunk graphs of one engine, their staging buffer and
    their launch accounting (`captured`, `replays`, `capture_seconds`,
    `pool_bytes`)."""

    def __init__(self, device: torch.device, words: int):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.host = torch.zeros(words, dtype=torch.int32, pin_memory=True)
        self.staged = torch.zeros(words, dtype=torch.int32, device=device)
        self.graphs = {}                   # key -> (CUDAGraph, output)
        self.captured = {}                 # key -> {wrapper name: launches}
        self.replays = collections.Counter()
        self.capture_seconds = 0.0
        self.pool_bytes = 0                # reserved memory the captures grew

    def stage(self, arrays) -> None:
        """Pack int32 arrays, in order, into the pinned mirror and copy it
        to the device.  The previous copy has run by now: the engine read
        the previous chunk's output back, which follows it on the
        stream."""
        buf, off = self.host.numpy(), 0
        for a in arrays:
            buf[off:off + a.size] = np.asarray(a, np.int32).ravel()
            off += a.size
        self.staged[:off].copy_(self.host[:off], non_blocking=True)

    def views(self, shapes) -> list:
        """Views of the device staging buffer in `stage`'s layout."""
        out, off = [], 0
        for shape in shapes:
            n = int(np.prod(shape))
            out.append(self.staged[off:off + n].view(shape))
            off += n
        return out

    def replay(self, key, fn) -> torch.Tensor:
        """Replay the graph of `key`, capturing fn() first if the key is
        new; returns the graph's output tensor (on the device)."""
        if key not in self.graphs:
            self._capture(key, fn)
        graph, out = self.graphs[key]
        graph.replay()
        self.replays[key] += 1
        return out

    def _capture(self, key, fn) -> None:
        """Capture fn() without running it.  There is no eager warm-up run
        first: a chunk must run exactly once, since on the dense backend a
        lane that freezes mid-chunk writes the donor's rows into its own
        stripe, which a second run of the same chunk would read back as
        its history.  The engine has run eagerly before its first capture
        (every admission is an eager prefill), so the libraries' lazy
        set-up is done."""
        t0 = time.perf_counter()
        # the capture empties the allocator's cache first; so does this,
        # so that the growth in reserved memory is the pool's
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = fn()
        after = launch_counts()
        self.captured[key] = {(w, n): after[(w, n)] - v
                              for (w, n), v in before.items()
                              if after[(w, n)] != v}
        self.graphs[key] = (graph, out)
        self.capture_seconds += time.perf_counter() - t0
        self.pool_bytes += max(
            0, torch.cuda.memory_reserved(self.device) - reserved)

    def launches(self, wrapper, name: str = "launches") -> int:
        """The launches of `wrapper` (counted as its counter `name`
        counts them) that replays ran since `replays` was last cleared:
        captured launches x replays."""
        return sum(c.get((wrapper, name), 0) * self.replays[key]
                   for key, c in self.captured.items())
