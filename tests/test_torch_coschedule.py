"""A lane's output from the decode-step kernels does not depend on the lanes
it shares a batch with, on the CPU.

The two kernels of every decode step sum each lane's work in pieces: the
split paged step merges runs of the lane's pages, the union CSR FFN cuts
its down projection into group splits.  Where those cuts fall must be a
function of the lane's own operands and of the plan's constants for the
engine's shape, never of the other lanes' contents, their groups (the
union), the walk bound (set by the batch's deepest lane) or a fused
chunk's span.  Then a stream decoded in a batch is bitwise the stream the
lane decodes alone, as the reference's engine gives
(tests/test_serving_overlap.py::test_staggered_stream_matches_solo_runs).

Here the plain decompositions (`paged_attention.paged_split_plain`,
`dsg_ffn.csr_union_plain`), called with the sizes the wrappers' plans
pick for each batch, are held to that bitwise, in f32 and bf16; the same
checks on the kernels are in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors gain nothing from threads, which would only contend with
# the other test workers
torch.set_num_threads(1)

from repro_torch.kernels import dsg_ffn, paged_attention  # noqa: E402
from repro_torch.serving.scheduler import live_page_bound  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# --- paged decode ------------------------------------------------------------

H, KV, D, PS, MAX_PAGES = 4, 2, 64, 8, 16     # g * D = 128: the split path
TARGET_POS = 37                               # 5 pages


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _paged_batch(others, target_at, dtype, seed=41):
    """A batch of the target lane (the same q, new K/V and page contents
    in every batch, made from `seed`) at index `target_at` among lanes at
    the positions `others` (their contents from another seed).  Returns
    the paged step's tensors; physical pages are handed out in lane
    order, so the target's page ids differ from batch to batch."""
    rng_t = np.random.default_rng(seed)
    t_q, t_k, t_v = (_rand(rng_t, (H, D)), _rand(rng_t, (KV, D)),
                     _rand(rng_t, (KV, D)))
    t_pages = _rand(rng_t, (2, TARGET_POS // PS + 1, PS, KV, D))
    rng = np.random.default_rng(seed + 1 + len(others) + target_at)
    pos = list(others)
    pos.insert(target_at, TARGET_POS)
    b = len(pos)
    q, k_new, v_new = (_rand(rng, (b, H, D)), _rand(rng, (b, KV, D)),
                       _rand(rng, (b, KV, D)))
    q[target_at], k_new[target_at], v_new[target_at] = t_q, t_k, t_v
    n_pages = 1 + b * MAX_PAGES
    pools = _rand(rng, (2, n_pages, PS, KV, D))
    table = np.zeros((b, MAX_PAGES), np.int32)
    nxt = 1
    for lane, p in enumerate(pos):
        for j in range(p // PS + 1):
            table[lane, j] = nxt
            if lane == target_at:
                pools[:, nxt] = t_pages[:, j]
            nxt += 1
    t = lambda a: torch.from_numpy(a).to(DTYPES[dtype])  # noqa: E731
    return (t(q), t(k_new), t(v_new), t(pools[0]), t(pools[1]),
            torch.from_numpy(table), torch.from_numpy(np.asarray(pos,
                                                                 np.int32)))


def _paged_row(others, target_at, span, dtype):
    """The target lane's output row of the split decomposition with the
    split count the wrapper's plan picks for this batch, at the walk bound
    the engine gives a dispatch of `span` micro-steps."""
    args = _paged_batch(others, target_at, dtype)
    b = args[0].shape[0]
    deepest = max(int(p) for p in args[6]) + span - 1
    walk = live_page_bound(min(deepest, MAX_PAGES * PS - 1), PS, MAX_PAGES)
    splits = paged_attention.plan(b, KV, H // KV, D, PS, walk,
                                  torch.bfloat16).splits
    o, _, _ = paged_attention.paged_split_plain(*args, num_pages=walk,
                                                splits=splits)
    return o[target_at]


# (other lanes' positions, the target's index, the dispatch's span):
# alone; shallow, deep and mixed neighbours, which move the walk bound
# from 8 to 16 pages; the target at another index; a fused chunk's span
PAGED_BATCHES = {"alone": ([], 0, 1),
                 "shallow": ([3, 9, 20], 0, 1),
                 "deep": ([120, 64, 90], 2, 1),
                 "mixed": ([0, 127, 15], 1, 1),
                 "chunk8": ([3, 9, 20], 3, 8),
                 "chunk8_deep": ([100, 9], 1, 8)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batch", [b for b in PAGED_BATCHES if b != "alone"])
def test_paged_split_lane_row_ignores_co_resident_lanes(dtype, batch):
    """The target lane's row equals its row alone, bit for bit, whatever
    the other lanes' depths, the walk bucket they set and the chunk span."""
    alone = _paged_row(*PAGED_BATCHES["alone"], dtype)
    got = _paged_row(*PAGED_BATCHES[batch], dtype)
    assert torch.equal(got, alone)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("walk", [8, 16])
def test_paged_split_row_ignores_the_walk_bound(dtype, walk):
    """One batch stepped at two walk bounds (its own bucket, and the one a
    deeper lane or a wider chunk would set) gives the target the same row:
    the wider walk adds only empty runs, which merge as exact zeros."""
    args = _paged_batch([3, 9, 20], 0, dtype)
    rows = []
    for num_pages in (walk, MAX_PAGES):
        splits = paged_attention.plan(4, KV, H // KV, D, PS, num_pages,
                                      torch.bfloat16).splits
        kp, vp = args[3].clone(), args[4].clone()
        o, _, _ = paged_attention.paged_split_plain(
            *args[:3], kp, vp, *args[5:], num_pages=num_pages, splits=splits)
        rows.append(o[0])
    assert torch.equal(rows[0], rows[1])


def test_paged_plan_cuts_every_lane_the_same_way():
    """The split count the plan gives a lane does not change with the batch
    size or the walk; the walk sizes the grid only."""
    bf = torch.bfloat16
    plans = [paged_attention.plan(b, 8, 2, 128, 16, walk, bf)
             for b in (1, 4, 8) for walk in (1, 2, 4, 8, 16, 32)]
    assert {p.splits for p in plans} == {paged_attention.MAX_SPLITS}
    assert [paged_attention.split_grid(8, w) for w in (1, 2, 3, 5, 8, 32)] \
        == [1, 2, 4, 8, 8, 8]


# --- union CSR FFN -----------------------------------------------------------

B, DM, FF, BLOCK, K = 4, 128, 1024, 64, 8      # G = 16 groups
TARGET_GROUPS = [1, 4, 5, 9, 14]


def _csr_weights(dtype, seed=43):
    rng = np.random.default_rng(seed)
    arrays = (_rand(rng, (DM, FF)) / np.sqrt(DM),
              _rand(rng, (DM, FF)) / np.sqrt(DM),
              _rand(rng, (FF, DM)) / np.sqrt(FF),
              _rand(rng, (B, DM)))
    return [torch.from_numpy(a).to(DTYPES[dtype]) for a in arrays]


# the other lanes' group lists: overlapping; disjoint from the target's;
# every group; empty; mirroring the target (free serving lanes)
CSR_BATCHES = {"overlap": [[0, 1, 2, 4], [4, 5, 6, 7, 8, 9], [14, 15]],
               "disjoint": [[0, 2], [3, 6, 7, 8], [10, 11, 12, 13, 15]],
               "every_group": [list(range(8)), list(range(8, 16)),
                               [0, 3, 6, 9, 12, 15]],
               "empty": [[], [], []],
               "mirrored": [TARGET_GROUPS] * 3}


def _csr_row(others, target_at, dtype):
    """The target lane's output row of the union decomposition, with the
    cluster and split sizes the plan picks for the engine's shape (B lanes
    of K slots); `others` None runs the target alone."""
    wg, wu, wd, x = _csr_weights(dtype)
    lists = [TARGET_GROUPS] if others is None else list(others)
    if others is not None:
        lists.insert(target_at, TARGET_GROUPS)
    else:
        target_at = 0
    b = len(lists)
    rows = x.clone()[:b]
    rows[target_at] = x[0]
    idx = np.zeros((b, K), np.int32)
    for lane, g in enumerate(lists):
        idx[lane, :len(g)] = g
    counts = np.asarray([len(g) for g in lists], np.int32)
    p = dsg_ffn.csr_plan(B, DM, FF, K, BLOCK, torch.bfloat16)
    assert p.path == "union"
    out = dsg_ffn.csr_union_plain(rows, wg, wu, wd, torch.from_numpy(idx),
                                  torch.from_numpy(counts), block=BLOCK,
                                  cluster=p.cluster, splits=p.splits)
    return out[target_at]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("target_at", [0, 2])
@pytest.mark.parametrize("batch", list(CSR_BATCHES))
def test_csr_union_lane_row_ignores_co_resident_groups(dtype, batch,
                                                       target_at):
    """The target lane's row equals its row alone, bit for bit, whatever
    groups the other lanes list (and so whatever the union holds)."""
    alone = _csr_row(None, 0, dtype)
    got = _csr_row(CSR_BATCHES[batch], target_at, dtype)
    assert torch.equal(got, alone)


def test_csr_plan_split_sizes_ignore_the_lanes_groups():
    """The down projection's splits come from d alone and cut the group
    index range at fixed points; the gate/up cluster from the engine's
    shape (lanes x slots)."""
    bf = torch.bfloat16
    plans = [dsg_ffn.csr_plan(4, 2048, 8192, k, 128, bf) for k in (16, 32)]
    assert len({(p.cluster, p.splits, p.tile) for p in plans}) == 1
