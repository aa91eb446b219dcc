"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the `cuda` marker and needs a CUDA device; it
skips without one (the check runs inside the `cuda` fixture, never at
import).  This file imports neither JAX nor `repro`, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 kernels sum in another order than the plain versions
(TF32 is off), so they agree to 1e-4.  In bf16 both round an f32 result
once, so they differ by at most one bf16 ulp of the value (2^-7 of it,
within rtol 8e-3), plus atol 4e-3 for values near zero.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the plain versions' CPU work gains nothing from threads, which would only
# contend with the other test workers
torch.set_num_threads(1)

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import (cuda_lib, drs_search, dsg_ffn,  # noqa: E402
                                 ops, paged_attention)
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving.dsg_runtime import DSGServingConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, ServingEngine  # noqa: E402
from repro_torch.serving.workload import mixed_requests  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=8e-3, atol=4e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            * scale).to(dtype).to(dev)


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _paged_inputs(rng, b, h, kv, d, ps, max_pages, pos, dtype, dev,
                  mirror=()):
    """Pools with page 0 as scratch and distinct live pages per lane;
    lanes in `mirror` copy lane 0's page table, position and new K/V (the
    serving engine's free-lane mirroring)."""
    n_pages = 1 + b * max_pages
    q = _rand(rng, (b, h, d), dtype, dev)
    k_new = _rand(rng, (b, kv, d), dtype, dev)
    v_new = _rand(rng, (b, kv, d), dtype, dev)
    k_pages = _rand(rng, (n_pages, ps, kv, d), dtype, dev)
    v_pages = _rand(rng, (n_pages, ps, kv, d), dtype, dev)
    table = np.zeros((b, max_pages), np.int32)
    nxt = 1
    for lane in range(b):
        for j in range(pos[lane] // ps + 1):
            table[lane, j] = nxt
            nxt += 1
    pos = np.asarray(pos, np.int32)
    for lane in mirror:
        table[lane], pos[lane] = table[0], pos[0]
        k_new[lane], v_new[lane] = k_new[0], v_new[0]
    return (q, k_new, v_new, k_pages, v_pages,
            torch.from_numpy(table).to(dev), torch.from_numpy(pos).to(dev))


def _path_launches(wrapper, paths):
    return {p: getattr(wrapper, f"launches_{p}") for p in paths}


def _run_paged(fn, args, **kw):
    q, kn, vn, kp, vp, pt, pos = args
    kp, vp = kp.clone(), vp.clone()
    return fn(q, kn, vn, kp, vp, pt, pos, **kw)


PAGED_PATHS = ("split", "serial")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 16), (2, 2, 16), (16, 8, 128),
                                    (16, 1, 128)])
def test_paged_decode_on_card(cuda, dtype, ps, h, kv, d):
    """bf16 at 64-, 128- or 256-wide heads in query groups of 1-8 takes the
    split kernel, the rest (f32, D 16, 16 query heads a kv head) the
    serial kernel; each call adds one launch to its kernel's count."""
    pos = [0, ps - 1, ps, 2 * ps + 3, 5 * ps - 1]
    args = _paged_inputs(np.random.default_rng(0), len(pos), h, kv, d, ps,
                         6, pos, dtype, cuda)
    want = ("split" if dtype == torch.bfloat16 and d == 128 and h // kv <= 8
            else "serial")
    assert paged_attention.plan(len(pos), kv, h // kv, d, ps, 6,
                                dtype).path == want
    before = _path_launches(paged_attention.paged_decode, PAGED_PATHS)
    o, kp, vp = _run_paged(paged_attention.paged_decode, args)
    after = _path_launches(paged_attention.paged_decode, PAGED_PATHS)
    assert after == {q: n + (q == want) for q, n in before.items()}
    ow, kw, vw = _run_paged(paged_attention.paged_decode_plain, args)
    _close(o, ow, dtype)
    assert torch.equal(kp, kw) and torch.equal(vp, vw)


@pytest.mark.parametrize("window,num_pages", [(10, 0), (0, 6), (0, 2)])
def test_paged_decode_window_walk_and_mirrors_on_card(cuda, window,
                                                      num_pages):
    """Sliding window, a bounded walk, an undersized walk (lanes past it
    write nothing) and mirrored lanes writing duplicate rows."""
    args = _paged_inputs(np.random.default_rng(1), 4, 4, 2, 16, 8, 8,
                         [5, 17, 40, 9], torch.float32, cuda, mirror=(3,))
    kw = dict(window=window, num_pages=num_pages)
    o, kp, vp = _run_paged(paged_attention.paged_decode, args, **kw)
    ow, kw_, vw = _run_paged(paged_attention.paged_decode_plain, args, **kw)
    _close(o, ow, torch.float32)
    assert torch.equal(kp, kw_) and torch.equal(vp, vw)


CSR_PATHS = ("union", "lanes")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d,f,block,k", [(3, 16, 64, 16, 2),
                                           (4, 64, 256, 64, 4),
                                           (4, 2048, 8192, 128, 32),
                                           (9, 256, 1024, 128, 4)])
def test_dsg_ffn_csr_on_card(cuda, dtype, b, d, f, block, k):
    """bf16 with up to 8 lanes, blocks of a multiple of 32 and d of a
    multiple of 64 takes the union kernels, the rest the per-lane kernels;
    each call adds one launch to its path's count."""
    rng = np.random.default_rng(2)
    g = f // block
    x = _rand(rng, (b, d), dtype, cuda)
    wg = _rand(rng, (d, f), dtype, cuda, 1 / math.sqrt(d))
    wu = _rand(rng, (d, f), dtype, cuda, 1 / math.sqrt(d))
    wd = _rand(rng, (f, d), dtype, cuda, 1 / math.sqrt(f))
    idx = np.zeros((b, k), np.int32)
    counts = rng.integers(1, k + 1, b).astype(np.int32)
    counts[0] = k
    for lane in range(b):
        idx[lane, :counts[lane]] = np.sort(rng.choice(g, counts[lane],
                                                      replace=False))
        idx[lane, counts[lane]:] = rng.integers(0, g, k - counts[lane])
    idx_t, cnt_t = (torch.from_numpy(a).to(cuda) for a in (idx, counts))
    want = ("union" if dtype == torch.bfloat16 and b <= 8 and block % 32 == 0
            and d % 64 == 0 else "lanes")
    assert dsg_ffn.csr_plan(b, d, f, k, block, dtype).path == want
    before = _path_launches(dsg_ffn.dsg_ffn_csr, CSR_PATHS)
    got = dsg_ffn.dsg_ffn_csr(x, wg, wu, wd, idx_t, cnt_t, block=block)
    after = _path_launches(dsg_ffn.dsg_ffn_csr, CSR_PATHS)
    assert after == {q: n + (q == want) for q, n in before.items()}
    _close(got, dsg_ffn.dsg_ffn_csr_plain(x, wg, wu, wd, idx_t, cnt_t,
                                          block=block), dtype)


def _csr_case(rng, case, b=4, k=32, g=64):
    """idx/counts of one CSR sweep case: "padded" (short lists zero-padded,
    group 0 listed by no lane), "empty" (a lane with count 0), "full"
    (counts equal to K), "mirrored" (lanes 1..3 copy lane 0) and
    "disjoint" (no group shared)."""
    idx = np.zeros((b, k), np.int32)
    counts = np.full(b, k, np.int32)
    if case == "disjoint":
        per = g // b
        for lane in range(b):
            n = min(k, per)
            idx[lane, :n] = np.arange(lane * per, lane * per + n)
            counts[lane] = n
        return idx, counts
    for lane in range(b):
        n = {"padded": min(k // 2 + lane, k, g - 1),
             "empty": 0 if lane == 1 else k}.get(case, k)
        idx[lane, :n] = np.sort(rng.choice(np.arange(1, g), n, replace=False))
        counts[lane] = n
    if case == "mirrored":
        idx[1:], counts[1:] = idx[0], counts[0]
    return idx, counts


def _csr_weights(rng, b, d, f, dtype, dev):
    return (_rand(rng, (b, d), dtype, dev),
            _rand(rng, (d, f), dtype, dev, 1 / math.sqrt(d)),
            _rand(rng, (d, f), dtype, dev, 1 / math.sqrt(d)),
            _rand(rng, (f, d), dtype, dev, 1 / math.sqrt(f)))


@pytest.mark.parametrize("case", ["padded", "empty", "full", "mirrored",
                                  "disjoint"])
def test_dsg_ffn_csr_union_sweep_on_card(cuda, case):
    """The union path at the full-width shape on each sweep case: one
    launch on the union path, equal to the plain version and to the union
    decomposition; a zero-padded slot never adds group 0."""
    rng = np.random.default_rng(20)
    bf = torch.bfloat16
    x, wg, wu, wd = _csr_weights(rng, 4, 2048, 8192, bf, cuda)
    idx, counts = (torch.from_numpy(a).to(cuda)
                   for a in _csr_case(rng, case))
    p = dsg_ffn.csr_plan(4, 2048, 8192, 32, 128, bf)
    assert p.path == "union"
    before = _path_launches(dsg_ffn.dsg_ffn_csr, CSR_PATHS)
    got = dsg_ffn.dsg_ffn_csr(x, wg, wu, wd, idx, counts)
    after = _path_launches(dsg_ffn.dsg_ffn_csr, CSR_PATHS)
    assert after == {q: n + (q == "union") for q, n in before.items()}
    _close(got, dsg_ffn.dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts), bf)
    _close(got, dsg_ffn.csr_union_plain(x, wg, wu, wd, idx, counts,
                                        cluster=p.cluster, splits=p.splits),
           bf)
    if case == "empty":
        assert not got[1].any()


# other lanes' positions and the dispatch's span for the co-scheduling
# checks: alone, shallow (walk 16), deep (walk 32), a fused chunk's span
COSCHED_PAGED = {"alone": ([], 1), "shallow": ([3, 40, 90], 1),
                 "deep": ([500, 260, 17], 1), "chunk8": ([3, 40, 245], 8)}


def _paged_target_row(cuda, others, span):
    """The target lane (position 150: 10 pages; the same q, new K/V and
    page contents in every batch) at index 1 of a batch (index 0 alone)
    through `paged_decode` at the walk bound the engine gives this batch
    and span; returns its output row on the split path."""
    from repro_torch.serving.scheduler import live_page_bound
    bf, ps, max_pages, target = torch.bfloat16, 16, 32, 150
    t = _paged_inputs(np.random.default_rng(61), 1, 16, 8, 128, ps,
                      max_pages, [target], bf, cuda)
    pos = list(others)
    at = min(1, len(pos))
    pos.insert(at, target)
    args = list(_paged_inputs(np.random.default_rng(62 + len(others)),
                              len(pos), 16, 8, 128, ps, max_pages, pos, bf,
                              cuda))
    for i in range(3):
        args[i][at] = t[i][0]
    for j in range(target // ps + 1):
        for i in (3, 4):
            args[i][args[5][at, j]] = t[i][t[5][0, j]]
    walk = live_page_bound(min(max(pos) + span - 1, ps * max_pages - 1), ps,
                           max_pages)
    assert paged_attention.plan(len(pos), 8, 2, 128, ps, walk,
                                bf).path == "split"
    o, _, _ = _run_paged(paged_attention.paged_decode, args, num_pages=walk)
    return o[at]


@pytest.mark.parametrize("batch", ["shallow", "deep", "chunk8"])
def test_paged_decode_lane_ignores_co_resident_lanes_on_card(cuda, batch):
    """The split kernel gives a lane the row it has alone, bit for bit,
    whatever its co-resident lanes' depths, the walk bound they set and a
    fused chunk's span."""
    alone = _paged_target_row(cuda, *COSCHED_PAGED["alone"])
    assert torch.equal(_paged_target_row(cuda, *COSCHED_PAGED[batch]), alone)


def _csr_target_row(cuda, case):
    """Lane 2 of a 4-lane union CSR step at the full-width shape, with the
    same x row and groups in every case, among lanes of another case's
    groups: `mirrored` is the lane alone (free serving lanes mirror it)."""
    rng = np.random.default_rng(63)
    bf = torch.bfloat16
    x, wg, wu, wd = _csr_weights(rng, 4, 2048, 8192, bf, cuda)
    idx, counts = _csr_case(np.random.default_rng(64), "padded")
    target_idx, target_n = idx[0].copy(), counts[0]
    if case != "mirrored":
        idx, counts = _csr_case(np.random.default_rng(65), case)
    else:
        idx[:], counts[:] = target_idx, target_n
    idx[2], counts[2] = target_idx, target_n
    x = x.clone()
    x[:2], x[3] = x[2] * 0.5, x[2] * -1.5
    got = dsg_ffn.dsg_ffn_csr(x, wg, wu, wd,
                              *(torch.from_numpy(a).to(cuda)
                                for a in (idx, counts)))
    return got[2]


@pytest.mark.parametrize("case", ["padded", "empty", "full", "disjoint"])
def test_dsg_ffn_csr_lane_ignores_co_resident_groups_on_card(cuda, case):
    """The union kernels give a lane the row it has alone, bit for bit,
    whatever groups the other lanes list."""
    assert dsg_ffn.csr_plan(4, 2048, 8192, 32, 128,
                            torch.bfloat16).path == "union"
    assert torch.equal(_csr_target_row(cuda, case),
                       _csr_target_row(cuda, "mirrored"))


def _csr_union_launch(x, wg, wu, wd, idx, counts, block, cluster, splits,
                      tile):
    b, d = x.shape
    f, k = wg.shape[1], idx.shape[1]
    lanes = dsg_ffn.csr_plan(b, d, f, k, block, x.dtype).lanes
    h = torch.empty((max(1, min(f // block, b * k)), b, block),
                    dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    cuda_lib.launch("repro_dsg_ffn_csr_union", x.data_ptr(), wg.data_ptr(),
                    wu.data_ptr(), wd.data_ptr(), idx.data_ptr(),
                    counts.data_ptr(), h.data_ptr(), out.data_ptr(), b, d, f,
                    k, block, lanes, cluster, min(128, block), tile, splits,
                    cuda_lib.stream(x.device))
    return out


@pytest.mark.parametrize("cluster,splits,tile", [(1, 1, 64), (2, 8, 128),
                                                 (8, 4, 64), (4, 2, 128)])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_dsg_ffn_csr_union_sizes_on_card(cuda, cluster, splits, tile, b):
    """Cluster and split sizes around the plan's, and lane counts that pad
    to 1, 4 and 8: every one equals the plain version."""
    rng = np.random.default_rng(21)
    bf = torch.bfloat16
    x, wg, wu, wd = _csr_weights(rng, b, 1024, 4096, bf, cuda)
    idx, counts = (torch.from_numpy(a[:b]).to(cuda)
                   for a in _csr_case(rng, "padded", b=8, k=16, g=32))
    got = _csr_union_launch(x, wg, wu, wd, idx, counts, 128, cluster,
                            splits, tile)
    _close(got, dsg_ffn.dsg_ffn_csr_plain(x, wg, wu, wd, idx, counts), bf)


@pytest.mark.parametrize("case", ["window", "undersized", "mirrored",
                                  "empty_splits", "deep"])
def test_paged_decode_split_sweep_on_card(cuda, case):
    """The split kernel at the full-width head shape (16 heads, 8 kv heads,
    D 128, pages of 16) on each sweep case, against the plain version and
    the split decomposition; the pools equal the plain version's writes
    exactly (an undersized walk writes nothing)."""
    bf = torch.bfloat16
    pos = {"empty_splits": [0, 3, 17, 20],
           "deep": [255, 130, 511, 64]}.get(case, [5, 100, 250, 31])
    args = _paged_inputs(np.random.default_rng(23), 4, 16, 8, 128, 16, 32,
                         pos, bf, cuda,
                         mirror=(3,) if case == "mirrored" else ())
    kw = {"window": dict(window=40),
          "undersized": dict(num_pages=4)}.get(case, dict(num_pages=32))
    walk = kw.get("num_pages", 32)
    p = paged_attention.plan(4, 8, 2, 128, 16, walk, bf)
    assert p.path == "split"
    if case == "empty_splits":
        assert p.splits > 2
    before = _path_launches(paged_attention.paged_decode, PAGED_PATHS)
    o, kp, vp = _run_paged(paged_attention.paged_decode, args, **kw)
    after = _path_launches(paged_attention.paged_decode, PAGED_PATHS)
    assert after == {q: n + (q == "split") for q, n in before.items()}
    ow, kw_, vw = _run_paged(paged_attention.paged_decode_plain, args, **kw)
    _close(o, ow, bf)
    assert torch.equal(kp, kw_) and torch.equal(vp, vw)
    os_, _, _ = _run_paged(paged_attention.paged_split_plain, args,
                           splits=p.splits, **kw)
    _close(o, os_, bf)


def _paged_split_launch(args, splits, window=0, num_pages=0):
    q, kn, vn, kp, vp, pt, pos = args
    kp, vp = kp.clone(), vp.clone()
    b, h, d = q.shape
    ps, kv = kp.shape[1], kp.shape[2]
    max_pages = pt.shape[1]
    walk = min(num_pages, max_pages) if num_pages else max_pages
    out = torch.empty_like(q)
    cuda_lib.launch("repro_paged_decode_split", q.data_ptr(), kn.data_ptr(),
                    vn.data_ptr(), kp.data_ptr(), vp.data_ptr(), pt.data_ptr(),
                    pos.data_ptr(), out.data_ptr(), b, kv, h // kv, d, ps,
                    max_pages, walk, window, 1 / math.sqrt(d), splits,
                    cuda_lib.stream(q.device))
    return out, kp, vp


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("h,kv,d,ps", [(16, 8, 128, 16), (8, 8, 128, 8),
                                       (8, 2, 64, 16), (4, 2, 256, 32)])
def test_paged_decode_split_sizes_on_card(cuda, splits, h, kv, d, ps):
    """Every split count at head shapes the split kernel takes (g 2, 1 and
    4; D 64, 128, 256; pages of 8, 16 and 32 rows), lanes with fewer pages
    than splits included."""
    bf = torch.bfloat16
    pos = [0, ps + 1, 5 * ps - 1, 9 * ps + 2]
    args = _paged_inputs(np.random.default_rng(24), 4, h, kv, d, ps, 12, pos,
                         bf, cuda)
    assert paged_attention.plan(4, kv, h // kv, d, ps, 12, bf).path == "split"
    o, kp, vp = _paged_split_launch(args, splits, window=3 * ps)
    ow, kw_, vw = _run_paged(paged_attention.paged_decode_plain, args,
                             window=3 * ps)
    _close(o, ow, bf)
    assert torch.equal(kp, kw_) and torch.equal(vp, vw)


PROJECT_PATHS = ("gemv", "tc", "simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,k", [
    (64, 128, 64), (4, 2048, 256), (37, 320, 128), (256, 2048, 256),
    (1, 2048, 256), (16, 2048, 256), (17, 2048, 256), (192, 2048, 256),
    (1, 320, 256), (4, 320, 256), (16, 320, 256), (17, 320, 256),
    (192, 320, 256), (256, 320, 256)])
def test_drs_project_on_card(cuda, dtype, m, d, k):
    """bf16 takes the GEMV for M <= 16 and the split-d wgmma tiles above;
    f32 the SIMT tile.  Each call adds one launch to its path's count."""
    rng = np.random.default_rng(3)
    x = _rand(rng, (m, d), dtype, cuda)
    r = _rand(rng, (k, d), dtype, cuda, 1 / math.sqrt(k))
    want = ("simt" if dtype == torch.float32
            else "gemv" if m <= 16 else "tc")
    assert drs_search.project_plan(m, k, d, dtype).path == want
    before = _path_launches(drs_search.drs_project, PROJECT_PATHS)
    got = drs_search.drs_project(x, r)
    after = _path_launches(drs_search.drs_project, PROJECT_PATHS)
    assert after == {p: n + (p == want) for p, n in before.items()}
    _close(got, drs_search.drs_project_plain(x, r), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,f,block", [(64, 64, 256, 32), (4, 256, 8192, 128),
                                         (37, 128, 512, 64),
                                         (256, 256, 8192, 128)])
def test_drs_scores_on_card(cuda, dtype, m, k, f, block):
    rng = np.random.default_rng(4)
    fx = _rand(rng, (m, k), dtype, cuda)
    fw = _rand(rng, (k, f), dtype, cuda)
    got = drs_search.drs_scores(fx, fw, block=block)
    want = drs_search.drs_scores_plain(fx, fw, block=block)
    # both sum exact products of the same inputs in f32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


SCORES_PATHS = ("gemv", "tc", "simt")


def _scores_inputs(rng, m, k, f, dtype, dev):
    return (_rand(rng, (m, k), dtype, dev),
            _rand(rng, (k, f), dtype, dev, 1 / math.sqrt(k)))


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("m", [1, 4, 16, 17, 37, 100, 192, 256])
def test_drs_scores_paths_on_card(cuda, m, block):
    """bf16 at the serve shapes (k 256, F 8192) and ragged M: M <= 16 takes
    the GEMV, larger M the wgmma tiles; each call adds one launch to its
    path's count and equals the plain version and, for the GEMV, the
    column-slice decomposition at the plan's slices."""
    rng = np.random.default_rng(40)
    bf = torch.bfloat16
    fx, fw = _scores_inputs(rng, m, 256, 8192, bf, cuda)
    p = drs_search.scores_plan(m, 256, 8192, block, bf)
    assert p.path == ("gemv" if m <= 16 else "tc")
    before = _path_launches(drs_search.drs_scores, SCORES_PATHS)
    got = drs_search.drs_scores(fx, fw, block=block)
    after = _path_launches(drs_search.drs_scores, SCORES_PATHS)
    assert after == {q: n + (q == p.path) for q, n in before.items()}
    tol = dict(rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(
        got, drs_search.drs_scores_plain(fx, fw, block=block), **tol)
    if p.path == "gemv":
        torch.testing.assert_close(got, drs_search.drs_scores_split_plain(
            fx, fw, block=block, slices=p.slices), **tol)


def _scores_launch(fx, fw, block, path, n):
    m, k = fx.shape
    f = fw.shape[1]
    out = torch.empty((m, f // block), dtype=torch.float32, device=fx.device)
    cuda_lib.launch(f"repro_drs_scores_{path}", fx.data_ptr(), fw.data_ptr(),
                    out.data_ptr(), m, k, f, block, n,
                    cuda_lib.stream(fx.device))
    return out


@pytest.mark.parametrize("path,m,n", [
    ("gemv", 4, 1), ("gemv", 4, 2), ("gemv", 4, 8), ("gemv", 16, 1),
    ("tc", 192, 2), ("tc", 192, 3), ("tc", 100, 2), ("tc", 256, 4)])
def test_drs_scores_sizes_on_card(cuda, path, m, n):
    """The GEMV at 1, 2 and 8 column slices of a group and the wgmma tiles
    at 2-4 row tiles a block (one block a group at M = 192), against the
    plain version."""
    rng = np.random.default_rng(41)
    fx, fw = _scores_inputs(rng, m, 256, 8192, torch.bfloat16, cuda)
    got = _scores_launch(fx, fw, 128, path, n)
    torch.testing.assert_close(
        got, drs_search.drs_scores_plain(fx, fw, block=128), rtol=1e-4,
        atol=1e-3)


def _tile_ffn_inputs(rng, m, d, f, block, dtype, dev, density=0.6):
    x = _rand(rng, (m, d), dtype, dev)
    wg = _rand(rng, (d, f), dtype, dev, 1 / math.sqrt(d))
    wu = _rand(rng, (d, f), dtype, dev, 1 / math.sqrt(d))
    wd = _rand(rng, (f, d), dtype, dev, 1 / math.sqrt(f))
    mask = torch.from_numpy((rng.random((m, f // block)) < density).astype(
        np.float32)).to(dev)
    return x, wg, wu, wd, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,block,bm,bf", [
    (64, 96, 256, 32, 32, 64), (48, 128, 320, 64, 16, 64),
    (256, 2048, 8192, 128, 128, 128)])
def test_dsg_ffn_tile_on_card(cuda, dtype, m, d, f, block, bm, bf):
    """Per-token, batch-shared (dead cells) and all-zero masks; ragged
    edges of the kernel's 64 x 64 cells at the middle shape."""
    rng = np.random.default_rng(6)
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, m, d, f, block, dtype, cuda)
    shared = mask[:1].expand_as(mask).contiguous()
    for mk in (mask, shared):
        got = dsg_ffn.dsg_ffn(x, wg, wu, wd, mk, block=block, bm=bm, bf=bf)
        _close(got, dsg_ffn.dsg_ffn_plain(x, wg, wu, wd, mk, block=block),
               dtype)
    zeros = dsg_ffn.dsg_ffn(x, wg, wu, wd, torch.zeros_like(mask),
                            block=block, bm=bm, bf=bf)
    assert not zeros.any()


TILE_PATHS = ("tc", "simt")


def _tile_masks(rng, mask):
    """Per-token, batch-shared (row 0 for every row), half-dead (the upper
    half of the groups selected by no token), all-live and all-dead
    masks."""
    half = mask.clone()
    half[:, mask.shape[1] // 2:] = 0
    return {"per_token": mask, "shared": mask[:1].expand_as(mask).contiguous(),
            "half_dead": half, "all_live": torch.ones_like(mask),
            "all_dead": torch.zeros_like(mask)}


@pytest.mark.parametrize("block", [32, 64, 128])
@pytest.mark.parametrize("m", [17, 64, 100, 192, 256])
def test_dsg_ffn_tile_tc_on_card(cuda, m, block):
    """The wgmma path at d 512, F 2048 over every mask kind: one launch on
    the tc path each, equal to the plain version and to the F-split
    decomposition at the plan's splits; an all-dead mask gives exact
    zeros."""
    rng = np.random.default_rng(42)
    bf = torch.bfloat16
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, m, 512, 2048, block, bf,
                                           cuda, density=0.1)
    p = dsg_ffn.tile_plan(m, 512, 2048, block, bf)
    assert p.path == "tc"
    for kind, mk in _tile_masks(rng, mask).items():
        before = _path_launches(dsg_ffn.dsg_ffn, TILE_PATHS)
        got = dsg_ffn.dsg_ffn(x, wg, wu, wd, mk, block=block, bm=m, bf=block)
        after = _path_launches(dsg_ffn.dsg_ffn, TILE_PATHS)
        assert after == {q: n + (q == "tc") for q, n in before.items()}
        _close(got, dsg_ffn.dsg_ffn_plain(x, wg, wu, wd, mk, block=block),
               bf)
        _close(got, dsg_ffn.dsg_ffn_split_plain(x, wg, wu, wd, mk,
                                                block=block, splits=p.splits,
                                                rows=p.rows), bf)
        if kind == "all_dead":
            assert not got.any()


def _tile_tc_launch(x, wg, wu, wd, mask, block, rows, splits):
    m, d = x.shape
    f = wg.shape[1]
    live = torch.empty((-(-m // rows), f // 128), dtype=torch.int32,
                       device=x.device)
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    cuda_lib.launch("repro_dsg_ffn_tile_tc", x.data_ptr(), wg.data_ptr(),
                    wu.data_ptr(), wd.data_ptr(), mask.data_ptr(),
                    live.data_ptr(), h.data_ptr(), out.data_ptr(), m, d, f,
                    block, rows, splits, cuda_lib.stream(x.device))
    return out


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m", [100, 256])
def test_dsg_ffn_tile_tc_sizes_on_card(cuda, rows, splits, m):
    """Gate/up blocks of 64 and 128 rows and 1-8 F splits of the down
    projection (ragged M and a half-width last column tile included; at 8
    splits some splits hold no live chunk), against the plain version and
    the F-split decomposition."""
    rng = np.random.default_rng(43)
    bf = torch.bfloat16
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, m, 576, 2048, 128,
                                           bf, cuda, density=0.2)
    mask[:, ::3] = 0
    got = _tile_tc_launch(x, wg, wu, wd, mask, 128, rows, splits)
    _close(got, dsg_ffn.dsg_ffn_plain(x, wg, wu, wd, mask, block=128), bf)
    _close(got, dsg_ffn.dsg_ffn_split_plain(x, wg, wu, wd, mask, block=128,
                                            splits=splits, rows=rows), bf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,t,d,causal,bq,bk", [
    (4, 128, 128, 32, True, 32, 32), (2, 64, 192, 64, False, 32, 64),
    (2, 48, 80, 16, True, 16, 16), (2, 64, 32, 16, True, 16, 16),
    (16, 256, 256, 128, True, 128, 128),
    (16, 256, 2048, 128, True, 128, 128),
    (2, 48, 80, 64, True, 16, 16), (2, 128, 64, 64, True, 64, 64),
    (2, 64, 4096, 64, True, 64, 128),
    (2, 64, 128, 192, True, 64, 64), (4, 128, 1024, 192, True, 128, 128),
    (2, 64, 128, 256, True, 64, 64), (4, 128, 1024, 256, True, 128, 128)])
def test_flash_attention_on_card(cuda, dtype, bh, s, t, d, causal, bq, bk):
    """Ragged kernel tiles (S 48, T 80), causal S > T (rows before the
    keys are exactly zero), the full-width prefill and suffix cases (the
    latter split across blocks in bf16), many splits at T = 4096, and head
    dims 192 and 256 in one block and split.  bf16 with D a multiple of 64
    takes the tensor-core kernel, the rest the SIMT kernel."""
    rng = np.random.default_rng(7)
    q = _rand(rng, (bh, s, d), dtype, cuda)
    k = _rand(rng, (bh, t, d), dtype, cuda)
    v = _rand(rng, (bh, t, d), dtype, cuda)
    plan = fa.plan(bh, s, t, d, dtype)
    want = "tc" if dtype == torch.bfloat16 and d % 64 == 0 else "simt"
    assert plan.path == want
    if want == "tc" and t >= 1024:
        assert plan.splits > 1
    elif want == "tc" and t == 128:
        assert plan.splits == 1
    before = _path_launches(fa.flash_attention, ("tc", "simt"))
    got = fa.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    after = _path_launches(fa.flash_attention, ("tc", "simt"))
    assert after == {p: n + (p == want) for p, n in before.items()}
    _close(got, fa.flash_attention_plain(q, k, v, causal=causal), dtype)
    if causal and s > t:
        assert not got[:, :s - t].any()


def test_tc_kernels_repeat_bitwise_on_card(cuda):
    """The split-KV flash kernel, both bf16 drs_project and drs_scores
    paths, the union CSR FFN, the split paged step and the tensor-core
    tile FFN sum their splits in a fixed order: two calls give the same
    bits."""
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    q = _rand(rng, (16, 256, 128), bf, cuda)
    k = _rand(rng, (16, 2048, 128), bf, cuda)
    v = _rand(rng, (16, 2048, 128), bf, cuda)
    assert fa.plan(16, 256, 2048, 128, bf).splits > 1
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention(q, k, v))
    r = _rand(rng, (256, 2048), bf, cuda, 1 / 16)
    for m in (4, 192):
        x = _rand(rng, (m, 2048), bf, cuda)
        assert torch.equal(drs_search.drs_project(x, r),
                           drs_search.drs_project(x, r))
    x, wg, wu, wd = _csr_weights(rng, 4, 2048, 8192, bf, cuda)
    idx, counts = (torch.from_numpy(a).to(cuda)
                   for a in _csr_case(rng, "padded"))
    assert dsg_ffn.csr_plan(4, 2048, 8192, 32, 128, bf).path == "union"
    assert torch.equal(dsg_ffn.dsg_ffn_csr(x, wg, wu, wd, idx, counts),
                       dsg_ffn.dsg_ffn_csr(x, wg, wu, wd, idx, counts))
    args = _paged_inputs(rng, 4, 16, 8, 128, 16, 32, [5, 100, 250, 31], bf,
                         cuda)
    assert paged_attention.plan(4, 8, 2, 128, 16, 16, bf).splits > 1
    first = _run_paged(paged_attention.paged_decode, args, num_pages=16)
    second = _run_paged(paged_attention.paged_decode, args, num_pages=16)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, second))
    for m in (4, 192):
        fx, fw = _scores_inputs(rng, m, 256, 8192, bf, cuda)
        assert drs_search.scores_plan(m, 256, 8192, 128, bf).path in (
            "gemv", "tc")
        assert torch.equal(drs_search.drs_scores(fx, fw),
                           drs_search.drs_scores(fx, fw))
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, 256, 2048, 8192, 128, bf,
                                           cuda)
    p = dsg_ffn.tile_plan(256, 2048, 8192, 128, bf)
    assert p.path == "tc" and p.splits > 1
    assert torch.equal(dsg_ffn.dsg_ffn(x, wg, wu, wd, mask),
                       dsg_ffn.dsg_ffn(x, wg, wu, wd, mask))


def test_tile_kernels_refuse_what_they_cannot_take(cuda):
    rng = np.random.default_rng(8)
    q = _rand(rng, (2, 64, 512), torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q, block_q=32, block_k=32)
    q = _rand(rng, (2, 64, 16), torch.float32, cuda)
    with pytest.raises(ValueError, match="flash_attention"):
        fa.flash_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="flash_attention"):
        fa.flash_attention(q, q, q, block_q=48)
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, 64, 32, 128, 32,
                                           torch.float32, cuda)
    with pytest.raises(ValueError, match="dsg_ffn"):
        dsg_ffn.dsg_ffn(x, wg, wu, wd, mask, block=32, bm=48, bf=64)
    with pytest.raises(ValueError, match="dsg_ffn"):
        dsg_ffn.dsg_ffn(x, wg, wu, wd, mask[:, :2], block=32, bm=32, bf=64)
    # the bf16 tensor-core paths take no misaligned base and no row that is
    # not a 16-byte multiple, and launch nothing then
    bf = torch.bfloat16
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, 64, 128, 256, 64, bf, cuda)
    fx, fw = _scores_inputs(rng, 32, 64, 256, bf, cuda)
    before = (dsg_ffn.dsg_ffn.launches, drs_search.drs_scores.launches)
    for args in ((_unaligned(x), wg, wu, wd), (x, _unaligned(wg), wu, wd),
                 (x, wg, wu, _unaligned(wd))):
        with pytest.raises(ValueError, match="16-byte"):
            dsg_ffn.dsg_ffn(*args, mask, block=64)
    for args in ((_unaligned(fx), fw), (fx, _unaligned(fw)),
                 (_unaligned(fx[:4]), fw)):
        with pytest.raises(ValueError, match="16-byte"):
            drs_search.drs_scores(*args, block=64)
    x, wg, wu, wd, mask = _tile_ffn_inputs(rng, 64, 100, 256, 64, bf, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        dsg_ffn.dsg_ffn(x, wg, wu, wd, mask, block=64)
    fx, fw = _scores_inputs(rng, 32, 60, 256, bf, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        drs_search.drs_scores(fx, fw, block=64)
    assert (dsg_ffn.dsg_ffn.launches,
            drs_search.drs_scores.launches) == before


def _unaligned(t):
    """A contiguous copy of t that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_tc_kernels_refuse_unaligned_on_card(cuda):
    """The TMA, bulk-copy and 16-byte cp.async paths (flash, drs_project,
    the union CSR FFN, the split paged step) raise on an operand off a
    16-byte boundary, and launch nothing; f32 takes the SIMT kernels at
    any alignment."""
    rng = np.random.default_rng(10)
    bf = torch.bfloat16
    q = _rand(rng, (2, 64, 128), bf, cuda)
    x, r = _rand(rng, (4, 256), bf, cuda), _rand(rng, (64, 256), bf, cuda)
    xm = _rand(rng, (64, 256), bf, cuda)
    before = (fa.flash_attention.launches, drs_search.drs_project.launches)
    for args in ((_unaligned(q), q, q), (q, q, _unaligned(q))):
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(*args)
    for args in ((_unaligned(x), r), (x, _unaligned(r)), (_unaligned(xm), r)):
        with pytest.raises(ValueError, match="16-byte"):
            drs_search.drs_project(*args)
    assert (fa.flash_attention.launches,
            drs_search.drs_project.launches) == before
    xc, wg, wu, wd = _csr_weights(rng, 4, 256, 1024, bf, cuda)
    idx, counts = (torch.from_numpy(a).to(cuda)
                   for a in _csr_case(rng, "padded", k=4, g=8))
    q, kn, vn, kp, vp, pt, pos = _paged_inputs(rng, 2, 16, 8, 128, 16, 4,
                                               [3, 20], bf, cuda)
    before = (dsg_ffn.dsg_ffn_csr.launches,
              paged_attention.paged_decode.launches)
    for args in ((xc, _unaligned(wg), wu, wd), (xc, wg, wu, _unaligned(wd)),
                 (_unaligned(xc), wg, wu, wd)):
        with pytest.raises(ValueError, match="16-byte"):
            dsg_ffn.dsg_ffn_csr(*args, idx, counts)
    for bad in ((q, _unaligned(kn), vn, kp, vp),
                (q, kn, vn, kp, _unaligned(vp))):
        with pytest.raises(ValueError, match="16-byte"):
            paged_attention.paged_decode(*bad, pt, pos)
    assert (dsg_ffn.dsg_ffn_csr.launches,
            paged_attention.paged_decode.launches) == before
    x32, r32 = _unaligned(x.float()), _unaligned(r.float())
    _close(drs_search.drs_project(x32, r32),
           drs_search.drs_project_plain(x32, r32), torch.float32)


def test_ops_launch_kernels_on_card(cuda):
    """CUDA tensors go through the kernels: each call adds one launch, and
    dsg_ffn_full launches the DRS kernels and the tile-masked FFN once
    each."""
    rng = np.random.default_rng(5)
    x = _rand(rng, (4, 64), torch.float32, cuda)
    r = _rand(rng, (64, 64), torch.float32, cuda)
    before = drs_search.drs_project.launches
    ops.drs_project(x, r)
    assert drs_search.drs_project.launches == before + 1
    x, wg, wu, wd, _ = _tile_ffn_inputs(rng, 64, 64, 256, 64, torch.float32,
                                        cuda)
    fw = r @ wg
    wrappers = (drs_search.drs_project, drs_search.drs_scores,
                dsg_ffn.dsg_ffn)
    before = [w.launches for w in wrappers]
    y = ops.dsg_ffn_full(x, wg, wu, wd, r, fw, gamma=0.5, block=64)
    assert [w.launches for w in wrappers] == [b + 1 for b in before]
    assert y.shape == x.shape
    q = _rand(rng, (2, 32, 16), torch.float32, cuda)
    before = fa.flash_attention.launches
    ops.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before + 1


def _smoke_engine(device, dsg_serving, cache_backend="paged",
                  decode_chunk=1, max_seq=64, page_size=8,
                  arch="internlm2-1.8b"):
    cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    model = model.to(device)
    dsg = {k: v.to(device) for k, v in dsg.items()}
    return ServingEngine(cfg, model, dsg, n_slots=2, max_seq=max_seq,
                         prompt_bucket=32, page_size=page_size,
                         cache_backend=cache_backend,
                         dsg_serving=dsg_serving, decode_chunk=decode_chunk)


def _smoke_requests(vocab):
    return mixed_requests(vocab, 6, seed=23, prompt_range=(4, 30),
                          max_new_range=(3, 9))


def _smoke_streams(device, dsg_serving, cache_backend="paged",
                   decode_chunk=1, arch="internlm2-1.8b", engine=False):
    eng = _smoke_engine(device, dsg_serving, cache_backend, decode_chunk,
                        arch=arch)
    for r in _smoke_requests(eng.cfg.vocab):
        eng.submit(r)
    streams = {u: r.output for u, r in eng.run(400).items()}
    return (streams, eng) if engine else streams


@pytest.mark.parametrize("dsg_serving", [None, DSGServingConfig(2)])
def test_engine_streams_card_match_cpu_on_card(cuda, dsg_serving):
    """The smoke engine in f32 on the card (kernels) and on the CPU (plain
    versions) emits the same greedy streams."""
    assert (_smoke_streams(cuda, dsg_serving)
            == _smoke_streams(torch.device("cpu"), dsg_serving))


@pytest.mark.parametrize("dsg_serving", [None, DSGServingConfig(8)],
                         ids=["no_dsg", "dsg"])
@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_engine_backends_and_chunks_card_match_cpu_on_card(
        cuda, backend, chunk, dsg_serving):
    """The dense backend and the fused chunk (CUDA graph replays on the
    card, the eager micro-step loop on the CPU) emit the CPU's streams."""
    assert (_smoke_streams(cuda, dsg_serving, backend, chunk)
            == _smoke_streams(torch.device("cpu"), dsg_serving, backend,
                              chunk))


@pytest.mark.parametrize("backend,chunk,dsg_on,sharing", [
    ("paged", 1, True, None), ("dense", 8, False, None),
    ("paged", 1, False, 28), ("paged", 8, True, 20)])
def test_sampling_and_prefix_sharing_card_match_cpu_on_card(
        cuda, backend, chunk, dsg_on, sharing):
    """Half the requests sampled (temperature 0.8, top_p 0.9; the noise is
    an integer hash, the same bits on both devices), and prefix sharing
    over 28-token prompts whose first `sharing` tokens agree (all 28:
    identical prompts, a shared partial tail copied on write): the card's
    streams (graph replays at chunk 8, the sampling graphs among them)
    equal the CPU's."""
    from repro_torch.serving.workload import shared_prefix_requests

    def streams(device):
        cfg = configs.get_smoke_config("internlm2-1.8b")
        cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
        gen = torch.Generator().manual_seed(0)
        model = api.init_model(cfg, generator=gen, device="cpu")
        dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
        model = model.to(device)
        dsg = {k: v.to(device) for k, v in dsg.items()}
        if sharing is None:
            reqs, kw = _smoke_requests(cfg.vocab), {}
        else:
            reqs = shared_prefix_requests(cfg.vocab, 6, prompt_len=28,
                                          prefix_len=sharing, max_new=7,
                                          seed=29)
            kw = dict(buckets=(28,), prefix_sharing=True)
        for r in reqs[1::2]:
            r.temperature, r.top_p = 0.8, 0.9
        eng = ServingEngine(cfg, model, dsg, n_slots=2, max_seq=64,
                            prompt_bucket=32, page_size=8,
                            cache_backend=backend, decode_chunk=chunk,
                            dsg_serving=DSGServingConfig(8) if dsg_on
                            else None, **kw)
        for r in reqs:
            eng.submit(r)
        out = {u: list(r.output) for u, r in eng.run(400).items()}
        if eng.graphs is not None:
            assert any(k[-1] for k in eng.graphs.graphs)   # a sample key
        return out
    assert streams(cuda) == streams(torch.device("cpu"))


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_lane_reaching_max_seq_mid_chunk_on_card(cuda, backend):
    """A lone request stops at max_seq (60) after 28 micro-steps, mid-chunk:
    the graph's last micro-steps feed every lane the position max_seq, the
    dense write stays inside the stripe, and the card's stream equals the
    CPU's."""
    def stream(device):
        eng = _smoke_engine(device, None, backend, 8, max_seq=60,
                            page_size=4)
        eng.submit(Request(uid=0, prompt=np.arange(29, dtype=np.int32) + 1,
                           max_new=64))
        return list(eng.run(400)[0].output), eng.steps
    want = stream(torch.device("cpu"))
    assert want[1] == len(want[0]) == 28
    assert stream(cuda) == want


def test_chunk_graph_launch_accounting_on_card(cuda):
    """After warmup_engine has captured every key, a run captures nothing
    more: the wrappers' counters then hold only eager launches (the DRS
    kernels' at admission), and the graph cache's captured launches x
    replays give the decode kernels layers x chunk x replays and the DRS
    kernels layers x refresh replays."""
    from repro_torch.serving import cuda_graphs, workload
    eng = _smoke_engine(cuda, DSGServingConfig(8), "paged", 8)
    workload.warmup_engine(eng, eng.cfg.vocab)
    keys = set(eng.graphs.graphs)
    assert len(keys) == 4 * 2        # live-page buckets 1-8 x refresh
    for w in cuda_graphs.WRAPPERS:
        for n in [n for n in vars(w) if n.startswith("launches")]:
            setattr(w, n, 0)
    for r in _smoke_requests(eng.cfg.vocab):
        eng.submit(r)
    done = eng.run(400)
    assert set(eng.graphs.graphs) == keys
    replays = sum(eng.graphs.replays.values())
    n_l = eng.cfg.n_layers
    assert len(done) == 6 and replays > 0 and eng.refresh_steps > 0
    for w in (paged_attention.paged_decode, dsg_ffn.dsg_ffn_csr):
        assert w.launches == 0
        assert eng.graphs.launches(w) == n_l * 8 * replays
    for w in (drs_search.drs_project, drs_search.drs_scores):
        assert w.launches == n_l * eng.admissions
        assert eng.graphs.launches(w) == n_l * eng.refresh_steps


def test_graph_cache_replays_and_counts_on_card(cuda):
    """A key is captured once, without running, and replayed after: each
    replay computes the eager call's output on what was staged for it, and
    the counter counts the capture's launch while the cache counts the
    replays'."""
    from repro_torch.serving import cuda_graphs
    cache = cuda_graphs.GraphCache(cuda, 32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    wg = torch.randn(16, 64, device=cuda, generator=gen)
    wu = torch.randn(16, 64, device=cuda, generator=gen)
    wd = torch.randn(64, 16, device=cuda, generator=gen)
    idx = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32, device=cuda)
    counts = torch.tensor([2, 1], dtype=torch.int32, device=cuda)
    (x,) = cache.views([(2, 16)])

    def fn():
        return ops.dsg_ffn_csr(x.float() / 32, wg, wu, wd, idx, counts,
                               block=16)
    dsg_ffn.dsg_ffn_csr.launches = 0
    for i, seed in enumerate((1, 2)):
        vals = np.random.default_rng(seed).integers(-32, 32, 32)
        cache.stage([vals.astype(np.int32)])
        out = cache.replay("k", fn)
        torch.cuda.synchronize()
        got = out.clone()
        want = fn()                  # eager, on the same staged input
        torch.cuda.synchronize()
        assert float(got.abs().max()) > 0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert cache.replays["k"] == i + 1
    assert len(cache.graphs) == 1
    assert cache.launches(dsg_ffn.dsg_ffn_csr) == 2         # the replays'
    assert dsg_ffn.dsg_ffn_csr.launches == 1 + 2    # capture + eager calls


def test_graph_capture_failure_raises_on_card(cuda):
    """A chunk that reads a value back to the host cannot be captured: the
    capture raises, and nothing falls back to an eager run."""
    from repro_torch.serving import cuda_graphs
    cache = cuda_graphs.GraphCache(cuda, 4)
    x = torch.ones(4, device=cuda)

    def fn():
        return x * float(x.sum())      # .item() inside the capture
    with pytest.raises(RuntimeError):
        cache.replay("sync", fn)
    assert "sync" not in cache.graphs


def _smoke_training(device, steps=4):
    """The smoke model (f32) trained `steps` steps from one CPU
    initialisation: its losses and the forward passes' DRS masks."""
    from repro_torch.core import dsg_linear
    from repro_torch.launch import train
    cfg = configs.get_smoke_config("internlm2-1.8b")
    cfg = cfg.replace(dsg=cfg.dsg._replace(refresh_every=2))
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = {k: v.to(device) for k, v in api.init_dsg(
        model, cfg, generator=gen, device="cpu").items()}
    model = model.to(device)
    masks, orig = [], dsg_linear.drs_group_mask

    def rec(x, state, c):
        m = orig(x, state, c)
        masks.append(m.cpu())
        return m
    dsg_linear.drs_group_mask = rec
    try:
        _, hist, monitor = train.train(cfg, steps=steps, global_batch=4,
                                       seq_len=32, device=device,
                                       init=(model, dsg))
    finally:
        dsg_linear.drs_group_mask = orig
    assert monitor.failures == []
    n = cfg.n_layers
    return ([h["loss"] for h in hist],
            [m for i, m in enumerate(masks) if i % (2 * n) < n])


def test_training_steps_card_match_cpu_on_card(cuda):
    """Four training steps at smoke width in f32 (TF32 off): the card's
    losses equal the CPU's to rtol 1e-5 and every DRS mask is the same."""
    card_losses, card_masks = _smoke_training(cuda)
    cpu_losses, cpu_masks = _smoke_training(torch.device("cpu"))
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-5)
    assert len(card_masks) == len(cpu_masks) == 8
    for a, b in zip(card_masks, cpu_masks):
        assert torch.equal(a, b)


def test_trained_bf16_model_keeps_master_weights_on_card(cuda):
    """A bf16 model trains with f32 master weights on the card: the
    parameters stay bf16 and equal their masters rounded, and the serving
    entry points record no autograd on the trained model."""
    from repro_torch.launch import train
    cfg = configs.get_smoke_config("internlm2-1.8b").replace(
        dtype="bfloat16")
    state, hist, _ = train.train(cfg, steps=3, global_batch=2, seq_len=16,
                                 device=cuda)
    assert all(np.isfinite(h["loss"]) for h in hist)
    for n, p in state["model"].named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        assert torch.equal(p.detach(), state["opt"]["master"][n].bfloat16())
    cache = api.make_cache(cfg, 1, 16, device=cuda)
    logits, cache = api.prefill(state["model"], state["dsg"], cfg,
                                {"tokens": torch.zeros(1, 4, dtype=torch.long,
                                                       device=cuda)}, cache)
    assert not logits.requires_grad and not cache["k"].requires_grad


# -- the router's executors on the card ------------------------------------------

def _router_streams(device, exec_mode, *, backend="paged", chunk=8,
                    dsg_serving=None, replicas=2, faults=None,
                    policy="least_queue"):
    """The smoke model's greedy streams (f32) over 6 requests through one
    engine (replicas=None) or a warmed Router; returns (streams, router or
    engine)."""
    from repro_torch.runtime.fault_tolerance import ServingFaultInjector
    from repro_torch.serving.router import Router
    from repro_torch.serving.workload import warmup_engine, warmup_router
    eng = _smoke_engine(device, dsg_serving, backend, chunk)
    if replicas is None:
        warmup_engine(eng, eng.cfg.vocab)
        runner = eng
    else:
        runner = Router(eng.cfg, eng.model, eng.dsg, n_replicas=replicas,
                        policy=policy, exec_mode=exec_mode, n_slots=2,
                        max_seq=64, prompt_bucket=32, page_size=8,
                        cache_backend=backend, dsg_serving=dsg_serving,
                        decode_chunk=chunk,
                        fault_tolerance=True if faults else None)
        warmup_router(runner, eng.cfg.vocab)
        if faults:
            ServingFaultInjector(faults).attach(runner.engines)
    engines = [eng] if replicas is None else runner.engines
    keys = [set(e.graphs.graphs) for e in engines if e.graphs is not None]
    for r in _smoke_requests(eng.cfg.vocab):
        runner.submit(r)
    try:
        done = runner.run(4000)
    finally:
        if replicas is not None:
            runner.close()
    assert all(r.status == "ok" for r in done.values()) and len(done) == 6
    # every key was captured by the warm-up: the run captured nothing
    assert keys == [set(e.graphs.graphs) for e in engines
                    if e.graphs is not None]
    return {u: list(r.output) for u, r in done.items()}, runner


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("dsg_serving", [None, DSGServingConfig(8)],
                         ids=["no_dsg", "dsg"])
def test_threaded_router_streams_equal_one_engine_on_card(
        cuda, dsg_serving, chunk):
    """Two replicas, each driven by its worker thread on its own stream,
    give one engine's streams on the card; the drive captures no graph
    (warmup_router captured every key) and a kill mid-run changes no
    stream."""
    from repro_torch.runtime.fault_tolerance import ReplicaFault
    want, _ = _router_streams(cuda, None, chunk=chunk,
                              dsg_serving=dsg_serving, replicas=None)
    got, router = _router_streams(cuda, "threaded", chunk=chunk,
                                  dsg_serving=dsg_serving)
    assert got == want
    assert all(s is not None for s in router.executor._streams)
    # round_robin puts every other request on replica 1, so it reaches
    # step 3 while it holds requests
    got, router = _router_streams(cuda, "threaded", chunk=chunk,
                                  dsg_serving=dsg_serving,
                                  faults=[ReplicaFault(replica=1, step=3)],
                                  policy="round_robin")
    assert got == want
    assert router.health[1].restarts == 1


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_sharded_group_graph_streams_equal_one_engine_on_card(
        cuda, backend, chunk):
    """One group tick is one replay of a graph that holds both replicas'
    step (chunk 1) or chunk bodies: the streams are one engine's, warm()
    captured every key, and the paged kernel's replayed launches are
    layers x chunk x 2 replicas x ticks."""
    want, _ = _router_streams(cuda, None, backend=backend, chunk=chunk,
                              replicas=None)
    got, router = _router_streams(cuda, "sharded", backend=backend,
                                  chunk=chunk)
    assert got == want
    # the group graph replaces the engines' chunk graphs
    assert all(e.graphs is None for e in router.engines)
    graphs = router.executor.graphs
    ticks = sum(graphs.replays.values())
    n_l = router.engines[0].cfg.n_layers
    assert ticks > 0 and len(graphs.graphs) == len(graphs.captured)
    keys = {k[0] for k in graphs.graphs}
    want_keys = ({1, 2, 4, 8} if backend == "paged" else {0})
    assert keys == want_keys
    if backend == "paged":
        assert graphs.launches(paged_attention.paged_decode) == \
            n_l * chunk * 2 * ticks


# -- serving replicas across ranks and cards ---------------------------------

REPLICA_TWIN = r"""
import sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import configs
from repro_torch.kernels import paged_attention
from repro_torch.models import api
from repro_torch.parallel.sharding import replica_mesh
from repro_torch.serving.router import Router
from repro_torch.serving.workload import mixed_requests, warmup_router
try:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = configs.get_smoke_config("internlm2-1.8b")
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    model = model.to(dev)
    dsg = {k: v.to(dev) for k, v in dsg.items()}
    out = {}
    for backend in ("dense", "paged"):
        for chunk in (1, 8):
            router = Router(cfg, model, dsg, n_replicas=4,
                            policy="round_robin", exec_mode="sharded",
                            mesh=replica_mesh(n, "cuda"),
                            n_slots=2, max_seq=64, prompt_bucket=32,
                            page_size=8, cache_backend=backend,
                            decode_chunk=chunk)
            warmup_router(router, cfg.vocab)
            graphs = router.executor.graphs
            for r in mixed_requests(cfg.vocab, 6, seed=23,
                                    prompt_range=(4, 30),
                                    max_new_range=(3, 9)):
                router.submit(r)
            done = router.run(4000)
            out[(backend, chunk)] = {
                "streams": {u: list(r.output) for u, r in done.items()},
                "log": list(router.dispatch_log), "steps": router.steps,
                "local": router.executor.local,
                "replays": sum(graphs.replays.values()),
                "split": graphs.launches(paged_attention.paged_decode)}
    every = [None] * n
    dist.all_gather_object(every, out)
    if rank == 0:
        dump(every, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def replica_twins(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_harness as mh
    return mh.run_ranks(tmp_path_factory.mktemp("replica_twins"),
                        REPLICA_TWIN, 2)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_replica_mesh_ranks_match_one_process_on_card(cuda, replica_twins,
                                                      backend, chunk):
    """Four replicas over two gloo ranks on the card, a block of two a
    rank, each rank's group in its own graphs: every rank returns the
    one-process sharded router's streams, dispatch log and steps, and a
    rank's paged launches are layers x chunk x 2 x its replays."""
    want, one = _router_streams(cuda, "sharded", backend=backend,
                                chunk=chunk, replicas=4,
                                policy="round_robin")
    n_l = one.engines[0].cfg.n_layers
    for k, ranks in enumerate(replica_twins):
        got = ranks[(backend, chunk)]
        assert got["local"] == [2 * k, 2 * k + 1]
        assert got["streams"] == want
        assert got["log"] == one.dispatch_log
        assert got["steps"] == one.steps
        assert got["replays"] > 0
        if backend == "paged":
            assert got["split"] == n_l * chunk * 2 * got["replays"]


def test_threaded_router_places_replicas_on_cards_on_card(cuda):
    """With several cards, a threaded router of 4 replicas runs replica r on
    a copy of the model on card r % count (replica 0 on the caller's), and
    the streams are one engine's."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two CUDA devices")
    want, eng = _router_streams(cuda, None, chunk=8, replicas=None)
    got, router = _router_streams(cuda, "threaded", chunk=8, replicas=4,
                                  policy="round_robin")
    assert got == want
    assert [e.device for e in router.engines] == [
        torch.device("cuda", r % count) for r in range(4)]
    assert all(e.graphs.device == e.device for e in router.engines)
    assert all(sum(e.graphs.replays.values()) > 0 for e in router.engines)


def test_kernel_for_another_card_launches_there_on_card(cuda):
    """A wrapper makes its operands' card current around its launch: called
    with cuda:0 current on operands on cuda:1 it runs on cuda:1 and agrees
    with the plain version.  The launch itself checks it: the stream
    argument of a launch for cuda:1 raises while cuda:0 is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    one = torch.device("cuda", 1)
    args = _paged_inputs(np.random.default_rng(0), 2, 4, 2, 16, 8, 4,
                         [3, 9], torch.float32, one)
    with torch.cuda.device(0):
        o, _, _ = _run_paged(paged_attention.paged_decode, args)
        with pytest.raises(RuntimeError, match="current device"):
            cuda_lib.stream(one)
    ow, _, _ = _run_paged(paged_attention.paged_decode_plain, args)
    assert o.device == one
    _close(o, ow, torch.float32)


def test_capture_inside_threaded_drive_raises_on_card(cuda):
    """A chunked engine that was not warmed meets its first graph key
    inside a threaded drive: the capture is refused and raises, and the
    engine never runs the chunk eagerly instead."""
    from repro_torch.serving.router import Router
    eng = _smoke_engine(cuda, None, "paged", 8)
    router = Router(eng.cfg, eng.model, eng.dsg, n_replicas=2,
                    exec_mode="threaded", n_slots=2, max_seq=64,
                    prompt_bucket=32, page_size=8, cache_backend="paged",
                    decode_chunk=8)
    for r in _smoke_requests(eng.cfg.vocab):
        router.submit(r)
    try:
        with pytest.raises(RuntimeError, match="captures are closed"):
            router.run(400)
    finally:
        router.close()
    assert all(not e.graphs.graphs for e in router.engines)
    assert all(e.graphs.capture_open for e in router.engines)


# -- the MoE layer and the other decoder families --------------------------

def _moe_parts(device, n_shared=1, mode="shared"):
    """A smoke-width MoE layer (d 64, 4 experts of 128, top-2) with DSG
    state, built on the CPU from a seed and moved to `device`."""
    from repro_torch.core.dsg_linear import DSGConfig
    from repro_torch.core.projection import make_projection
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(64, 4, 128, n_shared, generator=gen,
                     dtype=torch.float32)
    r = make_projection(64, 64, generator=gen)
    st = {"r": r, "fw_experts": torch.matmul(r, p.w_gate)}
    if n_shared:
        st["shared"] = {"r": r, "fw": r @ p.shared.w_gate}
    x = torch.randn(2, 12, 64, generator=gen)
    dsg = DSGConfig(enabled=True, gamma=0.5, block=32, threshold_mode=mode)

    def move(t):
        return ({k: move(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(device))
    return p.to(device), move(st), x.to(device), dsg


@pytest.mark.parametrize("mode", ["topk", "shared"])
@pytest.mark.parametrize("factor", [1.25, 0.25])
def test_moe_ffn_card_matches_cpu_on_card(cuda, mode, factor):
    """The MoE layer on the card (f32, TF32 off) against the CPU, with
    drops at factor 0.25; two calls on the card are bitwise equal (the
    combine adds in a fixed order, no atomics), and the routed body
    captured in a CUDA graph replays to the eager result: it reads nothing
    back to the host."""
    from repro_torch.models import moe
    kw = dict(n_experts=4, top_k=2, capacity_factor=factor)
    p, st, x, dsg = _moe_parts(torch.device("cpu"), mode=mode)
    want, aux_want = moe.moe_ffn(p, x, dsg=dsg, dsg_state=st, **kw)
    p, st, x, dsg = _moe_parts(cuda, mode=mode)
    got, aux = moe.moe_ffn(p, x, dsg=dsg, dsg_state=st, **kw)
    again, _ = moe.moe_ffn(p, x, dsg=dsg, dsg_state=st, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), aux_want, rtol=1e-6, atol=0)
    assert torch.equal(got, again)
    static = x.clone()
    moe.moe_ffn(p, static, dsg=dsg, dsg_state=st, aux_kind=None, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = moe.moe_ffn(p, static, dsg=dsg, dsg_state=st,
                             aux_kind=None, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_moe_combine_order_on_card(cuda):
    """On the card a token's output is bitwise the f32 sum from 0.0, in
    ascending expert order, of its experts' outputs times their weights."""
    from repro_torch.core.dsg_linear import DSGConfig
    from repro_torch.models import moe
    p, _, x, _ = _moe_parts(cuda, n_shared=0)
    x2d = x.reshape(-1, 64)
    logits = x2d @ p.router
    cap = 24
    y = moe.routed_body(x2d, logits, p, 4, 2, cap, None, None, DSGConfig())
    w, e = moe.router_topk(torch.softmax(logits, -1), 2)
    w = w / w.sum(-1, keepdim=True)
    slot_e, slot_p, in_cap = moe.dispatch(e, 4, cap)
    assert bool(in_cap.all())
    idx = torch.full((4, cap), 24, dtype=torch.int64, device=cuda)
    idx[slot_e, slot_p] = torch.arange(48, device=cuda) // 2
    xg = torch.cat([x2d, x2d.new_zeros(1, 64)])[idx]
    ye = torch.bmm(torch.nn.functional.silu(torch.bmm(xg, p.w_gate))
                   * torch.bmm(xg, p.w_up), p.w_down)
    for t in range(24):
        acc = torch.zeros(64, device=cuda)
        for k in sorted(range(2), key=lambda k: int(e[t, k])):
            acc = acc + ye[slot_e[2 * t + k], slot_p[2 * t + k]] * w[t, k]
        assert torch.equal(y[t], acc), t


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "llava-next-34b"])
def test_family_engine_streams_card_match_cpu_on_card(cuda, arch, backend,
                                                      chunk):
    """The MoE and VLM smoke engines (f32, DSG on in mask mode) emit the
    CPU's greedy streams on the card; at chunk 8 every chunk is a graph
    replay, the MoE's routed body inside it."""
    got, eng = _smoke_streams(cuda, None, backend, chunk, arch=arch,
                              engine=True)
    assert got == _smoke_streams(torch.device("cpu"), None, backend, chunk,
                                 arch=arch)
    if chunk > 1:
        assert sum(eng.graphs.replays.values()) > 0


# -- the recurrent families on the card ---------------------------------------

def _recurrent_smoke(arch, device):
    """`arch`'s smoke model (f32; DSG's per-row top-k threshold, as the
    other card == CPU checks) built on the CPU from seed 0 and moved to
    `device`."""
    cfg = configs.get_smoke_config(arch)
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk",
                                           refresh_every=2))
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    return cfg, model.to(device), {k: v.to(device) for k, v in dsg.items()}


@pytest.mark.parametrize("prompt", [12, 24])
@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_recurrent_generate_card_matches_cpu_on_card(cuda, arch, prompt):
    """`generate`'s greedy streams on the card equal the CPU's; 24 is past
    zamba's smoke window of 16, so its ring and window mask both run."""
    from repro_torch.launch import serve
    prompts = torch.from_numpy(np.random.default_rng(prompt).integers(
        0, 256, (2, prompt)))
    streams = []
    for device in (cuda, torch.device("cpu")):
        cfg, model, dsg = _recurrent_smoke(arch, device)
        streams.append(serve.generate(cfg, model, dsg, prompts.to(device),
                                      8).cpu())
    assert torch.equal(*streams)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_recurrent_training_steps_card_match_cpu_on_card(cuda, arch):
    """Two training steps at smoke width in f32 (TF32 off): the card's
    losses equal the CPU's to rtol 1e-5."""
    from repro_torch.launch import train
    losses = []
    for device in (cuda, torch.device("cpu")):
        cfg, model, dsg = _recurrent_smoke(arch, device)
        _, hist, monitor = train.train(cfg, steps=2, global_batch=4,
                                       seq_len=32, device=device,
                                       init=(model, dsg))
        assert monitor.failures == []
        losses.append([h["loss"] for h in hist])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


# -- the encoder-decoder family on the card ----------------------------------

def _whisper_smoke(dsg_mode, device):
    """whisper-large-v3's smoke model (f32) built on the CPU from seed 0
    and moved to `device`; dsg_mode "off", "topk" (the per-row threshold,
    as the other card == CPU checks) or "shared" (the config's)."""
    cfg = configs.get_smoke_config("whisper-large-v3")
    if dsg_mode == "off":
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    else:
        cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode=dsg_mode))
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    return cfg, model.to(device), (None if dsg is None else
                                   {k: v.to(device) for k, v in dsg.items()})


@pytest.mark.parametrize("dsg_mode", ["off", "topk", "shared"])
def test_whisper_prefill_and_decode_card_match_cpu_on_card(cuda, dsg_mode):
    """api.prefill on make_inputs' frames and 8 greedy decode steps: the
    card's logits equal the CPU's to 1e-4 and the streams are equal."""
    from repro_torch.configs.base import ShapeConfig
    runs = []
    for device in (cuda, torch.device("cpu")):
        cfg, model, dsg = _whisper_smoke(dsg_mode, device)
        inputs = api.make_inputs(cfg, ShapeConfig("p", 64, 2, "prefill"),
                                 concrete=True, seed=3, device=device)
        logits, st = api.prefill(model, dsg, cfg, inputs,
                                 api.make_cache(cfg, 2, 128, device=device))
        out, toks = [logits.cpu()], []
        for i in range(8):
            tok = torch.argmax(logits, -1)[:, None]
            toks.append(tok.cpu())
            logits, st = api.decode_step(model, dsg, cfg, tok, st,
                                         inputs["tokens"].shape[1] + i)
            out.append(logits.cpu())
        runs.append((torch.cat(toks, 1), out))
    assert torch.equal(runs[0][0], runs[1][0])
    for got, want in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dsg_mode", ["off", "shared"])
def test_whisper_train_loss_card_matches_cpu_on_card(cuda, dsg_mode):
    """api.train_loss and its gradients (remat on) on the card against
    the CPU's: loss rtol 1e-5, each gradient within 1e-5 x max(1,
    max|g|)."""
    from repro_torch.configs.base import SMOKE_SHAPE
    runs = []
    for device in (cuda, torch.device("cpu")):
        cfg, model, dsg = _whisper_smoke(dsg_mode, device)
        model.requires_grad_(True)
        batch = api.make_inputs(cfg, SMOKE_SHAPE, concrete=True,
                                device=device)
        loss = api.train_loss(model, dsg, cfg, batch)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((loss.item(), [g.cpu() for g in grads]))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    for got, want in zip(runs[0][1], runs[1][1]):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)


# -- the model's parallel parts on two gloo ranks of the card ----------------
#
# The shard_map bodies on a (data 1, model 2) mesh of two ranks on cuda:0,
# against the same ranks' run on a CPU mesh of the same gloo group, in f32
# (TF32 off): the sharded gather FFN forward and backward
# (`swiglu_dsg_gather_sharded`), the MoE's routed experts under expert
# parallelism (`moe._routed_ep`, DSG on and off), `pipeline_forward` over
# 'pipe' 2 and `compressed_psum`.  The whole smoke model's sharded
# train_loss has no twin here: DTensor's all_gather, which its layouts
# need, segfaults under gloo on CUDA tensors (PERF.md §7); it is held on
# gloo CPU ranks by tests/test_torch_sharded_model.py.

MESH_TWINS = r'''
import sys
from pathlib import Path
from types import SimpleNamespace
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate
from repro_torch import configs
from repro_torch.core import dsg_linear as dl
from repro_torch.core.projection import make_projection
from repro_torch.models import moe
from repro_torch.optim.compress import compressed_psum
from repro_torch.parallel import context as pctx
from repro_torch.parallel.collectives import shard_map
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.sharding import P, distribute
try:
    out = {}
    for dev in ("cpu", "cuda"):
        mesh = DeviceMesh(dev, torch.arange(2).reshape(1, 2),
                          mesh_dim_names=("data", "model"))
        gen = torch.Generator().manual_seed(0)
        cfg = configs.get_smoke_config("internlm2-1.8b")
        d, f = cfg.d_model, cfg.d_ff
        rnd = lambda *s: torch.randn(s, generator=gen)
        w = {"w_gate": rnd(d, f) / d ** 0.5, "w_up": rnd(d, f) / d ** 0.5,
             "w_down": rnd(f, d) / f ** 0.5}
        r = make_projection(dl.proj_dim(d, f, cfg.dsg), d, generator=gen)
        x, gy = rnd(2, 8, d), rnd(2, 8, d)
        specs = {"w_gate": P(None, "model"), "w_up": P(None, "model"),
                 "w_down": P("model", None)}
        wd = {k: distribute(v.to(dev), mesh, specs[k]).requires_grad_(True)
              for k, v in w.items()}
        st = {"r": distribute(r.to(dev), mesh, P()),
              "fw": distribute((r @ w["w_gate"]).to(dev), mesh,
                               P(None, "model"))}
        xd = distribute(x.to(dev), mesh, P(("data",), None, None))
        xd.requires_grad_(True)
        gyd = distribute(gy.to(dev), mesh, P(("data",), None, None))
        dcfg = cfg.dsg._replace(mode="gather_shared", n_chunks=2)
        with pctx.use_mesh(mesh):
            y = dl.swiglu_dsg_gather_sharded(SimpleNamespace(**wd), xd, st,
                                             dcfg)
            g = torch.autograd.grad(y, [xd] + list(wd.values()),
                                    grad_outputs=gyd)
            dx = g[0].redistribute(mesh, [g[0].placements[0], Replicate()])
        res = {"ffn_y": y.to_local(), "ffn_dx": dx.to_local(),
               "ffn_dw": [t.to_local() for t in g[1:]]}

        mcfg = configs.get_smoke_config("deepseek-moe-16b")
        e, fe = mcfg.moe_experts, mcfg.moe_d_ff
        mw = dict(w_gate=rnd(e, d, fe) / d ** 0.5, w_up=rnd(e, d, fe) / d ** 0.5,
                  w_down=rnd(e, fe, d) / fe ** 0.5)
        mr = make_projection(dl.proj_dim(d, fe, mcfg.dsg), d, generator=gen)
        fw = torch.matmul(mr, mw["w_gate"])
        xm = rnd(16, d)
        logits = xm @ (rnd(d, e) / d ** 0.5)
        ep = P("model", None, None)
        pd = SimpleNamespace(**{k: distribute(v.to(dev), mesh, ep)
                                for k, v in mw.items()})
        for on in (True, False):
            dsg = mcfg.dsg if on else mcfg.dsg._replace(enabled=False)
            with pctx.use_mesh(mesh):
                ym = moe._routed_ep(
                    xm.to(dev), logits.to(dev), pd, mesh, ("data",), e,
                    mcfg.moe_topk, mcfg.moe_capacity_factor,
                    distribute(fw.to(dev), mesh, ep) if on else None,
                    mr.to(dev) if on else None, dsg)
            res[f"moe_{on}"] = ym.to_local()

        pmesh = DeviceMesh(dev, torch.arange(2), mesh_dim_names=("pipe",))
        stages = {"w": (rnd(2, d, d) / d ** 0.5).to(dev)}
        res["pipe"] = pipeline_forward(
            lambda p, h: torch.tanh(h @ p["w"]), stages,
            rnd(4, 2, d).to(dev), pmesh).to_local()
        gs = rnd(2, 64).to(dev)
        run = shard_map(lambda gl, el: compressed_psum(gl, "model", el,
                                                       mesh=mesh),
                        mesh, (P("model"), P("model")),
                        (P("model"), P("model")))
        red, err = run(gs, torch.zeros_like(gs))
        res["cpsum"] = (red.to_local(), err.to_local())
        out[dev] = {k: ([t.cpu() for t in v] if isinstance(v, (list, tuple))
                        else v.cpu()) for k, v in res.items()}
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def mesh_twins(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch_mesh_harness as mh
    return mh.run_ranks(tmp_path_factory.mktemp("mesh_twins"), MESH_TWINS, 2)


@pytest.mark.parametrize("part", ["ffn_y", "ffn_dx", "ffn_dw", "moe_True",
                                  "moe_False", "pipe", "cpsum"])
def test_mesh_parts_on_card_match_cpu_ranks(mesh_twins, part):
    got, want = mesh_twins["cuda"][part], mesh_twins["cpu"][part]
    if not isinstance(got, list):
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **TOL[torch.float32])


# -- the whole smoke model sharded, under this machine's torch --------------
#
# The CPU tests hold the sharded model against the JAX package under the
# torch they run with; DTensor's sharding rules differ between torch
# versions (the card machine's refused einsum over head-sharded queries
# and the index backward of a sharded embedding, ROADMAP.md §3).  So the
# card's own torch runs the smoke model's sharded train_loss (every
# gradient taken), prefill and split-KV decode on a (data 2, model 2) mesh
# of four gloo CPU ranks, against the same model unsharded in the rank.
# (gloo cannot all_gather CUDA tensors, which the whole model's layouts
# need: PERF.md §7.)  Cases whose sharded semantics read local rows (MoE
# capacity and EP thresholds, the per-shard gather) are held finite only.

SHARDED_CASES = {
    "head": ("internlm2-1.8b", {}, {}, True),
    "seq": ("internlm2-1.8b", {"attn_shard": "seq"}, {}, True),
    "bf16": ("internlm2-1.8b", {"dtype": "bfloat16",
                                "attn_bf16_scores": True}, {}, True),
    "dsg_off": ("internlm2-1.8b", {}, {"enabled": False}, True),
    "topk": ("internlm2-1.8b", {}, {"threshold_mode": "topk"}, True),
    "gather": ("internlm2-1.8b", {},
               {"mode": "gather_shared", "n_chunks": 2}, False),
    "moe": ("deepseek-moe-16b", {}, {}, False),
    "whisper": ("whisper-large-v3", {}, {}, True),
    "decode": ("internlm2-1.8b", {}, {}, True),
    "prefill": ("deepseek-moe-16b", {"dtype": "bfloat16"}, {}, False),
}

SHARDED_RANKS = f"""
CASES = {SHARDED_CASES!r}
""" + r'''
import sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import configs
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import api, specs, transformer
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import (axes_for_mesh, distribute,
                                           distribute_model, distribute_tree)
try:
    mesh = make_elastic_mesh(4, model=2, device_type="cpu")
    ax = axes_for_mesh(mesh)
    out = {}
    for name, (arch, over, dover, _) in CASES.items():
        cfg = configs.get_smoke_config(arch).replace(**over)
        cfg = cfg.replace(dsg=cfg.dsg._replace(**dover))
        gen = torch.Generator().manual_seed(0)
        model = api.init_model(cfg, generator=gen, device="cpu")
        dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
        g2 = torch.Generator().manual_seed(1)
        if name == "whisper":
            batch = {"frames": torch.randn(4, 32, cfg.d_model, generator=g2),
                     "tokens": torch.randint(0, cfg.vocab, (4, 8),
                                             generator=g2),
                     "labels": torch.randint(0, cfg.vocab, (4, 8),
                                             generator=g2)}
        else:
            batch = {"tokens": torch.randint(0, cfg.vocab, (4, 16),
                                             generator=g2),
                     "labels": torch.randint(0, cfg.vocab, (4, 16),
                                             generator=g2)}
        if name in ("decode", "prefill"):
            cache = api.make_cache(cfg, 4, 32, device="cpu")
            want, cache = api.prefill(model, dsg, cfg,
                                      {"tokens": batch["tokens"]}, cache)
            if name == "decode":
                tok, pos = batch["tokens"][:, :1], torch.tensor([16, 15, 16,
                                                                 17])
                want, _ = api.decode_step(model, dsg, cfg, tok,
                                          {k: v.clone()
                                           for k, v in cache.items()}, pos)
        else:
            transformer.set_trainable(model)
            want = api.train_loss(model, dsg, cfg, batch)
        distribute_model(model, mesh, specs.param_specs(model, cfg, ax, 2))
        dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, cfg, ax, 2))
        if name == "decode":
            cache = distribute_tree(cache, mesh,
                                    specs.cache_specs(cache, cfg, ax, 2))
            got, _ = api.decode_step(model, dsg, cfg, tok, cache, pos,
                                     mesh=mesh, batch_axes=ax.batch)
        elif name == "prefill":
            got, _ = api.prefill(model, dsg, cfg, {"tokens": batch["tokens"]},
                                 api.make_cache(cfg, 4, 32, device="cpu"),
                                 mesh=mesh, batch_axes=ax.batch)
        else:
            bs = specs.input_specs(batch, cfg, ax)
            db = {k: distribute(v, mesh, bs[k]) for k, v in batch.items()}
            params = list(model.parameters())
            with pctx.use_mesh(mesh):
                got = api.train_loss(model, dsg, cfg, db, mesh=mesh,
                                     batch_axes=ax.batch)
                grads = torch.autograd.grad(got, params)
            assert all(torch.isfinite(g.full_tensor()).all() for g in grads)
        out[name] = (got.full_tensor().detach().float(),
                     want.detach().float())
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def sharded_under_this_torch(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("runs on the card machine's torch; needs a CUDA device")
    import torch_mesh_harness as mh
    return mh.run_ranks(tmp_path_factory.mktemp("sharded_torch"),
                        SHARDED_RANKS, 4)


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_smoke_model_runs_under_this_torch(sharded_under_this_torch,
                                                   case):
    got, want = sharded_under_this_torch[case]
    assert torch.isfinite(got).all()
    if SHARDED_CASES[case][3]:
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= (4e-3 if case == "bf16" else 1e-5), rel
