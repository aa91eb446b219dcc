"""The decode-step kernels' decompositions and plans, on the CPU.

The bf16 group-CSR FFN reads the union of the lanes' groups once (gate/up
split over d by cluster rank, the down projection split over runs of the
union, each summed in order), and the bf16 paged decode step splits each
lane's page walk S ways and merges the splits' (m, l, acc) in order.
Their plain PyTorch versions (`dsg_ffn.csr_union_plain`,
`paged_attention.paged_split_plain`) are held here against the Pallas
kernels in interpret mode, with inputs made by numpy from a seed; the
kernels themselves run only on the card (tests/test_torch_cuda.py).  The
plan functions that pick each kernel and its sizes are pure Python and
are checked at the main path's shapes.

Tolerances: f32 1e-4, where both sum exact f32 products in another order;
bf16 one ulp of the value (rtol 8e-3) plus 4e-3 near zero.  In bf16 both
sides compute in f32 from the same bf16 operands and round h and the
output to bf16; the Pallas CSR kernel also rounds its output accumulator
to bf16 after each of at most K = 4 slots here, which stays within that
bound at these magnitudes.  The paged pools are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors gain nothing from threads, which would only contend with
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dsg_ffn as jdf  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch.kernels import dsg_ffn, paged_attention  # noqa: E402

# the Pallas kernels in interpret mode, jitted so that each shape traces
# once
_pallas_csr = jax.jit(jdf.dsg_ffn_csr, static_argnames=("block", "interpret"))
_pallas_paged = jax.jit(jpa.paged_decode, static_argnames=(
    "window", "num_pages", "interpret"))

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=8e-3, atol=4e-3)}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


# --- group-CSR FFN ---------------------------------------------------------

CSR_B, CSR_D, CSR_F, CSR_BLOCK, CSR_K = 4, 64, 512, 64, 4   # G = 8 groups


def _csr_case(case):
    """idx/counts of one sweep case over G = 8 groups and K = 4 slots:
    "padded" (short lists zero-padded, group 0 listed by no lane), "empty"
    (a lane with count 0), "full" (counts equal to K), "mirrored" (every
    lane copies lane 0, as free serving lanes mirror a donor) and
    "disjoint" (no group shared)."""
    g = CSR_F // CSR_BLOCK
    idx = np.zeros((CSR_B, CSR_K), np.int32)
    rows = {"padded": [[1, 3, 6], [2, 5], [1, 2, 3, 7], [4]],
            "empty": [[0, 2, 4, 6], [], [1, 3], [5, 7]],
            "full": [[0, 1, 2, 3], [2, 3, 4, 5], [4, 5, 6, 7], [0, 3, 5, 7]],
            "mirrored": [[1, 2, 6]] * CSR_B,
            "disjoint": [[0, 1], [2, 3], [4, 5], [6, 7]]}[case]
    counts = np.asarray([len(r) for r in rows], np.int32)
    for lane, r in enumerate(rows):
        idx[lane, :len(r)] = r
    assert idx.max() < g
    return idx, counts


def _csr_inputs(case, dtype, seed=31):
    rng = np.random.default_rng(seed)
    d, f = CSR_D, CSR_F
    arrays = ((rng.standard_normal((CSR_B, d))).astype(np.float32),
              (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
              (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
              (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32))
    idx, counts = _csr_case(case)
    j = [jnp.asarray(a).astype(JD[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TD[dtype]) for a in arrays]
    return (j + [jnp.asarray(idx), jnp.asarray(counts)],
            t + [torch.from_numpy(idx), torch.from_numpy(counts)])


CSR_CASES = ["padded", "empty", "full", "mirrored", "disjoint"]


@pytest.mark.parametrize("cluster,splits", [(1, 1), (4, 3), (8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CSR_CASES)
def test_csr_union_plain_matches_pallas(case, dtype, cluster, splits):
    """The union decomposition over every sweep case, with d split 1, 4
    and 8 ways and the union split 1, 3 (ragged) and 8 ways (more splits
    than union groups leaves some empty)."""
    j, t = _csr_inputs(case, dtype)
    want = _pallas_csr(*j, block=CSR_BLOCK, interpret=True)
    got = dsg_ffn.csr_union_plain(*t, block=CSR_BLOCK, cluster=cluster,
                                  splits=splits)
    assert got.dtype == TD[dtype] and got.shape == (CSR_B, CSR_D)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    if case == "empty":
        np.testing.assert_array_equal(_np(got)[1], 0.0)
        np.testing.assert_array_equal(_np(want)[1], 0.0)


@pytest.mark.parametrize("case", CSR_CASES)
def test_csr_union_lists_only_counted_slots(case):
    """The union holds each listed group once, ascending, and no slot past
    a lane's count: the zero padding never adds group 0."""
    idx, counts = _csr_case(case)
    ulist, lists = dsg_ffn.csr_union(torch.from_numpy(idx),
                                     torch.from_numpy(counts),
                                     CSR_F // CSR_BLOCK)
    want = sorted({int(g) for lane in range(CSR_B)
                   for g in idx[lane, :counts[lane]]})
    assert ulist.tolist() == want
    for lane in range(CSR_B):
        assert {want[u] for u in range(len(want)) if lists[lane, u]} == set(
            idx[lane, :counts[lane]].tolist())
    if case == "padded":
        assert 0 not in want


def test_csr_union_zeroes_lanes_that_do_not_list_a_group():
    """A lane's output is its own groups' SwiGLU: the union path gives the
    same rows as running each lane alone."""
    _, t = _csr_inputs("padded", "float32")
    x, wg, wu, wd, idx, counts = t
    full = dsg_ffn.csr_union_plain(*t, block=CSR_BLOCK, cluster=2, splits=2)
    for lane in range(CSR_B):
        alone = dsg_ffn.csr_union_plain(
            x[lane:lane + 1], wg, wu, wd, idx[lane:lane + 1],
            counts[lane:lane + 1], block=CSR_BLOCK)
        torch.testing.assert_close(full[lane:lane + 1], alone, rtol=1e-5,
                                   atol=1e-5)


# --- paged decode ----------------------------------------------------------

PG_B, PG_H, PG_KV, PG_D, PG_PS, PG_MAX = 4, 4, 2, 16, 8, 8


def _paged_inputs(case, dtype, seed=32):
    """Pools with page 0 as scratch and distinct live pages per lane; in
    "mirrored" lane 3 copies lane 0's page-table row, position and new K/V
    (free-lane mirroring), in "short" every lane holds one to three pages."""
    rng = np.random.default_rng(seed)
    pos = {"short": [0, 7, 12, 20]}.get(case, [5, 17, 40, 63])
    n_pages = 1 + PG_B * PG_MAX
    mk = lambda shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, k_new, v_new = (mk((PG_B, PG_H, PG_D)), mk((PG_B, PG_KV, PG_D)),
                       mk((PG_B, PG_KV, PG_D)))
    k_pages = mk((n_pages, PG_PS, PG_KV, PG_D))
    v_pages = mk((n_pages, PG_PS, PG_KV, PG_D))
    table = np.zeros((PG_B, PG_MAX), np.int32)
    nxt = 1
    for lane in range(PG_B):
        for p in range(pos[lane] // PG_PS + 1):
            table[lane, p] = nxt
            nxt += 1
    pos = np.asarray(pos, np.int32)
    if case == "mirrored":
        table[3], pos[3] = table[0], pos[0]
        k_new[3], v_new[3] = k_new[0], v_new[0]
    floats = (q, k_new, v_new, k_pages, v_pages)
    j = [jnp.asarray(a).astype(JD[dtype]) for a in floats]
    t = [torch.from_numpy(a).to(TD[dtype]) for a in floats]
    return (j + [jnp.asarray(table), jnp.asarray(pos)],
            t + [torch.from_numpy(table), torch.from_numpy(pos)])


# case -> the step's window and walk bound: a sliding window; an
# undersized walk (lanes past it write nothing); mirrored lanes writing
# duplicate rows; lanes with fewer pages than splits
PAGED_CASES = {"window": dict(window=10, num_pages=8),
               "undersized": dict(window=0, num_pages=2),
               "mirrored": dict(window=0, num_pages=8),
               "short": dict(window=0, num_pages=4)}


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_paged_split_plain_matches_pallas(case, dtype, splits):
    """The split decomposition (1, 2, a ragged 3 and 8 splits; at 8 most
    lanes leave splits empty) against the Pallas kernel: the same output,
    and pools equal to the Pallas kernel's bit for bit."""
    kw = PAGED_CASES[case]
    j, t = _paged_inputs(case, dtype)
    ow, kw_, vw = _pallas_paged(*j, interpret=True, **kw)
    o, kp, vp = paged_attention.paged_split_plain(*t, splits=splits, **kw)
    assert o.dtype == TD[dtype] and o.shape == (PG_B, PG_H, PG_D)
    np.testing.assert_allclose(_np(o), _np(ow), **TOL[dtype])
    np.testing.assert_array_equal(_np(kp), _np(kw_))
    np.testing.assert_array_equal(_np(vp), _np(vw))


def test_paged_split_undersized_walk_writes_nothing_past_it():
    """With a walk of 2 pages only lane 0 (position 5) writes its row; the
    other lanes' write pages lie past the walk and their pools stay as
    they were."""
    _, t = _paged_inputs("undersized", "float32")
    before_k, before_v = t[3].clone(), t[4].clone()
    _, kp, vp = paged_attention.paged_split_plain(*t, splits=2,
                                                  **PAGED_CASES["undersized"])
    changed = (kp != before_k).any(dim=(2, 3)) | (vp != before_v).any(
        dim=(2, 3))
    table, pos = t[5], t[6]
    assert torch.nonzero(changed).tolist() == [
        [int(table[0, 0]), int(pos[0]) % PG_PS]]


# --- plans -------------------------------------------------------------------

def test_csr_plan_main_shape_fills_the_card():
    """The serve path's step: 4 lanes, d 2048, F 8192, K 32, block 128 in
    bf16 takes the union path with at least 132 blocks in each launch,
    within a block's shared memory."""
    p = dsg_ffn.csr_plan(4, 2048, 8192, 32, 128, torch.bfloat16)
    assert p.path == "union" and p.lanes == 4 and p.max_union == 64
    assert p.gate_up_blocks >= 132 and p.down_blocks >= 132
    assert 2048 % p.tile == 0 and p.slice == 128
    assert max(dsg_ffn.union_smem(p.lanes, 2048, 128, p.max_union,
                                  p.cluster, p.slice, p.tile,
                                  p.splits)) <= dsg_ffn.UNION_SMEM_LIMIT


@pytest.mark.parametrize("b,d,f,k,block,dtype,path,lanes", [
    (4, 2048, 8192, 32, 128, torch.float32, "lanes", 4),
    (4, 64, 256, 4, 64, torch.float32, "lanes", 4),
    (4, 64, 256, 4, 64, torch.bfloat16, "union", 4),
    (1, 2048, 8192, 32, 128, torch.bfloat16, "union", 1),
    (3, 2048, 8192, 32, 128, torch.bfloat16, "union", 4),
    (8, 2048, 8192, 32, 128, torch.bfloat16, "union", 8),
    (9, 2048, 8192, 32, 128, torch.bfloat16, "lanes", 9),
    (4, 16, 64, 2, 16, torch.bfloat16, "lanes", 4),
    (4, 2044, 8176, 4, 16, torch.bfloat16, "lanes", 4),
    (4, 4096, 16384, 64, 128, torch.bfloat16, "union", 4)])
def test_csr_plan_picks_path_by_dtype_and_shape(b, d, f, k, block, dtype,
                                                path, lanes):
    """f32, more than 8 lanes, blocks that are not multiples of 32 and d
    that is not a multiple of 64 take the per-lane kernels; the union path
    computes a power of two of lanes at least B."""
    p = dsg_ffn.csr_plan(b, d, f, k, block, dtype)
    assert (p.path, p.lanes) == (path, lanes)
    if path == "union":
        assert p.cluster in (1, 2, 4, 8) and p.splits in (1, 2, 4, 8)
        assert d % p.tile == 0 and block % p.slice == 0


@pytest.mark.parametrize("walk", [16, 32])
def test_paged_plan_main_shape_fills_the_card(walk):
    """The serve path's step: 4 lanes, 8 kv heads of 2 query heads, D 128,
    pages of 16 in bf16 takes the split kernel with at least 132 blocks."""
    p = paged_attention.plan(4, 8, 2, 128, 16, walk, torch.bfloat16)
    assert p.path == "split" and p.blocks >= 132
    assert p.blocks == 4 * 8 * p.splits and p.splits <= walk // 2
    assert p.smem == paged_attention.split_smem(2, 128, 16)


@pytest.mark.parametrize("b,kv,g,d,ps,walk,dtype,path,splits", [
    (4, 8, 2, 128, 16, 32, torch.float32, "serial", 1),
    (4, 2, 2, 16, 8, 8, torch.float32, "serial", 1),
    (4, 2, 2, 16, 8, 8, torch.bfloat16, "serial", 1),
    (4, 1, 16, 128, 16, 32, torch.bfloat16, "serial", 1),
    (4, 8, 3, 128, 16, 32, torch.bfloat16, "serial", 1),
    (4, 8, 2, 128, 64, 32, torch.bfloat16, "serial", 1),
    (4, 8, 2, 128, 16, 2, torch.bfloat16, "split", 1),
    (4, 8, 2, 128, 16, 5, torch.bfloat16, "split", 2),
    (1, 8, 2, 64, 16, 64, torch.bfloat16, "split", 8),
    (64, 8, 1, 128, 16, 64, torch.bfloat16, "split", 1),
    (4, 2, 2, 256, 32, 16, torch.bfloat16, "split", 8)])
def test_paged_plan_picks_kernel_by_dtype_and_shape(b, kv, g, d, ps, walk,
                                                    dtype, path, splits):
    """f32, head widths other than 64, 128 and 256, query groups that are
    not a power of two or too wide, and pages over 32 rows take the serial
    kernel; the split count stops at 8, at half the walk and once the
    blocks fill the SMs."""
    p = paged_attention.plan(b, kv, g, d, ps, walk, dtype)
    assert (p.path, p.splits) == (path, splits)
