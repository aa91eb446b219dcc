"""The tensor-core kernels' decompositions and plans, on the CPU.

The bf16 flash attention kernel splits the keys across blocks and merges
the splits' (m, l, acc) partials in order; the bf16 drs_project kernel
splits d across blocks and sums the partials in order.  Their plain
PyTorch versions (`flash_split_plain`, `drs_project_split_plain`) are held
here against the Pallas kernels in interpret mode, with inputs made by
numpy from a seed; the kernels themselves run only on the card
(tests/test_torch_cuda.py).  The plan functions that pick each kernel and
its splits are pure Python and are checked at the main path's shapes.

Tolerances: f32 2e-5 for flash attention (both sum exact f32 products, in
another order), 1e-4 for the projection's sums over d up to 2048; bf16
one ulp of the value (rtol 8e-3) plus 4e-3 near zero, where both round
an f32 sum once.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors gain nothing from threads, which would only contend with
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import drs_search as jds  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro_torch.kernels import drs_search  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# the Pallas kernels in interpret mode, jitted so that each shape traces
# once
_pallas_flash = jax.jit(jfa.flash_attention, static_argnames=(
    "causal", "block_q", "block_k", "interpret"))
_pallas_project = jax.jit(jds.drs_project, static_argnames=("bm", "interpret"))

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=8e-3, atol=4e-3)}


def _both(dtype, *arrays):
    """f32 numpy arrays -> (jax arrays, torch tensors) in `dtype`."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(td)
             for a in arrays])


def _np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


# (bh, S, T, D, causal): causal with S > T (the first S - T rows see no
# key), causal with S < T (the suffix offset), and not causal
FLASH_SHAPES = [(2, 160, 128, 16, True), (2, 64, 128, 32, True),
                (2, 64, 128, 16, False)]


@pytest.mark.parametrize("tiles_per_split", [8, 4, 2, 3])
@pytest.mark.parametrize("bh,s,t,d,causal", FLASH_SHAPES)
def test_flash_split_plain_matches_pallas(bh, s, t, d, causal,
                                          tiles_per_split):
    """Eight 16-key tiles in runs of 8, 4, 2 and 3 (1, 2, 4 and a ragged 3
    splits).  Under causal masking later splits hold no key for the early
    rows; rows that see no key at all stay exactly zero."""
    rng = np.random.default_rng(11)
    j, tt = _both("float32", *(rng.standard_normal(shape).astype(np.float32)
                               for shape in ((bh, s, d), (bh, t, d),
                                             (bh, t, d))))
    want = np.asarray(_pallas_flash(*j, causal=causal, block_q=32,
                                    block_k=32, interpret=True))
    got = fa.flash_split_plain(*tt, causal=causal,
                               tiles_per_split=tiles_per_split, block_k=16)
    assert got.dtype == torch.float32 and got.shape == (bh, s, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    if causal and s > t:
        np.testing.assert_array_equal(got[:, :s - t].numpy(), 0.0)
        np.testing.assert_array_equal(want[:, :s - t], 0.0)


def test_flash_merge_keeps_unseen_rows_zero():
    """Partials of rows no split saw (m = NEG, l = 0, acc = 0) merge to
    exact zeros beside rows that one split saw."""
    m = torch.tensor([[[fa.NEG], [0.5]], [[fa.NEG], [fa.NEG]]])
    l = torch.tensor([[[0.0], [2.0]], [[0.0], [0.0]]])
    acc = torch.tensor([[[0.0, 0.0], [1.0, 3.0]], [[0.0, 0.0], [0.0, 0.0]]])
    out = fa.flash_merge_plain([(m[i:i + 1], l[i:i + 1], acc[i:i + 1])
                                for i in range(2)])
    assert out.shape == (1, 2, 2)
    assert torch.equal(out[0, 0], torch.zeros(2))
    torch.testing.assert_close(out[0, 1], torch.tensor([0.5, 1.5]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,k,chunks_per_split", [
    (64, 320, 128, 1), (64, 320, 128, 2), (64, 320, 128, 3),
    (64, 320, 128, 5), (192, 2048, 256, 3), (32, 200, 64, 2)])
def test_drs_project_split_plain_matches_pallas(dtype, m, d, k,
                                                chunks_per_split):
    """The split-d sum at the admission shape (M 192, d 2048, 11 splits of
    3 chunks), ragged runs of d = 320 and a d that is no multiple of the
    64-wide chunk."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((m, d)).astype(np.float32)
    r = (rng.standard_normal((k, d)) / np.sqrt(k)).astype(np.float32)
    j, tt = _both(dtype, x, r)
    want = _pallas_project(*j, bm=min(64, m), interpret=True)
    got = drs_search.drs_project_split_plain(
        *tt, chunks_per_split=chunks_per_split)
    assert got.dtype == tt[0].dtype and got.shape == (m, k)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


# the main path's shapes: flash phase 8's two cases; drs_project at
# admission (every prompt bucket) and at refresh (4 lanes), k = 256, d = 2048
@pytest.mark.parametrize("bh,s,t,d", [(16, 256, 256, 128),
                                      (16, 256, 2048, 128)])
def test_flash_plan_main_shapes_fill_the_card(bh, s, t, d):
    p = fa.plan(bh, s, t, d, torch.bfloat16)
    n_kt = -(-t // fa.TC_KEYS)
    assert p.path == "tc" and p.blocks >= 128
    assert p.blocks == bh * -(-s // fa.TC_ROWS) * p.splits
    # the splits' runs of key tiles cover T exactly, none of them empty
    assert (p.splits - 1) * p.tiles_per_split < n_kt
    assert p.splits * p.tiles_per_split >= n_kt


@pytest.mark.parametrize("bh,s,t,d,dtype,path", [
    (16, 256, 256, 128, torch.float32, "simt"),
    (16, 256, 2048, 48, torch.bfloat16, "simt"),
    (2, 48, 80, 16, torch.bfloat16, "simt"),
    (2, 48, 80, 64, torch.bfloat16, "tc"),
    (4, 128, 128, 256, torch.bfloat16, "tc"),
    (4, 128, 128, 192, torch.bfloat16, "tc"),
    (2, 64, 4096, 64, torch.bfloat16, "tc"),
    (64, 512, 512, 128, torch.bfloat16, "tc")])
def test_flash_plan_picks_kernel_by_dtype_and_shape(bh, s, t, d, dtype, path):
    """f32 and D that is not a multiple of 64 take the SIMT kernel; where
    the query tiles fill the card the keys are not split."""
    p = fa.plan(bh, s, t, d, dtype)
    assert p.path == path
    if path == "tc":
        n_kt = -(-t // fa.TC_KEYS)
        q_tiles = bh * -(-s // fa.TC_ROWS)
        assert (p.splits - 1) * p.tiles_per_split < n_kt
        assert p.splits * p.tiles_per_split >= n_kt
        assert p.splits == 1 if q_tiles >= fa.SM_COUNT else p.splits >= 1
        assert p.tiles_per_split >= min(2, n_kt)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 96, 128, 192, 256])
def test_project_plan_main_shapes_fill_the_card(m):
    """M <= 16 takes the GEMV with at least 128 warps; larger M the wgmma
    tiles with at least 128 blocks, d split into runs that cover it
    exactly."""
    k, d = 256, 2048
    p = drs_search.project_plan(m, k, d, torch.bfloat16)
    if m <= 16:
        assert p.path == "gemv" and p.warps >= 128
        assert p.blocks * drs_search.GEMV_WARPS == k * p.splits
    else:
        chunks = d // drs_search.TC_TILE
        assert p.path == "tc" and p.blocks >= 128
        assert (p.splits - 1) * p.chunks_per_split < chunks
        assert p.splits * p.chunks_per_split >= chunks


@pytest.mark.parametrize("m,k,d,dtype,path,splits", [
    (4, 256, 2048, torch.float32, "simt", 1),
    (192, 256, 2048, torch.float32, "simt", 1),
    (4, 256, 2044, torch.bfloat16, "simt", 1),
    (4, 64, 128, torch.bfloat16, "gemv", 2),
    (4, 32, 128, torch.bfloat16, "gemv", 4),
    (16, 256, 8192, torch.bfloat16, "tc", 32),
    (4096, 256, 2048, torch.bfloat16, "tc", 1)])
def test_project_plan_picks_kernel_by_dtype_and_shape(m, k, d, dtype, path,
                                                      splits):
    """f32 and rows that are not 16-byte multiples take the SIMT tile; a
    narrow R splits each GEMV row across 2 or 4 warps; x too large for
    shared memory goes to the wgmma tiles; many output tiles split d no
    further."""
    p = drs_search.project_plan(m, k, d, dtype)
    assert (p.path, p.splits) == (path, splits)
