"""The DRS scores and tile-masked FFN kernels' decompositions and plans,
on the CPU, and the library entry points' default device.

The bf16 drs_scores GEMV splits each group's columns across a cluster
and sums the slices' partial group sums in rank order; the bf16
tile-masked FFN splits each row tile's live F chunks across a cluster
and sums the partials in rank order.  Their plain PyTorch versions
(`drs_search.drs_scores_split_plain`, `dsg_ffn.dsg_ffn_split_plain`) are
held here against the Pallas kernels in interpret mode, with inputs made
by numpy from a seed; the kernels themselves run only on the card
(tests/test_torch_cuda.py).  The plan functions that pick each kernel
and its sizes are pure Python and are checked at the main path's shapes.

Tolerances: f32 1e-5, where both sum exact f32 products in another
order; bf16 5e-2, the JAX tests' own, because the Pallas FFN rounds its
accumulator to bf16 after every F block where the port rounds once.
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
from repro.kernels import dsg_ffn as jdf  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.kernels import drs_search, dsg_ffn  # noqa: E402
from repro_torch.models import api  # noqa: E402

# the Pallas kernels in interpret mode, jitted so that each shape traces
# once
_pallas_scores = jax.jit(jds.drs_scores, static_argnames=(
    "block", "bm", "bf", "interpret"))
_pallas_ffn = jax.jit(jdf.dsg_ffn,
                      static_argnames=("block", "bm", "bf", "interpret"))

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
JD = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TD = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ROWS = [1, 4, 16, 17, 64, 192, 256]


def _both(dtype, *arrays):
    return ([jnp.asarray(a).astype(JD[dtype]) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(TD[dtype])
             for a in arrays])


def _np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


def _bm(m):
    """The reference's row tile: min(128, M) must divide M."""
    return 64 if m == 192 else 128


# --- drs_scores --------------------------------------------------------------

SC_K, SC_F, SC_BLOCK = 64, 512, 128   # G = 4 groups


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROWS)
def test_scores_split_plain_matches_pallas(m, dtype):
    """The column-slice decomposition at 1, 2, 4 and 8 slices of a group
    (16 columns each at 8) against the Pallas kernel."""
    rng = np.random.default_rng(50 + m)
    fx = rng.standard_normal((m, SC_K)).astype(np.float32)
    fw = (rng.standard_normal((SC_K, SC_F)) / np.sqrt(SC_K)).astype(
        np.float32)
    j, t = _both(dtype, fx, fw)
    want = _np(_pallas_scores(*j, block=SC_BLOCK, bm=_bm(m), interpret=True))
    for slices in (1, 2, 4, 8):
        got = drs_search.drs_scores_split_plain(*t, block=SC_BLOCK,
                                                slices=slices)
        assert got.dtype == torch.float32 and got.shape == (m, 4)
        np.testing.assert_allclose(_np(got), want, **TOL[dtype])


@pytest.mark.parametrize("m", [4, 192, 256])
def test_scores_plan_serve_shapes_fill_the_card(m):
    """The serve path's shapes (k 256, F 8192, block 128; M 4 lanes at
    refresh, the prompt bucket at admission) in bf16: the GEMV or the
    wgmma tiles with at least 132 blocks, within a block's shared memory
    (two wgmma blocks an SM)."""
    p = drs_search.scores_plan(m, 256, 8192, 128, torch.bfloat16)
    assert p.path == ("gemv" if m <= 16 else "tc")
    assert p.blocks >= 132 and p.smem <= drs_search.SCORES_SMEM_LIMIT
    if p.path == "gemv":
        assert p.blocks == 64 * p.slices and 128 // p.slices >= 8
        assert p.smem == drs_search.scores_gemv_smem(m, 256, 128, p.slices)
    else:
        assert p.per == 1 and p.blocks <= 2 * 132
        assert 2 * p.smem <= 228 * 1024 - 2 * 1024
        assert p.smem == drs_search.scores_tc_smem(256, 1)


def test_scores_plan_walks_row_tiles_past_one_wave():
    """Where one 64-row tile a block would take more than one wave of the
    SMs, each block walks the fewest row tiles that fit one wave."""
    p = drs_search.scores_plan(1024, 256, 8192, 128, torch.bfloat16)
    assert (p.path, p.per, p.blocks) == ("tc", 8, 128)
    assert p.smem == drs_search.scores_tc_smem(256, 2)


@pytest.mark.parametrize("m,k,f,block,dtype,path,slices", [
    (4, 256, 8192, 128, torch.float32, "simt", 0),
    (192, 256, 8192, 128, torch.float32, "simt", 0),
    (16, 256, 8192, 128, torch.bfloat16, "gemv", 4),
    (1, 256, 8192, 64, torch.bfloat16, "gemv", 2),
    (4, 256, 1024, 128, torch.bfloat16, "gemv", 8),
    (4, 64, 256, 32, torch.bfloat16, "gemv", 4),
    (4, 256, 8192, 96, torch.bfloat16, "simt", 0),
    (17, 256, 8192, 128, torch.bfloat16, "tc", 0),
    (37, 128, 512, 64, torch.bfloat16, "tc", 0),
    (192, 256, 8192, 256, torch.bfloat16, "simt", 0),
    (192, 1024, 8192, 128, torch.bfloat16, "simt", 0)])
def test_scores_plan_picks_kernel_by_dtype_and_shape(m, k, f, block, dtype,
                                                     path, slices):
    """f32, groups that are no power of two (GEMV) or do not tile 128
    columns (wgmma), and a k whose slab outgrows shared memory take the
    SIMT kernel; few groups split into more column slices."""
    p = drs_search.scores_plan(m, k, f, block, dtype)
    assert (p.path, p.slices) == (path, slices)


def test_scores_plan_refuses_rows_that_are_not_16_byte_multiples():
    for k, f in ((60, 8192), (256, 8188)):
        with pytest.raises(ValueError, match="multiples of 8"):
            drs_search.scores_plan(4, k, f, 4, torch.bfloat16)
    assert drs_search.scores_plan(4, 60, 8192, 128,
                                  torch.float32).path == "simt"


# --- the tile-masked FFN -------------------------------------------------------

FF_D, FF_F, FF_BLOCK = 64, 512, 64   # G = 8 groups, 4 chunks of 128


def _masks(rng, m):
    """All-dead, all-live, half-dead (the upper half of the groups selected
    by no token) and batch-shared (row 0 for every row) masks."""
    g = FF_F // FF_BLOCK
    per_token = (rng.random((m, g)) < 0.4).astype(np.float32)
    half = per_token.copy()
    half[:, g // 2:] = 0
    return {"all_dead": np.zeros((m, g), np.float32),
            "all_live": np.ones((m, g), np.float32), "half_dead": half,
            "shared": np.repeat(per_token[:1], m, axis=0)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROWS)
def test_ffn_split_plain_matches_pallas(m, dtype):
    """The F-split decomposition over 64- and 128-row blocks at 1, a ragged
    3 and 8 splits (more than the live chunks) over every mask kind
    against the Pallas kernel; an all-dead mask gives exact zeros."""
    rng = np.random.default_rng(60 + m)
    x = rng.standard_normal((m, FF_D)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for s in ((FF_D, FF_F), (FF_D, FF_F), (FF_F, FF_D))]
    for kind, mask in _masks(rng, m).items():
        j, t = _both(dtype, x, *w)
        want = _np(_pallas_ffn(*j, jnp.asarray(mask), block=FF_BLOCK,
                               bm=_bm(m), bf=128, interpret=True))
        tm = torch.from_numpy(mask)
        for rows, splits in ((64, 1), (64, 3), (128, 3), (128, 8)):
            got = dsg_ffn.dsg_ffn_split_plain(*t, tm, block=FF_BLOCK,
                                              splits=splits, rows=rows)
            assert got.dtype == TD[dtype] and got.shape == (m, FF_D)
            np.testing.assert_allclose(
                _np(got), want, **TOL[dtype],
                err_msg=f"{kind}, {rows} rows, {splits} splits")
            if kind == "all_dead":
                assert not got.any()


def test_live_cells_and_cell_skip_fraction():
    """The tensor-core path's live cells (64 rows x 128 columns) and the
    dead share of any cells, which at (128, 128) is the reference's
    tile-skip fraction."""
    rng = np.random.default_rng(61)
    mask = torch.from_numpy(_masks(rng, 256)["half_dead"])
    mask[:128] = 0
    live = dsg_ffn.live_cells(mask, FF_BLOCK, 64, 128)
    assert live.shape == (4, 4)
    assert not live[:2].any() and not live[:, 2:].any()
    assert live[2:, :2].all()
    assert torch.equal(dsg_ffn.live_cells(mask, FF_BLOCK, 128, 128),
                       live.reshape(2, 2, 4).any(dim=1))
    assert dsg_ffn.cell_skip_fraction(mask, 64, 128, FF_BLOCK) == 0.75
    for rows, cols in ((128, 128), (64, 128), (256, 512)):
        assert dsg_ffn.cell_skip_fraction(mask, rows, cols, FF_BLOCK) == \
            dsg_ffn.tile_skip_fraction(mask, rows, cols, FF_BLOCK)
    # ragged edge cells count whole: 17 rows make two 16-row cells
    assert dsg_ffn.cell_skip_fraction(torch.ones(17, 8), 16, 64, 64) == 0.0


def test_tile_plan_phase7_shape_fills_one_wave():
    """Phase 7's FFN (M 256, d 2048, F 8192, block 128) in bf16 takes the
    wgmma tiles, 128 rows a gate/up block, and splits F while the down
    blocks fit one wave of the 132 SMs, within a block's shared memory."""
    p = dsg_ffn.tile_plan(256, 2048, 8192, 128, torch.bfloat16)
    assert p.path == "tc" and (p.cell_rows, p.cell_cols) == (128, 128)
    assert p.rows == 128 and p.splits == 2
    assert 66 <= p.gate_up_blocks <= 132 and 66 <= p.down_blocks <= 132
    assert max(dsg_ffn.tile_tc_smem(p.rows)) <= 227 * 1024
    assert max(dsg_ffn.tile_tc_smem(64)) <= 227 * 1024


@pytest.mark.parametrize("m,d,f,block,dtype,path,rows,splits", [
    (256, 2048, 8192, 128, torch.float32, "simt", 64, 1),
    (256, 2048, 8192, 128, torch.bfloat16, "tc", 128, 2),
    (64, 2048, 8192, 128, torch.bfloat16, "tc", 64, 8),
    (4096, 2048, 8192, 128, torch.bfloat16, "tc", 128, 1),
    (64, 96, 256, 32, torch.bfloat16, "simt", 64, 1),
    (48, 128, 320, 64, torch.bfloat16, "simt", 64, 1),
    (100, 576, 2048, 128, torch.bfloat16, "tc", 128, 8),
    (192, 2048, 8192, 128, torch.bfloat16, "tc", 128, 2),
    (17, 512, 2048, 32, torch.bfloat16, "tc", 64, 8)])
def test_tile_plan_picks_path_by_dtype_and_shape(m, d, f, block, dtype, path,
                                                 rows, splits):
    """f32, d that is no multiple of 64 and F that is no multiple of 128
    take the SIMT tiles; 64-row blocks only where M fits in them; the down
    projection splits F while its blocks fit one wave."""
    p = dsg_ffn.tile_plan(m, d, f, block, dtype)
    assert (p.path, p.rows, p.splits) == (path, rows, splits)


def test_tile_plan_refuses_rows_that_are_not_16_byte_multiples():
    with pytest.raises(ValueError, match="multiples of 8"):
        dsg_ffn.tile_plan(64, 100, 256, 64, torch.bfloat16)
    assert dsg_ffn.tile_plan(64, 100, 256, 64, torch.float32).path == "simt"


# --- the entry points' default device -------------------------------------------

def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_entry_points_default_to_the_card():
    """Called without `device`, the entry points that make tensors ask for
    the card, and raise where there is none."""
    _no_card()
    cfg = configs.get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_model(cfg, generator=torch.Generator())
    model = api.init_model(cfg, generator=torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_dsg(model, cfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.dsg_from_jax({"r": np.zeros((2, 2), np.float32),
                             "fw": np.zeros((1, 2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.model_from_jax({}, cfg)


def test_entry_points_on_the_cpu_when_asked():
    cfg = configs.get_smoke_config("internlm2-1.8b")
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    cache = api.make_cache(cfg, 1, 8, device="cpu")
    assert model.embed.device.type == "cpu"
    assert dsg["r"].device.type == dsg["fw"].device.type == "cpu"
    assert cache["k"].device.type == "cpu"
    tdsg = bridge.dsg_from_jax({"r": np.ones((2, 2), np.float32),
                                "fw": np.ones((1, 2, 2), np.float32)},
                               device="cpu")
    assert tdsg["fw"].device.type == "cpu"
