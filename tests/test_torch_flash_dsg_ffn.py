"""The tile-masked DSG FFN and flash attention of the port against the
Pallas kernels (interpret mode) on the CPU, over the sweeps of
tests/test_kernels.py, with inputs made by numpy from a seed.  On CPU
tensors the `ops` entry points run the kernels' plain PyTorch versions.

Tolerances: the FFN in f32 5e-4 (and 1e-4 at the property sweep's small
widths), in bf16 5e-2, the JAX test's own, because the reference rounds its
accumulator to bf16 after every F block and the port rounds once; the
composed `dsg_ffn_full` in f32 2e-4 with equal masks; flash attention in
f32 2e-5 (3e-5 in the property sweep) and in bf16 2e-2, where both round
an f32 result once.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors gain nothing from threads, which would only contend with
# the other test workers
torch.set_num_threads(1)
pytest.importorskip("hypothesis")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import drs as jdrs  # noqa: E402
from repro.core import dsg_linear as jdl  # noqa: E402
from repro.kernels import dsg_ffn as jdf  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import drs  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.kernels import dsg_ffn, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# the Pallas kernels in interpret mode, jitted so that each shape traces
# once
_pallas_ffn = jax.jit(jdf.dsg_ffn,
                      static_argnames=("block", "bm", "bf", "interpret"))
_pallas_flash = jax.jit(jfa.flash_attention, static_argnames=(
    "causal", "block_q", "block_k", "interpret"))

FFN_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
           "bfloat16": dict(rtol=5e-2, atol=5e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _both(dtype, *arrays):
    """f32 numpy arrays -> (jax arrays, torch tensors), both rounded to
    `dtype` the same way (round to nearest even)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)).to(td)
             for a in arrays])


def _ffn_inputs(rng, m, d, f, scale=1.0):
    mk = lambda shape, s: (rng.standard_normal(shape) * s).astype(  # noqa: E731
        np.float32)
    return (mk((m, d), 1.0), mk((d, f), scale / math.sqrt(d)),
            mk((d, f), scale / math.sqrt(d)), mk((f, d), scale / math.sqrt(f)))


def _as_np(a):
    return np.asarray(a.float() if torch.is_tensor(a) else a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f,block,bm,bf", [
    (64, 96, 256, 32, 32, 64), (128, 128, 512, 64, 64, 128),
    (64, 256, 512, 128, 64, 128)])
def test_dsg_ffn_plain_matches_pallas(dtype, m, d, f, block, bm, bf):
    rng = np.random.default_rng(2)
    arrays = _ffn_inputs(rng, m, d, f)
    mask = (rng.random((m, f // block)) > 0.4).astype(np.float32)
    j, t = _both(dtype, *arrays)
    want = _pallas_ffn(*j, jnp.asarray(mask), block=block, bm=bm, bf=bf,
                       interpret=True)
    got = ops.dsg_ffn_fwd(*t, torch.from_numpy(mask), block=block, bm=bm,
                          bf=bf)
    assert got.dtype == t[0].dtype and got.shape == (m, d)
    np.testing.assert_allclose(_as_np(got), _as_np(want), **FFN_TOL[dtype])


def test_dsg_ffn_all_masked_is_zero():
    m, d, f, block = 32, 64, 128, 32
    j, t = _both("float32", *_ffn_inputs(np.random.default_rng(3), m, d, f))
    mask = np.zeros((m, f // block), np.float32)
    want = _pallas_ffn(*j, jnp.asarray(mask), block=block, bm=32, bf=32,
                       interpret=True)
    got = ops.dsg_ffn_fwd(*t, torch.from_numpy(mask), block=block, bm=32,
                          bf=32)
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), mt=st.integers(1, 4),
       ft=st.integers(1, 4), density=st.floats(0.0, 1.0))
def test_dsg_ffn_property(seed, mt, ft, density):
    """Random tile counts and mask densities, dead tiles included."""
    block, bm, bf, d = 16, 16, 32, 48
    m, f = mt * bm, ft * bf
    rng = np.random.default_rng(seed)
    j, t = _both("float32", *_ffn_inputs(rng, m, d, f, scale=0.1))
    mask = (rng.random((m, f // block)) < density).astype(np.float32)
    want = _pallas_ffn(*j, jnp.asarray(mask), block=block, bm=bm, bf=bf,
                       interpret=True)
    got = ops.dsg_ffn_fwd(*t, torch.from_numpy(mask), block=block, bm=bm,
                          bf=bf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_dsg_ffn_full_matches_reference():
    """ops.dsg_ffn_full on the CPU against the reference's ops.dsg_ffn_full
    (Pallas kernels in interpret mode) on the same weights and DRS state,
    carried across by the bridge: the same group masks, outputs within
    2e-4; and against the port's own swiglu_dsg_mask under topk."""
    d, f, m, block, gamma = 128, 512, 64, 64, 0.5
    cfg = jdl.DSGConfig(enabled=True, gamma=gamma, block=block, eps=0.5)
    p = jdl.init_swiglu(jax.random.PRNGKey(0), d, f)
    st_ = jdl.init_dsg_state(jax.random.PRNGKey(1), d, f, cfg,
                             jdl.search_weight(p))
    x = np.random.default_rng(4).standard_normal((m, d)).astype(np.float32)
    names = ("w_gate", "w_up", "w_down")
    w = [bridge.tensor(p[n]) for n in names]
    r, fw = bridge.tensor(st_["r"]), bridge.tensor(st_["fw"])
    xt = torch.from_numpy(x)

    jscores = jops.drs_scores(jops.drs_project(jnp.asarray(x), st_["r"]),
                              st_["fw"], block=block)
    jmask, _ = jdrs.select_mask(jscores, f, jdrs.DRSConfig(
        gamma=gamma, block=block, threshold_mode="topk"))
    mask = drs.select_mask(ops.drs_scores(ops.drs_project(xt, r), fw,
                                          block=block), f,
                           drs.DRSConfig(gamma=gamma, block=block,
                                         threshold_mode="topk"))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))

    want = jops.dsg_ffn_full(jnp.asarray(x), *(p[n] for n in names),
                             st_["r"], st_["fw"], gamma=gamma, block=block)
    got = ops.dsg_ffn_full(xt, *w, r, fw, gamma=gamma, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    own = dl.swiglu_dsg_mask(dl.SwiGLU(*w), xt, {"r": r, "fw": fw},
                             dl.DSGConfig(enabled=True, gamma=gamma,
                                          block=block,
                                          threshold_mode="topk"))
    np.testing.assert_allclose(got.numpy(), own.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_tile_skip_fraction_counts_dead_cells():
    """The count of benchmarks/bench_kernels.py: 1 - mean of the OR of the
    mask over each (bm-token tile, bf-column block) cell; with a mask shared
    by every row and bf == block it is the share of groups dropped."""
    rng = np.random.default_rng(5)
    m, g, block, bm, bf = 64, 16, 32, 16, 64
    mask = (rng.random((m, g)) < 0.05).astype(np.float32)
    tile = mask.reshape(m // bm, bm, g * block // bf, bf // block).max(
        axis=(1, 3))
    assert dsg_ffn.tile_skip_fraction(torch.from_numpy(mask), bm, bf,
                                      block) == pytest.approx(
        1.0 - tile.mean())
    shared = np.tile((np.arange(g) % 2).astype(np.float32), (m, 1))
    assert dsg_ffn.tile_skip_fraction(torch.from_numpy(shared), bm, block,
                                      block) == 0.5
    assert dsg_ffn.tile_skip_fraction(torch.zeros(m, g), bm, bf, block) == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,t,d,causal,bq,bk", [
    (4, 128, 128, 32, True, 32, 32),
    (2, 64, 192, 64, False, 32, 64),
    (2, 256, 256, 64, True, 128, 64),
])
def test_flash_attention_plain_matches_pallas(dtype, bh, s, t, d, causal, bq,
                                              bk):
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((bh, s, d), (bh, t, d), (bh, t, d))]
    j, tt = _both(dtype, *arrays)
    want = _pallas_flash(*j, causal=causal, block_q=bq, block_k=bk,
                               interpret=True)
    got = ops.flash_attention(*tt, causal=causal, block_q=bq, block_k=bk)
    assert got.dtype == tt[0].dtype and got.shape == (bh, s, d)
    np.testing.assert_allclose(_as_np(got), _as_np(want), **FLASH_TOL[dtype])


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), nq=st.integers(1, 4),
       nk=st.integers(1, 4), causal=st.booleans())
def test_flash_attention_property(seed, nq, nk, causal):
    bq = bk = 16
    d, bh = 16, 2
    s, t = nq * bq, nk * bk
    if causal and t < s:
        t = s
    rng = np.random.default_rng(seed)
    j, tt = _both("float32", *(rng.standard_normal(shape).astype(np.float32)
                               for shape in ((bh, s, d), (bh, t, d),
                                             (bh, t, d))))
    want = _pallas_flash(*j, causal=causal, block_q=bq, block_k=bk,
                               interpret=True)
    got = ops.flash_attention(*tt, causal=causal, block_q=bq, block_k=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def test_flash_attention_causal_rows_before_the_keys_are_zero():
    """Causal with S > T: rows i < S - T see no key.  The Pallas kernel and
    the port give zeros there (ref.flash_attention_ref gives the mean of
    v); the other rows agree to the f32 tolerance."""
    bh, s, t, d = 2, 64, 32, 16
    rng = np.random.default_rng(8)
    j, tt = _both("float32", *(rng.standard_normal(shape).astype(np.float32)
                               for shape in ((bh, s, d), (bh, t, d),
                                             (bh, t, d))))
    want = np.asarray(_pallas_flash(*j, causal=True, block_q=16,
                                          block_k=16, interpret=True))
    got = ops.flash_attention(*tt, causal=True, block_q=16,
                              block_k=16).numpy()
    np.testing.assert_array_equal(want[:, :s - t], 0.0)
    np.testing.assert_array_equal(got[:, :s - t], 0.0)
    np.testing.assert_allclose(got, want, **FLASH_TOL["float32"])


def test_wrappers_refuse_cpu_tensors_and_untiled_shapes():
    """The launchers never compute on the CPU, and every entry point
    refuses the shapes the reference asserts against."""
    x, w, wd_ = torch.zeros(64, 32), torch.zeros(32, 128), torch.zeros(128, 32)
    mask = torch.ones(64, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        dsg_ffn.dsg_ffn(x, w, w, wd_, mask, block=32, bm=32, bf=64)
    q = torch.zeros(2, 64, 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa.flash_attention(q, q, q, block_q=32, block_k=32)
    for bad in (dict(bm=48), dict(bf=48), dict(bf=16)):
        kw = dict(block=32, bm=32, bf=64) | bad
        with pytest.raises(ValueError, match="dsg_ffn"):
            dsg_ffn.dsg_ffn(x, w, w, wd_, mask, **kw)
        with pytest.raises(ValueError, match="dsg_ffn"):
            ops.dsg_ffn_fwd(x, w, w, wd_, mask, **kw)
    for bad in (dict(block_q=48), dict(block_k=24)):
        with pytest.raises(ValueError, match="flash_attention"):
            fa.flash_attention(q, q, q, **bad)
        with pytest.raises(ValueError, match="flash_attention"):
            ops.flash_attention(q, q, q, **bad)
