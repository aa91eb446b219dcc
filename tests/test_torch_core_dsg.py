"""The port's core DSG math for training (`repro_torch.core`) against the
reference's on the same numpy inputs, on the CPU.

Mirrors the reference's `tests/test_core_dsg.py` (projection statistics,
JLL preservation, DRS selection, mask algebra, double mask) and
`tests/test_drs_properties.py` (threshold-mode and mask-algebra
properties), and holds every function this slice ports to the reference:
`projection.project`/`maybe_refresh_fw`, the four group scores, the three
threshold modes, `expand_mask`, `oracle_mask`, `random_mask` (by its
properties: JAX's key schedule cannot be replayed in torch), the DMS
`double_mask`/`single_mask` after BN, `density`, `mask_overhead_bytes`,
`dense_to_csr`, `csr_overhead_bytes`, the stash model, and `dsg_linear`'s
`init_dsg_state`/`refresh_fw`/`shared_topk_indices`/`swiglu_dsg_gather`.

Tolerances: f32 products and sums agree to atol 1e-5 (rtol 1e-5 where
they reach the tens); selections ({0,1} masks, indices, CSR rows, byte
counts) exactly.  Scores come from a drawn seed through numpy, so rows are
generically distinct floats.  Every hypothesis test has deadline=None.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import double_mask as jdm  # noqa: E402
from repro.core import drs as jdrs  # noqa: E402
from repro.core import dsg_linear as jdl  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core import sparse_mask as jsm  # noqa: E402
from repro.core import stash as jstash  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import double_mask, drs, masks, projection  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.core import sparse_mask, stash  # noqa: E402

ATOL = 1e-5
SCORES = ("relu_sum", "abs_sum", "signed_sum", "max")
_SEED = st.integers(0, 2**32 - 1)
_ROWS = st.integers(1, 5)
_G = st.sampled_from([2, 4, 8, 16])
_BLOCK = st.sampled_from([4, 8])
_GAMMA = st.sampled_from([0.0, 0.25, 0.5, 0.75])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _scores(seed, rows, g):
    return _randn(seed, rows, g)


# ---------------------------------------------------------------------------
# sparse random projection
# ---------------------------------------------------------------------------

def test_projection_ternary_distribution():
    r = projection.make_projection(
        256, 512, generator=torch.Generator().manual_seed(0))
    vals = np.unique(np.round(r.numpy() * np.sqrt(256), 5))
    assert len(vals) == 3
    np.testing.assert_allclose(sorted(abs(v) for v in vals)[1:],
                               [np.sqrt(3)] * 2, rtol=1e-5)
    assert 0.60 < float((r == 0).float().mean()) < 0.73


def test_jll_dim_monotone_in_eps():
    k_tight = projection.jll_dim(4096, 1000, eps=0.3)
    k_loose = projection.jll_dim(4096, 1000, eps=0.9)
    assert k_tight >= k_loose
    assert k_tight % projection.LANE == 0 and k_loose >= projection.LANE


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_jll_inner_product_preservation(seed):
    """|<f(x), f(w)> - <x, w>| <= eps/2 (|x|^2 + |w|^2) with high
    probability (the paper's Eq. 4)."""
    gen = torch.Generator().manual_seed(seed)
    d, n, eps = 512, 64, 0.5
    x = torch.randn(n, d, generator=gen)
    w = torch.randn(d, n, generator=gen)
    r = projection.make_projection(projection.jll_dim(d, n, eps), d,
                                   generator=gen)
    approx = projection.project_rows(r, x) @ projection.project(r, w)
    bound = 0.5 * eps * ((x * x).sum(-1)[:, None] + (w * w).sum(0)[None, :])
    assert float(((approx - x @ w).abs() > bound).float().mean()) < 0.05


def test_norm_preservation():
    gen = torch.Generator().manual_seed(3)
    z = torch.randn(128, 1024, generator=gen)
    r = projection.make_projection(256, 1024, generator=gen)
    ratio = (projection.project_rows(r, z).norm(dim=-1) / z.norm(dim=-1))
    assert float((ratio - 1.0).abs().median()) < 0.15


@pytest.mark.parametrize("zshape", [(96,), (96, 40), (96, 3, 5)])
def test_project_equals_the_reference(zshape):
    r, z = _randn(1, 32, 96), _randn(2, *zshape)
    got = projection.project(_t(r), _t(z))
    want = jproj.project(jnp.asarray(r), jnp.asarray(z))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("step", [0, 1, 49, 50, 100, 101])
def test_maybe_refresh_fw_equals_the_reference(step):
    r, w, fw = _randn(1, 32, 96), _randn(2, 96, 40), _randn(3, 32, 40)
    got = projection.maybe_refresh_fw(step, _t(r), _t(w), _t(fw), 50)
    want = jproj.maybe_refresh_fw(jnp.int32(step), jnp.asarray(r),
                                  jnp.asarray(w), jnp.asarray(fw), 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert (step % 50 == 0) != np.array_equal(got.numpy(), fw)


# ---------------------------------------------------------------------------
# DRS scores and selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("score", SCORES)
def test_every_group_score_equals_the_reference(score):
    v = _randn(0, 3, 5, 256)
    got = drs.group_scores(_t(v), drs.DRSConfig(block=64, score=score))
    want = jdrs.group_scores(jnp.asarray(v),
                             jdrs.DRSConfig(block=64, score=score))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError, match="unknown score"):
        drs.group_scores(_t(v), drs.DRSConfig(block=64, score="median"))


@pytest.mark.parametrize("gamma", [0.25, 0.5, 0.75])
def test_topk_mask_exact_density(gamma):
    cfg = drs.DRSConfig(gamma=gamma, block=32, threshold_mode="topk")
    s = _scores(0, 64, 16)
    mask = drs.select_mask(_t(s), 512, cfg)
    assert (mask.sum(-1) == drs.keep_groups(512, cfg)).all()
    want, _ = jdrs.select_mask(jnp.asarray(s), 512, jdrs.DRSConfig(
        gamma=gamma, block=32, threshold_mode="topk"))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


@pytest.mark.parametrize("score", SCORES)
@pytest.mark.parametrize("mode", ["topk", "shared", "ema"])
def test_drs_mask_every_score_and_mode_equals_the_reference(score, mode):
    fx, fw = _randn(4, 2, 7, 64), _randn(5, 64, 256)
    cfg = dict(gamma=0.5, block=32, threshold_mode=mode, score=score)
    got = drs.drs_mask(_t(fx), _t(fw), drs.DRSConfig(**cfg))
    want, _ = jdrs.drs_mask(jnp.asarray(fx), jnp.asarray(fw),
                            jdrs.DRSConfig(**cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_drs_matches_oracle_on_separated_scores():
    """With weight columns of very different magnitudes DRS reproduces the
    oracle selection (the paper's Fig. 5(c) claim); the oracle itself
    equals the reference's on the same pre-activations."""
    d, f, block = 512, 1024, 64
    scales = np.repeat(2.0 ** np.arange(f // block), block)
    w = (_randn(1, d, f) * scales / np.sqrt(d)).astype(np.float32)
    x = np.abs(_randn(2, 32, d))
    cfg = drs.DRSConfig(gamma=0.5, block=block)
    r = projection.make_projection(projection.jll_dim(d, f, 0.5), d,
                                   generator=torch.Generator().manual_seed(3))
    m_drs = drs.drs_mask(projection.project_rows(r, _t(x)),
                         projection.project(r, _t(w)), cfg)
    pre = x @ w
    m_oracle = drs.oracle_mask(_t(pre), f, cfg)
    assert float((m_drs == m_oracle).float().mean()) > 0.95
    want = jdrs.oracle_mask(jnp.asarray(pre), f,
                            jdrs.DRSConfig(gamma=0.5, block=block,
                                           threshold_mode="shared"))
    np.testing.assert_array_equal(drs.oracle_mask(
        _t(pre), f, cfg._replace(threshold_mode="shared")).numpy(),
        np.asarray(want))


def test_shared_threshold_mode():
    cfg = drs.DRSConfig(gamma=0.5, block=32, threshold_mode="shared")
    mask = drs.select_mask(_t(_scores(0, 16, 8)), 256, cfg)
    assert int(mask[0].sum()) == drs.keep_groups(256, cfg)
    assert mask.shape == (16, 8)


def test_ema_threshold_updates():
    cfg = drs.DRSConfig(gamma=0.5, block=32, threshold_mode="ema",
                        ema_decay=0.5)
    scores = torch.ones(4, 8) * torch.arange(8.0)
    _, ema1 = drs.select_mask_ema(scores, 256, cfg, ema_threshold=0.0)
    _, ema2 = drs.select_mask_ema(scores, 256, cfg, ema_threshold=ema1)
    assert float(ema2) > float(ema1) >= 0.0
    assert ema1.dtype == torch.float32 and ema1.ndim == 0


def test_topk_all_tied_scores_keep_everything():
    cfg = drs.DRSConfig(gamma=0.5, block=4, threshold_mode="topk")
    assert drs.select_mask(torch.ones(3, 8), 32, cfg).bool().all()


@settings(max_examples=150, deadline=None)
@given(_SEED, _ROWS, _G, _BLOCK, _GAMMA)
def test_topk_density_respects_gamma(seed, rows, g, block, gamma):
    cfg = drs.DRSConfig(gamma=gamma, block=block, threshold_mode="topk")
    n_out = g * block
    s = _scores(seed, rows, g)
    mask, ema = drs.select_mask_ema(_t(s), n_out, cfg)
    assert ema is None
    k = drs.keep_groups(n_out, cfg)
    counts = mask.sum(dim=-1).numpy()
    assert (counts >= k).all()
    for r in range(rows):
        if len(np.unique(s[r])) == g:
            assert counts[r] == k
    assert float(masks.density(mask)) >= k / g - 1e-6


@settings(max_examples=150, deadline=None)
@given(_SEED, _ROWS, _G, _BLOCK, st.sampled_from([0.25, 0.5, 0.75]))
def test_shared_mode_uses_row0_topk_threshold(seed, rows, g, block, gamma):
    cfg = drs.DRSConfig(gamma=gamma, block=block, threshold_mode="shared")
    n_out = g * block
    s = _scores(seed, rows, g)
    k = drs.keep_groups(n_out, cfg)
    got = drs.select_mask(_t(s), n_out, cfg).numpy() > 0
    if k >= g:
        assert got.all()
        return
    assert np.array_equal(got, s >= np.sort(s[0])[g - k])


@settings(max_examples=150, deadline=None)
@given(_SEED, _ROWS, _G, _BLOCK)
def test_ema_deterministic_and_follows_decay(seed, rows, g, block):
    """ema mode is a pure function of (scores, carried threshold); the
    first call adopts the batch's mean top-k threshold, a carried EMA
    thresholds the mask and decays toward the batch's; both equal the
    reference's."""
    cfg = drs.DRSConfig(gamma=0.5, block=block, threshold_mode="ema",
                        ema_decay=0.9)
    jcfg = jdrs.DRSConfig(gamma=0.5, block=block, threshold_mode="ema",
                          ema_decay=0.9)
    n_out = g * block
    s = _scores(seed, rows, g)
    k = drs.keep_groups(n_out, cfg)
    m1, e1 = drs.select_mask_ema(_t(s), n_out, cfg)
    m2, e2 = drs.select_mask_ema(_t(s), n_out, cfg)
    assert torch.equal(m1, m2)
    if k >= g:
        assert e1 is None and e2 is None
        return
    assert float(e1) == float(e2)
    # the seed call's threshold: the f32 mean of the rows' k-th largest
    thr_now = float(_t(np.sort(s, axis=-1)[:, g - k].copy()).mean())
    assert np.isclose(float(e1), thr_now, rtol=1e-5, atol=1e-6)
    assert np.array_equal(m1.numpy(), (s >= thr_now).astype(np.float32))
    carried = np.float32(thr_now + 1.0)
    m3, e3 = drs.select_mask_ema(_t(s), n_out, cfg, ema_threshold=carried)
    assert np.array_equal(m3.numpy(), (s >= carried).astype(np.float32))
    # f32 rounding of terms ~1: absolute, for values near zero
    assert np.isclose(float(e3), 0.9 * carried + 0.1 * thr_now, rtol=1e-5,
                      atol=1e-6)
    for carry in (None, carried):
        jm, je = jdrs.select_mask(jnp.asarray(s), n_out, jcfg,
                                  None if carry is None
                                  else jnp.asarray(carry))
        tm, te = drs.select_mask_ema(_t(s), n_out, cfg, carry)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        # the EMA sums the rows' thresholds in another order than the
        # reference: an error of a few ulps of the largest, not of the sum
        np.testing.assert_allclose(float(te), float(je), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(s).max()))


def test_expand_mask_equals_the_reference():
    m = (np.random.default_rng(0).random((3, 4, 5)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(drs.expand_mask(_t(m), 8).numpy(),
                                  np.asarray(jdrs.expand_mask(
                                      jnp.asarray(m), 8)))


@settings(max_examples=50, deadline=None)
@given(st.integers(0, 2**31 - 1), _ROWS, _G, _GAMMA)
def test_random_mask_keeps_exactly_k_per_row(seed, rows, g, gamma):
    cfg = drs.DRSConfig(gamma=gamma, block=4)
    gen = torch.Generator().manual_seed(seed)
    m = drs.random_mask(gen, (rows, 3), g * 4, cfg)
    assert m.shape == (rows, 3, g) and m.dtype == torch.float32
    assert (m.sum(-1) == drs.keep_groups(g * 4, cfg)).all()
    again = drs.random_mask(torch.Generator().manual_seed(seed), (rows, 3),
                            g * 4, cfg)
    assert torch.equal(m, again)


def test_random_mask_reaches_every_group_evenly():
    cfg = drs.DRSConfig(gamma=0.75, block=8)
    m = drs.random_mask(torch.Generator().manual_seed(0), (4000,), 16 * 8,
                        cfg)
    freq = m.mean(dim=0)
    assert (freq > 0).all()
    np.testing.assert_allclose(freq.numpy(), 0.25, atol=0.03)


# ---------------------------------------------------------------------------
# DSG FFN: state, autodiff, gather path
# ---------------------------------------------------------------------------

def _ffn(d=128, f=256, block=64, **kw):
    cfg = jdl.DSGConfig(enabled=True, gamma=0.5, block=block, **kw)
    p = jdl.init_swiglu(jax.random.PRNGKey(0), d, f)
    state = jdl.init_dsg_state(jax.random.PRNGKey(1), d, f, cfg,
                               jdl.search_weight(p))
    tp = dl.SwiGLU(*(bridge.tensor(np.asarray(p[k]))
                     for k in ("w_gate", "w_up", "w_down")))
    ts = {k: bridge.tensor(np.asarray(v)) for k, v in state.items()}
    return cfg, p, state, dl.DSGConfig(*cfg), tp, ts


def test_init_dsg_state_refresh_fw_and_search_weight():
    cfg, p, state, tcfg, tp, ts = _ffn()
    assert dl.search_weight(tp) is tp.w_gate
    st_ = dl.init_dsg_state(128, 256, tcfg, tp.w_gate,
                            generator=torch.Generator().manual_seed(0))
    assert st_["r"].shape == (dl.proj_dim(128, 256, tcfg), 128)
    np.testing.assert_allclose(st_["fw"].numpy(),
                               (st_["r"] @ tp.w_gate).numpy(), atol=ATOL)
    moved = _randn(9, 128, 256)
    got = dl.refresh_fw(ts, _t(moved))
    want = jdl.refresh_fw(state, jnp.asarray(moved))
    assert got["r"] is ts["r"]
    np.testing.assert_allclose(got["fw"].numpy(), np.asarray(want["fw"]),
                               atol=ATOL)


def test_mask_is_constant_wrt_autodiff_and_grads_equal_the_reference():
    cfg, p, state, tcfg, tp, ts = _ffn()
    x = _randn(2, 8, 128)
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad((dl.swiglu_ffn(tp, xt, ts, tcfg) ** 2).sum(),
                               [xt])
    want = jax.grad(lambda x_: jnp.sum(
        jdl.swiglu_ffn(p, x_, state, cfg) ** 2))(jnp.asarray(x))
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                               atol=ATOL)


def test_backward_sparsity():
    """The paper's Algorithm 1: a group dropped by every row gets exactly
    zero gradient in its w_down rows and its w_gate/w_up columns."""
    cfg, p, state, tcfg, tp, ts = _ffn()
    for w in (tp.w_gate, tp.w_up, tp.w_down):
        w.requires_grad_(True)
    x = _t(_randn(2, 2, 128))
    mask = dl.drs_group_mask(x, ts, tcfg)                  # (2, 4)
    dropped = torch.nonzero(mask.amax(dim=0) == 0).flatten().tolist()
    assert dropped
    gg, gu, gd = torch.autograd.grad(
        (dl.swiglu_ffn(tp, x, ts, tcfg) ** 2).sum(),
        [tp.w_gate, tp.w_up, tp.w_down])
    for gidx in dropped:
        cols = slice(gidx * 64, (gidx + 1) * 64)
        assert not gd[cols].any()
        assert not gg[:, cols].any() and not gu[:, cols].any()


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_gather_shared_equals_the_reference(n_chunks):
    cfg, p, state, tcfg, tp, ts = _ffn(f=512, mode="gather_shared",
                                       n_chunks=n_chunks)
    x = _randn(3, 2, 5, 128)
    idx = dl.shared_topk_indices(_t(x), ts, tcfg, 512)
    jidx = jdl.shared_topk_indices(jnp.asarray(x), state, cfg, 512)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    got = dl.swiglu_ffn(tp, _t(x), ts, tcfg)
    want = jdl.swiglu_ffn(p, jnp.asarray(x), state, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=ATOL)
    np.testing.assert_allclose(
        dl.swiglu_dsg_gather(tp, _t(x), ts, tcfg).numpy(),
        np.asarray(jdl.swiglu_dsg_gather(p, jnp.asarray(x), state, cfg)),
        rtol=1e-5, atol=ATOL)


def test_swiglu_ffn_counts_its_calls_by_mode():
    cfg, p, state, tcfg, tp, ts = _ffn()
    dl.swiglu_ffn.calls.update(dict.fromkeys(dl.FFN_MODES, 0))
    x = _t(_randn(1, 4, 128))
    dl.swiglu_ffn(tp, x, ts, tcfg)
    dl.swiglu_ffn(tp, x, None, tcfg)
    dl.swiglu_ffn(tp, x, ts, tcfg._replace(mode="gather_shared"))
    dl.swiglu_ffn(tp, x, ts, tcfg._replace(enabled=False))
    assert dl.swiglu_ffn.calls == {"dense": 2, "mask": 1, "gather_shared": 1}
    with pytest.raises(ValueError, match="unknown DSG mode"):
        dl.swiglu_ffn(tp, x, ts, tcfg._replace(mode="csr"))


# ---------------------------------------------------------------------------
# double mask (the paper's §2.3)
# ---------------------------------------------------------------------------

def _bn_case():
    b, f, block = 64, 256, 32
    x = np.maximum(_randn(0, b, f), 0.0)
    gmask = (np.random.default_rng(1).random((b, f // block)) > 0.5).astype(
        np.float32)
    return x, gmask, np.full(f, 1.3, np.float32), np.full(f, 0.1, np.float32)


def test_double_mask_restores_sparsity_after_bn():
    x, gmask, scale, bias = _bn_case()

    def bn(z):
        return double_mask.batch_norm_train(z, _t(scale), _t(bias))

    single = double_mask.single_mask(bn, _t(x), _t(gmask), 32).numpy()
    dble = double_mask.double_mask(bn, _t(x), _t(gmask), 32).numpy()
    exp = drs.expand_mask(_t(gmask), 32).numpy()
    assert (single[exp == 0] != 0).mean() > 0.9
    np.testing.assert_array_equal(dble[exp == 0], 0.0)


def test_double_and_single_mask_equal_the_reference():
    x, gmask, scale, bias = _bn_case()
    for fn, jfn in ((double_mask.double_mask, jdm.double_mask),
                    (double_mask.single_mask, jdm.single_mask)):
        got = fn(lambda z: double_mask.batch_norm_train(z, _t(scale),
                                                        _t(bias)),
                 _t(x), _t(gmask), 32)
        want = jfn(lambda z: jdm.batch_norm_train(z, jnp.asarray(scale),
                                                  jnp.asarray(bias)),
                   jnp.asarray(x), jnp.asarray(gmask), 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=ATOL)


def test_double_mask_preserves_kept_values():
    b, f, block = 32, 128, 16
    x = _t(_randn(5, b, f))

    def bn(z):
        return double_mask.batch_norm_train(z, torch.ones(f), torch.zeros(f))

    out = double_mask.double_mask(bn, x, torch.ones(b, f // block), block)
    np.testing.assert_allclose(out.numpy(), bn(x).numpy(), rtol=1e-5,
                               atol=1e-6)


def test_double_mask_stops_gradients_into_the_mask():
    x = _t(_randn(6, 8, 32)).requires_grad_(True)
    m = torch.ones(8, 4, requires_grad=True)
    y = double_mask.double_mask(lambda z: z * 2.0, x, m, 8)
    assert y.requires_grad
    (gm,) = torch.autograd.grad(y.sum(), [x])
    np.testing.assert_array_equal(gm.numpy(), 2.0)


# ---------------------------------------------------------------------------
# mask algebra, CSR and the stash model
# ---------------------------------------------------------------------------

def test_mask_overhead_under_2pct():
    shape = (64, 4096, 14336)
    dense = int(np.prod(shape)) * 2
    assert masks.mask_overhead_bytes(shape, 128) / dense < 0.02


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(1, 6), min_size=1, max_size=3), _G, _BLOCK)
def test_mask_overhead_bytes_bit_packs_per_row(batch, g, block):
    shape = tuple(batch) + (g * block,)
    b = masks.mask_overhead_bytes(shape, block)
    assert b == int(np.prod(batch)) * ((g + 7) // 8)
    assert b == jmasks.mask_overhead_bytes(shape, block)
    assert masks.mask_overhead_bytes((2,) + shape, block) == 2 * b
    assert masks.mask_overhead_bytes((8 * block,), block) == 1


@settings(max_examples=150, deadline=None)
@given(_SEED, _ROWS, _G, _BLOCK)
def test_apply_expanded_matches_explicit_expansion(seed, rows, g, block):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, g * block)).astype(np.float32)
    gm = rng.integers(0, 2, (rows, g)).astype(np.float32)
    y = masks.apply_expanded(_t(x), _t(gm), block).numpy()
    assert np.array_equal(y, x * np.repeat(gm, block, axis=-1))
    assert np.array_equal(masks.apply_expanded(_t(y), _t(gm), block).numpy(),
                          y)
    assert np.array_equal(masks.apply_expanded(
        _t(x), torch.ones(rows, g), block).numpy(), x)
    got = masks.density(_t(gm))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(jmasks.density(
        jnp.asarray(gm))), rtol=1e-6)


@pytest.mark.parametrize("bound", [1, 2, 3, 5, 8])
def test_dense_to_csr_equals_the_reference(bound):
    rng = np.random.default_rng(bound)
    mask = (rng.random((3, 4, 8)) < 0.45).astype(np.float32)
    mask[0, 0] = 0.0                               # an empty row
    mask[0, 1] = 1.0                               # a full row
    idx, counts = sparse_mask.dense_to_csr(_t(mask), bound)
    jidx, jcounts = jsm.dense_to_csr(jnp.asarray(mask), bound)
    assert idx.dtype == counts.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    if bound == 8:                                 # covers every row
        back = sparse_mask.csr_to_dense(idx, counts, 8)
        np.testing.assert_array_equal(back.numpy(), mask)


@pytest.mark.parametrize("batch,bound", [((4,), 8), ((2, 3), 16), ((), 1)])
def test_csr_overhead_bytes_equals_the_reference(batch, bound):
    assert sparse_mask.csr_rows(batch) == jsm.csr_rows(batch)
    assert (sparse_mask.csr_overhead_bytes(batch, bound)
            == jsm.csr_overhead_bytes(batch, bound))
    assert (sparse_mask.csr_overhead_bytes(batch, bound, 2, 2)
            == jsm.csr_overhead_bytes(batch, bound, 2, 2))


STASH_SHAPES = [[(8, 256, 8192), (8, 256, 2048)], [(2, 16, 256)],
                [(4, 1024, 14336)] * 3]


@pytest.mark.parametrize("shapes", STASH_SHAPES)
@pytest.mark.parametrize("gamma", [0.0, 0.5, 0.9])
def test_stash_model_equals_the_reference(shapes, gamma):
    for dtype_bytes in (2, 4):
        kw = dict(gamma=gamma, block=128, param_bytes=123_456,
                  dtype_bytes=dtype_bytes)
        assert (stash.training_footprint(shapes, **kw)
                == jstash.training_footprint(shapes, **kw))
        assert (stash.inference_footprint(shapes, **kw)
                == jstash.inference_footprint(shapes, **kw))
        for s in shapes:
            assert (stash.dsg_stash_bytes(s, gamma, 128, dtype_bytes)
                    == jstash.dsg_stash_bytes(s, gamma, 128, dtype_bytes))
            assert (stash.dense_stash_bytes(s, dtype_bytes)
                    == jstash.dense_stash_bytes(s, dtype_bytes))


def test_stash_dsg_saves_what_gamma_drops():
    fp = stash.training_footprint([(8, 256, 8192)] * 24, 0.5, 128,
                                  param_bytes=0)
    assert 1.9 < fp["ratio_activations"] < 2.0
