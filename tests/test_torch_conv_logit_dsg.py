"""The port's `core/conv_dsg.py` and `core/logit_dsg.py` against the
reference's on the same inputs and the same bridged parameters, and the
port's mirrors of `tests/test_conv_dsg.py` and the logit-DSG cases of
`tests/test_serving.py`.  Neither module has a model call site, in either
package.

Tolerances: the im2col products and the convolution oracle rtol / atol
2e-5 (the reference's own im2col-against-lax.conv bound); masked outputs
and logits atol 1e-5, masks equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import conv_dsg as jconv  # noqa: E402
from repro.core import logit_dsg as jlogit  # noqa: E402
from repro.core.dsg_linear import DSGConfig as JDSGConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import conv_dsg, drs, logit_dsg  # noqa: E402
from repro_torch.core.dsg_linear import DSGConfig  # noqa: E402

CONV = dict(rtol=2e-5, atol=2e-5)
EXACT = dict(rtol=0, atol=1e-5)


def _t(a) -> torch.Tensor:
    return bridge.tensor(np.asarray(a))


def _dsg(cfg: JDSGConfig) -> DSGConfig:
    return DSGConfig(*cfg)


def _close(got, want, tol=EXACT):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# conv_dsg
# ---------------------------------------------------------------------------

def _conv_case(c_in, rs, n_k, cfg, seed, shape=(2, 8, 8)):
    x = jax.random.normal(jax.random.PRNGKey(seed), shape + (c_in,))
    p = jconv.init_conv_dsg(jax.random.PRNGKey(seed + 1), c_in, rs, n_k,
                            cfg)
    return x, p, _t(x), bridge.dsg_from_jax(jax.tree.map(np.asarray, p),
                                            device="cpu")


@pytest.mark.parametrize("rs", [(1, 1), (3, 3), (5, 5), (2, 2), (4, 3)])
def test_im2col_matches_reference(rs):
    """Patches equal, ordered (R, S, C), with the reference's SAME padding
    (r // 2 before, (r - 1) // 2 after: at an even window one more row
    before than lax's "SAME")."""
    x, _, tx, _ = _conv_case(3, rs, 16, JDSGConfig(enabled=False), 0)
    want = jconv.im2col(x, rs)
    got = conv_dsg.im2col(tx, rs)
    assert tuple(got.shape) == want.shape
    _close(got, want, dict(rtol=0, atol=0))
    valid = conv_dsg.im2col(tx, rs, padding="VALID")
    _close(valid, jconv.im2col(x, rs, padding="VALID"), dict(rtol=0, atol=0))


@pytest.mark.parametrize("rs", [(3, 3), (1, 1), (5, 5)])
def test_im2col_matches_lax_conv(rs):
    """The mirror of tests/test_conv_dsg.py's case: the im2col product
    equals the convolution oracle, and the port's oracle (F.conv2d)
    equals the reference's (lax.conv)."""
    x, p, tx, tp = _conv_case(3, rs, 16, JDSGConfig(enabled=False), 0)
    patches = conv_dsg.im2col(tx, rs)
    y = (patches.reshape(-1, patches.shape[-1]) @ tp["w"]).reshape(
        2, 8, 8, 16)
    want = jconv.conv2d_ref(p["w"], x, rs)
    ref = conv_dsg.conv2d_ref(tp["w"], tx, rs)
    _close(y, want, CONV)
    _close(ref, want, CONV)


@pytest.mark.parametrize("rs", [(2, 2), (4, 4)])
def test_conv2d_ref_pads_as_lax_same_at_even_windows(rs):
    x, p, tx, tp = _conv_case(3, rs, 8, JDSGConfig(enabled=False), 3)
    _close(conv_dsg.conv2d_ref(tp["w"], tx, rs),
           jconv.conv2d_ref(p["w"], x, rs), CONV)


def test_init_conv_dsg_matches_the_reference_shapes():
    cfg = JDSGConfig(enabled=True, gamma=0.5, block=8, eps=0.5)
    p = jconv.init_conv_dsg(jax.random.PRNGKey(3), 4, (3, 3), 32, cfg)
    tp = conv_dsg.init_conv_dsg(4, (3, 3), 32, _dsg(cfg),
                                generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in p.items()}
    assert all(v.dtype == torch.float32 for v in tp.values())
    _close(tp["fw"], (tp["r"] @ tp["w"]).numpy())


def test_conv_dsg_masks_per_window():
    """The mirror of tests/test_conv_dsg.py's case, and the reference's
    outputs and masks on the same parameters."""
    cfg = JDSGConfig(enabled=True, gamma=0.5, block=8, eps=0.5)
    x, p, tx, tp = _conv_case(4, (3, 3), 32, cfg, 2)
    want_y, want_m = jconv.conv2d_dsg(p, x, (3, 3), cfg)
    y, gmask = conv_dsg.conv2d_dsg(tp, tx, (3, 3), _dsg(cfg))
    assert tuple(y.shape) == (2, 8, 8, 32)
    assert tuple(gmask.shape) == (2 * 8 * 8, 4)     # per-window masks
    k = drs.keep_groups(32, _dsg(cfg).drs_cfg())
    assert torch.equal(gmask.sum(-1), torch.full((128,), float(k)))
    ym = y.reshape(-1, 4, 8)
    assert bool((ym[gmask == 0] == 0).all())
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(want_m))
    _close(y, want_y)


@pytest.mark.parametrize("mask_mode", ["double", "single"])
def test_conv_dsg_bn_matches_reference(mask_mode):
    """The mirror of tests/test_conv_dsg.py's double-mask case: the double
    mask keeps the dataflow fully sparse, the single mask lets BN densify
    it; both equal the reference's outputs."""
    cfg = JDSGConfig(enabled=True, gamma=0.5, block=8, eps=0.5)
    x, p, tx, tp = _conv_case(4, (3, 3), 32, cfg, 4, shape=(4, 6, 6))
    scale, bias = jnp.ones(32), jnp.ones(32) * 0.2
    want, wm = jconv.conv2d_dsg(p, x, (3, 3), cfg, scale, bias,
                                mask_mode=mask_mode)
    y, gmask = conv_dsg.conv2d_dsg(tp, tx, (3, 3), _dsg(cfg), _t(scale),
                                   _t(bias), mask_mode=mask_mode)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wm))
    _close(y, want, dict(rtol=0, atol=2e-5))
    dropped = y.reshape(-1, 4, 8)[gmask == 0]
    if mask_mode == "double":
        assert bool((dropped == 0).all())                # fully sparse
    else:
        assert float((dropped != 0).float().mean()) > 0.9   # BN densified


def test_conv_dsg_off_with_bn_matches_reference():
    cfg = JDSGConfig(enabled=False)
    x, p, tx, tp = _conv_case(3, (3, 3), 16, cfg, 6)
    scale, bias = jnp.full(16, 0.5), jnp.ones(16) * -0.1
    want, wm = jconv.conv2d_dsg(p, x, (3, 3), cfg, scale, bias)
    y, gmask = conv_dsg.conv2d_dsg(tp, tx, (3, 3), _dsg(cfg), _t(scale),
                                   _t(bias))
    assert wm is None and gmask is None
    _close(y, want, dict(rtol=0, atol=2e-5))
    plain, _ = conv_dsg.conv2d_dsg(tp, tx, (3, 3), _dsg(cfg))
    _close(plain, torch.relu(conv_dsg.conv2d_ref(tp["w"], tx, (3, 3))),
           CONV)


# ---------------------------------------------------------------------------
# logit_dsg
# ---------------------------------------------------------------------------

def _logit_case(d, v, b, cfg, seed, x=None):
    key = jax.random.PRNGKey(seed)
    w = jax.random.normal(key, (d, v)) / np.sqrt(d)
    if x is None:
        x = jax.random.normal(jax.random.fold_in(key, 1), (b, d))
    st = jlogit.init_logit_dsg(jax.random.fold_in(key, 2), w, cfg)
    return w, x, st, bridge.dsg_from_jax(jax.tree.map(np.asarray, st),
                                         device="cpu")


@pytest.mark.parametrize("per_request", [True, False])
def test_dsg_logits_match_reference(per_request):
    """Logits on the kept blocks, NEG elsewhere, and the block masks, as
    the reference's (per-request and batch-shared)."""
    cfg = JDSGConfig(enabled=True, gamma=0.5, block=32, eps=0.5)
    w, x, st, tst = _logit_case(64, 512, 4, cfg, 0)
    want, wm = jlogit.dsg_logits(x, w, st, cfg, per_request=per_request)
    got, mask = logit_dsg.dsg_logits(_t(x), _t(w), tst, _dsg(cfg),
                                     per_request=per_request)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wm))
    _close(got, want)
    assert mask.dtype == torch.float32
    if not per_request:
        assert bool((mask == mask[0]).all())


def test_dsg_logits_exact_on_selected_blocks():
    """The mirror of tests/test_serving.py's case."""
    cfg = DSGConfig(enabled=True, gamma=0.5, block=32, eps=0.5)
    gen = torch.Generator().manual_seed(0)
    d, v, b = 64, 512, 4
    w = torch.randn((d, v), generator=gen) / np.sqrt(d)
    x = torch.randn((b, d), generator=gen)
    st = logit_dsg.init_logit_dsg(w, cfg, generator=gen)
    assert tuple(st["r"].shape) == (64, 64) and tuple(st["fw"].shape) == \
        (64, 512)
    full = (x @ w).reshape(b, -1, 32)
    for per_request in (True, False):
        logits, mask = logit_dsg.dsg_logits(x, w, st, cfg,
                                            per_request=per_request)
        sel = mask.bool()
        lg = logits.reshape(b, -1, 32)
        np.testing.assert_allclose(lg[sel].numpy(), full[sel].numpy(),
                                   rtol=2e-5, atol=2e-5)
        assert bool((lg[~sel] <= -1e29).all())
        assert int(sel.sum(-1)[0]) == 8


@pytest.mark.parametrize("per_request", [True, False])
def test_dsg_logits_break_ties_toward_the_lower_block(per_request):
    """Two vocab blocks with identical weights tie on every score; with
    one slot left for them the lower block is kept, as lax.top_k keeps
    it."""
    cfg = JDSGConfig(enabled=True, gamma=0.75, block=32, eps=0.5)
    key = jax.random.PRNGKey(9)
    d = 64
    w = np.asarray(jax.random.normal(key, (d, 256)) / np.sqrt(d))
    w = w.copy()
    # blocks 2 and 5 hold the same columns, scaled up so that both beat
    # every other block: keep = 2 of 8 picks exactly one of them plus the
    # best other, unless they are the top two
    w[:, 160:192] = w[:, 64:96] = 3.0 * w[:, 64:96]
    w[:, 96:128] *= 6.0
    x = jax.random.normal(jax.random.fold_in(key, 1), (3, d))
    x = jnp.abs(x)
    wj = jnp.asarray(w)
    st = jlogit.init_logit_dsg(jax.random.fold_in(key, 2), wj, cfg)
    tst = bridge.dsg_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    want, wm = jlogit.dsg_logits(x, wj, st, cfg, per_request=per_request)
    got, mask = logit_dsg.dsg_logits(_t(x), _t(w), tst, _dsg(cfg),
                                     per_request=per_request)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wm))
    _close(got, want)
    # the tie is real: blocks 2 and 5 score the same, and one is kept
    scores = drs.group_scores(
        (_t(x) @ tst["r"].t()) @ tst["fw"],
        _dsg(cfg).drs_cfg()._replace(score="max"))
    assert torch.equal(scores[:, 2], scores[:, 5])
    kept = mask[:, [2, 5]]
    assert bool((kept.sum(-1) == 1).all()) and bool((kept[:, 0] == 1).all())


def test_dsg_logits_greedy_hit_rate():
    """The mirror of tests/test_serving.py's case: decode-like hidden
    states that correlate with the winning column keep its block in > 90%
    of rows, on the reference's inputs and parameters."""
    key = jax.random.PRNGKey(3)
    d, v, b = 128, 1024, 64
    w = jax.random.normal(key, (d, v)) / np.sqrt(d)
    targets = jax.random.randint(jax.random.fold_in(key, 9), (b,), 0, v)
    noise = jax.random.normal(jax.random.fold_in(key, 1), (b, d))
    x = 2.0 * w[:, targets].T * np.sqrt(d) / jnp.linalg.norm(
        w[:, targets].T, axis=-1, keepdims=True) + noise
    cfg = JDSGConfig(enabled=True, gamma=0.5, block=32, eps=0.3)
    _, _, st, tst = _logit_case(d, v, b, cfg, 3, x=x)
    st = jlogit.init_logit_dsg(jax.random.fold_in(key, 2), w, cfg)
    tst = bridge.dsg_from_jax(jax.tree.map(np.asarray, st), device="cpu")
    tx, tw = _t(x), _t(w)
    logits, _ = logit_dsg.dsg_logits(tx, tw, tst, _dsg(cfg))
    hit = (logits.argmax(-1) == (tx @ tw).argmax(-1)).float().mean()
    assert float(hit) > 0.9
    want, _ = jlogit.dsg_logits(x, w, st, cfg)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(want, -1)))


@pytest.mark.parametrize("v,d,eps,gamma", [(131072, 5120, 0.3, 0.5),
                                           (131072, 5120, 0.5, 0.5),
                                           (51872, 1280, 0.5, 0.75),
                                           (1024, 128, 0.3, 0.5)])
def test_flops_saving_equals_reference(v, d, eps, gamma):
    cfg = JDSGConfig(enabled=True, gamma=gamma, block=32, eps=eps)
    assert logit_dsg.flops_saving(v, d, _dsg(cfg)) == \
        jlogit.flops_saving(v, d, cfg)
    if (v, d) == (131072, 5120):
        # the reference's production-width claims
        assert logit_dsg.flops_saving(v, d, _dsg(cfg)) > (
            0.35 if eps == 0.3 else 0.4)
