"""The recurrent families' units in the port (`repro_torch.models.mamba2`
and `repro_torch.models.xlstm`) against `repro`'s on the same numpy-seeded
inputs, on the CPU in f32, plus the port's mirror of
`tests/test_models_units.py`'s recurrence checks (`:116` SSD chunked
against the recurrence, `:135` Mamba decode continuing a prefill, `:151`
mLSTM chunked against the recurrence), and the one deviation of both
chunked scans: their decay is masked before its exp, so a decay summed
past 88.7 over a chunk stays finite where the reference's turns NaN.

Tolerances (f32): each port function against the reference's rtol 1e-5 /
atol 1e-6 (the same products summed in another order; measured: at most
a few f32 ulps); gradients rtol 1e-4 with an atol of 1e-6 x the leaf's
largest entry; the chunked scans against the step-by-step recurrence at
the reference's own bound, rtol / atol 2e-4, and a decode step against the
full forward at its 2e-3.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors gain nothing from threads, which would only contend with
# the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import mamba2 as m2  # noqa: E402
from repro_torch.models import xlstm as xl  # noqa: E402

UNIT = dict(rtol=1e-5, atol=1e-6)
RECURRENCE = dict(rtol=2e-4, atol=2e-4)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or UNIT))


def _ssd_inputs(seed, b, s, h, p, n):
    rng = _rng(seed)
    xh = _normal(rng, (b, s, h, p))
    dt = np.log1p(np.exp(_normal(rng, (b, s, h)))).astype(np.float32)
    a = (-0.5 * dt).astype(np.float32)
    return xh, dt, a, _normal(rng, (b, s, n)), _normal(rng, (b, s, n))


def _naive_ssd(xh, dt, a, bmat, cmat, h0=None):
    """The SSD recurrence one token at a time, in torch f32."""
    b, s, h, p = xh.shape
    hst = (torch.zeros((b, h, bmat.shape[-1], p)) if h0 is None
           else h0.clone())
    ys = []
    for t in range(s):
        hst = hst * torch.exp(a[:, t])[:, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", bmat[:, t], xh[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bn,bhnp->bhp", cmat[:, t], hst))
    return torch.stack(ys, dim=1), hst


@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 24)])
def test_ssd_chunked_matches_recurrence(s, chunk):
    b, h, p, n = 2, 3, 4, 5
    dm = m2.Mamba2Dims(d=0, d_in=h * p, heads=h, head_dim=p, n=n,
                       chunk=chunk)
    args = _ssd_inputs(4, b, s, h, p, n)
    y, hf = m2.ssd_chunked(*map(_t, args), dm)
    y_ref, hf_ref = _naive_ssd(*map(_t, args))
    _close(y, y_ref.numpy(), **RECURRENCE)
    _close(hf, hf_ref.numpy(), **RECURRENCE)
    jy, jhf = jm2.ssd_chunked(*map(jnp.asarray, args),
                              jm2.Mamba2Dims(*dm))
    _close(y, jy)
    _close(hf, jhf)


@pytest.mark.parametrize("s,chunk,with_h0", [(20, 8, False), (20, 8, True),
                                             (7, 4, True), (3, 8, False)])
def test_ssd_chunked_ragged_tail_and_h0_match_reference(s, chunk, with_h0):
    """A ragged tail is padded with dt = 0 tokens (identity on the state),
    as the reference pads it."""
    b, h, p, n = 2, 3, 4, 5
    dm = m2.Mamba2Dims(d=0, d_in=h * p, heads=h, head_dim=p, n=n,
                       chunk=chunk)
    args = _ssd_inputs(11, b, s, h, p, n)
    h0 = _normal(_rng(12), (b, h, n, p)) if with_h0 else None
    y, hf = m2.ssd_chunked(*map(_t, args), dm,
                           None if h0 is None else _t(h0))
    jy, jhf = jm2.ssd_chunked(*map(jnp.asarray, args), jm2.Mamba2Dims(*dm),
                              None if h0 is None else jnp.asarray(h0))
    assert tuple(y.shape) == (b, s, h, p) and hf.dtype == torch.float32
    _close(y, jy)
    _close(hf, jhf)
    y_ref, hf_ref = _naive_ssd(*map(_t, args),
                               None if h0 is None else _t(h0))
    _close(y, y_ref.numpy(), **RECURRENCE)
    _close(hf, hf_ref.numpy(), **RECURRENCE)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = _rng(3)
    seq = _normal(rng, (2, 6, 5))
    w = _normal(rng, (m2.CONV_K, 5))
    state = _normal(rng, (2, m2.CONV_K - 1, 5)) if with_state else None
    out, st = m2._causal_conv(_t(seq), _t(w),
                              None if state is None else _t(state))
    jout, jst = jm2._causal_conv(jnp.asarray(seq), jnp.asarray(w),
                                 None if state is None else
                                 jnp.asarray(state))
    _close(out, jout)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))


def _mamba(seed, d=16, expand=2, n=8, heads=4, chunk=8):
    dm = m2.dims(d, expand, n, heads, chunk)
    params = jm2.init_mamba2(jax.random.PRNGKey(seed), jm2.Mamba2Dims(*dm))
    p = m2.Mamba2(**{k: bridge.tensor(v) for k, v in
                     jax.tree.map(np.asarray, params).items()})
    return dm, params, p


def test_init_mamba2_matches_reference_shapes_and_dtypes():
    dm = m2.dims(16, 2, 8, 4, 8)
    want = jm2.init_mamba2(jax.random.PRNGKey(0), jm2.Mamba2Dims(*dm),
                           jnp.bfloat16)
    got = m2.init_mamba2(dm, generator=torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16)
    names = dict(got.named_parameters())
    assert set(names) == set(want)
    for k, v in want.items():
        assert tuple(names[k].shape) == v.shape, k
        assert str(names[k].dtype).endswith(str(v.dtype)), k
    for k in ("a_log", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(names[k].numpy(), np.asarray(want[k]))
    assert m2.dims(3584, 2, 64, 112, 128) == (3584, 7168, 112, 64, 64, 128)
    assert m2.dims(64, 2, 16, 0, 16).heads == 2


@pytest.mark.parametrize("masked", [False, True])
def test_mamba2_forward_and_decode_match_reference(masked):
    dm, params, p = _mamba(5)
    rng = _rng(6)
    x = _normal(rng, (2, 13, dm.d))
    gm = ((rng.random((2, 13, dm.d_in)) < 0.5).astype(np.float32)
          if masked else None)
    out, st = m2.mamba2_forward(p, _t(x), dm, None,
                                None if gm is None else _t(gm))
    jout, jst = jm2.mamba2_forward(params, jnp.asarray(x),
                                   jm2.Mamba2Dims(*dm), None,
                                   None if gm is None else jnp.asarray(gm))
    _close(out, jout)
    assert set(st) == set(jst) == {"ssm", "conv_x", "conv_bc"}
    for k in st:
        _close(st[k], jst[k])
    # three decode steps from that state
    for i in range(3):
        xt = _normal(rng, (2, 1, dm.d))
        gt = gm[:, :1] if masked else None
        out, st = m2.mamba2_forward(p, _t(xt), dm, st,
                                    None if gt is None else _t(gt))
        jout, jst = jm2.mamba2_forward(params, jnp.asarray(xt),
                                       jm2.Mamba2Dims(*dm), jst,
                                       None if gt is None else
                                       jnp.asarray(gt))
        _close(out, jout)
        for k in st:
            _close(st[k], jst[k])


def test_mamba_decode_continues_prefill():
    dm, params, p = _mamba(5)
    x = _t(np.asarray(jax.random.normal(jax.random.PRNGKey(6), (1, 16, 16))))
    full, _ = m2.mamba2_forward(p, x, dm)
    _, st = m2.mamba2_forward(p, x[:, :15], dm)
    step, _ = m2.mamba2_forward(p, x[:, 15:16], dm, state=st)
    _close(step[:, 0], full[:, 15].numpy(), rtol=2e-3, atol=2e-3)


def _grads_match(fn_port, fn_ref, params, module):
    """d sum(out * w) / d params of the port against jax.grad."""
    names = dict(module.named_parameters())
    for t in names.values():
        t.requires_grad_(True)
    out = fn_port()
    w = _normal(_rng(99), tuple(out.shape))
    got = dict(zip(names, torch.autograd.grad((out * _t(w)).sum(),
                                              list(names.values()),
                                              allow_unused=True)))
    want = jax.jit(jax.grad(lambda prm: jnp.sum(fn_ref(prm) * w)))(params)
    for k, g in want.items():
        g = np.asarray(g)
        tol = 1e-6 * max(1.0, float(np.abs(g).max()))
        if got[k] is None:      # a leaf the forward does not read
            assert not np.any(g), k
            continue
        np.testing.assert_allclose(got[k].numpy(), g, rtol=1e-4, atol=tol,
                                   err_msg=k)


def test_mamba2_gradients_match_reference():
    dm, params, p = _mamba(7, chunk=4)
    x = _normal(_rng(8), (2, 10, dm.d))
    gm = (_rng(9).random((2, 10, dm.d_in)) < 0.5).astype(np.float32)
    _grads_match(lambda: m2.mamba2_forward(p, _t(x), dm, None, _t(gm))[0],
                 lambda prm: jm2.mamba2_forward(
                     prm, jnp.asarray(x), jm2.Mamba2Dims(*dm), None,
                     jnp.asarray(gm))[0], params, p)


# ---------------------------------------------------------------------------
# mLSTM and sLSTM
# ---------------------------------------------------------------------------

def _mlstm_inputs(seed, b, s, h, dk):
    rng = _rng(seed)
    q, k, v = (_normal(rng, (b, s, h, dk)) for _ in range(3))
    log_f = np.asarray(jax.nn.log_sigmoid(_normal(rng, (b, s, h)) + 2.0))
    i_gate = np.exp(_normal(rng, (b, s, h), 0.3)).astype(np.float32)
    return q, k, v, log_f, i_gate


def test_mlstm_chunked_matches_recurrence():
    b, s, h, dk = 1, 16, 2, 4
    dm = xl.MLSTMDims(d=h * dk, heads=h, dk=dk, dv=dk, chunk=4)
    q, k, v, log_f, i_gate = map(_t, _mlstm_inputs(7, b, s, h, dk))
    y, _ = xl.mlstm_chunked(q, k, v, log_f, i_gate, dm)
    c = torch.zeros((b, h, dk, dk))
    n = torch.ones((b, h, dk))
    outs = []
    for t in range(s):
        f = torch.exp(log_f[:, t])
        c = c * f[..., None, None] + i_gate[:, t][..., None, None] * \
            torch.einsum("bhd,bhv->bhdv", k[:, t], v[:, t])
        n = n * f[..., None] + i_gate[:, t][..., None] * k[:, t]
        qs = q[:, t] / math.sqrt(dk)
        num = torch.einsum("bhd,bhdv->bhv", qs, c)
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qs, n).abs(), min=1.0)
        outs.append(num / den[..., None])
    _close(y, torch.stack(outs, dim=1).numpy(), **RECURRENCE)


@pytest.mark.parametrize("s,chunk,with_c0", [(16, 4, False), (16, 4, True),
                                             (12, 128, True), (8, 8, False)])
def test_mlstm_chunked_matches_reference(s, chunk, with_c0):
    b, h, dk = 2, 2, 4
    dm = xl.MLSTMDims(d=h * dk, heads=h, dk=dk, dv=dk, chunk=chunk)
    args = _mlstm_inputs(13, b, s, h, dk)
    rng = _rng(14)
    c0 = _normal(rng, (b, h, dk, dk)) if with_c0 else None
    n0 = _normal(rng, (b, h, dk)) if with_c0 else None
    y, (c, n) = xl.mlstm_chunked(*map(_t, args), dm,
                                 *(None if a is None else _t(a)
                                   for a in (c0, n0)))
    jy, (jc, jn) = jxl.mlstm_chunked(*map(jnp.asarray, args),
                                     jxl.MLSTMDims(*dm),
                                     *(None if a is None else jnp.asarray(a)
                                       for a in (c0, n0)))
    _close(y, jy)
    _close(c, jc)
    _close(n, jn)


def test_mlstm_chunked_refuses_a_ragged_length():
    """The reference asserts S % min(chunk, S) == 0 (an xlstm prefill of
    129-255 tokens fails there); the port raises ValueError."""
    dm = xl.MLSTMDims(d=8, heads=2, dk=4, dv=4, chunk=4)
    args = _mlstm_inputs(1, 1, 10, 2, 4)
    with pytest.raises(AssertionError):
        jxl.mlstm_chunked(*map(jnp.asarray, args), jxl.MLSTMDims(*dm))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        xl.mlstm_chunked(*map(_t, args), dm)
    assert xl.mlstm_dims(1024, 4) == (1024, 4, 256, 256, 128)


def _mlstm(seed, d=16, heads=2):
    dm = xl.mlstm_dims(d, heads)
    params = jxl.init_mlstm(jax.random.PRNGKey(seed), jxl.MLSTMDims(*dm))
    p = xl.MLSTM(**{k: bridge.tensor(v) for k, v in
                    jax.tree.map(np.asarray, params).items()})
    return dm, params, p


def test_init_mlstm_and_slstm_match_reference_shapes_and_dtypes():
    dm = xl.mlstm_dims(16, 2)
    gen = torch.Generator().manual_seed(0)
    for want, got in (
            (jxl.init_mlstm(jax.random.PRNGKey(0), jxl.MLSTMDims(*dm),
                            jnp.bfloat16),
             xl.init_mlstm(dm, generator=gen, dtype=torch.bfloat16)),
            (jxl.init_slstm(jax.random.PRNGKey(0), 16, jnp.bfloat16),
             xl.init_slstm(16, generator=gen, dtype=torch.bfloat16))):
        names = dict(got.named_parameters())
        assert set(names) == set(want)
        for k, v in want.items():
            assert tuple(names[k].shape) == v.shape, k
            assert str(names[k].dtype).endswith(str(v.dtype)), k
        for k in ("b_gates", "skip", "bias"):
            if k in want:
                np.testing.assert_array_equal(names[k].numpy(),
                                              np.asarray(want[k]))


def test_mlstm_forward_and_decode_match_reference():
    dm, params, p = _mlstm(21)
    rng = _rng(22)
    x = _normal(rng, (2, 8, dm.d))
    out, st = xl.mlstm_forward(p, _t(x), dm)
    jout, jst = jxl.mlstm_forward(params, jnp.asarray(x), jxl.MLSTMDims(*dm))
    _close(out, jout)
    for i in range(3):
        _close(st["c"], jst["c"])
        _close(st["n"], jst["n"])
        xt = _normal(rng, (2, 1, dm.d))
        out, st = xl.mlstm_forward(p, _t(xt), dm, st)
        jout, jst = jxl.mlstm_forward(params, jnp.asarray(xt),
                                      jxl.MLSTMDims(*dm), jst)
        _close(out, jout)


def test_mlstm_gradients_match_reference():
    dm, params, p = _mlstm(23)
    x = _normal(_rng(24), (2, 8, dm.d))
    _grads_match(lambda: xl.mlstm_forward(p, _t(x), dm)[0],
                 lambda prm: jxl.mlstm_forward(prm, jnp.asarray(x),
                                               jxl.MLSTMDims(*dm))[0],
                 params, p)


def _slstm(seed, d=16):
    params = jxl.init_slstm(jax.random.PRNGKey(seed), d)
    p = xl.SLSTM(**{k: bridge.tensor(v) for k, v in
                    jax.tree.map(np.asarray, params).items()})
    return params, p


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_forward_matches_reference(with_state):
    params, p = _slstm(31)
    rng = _rng(32)
    x = _normal(rng, (2, 9, 16))
    state = None
    if with_state:
        state = {k: _normal(rng, (2, 16)) for k in ("c", "m", "h")}
        state["n"] = np.abs(_normal(rng, (2, 16))) + 1.0
    y, st = xl.slstm_forward(p, _t(x), None if state is None else
                             {k: _t(v) for k, v in state.items()})
    jy, jst = jxl.slstm_forward(params, jnp.asarray(x), None if state is None
                                else {k: jnp.asarray(v)
                                      for k, v in state.items()})
    _close(y, jy)
    assert set(st) == set(jst) == {"c", "n", "m", "h"}
    for k in st:
        _close(st[k], jst[k])


def test_slstm_in_a_bf16_model_runs_in_f32():
    """w_in is bf16 in a bf16 model; the sLSTM widens it, as the
    reference's einsum of an f32 x promotes it, and keeps its state f32."""
    params = jxl.init_slstm(jax.random.PRNGKey(33), 16, jnp.bfloat16)
    p = xl.SLSTM(**{k: bridge.tensor(v) for k, v in
                    jax.tree.map(np.asarray, params).items()})
    x = _normal(_rng(34), (2, 5, 16))
    y, st = xl.slstm_forward(p, _t(x).to(torch.bfloat16))
    jy, jst = jxl.slstm_forward(params, jnp.asarray(x, jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and st["c"].dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    for k in st:
        _close(st[k], jst[k], rtol=1e-4, atol=1e-5)


def test_slstm_gradients_match_reference():
    params, p = _slstm(35)
    x = _normal(_rng(36), (2, 6, 16))
    _grads_match(lambda: xl.slstm_forward(p, _t(x))[0],
                 lambda prm: jxl.slstm_forward(prm, jnp.asarray(x))[0],
                 params, p)


def test_long_decays_stay_finite_where_the_reference_overflows():
    """Both chunked scans take exp of every (i, j) decay and mask after
    it: above the diagonal that is exp of the decay summed over up to a
    chunk, inf past 88.7 in f32, and inf * 0 makes the reference's chunk
    NaN (zamba2-7b's deeper blocks reach it at full width).  The port masks
    before the exp: finite, and the step-by-step recurrence's values."""
    b, s, h, p, n = 1, 16, 2, 4, 3
    dm = m2.Mamba2Dims(d=0, d_in=h * p, heads=h, head_dim=p, n=n, chunk=16)
    xh, _, _, bmat, cmat = _ssd_inputs(41, b, s, h, p, n)
    dt = np.full((b, s, h), 8.0, np.float32)          # 15 x 8 = 120 > 88.7
    args = (xh, dt, -dt, bmat, cmat)
    jy, _ = jm2.ssd_chunked(*map(jnp.asarray, args), jm2.Mamba2Dims(*dm))
    assert np.isnan(np.asarray(jy)).any()
    y, hf = m2.ssd_chunked(*map(_t, args), dm)
    y_ref, hf_ref = _naive_ssd(*map(_t, args))
    _close(y, y_ref.numpy(), **RECURRENCE)
    _close(hf, hf_ref.numpy(), **RECURRENCE)

    dmm = xl.MLSTMDims(d=8, heads=2, dk=4, dv=4, chunk=16)
    q, k, v, _, i_gate = _mlstm_inputs(42, 1, 16, 2, 4)
    log_f = np.full((1, 16, 2), -8.0, np.float32)
    args = (q, k, v, log_f, i_gate)
    jy, _ = jxl.mlstm_chunked(*map(jnp.asarray, args), jxl.MLSTMDims(*dmm))
    assert np.isnan(np.asarray(jy)).any()
    y, _ = xl.mlstm_chunked(*map(_t, args), dmm)
    assert bool(torch.isfinite(y).all())
    # the step-by-step recurrence
    qt, kt, vt, ft, it = map(_t, args)
    c, nn_, outs = torch.zeros((1, 2, 4, 4)), torch.ones((1, 2, 4)), []
    for t in range(16):
        f = torch.exp(ft[:, t])
        c = c * f[..., None, None] + it[:, t][..., None, None] * \
            torch.einsum("bhd,bhv->bhdv", kt[:, t], vt[:, t])
        nn_ = nn_ * f[..., None] + it[:, t][..., None] * kt[:, t]
        qs = qt[:, t] / 2.0
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qs, nn_).abs(), min=1.0)
        outs.append(torch.einsum("bhd,bhdv->bhv", qs, c) / den[..., None])
    _close(y, torch.stack(outs, dim=1).numpy(), **RECURRENCE)
