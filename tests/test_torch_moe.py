"""The port's MoE layer (`repro_torch.models.moe`) against `repro.models.moe`
on the same parameters and inputs (seeded numpy, f32, on the CPU).

Cases: ample capacity; capacity 1 with drops (the same (token, k) pairs
dropped); both auxiliary losses; DSG's per-expert masks in the "topk" and
"shared" threshold modes, also when expert 0 receives no token (its first
slot is then a zero row, whose scores set the shared threshold); shared
experts with their own f(W); a router tie (the lower expert index wins, as
`lax.top_k` breaks it); and the reference's own dispatch properties
(`tests/test_models_units.py`) on the port.

Tolerances (f32): outputs rtol 1e-5 / atol 1e-6 (measured: under 1e-6;
the expert products sum d or F_e terms in another order than XLA's), aux
losses rtol 1e-6.  The routing, the slots and the dropped pairs must be
equal exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import projection as jproj  # noqa: E402
from repro.core.dsg_linear import DSGConfig as JDSG  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import tensor  # noqa: E402
from repro_torch.core.dsg_linear import DSGConfig, SwiGLU  # noqa: E402
from repro_torch.models import moe  # noqa: E402

D, E, FE = 64, 4, 128
OUT = dict(rtol=1e-5, atol=1e-6)


def _ref_moe(seed, n_shared=0, e=E, d=D, fe=FE):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), d, e, fe, n_shared)
    return jax.tree.map(np.array, p)          # writable copies


def _port_moe(p) -> moe.MoE:
    shared = None
    if "shared" in p:
        shared = SwiGLU(*(tensor(p["shared"][n])
                          for n in ("w_gate", "w_up", "w_down")))
    return moe.MoE(tensor(p["router"]), tensor(p["w_gate"]),
                   tensor(p["w_up"]), tensor(p["w_down"]), shared)


def _dsg_state(p, k=64, seed=7):
    """A reference DSG state for one MoE layer and its port copy."""
    d = p["w_gate"].shape[1]
    r = jproj.make_projection(jax.random.PRNGKey(seed), k, d)
    st = {"r": r, "fw_experts": jnp.einsum("kd,edf->ekf", r, p["w_gate"])}
    if "shared" in p:
        st["shared"] = {"r": r, "fw": r @ p["shared"]["w_gate"]}
    port = jax.tree.map(lambda a: tensor(np.asarray(a)), st)
    return st, port


def _both(p, x, *, top_k=2, capacity_factor=1.25, dsg=None, state=None,
          aux_kind="topk"):
    dsg = dsg or JDSG()
    jst, tst = state if state is not None else (None, None)
    yj, aj = jmoe.moe_ffn(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          n_experts=p["w_gate"].shape[0], top_k=top_k,
                          capacity_factor=capacity_factor, dsg=dsg,
                          dsg_state=jst, aux_kind=aux_kind)
    yt, at = moe.moe_ffn(_port_moe(p), torch.from_numpy(x),
                         n_experts=p["w_gate"].shape[0], top_k=top_k,
                         capacity_factor=capacity_factor,
                         dsg=DSGConfig(*dsg), dsg_state=tst,
                         aux_kind=aux_kind)
    return (np.asarray(yj), float(aj)), (yt.numpy(), float(at))


def _x(seed, t=16, d=D):
    return np.random.default_rng(seed).standard_normal(
        (1, t, d)).astype(np.float32)


def _ref_slots(p, x, top_k, cap):
    """The reference's routing and slot assignment, its own lines
    (`repro/models/moe.py:59-77`) run here: (top_e, in_cap)."""
    e = p["w_gate"].shape[0]
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) @ p["router"]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, top_k)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return np.asarray(top_e), np.asarray(pos < cap)


def test_ample_capacity_matches_reference():
    p = _ref_moe(0)
    (yj, aj), (yt, at) = _both(p, _x(1), capacity_factor=8.0)
    np.testing.assert_allclose(yt, yj, **OUT)
    np.testing.assert_allclose(at, aj, rtol=1e-6)


@pytest.mark.parametrize("top_k,factor", [(2, 0.125), (1, 0.125), (2, 0.5)])
def test_drops_past_capacity_match_reference(top_k, factor):
    """Capacity max(1, int(factor * 16 * top_k / 4)): 1, 1 and 4 slots an
    expert, so pairs are dropped; the port drops the same pairs, and a
    token whose every pair is dropped comes out exactly zero in both."""
    p = _ref_moe(2)
    x = _x(3)
    cap = moe.capacity(16, E, top_k, factor)
    assert cap == max(1, int(factor * 16 * top_k / E))
    want_e, want_in = _ref_slots(p, x, top_k, cap)
    logits = torch.from_numpy(x.reshape(-1, D)) @ tensor(p["router"])
    _, top_e = moe.router_topk(torch.softmax(logits, -1), top_k)
    _, _, in_cap = moe.dispatch(top_e, E, cap)
    np.testing.assert_array_equal(top_e.numpy(), want_e)
    np.testing.assert_array_equal(in_cap.numpy(), want_in)
    assert not want_in.all()
    (yj, _), (yt, _) = _both(p, x, top_k=top_k, capacity_factor=factor)
    np.testing.assert_allclose(yt, yj, **OUT)
    dropped = ~want_in.reshape(16, top_k).any(axis=1)
    assert (yt[0][dropped] == 0).all() and (yj[0][dropped] == 0).all()


@pytest.mark.parametrize("aux_kind", ["topk", "probs"])
def test_aux_losses_match_reference(aux_kind):
    p = _ref_moe(4)
    (yj, aj), (yt, at) = _both(p, _x(5, t=24), aux_kind=aux_kind)
    np.testing.assert_allclose(at, aj, rtol=1e-6)
    np.testing.assert_allclose(yt, yj, **OUT)


@pytest.mark.parametrize("mode", ["topk", "shared"])
@pytest.mark.parametrize("n_shared", [0, 1])
def test_per_expert_dsg_masks_match_reference(mode, n_shared):
    p = _ref_moe(6, n_shared=n_shared)
    dsg = JDSG(enabled=True, gamma=0.5, block=32, threshold_mode=mode)
    (yj, _), (yt, _) = _both(p, _x(7), dsg=dsg, state=_dsg_state(p))
    np.testing.assert_allclose(yt, yj, **OUT)
    # the masks act: DSG off gives another output
    (y_off, _), _ = _both(p, _x(7))
    assert np.abs(y_off - yj).max() > 1e-3


@pytest.mark.parametrize("mode", ["topk", "shared"])
def test_expert0_empty_first_slot_sets_the_shared_threshold(mode):
    """Positive inputs and a router column 0 of -1s: expert 0 receives no
    token, so its first slot is the zero row, whose scores are all 0; in
    "shared" mode that row's threshold (0) keeps every group of every
    slot, in the port as in the reference."""
    p = _ref_moe(8, n_shared=1)
    p["router"][:, 0] = -1.0
    x = np.abs(_x(9))
    top_e, _ = _ref_slots(p, x, 2, moe.capacity(16, E, 2, 1.25))
    assert not (top_e == 0).any()
    dsg = JDSG(enabled=True, gamma=0.5, block=32, threshold_mode=mode)
    state = _dsg_state(p)
    (yj, _), (yt, _) = _both(p, x, dsg=dsg, state=state)
    np.testing.assert_allclose(yt, yj, **OUT)
    if mode == "shared":
        # every group kept: the routed part equals DSG off's (the shared
        # expert, thresholded on its own row 0, still masks)
        no_sh = {k: v for k, v in p.items() if k != "shared"}
        st_ns = ({"r": state[0]["r"], "fw_experts": state[0]["fw_experts"]},
                 {"r": state[1]["r"], "fw_experts": state[1]["fw_experts"]})
        (y_on, _), _ = _both(no_sh, x, dsg=dsg, state=st_ns)
        (y_off, _), _ = _both(no_sh, x)
        np.testing.assert_array_equal(y_on, y_off)


def test_router_tie_goes_to_the_lower_expert():
    """Router columns 1 and 2 equal and largest for positive inputs: every
    token's top-1 is a tie, which `lax.top_k` gives to expert 1."""
    p = _ref_moe(10)
    p["router"][:] = -1.0
    p["router"][:, 1] = p["router"][:, 2] = 1.0
    x = np.abs(_x(11))
    top_e, _ = _ref_slots(p, x, 1, 16)
    assert (top_e[:, 0] == 1).all()
    logits = torch.from_numpy(x.reshape(-1, D)) @ tensor(p["router"])
    vals, idx = moe.router_topk(torch.softmax(logits, -1), 2)
    assert (idx[:, 0] == 1).all() and (idx[:, 1] == 2).all()
    assert torch.equal(vals[:, 0], vals[:, 1])
    (yj, aj), (yt, at) = _both(p, x, top_k=1, capacity_factor=4.0)
    np.testing.assert_allclose(yt, yj, **OUT)
    np.testing.assert_allclose(at, aj, rtol=1e-6)


def test_mesh_is_refused_naming_the_roadmap():
    """A mesh is no longer refused: expert parallelism is ported (ROADMAP
    item 9b; held on gloo ranks by tests/test_torch_sharded_model.py).
    As the reference's gate has it, a mesh whose 'model' axis is 1 runs
    every expert locally: the same result as no mesh."""
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    p = _port_moe(_ref_moe(0))
    x = torch.from_numpy(_x(1, t=4))
    kw = dict(n_experts=E, top_k=2, capacity_factor=1.25, dsg=DSGConfig())
    want, _ = moe.moe_ffn(p, x, **kw)
    with fake_world(1):
        got, _ = moe.moe_ffn(p, x, mesh=make_local_mesh(device_type="cpu"),
                             batch_axes=("data",), **kw)
    assert torch.equal(got, want)


def test_combine_adds_in_ascending_expert_order():
    """A token's contributions are summed from 0.0 in f32 in ascending
    expert order, whatever the order of its top-k: bitwise the sequential
    sum of the expert outputs the same (E, C, d) products give."""
    p = _ref_moe(12)
    tm = _port_moe(p)
    x2d = torch.from_numpy(_x(13, t=8).reshape(-1, D))
    logits = x2d @ tm.router
    cap = 16
    y = moe.routed_body(x2d, logits, tm, E, 2, cap, None, None, DSGConfig())
    w, e = moe.router_topk(torch.softmax(logits, -1), 2)
    w = w / w.sum(-1, keepdim=True)
    slot_e, slot_p, in_cap = moe.dispatch(e, E, cap)
    assert in_cap.all()
    idx = torch.full((E, cap), 8, dtype=torch.int64)
    idx[slot_e, slot_p] = torch.arange(16) // 2
    xg = torch.cat([x2d, torch.zeros(1, D)])[idx]
    ye = torch.bmm(torch.nn.functional.silu(torch.bmm(xg, tm.w_gate))
                   * torch.bmm(xg, tm.w_up), tm.w_down)
    assert (e[:, 0] > e[:, 1]).any()          # some top-k lists descend
    for t in range(8):
        acc = torch.zeros(D)
        for k in sorted(range(2), key=lambda k: int(e[t, k])):
            j = 2 * t + k
            acc = acc + ye[slot_e[j], slot_p[j]] * w[t, k]
        assert torch.equal(y[t], acc), t


# -- the reference's dispatch properties (tests/test_models_units.py) -----

@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), topk=st.integers(1, 3))
def test_moe_dispatch_conservation(seed, topk):
    """With ample capacity, every token's output is a convex combination
    of its top-k experts' outputs (weights summing to 1)."""
    d, e, fe, t = 8, 4, 16, 12
    p = _ref_moe(seed % 1000, e=e, d=d, fe=fe)
    tm = _port_moe(p)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (1, t, d)).astype(np.float32))
    y, aux = moe.moe_ffn(tm, x, n_experts=e, top_k=topk,
                         capacity_factor=8.0, dsg=DSGConfig(),
                         aux_kind="probs")
    x2d = x.reshape(-1, d)
    tw, te = moe.router_topk(torch.softmax(x2d @ tm.router, -1), topk)
    tw = tw / tw.sum(-1, keepdim=True)
    want = torch.zeros_like(x2d)
    for kk in range(topk):
        for ei in range(e):
            sel = (te[:, kk] == ei)[:, None]
            g = (torch.nn.functional.silu(x2d @ tm.w_gate[ei])
                 * (x2d @ tm.w_up[ei]))
            want = want + torch.where(sel, (g @ tm.w_down[ei])
                                      * tw[:, kk:kk + 1], 0.0)
    torch.testing.assert_close(y.reshape(-1, d), want, rtol=5e-4,
                               atol=5e-4)
    assert torch.isfinite(aux)


def test_moe_capacity_drops_tokens():
    """With capacity 1, overflow tokens are dropped (zero output), not
    corrupted."""
    d, e, fe, t = 8, 2, 16, 16
    tm = _port_moe(_ref_moe(9, e=e, d=d, fe=fe))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, t, d)).astype(np.float32))
    y, _ = moe.moe_ffn(tm, x, n_experts=e, top_k=1, capacity_factor=0.125,
                       dsg=DSGConfig(), aux_kind="probs")
    norms = torch.linalg.norm(y.reshape(-1, d), dim=-1)
    assert int((norms == 0.0).sum()) >= t - 2 * max(1, int(0.125 * t / e))
