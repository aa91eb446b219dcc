"""Training of the encoder-decoder family (whisper-large-v3) in the port
against `repro` on the same bridged parameters, on the CPU at smoke width
(2 + 2 layers, d 64): `api.train_loss` and every gradient leaf against
`jax.value_and_grad` of the reference's, with DSG off, mask/shared (the
config), mask/topk and gather_shared, remat on and off; the
`tests/test_archs_smoke.py` training cases as parity tests; 4 AdamW steps
through `launch.train.trainer_for`; the trainer state's bridges.  The
reference has no whisper trainer (its CLI crashes on the arch, ROADMAP.md
§3): its losses come from value_and_grad and `optim.adamw.apply_updates`.

Tolerances, as `tests/test_torch_archs.py`'s: losses rtol 1e-5; each
gradient leaf within 1e-5 · max(1, max|g|).  The f32 4-step run is held
within MAX_ULPS f32 ulps of the reference's losses (measured: 2), as the
recurrent families' run is; bf16 with f32 masters to a tolerance measured
from the reference's own bf16 error (ROADMAP.md §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import SMOKE_SHAPE as JSMOKE  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_encdec import _cfg, _leaves, _np, _port, _t  # noqa: E402

MODES = ("off", "mask_shared", "mask_topk", "gather_shared")
MAX_ULPS = 4


@pytest.fixture(scope="module")
def built():
    """Per DSG mode: the reference's smoke (cfg, params, dsg), made as
    `tests/test_archs_smoke.py` makes them."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cfg = _cfg(mode)
            params = japi.init_model(jax.random.PRNGKey(0), cfg)
            cache[mode] = (cfg, params, japi.init_dsg(jax.random.PRNGKey(1),
                                                      params, cfg))
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def reference_grads(built):
    """Per (DSG mode, remat): the reference's loss and gradients on the
    smoke batch."""
    cache = {}

    def get(mode, remat):
        if (mode, remat) not in cache:
            cfg, params, dsg = built(mode)
            cfg = cfg.replace(remat=remat)
            batch = japi.make_inputs(cfg, JSMOKE, concrete=True)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: japi.train_loss(p, dsg, cfg, batch)))(params)
            cache[(mode, remat)] = (cfg, batch, float(loss), _np(grads))
        return cache[(mode, remat)]

    return get


def _port_grads(cfg, params, dsg, batch):
    tcfg, model, tdsg = _port(cfg, params, dsg, trainable=True)
    named = dict(model.named_parameters())
    tloss = api.train_loss(model, tdsg, tcfg, _t(batch))
    grads = torch.autograd.grad(tloss, list(named.values()))
    return tloss, dict(zip(named, grads))


@pytest.mark.parametrize("mode,remat", [(m, True) for m in MODES]
                         + [("mask_shared", False)])
def test_train_loss_and_every_gradient_match_reference(
        mode, remat, built, reference_grads):
    _, params, dsg = built(mode)
    cfg, batch, loss, grads = reference_grads(mode, remat)
    want = _leaves(grads)
    dl.gelu_ffn.calls.update(dict.fromkeys(dl.FFN_MODES, 0))
    tloss, tgrads = _port_grads(cfg, params, dsg, batch)
    got = _leaves(bridge.to_reference_tree(tgrads))
    # each layer's FFN ran once in the forward, and again under remat
    took = "dense" if mode == "off" else cfg.dsg.mode
    assert dl.gelu_ffn.calls[took] == (cfg.n_layers + cfg.enc_layers) * (
        2 if remat else 1)
    np.testing.assert_allclose(tloss.item(), loss, rtol=1e-5)
    assert set(got) == set(want)
    for path, g in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[path].numpy(), g, rtol=0, atol=tol,
                                   err_msg=path)
    assert float(np.sum([np.sum(np.square(g)) for g in want.values()])) > 0


def test_remat_changes_no_gradient(built, reference_grads):
    """The same loss and gradients with each layer recomputed in the
    backward as without (the masks are recomputed from the same input)."""
    cfg, params, dsg = built("mask_shared")
    _, batch, _, _ = reference_grads("mask_shared", True)
    on = _port_grads(cfg.replace(remat=True), params, dsg, batch)
    off = _port_grads(cfg.replace(remat=False), params, dsg, batch)
    assert on[0].item() == off[0].item()
    for n, g in on[1].items():
        np.testing.assert_allclose(g.numpy(), off[1][n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


# -- the training cases of tests/test_archs_smoke.py, as parity tests -------

def test_smoke_train_step_matches_reference(built, reference_grads):
    """test_train_step_finite: the loss and the gradients' squared norm."""
    _, params, dsg = built("mask_shared")
    cfg, batch, loss, grads = reference_grads("mask_shared", True)
    gnorm = sum(float(np.sum(np.square(g)))
                for g in _leaves(grads).values())
    tloss, tgrads = _port_grads(cfg, params, dsg, batch)
    tnorm = sum(float(torch.sum(g * g)) for g in tgrads.values())
    assert np.isfinite(tloss.item()) and np.isfinite(tnorm) and tnorm > 0
    np.testing.assert_allclose(tloss.item(), loss, rtol=1e-5)
    np.testing.assert_allclose(tnorm, gnorm, rtol=1e-4)


def test_smoke_dsg_off_matches_reference(built):
    """test_dsg_off_still_works: a fresh model with DSG off."""
    cfg, _, _ = built("mask_shared")
    cfg_off = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    params = japi.init_model(jax.random.PRNGKey(0), cfg_off)
    assert japi.init_dsg(jax.random.PRNGKey(1), params, cfg_off) is None
    batch = japi.make_inputs(cfg_off, JSMOKE, concrete=True)
    tcfg, model, _ = _port(cfg_off, params, None)
    want = jax.jit(japi.train_loss, static_argnums=(2,))(params, None,
                                                         cfg_off, batch)
    np.testing.assert_allclose(
        api.train_loss(model, None, tcfg, _t(batch)).item(), float(want),
        rtol=1e-5)


# ---------------------------------------------------------------------------
# training with AdamW
# ---------------------------------------------------------------------------

# bf16 weights with f32 masters: the reference's own bf16 error against
# its f32 run of the same 4 steps (cast weights), measured at seed 0:
# E = 0.0642 (step 4; 0.021, 0.043, 0.0093 before), the port's largest gap
# 0.0299 (seed 1: E 0.048, gap 0.027).  atol in [2E, 3E].
BF16_LOSS_ATOL = 0.13


def _reference_run(cfg, params, dsg, batch, acfg, use_master):
    opt = jadamw.init_opt(params, use_master)

    @jax.jit
    def step(p, o):
        loss, g = jax.value_and_grad(
            lambda q: japi.train_loss(q, dsg, cfg, batch))(p)
        p, o, _ = jadamw.apply_updates(p, g, o, acfg)
        return p, o, loss

    losses = []
    for _ in range(4):
        params, opt, loss = step(params, opt)
        losses.append(float(loss))
    return losses, params, opt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_four_step_adamw_run_follows_the_reference(dtype):
    """4 AdamW steps on one make_inputs batch from bridged weights: the
    port's `trainer_for` (f32 masters for bf16, as the reference keeps
    them) against the reference's value_and_grad and apply_updates."""
    cfg = _cfg("mask_shared").replace(dtype=dtype)
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    dsg = japi.init_dsg(jax.random.PRNGKey(1), params, cfg)
    batch = japi.make_inputs(cfg, JSMOKE, concrete=True)
    acfg = jadamw.AdamWConfig(warmup=2, total_steps=4)
    bf16 = dtype == "bfloat16"
    want, wparams, wopt = _reference_run(cfg, params, dsg, batch, acfg, bf16)
    tcfg, model, tdsg = _port(cfg, params, dsg)
    state, step_fn, _ = train.trainer_for(
        model, tdsg, tcfg, adamw.AdamWConfig(warmup=2, total_steps=4))
    assert ("master" in state["opt"]) == bf16
    tb = _t(batch)
    got = []
    for _ in range(4):
        state, metrics = step_fn(state, tb)
        got.append(float(metrics["loss"]))
    assert got[-1] < got[0]
    if not bf16:
        ulps = [abs(g - w) / np.spacing(np.float32(w))
                for g, w in zip(got, want)]
        assert max(ulps) <= MAX_ULPS, (got, want, ulps)
        # the whole trainer state lays out as the reference's tree
        tree = bridge.state_to_numpy(model, tdsg, state["opt"])
        assert set(_leaves(tree["opt"])) == set(_leaves(_np(
            {"step": wopt["step"], "m": wopt["m"], "v": wopt["v"]})))
        for path, w in _leaves(_np(wparams)).items():
            np.testing.assert_allclose(_leaves(tree["params"])[path], w,
                                       rtol=0, atol=1e-5, err_msg=path)
        return
    c32 = cfg.replace(dtype="float32")
    ref32, _, _ = _reference_run(
        c32, jax.tree.map(lambda a: a.astype(jnp.float32), params),
        jax.tree.map(lambda a: a.astype(jnp.float32), dsg),
        dict(batch, frames=batch["frames"].astype(jnp.float32)), acfg,
        False)
    e = max(abs(a - b) for a, b in zip(want, ref32))
    assert 2 * e <= BF16_LOSS_ATOL <= 3 * e, e
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_LOSS_ATOL)


def test_trainer_state_bridges_both_ways(built):
    """bridge.opt_from_jax carries the reference's AdamW state (with
    masters) into the port, and state_tree / load_state_tree lay the
    encoder-decoder's state out as the reference's tree and back."""
    cfg, params, dsg = built("mask_shared")
    opt = jadamw.init_opt(params, use_master=True)
    rng = np.random.default_rng(5)
    opt = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
        a.dtype) if a.ndim else a, opt)
    tcfg, model, tdsg = _port(cfg, params, dsg)
    topt = bridge.opt_from_jax(_np(opt), model, device="cpu")
    tree = bridge.state_to_numpy(model, tdsg, topt)
    for part in ("m", "v", "master"):
        for path, w in _leaves(_np(opt[part])).items():
            np.testing.assert_array_equal(_leaves(tree["opt"][part])[path],
                                          w, err_msg=f"{part}/{path}")
    for path, w in _leaves(_np(dsg)).items():
        np.testing.assert_array_equal(tree["dsg"][path], w)
    # load the tree into a fresh port state
    gen = torch.Generator().manual_seed(3)
    fresh = api.init_model(tcfg, generator=gen, device="cpu")
    fdsg = api.init_dsg(fresh, tcfg, generator=gen, device="cpu")
    fopt = adamw.init_opt(dict(fresh.named_parameters()), True)
    bridge.load_state_tree(bridge.state_tree(model, tdsg, topt), fresh,
                           fdsg, fopt)
    again = bridge.state_to_numpy(fresh, fdsg, fopt)
    for path, w in _leaves(tree).items():
        np.testing.assert_array_equal(_leaves(again)[path], w, err_msg=path)
