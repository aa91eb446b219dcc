"""The port's model (`repro_torch.models.api`) against `repro.models.api` on
the same parameters, carried over with `repro_torch.bridge`, on the CPU at
smoke width: prompt prefill into a 1-lane dense cache, the splice into the
paged pool, then six per-lane paged decode steps.

Three FFN variants: DSG off, DSG mask mode (per-row top-k DRS selection in
both prefill and decode), and the serving CSR path (per-lane group-CSR
patterns in decode, with the DRS scores collected at every step).  The
reference runs its Pallas kernels in interpret mode; the port runs its
kernels' plain versions, as it does for CPU tensors.

Tolerances (f32): logits agree to atol 1e-4; DRS scores, which are sums of
relu'd products reaching the tens, to rtol 1e-5 / atol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import smoke_cfg  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402

MAX_SEQ, PAGE = 64, 8
PROMPTS = (13, 21)           # two lanes at different depths
STEPS = 6
LOGITS = dict(rtol=0, atol=1e-4)
SCORES = dict(rtol=1e-5, atol=1e-4)


def _parts(variant):
    cfg = smoke_cfg(threshold_mode="topk").replace(
        paged_attn_kernel="kernel", dsg_ffn_apply="kernel")
    if variant == "dense":
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    key = jax.random.PRNGKey(0)
    params = japi.init_model(key, cfg)
    dsg = japi.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    tcfg = bridge.config_from_jax(cfg).replace(paged_attn_kernel="auto",
                                               dsg_ffn_apply="auto")
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(
        None if dsg is None else jax.tree.map(np.asarray, dsg), device="cpu")
    return cfg, params, dsg, tcfg, model, tdsg


def _csr_pattern(rng, n_layers, n_lanes, n_groups):
    """Random ascending per-lane group lists with garbage padding."""
    idx = rng.integers(0, n_groups, (n_layers, n_lanes, n_groups))
    counts = rng.integers(1, n_groups + 1, (n_layers, n_lanes))
    for l in range(n_layers):
        for b in range(n_lanes):
            c = counts[l, b]
            idx[l, b, :c] = np.sort(rng.choice(n_groups, c, replace=False))
    return idx.astype(np.int32), counts.astype(np.int32)


@pytest.mark.parametrize("variant", ["dense", "mask", "csr"])
def test_prefill_and_paged_decode_match_reference(variant):
    cfg, params, dsg, tcfg, model, tdsg = _parts(variant)
    rng = np.random.default_rng(11)
    collect = variant == "csr"
    jb = jkv.PagedBackend(page_size=PAGE)
    tb = kv_cache.PagedBackend(page_size=PAGE)
    jh = jb.make(cfg, len(PROMPTS), MAX_SEQ)
    th = tb.make(tcfg, len(PROMPTS), MAX_SEQ, "cpu")
    first = []
    for lane, plen in enumerate(PROMPTS):
        toks = rng.integers(0, cfg.vocab, (1, plen)).astype(np.int32)
        jout = japi.prefill(params, dsg, cfg, {"tokens": jnp.asarray(toks)},
                            japi.make_cache(cfg, 1, MAX_SEQ),
                            collect_drs_scores=collect)
        tout = api.prefill(model, tdsg, tcfg,
                           {"tokens": torch.from_numpy(toks).long()},
                           api.make_cache(tcfg, 1, MAX_SEQ, device="cpu"),
                           collect_drs_scores=collect)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   **LOGITS)
        if collect:
            np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                       **SCORES)
        jh = jb.write(jh, jout[1], lane, n_tokens=plen,
                      reserve_tokens=plen + STEPS)
        th = tb.write(th, tout[1], lane, n_tokens=plen,
                      reserve_tokens=plen + STEPS)
        first.append(int(np.argmax(np.asarray(jout[0])[0])))

    csr = None
    if variant == "csr":
        g = cfg.d_ff // cfg.dsg.block
        idx, counts = _csr_pattern(rng, cfg.n_layers, len(PROMPTS), g)
        csr = ({"idx": jnp.asarray(idx), "counts": jnp.asarray(counts)},
               {"idx": torch.from_numpy(idx), "counts": torch.from_numpy(counts)})
    tok = np.asarray(first, np.int32)
    pos = np.asarray(PROMPTS, np.int32)
    for step in range(STEPS):
        for lane in range(len(PROMPTS)):
            jh = jb.ensure(jh, lane, int(pos[lane]))
            th = tb.ensure(th, lane, int(pos[lane]))
        live = 4 if step % 2 else None       # bounded and full walks
        jout = japi.decode_step(
            params, dsg, cfg, jnp.asarray(tok[:, None]), jh.data,
            jnp.asarray(pos), live_pages=live,
            ffn_csr=None if csr is None else csr[0],
            collect_drs_scores=collect)
        tout = api.decode_step(
            model, tdsg, tcfg, torch.from_numpy(tok[:, None]).long(),
            th.data, torch.from_numpy(pos), live_pages=live,
            ffn_csr=None if csr is None else csr[1],
            collect_drs_scores=collect)
        np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                                   err_msg=f"step {step}", **LOGITS)
        if collect:
            np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]),
                                       err_msg=f"step {step}", **SCORES)
        jh = jkv.CacheHandle({**jh.data, "pages_k": jout[1]["pages_k"],
                              "pages_v": jout[1]["pages_v"]}, "paged", PAGE)
        for leaf in ("pages_k", "pages_v"):
            np.testing.assert_allclose(th.data[leaf].numpy(),
                                       np.asarray(jh.data[leaf]), atol=1e-5)
        tok = np.argmax(np.asarray(jout[0]), axis=-1).astype(np.int32)
        pos = pos + 1


def test_bridge_unstacks_every_layer_leaf():
    cfg, params, _, tcfg, model, _ = _parts("dense")
    assert len(model.layers) == cfg.n_layers
    for l, blk in enumerate(model.layers):
        np.testing.assert_array_equal(
            blk.attn.wq.numpy(), np.asarray(params["layers"]["attn"]["wq"][l]))
        np.testing.assert_array_equal(
            blk.ffn.w_down.numpy(),
            np.asarray(params["layers"]["ffn"]["w_down"][l]))
    assert tuple(model.layers[0].attn.wq.shape) == (
        cfg.d_model, cfg.n_heads, cfg.head_dim)
    assert tuple(model.layers[0].ffn.w_gate.shape) == (cfg.d_model, cfg.d_ff)
