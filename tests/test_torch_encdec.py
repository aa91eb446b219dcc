"""The encoder-decoder family (whisper-large-v3) of the port against
`repro` on the same parameters, carried over with `repro_torch.bridge`, on
the CPU at smoke width (2 + 2 layers, d 64, f32): the units it adds
(`layer_norm`, the GELU FFN, cross-attention, the bidirectional encoder
attention), the serving `api` verbs with DSG off, mask/shared (the
config), mask/topk and gather_shared, bf16, and the refusals
(`tests/test_torch_encdec_train.py` holds training).  The reference runs
whisper only through its `api` verbs on `make_inputs`' frames (its CLIs
crash on it, ROADMAP.md §3), so parity is held there.

Tolerances (f32), as `tests/test_torch_archs.py`'s: logits atol 1e-4;
f(W) atol 1e-5; the FFN and attention units atol 1e-5.  bf16 is held to
tolerances measured from the reference's own bf16 error (the bf16 test).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core import dsg_linear as jdl  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.configs.base import SMOKE_SHAPE, ShapeConfig  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import api, attention, encdec, layers  # noqa: E402
from repro_torch.serving.scheduler import ServingEngine  # noqa: E402

ARCH = "whisper-large-v3"
LOGITS = dict(rtol=0, atol=1e-4)
UNIT = dict(rtol=0, atol=1e-5)
# DSG modes: off, the config's (mask, shared threshold), mask with the
# per-row top-k threshold, and the batch-shared gather
MODES = ("off", "mask_shared", "mask_topk", "gather_shared")
PREFILL = JShape("p", 16, 2, "prefill")     # 16 frames, 4 prompt tokens
MAX_SEQ = 64                                # 16 decoder slots
STEPS = 8

jprefill = jax.jit(japi.prefill, static_argnums=(2,))
jdecode = jax.jit(japi.decode_step, static_argnums=(2,))


def _cfg(mode: str):
    """whisper-large-v3's reference smoke config with DSG "off", as the
    config sets it ("mask_shared"), "mask_topk" (the per-row top-k
    threshold) or "gather_shared"."""
    cfg = jconfigs.get_smoke_config(ARCH)
    if mode == "off":
        return cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    if mode == "mask_topk":
        return cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    if mode == "gather_shared":
        return cfg.replace(dsg=cfg.dsg._replace(mode="gather_shared"))
    assert mode == "mask_shared", mode
    return cfg


def _np(tree):
    """A reference pytree with numpy leaves (None stays None)."""
    return None if tree is None else jax.tree.map(np.asarray, tree)


def _port(cfg, params, dsg, trainable=False):
    """The port's (cfg, model, dsg) on the CPU from the reference's."""
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(_np(params), tcfg, device="cpu",
                                  trainable=trainable)
    return tcfg, model, bridge.dsg_from_jax(_np(dsg), device="cpu")


def _t(batch: dict) -> dict:
    """The reference's batch as port tensors (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = bridge.tensor(a.astype(np.int64) if a.dtype == np.int32
                               else a)
    return out


def _leaves(tree, prefix="") -> dict:
    """A nested dict's leaves by their '/'-joined paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _close(got, want, tol=LOGITS, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), err_msg=msg,
                               **tol)


@pytest.fixture(scope="module")
def built():
    """Per DSG mode: the reference's smoke (cfg, params, dsg), made as
    `tests/test_archs_smoke.py` makes them, and the port's bridged copy."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cfg = _cfg(mode)
            params = japi.init_model(jax.random.PRNGKey(0), cfg)
            dsg = japi.init_dsg(jax.random.PRNGKey(1), params, cfg)
            cache[mode] = ((cfg, params, dsg), _port(cfg, params, dsg))
        return cache[mode]

    return get


@pytest.fixture(scope="module")
def served(built):
    """Per DSG mode: the reference's prefill on PREFILL's inputs and its
    greedy loop of STEPS decode steps: (inputs, prefill logits, prefill
    state, [(token fed, logits)] per step)."""
    cache = {}

    def get(mode):
        if mode not in cache:
            (cfg, params, dsg), _ = built(mode)
            inputs = japi.make_inputs(cfg, PREFILL, concrete=True)
            logits, state = jprefill(params, dsg, cfg, inputs,
                                     japi.make_cache(cfg, 2, MAX_SEQ))
            first = (np.asarray(logits), _np(state))
            steps = []
            p_len = inputs["tokens"].shape[1]
            for i in range(STEPS):
                tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
                logits, state = jdecode(params, dsg, cfg, tok, state,
                                        jnp.int32(p_len + i))
                steps.append((np.asarray(tok), np.asarray(logits)))
            cache[mode] = (inputs,) + first + (steps,)
        return cache[mode]

    return get


# ---------------------------------------------------------------------------
# config, registry, inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_config_matches_field_for_field(getter):
    ref = getattr(jconfigs, getter)(ARCH)
    port = getattr(configs, getter)(ARCH)
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        if name == "dsg":
            assert tuple(port.dsg) == tuple(ref.dsg)
        else:
            assert getattr(port, name) == getattr(ref, name), name
    assert port.head_dim == ref.head_dim
    assert bridge.config_from_jax(ref) == port


def test_whisper_is_registered_as_in_the_reference():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert "encdec" in api.FAMILIES
    for shape in ("train_4k", "long_500k"):
        assert configs.cell_is_runnable(ARCH, shape) == \
            jconfigs.cell_is_runnable(ARCH, shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_inputs_match_reference(kind):
    cfg, tcfg = jconfigs.get_smoke_config(ARCH), configs.get_smoke_config(
        ARCH)
    want = japi.make_inputs(cfg, JShape("c", 32, 2, kind), concrete=True,
                            seed=5)
    got = api.make_inputs(tcfg, ShapeConfig("c", 32, 2, kind),
                          concrete=True, seed=5, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert str(got[k].dtype).endswith(str(np.asarray(v).dtype))
    spec = japi.make_inputs(cfg, JShape("c", 32, 2, kind))
    meta = api.make_inputs(tcfg, ShapeConfig("c", 32, 2, kind))
    for k, v in spec.items():
        assert meta[k].is_meta and tuple(meta[k].shape) == v.shape


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference_with_the_population_variance(dtype):
    """Rows with a large mean and few features, where the unbiased
    variance (torch.var's default) would differ by d / (d - 1)."""
    rng = np.random.default_rng(0)
    x = (100.0 + 3.0 * rng.standard_normal((4, 3, 8))).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = jlayers.layer_norm(jx, jnp.asarray(scale, dtype),
                              jnp.asarray(bias, dtype))
    tx = bridge.tensor(np.asarray(jx))
    got = layers.layer_norm(tx, bridge.tensor(np.asarray(
        jnp.asarray(scale, dtype))), bridge.tensor(np.asarray(
            jnp.asarray(bias, dtype))))
    assert str(got.dtype).endswith(dtype)
    _close(got, want.astype(jnp.float32),
           UNIT if dtype == "float32" else dict(rtol=0, atol=0))
    x32 = tx.float()
    unbiased = ((x32 - x32.mean(-1, keepdim=True))
                * torch.rsqrt(x32.var(-1, keepdim=True) + 1e-5))
    assert float((unbiased - (x32 - x32.mean(-1, keepdim=True)) * torch.rsqrt(
        x32.var(-1, keepdim=True, unbiased=False) + 1e-5)).abs().max()) > 1e-2


def test_norm_kinds():
    ln = layers.norm_init(8, "layernorm", dtype=torch.float32)
    assert isinstance(ln, layers.LayerNorm)
    assert torch.equal(ln.scale, torch.ones(8))
    assert torch.equal(ln.bias, torch.zeros(8))
    rms = layers.norm_init(8, dtype=torch.float32)
    assert isinstance(rms, layers.RMSNorm)
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(layers.norm_apply("layernorm", ln, x), ln(x))
    assert torch.equal(layers.norm_apply("rmsnorm", rms, x), rms(x))
    with pytest.raises(ValueError, match="unknown norm"):
        layers.norm_init(8, "batchnorm", dtype=torch.float32)


def _gelu_case(mode: str):
    """A GELU FFN (d 64, F 256) and its DSG state from the reference, and
    x (2, 8, 64)."""
    cfg = _cfg(mode).dsg
    key = jax.random.PRNGKey(7)
    p = jdl.init_gelu_ffn(key, 64, 256)
    st = (None if not cfg.enabled else jdl.init_dsg_state(
        jax.random.fold_in(key, 1), 64, 256, cfg, p["w_up"]))
    x = jax.random.normal(jax.random.fold_in(key, 2), (2, 8, 64))
    tp = dl.GeluFFN(*(bridge.tensor(np.asarray(p[k]))
                      for k in ("w_up", "w_down")))
    tst = bridge.dsg_from_jax(_np(st), device="cpu")
    return cfg, p, st, x, tp, tst


def test_gelu_dense_is_the_reference_tanh_gelu():
    _, p, _, x, tp, _ = _gelu_case("off")
    want = jax.jit(jdl.gelu_dense)(p, x)
    got = dl.gelu_dense(tp, bridge.tensor(np.asarray(x)))
    _close(got, want, UNIT)
    # torch's default exact-erf GELU is another function
    erf = (torch.nn.functional.gelu(bridge.tensor(np.asarray(x)) @ tp.w_up)
           @ tp.w_down)
    assert float((erf - got).abs().max()) > 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_gelu_ffn_matches_reference(mode):
    cfg, p, st, x, tp, tst = _gelu_case(mode)
    want = jax.jit(jdl.gelu_ffn, static_argnums=(3,))(p, x, st, cfg)
    dl.gelu_ffn.calls.update(dict.fromkeys(dl.FFN_MODES, 0))
    got = dl.gelu_ffn(tp, bridge.tensor(np.asarray(x)), tst, cfg)
    _close(got, want, UNIT)
    took = "dense" if mode == "off" else cfg.mode
    assert dl.gelu_ffn.calls == dict(dict.fromkeys(dl.FFN_MODES, 0),
                                     **{took: 1})
    if mode != "off":
        # DSG dropped something: the dense FFN is another function
        dense = dl.gelu_dense(tp, bridge.tensor(np.asarray(x)))
        assert float((dense - got).abs().max()) > 1e-3


def test_search_weight_is_the_up_path_without_a_gate():
    _, p, _, _, tp, _ = _gelu_case("off")
    assert dl.search_weight(tp) is tp.w_up
    assert jdl.search_weight(p) is p["w_up"]
    sw = dl.init_swiglu(8, 16, generator=torch.Generator().manual_seed(0),
                        dtype=torch.float32)
    assert dl.search_weight(sw) is sw.w_gate


def _attn_case(s=4, t=12):
    key = jax.random.PRNGKey(11)
    p = jattn.init_attention(key, 64, 4, 4, 16)
    x = jax.random.normal(jax.random.fold_in(key, 1), (2, s, 64))
    mem = jax.random.normal(jax.random.fold_in(key, 2), (2, t, 64))
    tp = attention.Attention(*(bridge.tensor(np.asarray(p[k]))
                               for k in ("wq", "wk", "wv", "wo")))
    return p, x, mem, tp


def test_cross_attention_and_memory_kv_match_reference():
    p, x, mem, tp = _attn_case()
    k, v = jax.jit(jattn.memory_kv)(p, mem)
    tk, tv = attention.memory_kv(tp, bridge.tensor(np.asarray(mem)))
    _close(tk, k, UNIT)
    _close(tv, v, UNIT)
    want = jax.jit(jattn.cross_attention, static_argnames=("n_heads",))(
        p, x, k, v, n_heads=4, q_pos=jnp.arange(4) + 3)
    got = attention.cross_attention(tp, bridge.tensor(np.asarray(x)), tk,
                                    tv, n_heads=4,
                                    q_pos=torch.arange(4) + 3)
    _close(got, want, UNIT)
    # no RoPE and no causal mask: the query positions change nothing
    again = attention.cross_attention(tp, bridge.tensor(np.asarray(x)), tk,
                                      tv, n_heads=4, q_pos=torch.arange(4))
    assert torch.equal(again, got)


def test_cross_attention_switches_to_chunked_as_the_reference(monkeypatch):
    """Above CHUNK_THRESHOLD (S · T) both packages' cross-attention takes
    the chunked path: with the threshold at 32, 4 queries over 12 memory
    rows (48) switch."""
    p, x, mem, tp = _attn_case()
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 32)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 32)
    calls = []
    real = attention.attend_chunked

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)

    monkeypatch.setattr(attention, "attend_chunked", spy)
    k, v = jattn.memory_kv(p, mem)
    want = jattn.cross_attention(p, x, k, v, n_heads=4, q_pos=jnp.arange(4))
    tk, tv = attention.memory_kv(tp, bridge.tensor(np.asarray(mem)))
    got = attention.cross_attention(tp, bridge.tensor(np.asarray(x)), tk,
                                    tv, n_heads=4, q_pos=torch.arange(4))
    assert calls == [(2, 4, 4, 16)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_attend_chunked_bidirectional_matches_reference():
    """causal=False at a size that tiles the default 1024 chunks: 2 x 2
    tiles, every key visible to every query."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 2048, 2, 16)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(2048)
    want = jax.jit(jattn.attend_chunked, static_argnums=(5, 6))(
        *map(jnp.asarray, (q, k, v, pos, pos)), False, 0)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = attention.attend_chunked(tq, tk, tv, tp, tp, False, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    direct = attention.attend_direct(tq, tk, tv, tp, tp, False, 0)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_encoder_self_attention_is_bidirectional_as_the_reference():
    p, x, _, tp = _attn_case(s=12)
    pos = jnp.arange(12)
    kw = dict(n_heads=4, n_kv=4, rope_theta=10_000.0, causal=False,
              window=0)
    want, _ = jax.jit(jattn.self_attention, static_argnames=tuple(kw))(
        p, x, q_pos=pos, **kw)
    tx = bridge.tensor(np.asarray(x))
    got, _ = attention.self_attention(tp, tx, q_pos=torch.arange(12), **kw)
    _close(got, want, UNIT)
    # the first token sees the last: changing it moves the first output
    moved = tx.clone()
    moved[:, -1] += 1.0
    out, _ = attention.self_attention(tp, moved, q_pos=torch.arange(12),
                                      **kw)
    assert float((out[:, 0] - got[:, 0]).abs().max()) > 1e-4


# ---------------------------------------------------------------------------
# the api verbs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_encode_and_memory_kv_match_reference(mode, built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built(mode)
    frames = japi.make_inputs(cfg, PREFILL, concrete=True)["frames"]
    enc = jax.jit(jencdec.encode, static_argnums=(2,))(params, dsg, cfg,
                                                        frames)
    mem = jax.jit(jencdec.build_memory_kv)(params, enc)
    with torch.no_grad():
        tenc = encdec.encode(model, tdsg, tcfg, bridge.tensor(
            np.asarray(frames)))
        tmem = encdec.build_memory_kv(model, tenc)
    _close(tenc, enc, UNIT)
    for k in ("k", "v"):
        assert tuple(tmem[k].shape) == mem[k].shape
        _close(tmem[k], mem[k], UNIT, k)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_greedy_decode_match_reference(mode, built, served):
    """api.prefill's last logits and both parts of its state, then STEPS
    greedy decode steps: identical token streams, logits within 1e-4."""
    _, (tcfg, model, tdsg) = built(mode)
    inputs, logits, state, steps = served(mode)
    tcache = api.make_cache(tcfg, 2, MAX_SEQ, device="cpu")
    assert tuple(tcache["k"].shape) == state["self"]["k"].shape
    tl, tstate = api.prefill(model, tdsg, tcfg, _t(inputs), tcache)
    assert tstate["self"] is tcache
    _close(tl, logits)
    for part in ("self", "memory"):
        for k in ("k", "v"):
            _close(tstate[part][k], state[part][k], UNIT, f"{part}/{k}")
    p_len = inputs["tokens"].shape[1]
    for i, (tok, want) in enumerate(steps):
        got_tok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(got_tok.numpy(), tok)
        tl, tstate = api.decode_step(model, tdsg, tcfg, got_tok, tstate,
                                     p_len + i)
        assert bool(torch.isfinite(tl).all())
        _close(tl, want, msg=f"step {i}")


@pytest.mark.parametrize("mode", MODES)
def test_refresh_dsg_matches_reference(mode, built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built(mode)
    if dsg is None:
        assert tdsg is None and api.refresh_dsg(None, model, tcfg) is None
        gen = torch.Generator().manual_seed(0)
        assert api.init_dsg(model, tcfg, generator=gen, device="cpu") is None
        return
    rng = np.random.default_rng(3)
    moved = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(a.dtype), params)
    want = japi.refresh_dsg(dsg, moved, cfg)
    _, mmodel, _ = _port(cfg, moved, dsg)
    got = api.refresh_dsg(tdsg, mmodel, tcfg)
    assert set(got) == set(want) == {"r", "fw_enc", "fw_dec"}
    assert got["r"] is tdsg["r"]
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and not got[k].requires_grad
        _close(got[k], v, UNIT, k)
    # a fresh port init builds the same leaves at the same shapes
    gen = torch.Generator().manual_seed(0)
    fresh = api.init_model(tcfg, generator=gen, device="cpu")
    own = api.init_dsg(fresh, tcfg, generator=gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    assert [n for n, _ in fresh.named_parameters()] == \
        [n for n, _ in model.named_parameters()]


# -- the cases of tests/test_archs_smoke.py, as parity tests ---------------

def test_smoke_prefill_decode_roundtrip_matches_reference(built):
    """test_prefill_decode_roundtrip: its cache of 32 // 4 = 8 decoder
    slots and its positions 16, 17, 18, past the cache: the reference's
    dynamic_update_slice clamps the write into the last slot and every
    slot stays visible; the port writes and attends the same."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built("mask_shared")
    inputs = japi.make_inputs(cfg, PREFILL, concrete=True)
    logits, state = jprefill(params, dsg, cfg, inputs,
                             japi.make_cache(cfg, 2, 32))
    tl, tstate = api.prefill(model, tdsg, tcfg, _t(inputs),
                             api.make_cache(tcfg, 2, 32, device="cpu"))
    assert tuple(tl.shape) == (2, cfg.vocab)
    _close(tl, logits)
    for i in range(3):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(),
                                      np.asarray(tok[:, 0]))
        logits, state = jdecode(params, dsg, cfg, tok, state,
                                jnp.int32(16 + i))
        tl, tstate = api.decode_step(
            model, tdsg, tcfg, torch.from_numpy(np.array(tok)).long(),
            tstate, 16 + i)
        assert bool(torch.isfinite(tl).all())
        _close(tl, logits, msg=f"step {i}")
    _close(tstate["self"]["k"], state["self"]["k"], UNIT)


def test_smoke_dsg_refresh_keeps_shapes_and_dtypes(built):
    """test_dsg_refresh_shapes."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built("mask_shared")
    new = japi.refresh_dsg(dsg, params, cfg)
    got = api.refresh_dsg(tdsg, model, tcfg)
    for k in new:
        assert tuple(got[k].shape) == new[k].shape == dsg[k].shape
        assert got[k].dtype == tdsg[k].dtype


def test_decode_continues_prefill(built):
    """DSG off, where masks cannot part (with the shared threshold, row 0
    of each call sets it, ROADMAP.md §3): prefill(P - 1) and one decode
    step give prefill(P)'s last logits, in both packages."""
    (cfg, params, _), (tcfg, model, _) = built("off")
    inputs = japi.make_inputs(cfg, JShape("p", 32, 2, "prefill"),
                              concrete=True, seed=4)
    t = _t(inputs)
    p_len = t["tokens"].shape[1]
    full, _ = api.prefill(model, None, tcfg, t,
                          api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    _, st = api.prefill(model, None, tcfg, dict(
        t, tokens=t["tokens"][:, :-1]), api.make_cache(
            tcfg, 2, MAX_SEQ, device="cpu"))
    step, _ = api.decode_step(model, None, tcfg, t["tokens"][:, -1:], st,
                              p_len - 1)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=0,
                               atol=1e-4)
    want, _ = jprefill(params, None, cfg, inputs,
                       japi.make_cache(cfg, 2, MAX_SEQ))
    _close(full, want)


def test_decoding_twice_from_one_state_needs_a_clone(built):
    """The port's decoder cache is written in place (the reference returns
    new arrays): a state kept for a second decode is cloned first."""
    _, (tcfg, model, tdsg) = built("mask_shared")
    (cfg, _, _), _ = built("mask_shared")
    inputs = _t(japi.make_inputs(cfg, PREFILL, concrete=True))
    logits, st = api.prefill(model, tdsg, tcfg, inputs,
                             api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    kept = {"self": {k: v.clone() for k, v in st["self"].items()},
            "memory": st["memory"]}
    tok = torch.argmax(logits, -1)[:, None]
    a, st2 = api.decode_step(model, tdsg, tcfg, tok, st, 4)
    assert st2["self"] is st["self"]
    assert not torch.equal(st["self"]["k"], kept["self"]["k"])
    b, _ = api.decode_step(model, tdsg, tcfg, tok, kept, 4)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# numerics the reference fixes
# ---------------------------------------------------------------------------

def test_scores_stay_f32_although_the_config_sets_bf16_scores(
        built, monkeypatch):
    """whisper's config sets attn_bf16_scores, but no attention call of
    the reference's encdec passes it on: every score is f32.  Both
    packages' attend_direct calls, in bf16, take bf16_scores False."""
    (cfg, params, dsg), _ = built("mask_shared")
    assert cfg.attn_bf16_scores
    cfg = cfg.replace(dtype="bfloat16")
    params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    dsg = jax.tree.map(lambda a: a.astype(jnp.bfloat16), dsg)
    tcfg, model, tdsg = _port(cfg, params, dsg)
    seen = {"ref": [], "port": []}

    def spy(side, real):
        def f(q, k, v, *a, bf16_scores=False, **kw):
            seen[side].append((str(q.dtype), bf16_scores))
            return real(q, k, v, *a, bf16_scores=bf16_scores, **kw)
        return f

    monkeypatch.setattr(jattn, "attend_direct",
                        spy("ref", jattn.attend_direct))
    monkeypatch.setattr(attention, "attend_direct",
                        spy("port", attention.attend_direct))
    inputs = japi.make_inputs(cfg, PREFILL, concrete=True)
    japi.prefill(params, dsg, cfg, inputs, japi.make_cache(cfg, 2, MAX_SEQ))
    api.prefill(model, tdsg, tcfg, _t(inputs),
                api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    # encoder self, decoder self and cross: one call a layer each (the
    # reference traces each scanned body once)
    assert seen["port"] == [("torch.bfloat16", False)] * (
        cfg.enc_layers + 2 * cfg.n_layers)
    assert {b for _, b in seen["ref"]} == {False} and len(seen["ref"]) == 3
    assert {d for d, _ in seen["ref"]} == {"bfloat16"}


# bf16 at smoke width, DSG off (a mask taken at a tie is a selection, not
# arithmetic: with DSG on the reference's own bf16 run parts from its f32
# run by up to 0.77 at seed 1 where a group flips), 8 prompt tokens, seed
# 0.  E, the reference's bf16 error against its f32 run on the same
# (cast) weights, measured: 0.0254 at the prefill and 0.0169 at the decode
# step (the port's gaps: 0.0234 and 0.0195; seeds 1-2 gave E 0.021-0.022
# and gaps up to 0.031).  Each atol lies in [2E, 3E], rounded.
BF16_PREFILL_ATOL = 0.06
BF16_DECODE_ATOL = 0.05


def test_bf16_prefill_and_decode_step_within_measured_tolerance():
    cfg = _cfg("off").replace(dtype="bfloat16")
    c32 = cfg.replace(dtype="float32")
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    inputs = japi.make_inputs(cfg, JShape("p", 32, 2, "prefill"),
                              concrete=True)
    in32 = dict(inputs, frames=inputs["frames"].astype(jnp.float32))
    l16, st16 = jprefill(params, None, cfg, inputs,
                         japi.make_cache(cfg, 2, MAX_SEQ))
    l32, _ = jprefill(p32, None, c32, in32, japi.make_cache(c32, 2, MAX_SEQ))
    tok = jnp.argmax(l16, -1)[:, None].astype(jnp.int32)
    d16, _ = jdecode(params, None, cfg, tok, st16, jnp.int32(8))
    d32, _ = jdecode(p32, None, c32, tok,
                     jax.tree.map(lambda a: a.astype(jnp.float32), st16),
                     jnp.int32(8))
    tcfg, model, _ = _port(cfg, params, None)
    tl, _ = api.prefill(model, None, tcfg, _t(inputs),
                        api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    assert tl.dtype == torch.bfloat16
    # the decode step teacher-forced on the reference's bf16 prefill state
    tstate = {part: {k: bridge.tensor(np.asarray(v)) for k, v in
                     st16[part].items()} for part in ("self", "memory")}
    td, _ = api.decode_step(model, None, tcfg,
                            torch.from_numpy(np.array(tok)).long(),
                            tstate, 8)
    for got, ref16, ref32, atol in ((tl, l16, l32, BF16_PREFILL_ATOL),
                                    (td, d16, d32, BF16_DECODE_ATOL)):
        ref16 = np.asarray(ref16.astype(jnp.float32))
        e = float(np.abs(ref16 - np.asarray(ref32)).max())
        assert 2 * e <= atol <= 3 * e, (e, atol)
        np.testing.assert_allclose(got.float().numpy(), ref16, rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli", [serve, train])
def test_clis_refuse_whisper_naming_the_roadmap(cli, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--smoke", "--device", "cpu", "--arch", ARCH])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "ROADMAP.md §3" in err and "frames" in err


def test_generate_and_the_engine_refuse_the_family(built):
    _, (tcfg, model, tdsg) = built("mask_shared")
    prompts = torch.zeros((2, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §3"):
        serve.generate(tcfg, model, tdsg, prompts, 2)
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        ServingEngine(tcfg, model, tdsg)


def test_serving_features_are_refused_as_in_the_reference(built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built("mask_shared")
    inputs = japi.make_inputs(cfg, PREFILL, concrete=True)
    with pytest.raises(NotImplementedError, match="decoder-family"):
        japi.prefill(params, dsg, cfg, inputs,
                     japi.make_cache(cfg, 2, MAX_SEQ),
                     collect_drs_scores=True)
    with pytest.raises(NotImplementedError, match="decoder-family"):
        api.prefill(model, tdsg, tcfg, _t(inputs),
                    api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"),
                    collect_drs_scores=True)
    _, st = api.prefill(model, tdsg, tcfg, _t(inputs),
                        api.make_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    tok = torch.zeros((2, 1), dtype=torch.long)
    for kw in ({"ffn_csr": {"idx": None, "counts": None}},
               {"collect_drs_scores": True}):
        with pytest.raises(NotImplementedError, match="decoder-family"):
            api.decode_step(model, tdsg, tcfg, tok, st, 4, **kw)
    with pytest.raises(NotImplementedError, match="one position"):
        api.decode_step(model, tdsg, tcfg, tok, st, torch.tensor([4, 5]))
    with pytest.raises(ValueError, match="make_cache"):
        api.prefill(model, tdsg, tcfg, _t(inputs), None)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    tcfg = configs.get_smoke_config(ARCH)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: api.init_model(tcfg, generator=gen),
                 lambda: api.make_cache(tcfg, 2, 32),
                 lambda: api.make_inputs(tcfg, SMOKE_SHAPE, concrete=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
