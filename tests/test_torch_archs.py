"""The seven decoder-family archs (dense, moe, vlm) of the port against
`repro` on the same parameters, carried over with `repro_torch.bridge`, on
the CPU at smoke width (f32): the port's mirror of
`tests/test_archs_smoke.py`, plus what those archs need of
`tests/test_models_units.py` (chunked attention).

Every arch: its full and smoke configs equal the reference's field for
field; `make_inputs` gives the reference's arrays; `api.prefill` plus 3
greedy decode steps give the reference's logits (a VLM's prefill carries
its stub patch embeddings); `train_loss` and every gradient agree with
`jax.value_and_grad`; DSG off; `refresh_dsg` gives the reference's f(W)
leaves.

Tolerances (f32), as `tests/test_torch_train.py` measured them: logits
atol 1e-4; losses rtol 1e-5; each gradient leaf within 1e-5 ·
max(1, max|g|); f(W) atol 1e-5; chunked attention rtol / atol 2e-5 (the
reference's own chunked-against-direct bound).
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
from repro.configs.base import SMOKE_SHAPE as JSMOKE  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.configs.base import SMOKE_SHAPE, ShapeConfig  # noqa: E402
from repro_torch.models import api, attention  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ARCHS = ["mistral-nemo-12b", "internlm2-1.8b", "llama3.2-3b",
         "phi3-mini-3.8b", "deepseek-moe-16b", "llama4-scout-17b-a16e",
         "llava-next-34b"]
LOGITS = dict(rtol=0, atol=1e-4)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _port(cfg, params, dsg, trainable=False):
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu", trainable=trainable)
    tdsg = bridge.dsg_from_jax(
        None if dsg is None else jax.tree.map(np.asarray, dsg), device="cpu")
    return tcfg, model, tdsg


@pytest.fixture(scope="module")
def built():
    """Per arch, as `tests/test_archs_smoke.py` builds it: the reference's
    smoke (cfg, params, dsg) and the port's bridged copy."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jconfigs.get_smoke_config(arch)
            params = japi.init_model(jax.random.PRNGKey(0), cfg)
            dsg = japi.init_dsg(jax.random.PRNGKey(1), params, cfg)
            cache[arch] = ((cfg, params, dsg), _port(cfg, params, dsg))
        return cache[arch]

    return get


def _t(batch: dict) -> dict:
    """The reference's batch as port tensors (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a.copy())
    return out


def test_the_seven_decoder_archs_are_ported():
    # the registry also holds the two recurrent archs
    # (tests/test_torch_recurrent.py) and whisper-large-v3
    # (tests/test_torch_encdec.py): every arch of the reference
    assert sorted(configs.ARCHS) == sorted(ARCHS + ["xlstm-350m",
                                                    "zamba2-7b",
                                                    "whisper-large-v3"])
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert sorted(ARCHS) == sorted(
        a for a in jconfigs.ARCHS if jconfigs.get_config(a).family in
        ("dense", "moe", "vlm"))
    assert configs.LONG_CONTEXT_ARCHS == jconfigs.LONG_CONTEXT_ARCHS
    for arch in jconfigs.ARCHS:
        for shape in ("train_4k", "long_500k"):
            assert configs.cell_is_runnable(arch, shape) == \
                jconfigs.cell_is_runnable(arch, shape)


@pytest.mark.parametrize("arch", ["no-such-arch"])
def test_other_archs_are_refused_with_a_pointer(arch):
    # every arch of the reference is ported: an arch neither package
    # knows is refused, naming the archs there are
    assert arch not in jconfigs.ARCHS
    with pytest.raises(KeyError, match="unknown arch.*whisper-large-v3"):
        configs.get_config(arch)
    with pytest.raises(KeyError, match="unknown arch.*internlm2-1.8b"):
        configs.get_smoke_config(arch)


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_field_for_field(arch, getter):
    ref = getattr(jconfigs, getter)(arch)
    port = getattr(configs, getter)(arch)
    names = [f.name for f in dataclasses.fields(ref)]
    assert names == [f.name for f in dataclasses.fields(port)]
    for name in names:
        if name == "dsg":
            assert tuple(port.dsg) == tuple(ref.dsg)
        else:
            assert getattr(port, name) == getattr(ref, name), name
    assert port.head_dim == ref.head_dim and port.is_moe == ref.is_moe
    assert bridge.config_from_jax(ref) == port


def test_shapes_match_reference():
    assert [dataclasses.astuple(s) for s in configs.SHAPES] == \
        [dataclasses.astuple(s) for s in jconfigs.SHAPES]
    assert dataclasses.astuple(SMOKE_SHAPE) == dataclasses.astuple(JSMOKE)
    for s in jconfigs.SHAPES:
        assert dataclasses.astuple(configs.shape_by_name(s.name)) == \
            dataclasses.astuple(s)
    with pytest.raises(KeyError):
        configs.shape_by_name("nope")


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_inputs_match_reference(arch, kind):
    cfg, tcfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(
        arch)
    want = japi.make_inputs(cfg, JShape("c", 32, 2, kind), concrete=True,
                            seed=5)
    got = api.make_inputs(tcfg, ShapeConfig("c", 32, 2, kind),
                          concrete=True, seed=5, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
        assert str(got[k].dtype).endswith(str(np.asarray(v).dtype))
    spec = japi.make_inputs(cfg, JShape("c", 32, 2, kind))
    meta = api.make_inputs(tcfg, ShapeConfig("c", 32, 2, kind))
    for k, v in spec.items():
        assert meta[k].is_meta and tuple(meta[k].shape) == v.shape
        assert str(meta[k].dtype).endswith(str(v.dtype))


def test_make_inputs_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.make_inputs(cfg, SMOKE_SHAPE, concrete=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built(arch)
    inputs = japi.make_inputs(cfg, JShape("p", 16, 2, "prefill"),
                              concrete=True)
    cache = japi.make_cache(cfg, 2, 32)
    logits, state = japi.prefill(params, dsg, cfg, inputs, cache)
    tcache = api.make_cache(tcfg, 2, 32, device="cpu")
    tl, tcache = api.prefill(model, tdsg, tcfg, _t(inputs), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)
    for i in range(3):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        assert torch.equal(torch.argmax(tl, -1), torch.from_numpy(
            np.asarray(tok[:, 0]).astype(np.int64)))
        logits, state = japi.decode_step(params, dsg, cfg, tok, state,
                                         jnp.int32(16 + i))
        tl, tcache = api.decode_step(
            model, tdsg, tcfg, torch.from_numpy(np.array(tok)).long(),
            tcache, 16 + i)
        assert bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch, built):
    (cfg, params, dsg), _ = built(arch)
    batch = japi.make_inputs(cfg, JSMOKE, concrete=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, dsg, cfg, batch)))(params)
    want = _leaves(jax.tree.map(np.asarray, grads))
    tcfg, model, tdsg = _port(cfg, params, dsg, trainable=True)
    named = dict(model.named_parameters())
    tloss = api.train_loss(model, tdsg, tcfg, _t(batch))
    got = _leaves(bridge.to_reference_tree(dict(zip(
        named, torch.autograd.grad(tloss, list(named.values()))))))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    assert set(got) == set(want)
    for path, g in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[path].numpy(), g, rtol=0, atol=tol,
                                   err_msg=path)
    assert float(np.sum([np.sum(np.square(g)) for g in want.values()])) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_dsg_off_matches_reference(arch, built):
    (cfg, _, _), _ = built(arch)
    cfg_off = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    params = japi.init_model(jax.random.PRNGKey(0), cfg_off)
    assert japi.init_dsg(jax.random.PRNGKey(1), params, cfg_off) is None
    batch = japi.make_inputs(cfg_off, JSMOKE, concrete=True)
    tcfg, model, _ = _port(cfg_off, params, None)
    gen = torch.Generator().manual_seed(0)
    assert api.init_dsg(model, tcfg, generator=gen, device="cpu") is None
    np.testing.assert_allclose(
        api.train_loss(model, None, tcfg, _t(batch)).item(),
        float(japi.train_loss(params, None, cfg_off, batch)), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_refresh_dsg_matches_reference(arch, built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built(arch)
    want = japi.refresh_dsg(dsg, params, cfg)
    got = api.refresh_dsg(tdsg, model, tcfg)
    assert set(got) == set(want) == set(tdsg)
    assert got["r"] is tdsg["r"]
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape == tdsg[k].shape
        assert got[k].dtype == tdsg[k].dtype
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
    # a fresh port init builds the same leaves at the same shapes
    gen = torch.Generator().manual_seed(0)
    fresh = api.init_model(tcfg, generator=gen, device="cpu")
    own = api.init_dsg(fresh, tcfg, generator=gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    if tcfg.is_moe:
        assert isinstance(fresh.layers[0].moe.router, torch.Tensor)
        assert fresh.layers[0].moe.router.dtype == torch.float32


def test_vlm_prefix_forward_matches_reference(built):
    """The stub patch embeddings are prepended: the forward's logits cover
    prefix and tokens, as the reference's do, and the loss cuts the
    prefix's positions off."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built("llava-next-34b")
    batch = japi.make_inputs(cfg, JSMOKE, concrete=True, seed=3)
    p = batch["prefix_embeds"].shape[1]
    assert p == cfg.vision_prefix == 8
    want, _, _ = jtransformer.forward(params, dsg, cfg, batch["tokens"],
                                      prefix_embeds=batch["prefix_embeds"])
    tb = _t(batch)
    got, _ = transformer.forward(model, tdsg, tcfg, tb["tokens"],
                                 prefix_embeds=tb["prefix_embeds"])
    assert tuple(got.shape) == want.shape == (2, 32, cfg.vocab)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGITS)
    # the loss reads the token positions only
    no_prefix, _ = transformer.forward(model, tdsg, tcfg, tb["tokens"])
    assert not torch.allclose(no_prefix, got[:, p:])
    np.testing.assert_allclose(
        api.train_loss(model, tdsg, tcfg, tb).item(),
        float(japi.train_loss(params, dsg, cfg, batch)), rtol=1e-5)


def test_other_families_raise_naming_the_roadmap(built):
    # every family of the reference is ported: a family neither package
    # has is refused by every verb, naming the families there are
    _, (tcfg, model, tdsg) = built("internlm2-1.8b")
    for fam in ("no-such-family",):
        cfg = tcfg.replace(family=fam)
        gen = torch.Generator().manual_seed(0)
        for call in (
                lambda: api.init_model(cfg, generator=gen, device="cpu"),
                lambda: api.init_dsg(model, cfg, generator=gen,
                                     device="cpu"),
                lambda: api.refresh_dsg(tdsg, model, cfg),
                lambda: api.train_loss(model, tdsg, cfg, {}),
                lambda: api.make_cache(cfg, 1, 8, device="cpu"),
                lambda: api.prefill(model, tdsg, cfg, {}, None),
                lambda: api.decode_step(model, tdsg, cfg, None, None, 0),
                lambda: api.make_inputs(cfg, SMOKE_SHAPE)):
            with pytest.raises(ValueError, match="unknown family.*encdec"):
                call()


def test_slot_wrappers_match_reference(built):
    (cfg, params, dsg), (tcfg, model, tdsg) = built("internlm2-1.8b")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 12),
                                             dtype=np.int32)
    lane = japi.make_slot_cache(cfg, 32)
    logits, lane = japi.prefill_slot(params, dsg, cfg, jnp.asarray(toks),
                                     lane)
    merged = japi.merge_slot_cache(japi.make_cache(cfg, 3, 32), lane, 1)
    tlane = api.make_slot_cache(tcfg, 32, device="cpu")
    assert tuple(tlane["k"].shape) == lane["k"].shape
    tlogits, tlane = api.prefill_slot(model, tdsg, tcfg,
                                      torch.from_numpy(toks).long(), tlane)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               **LOGITS)
    tm = api.merge_slot_cache(api.make_cache(tcfg, 3, 32, device="cpu"),
                              tlane, 1)
    for k in ("k", "v"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(merged[k]),
                                   rtol=0, atol=1e-5)


# -- chunked attention (tests/test_models_units.py:24-48) ------------------

@pytest.mark.parametrize("s,h,d,window,chunk", [(128, 4, 32, 0, 32),
                                                (64, 2, 16, 16, 16)])
def test_attend_chunked_matches_reference(s, h, d, window, chunk):
    rng = np.random.default_rng(s + window)
    q, k, v = (rng.standard_normal((2, s, h, d)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(s)
    want = jattn.attend_chunked(*map(jnp.asarray, (q, k, v, pos, pos)),
                                causal=True, window=window, q_chunk=chunk,
                                kv_chunk=chunk)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = attention.attend_chunked(tq, tk, tv, tp, tp, True, window,
                                   q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    direct = attention.attend_direct(tq, tk, tv, tp, tp, True, window)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="tile exactly"):
        attention.attend_chunked(tq, tk, tv, tp, tp, True, window,
                                 q_chunk=chunk + 1, kv_chunk=chunk)


def test_chunk_threshold_switch_taken_as_the_reference_takes_it(
        built, monkeypatch):
    """Above CHUNK_THRESHOLD (S · T, T the whole cache for a prefill) both
    packages attend through the chunked path: with the threshold lowered
    to 256, a 16-token llava prefill (8 prefix + 8 tokens, 32-slot cache:
    512) and its 32-token loss (1024) switch, and the 3 decode steps that
    follow (per-lane positions are never chunked) do not."""
    assert attention.CHUNK_THRESHOLD == jattn.CHUNK_THRESHOLD == 1 << 24
    (cfg, params, dsg), (tcfg, model, tdsg) = built("llava-next-34b")
    monkeypatch.setattr(jattn, "CHUNK_THRESHOLD", 256)
    monkeypatch.setattr(attention, "CHUNK_THRESHOLD", 256)
    calls = []
    real = attention.attend_chunked

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return real(q, *a, **kw)

    monkeypatch.setattr(attention, "attend_chunked", spy)
    inputs = japi.make_inputs(cfg, JShape("p", 16, 2, "prefill"),
                              concrete=True, seed=2)
    logits, _ = japi.prefill(params, dsg, cfg, inputs,
                             japi.make_cache(cfg, 2, 32))
    tl, _ = api.prefill(model, tdsg, tcfg, _t(inputs),
                        api.make_cache(tcfg, 2, 32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)
    assert calls == [(2, 16, 4, 16)] * cfg.n_layers
    batch = japi.make_inputs(cfg, JSMOKE, concrete=True)
    np.testing.assert_allclose(
        api.train_loss(model, tdsg, tcfg, _t(batch)).item(),
        float(japi.train_loss(params, dsg, cfg, batch)), rtol=1e-5)
    assert len(calls) == 2 * cfg.n_layers
