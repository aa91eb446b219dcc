"""The recurrent archs, xlstm-350m and zamba2-7b, in the port against
`repro` on the same parameters, carried over with `repro_torch.bridge`, on
the CPU at smoke width (f32): the port's mirror of
`tests/test_archs_smoke.py` for these two archs, their greedy streams
through `generate`, an 8-step training run, checkpoints across the two
packages, and the CLIs.

Tolerances (f32), each stated with what it was measured at:
  * logits atol 1e-4 (`tests/test_torch_archs.py`'s; measured: 1.2e-5);
  * decode states, each leaf within 2e-5 x max(1, max|leaf|) (measured:
    7.6e-6 on the sLSTM's c, whose exponential gates sum 16 steps; 1.3e-6
    on every other leaf);
  * losses rtol 1e-5 (measured: equal, or one ulp);
  * gradients, each leaf within rtol 1e-4 of its largest entry (measured:
    2.4e-5 on the mLSTM's w_out with DSG on, 1.1e-5 on its norm scale; the
    mLSTM's exp(min(i, 8)) input gate and the exp of summed log forget
    gates amplify the summation order, where a decoder's leaves stay
    under 1e-5);
  * f(W) atol 1e-5;
  * the 8-step training run's losses within 4 f32 ulps of the
    reference's, where the decoder run holds 2 (`tests/test_torch_train.py`);
    measured here: 3 ulps at most (steps 2 and 5), 1 ulp already at step
    0, whose loss is the forward's alone: the chunked scans' einsums sum
    in another order than XLA's.  ROADMAP §3 logs this under the
    deliberate deviations.
Greedy streams are compared token for token.
"""
import dataclasses
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.configs.base import SMOKE_SHAPE as JSMOKE  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import api, recurrent  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving.scheduler import ServingEngine  # noqa: E402

ARCHS = ["xlstm-350m", "zamba2-7b"]
LOGITS = dict(rtol=0, atol=1e-4)
STATE_SCALE = 2e-5
MAX_ULPS = 4
STEPS, REFRESH, BATCH, SEQ = 8, 4, 4, 32


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    return (t.detach().float() if t.dtype == torch.bfloat16
            else t.detach()).numpy()


def _port(cfg, params, dsg, trainable=False):
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu", trainable=trainable)
    tdsg = bridge.dsg_from_jax(
        None if dsg is None else jax.tree.map(np.asarray, dsg), device="cpu")
    return tcfg, model, tdsg


def _t(batch: dict) -> dict:
    """The reference's batch as port tensors (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        out[k] = torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                  else a.copy())
    return out


def _cfg(arch, dsg_on=True):
    cfg = jconfigs.get_smoke_config(arch)
    return cfg if dsg_on else cfg.replace(
        dsg=cfg.dsg._replace(enabled=False))


def _jitted(cfg):
    """The reference's prefill and decode_step for cfg, each jitted (one
    trace for the 3 decode steps)."""
    return (jax.jit(lambda p, d, inp, c: japi.prefill(p, d, cfg, inp, c)),
            jax.jit(lambda p, d, tok, st, pos: japi.decode_step(
                p, d, cfg, tok, st, pos)))


@pytest.fixture(scope="module")
def built():
    """Per (arch, DSG on): the reference's smoke (cfg, params, dsg), as
    `tests/test_archs_smoke.py` builds it, and the port's bridged copy."""
    cache = {}

    def get(arch, dsg_on=True):
        if (arch, dsg_on) not in cache:
            cfg = _cfg(arch, dsg_on)
            params = japi.init_model(jax.random.PRNGKey(0), cfg)
            dsg = japi.init_dsg(jax.random.PRNGKey(1), params, cfg)
            cache[arch, dsg_on] = ((cfg, params, dsg),
                                   _port(cfg, params, dsg))
        return cache[arch, dsg_on]

    return get


# ---------------------------------------------------------------------------
# configs and inputs
# ---------------------------------------------------------------------------

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
    assert port.head_dim == ref.head_dim
    assert bridge.config_from_jax(ref) == port
    assert configs.cell_is_runnable(arch, "long_500k")


@pytest.mark.parametrize("arch,billions", [("xlstm-350m", 0.279),
                                           ("zamba2-7b", 6.52)])
def test_full_width_models_have_the_reference_leaves(arch, billions):
    """The full configs' numbers (`tests/test_archs_smoke.py`), and the
    port's full-width model, built on the meta device, has the reference's
    leaves, shapes and dtypes (the reference's by jax.eval_shape)."""
    cfg = configs.get_config(arch)
    if arch == "xlstm-350m":
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == \
            (24, 1024, 4, 50304)
        model = recurrent.init_xlstm_model(cfg, generator=None,
                                           device="meta")
    else:
        assert (cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
                cfg.ssm_state) == (3584, 32, 14336, 32000, 64)
        model = recurrent.init_zamba_model(cfg, generator=None,
                                           device="meta")
    want = _leaves(jax.eval_shape(lambda k: japi.init_model(
        k, jconfigs.get_config(arch)), jax.random.PRNGKey(0)))
    got = _leaves(bridge.to_reference_tree(dict(model.named_parameters())))
    assert set(got) == set(want)
    for path, v in want.items():
        assert tuple(got[path].shape) == v.shape, path
        assert str(got[path].dtype).endswith(str(v.dtype)), path
    n = sum(p.numel() for p in model.parameters())
    assert round(n / 1e9, 3 if billions < 1 else 2) == billions


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
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


# ---------------------------------------------------------------------------
# prefill, decode, loss, gradients, refresh
# ---------------------------------------------------------------------------

def _assert_states(got, want):
    got, want = _leaves(got), _leaves(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for path, v in want.items():
        assert tuple(got[path].shape) == v.shape, path
        assert str(got[path].dtype).endswith(str(v.dtype)), path
        tol = STATE_SCALE * max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(_np(got[path]), v, rtol=0, atol=tol,
                                   err_msg=path)


@pytest.mark.parametrize("dsg_on", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dsg_on, built):
    """Prefill plus 3 greedy decode steps: the logits and every state
    leaf."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built(arch, dsg_on)
    prefill, decode = _jitted(cfg)
    inputs = japi.make_inputs(cfg, JShape("p", 16, 2, "prefill"),
                              concrete=True)
    logits, state = prefill(params, dsg, inputs, japi.make_cache(cfg, 2, 32))
    tl, tstate = api.prefill(model, tdsg, tcfg, _t(inputs),
                             api.make_cache(tcfg, 2, 32, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)
    _assert_states(tstate, state)
    for i in range(3):
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        assert torch.equal(torch.argmax(tl, -1), torch.from_numpy(
            np.asarray(tok[:, 0]).astype(np.int64)))
        logits, state = decode(params, dsg, tok, state, jnp.int32(16 + i))
        tl, tstate = api.decode_step(
            model, tdsg, tcfg, torch.from_numpy(np.array(tok)).long(),
            tstate, 16 + i)
        assert not tl.requires_grad
        np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)
        _assert_states(tstate, state)


@pytest.mark.parametrize("dsg_on", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_reference(arch, dsg_on, built):
    (cfg, params, dsg), _ = built(arch, dsg_on)
    batch = japi.make_inputs(cfg, JSMOKE, concrete=True)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, dsg, cfg, batch)))(params)
    want = _leaves(jax.tree.map(np.asarray, grads))
    tcfg, model, tdsg = _port(cfg, params, dsg, trainable=True)
    named = dict(model.named_parameters())
    tloss = api.train_loss(model, tdsg, tcfg, _t(batch))
    got = _leaves(bridge.to_reference_tree(dict(zip(
        named, train.loss_grads(tloss, named)))))
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    assert set(got) == set(want)
    for path, g in want.items():
        tol = 1e-4 * float(np.abs(g).max())
        np.testing.assert_allclose(got[path].numpy(), g, rtol=0, atol=tol,
                                   err_msg=path)
    assert float(np.sum([np.sum(np.square(g)) for g in want.values()])) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_refresh_dsg_matches_reference(arch, built):
    (cfg, params, dsg), _ = built(arch)
    rng = np.random.default_rng(3)
    moved = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(a.dtype), params)
    want = japi.refresh_dsg(dsg, moved, cfg)
    tcfg, model, tdsg = _port(cfg, moved, dsg)
    got = api.refresh_dsg(tdsg, model, tcfg)
    assert set(got) == set(want) == set(tdsg)
    assert got["r"] is tdsg["r"]
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape and not got[k].requires_grad
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=0,
                                   atol=1e-5, err_msg=k)
    assert api.refresh_dsg(None, model, tcfg) is None
    # a fresh port init builds the same leaves at the same shapes
    gen = torch.Generator().manual_seed(0)
    fresh = api.init_model(tcfg, generator=gen, device="cpu")
    own = api.init_dsg(fresh, tcfg, generator=gen, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    off = tcfg.replace(dsg=tcfg.dsg._replace(enabled=False))
    assert api.init_dsg(fresh, off, generator=gen, device="cpu") is None


def test_serving_features_and_encdec_are_refused(built):
    for arch in ARCHS:
        _, (tcfg, model, tdsg) = built(arch)
        toks = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="decoder-family"):
            api.prefill(model, tdsg, tcfg, {"tokens": toks}, None,
                        collect_drs_scores=True)
        _, st = api.prefill(model, tdsg, tcfg, {"tokens": toks}, None)
        with pytest.raises(NotImplementedError, match="decoder-family"):
            api.decode_step(model, tdsg, tcfg, toks[:, :1], st, 4,
                            ffn_csr={"idx": None, "counts": None})
    assert api.make_cache(tcfg.replace(family="xlstm"), 2, 8,
                          device="cpu") is None
    # the encoder-decoder's cache is the decoder's: max_seq // dec_ratio
    # slots (tests/test_torch_encdec.py holds the family)
    enc = tcfg.replace(family="encdec", dec_ratio=4)
    cache = api.make_cache(enc, 2, 8, device="cpu")
    assert set(cache) == {"k", "v"}
    for t in cache.values():
        assert tuple(t.shape) == (enc.n_layers, 2, 2, enc.n_kv, enc.head_dim)
        assert t.dtype == torch.float32 and not bool(t.any())


# ---------------------------------------------------------------------------
# the reference's traps, copied
# ---------------------------------------------------------------------------

def test_zamba_decode_uses_the_prompt_length_ring(built):
    """zamba's prefill ignores the cache and returns K/V of the prompt's
    length P; decode then writes slot pos % P, so the first decode token
    overwrites position 0 (`repro/models/api.py:121-125`,
    `repro/models/recurrent.py:308-313`)."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built("zamba2-7b")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 12),
                                             dtype=np.int32)
    jcache = japi.make_cache(cfg, 2, 20)
    tcache = api.make_cache(tcfg, 2, 20, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape == (2, 2, 16, 4, 16)
    prefill, decode = _jitted(cfg)
    logits, state = prefill(params, dsg, {"tokens": jnp.asarray(toks)},
                            jcache)
    tl, tstate = api.prefill(model, tdsg, tcfg,
                             {"tokens": torch.from_numpy(toks).long()},
                             tcache)
    assert tuple(tstate["k"].shape) == state["k"].shape == (2, 2, 12, 4, 16)
    before = tstate["k"].clone()
    seq = toks
    for i in range(3):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        seq = np.concatenate([seq, tok], axis=1)
        logits, state = decode(params, dsg, jnp.asarray(tok), state,
                               jnp.int32(12 + i))
        tl, tstate = api.decode_step(model, tdsg, tcfg,
                                     torch.from_numpy(tok).long(), tstate,
                                     12 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(logits), **LOGITS)
        _assert_states(tstate, state)
    # slots 0-2 now hold positions 12-14; slots 3-11 the prompt's own
    assert not torch.equal(tstate["k"][:, :, :3], before[:, :, :3])
    assert torch.equal(tstate["k"][:, :, 3:], before[:, :, 3:])
    # the whole sequence in one forward still sees positions 0-2 (the
    # window of 16 reaches back to them): the ring's logits differ
    full, _ = recurrent.zamba_forward(model, tdsg, tcfg,
                                      torch.from_numpy(seq[:, :-1]).long(),
                                      last_only=True)
    assert not torch.allclose(full[:, -1], tl, atol=1e-3)


def test_zamba_shared_attention_keeps_f32_scores(built, monkeypatch):
    """zamba2_7b sets attn_bf16_scores, but the reference's shared
    attention passes no bf16_scores (`repro/models/recurrent.py:314-319`):
    the port keeps the f32 scores too."""
    assert configs.get_config("zamba2-7b").attn_bf16_scores
    _, (tcfg, model, tdsg) = built("zamba2-7b")
    seen = []
    direct = recurrent.attn.attend_direct

    def spy(*args, **kw):
        seen.append(kw.get("bf16_scores"))
        return direct(*args, **kw)
    monkeypatch.setattr(recurrent.attn, "attend_direct", spy)
    api.prefill(model, tdsg, tcfg.replace(attn_bf16_scores=True),
                {"tokens": torch.zeros((1, 4), dtype=torch.long)}, None)
    assert seen == [False] * 2


def test_xlstm_refuses_a_prefill_the_reference_cannot_chunk(built):
    """`mlstm_chunked` needs S % min(128, S) == 0: a 130-token prompt
    fails in both packages."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built("xlstm-350m")
    toks = np.zeros((1, 130), dtype=np.int32)
    with pytest.raises(AssertionError):
        japi.prefill(params, dsg, cfg, {"tokens": jnp.asarray(toks)}, None)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        api.prefill(model, tdsg, tcfg,
                    {"tokens": torch.from_numpy(toks).long()}, None)


def test_xlstm_decode_continues_prefill(built):
    """prefill(127) and one decode step give prefill(128)'s last logits
    (both take a single chunk, of 127 and of 128 tokens)."""
    _, (tcfg, model, tdsg) = built("xlstm-350m", dsg_on=False)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tcfg.vocab, (2, 128))).long()
    full, _ = api.prefill(model, tdsg, tcfg, {"tokens": toks}, None)
    _, st = api.prefill(model, tdsg, tcfg, {"tokens": toks[:, :127]}, None)
    step, _ = api.decode_step(model, tdsg, tcfg, toks[:, 127:], st, 127)
    np.testing.assert_allclose(step.numpy(), full.numpy(), rtol=0, atol=1e-4)
    assert torch.equal(step.argmax(-1), full.argmax(-1))


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dsg_on", [True, False])
@pytest.mark.parametrize("prompt", [12, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_streams_match_reference(arch, prompt, dsg_on, built):
    """`generate`'s greedy streams equal `repro.launch.serve.generate`'s,
    token for token; 24 is past zamba's smoke window of 16."""
    (cfg, params, dsg), (tcfg, model, tdsg) = built(arch, dsg_on)
    prompts = np.random.default_rng(prompt).integers(
        0, cfg.vocab, (2, prompt), dtype=np.int32)
    want = np.asarray(jserve.generate(cfg, params, dsg,
                                      jnp.asarray(prompts), 8))
    got = serve.generate(tcfg, model, tdsg, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_eight_step_run_follows_the_reference(arch):
    """The reference's trainer at seed 0 (`build_trainer`'s jitted step and
    refresh, driven as `train` drives them) against the port's `train` from
    the same bridged initialisation: losses within MAX_ULPS f32 ulps."""
    cfg = jconfigs.get_smoke_config(arch)
    cfg = cfg.replace(dsg=cfg.dsg._replace(refresh_every=REFRESH))
    acfg = jadamw.AdamWConfig(total_steps=STEPS,
                              warmup=min(20, STEPS // 5 + 1))
    state, step_fn, refresh_fn, _ = jtrain.build_trainer(
        cfg, make_local_mesh(), acfg, seed=0)
    init = (jax.tree.map(np.array, state["params"]),
            jax.tree.map(np.array, state["dsg"]))
    want = []
    for step in range(STEPS):
        state, metrics = step_fn(state, jsynthetic.batch_at(
            step, global_batch=BATCH, seq_len=SEQ, vocab=cfg.vocab, seed=0))
        want.append(float(metrics["loss"]))
        if int(state["opt"]["step"]) % REFRESH == 0:
            state = refresh_fn(state)
    tcfg, model, tdsg = _port(cfg, *init)
    _, hist, monitor = train.train(tcfg, steps=STEPS, global_batch=BATCH,
                                   seq_len=SEQ, seed=0, device="cpu",
                                   init=(model, tdsg))
    assert monitor.failures == []
    assert [h["refresh"] for h in hist] == [
        float((s + 1) % REFRESH == 0) for s in range(STEPS)]
    got = [h["loss"] for h in hist]
    ulps = [abs(g - w) / np.spacing(np.float32(w)) for g, w in zip(got, want)]
    print(f"[8-step run {arch}] losses {got}; f32 ulps from the "
          f"reference's {ulps}")
    assert max(ulps) <= MAX_ULPS, (got, want)
    assert got[-1] < got[0]


def _states(arch):
    """The reference's trainer state at seed 0 (f32 smoke model) and the
    port's on the same bridged values."""
    cfg = jconfigs.get_smoke_config(arch)
    key = jax.random.PRNGKey(0)
    params = japi.init_model(key, cfg)
    dsg = japi.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    jstate = {"params": params, "dsg": dsg,
              "opt": jadamw.init_opt(params, use_master=False)}
    tcfg, model, tdsg = _port(cfg, params, dsg)
    state, step_fn, _ = train.trainer_for(
        model, tdsg, tcfg, adamw.AdamWConfig(warmup=2, total_steps=4))
    return tcfg, jstate, state, step_fn


def _assert_trees_equal(got, want, prefix=""):
    assert set(got) == set(want), prefix
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=prefix + k)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_restore_across_the_packages(arch, tmp_path):
    """A reference checkpoint restores into the port's trainer, and the
    port's, after a step, into the reference's tree."""
    tcfg, jstate, state, step_fn = _states(arch)
    jstate["opt"]["step"] = jnp.int32(3)
    jstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, jstate["opt"]["m"])
    JCheckpointManager(str(tmp_path / "ref")).save(3, jstate,
                                                   meta={"step": 3})
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path / "ref")))
    restored, step, meta = ckpt.restore(state)
    assert step == 3 and meta == {"step": 3} and restored is state
    _assert_trees_equal(bridge.state_to_numpy(state["model"], state["dsg"],
                                              state["opt"]),
                        jax.tree.map(np.asarray, jstate))
    state, _ = step_fn(state, {k: v for k, v in _t(jsynthetic.batch_at(
        0, global_batch=2, seq_len=8, vocab=tcfg.vocab)).items()})
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path / "port")))
    ckpt.save_async(4, state, meta={"step": 4})
    ckpt.wait()
    back, step, _ = JCheckpointManager(str(tmp_path / "port")).restore(
        jstate)
    assert step == 4 and int(back["opt"]["step"]) == 4
    _assert_trees_equal(back, bridge.state_to_numpy(
        state["model"], state["dsg"], state["opt"]))


# ---------------------------------------------------------------------------
# the CLIs and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_the_batch_workload_and_refuses_mixed(arch, capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert tuple(out["tokens"].shape) == (2, 4)
    assert "[batch/dense on cpu] generated (2, 4)" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--device", "cpu", "--arch", arch,
                    "--workload", "mixed"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--workload mixed" in err and "ROADMAP.md §3" in err


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_refuses_the_recurrent_families(arch, built):
    _, (tcfg, model, tdsg) = built(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md §3"):
        ServingEngine(tcfg, model, tdsg, n_slots=2, max_seq=32)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_and_resumes(arch, tmp_path, capsys, caplog):
    tcfg = configs.get_smoke_config(arch)
    train.train(tcfg, steps=2, global_batch=2, seq_len=16, device="cpu",
                ckpt_dir=str(tmp_path), ckpt_every=2)
    with caplog.at_level(logging.INFO, logger="repro_torch.train"):
        train.main(["--smoke", "--device", "cpu", "--arch", arch, "--steps",
                    "4", "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path)])
    assert "resumed from step 2" in caplog.text
    assert "steps=2 first_loss=" in capsys.readouterr().out
