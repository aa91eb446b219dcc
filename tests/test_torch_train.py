"""The port's training path (`repro_torch.launch.train` and what it runs)
against `repro`'s on the same parameters, carried over with
`repro_torch.bridge`, on the CPU at smoke width (internlm2-1.8b's
smoke_config: 2 layers, d 64, F 256, DSG mask mode with the shared
threshold, block 64, f32).  The reference runs through its own functions,
each jitted once per module.

Tolerances (f32), each measured here and stated with its reason:
  * train_loss: rtol 1e-5 (measured: equal to the last bit).
  * gradients: every leaf within 1e-5 * max(1, max|g|) (measured: 7e-7 on
    the embedding, whose rows sum the most terms; 1e-7 elsewhere).
  * one AdamW step: the moments m, v and the error feedback rtol 2e-6
    (atol 1e-12 for zero gradients); grad_norm and lr rtol 1e-6.  The
    step's only differences are the global norm's summation order and the
    libm pow/cos of the schedule, a few f32 ulps, which reach the weights
    through the update lr * m_hat / sqrt(v_hat) of size up to lr = 1e-2:
    the f32 weights (params, master) rtol 2e-6 plus atol 1e-8, about ten
    ulps of the update (measured: 1.9e-9, two ulps, on a weight near 0).
    A bf16 parameter is its f32 master rounded, so it equals the
    reference's wherever the masters round alike: at most one bf16 ulp
    (2^-8 relative) apart.  With gradient compression each leaf's ternary
    scale is a sum over the leaf (3072 terms), which the reference's CPU
    reduction adds in another order than torch's: its rounding, about
    sqrt(n) f32 ulps (3e-6 relative), carries into the gradients, so
    grad_norm, m, v and the error feedback are held to rtol 1e-5 there,
    the feedback with an atol of 1e-5 x the scale, since a kept entry's
    feedback g - scale is a difference (measured: 3.0e-6 relative).
  * the 8-step free-running run (refresh every 4, batch 4 x seq 32, the
    reference's synthetic.batch_at): losses rtol 1e-6.  An f32 ulp of a
    loss near 6 is 4.8e-7 (8e-8 relative); the two packages sum the
    logsumexp over the vocabulary and the mean over tokens in different
    orders, about one ulp each, and the weights drift apart by the same
    few ulps a step, so 8 steps stay within 12 ulps (measured: 1.6e-7,
    2 ulps).  The DRS masks must be equal at every step and layer except
    groups whose reference score lies within EPS_SCORE * max(1, |thr|) of
    the shared threshold thr: the scores are sums of 64 relu'd products
    of magnitude ~1 whose inputs drift by the loss's few ulps, so 1e-4 is
    two orders above the drift.  The exclusions are counted and printed
    (measured: 1 of the 8 x 2 x 512 groups near the threshold, 0
    differing).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import mixed_traffic  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import drs as jdrs  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.serving import scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BATCH, SEQ, STEPS, REFRESH = 4, 32, 8, 4
EPS_SCORE = 1e-4
VARIANTS = ("mask", "gather_shared", "dense")


def _cfg(variant="mask"):
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    dsg = cfg.dsg._replace(refresh_every=REFRESH)
    if variant == "dense":
        dsg = dsg._replace(enabled=False)
    elif variant == "gather_shared":
        dsg = dsg._replace(mode="gather_shared")
    return cfg.replace(dsg=dsg)


def _init(cfg):
    """The reference's trainer initialisation at seed 0
    (`repro.launch.train.build_trainer`), as numpy trees."""
    key = jax.random.PRNGKey(0)
    params = japi.init_model(key, cfg)
    dsg = japi.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    return (jax.tree.map(np.asarray, params),
            None if dsg is None else jax.tree.map(np.asarray, dsg))


def _port(cfg, params, dsg, trainable=True):
    tcfg = bridge.config_from_jax(cfg)
    return (tcfg, bridge.model_from_jax(params, tcfg, device="cpu",
                                        trainable=trainable),
            bridge.dsg_from_jax(dsg, device="cpu"))


def _batch(step, vocab, batch=BATCH, seq=SEQ):
    return synthetic.batch_at(step, global_batch=batch, seq_len=seq,
                              vocab=vocab, seed=0)


def _jbatch(step, vocab):
    return jsynthetic.batch_at(step, global_batch=BATCH, seq_len=SEQ,
                               vocab=vocab, seed=0)


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
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


@pytest.fixture(scope="module")
def ref():
    """Per variant: cfg, numpy init, and the reference's loss and grads on
    batch 0 through one jitted value_and_grad."""
    out = {}
    for variant in VARIANTS:
        cfg = _cfg(variant)
        params, dsg = _init(cfg)
        fn = jax.jit(jax.value_and_grad(
            lambda p, d, b, cfg=cfg: japi.train_loss(p, d, cfg, b)))
        loss, grads = fn(params, dsg, _jbatch(0, cfg.vocab))
        out[variant] = (cfg, params, dsg, float(loss),
                        _leaves(jax.tree.map(np.asarray, grads)))
    return out


def _port_grads(model, dsg, tcfg, batch):
    params = dict(model.named_parameters())
    loss = api.train_loss(model, dsg, tcfg, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss, _leaves(bridge.to_reference_tree(dict(zip(params, grads))))


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_loss_and_every_gradient_match_reference(ref, variant):
    cfg, params, dsg, want_loss, want = ref[variant]
    tcfg, model, tdsg = _port(cfg, params, dsg)
    dl.swiglu_ffn.calls.update(dict.fromkeys(dl.FFN_MODES, 0))
    loss, got = _port_grads(model, tdsg, tcfg, _batch(0, cfg.vocab))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for path, g in want.items():
        tol = 1e-5 * max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[path].numpy(), g, rtol=0, atol=tol,
                                   err_msg=path)
    # every layer's FFN took the configured path, once in the forward and
    # once more in the remat recompute of the backward
    assert dl.swiglu_ffn.calls == dict(
        dict.fromkeys(dl.FFN_MODES, 0), **{variant: 2 * cfg.n_layers})


def _record_masks(monkeypatch):
    calls = []
    orig = dl.drs_group_mask

    def rec(x, state, cfg):
        m = orig(x, state, cfg)
        calls.append(m.clone())
        return m
    monkeypatch.setattr(dl, "drs_group_mask", rec)
    return calls


def test_remat_recomputes_the_forward_masks_and_grads(ref, monkeypatch):
    cfg, params, dsg, *_ = ref["mask"]
    tcfg, model, tdsg = _port(cfg, params, dsg)
    calls = _record_masks(monkeypatch)
    batch = _batch(0, cfg.vocab)
    _, with_remat = _port_grads(model, tdsg, tcfg, batch)
    n = cfg.n_layers
    assert len(calls) == 2 * n
    for l in range(n):       # the backward recomputes the layers in reverse
        assert torch.equal(calls[2 * n - 1 - l], calls[l])
    _, without = _port_grads(model, tdsg, tcfg.replace(remat=False), batch)
    assert len(calls) == 3 * n
    for path, g in with_remat.items():
        assert torch.equal(g, without[path]), path


def test_backward_is_sparse_in_the_dropped_groups(ref, monkeypatch):
    """The paper's Algorithm 1: a group every token dropped gets exactly
    zero gradient in its w_down rows and its w_gate/w_up columns."""
    cfg, params, dsg, *_ = ref["mask"]
    tcfg, model, tdsg = _port(cfg, params, dsg)
    calls = _record_masks(monkeypatch)
    _, grads = _port_grads(model, tdsg, tcfg, _batch(0, cfg.vocab, 1, 2))
    block, dropped = cfg.dsg.block, 0
    for l in range(cfg.n_layers):
        kept = calls[l].reshape(-1, calls[l].shape[-1]).amax(dim=0)
        for gidx in torch.nonzero(kept == 0).flatten().tolist():
            cols = slice(gidx * block, (gidx + 1) * block)
            assert not grads["layers/ffn/w_down"][l, cols].any()
            assert not grads["layers/ffn/w_gate"][l, :, cols].any()
            assert not grads["layers/ffn/w_up"][l, :, cols].any()
            dropped += 1
    assert dropped > 0


def _opt_case(dtype, mode):
    """Params, grads (from the smoke model's real loss), AdamW config and
    optional error feedback, as numpy trees in the reference's layout."""
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((64, 48)).astype(np.float32),
              "b": rng.standard_normal((48,)).astype(np.float32),
              "z": np.zeros((16,), np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 0.05).astype(np.float32)
             for k, v in params.items()}
    grads["z"][:] = 0.0                       # a leaf with no gradient
    if dtype != "f32":
        params = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                  for k, v in params.items()}
        grads = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                 for k, v in grads.items()}
    clip = 0.5 if mode == "clip" else 1e9
    acfg = dict(lr=1e-2, clip_norm=clip, warmup=3, total_steps=10)
    return params, grads, acfg


@pytest.mark.parametrize("mode", ["no_clip", "clip", "compress"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "bf16_no_master"])
def test_apply_updates_matches_reference(dtype, mode):
    params, grads, acfg = _opt_case(dtype, mode)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tp = {k: bridge.tensor(v) for k, v in params.items()}
    tg = {k: bridge.tensor(v) for k, v in grads.items()}
    use_master = dtype == "bf16"
    jopt = jadamw.init_opt(jp, use_master)
    topt = adamw.init_opt(tp, use_master)
    jerr = jcompress.init_feedback(jp)
    terr = compress.init_feedback(tp)
    rtol = 1e-5 if mode == "compress" else 2e-6
    for step in range(3):      # three steps: warm-up, then the schedule
        jgs, tgs = jg, tg
        if mode == "compress":
            jgs, jerr = jcompress.tree_compress_with_feedback(jg, jerr)
            tgs, terr = compress.tree_compress_with_feedback(tg, terr)
        jp, jopt, jm = jadamw.apply_updates(jp, jgs, jopt,
                                            jadamw.AdamWConfig(**acfg))
        tp, topt, tm = adamw.apply_updates(tp, tgs, topt,
                                           adamw.AdamWConfig(**acfg))
        assert topt["step"] == int(jopt["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]),
                                   rtol=1e-5 if mode == "compress" else 1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        if mode == "clip":
            assert float(jm["grad_norm"]) > acfg["clip_norm"]
        for key in ("m", "v", "master") if use_master else ("m", "v"):
            for k in params:
                np.testing.assert_allclose(
                    topt[key][k].numpy(), np.asarray(jopt[key][k]),
                    rtol=rtol, atol=1e-8 if key == "master" else 1e-12,
                    err_msg=f"{key}/{k}")
        for k in params:
            want = np.asarray(jp[k]).astype(np.float32)
            got = _np(tp[k])
            if dtype != "f32":
                assert tp[k].dtype == torch.bfloat16
                if use_master:
                    assert torch.equal(tp[k], topt["master"][k].bfloat16())
                np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=0)
            else:
                np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-8,
                                           err_msg=k)
        if mode == "compress":
            for k in params:
                # err = g - scale * code: the scale's rounding is absolute
                scale = float(np.abs(np.asarray(jgs[k])).max())
                np.testing.assert_allclose(terr[k].numpy(),
                                           np.asarray(jerr[k]), rtol=rtol,
                                           atol=rtol * scale)


def test_refresh_dsg_matches_reference(ref):
    cfg, params, dsg, *_ = ref["mask"]
    rng = np.random.default_rng(3)
    moved = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(a.dtype), params)
    want = jtransformer.refresh_dsg(dsg, moved, cfg)
    tcfg, model, tdsg = _port(cfg, moved, dsg)
    got = api.refresh_dsg(tdsg, model, tcfg)
    assert got["r"] is tdsg["r"]
    assert not got["fw"].requires_grad
    np.testing.assert_allclose(got["fw"].numpy(), np.asarray(want["fw"]),
                               rtol=0, atol=1e-5)
    assert api.refresh_dsg(None, model, tcfg) is None


def test_other_families_point_at_the_roadmap(ref):
    cfg, params, dsg, *_ = ref["mask"]
    tcfg, model, tdsg = _port(cfg, params, dsg)
    # every family of the reference trains; one that does not exist is
    # refused
    other = tcfg.replace(family="no-such-family")
    with pytest.raises(ValueError, match="unknown family"):
        api.train_loss(model, tdsg, other, _batch(0, cfg.vocab))
    with pytest.raises(ValueError, match="unknown family"):
        api.refresh_dsg(tdsg, model, other)


@pytest.fixture(scope="module")
def reference_run():
    """The reference's 8-step trainer at seed 0 (`build_trainer`'s jitted
    step and refresh, driven as `train` drives them), with each step's DRS
    scores (L, B, S, G) on the weights that step trains."""
    cfg = _cfg("mask")
    acfg = jadamw.AdamWConfig(total_steps=STEPS,
                              warmup=min(20, STEPS // 5 + 1))
    state, step_fn, refresh_fn, _ = jtrain.build_trainer(
        cfg, make_local_mesh(), acfg, seed=0)
    init = (jax.tree.map(np.asarray, state["params"]),
            jax.tree.map(np.asarray, state["dsg"]))
    scores_fn = jax.jit(lambda p, d, toks: jtransformer.forward(
        p, d, cfg, toks, collect_drs_scores=True)[3])
    losses, scores = [], []
    for step in range(STEPS):
        batch = _jbatch(step, cfg.vocab)
        scores.append(np.asarray(scores_fn(state["params"], state["dsg"],
                                           batch["tokens"])))
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if int(state["opt"]["step"]) % REFRESH == 0:
            state = refresh_fn(state)
    return cfg, init, losses, scores


def test_eight_step_run_follows_the_reference(reference_run, monkeypatch):
    cfg, (params, dsg), want_losses, ref_scores = reference_run
    tcfg, model, tdsg = _port(cfg, params, dsg, trainable=False)
    calls = _record_masks(monkeypatch)
    _, hist, monitor = train.train(tcfg, steps=STEPS, global_batch=BATCH,
                                   seq_len=SEQ, seed=0, device="cpu",
                                   init=(model, tdsg))
    assert [h["step"] for h in hist] == list(range(STEPS))
    assert monitor.failures == []
    assert [h["refresh"] for h in hist] == [
        float((s + 1) % REFRESH == 0) for s in range(STEPS)]
    np.testing.assert_allclose([h["loss"] for h in hist], want_losses,
                               rtol=1e-6)
    n = cfg.n_layers
    assert len(calls) == STEPS * 2 * n      # forward + remat recompute
    k = jdrs.keep_groups(cfg.d_ff, cfg.dsg.drs_cfg())
    near = differ = 0
    for step in range(STEPS):
        for l in range(n):
            got = calls[step * 2 * n + l].numpy()
            sc = ref_scores[step][l]                       # (B, S, G)
            thr = np.sort(sc.reshape(-1, sc.shape[-1])[0])[::-1][k - 1]
            want = (sc >= thr).astype(np.float32)
            close = np.abs(sc - thr) <= EPS_SCORE * max(1.0, abs(thr))
            close.reshape(-1, sc.shape[-1])[0] &= sc.reshape(
                -1, sc.shape[-1])[0] != thr     # the threshold's own group
            near += int(close.sum())
            bad = (got != want) & ~close
            differ += int((got != want).sum())
            assert not bad.any(), (step, l, np.argwhere(bad))
    print(f"[8-step run] masks: {differ} groups differ, {near} of "
          f"{STEPS * n * BATCH * SEQ * sc.shape[-1]} lie within the "
          f"threshold's "
          f"epsilon and are excluded")


def test_trained_model_serves_the_streams_of_its_weights_bridged_fresh(ref):
    """A model out of the trainer (parameters requiring grad) serves the
    same greedy streams as the same weights bridged into a fresh model,
    and the serving calls record no autograd."""
    cfg, params, dsg, *_ = ref["mask"]
    cfg = cfg.replace(dsg=cfg.dsg._replace(threshold_mode="topk"))
    tcfg, model, tdsg = _port(cfg, params, dsg, trainable=False)
    state, _, _ = train.train(tcfg, steps=2, global_batch=BATCH,
                              seq_len=SEQ, device="cpu", init=(model, tdsg))
    assert all(p.requires_grad for p in model.parameters())
    tree = bridge.state_to_numpy(model, state["dsg"], state["opt"])
    fresh = bridge.model_from_jax(tree["params"], tcfg, device="cpu")
    fresh_dsg = bridge.dsg_from_jax(tree["dsg"], device="cpu")
    assert not any(p.requires_grad for p in fresh.parameters())

    def streams(m, d):
        eng = scheduler.ServingEngine(tcfg, m, d, n_slots=2, max_seq=64,
                                      prompt_bucket=32,
                                      cache_backend="paged", page_size=8)
        for r in mixed_traffic(cfg):
            eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                         max_new=r.max_new))
        done = eng.run(400)
        assert all(r.status == "ok" for r in done.values())
        return {u: list(r.output) for u, r in done.items()}

    assert streams(model, state["dsg"]) == streams(fresh, fresh_dsg)
    cache = api.make_cache(tcfg, 1, 16, device="cpu")
    logits, cache = api.prefill(model, state["dsg"], tcfg,
                                {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                                cache)
    assert not logits.requires_grad and not cache["k"].requires_grad


def test_checkpointed_run_resumes_where_it_stopped(ref, tmp_path):
    cfg, params, dsg, *_ = ref["mask"]
    tcfg = bridge.config_from_jax(cfg)

    def run(steps):
        _, m, d = _port(cfg, params, dsg, trainable=False)
        return train.train(tcfg, steps=steps, global_batch=BATCH,
                           seq_len=SEQ, device="cpu", init=(m, d),
                           ckpt_dir=str(tmp_path), ckpt_every=2)
    state4, hist4, _ = run(4)
    assert [h["step"] for h in hist4] == [0, 1, 2, 3]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2", "step_4"]
    state6, hist6, _ = run(6)
    assert [h["step"] for h in hist6] == [4, 5]     # resumed at step 4
    assert state6["opt"]["step"] == 6


def test_cli_trains_the_smoke_model_on_the_cpu(capsys):
    train.main(["--smoke", "--device", "cpu", "--steps", "4", "--batch",
                "2", "--seq", "16", "--grad-compress"])
    out = capsys.readouterr().out
    assert "steps=4 first_loss=" in out and "stragglers=" in out


@pytest.mark.parametrize("flags,says", [
    (["--production-mesh", "--arch", "xlstm-350m"], "ROADMAP"),
    (["--steps", "0"], "--steps"),
    (["--batch", "0"], "--batch"), (["--arch", "whisper-large-v3"], "ROADMAP.md §3"),
    (["--steps", "x"], "invalid int")])
def test_cli_rejects_bad_flags(flags, says, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--smoke", "--device", "cpu"] + flags)
    assert exc.value.code != 0
    assert says in capsys.readouterr().err


def test_cli_needs_a_gpu_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "1"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
