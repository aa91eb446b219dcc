"""The port's training substrate against the reference's, on the CPU:
AdamW (`repro_torch.optim.adamw`), ternary gradient compression
(`optim.compress`), the synthetic data (`data.synthetic`), checkpoints
(`ckpt.manager`) and the restart loop (`runtime.fault_tolerance`).

Mirrors the reference's `tests/test_substrate.py` (optimizer, compression,
data and checkpoint tests; its ZeRO-1, elastic and sharding-spec tests are
mirrored in `tests/test_torch_specs.py`) and the training half of
`tests/test_runtime_fault_tolerance.py`, and adds parity: the learning
rate schedule equals the reference's f32 values (rtol 1e-6: the libm cos
and pow differ by an ulp at most), ternary codes equal and scales agree to
rtol 1e-6 (a sum over the leaf in another order), synthetic batches are
equal bit for bit, and a checkpoint either package writes restores in the
other with equal arrays.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import adamw, compress  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultInjector, InjectedFault, StragglerMonitor, run_with_restarts)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup=1,
                            total_steps=200, schedule="const")
    w = torch.tensor([5.0, -3.0, 2.0], requires_grad=True)
    params = {"w": w}
    opt = adamw.init_opt(params, use_master=False)
    target = torch.ones(3)
    for _ in range(200):
        (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
        adamw.apply_updates(params, {"w": g}, opt, cfg)
    np.testing.assert_allclose(w.detach().numpy(), target.numpy(), atol=1e-2)


def test_grad_clipping():
    cfg = adamw.AdamWConfig(clip_norm=1.0, warmup=1)
    params = {"w": torch.zeros(4)}
    opt = adamw.init_opt(params, False)
    _, _, m = adamw.apply_updates(params, {"w": torch.full((4,), 100.0)},
                                  opt, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_lr_schedule_shapes():
    cfg = adamw.AdamWConfig(lr=1.0, warmup=10, total_steps=100,
                            schedule="cosine")
    assert float(adamw.lr_at(cfg, 0)) < 0.2
    assert float(adamw.lr_at(cfg, 10)) == pytest.approx(1.0, abs=0.05)
    assert float(adamw.lr_at(cfg, 100)) < 0.01


@pytest.mark.parametrize("schedule", ["cosine", "linear", "const"])
def test_lr_at_equals_the_reference_in_f32(schedule):
    cfg = dict(lr=3e-4, warmup=7, total_steps=50, schedule=schedule)
    for step in range(0, 60):
        got = adamw.lr_at(adamw.AdamWConfig(**cfg), step)
        want = jadamw.lr_at(jadamw.AdamWConfig(**cfg), step)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_master_weights_bf16():
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    opt = adamw.init_opt(params, use_master=True)
    assert opt["master"]["w"].dtype == torch.float32
    cfg = adamw.AdamWConfig(lr=1e-3, warmup=1)
    g = {"w": torch.full((8,), 1e-4, dtype=torch.bfloat16)}
    # tiny updates accumulate in the f32 master even where bf16 cannot
    for _ in range(10):
        adamw.apply_updates(params, g, opt, cfg)
    assert float((opt["master"]["w"] - 1.0).abs().max()) > 0
    assert params["w"].dtype == torch.bfloat16


def test_global_norm_of_a_mixed_tree():
    tree = {"a": torch.full((3,), 2.0, dtype=torch.bfloat16),
            "b": torch.tensor([[3.0, 4.0]])}
    assert float(adamw.global_norm(tree)) == pytest.approx(np.sqrt(37.0))


# ---------------------------------------------------------------------------
# ternary gradient compression
# ---------------------------------------------------------------------------

def test_ternarize_codes():
    codes, scale = compress.ternarize(
        torch.tensor([3.0, -2.5, 0.01, 0.0, 5.0]))
    assert set(torch.unique(codes).tolist()) <= {-1.0, 0.0, 1.0}
    assert float(scale) > 0


@pytest.mark.parametrize("frac", [0.3, 0.7, 1.5])
def test_ternarize_equals_the_reference(frac):
    g = np.random.default_rng(1).standard_normal((33, 17)).astype(np.float32)
    codes, scale = compress.ternarize(torch.from_numpy(g), frac)
    jc, js = jcompress.ternarize(jnp.asarray(g), frac)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(scale), float(js), rtol=1e-6)


def test_error_feedback_telescopes():
    """The decoded sum over steps misses the true sum by exactly the
    final error buffer."""
    gs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (50, 64)).astype(np.float32))
    err = torch.zeros(64)
    decoded_sum = torch.zeros(64)
    for i in range(50):
        dec, err = compress.compress_with_feedback(gs[i], err)
        decoded_sum += dec
    np.testing.assert_allclose((gs.sum(0) - decoded_sum).numpy(),
                               err.numpy(), rtol=1e-4, atol=1e-4)


def test_compressed_sgd_converges():
    w = torch.tensor([4.0, -4.0])
    err = torch.zeros(2)
    for _ in range(300):
        dec, err = compress.compress_with_feedback(2 * w, err)
        w = w - 0.05 * dec
    assert float(w.abs().max()) < 0.1


def test_wire_bytes_reduction():
    g = torch.zeros(1024)
    assert compress.wire_bytes(g) < g.numel() * 4 / 10
    assert compress.wire_bytes(g) == jcompress.wire_bytes(jnp.zeros(1024))


def test_tree_compress_keeps_dtypes_and_feedback_is_f32():
    grads = {"a": torch.randn(8, dtype=torch.float32),
             "b": torch.randn(4, 4).to(torch.bfloat16)}
    errs = compress.init_feedback(grads)
    dec, new = compress.tree_compress_with_feedback(grads, errs)
    assert dec["a"].dtype == torch.float32 and dec["b"].dtype == torch.bfloat16
    assert all(e.dtype == torch.float32 for e in new.values())


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic():
    a = synthetic.batch_at(7, global_batch=4, seq_len=16, vocab=100)
    b = synthetic.batch_at(7, global_batch=4, seq_len=16, vocab=100)
    assert torch.equal(a["tokens"], b["tokens"])


def test_data_labels_are_shifted():
    b = synthetic.batch_at(0, global_batch=2, seq_len=32, vocab=50)
    assert b["tokens"].shape == (2, 32) and b["labels"].shape == (2, 32)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_hosts_disjoint():
    h0 = synthetic.batch_at(3, global_batch=8, seq_len=16, vocab=1000,
                            host_index=0, host_count=2)
    h1 = synthetic.batch_at(3, global_batch=8, seq_len=16, vocab=1000,
                            host_index=1, host_count=2)
    assert h0["tokens"].shape == (4, 16)
    assert not torch.equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="host_count"):
        synthetic.batch_at(0, global_batch=5, seq_len=4, vocab=9,
                           host_count=2)


@settings(max_examples=10, deadline=None)
@given(step=st.integers(0, 1000), seed=st.integers(0, 100))
def test_data_in_vocab(step, seed):
    b = synthetic.batch_at(step, global_batch=2, seq_len=8, vocab=37,
                           seed=seed)
    assert int(b["tokens"].max()) < 37 and int(b["tokens"].min()) >= 0


@settings(max_examples=30, deadline=None)
@given(step=st.integers(0, 10_000), seed=st.integers(0, 2**31 - 1),
       host=st.integers(0, 3), seq=st.sampled_from([1, 8, 63, 64, 256]))
def test_batches_equal_the_reference_bit_for_bit(step, seed, host, seq):
    kw = dict(global_batch=8, seq_len=seq, vocab=92544, host_index=host,
              host_count=4, seed=seed, extras={"img": (3, 2)})
    got = synthetic.batch_at(step, **kw)
    want = jsynthetic.batch_at(step, **kw)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].numpy().dtype == w.dtype
        assert got[k].numpy().tobytes() == w.tobytes(), k


def test_stream_walks_the_steps():
    s = synthetic.stream(5, global_batch=2, seq_len=4, vocab=11)
    for step in (5, 6, 7):
        assert torch.equal(next(s)["tokens"], synthetic.batch_at(
            step, global_batch=2, seq_len=4, vocab=11)["tokens"])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"step": torch.tensor(5, dtype=torch.int32),
                    "m": [torch.ones(4)]}}


def test_ckpt_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save(10, t, meta={"note": "x"})
    restored, step, meta = mgr.restore(t)
    assert step == 10 and meta["note"] == "x"
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    assert isinstance(restored["opt"]["m"], list)
    assert int(restored["opt"]["step"]) == 5


def test_ckpt_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.latest_step() == 4
    assert mgr.steps() == [3, 4]


def test_ckpt_ignores_partial_writes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_2.tmp")        # a crash mid-write
    (tmp_path / "step_2.tmp" / "arrays.npz").write_bytes(b"garbage")
    assert mgr.latest_step() == 1


def test_ckpt_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    bad = _tree()
    bad["params"]["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError):
        mgr.restore(bad)
    bad = _tree()
    bad["params"]["u"] = torch.zeros(2)
    with pytest.raises(KeyError):
        mgr.restore(bad)


def test_ckpt_async_snapshots_before_returning(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    mgr.save_async(7, t)
    t["params"]["w"].fill_(-1.0)      # written after save_async returned
    mgr.wait()
    assert mgr.latest_step() == 7
    restored, _, _ = mgr.restore(_tree())
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])


def test_ckpt_restore_waits_for_an_inflight_write(tmp_path, monkeypatch):
    """A restore right after save_async sees that checkpoint, however long
    the write takes (the restart loop restores right after a crash)."""
    from repro_torch.ckpt import manager
    savez = manager.np.savez

    def slow_savez(*args, **kwargs):
        threading.Event().wait(0.3)
        return savez(*args, **kwargs)
    monkeypatch.setattr(manager.np, "savez", slow_savez)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, _tree())
    restored, step, _ = mgr.restore(_tree())
    assert step == 2
    assert torch.equal(restored["params"]["w"], _tree()["params"]["w"])


def test_ckpt_stores_bf16_as_uint16_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.randn(5, 3).to(torch.bfloat16)
    mgr.save(1, {"w": w})
    with np.load(tmp_path / "step_1" / "arrays.npz") as z:
        assert z["w"].dtype == np.uint16
    import json
    manifest = json.loads((tmp_path / "step_1" / "manifest.json").read_text())
    assert manifest["arrays"]["w"] == {"shape": [5, 3], "dtype": "bfloat16"}
    restored, _, _ = mgr.restore({"w": w})
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], w)


def _smoke_states():
    """The reference's trainer state at seed 0 (f32 smoke model) and the
    port's on the same bridged values."""
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    key = jax.random.PRNGKey(0)
    params = japi.init_model(key, cfg)
    dsg = japi.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    jstate = {"params": params, "dsg": dsg,
              "opt": jadamw.init_opt(params, use_master=False)}
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, dsg), device="cpu")
    state, step_fn, _ = train.trainer_for(
        model, tdsg, tcfg, adamw.AdamWConfig(warmup=2, total_steps=4))
    return cfg, tcfg, jstate, state, step_fn


def _assert_trees_equal(got, want, prefix=""):
    assert set(got) == set(want), prefix
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=prefix + k)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    _, _, jstate, state, _ = _smoke_states()
    jstate["opt"]["step"] = jnp.int32(3)
    jstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, jstate["opt"]["m"])
    JCheckpointManager(str(tmp_path)).save(3, jstate, meta={"step": 3})
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path)))
    restored, step, meta = ckpt.restore(state)
    assert step == 3 and meta == {"step": 3} and restored is state
    _assert_trees_equal(bridge.state_to_numpy(state["model"], state["dsg"],
                                              state["opt"]),
                        jax.tree.map(np.asarray, jstate))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, _, jstate, state, step_fn = _smoke_states()
    state, _ = step_fn(state, synthetic.batch_at(
        0, global_batch=2, seq_len=8, vocab=cfg.vocab))
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path)))
    ckpt.save_async(1, state, meta={"step": 1})
    ckpt.wait()
    restored, step, meta = JCheckpointManager(str(tmp_path)).restore(jstate)
    assert step == 1 and meta == {"step": 1}
    _assert_trees_equal(restored, bridge.state_to_numpy(
        state["model"], state["dsg"], state["opt"]))
    assert int(restored["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# fault tolerance and stragglers
# ---------------------------------------------------------------------------

def test_run_with_restarts_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def step_fn(st, batch):
        return {"x": st["x"] + 1.0}, {"loss": st["x"]}

    monitor = StragglerMonitor()
    state, hist = run_with_restarts(
        step_fn=step_fn, state={"x": torch.tensor(0.0)},
        make_batch=lambda s: None, ckpt=mgr, total_steps=20, ckpt_every=5,
        injector=FaultInjector(fail_at=(7, 13)), monitor=monitor)
    assert float(state["x"]) == 20.0           # the replay is exact
    assert len(hist) >= 20
    assert [s for s, _ in monitor.failures] == [7, 13]


def test_run_with_restarts_gives_up():
    def bad(st, batch):
        raise RuntimeError("always")

    with pytest.raises(RuntimeError):
        run_with_restarts(step_fn=bad, state={}, make_batch=lambda s: None,
                          ckpt=None, total_steps=3, max_retries=2)


def test_straggler_detection():
    mon = StragglerMonitor(window=16, factor=1.5)
    for i in range(10):
        mon.record(i, 1.0)
    assert mon.record(10, 2.0) is True
    assert mon.record(11, 1.05) is False
    assert len(mon.flagged) == 1


def test_straggler_monitor_flags_injected_delays():
    mon = StragglerMonitor(window=16, factor=1.5)
    delayed = {12, 17}
    for step in range(20):
        assert mon.record(step, 0.35 if step in delayed else 0.10) == (
            step in delayed)
    assert [f[0] for f in mon.flagged] == sorted(delayed)
    for _, seconds, median in mon.flagged:
        assert seconds > 1.5 * median


def test_straggler_monitor_needs_history():
    mon = StragglerMonitor()
    assert not mon.record(0, 100.0)
    for step in range(1, 8):
        mon.record(step, 0.1)
    assert mon.record(8, 100.0)


def test_straggler_monitor_rolling_window():
    mon = StragglerMonitor(window=8, factor=1.5)
    for step in range(8):
        mon.record(step, 0.1)
    assert mon.record(8, 0.3)
    for step in range(9, 17):
        mon.record(step, 0.3)
    assert not mon.record(17, 0.3)


def test_fault_injector_fires_exactly_once_per_step():
    inj = FaultInjector(fail_at=(3,))
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                  # the replay after a restore
    inj.maybe_fail(4)
    with pytest.raises(InjectedFault):
        FaultInjector(fail_at=(0,), exc=InjectedFault).maybe_fail(0)


def test_run_with_restarts_restore_is_bit_exact(tmp_path):
    """A run that crashes at step 30 and restores the step-20 checkpoint
    replays 20..29 and lands bit-identical to a run without the fault."""
    def step_fn(state, batch):
        s = state["x"] * 1.000001 + batch
        return {"x": s}, {"loss": float(s.sum())}

    def make_batch(step):
        return torch.full((4,), float(step), dtype=torch.float64)

    zeros = lambda: {"x": torch.zeros(4, dtype=torch.float64)}  # noqa: E731
    clean, _ = run_with_restarts(step_fn=step_fn, state=zeros(),
                                 make_batch=make_batch, ckpt=None,
                                 total_steps=40)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mid, _ = run_with_restarts(step_fn=step_fn, state=zeros(),
                               make_batch=make_batch, ckpt=mgr,
                               total_steps=20, ckpt_every=20)
    faulty, hist = run_with_restarts(
        step_fn=step_fn, state=mid, make_batch=make_batch, ckpt=mgr,
        total_steps=40, start_step=20, ckpt_every=1000,
        injector=FaultInjector(fail_at=(30,)))
    assert torch.equal(clean["x"], faulty["x"])
    assert [h["step"] for h in hist].count(25) == 2


def test_run_with_restarts_exhausts_retries():
    calls = []

    def bad(state, batch):
        calls.append(batch)
        raise ValueError("persistent")

    monitor = StragglerMonitor()
    with pytest.raises(ValueError, match="persistent"):
        run_with_restarts(step_fn=bad, state={}, make_batch=lambda s: s,
                          ckpt=None, total_steps=4, max_retries=2,
                          monitor=monitor)
    assert len(calls) == 3             # the first try + 2 retries
    assert len(monitor.failures) == 3
    with pytest.raises(OSError):       # the injector's exception type
        run_with_restarts(step_fn=lambda s, b: (s, {}), state={},
                          make_batch=lambda s: s, ckpt=None, total_steps=4,
                          max_retries=0,
                          injector=FaultInjector(fail_at=(2,), exc=OSError))


def test_trainer_restarts_from_its_checkpoint_bit_exact(tmp_path):
    """The port's trainer under a FaultInjector: a crash at step 3 with a
    checkpoint every 2 steps restores step 2 and ends bit-identical to a
    run with no fault."""
    cfg = jconfigs.get_smoke_config("internlm2-1.8b")
    tcfg = bridge.config_from_jax(cfg)
    kw = dict(steps=5, global_batch=2, seq_len=8, device="cpu")
    clean, _, _ = train.train(tcfg, **kw)
    faulty, hist, monitor = train.train(
        tcfg, ckpt_dir=str(tmp_path), ckpt_every=2,
        injector=FaultInjector(fail_at=(3,)), **kw)
    assert [s for s, _ in monitor.failures] == [3]
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3, 4]
    for (n, a), (_, b) in zip(clean["model"].named_parameters(),
                              faulty["model"].named_parameters()):
        assert torch.equal(a, b), n
    assert torch.equal(clean["dsg"]["fw"], faulty["dsg"]["fw"])


def test_opt_from_jax_carries_the_reference_adamw_state():
    """The reference's AdamW state after a step, carried into the port,
    lays out again as the reference's tree, leaf for leaf."""
    cfg = jconfigs.get_smoke_config("internlm2-1.8b").replace(
        dtype="bfloat16")
    params = japi.init_model(jax.random.PRNGKey(0), cfg)
    opt = jadamw.init_opt(params, use_master=True)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = jadamw.apply_updates(params, grads, opt,
                                          jadamw.AdamWConfig(warmup=1))
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    topt = bridge.opt_from_jax(jax.tree.map(np.asarray, opt), model,
                               device="cpu")
    assert topt["step"] == 1 and set(topt) == {"step", "m", "v", "master"}
    tree = bridge.state_to_numpy(model, None, topt)
    assert "dsg" not in tree
    _assert_trees_equal(tree["opt"], jax.tree.map(
        lambda a: np.asarray(a, np.float32), opt))
    _assert_trees_equal(tree["params"], jax.tree.map(
        lambda a: np.asarray(a, np.float32), params))
