"""The port's serving engine on the MoE and VLM families against the
reference's, on the same parameters and traffic, on the CPU at smoke width
(f32): deepseek-moe-16b (4 experts, top-2, one shared expert) and
llava-next-34b served through `ServingEngine` exactly as the dense family
is, greedy streams identical to `harness.run_and_collect`'s over
`harness.mixed_traffic` (6 requests through 2 slots), for the dense and
paged backends, chunks 1 and 8, DSG on (mask mode, per-row top-k) and off.

An MoE lane's output depends on its co-resident lanes (expert capacity is
shared by the batch, and idle lanes feed the donor's duplicates), so the
streams are compared at one chunk size at a time: the port and the
reference admit at the same steps, and the batch at every step is the
same.  The DRS threshold is the serving tests' per-row top-k: with the
config's shared threshold, the left-padded bucket's pad rows are near
duplicates of row 0, whose groups then sit at the threshold and are
decided by rounding (ROADMAP.md §3).

Also: `dsg_serving` is refused for an MoE as the reference refuses it; the
paged backend refuses a family outside the decoder families; the serve and
train CLIs run the MoE smoke model; an MoE trainer's checkpoint (the
router, the experts, `fw_experts`, `fw_shared` and AdamW's moments) moves
between the two packages leaf for leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import (engine_spec, make_engine_parts, mixed_traffic,  # noqa: E402
                     run_and_collect)
from repro.ckpt.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.serving.dsg_runtime import DSGServingConfig as JDSGServing  # noqa: E402
from repro.serving.scheduler import ServingEngine as JEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import kv_cache  # noqa: E402
from repro_torch.serving.dsg_runtime import DSGServingConfig  # noqa: E402
from repro_torch.serving.scheduler import ServingEngine  # noqa: E402
from torch_port_harness import port_run  # noqa: E402

ARCHS = ("deepseek-moe-16b", "llava-next-34b")


@pytest.fixture(scope="module")
def parts():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg, params, dsg = make_engine_parts(arch)
            tcfg = bridge.config_from_jax(cfg)
            model = bridge.model_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg, device="cpu")
            tdsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, dsg),
                                       device="cpu")
            cache[arch] = (cfg, params, dsg), (tcfg, model, tdsg)
        return cache[arch]

    return get


@pytest.mark.parametrize("dsg_on", [True, False], ids=["dsg", "no_dsg"])
@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_identical_to_reference(parts, arch, backend, chunk,
                                               dsg_on):
    (cfg, params, dsg), (tcfg, model, tdsg) = parts(arch)
    assert cfg.dsg.threshold_mode == "topk" and cfg.dsg.mode == "mask"
    kw = dict(cache_backend=backend, decode_chunk=chunk)
    if backend == "paged":
        kw["page_size"] = 8
    want = run_and_collect(
        engine_spec(cfg, params, dsg if dsg_on else None, **kw),
        mixed_traffic(cfg))
    got = port_run(engine_spec(tcfg, model, tdsg if dsg_on else None, **kw),
                   mixed_traffic(cfg))
    assert got == want


def test_dsg_serving_is_refused_for_moe(parts):
    (cfg, params, dsg), (tcfg, model, tdsg) = parts("deepseek-moe-16b")
    with pytest.raises(ValueError, match="dense SwiGLU FFN family") as ref:
        JEngine(cfg, params, dsg, dsg_serving=JDSGServing())
    with pytest.raises(ValueError, match="dense SwiGLU FFN family") as got:
        ServingEngine(tcfg, model, tdsg, dsg_serving=DSGServingConfig())
    assert str(got.value) == str(ref.value)
    # the VLM's FFN is the dense SwiGLU: its DSG serving runs
    _, (vcfg, vmodel, vdsg) = parts("llava-next-34b")
    ServingEngine(vcfg, vmodel, vdsg, n_slots=2, max_seq=64,
                  dsg_serving=DSGServingConfig())


def test_paged_backend_refuses_other_families(parts):
    _, (tcfg, _, _) = parts("deepseek-moe-16b")
    with pytest.raises(NotImplementedError, match="decoder families"):
        kv_cache.PagedBackend(page_size=8).make(
            tcfg.replace(family="zamba"), 2, 64, "cpu")


def test_serve_cli_serves_moe_on_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--arch", "deepseek-moe-16b",
                "--workload", "mixed", "--requests", "3",
                "--cache-backend", "paged", "--decode-chunk", "4"])
    assert "3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="dense SwiGLU FFN family"):
        serve.main(["--smoke", "--device", "cpu", "--arch",
                    "deepseek-moe-16b", "--workload", "mixed",
                    "--requests", "2", "--dsg-serving"])


def test_train_cli_takes_the_moe_aux_loss(capsys):
    train.main(["--smoke", "--device", "cpu", "--arch", "deepseek-moe-16b",
                "--steps", "2", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    first = float(out.split("first_loss=")[1].split()[0])
    assert np.isfinite(first)


def _assert_trees_equal(got, want, prefix=""):
    assert set(got) == set(want), prefix
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v, f"{prefix}{k}/")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=prefix + k)


def test_moe_checkpoint_round_trips_with_the_reference(parts, tmp_path):
    """The reference's deepseek-moe-16b smoke trainer state restores into
    the port's trainer leaf for leaf, and the port's state after one step
    restores into the reference's tree."""
    (cfg, params, dsg), (tcfg, _, tdsg) = parts("deepseek-moe-16b")
    jstate = {"params": params, "dsg": dsg,
              "opt": jadamw.init_opt(params, use_master=False)}
    assert set(dsg) == {"r", "fw_experts", "fw_shared"}
    jstate["opt"]["step"] = jnp.int32(3)
    jstate["opt"]["m"] = jax.tree.map(lambda a: a + 0.5, jstate["opt"]["m"])
    JCheckpointManager(str(tmp_path / "ref")).save(3, jstate,
                                                   meta={"step": 3})
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = {k: v.clone() for k, v in tdsg.items()}
    state, step_fn, _ = train.trainer_for(
        model, tdsg, tcfg, adamw.AdamWConfig(warmup=2, total_steps=4))
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path / "ref")))
    restored, step, _ = ckpt.restore(state)
    assert step == 3 and restored is state
    _assert_trees_equal(bridge.state_to_numpy(state["model"], state["dsg"],
                                              state["opt"]),
                        jax.tree.map(np.asarray, jstate))
    state, _ = step_fn(state, synthetic.batch_at(
        0, global_batch=2, seq_len=8, vocab=cfg.vocab))
    ckpt = train.TrainCheckpoint(CheckpointManager(str(tmp_path / "port")))
    ckpt.save_async(4, state, meta={"step": 4})
    ckpt.wait()
    back, step, _ = JCheckpointManager(str(tmp_path / "port")).restore(jstate)
    assert step == 4 and int(back["opt"]["step"]) == 4
    _assert_trees_equal(back, bridge.state_to_numpy(
        state["model"], state["dsg"], state["opt"]))
