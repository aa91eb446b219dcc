"""The port's serving engine (`repro_torch.serving`) against the reference's
on the same parameters and traffic, on the CPU at smoke width, and the
port's `python -m repro_torch.launch.serve` entry point.

Greedy streams must be identical, token for token, over
`harness.mixed_traffic` (seed 23, 6 requests through 2 slots, so lanes
retire and are re-admitted) with the paged backend (page 8, max_seq 64):
with the DSG serving runtime (refresh every 2 tokens; the reference runs
its Pallas kernels in interpret mode) and with DSG off.
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

from harness import (engine_spec, make_engine_parts, mixed_traffic,  # noqa: E402
                     run_and_collect)
from repro.serving.dsg_runtime import DSGServingConfig as JDSGServing  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import dsg_runtime, kv_cache, scheduler  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ENGINE = dict(n_slots=2, max_seq=64, prompt_bucket=32, page_size=8)


def _port_streams(cfg, params, dsg, dsg_serving):
    tcfg = bridge.config_from_jax(cfg).replace(paged_attn_kernel="auto",
                                               dsg_ffn_apply="auto")
    eng = scheduler.ServingEngine(
        tcfg, bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg),
        bridge.dsg_from_jax(None if dsg is None
                            else jax.tree.map(np.asarray, dsg)),
        cache_backend="paged", dsg_serving=dsg_serving, **ENGINE)
    reqs = mixed_traffic(cfg)
    for r in reqs:
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new))
    done = eng.run(400)
    assert len(done) == len(reqs)
    assert all(r.status == "ok" for r in done.values())
    return {u: list(r.output) for u, r in done.items()}, eng


@pytest.mark.parametrize("dsg_on", [True, False], ids=["dsg", "no_dsg"])
def test_engine_streams_identical_to_reference(dsg_on):
    cfg, params, dsg = make_engine_parts()
    cfg = cfg.replace(paged_attn_kernel="kernel", dsg_ffn_apply="kernel")
    if not dsg_on:
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
        dsg = None
    want = run_and_collect(
        engine_spec(cfg, params, dsg, cache_backend="paged", page_size=8,
                    dsg_serving=JDSGServing(refresh_interval=2)
                    if dsg_on else None),
        mixed_traffic(cfg))
    got, eng = _port_streams(
        cfg, params, dsg,
        dsg_runtime.DSGServingConfig(refresh_interval=2) if dsg_on else None)
    assert got == want
    assert eng.admissions == 6 > ENGINE["n_slots"]     # retire and readmit
    assert eng.backend.allocator.live_pages == 0       # every page returned
    if dsg_on:
        assert eng.refresh_steps > 0


def test_request_refuses_sampling():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        scheduler.Request(uid=0, prompt=np.zeros(4, np.int32),
                          temperature=0.7)


def test_bucket_and_page_bounds():
    assert scheduler.bucket_sizes(32, 64) == (16, 32)
    assert scheduler.bucket_sizes(256, 64) == (16, 32, 63)
    assert [scheduler.live_page_bound(p, 8, 8) for p in (0, 7, 8, 24, 63)] \
        == [1, 1, 2, 4, 8]


def test_allocator_refcounts_and_pool_gating():
    a = kv_cache.BlockAllocator(4, reserved=1)
    pages = a.alloc(2)
    a.share(pages[0])
    a.free(pages)
    assert a.live_pages == 1 and a.refcount(pages[0]) == 1
    with pytest.raises(kv_cache.OutOfPages):
        a.alloc(3)
    with pytest.raises(ValueError):
        a.free([pages[1]])


def test_serve_cli_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--workload", "mixed", "--requests", "4",
         "--cache-backend", "paged", "--dsg-serving"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                       "OMP_NUM_THREADS": "1"},       # one thread, as above
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "4 requests" in out.stdout and "on cpu" in out.stdout


def test_serve_cli_needs_a_gpu_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--requests", "1"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("flag,says", [
    (["--replicas", "2"], "ROADMAP"), (["--decode-chunk", "8"], "ROADMAP"),
    (["--prefix-sharing"], "ROADMAP"), (["--chaos", "crash"], "ROADMAP"),
    (["--cache-backend", "dense"], "invalid choice"),
    (["--paged-kernel", "xla"], "invalid choice"),
    (["--dsg-apply", "dense"], "invalid choice")])
def test_serve_cli_rejects_unported_flags(flag, says, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--smoke", *flag])
    assert exc.value.code != 0
    assert says in capsys.readouterr().err
