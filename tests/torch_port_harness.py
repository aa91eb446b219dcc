"""Shared set-up of the port's router, executor and fault tests: the
reference's smoke parts bridged into the port, the reference's traffic as
port requests, and `port_run`, the port's counterpart of
`harness.run_and_collect` (a bare port engine, or a port Router when the
spec names `n_replicas`).

    ref, port = bridged_parts()          # (cfg, params, dsg), (cfg, model, dsg)
    want = run_and_collect(engine_spec(*ref), mixed_traffic(ref[0]))
    got = port_run(port, engine_spec(*port, n_replicas=2),
                   mixed_traffic(ref[0]))
    assert_streams_equal(want, got)
"""
import jax
import numpy as np

from harness import make_engine_parts
from repro_torch import bridge
from repro_torch.runtime.fault_tolerance import ServingFaultInjector
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import Request, ServingEngine


def bridged_parts(threshold_mode: str = "topk"):
    """(reference cfg, params, dsg) and the port's (cfg, model, dsg) on the
    same parameters, on the CPU."""
    cfg, params, dsg = make_engine_parts(threshold_mode=threshold_mode)
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, dsg), device="cpu")
    return (cfg, params, dsg), (tcfg, model, tdsg)


def port_request(r) -> Request:
    """A fresh port Request with a reference Request's fields."""
    return Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new,
                   eos_id=r.eos_id, temperature=r.temperature, top_p=r.top_p,
                   deadline_s=r.deadline_s)


def port_router(port, **kw) -> Router:
    """A port Router over the port parts with the harness's engine
    defaults (2 slots, max_seq 64, prompt bucket 32)."""
    cfg, model, dsg = port
    spec = dict(n_slots=2, max_seq=64, prompt_bucket=32)
    spec.update(kw)
    return Router(cfg, model, dsg, **spec)


def port_run(spec: dict, requests, *, max_steps: int = 400,
             return_engine: bool = False, faults=None):
    """`harness.run_and_collect` for the port: run the reference's
    `requests` (converted) through the engine or router that `spec`
    describes (an `engine_spec` over the port's parts) and return
    {uid: tokens}; every request must finish ok within max_steps."""
    kw = dict(spec)
    cfg, model, dsg = kw.pop("cfg"), kw.pop("params"), kw.pop("dsg")
    n_replicas = kw.pop("n_replicas", None)
    policy = kw.pop("policy", "least_queue")
    if n_replicas is None:
        eng = ServingEngine(cfg, model, dsg, **kw)
    else:
        eng = Router(cfg, model, dsg, n_replicas=n_replicas, policy=policy,
                     **kw)
    if faults:
        ServingFaultInjector(list(faults)).attach(
            eng.engines if n_replicas is not None else [eng])
    for r in requests:
        eng.submit(port_request(r))
    try:
        done = eng.run(max_steps=max_steps)
    finally:
        if n_replicas is not None:
            eng.close()
    assert len(done) == len(requests), (
        f"only {len(done)} of {len(requests)} requests finished "
        f"within {max_steps} steps")
    assert all(r.status == "ok" for r in done.values()), (
        "non-ok request in " +
        str({u: r.status for u, r in done.items() if r.status != "ok"}))
    streams = {u: list(r.output) for u, r in done.items()}
    return (streams, eng) if return_engine else streams
