"""The sharded replica executor over a `replicas` mesh
(`Router(..., exec_mode="sharded", mesh=replica_mesh(m))`) on gloo CPU
ranks, one process a rank, against the reference's `ShardedExecutor` on a
host mesh of two CPU devices and against the port's one-process sharded
router.

The reference lays its stacked replica group over the mesh's `replicas`
axis; the port's rank k builds and runs the engines of its block of
replicas only, and rank 0 routes.  On the smoke model (f32, DSG on in
mask mode with a per-row top-k threshold) over bridged parameters:

  * the merged greedy streams on two ranks equal the reference's
    replica-mesh run's, dense and paged, chunk 1 and 8, every uid
    dispatched once, every rank returning every request;
  * four replicas over two ranks (two a rank) under round_robin,
    least_queue and least_pages, sampled traffic, and the kill and poison
    failovers give the one-process sharded router's streams,
    `dispatch_log`, `steps`, retries and health events;
  * least_pages asks the owner's `can_admit_request`: an answer kept
    from an earlier record (stale) changes the dispatch;
  * the stall rule reads every replica's record;
  * a mesh without `replicas`, 3 replicas over 2 ranks and DSG-serving
    engines are refused as the reference refuses them;
  * a rank that dies or hangs makes rank 0 raise and both exit non-zero;
  * with rank 1's clock 1e6 s ahead of rank 0's (as on another host),
    deadlines hold and every request's time stamps are rank 0's clock;
  * `Router.close()` releases the control group on every rank.

The router's per-replica models and the kernels' current-device check
run in-process (the multi-card placement itself is a card test).
"""
from __future__ import annotations

import subprocess
import sys
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_harness as mh  # noqa: E402

BACKENDS = {"dense": {},
            "paged": {"cache_backend": "paged", "page_size": 8,
                      "cache_tokens": 80}}
CHUNKS = (1, 8)
POLICIES = ("round_robin", "least_queue", "least_pages")

COMMON = f"""
BACKENDS = {BACKENDS!r}
CHUNKS = {CHUNKS!r}
POLICIES = {POLICIES!r}
ENGINE = dict(n_slots=2, max_seq=64, prompt_bucket=32)
"""

REF = COMMON + r'''
import dataclasses
import sys
from pathlib import Path
import numpy as np
import jax
from jax.sharding import Mesh
from harness import (engine_spec, make_engine_parts, mixed_traffic,
                     run_and_collect)
from repro.parallel.sharding import replica_mesh
from repro.serving.router import Router
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
cfg, params, dsg = make_engine_parts()
npy = lambda t: jax.tree.map(np.asarray, t)
fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
fields["dsg"] = tuple(cfg.dsg)
reqs = [dict(uid=r.uid, prompt=np.asarray(r.prompt), max_new=r.max_new)
        for r in mixed_traffic(cfg, n=12)]
dump({"params": npy(params), "dsg": npy(dsg), "cfg": fields,
      "traffic": reqs}, tmp / "inputs.pkl")
out = {}
for backend, kw in BACKENDS.items():
    for chunk in CHUNKS:
        spec = engine_spec(cfg, params, dsg, n_replicas=2,
                           exec_mode="sharded", decode_chunk=chunk, **kw)
        spec["mesh"] = replica_mesh(2)
        out[(backend, chunk)] = run_and_collect(
            spec, mixed_traffic(cfg, n=12), max_steps=100_000)
refused = {}
cases = {"axis": dict(n_replicas=2, mesh=Mesh(np.array(jax.devices()[:2]),
                                               ("data",))),
         "divide": dict(n_replicas=3, mesh=replica_mesh(2)),
         "dsg_serving": dict(n_replicas=2, mesh=replica_mesh(2),
                             dsg_serving=True)}
for name, kw in cases.items():
    try:
        Router(cfg, params, dsg, exec_mode="sharded", **ENGINE, **kw)
    except Exception as e:
        refused[name] = (type(e).__name__, str(e))
out["refused"] = refused
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import sys
import time
from pathlib import Path
from types import SimpleNamespace
import numpy as np
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks, wait_load

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch import bridge
from repro_torch.parallel.sharding import replica_mesh
from repro_torch.runtime.fault_tolerance import (ReplicaFault,
                                                 ServingFaultInjector)
from repro_torch.serving import parallel_exec
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import Request, ServingEngine

try:
    inputs = wait_load(tmp / "inputs.pkl", timeout=300)
    f = dict(inputs["cfg"])
    cfg = bridge.config_from_jax(SimpleNamespace(**f))
    model = bridge.model_from_jax(inputs["params"], cfg, device="cpu")
    dsg = bridge.dsg_from_jax(inputs["dsg"], device="cpu")
    mesh = replica_mesh(n, "cpu")

    def traffic(sampled=False, deadline=None):
        return [Request(uid=r["uid"], prompt=r["prompt"],
                        max_new=r["max_new"],
                        temperature=0.8 if sampled and r["uid"] % 2 else 0.0,
                        top_p=0.9 if sampled and r["uid"] % 2 else 1.0,
                        deadline_s=deadline)
                for r in inputs["traffic"]]

    def serve(router, faults=None, sampled=False, deadline=None):
        inj = None
        if faults:
            inj = ServingFaultInjector(faults)
            inj.attach(router.engines)
        t0 = time.perf_counter()
        for r in traffic(sampled, deadline):
            router.submit(r)
        done = router.run(max_steps=5000)
        t1 = time.perf_counter()
        return {"streams": {u: list(r.output) for u, r in done.items()},
                "stamps": {u: (r.submitted, r.started, r.first_token,
                               r.finished) for u, r in done.items()},
                "span": (t0, t1),
                "status": {u: (r.status, r.retries) for u, r in done.items()},
                "log": list(router.dispatch_log), "steps": router.steps,
                "health": [(h.state, h.restarts, [e[:2] for e in h.events])
                           for h in router.health],
                "fired": inj.log if inj else []}

    def both(tag, faults=None, sampled=False, deadline=None, **kw):
        """The mesh router's run on every rank, and rank 0's one-process
        sharded router's on the same traffic and faults."""
        spec = dict(ENGINE, exec_mode="sharded", **kw)
        router = Router(cfg, model, dsg, mesh=mesh, **spec)
        got = serve(router, faults, sampled, deadline)
        got["local"] = router.executor.local
        got["kinds"] = [type(e).__name__ for e in router.engines]
        got["ops"] = dict(router.executor.control.ops)
        router.close()
        router.close()
        got["closed"] = router.executor.control.group is None
        out[tag] = got
        if rank == 0:
            one[tag] = serve(Router(cfg, model, dsg, **spec), faults,
                             sampled, deadline)

    out, one = {}, {}
    for backend, kw in BACKENDS.items():
        for chunk in CHUNKS:
            both(f"{backend}/{chunk}", n_replicas=2, decode_chunk=chunk, **kw)
    for policy in POLICIES:
        both(f"4/{policy}", n_replicas=4, policy=policy, **BACKENDS["paged"])
    both("2/least_pages", n_replicas=2, policy="least_pages",
         **BACKENDS["paged"])
    both("sampled", n_replicas=4, policy="round_robin", sampled=True)
    ft = {"max_replica_restarts": 0, "max_retries": 3}
    both("kill", n_replicas=2, policy="round_robin", fault_tolerance=ft,
         faults=[ReplicaFault(replica=1, step=6)])
    both("poison", n_replicas=4, policy="round_robin", fault_tolerance=True,
         faults=[ReplicaFault(replica=3, step=3, kind="poison")])

    # rank 1's clock 1e6 s ahead of rank 0's, as on another host: every
    # request has a 600 s deadline, which the owner's engine reads
    clock = time.perf_counter
    if rank == 1:
        time.perf_counter = lambda: clock() + 1e6
    both("clock", n_replicas=2, policy="round_robin", deadline=600.0)
    time.perf_counter = clock

    # the stall rule reads every replica's record: no pool can hold the
    # request, every replica is idle, so the router raises (fault
    # tolerance off) or fails the request (on)
    for tag, ft in (("stall", None), ("stall_ft", True)):
        spec = dict(ENGINE, exec_mode="sharded", n_replicas=2,
                    policy="least_pages", fault_tolerance=ft,
                    **dict(BACKENDS["paged"], cache_tokens=16))
        runs = [Router(cfg, model, dsg, mesh=mesh, **spec)]
        if rank == 0:
            runs.append(Router(cfg, model, dsg, **spec))
        for k, router in enumerate(runs):
            router.submit(Request(uid=0, prompt=np.zeros(30, np.int32),
                                  max_new=16))
            try:
                done = router.run(max_steps=100)
                got = {"status": {u: r.status for u, r in done.items()},
                       "fail_log": [f[:2] for f in router.fail_log]}
            except RuntimeError as e:
                got = {"error": str(e)}
            router.close()
            (out if k == 0 else one)[tag] = dict(got, steps=router.steps)

    # least_pages with the admission check answered from the owner's first
    # answer, never asked again (a stale record)
    asked = parallel_exec.RemoteReplica.can_admit_request
    kept = {}

    def stale(self, req):
        if self.index not in kept:
            kept[self.index] = asked(self, req)
        return kept[self.index]
    if rank == 0:
        parallel_exec.RemoteReplica.can_admit_request = stale
    router = Router(cfg, model, dsg, mesh=mesh, n_replicas=2,
                    policy="least_pages", exec_mode="sharded", **ENGINE,
                    **BACKENDS["paged"])
    out["stale"] = serve(router)
    router.close()
    parallel_exec.RemoteReplica.can_admit_request = asked

    refused = {}
    cases = {"axis": dict(n_replicas=2, mesh=DeviceMesh(
                 "cpu", torch.arange(n), mesh_dim_names=("data",))),
             "divide": dict(n_replicas=3, mesh=mesh),
             "dsg_serving": dict(n_replicas=2, mesh=mesh, dsg_serving=True)}
    for name, kw in cases.items():
        try:
            Router(cfg, model, dsg, exec_mode="sharded", **ENGINE, **kw)
        except Exception as e:
            refused[name] = (type(e).__name__, str(e))
    out["refused"] = refused
    every = [None] * n
    dist.all_gather_object(every, out)
    if rank == 0:
        dump({"ranks": every, "one": one}, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''

# a rank that dies (exits) or hangs (sleeps past the control timeout) when
# its replica reaches step 2; every rank prints what it saw
STOPS = r'''
import datetime
import os
import sys
import time
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, n, tmp, how = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), \
    sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group(
    "gloo", store=dist.FileStore(str(tmp / "store"), n), rank=rank,
    world_size=n, timeout=datetime.timedelta(seconds=120))
from repro_torch import configs
from repro_torch.models import api
from repro_torch.parallel.sharding import replica_mesh
from repro_torch.serving import parallel_exec
from repro_torch.serving.router import Router
from repro_torch.serving.scheduler import Request

cfg = configs.get_smoke_config("internlm2-1.8b")
gen = torch.Generator().manual_seed(0)
model = api.init_model(cfg, generator=gen, device="cpu")
dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
# the control group's timeout, short; the ranks meet first, so that the
# group's own set-up does not wait on a slow start
parallel_exec.default_timeout = lambda: datetime.timedelta(seconds=3)
dist.barrier()
router = Router(cfg, model, dsg, n_replicas=2, policy="round_robin",
                exec_mode="sharded", mesh=replica_mesh(n, "cpu"), n_slots=2,
                max_seq=64, prompt_bucket=32)


class Stop:
    def on_step(self, eng):
        if eng.steps >= 2:
            if how == "dies":
                os._exit(3)
            print(f"HANG {time.monotonic()}", flush=True)
            time.sleep(12)
            print(f"WOKE {time.monotonic()}", flush=True)
            eng.fault_injector = None


if rank == 1:
    router.engines[1].fault_injector = Stop()
rng = np.random.default_rng(0)
for u in range(4):
    router.submit(Request(uid=u, prompt=rng.integers(0, cfg.vocab, 8,
                                                     dtype=np.int32),
                          max_new=6))
try:
    router.run()
except Exception as e:
    print(f"RAISED {time.monotonic()} {type(e).__name__}: "
          f"{str(e)[:300]}", flush=True)
    sys.exit(1)
print("FINISHED", flush=True)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replica_mesh")
    stops = {}
    for how in ("dies", "hangs"):
        d = tmp / how
        d.mkdir()
        stops[how] = [subprocess.Popen(
            [sys.executable, "-c", STOPS, str(r), "2", str(d), how],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=mh._env()) for r in range(2)]
    ref, got = mh.run(tmp, REF, 2, RANKS, 2, timeout=400)
    ended = {}
    for how, procs in stops.items():
        ended[how] = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=120)
            finally:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            ended[how].append((p.returncode, out, err))
    return {"ref": ref, "ranks": got["ranks"], "one": got["one"],
            "stops": ended}


def _same_on_ranks(runs, tag):
    first = runs["ranks"][0][tag]
    for other in runs["ranks"][1:]:
        for key in ("streams", "status", "log", "steps", "health"):
            assert other[tag][key] == first[key], (tag, key)
    return first


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_greedy_streams_equal_the_reference_replica_mesh(runs, backend,
                                                         chunk):
    """Two ranks, one replica each: the merged streams equal the
    reference's ShardedExecutor on a two-device replicas mesh, every uid is
    dispatched once and every rank returns every request."""
    tag = f"{backend}/{chunk}"
    got = _same_on_ranks(runs, tag)
    want = runs["ref"][(backend, chunk)]
    assert got["streams"] == want
    assert sorted(u for u, _ in got["log"]) == sorted(want)
    assert all(s == ("ok", 0) for s in got["status"].values())
    # and the one-process sharded router's dispatch and steps
    assert got["log"] == runs["one"][tag]["log"]
    assert got["steps"] == runs["one"][tag]["steps"]


@pytest.mark.parametrize("policy", POLICIES)
def test_blocks_and_policies_match_the_one_process_router(runs, policy):
    """Four replicas over two ranks (a block of two a rank): the policy
    sees what a one-process router sees, so dispatch_log and steps equal
    the one-process sharded router's, and the streams the reference's."""
    tag = f"4/{policy}"
    got = _same_on_ranks(runs, tag)
    one = runs["one"][tag]
    assert got["log"] == one["log"] and got["steps"] == one["steps"]
    assert got["streams"] == one["streams"] == runs["ref"][("paged", 1)]
    assert len({r for _, r in got["log"]}) > 1


def test_each_rank_runs_only_its_block(runs):
    """Rank k builds the engines of [2k, 2k + 2) and holds a RemoteReplica
    for every other replica; rank 0 sent the commands, the others served
    them."""
    for k, ranks in enumerate(runs["ranks"]):
        got = ranks["4/least_pages"]
        assert got["local"] == [2 * k, 2 * k + 1]
        assert [name == "ServingEngine" for name in got["kinds"]] == [
            i in got["local"] for i in range(4)]
        assert got["ops"]["tick"] > 0 and got["ops"]["admit"] > 0
        assert got["ops"]["sync"] == got["ops"]["end"] == 1
    ops = [r["4/least_pages"]["ops"] for r in runs["ranks"]]
    assert ops[0] == ops[1]


def test_sampled_streams_equal_the_one_process_router(runs):
    """Odd requests at temperature 0.8 / top_p 0.9: replica r samples from
    seed + r wherever it runs, so the streams equal the one-process
    sharded router's, and the sampled ones differ from greedy."""
    got = _same_on_ranks(runs, "sampled")
    one = runs["one"]["sampled"]
    assert got["streams"] == one["streams"]
    assert got["log"] == one["log"] and got["steps"] == one["steps"]
    greedy = runs["ref"][("dense", 1)]
    assert any(got["streams"][u] != greedy[u] for u in greedy if u % 2)
    assert all(got["streams"][u] == greedy[u] for u in greedy if u % 2 == 0)


@pytest.mark.parametrize("fault", ["kill", "poison"])
def test_failover_matches_the_one_process_router(runs, fault):
    """kill@1:6 (replica 1 dead, no restart) and a poison on replica 3:
    the owner's engine raises, rank 0 contains it and the reset runs on
    the owner; streams, retries, statuses, health events and dispatch equal
    the one-process router's, and the streams the fault-free ones."""
    got = _same_on_ranks(runs, fault)
    one = runs["one"][fault]
    for key in ("streams", "status", "log", "steps", "health"):
        assert got[key] == one[key], key
    assert got["streams"] == runs["ref"][("dense", 1)]
    assert any(r > 0 for _, r in got["status"].values())
    owner = 1 if fault == "kill" else 3
    assert got["health"][owner][2], "the fault never fired"
    fired = [r[fault]["fired"] for r in runs["ranks"]]
    assert fired[0] == [] and len(fired[1]) == 1
    if fault == "kill":
        assert got["health"][1][0] == "dead"


def test_least_pages_asks_the_owner(runs):
    """least_pages reads can_admit_request as the owner computes it at
    the time of asking: the mesh's dispatch equals the one-process
    router's, and an answer kept from the first record (stale) sends a
    request to a replica whose lanes are full, which changes the
    dispatch."""
    stale = runs["ranks"][0]["stale"]
    right = runs["one"]["2/least_pages"]
    got = _same_on_ranks(runs, "2/least_pages")
    assert got["log"] == right["log"] and got["steps"] == right["steps"]
    assert got["streams"] == runs["ref"][("paged", 1)]
    assert stale["log"] != right["log"]
    assert stale["streams"] == got["streams"]


def test_stall_rule_reads_every_replica(runs):
    """A request no replica's pool can hold, every replica idle: the mesh's
    rank 0 decides the stall from every replica's record as one process
    does.  Fault tolerance off, rank 0 raises the router-stall error and
    the other rank stops with it; on, the request finishes `failed` on
    every rank after the same steps."""
    ranks = [r["stall"] for r in runs["ranks"]]
    one = runs["one"]["stall"]
    assert "router stalled" in one["error"]
    assert ranks[0]["error"] == one["error"]
    assert "rank 0 stopped the replica mesh's run" in ranks[1]["error"]
    assert "router stalled" in ranks[1]["error"]
    for r in runs["ranks"]:
        assert r["stall_ft"] == runs["one"]["stall_ft"]
    assert runs["one"]["stall_ft"]["status"] == {0: "failed"}


@pytest.mark.parametrize("case", ["axis", "divide", "dsg_serving"])
def test_refusals_match_the_reference(runs, case):
    """A mesh without a `replicas` axis and one whose axis does not divide
    the group raise the reference's ValueError, word for word;
    DSG-serving engines raise NotImplementedError in both packages."""
    want = runs["ref"]["refused"][case]
    for ranks in runs["ranks"]:
        got = ranks["refused"][case]
        assert got[0] == want[0]
        if case != "dsg_serving":
            assert got[1] == want[1]
        else:
            assert got[1].startswith("sharded executor batches the plain "
                                     "decode step")


@pytest.mark.parametrize("how", ["dies", "hangs"])
def test_a_stopped_rank_makes_rank0_raise(runs, how):
    """Rank 1 exits, or sleeps 12 s, past the control group's 3 s timeout, when
    its replica reaches step 2: rank 0 raises (within the timeout when
    it hangs) and exits non-zero, and no rank finishes the run alone."""
    (rc0, out0, err0), (rc1, out1, err1) = runs["stops"][how]
    assert rc0 != 0 and rc1 != 0, (out0, err0[-2000:], out1, err1[-2000:])
    assert "RAISED" in out0 and "FINISHED" not in out0 + out1
    if how == "dies":
        assert rc1 == 3
    else:
        hung = float(out1.split("HANG ")[1].split()[0])
        raised = float(out0.split("RAISED ")[1].split()[0])
        woke = float(out1.split("WOKE ")[1].split()[0])
        assert raised < woke and raised - hung < 10


def test_stamps_are_rank0s_clock(runs):
    """Rank 1's clock runs 1e6 s ahead of rank 0's.  Every request keeps
    its 600 s deadline (the owner reads it on its own clock), and on every
    rank each request's submit, admission, first token and finish are
    rank 0's clock, in that order, inside rank 0's span of the run: so
    the latencies are real, whichever rank served the request."""
    got = _same_on_ranks(runs, "clock")
    one = runs["one"]["clock"]
    assert got["streams"] == one["streams"] == runs["ref"][("dense", 1)]
    assert all(s == ("ok", 0) for s in got["status"].values())
    assert {r for _, r in got["log"]} == {0, 1}
    t0, t1 = runs["ranks"][0]["clock"]["span"]
    for ranks in runs["ranks"]:
        for uid, stamps in ranks["clock"]["stamps"].items():
            assert t0 <= stamps[0] <= stamps[1] <= stamps[2] <= stamps[3] \
                <= t1, (uid, stamps, t0, t1)


def test_close_releases_the_control_group(runs):
    """Router.close() destroys the executor's gloo group on every rank,
    and a second close is a no-op."""
    for ranks in runs["ranks"]:
        for tag in ("dense/1", "4/least_pages", "kill", "clock"):
            assert ranks[tag]["closed"], tag


# -- one process -------------------------------------------------------------

def _with_sharding_blocks(axes, sizes, n):
    from repro_torch.parallel import sharding
    mesh = SimpleNamespace(mesh_dim_names=axes,
                           mesh=SimpleNamespace(shape=sizes))
    return sharding.replica_blocks(mesh, n)


def test_replica_blocks_are_contiguous():
    """Coordinate k of the `replicas` axis owns [k n/m, (k+1) n/m)."""
    assert _with_sharding_blocks(("replicas",), (2,), 4) == [range(0, 2),
                                                               range(2, 4)]
    assert _with_sharding_blocks(("replicas",), (4,), 8)[3] == range(6, 8)
    with pytest.raises(ValueError, match="'replicas' axis"):
        _with_sharding_blocks(("data",), (2,), 4)
    with pytest.raises(ValueError, match="do not divide"):
        _with_sharding_blocks(("replicas",), (2,), 3)


def test_kernel_launch_on_another_card_raises(monkeypatch):
    """A launch acts on the calling thread's current device: the stream
    argument of a launch for operands on cuda:1 raises while cuda:0 is
    current, so that a wrapper whose launch were not inside its operands'
    device context could not run on the wrong card."""
    from repro_torch.kernels import cuda_lib
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="current device"):
        cuda_lib.stream(torch.device("cuda", 1))
