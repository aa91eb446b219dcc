"""The trainer on a (data 2, model 2) mesh of four gloo CPU ranks, held
against the reference's `repro.launch.train.build_trainer` on a
four-device host mesh, and the mesh-side substrate:

  * 4 AdamW steps of the smoke internlm2 (f32, DSG mask/shared, remat)
    from the reference's weights (`bridge.py`), f(W) refreshed after step
    2, on `synthetic.batch_at`'s batches of 4 x 16, with and without
    gradient compression: each step's loss within 4 f32 ulps of the
    reference's, and every parameter, moment and feedback buffer after
    the last step within 1e-5 of its leaf's largest entry (a gradient
    within 1e-4, ROADMAP.md §3, scaled by the learning rate);
  * the checkpoint round-trip on the mesh: rank 0 writes the state
    gathered whole, a fresh sharded trainer restores equal shards, and a
    longer run resumes where the first stopped;
  * `synthetic.make_global_batch`: each rank makes its own rows, and the
    global batch on a (data 1, model 2) mesh equals `batch_at`'s whole
    batch (the reference's make_global_batch's), on (data 2, model 2) the
    two hosts' slices in order;
  * `runtime.elastic.remesh_state` from (data 2, model 2) onto
    `plan_after_loss(3, model=2)`'s (data 1, model 2): every leaf equal,
    laid out by its old spec on the new mesh;
  * the CLI: `--production-mesh` on 4 ranks fails with the mesh
    builder's own message (as the reference's fails on too few devices).

The ranks and the reference start once, in a module-scoped fixture.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

LOSS_ULPS = 4
STATE_TOL = 1e-5
STEPS, B, S = 4, 4, 16

COMMON = f"""
STEPS, B, S = {STEPS}, {B}, {S}


def make_cfg(configs):
    return configs.get_smoke_config("internlm2-1.8b").replace(
        dtype="float32")
"""

REF = COMMON + r'''
import dataclasses
import sys
from pathlib import Path
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.compat import make_mesh
from repro.data import synthetic
from repro.launch.train import build_trainer
from repro.optim import adamw
from repro.runtime.elastic import plan_after_loss
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
npy = lambda t: jax.tree.map(np.asarray, t)
cfg = make_cfg(configs)
mesh = make_mesh((2, 2), ("data", "model"))
acfg = adamw.AdamWConfig(total_steps=STEPS, warmup=1)
out, inputs = {}, {}
for gc in (False, True):
    state, step, refresh, _ = build_trainer(cfg, mesh, acfg,
                                            grad_compress=gc, seed=0)
    if not gc:
        inputs = {"params": npy(state["params"]), "dsg": npy(state["dsg"])}
        dump(inputs, tmp / "inputs.pkl")
    losses = []
    for i in range(STEPS):
        batch = synthetic.batch_at(i, global_batch=B, seq_len=S,
                                   vocab=cfg.vocab)
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        if i == 1:
            state = refresh(state)
    out[gc] = {"losses": losses, "state": npy(state)}
whole = synthetic.batch_at(3, global_batch=B, seq_len=S, vocab=cfg.vocab)
gb = synthetic.make_global_batch(3, mesh, {"tokens": P("data", None),
                                           "labels": P("data", None)},
                                 global_batch=B, seq_len=S, vocab=cfg.vocab)
out["global_batch"] = npy(gb)
out["plan"] = dataclasses.astuple(plan_after_loss(3, model=2))
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import shutil
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks, wait_load

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import bridge, configs
from repro_torch.data import synthetic
from repro_torch.launch import train
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import P, full_tree, placements
from repro_torch.runtime.elastic import plan_after_loss, remesh_state
try:
    inputs = wait_load(tmp / "inputs.pkl")
    cfg = make_cfg(configs)
    mesh = make_elastic_mesh(4, model=2, device_type="cpu")
    acfg = adamw.AdamWConfig(total_steps=STEPS, warmup=1)
    out = {}

    def port_init():
        return (bridge.model_from_jax(inputs["params"], cfg, device="cpu"),
                bridge.dsg_from_jax(inputs["dsg"], device="cpu"))

    for gc in (False, True):
        state, step, refresh = train.trainer_for(*port_init(), cfg, acfg,
                                                 grad_compress=gc, mesh=mesh)
        losses = []
        for i in range(STEPS):
            batch = synthetic.batch_at(i, global_batch=B, seq_len=S,
                                       vocab=cfg.vocab)
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            if i == 1:
                state = refresh(state)
        tree = bridge.state_to_numpy(state["model"], state["dsg"],
                                     state["opt"], state.get("err"))
        out[gc] = {"losses": losses, "state": tree}
    trained = state

    # remesh: (data 2, model 2) -> plan_after_loss(3, model=2)
    plan = plan_after_loss(3, model=2)
    flat = {"params": dict(trained["model"].named_parameters()),
            "dsg": trained["dsg"], "m": trained["opt"]["m"]}
    specs = {"params": trained["specs"]["params"],
             "dsg": trained["specs"]["dsg"], "m": trained["specs"]["opt"]["m"]}
    new_mesh, moved = remesh_state(flat, specs, plan, device_type="cpu")
    before, after = full_tree(flat), full_tree(moved)
    same = all(torch.equal(before[p][k], after[p][k])
               for p in before for k in before[p])
    laid = all(list(after_d.placements) == placements(new_mesh, specs[p][k])
               for p in moved for k, after_d in moved[p].items()) \
        if rank < plan.n_devices else True
    out["remesh"] = {"plan": (plan.n_devices, plan.data, plan.model,
                              plan.dropped), "same": same, "laid": laid,
                     "shape": tuple(new_mesh.mesh.shape)}

    # make_global_batch on (data 2, model 2) and on (data 1, model 2)
    kw = dict(global_batch=B, seq_len=S, vocab=cfg.vocab)
    spec = {"tokens": P(("data",), None), "labels": P(("data",), None)}
    gb2 = synthetic.make_global_batch(3, mesh, spec, **kw)
    one = make_elastic_mesh(2, model=2, device_type="cpu")
    gb1 = synthetic.make_global_batch(3, one, spec, **kw) if rank < 2 else None
    out["global_batch"] = {
        "data2": {k: v.full_tensor().numpy() for k, v in gb2.items()},
        "data1": ({k: v.full_tensor().numpy() for k, v in gb1.items()}
                  if gb1 is not None else None),
        "data2_local": {k: v.to_local().numpy() for k, v in gb2.items()},
        "hosts": [synthetic.batch_at(3, host_index=i, host_count=2, **kw)
                  for i in range(2)]}

    # the checkpoint round-trip on the mesh
    ckpt = tmp / "ckpt"
    first, hist4, _ = train.train(cfg, steps=4, global_batch=B, seq_len=S,
                                  device="cpu", init=port_init(), mesh=mesh,
                                  ckpt_dir=str(ckpt), ckpt_every=2)
    want = bridge.state_to_numpy(first["model"], first["dsg"], first["opt"])
    fresh, _, _ = train.trainer_for(*port_init(), cfg, acfg, mesh=mesh)
    ck = train.TrainCheckpoint(train.CheckpointManager(str(ckpt)), mesh)
    _, rstep, _ = ck.restore(fresh)
    got = bridge.state_to_numpy(fresh["model"], fresh["dsg"], fresh["opt"])
    state6, hist6, _ = train.train(cfg, steps=6, global_batch=B, seq_len=S,
                                   device="cpu", init=port_init(),
                                   mesh=mesh, ckpt_dir=str(ckpt),
                                   ckpt_every=2)
    out["ckpt"] = {"want": want, "got": got, "step": rstep,
                   "hist4": [h["step"] for h in hist4],
                   "hist6": [h["step"] for h in hist6],
                   "opt_step": state6["opt"]["step"]}

    # the CLI on the mesh: --production-mesh on 4 ranks
    try:
        train.main(["--smoke", "--device", "cpu", "--production-mesh",
                    "--steps", "1"])
        refused = None
    except ValueError as e:
        refused = str(e)
    out["cli"] = {"refused": refused}
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mh.run(tmp_path_factory.mktemp("sharded_train"), REF, 4, RANKS, 4)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("gc", [False, True], ids=["plain", "compress"])
def test_mesh_trainer_losses_match_the_reference(runs, gc, step):
    ref, got = runs
    assert mh.ulps(got[gc]["losses"][step], ref[gc]["losses"][step]) \
        <= LOSS_ULPS, (got[gc]["losses"], ref[gc]["losses"])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("part", ["params", "dsg", "opt", "err"])
@pytest.mark.parametrize("gc", [False, True], ids=["plain", "compress"])
def test_mesh_trainer_state_matches_the_reference(runs, gc, part):
    ref, got = runs
    if part == "err" and not gc:
        assert "err" not in got[gc]["state"]
        return
    want = dict(_leaves(ref[gc]["state"][part]))
    have = dict(_leaves(got[gc]["state"][part]))
    assert want.keys() == have.keys()
    for k in want:
        if want[k].ndim == 0:               # the step count
            assert int(have[k]) == int(want[k]), k
            continue
        assert have[k].shape == want[k].shape, k
        assert mh.leaf_err(have[k], want[k]) <= STATE_TOL, k


def test_checkpoint_round_trip_on_the_mesh(runs):
    _, got = runs
    ck = got["ckpt"]
    assert ck["step"] == 4 and ck["hist4"] == [0, 1, 2, 3]
    want, have = dict(_leaves(ck["want"])), dict(_leaves(ck["got"]))
    assert want.keys() == have.keys()
    for k in want:
        assert np.array_equal(have[k], want[k]), k
    assert ck["hist6"] == [4, 5] and ck["opt_step"] == 6


def test_make_global_batch(runs):
    ref, got = runs
    gb = got["global_batch"]
    for k in ("tokens", "labels"):
        # one data shard: batch_at's whole batch, as the reference's
        assert np.array_equal(gb["data1"][k], ref["global_batch"][k])
        # two: the hosts' slices in order, rank 0 holding host 0's rows
        hosts = np.concatenate([h[k].numpy() for h in gb["hosts"]])
        assert np.array_equal(gb["data2"][k], hosts)
        assert np.array_equal(gb["data2_local"][k], gb["hosts"][0][k].numpy())


def test_remesh_state_keeps_every_leaf(runs):
    ref, got = runs
    rm = got["remesh"]
    assert rm["plan"] == ref["plan"] == (2, 1, 2, 1)
    assert rm["shape"] == (1, 2)
    assert rm["same"] and rm["laid"]


def test_cli_on_the_mesh(runs):
    _, got = runs
    assert got["cli"]["refused"] is not None
    assert "needs 256 ranks, the process group has 4" in got["cli"]["refused"]
