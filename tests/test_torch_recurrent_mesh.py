"""The recurrent families sharded on two gloo CPU ranks, held against the
reference's unsharded run and the port's own unsharded run.

xlstm-350m and zamba2-7b, each at its smoke width in f32 with the
reference's weights carried across by `bridge.py` and a batch of 4 x 16
tokens from a numpy seed, on (data 1, model 2) and (data 2, model 1):
every parameter, the DSG state, the inputs and the decode state laid out
by the spec rules (`models.specs`), the verbs called without `mesh=`
under the mesh's parallel context, as the dry run traces them
(`models/recurrent.py`'s shard_map bodies: the wrap's and the mLSTM's
row-parallel projections, the sLSTM's loop on a rank's channels,
Mamba2's heads, the gate-branch DRS masks thresholded over 'model', the
shared block's attention and FFN bodies):

  * train: `api.train_loss` and its gradients;
  * prefill: the 16-token prompt's last logits and the state;
  * decode: one step at position 16 from the prefill's state laid out by
    `cache_specs` (the dry run's decode cell), and one from the sharded
    prefill's own state as it came back.

Tolerances (ROADMAP.md §3's rule for sharded runs): the loss within 4
f32 ulps of the reference's and of the port's unsharded loss; each
gradient, logit and state leaf within 1e-4 of the leaf's largest
entry.  The ranks and the reference start once, in a module-scoped
fixture.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

LOSS_ULPS = 4
TOL = 1e-4
ARCHS = ["xlstm-350m", "zamba2-7b"]
MESHES = {"model2": (1, 2), "data2": (2, 1)}
B, S = 4, 16

COMMON = f"""
ARCHS, MESHES, B, S = {ARCHS!r}, {MESHES!r}, {B}, {S}
"""

REF = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import jax
from repro import configs
from repro.models import api
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
npy = lambda t: jax.tree.map(np.asarray, t)
inputs, out = {}, {}
for i, arch in enumerate(ARCHS):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    key = jax.random.PRNGKey(20 + i)
    params = api.init_model(key, cfg)
    dsg = api.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    rng = np.random.default_rng(40 + i)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "token": rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32)}
    inputs[arch] = {"params": npy(params), "dsg": npy(dsg), "batch": batch}
    loss, grads = jax.value_and_grad(lambda p: api.train_loss(
        p, dsg, cfg, {"tokens": batch["tokens"],
                      "labels": batch["labels"]}))(params)
    last, st = api.prefill(params, dsg, cfg, {"tokens": batch["tokens"]},
                           api.make_cache(cfg, B, S))
    step, st2 = api.decode_step(params, dsg, cfg, batch["token"], st, S)
    out[arch] = {"loss": float(loss), "grads": npy(grads),
                 "prefill": np.asarray(last), "prefill_state": npy(st),
                 "decode": np.asarray(step), "decode_state": npy(st2)}
dump(inputs, tmp / "inputs.pkl")
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks, wait_load

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import bridge, configs
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import api, specs
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import (axes_for_mesh, distribute_model,
                                           distribute_tree, full_tree)


def numpy_tree(t):
    """A copy: a decode step writes zamba's K/V in place."""
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    return full_tree(t).detach().numpy().copy()


def clone_tree(t):
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    return t.clone()


def run(arch, case, mesh):
    """(loss, grads, prefill logits and state, decode from the laid-out
    state, decode from the prefill's own state), sharded on `mesh`, or
    unsharded with mesh None."""
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    res = {}
    for trainable in (True, False):
        model = bridge.model_from_jax(case["params"], cfg, device="cpu",
                                      trainable=trainable)
        dsg = bridge.dsg_from_jax(case["dsg"], device="cpu")
        lay = {k: v for k, v in batch.items()}
        ctx = pctx.use_mesh(None)
        if mesh is not None:
            ax = axes_for_mesh(mesh)
            m = mesh.size(1)
            distribute_model(model, mesh, specs.param_specs(model, cfg, ax, m))
            dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, cfg, ax, m))
            lay = distribute_tree(batch, mesh,
                                  specs.input_specs(batch, cfg, ax))
            ctx = pctx.use_mesh(mesh)
        with ctx:
            if trainable:
                params = dict(model.named_parameters())
                loss = api.train_loss(model, dsg, cfg,
                                      {"tokens": lay["tokens"],
                                       "labels": lay["labels"]})
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                res["loss"] = float(full_tree(loss))
                res["grads"] = {k: numpy_tree(g) for k, g in
                                zip(params, grads) if g is not None}
                continue
            cache = api.make_cache(cfg, B, S, device="cpu")
            if cache is not None and mesh is not None:
                cache = distribute_tree(cache, mesh,
                                        specs.cache_specs(cache, cfg, ax, m))
            last, st = api.prefill(model, dsg, cfg, {"tokens": lay["tokens"]},
                                   cache)
            res["prefill"] = numpy_tree(last)
            res["prefill_state"] = numpy_tree(st)
            chained = None
            if mesh is not None:
                # the decode cell's state: laid out by cache_specs (taken
                # first: a decode step writes zamba's K/V in place)
                whole = clone_tree(full_tree(st))
                step, st2 = api.decode_step(model, dsg, cfg, lay["token"], st,
                                            S)
                chained = {"logits": numpy_tree(step),
                           "state": numpy_tree(st2)}
                st = distribute_tree(whole, mesh,
                                     specs.cache_specs(whole, cfg, ax, m))
            step, st2 = api.decode_step(model, dsg, cfg, lay["token"], st, S)
            res["decode"] = numpy_tree(step)
            res["decode_state"] = numpy_tree(st2)
            res["chained"] = chained
    return res


try:
    inputs = wait_load(tmp / "inputs.pkl")
    out = {}
    for arch in ARCHS:
        out[arch, "plain"] = run(arch, inputs[arch], None)
        for name, (data, model) in MESHES.items():
            mesh = make_elastic_mesh(2, model=model, device_type="cpu")
            out[arch, name] = run(arch, inputs[arch], mesh)
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mh.run(tmp_path_factory.mktemp("recurrent_mesh"), REF, 1, RANKS,
                  2, timeout=600)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _worst(got: dict, want: dict) -> tuple:
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    errs = {k: mh.leaf_err(got[k], want[k]) for k in want}
    assert all(got[k].shape == want[k].shape for k in want)
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_matches_the_reference(runs, arch, mesh):
    ref, got = runs
    loss = got[arch, mesh]["loss"]
    assert mh.ulps(loss, ref[arch]["loss"]) <= LOSS_ULPS, (
        loss, ref[arch]["loss"])
    assert mh.ulps(loss, got[arch, "plain"]["loss"]) <= LOSS_ULPS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_the_reference(runs, arch, mesh):
    from repro_torch import bridge
    ref, got = runs
    grads = got[arch, mesh]["grads"]
    want = {k: v.numpy() for k, v in bridge.from_reference_tree(
        ref[arch]["grads"], list(grads)).items()}
    assert _worst(grads, want)[1] <= TOL
    assert _worst(grads, got[arch, "plain"]["grads"])[1] <= TOL


@pytest.mark.parametrize("part", ["prefill", "prefill_state", "decode",
                                  "decode_state"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_the_reference(runs, arch, mesh,
                                                        part):
    ref, got = runs
    worst, err = _worst({"x": got[arch, mesh][part]}, {"x": ref[arch][part]})
    assert err <= TOL, (worst, err)
    assert _worst({"x": got[arch, mesh][part]},
                  {"x": got[arch, "plain"][part]})[1] <= TOL


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_the_sharded_prefills_own_state(runs, arch, mesh):
    """The state as the sharded prefill leaves it (the sLSTM's and
    Mamba2's split over 'model', zamba's K/V by head) decodes as the
    state laid out by `cache_specs` does."""
    ref, got = runs
    chained = got[arch, mesh]["chained"]
    assert _worst({"x": chained["logits"]}, {"x": ref[arch]["decode"]})[1] \
        <= TOL
    assert _worst(chained["state"], ref[arch]["decode_state"])[1] <= TOL
