"""The model sharded over a (data 2, model 2) mesh on four gloo CPU ranks,
held against the reference's sharded run of the same function on a
four-device host mesh.

Every case is the smoke config in f32 with the reference's weights
carried across by `bridge.py`, a batch of 4 x 16 tokens from a numpy
seed, laid out on the mesh by the reference's specs (`models.specs`):

  * head / seq: the dense family (internlm2) with DSG mask/shared, the
    attention in head mode (auto: 4 heads divide 2) and forced to seq
    mode (cfg.attn_shard, as the reference allows);
  * dsg_off, topk: DSG off, and mask mode with per-row top-k;
  * gather: DSG gather_shared with n_chunks 2, the sharded gather
    (`swiglu_dsg_gather_sharded`: each model shard selects its own groups
    over its own rows);
  * moe: deepseek-moe-16b's smoke config under expert parallelism (2 of
    its 4 experts a shard, capacity from the shard's rows);
  * whisper: the encoder-decoder's train_loss (frames 4 x 32, tokens 4 x 8);
  * decode: split-KV decode through `api.decode_step`, the dense cache of
    a 12-token prefill sequence-sharded over 'model', lanes at their own
    positions.

Tolerances (ROADMAP.md §3's f32 rule): the loss within 4 f32 ulps of the
reference's, each gradient leaf within 1e-4 of the leaf's largest entry;
the decode step's logits and the written cache within 1e-5 of their
largest entry.  The ranks and the reference start once, in a
module-scoped fixture, and each case is a test of its own.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

LOSS_ULPS = 4
GRAD_TOL = 1e-4
DECODE_TOL = 1e-5

# name -> (arch, config overrides, DSG overrides)
CASES = {
    "head": ("internlm2-1.8b", {}, {}),
    "seq": ("internlm2-1.8b", {"attn_shard": "seq"}, {}),
    "dsg_off": ("internlm2-1.8b", {}, {"enabled": False}),
    "topk": ("internlm2-1.8b", {}, {"threshold_mode": "topk"}),
    "gather": ("internlm2-1.8b", {},
               {"mode": "gather_shared", "n_chunks": 2}),
    "moe": ("deepseek-moe-16b", {}, {}),
    "whisper": ("whisper-large-v3", {}, {}),
    "decode": ("internlm2-1.8b", {}, {}),
}
B, S, PROMPT, MAX_SEQ = 4, 16, 12, 32

COMMON = f"""
CASES = {CASES!r}
B, S, PROMPT, MAX_SEQ = {B}, {S}, {PROMPT}, {MAX_SEQ}


def cfg_of(configs, name):
    arch, over, dover = CASES[name]
    c = configs.get_smoke_config(arch).replace(dtype="float32", **over)
    return c.replace(dsg=c.dsg._replace(**dover))
"""

REF = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.compat import make_mesh
from repro.models import api, specs
from repro.parallel import context as pctx
from repro.parallel.sharding import axes_for_mesh
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
npy = lambda t: jax.tree.map(np.asarray, t)
inputs, state = {}, {}
for i, name in enumerate(CASES):
    cfg = cfg_of(configs, name)
    key = jax.random.PRNGKey(i)
    params = api.init_model(key, cfg)
    dsg = api.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    rng = np.random.default_rng(100 + i)
    if name == "whisper":
        batch = {"frames": rng.standard_normal((B, 32, cfg.d_model))
                 .astype(np.float32),
                 "tokens": rng.integers(0, cfg.vocab, (B, 8), dtype=np.int32),
                 "labels": rng.integers(0, cfg.vocab, (B, 8), dtype=np.int32)}
    elif name == "decode":
        batch = {"prompt": rng.integers(0, cfg.vocab, (B, PROMPT),
                                        dtype=np.int32),
                 "token": rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32),
                 "pos": np.array([PROMPT, PROMPT - 1, PROMPT, PROMPT + 3],
                                 np.int32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
                 "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    inputs[name] = {"params": npy(params), "dsg": npy(dsg), "batch": batch}
    state[name] = (cfg, params, dsg)
dump(inputs, tmp / "inputs.pkl")

mesh = make_mesh((2, 2), ("data", "model"))
ax = axes_for_mesh(mesh)


def put(tree, sp):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                        tree, sp, is_leaf=lambda x: isinstance(x, P))


out = {}
for name, (cfg, params, dsg) in state.items():
    batch = {k: jnp.asarray(v) for k, v in inputs[name]["batch"].items()}
    if name == "decode":
        cache = api.make_cache(cfg, B, MAX_SEQ)
        _, cache = jax.jit(lambda p, d, t, c: api.prefill(
            p, d, cfg, {"tokens": t}, c))(params, dsg, batch["prompt"], cache)
    with pctx.use_mesh(mesh):
        p_sh = put(params, specs.param_specs(params, cfg, ax, 2))
        d_sh = put(dsg, specs.dsg_specs(dsg, cfg, ax, 2)) if dsg else None
        if name == "decode":
            c_sh = put(cache, specs.cache_specs(cache, cfg, ax, 2))
            step = jax.jit(lambda p, d, t, c, pos: api.decode_step(
                p, d, cfg, t, c, pos, mesh=mesh, batch_axes=ax.batch))
            logits, new = step(p_sh, d_sh, batch["token"], c_sh, batch["pos"])
            out[name] = {"logits": np.asarray(logits), "k": np.asarray(new["k"]),
                         "v": np.asarray(new["v"])}
            continue
        b_sh = put(batch, specs.input_specs(batch, cfg, ax))
        f = jax.jit(jax.value_and_grad(lambda p, d, b: api.train_loss(
            p, d, cfg, b, mesh=mesh, batch_axes=ax.batch)))
        loss, grads = f(p_sh, d_sh, b_sh)
        out[name] = {"loss": float(loss), "grads": npy(grads)}
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
from repro_torch.parallel.sharding import (axes_for_mesh, distribute,
                                           distribute_model, distribute_tree)
try:
    inputs = wait_load(tmp / "inputs.pkl")
    mesh = make_elastic_mesh(4, model=2, device_type="cpu")
    ax = axes_for_mesh(mesh)
    out = {}
    for name in CASES:
        cfg = cfg_of(configs, name)
        case = inputs[name]
        model = bridge.model_from_jax(case["params"], cfg, device="cpu",
                                      trainable=name != "decode")
        dsg = bridge.dsg_from_jax(case["dsg"], device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
        if name == "decode":
            cache = api.make_cache(cfg, B, MAX_SEQ, device="cpu")
            api.prefill(model, dsg, cfg, {"tokens": batch["prompt"]}, cache)
        distribute_model(model, mesh, specs.param_specs(model, cfg, ax, 2))
        dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, cfg, ax, 2))
        if name == "decode":
            cache = distribute_tree(cache, mesh,
                                    specs.cache_specs(cache, cfg, ax, 2))
            logits, cache = api.decode_step(
                model, dsg, cfg, batch["token"], cache, batch["pos"],
                mesh=mesh, batch_axes=ax.batch)
            out[name] = {"logits": logits.full_tensor().numpy(),
                         "k": cache["k"].full_tensor().numpy(),
                         "v": cache["v"].full_tensor().numpy()}
            continue
        bspecs = specs.input_specs(batch, cfg, ax)
        batch = {k: distribute(v, mesh, bspecs[k]) for k, v in batch.items()}
        params = dict(model.named_parameters())
        with pctx.use_mesh(mesh):
            loss = api.train_loss(model, dsg, cfg, batch, mesh=mesh,
                                  batch_axes=ax.batch)
            grads = torch.autograd.grad(loss, list(params.values()))
        out[name] = {"loss": loss.full_tensor().item(),
                     "grads": {k: g.full_tensor().detach().numpy()
                               for k, g in zip(params, grads)}}
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mh.run(tmp_path_factory.mktemp("sharded_model"), REF, 4, RANKS, 4)


TRAIN_CASES = [c for c in CASES if c != "decode"]


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_loss_matches_the_reference(runs, case):
    ref, got = runs
    assert mh.ulps(got[case]["loss"], ref[case]["loss"]) <= LOSS_ULPS, (
        got[case]["loss"], ref[case]["loss"])


@pytest.mark.parametrize("case", TRAIN_CASES)
def test_sharded_gradients_match_the_reference(runs, case):
    from repro_torch import bridge
    ref, got = runs
    names = list(got[case]["grads"])
    want = bridge.from_reference_tree(ref[case]["grads"], names)
    errs = {n: mh.leaf_err(got[case]["grads"][n], want[n].numpy())
            for n in names}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("part", ["logits", "k", "v"])
def test_split_kv_decode_matches_the_reference(runs, part):
    ref, got = runs
    assert got["decode"][part].shape == ref["decode"][part].shape
    assert mh.leaf_err(got["decode"][part], ref["decode"][part]) \
        <= DECODE_TOL
