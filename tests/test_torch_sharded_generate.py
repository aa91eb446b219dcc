"""`launch.serve.generate(..., mesh=, temperature=, seed=)` on gloo CPU
ranks.

internlm2-1.8b and deepseek-moe-16b at smoke width in f32, DSG on (mask
mode, per-row top-k threshold, as stream comparisons use: ROADMAP.md §3)
and off, with the reference's weights carried across by `bridge.py`:
4 prompts of 8 tokens from a numpy seed, 6 tokens each.  Under (data 1,
model 2) on two ranks and (data 2, model 2) on four, the greedy stream
equals the port's one-rank `generate` and the reference's
`generate(..., mesh=)` on a four-device host mesh.  Sampled at
temperature 0.8 the same seed gives the same stream on one rank and
under the mesh, two seeds differ, and temperature 0 is the greedy
stream.  The recurrent families refuse a mesh (TypeError, as their
`api`) and the encoder-decoder family refuses `generate`.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

# name -> (arch, DSG on)
CASES = {"dense": ("internlm2-1.8b", True),
         "dense_nodsg": ("internlm2-1.8b", False),
         "moe": ("deepseek-moe-16b", True),
         "moe_nodsg": ("deepseek-moe-16b", False)}
B, PROMPT, GEN = 4, 8, 6
TEMP, SEEDS = 0.8, (3, 4)

COMMON = f"""
CASES = {CASES!r}
B, PROMPT, GEN = {B}, {PROMPT}, {GEN}
TEMP, SEEDS = {TEMP!r}, {SEEDS!r}


def cfg_of(configs, name):
    arch, on = CASES[name]
    c = configs.get_smoke_config(arch).replace(dtype="float32")
    return c.replace(dsg=c.dsg._replace(enabled=on, threshold_mode="topk"))
"""

REF = COMMON + r'''
import sys
from pathlib import Path
import numpy as np
import jax
from jax.sharding import Mesh
from repro import configs
from repro.launch.serve import generate
from repro.models import api
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
npy = lambda t: jax.tree.map(np.asarray, t)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
inputs, state = {}, {}
for i, name in enumerate(CASES):
    cfg = cfg_of(configs, name)
    key = jax.random.PRNGKey(40 + i)
    params = api.init_model(key, cfg)
    dsg = api.init_dsg(jax.random.fold_in(key, 1), params, cfg)
    prompts = np.random.default_rng(60 + i).integers(
        0, cfg.vocab, (B, PROMPT), dtype=np.int32)
    inputs[name] = {"params": npy(params), "dsg": npy(dsg),
                    "prompts": prompts}
    state[name] = (cfg, params, dsg, prompts)
dump(inputs, tmp / "inputs.pkl")
out = {name: np.asarray(generate(cfg, params, dsg, prompts, GEN, mesh=mesh))
       for name, (cfg, params, dsg, prompts) in state.items()}
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks, wait_load

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import bridge, configs
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.serve import generate
try:
    inputs = wait_load(tmp.parent / "inputs.pkl", timeout=300)
    mesh = make_elastic_mesh(n, model=2, device_type="cpu")
    out = {}
    for name in CASES:
        cfg = cfg_of(configs, name)
        case = inputs[name]
        prompts = torch.from_numpy(case["prompts"])

        def run(**kw):
            model = bridge.model_from_jax(case["params"], cfg, device="cpu")
            dsg = bridge.dsg_from_jax(case["dsg"], device="cpu")
            return generate(cfg, model, dsg, prompts, GEN, **kw).numpy()

        got = {"one": run(), "mesh": run(mesh=mesh)}
        if name == "dense":
            got["one_sampled"] = run(temperature=TEMP, seed=SEEDS[0])
            for seed in SEEDS:
                got[f"mesh_sampled_{seed}"] = run(mesh=mesh,
                                                  temperature=TEMP,
                                                  seed=seed)
            got["mesh_t0"] = run(mesh=mesh, temperature=0.0, seed=SEEDS[0])
        out[name] = got
    every = [None] * n
    dist.all_gather_object(every, out)
    if rank == 0:
        dump(every, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_generate")
    (tmp / "four").mkdir()
    (tmp / "two").mkdir()
    # the reference writes the inputs both rank groups read
    ref, four = mh.run(tmp / "four", REF.replace(
        'tmp / "inputs.pkl"', 'tmp.parent / "inputs.pkl"'), 4, RANKS, 4,
        timeout=600)
    two = mh.run_ranks(tmp / "two", RANKS, 2, timeout=300)
    return {"ref": ref, 2: two, 4: four}


def _ranks_agree(every):
    for other in every[1:]:
        for name, got in every[0].items():
            for key, stream in got.items():
                assert np.array_equal(stream, other[name][key]), (name, key)
    return every[0]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_greedy_stream_matches_one_rank(runs, ranks, name):
    got = _ranks_agree(runs[ranks])[name]
    assert got["mesh"].shape == (B, GEN)
    assert np.array_equal(got["mesh"], got["one"])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("ranks", [2, 4])
def test_mesh_greedy_stream_matches_the_reference(runs, ranks, name):
    got = _ranks_agree(runs[ranks])[name]
    assert np.array_equal(got["mesh"], runs["ref"][name])


@pytest.mark.parametrize("ranks", [2, 4])
def test_sampled_stream_is_seeded_and_reproducible(runs, ranks):
    got = _ranks_agree(runs[ranks])["dense"]
    first = got[f"mesh_sampled_{SEEDS[0]}"]
    assert np.array_equal(first, got["one_sampled"])
    assert not np.array_equal(first, got[f"mesh_sampled_{SEEDS[1]}"])
    assert not np.array_equal(first, got["mesh"])
    assert np.array_equal(got["mesh_t0"], got["mesh"])


def test_refusals_are_unchanged():
    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import api
    prompts = torch.zeros((1, 4), dtype=torch.long)
    for arch in ("xlstm-350m", "zamba2-7b"):
        cfg = configs.get_smoke_config(arch)
        with pytest.raises(TypeError, match="takes no mesh"):
            generate(cfg, None, None, prompts, 2, mesh=object())
    cfg = configs.get_smoke_config("whisper-large-v3")
    for kw in ({}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="frames"):
            generate(cfg, None, None, prompts, 2, **kw)
    # the recurrent family still generates without a mesh
    cfg = configs.get_smoke_config("xlstm-350m")
    gen = torch.Generator().manual_seed(0)
    model = api.init_model(cfg, generator=gen, device="cpu")
    dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
    assert generate(cfg, model, dsg, prompts, 2).shape == (1, 2)
