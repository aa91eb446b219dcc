"""The port's dry run (`repro_torch.launch.dryrun`) on the CPU: the bytes
per device it lays out against the reference's spec arithmetic, the
skipped cells, the CLI, and the DTensor layout on four real gloo ranks.

The bytes: for every arch's `train_4k` cell on the single-pod mesh (256
fake ranks; the multi-pod mesh is `test_torch_dryrun_pod.py`),
`memory.params`, `memory.dsg`, `memory.opt` and `memory.inputs` (read from
rank 0's DTensor shards of meta tensors) equal the same sums over the reference's
`jax.eval_shape` trees and spec trees: per leaf, its shape with each
sharded dim divided by the product of its axes' sizes, times its item
size.  The reference's optimizer state adds a 4-byte step counter, which
the port keeps on the host.  Every cell leaves no process group behind.

The four-rank test lays the smoke model, its DSG state and its AdamW
state out on a (data 2, model 2) mesh of gloo ranks from rank 0's
tensors: each rank's shards are its slices of rank 0's tensors,
`full_tensor()` gives them back, and each rank's bytes are the dry run's
at that mesh.  Rendezvous is a FileStore in the test's tmp_path (no TCP
port), every rank has a deadline, and a failed rank fails the test.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import shape_by_name as jshape_by_name  # noqa: E402
from repro.models import api as japi, specs as jspecs  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import Axes as JAxes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (fake_world, make_elastic_mesh,  # noqa: E402
                                     make_production_mesh)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}


def _local_bytes(sds, spec, sizes) -> int:
    n = 1
    entries = tuple(spec) + (None,) * (len(sds.shape) - len(spec))
    for dim, e in zip(sds.shape, entries):
        names = () if e is None else (e if isinstance(e, tuple) else (e,))
        div = math.prod(sizes[a] for a in names)
        assert dim % div == 0, (sds.shape, spec)
        n *= dim // div
    return n * sds.dtype.itemsize


def _tree_bytes(tree, spec_tree, sizes) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    specs_ = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(specs_)
    return sum(_local_bytes(x, s, sizes) for x, s in zip(leaves, specs_))


def reference_bytes(arch: str, shape_name: str, mesh: str) -> dict:
    """The reference's per-device bytes of a train or prefill cell's
    params, DSG state, optimizer state (train: m, v and masters, not the
    step counter), inputs and cache (prefill: make_cache's), from its
    eval_shape trees and spec trees."""
    sizes = MESH_SIZES[mesh]
    cfg = jconfigs.get_config(arch)
    shape = jshape_by_name(shape_name)
    batch = ("pod", "data") if mesh == "multi" else ("data",)
    n_data = math.prod(sizes[a] for a in batch)
    ax = JAxes(batch if shape.global_batch % n_data == 0 else None, "model")
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: japi.init_model(key, cfg))
    dsg = jax.eval_shape(lambda p: japi.init_dsg(key, p, cfg), params)
    pspecs = jspecs.param_specs(params, cfg, ax, 16)
    inputs = japi.make_inputs(cfg, shape)
    out = {
        "params": _tree_bytes(params, pspecs, sizes),
        "dsg": _tree_bytes(dsg, jspecs.dsg_specs(dsg, cfg, ax, 16), sizes),
        "inputs": _tree_bytes(inputs, jspecs.input_specs(inputs, cfg, ax),
                              sizes), "opt": 0, "cache": 0}
    if shape.kind == "train":
        master = cfg.dtype == "bfloat16"
        opt = jax.eval_shape(lambda p: jadamw.init_opt(p, master), params)
        ospecs = (jadamw.opt_specs_with_master if master
                  else jadamw.opt_specs)(pspecs, params, zero1=True)
        out["opt"] = sum(_tree_bytes(opt[k], ospecs[k], sizes)
                         for k in opt if k != "step")
    else:
        cache = jax.eval_shape(lambda: japi.make_cache(
            cfg, shape.global_batch, shape.seq_len))
        out["cache"] = _tree_bytes(
            cache, jspecs.cache_specs(cache, cfg, ax, 16), sizes)
    return out


def check_cell_bytes(arch: str, shape: str, mesh: str) -> None:
    """The dry run's per-device bytes of a train or prefill cell equal
    the reference's arithmetic, and the cell leaves no group behind."""
    with fake_world(512 if mesh == "multi" else 256):
        dmesh = make_production_mesh(multi_pod=mesh == "multi",
                                     device_type="cpu")
        mem = dryrun.memory(dryrun.build_cell(arch, shape, dmesh))
    assert not torch.distributed.is_initialized()
    want = reference_bytes(arch, shape, mesh)
    assert {k: mem[k] for k in want} == want
    assert mem["argument_size_in_bytes"] == sum(
        mem[k] for k in ("params", "dsg", "opt", "inputs", "cache"))


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_train_cell_bytes_equal_the_reference_single_pod(arch):
    check_cell_bytes(arch, "train_4k", "single")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "llava-next-34b",
                                  "mistral-nemo-12b"])
def test_long_context_cell_of_a_full_attention_arch_is_skipped(arch):
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ("pure full-attention arch: long_500k requires "
                             "sub-quadratic attention (DESIGN.md §4)")
    assert rec["devices"] == 256 and rec["mesh"] == "single_pod"
    assert not torch.distributed.is_initialized()


def test_cli_writes_the_reference_file_names(tmp_path, capsys):
    out = str(tmp_path)
    dryrun.main(["--arch", "llava-next-34b", "--shape", "long_500k",
                 "--mesh", "multi", "--out", out])
    fname = tmp_path / "llava-next-34b__long_500k__multi__dsg.json"
    rec = json.loads(fname.read_text())
    assert rec["status"] == "skipped" and rec["mesh"] == "multi_pod"
    assert os.listdir(out) == [fname.name]          # no HLO directory
    dryrun.main(["--arch", "llava-next-34b", "--shape", "long_500k",
                 "--mesh", "multi", "--out", out])
    assert "[skip existing]" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--shape", "train_4k", "--out", out])
    with pytest.raises(SystemExit):
        dryrun.main(["--all", "--jobs", "0", "--out", out])


def test_all_runs_one_resumable_subprocess_per_cell(tmp_path, monkeypatch):
    calls = []

    def fake_run(cmd, timeout, check):
        calls.append(cmd)
        if cmd[cmd.index("--arch") + 1] == "zamba2-7b" and \
                cmd[cmd.index("--shape") + 1] == "long_500k":
            raise subprocess.TimeoutExpired(cmd, timeout)

    monkeypatch.setattr(dryrun.subprocess, "run", fake_run)
    (tmp_path / "xlstm-350m__train_4k__multi__dense.json").write_text("{}")
    dryrun.main(["--all", "--no-dsg", "--jobs", "3", "--out", str(tmp_path)])
    assert len(calls) == len(configs.ARCHS) * 4 * 2 - 1
    assert all(c[1:3] == ["-m", "repro_torch.launch.dryrun"]
               and "--no-dsg" in c for c in calls)
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"zamba2-7b__long_500k__{mesh}__dense"
                                     f".json").read_text())
        assert rec["status"] == "error" and "timeout" in rec["error"]


# ---------------------------------------------------------------------------
# the layout on four gloo ranks
# ---------------------------------------------------------------------------

WORKER = r'''
import datetime, json, sys
import torch
import torch.distributed as dist
from repro_torch import configs
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import api, specs, transformer
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import axes_for_mesh, distribute

rank, store_path = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                        rank=rank, world_size=4,
                        timeout=datetime.timedelta(seconds=60))
try:
    cfg = configs.get_smoke_config("internlm2-1.8b").replace(
        dtype="bfloat16")

    def build(seed):
        gen = torch.Generator().manual_seed(seed)
        model = api.init_model(cfg, generator=gen, device="cpu")
        dsg = api.init_dsg(model, cfg, generator=gen, device="cpu")
        transformer.set_trainable(model)
        params = {n: p.detach() for n, p in model.named_parameters()}
        opt = adamw.init_opt(params, use_master=True)
        for key in ("m", "v"):
            for t in opt[key].values():
                t.normal_(generator=gen)
        return model, {"params": params, "dsg": dsg,
                       "opt": {k: opt[k] for k in ("m", "v", "master")}}

    # every rank builds other weights: the layout must carry rank 0's
    model, mine = build(seed=rank)
    _, want = build(seed=0)
    mesh = make_elastic_mesh(4, model=2, device_type="cpu")    # (2, 2)
    ax = axes_for_mesh(mesh)
    pspecs = specs.param_specs(model, cfg, ax, 2)
    sp = {"params": pspecs, "dsg": specs.dsg_specs(mine["dsg"], cfg, ax, 2),
          "opt": dict.fromkeys(("m", "v", "master"),
                               adamw.zero1_specs(pspecs, mine["params"]))}
    nbytes = {}
    for part in ("params", "dsg", "opt"):
        flat = ([(k, t, sp[part][k]) for k, t in mine[part].items()]
                if part != "opt" else
                [(f"{s}.{k}", t, sp[part][s][k])
                 for s in mine[part] for k, t in mine[part][s].items()])
        ref = (want[part] if part != "opt" else
               {f"{s}.{k}": t for s in want[part]
                for k, t in want[part][s].items()})
        nbytes[part] = 0
        for name, t, spec in flat:
            d = distribute(t, mesh, spec)
            local = d.to_local()
            coord = mesh.get_coordinate()
            piece = ref[name]
            for dim_names, c in zip(mesh.mesh_dim_names, coord):
                for i, e in enumerate(spec):
                    names = e if isinstance(e, tuple) else (e,)
                    if dim_names in names:
                        piece = piece.chunk(mesh.size(
                            mesh.mesh_dim_names.index(dim_names)), dim=i)[c]
            assert torch.equal(local, piece), (rank, name, spec)
            assert torch.equal(d.full_tensor(), ref[name]), (rank, name)
            nbytes[part] += local.numel() * local.element_size()
    print(json.dumps({"rank": rank, "bytes": nbytes}), flush=True)
finally:
    dist.destroy_process_group()
'''


def smoke_overrides(arch: str) -> list:
    """--set pairs that turn `arch`'s full config into its smoke config."""
    full, smoke = configs.get_config(arch), configs.get_smoke_config(arch)
    out = [f"{f.name}={getattr(smoke, f.name)!r}"
           for f in dataclasses.fields(full)
           if f.name != "dsg" and getattr(full, f.name) != getattr(smoke,
                                                                    f.name)]
    return out + [f"dsg.{k}={v!r}" for k, v in smoke.dsg._asdict().items()
                  if getattr(full.dsg, k) != v]


def test_dtensor_layout_on_four_gloo_ranks(tmp_path):
    arch = "internlm2-1.8b"
    # the smoke model in bf16, so that AdamW keeps f32 masters
    overrides = smoke_overrides(arch) + ["dtype='bfloat16'"]
    assert dryrun.apply_overrides(configs.get_config(arch), overrides) == \
        configs.get_smoke_config(arch).replace(dtype="bfloat16")
    with fake_world(4):
        mesh = make_elastic_mesh(4, model=2, device_type="cpu")
        mem = dryrun.memory(dryrun.build_cell(
            arch, "train_4k", mesh, overrides=overrides))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), store],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(4)]
    deadline = time.monotonic() + 180
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["rank"] == r
        assert rec["bytes"] == {k: mem[k] for k in ("params", "dsg", "opt")}
