"""Dry run: every full config's state laid out on the production mesh and
its step traced on shape-only tensors (the port's analogue of
`repro.launch.dryrun` and `repro.launch.hlo_analysis`).

For an (architecture x input shape x mesh) cell it
  * builds the model, the DSG state and, for a train cell, the AdamW
    state (f32 master weights for a bf16 model) on the meta device
    (shapes and dtypes, no storage, no values); the inputs at the shape's
    global size; for decode, the state `api.prefill` leaves;
  * lays every leaf out as a DTensor on a "fake" process group of the
    mesh's size (256 ranks for (data 16, model 16), 512 for (pod 2,
    data 16, model 16)) by the spec rules of `models/specs.py`, ZeRO-1's
    for the optimizer state, and records the bytes of rank 0's shards;
  * traces the step on the unsharded model: at the global batch under
    torch.utils.flop_counter.FlopCounterMode (the step's global FLOPs; a
    train step is `api.train_loss`, its backward with the remat
    recompute, over cfg.microbatches accumulated, and
    `adamw.apply_updates`), and at one data shard's batch under
    torch.distributed's MemTracker (the peak bytes of live tensors).

Meta tensors rather than FakeTensorMode's fake CPU tensors: the same
shapes, dtypes and ops, at a third of the time a traced op takes (a
32k-token prefill dispatches about 10^5 ops a layer through the chunked
attention's tiles).  Meta tensors are not on the card, so `kernels/ops.py`
takes the plain versions, and no kernel is launched.

It needs no card: the one entry point of the port that runs on the CPU
by design.  No collective is traced: the sharded step's collectives on
the fake backend are ROADMAP.md queue 1 item 9c, so a record's
`collectives` is null.  The
figures for the 256- and 512-rank meshes are computed, not measured.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      mistral-nemo-12b --shape train_4k --mesh single --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --jobs 6 \\
      --out /tmp/dryrun
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeConfig, shape_by_name
from repro_torch.launch import train
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import api, specs, transformer
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (Axes, axes_for_mesh,
                                           data_shards, distribute,
                                           model_shards)

MESHES = {"single": ("single_pod", 256), "multi": ("multi_pod", 512),
          "local": ("local", 1)}
CELL_TIMEOUT_S = 3600
SKIP_REASON = ("pure full-attention arch: long_500k requires sub-quadratic "
               "attention (DESIGN.md §4)")


def apply_overrides(cfg, overrides):
    """--set key=value pairs onto ModelConfig (dotted 'dsg.*' reaches the
    DSGConfig).  Values are literal-eval'd with string fallback."""
    for kv in overrides or ():
        key, val = kv.split("=", 1)
        try:
            val = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        if key.startswith("dsg."):
            cfg = cfg.replace(dsg=cfg.dsg._replace(**{key[4:]: val}))
        else:
            cfg = cfg.replace(**{key: val})
    return cfg


@dataclass
class Cell:
    """A cell's state on the meta device: the plain tensors the step runs
    on, their specs, and their DTensor layout on the mesh."""
    cfg: object
    shape: ShapeConfig
    ax: Axes
    n_data: int
    batch_ok: bool
    model: torch.nn.Module
    dsg: Optional[dict]
    opt: Optional[dict]
    inputs: dict
    cache: Optional[dict]      # prefill: make_cache's; decode: prefill's
    specs: dict                # part -> tree of specs
    layout: dict               # part -> tree of DTensors


def _leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _zip_map(fn, tree, spec_tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, spec_tree[k]) for k, v in tree.items()}
    return fn(tree, spec_tree)


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree of DTensors."""
    return sum(t.to_local().numel() * t.to_local().element_size()
               for t in _leaves(tree))


def _decode_pos(cfg, shape: ShapeConfig):
    """The last position of the decode cache, as the step takes it: (B,)
    for the decoder families, one int shared by the batch otherwise."""
    if cfg.family == "encdec":
        return shape.seq_len // cfg.dec_ratio - 1
    if cfg.family in api.DECODER_FAMILIES:
        return torch.full((shape.global_batch,), shape.seq_len - 1,
                          dtype=torch.int32, device="meta")
    return shape.seq_len - 1


def build_cell(arch: str, shape, mesh, dsg_on: bool = True,
               remat: bool = True, overrides=None) -> Cell:
    """The cell's state on the meta device and its layout on `mesh` (a
    DeviceMesh over a fake process group).  `shape` is a ShapeConfig or
    its name."""
    cfg = configs.get_config(arch)
    if not dsg_on:
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    if not remat:
        cfg = cfg.replace(remat=False)
    cfg = apply_overrides(cfg, overrides)
    if not isinstance(shape, ShapeConfig):
        shape = shape_by_name(shape)
    ax = axes_for_mesh(mesh)
    n_model, n_data = model_shards(mesh), data_shards(mesh)
    batch_ok = shape.global_batch % n_data == 0
    if not batch_ok:
        ax = Axes(batch=None, model=ax.model)
    model = api.init_model(cfg, generator=None, device="meta")
    dsg = api.init_dsg(model, cfg, generator=None, device="meta") \
        if cfg.dsg.enabled else None
    params = dict(model.named_parameters())
    pspecs = specs.param_specs(model, cfg, ax, n_model)
    sp = {"params": pspecs,
          "dsg": specs.dsg_specs(dsg, cfg, ax, n_model)}
    opt = cache = None
    inputs = api.make_inputs(cfg, shape)
    if shape.kind == "train":
        transformer.set_trainable(model)
        use_master = cfg.dtype == "bfloat16"
        opt = adamw.init_opt(params, use_master)
        ospecs = (adamw.opt_specs_with_master if use_master
                  else adamw.opt_specs)(pspecs, params, zero1=True)
        # the port keeps the step count on the host
        sp["opt"] = {k: v for k, v in ospecs.items() if k != "step"}
    elif shape.kind == "prefill":
        cache = api.make_cache(cfg, shape.global_batch, shape.seq_len,
                               device="meta")
    else:
        prompt = api.make_inputs(cfg, ShapeConfig(
            "prompt", shape.seq_len, shape.global_batch, "prefill"))
        cache = api.prefill(
            model, dsg, cfg, prompt,
            api.make_cache(cfg, shape.global_batch, shape.seq_len,
                           device="meta"))[1]
    sp["inputs"] = specs.input_specs(inputs, cfg, ax)
    if cache is not None:
        sp["cache"] = specs.cache_specs(cache, cfg, ax, n_model)
    state = {"params": {n: p.detach() for n, p in params.items()},
             "dsg": dsg, "inputs": inputs, "cache": cache,
             "opt": None if opt is None else
             {k: v for k, v in opt.items() if k != "step"}}
    layout = {part: _zip_map(lambda t, s: distribute(t, mesh, s),
                             state[part], sp[part]) for part in sp}
    return Cell(cfg, shape, ax, n_data, batch_ok, model, dsg, opt,
                inputs, cache, sp, layout)


def memory(cell: Cell) -> dict:
    """Per-device bytes of each part (rank 0's shards) and their sum."""
    mem = {part: local_bytes(cell.layout.get(part))
           for part in ("params", "dsg", "opt", "inputs", "cache")}
    mem["argument_size_in_bytes"] = sum(mem.values())
    return mem


def train_step(model, dsg, opt, cfg, batch, acfg, read_norm=None):
    """The port's train step as `launch.train` runs it, with gradient
    accumulation over cfg.microbatches (the reference's dry run's): each
    microbatch's f32 gradients summed, then divided by the count.
    Returns the mean loss."""
    params = dict(model.named_parameters())
    mb = max(1, cfg.microbatches)
    if mb == 1:
        loss = api.train_loss(model, dsg, cfg, batch)
        grads = dict(zip(params, train.loss_grads(loss, params)))
        loss = loss.detach()
    else:
        grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device) for n, p in params.items()}
        loss = 0.0
        for i in range(mb):
            b = {k: v.chunk(mb)[i] for k, v in batch.items()}
            part = api.train_loss(model, dsg, cfg, b)
            for acc, g in zip(grads.values(),
                              train.loss_grads(part, params)):
                acc.add_(g)
            loss = loss + part.detach()
        for g in grads.values():
            g.div_(mb)
        loss = loss / mb
    adamw.apply_updates(params, grads, opt, acfg, read_norm=read_norm)
    return loss


def _meta_norm(norm) -> float:
    """A meta tensor holds no value: the step's scalars come from a norm
    of 1, which changes no shape and no op of the trace."""
    return 1.0


def _shard_batch(t: torch.Tensor, spec, ax: Axes, n_data: int):
    """A tensor like `t` with its batch-sharded dim cut to one data
    shard's size."""
    shape = list(t.shape)
    for i, e in enumerate(spec):
        if ax.batch is not None and e == ax.batch:
            shape[i] //= n_data
    return t.new_empty(shape)


def step_fn(cell: Cell, inputs: dict, cache):
    """The cell's step on the given inputs and decode state."""
    cfg, shape = cell.cfg, cell.shape
    if shape.kind == "train":
        acfg = adamw.AdamWConfig()
        return lambda: train_step(cell.model, cell.dsg, cell.opt, cfg,
                                  inputs, acfg, read_norm=_meta_norm)
    if shape.kind == "prefill":
        return lambda: api.prefill(cell.model, cell.dsg, cfg, inputs, cache)
    b = inputs["token"].shape[0]
    pos = _decode_pos(cfg, ShapeConfig(shape.name, shape.seq_len, b,
                                       shape.kind))
    return lambda: api.decode_step(cell.model, cell.dsg, cfg,
                                   inputs["token"], cache, pos)


def flops_of(fn) -> int:
    """The FLOPs of the matmul-class ops (mm, bmm, addmm, baddbmm,
    convolution, attention) that torch's FLOP counter sees `fn()` run."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def count_flops(cell: Cell) -> int:
    """The step's global FLOPs."""
    return flops_of(step_fn(cell, cell.inputs, cell.cache))


def _peak_tracker():
    """torch.distributed's MemTracker counting the bytes of live tensor
    storages, without its per-module statistics: those refuse a module
    called a second time from the top level, as the port's norms are
    (called from functions, once a microbatch; zamba's shared block once
    a group)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class PeakTracker(MemTracker):
        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass

    return PeakTracker()


def trace_peak(cell: Cell) -> tuple:
    """(peak bytes, batch) of the step traced at one data shard's batch
    with the model unsharded: the most bytes of tensor storage live at
    once (parameters, DSG and optimizer state, inputs, caches,
    activations, gradients, temporaries)."""
    inputs = _zip_map(lambda t, s: _shard_batch(t, s, cell.ax,
                                                cell.n_data),
                      cell.inputs, cell.specs["inputs"])
    cache = _zip_map(lambda t, s: _shard_batch(t, s, cell.ax,
                                               cell.n_data),
                     cell.cache, cell.specs.get("cache"))
    tracker = _peak_tracker()
    tracker.track_external(cell.model, *_leaves(cell.dsg),
                           *_leaves(cell.opt), *_leaves(inputs),
                           *_leaves(cache))
    with tracker:
        step_fn(cell, inputs, cache)()
    peak = tracker.get_tracker_snapshot("peak")
    batch = next(iter(inputs.values())).shape[0]
    return sum(v["Total"] for v in peak.values()), batch


def run_cell(arch: str, shape, multi_pod: bool = False, dsg_on: bool = True,
             remat: bool = True, overrides=None, tag: str = None,
             mesh: str = None) -> dict:
    """The cell's record.  `shape` is a ShapeConfig or its name; `mesh`
    "single", "multi" or "local" (1 x 1) overrides `multi_pod`.  Sets up
    a fake process group of the mesh's size and leaves none behind."""
    mesh = mesh or ("multi" if multi_pod else "single")
    mesh_name, devices = MESHES[mesh]
    if not isinstance(shape, ShapeConfig):
        shape = shape_by_name(shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "devices": devices, "dsg": dsg_on,
           "overrides": list(overrides or ()), "tag": tag}
    if not configs.cell_is_runnable(arch, shape.name):
        rec["status"] = "skipped"
        rec["reason"] = SKIP_REASON
        return rec
    t0 = time.perf_counter()
    with fake_world(devices):
        dmesh = (make_local_mesh("cpu") if mesh == "local" else
                 make_production_mesh(multi_pod=mesh == "multi",
                                      device_type="cpu"))
        cell = build_cell(arch, shape, dmesh, dsg_on, remat, overrides)
        rec["memory"] = memory(cell)
    t1 = time.perf_counter()
    flops = count_flops(cell)
    peak, batch = trace_peak(cell)
    t2 = time.perf_counter()
    rec.update({
        "batch_sharded": cell.batch_ok,
        "flops": flops,
        "flops_per_device_ideal": flops / devices,
        "trace_peak_bytes": peak,
        "trace_batch": batch,
        "build_s": round(t1 - t0, 2),
        "trace_s": round(t2 - t1, 2),
        "collectives": None,
        "notes": {
            "memory": "per-device bytes of rank 0's DTensor shards by the "
                      "spec rules (ZeRO-1 for the optimizer state); the "
                      "AdamW step count is a host int",
            "flops": "the step's global FLOPs on the unsharded model "
                     "(torch.utils.flop_counter), remat recompute "
                     "included; flops_per_device_ideal is flops / devices",
            "trace_peak_bytes": f"MemTracker's peak of the step traced at "
                                f"one data shard's batch ({batch}) with "
                                f"the model unsharded",
            "collectives": "not traced yet: ROADMAP.md queue 1 item "
                           "9c"},
        "status": "ok"})
    return rec


def _fname(out, arch, shape, mesh, tag) -> str:
    return os.path.join(out, f"{arch}__{shape}__{mesh}__{tag}.json")


def run_all(out: str, no_dsg: bool, jobs: int = 1) -> None:
    """Every arch x shape x mesh cell, one subprocess each (its own
    memory and time limit), `jobs` at a time; cells whose file exists are
    skipped, so an interrupted run resumes."""
    from concurrent.futures import ThreadPoolExecutor
    tag = "dense" if no_dsg else "dsg"
    todo = []
    for arch in configs.ARCHS:
        for shape in SHAPES:
            for mesh in ("single", "multi"):
                fname = _fname(out, arch, shape.name, mesh, tag)
                if os.path.exists(fname):
                    print(f"[skip existing] {fname}", flush=True)
                else:
                    todo.append((arch, shape.name, mesh, fname))

    def one(cell):
        arch, shape, mesh, fname = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out", out] + (
                   ["--no-dsg"] if no_dsg else [])
        try:
            subprocess.run(cmd, timeout=CELL_TIMEOUT_S, check=False)
        except subprocess.TimeoutExpired:
            with open(fname, "w") as f:
                json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                           "status": "error",
                           "error": f"timeout ({CELL_TIMEOUT_S}s)"}, f)
            print(f"  -> TIMEOUT {arch} {shape} {mesh}", flush=True)

    with ThreadPoolExecutor(max_workers=jobs) as pool:
        for f in [pool.submit(one, c) for c in todo]:
            f.result()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells --all runs at once (one process each)")
    ap.add_argument("--no-dsg", action="store_true")
    ap.add_argument("--set", nargs="*", default=None,
                    help="cfg overrides, e.g. dsg.mode=gather_shared")
    ap.add_argument("--tag", default=None,
                    help="variant tag for output filenames")
    ap.add_argument("--out", default="results")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.all:
        if args.jobs < 1:
            ap.error(f"--jobs must be >= 1, got {args.jobs}")
        run_all(args.out, args.no_dsg, args.jobs)
        return
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required without --all")
    tag = args.tag or ("dense" if args.no_dsg else "dsg")
    fname = _fname(args.out, args.arch, args.shape, args.mesh, tag)
    if os.path.exists(fname):
        print(f"[skip existing] {fname}")
        return
    print(f"[dryrun] {args.arch} x {args.shape} x {args.mesh} ({tag}) ...",
          flush=True)
    try:
        rec = run_cell(args.arch, args.shape, args.mesh == "multi",
                       dsg_on=not args.no_dsg, overrides=args.set, tag=tag)
    except Exception as e:     # the record says why; --all goes on
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"  -> {rec['status']}"
          + (f" trace={rec['trace_s']}s" if "trace_s" in rec else "")
          + (f" err={rec.get('error', '')[:300]}"
             if rec["status"] == "error" else ""), flush=True)


if __name__ == "__main__":
    main()
