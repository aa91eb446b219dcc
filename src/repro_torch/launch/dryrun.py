"""Dry run: every full config's state laid out on the production mesh and
its step traced on shape-only tensors, sharded (the port's analogue of
`repro.launch.dryrun` and `repro.launch.hlo_analysis`).

For an (architecture x input shape x mesh) cell it
  * builds the model, the DSG state and, for a train cell, the AdamW
    state (f32 master weights for a bf16 model) on the meta device
    (shapes and dtypes, no storage, no values); the inputs at the shape's
    global size; for decode, the state `api.prefill` leaves (the
    recurrent families' built from its shapes, with no prefill of the
    prompt: `decode_state`);
  * lays every leaf out as a DTensor on a "fake" process group of the
    mesh's size (256 ranks for (data 16, model 16), 512 for (pod 2,
    data 16, model 16)), a mesh of the card's type, by the spec rules of
    `models/specs.py`, ZeRO-1's for the optimizer state, and records the
    bytes of rank 0's shards;
  * counts the step's global FLOPs on the unsharded model under
    torch.utils.flop_counter.FlopCounterMode (a train step is
    `api.train_loss`, its backward with the remat recompute, over
    cfg.microbatches accumulated, and `adamw.apply_updates`);
  * traces the sharded step once as rank 0 runs it (`trace_sharded`):
    the model's parameters laid out too, a train step as
    `launch.train`'s trainer runs it on a mesh, prefill and decode
    through the `api` verbs (with `mesh=`, but for the recurrent
    families, whose verbs take their layout from their arguments);
    `comm_analysis.CommCounter` counts rank 0's FLOPs, HBM bytes and
    collectives by the reference's kinds (the record's `analysis` and
    `collectives`), and `meta_trace.PeakTracker` the peak of its live
    local storage as torch.distributed's MemTracker counts it
    (`trace_peak_bytes`; less the argument bytes,
    `memory.temp_size_in_bytes`).  The fake group's collectives move
    nothing; each returns its result's shape.

Meta tensors rather than FakeTensorMode's fake CPU tensors: the same
shapes, dtypes and ops, at a third of the time a traced op takes (a
32k-token prefill dispatches about 10^5 ops a layer through the chunked
attention's tiles), and a third of that again with each op's output
shapes cached (`meta_trace.MetaCache`).  Meta tensors are not on the
card, so `kernels/ops.py` takes the plain versions, and no kernel is
launched.

It needs no card: the one entry point of the port that runs on the CPU
by design.  The figures for the 256- and 512-rank meshes are computed,
not measured.

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
from repro_torch.launch import comm_analysis, train
from repro_torch.launch.mesh import (fake_world, make_local_mesh,
                                     make_production_mesh)
from repro_torch.launch.meta_trace import MetaCache, PeakTracker
from repro_torch.models import api, specs, transformer
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import (Axes, axes_for_mesh,
                                           data_shards, distribute,
                                           distribute_model, full_tree,
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
    mesh: object               # the DeviceMesh of the layout


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


def _prefill_state(model, dsg, cfg, batch: int, seq_len: int):
    prompt = api.make_inputs(cfg, ShapeConfig("prompt", seq_len, batch,
                                              "prefill"))
    return api.prefill(model, dsg, cfg, prompt,
                       api.make_cache(cfg, batch, seq_len, device="meta"))[1]


def decode_state(model, dsg, cfg, shape: ShapeConfig):
    """The decode state `api.prefill` leaves after the cell's prompt
    (shape.seq_len tokens), on the meta device.  The recurrent families'
    state is built without the prompt's prefill, as the reference takes
    it from jax.eval_shape: xLSTM's states do not depend on the prompt's
    length, so a one-token prefill gives them; zamba's do too, but for
    the shared attention's K/V, which have the prompt's length (decode
    uses them as a ring, ROADMAP.md §3), so those two leaves are made at
    that length."""
    b = shape.global_batch
    if cfg.family not in api.RECURRENT_FAMILIES:
        return _prefill_state(model, dsg, cfg, b, shape.seq_len)
    st = _prefill_state(model, dsg, cfg, b, 1)
    if cfg.family == "zamba":
        for k in ("k", "v"):
            g, _, _, kv, hd = st[k].shape
            st[k] = st[k].new_empty((g, b, shape.seq_len, kv, hd))
    return st


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
        cache = decode_state(model, dsg, cfg, shape)
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
                inputs, cache, sp, layout, mesh)


def memory(cell: Cell) -> dict:
    """Per-device bytes of each part (rank 0's shards) and their sum."""
    mem = {part: local_bytes(cell.layout.get(part))
           for part in ("params", "dsg", "opt", "inputs", "cache")}
    mem["argument_size_in_bytes"] = sum(mem.values())
    return mem


def train_step(model, dsg, opt, cfg, batch, acfg, read_norm=None,
               mesh=None, batch_axes=None):
    """The port's train step as `launch.train`'s trainer runs it
    (`train.step_grads`, `train.step_update`: on a mesh the gradients
    reduced to the parameters' layout, then to ZeRO-1's, and AdamW), with
    gradient accumulation over cfg.microbatches (the reference's dry
    run's).  Returns the mean loss."""
    loss, grads = train.step_grads(model, dsg, cfg, batch, mesh=mesh,
                                   batch_axes=batch_axes,
                                   microbatches=cfg.microbatches)
    train.step_update(dict(model.named_parameters()), grads, opt, acfg,
                      mesh=mesh, read_norm=read_norm)
    return loss


def _meta_norm(norm) -> float:
    """A meta tensor holds no value: the step's scalars come from a norm
    of 1, which changes no shape and no op of the trace.  A DTensor norm
    is gathered whole first, the collective reading it takes."""
    full_tree(norm)
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
    with MetaCache(), FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def count_flops(cell: Cell) -> int:
    """The step's global FLOPs."""
    return flops_of(step_fn(cell, cell.inputs, cell.cache))


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
    tracker = PeakTracker()
    tracker.track_external(cell.model, *_leaves(cell.dsg),
                           *_leaves(cell.opt), *_leaves(inputs),
                           *_leaves(cache))
    with MetaCache(), tracker:
        step_fn(cell, inputs, cache)()
    batch = next(iter(inputs.values())).shape[0]
    return sum(tracker.peak.values()), batch


def sharded_step_fn(cell: Cell):
    """The cell's step on its layout on the mesh, as a launcher runs it
    there: the model's parameters laid out as DTensors (in place, so
    `count_flops` runs first), the DSG state, the AdamW state (ZeRO-1),
    the inputs and the cache as `build_cell` laid them out; a train step
    by `train_step` with `mesh=`, prefill and decode by the `api` verbs
    with `mesh=` and `batch_axes=` (the recurrent families' without:
    their layout comes from the arguments).  Call it under the mesh's
    parallel context."""
    cfg, shape, mesh, lay = cell.cfg, cell.shape, cell.mesh, cell.layout
    distribute_model(cell.model, mesh, cell.specs["params"])
    if shape.kind == "train":
        opt = dict(lay["opt"], step=0)
        acfg = adamw.AdamWConfig()
        return lambda: train_step(cell.model, lay["dsg"], opt, cfg,
                                  lay["inputs"], acfg, read_norm=_meta_norm,
                                  mesh=mesh, batch_axes=cell.ax.batch)
    kw = ({} if cfg.family in api.RECURRENT_FAMILIES else
          {"mesh": mesh, "batch_axes": cell.ax.batch})
    if shape.kind == "prefill":
        return lambda: api.prefill(cell.model, lay["dsg"], cfg,
                                   lay["inputs"], lay.get("cache"), **kw)
    pos = _decode_pos(cfg, shape)
    return lambda: api.decode_step(cell.model, lay["dsg"], cfg,
                                   lay["inputs"]["token"], lay["cache"],
                                   pos, **kw)


def trace_sharded(cell: Cell) -> tuple:
    """(analysis, peak bytes) of one pass of the sharded step on rank 0
    of the fake process group: `comm_analysis.CommCounter`'s per-device
    FLOPs and collectives, and MemTracker's peak of live local storage
    on the meta device (rank 0's shards of the state, inputs and cache,
    its activations, gradients, temporaries and collective buffers)."""
    fn = sharded_step_fn(cell)
    lay = cell.layout
    tracker = PeakTracker()
    tracker.track_external(cell.model, *_leaves(lay["dsg"]),
                           *_leaves(lay.get("opt")),
                           *_leaves(lay["inputs"]), *_leaves(lay.get("cache")))
    with pctx.use_mesh(cell.mesh, batch_shardable=cell.batch_ok), \
            MetaCache(), tracker, comm_analysis.CommCounter() as counter:
        fn()
    # the device's bytes: DTensor keeps a few host scalars of its own
    return counter.analysis(), tracker.peak.get(torch.device("meta"), 0)


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
        # the card's mesh type: DTensor picks its collectives by it (on
        # a "cpu" mesh an all_to_all becomes an all_gather and a chunk)
        dmesh = (make_local_mesh("cuda") if mesh == "local" else
                 make_production_mesh(multi_pod=mesh == "multi",
                                      device_type="cuda"))
        cell = build_cell(arch, shape, dmesh, dsg_on, remat, overrides)
        rec["memory"] = memory(cell)
        t1 = time.perf_counter()
        flops = count_flops(cell)
        analysis, peak = trace_sharded(cell)
        batch = shape.global_batch // (cell.n_data if cell.batch_ok else 1)
        rec["memory"]["temp_size_in_bytes"] = (
            peak - rec["memory"]["argument_size_in_bytes"])
        t2 = time.perf_counter()
    rec.update({
        "batch_sharded": cell.batch_ok,
        "flops": flops,
        "flops_per_device_ideal": flops / devices,
        "analysis": analysis,
        "trace_peak_bytes": peak,
        "trace_batch": batch,
        "build_s": round(t1 - t0, 2),
        "trace_s": round(t2 - t1, 2),
        "collectives": analysis["collectives"],
        "notes": _notes(batch),
        "status": "ok"})
    return rec


def _notes(batch: int) -> dict:
    return {
        "memory": "per-device bytes of rank 0's DTensor shards by the spec "
                  "rules (ZeRO-1 for the optimizer state); the AdamW step "
                  "count is a host int",
        "flops": "the step's global FLOPs on the unsharded model "
                 "(torch.utils.flop_counter), remat recompute included; "
                 "flops_per_device_ideal is flops / devices",
        "analysis": "rank 0's share of the sharded step, counted at "
                    "dispatch (launch/comm_analysis.py): flops of its "
                    "local ops; collectives by the reference's kinds, "
                    "bytes of each result on this rank (f32_bytes: of "
                    "the f32 ones); bytes: " + comm_analysis.BYTES_NOTE,
        "trace_peak_bytes": "the peak of live local storage over the "
                            "sharded step on rank 0 (its batch "
                            f"{batch}), as MemTracker counts it: the "
                            "state's shards, inputs, cache, activations, "
                            "gradients, temporaries, collective buffers",
        "temp_size_in_bytes": "trace_peak_bytes less "
                              "argument_size_in_bytes",
        "collectives": "analysis['collectives']"}


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
