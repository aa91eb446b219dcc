"""Fault-tolerant DSG training loop and CLI (the port of `repro.launch.train`).

config -> model + DSG state -> train step (autograd through the DRS-masked
forward, optional ternary gradient compression with error feedback, AdamW
with f32 master weights for bf16 models) -> f(W) refresh every
cfg.dsg.refresh_every steps -> synthetic data -> async checkpoints ->
straggler monitor -> crash/restore loop.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --arch zamba2-7b --steps 2        # or xlstm-350m: the recurrent archs

The CLI refuses `--arch whisper-large-v3`: the synthetic stream has tokens
and no audio frames (the reference's CLI crashes on it); the
encoder-decoder trains through `api.train_loss` and `trainer_for` on
`api.make_inputs`' batches.

Runs on the card unless `--device cpu` (or device="cpu") asks for the CPU;
without a card it exits with an error.

On a mesh (`build_trainer(..., mesh=)`, `train(mesh=)`, the CLI's
`--production-mesh`), every rank of the process group runs the same
program: the parameters, DSG state, AdamW state (ZeRO-1: its leaves split
over 'data' as well) and error-feedback buffers are DTensors laid out by
`models.specs` and `optim.adamw`'s specs; the step runs the sharded loss
and its backward under the mesh's parallel context, and the update on the
shards.  Each rank reads its own rows of the batch
(`synthetic.make_global_batch`); rank 0 writes the checkpoints, gathered
whole, and every rank restores its shards from them.

  torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
      --production-mesh            # (data 16, model 16): 256 ranks
"""
from __future__ import annotations

import argparse
import logging
import time
from contextlib import nullcontext

import torch

from repro_torch import bridge, configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.models import specs as mspecs
from repro_torch.optim.compress import init_feedback, \
    tree_compress_with_feedback
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import (axes_for_mesh, distribute_model,
                                           distribute_tree, full_tree,
                                           model_shards, placements)
from repro_torch.runtime.fault_tolerance import StragglerMonitor, \
    run_with_restarts

log = logging.getLogger("repro_torch.train")


def loss_grads(loss: torch.Tensor, params: dict) -> list:
    """d loss / d p for every parameter, in order; zeros for a parameter
    the loss does not read (an mLSTM's `skip`), as jax.grad gives."""
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params.values())]


def trainer_for(model, dsg, cfg, acfg: adamw.AdamWConfig, *,
                grad_compress: bool = False, mesh=None):
    """(state, step_fn, refresh_fn) for an existing model and DSG state,
    whose parameters are made trainable.  state is {'model', 'dsg', 'opt'}
    plus 'err' with gradient compression; step_fn(state, batch) -> (state,
    metrics {'loss', 'grad_norm', 'lr'}) updates it in place;
    refresh_fn(state) recomputes f(W).  With `mesh` the model and DSG
    state (whole, on every rank, or rank 0's copy taken) are laid out on
    it first, and state gains 'mesh' and 'specs'."""
    sspecs = None
    if mesh is not None:
        ax, n_model = axes_for_mesh(mesh), model_shards(mesh)
        pspecs = mspecs.param_specs(model, cfg, ax, n_model)
        sspecs = {"params": pspecs,
                  "dsg": mspecs.dsg_specs(dsg, cfg, ax, n_model)}
        distribute_model(model, mesh, pspecs)
        dsg = distribute_tree(dsg, mesh, sspecs["dsg"])
    transformer.set_trainable(model)
    params = dict(model.named_parameters())
    use_master = cfg.dtype == "bfloat16"
    if mesh is None:
        opt = adamw.init_opt(params, use_master)
        err = init_feedback(params) if grad_compress else None
    else:
        sspecs["opt"] = (adamw.opt_specs_with_master(pspecs, params)
                         if use_master else adamw.opt_specs(pspecs, params))
        opt = _opt_on_mesh(params, use_master, mesh, sspecs["opt"])
        err = ({n: torch.zeros_like(p.detach(), dtype=torch.float32)
                for n, p in params.items()} if grad_compress else None)
    state = {"model": model, "dsg": dsg, "opt": opt}
    if grad_compress:
        state["err"] = err
    if mesh is not None:
        state.update(mesh=mesh, specs=sspecs)
    device = next(model.parameters()).device
    batch_axes = axes_for_mesh(mesh).batch if mesh is not None else None

    def on_mesh():
        return pctx.use_mesh(mesh) if mesh is not None else nullcontext()

    def lay_batch(batch):
        if mesh is None:
            return {k: v.to(device, non_blocking=True)
                    for k, v in batch.items()}
        from torch.distributed.tensor import DTensor
        from repro_torch.parallel.sharding import distribute
        bspecs = mspecs.input_specs(batch, cfg, axes_for_mesh(mesh))
        return {k: v if isinstance(v, DTensor)
                else distribute(v.to(device), mesh, bspecs[k])
                for k, v in batch.items()}

    def step_fn(state, batch):
        params = dict(state["model"].named_parameters())
        with on_mesh():
            loss, grads = step_grads(state["model"], state["dsg"], cfg,
                                     lay_batch(batch), mesh=mesh,
                                     batch_axes=batch_axes)
            if grad_compress:
                # ternary codes + error feedback on the gradient stream
                grads, state["err"] = tree_compress_with_feedback(
                    grads, state["err"], group=_stacked_leaf)
            _, _, metrics = step_update(params, grads, state["opt"], acfg,
                                        mesh=mesh)
        metrics["loss"] = loss
        return state, metrics

    def refresh_fn(state):
        with on_mesh():
            dsg = api.refresh_dsg(state["dsg"], state["model"], cfg)
        if mesh is not None and dsg is not None:
            dsg = {k: v.redistribute(mesh, placements(
                mesh, state["specs"]["dsg"][k])) for k, v in dsg.items()}
        return {**state, "dsg": dsg}

    return state, step_fn, refresh_fn


def _microbatch(t: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Slice i of n of the batch rows.  A DTensor is sliced on each
    rank's own rows, with no collective: microbatch i holds slice i of
    every data shard."""
    from repro_torch.parallel.sharding import is_dtensor
    if n == 1:
        return t
    if not is_dtensor(t):
        return t.chunk(n)[i]
    from torch.distributed.tensor import DTensor
    shape = (t.shape[0] // n,) + tuple(t.shape[1:])
    return DTensor.from_local(t.to_local().chunk(n)[i], t.device_mesh,
                              t.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def step_grads(model, dsg, cfg, batch: dict, *, mesh=None, batch_axes=None,
               microbatches: int = 1) -> tuple:
    """(loss, grads) of one training step: the mean loss, read whole, and
    d loss / d p for every parameter.  Over `microbatches` slices of the
    batch each slice's gradients are summed in f32 and the sum divided by
    the count (the reference's dry run's accumulation); one slice gives
    the gradients as they come.  On a mesh (run it under the mesh's
    parallel context) the slices' gradients, the ranks' partial sums,
    are summed on each rank and reduced once to the parameters' own
    layout (`collectives.reduce_partials`)."""
    params = dict(model.named_parameters())
    mb = max(1, microbatches)
    grads = None
    # the recurrent families' loss takes its layout from its arguments
    loss_mesh = None if cfg.family in api.RECURRENT_FAMILIES else mesh
    for i in range(mb):
        part = api.train_loss(model, dsg, cfg,
                              {k: _microbatch(v, i, mb)
                               for k, v in batch.items()},
                              mesh=loss_mesh, batch_axes=batch_axes)
        g = loss_grads(part, params)
        if mb == 1:
            grads, loss = dict(zip(params, g)), part.detach()
        elif grads is None:
            grads = {n: x.float() for n, x in zip(params, g)}
            loss = part.detach()
        else:
            for n, x in zip(params, g):
                grads[n].add_(x)
            loss = loss + part.detach()
        del g              # not held through the next slice's step
    if mesh is not None:
        # the ranks' partial sums, accumulated over the slices, reduced
        # once to the parameters' own layout
        from repro_torch.parallel.collectives import reduce_partials
        grads = reduce_partials(grads, {n: p.placements
                                        for n, p in params.items()})
    if mb > 1:
        for x in grads.values():
            x.div_(mb)
        loss = loss / mb
    return full_tree(loss), grads


def step_update(params: dict, grads: dict, opt: dict,
                acfg: adamw.AdamWConfig, *, mesh=None, read_norm=None):
    """`adamw.apply_updates` on the step's gradients.  On a mesh (under
    its parallel context) each rank first keeps its ZeRO-1 slice of them,
    and the global norm is read whole unless `read_norm` reads it."""
    if mesh is not None:
        # ZeRO-1: each rank keeps its slice of the gradients
        grads = {n: g.redistribute(mesh, opt["m"][n].placements)
                 for n, g in grads.items()}
        read_norm = read_norm or _read_dtensor
    return adamw.apply_updates(params, grads, opt, acfg,
                               read_norm=read_norm)


def _stacked_leaf(name: str) -> tuple:
    """The reference's tree path of a parameter: its stacked leaf."""
    return bridge.reference_path(name)[0]


def _read_dtensor(t) -> float:
    return full_tree(t).item()


def _opt_on_mesh(params: dict, use_master: bool, mesh, ospecs: dict
                 ) -> dict:
    """AdamW's state for DTensor parameters, laid out by `ospecs` (the
    ZeRO-1 specs): zero moments and f32 master copies, each rank making
    only its own shards."""
    def lay(t, spec):
        return t.redistribute(mesh, placements(mesh, spec))

    def zeros(key):
        return {n: lay(torch.zeros_like(p.detach(), dtype=torch.float32),
                       ospecs[key][n]) for n, p in params.items()}
    st = {"step": 0, "m": zeros("m"), "v": zeros("v")}
    if use_master:
        st["master"] = {n: lay(p.detach().float(), ospecs["master"][n])
                        for n, p in params.items()}
    return st


def build_trainer(cfg, acfg: adamw.AdamWConfig, *,
                  grad_compress: bool = False, seed: int = 0,
                  device="cuda", mesh=None):
    """Random weights and DSG state from a generator seeded with `seed`,
    on the card unless `device` says otherwise; returns trainer_for's
    (state, step_fn, refresh_fn).  With `mesh` (a DeviceMesh of 'data',
    'model' and perhaps 'pod' axes over the process group) every rank
    calls this, and the state is laid out on the mesh."""
    device = api.require_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = api.init_model(cfg, generator=gen, device=device)
    dsg = api.init_dsg(model, cfg, generator=gen, device=device)
    return trainer_for(model, dsg, cfg, acfg, grad_compress=grad_compress,
                       mesh=mesh)


class TrainCheckpoint:
    """A CheckpointManager over the trainer's state: saved and restored in
    the reference's tree layout (`bridge.state_tree`), in place.  On a
    mesh every rank gathers the state whole, rank 0 alone writes it, and
    every rank restores its own shards from the written tree."""

    def __init__(self, manager: CheckpointManager, mesh=None):
        self.manager = manager
        self.mesh = mesh

    def _writer(self) -> bool:
        from torch import distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    @staticmethod
    def _tree(state):
        return bridge.state_tree(state["model"], state["dsg"], state["opt"],
                                 state.get("err"))

    def save_async(self, step: int, state, meta=None):
        tree = self._tree(state)
        if self._writer():
            self.manager.save_async(step, tree, meta)

    def restore(self, state):
        self.wait()
        tree, step, meta = self.manager.restore(self._tree(state))
        if tree is None:
            return None, None, None
        bridge.load_state_tree(tree, state["model"], state["dsg"],
                               state["opt"], state.get("err"))
        return state, step, meta

    def wait(self):
        """The writer's checkpoint on disk; on a mesh every rank waits for
        it."""
        self.manager.wait()
        if self.mesh is not None:
            from torch import distributed as dist
            dist.barrier()


def train(cfg, *, steps: int = 100, ckpt_dir=None, ckpt_every: int = 20,
          grad_compress: bool = False, global_batch: int = 8,
          seq_len: int = 64, seed: int = 0, injector=None,
          log_every: int = 10, device="cuda", init=None, mesh=None):
    """Train for `steps` steps on `synthetic.batch_at(step, seed=seed)`.
    `init` = (model, dsg) starts from given weights (a bridged
    initialisation) instead of random ones.  With `mesh` every rank of
    the process group calls this; the state is sharded on the mesh and
    each rank reads its rows of the batch (`synthetic.make_global_batch`).
    Returns (state, history, monitor); each history entry has the step's
    loss, grad_norm, lr, seconds (the step's wall time, the device's work
    included: the metrics are read back before the clock stops) and
    refresh (1.0 where f(W) was refreshed after the step)."""
    acfg = adamw.AdamWConfig(total_steps=steps,
                             warmup=min(20, steps // 5 + 1))
    if init is None:
        state, step_fn, refresh_fn = build_trainer(
            cfg, acfg, grad_compress=grad_compress, seed=seed, device=device,
            mesh=mesh)
    else:
        state, step_fn, refresh_fn = trainer_for(
            *init, cfg, acfg, grad_compress=grad_compress, mesh=mesh)

    ckpt = (TrainCheckpoint(CheckpointManager(ckpt_dir), mesh)
            if ckpt_dir else None)
    start = 0
    if ckpt is not None:
        restored, rstep, _ = ckpt.restore(state)
        if restored is not None:
            state, start = restored, rstep
            log.info("resumed from step %d", start)

    def make_batch(step):
        kw = dict(global_batch=global_batch, seq_len=seq_len,
                  vocab=cfg.vocab, seed=seed)
        if mesh is None:
            return synthetic.batch_at(step, **kw)
        ax = axes_for_mesh(mesh)
        spec = mspecs.input_specs({"tokens": torch.empty(0, 0)}, cfg,
                                  ax)["tokens"]
        return synthetic.make_global_batch(
            step, mesh, {"tokens": spec, "labels": spec}, **kw)

    monitor = StragglerMonitor()
    refresh_every = max(1, cfg.dsg.refresh_every)

    def step_with_refresh(state, batch):
        state, metrics = step_fn(state, batch)
        refresh = cfg.dsg.enabled and state["opt"]["step"] % refresh_every == 0
        if refresh:
            state = refresh_fn(state)    # the paper: every 50 steps
        metrics = {k: float(v) for k, v in metrics.items()}
        return state, dict(metrics, refresh=float(refresh))

    state, history = run_with_restarts(
        step_fn=step_with_refresh, state=state, make_batch=make_batch,
        ckpt=ckpt, total_steps=steps, start_step=start,
        ckpt_every=ckpt_every, injector=injector, monitor=monitor,
        on_step=(lambda s, st, m: log.info("step %d loss %.4f", s, m["loss"])
                 if s % log_every == 0 else None))
    if ckpt is not None and mesh is not None:
        ckpt.wait()
    return state, history, monitor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        epilog="--production-mesh runs every rank of a process group set "
               "up from torchrun's environment (RANK, WORLD_SIZE, "
               "MASTER_ADDR, MASTER_PORT).")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, d=64)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--production-mesh", action="store_true",
                    help="(data 16, model 16) over 256 ranks")
    return ap


def _mesh_from_env(device: torch.device):
    """The process group from torchrun's environment, and the production
    mesh over it (each rank on its own card, or the CPU)."""
    import datetime
    import os
    from torch import distributed as dist
    from repro_torch.launch import mesh as lmesh
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            timeout=datetime.timedelta(minutes=10))
    return lmesh.make_production_mesh(device_type=device.type)


def main(argv=None):
    ap = build_parser()
    args, unknown = ap.parse_known_args(argv)
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)} (not ported "
                 f"to repro_torch yet; see ROADMAP.md)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to run on "
                 "the CPU")
    for flag in ("steps", "batch", "seq"):
        if getattr(args, flag) < 1:
            ap.error(f"--{flag} must be >= 1, got {getattr(args, flag)}")
    logging.basicConfig(level=logging.INFO)
    try:
        cfg = (configs.get_smoke_config(args.arch) if args.smoke
               else configs.get_config(args.arch))
    except KeyError as e:
        ap.error(str(e))
    if cfg.family == "encdec":
        from repro_torch.launch.serve import ENCDEC_REFUSAL
        ap.error(f"--arch {args.arch}: {ENCDEC_REFUSAL}")
    mesh = None
    if args.production_mesh:
        if cfg.family in api.RECURRENT_FAMILIES:
            ap.error(f"--arch {args.arch}: --production-mesh does not lay "
                     f"out the recurrent families yet; train(mesh=) does "
                     f"(ROADMAP.md §3)")
        import os
        from torch import distributed as dist
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            ap.error("a mesh runs one process a rank: start them with "
                     "torchrun (README.md)")
        # fewer ranks than the mesh: the mesh builder's own error
        mesh = _mesh_from_env(device)
    t0 = time.perf_counter()
    _, history, monitor = train(cfg, steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                grad_compress=args.grad_compress,
                                global_batch=args.batch, seq_len=args.seq,
                                device=device, mesh=mesh)
    losses = [h["loss"] for h in history]
    if not losses:
        print(f"steps=0: the checkpoint in {args.ckpt_dir} already reaches "
              f"step {args.steps}")
        return history
    print(f"steps={len(history)} first_loss={losses[0]:.4f} "
          f"last_loss={losses[-1]:.4f} wall={time.perf_counter()-t0:.1f}s "
          f"stragglers={len(monitor.flagged)}")
    return history


if __name__ == "__main__":
    main()
