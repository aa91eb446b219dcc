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
without a card it exits with an error.  The ZeRO-1 optimizer layout is
planned (`optim.adamw.zero1_specs`, `launch.dryrun`), but training over
the production mesh waits for the model to run sharded (ROADMAP.md
queue 1 item 9b).
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch import bridge, configs
from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data import synthetic
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.optim.compress import init_feedback, \
    tree_compress_with_feedback
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
                grad_compress: bool = False):
    """(state, step_fn, refresh_fn) for an existing model and DSG state,
    whose parameters are made trainable.  state is {'model', 'dsg', 'opt'}
    plus 'err' with gradient compression; step_fn(state, batch) -> (state,
    metrics {'loss', 'grad_norm', 'lr'}) updates it in place;
    refresh_fn(state) recomputes f(W)."""
    transformer.set_trainable(model)
    params = dict(model.named_parameters())
    state = {"model": model, "dsg": dsg,
             "opt": adamw.init_opt(params, cfg.dtype == "bfloat16")}
    if grad_compress:
        state["err"] = init_feedback(params)
    device = next(model.parameters()).device

    def step_fn(state, batch):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        params = dict(state["model"].named_parameters())
        loss = api.train_loss(state["model"], state["dsg"], cfg, batch)
        grads = dict(zip(params, loss_grads(loss, params)))
        if grad_compress:
            # ternary codes + error feedback on the gradient stream
            grads, state["err"] = tree_compress_with_feedback(
                grads, state["err"])
        _, _, metrics = adamw.apply_updates(params, grads, state["opt"],
                                            acfg)
        metrics["loss"] = loss.detach()
        return state, metrics

    def refresh_fn(state):
        return {**state, "dsg": api.refresh_dsg(state["dsg"], state["model"],
                                                cfg)}

    return state, step_fn, refresh_fn


def build_trainer(cfg, acfg: adamw.AdamWConfig, *,
                  grad_compress: bool = False, seed: int = 0,
                  device="cuda"):
    """Random weights and DSG state from a generator seeded with `seed`,
    on the card unless `device` says otherwise; returns trainer_for's
    (state, step_fn, refresh_fn)."""
    device = api.require_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = api.init_model(cfg, generator=gen, device=device)
    dsg = api.init_dsg(model, cfg, generator=gen, device=device)
    return trainer_for(model, dsg, cfg, acfg, grad_compress=grad_compress)


class TrainCheckpoint:
    """A CheckpointManager over the trainer's state: saved and restored in
    the reference's tree layout (`bridge.state_tree`), in place."""

    def __init__(self, manager: CheckpointManager):
        self.manager = manager

    @staticmethod
    def _tree(state):
        return bridge.state_tree(state["model"], state["dsg"], state["opt"],
                                 state.get("err"))

    def save_async(self, step: int, state, meta=None):
        self.manager.save_async(step, self._tree(state), meta)

    def restore(self, state):
        tree, step, meta = self.manager.restore(self._tree(state))
        if tree is None:
            return None, None, None
        bridge.load_state_tree(tree, state["model"], state["dsg"],
                               state["opt"], state.get("err"))
        return state, step, meta

    def wait(self):
        self.manager.wait()


def train(cfg, *, steps: int = 100, ckpt_dir=None, ckpt_every: int = 20,
          grad_compress: bool = False, global_batch: int = 8,
          seq_len: int = 64, seed: int = 0, injector=None,
          log_every: int = 10, device="cuda", init=None):
    """Train for `steps` steps on `synthetic.batch_at(step, seed=seed)`.
    `init` = (model, dsg) starts from given weights (a bridged
    initialisation) instead of random ones.  Returns (state, history,
    monitor); each history entry has the step's loss, grad_norm, lr,
    seconds (the step's wall time, the device's work included: the
    metrics are read back before the clock stops) and refresh (1.0 where
    f(W) was refreshed after the step)."""
    acfg = adamw.AdamWConfig(total_steps=steps,
                             warmup=min(20, steps // 5 + 1))
    if init is None:
        state, step_fn, refresh_fn = build_trainer(
            cfg, acfg, grad_compress=grad_compress, seed=seed, device=device)
    else:
        state, step_fn, refresh_fn = trainer_for(
            *init, cfg, acfg, grad_compress=grad_compress)

    ckpt = TrainCheckpoint(CheckpointManager(ckpt_dir)) if ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored, rstep, _ = ckpt.restore(state)
        if restored is not None:
            state, start = restored, rstep
            log.info("resumed from step %d", start)

    def make_batch(step):
        return synthetic.batch_at(step, global_batch=global_batch,
                                  seq_len=seq_len, vocab=cfg.vocab,
                                  seed=seed)

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
    return state, history, monitor


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        epilog="--production-mesh waits for the model to run sharded "
               "(ROADMAP.md queue 1 item 9b).")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, d=64)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


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
    t0 = time.perf_counter()
    _, history, monitor = train(cfg, steps=args.steps,
                                ckpt_dir=args.ckpt_dir,
                                grad_compress=args.grad_compress,
                                global_batch=args.batch, seq_len=args.seq,
                                device=device)
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
