"""The training loop's fault tolerance: checkpoint/restart, a straggler
monitor and failure injection for tests.

The contract:
  * every step is resumable: the model, DSG state, optimizer state and the
    data cursor live in the checkpoint, and the data is a pure function of
    the step, so replaying from step k is bit-exact;
  * a failure surfaces as an exception from the step; the loop restores
    the newest complete checkpoint and goes on, with a bounded number of
    retries per step, and re-raises once they are spent;
  * the straggler monitor records each step's wall time and flags steps
    slower than `factor` x the rolling median.  It also keeps the steps
    that raised (`failures`), so a caller can tell a run that retried
    from one that did not.
The serving side's chaos injector (`ReplicaFault`, `ServingFaultInjector`)
belongs with the router (ROADMAP.md queue 1 item 6).
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

log = logging.getLogger("repro_torch.runtime")


class StragglerMonitor:
    def __init__(self, window: int = 32, factor: float = 1.5):
        self.times = deque(maxlen=window)
        self.factor = factor
        self.flagged = []
        self.failures = []        # (step, repr(exception)) of each retry

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            xs = sorted(self.times)
            median = xs[len(xs) // 2]
            if seconds > self.factor * median:
                self.flagged.append((step, seconds, median))
                is_straggler = True
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, seconds, median)
        self.times.append(seconds)
        return is_straggler


@dataclass
class FaultInjector:
    """Deterministic failure injection for tests: raises at given steps,
    each once."""
    fail_at: tuple = ()
    exc: type = RuntimeError
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise self.exc(f"injected failure at step {step}")


class InjectedFault(RuntimeError):
    """An injected crash: what a device loss or a worker's OOM surfaces
    as, minus the flakiness."""


def run_with_restarts(*, step_fn: Callable, state, make_batch: Callable,
                      ckpt, total_steps: int, start_step: int = 0,
                      ckpt_every: int = 20, max_retries: int = 3,
                      injector: Optional[FaultInjector] = None,
                      on_step: Optional[Callable] = None,
                      monitor: Optional[StragglerMonitor] = None):
    """Fault-tolerant training loop.

    step_fn(state, batch) -> (state, metrics); ckpt: a CheckpointManager
    (or anything with its save_async/restore/wait) or None.  Restores and
    replays on any exception, up to max_retries per step, then re-raises.
    Returns (state, history)."""
    monitor = monitor or StragglerMonitor()
    history = []
    step = start_step
    retries = 0
    while step < total_steps:
        try:
            t0 = time.perf_counter()
            if injector is not None:
                injector.maybe_fail(step)
            batch = make_batch(step)
            state, metrics = step_fn(state, batch)
            dt = time.perf_counter() - t0
            monitor.record(step, dt)
            history.append({"step": step, "seconds": dt, **{
                k: float(v) for k, v in metrics.items()}})
            if on_step is not None:
                on_step(step, state, metrics)
            if ckpt is not None and (step + 1) % ckpt_every == 0:
                ckpt.save_async(step + 1, state, meta={"step": step + 1})
            step += 1
            retries = 0
        except Exception as e:                      # noqa: BLE001
            retries += 1
            monitor.failures.append((step, repr(e)))
            log.error("step %d failed (%s); retry %d/%d", step, e,
                      retries, max_retries)
            if retries > max_retries:
                raise
            if ckpt is not None:
                restored, rstep, _ = ckpt.restore(state)
                if restored is not None:
                    state = restored
                    step = rstep
                    log.info("restored from checkpoint at step %d", rstep)
    if ckpt is not None:
        ckpt.wait()
    return state, history
