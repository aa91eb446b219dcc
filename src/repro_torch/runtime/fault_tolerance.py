"""Fault tolerance: the training loop's checkpoint/restart, a straggler
monitor and failure injection, and the serving router's chaos injector.

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

Serving (serving/router.py): `ServingFaultInjector` fires deterministic
`ReplicaFault`s (kill, delay, poison) at replica step boundaries, each
once, and the router's fault tolerance contains them.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

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


# -- serving chaos harness -----------------------------------------------------

#: The token a "poison" fault writes over a lane's last emitted token: out
#: of every vocabulary, so a poisoned stream that survived failover (instead
#: of being replayed from its prompt) cannot pass a stream comparison.
POISON_TOKEN = -7

FAULT_KINDS = ("kill", "delay", "poison")


class InjectedFault(RuntimeError):
    """An injected crash: what a device loss or a worker's OOM surfaces
    as, minus the flakiness."""


@dataclass(frozen=True)
class ReplicaFault:
    """One deterministic serving fault: when replica `replica`'s engine
    reaches step `step`, do `kind`.  "Reaches" is the first step boundary
    whose counter is at or past `step`: a fused decode chunk advances the
    counter by up to a chunk per boundary, so the fault lands on the next
    chunk boundary, the only place the engine can contain it.

      kill   — raise InjectedFault at the step boundary, before the step's
               tokens land;
      delay  — sleep `delay_s` inside the step (a straggler; it trips the
               router's stall timeout when one is set);
      poison — overwrite the last emitted token of every resident lane
               with POISON_TOKEN, then raise: failover must discard the
               partial output and replay from the prompt.
    """
    replica: int
    step: int
    kind: str = "kill"
    delay_s: float = 0.05

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.replica < 0 or self.step < 0:
            raise ValueError(f"replica/step must be >= 0 "
                             f"(got {self.replica}/{self.step})")


class ServingFaultInjector:
    """Deterministic serving faults keyed on (replica index, engine step),
    each firing exactly once, across replica restarts and repeats too,
    until `reset()` re-arms them.

    `attach(engines)` stamps each engine's `replica_index` and installs the
    injector as its `fault_injector`; `ServingEngine.begin_step()` calls
    `on_step(engine)` at every step boundary.  Attach after the warm-up,
    which resets the step counters: a fault keyed on an early step would
    otherwise fire inside it."""

    def __init__(self, faults: Sequence[ReplicaFault]):
        self.faults: List[ReplicaFault] = [
            f if isinstance(f, ReplicaFault) else ReplicaFault(*f)
            for f in faults]
        self._fired: set = set()
        self.log: List[dict] = []      # the faults that fired

    def attach(self, engines) -> None:
        for r, eng in enumerate(engines):
            eng.replica_index = r
            eng.fault_injector = self

    def detach(self, engines) -> None:
        for eng in engines:
            if eng.fault_injector is self:
                eng.fault_injector = None

    def reset(self) -> None:
        """Re-arm every fault."""
        self._fired.clear()
        self.log.clear()

    def on_step(self, eng) -> None:
        for k, f in enumerate(self.faults):
            # at or past the step: a chunked engine's counter jumps by up
            # to a chunk per boundary
            if (k in self._fired or f.replica != eng.replica_index
                    or eng.steps < f.step):
                continue
            self._fired.add(k)
            self.log.append({"replica": f.replica, "step": f.step,
                             "kind": f.kind})
            if f.kind == "delay":
                time.sleep(f.delay_s)
                continue
            if f.kind == "poison":
                for slot in eng.slots:
                    if slot.req is not None and slot.req.output:
                        slot.req.output[-1] = POISON_TOKEN
            raise InjectedFault(f"injected {f.kind} at replica {f.replica} "
                                f"step {f.step}")


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
