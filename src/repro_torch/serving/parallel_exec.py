"""Replica executors: how the router's N serving replicas run.

  * sequential — replicas step in index order inside the router tick;
                 per-replica busy time is recorded and
                 `Router.makespan_seconds()` is MODELED from it (the
                 slowest replica's busy time).  The executor every other
                 mode is held against.
  * threaded   — one free-running worker thread per replica, each driving
                 its own engine, while the router thread dispatches
                 against live introspection.  Makespan is MEASURED.
  * sharded    — one group tick runs every replica's decode step (chunk
                 1) or fused chunk (chunk > 1) back to back, each on its
                 own operands and cache: on the card as ONE CUDA-graph
                 replay keyed by (the group's live-page bucket, sample),
                 on the CPU eagerly one after another.  Makespan is
                 MEASURED.

On one card the replicas share the caller's model tensors (one copy of the
weights) and each owns its cache, its DSG runtime and its graph pool.
Under the threaded executor each worker makes its replica's own
`torch.cuda.Stream` current (the current stream is per thread), so the
kernels, the graph replays, the staging copy and the read-back of a step
all follow that stream, and a step's read-back waits on that stream only.
Nothing on a step's path synchronises the whole device; a graph capture
would (and fails in global mode while another thread launches work), so
captures are closed for the drive: `warmup_router` captures every key
first, and a key first met during the drive raises.

Determinism: at temperature 0 a lane's stream does not depend on its
co-resident lanes, so the merged uid-keyed streams are the same whatever
the replica count, the policy and the executor (tests/test_torch_router.py
and tests/test_torch_parallel_exec.py hold them to the reference's).  The
threaded executor gives up placement reproducibility: dispatch follows live
timing, so sampled streams are reproducible only under the lockstep
executors.

The router dispatches through executor-owned `ReplicaProxy` objects:
attribute reads and writes forward to the engine, and `submit` goes
through the executor, which wakes the replica's worker.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.contracts import (CheckedCondition, GuardedDeque,
                                            GuardedDict, GuardedList,
                                            locked_by, owned_by, runs_on,
                                            tsan_enabled)
from repro_torch.serving import cuda_graphs
from repro_torch.serving import scheduler as sched

EXEC_MODES = ("sequential", "threaded", "sharded")


class ReplicaFailure(RuntimeError):
    """A replica's engine raised during a step.  Carries the replica's
    `index` and the original exception (`cause`) so that the router's
    fault tolerance can contain it; str() embeds the cause's message, so
    callers that match on it keep working when the router re-raises."""

    def __init__(self, index: int, cause: BaseException):
        super().__init__(f"replica {index} failed: {cause}")
        self.index = index
        self.cause = cause


class ReplicaProxy:
    """Executor-owned handle for one replica: attribute reads and writes
    forward to the `ServingEngine` (so `queue_depth()`, `free_slots()`,
    `free_pages()`, `can_admit_request()`, ... work unchanged), while
    `submit` goes through the executor.  It holds its executor weakly, so
    that a dropped router frees its engines (and their caches and graph
    pools) at once, not at the next garbage collection."""

    __slots__ = ("_executor", "index")

    def __init__(self, executor: "ReplicaExecutor", index: int):
        object.__setattr__(self, "_executor", weakref.proxy(executor))
        object.__setattr__(self, "index", index)

    @property
    def engine(self):
        """The wrapped ServingEngine (direct access for warm-up and
        stats)."""
        return self._executor.engines[self.index]

    def submit(self, req):
        """Dispatch `req` to this replica through the executor."""
        self._executor.dispatch(self.index, req)

    def __getattr__(self, name):
        return getattr(self._executor.engines[self.index], name)

    def __setattr__(self, name, value):
        setattr(self._executor.engines[self.index], name, value)

    def __repr__(self):
        return (f"ReplicaProxy({self.index}, "
                f"executor={self._executor.name!r})")


class ReplicaExecutor:
    """How a router's replica group executes: the lockstep protocol
    (`lockstep=True`: the router tick calls `step_all(indices)` and each
    named replica advances one step) or the free-running one
    (`lockstep=False`: `drive(router, max_steps)` owns the run loop).

    `busy_seconds[i]` accumulates replica i's stepping time and
    `wall_seconds` the real time of `step_all`/`drive` calls; `measured`
    tells the router which one `makespan_seconds()` reports."""

    name = "abstract"
    lockstep = True
    #: True when replicas really overlap, so that wall_seconds (and not
    #: the modeled max busy time) is the makespan
    measured = False

    def __init__(self, engines: Sequence):
        self.engines = list(engines)
        self.proxies = [ReplicaProxy(self, i)
                        for i in range(len(self.engines))]
        self.busy_seconds = [0.0] * len(self.engines)
        self.wall_seconds = 0.0

    def dispatch(self, index: int, req):
        """Hand `req` to replica `index` (from the router thread)."""
        self.engines[index].submit(req)

    def step_all(self, indices: Sequence[int]):
        """Advance every replica in `indices` one step (lockstep only)."""
        raise NotImplementedError

    def drive(self, router, max_steps: int):
        """Run the router's whole drain loop (free-running only)."""
        raise NotImplementedError(
            f"{self.name!r} is a lockstep executor; the router drives it "
            f"through step_all()")

    def reset_timing(self):
        self.busy_seconds = [0.0] * len(self.engines)
        self.wall_seconds = 0.0

    def warm(self, sample: bool = False):
        """Capture any executor-owned graphs (the engines' own are captured
        by workload.warmup_engine).  Only the sharded executor has any."""

    def close(self):
        """Release executor resources (worker threads).  Idempotent."""

    @staticmethod
    def has_work(eng) -> bool:
        """Whether an engine has queued requests or a resident lane: the
        busy predicate the router and every executor share."""
        return bool(eng.queue) or any(not s.free for s in eng.slots)


class SequentialExecutor(ReplicaExecutor):
    """Replicas step one after another in index order inside the router
    tick.  The makespan is MODELED (the slowest replica's busy time):
    stepping is serialised, so the wall clock would hide the parallel
    gain."""

    name = "sequential"
    lockstep = True
    measured = False

    def step_all(self, indices):
        t0 = time.perf_counter()
        try:
            for i in indices:
                ti = time.perf_counter()
                try:
                    # each engine's step is whole (begin, dispatch, commit),
                    # so a failure never corrupts a sibling replica; the
                    # replicas after `i` skip this tick
                    self.engines[i].step()
                except BaseException as e:
                    raise ReplicaFailure(i, e) from e
                finally:
                    self.busy_seconds[i] += time.perf_counter() - ti
        finally:
            self.wall_seconds += time.perf_counter() - t0


@locked_by("_cond", "_idle", "_errors", "busy_seconds", "_stop",
           "_progress")
@owned_by("router", "_threads", "wall_seconds")
class ThreadedExecutor(ReplicaExecutor):
    """One free-running worker thread per replica.

    Workers step their own engine whenever it has work; the router thread
    is the only dispatcher and `dispatch()` wakes the chosen replica's
    worker.  There is no per-tick barrier: a replica draining light
    requests never waits for a sibling in a long generation.  On one card
    the drive is host-bound: at full width it measured 1.3-1.8x slower
    than stepping the replicas in turn (`chip_smoke.py` phase 20 on an
    NVIDIA H100 80GB HBM3 at 700 W; PERF.md), the workers' host halves
    contending for the interpreter.

    On the card each worker runs on its replica's own stream.  A drive
    orders the streams after the caller's current stream at its start and
    the caller's stream after them at its end; a worker whose step raised
    synchronises its stream before the router reclaims the engine, so the
    reclaim's page-table writes cannot race its kernels.  The engines'
    graph captures are closed for the drive.

    Greedy merged streams equal the sequential executor's bit for bit;
    `makespan_seconds()` is the measured wall clock of the drive loop.
    Workers are daemon threads, started at the first `drive()` and parked
    between runs; `close()` joins them, each within 5 s.
    """

    name = "threaded"
    lockstep = False
    measured = True
    # the router's safety-net poll: worker -> router wakes ride a sticky
    # Event, so this only bounds recovery from a crashed worker or an
    # external submit
    _POLL_S = 0.1

    def __init__(self, engines):
        super().__init__(engines)
        # REPRO_TSAN=1, read here: the Condition learns who holds it and
        # the annotated mutable state asserts the lock/owner discipline on
        # every mutation
        self._tsan = tsan_enabled()
        self._cond = (CheckedCondition() if self._tsan
                      else threading.Condition(threading.RLock()))
        self._router_wake = threading.Event()
        self._idle = [True] * len(self.engines)
        self._errors: List[ReplicaFailure] = []
        # per-replica stamp of the last completed step: the stall-timeout
        # detector compares against it while a worker is busy
        self._progress = [time.perf_counter()] * len(self.engines)
        self._stop = False
        self._threads: Optional[List[threading.Thread]] = None
        self._streams = [torch.cuda.Stream(device=e.device)
                         if e.device.type == "cuda" else None
                         for e in self.engines]
        if self._tsan:
            self._idle = GuardedList(self._idle, cond=self._cond,
                                     label="ThreadedExecutor._idle")
            self._errors = GuardedList(cond=self._cond,
                                       label="ThreadedExecutor._errors")
            self._progress = GuardedList(
                self._progress, cond=self._cond,
                label="ThreadedExecutor._progress")
            self.busy_seconds = GuardedList(
                self.busy_seconds, cond=self._cond,
                label="ThreadedExecutor.busy_seconds")
            for i, eng in enumerate(self.engines):
                eng.queue = GuardedDeque(eng.queue, cond=self._cond,
                                         label=f"engines[{i}].queue")
                eng.done = GuardedDict(eng.done, cond=self._cond,
                                       label=f"engines[{i}].done")

    def _own_engine(self, i: int, thread):
        """TSAN bookkeeping: give the 'worker' role of replica `i` to a
        live thread, or back to quiescent (None: anyone may mutate, e.g.
        warm-up or stats on the main thread between drives)."""
        if not self._tsan:
            return
        eng = self.engines[i]
        for obj in (eng.queue, eng.done):
            set_owner = getattr(obj, "set_owner", None)
            if set_owner is not None:
                set_owner(thread)

    def _on_stream(self, i: int):
        """Make replica `i`'s stream current in this thread (a no-op
        context on the CPU)."""
        s = self._streams[i]
        return torch.cuda.stream(s) if s is not None else \
            contextlib.nullcontext()

    def _captures(self, open_: bool):
        """Open or close the engines' graph captures."""
        for eng in self.engines:
            if eng.graphs is not None:
                eng.graphs.capture_open = open_

    # -- dispatch ---------------------------------------------------------------

    @runs_on("router")
    def dispatch(self, index, req):
        with self._cond:
            self.engines[index].submit(req)
            self._cond.notify_all()

    # -- worker protocol --------------------------------------------------------

    @runs_on("router")
    def _ensure_threads(self):
        """Start (or re-staff) one worker per replica.  A worker exits when
        its engine raises (the error re-raises in drive), so a later run()
        replaces dead workers; parked live workers are kept."""
        with self._cond:
            old = self._threads or [None] * len(self.engines)
            if all(t is not None and t.is_alive() for t in old):
                return
            if not any(t is not None and t.is_alive() for t in old):
                self._stop = False   # fully stopped: safe to restart
            if self._stop:
                return               # close() timed out on a live worker
            self._threads = []
            for i in range(len(self.engines)):
                t = old[i]
                if t is None or not t.is_alive():
                    # start() under the lock is safe: the worker first
                    # acquires the cond, so it waits until we release
                    t = threading.Thread(target=self._worker, args=(i,),
                                         daemon=True, name=f"replica-{i}")
                    t.start()
                self._threads.append(t)

    @runs_on("worker")
    def _worker(self, i: int):
        eng = self.engines[i]
        stream = self._streams[i]
        with self._on_stream(i):
            while True:
                with self._cond:
                    self._own_engine(i, None)     # parked: engine quiescent
                    while not self._stop and not self.has_work(eng):
                        self._idle[i] = True
                        self._router_wake.set()
                        self._cond.wait()
                    if self._stop:
                        return
                    self._idle[i] = False
                    # a fresh stall clock at the idle -> busy transition, or
                    # a worker woken after a long idle would be suspected
                    # before its first step ends
                    self._progress[i] = time.perf_counter()
                    self._own_engine(i, threading.current_thread())
                while True:                      # step outside the lock
                    done0 = len(eng.done)
                    queued0 = len(eng.queue)
                    t0 = time.perf_counter()
                    try:
                        eng.step()
                    except BaseException as e:   # surfaced by the drive loop
                        if stream is not None:
                            # the router reclaims the engine next; let this
                            # stream's kernels end first.  A sync that
                            # raises means the device is lost, and the
                            # step's own error is the one reported.
                            with contextlib.suppress(BaseException):
                                stream.synchronize()
                        with self._cond:
                            self._errors.append(ReplicaFailure(i, e))
                            self._idle[i] = True
                            self._own_engine(i, None)
                            self._router_wake.set()
                        return
                    dt = time.perf_counter() - t0
                    with self._cond:
                        # the makespan code reads busy_seconds while
                        # workers run
                        self.busy_seconds[i] += dt
                        self._progress[i] = time.perf_counter()
                    # wake the router only on what a policy can act on: a
                    # retirement freed a lane, or an admission drained
                    # this replica's queue
                    if len(eng.done) != done0 or len(eng.queue) < queued0:
                        self._router_wake.set()
                    # engines are between steps here, so stopping is safe
                    if self._stop or not self.has_work(eng):
                        break                    # outer loop parks

    # -- drive --------------------------------------------------------------------

    @runs_on("router")
    def drive(self, router, max_steps: int):
        """Drain the router: dispatch from this (the router's) thread, let
        the workers free-run, return when no queued or resident work is
        left.  Worker exceptions re-raise unless the router opted into
        fault tolerance, which contains them (reclaim and re-dispatch) and
        re-staffs the dead worker; the router-stall error (every worker
        parked, the policy deferring the head) then fails requests one by
        one instead.  With `stall_timeout_s`, a busy worker that makes no
        step progress gets its replica marked SUSPECT and its engine
        aborted at the next step boundary."""
        caller = [torch.cuda.current_stream(s.device)
                  if s is not None else None for s in self._streams]
        for s, c in zip(self._streams, caller):
            if s is not None:
                s.wait_stream(c)
        self._captures(False)
        self._ensure_threads()
        ft = getattr(router, "ft", None)
        t0 = time.perf_counter()
        reopen = True
        try:
            with self._cond:
                now = time.perf_counter()
                for i in range(len(self.engines)):
                    self._progress[i] = now    # stall clock starts now
                self._cond.notify_all()      # work may predate the drive
            while router.steps < max_steps:
                with self._cond:             # dispatch and the parked check
                    if self._errors:         # are atomic against parking
                        err = self._errors.pop(0)
                        if not router._handle_replica_failure(err):
                            raise err
                        # contained: re-staff the dead worker (a DEAD
                        # replica's worker just parks, starved by
                        # routable()) with a fresh stall clock
                        self._progress[err.index] = time.perf_counter()
                        self._ensure_threads()
                        self._cond.notify_all()
                        router.steps += 1
                        continue
                    if ft is not None and ft.stall_timeout_s is not None:
                        now = time.perf_counter()
                        for i in range(len(self.engines)):
                            if (not self._idle[i]
                                    and now - self._progress[i]
                                    > ft.stall_timeout_s):
                                router._on_replica_stall(i)
                    router._expire_deadlines()
                    router._dispatch()       # safe: the RLock is re-entrant
                    all_parked = (all(self._idle) and
                                  not any(self.has_work(e)
                                          for e in self.engines))
                    if all_parked and not router.queue:
                        return               # drained
                    if all_parked and router.queue:
                        if ft is not None:
                            router._fail_undispatchable()
                            router.steps += 1
                            continue
                        raise RuntimeError(
                            f"router stalled: {len(router.queue)} queued "
                            f"request(s) undispatchable by policy "
                            f"{router.policy.name!r} while all replicas "
                            f"are idle; raise cache_tokens or lower "
                            f"max_new/prompt_bucket")
                    router.steps += 1
                # wait outside the lock: the sticky Event keeps a wake that
                # fires between the check and the wait
                self._router_wake.wait(timeout=self._POLL_S)
                self._router_wake.clear()
            # the step budget ran out with work left: stop the workers so
            # that the snapshot run() returns is stable
            self.close()
        except BaseException:
            # stop the workers before the captures open again: one still
            # stepping could otherwise capture behind the caller's back.
            # A worker stuck in a step keeps them closed.
            reopen = not self._join()
            raise
        finally:
            if reopen:
                self._captures(True)
            for s, c in zip(self._streams, caller):
                if s is not None:
                    c.wait_stream(s)
            self.wall_seconds += time.perf_counter() - t0

    @runs_on("router")
    def reset_timing(self):
        """The base reset under the lock; under TSAN the rebinding made a
        plain list of busy_seconds, so it is wrapped again."""
        with self._cond:
            super().reset_timing()
            if self._tsan:
                self.busy_seconds = GuardedList(
                    self.busy_seconds, cond=self._cond,
                    label="ThreadedExecutor.busy_seconds")

    @runs_on("router")
    def close(self):
        """Idempotent shutdown: signal every worker, join each within 5 s,
        and raise naming any that did not exit (a worker stuck inside one
        step) instead of leaking it.  `_stop` stays set so that it exits at
        its next step boundary; call close() again to confirm."""
        stuck = self._join()
        if stuck:
            # restarting now could put two workers on one engine, so the
            # executor stays stopped until the straggler exits
            raise RuntimeError(
                f"ThreadedExecutor.close(): worker thread(s) "
                f"{', '.join(stuck)} did not exit within 5s (stuck "
                f"inside a step); they exit at their next step boundary "
                f"— call close() again to confirm shutdown")

    @runs_on("router")
    def _join(self) -> List[str]:
        """Signal every worker to stop and join each within 5 s; returns
        the names of those still alive (stuck inside a step).  When all
        exited, the executor is stopped and can restart."""
        with self._cond:
            threads = self._threads or ()
            if not threads:
                return []                # already closed
            self._stop = True
            self._cond.notify_all()
        for t in threads:
            t.join(timeout=5.0)
        stuck = [t.name for t in threads if t.is_alive()]
        if not stuck:
            with self._cond:
                self._threads = None
                self._stop = False
        return stuck


class ShardedExecutor(ReplicaExecutor):
    """One dispatch for the whole replica group.

    Each lockstep tick runs the host half of every active replica's step
    (`ServingEngine.begin_step()`), then one group body that holds every
    replica's fused chunk (of one micro-step at chunk 1) back to back,
    each on its own operands, cache and shapes, then each replica's
    commit.  On the card the group body is one CUDA graph replay, captured
    once per (the group's live-page bucket, sample) in the executor's own
    graph pool; `warm()` captures every key.  On the CPU the same bodies
    run eagerly.  The reference stacks the replicas' caches on a replica
    axis and vmaps one step over them; here each replica keeps its own
    cache and shapes, so that no GEMM changes shape and no cache byte is
    restacked.

    Every tick runs the full group: a replica with no work rides along on
    `_dummy_plan` (every lane done, mirroring lane 0 at position 0).  Its
    writes land where nothing reads them: an idle paged engine's page-table
    rows are all the scratch page, which is never allocated or indexed,
    and an idle dense engine's stripes are overwritten whole at the next
    admission.  The paged walk bound is the group's deepest; a lane's
    result does not depend on the bound.

    Engines with the DSG serving runtime are refused, as in the reference
    (their CSR and refresh variants dispatch inside `ServingEngine.step`),
    and so is `mesh=`: a replica mesh is ROADMAP.md queue 1 item 9c."""

    name = "sharded"
    lockstep = True
    measured = True

    def __init__(self, engines, mesh=None):
        super().__init__(engines)
        if any(getattr(e, "dsg_rt", None) is not None for e in engines):
            raise NotImplementedError(
                "sharded executor batches the plain decode step; DSG-serving "
                "engines dispatch the CSR/refresh variants inside "
                "ServingEngine.step() — use exec_mode 'sequential' or "
                "'threaded' with dsg_serving")
        if mesh is not None:
            raise NotImplementedError(
                "the sharded executor runs its replica group on one device; "
                "a replica mesh is not ported (ROADMAP.md queue 1 item 9c)")
        self.chunk = 1
        self.graphs = None
        # begin-phase failures deferred past the group step (one raise a
        # tick keeps sibling replicas consistent; see step_all)
        self._pending_failures: List[ReplicaFailure] = []
        if not self.engines:
            return
        e0 = self.engines[0]
        if any(e.decode_chunk != e0.decode_chunk for e in self.engines):
            raise ValueError(
                "sharded executor needs a homogeneous decode_chunk across "
                "replicas (the group step is one variant): got "
                f"{[e.decode_chunk for e in self.engines]}")
        if any(e.device != e0.device for e in self.engines):
            raise ValueError("sharded executor needs every replica on one "
                             "device")
        self.chunk = e0.decode_chunk
        if e0.device.type == "cuda":
            words = sum(9 * e.n_slots for e in self.engines)
            self.graphs = cuda_graphs.GraphCache(e0.device, words)
            # no tick replays an engine's own chunk graphs: drop them, so
            # that warming an engine (its prefills) captures nothing
            for e in self.engines:
                e.graphs = None

    @staticmethod
    def _dummy_plan(eng) -> sched.StepPlan:
        """Ride-along operands for an engine with no active lane this tick:
        every lane done, mirroring lane 0 at position 0."""
        n = eng.n_slots
        zeros = np.zeros(n, np.int32)
        return sched.StepPlan(
            active=[], tok=zeros, pos=zeros, free_mask=np.ones(n, np.bool_),
            live_pages=0, temps=np.zeros(n, np.float32),
            top_ps=np.ones(n, np.float32), draws=zeros, nth=zeros,
            sample=False, chunk=eng.decode_chunk,
            eos_ids=np.full(n, -1, np.int32), emit_left=np.ones(n, np.int32))

    def _group(self, plans, live: int, sample: bool) -> List[np.ndarray]:
        """Run every replica's fused chunk (of one micro-step at chunk 1)
        for `plans`: one staged copy, one graph replay and one read-back on
        the card, the chunks in turn on the CPU.  Returns each replica's
        packed host output (blk, flags, final tokens)."""
        arrays = [e._chunk_operands(p) for e, p in zip(self.engines, plans)]
        if self.graphs is None:
            return [e._chunk_fn([torch.from_numpy(np.ascontiguousarray(a))
                                 for a in ops], live, False, sample).numpy()
                    for e, ops in zip(self.engines, arrays)]
        flat = [a for ops in arrays for a in ops]
        shapes = [a.shape for a in flat]

        def fn():
            views = self.graphs.views(shapes)
            return torch.cat([e._chunk_fn(views[9 * r:9 * r + 9], live,
                                          False, sample)
                              for r, e in enumerate(self.engines)])
        self.graphs.stage(flat)
        out = self.graphs.replay((live, sample), fn).cpu().numpy()
        sizes = [(2 * self.chunk + 1) * e.n_slots for e in self.engines]
        return np.split(out, np.cumsum(sizes)[:-1])

    def step_all(self, indices):
        t0 = time.perf_counter()
        if self._pending_failures:       # deferred from the previous tick
            raise self._pending_failures.pop(0)
        idx = set(indices)
        plans, real, failures = [], [], []
        for i, eng in enumerate(self.engines):
            plan = None
            if i in idx:
                try:
                    plan = eng.begin_step()
                except BaseException as e:
                    # siblings that began this tick have emitted tokens:
                    # finish the group without the failed replica (it
                    # rides a dummy plan) and raise after the commits
                    failures.append(ReplicaFailure(i, e))
            if plan is not None:
                real.append(i)
            plans.append(plan if plan is not None
                         else self._dummy_plan(eng))
        if not real:
            self.wall_seconds += time.perf_counter() - t0
            if failures:
                self._pending_failures.extend(failures[1:])
                raise failures[0]
            return
        live = max(p.live_pages for p in plans)
        sample = any(p.sample for p in plans)
        outs = self._group(plans, live, sample)
        wall = time.perf_counter() - t0
        share = wall / len(real)
        for i, plan in enumerate(plans):
            if i in idx and plan.active:
                # decode_seconds gets an equal share of the group dispatch,
                # busy_seconds all of it (the replica was busy for all of
                # it); the makespan is wall_seconds either way
                eng, out = self.engines[i], outs[i]
                c, b = self.chunk, eng.n_slots
                if c > 1:
                    eng.commit_chunk(
                        plan, out[:c * b].reshape(c, b),
                        out[c * b:2 * c * b].reshape(c, b).astype(bool),
                        out[2 * c * b:], share)
                else:                    # a live lane's final token is next
                    eng.commit_step(plan, out[2 * b:], share)
                self.busy_seconds[i] += wall
        self.wall_seconds += wall
        if failures:
            self._pending_failures.extend(failures[1:])
            raise failures[0]

    def warm(self, sample: bool = False):
        """Capture the group graph of every live-page bucket the group can
        reach, greedy and, with `sample`, sampling (warmup_router calls
        it), then clear the replay counts.  All-dummy plans: nothing reads
        their writes.  On the CPU there is nothing to capture."""
        if self.graphs is None:
            return
        e0 = self.engines[0]
        if e0.cache.kind == "paged":
            buckets = sched.live_page_buckets(
                e0.max_seq // e0.backend.page_size)
        else:
            buckets = (0,)
        plans = [self._dummy_plan(e) for e in self.engines]
        for live in buckets:
            for do_sample in sorted({False, sample}):
                self._group(plans, live, do_sample)
        # the replays counted from here on are a measured run's
        self.graphs.replays.clear()


def get_executor(mode, engines, *, mesh=None) -> ReplicaExecutor:
    """Executor factory: name -> a fresh executor over `engines`.  Every
    replica runs on the one device of its model, so a `mesh` raises."""
    if mesh is not None:
        raise NotImplementedError(
            "replica meshes are not ported: every replica runs on its "
            "model's device (ROADMAP.md queue 1 item 9c)")
    if mode == "sequential":
        return SequentialExecutor(engines)
    if mode == "threaded":
        return ThreadedExecutor(engines)
    if mode == "sharded":
        return ShardedExecutor(engines, mesh=mesh)
    raise ValueError(f"unknown exec mode {mode!r}; "
                     f"expected one of {EXEC_MODES}")
