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

With `mesh=` (a `replicas` mesh, `parallel.sharding.replica_mesh`) the
sharded executor spans the ranks of the process group, one process a
rank: rank k builds and runs only its block of replicas
(`sharding.replica_block`), in its own group graphs on its own device,
and rank 0 alone routes.  Rank 0 holds a `RemoteReplica` for every
replica another rank runs, and each command it sends (a tick, an
admission check, a reset) comes back with every replica's record over a
gloo group on CPU objects (`ControlGroup`).  No weight, cache or
activation crosses ranks, and each rank sends its requests' time stamps
on rank 0's clock (`ShardedExecutor._follow`), so that the ranks may run
on hosts whose clocks differ.  Engines on several cards of one process (the
router's `models=` and the threaded placement) each run with their card
current, since the hand-written kernels launch on the calling thread's
current device (`on_device`).
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import itertools
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


def on_device(device: torch.device):
    """Make `device` current in this thread while the context is open (a
    no-op context off CUDA).  The hand-written kernels launch on the
    calling thread's current device, and their wrappers raise when the
    operands lie on another card (`kernels.cuda_lib.stream`)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class RemoteError(RuntimeError):
    """What a replica's engine raised on the rank that runs it, carried
    to rank 0 as its message: str() is the original exception's, so that
    the router's health events read as in one process."""


class RemoteReplica:
    """Rank 0's stand-in for a replica that another rank of a replica mesh
    runs (`ShardedExecutor(mesh=)`).

    The policies' reads answer from the owner's record of the last
    command (`queue_depth`, `free_slots`, `busy_slots`, `free_pages`,
    `has_work`, and the step and token counters), and a dispatch counts
    at once: the request waits in `pending` until the next command
    delivers it, and `queue_depth()` includes it.  What no record can
    answer is a round trip to the owner: `can_admit_request` (it depends
    on the request) and `reset` (failover).  The requests it holds are
    rank 0's own objects; the owner serves copies, and what a finished
    copy carries is written back into rank 0's object, which then lands
    in `done`.  Its `submitted` stays rank 0's stamp; the owner sends its
    other stamps already on rank 0's clock."""

    def __init__(self, executor: "ShardedExecutor", index: int, owner: int):
        self._executor = weakref.proxy(executor)
        self.index = self.replica_index = index
        self.owner = owner                 # the rank that runs it
        self.pending: List = []            # dispatched, not yet delivered
        self.held: dict = {}               # uid -> request the owner holds
        self.done: dict = {}
        self.record = {"queue_depth": 0, "free_slots": 0, "busy_slots": 0,
                       "free_pages": 0, "has_work": False}
        self.steps = self.decode_tokens = 0
        self.admissions = self.refresh_steps = 0
        self.decode_seconds = 0.0

    def submit(self, req):
        req.submitted = req.submitted or time.perf_counter()
        self.pending.append(req)
        self.held[req.uid] = req

    def queue_depth(self) -> int:
        return self.record["queue_depth"] + len(self.pending)

    def free_slots(self) -> int:
        return self.record["free_slots"]

    def busy_slots(self) -> int:
        return self.record["busy_slots"]

    def free_pages(self) -> int:
        return self.record["free_pages"]

    def has_work(self) -> bool:
        return self.record["has_work"] or bool(self.pending)

    def can_admit_request(self, req) -> bool:
        """The owner's `can_admit_request(req)`, asked now."""
        return self._executor.command("admit", replica=self.index,
                                      request=req)[self.owner]

    def reset(self) -> list:
        """Reclaim the replica's requests on its owner; rank 0's objects
        come back in the owner's reclaim order (resident lanes by slot,
        then the queue)."""
        uids = self._executor.command("reset", replica=self.index)[self.owner]
        return [self.held.pop(u) for u in uids]

    def update(self, record: dict) -> None:
        """Take the owner's record: its counters, and the requests that
        finished since the last one."""
        for key in self.record:
            self.record[key] = record[key]
        for key in ("steps", "decode_tokens", "admissions", "refresh_steps",
                    "decode_seconds"):
            setattr(self, key, record[key])
        for uid, fields in record["finished"]:
            req = self.held.pop(uid)
            for key, value in fields.items():
                setattr(req, key, value)
            self.done[uid] = req


#: the fields of a finished request that its owner sends back (its time
#: stamps on rank 0's clock; `submitted` is rank 0's own)
FINISHED_FIELDS = ("output", "truncated", "started", "first_token",
                   "finished", "status", "retries")
#: the fields stamped by the owner's clock (0.0 when never stamped)
STAMPS = ("started", "first_token", "finished")


class ControlGroup:
    """The replica mesh's control plane: a gloo group over every rank of
    the default process group, carrying pickled CPU objects (never a CUDA
    tensor: gloo aborts or crashes on them, PERF.md §7), whatever backend
    the default group has.  Rank 0 broadcasts each command and gathers
    the answers; a rank that died or hangs makes the collective raise
    within the default group's timeout (`default_timeout`)."""

    def __init__(self):
        from torch import distributed as dist
        self._dist = dist
        self.group = dist.new_group(backend="gloo", timeout=default_timeout())
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.seconds = 0.0                 # spent in this rank's collectives
        self.ops = collections.Counter()   # commands sent or served, by op

    def broadcast(self, msg=None):
        """Rank 0's `msg`, on every rank."""
        t0 = time.perf_counter()
        box = [msg]
        self._dist.broadcast_object_list(box, src=0, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.ops[box[0]["op"]] += 1
        return box[0]

    def gather(self, obj):
        """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
        t0 = time.perf_counter()
        out = [None] * self.size if self.rank == 0 else None
        self._dist.gather_object(obj, out, dst=0, group=self.group)
        self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, obj) -> list:
        """Every rank's `obj`, in rank order, on every rank."""
        out = [None] * self.size
        self._dist.all_gather_object(out, obj, group=self.group)
        return out

    def close(self) -> None:
        """Release the gloo group (every rank calls it).  Idempotent."""
        if self.group is not None and self._dist.is_initialized():
            self._dist.destroy_process_group(self.group)
        self.group = None


def default_timeout() -> datetime.timedelta:
    """The default process group's collective timeout (torch's own default
    for gloo when it cannot be read)."""
    from torch.distributed import distributed_c10d as c10d
    pg = c10d._get_default_group()
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (RuntimeError, AttributeError):
            continue
    return c10d.default_pg_timeout


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
    #: True when every rank of a process group runs the router together:
    #: `drive(router, max_steps)` then owns the run on every rank
    collective = False

    def __init__(self, engines: Sequence):
        self.engines = list(engines)
        self.proxies = [ReplicaProxy(self, i)
                        for i in range(len(self.engines))]
        self.busy_seconds = [0.0] * len(self.engines)
        self.wall_seconds = 0.0
        # the replicas this process runs (a replica mesh runs a block)
        self.local = list(range(len(self.engines)))

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
        return eng.has_work()


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
                eng = self.engines[i]
                try:
                    # each engine's step is whole (begin, dispatch, commit),
                    # so a failure never corrupts a sibling replica; the
                    # replicas after `i` skip this tick
                    with on_device(eng.device):
                        eng.step()
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
        # the replica's card current for its steps and replays (the
        # stream context alone is not relied on to switch it)
        with on_device(eng.device), self._on_stream(i):
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

    With `mesh=` (a `replicas` axis, one process a rank) the group spans
    the ranks, as the reference lays its stacked group over the axis:
    `engines` holds an engine for each replica of this rank's block
    (`sharding.replica_block`) and None for every other, which becomes a
    `RemoteReplica`.  A rank's tick is the above over its own block, in
    its own graph cache on its own device.  Rank 0's router alone decides;
    every rank enters `Router.run()` (`drive`), and rank 0 sends each tick,
    admission check and reset as a command over the `ControlGroup`: the
    command first delivers the requests rank 0 dispatched to other ranks,
    then runs on every rank, and one gather brings back each replica's
    record: its counters and the requests finished since the last one.
    Each rank keeps its requests' time stamps on its own clock while it
    serves them and sends them on rank 0's, so that deadlines and
    latencies never mix two hosts' clocks.  A mesh without the axis, or whose axis does not divide the
    group, raises ValueError as the reference's does, and the mesh must
    span the process group.  The default group's timeout bounds each
    control collective, so a rank that died or hangs makes every rank
    still running raise.

    Engines with the DSG serving runtime are refused, as in the reference
    (their CSR and refresh variants dispatch inside `ServingEngine.step`).
    """

    name = "sharded"
    lockstep = True
    measured = True

    def __init__(self, engines, mesh=None):
        engines = list(engines)
        if any(getattr(e, "dsg_rt", None) is not None for e in engines):
            raise NotImplementedError(
                "sharded executor batches the plain decode step; DSG-serving "
                "engines dispatch the CSR/refresh variants inside "
                "ServingEngine.step() — use exec_mode 'sequential' or "
                "'threaded' with dsg_serving")
        super().__init__(engines)
        self.mesh = mesh
        self.control = None
        self.chunk = 1
        self.graphs = None
        # begin-phase failures deferred past the group step (one raise a
        # tick keeps sibling replicas consistent; see step_all)
        self._pending_failures: List[ReplicaFailure] = []
        # per local replica: how many entries of its insertion-ordered
        # `done` were reported to rank 0 (a record ships only those after)
        self._reported: dict = {}
        # this rank's clock less rank 0's, estimated from the commands
        # (`_follow`); 0.0 on rank 0 and without a mesh
        self._shift = 0.0
        if mesh is not None:
            self._span(mesh)
        elif any(e is None for e in engines):
            raise ValueError("without a mesh the sharded executor needs an "
                             "engine for every replica")
        mine = self._mine()
        if not mine:
            return
        e0 = mine[0]
        if any(e.decode_chunk != e0.decode_chunk for e in mine):
            raise ValueError(
                "sharded executor needs a homogeneous decode_chunk across "
                "replicas (the group step is one variant): got "
                f"{[e.decode_chunk for e in mine]}")
        if any(e.device != e0.device for e in mine):
            raise ValueError("sharded executor needs every replica on one "
                             "device")
        self.chunk = e0.decode_chunk
        self.device = e0.device
        if e0.device.type == "cuda":
            words = sum(9 * e.n_slots for e in mine)
            self.graphs = cuda_graphs.GraphCache(e0.device, words)
            # no tick replays an engine's own chunk graphs: drop them, so
            # that warming an engine (its prefills) captures nothing
            for e in mine:
                e.graphs = None

    def _span(self, mesh) -> None:
        """Lay the group over the ranks of `mesh`: check this rank's
        engines against its block, open the control group and stand a
        RemoteReplica in for every replica another rank runs."""
        from torch import distributed as dist

        from repro_torch.parallel import sharding
        blocks = sharding.replica_blocks(mesh, len(self.engines))
        world = dist.get_world_size()
        if world != len(blocks):
            raise ValueError(
                f"the replica mesh ({len(blocks)} ranks) must span the "
                f"process group ({world} ranks): every rank runs the "
                f"router together")
        self.local = list(blocks[mesh.get_local_rank("replicas")])
        given = [i for i, e in enumerate(self.engines) if e is not None]
        if given != self.local:
            raise ValueError(
                f"rank {dist.get_rank()} runs replicas {self.local} of the "
                f"replica mesh: pass an engine for each of them and None "
                f"for every other, got engines for {given}")
        owners = mesh.mesh.flatten().tolist()
        per = len(self.local)
        self.control = ControlGroup()
        self.collective = True
        for i, e in enumerate(self.engines):
            if e is None:
                self.engines[i] = RemoteReplica(self, i, owners[i // per])

    def _mine(self) -> list:
        """The engines this process runs."""
        return [self.engines[i] for i in self.local]

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
        """Run every local replica's fused chunk (of one micro-step at
        chunk 1) for `plans`: one staged copy, one graph replay and one
        read-back on the card, the chunks in turn on the CPU.  Returns each
        replica's packed host output (blk, flags, final tokens)."""
        mine = self._mine()
        arrays = [e._chunk_operands(p) for e, p in zip(mine, plans)]
        if self.graphs is None:
            return [e._chunk_fn([torch.from_numpy(np.ascontiguousarray(a))
                                 for a in ops], live, False, sample).numpy()
                    for e, ops in zip(mine, arrays)]
        flat = [a for ops in arrays for a in ops]
        shapes = [a.shape for a in flat]

        def fn():
            views = self.graphs.views(shapes)
            return torch.cat([e._chunk_fn(views[9 * r:9 * r + 9], live,
                                          False, sample)
                              for r, e in enumerate(mine)])
        self.graphs.stage(flat)
        out = self.graphs.replay((live, sample), fn).cpu().numpy()
        sizes = [(2 * self.chunk + 1) * e.n_slots for e in mine]
        return np.split(out, np.cumsum(sizes)[:-1])

    def _step_local(self, indices) -> List[ReplicaFailure]:
        """One tick of this process's replicas: begin those `indices`
        names (the others ride along), run the group, commit.  Returns the
        begin-phase failures, in replica order."""
        t0 = time.perf_counter()
        idx = set(indices)
        plans, real, failures = [], [], []
        for i in self.local:
            eng = self.engines[i]
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
            return failures
        live = max(p.live_pages for p in plans)
        sample = any(p.sample for p in plans)
        with on_device(self.device):
            outs = self._group(plans, live, sample)
        wall = time.perf_counter() - t0
        share = wall / len(real)
        for i, plan, out in zip(self.local, plans, outs):
            if i in idx and plan.active:
                # decode_seconds gets an equal share of the group dispatch,
                # busy_seconds all of it (the replica was busy for all of
                # it); the makespan is wall_seconds either way
                eng = self.engines[i]
                c, b = self.chunk, eng.n_slots
                if c > 1:
                    eng.commit_chunk(
                        plan, out[:c * b].reshape(c, b),
                        out[c * b:2 * c * b].reshape(c, b).astype(bool),
                        out[2 * c * b:], share)
                else:                    # a live lane's final token is next
                    eng.commit_step(plan, out[2 * b:], share)
                self.busy_seconds[i] += wall
        return failures

    def step_all(self, indices):
        t0 = time.perf_counter()
        if self._pending_failures:       # deferred from the previous tick
            raise self._pending_failures.pop(0)
        try:
            if self.control is None:
                failures = self._step_local(indices)
            else:
                failures = sorted(
                    (f for answer in self.command("tick",
                                                  active=sorted(indices))
                     for f in answer), key=lambda f: f.index)
        finally:
            self.wall_seconds += time.perf_counter() - t0
        if failures:
            self._pending_failures.extend(failures[1:])
            raise failures[0]

    # -- the replica mesh's control plane ----------------------------------

    def command(self, op: str, **args) -> list:
        """Rank 0: send command `op` to every rank, after the requests
        dispatched to other ranks since the last one, and return each
        rank's answer in rank order once every remote replica's record is
        taken.  An error on any rank raises here, after the gather, so
        that no rank is left inside a collective."""
        dispatch = []
        for eng in self.engines:
            if isinstance(eng, RemoteReplica) and eng.pending:
                dispatch += [(eng.index, req) for req in eng.pending]
                eng.pending.clear()
        msg = dict(args, op=op, dispatch=dispatch,
                   sent=time.perf_counter())
        self.control.broadcast(msg)
        mine, err = self._serve(msg)
        replies = self.control.gather(None)
        answers, errors = [], []
        for rank, reply in enumerate(replies):
            if rank == self.control.rank:
                answers.append(mine)
                continue
            answer, records, error = reply
            if error is not None:
                errors.append(f"rank {rank}: {error}")
            for i, rec in records.items():
                self.engines[i].update(rec)
                self.busy_seconds[i] = rec["busy_seconds"]
            if op == "tick":
                answer = [ReplicaFailure(i, RemoteError(m))
                          for i, m in answer or ()]
            answers.append(answer)
        if err is not None:
            raise err
        if errors:
            raise RuntimeError("replica mesh command "
                               f"{op!r} failed on " + "; ".join(errors))
        return answers

    def _serve(self, msg):
        """Run one command on this rank: submit the dispatched requests
        that this rank's replicas own (their `submitted` moved onto this
        rank's clock, which the engine's deadline reads), then the command
        itself.  Returns (answer, None) or (None, the exception)."""
        try:
            for i, req in msg["dispatch"]:
                if i in self.local:
                    req.submitted += self._shift
                    self.engines[i].submit(req)
            op, i = msg["op"], msg.get("replica")
            if op == "tick":
                return self._step_local(msg["active"]), None
            if op == "sync":
                self._reported = {j: len(self.engines[j].done)
                                  for j in self.local}
                return None, None
            if i not in self.local:
                return None, None
            if op == "admit":
                return self.engines[i].can_admit_request(msg["request"]), None
            if op == "reset":
                return [r.uid for r in self.engines[i].reset()], None
            raise ValueError(f"unknown replica mesh command {op!r}")
        except BaseException as e:
            return None, e

    def _record(self, i: int) -> dict:
        """Local replica i's record for rank 0: the policies' counters,
        the step and token counters, its busy time and the requests that
        finished since the last record, their stamps on rank 0's clock.
        `done` only grows during a run, in insertion order, so the new
        entries are its last ones: a record costs what it ships."""
        eng = self.engines[i]
        rec = eng.introspect()
        rec.update(steps=eng.steps, decode_tokens=eng.decode_tokens,
                   admissions=eng.admissions,
                   refresh_steps=eng.refresh_steps,
                   decode_seconds=eng.decode_seconds,
                   busy_seconds=self.busy_seconds[i])
        new = len(eng.done) - self._reported.get(i, 0)
        self._reported[i] = len(eng.done)
        finished = []
        for uid, req in reversed(list(itertools.islice(
                reversed(eng.done.items()), max(new, 0)))):
            fields = {k: getattr(req, k) for k in FINISHED_FIELDS}
            for k in STAMPS:
                fields[k] = fields[k] and fields[k] - self._shift
            finished.append((uid, fields))
        rec["finished"] = finished
        return rec

    def drive(self, router, max_steps: int):
        """The whole run on every rank: rank 0 ticks the router (its
        dispatch, deadlines, failover and stall rule read every replica's
        record) and ends by sending its results, which every other rank
        adopts; the other ranks serve rank 0's commands until then.  On
        an error rank 0 tells the others to stop before it raises."""
        if self.control.rank != 0:
            return self._follow(router)
        try:
            self.command("sync")
            while router._busy() and router.steps < max_steps:
                router._tick()
            self.control.broadcast({"op": "end", "state": dict(
                router._export(),
                done={i: dict(e.done) for i, e in enumerate(self.engines)},
                busy_seconds=list(self.busy_seconds),
                wall_seconds=self.wall_seconds)})
        except BaseException as e:
            with contextlib.suppress(BaseException):
                self.control.broadcast({"op": "abort",
                                        "error": f"{type(e).__name__}: {e}"})
            raise

    def _follow(self, router):
        """A rank other than 0: serve commands until rank 0 ends the run
        (adopt its results) or stops it (raise).  Each command carries
        rank 0's clock at its sending.  This rank waits in the broadcast,
        so a command arrives one transit after it was sent, and the least
        (arrival - sending) over the commands is this rank's clock less
        rank 0's, plus the shortest transit: the shift that moves a stamp
        from one clock to the other."""
        best = float("inf")
        while True:
            msg = self.control.broadcast()
            if "sent" in msg:
                best = min(best, time.perf_counter() - msg["sent"])
                self._shift = best
            if msg["op"] == "end":
                # rank 0's objects, for its own replicas too (their
                # stamps are rank 0's clock, the local copies' this rank's)
                state = msg["state"]
                for i, eng in enumerate(self.engines):
                    if isinstance(eng, RemoteReplica):
                        eng.done = state["done"][i]
                    else:
                        eng.done.update(state["done"][i])
                self.busy_seconds = state["busy_seconds"]
                self.wall_seconds = state["wall_seconds"]
                router._adopt(state)
                return
            if msg["op"] == "abort":
                raise RuntimeError(f"rank 0 stopped the replica mesh's "
                                   f"run: {msg['error']}")
            answer, err = self._serve(msg)
            if msg["op"] == "tick" and answer:
                answer = [(f.index, str(f.cause)) for f in answer]
            self.control.gather((
                answer, {i: self._record(i) for i in self.local},
                None if err is None else f"{type(err).__name__}: {err}"))

    def close(self):
        """Release the replica mesh's control group (every rank calls it,
        through `Router.close()`).  Idempotent."""
        if self.control is not None:
            self.control.close()

    def warm(self, sample: bool = False):
        """Capture the group graph of every live-page bucket this process's
        group can reach, greedy and, with `sample`, sampling
        (warmup_router calls it), then clear the replay counts.  All-dummy
        plans: nothing reads their writes.  On the CPU there is nothing to
        capture."""
        if self.graphs is None:
            return
        e0 = self._mine()[0]
        if e0.cache.kind == "paged":
            buckets = sched.live_page_buckets(
                e0.max_seq // e0.backend.page_size)
        else:
            buckets = (0,)
        plans = [self._dummy_plan(e) for e in self._mine()]
        with on_device(self.device):
            for live in buckets:
                for do_sample in sorted({False, sample}):
                    self._group(plans, live, do_sample)
        # the replays counted from here on are a measured run's
        self.graphs.replays.clear()


def get_executor(mode, engines, *, mesh=None) -> ReplicaExecutor:
    """Executor factory: name -> a fresh executor over `engines`.  Only
    the sharded executor takes a `mesh` (each rank runs its block of
    replicas); the sequential and threaded executors run every replica
    in this process and ignore it, as the reference's factory does."""
    if mode == "sequential":
        return SequentialExecutor(engines)
    if mode == "threaded":
        return ThreadedExecutor(engines)
    if mode == "sharded":
        return ShardedExecutor(engines, mesh=mesh)
    raise ValueError(f"unknown exec mode {mode!r}; "
                     f"expected one of {EXEC_MODES}")
