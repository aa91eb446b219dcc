"""Queue-depth-aware front-end router over per-replica serving engines.

Every replica owns its serving state (its cache backend and allocator, its
DSG runtime, its sampling seed, its graph pool), and a front-end `Router`
decides which replica each incoming `Request` lands on from LIVE state:

  * round_robin  — static cyclic assignment; dispatches unconditionally.
                   The baseline: it cannot see that one replica drew every
                   expensive request.
  * least_queue  — pull-based: a request is dispatched only when some
                   replica has an uncommitted free lane (free_slots >
                   queue_depth), to the replica with the least outstanding
                   work (queued + resident requests).
  * least_pages  — admission-safe: dispatch only to a replica whose cache
                   backend can reserve the request's worst-case page count
                   now (ServingEngine.can_admit_request), preferring the
                   one with the most unreserved free pages, so a
                   dispatched request is admitted on the replica's next
                   step.

Requests a policy declines to place wait in the router's FIFO queue and are
offered again every step; policies never reorder the queue.

On one card every replica shares the caller's model tensors: one copy of
the weights, however many replicas.  `models=` gives each replica its
own model (the reference's `param_views`), and under the threaded
executor, with a model on CUDA and several cards, replica r runs on a
copy of the model and the DSG state on card r % count, as the reference
places replicas on its local devices.  With the sharded executor and a
`replicas` mesh (`mesh=`), each rank of the process group runs its block
of the replicas and rank 0 routes (serving/parallel_exec.py).

Determinism: a lane's greedy stream does not depend on its lane or its
co-resident lanes, so the merged results keyed by uid are the same for any
replica count, policy and executor at temperature 0.  Replica r samples
from seed + r (replica 0 is a bare engine's).

How the replicas run is an executor (serving/parallel_exec.py,
`exec_mode=`): "sequential" steps them one after another and MODELS the
makespan from the slowest replica's busy time; "threaded" free-runs one
worker thread (and on the card one stream) per replica, and "sharded" runs
the group's steps as one dispatch; both MEASURE the makespan.

Fault tolerance (`fault_tolerance=`) is opt-in: a replica failure is
contained (the replica's requests are reclaimed and replayed from their
prompts on healthy replicas, which at temperature 0 gives the same
streams), the replica restarts within its budget or is marked dead, and
requests that cannot be served finish `failed` or `timed_out`.  Without
it a failure re-raises.
"""
from __future__ import annotations

import collections
import copy
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.analysis.contracts import owned_by, runs_on
from repro_torch.parallel import sharding
from repro_torch.serving.parallel_exec import (EXEC_MODES, ReplicaFailure,
                                               get_executor)
from repro_torch.serving.scheduler import Request, ServingEngine

POLICIES = ("round_robin", "least_queue", "least_pages")

HEALTH_STATES = ("healthy", "suspect", "dead")


@dataclass(frozen=True)
class FaultToleranceConfig:
    """Failover policy for a Router.  Passing any config (the defaults too)
    opts in: replica failures are contained instead of re-raised, and
    requests that cannot be dispatched finish `failed`/`timed_out` instead
    of raising the stall error.

      max_replica_restarts — how many times a failed replica returns to
          service before it is marked DEAD (0: its first failure is final).
      max_retries — per-request re-dispatch budget: a request reclaimed
          from failed replicas more often than this finishes `failed`.
      stall_timeout_s — threaded executor only: a replica whose worker
          makes no step progress for this long is marked SUSPECT and asked
          to abort at its next step boundary (None: no stall detection).
    """
    max_replica_restarts: int = 1
    max_retries: int = 2
    stall_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.max_replica_restarts < 0:
            raise ValueError(f"max_replica_restarts must be >= 0 "
                             f"(got {self.max_replica_restarts})")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 "
                             f"(got {self.max_retries})")
        if self.stall_timeout_s is not None and self.stall_timeout_s <= 0:
            raise ValueError(f"stall_timeout_s must be positive or None "
                             f"(got {self.stall_timeout_s})")


def as_ft_config(ft) -> Optional[FaultToleranceConfig]:
    """None | True | dict | FaultToleranceConfig -> config or None."""
    if ft is None or isinstance(ft, FaultToleranceConfig):
        return ft
    if ft is True:
        return FaultToleranceConfig()
    if isinstance(ft, dict):
        return FaultToleranceConfig(**ft)
    raise ValueError(f"fault_tolerance must be None, True, a dict, or a "
                     f"FaultToleranceConfig (got {ft!r})")


@dataclass
class ReplicaHealth:
    """Per-replica health: HEALTHY -> SUSPECT -> DEAD.  SUSPECT is the
    stall-timeout state (the engine was asked to abort, and the abort
    surfaces as a failure at its next step boundary).  A failure spends
    one restart of `max_replica_restarts`: within the budget the replica
    is HEALTHY again, beyond it DEAD.  `events` records every transition
    as (from_state, to_state, reason)."""
    state: str = "healthy"
    restarts: int = 0                       # restarts spent so far
    failures: List[str] = field(default_factory=list)
    events: List[tuple] = field(default_factory=list)


class RoutePolicy:
    """`select` returns the replica index to dispatch `req` to, or None to
    leave it queued at the router until the next step.  Policies read
    replica introspection only, and mutate no engine."""

    name = "abstract"

    def select(self, router: "Router", req: Request) -> Optional[int]:
        raise NotImplementedError


class RoundRobin(RoutePolicy):
    """Static cyclic assignment, blind to load; skips unhealthy replicas,
    keeping the cadence over the survivors."""

    name = "round_robin"

    def __init__(self):
        self._next = 0

    def select(self, router, req):
        n = len(router.replicas)
        for _ in range(n):
            r = self._next % n
            self._next += 1
            if router.routable(r):
                return r
        return None                    # every replica unhealthy: defer


class LeastQueue(RoutePolicy):
    """Least outstanding work (queued + resident requests) among replicas
    with an uncommitted free lane; ties go to the lowest index."""

    name = "least_queue"

    def select(self, router, req):
        best, best_score = None, None
        for i, eng in enumerate(router.replicas):
            if not router.routable(i):
                continue
            if eng.free_slots() <= eng.queue_depth():
                continue                   # every free lane spoken for
            score = eng.queue_depth() + eng.busy_slots()
            if best_score is None or score < best_score:
                best, best_score = i, score
        return best


class LeastPages(RoutePolicy):
    """Most unreserved free pages among replicas that can admit the request
    now (a free lane and a backend that covers its worst-case
    reservation), with an empty replica queue, so that a second dispatch
    cannot count on pages the first is about to reserve."""

    name = "least_pages"

    def select(self, router, req):
        best, best_pages = None, None
        for i, eng in enumerate(router.replicas):
            if not router.routable(i):
                continue
            if eng.queue_depth() or not eng.can_admit_request(req):
                continue
            pages = eng.free_pages()
            if best_pages is None or pages > best_pages:
                best, best_pages = i, pages
        return best


def get_policy(name: Union[str, RoutePolicy]) -> RoutePolicy:
    """Policy name -> a fresh policy (round_robin carries a cursor, so each
    router has its own); an object with a `select` method passes
    through."""
    if hasattr(name, "select"):
        return name
    if name == "round_robin":
        return RoundRobin()
    if name == "least_queue":
        return LeastQueue()
    if name == "least_pages":
        return LeastPages()
    raise ValueError(f"unknown route policy {name!r}; "
                     f"expected one of {POLICIES}")


def to_device(tree, device: torch.device):
    """A (nested dict of) tensor(s) on `device`; None and non-tensor leaves
    stay, and a tensor already there is not copied."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def model_copy(model, device: torch.device):
    """A copy of `model` with every parameter and buffer on `device`, made
    tensor by tensor (the source's card never holds a second copy); the
    model itself when it is there already."""
    if model.embed.device == device:
        return model
    memo = {}
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(p.detach().to(device),
                                         requires_grad=p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = b.to(device)
    return copy.deepcopy(model, memo)


def replica_views(model, dsg, models, owned) -> dict:
    """{replica: (model, dsg)} for the replicas in `owned`: the caller's
    pair when `models` is None; else each replica's entry of `models` (a
    model, or a device to copy the caller's model to) with the DSG state
    on its device.  Copies are made once a device."""
    if models is None:
        return {r: (model, dsg) for r in owned}
    dsg_on, copies, out = {model.embed.device: dsg}, {}, {}
    for r in owned:
        m = models[r]
        if isinstance(m, torch.device):
            if m not in copies:
                copies[m] = model_copy(model, m)
            m = copies[m]
        dev = m.embed.device
        if dev not in dsg_on:
            dsg_on[dev] = to_device(dsg, dev)
        out[r] = (m, dsg_on[dev])
    return out


@owned_by("router", "queue", "dispatch_log", "steps", "health", "failed",
          "fail_log")
class Router:
    """Front-end over N `ServingEngine` replicas.

    `**engine_kw` goes to every replica (`n_slots`, `max_seq`,
    `prompt_bucket`, `admission`, `cache_backend`, `page_size`,
    `cache_tokens`, `dsg_serving`, `decode_chunk`, ...).  `cache_backend`
    must be a name: a backend instance manages one live handle, so each
    replica builds its own.  Every replica shares the caller's model (one
    card holds one copy of the weights) unless `models` gives one model
    a replica, each run on its own device with the DSG state moved there;
    under "threaded", with no `models`, a model on CUDA and more than one
    card, replica r gets a copy of the model and of the DSG state on card
    r % count (one copy a card).

    `exec_mode` picks how the group runs (serving/parallel_exec.py):
    "sequential" (default, modeled makespan), "threaded" or "sharded"
    (measured makespan).  `mesh` (a `replicas` mesh,
    `parallel.sharding.replica_mesh`) spans a sharded group over the
    ranks of the process group: every rank builds the router with the
    same arguments and calls `run()` together; each runs the engines of
    its block only, rank 0 alone routes (its submissions are the ones
    served; the other ranks' are dropped at each run), and at the end
    every rank holds rank 0's results, dispatch log, steps and health.
    The other executors ignore a mesh, as the reference's do.
    `fault_tolerance` (None | True | dict | FaultToleranceConfig) opts
    into health tracking, restart budgets, failover replay from the
    prompt, deadlines and retries.

        router = Router(cfg, model, dsg, n_replicas=2,
                        policy="least_queue", n_slots=4)
        for r in requests: router.submit(r)
        done = router.run()        # {uid: Request}
    """

    def __init__(self, cfg, model, dsg, *, n_replicas: int = 1,
                 policy: Union[str, RoutePolicy] = "least_queue",
                 models: Optional[Sequence] = None, seed: int = 0,
                 exec_mode: str = "sequential", mesh=None,
                 fault_tolerance=None, **engine_kw):
        if n_replicas < 1:
            raise ValueError("router needs at least one replica")
        if hasattr(engine_kw.get("cache_backend"), "make"):
            raise ValueError(
                "pass cache_backend by name: backend instances manage one "
                "live handle and cannot be shared across replicas")
        if models is not None and len(models) != n_replicas:
            raise ValueError(f"models must supply one model per replica "
                             f"({n_replicas})")
        if exec_mode not in EXEC_MODES:
            # checked before the engines are built
            raise ValueError(f"unknown exec mode {exec_mode!r}; "
                             f"expected one of {EXEC_MODES}")
        self.policy = get_policy(policy)
        owned = range(n_replicas)
        if mesh is not None and exec_mode == "sharded":
            owned = sharding.replica_block(mesh, n_replicas)
        if (models is None and exec_mode == "threaded"
                and model.embed.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            count = torch.cuda.device_count()
            models = [torch.device("cuda", r % count)
                      for r in range(n_replicas)]
        views = replica_views(model, dsg, models, owned)
        engines = [ServingEngine(cfg, *views[r], seed=seed + r, **engine_kw)
                   if r in owned else None for r in range(n_replicas)]
        self.executor = get_executor(exec_mode, engines, mesh=mesh)
        # the executor's engines: on a replica mesh, this rank's block and
        # a RemoteReplica for every other replica
        self.engines: List[ServingEngine] = self.executor.engines
        # what policies see and dispatch to: the executor's proxies
        self.replicas = self.executor.proxies
        self.queue: collections.deque = collections.deque()
        self.dispatch_log: List[tuple] = []     # (uid, replica index)
        self.steps = 0
        self.ft = as_ft_config(fault_tolerance)
        self.health = [ReplicaHealth() for _ in range(n_replicas)]
        self.failed: Dict[int, Request] = {}    # failed/timed_out, by uid
        self.fail_log: List[tuple] = []         # (uid, status, reason)
        for r, eng in enumerate(self.engines):
            eng.replica_index = r               # failure attribution

    # -- request flow -------------------------------------------------------------

    @runs_on("router")
    def submit(self, req: Request):
        req.submitted = req.submitted or time.perf_counter()
        self.queue.append(req)

    def routable(self, i: int) -> bool:
        """Whether policies may dispatch to replica `i`; without fault
        tolerance every replica stays routable."""
        return self.health[i].state == "healthy"

    @runs_on("router")
    def _dispatch(self):
        """Offer the queue head to the policy until it defers (FIFO: no
        request is dispatched around a deferred head)."""
        while self.queue:
            r = self.policy.select(self, self.queue[0])
            if r is None:
                return
            req = self.queue.popleft()
            self.replicas[r].submit(req)
            self.dispatch_log.append((req.uid, r))

    @runs_on("router")
    def step(self):
        """One lockstep tick: dispatch what the policy places, then have the
        executor advance every replica that has work one step.  A
        free-running executor has no tick, and a replica mesh ticks on
        every rank at once: drive them with run()/drain()."""
        if not self.executor.lockstep:
            raise RuntimeError(
                f"executor {self.executor.name!r} free-runs replicas from "
                f"worker threads; drive it with run() or drain(), not "
                f"step()")
        if self.executor.collective:
            raise RuntimeError(
                "a router over a replica mesh ticks on every rank at once; "
                "call run() or drain() on every rank, not step()")
        self._tick()

    @runs_on("router")
    def _tick(self):
        """step()'s body (a replica mesh's rank 0 ticks through it)."""
        self._expire_deadlines()
        self._dispatch()
        active = [i for i, eng in enumerate(self.engines)
                  if self.executor.has_work(eng)]
        if active:
            try:
                self.executor.step_all(active)
            except ReplicaFailure as err:
                # fault tolerance off: re-raise (str(err) carries the
                # cause's message)
                if not self._handle_replica_failure(err):
                    raise
        elif self.queue:
            # every replica is idle and the policy still defers the head:
            # no retirement can free what it waits for
            if self.ft is not None:
                self._fail_undispatchable()
            else:
                raise RuntimeError(
                    f"router stalled: {len(self.queue)} queued request(s) "
                    f"undispatchable by policy {self.policy.name!r} while "
                    f"all replicas are idle; raise cache_tokens or lower "
                    f"max_new/prompt_bucket")
        self.steps += 1

    # -- fault tolerance ------------------------------------------------------------

    @runs_on("router")
    def _transition(self, i: int, state: str, reason: str):
        h = self.health[i]
        h.events.append((h.state, state, reason))
        h.state = state

    @runs_on("router")
    def _finish_failed(self, req: Request, status: str, reason: str):
        """A terminal non-ok completion: the request surfaces in done()
        with its status instead of hanging the drain loop."""
        req.status = status
        req.finished = time.perf_counter()
        self.failed[req.uid] = req
        self.fail_log.append((req.uid, status, reason))

    @runs_on("router")
    def _expire_deadlines(self):
        """Fail out router-queued requests whose deadline passed.  A
        request in a lane is not interrupted; its deadline is checked
        again if its replica fails."""
        if self.ft is None:
            return
        now = time.perf_counter()
        expired = [r for r in self.queue
                   if r.deadline_s is not None
                   and now - r.submitted > r.deadline_s]
        for req in expired:
            self.queue.remove(req)
            self._finish_failed(req, "timed_out",
                                f"deadline {req.deadline_s}s expired in "
                                f"router queue")

    @runs_on("router")
    def _handle_replica_failure(self, err: ReplicaFailure) -> bool:
        """Contain one replica failure; False when fault tolerance is off
        (the caller re-raises)."""
        if self.ft is None:
            return False
        self._on_replica_failure(err.index, err.cause)
        return True

    @runs_on("router")
    def _on_replica_failure(self, i: int, cause: BaseException):
        """Failover: reclaim the failed replica's queued and in-flight
        requests (ServingEngine.reset frees their lanes and pages), decide
        the replica's fate against its restart budget, and requeue the
        reclaimed requests at the front of the router queue in their
        order.  Each replays from its prompt (its partial output is
        dropped), so at temperature 0 its stream is an uninterrupted
        run's."""
        h = self.health[i]
        h.failures.append(str(cause))
        reclaimed = self.engines[i].reset()
        if h.restarts < self.ft.max_replica_restarts:
            h.restarts += 1
            self._transition(
                i, "healthy",
                f"restarted ({h.restarts}/{self.ft.max_replica_restarts})"
                f" after: {cause}")
        else:
            self._transition(i, "dead",
                             f"restart budget exhausted after: {cause}")
        now = time.perf_counter()
        # reversed, so that appendleft keeps the reclaim order at the head
        for req in reversed(reclaimed):
            req.retries += 1
            req.output.clear()           # replay from the prompt
            req.started = 0.0
            req.first_token = 0.0        # TTFT stamps again on the survivor
            if (req.deadline_s is not None
                    and now - req.submitted > req.deadline_s):
                self._finish_failed(req, "timed_out",
                                    f"deadline {req.deadline_s}s expired "
                                    f"during failover from replica {i}")
            elif req.retries > self.ft.max_retries:
                self._finish_failed(req, "failed",
                                    f"retry budget exhausted "
                                    f"({self.ft.max_retries}) after "
                                    f"replica {i} failed")
            else:
                self.queue.appendleft(req)

    @runs_on("router")
    def _on_replica_stall(self, i: int):
        """Stall-timeout containment (threaded executor): a worker stuck in
        a step cannot be killed safely, so mark the replica SUSPECT
        (policies stop routing to it) and ask its engine to abort; the
        EngineAborted raise at its next step boundary takes the failure
        path.  A worker wedged forever inside one device call never gets
        there (a documented limit)."""
        if self.ft is None or self.health[i].state != "healthy":
            return
        timeout = self.ft.stall_timeout_s
        self._transition(i, "suspect",
                         f"no step progress for {timeout}s")
        self.engines[i].abort = True

    @runs_on("router")
    def _fail_undispatchable(self):
        """Every replica is idle and the policy still defers: with no
        routable replica left every queued request fails, otherwise the
        head does (the next one may be placeable)."""
        if not any(self.routable(i) for i in range(len(self.engines))):
            while self.queue:
                self._finish_failed(self.queue.popleft(), "failed",
                                    "no routable replica (all dead)")
        elif self.queue:
            self._finish_failed(self.queue.popleft(), "failed",
                                f"undispatchable by policy "
                                f"{self.policy.name!r} with all replicas "
                                f"idle")

    @runs_on("router")
    def reset_health(self):
        """Revive every replica (repeats after a chaos run): health back to
        HEALTHY, the failure, event and fail logs cleared.  Engines keep
        what they built."""
        for h in self.health:
            h.state = "healthy"
            h.restarts = 0
            h.failures.clear()
            h.events.clear()
        self.failed.clear()
        self.fail_log.clear()

    def _busy(self) -> bool:
        return bool(self.queue) or any(
            self.executor.has_work(eng) for eng in self.engines)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drive every submitted request to completion and return the
        merged {uid: Request}: lockstep executors tick through step(),
        free-running ones own the loop (`executor.drive()`)."""
        if self.executor.collective:
            self.executor.drive(self, max_steps)
        elif self.executor.lockstep:
            while self._busy() and self.steps < max_steps:
                self.step()
        elif self._busy():
            self.executor.drive(self, max_steps)
        return self.done()

    def _export(self) -> dict:
        """The router's results and bookkeeping, as rank 0 of a replica
        mesh sends them to the other ranks at the end of a run."""
        return {"failed": self.failed, "queue": list(self.queue),
                "dispatch_log": self.dispatch_log, "steps": self.steps,
                "health": self.health, "fail_log": self.fail_log}

    @runs_on("router")
    def _adopt(self, state: dict) -> None:
        """Take rank 0's `_export()` (the other ranks of a replica mesh)."""
        self.failed = state["failed"]
        self.queue = collections.deque(state["queue"])
        self.dispatch_log = state["dispatch_log"]
        self.steps = state["steps"]
        self.health = state["health"]
        self.fail_log = state["fail_log"]

    def drain(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Finish every in-flight and queued request (no new submissions
        assumed): run() under the engine's name for it."""
        return self.run(max_steps=max_steps)

    def done(self) -> Dict[int, Request]:
        """Completed requests of every replica, keyed by uid (uids must be
        unique across the submitted set), with the ones fault tolerance
        finished `failed`/`timed_out`: every submitted request surfaces
        once; check `req.status`."""
        out: Dict[int, Request] = dict(self.failed)
        for eng in self.engines:
            out.update(eng.done)
        return out

    def close(self):
        """Release the executor's resources (the threaded executor's
        workers).  Safe to call more than once; the router stays usable."""
        self.executor.close()

    # -- introspection and stats ------------------------------------------------------

    def queue_depth(self) -> int:
        """The router's queue only; the replicas' are their own."""
        return len(self.queue)

    @property
    def busy_seconds(self) -> List[float]:
        """Per-replica stepping time (the executor's)."""
        return self.executor.busy_seconds

    def makespan_seconds(self) -> float:
        """The data-parallel wall clock: MEASURED (the executor's wall
        time) when the executor overlaps replicas (threaded, sharded),
        else MODELED as the slowest replica's busy time, which is what N
        parallel replicas would take."""
        if self.executor.measured:
            return self.executor.wall_seconds
        return max(self.executor.busy_seconds)

    def throughput(self) -> float:
        """Merged tokens per second from the first admission to the last
        finish; raises before any request finishes."""
        done = self.done()
        if not done:
            raise ValueError(
                "throughput() needs at least one finished request; "
                "run the router (or drain()) before reading stats")
        toks = sum(len(r.output) for r in done.values())
        t0 = min(r.started or r.submitted for r in done.values())
        t1 = max(r.finished for r in done.values())
        return toks / max(t1 - t0, 1e-9)

    @runs_on("router")
    def reset_counters(self):
        """Zero the step and timing counters and the dispatch log after a
        warm-up, so that a measured window starts from them."""
        self.steps = 0
        self.executor.reset_timing()
        self.dispatch_log.clear()

    def replica_stats(self) -> List[dict]:
        """Per replica: the executor's busy time, the engine's step, token
        and queue counters, and its health."""
        return [{
            "replica": i,
            "busy_s": self.executor.busy_seconds[i],
            "steps": eng.steps,
            "decode_tokens": eng.decode_tokens,
            "finished": len(eng.done),
            "queue_depth": eng.queue_depth(),
            "free_slots": eng.free_slots(),
            "free_pages": eng.free_pages(),
            "health": self.health[i].state,
            "restarts": self.health[i].restarts,
        } for i, eng in enumerate(self.engines)]
