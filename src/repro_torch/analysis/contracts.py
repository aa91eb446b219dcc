"""Concurrency contracts: annotations + the REPRO_TSAN runtime shim.

The serving stack shares mutable state across threads under a lock
discipline ("mutations of `_idle` happen with `self._cond` held").  This
module makes the discipline explicit and checkable twice over:

**Statically** — the decorators below are metadata-only at runtime (they
stash the contract on the class/function and return it unchanged); the
`analysis.locks` checker reads them from the AST and verifies every
mutation site of a declared field is either inside a ``with self.<lock>:``
block, in a method declared `@runs_on(<owner>)` for an `owned_by` field,
or explicitly waived with `@exempt`.

**Dynamically** — under ``REPRO_TSAN=1``, `ThreadedExecutor` wraps its
Condition in a `CheckedCondition` (tracks the holding thread through
acquire/release/wait) and its annotated mutable fields in guarded
containers whose mutating methods assert the discipline on every call,
so the tier-1 suite doubles as a thread sanitizer for exactly the
annotated state.

Vocabulary:

  @locked_by("_cond", "_idle", "_errors")     # class decorator: every
      mutation of the named fields must hold ``self._cond``
  @owned_by("worker", "queue", "done")        # class decorator: the
      named fields are mutated only by the declared owner role (or
      under the class's declared lock, which also serializes)
  @runs_on("worker")                          # method decorator: this
      method executes in the named role's thread
  @exempt("queue", reason="...")              # method decorator: waive
      the static check for the named fields in this method; the reason
      is mandatory and the dynamic shim still covers the site

Owner names are roles, not thread ids — "worker" is whichever thread
drives the engine (a `ThreadedExecutor` worker, or the caller's thread
for a bare engine), "router" is the thread calling `Router.run()`.  The
runtime shim resolves roles to live threads at claim time
(`GuardedDeque.set_owner`).
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Optional

__all__ = [
    "locked_by", "owned_by", "runs_on", "exempt", "tsan_enabled",
    "TsanViolation", "CheckedCondition", "GuardedList", "GuardedDict",
    "GuardedDeque",
]

CONTRACT_ATTR = "__repro_contracts__"


def _add_contract(obj, kind: str, payload: dict):
    table = getattr(obj, CONTRACT_ATTR, None)
    if table is None:
        table = []
        setattr(obj, CONTRACT_ATTR, table)
    table.append({"kind": kind, **payload})
    return obj


def locked_by(lock: str, *fields: str):
    """Class decorator: mutations of `fields` must hold ``self.<lock>``."""
    if not fields:
        raise TypeError("locked_by needs at least one field name")

    def deco(cls):
        return _add_contract(cls, "locked_by",
                             {"lock": lock, "fields": fields})
    return deco


def owned_by(owner: str, *fields: str):
    """Class decorator: `fields` are mutated only by the `owner` role
    (methods marked ``@runs_on(owner)``) or under the class's lock."""
    if not fields:
        raise TypeError("owned_by needs at least one field name")

    def deco(cls):
        return _add_contract(cls, "owned_by",
                             {"owner": owner, "fields": fields})
    return deco


def runs_on(owner: str):
    """Method decorator: the body executes in the `owner` role's thread."""

    def deco(fn):
        return _add_contract(fn, "runs_on", {"owner": owner})
    return deco


def exempt(*fields: str, reason: str):
    """Method decorator: waive the static lock/owner check for `fields`
    inside this method.  `reason` is mandatory — waivers are part of the
    reviewed contract, not an escape hatch (docs/analysis.md)."""
    if not fields:
        raise TypeError("exempt needs at least one field name")
    if not reason:
        raise TypeError("exempt needs a non-empty reason")

    def deco(fn):
        return _add_contract(fn, "exempt",
                             {"fields": fields, "reason": reason})
    return deco


# ---------------------------------------------------------------------------
# runtime sanitizer (REPRO_TSAN=1)
# ---------------------------------------------------------------------------

def tsan_enabled() -> bool:
    """True when the dynamic lock-discipline shim should be active.
    Read at object construction time: flipping the env var after an
    executor exists has no effect on it."""
    return os.environ.get("REPRO_TSAN", "") not in ("", "0")


class TsanViolation(RuntimeError):
    """A guarded mutation ran without the declared lock/owner."""


class CheckedCondition:
    """A `threading.Condition` (over an RLock) that knows who holds it.

    Drop-in for the executor's ``_cond``: supports the context-manager
    protocol, `wait`, `notify`, `notify_all`, and adds
    `held_by_current()` — the predicate the guarded containers assert.
    Holder tracking survives `wait()` (which releases and reacquires)
    and re-entrant acquisition.
    """

    def __init__(self):
        self._cond = threading.Condition(threading.RLock())
        self._holder: Optional[threading.Thread] = None
        self._depth = 0

    # -- holder bookkeeping --------------------------------------------------

    def _acquired(self):
        self._holder = threading.current_thread()
        self._depth += 1

    def _releasing(self):
        self._depth -= 1
        if self._depth == 0:
            self._holder = None

    def held_by_current(self) -> bool:
        return self._holder is threading.current_thread()

    # -- condition protocol --------------------------------------------------

    def acquire(self, *a, **kw):
        got = self._cond.acquire(*a, **kw)
        if got:
            self._acquired()
        return got

    def release(self):
        self._releasing()
        self._cond.release()

    def __enter__(self):
        self._cond.__enter__()
        self._acquired()
        return self

    def __exit__(self, *exc):
        self._releasing()
        return self._cond.__exit__(*exc)

    def wait(self, timeout: Optional[float] = None):
        if not self.held_by_current():
            raise TsanViolation("wait() without holding the condition")
        # wait releases the lock fully, then reacquires at our depth
        depth, self._depth, self._holder = self._depth, 0, None
        try:
            return self._cond.wait(timeout)
        finally:
            self._depth, self._holder = depth, threading.current_thread()

    def notify(self, n: int = 1):
        self._cond.notify(n)

    def notify_all(self):
        self._cond.notify_all()


class _Guard:
    """Shared discipline check for the guarded containers.

    A mutation is legal when the guarding condition is held by the
    current thread, when the current thread is the registered owner, or
    when no owner is registered (the structure is quiescent — e.g. an
    engine between drives, warmed and read by the main thread).

    No __slots__: a mixin with slots cannot share an instance layout
    with the C container bases (list/dict/deque)."""

    def _init_guard(self, cond, label: str):
        self._tsan_cond = cond
        self._tsan_owner: Optional[threading.Thread] = None
        self._tsan_label = label

    def set_owner(self, thread: Optional[threading.Thread]):
        """Claim (or release, with None) exclusive mutation rights."""
        self._tsan_owner = thread

    def _check(self):
        if self._tsan_cond is not None and self._tsan_cond.held_by_current():
            return
        owner = self._tsan_owner
        if owner is None or owner is threading.current_thread():
            return
        raise TsanViolation(
            f"REPRO_TSAN: mutation of {self._tsan_label} on thread "
            f"{threading.current_thread().name!r} without holding the "
            f"guarding condition (owner: {owner.name!r})")


def _guarded(base, mutators):
    """Build a guarded subclass of `base` asserting before `mutators`."""

    def make(name):
        def method(self, *a, **kw):
            self._check()
            return getattr(base, name)(self, *a, **kw)
        method.__name__ = name
        return method

    ns = {name: make(name) for name in mutators}

    def __init__(self, data=(), *, cond=None, label="<guarded>"):
        base.__init__(self, data)
        self._init_guard(cond, label)
    ns["__init__"] = __init__
    return type(f"Guarded{base.__name__.capitalize()}", (base, _Guard), ns)


GuardedList = _guarded(list, (
    "__setitem__", "__delitem__", "__iadd__", "append", "extend",
    "insert", "pop", "remove", "clear", "sort", "reverse"))
GuardedDict = _guarded(dict, (
    "__setitem__", "__delitem__", "pop", "popitem", "clear", "update",
    "setdefault"))
GuardedDeque = _guarded(collections.deque, (
    "append", "appendleft", "extend", "extendleft", "pop", "popleft",
    "remove", "clear", "__setitem__", "__delitem__", "__iadd__"))
