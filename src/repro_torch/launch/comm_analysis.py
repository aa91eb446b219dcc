"""Per-device FLOPs and collective bytes of a traced step (the port's
counterpart of `repro.launch.hlo_analysis`).

The reference parses the partitioned program's HLO.  Eager PyTorch has no
such program, so `CommCounter` counts at dispatch: a TorchDispatchMode
that lets DTensor desugar each of its ops into the local ops and the
collectives this rank runs (it returns NotImplemented for a DTensor op,
as torch.distributed's CommDebugMode and MemTracker do), then sees those
plain ops.  It counts

  * every functional collective (`_c10d_functional`, and the legacy
    `c10d_functional`) under the reference's five kinds: all_reduce and
    its coalesced form -> all-reduce, all_gather_into_tensor ->
    all-gather, reduce_scatter_tensor -> reduce-scatter,
    all_to_all_single -> all-to-all, except the one
    `parallel.collectives.ppermute` issues (one peer to send to and one
    to receive from) -> collective-permute; and DTensor's own
    `_dtensor.shard_dim_alltoall` (its Shard(i) -> Shard(j) on a CUDA
    mesh) -> all-to-all;
  * its bytes by the reference's convention: the result's shape on this
    rank (`hlo_analysis.py`'s `_shape_bytes(op.type_str)`), summed again
    under `f32_bytes` for an f32 result;
  * the FLOPs of the local ops, by torch.utils.flop_counter's formulas
    (FlopCounterMode's registry: mm, bmm, addmm, baddbmm, convolution,
    attention) on the local shapes: this rank's share;
  * the HBM bytes of the local ops (BYTES_NOTE): the reference's
    convention for a top-level op of the partitioned program (its
    result's bytes plus each operand's, a dynamic-update-slice twice its
    update's), applied to an eager program, in which every op is
    top-level.

A collective of any other c10d op (a broadcast or scatter, which XLA
has no kind for) is counted under `unmapped` by its op name, so nothing
the rank runs goes unseen.
"""
from __future__ import annotations

from functools import lru_cache

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_reduce_coalesced_": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_FUNCTIONAL = ("_c10d_functional", "c10d_functional")
# ops of those namespaces that move no data
_NOT_COLLECTIVE = ("wait_tensor", "_wrap_tensor_autograd")
BYTES_NOTE = ("HBM traffic of this rank's local ops, each counted as the "
              "reference's hlo_analysis counts a top-level op: the bytes of "
              "each distinct input tensor read plus each output written "
              "(eager PyTorch has no fusions, so every op is top-level); "
              "views, aliases, empty allocations, ops that return no tensor "
              "and a collective's wait move nothing; an in-place write into "
              "a slice (copy_, index_put_, index_copy_, scatter_) counts "
              "twice its update, as a dynamic-update-slice does; fill_ and "
              "zero_ their output; a collective its operand and result; "
              "tensors in host memory (the mesh's rank tables, host "
              "scalars) are not counted")
# in-place writes of an update into part of a buffer: the update's
# argument (copy_'s is the slice it writes)
_UPDATE_ARG = {"copy_": ("self", 0), "index_put_": ("values", 2),
               "index_copy_": ("source", 3), "scatter_": ("src", 3)}
_WRITE_ONLY = ("fill_", "zero_")
_EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided", "empty_permuted")


def _tensors(out) -> list:
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if torch.is_tensor(t)]
    return []


def _nbytes(t) -> int:
    """The device bytes a tensor spans: its elements, a broadcast
    (stride-0) dim counted once; none for a tensor in host memory."""
    if t.is_cpu:
        return 0
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
        elif size == 0:
            return 0
    return n


def _inputs(args, kwargs) -> list:
    """The distinct tensors among an op's arguments (one level of lists:
    cat's inputs, index_put_'s indices)."""
    seen, out = set(), []
    for a in (*args, *kwargs.values()):
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


@lru_cache(maxsize=None)
def _moves_nothing(func) -> bool:
    """A view or alias, an allocation with no values, a collective's
    wait: no HBM traffic.  (An op that returns no tensor and writes none,
    a size or a Python scalar, has no outputs to count.)"""
    s = func._schema
    if s.returns and all(r.alias_info is not None
                         and not r.alias_info.is_write for r in s.returns):
        return True
    name = func._overloadpacket.__name__
    if func.namespace in _FUNCTIONAL:
        return name in _NOT_COLLECTIVE
    return func.namespace == "aten" and name in _EMPTY


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place (a foreach update returns
    none)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            out += _tensors(args[i] if i < len(args) else kwargs.get(a.name))
    return out


def op_bytes(func, args, kwargs, out) -> int:
    """The HBM bytes of one op by BYTES_NOTE's convention."""
    if _moves_nothing(func):
        return 0
    written = _tensors(out) or _written(func, args, kwargs)
    if not written:
        return 0
    name = func._overloadpacket.__name__
    if func.namespace == "aten":
        if name in _UPDATE_ARG:
            key, i = _UPDATE_ARG[name]
            update = args[i] if i < len(args) else kwargs.get(key)
            if isinstance(update, torch.Tensor):
                return 2 * _nbytes(update)
        if name in _WRITE_ONLY:
            return sum(_nbytes(t) for t in written)
    return (sum(_nbytes(t) for t in _inputs(args, kwargs))
            + sum(_nbytes(t) for t in written))


def _is_permute(args) -> bool:
    """An all_to_all_single whose splits name one peer each way: the
    form funcol.permute_tensor gives a ppermute."""
    out_split, in_split = args[1], args[2]
    return (bool(out_split) and bool(in_split)
            and sum(s > 0 for s in out_split) == 1
            and sum(s > 0 for s in in_split) == 1)


def _kind_of(func, args) -> str | None:
    """The reference's kind of a collective op, None for any other op;
    "?" + its name for a collective of no kind."""
    ns = func.namespace
    name = func._overloadpacket.__name__
    if ns in _FUNCTIONAL:
        if name in _NOT_COLLECTIVE:
            return None
        kind = _KIND.get(name)
        if kind == "all-to-all" and _is_permute(args):
            return "collective-permute"
        return kind or "?" + f"{ns}.{name}"
    if ns == "_dtensor" and name == "shard_dim_alltoall":
        return "all-to-all"
    if ns == "c10d" and name not in ("wait", "barrier", "monitored_barrier"):
        return "?" + f"{ns}.{name}"
    return None


class CommCounter(TorchDispatchMode):
    """Counts this rank's collectives and local FLOPs while it is on.
    `analysis()` gives the reference's record."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor = DTensor
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll = {k: {"bytes": 0, "count": 0, "f32_bytes": 0}
                     for k in COLLECTIVES}
        self.unmapped: dict = {}
        self._fake_on_entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, self._dtensor) for t in types):
            # DTensor runs the op, and its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        from torch._guards import active_fake_mode
        if active_fake_mode() is not self._fake_on_entry:
            # DTensor's sharding propagation running the op on fake
            # tensors of the global shapes: not work this rank does
            return out
        count = self._flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        self.bytes += op_bytes(func, args, kwargs, out)
        kind = _kind_of(func, args)
        if kind is not None:
            res = _tensors(out)
            nb = sum(t.numel() * t.element_size() for t in res)
            if kind.startswith("?"):
                slot = self.unmapped.setdefault(kind[1:], {"bytes": 0,
                                                           "count": 0})
            else:
                slot = self.coll[kind]
                slot["f32_bytes"] += sum(t.numel() * t.element_size()
                                         for t in res
                                         if t.dtype == torch.float32)
            slot["bytes"] += nb
            slot["count"] += 1
        return out

    def analysis(self) -> dict:
        """{"flops", "bytes", "collectives": {kind: {"bytes", "count",
        "f32_bytes"}}, "collective_total_bytes"} as
        `hlo_analysis.analyze` gives it, per device; `bytes` is the HBM
        traffic by BYTES_NOTE's convention.  `unmapped` is added where a
        collective of no kind ran."""
        out = {"flops": self.flops, "bytes": self.bytes,
               "collectives": {k: dict(v) for k, v in self.coll.items()},
               "collective_total_bytes": sum(v["bytes"]
                                             for v in self.coll.values())}
        if self.unmapped:
            out["unmapped"] = {k: dict(v) for k, v in self.unmapped.items()}
        return out


def analyze(fn) -> tuple:
    """(fn(), the analysis of what this rank ran in it)."""
    with CommCounter() as counter:
        res = fn()
    return res, counter.analysis()
