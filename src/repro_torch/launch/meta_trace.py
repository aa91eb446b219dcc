"""Tracing a step on the meta device quickly and exactly: a cache of the
meta kernels' output shapes (`MetaCache`) and a tracker of live tensor
storage (`PeakTracker`), both dispatch modes, for the dry run.

On the meta device most elementwise ops run their shape rules in Python
(torch._refs and the prims' meta functions), about 0.1 ms an op: a
32k-token sLSTM prefill dispatches millions of them.  The output of an op
that makes new tensors depends on nothing but its inputs' shapes,
strides and dtypes and its other arguments, so `MetaCache` runs each
such op's meta kernel once per signature and afterwards makes the same
outputs with `torch.empty_strided`.  Views, in-place ops, ops that
return no tensor or whose output shape depends on data, and ops on
anything but plain meta tensors go to the kernel as before.

`PeakTracker` counts what torch.distributed's MemTracker counts (the
bytes of every tensor storage alive, by device, sampled after each op),
without its per-module and per-category bookkeeping, at a fraction of
its cost per op.

Enter `MetaCache` first: a dispatch mode sees an op before the modes
entered before it, so the counters above it see every op and its
outputs, and the cache answers last.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

_ATOMS = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)
_UNCACHED_TAGS = (torch.Tag.nondeterministic_seeded,
                  torch.Tag.data_dependent_output,
                  torch.Tag.dynamic_output_shape)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


class _Uncacheable(Exception):
    pass


def _key(x):
    """A hashable signature of an argument: a plain meta tensor's shape,
    strides and dtype, an atom with its type (1 and 1.0 and True give
    outputs of different dtypes)."""
    if type(x) is torch.Tensor:
        if not x.is_meta:
            raise _Uncacheable
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, _ATOMS):
        return (type(x), x)
    if isinstance(x, (list, tuple)):
        return tuple(_key(y) for y in x)
    raise _Uncacheable


class MetaCache(TorchDispatchMode):
    """Answers a functional aten op on plain meta tensors from the output
    shapes its meta kernel gave for the same signature.  `hits` and
    `misses` count the answers."""

    def __init__(self):
        super().__init__()
        self._dtensor = _dtensor_type()
        self._ok: dict = {}
        self._table: dict = {}
        self.hits = self.misses = 0

    def _cacheable(self, func) -> bool:
        ok = self._ok.get(func)
        if ok is None:
            s = func._schema
            ok = (func.namespace == "aten" and not s.is_mutable
                  and len(s.returns) > 0
                  and all(r.alias_info is None and str(r.type) == "Tensor"
                          for r in s.returns)
                  and not any(t in func.tags for t in _UNCACHED_TAGS))
            self._ok[func] = ok
        return ok

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if not self._cacheable(func):
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except _Uncacheable:
            return func(*args, **kwargs)
        spec = self._table.get(key)
        if spec is not None:
            self.hits += 1
            many, outs = spec
            made = tuple(torch.empty_strided(shape, stride, dtype=dt,
                                             device="meta")
                         for shape, stride, dt in outs)
            return made if many else made[0]
        self.misses += 1
        out = func(*args, **kwargs)
        many = isinstance(out, tuple)
        outs = out if many else (out,)
        if _aliases_input(outs, args, kwargs):
            # a view its schema does not declare (_unsafe_view)
            self._ok[func] = False
        elif all(_plain_output(o) for o in outs):
            self._table[key] = (many, tuple((tuple(o.shape), o.stride(),
                                             o.dtype) for o in outs))
        return out


def _aliases_input(outs, args, kwargs) -> bool:
    def storages(xs):
        for x in xs:
            if isinstance(x, (list, tuple)):
                yield from storages(x)
            elif isinstance(x, torch.Tensor):
                yield x.untyped_storage()._cdata
    ins = set(storages((*args, *kwargs.values())))
    return any(c in ins for c in storages(outs))


def _plain_output(t) -> bool:
    """A fresh meta tensor that `empty_strided` of its shape and strides
    remakes: concrete sizes, offset 0 and the storage those strides
    need."""
    if type(t) is not torch.Tensor or not t.is_meta:
        return False
    if not all(type(s) is int for s in t.shape) or t.storage_offset():
        return False
    need = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")
    return need.untyped_storage().nbytes() == t.untyped_storage().nbytes()


def _storages(t) -> list:
    """The storages a tensor holds: a DTensor's local shard's."""
    if type(t) is not torch.Tensor:
        inner = getattr(t, "_local_tensor", None)
        if inner is not None:
            return _storages(inner)
    return [t.untyped_storage()]


class PeakTracker(TorchDispatchMode):
    """The bytes of live tensor storage by device, and their peak over
    the ops run while it is on (sampled after each op, as MemTracker
    samples them).  It sees the storages it is given (`track_external`:
    modules' parameters and buffers, and tensors) and those the ops
    make; a storage counts until Python frees it.  DTensor ops are
    desugared first, so it sees each rank's local tensors.  On the meta
    device a collective's wait and autograd wrap return their input, as
    they do on the card (their meta kernels make a new tensor, which
    would count it twice).  `peak` is {device: bytes}."""

    _ALIAS_OPS = ("wait_tensor", "_wrap_tensor_autograd")

    def __init__(self):
        super().__init__()
        self._dtensor = _dtensor_type()
        self._seen = WeakIdKeyDictionary()
        self.current: dict = {}
        self.peak: dict = {}
        self._fake_on_entry = None

    def _free(self, device, nbytes, _ref):
        self.current[device] -= nbytes

    def _track(self, t) -> None:
        for st in _storages(t):
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            device = t.device
            self._seen[st] = weakref.ref(st, lambda r, d=device, n=nbytes:
                                         self._free(d, n, r))
            self.current[device] = self.current.get(device, 0) + nbytes

    def _sample(self) -> None:
        for device, now in self.current.items():
            if now > self.peak.get(device, 0):
                self.peak[device] = now

    def track_external(self, *objs) -> None:
        for obj in objs:
            if obj is None:
                continue
            if isinstance(obj, torch.nn.Module):
                for t in (*obj.parameters(), *obj.buffers()):
                    self._track(t)
                    if t.grad is not None:
                        self._track(t.grad)
            else:
                self._track(obj)

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        self._sample()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if (func.namespace == "_c10d_functional"
                and func._overloadpacket.__name__ in self._ALIAS_OPS
                and args[0].is_meta):
            out = args[0]
        else:
            out = func(*args, **(kwargs or {}))
        if active_fake_mode() is not self._fake_on_entry:
            # DTensor's sharding propagation on fake tensors of the
            # global shapes: not memory this rank holds
            return out
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._track(t)
        self._sample()
        return out
