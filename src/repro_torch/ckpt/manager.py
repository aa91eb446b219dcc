"""Checkpoint manager: atomic, manifest-verified, async-capable, in the
reference's on-disk layout.

Layout:
    <dir>/step_<N>/arrays.npz      the tree's leaves, keyed by tree path
    <dir>/step_<N>/manifest.json   shapes, dtypes and meta
    <dir>/LATEST                   the newest complete step

A tree is nested dicts, lists and tuples with tensor, numpy or scalar
leaves; a leaf's key joins its dict keys and list indices with "/"
(`params/layers/ffn/w_gate`, `opt/m/embed`, `opt/step`), as the
reference's tree paths do, so a checkpoint either package writes restores
in the other (f32 trees; bf16 is stored below).

Write protocol: write into step_<N>.tmp/, fsync, rename to step_<N>/, then
move LATEST, so a half-written checkpoint is never restored.  `keep`
bounds retention.  `save_async` copies every leaf to the host before it
returns and writes on a thread, overlapping the next steps.

numpy has no bfloat16 of its own, so a bf16 leaf is stored as its uint16
bit pattern with "bfloat16" as its manifest dtype, and restored as bf16.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

SEP = "/"
BF16 = "bfloat16"


def _items(tree, prefix=()):
    """(path, leaf) pairs in the order of the tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield SEP.join(prefix), tree


def _to_host(leaf):
    """A leaf as (numpy array, manifest dtype)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), BF16
        a = t.numpy().copy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _flatten(tree):
    """(key, (numpy array, manifest dtype)) for every leaf."""
    for key, leaf in _items(tree):
        yield key, _to_host(leaf)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _rebuild(tree, values):
    """`tree`'s structure with its leaves taken in order from `values`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values) for v in tree)
    return next(values)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ---- write ----
    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        self._write(step, dict(_flatten(tree)), meta or {})

    def save_async(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        flat = dict(_flatten(tree))      # host snapshot before returning
        self._thread = threading.Thread(
            target=self._write, args=(step, flat, meta or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: a for k, (a, _) in flat.items()})
        manifest = {
            "step": step,
            "time": time.time(),
            "meta": meta,
            "arrays": {k: {"shape": list(a.shape), "dtype": dt}
                       for k, (a, dt) in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---- read ----
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if os.path.exists(path):
            with open(path) as f:
                s = int(f.read().strip())
            if s in self.steps():
                return s
        steps = self.steps()     # LATEST missing or stale: the manifests
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None):
        """Restore into the structure of `template`, shapes verified, with
        CPU tensor leaves.  Returns (tree, step, meta), or (None, None,
        None) when there is no checkpoint.  A write this manager has in
        flight finishes first, so a restore right after `save_async` finds
        that checkpoint (the reference's restore does not wait, and can
        miss it while the thread runs)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        leaves = []
        for key, leaf in _items(template):
            if key not in data:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = data[key]
            want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs template {want}")
            dtype = manifest["arrays"].get(key, {}).get("dtype")
            leaves.append(_from_host(arr, dtype))
        return (_rebuild(template, iter(leaves)), step,
                manifest.get("meta", {}))
