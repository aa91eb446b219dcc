"""The sharded layer's shard_map bodies against the unsharded layer, on
gloo CPU ranks: (data 1, model 2) over two ranks and (data 2, model 2)
over four.

FFN (`dsg_linear._tp_ffn`, reached through `swiglu_ffn` / `gelu_ffn`
with the weights column / row parallel over 'model'): dense; DSG mask
mode with the shared, per-row top-k and EMA thresholds over four groups
(two a rank); three groups, split between the ranks (the virtual
pre-activations gathered); the GELU FFN.  Attention without a cache
(`attention._tp_attention`, training's path): head mode with K/V heads
split, head mode with one K/V head replicated, seq mode, and seq mode
on rows that do not divide the axis.  Split-KV decode
(`attention._tp_split_kv`): one token a lane at its own position over a
cache sequence-sharded over 'model', the cache written shard by shard.

Inputs from a numpy seed (f32, d 32, 4 x 8 tokens); every rank runs the
unsharded function on the same values.  Forward outputs and the written
cache within 1e-5 of their largest entry, gradients (x and each weight)
within 1e-4 of their largest entry (ROADMAP.md §3's f32 rule).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

OUT_TOL, GRAD_TOL = 1e-5, 1e-4

# name -> (act, F, block, threshold mode or None for DSG off)
FFN_CASES = {"dense": ("swiglu", 256, 64, None),
             "mask_shared": ("swiglu", 256, 64, "shared"),
             "mask_topk": ("swiglu", 256, 64, "topk"),
             "mask_ema": ("swiglu", 256, 64, "ema"),
             "mask_split": ("swiglu", 192, 64, "shared"),
             "gelu_mask": ("gelu", 256, 64, "shared")}
# name -> (attention mode, H, Kv, S)
ATTN_CASES = {"head": ("head", 4, 2, 8), "head_kv_rep": ("head", 4, 1, 8),
              "seq": ("seq", 4, 2, 8), "seq_uneven": ("seq", 4, 2, 7)}

RANKS = f"""
FFN_CASES = {FFN_CASES!r}
ATTN_CASES = {ATTN_CASES!r}
""" + r'''
import sys
from pathlib import Path
from types import SimpleNamespace
import numpy as np
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch.core import dsg_linear as dl
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import attention as attn
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import P, distribute

D_MODEL, B, S = 32, 4, 8
mesh = make_elastic_mesh(n, model=2, device_type="cpu")
BA = ("data",)


def arr(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def grads_of(fn, inputs, gy):
    """fn's output and the gradients of sum(out * gy) by each input."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    g = torch.autograd.grad(out, ins, grad_outputs=gy)
    return out.detach(), [t.detach() for t in g]


def sharded(fn, inputs, specs, gy):
    """The same on the mesh: inputs laid out by specs, under its
    context; results gathered whole."""
    ins = [distribute(t, mesh, s).requires_grad_(True)
           for t, s in zip(inputs, specs)]
    gyd = distribute(gy, mesh, P(BA, *([None] * (gy.ndim - 1))))
    with pctx.use_mesh(mesh):
        out = fn(*ins)
        g = torch.autograd.grad(out, ins, grad_outputs=gyd)
    return out.full_tensor().detach(), [t.full_tensor().detach() for t in g]


out = {}
for i, (name, (act, f, block, thr)) in enumerate(FFN_CASES.items()):
    rng = np.random.default_rng(100 + i)
    x = arr(rng, (B, S, D_MODEL))
    gy = arr(rng, (B, S, D_MODEL))
    w = [arr(rng, (D_MODEL, f), D_MODEL ** -0.5),
         arr(rng, (f, D_MODEL), f ** -0.5)]
    if act == "swiglu":
        w.insert(0, arr(rng, (D_MODEL, f), D_MODEL ** -0.5))
    cfg = dl.DSGConfig(enabled=thr is not None, block=block,
                       threshold_mode=thr or "topk", mode="mask")
    k = dl.proj_dim(D_MODEL, f, cfg)
    r = arr(rng, (k, D_MODEL), k ** -0.5)
    fw = r @ w[0]

    def ffn(x_, *ws, fw=fw):
        names = (("w_gate", "w_up", "w_down") if act == "swiglu"
                 else ("w_up", "w_down"))
        p = SimpleNamespace(**dict(zip(names, ws)))
        st = {"r": r, "fw": pctx.replicated(fw) if pctx.current()
              else fw} if thr else None
        fn = dl.swiglu_ffn if act == "swiglu" else dl.gelu_ffn
        return fn(p, x_, st, cfg)

    col, row = P(None, "model"), P("model", None)
    wspecs = [col, col, row] if act == "swiglu" else [col, row]
    out[name] = {"plain": grads_of(ffn, [x, *w], gy),
                 "sharded": sharded(ffn, [x, *w],
                                    [P(BA, None, None), *wspecs], gy)}

for i, (name, (mode, h, kv, s)) in enumerate(ATTN_CASES.items()):
    rng = np.random.default_rng(200 + i)
    hd = D_MODEL // h
    x = arr(rng, (B, s, D_MODEL))
    gy = arr(rng, (B, s, D_MODEL))
    w = [arr(rng, (D_MODEL, h, hd), D_MODEL ** -0.5),
         arr(rng, (D_MODEL, kv, hd), D_MODEL ** -0.5),
         arr(rng, (D_MODEL, kv, hd), D_MODEL ** -0.5),
         arr(rng, (h, hd, D_MODEL), D_MODEL ** -0.5)]
    pos = torch.arange(s)

    def layer(x_, *ws, h=h, kv=kv, mode=mode):
        p = SimpleNamespace(**dict(zip(("wq", "wk", "wv", "wo"), ws)))
        return attn.self_attention(p, x_, n_heads=h, n_kv=kv,
                                   rope_theta=10000.0, q_pos=pos,
                                   causal=True, shard=mode)[0]

    m = "model" if mode == "head" else None
    mk = m if kv % 2 == 0 else None
    specs = [P(BA, None, None), P(None, m, None), P(None, mk, None),
             P(None, mk, None), P(m, None, None)]
    out[name] = {"plain": grads_of(layer, [x, *w], gy),
                 "sharded": sharded(layer, [x, *w], specs, gy)}

# split-KV decode: lanes at their own positions over a 16-slot cache
rng = np.random.default_rng(300)
h, kv, hd, t = 4, 2, 8, 16
x = arr(rng, (B, 1, D_MODEL))
w = [arr(rng, (D_MODEL, h, hd), D_MODEL ** -0.5),
     arr(rng, (D_MODEL, kv, hd), D_MODEL ** -0.5),
     arr(rng, (D_MODEL, kv, hd), D_MODEL ** -0.5),
     arr(rng, (h, hd, D_MODEL), D_MODEL ** -0.5)]
cache = {"k": arr(rng, (B, t, kv, hd)), "v": arr(rng, (B, t, kv, hd))}
lanes = torch.tensor([5, 9, 15, 2])


def step(p, c):
    with torch.no_grad():
        o, c = attn.self_attention(p, x, n_heads=h, n_kv=kv,
                                   rope_theta=10000.0, q_pos=lanes[:, None],
                                   causal=True, cache=c, cache_pos=lanes)
    return o, c


o, c = step(SimpleNamespace(**dict(zip(("wq", "wk", "wv", "wo"), w))),
            {k: v.clone() for k, v in cache.items()})
plain = {"out": o, "k": c["k"], "v": c["v"]}
specs = [P(None, "model", None)] * 3 + [P("model", None, None)]
pd = SimpleNamespace(**dict(zip(("wq", "wk", "wv", "wo"),
                                 [distribute(a, mesh, s)
                                  for a, s in zip(w, specs)])))
cd = {k: distribute(v.clone(), mesh, P(BA, "model", None, None))
      for k, v in cache.items()}
with pctx.use_mesh(mesh):
    o, c = step(pd, cd)
out["decode"] = {"plain": plain,
                 "sharded": {"out": o.full_tensor(),
                             "k": c["k"].full_tensor(),
                             "v": c["v"].full_tensor()}}
if rank == 0:
    dump(out, tmp / "torch.pkl")
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {n: mh.run_ranks(tmp_path_factory.mktemp(f"tp_bodies{n}"), RANKS,
                            n, timeout=300) for n in (2, 4)}


def _err(got, want) -> float:
    return mh.leaf_err(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name", list(FFN_CASES) + list(ATTN_CASES))
@pytest.mark.parametrize("ranks", [2, 4])
def test_body_matches_the_unsharded_layer(runs, ranks, name):
    (y, g), (y_sh, g_sh) = (runs[ranks][name]["plain"],
                            runs[ranks][name]["sharded"])
    assert y_sh.shape == y.shape
    assert _err(y_sh, y) <= OUT_TOL, name
    errs = [_err(a, b) for a, b in zip(g_sh, g)]
    assert len(errs) == len(g) and max(errs) <= GRAD_TOL, (name, errs)


@pytest.mark.parametrize("ranks", [2, 4])
def test_split_kv_decode_matches_the_unsharded_step(runs, ranks):
    got = runs[ranks]["decode"]
    for part in ("out", "k", "v"):
        assert _err(got["sharded"][part], got["plain"][part]) <= OUT_TOL, \
            part
    # the new rows were written at each lane's own position
    assert not np.array_equal(np.asarray(got["plain"]["k"][0, 5]), 0.0)
