"""The dry run's sharded trace (`launch.dryrun.trace_sharded`,
`launch.comm_analysis`) on the CPU.

(a) At smoke width in f32, on a (data 2, model 2) mesh, for
internlm2-1.8b, deepseek-moe-16b and whisper-large-v3, train, prefill and
decode: the port's collectives by kind, counted on rank 0 of a 4-rank
fake group, against `repro.launch.hlo_analysis.analyze` of the
reference's compiled sharded step (`repro.launch.dryrun.run_cell` on a
4-device host mesh, in a subprocess; f32, because XLA:CPU promotes bf16
collectives to f32).  Both count a collective's result shape on one
device.  No kind of any cell moves the same data in both: GSPMD keeps
the projections' outputs sharded and reduces them in the reference's
own pattern, while DTensor's sharding propagation picks a layout per op
(gathering activations and some weights, re-sharding heads with
all-to-alls, reduce-scattering the row-parallel outputs).  `GAP`
records both values of each kind, listed in ROADMAP.md §3.  The counter
itself is held two ways: one collective of each kind alone, run through
the reference's compiled program and through DTensor on the fake group,
counts the same (count, bytes, f32_bytes) in f32 and in int32; and every
collective the port runs in internlm2-1.8b's decode is written out from
the model's shapes, site by site, kind by kind.

(b) The counter on two real gloo CPU ranks equals it on a 2-rank fake
group for the sharded gather FFN's forward and backward (phase 27 (a)'s
call, at smoke width).  The same ranks run a prefill and a decode step
on (data 1, model 2) into caches whose sequence is sharded over 'model'
(whisper-large-v3's decoder cache, its attention also in seq mode;
internlm2-1.8b's, a 12-token prompt into 32 slots), held against the
unsharded run: DTensor's own slice
assignment into a sharded dim writes nothing, so the cache is written
shard by shard (`attention._write_rows`; ROADMAP.md §3).

(c) The sharded peak on a 1 x 1 mesh equals the unsharded trace's; on
(data 1, model 2) a one-layer decode's peak is smaller, by bytes worked
out from the layer's shapes.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import comm_analysis, dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_elastic_mesh  # noqa: E402
from test_torch_dryrun import smoke_overrides  # noqa: E402

ARCHS = ["internlm2-1.8b", "deepseek-moe-16b", "whisper-large-v3"]
KINDS = ["train", "prefill", "decode"]
B, S = 8, 32

REF = f"""
ARCHS, KINDS, B, S = {ARCHS!r}, {KINDS!r}, {B}, {S}
""" + r'''
import sys
from pathlib import Path
import jax
import numpy as np
jax.devices()        # 4 host devices, before the dry run sets its flags
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ShapeConfig
from repro.launch import dryrun
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
dump({}, tmp / "inputs.pkl")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
dryrun.make_production_mesh = lambda multi_pod=False: mesh
out = {}
for arch in ARCHS:
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    configs.get_config = lambda a, cfg=cfg: cfg
    for kind in KINDS:
        dryrun.shape_by_name = lambda n, kind=kind: ShapeConfig(n, S, B, kind)
        rec = dryrun.run_cell(arch, "smoke_" + kind, False)
        out[arch, kind] = rec["analysis"]

# one collective of each kind alone, over 'model', on a (4, 8) block of
# each device: the counter's kinds and byte rule against hlo_analysis's
import jax.numpy as jnp
from jax.sharding import PartitionSpec
from repro.compat import shard_map
from repro.launch import hlo_analysis
MATCHED = {
    "all-reduce": lambda b: jax.lax.psum(b, "model"),
    "all-gather": lambda b: jax.lax.all_gather(b, "model", axis=1,
                                               tiled=True),
    "reduce-scatter": lambda b: jax.lax.psum_scatter(
        b, "model", scatter_dimension=1, tiled=True),
    "all-to-all": lambda b: jax.lax.all_to_all(b, "model", 0, 1, tiled=True),
    "collective-permute": lambda b: jax.lax.ppermute(b, "model",
                                                     [(0, 1), (1, 0)]),
}
spec = PartitionSpec("data", "model")
for dtype in ("float32", "int32"):
    x = jnp.zeros((8, 16), dtype)
    for kind, f in MATCHED.items():
        step = jax.jit(shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec))
        out["matched", kind, dtype] = hlo_analysis.analyze(
            step.lower(x).compile().as_text())
dump(out, tmp / "ref.pkl")
'''

FFN = r'''
def ffn_case(cfg, tokens, device):
    """Seeded weights, DSG state, x and cotangent of one SwiGLU FFN."""
    import torch
    from repro_torch.core import dsg_linear as dl
    from repro_torch.core.projection import make_projection
    gen = torch.Generator().manual_seed(27)
    d, f = cfg.d_model, cfg.d_ff

    def normal(shape):
        return torch.randn(shape, generator=gen).to(device)
    w = {"w_gate": normal((d, f)), "w_up": normal((d, f)),
         "w_down": normal((f, d))}
    r = make_projection(dl.proj_dim(d, f, cfg.dsg), d, generator=gen,
                        dtype=torch.float32, device="cpu").to(device)
    return w, {"r": r, "fw": r @ w["w_gate"]}, normal(tokens + (d,)), \
        normal(tokens + (d,))


def ffn_call(cfg, mesh, w, st, x, gy):
    """The sharded gather FFN's forward and backward, dx reduced."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.core import dsg_linear as dl
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.sharding import P, distribute
    dcfg = cfg.dsg._replace(mode="gather_shared", n_chunks=2)
    wd = {"w_gate": distribute(w["w_gate"], mesh, P(None, "model")),
          "w_up": distribute(w["w_up"], mesh, P(None, "model")),
          "w_down": distribute(w["w_down"], mesh, P("model", None))}
    for t in wd.values():
        t.requires_grad_(True)
    std = {"r": distribute(st["r"], mesh, P()),
           "fw": distribute(st["fw"], mesh, P(None, "model"))}
    xd = distribute(x, mesh, P(("data",), None, None)).requires_grad_(True)
    gyd = distribute(gy, mesh, P(("data",), None, None))
    ffn = type("FFN", (), wd)

    def call():
        with pctx.use_mesh(mesh):
            y = dl.swiglu_dsg_gather_sharded(ffn, xd, std, dcfg)
            g = torch.autograd.grad(
                y, [xd, wd["w_gate"], wd["w_up"], wd["w_down"]],
                grad_outputs=gyd)
            return g[0].redistribute(mesh, [g[0].placements[0],
                                            Replicate()])
    return call
'''
FFN_TOKENS = (2, 16)

# a case of the sharded cache writes: (arch, config overrides); whisper
# also in seq mode, its cross-attention then splitting the query rows
CACHE_CASES = {"whisper": ("whisper-large-v3", {}),
               "whisper_seq": ("whisper-large-v3", {"attn_shard": "seq"}),
               "internlm2": ("internlm2-1.8b", {})}

RANKS = FFN + f"""
FFN_TOKENS = {FFN_TOKENS!r}
CACHE_CASES = {CACHE_CASES!r}
""" + r'''
import sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import comm_analysis
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models import api, specs
from repro_torch.parallel.sharding import (axes_for_mesh, distribute,
                                           distribute_model, distribute_tree)
try:
    mesh = make_elastic_mesh(2, model=2, device_type="cpu")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    call = ffn_call(cfg, mesh, *ffn_case(cfg, FFN_TOKENS, "cpu"))
    _, counted = comm_analysis.analyze(call)
    every = [None] * n
    dist.all_gather_object(every, counted)

    # a prefill and a decode step, sharded and not, into caches whose
    # sequence is sharded over 'model': whisper-large-v3's decoder cache
    # (one position shared by the batch) and internlm2-1.8b's (a prompt
    # of 12 into 32 slots, lanes then at their own positions)
    ax = axes_for_mesh(mesh)

    def run(case, layout):
        arch, over = CACHE_CASES[case]
        c = configs.get_smoke_config(arch).replace(dtype="float32", **over)
        gen = torch.Generator().manual_seed(5)
        model = api.init_model(c, generator=gen, device="cpu")
        dsg = api.init_dsg(model, c, generator=gen, device="cpu")
        seq = 32 if c.family == "encdec" else 12
        inputs = api.make_inputs(c, ShapeConfig("p", seq, 2, "prefill"),
                                 concrete=True, device="cpu")
        cache = api.make_cache(c, 2, 32, device="cpu")
        token = inputs["tokens"][:, :1]
        pos = (inputs["tokens"].shape[1] if c.family == "encdec"
               else torch.tensor([12, 12], dtype=torch.int32))
        kw = {}
        if layout:
            distribute_model(model, mesh,
                             specs.param_specs(model, c, ax, 2))
            dsg = distribute_tree(dsg, mesh, specs.dsg_specs(dsg, c, ax, 2))
            ispecs = specs.input_specs(inputs, c, ax)
            inputs = {k: distribute(v, mesh, ispecs[k])
                      for k, v in inputs.items()}
            cache = distribute_tree(cache, mesh,
                                    specs.cache_specs(cache, c, ax, 2))
            kw = {"mesh": mesh, "batch_axes": ax.batch}
        full = (lambda t: t.full_tensor()) if layout else (lambda t: t)
        last, st = api.prefill(model, dsg, c, inputs, cache, **kw)
        kv = st["self"] if c.family == "encdec" else st
        out = {"prefill": full(last), "prefill_k": full(kv["k"]).clone()}
        step, st = api.decode_step(model, dsg, c, token, st, pos, **kw)
        kv = st["self"] if c.family == "encdec" else st
        out.update(decode=full(step), decode_k=full(kv["k"]))
        return out

    caches = {case: {"sharded": run(case, True), "plain": run(case, False)}
              for case in CACHE_CASES}
    if rank == 0:
        dump({"counted": every, "caches": caches}, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mh.run(tmp_path_factory.mktemp("dryrun_coll"), REF, 4, RANKS, 2,
                  timeout=900)


_PORT = {}


def _port(arch: str, kind: str) -> dict:
    """The port's analysis of the smoke cell, traced on rank 0 of a
    4-rank fake group on a (data 2, model 2) mesh of the card's type."""
    if (arch, kind) not in _PORT:
        over = smoke_overrides(arch) + ["dtype='float32'"]
        with fake_world(4):
            mesh = make_elastic_mesh(4, model=2, device_type="cuda")
            cell = dryrun.build_cell(arch, ShapeConfig("s", S, B, kind), mesh,
                                     overrides=over)
            _PORT[arch, kind] = dryrun.trace_sharded(cell)[0]
    return _PORT[arch, kind]


def _pairs(analysis: dict) -> dict:
    return {k: (int(v["count"]), int(v["bytes"]))
            for k, v in analysis["collectives"].items()}


# (arch, kind, collective kind) -> ((port count, port bytes), (reference
# count, reference bytes)) at B 8 x S 32 on (data 2, model 2), f32; the
# kinds not listed are equal (none ran, or the same in both)
GAP = {
    ("internlm2-1.8b", "train", "all-reduce"): ((67, 1021268), (53, 1151164)),
    ("internlm2-1.8b", "train", "all-gather"): ((115, 2427200), (22, 313728)),
    ("internlm2-1.8b", "train", "reduce-scatter"): ((66, 1064960), (0, 0)),
    ("internlm2-1.8b", "train", "all-to-all"): ((26, 246784), (4, 33792)),
    ("internlm2-1.8b", "train", "collective-permute"): ((0, 0), (2, 512)),
    ("internlm2-1.8b", "prefill", "all-reduce"): ((3, 98304), (7, 66600)),
    ("internlm2-1.8b", "prefill", "all-gather"): ((19, 467984), (17, 659456)),
    ("internlm2-1.8b", "prefill", "reduce-scatter"): ((6, 245760), (0, 0)),
    ("internlm2-1.8b", "prefill", "all-to-all"): ((5, 81920), (8, 65536)),
    ("internlm2-1.8b", "prefill", "collective-permute"): ((0, 0), (1, 1024)),
    ("internlm2-1.8b", "decode", "all-reduce"): ((12, 11264), (15, 7448)),
    ("internlm2-1.8b", "decode", "all-gather"): ((19, 498048), (8, 4128)),
    ("internlm2-1.8b", "decode", "reduce-scatter"): ((8, 13312), (0, 0)),
    ("internlm2-1.8b", "decode", "all-to-all"): ((2, 4096), (0, 0)),
    ("deepseek-moe-16b", "train", "all-reduce"): ((133, 1777492),
                                                  (53, 1976632)),
    ("deepseek-moe-16b", "train", "all-gather"): ((133, 2375456),
                                                  (26, 627008)),
    ("deepseek-moe-16b", "train", "reduce-scatter"): ((74, 727040), (0, 0)),
    ("deepseek-moe-16b", "train", "all-to-all"): ((26, 213504), (4, 33792)),
    ("deepseek-moe-16b", "train", "collective-permute"): ((0, 0), (6, 2560)),
    ("deepseek-moe-16b", "prefill", "all-reduce"): ((7, 198656), (9, 132120)),
    ("deepseek-moe-16b", "prefill", "all-gather"): ((22, 484352),
                                                    (19, 493568)),
    ("deepseek-moe-16b", "prefill", "reduce-scatter"): ((5, 131072), (0, 0)),
    ("deepseek-moe-16b", "prefill", "all-to-all"): ((5, 81920), (8, 98304)),
    ("deepseek-moe-16b", "prefill", "collective-permute"): ((0, 0),
                                                            (1, 1024)),
    ("deepseek-moe-16b", "decode", "all-reduce"): ((7, 6208), (15, 9488)),
    ("deepseek-moe-16b", "decode", "all-gather"): ((25, 149704), (8, 6160)),
    ("deepseek-moe-16b", "decode", "reduce-scatter"): ((8, 5632), (0, 0)),
    ("whisper-large-v3", "train", "all-reduce"): ((144, 1505444),
                                                  (57, 1202860)),
    ("whisper-large-v3", "train", "all-gather"): ((146, 2676256),
                                                  (41, 530816)),
    ("whisper-large-v3", "train", "reduce-scatter"): ((69, 1138688), (0, 0)),
    ("whisper-large-v3", "train", "all-to-all"): ((28, 443392), (1, 8192)),
    ("whisper-large-v3", "train", "collective-permute"): ((0, 0), (1, 128)),
    ("whisper-large-v3", "prefill", "all-reduce"): ((18, 189440),
                                                    (19, 188464)),
    ("whisper-large-v3", "prefill", "all-gather"): ((31, 748560), (4, 64)),
    ("whisper-large-v3", "prefill", "reduce-scatter"): ((12, 258048),
                                                        (0, 0)),
    ("whisper-large-v3", "prefill", "all-to-all"): ((13, 163840), (4, 16384)),
    ("whisper-large-v3", "decode", "all-reduce"): ((16, 16384), (23, 11800)),
    ("whisper-large-v3", "decode", "all-gather"): ((19, 414080), (10, 8224)),
    ("whisper-large-v3", "decode", "reduce-scatter"): ((8, 10240), (0, 0)),
    ("whisper-large-v3", "decode", "all-to-all"): ((6, 69632), (0, 0)),
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_collectives_against_the_reference_hlo_analysis(runs, arch, kind):
    ref, port = _pairs(runs[0][arch, kind]), _pairs(_port(arch, kind))
    got = {k: (port[k], ref[k]) for k in comm_analysis.COLLECTIVES
           if port[k] != ref[k]}
    want = {k: GAP[arch, kind, k] for k in comm_analysis.COLLECTIVES
            if (arch, kind, k) in GAP}
    assert got == want, (arch, kind, got)
    # the port moves f32 alone here; the reference some s32 too
    assert all(v["f32_bytes"] == v["bytes"]
               for v in _port(arch, kind)["collectives"].values())
    assert all(v["f32_bytes"] <= v["bytes"]
               for v in runs[0][arch, kind]["collectives"].values())


def test_decode_all_reduces_written_out_from_the_shapes():
    """internlm2-1.8b's decode on (data 2, model 2): each all-reduce the
    port runs, from the smoke model's shapes (f32, L 2 layers, d 64,
    H 4 heads, Kv 2, D 16; a data shard's Bd = B / 2 lanes of one token).
    Where both mesh dims hold a partial sum, DTensor reduces one dim at
    a time: two all-reduces."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    L, d, H, Kv, D = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
                      cfg.head_dim)
    bd, f32 = B // 2, 4
    row = bd * d * f32                   # one (Bd, 1, d) residual row
    sites = [
        (L, row),        # the attention norm's input, partial over 'model'
        (2 * L, row),    # the FFN norm's input, partial over both dims
        (2, row),        # the final norm's input, partial over both dims
        (1, row),        # the sharded DSG psum of one layer
        (2, bd * Kv * D * f32),   # the new K and V rows, reduced to write
        (1, bd * H * D * f32),    # q laid out for split-KV decode
    ]
    got = _pairs(_port("internlm2-1.8b", "decode"))["all-reduce"]
    assert got == (sum(n for n, _ in sites), sum(n * b for n, b in sites))


# the port's move for each kind of MATCHED: the block's placements
# (data, model) on a global (8, 16) before and after
def _moves():
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"all-reduce": ([Shard(0), Partial()], [Shard(0), Replicate()]),
            "all-gather": ([Shard(0), Shard(1)], [Shard(0), Replicate()]),
            "reduce-scatter": ([Shard(0), Partial()], [Shard(0), Shard(1)]),
            "all-to-all": ([Shard(0), Shard(1)], [Shard(0), Shard(0)])}


@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("kind", comm_analysis.COLLECTIVES)
def test_one_collective_counts_as_hlo_analysis_does(runs, kind, dtype):
    """The same movement of a (4, 8) block over 'model' on (data 2,
    model 2): a DTensor redistribute (ppermute for the permute) on rank 0
    of a 4-rank fake group of the card's type, against the reference's
    shard_map collective: the result on one device, f32 alone under
    f32_bytes."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import collectives
    with fake_world(4):
        mesh = make_elastic_mesh(4, model=2, device_type="cuda")
        block = torch.zeros((4, 8), dtype=getattr(torch, dtype),
                            device="meta")
        if kind == "collective-permute":
            _, port = comm_analysis.analyze(lambda: collectives.ppermute(
                block, "model", [(0, 1), (1, 0)], mesh))
        else:
            src, dst = _moves()[kind]
            t = DTensor.from_local(block, mesh, src, run_check=False)
            _, port = comm_analysis.analyze(lambda: t.redistribute(mesh, dst))
    ref = runs[0]["matched", kind, dtype]["collectives"]
    want = 4 * 8 * 4 * {"all-gather": 2, "reduce-scatter": 0.5}.get(kind, 1)
    assert ref[kind]["count"] == 1 and ref[kind]["bytes"] == want
    assert {k: (int(v["count"]), int(v["bytes"]), int(v["f32_bytes"]))
            for k, v in port["collectives"].items()} == \
        {k: (int(v["count"]), int(v["bytes"]), int(v["f32_bytes"]))
         for k, v in ref.items()}
    assert "unmapped" not in port


@pytest.mark.parametrize("coll", ["all-gather", "reduce-scatter",
                                  "all-to-all"])
def test_decode_collectives_written_out_from_the_shapes(coll):
    """internlm2-1.8b's decode on (data 2, model 2), as the all-reduces
    above: each all-gather, reduce-scatter and all-to-all the port runs,
    by its result on this rank (f32, L 2 layers, d 64, F 256, vocab V
    256, H 4, Kv 2, D 16, DSG groups G = F / 64 scored on a pk-row
    projection; B 8 lanes, Bd = B / 2 a data shard's, T 32 cache slots).
    Layer 0 and layer 1 differ: the residual reaches layer 1 split over
    d, and DTensor then gathers the projections' weights where it
    gathered layer 0's activations."""
    from repro_torch.core import dsg_linear as dl
    cfg = configs.get_smoke_config("internlm2-1.8b")
    L, d, F, V, H, Kv, D = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab,
                            cfg.n_heads, cfg.n_kv, cfg.head_dim)
    G, pk = F // cfg.dsg.block, dl.proj_dim(d, F, cfg.dsg)
    bd, t, f32 = B // 2, S, 4
    ffn = [             # each layer's DSG FFN
        (1, pk * F),    # fw (pk, F) gathered over F, for the scores
        (1, bd * G),    # the group scores' lanes, gathered over 'model'
        (1, B * G),     # ... then over 'data', for the batch's EMA
        (2, d * F),     # w_gate and w_up gathered over F
    ]
    sites = {
        "all-gather": [
            (2, bd * Kv * D),    # layer 0: new K and V rows, to the lanes
            (1, bd * H * D),     # layer 0: q's heads, for split-KV decode
            (1, d * H * D),      # layer 1: wq gathered over its heads
            (2, d * Kv * D),     # layer 1: wk and wv
            (L, bd * H * t),     # the attention weights over the keys
            *[(L * n, b) for n, b in ffn],
            (1, V * d),          # the LM head (d, V), gathered over V
        ],
        "reduce-scatter": [
            (L, bd * d // 2),    # the out-projection's partial sums
            (L, bd // 2 * F),    # the virtual pre-activations (scores)
            (2 * L, bd // 2 * F),  # x @ w_gate and x @ w_up
        ],
        "all-to-all": [
            (L, bd * F // 2),    # h: from split lanes to split F
        ],
    }[coll]
    got = _pairs(_port("internlm2-1.8b", "decode"))[coll]
    assert got == (sum(n for n, _ in sites),
                   sum(n * b * f32 for n, b in sites))


def test_counter_on_gloo_ranks_equals_the_fake_world(runs):
    from repro_torch.launch.mesh import make_elastic_mesh as elastic
    ns = {}
    exec(FFN, ns)
    cfg = configs.get_smoke_config("internlm2-1.8b")
    w, st, x, gy = ns["ffn_case"](cfg, FFN_TOKENS, "meta")
    with fake_world(2):
        mesh = elastic(2, model=2, device_type="cpu")
        _, traced = comm_analysis.analyze(ns["ffn_call"](cfg, mesh, w, st,
                                                         x, gy))
    counted = runs[1]["counted"]
    assert len(counted) == 2
    for c in counted:
        assert c == traced
    # the psum of the two shards' outputs and dx's reduction
    assert _pairs(traced)["all-reduce"] == (2, 2 * 2 * 16 * cfg.d_model * 4)


@pytest.mark.parametrize("part", ["prefill", "prefill_k", "decode",
                                  "decode_k"])
@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_sharded_cache_writes_match_the_unsharded_run(runs, case, part):
    got = runs[1]["caches"][case]
    a, b = got["sharded"][part], got["plain"][part]
    assert a.shape == b.shape
    assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_peak_on_one_device_equals_the_unsharded_trace(arch, kind):
    over = smoke_overrides(arch) + ["dtype='float32'"]
    with fake_world(1):
        mesh = make_elastic_mesh(1, model=1, device_type="cuda")
        cell = dryrun.build_cell(arch, ShapeConfig("s", S, B, kind), mesh,
                                 overrides=over)
        unsharded, batch = dryrun.trace_peak(cell)
        analysis, sharded = dryrun.trace_sharded(cell)
    assert batch == B and sharded == unsharded
    assert analysis["collective_total_bytes"] == 0


def _one_layer_decode_peak(n_model: int) -> int:
    over = smoke_overrides("internlm2-1.8b") + [
        "n_layers=1", "dsg.enabled=False"]
    with fake_world(n_model):
        mesh = make_elastic_mesh(n_model, model=n_model, device_type="cuda")
        cell = dryrun.build_cell("internlm2-1.8b",
                                 ShapeConfig("d", 32, 4, "decode"), mesh,
                                 overrides=over)
        args = dryrun.memory(cell)["argument_size_in_bytes"]
        return args, dryrun.trace_sharded(cell)[1]


def test_sharded_peak_of_one_layer_by_hand():
    """internlm2-1.8b's smoke layer (f32, d 64, F 256, vocab V 256, H 4,
    Kv 2, D 16), DSG off, one decode step of B 4 lanes over T 32 slots.
    On one device the peak is at the attention; on (data 1, model 2) at
    the FFN, where DTensor gathers w_gate whole."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    d, F, V, H, Kv, D = (cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_heads,
                         cfg.n_kv, cfg.head_dim)
    b, t, f32, i64 = 4, 32, 4, 8

    def state(m):
        """The arguments' bytes with the model split m ways: vocab,
        FFN width, heads and cache slots split, norms replicated."""
        weights = (2 * V * d + 3 * d * F + 2 * d * H * D + 2 * d * Kv * D)
        return f32 * (weights // m + 3 * d + 2 * b * t * Kv * D // m) + 4 * b

    one = (state(1)
           + 2 * b * t * H * D * f32     # K and V repeated to H heads
           + b * H * t * D * f32         # V laid out for the product
           + 2 * b * H * t * f32         # the scores, masked and softmaxed
           + 4 * b * d * f32             # q's and the residual's rows
           + 2 * b * Kv * D * f32        # the new k row, projected, roped
           + t * i64 + b * t             # slot positions, causal mask
           + 2 * b * i64 + b * 4 + i64)  # write positions, token, step
    two = (state(2)
           + 2 * d * F * f32             # w_gate gathered, then joined
           + (b // 2) * F * f32          # silu of a model shard's lanes
           + 4 * b * d * f32             # the psum, out-projection, rows
           + b * i64 + b * 4 + i64)      # positions, token, step
    args1, peak1 = _one_layer_decode_peak(1)
    args2, peak2 = _one_layer_decode_peak(2)
    assert (args1, args2) == (state(1), state(2))
    assert (peak1, peak2) == (one, two)
    assert peak1 - peak2 == one - two > 0


@pytest.mark.parametrize("kind", KINDS)
def test_uneven_groups_and_transposed_grads_trace_sharded(kind):
    """deepseek-moe-16b's smoke model with 22 DSG groups in each FFN
    (d_ff 1408, block 64) on a model axis of 4, which splits groups (as
    the full config's 22 shared-expert groups over 16): the group
    reshapes gather the groups whole (`context.whole_groups`), forward
    and backward; and the attention core's input gradients come back
    row-major (`collectives._RowMajorGrad`), which training views."""
    over = smoke_overrides("deepseek-moe-16b") + ["moe_d_ff=1408"]
    with fake_world(4):
        mesh = make_elastic_mesh(4, model=4, device_type="cuda")
        cell = dryrun.build_cell("deepseek-moe-16b",
                                 ShapeConfig("s", 64, 8, kind), mesh,
                                 overrides=over)
        analysis, peak = dryrun.trace_sharded(cell)
    assert peak > dryrun.memory(cell)["argument_size_in_bytes"]
    assert analysis["collectives"]["all-gather"]["count"] > 0


def test_uneven_heads_trace_sharded_at_full_width():
    """whisper-large-v3's 20 heads over the single-pod model axis of 16,
    at full width (two decoder layers and one encoder layer, 32 x 1024
    frames): from the second decoder layer DTensor hands the attention
    output's heads back split unevenly, and the output projection
    gathers them whole (`attention._out`) before it merges them."""
    from repro_torch.launch.mesh import make_production_mesh
    with fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        cell = dryrun.build_cell(
            "whisper-large-v3", ShapeConfig("p", 1024, 32, "prefill"), mesh,
            overrides=["n_layers=2", "enc_layers=1"])
        analysis, peak = dryrun.trace_sharded(cell)
    assert peak > dryrun.memory(cell)["argument_size_in_bytes"]
    assert analysis["collective_total_bytes"] > 0
