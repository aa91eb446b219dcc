"""The dry run's sharded trace (`launch.dryrun.trace_sharded`,
`launch.comm_analysis`) on the CPU.

(a) At smoke width in f32, on a (data 2, model 2) mesh, for
internlm2-1.8b, deepseek-moe-16b, whisper-large-v3, xlstm-350m and
zamba2-7b, train, prefill and decode: the port's collectives by kind, counted on rank 0 of a 4-rank
fake group, against `repro.launch.hlo_analysis.analyze` of the
reference's compiled sharded step (`repro.launch.dryrun.run_cell` on a
4-device host mesh, in a subprocess; f32, because XLA:CPU promotes bf16
collectives to f32).  Both count a collective's result shape on one
device.  The port's projections, loss and embedding are shard_map bodies
that keep the reference's pattern (q/k/v and gate/up column-parallel,
the out- and down-projections row-parallel with one all-reduce each, the
split-KV decode's three reductions, the vocab-parallel loss's three), and
its gradients are reduced once a step in buckets; the recurrent
families' blocks are shard_map bodies with the reference's row- and
column-parallel projections and their scans on local shards
(`models/recurrent.py`), where the reference's partitioner permutes the
scans' carries step by step; every cell stays within 1.25x the
reference's bytes and 1.5x its count, and no decode cell gathers a
weight.  `GAP` records both values of each kind that
still differs, each cause given site by site in ROADMAP.md §3.  The counter
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
# traced as every family is since the recurrent families' bodies
RECURRENT = ["xlstm-350m", "zamba2-7b"]
KINDS = ["train", "prefill", "decode"]
B, S = 8, 32

REF = f"""
ARCHS, KINDS, B, S = {ARCHS + RECURRENT!r}, {KINDS!r}, {B}, {S}
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
# kinds not listed are equal (none ran, or the same in both).  Each
# entry's cause, site by site, is in ROADMAP.md section 3.
GAP = {
    ("internlm2-1.8b", "train", "all-reduce"): ((45, 709012), (53, 1151164)),
    ("internlm2-1.8b", "train", "all-gather"): ((29, 312704), (22, 313728)),
    ("internlm2-1.8b", "train", "all-to-all"): ((0, 0), (4, 33792)),
    ("internlm2-1.8b", "train", "collective-permute"): ((0, 0), (2, 512)),
    ("internlm2-1.8b", "prefill", "all-reduce"): ((7, 163856), (7, 66600)),
    ("internlm2-1.8b", "prefill", "all-gather"): ((6, 65568), (17, 659456)),
    ("internlm2-1.8b", "prefill", "all-to-all"): ((0, 0), (8, 65536)),
    ("internlm2-1.8b", "prefill", "collective-permute"): ((0, 0), (1, 1024)),
    ("internlm2-1.8b", "decode", "all-reduce"): ((13, 7440), (15, 7448)),
    ("deepseek-moe-16b", "train", "all-reduce"): ((73, 1221364),
                                                  (53, 1976632)),
    ("deepseek-moe-16b", "train", "all-gather"): ((37, 625984),
                                                  (26, 627008)),
    ("deepseek-moe-16b", "train", "reduce-scatter"): ((4, 4096), (0, 0)),
    ("deepseek-moe-16b", "train", "all-to-all"): ((0, 0), (4, 33792)),
    ("deepseek-moe-16b", "train", "collective-permute"): ((0, 0), (6, 2560)),
    ("deepseek-moe-16b", "prefill", "all-reduce"): ((9, 229384),
                                                    (9, 132120)),
    ("deepseek-moe-16b", "prefill", "all-gather"): ((6, 131088),
                                                    (19, 493568)),
    ("deepseek-moe-16b", "prefill", "all-to-all"): ((0, 0), (8, 98304)),
    ("deepseek-moe-16b", "prefill", "collective-permute"): ((0, 0),
                                                            (1, 1024)),
    ("deepseek-moe-16b", "decode", "all-reduce"): ((15, 9480), (15, 9488)),
    ("whisper-large-v3", "train", "all-reduce"): ((46, 1013092),
                                                  (57, 1202860)),
    ("whisper-large-v3", "train", "all-gather"): ((66, 530560),
                                                  (41, 530816)),
    ("whisper-large-v3", "train", "all-to-all"): ((0, 0), (1, 8192)),
    ("whisper-large-v3", "train", "collective-permute"): ((0, 0), (1, 128)),
    ("whisper-large-v3", "prefill", "all-reduce"): ((15, 188448),
                                                    (19, 188464)),
    ("whisper-large-v3", "prefill", "all-gather"): ((8, 32832), (4, 64)),
    ("whisper-large-v3", "decode", "all-reduce"): ((21, 11792), (23, 11800)),
    ("xlstm-350m", "train", "all-reduce"): ((50, 2086452), (114, 1782712)),
    ("xlstm-350m", "train", "all-gather"): ((47, 1021248), (37, 898464)),
    ("xlstm-350m", "train", "reduce-scatter"): ((4, 131072), (0, 0)),
    ("xlstm-350m", "train", "all-to-all"): ((0, 0), (19, 299008)),
    ("xlstm-350m", "train", "collective-permute"): ((0, 0), (859, 693760)),
    ("xlstm-350m", "prefill", "all-reduce"): ((17, 692240), (19, 692256)),
    ("xlstm-350m", "prefill", "all-gather"): ((8, 262176), (4, 32)),
    ("xlstm-350m", "prefill", "collective-permute"): ((0, 0),
                                                      (268, 264192)),
    ("xlstm-350m", "decode", "all-reduce"): ((17, 21648), (19, 21664)),
    ("xlstm-350m", "decode", "all-gather"): ((8, 8224), (4, 32)),
    ("xlstm-350m", "decode", "collective-permute"): ((0, 0), (20, 8256)),
    ("zamba2-7b", "train", "all-reduce"): ((163, 1268420), (327, 3481308)),
    ("zamba2-7b", "train", "all-gather"): ((84, 434944), (274, 688448)),
    ("zamba2-7b", "train", "all-to-all"): ((0, 0), (54, 99328)),
    ("zamba2-7b", "train", "collective-permute"): ((0, 0), (228, 94720)),
    ("zamba2-7b", "prefill", "all-reduce"): ((15, 294976), (29, 327768)),
    ("zamba2-7b", "prefill", "all-gather"): ((6, 128), (22, 65664)),
    ("zamba2-7b", "prefill", "collective-permute"): ((0, 0), (16, 40960)),
    ("zamba2-7b", "decode", "all-reduce"): ((21, 11584), (27, 11608)),
    ("zamba2-7b", "decode", "all-gather"): ((12, 6272), (20, 8320)),
    ("zamba2-7b", "decode", "collective-permute"): ((0, 0), (16, 1280)),
}

# the layout's bounds against the reference, a device's totals over the
# five kinds
BYTES_BOUND, COUNT_BOUND = 1.25, 1.5


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
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


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS + RECURRENT)
def test_collectives_within_the_reference_bounds(runs, arch, kind):
    """A device's collective bytes at most 1.25x the reference's and its
    count at most 1.5x, summed over the kinds; at decode the mesh
    families' all-gathers are the reference's own (q's heads, the new K/V
    row's heads, the DSG threshold's row), so no weight is gathered (the
    recurrent families' are written out below)."""
    ref, port = _pairs(runs[0][arch, kind]), _pairs(_port(arch, kind))
    total = {name: (sum(c for c, _ in pairs.values()),
                    sum(b for _, b in pairs.values()))
             for name, pairs in (("ref", ref), ("port", port))}
    assert total["port"][1] <= BYTES_BOUND * total["ref"][1], total
    assert total["port"][0] <= COUNT_BOUND * total["ref"][0], total
    if kind == "decode" and arch in ARCHS:
        assert port["all-gather"] == ref["all-gather"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_gathers_written_out_from_the_shapes(arch):
    """Every all-gather of the recurrent families' decode on (data 2,
    model 2), by its result on this rank (f32; Bd = B / 2 lanes a data
    shard): activations and DRS threshold rows, no weight.  xlstm-350m's
    smoke model has 2 groups of an mLSTM and an sLSTM block (d 64, G = 2
    DRS groups of 32 in each gate); zamba2-7b's 2 groups of 2 Mamba2
    blocks (d_in 128, 4 DRS groups) and the shared block (H = Kv = 4 of
    16, F 256 in 8 DRS groups) called once a group."""
    cfg = configs.get_smoke_config(arch)
    bd, f32, block = B // 2, 4, cfg.dsg.block
    if arch == "xlstm-350m":
        blocks = cfg.n_layers
        sites = [
            (blocks, bd * 2 * cfg.d_model),   # the up-projection, whole
            (blocks, cfg.d_model // block),   # the threshold row's groups
        ]
    else:
        groups = cfg.n_layers // cfg.shared_attn_every
        d_in = cfg.ssm_expand * cfg.d_model
        h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
        sites = [
            (cfg.n_layers, d_in // block),    # a Mamba2 gate's threshold row
            (groups, bd * h * d),             # q, every head (split-KV)
            (2 * groups, bd * kv * d),        # the new K and V rows
            (groups, cfg.d_ff // block),      # the FFN's threshold row
        ]
    got = _pairs(_port(arch, "decode"))["all-gather"]
    assert got == (sum(n for n, _ in sites),
                   sum(n * b * f32 for n, b in sites))


def test_decode_all_reduces_written_out_from_the_shapes():
    """internlm2-1.8b's decode on (data 2, model 2): each all-reduce the
    port runs, from the smoke model's shapes (f32, L 2 layers, d 64,
    H 4 heads, D 16, F 256 in G = F / 64 DSG groups; a data shard's
    Bd = B / 2 lanes of one token).  Every one is over 'model' but the
    DSG threshold's row, which comes from the data shard holding row 0."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    L, d, H, D = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
    G = cfg.d_ff // cfg.dsg.block
    bd, f32 = B // 2, 4
    row = bd * d * f32                   # one (Bd, 1, d) residual row
    sites = [
        (1, row),                # the vocab-parallel embedding's rows
        (L, bd * H * f32),       # split-KV: the softmax's max
        (L, bd * H * f32),       # ... its sum of exponentials
        (L, bd * H * D * f32),   # ... the probabilities times V
        (L, row),                # the out-projection's partial sums
        (L, G // 2 * f32),       # row 0's scores of a model shard's
                                 # groups, from data shard 0
        (L, row),                # the FFN's down-projection partial sums
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
    by its result on this rank (f32, L 2 layers, d 64, F 256, H 4, Kv 2,
    D 16, DSG groups G = F / 64; Bd = B / 2 lanes a data shard).  The
    projections are the shard_map bodies of `models.attention` and
    `core.dsg_linear`: each rank projects its own heads and hidden
    columns, so the only gathers are of q's heads for split-KV decode,
    of the new K/V row's heads for the sequence-sharded cache, and of the
    DSG threshold's row over the model shards' groups; nothing is
    reduce-scattered or exchanged all to all, and no weight moves."""
    cfg = configs.get_smoke_config("internlm2-1.8b")
    L, F, H, Kv, D = (cfg.n_layers, cfg.d_ff, cfg.n_heads, cfg.n_kv,
                      cfg.head_dim)
    G = F // cfg.dsg.block
    bd, f32 = B // 2, 4
    sites = {
        "all-gather": [
            (L, bd * H * D),     # q, every head, for split-KV decode
            (2 * L, bd * Kv * D),    # the new K and V rows, every head
            (L, G),              # row 0's scores of every group
        ],
        "reduce-scatter": [],
        "all-to-all": [],
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
    # HBM bytes count device memory: the gloo ranks' tensors are in host
    # memory, the fake world's on the meta device
    assert traced["bytes"] > 0
    for c in counted:
        assert c["bytes"] == 0
        assert dict(c, bytes=traced["bytes"]) == traced
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
    the split-KV core's product of the probabilities and V over the
    rank's T / 2 slots, with every head's q gathered."""
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
    t2 = t // 2                          # a rank's cache slots
    two = (state(2)
           + 3 * b * t2 * H * D * f32    # its K and V repeated to H heads,
                                         # V laid out for the product
           + 2 * b * d * f32             # the residual and its norm
           + 2 * b * H * D * f32         # q gathered, the product's output
           + 3 * b * H * t2 * f32        # scores, exponentials, softmax
           + b * (H // 2) * D * f32      # q, the rank's heads
           + 2 * b * (Kv // 2) * D * f32  # the new K and V, its heads
           + t * i64                     # slot positions
           + 2 * b * H * f32             # the softmax's max and sum
           + 2 * b * i64 + b * 4 + i64)  # positions, lanes' int32, step
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
