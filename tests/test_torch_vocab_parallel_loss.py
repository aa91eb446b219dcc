"""The vocab-parallel loss (`transformer.sharded_cross_entropy`) on gloo
CPU ranks.

Logits (B 4, S 8, V 64) and labels from a numpy seed, every shard's
first and last vocabulary id among the labels, laid out (batch over the
batch axes, vocab over 'model') on (data 1, model 2) over two ranks and
on (data 2, model 2) over four, with and without a token mask.  Held
against the unsharded `cross_entropy` of the same logits on each rank
(the loss within 4 f32 ulps, the logits' gradient within 1e-4 of its
largest entry, ROADMAP.md §3's f32 rule) and against the reference's
`cross_entropy` compiled with the same layout on a four-device host mesh
(GSPMD partitions it over the vocab shards), loss and gradient.  On a
model axis of 1 the function is `cross_entropy` bit for bit.  Each rank
counts the call's collectives: three all-reduces over 'model' of one
(rows, S) f32 block each (the max, the sum of exponentials, the gold
logit), none in the backward, equal to the same call traced on a fake
group.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_harness as mh  # noqa: E402

LOSS_ULPS = 4
GRAD_TOL = 1e-4
B, S, V = 4, 8, 64

COMMON = f"""
B, S, V = {B}, {S}, {V}
""" + r'''
import numpy as np


def case_inputs():
    rng = np.random.default_rng(27)
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    # the first and last id of each of two and four shards
    edges = [0, V // 4 - 1, V // 4, V // 2 - 1, V // 2, 3 * V // 4 - 1,
             3 * V // 4, V - 1]
    labels[0, :len(edges)] = edges
    labels[B - 1, :len(edges)] = edges[::-1]
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    return logits, labels, mask
'''

REF = COMMON + r'''
import sys
from pathlib import Path
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.models.transformer import cross_entropy
from torch_mesh_harness import dump

tmp = Path(sys.argv[1])
dump({}, tmp / "inputs.pkl")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
logits, labels, mask = case_inputs()
lg = jax.device_put(logits, NamedSharding(mesh, P(("data",), None, "model")))
lb = jax.device_put(labels, NamedSharding(mesh, P(("data",), None)))
mk = jax.device_put(mask, NamedSharding(mesh, P(("data",), None)))
out = {}
for masked in (False, True):
    f = jax.jit(jax.value_and_grad(
        lambda x: cross_entropy(x, lb, mk if masked else None)))
    loss, grad = f(lg)
    out[masked] = (float(loss), np.asarray(grad))
dump(out, tmp / "ref.pkl")
'''

RANKS = COMMON + r'''
import sys
from pathlib import Path
import torch
import torch.distributed as dist
from torch_mesh_harness import dump, init_ranks

rank, n, tmp = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
init_ranks(rank, n, tmp)
from repro_torch.launch import comm_analysis
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.models.transformer import (cross_entropy,
                                            sharded_cross_entropy)
from repro_torch.parallel import context as pctx
from repro_torch.parallel.sharding import P, distribute


def run(mesh, masked, data_axes=("data",)):
    logits, labels, mask = (torch.from_numpy(a) for a in case_inputs())
    lg = distribute(logits, mesh, P(data_axes, None, "model"))
    lg.requires_grad_(True)
    lb = distribute(labels, mesh, P(data_axes, None))
    mk = distribute(mask, mesh, P(data_axes, None)) if masked else None
    with pctx.use_mesh(mesh):
        loss = sharded_cross_entropy(lg, lb, mk)
        (grad,) = torch.autograd.grad(loss, [lg])
        got = (float(loss.full_tensor()), grad.full_tensor().numpy())
    x = logits.clone().requires_grad_(True)
    want_loss = cross_entropy(x, labels, mask if masked else None)
    (want_grad,) = torch.autograd.grad(want_loss, [x])
    return {"got": got, "want": (float(want_loss), want_grad.numpy())}


try:
    model = 2 if n >= 2 else 1
    mesh = make_elastic_mesh(n, model=model, device_type="cpu")
    out = {masked: run(mesh, masked) for masked in (False, True)}

    logits, labels, _ = (torch.from_numpy(a) for a in case_inputs())
    lg = distribute(logits, mesh, P(("data",), None, "model"))
    lg.requires_grad_(True)
    lb = distribute(labels, mesh, P(("data",), None))

    def call():
        with pctx.use_mesh(mesh):
            loss = sharded_cross_entropy(lg, lb)
            return torch.autograd.grad(loss, [lg])
    _, counted = comm_analysis.analyze(call)
    out["counted"] = [None] * n
    dist.all_gather_object(out["counted"], counted)
    if n == 2:
        # a model axis of 1 (data 2): the function is cross_entropy
        one = make_elastic_mesh(2, model=1, device_type="cpu")
        out["model1"] = run(one, True)
    if rank == 0:
        dump(out, tmp / "torch.pkl")
finally:
    dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    two = mh.run_ranks(tmp_path_factory.mktemp("vp_loss2"), RANKS, 2,
                       timeout=300)
    ref, four = mh.run(tmp_path_factory.mktemp("vp_loss4"), REF, 4, RANKS,
                       4, timeout=300)
    return {"ref": ref, 2: two, 4: four}


def _check(got, want):
    assert mh.ulps(got[0], want[0]) <= LOSS_ULPS, (got[0], want[0])
    assert mh.leaf_err(got[1], want[1]) <= GRAD_TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ranks", [2, 4])
def test_vocab_parallel_loss_matches_the_unsharded_loss(runs, ranks,
                                                        masked):
    case = runs[ranks][masked]
    _check(case["got"], case["want"])


@pytest.mark.parametrize("masked", [False, True])
def test_vocab_parallel_loss_matches_the_reference(runs, masked):
    _check(runs[4][masked]["got"], runs["ref"][masked])


def test_model_axis_of_one_is_cross_entropy(runs):
    case = runs[2]["model1"]
    assert case["got"][0] == case["want"][0]
    assert np.array_equal(case["got"][1], case["want"][1])


def test_labels_on_every_shard_edge_are_held():
    """The labels the ranks read hold the first and last id of each
    shard of two and of four, in rows of both data shards."""
    ns = {}
    exec(COMMON, ns)
    _, labels, _ = ns["case_inputs"]()
    for shards in (2, 4):
        rows = V // shards
        edges = {i * rows for i in range(shards)} | \
            {(i + 1) * rows - 1 for i in range(shards)}
        for row in (0, B - 1):
            assert edges <= set(labels[row].tolist())


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_are_three_all_reduces_of_the_rows(runs, ranks):
    """max, sum and gold: one (rows, S) f32 block each, over 'model', on
    every rank; equal to the fake group's trace of the same call."""
    from repro_torch.launch import comm_analysis
    from repro_torch.launch.mesh import fake_world, make_elastic_mesh
    from repro_torch.models.transformer import sharded_cross_entropy
    from repro_torch.parallel import context as pctx
    from repro_torch.parallel.sharding import P, distribute
    counted = runs[ranks]["counted"]
    assert len(counted) == ranks and all(c == counted[0] for c in counted)
    rows = B // (ranks // 2)
    got = {k: (int(v["count"]), int(v["bytes"]))
           for k, v in counted[0]["collectives"].items() if v["count"]}
    assert got == {"all-reduce": (3, 3 * rows * S * 4)}
    with fake_world(ranks):
        mesh = make_elastic_mesh(ranks, model=2, device_type="cpu")
        lg = distribute(torch.zeros((B, S, V), device="meta"), mesh,
                        P(("data",), None, "model")).requires_grad_(True)
        lb = distribute(torch.zeros((B, S), dtype=torch.int32,
                                    device="meta"), mesh, P(("data",), None))

        def call():
            with pctx.use_mesh(mesh):
                return torch.autograd.grad(sharded_cross_entropy(lg, lb),
                                           [lg])
        _, traced = comm_analysis.analyze(call)
    # HBM bytes count device memory: the gloo ranks' tensors are in host
    # memory, the fake group's on the meta device
    assert counted[0]["bytes"] == 0 < traced["bytes"]
    assert dict(counted[0], bytes=traced["bytes"]) == traced
