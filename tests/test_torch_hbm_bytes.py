"""The dry run's HBM byte count (`launch.comm_analysis.op_bytes`, the
`bytes` of every record's `analysis`) on built cases, exactly.

The convention is the reference's `hlo_analysis.analyze` for a top-level
op of the partitioned program: its result's bytes plus each operand's, a
dynamic-update-slice twice its update's, a collective like any other op.
Eager PyTorch runs every op on its own, so every op is top-level: a view
moves nothing, an in-place write into a slice counts twice its update,
and a chain of elementwise ops counts each op's reads and writes where
XLA's fusion would read the chain's inputs and write its output once.
A lone dot, which XLA does not fuse, counts the same in both.  Tensors
in host memory (a mesh's rank tables) count nothing.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import comm_analysis  # noqa: E402
from repro_torch.launch.mesh import fake_world, make_elastic_mesh  # noqa: E402

F32 = 4


def _bytes(fn, *args) -> int:
    return comm_analysis.analyze(lambda: fn(*args))[1]["bytes"]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_one_matmul_counts_its_operands_and_result():
    a, b = _meta(8, 16), _meta(16, 32)
    assert _bytes(torch.matmul, a, b) == (8 * 16 + 16 * 32 + 8 * 32) * F32


@pytest.mark.parametrize("view", ["view", "t", "slice", "expand",
                                  "unsqueeze", "detach"])
def test_a_view_moves_nothing(view):
    x = _meta(8, 16)
    fn = {"view": lambda: x.view(16, 8), "t": lambda: x.t(),
          "slice": lambda: x[:, 4:12], "expand": lambda: x[None].expand(
              3, 8, 16), "unsqueeze": lambda: x.unsqueeze(1),
          "detach": lambda: x.detach()}[view]
    assert _bytes(fn) == 0


def test_empty_allocations_move_nothing():
    x = _meta(8, 16)
    assert _bytes(lambda: torch.empty_like(x)) == 0
    assert _bytes(lambda: x.new_empty((4, 4))) == 0
    # zeros writes its output
    assert _bytes(lambda: torch.zeros((8, 16), device="meta")) == \
        8 * 16 * F32


def test_an_in_place_op_reads_and_writes_its_operand():
    x, y = _meta(8, 16), _meta(8, 16)
    n = 8 * 16 * F32
    assert _bytes(lambda: x.add_(y)) == 3 * n        # reads x, y; writes x
    assert _bytes(lambda: x.add_(x)) == 2 * n        # x read once
    assert _bytes(lambda: x.zero_()) == n            # a write alone


def test_a_write_into_a_slice_counts_twice_its_update():
    buf, upd = _meta(4, 32, 16), _meta(4, 2, 16)
    n = 4 * 2 * 16 * F32

    def write():
        buf[:, 5:7] = upd
    assert _bytes(write) == 2 * n

    rows = torch.zeros(4, dtype=torch.long, device="meta")
    lanes = torch.zeros(4, dtype=torch.long, device="meta")
    vals = _meta(4, 16)

    def index_write():
        buf[lanes, rows] = vals
    assert _bytes(index_write) == 2 * 4 * 16 * F32


def test_a_chain_of_two_elementwise_ops_counts_each_op():
    """tanh(x) + y: tanh reads x and writes t, the add reads t and y and
    writes the sum (5n), where XLA's loop fusion reads x and y and writes
    the sum (3n)."""
    x, y = _meta(8, 16), _meta(8, 16)
    n = 8 * 16 * F32
    assert _bytes(lambda: torch.tanh(x) + y) == 5 * n


def test_host_tensors_count_nothing():
    x = torch.zeros(8, 16)
    assert _bytes(lambda: x + x) == 0


def test_a_broadcast_operand_counts_its_own_elements():
    x, row = _meta(8, 16), _meta(1, 16)
    assert _bytes(lambda: x * row) == (2 * 8 * 16 + 16) * F32
    assert _bytes(lambda: x * row.expand(8, 16)) == (2 * 8 * 16 + 16) * F32


@pytest.mark.parametrize("kind", comm_analysis.COLLECTIVES)
def test_one_collective_counts_its_operand_and_result(kind):
    """One collective of each kind over 'model' of a (data 2, model 2)
    fake group, on a (4, 8) f32 block: its operand and its result, as the
    reference counts a collective op; the wait moves nothing."""
    from torch.distributed import _functional_collectives as funcol
    from repro_torch.parallel import collectives
    n = 4 * 8 * F32
    with fake_world(4):
        mesh = make_elastic_mesh(4, model=2, device_type="cuda")
        group = mesh["model"]
        x = _meta(4, 8)
        fn = {
            "all-reduce": lambda: collectives.psum(x, "model", mesh),
            "all-gather": lambda: collectives.all_gather(x, "model", 0, mesh),
            "reduce-scatter": lambda: funcol.wait_tensor(
                funcol.reduce_scatter_tensor(x, "sum", 0, group)),
            "all-to-all": lambda: funcol.wait_tensor(
                funcol.all_to_all_single(x, None, None, group)),
            "collective-permute": lambda: collectives.ppermute(
                x, "model", [(0, 1), (1, 0)], mesh),
        }[kind]
        _, a = comm_analysis.analyze(fn)
    assert a["collectives"][kind]["count"] == 1
    result = {"all-gather": 2 * n, "reduce-scatter": n // 2}.get(kind, n)
    assert a["collectives"][kind]["bytes"] == result
    assert a["bytes"] == n + result


def test_a_lone_dot_counts_as_the_reference_counts_it():
    """(8, 16) @ (16, 32) in f32: the reference's compiled dot, a
    top-level op XLA does not fuse, against the counter on the port's
    mm."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.launch import hlo_analysis
    a, b = jnp.zeros((8, 16), jnp.float32), jnp.zeros((16, 32), jnp.float32)
    text = jax.jit(lambda p, q: p @ q).lower(a, b).compile().as_text()
    ref = hlo_analysis.analyze(text)
    p, q = _meta(8, 16), _meta(16, 32)
    got = comm_analysis.analyze(lambda: p @ q)[1]
    assert got["bytes"] == ref["bytes"] == (8 * 16 + 16 * 32 + 8 * 32) * F32
    assert got["flops"] == ref["flops"]
