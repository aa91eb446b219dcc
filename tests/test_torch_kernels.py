"""Each kernel's plain PyTorch version against its Pallas kernel (interpret
mode), over the sweeps of the JAX kernel tests, on the CPU; and the rule
that a kernel request on a machine without CUDA raises instead of
computing on the CPU.

Tolerances (f32): outputs agree to atol 1e-5 (scores and projections, whose
values reach the hundreds, also to rtol 1e-5); the K/V pools written by the
paged step agree exactly.
"""
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import dsg_linear as jdl  # noqa: E402
from repro.kernels import drs_search as jds  # noqa: E402
from repro.kernels import dsg_ffn as jdf  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import dsg_linear as dl  # noqa: E402
from repro_torch.kernels import (cuda_lib, drs_search, dsg_ffn, ops,  # noqa: E402
                                 paged_attention)
from repro_torch.models import api, attention  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _both(*arrays):
    """numpy arrays -> (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _paged_setup(seed, b, h, kv, d, ps, max_pages, pos):
    """Random pools + a page table mapping each lane's live pages to
    distinct physical pages (page 0 is scratch), as numpy."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * max_pages
    mk = lambda shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    table = np.zeros((b, max_pages), np.int32)
    nxt = 1
    for lane in range(b):
        for j in range(pos[lane] // ps + 1):
            table[lane, j] = nxt
            nxt += 1
    return (mk((b, h, d)), mk((b, kv, d)), mk((b, kv, d)),
            mk((n_pages, ps, kv, d)), mk((n_pages, ps, kv, d)), table,
            np.asarray(pos, np.int32))


def _check_paged(args, **kw):
    j, t = _both(*args)
    ow, kw_, vw = jpa.paged_decode(*j, interpret=True, **kw)
    o, kp, vp = ops.paged_decode_attention(*t, **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(ow), **TOL)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kw_))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vw))
    return o


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("h,kv", [(4, 2), (2, 2)])
def test_paged_decode_plain_matches_pallas(ps, h, kv):
    pos = [0, ps - 1, ps, 2 * ps + 3, 5 * ps - 1]
    _check_paged(_paged_setup(0, len(pos), h, kv, 16, ps, 6, pos))


@pytest.mark.parametrize("kw", [dict(num_pages=6), dict(window=10),
                                dict(window=10, num_pages=6)])
def test_paged_decode_plain_bounded_walk_and_window(kw):
    args = _paged_setup(1, 3, 4, 2, 16, 8, 8, [5, 17, 40])
    o = _check_paged(args, **kw)
    if "window" not in kw:   # the bounded walk covers every lane
        full, _, _ = ops.paged_decode_attention(*_both(*args)[1])
        np.testing.assert_array_equal(o.numpy(), full.numpy())


def test_paged_decode_plain_undersized_walk_never_corrupts_pools():
    args = _paged_setup(7, 3, 4, 2, 16, 8, 8, [5, 17, 40])
    q, k_new, v_new, k_pages, v_pages, table, pos = args
    _, t = _both(*args)
    _, kp, vp = ops.paged_decode_attention(*t, num_pages=2)
    want_k, want_v = k_pages.copy(), v_pages.copy()
    want_k[table[0, 0], 5] = k_new[0]
    want_v[table[0, 0], 5] = v_new[0]
    np.testing.assert_array_equal(kp.numpy(), want_k)
    np.testing.assert_array_equal(vp.numpy(), want_v)
    _check_paged(args, num_pages=2)


@pytest.mark.parametrize("live_pages", [None, 4])
def test_self_attention_paged_gather_matches_pallas_executor(live_pages):
    """The port's paged branch on CPU tensors (the kernel's plain bounded
    gather) against the reference's Pallas executor on the same inputs,
    RoPE included."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(3)
    ps, pos = 8, np.asarray([3, 12, 25], np.int32)
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in (("wq", (32, 4, 8)), ("wk", (32, 2, 8)),
                      ("wv", (32, 2, 8)), ("wo", (4, 8, 32)))}
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    _, _, _, kpool, vpool, table, _ = _paged_setup(4, 3, 4, 2, 8, ps, 8,
                                                   list(pos))
    kw = dict(n_heads=4, n_kv=2, rope_theta=10_000.0, live_pages=live_pages)
    out_j, cache_j = jattn.self_attention(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        q_pos=jnp.asarray(pos)[:, None], cache_pos=jnp.asarray(pos),
        cache={"k": jnp.asarray(kpool), "v": jnp.asarray(vpool)},
        page_table=jnp.asarray(table), paged_kernel="kernel", **kw)
    cache_t = {"k": torch.from_numpy(kpool.copy()),
               "v": torch.from_numpy(vpool.copy())}
    tp = torch.from_numpy(pos)
    out_t, _ = attention.self_attention(
        attention.Attention(*(torch.from_numpy(p[k])
                              for k in ("wq", "wk", "wv", "wo"))),
        torch.from_numpy(x), q_pos=tp[:, None], cache_pos=tp,
        cache=cache_t, page_table=torch.from_numpy(table),
        paged_kernel="auto", **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache_t[leaf].numpy(),
                                   np.asarray(cache_j[leaf]), **TOL)


@pytest.mark.parametrize("m,d,k", [(64, 128, 64), (256, 320, 128),
                                   (128, 512, 256), (5, 64, 64)])
def test_drs_project_plain_matches_pallas(m, d, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((m, d)).astype(np.float32)
    r = (rng.standard_normal((k, d)) / np.sqrt(k)).astype(np.float32)
    j, t = _both(x, r)
    want = jds.drs_project(*j, bm=min(32, m) if m % 32 == 0 else m,
                           interpret=True)
    np.testing.assert_allclose(ops.drs_project(*t).numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("m,k,f,block,bm,bf", [
    (64, 64, 256, 32, 32, 64), (128, 128, 512, 64, 64, 128),
    (32, 64, 1024, 128, 32, 256)])
def test_drs_scores_plain_matches_pallas(m, k, f, block, bm, bf):
    rng = np.random.default_rng(1)
    j, t = _both(rng.standard_normal((m, k)).astype(np.float32),
                 rng.standard_normal((k, f)).astype(np.float32))
    want = jds.drs_scores(*j, block=block, bm=bm, bf=bf, interpret=True)
    got = ops.drs_scores(*t, block=block)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _ffn_weights(seed, d, f, b):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("case", ["serving_units", "full_density",
                                  "random_padded"])
def test_dsg_ffn_csr_plain_matches_pallas(case):
    if case == "serving_units":        # tests/test_dsg_serving.py:99
        block, d, f = 16, 16, 64
        idx = np.asarray([[0, 2], [1, 3], [3, 0]], np.int32)
        counts = np.asarray([2, 2, 1], np.int32)
    elif case == "full_density":       # tests/test_dsg_serving.py:111
        block, d, f = 16, 16, 64
        idx = np.tile(np.arange(4, dtype=np.int32), (3, 1))
        counts = np.full(3, 4, np.int32)
    else:
        block, d, f = 64, 64, 512
        rng = np.random.default_rng(9)
        counts = np.asarray([4, 1, 3, 2], np.int32)
        idx = rng.integers(0, 8, (4, 4)).astype(np.int32)  # padding garbage
        for lane, c in enumerate(counts):
            idx[lane, :c] = np.sort(rng.choice(8, c, replace=False))
    wg, wu, wd, x = _ffn_weights(0, d, f, len(counts))
    j, t = _both(x, wg, wu, wd, idx, counts)
    want = jdf.dsg_ffn_csr(*j, block=block, interpret=True)
    got = ops.dsg_ffn_csr(*t, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("idx,counts,groups", [
    ([[1, 3, -1, 9], [0, 2, 3, 99]], [2, 3], 4),
    ([[1, 3, 64, -1]], [2], 8)])
def test_dsg_ffn_csr_plain_ignores_out_of_range_padding(idx, counts, groups):
    """Slots past a lane's count may hold any value (ROADMAP.md §3's
    padding fault, now fixed): the plain version gives the Pallas
    kernel's result, where it used to raise IndexError."""
    block, d = 16, 16
    idx, counts = np.asarray(idx, np.int32), np.asarray(counts, np.int32)
    wg, wu, wd, x = _ffn_weights(5, d, groups * block, len(counts))
    j, t = _both(x, wg, wu, wd, idx, counts)
    want = jdf.dsg_ffn_csr(*j, block=block, interpret=True)
    got = ops.dsg_ffn_csr(*t, block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_swiglu_csr_executors_agree_with_reference():
    wg, wu, wd, x = _ffn_weights(1, 16, 64, 3)
    idx = np.asarray([[0, 2], [1, 3], [3, 0]], np.int32)
    counts = np.asarray([2, 2, 1], np.int32)
    j, t = _both(x[:, None], idx, counts)
    ref = jdl.swiglu_csr_masked({"w_gate": jnp.asarray(wg),
                                 "w_up": jnp.asarray(wu),
                                 "w_down": jnp.asarray(wd)},
                                *j, block=16)
    p = dl.SwiGLU(*(torch.from_numpy(w) for w in (wg, wu, wd)))
    for name, got in (("masked", dl.swiglu_csr_masked(p, *t, block=16)),
                      ("auto", dl.swiglu_csr(p, *t, block=16))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                   err_msg=name)
    with pytest.raises(RuntimeError, match="CUDA"):
        dl.swiglu_csr(p, *t, block=16, apply="kernel")
    with pytest.raises(ValueError, match="decode step"):
        dl.swiglu_csr(p, torch.zeros(3, 4, 16), *t[1:], block=16)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launchers never compute on the CPU: a CPU tensor raises before
    any library is loaded."""
    x = torch.zeros(4, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        drs_search.drs_project(x, torch.zeros(64, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        drs_search.drs_scores(x, torch.zeros(64, 128), block=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        dsg_ffn.dsg_ffn_csr(x, torch.zeros(64, 128), torch.zeros(64, 128),
                            torch.zeros(128, 64),
                            torch.zeros(4, 1, dtype=torch.int32),
                            torch.ones(4, dtype=torch.int32), block=64)
    args = [torch.from_numpy(a) for a in
            _paged_setup(0, 2, 4, 2, 16, 8, 4, [3, 9])]
    with pytest.raises(RuntimeError, match="CUDA"):
        paged_attention.paged_decode(*args)
    with pytest.raises(RuntimeError, match="CUDA"):
        attention._check_paged_kernel("kernel", torch.device("cpu"))
    with pytest.raises(ValueError, match="unknown paged_attn_kernel"):
        attention._check_paged_kernel("mosaic", torch.device("cpu"))


@pytest.mark.parametrize("mode", ["xla", "dense", "gather"])
def test_plain_executor_modes_are_refused(mode):
    """No mode runs a plain version by name: the reference's "xla"/"dense"
    executors raise on the mode alone, so a CUDA tensor can never reach a
    plain path through them."""
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="unknown paged_attn_kernel"):
            attention._check_paged_kernel(mode, torch.device(device))
    wg, wu, wd, x = _ffn_weights(2, 16, 64, 2)
    p = dl.SwiGLU(*(torch.from_numpy(w) for w in (wg, wu, wd)))
    with pytest.raises(ValueError, match="unknown CSR FFN apply"):
        dl.swiglu_csr(p, torch.from_numpy(x[:, None]),
                      torch.zeros(2, 1, dtype=torch.int32),
                      torch.ones(2, dtype=torch.int32), block=16, apply=mode)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = configs.get_smoke_config("internlm2-1.8b")
    with pytest.raises((RuntimeError, AssertionError)):
        api.init_model(cfg, generator=torch.Generator(), device="cuda")
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lib.build()
