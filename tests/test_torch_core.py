"""The port's configs and DSG math (`repro_torch.configs`, `repro_torch.core`)
against the JAX package on the same numpy inputs, on the CPU.

Tolerances: f32 throughout; elementwise results agree to atol 1e-5,
selections ({0,1} masks, CSR rows, sizes) exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import drs as jdrs  # noqa: E402
from repro.core import dsg_linear as jdl  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import projection as jproj  # noqa: E402
from repro.core import sparse_mask as jsm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import drs, dsg_linear, masks, projection  # noqa: E402
from repro_torch.core import sparse_mask  # noqa: E402

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("getter", ["get_config", "get_smoke_config"])
def test_internlm2_configs_match_field_for_field(getter):
    ref = getattr(jconfigs, getter)("internlm2-1.8b")
    port = getattr(tconfigs, getter)("internlm2-1.8b")
    ref_fields = [f.name for f in dataclasses.fields(ref)]
    assert ref_fields == [f.name for f in dataclasses.fields(port)]
    for name in ref_fields:
        if name == "dsg":
            assert port.dsg._fields == ref.dsg._fields
            assert tuple(port.dsg) == tuple(ref.dsg)
        else:
            assert getattr(port, name) == getattr(ref, name), name
    assert port.head_dim == ref.head_dim
    assert bridge.config_from_jax(ref) == port


def test_unported_arch_is_refused_with_a_pointer():
    assert "llama3.2-3b" in jconfigs.ARCHS
    with pytest.raises(KeyError, match="ROADMAP"):
        tconfigs.get_config("llama3.2-3b")


@pytest.mark.parametrize("d,n,eps", [(2048, 8193, 0.5), (64, 257, 0.5),
                                     (512, 100, 0.3), (4096, 50000, 0.1),
                                     (128, 2, 1.0), (300, 1000, 0.2)])
def test_jll_dim(d, n, eps):
    assert projection.jll_dim(d, n, eps) == jproj.jll_dim(d, n, eps)


@pytest.mark.parametrize("getter,k", [("get_config", 256),
                                      ("get_smoke_config", 64)])
def test_proj_dim_keeps_the_lane_round_up(getter, k):
    cfg = getattr(tconfigs, getter)("internlm2-1.8b")
    ref = getattr(jconfigs, getter)("internlm2-1.8b")
    assert dsg_linear.proj_dim(cfg.d_model, cfg.d_ff, cfg.dsg) == k
    assert jdl.proj_dim(ref.d_model, ref.d_ff, ref.dsg) == k


def test_make_projection_is_scaled_ternary():
    gen = torch.Generator().manual_seed(0)
    r = projection.make_projection(64, 512, generator=gen)
    vals = torch.unique(r)
    step = float(np.sqrt(3.0) / np.sqrt(64))
    assert torch.allclose(vals, torch.tensor([-step, 0.0, step]))
    assert abs(float((r != 0).float().mean()) - 1 / 3) < 0.02
    x = torch.randn(4, 512, generator=gen)
    np.testing.assert_allclose(projection.project_rows(r, x).numpy(),
                               np.asarray(jproj.project_rows(
                                   jnp.asarray(r.numpy()),
                                   jnp.asarray(x.numpy()))), atol=ATOL)


@pytest.mark.parametrize("gamma,n_out,block", [(0.5, 8192, 128),
                                               (0.5, 256, 64), (0.3, 640, 64),
                                               (0.99, 256, 32), (0.0, 256, 64)])
def test_keep_groups(gamma, n_out, block):
    assert (drs.keep_groups(n_out, drs.DRSConfig(gamma, block))
            == jdrs.keep_groups(n_out, jdrs.DRSConfig(gamma, block)))


def test_group_scores_relu_sum():
    v = np.random.default_rng(0).standard_normal((3, 5, 256), np.float32)
    got = drs.group_scores(_t(v), drs.DRSConfig(block=64))
    want = jdrs.group_scores(jnp.asarray(v), jdrs.DRSConfig(block=64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _tied_scores():
    """Random scores plus rows whose threshold falls on a tie."""
    s = np.random.default_rng(1).standard_normal((6, 8)).astype(np.float32)
    s[1] = [1, 2, 2, 0, 2, -1, 0, 0]        # k-th largest is a 3-way tie
    s[2] = 3.0                               # every group tied
    s[0] = [5, 5, 5, 5, 1, 1, 1, 1]          # row 0 (the shared row) tied
    return s.reshape(2, 3, 8)


@pytest.mark.parametrize("mode", ["topk", "shared"])
@pytest.mark.parametrize("gamma", [0.5, 0.75, 0.0])
def test_select_mask_with_ties(mode, gamma):
    s = _tied_scores()
    got = drs.select_mask(_t(s), 8 * 16, drs.DRSConfig(gamma, 16, mode))
    want, _ = jdrs.select_mask(jnp.asarray(s), 8 * 16,
                               jdrs.DRSConfig(gamma, 16, mode))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_mask_shared_takes_row_zero_threshold():
    s = _tied_scores()
    got = drs.select_mask(_t(s), 128, drs.DRSConfig(0.5, 16, "shared"))
    # row 0's 4th largest is 5: only entries >= 5 survive anywhere
    np.testing.assert_array_equal(got.numpy(), (s >= 5).astype(np.float32))


def test_drs_mask_end_to_end():
    rng = np.random.default_rng(2)
    fx = rng.standard_normal((2, 7, 64), np.float32)
    fw = rng.standard_normal((64, 256), np.float32)
    for mode in ("topk", "shared"):
        got = drs.drs_mask(_t(fx), _t(fw), drs.DRSConfig(0.5, 64, mode))
        want, _ = jdrs.drs_mask(jnp.asarray(fx), jnp.asarray(fw),
                                jdrs.DRSConfig(0.5, 64, mode))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_expanded_and_freeze():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 256), np.float32)
    m = (rng.random((2, 3, 4)) < 0.5).astype(np.float32)
    got = masks.apply_expanded(_t(x), masks.freeze(_t(m)), 64)
    want = jmasks.apply_expanded(jnp.asarray(x), jnp.asarray(m), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_csr_to_dense_ignores_padding():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 8, (3, 5, 4)).astype(np.int32)
    counts = rng.integers(0, 5, (3, 5)).astype(np.int32)
    idx[0, 0] = [3, 7, 7, 7]                 # count 2: trailing 7s ignored
    counts[0, 0] = 2
    got = sparse_mask.csr_to_dense(_t(idx), _t(counts), 8)
    want = jsm.csr_to_dense(jnp.asarray(idx), jnp.asarray(counts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_active_group_bound_and_buckets():
    for g in (1, 3, 4, 8, 64):
        assert (sparse_mask.active_group_buckets(g)
                == jsm.active_group_buckets(g))
        for c in range(0, g + 2):
            assert (sparse_mask.active_group_bound(c, g)
                    == jsm.active_group_bound(c, g))
