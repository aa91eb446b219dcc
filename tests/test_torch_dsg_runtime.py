"""The port's DSG serving runtime (`repro_torch.serving.dsg_runtime`)
against the reference's, on the CPU at smoke width (f32), on bridged
parameters.

Mirrors the runtime tests of tests/test_dsg_serving.py: top-k seeding and
reset, the per-lane "ema" threshold (seeded at admission, blended at each
refresh), the device-push cache, warm bounds by mode, validation, the FLOP
model (`record_step`/`flop_stats`, equal to the reference's exactly on the
same traffic, eager and chunked), `double_mask_csr`, streams invariant to
the replica count, and the sharded executor refusing DSG-serving engines.
Fed the same scores, the two runtimes write the same patterns and the same
EMA bits; fed the model's own scores (summed in another order), the EMA
arrays agree within rtol 1e-5 / atol 1e-6 and the lane patterns equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from harness import (CHUNK_AXIS, assert_streams_equal,  # noqa: E402
                     engine_spec, mixed_traffic, run_and_collect)
from repro.core import double_mask as jdm  # noqa: E402
from repro.core import sparse_mask as jsm  # noqa: E402
from repro.serving import dsg_runtime as jrt  # noqa: E402
from repro_torch.core import sparse_mask  # noqa: E402
from repro_torch.serving import dsg_runtime  # noqa: E402
from repro_torch.serving.dsg_runtime import (DSGRuntime,  # noqa: E402
                                             DSGServingConfig)
from repro_torch.serving.router import Router  # noqa: E402
from torch_port_harness import (bridged_parts, port_request,  # noqa: E402
                                port_run)

_DSG = DSGServingConfig(refresh_interval=4)
_JDSG = jrt.DSGServingConfig(refresh_interval=4)


@pytest.fixture(scope="module")
def parts():
    return bridged_parts()


def _pair(parts, n_slots=2, **scfg):
    """A reference runtime and the port's on the same config."""
    return (jrt.DSGRuntime(parts[0][0], jrt.DSGServingConfig(**scfg),
                           n_slots=n_slots),
            DSGRuntime(parts[1][0], DSGServingConfig(**scfg), n_slots,
                       torch.device("cpu")))


def _same_state(j, p):
    assert np.array_equal(p.idx, j.idx)
    assert np.array_equal(p.counts, j.counts)
    assert np.array_equal(p.lane_active, j.lane_active)
    assert p.bound() == j.bound()


# -- runtime state --------------------------------------------------------------

def test_runtime_topk_seeding_and_reset(parts):
    cfg = parts[1][0]
    j, rt = _pair(parts, n_slots=3)
    assert rt.n_groups == 4 and rt.keep == 2
    assert rt.bound() == 1                   # every lane parked
    scores = np.random.default_rng(0).standard_normal(
        (cfg.n_layers, rt.n_groups)).astype(np.float32)
    for r in (j, rt):
        r.set_lane_from_scores(1, scores)
    assert (rt.counts[:, 1] == rt.keep).all()
    for l in range(cfg.n_layers):
        want = np.sort(np.argsort(scores[l])[-rt.keep:])
        assert np.array_equal(rt.idx[l, 1, :rt.keep], want)
    _same_state(j, rt)
    for r in (j, rt):
        r.reset_lane(1)
    assert rt.bound() == 1 and not rt.lane_active.any()
    assert (rt.counts == 1).all() and (rt.ema == 0).all()
    _same_state(j, rt)


@pytest.mark.parametrize("decay", [0.9, 0.5])
def test_runtime_ema_matches_reference(parts, decay):
    """Seeded at admission from the lane's top-k threshold and blended at
    each refresh: on the same scores the port's patterns and EMA bits are
    the reference's, a lane never admitted is not touched, and a threshold
    above every score keeps the lane's top group."""
    cfg = parts[1][0]
    j, rt = _pair(parts, threshold="ema", ema_decay=decay)
    rng = np.random.default_rng(1)
    seed = rng.standard_normal((cfg.n_layers, 4)).astype(np.float32)
    for r in (j, rt):
        r.set_lane_from_scores(0, seed)
    assert np.array_equal(rt.ema, j.ema)
    for _ in range(5):
        step = rng.standard_normal((cfg.n_layers, 2, 4)).astype(np.float32)
        for r in (j, rt):
            r.update_from_scores(step, lanes=[0, 1])
        _same_state(j, rt)
        assert np.array_equal(rt.ema, j.ema)
    assert (rt.counts[:, 1] == 1).all() and not rt.lane_active[1]
    low = np.full((cfg.n_layers, 2, 4), -50.0, np.float32)
    low[:, 0, 2] = -40.0
    for r in (j, rt):
        r.update_from_scores(low, lanes=[0])
    _same_state(j, rt)
    assert (rt.counts[:, 0] == 1).all() and (rt.idx[:, 0, 0] == 2).all()


def test_runtime_device_csr_cache_invalidation(parts):
    cfg = parts[1][0]
    _, rt = _pair(parts)
    first = rt.device_csr(2)
    assert rt.device_csr(2) is first               # cached per version
    rt.set_lane_from_scores(0, np.ones((cfg.n_layers, 4), np.float32))
    assert rt.device_csr(2) is not first           # a write invalidates
    sliced = rt.device_csr(1)
    assert tuple(sliced["idx"].shape) == (cfg.n_layers, 2, 1)
    assert int(sliced["counts"].max()) <= 1


def test_runtime_warm_bounds_by_threshold_mode(parts):
    topk, ptopk = _pair(parts)
    ema, pema = _pair(parts, threshold="ema")
    assert ptopk.warm_bounds() == topk.warm_bounds() == (2,)
    assert pema.warm_bounds() == ema.warm_bounds() == (1, 2, 4)


def test_runtime_validation_raises(parts):
    cfg = parts[1][0]
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="'topk' or 'ema'"):
        DSGRuntime(cfg, DSGServingConfig(threshold="shared"), 2, cpu)
    with pytest.raises(ValueError, match="refresh_interval"):
        DSGRuntime(cfg, DSGServingConfig(refresh_interval=0), 2, cpu)
    off = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    with pytest.raises(ValueError, match="enabled"):
        DSGRuntime(off, DSGServingConfig(), 2, cpu)
    assert DSGServingConfig()._asdict() == jrt.DSGServingConfig()._asdict()


def test_flop_stats_accounting(parts):
    cfg = parts[1][0]
    j, rt = _pair(parts)
    with pytest.raises(ValueError, match="no decode steps"):
        rt.flop_stats()
    scores = np.random.default_rng(2).standard_normal(
        (cfg.n_layers, 4)).astype(np.float32)
    for r in (j, rt):
        r.set_lane_from_scores(0, scores)
        r.record_step(active=[0], bound=r.bound())
    st = rt.flop_stats()
    assert st["dense_units"] == cfg.n_layers * 4
    assert st["csr_units"] == cfg.n_layers * rt.keep
    assert st["flop_reduction_csr"] == pytest.approx(4 / rt.keep)
    assert st == j.flop_stats()


def test_double_mask_csr_matches_reference():
    rng = np.random.default_rng(3)
    block, g = 8, 4
    x = rng.standard_normal((3, g * block)).astype(np.float32)
    mask = (rng.random((3, g)) < 0.6).astype(np.float32)
    idx, counts = jsm.dense_to_csr(jnp.asarray(mask), g)

    def jnorm(z):
        return z / (1.0 + jnp.mean(jnp.abs(z), axis=-1, keepdims=True))

    def norm(z):
        return z / (1.0 + torch.mean(torch.abs(z), dim=-1, keepdim=True))

    want = jrt.double_mask_csr(jnorm, jnp.asarray(x), idx, counts,
                               block=block, n_groups=g)
    assert np.allclose(np.asarray(want), np.asarray(jdm.double_mask(
        jnorm, jnp.asarray(x), jnp.asarray(mask), block)), atol=1e-6)
    got = dsg_runtime.double_mask_csr(
        norm, torch.from_numpy(x), torch.from_numpy(np.array(idx)),
        torch.from_numpy(np.array(counts)), block=block, n_groups=g)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the zeros the pattern made stay zeros after the norm
    dead = np.repeat(mask == 0, block, axis=-1)
    assert (got.numpy()[dead] == 0).all()
    assert sparse_mask.csr_overhead_bytes((2, 3), g) == \
        jsm.csr_overhead_bytes((2, 3), g)


# -- the engine: FLOP model and EMA on the same traffic ----------------------------

@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_flop_stats_equal_reference_on_traffic(parts, chunk):
    """The measured window's FLOP model, one entry a micro-step with a live
    lane, equals the reference's exactly (integer counts), eagerly and
    with fused chunks; gamma 0.5 top-k gives exactly 2x."""
    every = max(4, chunk)              # the chunk divides the interval
    want, jeng = run_and_collect(
        engine_spec(*parts[0], decode_chunk=chunk,
                    dsg_serving=jrt.DSGServingConfig(refresh_interval=every)),
        mixed_traffic(parts[0][0]), return_engine=True)
    got, eng = port_run(
        engine_spec(*parts[1], decode_chunk=chunk,
                    dsg_serving=DSGServingConfig(refresh_interval=every)),
        mixed_traffic(parts[0][0]), return_engine=True)
    assert_streams_equal(want, got, f"DSG serving chunk={chunk}")
    st = eng.dsg_rt.flop_stats()
    assert st == jeng.dsg_rt.flop_stats()
    assert eng.dsg_rt.step_log == jeng.dsg_rt.step_log
    assert st["flop_reduction_csr"] == pytest.approx(2.0)
    assert st["steps"] == eng.steps


@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_ema_engine_matches_reference(parts, chunk):
    """threshold="ema" through the engine: the streams and every lane
    pattern equal the reference's, the EMA thresholds agree within rtol
    1e-5 / atol 1e-6 (the scores are f32 sums in another order), counts
    stay in [1, G], and the FLOP model equals the reference's."""
    every = max(4, chunk)              # the chunk divides the interval
    jspec = engine_spec(*parts[0], dsg_serving=jrt.DSGServingConfig(
        refresh_interval=every, threshold="ema"), decode_chunk=chunk)
    want, jeng = run_and_collect(jspec, mixed_traffic(parts[0][0]),
                                 return_engine=True)
    snaps = []
    spec = engine_spec(*parts[1], dsg_serving=DSGServingConfig(
        refresh_interval=every, threshold="ema"), decode_chunk=chunk)
    got, eng = port_run(spec, mixed_traffic(parts[0][0]),
                        return_engine=True)
    assert_streams_equal(want, got, f"ema chunk={chunk}")
    rt, jr = eng.dsg_rt, jeng.dsg_rt
    assert rt.counts.min() >= 1 and rt.counts.max() <= rt.n_groups
    assert rt.flop_stats() == jr.flop_stats()
    # retirement resets a lane's state: drive one lane to a refresh and
    # compare the live state there
    for e, reqs in ((jeng, mixed_traffic(parts[0][0], n=1, seed=5)),
                    (eng, mixed_traffic(parts[0][0], n=1, seed=5))):
        r = reqs[0]
        r.max_new = 40
        e.submit(port_request(r) if e is eng else r)
        for _ in range(2 * every // chunk + 1):
            e.step()
        snaps.append((e.dsg_rt.idx.copy(), e.dsg_rt.counts.copy(),
                      e.dsg_rt.ema.copy()))
    (jidx, jcnt, jema), (idx, cnt, ema) = snaps
    assert np.array_equal(idx, jidx) and np.array_equal(cnt, jcnt)
    assert ema.any()
    np.testing.assert_allclose(ema, jema, rtol=1e-5, atol=1e-6)


def test_streams_invariant_to_replica_count(parts):
    """A lane refreshes on its own token count, so DSG-serving streams are
    the reference's bare engine's for 1 and 2 replicas."""
    want = run_and_collect(engine_spec(*parts[0], dsg_serving=_JDSG),
                           mixed_traffic(parts[0][0]))
    for n in (1, 2):
        got = port_run(engine_spec(*parts[1], dsg_serving=_DSG,
                                   n_replicas=n),
                       mixed_traffic(parts[0][0]))
        assert_streams_equal(want, got, f"replicas={n}")


def test_sharded_executor_rejects_dsg(parts):
    cfg, model, dsg = parts[1]
    with pytest.raises(NotImplementedError, match="DSG-serving"):
        Router(cfg, model, dsg, n_replicas=2, exec_mode="sharded",
               n_slots=2, max_seq=64, prompt_bucket=32, dsg_serving=_DSG)
