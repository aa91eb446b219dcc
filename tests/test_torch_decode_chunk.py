"""The port's fused decode chunk and dense KV backend against the reference,
on the CPU at smoke width (f32), mirroring tests/test_decode_chunk.py.

At temperature 0 the port's per-request greedy streams must equal the
reference's chunk-1 streams token for token, for {dense, paged} x
decode_chunk {1, 2, 8} x DSG serving {on (refresh every 8 tokens), off},
over `harness.mixed_traffic` (6 requests through 2 slots, so lanes retire
and are re-admitted at chunk boundaries), with EOS landing mid-chunk too.
On the CPU the chunk is the eager micro-step loop; the card replays it as
a CUDA graph (tests/test_torch_cuda.py).  The accounting is held exactly:
micro-steps, tokens, refreshes and the paged pool's free pages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import (assert_streams_equal, engine_spec,  # noqa: E402
                     make_engine_parts, mixed_traffic, run_and_collect)
from repro.models import attention as jattn  # noqa: E402
from repro.serving.dsg_runtime import DSGServingConfig as JDSGServing  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.serving import kv_cache, scheduler, workload  # noqa: E402
from repro_torch.serving.dsg_runtime import DSGServingConfig  # noqa: E402

CHUNKS = (1, 2, 8)
ENGINE = dict(n_slots=2, max_seq=64, prompt_bucket=32)
PAGED = dict(cache_backend="paged", page_size=8, cache_tokens=160)
REFRESH = 8


@pytest.fixture(scope="module")
def parts():
    """(reference cfg, params, dsg) and the port's (cfg, model, dsg) on the
    same parameters."""
    cfg, params, dsg = make_engine_parts()
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, dsg), device="cpu")
    return (cfg, params, dsg), (tcfg, model, tdsg)


def _reference(parts, dsg_on, eos=None):
    cfg, params, dsg = parts[0]
    reqs = mixed_traffic(cfg)
    for r in reqs:
        r.eos_id = eos
    return run_and_collect(
        engine_spec(cfg, params, dsg,
                    dsg_serving=JDSGServing(REFRESH) if dsg_on else None),
        reqs)


@pytest.fixture(scope="module")
def ref_streams(parts):
    """The reference's chunk-1 dense streams, DSG serving on and off."""
    return {on: _reference(parts, on) for on in (True, False)}


def _port_engine(parts, **kw):
    cfg, model, dsg = parts[1]
    return scheduler.ServingEngine(cfg, model, dsg, **{**ENGINE, **kw})


def _port_run(parts, traffic, **kw):
    eng = _port_engine(parts, **kw)
    for r in traffic:
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new, eos_id=r.eos_id))
    done = eng.run(400)
    assert len(done) == len(traffic)
    assert all(r.status == "ok" for r in done.values())
    return {u: list(r.output) for u, r in done.items()}, eng


@pytest.mark.parametrize("dsg_on", [True, False], ids=["dsg", "no_dsg"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_streams_equal_reference_chunk1(parts, ref_streams, backend, chunk,
                                        dsg_on):
    kw = dict(PAGED) if backend == "paged" else {"cache_backend": "dense"}
    got, eng = _port_run(
        parts, mixed_traffic(parts[0][0]), decode_chunk=chunk,
        dsg_serving=DSGServingConfig(REFRESH) if dsg_on else None, **kw)
    assert_streams_equal(ref_streams[dsg_on], got,
                         f"{backend} chunk={chunk} dsg={dsg_on}")
    assert eng.admissions == 6 > ENGINE["n_slots"]     # retire and readmit
    if backend == "paged":                             # every page returned
        assert eng.backend.allocator.live_pages == 0
        assert int(eng.backend._resv.sum()) == 0


def test_eos_mid_chunk(parts, ref_streams):
    """A stop token taken from the middle of the longest reference stream
    cuts streams at micro-steps that are not chunk boundaries: the device
    done mask freezes the lane there and the lagged commit retires it."""
    base = ref_streams[False]
    uid = max(base, key=lambda u: len(base[u]))
    eos = base[uid][len(base[uid]) // 2]
    want = _reference(parts, False, eos=eos)
    assert any(s and s[-1] == eos and len(s) < len(base[u])
               for u, s in want.items()), "the chosen eos cut no stream"
    for chunk in (2, 8):
        for kw in ({"cache_backend": "dense"}, PAGED):
            traffic = mixed_traffic(parts[0][0])
            for r in traffic:
                r.eos_id = eos
            got, _ = _port_run(parts, traffic, decode_chunk=chunk, **kw)
            assert_streams_equal(want, got, f"eos chunk={chunk} {kw}")


@pytest.mark.parametrize("dsg_on", [True, False], ids=["dsg", "no_dsg"])
def test_chunked_counters_and_paged_pool(parts, dsg_on):
    """A solo request decodes the same micro-steps, tokens and refreshes
    at any chunk (no co-resident lanes, so occupancy is identical), and
    the paged pool returns to full: the pages a chunk maps ahead
    (ensure_range) stay inside the lane's reservation and all come back
    at retirement."""
    counts = {}
    for chunk in (1, 8):
        _, eng = _port_run(
            parts, [scheduler.Request(uid=0, prompt=np.arange(
                5, dtype=np.int32) + 3, max_new=20)],
            decode_chunk=chunk,
            dsg_serving=DSGServingConfig(REFRESH) if dsg_on else None,
            **PAGED)
        alloc = eng.backend.allocator
        counts[chunk] = (eng.steps, eng.decode_tokens, eng.refresh_steps,
                         alloc.free_pages, int(eng.backend._resv.sum()))
        assert alloc.free_pages == alloc.n_pages - alloc.reserved
    assert counts[1] == counts[8]
    assert counts[1][:3] == (20, 20, 2 if dsg_on else 0)
    assert counts[1][4] == 0           # no leaked reservations


def test_warm_decode_leaves_streams_and_pool(parts, ref_streams):
    """warm_decode runs every chunk variant with all lanes done: its writes
    land in the scratch page, so the pool stays full and the streams that
    follow are the reference's."""
    eng = _port_engine(parts, decode_chunk=8,
                       dsg_serving=DSGServingConfig(REFRESH), **PAGED)
    workload.warmup_engine(eng, parts[1][0].vocab)
    alloc = eng.backend.allocator
    assert alloc.free_pages == alloc.n_pages - alloc.reserved
    assert (eng.steps, eng.admissions, eng.refresh_steps) == (0, 0, 0)
    for r in mixed_traffic(parts[0][0]):
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new))
    got = {u: list(r.output) for u, r in eng.run(400).items()}
    assert_streams_equal(ref_streams[True], got, "after warm-up")


def test_dsg_chunk_must_divide_refresh_interval(parts):
    with pytest.raises(ValueError, match="refresh_interval"):
        _port_engine(parts, decode_chunk=3,
                     dsg_serving=DSGServingConfig(REFRESH))


@pytest.mark.parametrize("chunk", [0, -1])
def test_decode_chunk_validation(parts, chunk):
    with pytest.raises(ValueError, match="decode_chunk"):
        _port_engine(parts, decode_chunk=chunk)


def test_per_lane_dense_decode_matches_reference(parts):
    """self_attention on a dense cache with per-lane (B,) depths: each
    lane writes at its own position and attends causally over the stripe,
    as the reference's `ndim(cache_pos) == 1` branch does (f32, atol
    1e-5: the same products summed in another order)."""
    cfg, params, _ = parts[0]
    rng = np.random.default_rng(7)
    b, smax = 3, 16
    kv, d = cfg.n_kv, cfg.head_dim
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    cv = rng.standard_normal((b, smax, kv, d)).astype(np.float32)
    pos = np.asarray([0, 9, 15], np.int32)
    p = jax.tree.map(lambda a: np.asarray(a)[0], params["layers"]["attn"])
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, rope_theta=cfg.rope_theta)
    want, wcache = jattn.self_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x),
        q_pos=jnp.asarray(pos)[:, None], cache={"k": jnp.asarray(ck),
                                                "v": jnp.asarray(cv)},
        cache_pos=jnp.asarray(pos), **kw)
    tp = attention.Attention(*(torch.from_numpy(p[n].copy())
                               for n in ("wq", "wk", "wv", "wo")))
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, _ = attention.self_attention(
        tp, torch.from_numpy(x), q_pos=torch.from_numpy(pos)[:, None].long(),
        cache=cache, cache_pos=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(wcache[n]),
                                   rtol=0, atol=1e-5)


def test_dense_backend_merges_full_stripe_in_place(parts):
    """Admission copies the whole Smax stripe of the 1-lane cache into the
    persistent tensors (stale K/V of a retired request are wiped), and
    every handle keeps the tensors `make` allocated."""
    cfg = parts[1][0]
    be = kv_cache.get_backend("dense")
    h = be.make(cfg, 2, 16, "cpu")
    ptrs = {n: t.data_ptr() for n, t in h.data.items()}
    h.data["k"].fill_(7.0)
    lane = {n: torch.zeros((cfg.n_layers, 1, 16, cfg.n_kv, cfg.head_dim))
            for n in ("k", "v")}
    lane["k"][:, :, :3] = 1.0
    h = be.write(h, lane, 1, n_tokens=3)
    assert {n: t.data_ptr() for n, t in h.data.items()} == ptrs
    assert float(h.data["k"][:, 1, :3].min()) == 1.0
    assert float(h.data["k"][:, 1, 3:].abs().max()) == 0.0
    assert float(h.data["k"][:, 0].min()) == 7.0     # other lane untouched
    assert be.can_admit(10 ** 6) and be.ensure_range(h, 0, 0, 16) is h
    with pytest.raises(ValueError, match="unknown cache backend"):
        kv_cache.get_backend("ring")


def test_paged_table_is_persistent_and_ranges_map_once(parts):
    """The device page table is allocated once and updated in place, so a
    captured graph keeps reading it; ensure_range maps every page of the
    range, and none twice."""
    cfg = parts[1][0]
    be = kv_cache.get_backend("paged", page_size=4, total_tokens=64)
    h = be.make(cfg, 2, 32, "cpu")
    table = h.data["page_table"]
    h = be.write(h, {n: torch.zeros((cfg.n_layers, 1, 32, cfg.n_kv,
                                     cfg.head_dim)) for n in ("k", "v")},
                 0, n_tokens=6, reserve_tokens=20)
    h = be.ensure_range(h, 0, 6, 17)           # pages 1 (mapped) .. 4
    assert h.data["page_table"] is table
    row = table[0].tolist()
    assert all(p != kv_cache.NULL_PAGE for p in row[:5])
    assert len(set(row[:5])) == 5 and row[5:] == [kv_cache.NULL_PAGE] * 3
    assert int(be._resv[0]) == 0
    h = be.free(h, 0)
    assert table[0].tolist() == [kv_cache.NULL_PAGE] * 8


@pytest.mark.parametrize("prompt_len", [12, 29])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_lane_reaching_max_seq_mid_chunk(parts, backend, prompt_len):
    """A lone request in lane 0 whose bucket + max_new exceeds max_seq
    stops at max_seq (60: 44 or 28 micro-steps from bucket 16 or 32, so
    off a chunk boundary).  The chunk then runs on with every lane done,
    each fed the donor's position max_seq: the dense write there lands on
    the stripe's last row, as the reference's dynamic_update_slice clamps
    it, the paged write lies outside every walk (4-token pages, so the
    position's page is past the table), and the stream is the
    reference's."""
    cfg, params, dsg = parts[0]
    prompt = np.arange(prompt_len, dtype=np.int32) % cfg.vocab + 1
    from repro.serving.scheduler import Request as JRequest
    want = run_and_collect(engine_spec(cfg, params, dsg, max_seq=60),
                           [JRequest(uid=0, prompt=prompt, max_new=64)])
    kw = ({**PAGED, "page_size": 4} if backend == "paged"
          else {"cache_backend": "dense"})
    got, eng = _port_run(parts, [scheduler.Request(uid=0, prompt=prompt,
                                                   max_new=64)],
                         decode_chunk=8, max_seq=60, **kw)
    assert_streams_equal(want, got, f"{backend} prompt={prompt_len}")
    assert len(got[0]) == eng.steps == 60 - (16 if prompt_len <= 16 else 32)
    assert eng.steps % 8                       # stopped mid-chunk
