"""The port's copy-on-write prefix sharing and paged-cache bookkeeping
(`repro_torch.serving.kv_cache`) against the reference's, on the CPU at
smoke width (f32).

Mirrors tests/test_prefix_sharing.py (the router and chaos cases wait for
the router's port; `test_sharing_streams_bitwise_equal` runs with one
engine), the allocator properties of tests/test_serving_properties.py and
tests/test_kv_cache.py.  Greedy streams with sharing on must equal the
reference's and the port's with sharing off, and on the same traffic the
page counters (hits, copies, prefill replays, peak and live pages, the
index) must equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import jax  # noqa: E402

from harness import (CHUNK_AXIS, assert_streams_equal,  # noqa: E402
                     engine_spec, make_engine_parts, run_and_collect,
                     shared_prefix_traffic)
from repro.serving import kv_cache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.serving import kv_cache, scheduler  # noqa: E402
from repro_torch.serving.kv_cache import (NULL_PAGE, BlockAllocator,  # noqa: E402
                                          OutOfPages, prefix_chain)

PAGE = 16


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


def _paged_kw(**extra):
    return dict(cache_backend="paged", page_size=PAGE, cache_tokens=256,
                **extra)


def _port_run(parts, traffic, **kw):
    cfg, model, dsg = parts[1]
    spec = dict(n_slots=2, max_seq=64, prompt_bucket=32)
    spec.update(kw)
    eng = scheduler.ServingEngine(cfg, model, dsg, **spec)
    for r in traffic:
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new, eos_id=r.eos_id))
    done = eng.run(2000)
    assert len(done) == len(traffic)
    assert all(r.status == "ok" for r in done.values())
    return {u: list(r.output) for u, r in done.items()}, eng


def _counters(eng):
    """The sharing bookkeeping of an engine of either package."""
    be, a = eng.backend, eng.backend.allocator
    return {"shared_page_hits": be.shared_page_hits,
            "cow_copies": be.cow_copies,
            "prefill_cache_hits": eng.prefill_cache_hits,
            "peak_live": a.peak_live, "live_pages": a.live_pages,
            "free_pages": a.free_pages, "index_size": a.index_size}


# --- prefix_chain ------------------------------------------------------------

def test_prefix_chain_is_chained_and_deterministic():
    row = np.arange(48, dtype=np.int32)
    chain = prefix_chain(row, PAGE)
    assert len(chain) == 3 and all(isinstance(k, bytes) for k in chain)
    assert chain == prefix_chain(row.copy(), PAGE)
    assert len(prefix_chain(np.arange(40, dtype=np.int32), PAGE)) == 3
    other = row.copy()
    other[0] = 999
    diverged = prefix_chain(other, PAGE)
    assert all(d != c for d, c in zip(diverged, chain))
    # the same keys as the reference's, so the two index the same pages
    assert chain == jkv.prefix_chain(row, PAGE)


def test_prefix_chain_validates_input():
    with pytest.raises(ValueError):
        prefix_chain(np.zeros((2, 4), np.int32), PAGE)
    assert (prefix_chain(np.arange(8), PAGE)
            == prefix_chain(np.arange(8, dtype=np.int32), PAGE))


# --- BlockAllocator ------------------------------------------------------------

def test_allocator_share_free_lifecycle():
    a = BlockAllocator(8, reserved=1)
    p, q = a.alloc(2)
    assert a.refcount(p) == 1 and a.live_pages == 2
    assert a.share(p) == 2
    free_before = a.free_pages
    a.free([p])
    assert a.refcount(p) == 1 and a.free_pages == free_before
    a.free([p, q])
    assert a.live_pages == 0 and a.free_pages == free_before + 2
    with pytest.raises(ValueError):
        a.free([p])
    with pytest.raises(ValueError):
        a.share(p)


def test_allocator_index_is_live_only():
    a = BlockAllocator(4)
    (p,) = a.alloc(1)
    a.register(b"k0", p)
    assert a.lookup(b"k0") == p and a.index_size == 1
    a.register(b"k0", p)
    assert a.index_size == 1
    a.free([p])
    assert a.lookup(b"k0") is None and a.index_size == 0
    with pytest.raises(ValueError):
        a.register(b"k1", p)
    pages = a.alloc(a.free_pages)
    assert p in pages
    a.register(b"k2", p)
    assert a.lookup(b"k2") == p


def test_allocator_exhaustion_and_peak():
    a = BlockAllocator(3)
    got = a.alloc(3)
    with pytest.raises(OutOfPages):
        a.alloc(1)
    a.share(got[0])
    assert a.free_pages == 0 and a.peak_live == 3
    a.free(got + [got[0]])
    a.reset_peak()
    assert a.peak_live == a.live_pages == 0


def test_allocator_alloc_free_reuse():
    a = BlockAllocator(8, reserved=1)
    assert a.free_pages == 7
    p1 = a.alloc(3)
    assert len(set(p1)) == 3 and all(1 <= p < 8 for p in p1)
    p2 = a.alloc(4)
    assert a.free_pages == 0 and not set(p1) & set(p2)
    a.free(p1)
    assert set(a.alloc(3)) == set(p1)
    with pytest.raises(ValueError):
        BlockAllocator(1, reserved=1)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 24), st.integers(0, 3),
       st.lists(st.tuples(st.booleans(), st.integers(0, 10)), max_size=50))
def test_allocator_never_double_assigns_and_conserves(alloc_pages,
                                                      reserved, ops):
    """Mirror of tests/test_serving_properties.py: handed-out pages are
    unique, at or above `reserved` and disjoint from the live ones, and
    free + live is conserved; a request past capacity raises and changes
    nothing.  The reference's allocator, driven alike, hands out the same
    page ids."""
    n_pages = reserved + alloc_pages
    a = BlockAllocator(n_pages, reserved=reserved)
    ref = jkv.BlockAllocator(n_pages, reserved=reserved)
    live = []
    for is_alloc, k in ops:
        if is_alloc:
            if k > a.free_pages:
                before = (a.free_pages, sorted(live))
                with pytest.raises(OutOfPages):
                    a.alloc(k)
                assert (a.free_pages, sorted(live)) == before
            else:
                got = a.alloc(k)
                assert got == ref.alloc(k)
                assert len(got) == len(set(got)) == k
                assert all(reserved <= p < n_pages for p in got)
                assert not set(got) & set(live)
                live.extend(got)
        elif live:
            take = live[:min(k, len(live))]
            del live[:len(take)]
            if take:
                a.free(take)
                ref.free(take)
        assert a.free_pages + len(live) == alloc_pages
        assert a.peak_live == ref.peak_live


@settings(max_examples=100, deadline=None)
@given(st.integers(1, 16), st.integers(1, 8))
def test_allocator_rejects_double_free_and_foreign(alloc_pages, k):
    a = BlockAllocator(alloc_pages + 1, reserved=1)
    got = a.alloc(min(k, alloc_pages))
    a.free(got)
    with pytest.raises(ValueError):
        a.free(got[:1])
    with pytest.raises(ValueError):
        a.free([0])
    assert a.free_pages == alloc_pages


_SHARE_OPS = st.lists(st.tuples(st.integers(0, 3), st.integers(0, 9)),
                      max_size=60)


@settings(max_examples=200, deadline=None)
@given(st.integers(2, 16), _SHARE_OPS)
def test_share_cow_free_interleavings_conserve(alloc_pages, ops):
    """Mirror of tests/test_serving_properties.py: a page is free-listed
    exactly when its refcount reaches zero, pages are conserved, the index
    never points at a freed page, and a release past zero raises."""
    a = BlockAllocator(alloc_pages + 1, reserved=1)
    refs, key_of, n_keys = {}, {}, 0
    for op, pick in ops:
        if op == 0 and a.free_pages:
            (p,) = a.alloc(1)
            assert p not in refs
            refs[p] = 1
            k = b"key%d" % n_keys
            n_keys += 1
            a.register(k, p)
            key_of[p] = k
        elif op == 1 and refs:
            p = sorted(refs)[pick % len(refs)]
            refs[p] += 1
            assert a.share(p) == refs[p] == a.refcount(p)
        elif op == 2 and refs:
            p = sorted(refs)[pick % len(refs)]
            refs[p] -= 1
            a.free([p])
            if refs[p] == 0:
                del refs[p]
                assert a.refcount(p) == 0
                assert a.lookup(key_of.pop(p)) is None
                with pytest.raises(ValueError):
                    a.free([p])
                with pytest.raises(ValueError):
                    a.share(p)
        elif op == 3 and refs:
            p = sorted(refs)[pick % len(refs)]
            a.free([p] * refs.pop(p))
            assert a.refcount(p) == 0
            assert a.lookup(key_of.pop(p)) is None
        assert a.free_pages + len(refs) == alloc_pages
        assert a.live_pages == len(refs)
        for p, k in key_of.items():
            assert a.lookup(k) == p
        assert a.index_size == len(key_of)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 8), st.integers(1, 5))
def test_register_is_first_writer_wins_and_live_only(alloc_pages, extra):
    a = BlockAllocator(alloc_pages + 1, reserved=1)
    pages = a.alloc(alloc_pages)
    a.register(b"k", pages[0])
    for p in pages[:extra]:
        a.register(b"k", p)
    assert a.lookup(b"k") == pages[0] and a.lookup(b"nope") is None
    a.free(pages)
    with pytest.raises(ValueError):
        a.register(b"k2", pages[0])
    assert a.index_size == 0


# --- PagedBackend ---------------------------------------------------------------

def _mini_backend(parts):
    be = kv_cache.get_backend("paged", page_size=4, total_tokens=64,
                              prefix_sharing=True)
    handle = be.make(parts[1][0], 2, 16, "cpu")
    return be, handle


def _lane(cfg, s=16, fill=0.0):
    return {n: torch.full((cfg.n_layers, 1, s, cfg.n_kv, cfg.head_dim), fill)
            for n in ("k", "v")}


def test_shared_hits_is_a_leading_run(parts):
    be, _ = _mini_backend(parts)
    chain = prefix_chain(np.arange(12, dtype=np.int32), 4)
    assert be.shared_hits(chain) == 0
    pages = be.allocator.alloc(2)
    be.allocator.register(chain[0], pages[0])
    be.allocator.register(chain[2], pages[1])
    assert be.shared_hits(chain) == 1
    assert be.shared_hits(None) == 0


def test_can_admit_accounts_for_sharing(parts):
    be, _ = _mini_backend(parts)
    chain = prefix_chain(np.arange(8, dtype=np.int32), 4)
    base_free = be.allocator.free_pages
    assert be.can_admit(12)
    pages = be.allocator.alloc(2)
    for k, p in zip(chain, pages):
        be.allocator.register(k, p)
    assert be.sharing_adjustment(chain, prompt_tokens=8) == -2
    ragged = prefix_chain(np.arange(6, dtype=np.int32), 4)
    assert be.sharing_adjustment(ragged, prompt_tokens=6) == 0
    fresh = prefix_chain(np.arange(100, 106, dtype=np.int32), 4)
    assert be.sharing_adjustment(fresh, prompt_tokens=6) == 1
    be.allocator.free(pages)
    assert be.allocator.free_pages == base_free


def test_write_slot_kv_none_requires_full_coverage(parts):
    be, handle = _mini_backend(parts)
    chain = prefix_chain(np.arange(8, dtype=np.int32), 4)
    with pytest.raises(ValueError, match="slot_kv"):
        be.write(handle, None, 0, n_tokens=8, reserve_tokens=12,
                 chain=chain)


def test_write_maps_shared_pages_and_cow_copies_bytes(parts):
    """A second lane with the same 6-token prompt maps both prompt pages
    (no copy); its write at position 6 lands on the shared partial tail,
    which is copied into a private page first, bytes and all, while the
    first lane keeps the original."""
    cfg = parts[1][0]
    be, h = _mini_backend(parts)
    chain = prefix_chain(np.arange(6, dtype=np.int32), 4)
    h = be.write(h, _lane(cfg, fill=3.0), 0, n_tokens=6, reserve_tokens=10,
                 chain=chain)
    h = be.write(h, None, 1, n_tokens=6, reserve_tokens=10, chain=chain)
    assert be.shared_page_hits == 2
    assert (be._table[0, :2] == be._table[1, :2]).all()
    tail = int(be._table[1, 1])
    assert be.allocator.refcount(tail) == 2
    h = be.ensure(h, 1, 6)
    new = int(be._table[1, 1])
    assert new != tail and be.cow_copies == 1
    assert be.allocator.refcount(tail) == 1
    for n in ("pages_k", "pages_v"):
        assert torch.equal(h.data[n][:, new], h.data[n][:, tail])
    assert h.data["page_table"][1, 1] == new
    h = be.ensure(h, 1, 7)                     # private now: no copy
    assert be.cow_copies == 1
    h = be.free(h, 0)
    h = be.free(h, 1)
    assert be.allocator.live_pages == 0 and be.allocator.index_size == 0


def test_paged_backend_write_grow_free(parts):
    """Mirror of tests/test_kv_cache.py: allocation, reservation, growth
    and release, page for page."""
    cfg = parts[1][0]
    be = kv_cache.get_backend("paged", page_size=8, total_tokens=64)
    h = be.make(cfg, 2, 32, "cpu")
    assert h.kind == "paged" and h.page_size == 8
    assert tuple(h.data["page_table"].shape) == (2, 4)
    h = be.write(h, _lane(cfg, 32), 0, n_tokens=12, reserve_tokens=20)
    row = be._table[0]
    assert (row[:2] != NULL_PAGE).all() and (row[2:] == NULL_PAGE).all()
    assert be.allocator.free_pages == 6 and int(be._resv[0]) == 1
    assert be.can_admit(40) and not be.can_admit(41)
    h = be.ensure(h, 0, 16)
    assert be._table[0, 2] != NULL_PAGE
    assert int(be._resv[0]) == 0 and be.allocator.free_pages == 5
    assert be.ensure(h, 0, 17) is h
    h = be.free(h, 0)
    assert (be._table[0] == NULL_PAGE).all()
    assert be.allocator.free_pages == 8
    assert (h.data["page_table"][0] == NULL_PAGE).all()


def test_paged_backend_guards(parts):
    cfg = parts[1][0]
    be = kv_cache.get_backend("paged", page_size=8)
    with pytest.raises(ValueError):
        be.make(cfg, 2, 30, "cpu")
    be2 = kv_cache.get_backend("paged", page_size=8)
    h = be2.make(cfg, 2, 32, "cpu")
    with pytest.raises(RuntimeError):
        be2.make(cfg, 2, 32, "cpu")
    with pytest.raises(ValueError):
        be2.write(h, _lane(cfg, 32), 0, n_tokens=None)
    with pytest.raises(ValueError):
        kv_cache.get_backend("ring")
    with pytest.raises(ValueError, match="paged backend"):
        kv_cache.get_backend("dense", prefix_sharing=True)


def test_backend_resident_bytes(parts):
    cfg = parts[1][0]
    hd = kv_cache.get_backend("dense").make(cfg, 4, 256, "cpu")
    paged = kv_cache.get_backend("paged", page_size=16, total_tokens=4 * 96)
    hp = paged.make(cfg, 4, 256, "cpu")
    assert (kv_cache.DenseBackend().resident_bytes(hd)
            >= 2 * paged.resident_bytes(hp))


# --- engine differentials ---------------------------------------------------------

@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_sharing_streams_bitwise_equal(parts, chunk):
    """Mirror of tests/test_prefix_sharing.py (one engine): greedy streams
    with sharing on equal the reference's dense streams and the port's
    with sharing off, and the page counters equal the reference's with
    sharing on."""
    cfg, params, dsg = parts[0]
    ref = run_and_collect(engine_spec(*parts[0], decode_chunk=chunk),
                          shared_prefix_traffic(cfg), max_steps=2000)
    ref_on, jeng = run_and_collect(
        engine_spec(*parts[0], decode_chunk=chunk,
                    **_paged_kw(prefix_sharing=True)),
        shared_prefix_traffic(cfg), max_steps=2000, return_engine=True)
    off, _ = _port_run(parts, shared_prefix_traffic(cfg), decode_chunk=chunk,
                       **_paged_kw())
    on, eng = _port_run(parts, shared_prefix_traffic(cfg),
                        decode_chunk=chunk, **_paged_kw(prefix_sharing=True))
    assert_streams_equal(ref, off, "dense vs paged")
    assert_streams_equal(ref, on, "dense vs paged+sharing")
    assert_streams_equal(ref_on, on, "reference vs port, sharing on")
    assert eng.backend.shared_page_hits > 0
    assert _counters(eng) == _counters(jeng)
    assert eng.backend.allocator.live_pages == 0
    assert eng.backend.allocator.index_size == 0


@pytest.mark.parametrize("chunk", CHUNK_AXIS)
def test_cow_partial_tail_streams_and_counters(parts, chunk):
    """Identical prompts in a 24-token bucket (page 16) share a partial
    tail page, so every lane's first decode write lands on a shared page
    and copies it.  Streams equal the sharing-off run, and the copies,
    hits and prefill replays equal the reference's."""
    cfg = parts[0][0]
    reqs = lambda: shared_prefix_traffic(  # noqa: E731
        cfg, n=5, prompt_len=24, prefix_len=24, max_new=6)
    spec = dict(buckets=(24,), decode_chunk=chunk)
    off, _ = _port_run(parts, reqs(), **_paged_kw(), **spec)
    on, eng = _port_run(parts, reqs(), **_paged_kw(prefix_sharing=True),
                        **spec)
    _, jeng = run_and_collect(
        engine_spec(*parts[0], **_paged_kw(prefix_sharing=True), **spec),
        reqs(), max_steps=2000, return_engine=True)
    assert_streams_equal(off, on, f"chunk={chunk}")
    assert eng.prefill_cache_hits >= 1
    assert 1 <= eng.backend.cow_copies <= 5
    assert eng.backend.shared_page_hits >= eng.prefill_cache_hits
    assert _counters(eng) == _counters(jeng)
    assert eng.backend.allocator.live_pages == 0


def test_sharing_reduces_peak_pages(parts):
    cfg = parts[0][0]
    reqs = lambda: shared_prefix_traffic(  # noqa: E731
        cfg, n=6, prompt_len=24, prefix_len=24, max_new=4)
    spec = dict(buckets=(24,), n_slots=3)
    _, off = _port_run(parts, reqs(), **_paged_kw(), **spec)
    _, on = _port_run(parts, reqs(), **_paged_kw(prefix_sharing=True),
                      **spec)
    assert on.backend.allocator.peak_live < off.backend.allocator.peak_live
    _, jon = run_and_collect(
        engine_spec(*parts[0], **_paged_kw(prefix_sharing=True), **spec),
        reqs(), max_steps=2000, return_engine=True)
    assert on.backend.allocator.peak_live == jon.backend.allocator.peak_live


def test_retire_readmit_reuses_and_reclaims(parts):
    """Two waves of the same traffic through one engine: wave 2 registers
    the reclaimed pages anew, shares within the wave, and reproduces wave
    1's streams."""
    cfg = parts[0][0]
    tcfg, model, dsg = parts[1]
    eng = scheduler.ServingEngine(tcfg, model, dsg, n_slots=2, max_seq=64,
                                  buckets=(24,), cache_backend="paged",
                                  page_size=PAGE, cache_tokens=256,
                                  prefix_sharing=True)
    wave1 = shared_prefix_traffic(cfg, n=4, prompt_len=24, prefix_len=24,
                                  max_new=6)
    for r in wave1:
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new))
    done1 = {u: list(r.output) for u, r in eng.run(2000).items()}
    assert eng.backend.allocator.live_pages == 0
    assert eng.backend.allocator.index_size == 0
    hits1 = eng.backend.shared_page_hits
    for r in wave1:
        eng.submit(scheduler.Request(uid=r.uid + 100, prompt=r.prompt.copy(),
                                     max_new=r.max_new))
    done2 = eng.run(2000)
    assert eng.backend.shared_page_hits > hits1
    for r in wave1:
        assert done1[r.uid] == list(done2[r.uid + 100].output)
    assert eng.backend.allocator.live_pages == 0


def test_sharing_with_dsg_serving_and_sampling(parts):
    """Prefix sharing under the DSG serving runtime (a replayed prefill
    seeds the lane's CSR pattern from the cached scores) and with sampled
    lanes: streams equal the sharing-off run."""
    from repro_torch.serving.dsg_runtime import DSGServingConfig
    cfg = parts[0][0]
    tcfg, model, dsg = parts[1]

    def run(sharing):
        eng = scheduler.ServingEngine(
            tcfg, model, dsg, n_slots=2, max_seq=64, buckets=(24,),
            decode_chunk=8, dsg_serving=DSGServingConfig(8),
            **_paged_kw(prefix_sharing=sharing))
        for r in shared_prefix_traffic(cfg, n=5, prompt_len=24,
                                       prefix_len=24, max_new=9):
            eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                         max_new=r.max_new,
                                         temperature=0.7 * (r.uid % 2)))
        return {u: list(r.output) for u, r in eng.run(2000).items()}, eng

    off, _ = run(False)
    on, eng = run(True)
    assert on == off
    assert eng.prefill_cache_hits >= 1 and eng.backend.cow_copies >= 1


def test_engine_page_math_matches_reference(parts):
    """pages_needed, can_admit_request and free_pages agree with the
    reference's engine as sharing builds up."""
    cfg, params, dsg = parts[0]
    from repro.serving.scheduler import ServingEngine as JEngine
    tcfg, model, tdsg = parts[1]
    kw = dict(n_slots=2, max_seq=64, buckets=(24,),
              **_paged_kw(prefix_sharing=True))
    jeng = JEngine(cfg, params, dsg, **kw)
    eng = scheduler.ServingEngine(tcfg, model, tdsg, **kw)
    reqs = shared_prefix_traffic(cfg, n=3, prompt_len=24, prefix_len=24,
                                 max_new=20)
    for r in reqs:
        t = scheduler.Request(uid=r.uid, prompt=r.prompt, max_new=r.max_new)
        assert eng.pages_needed(t) == jeng.pages_needed(r)
        assert eng.can_admit_request(t) == jeng.can_admit_request(r)
        assert eng.free_pages() == jeng.free_pages()
        eng.submit(t)
        jeng.submit(r)
        eng.step()
        jeng.step()
    assert eng.free_pages() == jeng.free_pages()
    assert _counters(eng) == _counters(jeng)


def test_prefix_sharing_needs_the_paged_backend(parts):
    tcfg, model, dsg = parts[1]
    with pytest.raises(ValueError, match="paged"):
        scheduler.ServingEngine(tcfg, model, dsg, prefix_sharing=True)
