"""The port's sampling (`repro_torch.serving.scheduler.sample_tokens`,
`gumbel_noise` and the engine's sampled decode) against the reference's,
on the CPU.

`sample_tokens` takes its Gumbel noise as a tensor.  The reference draws
`jax.random.categorical(key, lg)`, which is argmax(gumbel(key, (V,), f32)
+ lg), so on the same noise the two functions must pick the same token:
held here on seeded cases over mixed temperatures and top_p in
{0, 0.5, 0.9, 1}.  A case is excluded only where a cumulative mass of the
sorted distribution lies within 1e-6 of top_p (the two packages' softmax
and cumsum round differently, so the nucleus cut could move there); the
exclusions are counted and bounded.

JAX's PRNG cannot be replayed, so the engine's sampled streams are held to
rules, not to the reference's bits: greedy lanes in a sampled batch keep
the reference's greedy streams, a vanishing nucleus equals greedy, and a
sampled stream is the same from run to run with one seed, at any decode
chunk, on either backend and with DSG serving on.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import (engine_spec, make_engine_parts,  # noqa: E402
                     mixed_traffic, run_and_collect)
from repro.serving import scheduler as jsched  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import scheduler, workload  # noqa: E402
from repro_torch.serving.dsg_runtime import DSGServingConfig  # noqa: E402

ENGINE = dict(n_slots=2, max_seq=64, prompt_bucket=32)
PAGED = dict(cache_backend="paged", page_size=8, cache_tokens=160)
TOP_PS = (0.0, 0.5, 0.9, 1.0)
TEMPS = (0.0, 0.5, 0.8, 1.0, 1.7)
VOCABS = (64, 256, 1024)
CASES = 240          # seeded batches of 4 lanes: 960 lane draws


def _case(i):
    """Batch i: 4 lanes over a vocabulary of 64, 256 or 1024 tokens,
    logits at a scale that puts the nucleus cut anywhere, mixed
    temperatures and top_ps, and the reference's per-lane keys."""
    rng = np.random.default_rng(1000 + i)
    v = VOCABS[i % len(VOCABS)]
    logits = (rng.standard_normal((4, v)) * rng.uniform(0.3, 2.0)).astype(
        np.float32)
    temps = rng.choice(TEMPS, 4).astype(np.float32)
    top_ps = rng.choice(TOP_PS, 4).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(i), 4)
    return logits, temps, top_ps, keys


def _near_cut(logits, temp, top_p):
    """Whether a cumulative mass of the sorted distribution (the mass
    before each token, as the keep test reads it; the top token is kept
    whatever its mass) lies within 1e-6 of top_p."""
    lg = np.sort(logits.astype(np.float64) / max(temp, 1e-6))[::-1]
    p = np.exp(lg - lg.max())
    p /= p.sum()
    before = (np.cumsum(p) - p)[1:]
    return bool((np.abs(before - top_p) < 1e-6).any())


def test_sample_tokens_matches_reference_on_the_same_noise():
    """On the reference's own Gumbel noise, the port picks the reference's
    token in every counted case: at least 200 batches' worth of lanes, with
    the exclusions at a nucleus cut counted and bounded."""
    ref = jax.jit(jsched.sample_tokens)
    noise_of = jax.jit(jax.vmap(lambda k, lg: jax.random.gumbel(
        k, lg.shape, jnp.float32)))
    counted = excluded = 0
    for i in range(CASES):
        logits, temps, top_ps, keys = _case(i)
        want = np.asarray(ref(jnp.asarray(logits), keys, jnp.asarray(temps),
                              jnp.asarray(top_ps)))
        noise = np.array(noise_of(keys, jnp.asarray(logits)))
        got = scheduler.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(noise),
            torch.from_numpy(temps), torch.from_numpy(top_ps)).numpy()
        assert got.dtype == np.int32
        for lane in range(4):
            if temps[lane] > 0 and _near_cut(logits[lane], temps[lane],
                                             top_ps[lane]):
                excluded += 1
                continue
            assert got[lane] == want[lane], (i, lane, temps[lane],
                                             top_ps[lane])
            counted += 1
    assert counted >= 200 * 4, (counted, excluded)
    print(f"{counted} lanes counted, {excluded} excluded at a nucleus cut")
    assert excluded <= 0.1 * CASES * 4, excluded


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_temperature_zero_takes_the_argmax(dtype):
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((5, 97)).astype(
        np.float32)).to(dtype)
    noise = torch.from_numpy(rng.gumbel(size=(5, 97)).astype(np.float32))
    got = scheduler.sample_tokens(logits, noise, torch.zeros(5),
                                  torch.full((5,), 0.9))
    assert torch.equal(got, torch.argmax(logits, dim=-1).to(torch.int32))


def test_vanishing_nucleus_keeps_only_the_top_token():
    """top_p 0 (and a tiny top_p) keep the crossing token alone: whatever
    the noise, the sample is the argmax."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    for top_p in (0.0, 1e-6):
        for seed in range(5):
            noise = torch.from_numpy(np.random.default_rng(seed).gumbel(
                size=(6, 50)).astype(np.float32) * 10)
            got = scheduler.sample_tokens(logits, noise, torch.ones(6),
                                          torch.full((6,), top_p))
            assert torch.equal(got, torch.argmax(logits, dim=-1).to(
                torch.int32))


def test_gumbel_noise_is_a_pure_function_of_its_counters():
    """The hash gives the same noise for the same (seed, stream, counter),
    other noise when any of them moves, and lane rows that depend on their
    own (stream, counter) only."""
    f = scheduler.gumbel_noise
    s = torch.tensor([3, 3, 9, 0])
    c = torch.tensor([1, 2, 1, 7])
    a = f(5, s, c, 300)
    assert a.shape == (4, 300) and a.dtype == torch.float32
    assert torch.isfinite(a).all()
    assert torch.equal(a, f(5, s, c, 300))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert not torch.equal(a, f(6, s, c, 300))
    assert torch.equal(f(5, s[2:3], c[2:3], 300)[0], a[2])
    assert torch.equal(f(5, s, c, 200), a[:, :200])


def test_gumbel_noise_is_standard_gumbel():
    """Mean and variance over 2^20 draws: Euler's constant and pi^2 / 6
    within 1%; the hash stays inside 32 bits, so no value saturates."""
    g = scheduler.gumbel_noise(1, torch.arange(64), torch.zeros(64,
                                                                 dtype=torch.long),
                               1 << 14).double()
    assert abs(float(g.mean()) - 0.5772156649) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.02 * np.pi ** 2 / 6
    assert float(g.min()) > -3.0 and float(g.max()) < 20.0
    x = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 12345])
    h = scheduler._mix32(x)
    assert int(h.min()) >= 0 and int(h.max()) <= 0xFFFFFFFF
    assert [scheduler._mix32(int(v)) for v in x] == h.tolist()


# --- the engine --------------------------------------------------------------

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


def _port_run(parts, traffic, **kw):
    cfg, model, dsg = parts[1]
    eng = scheduler.ServingEngine(cfg, model, dsg, **{**ENGINE, **kw})
    for r in traffic:
        eng.submit(scheduler.Request(uid=r.uid, prompt=r.prompt,
                                     max_new=r.max_new, eos_id=r.eos_id,
                                     temperature=r.temperature,
                                     top_p=r.top_p))
    done = eng.run(400)
    assert len(done) == len(traffic)
    assert all(r.status == "ok" for r in done.values())
    return {u: list(r.output) for u, r in done.items()}, eng


def _half_sampled(cfg, n=6):
    """harness.mixed_traffic with the odd requests sampled at 0.8 / 0.9."""
    reqs = mixed_traffic(cfg, n=n)
    for r in reqs[1::2]:
        r.temperature, r.top_p = 0.8, 0.9
    return reqs


@pytest.fixture(scope="module")
def ref_greedy(parts):
    cfg, params, dsg = parts[0]
    return run_and_collect(engine_spec(cfg, params, dsg), mixed_traffic(cfg))


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_greedy_lanes_in_a_sampled_batch_keep_reference_streams(
        parts, ref_greedy, backend, chunk):
    """Sampled lanes share every step with greedy ones; the greedy lanes'
    streams stay the reference's greedy streams, and the sampled lanes'
    streams are valid tokens of their budget."""
    kw = PAGED if backend == "paged" else {"cache_backend": "dense"}
    reqs = _half_sampled(parts[0][0])
    got, _ = _port_run(parts, reqs, decode_chunk=chunk, **kw)
    for r in reqs:
        if r.temperature == 0:
            assert got[r.uid] == ref_greedy[r.uid]
        else:
            assert len(got[r.uid]) == r.max_new
            assert all(0 <= t < parts[1][0].vocab for t in got[r.uid])
    assert any(got[r.uid] != ref_greedy[r.uid] for r in reqs[1::2])


def test_sampling_topp_collapse_matches_greedy(parts):
    """Mirror of tests/test_serving.py:172: temperature > 0 with a
    vanishing nucleus keeps only the argmax token, so the sampled stream
    equals the greedy one, which equals the reference's."""
    cfg, params, dsg = parts[0]
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, 12, dtype=np.int32)
    want = run_and_collect(
        engine_spec(cfg, params, dsg, n_slots=1, prompt_bucket=16),
        [jsched.Request(uid=0, prompt=prompt, max_new=8)])[0]

    def run_one(**kw):
        return _port_run(parts, [scheduler.Request(uid=0, prompt=prompt,
                                                   max_new=8, **kw)],
                         n_slots=1, prompt_bucket=16)[0][0]

    assert run_one() == want
    assert run_one(temperature=1.0, top_p=1e-6) == want
    assert run_one(temperature=1.0, top_p=0.0) == want


def test_sampling_reproducible_across_engines(parts):
    """Mirror of tests/test_serving.py:208: one seed, one stream; another
    seed, another stream."""
    cfg = parts[1][0]
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, cfg.vocab, 10, dtype=np.int32)

    def run_one(seed):
        out = _port_run(parts, [scheduler.Request(
            uid=0, prompt=prompt, max_new=10, temperature=1.5, top_p=0.95)],
            prompt_bucket=16, seed=seed)[0][0]
        assert all(0 <= t < cfg.vocab for t in out)
        return out

    assert run_one(seed=0) == run_one(seed=0)
    assert run_one(seed=0) != run_one(seed=1)


def test_paged_matches_dense_under_sampling(parts):
    """Mirror of tests/test_serving_overlap.py:143: sampling reads the same
    logits on both backends, and the noise depends on the seed and the
    request's admission draw, so sampled streams agree token for token."""
    kw = dict(temperature=0.8, top_p=0.9)
    reqs = lambda: mixed_traffic(parts[0][0], n=4, **kw)  # noqa: E731
    dense, _ = _port_run(parts, reqs(), seed=7)
    paged, _ = _port_run(parts, reqs(), seed=7, page_size=8,
                         cache_backend="paged", cache_tokens=80)
    assert dense == paged
    assert any(len(s) > 1 for s in dense.values())


@pytest.mark.parametrize("dsg_on", [False, True], ids=["no_dsg", "dsg"])
def test_sampled_streams_ignore_the_chunk(parts, dsg_on):
    """A sampled stream is the same at chunk 1, 2 and 8 (lanes admit at
    other steps at each chunk, so a key of the engine step or the lane
    would move it; the noise keys neither)."""
    scfg = DSGServingConfig(8) if dsg_on else None
    runs = [_port_run(parts, _half_sampled(parts[0][0]), decode_chunk=c,
                      dsg_serving=scfg, **PAGED)[0] for c in (1, 2, 8)]
    assert runs[0] == runs[1] == runs[2]


def test_first_token_is_drawn_at_admission(parts):
    """A request whose budget is one token emits only its admission draw:
    at a high temperature over many seeds it is not always the argmax, and
    it is the same for the same seed."""
    cfg = parts[1][0]
    prompt = np.arange(9, dtype=np.int32) + 5

    def first(seed, temp):
        return _port_run(parts, [scheduler.Request(
            uid=0, prompt=prompt, max_new=1, temperature=temp)],
            seed=seed)[0][0]

    greedy = first(0, 0.0)
    draws = [first(s, 5.0) for s in range(6)]
    assert all(len(d) == 1 and 0 <= d[0] < cfg.vocab for d in draws)
    assert any(d != greedy for d in draws)
    assert first(3, 5.0) == draws[3]


def test_warmup_reaches_the_sampling_variants(parts):
    """warm_temp_for reads the traffic's temperatures; warming with a
    sampled request leaves the engine idle, its counters (its admission
    draws too) at zero and its pool full, so the sampled streams that
    follow are a fresh engine's."""
    cfg = parts[1][0]
    reqs = _half_sampled(parts[0][0])
    assert workload.warm_temp_for(reqs) == 0.8
    assert workload.warm_temp_for([], 0.3) == 0.3
    want, _ = _port_run(parts, _half_sampled(parts[0][0]), decode_chunk=8,
                        **PAGED)
    eng = scheduler.ServingEngine(parts[1][0], parts[1][1], parts[1][2],
                                  decode_chunk=8, **ENGINE, **PAGED)
    workload.warmup_engine(eng, cfg.vocab, requests=reqs)
    alloc = eng.backend.allocator
    assert alloc.free_pages == alloc.n_pages - alloc.reserved
    assert (eng.steps, eng.admissions, len(eng.done)) == (0, 0, 0)
    for r in _half_sampled(parts[0][0]):
        eng.submit(r)
    got = {u: list(r.output) for u, r in eng.run(400).items()}
    assert got == want


def test_serve_cli_samples_on_cpu(capsys):
    serve.main(["--device", "cpu", "--smoke", "--workload", "mixed",
                "--requests", "3", "--temperature", "0.8", "--top-p", "0.9",
                "--cache-backend", "paged", "--decode-chunk", "4"])
    assert "[overlap/paged/chunk4 on cpu] 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags,says", [
    (["--temperature", "-1"], "--temperature must be >= 0"),
    (["--top-p", "1.5"], "--top-p must be in [0, 1]")])
def test_serve_cli_rejects_bad_sampling_flags(flags, says, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--smoke", *flags])
    assert exc.value.code != 0
    assert says in capsys.readouterr().err
