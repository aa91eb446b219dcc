"""The bf16 parity rule (ROADMAP.md §3, deliberate deviations): the port
in bf16 against the reference in bf16, teacher-forced, on the CPU at smoke
width with the full config's bf16 settings (bf16 weights and activations,
bf16 attention scores).

The port does not copy XLA-CPU's per-op bf16 rounding (of `silu`, for
one), so bf16 streams may part where two logits are closer than the two
packages' rounding.  What is held instead:

* Teacher forcing.  The port decodes on the reference's own prefill (its
  K/V cache and last-token logits, carried over), fed the reference's
  greedy tokens and, with DSG serving, the reference's CSR patterns
  (seeded and refreshed from the reference's DRS scores every REFRESH
  tokens).  Each step then compares one decode step's arithmetic.
* Logits: |port - reference| <= LOGIT_ATOL[dsg_on] at every step (rtol 0).
* Argmax: equal at every step where the reference's top-2 margin exceeds
  2 * LOGIT_ATOL[dsg_on].
* DSG serving, at every refresh: |port - reference| <= SCORE_ATOL on the
  DRS scores, and the port's per-lane top-k selection equals the
  reference's except for groups whose reference score lies within
  SCORE_ATOL of the lane's k-th score.
* The prompt prefill with no selection in it (DSG off): the last-token
  logits within LOGIT_ATOL[False].  (The prefill's per-token DSG masks
  are each package's own, and a mask taken at a tie changes the prompt's K/V: the
  6th prompt of `harness.mixed_traffic` flips one layer-1 group whose
  reference score equals the k-th, and its logits then differ by 0.48.
  That is a selection at a tie, not arithmetic, so the prefill is held
  where it selects nothing.)

Derivation of the tolerances (measured, not picked): both packages
approximate the same f32 function, each within its own bf16 error, so
they may differ by twice that error.  The reference's bf16 error is
measured on these very steps: the reference in f32 decodes on the bf16
prefill (cast) with the same tokens and patterns, and E is the largest
|reference bf16 - reference f32| seen.  Over 8 prompts x 32 steps
(`_run(dsg_on, check=False)` with PROMPTS, STEPS = 8, 32), E was 0.0975
(DSG off) and 0.0459 (DSG on) for logits of |value| < 4, and 0.2235 for
the DRS scores; the port's own largest gaps there were 0.0527, 0.0410 and
0.1782.  LOGIT_ATOL = 2 x 0.0975 -> 0.2 with DSG off and 2 x 0.0459 -> 0.1
with DSG on, SCORE_ATOL = 2 x 0.2235 -> 0.45.  Every run re-measures E on
its own steps (PROMPTS x STEPS: 0.0975, 0.0428 and 0.2235) and requires
2 E <= tolerance <= 3 E, so the derivation is re-checked and no tolerance
is much wider than it.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# smoke-width tensors gain nothing from threads, which would only contend
# with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from harness import make_engine_parts, mixed_traffic  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import drs  # noqa: E402
from repro_torch.models import api  # noqa: E402

LOGIT_ATOL = {False: 0.2, True: 0.1}      # by dsg_on
SCORE_ATOL = 0.45
REFRESH = 8
STEPS = 24
PROMPTS = 6
SMAX = 64


def _setup(dsg_on):
    cfg, _, _ = make_engine_parts()
    cfg = cfg.replace(dtype="bfloat16", attn_bf16_scores=True)
    if not dsg_on:
        cfg = cfg.replace(dsg=cfg.dsg._replace(enabled=False))
    key = jax.random.PRNGKey(0)
    params = japi.init_model(key, cfg)
    dsg = (japi.init_dsg(jax.random.fold_in(key, 1), params, cfg)
           if dsg_on else None)
    cfg32 = cfg.replace(dtype="float32", attn_bf16_scores=False)
    f32 = functools.partial(jax.tree.map, lambda a: a.astype(jnp.float32))
    tcfg = bridge.config_from_jax(cfg)
    model = bridge.model_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                  device="cpu")
    tdsg = bridge.dsg_from_jax(
        None if dsg is None else jax.tree.map(np.asarray, dsg), device="cpu")
    return ((cfg, params, dsg), (cfg32, f32(params),
                                 None if dsg is None else f32(dsg)),
            (tcfg, model, tdsg))


@functools.lru_cache(maxsize=None)
def _jit_decode(cfg, collect, with_csr):
    if with_csr:
        return jax.jit(lambda p, d, t, c, pos, csr: japi.decode_step(
            p, d, cfg, t, c, pos, ffn_csr=csr, collect_drs_scores=collect))
    return jax.jit(lambda p, d, t, c, pos: japi.decode_step(
        p, d, cfg, t, c, pos, collect_drs_scores=collect))


@functools.lru_cache(maxsize=None)
def _jit_prefill(cfg, collect):
    return jax.jit(lambda p, d, t, c: japi.prefill(
        p, d, cfg, {"tokens": t}, c, collect_drs_scores=collect))


def _pattern(scores, keep):
    """Per-lane top-k rows from scores (L, 1, G), as the serving runtime
    writes them: every group at or above the k-th score, ascending."""
    n_l, _, g = scores.shape
    idx = np.zeros((n_l, 1, g), np.int32)
    counts = np.zeros((n_l, 1), np.int32)
    for l in range(n_l):
        s = scores[l, 0]
        act = np.flatnonzero(s >= np.partition(s, g - keep)[g - keep])
        idx[l, 0, :len(act)] = act
        counts[l, 0] = len(act)
    return idx, counts


def _check_selection(ref, port, keep, tol):
    """Top-k selections of scores (L, 1, G) equal except for groups whose
    reference score is within `tol` of the lane's k-th score."""
    g = ref.shape[-1]
    kth = np.partition(ref, g - keep, axis=-1)[..., g - keep:g - keep + 1]
    kth_p = np.partition(port, g - keep, axis=-1)[..., g - keep:g - keep + 1]
    flipped = (ref >= kth) != (port >= kth_p)
    near = np.abs(ref - kth) <= tol
    assert not (flipped & ~near).any(), (
        f"selection differs away from a tie: reference scores "
        f"{ref[flipped & ~near]}, k-th {kth.ravel()}")


def _to_torch(a):
    return bridge.tensor(np.asarray(a))


def _run(dsg_on, check=True):
    """Teacher-forced decode over PROMPTS prompts x STEPS steps; returns
    the largest |port - ref| and the reference's own bf16 error E, for
    logits and for scores."""
    (cfg, params, dsg), (cfg32, p32, d32), (tcfg, model, tdsg) = \
        _setup(dsg_on)
    logit_atol = LOGIT_ATOL[dsg_on]
    keep = drs.keep_groups(cfg.d_ff, drs.DRSConfig(gamma=cfg.dsg.gamma,
                                                   block=cfg.dsg.block))
    stats = {"logit": 0.0, "logit_e": 0.0, "score": 0.0, "score_e": 0.0,
             "argmax_held": 0}
    for r in mixed_traffic(cfg, n=PROMPTS):
        toks = jnp.asarray(r.prompt[None].astype(np.int32))
        jl, jc, *sc = _jit_prefill(cfg, dsg_on)(
            params, dsg, toks, japi.make_cache(cfg, 1, SMAX))
        if not dsg_on:
            # the prefill selects nothing: the port's own prefill is held
            tl, _ = api.prefill(model, None, tcfg,
                                {"tokens": _to_torch(toks).long()},
                                api.make_cache(tcfg, 1, SMAX, device="cpu"))
            gap = np.abs(np.asarray(jl, np.float32) - tl.float().numpy())
            assert not check or gap.max() <= logit_atol, gap.max()
        # teacher forcing: the port and the f32 reference decode on the
        # reference's prefill cache
        tc = {n: _to_torch(jc[n]) for n in ("k", "v")}
        jc32 = jax.tree.map(lambda a: a.astype(jnp.float32), jc)
        csr = _pattern(np.asarray(sc[0], np.float32), keep) if dsg_on \
            else None
        logits = (np.asarray(jl, np.float32),) * 3
        pos = toks.shape[1]
        for step in range(STEPS + 1):
            ref, port, ref32 = logits
            if step:
                gap = np.abs(ref - port).max()
                stats["logit"] = max(stats["logit"], gap)
                stats["logit_e"] = max(stats["logit_e"],
                                       np.abs(ref - ref32).max())
                assert not check or gap <= logit_atol, (step, gap)
                top2 = np.sort(ref[0])[-2:]
                if top2[1] - top2[0] > 2 * logit_atol:
                    assert not check or ref.argmax() == port.argmax()
                    stats["argmax_held"] += 1
            if step == STEPS:
                break
            tok = np.asarray([[ref.argmax()]], np.int32)
            collect = dsg_on and (step + 1) % REFRESH == 0
            jpos = jnp.asarray([pos], jnp.int32)
            extra = ({"idx": jnp.asarray(csr[0]),
                      "counts": jnp.asarray(csr[1])},) if dsg_on else ()
            jo = _jit_decode(cfg, collect, dsg_on)(
                params, dsg, jnp.asarray(tok), jc, jpos, *extra)
            jo32 = _jit_decode(cfg32, collect, dsg_on)(
                p32, d32, jnp.asarray(tok), jc32, jpos, *extra)
            to = api.decode_step(
                model, tdsg, tcfg, torch.from_numpy(tok).long(), tc,
                torch.tensor([pos], dtype=torch.int32),
                ffn_csr=({"idx": torch.from_numpy(csr[0]),
                          "counts": torch.from_numpy(csr[1])}
                         if dsg_on else None),
                collect_drs_scores=collect)
            jc, jc32 = jo[1], jo32[1]
            logits = (np.asarray(jo[0], np.float32),
                      to[0].float().numpy(), np.asarray(jo32[0], np.float32))
            if collect:
                rs, ps_ = np.asarray(jo[2], np.float32), to[2].float().numpy()
                gap = np.abs(rs - ps_).max()
                stats["score"] = max(stats["score"], gap)
                stats["score_e"] = max(stats["score_e"], np.abs(
                    rs - np.asarray(jo32[2], np.float32)).max())
                if check:
                    assert gap <= SCORE_ATOL, (step, gap)
                    _check_selection(rs, ps_, keep, SCORE_ATOL)
                csr = _pattern(rs, keep)
            pos += 1
    return stats


@pytest.mark.parametrize("dsg_on", [False, True], ids=["no_dsg", "dsg"])
def test_bf16_teacher_forced_within_derived_tolerance(dsg_on):
    stats = _run(dsg_on)
    # the derivation holds on this run's own steps: 2 E <= the tolerance
    # <= 3 E
    e = stats["logit_e"]
    assert 2 * e <= LOGIT_ATOL[dsg_on] <= 3 * e, stats
    if dsg_on:
        assert 2 * stats["score_e"] <= SCORE_ATOL <= 3 * stats["score_e"], \
            stats
    assert stats["argmax_held"] > 0, stats
