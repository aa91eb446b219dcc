"""The dry run's recurrent decode state, built without the prompt's
prefill (`launch.dryrun.decode_state`), on the CPU.

At smoke width, for xlstm-350m and zamba2-7b at several prompt lengths,
the state it builds has the same leaves, shapes, dtypes and bytes as the
state `api.prefill` leaves after the whole prompt, and as the reference's
`jax.eval_shape(prefill)[1]`, the state the reference's dry run lays out
(`repro.launch.dryrun.build_cell`).  xLSTM's states do not depend on the
prompt's length; zamba's shared-attention K/V have the prompt's length
(decode uses them as a ring, ROADMAP.md §3).

At full width, the long_500k decode cells of both archs on the
single-pod mesh (256 fake ranks) come back `ok`, their cache bytes per
device equal to the reference's spec rules over its eval_shape state,
their step traced sharded with its collectives and HBM bytes.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import api as japi, specs as jspecs  # noqa: E402
from repro.parallel.sharding import Axes as JAxes  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = ["xlstm-350m", "zamba2-7b"]
B = 2
# xLSTM's chunked scan takes S % min(128, S) == 0: any S up to 128, then
# multiples of 128
PROMPTS = [1, 8, 96, 256]


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _port_leaves(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."),
                v.numel() * v.element_size())
            for k, v in _flat(tree).items()}


def _ref_state(cfg, batch: int, seq: int):
    """The reference dry run's decode state: eval_shape of its prefill
    over a prompt of `seq` tokens."""
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: japi.init_model(key, cfg))
    dsg = jax.eval_shape(lambda p: japi.init_dsg(key, p, cfg), params)
    prompt = japi.make_inputs(cfg, JShape("p", seq, batch, "prefill"))
    cache = jax.eval_shape(lambda: japi.make_cache(cfg, batch, seq))
    return jax.eval_shape(lambda p, d, pr, c: japi.prefill(p, d, cfg, pr, c),
                          params, dsg, prompt, cache)[1]


def _ref_leaves(tree) -> dict:
    return {k: (tuple(v.shape), str(v.dtype),
                math.prod(v.shape) * v.dtype.itemsize)
            for k, v in _flat(tree).items()}


_MODELS = {}


def _smoke(arch):
    if arch not in _MODELS:
        cfg = configs.get_smoke_config(arch)
        model = api.init_model(cfg, generator=None, device="meta")
        dsg = api.init_dsg(model, cfg, generator=None, device="meta")
        _MODELS[arch] = cfg, model, dsg
    return _MODELS[arch]


@pytest.mark.parametrize("seq", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_state_without_prefill_equals_the_prefills(arch, seq):
    cfg, model, dsg = _smoke(arch)
    shape = ShapeConfig("decode", seq, B, "decode")
    built = _port_leaves(dryrun.decode_state(model, dsg, cfg, shape))
    prompt = api.make_inputs(cfg, ShapeConfig("p", seq, B, "prefill"))
    prefilled = _port_leaves(api.prefill(
        model, dsg, cfg, prompt,
        api.make_cache(cfg, B, seq, device="meta"))[1])
    ref = _ref_leaves(_ref_state(jconfigs.get_smoke_config(arch), B, seq))
    assert built == prefilled
    assert built == ref
    if arch == "zamba2-7b":
        assert built["k"][0][2] == seq == built["v"][0][2]


def _ref_cache_bytes(arch: str, shape_name: str) -> int:
    """The reference's per-device bytes of a decode cell's state on the
    single-pod mesh, by its spec rules."""
    cfg = jconfigs.get_config(arch)
    shape = next(s for s in configs.SHAPES if s.name == shape_name)
    ax = JAxes(("data",) if shape.global_batch % 16 == 0 else None, "model")
    state = _ref_state(cfg, shape.global_batch, shape.seq_len)
    sizes = {"data": 16, "model": 16}
    leaves = jax.tree_util.tree_leaves(state)
    spec_leaves = jax.tree_util.tree_leaves(
        jspecs.cache_specs(state, cfg, ax, 16),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, spec in zip(leaves, spec_leaves, strict=True):
        n = 1
        for dim, e in zip(x.shape, tuple(spec) + (None,) * x.ndim):
            names = () if e is None else (e if isinstance(e, tuple) else (e,))
            n *= dim // math.prod(sizes[a] for a in names)
        total += n * x.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_long_500k_decode_cell_comes_back_ok(arch):
    rec = dryrun.run_cell(arch, "long_500k", multi_pod=False)
    assert not torch.distributed.is_initialized()
    assert rec["status"] == "ok", rec
    assert rec["memory"]["cache"] == _ref_cache_bytes(arch, "long_500k")
    assert rec["memory"]["cache"] > 0
    # traced sharded as every family is: the model-parallel bodies'
    # collectives, the per-device peak over the cache's shard
    a = rec["analysis"]
    assert rec["collectives"] == a["collectives"]
    assert a["collectives"]["all-reduce"]["count"] > 0
    assert isinstance(a["bytes"], int) and a["bytes"] > rec["memory"]["cache"]
    assert rec["memory"]["temp_size_in_bytes"] == (
        rec["trace_peak_bytes"] - rec["memory"]["argument_size_in_bytes"])
    assert rec["trace_peak_bytes"] > rec["memory"]["argument_size_in_bytes"]
