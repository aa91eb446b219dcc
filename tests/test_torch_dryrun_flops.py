"""The dry run's FLOP count against the reference's, on the CPU, at smoke
width on bridged parameters: `launch.dryrun.flops_of` (torch's FLOP
counter) over the port's `api.prefill` and over the dry run's train step
(`train_loss`, its backward with the remat recompute, and AdamW, which
adds no counted op) equals `repro.launch.hlo_analysis.analyze(...)
["flops"]` of the reference's compiled 1-device program of the same call
(its prefill; `jax.value_and_grad` of its `train_loss`), one microbatch
on both sides.

The counts are equal for every family's prefill and for the decoder and
encoder-decoder families' training.  Training a recurrent family differs
by a fixed set of products, which the test holds exactly (ROADMAP.md §3):
autograd computes no gradient that nothing needs, where JAX's scan
transpose runs every iteration's products alike.  In zamba2-7b's chunked
SSD scan the first chunk's state is a zero constant and the last chunk's
state feeds nothing in training, so the port skips three inter-chunk
state products a Mamba2 block that the reference's compiled program
runs: 12 products of 131,072 FLOPs at smoke width (4 blocks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import hlo_analysis  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

B, S = 2, 32
# the port's training count less the reference's, from the products above
TRAIN_GAP = {"zamba2-7b": -12 * 131_072}
MEASURED = {("internlm2-1.8b", "prefill"): 22_085_632,
            ("internlm2-1.8b", "train"): 79_691_776}


def _ref_flops(fn, *args) -> float:
    return hlo_analysis.analyze(
        jax.jit(fn).lower(*args).compile().as_text())["flops"]


_CELLS = {}


def _cell(arch):
    """(reference flops, port flops) of the prefill and the train step."""
    if arch in _CELLS:
        return _CELLS[arch]
    jcfg = jconfigs.get_smoke_config(arch).replace(microbatches=1)
    cfg = configs.get_smoke_config(arch).replace(microbatches=1)
    key = jax.random.PRNGKey(0)
    jp = japi.init_model(key, jcfg)
    jd = japi.init_dsg(key, jp, jcfg)
    jin = japi.make_inputs(jcfg, JShape("p", S, B, "prefill"), concrete=True)
    jbatch = japi.make_inputs(jcfg, JShape("t", S, B, "train"),
                              concrete=True)
    ref = {"prefill": _ref_flops(
        lambda p, d, i, c: japi.prefill(p, d, jcfg, i, c), jp, jd, jin,
        japi.make_cache(jcfg, B, S)),
        "train": _ref_flops(jax.value_and_grad(
            lambda p, b: japi.train_loss(p, jd, jcfg, b)), jp, jbatch)}
    model = bridge.model_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu", trainable=True)
    dsg = bridge.dsg_from_jax(jax.tree.map(np.asarray, jd), device="cpu")
    ins = api.make_inputs(cfg, ShapeConfig("p", S, B, "prefill"),
                          concrete=True, device="cpu")
    batch = api.make_inputs(cfg, ShapeConfig("t", S, B, "train"),
                            concrete=True, device="cpu")
    opt = adamw.init_opt(dict(model.named_parameters()),
                         cfg.dtype == "bfloat16")
    port = {"prefill": dryrun.flops_of(lambda: api.prefill(
        model, dsg, cfg, ins, api.make_cache(cfg, B, S, device="cpu"))),
        "train": dryrun.flops_of(lambda: dryrun.train_step(
            model, dsg, opt, cfg, batch, adamw.AdamWConfig()))}
    _CELLS[arch] = ref, port
    return ref, port


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "deepseek-moe-16b",
                                  "zamba2-7b", "whisper-large-v3"])
def test_flops_equal_the_reference_hlo_analysis(arch, kind):
    ref, port = _cell(arch)
    gap = TRAIN_GAP.get(arch, 0) if kind == "train" else 0
    assert port[kind] == ref[kind] + gap, (arch, kind, ref[kind], port[kind])
    if (arch, kind) in MEASURED:
        assert port[kind] == MEASURED[arch, kind]
