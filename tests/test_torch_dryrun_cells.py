"""Full-width dry-run cells, on the CPU: `launch.dryrun.run_cell` of
internlm2-1.8b x train_4k on the single-pod mesh (256 fake ranks), whole,
its sharded step traced as rank 0 runs it, its peak under one card's
80 GB and below the peak of the loss that gathered the logits by at
least their global buffer;
and 8d's llava-next-34b x prefill_32k, its layout at full depth against
the reference's spec arithmetic (params, DSG state, inputs and the
32k-slot cache) and its step traced at one of its 60 layers (full width,
the shape's global size).  A whole 60-layer trace of a 32k-token prefill
runs the chunked attention's 1024 tiles a layer and takes about 20
minutes here; `python -m repro_torch.launch.dryrun --all` runs it
(PERF.md).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_torch_dryrun import check_cell_bytes  # noqa: E402

# forward + backward of internlm2-1.8b at 256 x 4096, remat included
INTERNLM2_TRAIN_4K_FLOPS = 16.656e15
# the cell's traced per-device peak when the sharded loss gathered the
# vocab-sharded logits over 'model' (its backward then held the
# microbatch's whole logits on every rank; PERF.md section 6)
GATHERED_LOSS_PEAK = 247_936_165_388
DEVICE_BYTES = 80e9               # one H100's memory


def _parts(mem) -> int:
    return sum(mem[k] for k in ("params", "dsg", "opt", "inputs", "cache"))


def test_internlm2_train_4k_cell():
    rec = dryrun.run_cell("internlm2-1.8b", "train_4k", multi_pod=False)
    assert not torch.distributed.is_initialized()
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["flops"] == pytest.approx(INTERNLM2_TRAIN_4K_FLOPS, rel=1e-3)
    assert rec["flops_per_device_ideal"] == rec["flops"] / 256
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _parts(mem)
    assert mem["cache"] == 0 and mem["opt"] > 0 and mem["params"] > 0
    # the sharded step traced on rank 0: its data shard's batch, its
    # shards, activations, gradients and collective buffers
    assert rec["trace_batch"] == 16
    assert rec["trace_peak_bytes"] > mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] == (rec["trace_peak_bytes"]
                                         - mem["argument_size_in_bytes"])
    a = rec["analysis"]
    assert rec["collectives"] == a["collectives"] and rec["trace_s"] > 0
    assert set(a["collectives"]) == {"all-reduce", "all-gather",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute"}
    assert all(set(v) == {"bytes", "count", "f32_bytes"}
               for v in a["collectives"].values())
    assert a["collective_total_bytes"] == sum(
        v["bytes"] for v in a["collectives"].values()) > 0
    assert rec["flops"] / 256 <= a["flops"] < rec["flops"]
    # HBM bytes by the reference's top-level convention: every shard of
    # the state is read at least once (AdamW reads and writes its own)
    assert isinstance(a["bytes"], int)
    assert a["bytes"] > 2 * mem["argument_size_in_bytes"]
    # the vocab-parallel loss: no rank holds the global logits, a
    # microbatch's rows x 4096 x vocab in f32, any more
    cfg = configs.get_config("internlm2-1.8b")
    logits = 256 // cfg.microbatches * 4096 * cfg.vocab * 4
    assert logits == 128 * 4096 * 92544 * 4
    assert GATHERED_LOSS_PEAK - rec["trace_peak_bytes"] >= logits
    assert rec["trace_peak_bytes"] < DEVICE_BYTES


def test_llava_prefill_32k_cell():
    check_cell_bytes("llava-next-34b", "prefill_32k", "single")
    rec = dryrun.run_cell("llava-next-34b", "prefill_32k", multi_pod=False,
                          overrides=["n_layers=1"])
    assert not torch.distributed.is_initialized()
    assert rec["status"] == "ok" and rec["overrides"] == ["n_layers=1"]
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == _parts(mem) and mem["opt"] == 0
    assert mem["cache"] > 0 and mem["inputs"] > 0
    assert rec["flops"] > 0 and rec["trace_batch"] == 2
    assert rec["trace_peak_bytes"] > mem["cache"]
