"""The port's HBM bytes a device against the reference's, cell by cell, at
the smoke width of `tests/test_torch_dryrun_collectives.py` (f32, a (data
2, model 2) mesh, B 8 x S 32): the reference's `hlo_analysis.analyze` of
its compiled sharded step on a 4-device host mesh, in a subprocess,
against `launch.dryrun.trace_sharded` on rank 0 of a 4-rank fake group.
Prints one line a family: train / prefill / decode ratios and both byte
counts.  Host CPU only (~3 min):

  PYTHONPATH=src:tests JAX_PLATFORMS=cpu python scripts/dryrun_byte_ratios.py
"""
import tempfile
from pathlib import Path

import test_torch_dryrun_collectives as cells
import torch_mesh_harness as mh


def main() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        ref, _ = mh.run(Path(tmp), cells.REF, 4, cells.RANKS, 2,
                        timeout=900)
    for arch in cells.ARCHS + cells.RECURRENT:
        want = [int(ref[arch, k]["bytes"]) for k in cells.KINDS]
        got = [cells._port(arch, k)["bytes"] for k in cells.KINDS]
        ratios = " / ".join(f"{g / w:.2f}" for g, w in zip(got, want))
        print(f"{arch}: port / reference {ratios} ({got} against {want})",
              flush=True)


if __name__ == "__main__":
    main()
