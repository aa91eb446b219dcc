"""The dry run's bytes per device on the multi-pod mesh, (pod 2, data 16,
model 16) = 512 fake ranks: every arch's `train_4k` cell against the
reference's spec arithmetic, as `test_torch_dryrun.py` holds the
single-pod mesh (the checks are shared)."""
import pytest

pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from test_torch_dryrun import check_cell_bytes  # noqa: E402


@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_train_cell_bytes_equal_the_reference_multi_pod(arch):
    check_cell_bytes(arch, "train_4k", "multi")
