"""Registers the `cuda` marker: tests that need a CUDA device carry it and
skip without one.  Run them on a machine with the card with
`PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py`."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips on a machine without one)")
