"""repro_torch — the PyTorch/CUDA port of `repro` for one NVIDIA H100.

The JAX package `repro` is the reference; this package computes the same
functions with plain PyTorch around hand-written sm_90a kernels
(`repro_torch/csrc/`).  It never imports `jax` or `repro`.
"""
__version__ = "0.1.0"
