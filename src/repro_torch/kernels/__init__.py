"""Hand-written sm_90a kernels (csrc/) with their plain PyTorch versions."""
