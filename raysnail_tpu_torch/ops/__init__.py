"""Hand-written CUDA kernels for the hot intersection stages, with their plain PyTorch versions."""
