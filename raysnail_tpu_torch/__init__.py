"""raysnail_tpu_torch: the raysnail path tracer on PyTorch and CUDA.

The port of the JAX package `raysnail_tpu` to one NVIDIA H100. It mirrors
that package's module names, so each counterpart is found by path; its
kernels are written by hand for Hopper (`csrc/`, wrapped in `ops/`). On CPU
tensors every kernel wrapper runs its plain PyTorch version instead, which
is what the tests compare against the JAX package.

This package imports torch and numpy, never jax.
"""

from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude.vec import Vec3

__version__ = "0.1.0"
__all__ = ["RenderConfig", "Vec3", "__version__"]
