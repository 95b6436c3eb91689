"""Framebuffer color handling (reference: src/prelude/color.rs,
vec3.rs:225-240): average the radiance sums, drop non-finite samples,
optional sqrt gamma, and u8 quantization for PNG."""

from __future__ import annotations

import numpy as np
import torch

from raysnail_tpu_torch.prelude.vec import Vec3


def into_color(accum: Vec3, samples, gamma: bool = True) -> Vec3:
    """Average radiance -> display color (vec3.rs:225-240): divide by spp,
    optional sqrt gamma; non-finite samples are dropped to 0."""
    c = accum * (1.0 / samples)
    c = Vec3.where(c.isfinite(), c, Vec3.zeros(c.shape, c.x.dtype, c.x.device))
    c = c.map(lambda v: torch.clamp_min(v, 0.0))
    if gamma:
        c = c.map(torch.sqrt)
    return c


def to_u8(img) -> np.ndarray:
    """[H,W,3] float -> uint8 with the reference's clamp-to-0.999
    quantization (prelude/mod.rs:22-39 clamp + painter u8 conversion)."""
    a = np.nan_to_num(np.asarray(img), nan=0.0, posinf=1.0, neginf=0.0)
    return (np.clip(a, 0.0, 0.999) * 256.0).astype(np.uint8)
