"""Counter-based RNG: the JAX package's "fast" backend, bit for bit.

Every draw is a pure function of (seed, pixel, sample, bounce, purpose,
slot): a murmur3 fmix32 avalanche over golden-ratio-separated counters. The
port reproduces the JAX package's uint32 streams exactly, so the same
(seed, pixel, sample) sees the same random numbers in both packages and
renders compare pixel for pixel.

uint32 arithmetic is emulated in int64 with a mask after every multiply and
add: torch has no `>>` or `+` for uint32 on the CPU. A product of two
values below 2^32 can wrap in int64, but the wrap is modulo 2^64, so its
low 32 bits are right. The same code runs on CUDA tensors.
"""

from __future__ import annotations

import torch

# purpose tags (folded into keys so draws for different uses are independent)
RAYGEN = 1
LENS = 2
TIME = 3
SCATTER = 4
LIGHT = 5
MEDIUM = 6
MIX = 7
BRANCH = 8

MASK = 0xFFFFFFFF
_PHI = 0x9E3779B9          # 2^32 / golden ratio
_FOLD_OFFSET = 0x7F4A7C15
_SLOT_STRIDE = 0x632BE5AB


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


def fast_streams(seed: int, ids: torch.Tensor) -> torch.Tensor:
    """(N,) streams from an integer seed in [0, 2^32) and ray identities
    (int64 holding uint32). The JAX package digests the key data of
    `PRNGKey(seed)`, which is [0, seed], to the base 0 ^ seed * PHI."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    base = (int(seed) * _PHI) & MASK
    ids = ids.to(torch.int64) & MASK
    return _fmix32(base ^ ((ids * _PHI) & MASK))


def fold_all(keys: torch.Tensor, tag) -> torch.Tensor:
    """Fold an integer tag (a Python int or a per-ray tensor) into keys."""
    if isinstance(tag, torch.Tensor):
        t = tag.to(torch.int64) & MASK
    else:
        t = int(tag) & MASK
    return _fmix32(keys ^ ((t * _PHI + _FOLD_OFFSET) & MASK))


def ray_uniforms(keys: torch.Tensor, n: int, dtype=torch.float32):
    """n U[0,1) draws per ray -> tuple of n (N,) tensors."""
    out = []
    for i in range(n):
        h = _fmix32((keys + (i * _SLOT_STRIDE & MASK)) & MASK)
        out.append((h >> 8).to(dtype) * (1.0 / (1 << 24)))
    return tuple(out)
