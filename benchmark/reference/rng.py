"""The renderer's counter-based random numbers, written out plainly: every
draw is a murmur3 fmix32 avalanche of (seed, pixel, sample, bounce,
purpose, slot). uint32 arithmetic is held in int64 and masked after every
multiply and add."""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
PHI = 0x9E3779B9
FOLD_OFFSET = 0x7F4A7C15
SLOT_STRIDE = 0x632BE5AB

# purpose tags
RAYGEN, LENS, SCATTER = 1, 2, 4


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


def streams(seed: int, pixel: torch.Tensor) -> torch.Tensor:
    """The stream of each pixel under a frame seed in [0, 2^32)."""
    base = (int(seed) * PHI) & MASK
    return fmix32(base ^ ((pixel.to(torch.int64) * PHI) & MASK))


def fold(keys: torch.Tensor, tag) -> torch.Tensor:
    """Fold an integer tag (an int or a per-ray tensor) into the keys."""
    t = tag.to(torch.int64) & MASK if isinstance(tag, torch.Tensor) else int(tag) & MASK
    return fmix32(keys ^ ((t * PHI + FOLD_OFFSET) & MASK))


def uniforms(keys: torch.Tensor, n: int, dtype) -> list:
    """n draws in [0, 1) per key: the top 24 bits of slot i's hash."""
    out = []
    for i in range(n):
        h = fmix32((keys + (i * SLOT_STRIDE & MASK)) & MASK)
        out.append((h >> 8).to(dtype) * (1.0 / (1 << 24)))
    return out
