"""Counter-based RNG: the JAX package's two backends, bit for bit.

Every draw is a pure function of (seed, pixel, sample, bounce, purpose,
slot). The port reproduces the JAX package's uint32 streams exactly, so
the same (seed, pixel, sample) sees the same random numbers in both
packages and renders compare pixel for pixel. As in the JAX package,
`fold_all` and `ray_uniforms` dispatch on the shape of the key batch:

  * "fast" (the default): (N,) streams, a murmur3 fmix32 avalanche over
    golden-ratio-separated counters;
  * "threefry": (N, 2) per-ray keys of `jax.random`, Threefry-2x32 with 20
    rounds. `key(seed)` is the key data of `jax.random.PRNGKey(seed)`,
    `fold` is `jax.random.fold_in`, and `ray_uniforms` is
    `jax.random.uniform(k, (n,))` per key, as JAX 0.9.0 draws it with
    `jax_threefry_partitionable = True` (its default): slot i hashes the
    counter pair (0, i) and takes the XOR of the two output words, whose
    top 23 bits become the mantissa of a float in [1, 2), minus 1. With the
    flag off JAX draws other bits; tests/test_torch_scan.py pins the
    version and the flag.

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
_THREEFRY_PARITY = 0x1BD11BDA
_THREEFRY_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32 = 0x3F800000        # the bits of 1.0f


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & MASK
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & MASK
    return x ^ (x >> 16)


def _rotl(x, d: int):
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (`jax._src.prng._threefry2x32_lowering`):
    key words (k1, k2) hash the counter words (x1, x2) -> two words. All
    uint32 values held in int64 tensors (or ints), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _THREEFRY_PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for rot in _THREEFRY_ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, rot) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """The threefry key of `seed`: the (2,) key data of
    `jax.random.PRNGKey(seed)`, [0, seed], for a seed in [0, 2^32)."""
    if not 0 <= seed <= MASK:
        raise ValueError(f"seed must lie in [0, 2^32), got {seed}")
    return torch.tensor([0, int(seed)], dtype=torch.int64, device=device)


def _fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in on a (..., 2) batch of keys: the key hashes the
    counter pair (0, data)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & MASK
    else:
        data = int(data) & MASK
    return torch.stack(threefry2x32(k[..., 0], k[..., 1], 0, data), dim=-1)


def fold(k: torch.Tensor, *tags: int) -> torch.Tensor:
    """Fold integer tags into a threefry key in turn (`jax.random.fold_in`)."""
    for t in tags:
        k = _fold_in(k, t)
    return k


def per_ray_keys(k: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Threefry backend: one key per ray, fold_in(k, id) -> (N, 2)."""
    return _fold_in(k, ids.to(torch.int64))


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
    """Fold an integer tag (a Python int or a per-ray tensor) into keys:
    (N,) fast streams, or (N, 2) threefry keys."""
    if keys.dim() == 2:
        return _fold_in(keys, tag)
    if isinstance(tag, torch.Tensor):
        t = tag.to(torch.int64) & MASK
    else:
        t = int(tag) & MASK
    return _fmix32(keys ^ ((t * _PHI + _FOLD_OFFSET) & MASK))


def ray_uniforms(keys: torch.Tensor, n: int, dtype=torch.float32):
    """n U[0,1) draws per ray -> tuple of n (N,) tensors."""
    if keys.dim() == 2:  # threefry: jax.random.uniform(k, (n,)) per key
        slots = torch.arange(n, dtype=torch.int64, device=keys.device)
        b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], 0, slots)
        bits = ((b1 ^ b2) >> 9) | _ONE_F32
        u = bits.to(torch.int32).view(torch.float32) - 1.0
        return tuple(u[:, i].to(dtype) for i in range(n))
    out = []
    for i in range(n):
        h = _fmix32((keys + (i * _SLOT_STRIDE & MASK)) & MASK)
        out.append((h >> 8).to(dtype) * (1.0 / (1 << 24)))
    return tuple(out)
