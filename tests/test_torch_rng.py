"""The port's counter-based RNG against the JAX package's fast backend.

Tolerance: none. Every draw of a render is keyed by (seed, pixel, sample,
bounce, purpose), so the port must reproduce the uint32 streams bit for bit;
the render parity tests rest on that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu_torch.prelude import rng as trng

N = 100_000


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())


def test_fmix32_bit_equal():
    x = _ids(1)
    _same(jrng._fmix32(jnp.asarray(x)), trng._fmix32(_t(x)))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**32 - 1])
def test_fast_streams_bit_equal(seed):
    ids = _ids(2)
    _same(jrng.fast_streams(jrng.key(seed), jnp.asarray(ids)), trng.fast_streams(seed, _t(ids)))


def test_purpose_tags_match():
    for name in ("RAYGEN", "LENS", "TIME", "SCATTER", "LIGHT", "MEDIUM", "MIX", "BRANCH"):
        assert getattr(trng, name) == getattr(jrng, name)


def test_seed_range_checked():
    with pytest.raises(ValueError):
        trng.fast_streams(-1, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(ValueError):
        trng.fast_streams(2**32, torch.zeros(1, dtype=torch.int64))


def test_fold_all_bit_equal():
    keys = np.asarray(jrng.fast_streams(jrng.key(7), jnp.asarray(_ids(3))))
    tags = _ids(4)
    # a per-ray tag tensor (sample / bounce ids) and a Python int (purpose tags)
    _same(jrng.fold_all(jnp.asarray(keys), jnp.asarray(tags)), trng.fold_all(_t(keys), _t(tags)))
    for tag in (trng.RAYGEN, trng.LENS, trng.SCATTER, 2**32 - 1):
        _same(jrng.fold_all(jnp.asarray(keys), tag), trng.fold_all(_t(keys), tag))


def test_ray_uniforms_bit_equal():
    keys = np.asarray(jrng.fast_streams(jrng.key(11), jnp.asarray(_ids(5))))
    ju = jrng.ray_uniforms(jnp.asarray(keys), 17)
    tu = trng.ray_uniforms(_t(keys), 17)
    assert len(tu) == 17
    for a, b in zip(ju, tu):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert 0.0 <= float(min(u.min() for u in tu)) and float(max(u.max() for u in tu)) < 1.0
