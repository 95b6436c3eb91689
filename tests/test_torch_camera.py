"""The port's camera and ray generation against the JAX package's.

Tolerance 1e-6 absolute: both compute the same float32 operations in the
same order, but the two frameworks' sin/cos/rsqrt may differ by an ulp, and
ray components are O(1) (origins O(10)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import camera as jcam
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu_torch import camera as tcam
from raysnail_tpu_torch.convert import camera_from_numpy
from raysnail_tpu_torch.prelude import rng as trng

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: see tests/test_torch_sphere_kernel.py for the
    block of rays once computed a few ulps off under the parallel runner."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CAMERAS = [
    dict(look_from=(6.0, 1.0, 2.5), look_at=(0, -0.8, 0), fov=50, aperture=0.01,
         focus_distance=10.0, width=96, height=64),           # example.sdl's
    dict(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=90, width=40, height=30,
         shutter_speed=0.5),
]


def _vec(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], -1)


@pytest.mark.parametrize("kw", CAMERAS)
def test_build_camera(kw):
    jc = jcam.build_camera(**kw)
    tc = tcam.build_camera(**kw, device="cpu")
    for name in ("origin", "lb", "horizontal_full", "vertical_full",
                 "horizontal_unit", "vertical_unit"):
        np.testing.assert_allclose(_vec(getattr(tc, name)), _vec(getattr(jc, name)),
                                   atol=ATOL * 10, err_msg=name)
    assert float(tc.aperture) == pytest.approx(float(jc.aperture))
    assert float(tc.shutter_speed) == pytest.approx(float(jc.shutter_speed))


@pytest.mark.parametrize("kw", CAMERAS)
def test_generate_rays(kw):
    w, h, sqrt_spp = kw["width"], kw["height"], 3
    rng = np.random.default_rng(0)
    n = 5000
    pix = rng.integers(0, w * h, n)
    sid = rng.integers(0, sqrt_spp * sqrt_spp, n)
    px, py = (pix % w).astype(np.float32), (pix // w).astype(np.float32)
    s_i, s_j = (sid % sqrt_spp).astype(np.float32), (sid // sqrt_spp).astype(np.float32)

    jc = jcam.build_camera(**kw)
    jkeys = jrng.fold_all(jrng.fast_streams(jrng.key(7), jnp.asarray(pix, jnp.int32)),
                          jnp.asarray(sid, jnp.int32))
    jr = jcam.generate_rays(jc, *(jnp.asarray(a) for a in (px, py, s_i, s_j)),
                            sqrt_spp, w, h, jkeys)
    # the JAX camera carried over, so only ray generation is compared
    tc = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    tkeys = trng.fold_all(trng.fast_streams(7, torch.from_numpy(pix)), torch.from_numpy(sid))
    tr = tcam.generate_rays(tc, *(torch.from_numpy(a) for a in (px, py, s_i, s_j)),
                            sqrt_spp, w, h, tkeys)
    np.testing.assert_allclose(_vec(tr.origin), _vec(jr.origin), atol=ATOL * 10)
    np.testing.assert_allclose(_vec(tr.direction), _vec(jr.direction), atol=ATOL)
    np.testing.assert_allclose(tr.time.numpy(), np.asarray(jr.time), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(_vec(tr.direction), axis=-1), 1.0, atol=1e-6)
