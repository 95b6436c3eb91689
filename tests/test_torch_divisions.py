"""Divisions by a constant on the port's render path, on the CPU.

`prelude.vec.div_const` divides by a tensor full of the constant, so that
the card rounds the quotient as one IEEE division (PyTorch's CUDA division
by a Python number multiplies by the reciprocal; tests/test_torch_cuda.py
holds the card's results to the CPU's bit for bit). On the CPU it is the
same division as before: bit for bit the quotient by the Python number.
Against the JAX package the functions that take it keep the tolerances of
their own files: uv within 1e-5 (tests/test_torch_geometry.py), the
shading's rtol and atol 2e-5 and the light pdf's rtol 1e-4
(tests/test_torch_shading.py), a Vec3 quotient within one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import lights as jlights
from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.prelude.sampling import PI as JPI
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch import lights as tlights
from raysnail_tpu_torch import materials as tmat
from raysnail_tpu_torch.geometry import spheres as tsph
from raysnail_tpu_torch.prelude.vec import Vec3, div_const
from test_torch_shading import ATOL, KINDS, RTOL, light_tables

N = 4099


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a):
    return (Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))),
            JVec3(*(jnp.asarray(a[:, i]) for i in range(3))))


@pytest.mark.parametrize("c", [3.0, 7, 2.0 * np.pi, np.pi, 0.1, 4.0])
def test_div_const_is_the_cpus_division_by_the_number(c):
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(N).astype(np.float32) * 1e3)
    assert torch.equal(div_const(a, c), a / c)


def test_sphere_uv_matches_jax():
    tv, jv = _pair(np.random.default_rng(2).standard_normal((N, 3)).astype(np.float32))
    for t, j in zip(tsph.sphere_uv(tv), jsph.sphere_uv(jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_lobe_matches_jax():
    """The Phong lobe's density (e + 1) / (2 pi) cos^e, as the JAX package's
    materials write it inline."""
    rng = np.random.default_rng(3)
    e = rng.uniform(0.0, 500.0, N).astype(np.float32)
    cos_r = rng.uniform(-0.1, 1.0, N).astype(np.float32)
    want = (jnp.asarray(e) + 1.0) / (2.0 * JPI) * jnp.power(
        jnp.maximum(jnp.asarray(cos_r), 1e-12), jnp.asarray(e))
    got = tmat._lobe(torch.from_numpy(e), torch.from_numpy(cos_r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_light_pdf_of_three_lights_matches_jax():
    jl, tl = light_tables()
    rng = np.random.default_rng(4)
    origin = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    u = rng.random((3, N)).astype(np.float32)
    to, jo = _pair(origin)
    d = tlights.sample_proper(tl, to, *(torch.from_numpy(x) for x in u), KINDS).unit()
    dn = np.stack([c.numpy() for c in d], -1)
    td, jd = _pair(dn)
    got = tlights.pdf_value(tl, to, td, KINDS)
    want = jlights.pdf_value(jl, jo, jd, KINDS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    assert int(tl.kind.shape[0]) == 3 and (got.numpy() > 0).mean() > 0.5


@pytest.mark.parametrize("c", [3.0, 7])
def test_vec3_divided_by_a_number_matches_jax(c):
    tv, jv = _pair(np.random.default_rng(5).standard_normal((N, 3)).astype(np.float32))
    jq = jv / c
    for t, j in zip(tv / c, (jq.x, jq.y, jq.z)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1.2e-7)
