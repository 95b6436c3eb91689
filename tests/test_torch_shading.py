"""The port's materials, textures and lights against the JAX package's.

The same numpy inputs (normals, directions, hit points, uniforms and table
rows) go to both. Tolerances: selections (material kind, texture row,
checker cell, light pick) exact; directions and densities within 2e-5
relative, except where a power with a large exponent or a near-grazing
cosine amplifies an ulp of the two frameworks' pow/sin/rsqrt, which the
tests bound by a 0.5% share of lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import lights as jlights
from raysnail_tpu import materials as jmat
from raysnail_tpu import textures as jtex
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch import lights as tlights
from raysnail_tpu_torch import materials as tmat
from raysnail_tpu_torch import textures as ttex
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3

N = 4000
RTOL = 2e-5
ATOL = 2e-5
SHARE = 0.005


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: see tests/test_torch_sphere_kernel.py for the
    block of rays once computed a few ulps off under the parallel runner."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jvec(a):
    return JVec3(*(jnp.asarray(np.ascontiguousarray(a[..., i])) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[..., i])) for i in range(3)))


def unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def close(t, j, rtol=RTOL, atol=ATOL, share=0.0):
    """Elementwise |t - j| <= atol + rtol |j| on all but `share` of lanes."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    ok = np.abs(t - j) <= atol + rtol * np.abs(j)
    assert ok.mean() >= 1.0 - share, (ok.mean(), np.abs(t - j).max())


def close_vec(t, j, **kw):
    for a, b in zip((t.x, t.y, t.z), (j.x, j.y, j.z)):
        close(a, b, **kw)


# -- materials ----------------------------------------------------------------

# one row per kind: (mtype, tex_id, param0, param1, emit, phong_factor,
# phong_exponent, mix_prob, mix_a, mix_b)
MAT_ROWS = [
    (jmat.LAMBERTIAN, 0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0, 0),
    (jmat.METAL, 1, 0.0, 0.0, 0.0, 0.4, 20.0, 0.0, 0, 0),
    (jmat.DIFFUSE_METAL, 2, 30.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0, 0),
    (jmat.DIELECTRIC, 0, 1.5, 1.0, 0.0, 0.0, 1.0, 0.0, 0, 0),
    (jmat.BLINN_PHONG, 1, 0.3, 40.0, 0.0, 0.2, 8.0, 0.0, 0, 0),
    (jmat.DIFFUSE_LIGHT, 2, 0.0, 0.0, 1.7, 0.0, 1.0, 0.0, 0, 0),
    (jmat.ISOTROPIC, 0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0, 0),
    (jmat.MIXED, 0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.35, 1, 2),
    (jmat.MIXED, 0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.6, 7, 4),   # nested Mixed
]
ALL_KINDS = frozenset(r[0] for r in MAT_ROWS)


def mat_tables():
    cols = list(zip(*MAT_ROWS))
    ints = lambda c: np.asarray(c, np.int32)
    flts = lambda c: np.asarray(c, np.float32)
    kw = dict(mtype=ints(cols[0]), tex_id=ints(cols[1]), param0=flts(cols[2]),
              param1=flts(cols[3]), emit_mult=flts(cols[4]), phong_factor=flts(cols[5]),
              phong_exponent=flts(cols[6]), mix_prob=flts(cols[7]), mix_a=ints(cols[8]),
              mix_b=ints(cols[9]))
    jt = jmat.MaterialTable(**{k: jnp.asarray(v) for k, v in kw.items()})
    tt = tmat.MaterialTable(**{k: torch.from_numpy(v) for k, v in kw.items()})
    return jt, tt


def shading_inputs(seed):
    rng = np.random.default_rng(seed)
    normal = unit(rng.standard_normal((N, 3)))
    ray_dir = unit(rng.standard_normal((N, 3)))
    # incoming rays face the surface: flip those on the normal's side
    ray_dir = np.where((ray_dir * normal).sum(-1, keepdims=True) > 0, -ray_dir, ray_dir)
    outside = rng.random(N) < 0.7
    uniforms = rng.random((2 * jmat.REJECT_TRIES + 3, N)).astype(np.float32)
    return normal, ray_dir.astype(np.float32), outside, uniforms


@pytest.fixture(scope="module")
def mats():
    jt, tt = mat_tables()
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 7, N).astype(np.int32)  # -1: the world default row
    u_mix = rng.random((2, N)).astype(np.float32)
    jm = jmat.resolve(jt, jnp.asarray(ids), jnp.asarray(u_mix), depth=2)
    tm = tmat.resolve(tt, torch.from_numpy(ids), torch.from_numpy(u_mix), depth=2)
    return jt, tt, jm, tm


def test_resolve_and_gather(mats):
    jt, tt, jm, tm = mats
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    # nested Mixed rows resolve to a non-Mixed kind in two levels
    ids = np.full(N, 8, np.int32)
    u = np.random.default_rng(2).random((2, N)).astype(np.float32)
    res = tmat.resolve(tt, torch.from_numpy(ids), torch.from_numpy(u), depth=2)
    np.testing.assert_array_equal(res.numpy(),
                                  np.asarray(jmat.resolve(jt, jnp.asarray(ids), jnp.asarray(u),
                                                          depth=2)))
    assert not (tt.mtype[res] == tmat.MIXED).any()
    jr, tr = jmat.gather(jt, jm), tmat.gather(tt, tm)
    for name in jmat.Rows._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)))


@pytest.mark.parametrize("kinds", [frozenset({jmat.LAMBERTIAN}), ALL_KINDS],
                         ids=["lambertian-only", "every-kind"])
def test_bsdf_sample(mats, kinds):
    jt, tt, jm, tm = mats
    normal, ray_dir, _, u = shading_inputs(3)
    jd = jmat.bsdf_sample(jmat.gather(jt, jm), jvec(ray_dir), jvec(normal),
                          tuple(jnp.asarray(x) for x in u), kinds)
    td = tmat.bsdf_sample(tmat.gather(tt, tm), tvec(ray_dir), tvec(normal),
                          tuple(torch.from_numpy(x) for x in u), kinds)
    close_vec(td, jd, share=SHARE)


@pytest.mark.parametrize("proper", [False, True], ids=["compat", "proper"])
def test_bsdf_pdf_value(mats, proper):
    jt, tt, jm, tm = mats
    normal, ray_dir, _, _ = shading_inputs(4)
    direction = unit(np.random.default_rng(5).standard_normal((N, 3)))
    jv = jmat.bsdf_pdf_value(jmat.gather(jt, jm), jvec(ray_dir), jvec(normal),
                             jvec(direction), ALL_KINDS, proper=proper)
    tv = tmat.bsdf_pdf_value(tmat.gather(tt, tm), tvec(ray_dir), tvec(normal),
                             tvec(direction), ALL_KINDS, proper=proper)
    close(tv, jv, rtol=1e-4, share=SHARE)


def test_specular_dir_and_emission(mats):
    jt, tt, jm, tm = mats
    normal, ray_dir, outside, u = shading_inputs(6)
    jr, tr = jmat.gather(jt, jm), tmat.gather(tt, tm)
    jd, jabs = jmat.specular_dir(jr, jvec(ray_dir), jvec(normal), jnp.asarray(outside),
                                 jnp.asarray(u[0]), ALL_KINDS)
    td, tabs = tmat.specular_dir(tr, tvec(ray_dir), tvec(normal), torch.from_numpy(outside),
                                 torch.from_numpy(u[0]), ALL_KINDS)
    close_vec(td, jd, share=SHARE)
    np.testing.assert_array_equal(tabs.numpy(), np.asarray(jabs))
    np.testing.assert_array_equal(tmat.is_skip_pdf(tr).numpy(), np.asarray(jmat.is_skip_pdf(jr)))
    color = np.random.default_rng(7).random((N, 3)).astype(np.float32)
    close_vec(tmat.emitted(tr, tvec(color)), jmat.emitted(jr, jvec(color)))
    light = unit(np.random.default_rng(8).standard_normal((N, 3)))
    close(tmat.phong_highlight(tvec(light), tvec(ray_dir), tvec(normal), tr),
          jmat.phong_highlight(jvec(light), jvec(ray_dir), jvec(normal), jr),
          rtol=1e-4, share=SHARE)


def test_absorption_gather():
    jt, tt = mat_tables()
    ab = np.random.default_rng(9).random((len(MAT_ROWS), 3)).astype(np.float32)
    jt, tt = jt._replace(absorb=jvec(ab)), tt._replace(absorb=tvec(ab))
    ids = np.random.default_rng(10).integers(0, len(MAT_ROWS), N).astype(np.int32)
    close_vec(tmat.gather_absorb(tt, torch.from_numpy(ids)),
              jmat.gather_absorb(jt, jnp.asarray(ids)), rtol=0, atol=0)


# -- textures -----------------------------------------------------------------

def tex_tables():
    """Rows: 0 constant, 1 constant, 2 checker of constants, 3 constant,
    4 checker of (checker 2, constant 3) — a nested checker."""
    ttype = np.asarray([jtex.CONSTANT, jtex.CONSTANT, jtex.CHECKER, jtex.CONSTANT,
                        jtex.CHECKER], np.int32)
    c1 = np.asarray([[0.9, 0.5, 0.1], [0.3, 0.3, 0.3], [0.3, 0.3, 0.3], [0.1, 0.2, 0.6],
                     [0, 0, 0]], np.float32)
    c2 = np.asarray([[0, 0, 0], [0, 0, 0], [0.01, 0.01, 0.01], [0, 0, 0], [0, 0, 0]],
                    np.float32)
    scale = np.asarray([1, 1, 10, 1, 3], np.float32)
    child1 = np.asarray([-1, -1, 0, -1, 2], np.int32)
    child2 = np.asarray([-1, -1, 1, -1, 3], np.int32)
    n = len(ttype)
    jt = jtex.TextureTable(ttype=jnp.asarray(ttype), color1=jvec(c1), color2=jvec(c2),
                           scale=jnp.asarray(scale), image_id=jnp.full(n, -1, jnp.int32),
                           depth=jnp.zeros(n, jnp.int32), child1=jnp.asarray(child1),
                           child2=jnp.asarray(child2))
    f = torch.from_numpy
    tt = ttex.TextureTable(ttype=f(ttype), color1=tvec(c1), color2=tvec(c2), scale=f(scale),
                           child1=f(child1), child2=f(child2))
    return jt, tt


@pytest.mark.parametrize("modes", [
    frozenset({jtex.CONSTANT}),
    frozenset({jtex.CONSTANT, jtex.CHECKER}),
    frozenset({jtex.CONSTANT, jtex.CHECKER, jtex.CHECKER_DEEP, ("checker_depth", 2)}),
], ids=["constant", "checker", "deep-checker"])
def test_texture_evaluate(modes):
    jt, tt = tex_tables()
    rng = np.random.default_rng(11)
    hi = 5 if jtex.CHECKER_DEEP in modes else (3 if jtex.CHECKER in modes else 2)
    tid = rng.integers(0, hi, N).astype(np.int32)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    uv = rng.random((2, N)).astype(np.float32)
    jc = jtex.evaluate(jt, jnp.asarray(tid), jnp.asarray(uv[0]), jnp.asarray(uv[1]),
                       jvec(p), modes)
    tc = ttex.evaluate(tt, torch.from_numpy(tid), torch.from_numpy(uv[0]),
                       torch.from_numpy(uv[1]), tvec(p), modes)
    # colors are table entries: a checker cell flipped by an ulp of sin at a
    # cell boundary is the only allowed difference
    close_vec(tc, jc, rtol=0, atol=0, share=SHARE)
    if jtex.CHECKER in modes:
        assert len(np.unique(tc.x.numpy())) >= 3  # both checker cells occur


# -- lights -------------------------------------------------------------------

def light_tables():
    kind = np.asarray([jlights.SPHERE, jlights.RECT_XZ, jlights.SPHERE], np.int32)
    center = np.asarray([[300, 400, 100], [0, 0, 0], [0, 8, -2]], np.float32)
    radius = np.asarray([12, 0, 1.5], np.float32)
    k = np.asarray([0, 5, 0], np.float32)
    a0, a1 = np.asarray([0, -1, 0], np.float32), np.asarray([0, 2, 0], np.float32)
    b0, b1 = np.asarray([0, -3, 0], np.float32), np.asarray([0, 1, 0], np.float32)
    kw = dict(kind=kind, radius=radius, k=k, a0=a0, a1=a1, b0=b0, b1=b1)
    jl = jlights.LightArrays(center=jvec(center), **{n: jnp.asarray(v) for n, v in kw.items()})
    tl = tlights.LightArrays(center=tvec(center), **{n: torch.from_numpy(v) for n, v in kw.items()})
    return jl, tl


KINDS = frozenset({jlights.SPHERE, jlights.RECT_XZ})


@pytest.mark.parametrize("proper", [False, True], ids=["sample", "sample_proper"])
def test_light_sample(proper):
    jl, tl = light_tables()
    rng = np.random.default_rng(12)
    origin = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    u = rng.random((3, N)).astype(np.float32)
    jf = jlights.sample_proper if proper else jlights.sample
    tf = tlights.sample_proper if proper else tlights.sample
    jd = jf(jl, jvec(origin), *(jnp.asarray(x) for x in u), KINDS)
    td = tf(tl, tvec(origin), *(torch.from_numpy(x) for x in u), KINDS)
    # unnormalized directions of length up to ~500: relative tolerance
    close_vec(td, jd, rtol=1e-5, atol=1e-4, share=SHARE)


def test_light_pdf_value():
    jl, tl = light_tables()
    rng = np.random.default_rng(13)
    origin = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    u = rng.random((3, N)).astype(np.float32)
    # directions drawn by the proper sampler land inside the lights' cones
    v = jlights.sample_proper(jl, jvec(origin), *(jnp.asarray(x) for x in u), KINDS)
    d = unit(np.stack([np.asarray(c) for c in (v.x, v.y, v.z)], -1))
    jp = jlights.pdf_value(jl, jvec(origin), jvec(d), KINDS)
    tp = tlights.pdf_value(tl, tvec(origin), tvec(d), KINDS)
    close(tp, jp, rtol=1e-4, share=SHARE)
    assert (tp.numpy() > 0).mean() > 0.9
