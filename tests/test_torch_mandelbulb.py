"""The port's Mandelbulb (geometry/mandelbulb.py, ops/mandelbulb_march.py)
against the JAX package's, on the CPU.

The distance estimator is a long chain of separately rounded operations,
and the orbit is chaotic near the set: one ulp early on can move the DE far.
The port's DE runs the JAX package's operations in the JAX package's order,
but the two libraries' sqrt, log and rsqrt round differently, and XLA's
compiled CPU code rounds the chain otherwise than the same code run op by
op. So:
  * against the JAX package run op by op (`jax.disable_jit()`) the DE is
    held tightly: every inside flag equal and at least 0.9 of the values bit
    for bit (reading on 65,536 seeded points: 0.959), within 1e-6 relative
    on 99% and 1e-4 on 99.9% of them (readings 1.9e-7 and 4.0e-5);
  * against jitted JAX only statistically: inside flags equal on at least
    0.999 of the points and a median relative difference below 1e-4
    (readings 0.99995 and 0);
  * the march's hits likewise: against JAX op by op every hit mask equal
    and t bit for bit on 0.99 of the anchor's hits (reading 0.994; on rays
    that start inside the bound, 0.9 with t within 1e-4 relative on 99%:
    reading 0.942), against jitted
    JAX the hit masks equal on 0.999 of the rays and t within 1e-4 relative;
    the normals, a difference quotient of two DEs over 0.02, within 0.02
    (readings 0.0014 op by op, 0.0100 jitted), the uv within 1e-4.
The anchor `mandelbulb` is the end-to-end gate, held with check_anchor's
usual limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.camera import generate_rays as jgenerate_rays
from raysnail_tpu.geometry import mandelbulb as jmb
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu.utils import golden as jgolden
from raysnail_tpu_torch.camera import Ray
from raysnail_tpu_torch.geometry import mandelbulb as tmb
from raysnail_tpu_torch.ops import mandelbulb_march as mm
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.utils import golden

TMIN, TMAX = 1e-3, 3e4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n=4096, seed=7):
    """Points spanning inside, near the surface and outside the r = 1.3
    bound, with the axis-degenerate ones of tests/test_mandelbulb.py."""
    pts = np.random.default_rng(seed).uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    pts[:8, 0:2] = 0.0
    pts[8] = (0.0, 0.0, 0.0)
    return pts


def _tvec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jvec(a):
    return JVec3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-6)


def test_distance_est_matches_jax_run_op_by_op():
    pts = _points(65536)
    de, inside = (x.numpy() for x in tmb.distance_est(_tvec(pts)))
    with jax.disable_jit():
        jde, jinside = (np.asarray(x) for x in jmb.distance_est(_jvec(pts)))
    assert (inside == jinside).all()
    assert (de == jde).mean() >= 0.9, (de == jde).mean()
    rel = _rel(de, jde)
    assert np.quantile(rel, 0.99) <= 1e-6 and np.quantile(rel, 0.999) <= 1e-4, (
        np.quantile(rel, 0.99), np.quantile(rel, 0.999))
    np.testing.assert_allclose(de[:9], jde[:9], rtol=1e-6)  # the axis-degenerate points


def test_distance_est_matches_jitted_jax_statistically():
    pts = _points(65536)
    de, inside = (x.numpy() for x in tmb.distance_est(_tvec(pts)))
    jde, jinside = (np.asarray(x) for x in jax.jit(jmb.distance_est)(_jvec(pts)))
    agree = inside == jinside
    assert agree.mean() >= 0.999, agree.mean()
    assert np.median(_rel(de, jde)[agree]) < 1e-4


def test_distance_est_matches_the_trig_oracle():
    """tests/test_mandelbulb.py's check, on the port: the trig-free DE
    against the literal formula, and the port's literal formula against the
    JAX package's."""
    pts = _points()
    de, inside = (x.numpy() for x in tmb.distance_est(_tvec(pts)))
    tde, tinside = (x.numpy() for x in tmb.distance_est_trig(_tvec(pts)))
    agree = inside == tinside
    assert agree.mean() > 0.995, agree.mean()
    rel = _rel(de[agree], tde[agree])
    assert np.median(rel) < 1e-4 and np.quantile(rel, 0.99) < 1e-2
    np.testing.assert_allclose(de[:9], tde[:9], rtol=1e-4)
    jde, jinside = (np.asarray(x) for x in jax.jit(jmb.distance_est_trig)(_jvec(pts)))
    same = tinside == jinside
    assert same.mean() > 0.995 and np.median(_rel(tde[same], jde[same])) < 1e-4


def test_distance_est_counts_the_iterations_each_point_ran():
    pts = _points(512)
    de, inside, iters = mm.distance_est(*(torch.from_numpy(pts[:, i].copy()) for i in range(3)),
                                        counts=True)
    assert int(iters.min()) >= 1 and int(iters.max()) == mm.DE_ITERATIONS
    assert bool((iters[inside] == mm.DE_ITERATIONS).all())
    # fewer iterations give the same DE to every point that escaped by then
    short, _ = mm.distance_est(*(torch.from_numpy(pts[:, i].copy()) for i in range(3)),
                               iterations=6)
    done = iters <= 6
    assert torch.equal(short[done], de[done])


def _jax_hit(o, d, active=None, eager=False):
    ray = JRay(origin=_jvec(o), direction=_jvec(d), time=jnp.zeros(o.shape[0], jnp.float32))
    node = jmb.MandelbulbNode(mat_id=0)
    act = None if active is None else jnp.asarray(active)
    if eager:
        with jax.disable_jit():
            return node.hit(ray, TMIN, TMAX, active=act)
    return jax.jit(lambda r, a: node.hit(r, TMIN, TMAX, active=a))(ray, act)


def _torch_hit(o, d, active=None):
    ray = Ray(origin=_tvec(o), direction=_tvec(d), time=None)
    act = None if active is None else torch.from_numpy(active)
    return tmb.MandelbulbNode(mat_id=0).hit(ray, TMIN, TMAX, active=act)


def test_hit_and_miss():
    """tests/test_mandelbulb.py's case: a ray toward the bulb along -x hits
    it inside the bounding radius with an outward normal, one away misses."""
    o = np.asarray([[3.0, 0.0, 0.0], [3.0, 0.0, 0.0]], np.float32)
    d = np.asarray([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    h = tmb.MandelbulbNode(mat_id=0).hit(
        Ray(origin=_tvec(o), direction=_tvec(d), time=None), TMIN, 1e30)
    assert bool(h.valid[0]) and not bool(h.valid[1])
    assert 3.0 - 1.3 <= float(h.t[0]) <= 3.0
    assert float(h.normal.x[0]) > 0.5
    assert float(h.t[1]) == float(np.float32(1e30)) and abs(float(h.normal.z[1])) == 1.0


def _anchor_rays():
    """The `mandelbulb` anchor's primary rays (80x48, sample 0), made by the
    JAX package."""
    _, cam, cfg, seed = jgolden.golden_configs()["mandelbulb"]()
    w, h = cfg.width, cfg.height
    p = np.arange(w * h)
    keys = jrng.fold_all(jrng.fast_streams(jrng.key(seed), jnp.asarray(p, jnp.uint32)), 0)
    z = jnp.zeros(w * h, jnp.float32)
    ray = jgenerate_rays(cam, jnp.asarray(p % w, jnp.float32), jnp.asarray(p // w, jnp.float32),
                         z, z, cfg.sqrt_spp, w, h, keys)
    return (np.asarray(ray.origin.to_array(), np.float32),
            np.asarray(ray.direction.to_array(), np.float32))


def _compare(th, jh):
    valid, jvalid = th.valid.numpy(), np.asarray(jh.valid)
    both = valid & jvalid
    t, jt = th.t.numpy()[both], np.asarray(jh.t)[both]
    dn = np.abs(th.normal.to_array().numpy()[both] - np.asarray(jh.normal.to_array())[both])
    duv = np.maximum(np.abs(th.u.numpy() - np.asarray(jh.u)),
                     np.abs(th.v.numpy() - np.asarray(jh.v)))[both]
    return (valid == jvalid).mean(), both.sum(), t, jt, dn.max(initial=0.0), duv.max(initial=0.0)


@pytest.mark.parametrize("eager", [True, False], ids=["op-by-op", "jit"])
def test_hit_matches_jax_on_the_anchor_rays(eager):
    o, d = _anchor_rays()
    agree, n_both, t, jt, dn, duv = _compare(_torch_hit(o, d), _jax_hit(o, d, eager=eager))
    assert n_both > 500
    if eager:
        assert agree == 1.0 and (t == jt).mean() >= 0.99, (agree, (t == jt).mean())
    else:
        assert agree >= 0.999 and np.abs(t - jt).max() <= 1e-4 * jt.max(), agree
    assert dn <= 0.02 and duv <= 1e-4, (dn, duv)


def test_hit_matches_jax_inside_the_bound_and_on_dead_lanes():
    """Rays that start inside the bounding sphere (near and inside the set),
    and a third of the lanes dead."""
    rng = np.random.default_rng(3)
    n = 2048
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) > 1 / 3
    th = _torch_hit(o, d, active)
    agree, n_both, t, jt, dn, duv = _compare(th, _jax_hit(o, d, active, eager=True))
    assert not bool(th.valid.numpy()[~active].any())
    assert n_both > 100 and agree >= 0.995, (n_both, agree)
    exact, rel = (t == jt).mean(), np.quantile(_rel(t, jt), 0.99)
    assert exact >= 0.9 and rel <= 1e-4, (exact, rel)


def test_march_wrapper_takes_the_plain_version_on_the_cpu():
    o, d = _anchor_rays()
    o3, d3 = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    before = mm.mandelbulb_march.launches
    *out, counts = mm.mandelbulb_march(o3, d3, TMIN, TMAX, stats=True)
    plain = mm.mandelbulb_march_plain(o3, d3, TMIN, TMAX)
    assert mm.mandelbulb_march.launches == before  # no kernel on the CPU
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    t, valid = out[0], out[1]
    steps, march_iters, normal_iters = counts
    assert bool((steps[valid] >= 1).all()) and int(steps.max()) <= mm.MAX_STEPS
    assert bool((march_iters >= steps).all()) and bool((march_iters <= 24 * steps).all())
    assert bool((normal_iters[valid] >= 6).all()) and not bool(normal_iters[~valid].any())
    assert bool((t[~valid] == 1e30).all())
    with pytest.raises(ValueError, match="contiguous"):
        mm.mandelbulb_march(o3.T, d3, TMIN, TMAX)


def test_anchor_holds():
    res = golden.check_anchor("mandelbulb", golden.load_golden(), "cpu")
    assert res["dthumb"] <= golden.THUMB_ATOL and res["dmean"] <= golden.MEAN_ATOL


def test_anchor_thumbnail_moves_with_the_camera_division(monkeypatch):
    """Why camera.pixel_uv divides by a tensor: the anchor's thumbnail pins
    the rounding of u = x / width. Rounded as a multiply by the reciprocal
    (what PyTorch's CUDA division by a Python number does), one block moves
    beyond THUMB_ATOL (reading 0.013469; the JAX package run op by op:
    0.013463, tests/mandelbulb_anchor_reading.py)."""
    from mandelbulb_anchor_reading import reciprocal_pixel_uv
    from raysnail_tpu_torch import camera

    golden_stats = golden.load_golden()
    monkeypatch.setattr(camera, "pixel_uv", reciprocal_pixel_uv)
    res = golden.anchor_drift("mandelbulb", golden_stats, "cpu")
    assert res["dthumb"] > golden.THUMB_ATOL and res["blocks_beyond"] == 1, res
    assert res["dmean"] <= golden.MEAN_ATOL
