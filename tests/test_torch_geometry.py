"""The port's box intersection and hit combination against the JAX package's.

Tolerances: validity, winner (mat id) and entry side exact; t
within rtol 1e-6 and normals/uv within 1e-5 (the same float32 operations in
the same order; XLA may fuse a product-sum with other rounding). A
parallel-to-a-face ray can make either framework's ulp pick another face,
so the comparisons allow a 0.5% share of rays to differ where noted.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.geometry import boxes as jbox
from raysnail_tpu.geometry import hit as jhit
from raysnail_tpu.geometry import transforms as jtf
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch.camera import Ray as TRay
from raysnail_tpu_torch.geometry import boxes as tbox
from raysnail_tpu_torch.geometry import hit as thit
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread: see tests/test_torch_sphere_kernel.py for the
    block of rays once computed a few ulps off under the parallel runner."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TMIN, TMAX = 1e-3, 3e4


def jvec(a):
    return JVec3(*(jnp.asarray(np.ascontiguousarray(a[..., i])) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[..., i])) for i in range(3)))


def box_case(seed, n_boxes, n_rays, oriented, inside=False):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-6, 4, (n_boxes, 3)).astype(np.float32)
    hi = (lo + rng.uniform(0.5, 3, (n_boxes, 3))).astype(np.float32)
    mats = rng.integers(0, 9, n_boxes).astype(np.int32)
    if inside:  # rays start inside box 0 (the far face is the surface)
        o = (lo[0] + (hi[0] - lo[0]) * rng.uniform(0.2, 0.8, (n_rays, 3))).astype(np.float32)
    else:
        o = rng.uniform(-12, 12, (n_rays, 3)).astype(np.float32)
    target = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rots = offs = None
    if oriented:
        rots, offs = [], []
        for i in range(n_boxes):
            if i % 2:  # mix oriented and axis-aligned boxes, as scene compile does
                a, b, c = rng.uniform(-0.7, 0.7, 3)
                m = (jtf.translate(rng.uniform(-1, 1, 3)) @ jtf.rotate_x(a) @ jtf.rotate_y(b)
                     @ jtf.rotate_z(c))
                r, f = jtf.inverse_rows(m)
            else:
                r, f = np.eye(3), np.zeros(3)
            rots.append(r)
            offs.append(f)
        rots = np.asarray(rots, np.float32)
        offs = np.asarray(offs, np.float32)
    return lo, hi, mats, o, d.astype(np.float32), rots, offs


def both_groups(lo, hi, mats, rots, offs):
    n = len(mats)
    jg = jbox.BoxGroup(p_min=jvec(lo), p_max=jvec(hi), mat_id=jnp.asarray(mats),
                       active=jnp.ones(n, bool),
                       inv_rows=None if rots is None else tuple(jvec(rots[:, i]) for i in range(3)),
                       inv_off=None if rots is None else jvec(offs))
    tg = tbox.BoxGroup(p_min=tvec(lo), p_max=tvec(hi), mat_id=torch.from_numpy(mats),
                       active=torch.ones(n, dtype=torch.bool),
                       inv_rows=None if rots is None else tuple(tvec(rots[:, i]) for i in range(3)),
                       inv_off=None if rots is None else tvec(offs))
    return jg, tg


def assert_hits_match(th, jh, share=0.005):
    valid = np.asarray(jh.valid)
    assert (th.valid.numpy() != valid).mean() <= share
    both = valid & th.valid.numpy()
    same = both & (th.mat_id.numpy() == np.asarray(jh.mat_id))
    assert (both & ~same).sum() <= share * len(valid)
    np.testing.assert_allclose(th.t.numpy()[same], np.asarray(jh.t)[same], rtol=1e-6)
    np.testing.assert_array_equal(th.outside.numpy()[same], np.asarray(jh.outside)[same])
    for a, b in ((th.normal.x, jh.normal.x), (th.normal.y, jh.normal.y),
                 (th.normal.z, jh.normal.z), (th.u, jh.u), (th.v, jh.v)):
        close = np.abs(a.numpy()[same] - np.asarray(b)[same]) <= 1e-5
        assert close.mean() >= 1 - share
    return both.sum()


@pytest.mark.parametrize("oriented", [False, True], ids=["axis-aligned", "oriented"])
@pytest.mark.parametrize("inside", [False, True], ids=["outside-start", "inside-start"])
def test_boxes_match_jax(oriented, inside):
    lo, hi, mats, o, d, rots, offs = box_case(5 + oriented + 2 * inside, 12, 3000,
                                              oriented, inside)
    jg, tg = both_groups(lo, hi, mats, rots, offs)
    jh = jbox.intersect(jg, JRay(jvec(o), jvec(d), jnp.zeros(len(o))), jnp.float32(TMIN),
                        jnp.float32(TMAX))
    th = tbox.intersect(tg, TRay(tvec(o), tvec(d), None), TMIN, TMAX)
    n_hits = assert_hits_match(th, jh)
    assert n_hits > 300
    if inside and not oriented:
        # started inside box 0: those rays leave it through a back face
        assert (~th.outside.numpy()).sum() > 0


def test_box_slab_head_on():
    """A ray down -z onto a unit box: entry face +z at t=4, outward normal."""
    tg = tbox.BoxGroup(p_min=tvec(np.array([[-1, -1, -6]], np.float32)),
                       p_max=tvec(np.array([[1, 1, -4]], np.float32)),
                       mat_id=torch.tensor([3], dtype=torch.int32),
                       active=torch.ones(1, dtype=torch.bool))
    ray = TRay(tvec(np.array([[0.2, 0.3, 0.0]], np.float32)),
               tvec(np.array([[0, 0, -1]], np.float32)), None)
    h = tbox.intersect(tg, ray, TMIN, TMAX)
    assert bool(h.valid[0]) and float(h.t[0]) == pytest.approx(4.0)
    assert [float(h.normal.x[0]), float(h.normal.y[0]), float(h.normal.z[0])] == [0, 0, 1]
    assert int(h.mat_id[0]) == 3 and bool(h.outside[0])


def test_combine_hits_matches_jax():
    rng = np.random.default_rng(2)
    n = 1000

    def rand_hit(seed):
        r = np.random.default_rng(seed)
        valid = r.random(n) < 0.6
        t = np.where(valid, r.uniform(0.1, 10, n), 1e30).astype(np.float32)
        nrm = r.standard_normal((n, 3)).astype(np.float32)
        u, v = r.random(n).astype(np.float32), r.random(n).astype(np.float32)
        mat = r.integers(-1, 5, n).astype(np.int32)
        out = r.random(n) < 0.5
        return t, valid, nrm, u, v, mat, out

    def jh(h):
        t, valid, nrm, u, v, mat, out = h
        return jhit.Hit(jnp.asarray(t), jnp.asarray(valid), jvec(nrm), jnp.asarray(u),
                        jnp.asarray(v), jnp.asarray(mat), jnp.asarray(out))

    def th(h):
        t, valid, nrm, u, v, mat, out = h
        f = torch.from_numpy
        return thit.Hit(f(t), f(valid), tvec(nrm), f(u), f(v), f(mat), f(out))

    a, b = rand_hit(rng.integers(1 << 30)), rand_hit(rng.integers(1 << 30))
    jc = jhit.combine_hits(jh(a), jh(b))
    tc = thit.combine_hits(th(a), th(b))
    for name in ("t", "valid", "u", "v", "mat_id", "outside"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    for c in "xyz":
        np.testing.assert_array_equal(getattr(tc.normal, c).numpy(),
                                      np.asarray(getattr(jc.normal, c)))
    m = thit.miss((4,))
    assert (m.t.numpy() == np.float32(1e30)).all() and not m.valid.any()
    assert (m.mat_id.numpy() == -1).all() and m.outside.all()
