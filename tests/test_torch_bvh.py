"""The port's BVH traversal, host packing, binning and brute triangle sweep
against the JAX package's, on the CPU.

  * `bvh_traverse_plain` (the CUDA kernel's plain version) against the JAX
    kernel `bvh_traverse(..., interpret=True)` on the same packed arrays,
    for the kinds tri, box and sphere, with a ragged ray count, dead lanes
    and a finite t_cap on a third of the rays;
  * the port's compiled BVH and leaf blocks against the JAX compile's,
    exactly (both run the same native builder);
  * the binning destinations against the JAX package's `perm`;
  * `intersect_brute` against the JAX one.

Tolerances. The two traversals walk differently: the JAX kernel walks
128-ray packets in the packet's octant order and sweeps every leaf any ray
of the packet admits; the port walks each ray in its own octant order. Both
find every ray's closest hit within its admission cap, so a result is
compared as the caller sees it, after the min with the group that set
t_cap: a hit beyond t_cap counts as a miss (what each returns there depends
on its visiting order). Hit/miss must agree on all rays but 0.1%; on common
hits t within rtol 1e-5 (XLA and torch round the same f32 formulas, XLA may
reassociate), tri normals within 1e-4, sphere center/radius exact, box u, v
within 1e-4, material equal. Box rays whose two best candidates tie (a
grid's shared face, met often by the sixth of the rays that start inside a
box: 81 of the 1000 rays here) are left out of the attribute check: there
the winner depends on visiting order.
"""

import ast
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu.accel.native import build as jnative
from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.geometry import triangles as jtri
from raysnail_tpu.ops import binning as jbin
from raysnail_tpu.ops import bvh_pallas
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch.accel.native import build as tnative
from raysnail_tpu_torch.camera import Ray as TRay
from raysnail_tpu_torch.convert import scene_arrays_from_numpy
from raysnail_tpu_torch.geometry import triangles as ttri
from raysnail_tpu_torch.ops import binning as tbin
from raysnail_tpu_torch.ops.bvh_traverse import bvh_traverse, bvh_traverse_plain
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder
from raysnail_tpu_torch.scenes.meshes import torus_knot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMIN, TMAX = 1e-3, 1e30
BIG = 1e30
MISS_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- scenes, built identically through both packages' builders --------------

def _knot(ir, n_seg, n_ring):
    v, f, n = torus_knot(n_seg=n_seg, n_ring=n_ring)
    return [ir.Mesh(vertices=v, indices=f, normals=n,
                    material=ir.Lambertian(ir.Constant((0.5, 0.5, 0.5))))]


def _box_field(ir):
    rng = np.random.default_rng(5)
    mat = ir.Lambertian(ir.Constant((0.48, 0.83, 0.53)))
    return [ir.Box((-6.0 + i, 0.0, -6.0 + j), (-5.0 + i, 0.1 + 2.0 * rng.random(), -5.0 + j),
                   mat) for i in range(12) for j in range(12)]


def _sphere_set(ir, n):
    rng = np.random.default_rng(3)
    mats = [ir.Lambertian(ir.Constant((0.2 * k, 0.5, 0.5))) for k in range(4)]
    return [ir.Sphere(tuple(rng.uniform(-4, 4, 3)), 0.15 + 0.05 * (i % 4), mats[i % 4])
            for i in range(n)]


SCENES = {
    "knot-1440": lambda ir: _knot(ir, 60, 12),
    "knot-9600": lambda ir: _knot(ir, 200, 24),
    "boxes-144": _box_field,
    "spheres-96": lambda ir: _sphere_set(ir, 96),
    "spheres-700": lambda ir: _sphere_set(ir, 700),
}


def _compile_both(name):
    jb, tb = JBuilder(), TBuilder()
    for obj in SCENES[name](jir):
        jb.add(obj)
    for obj in SCENES[name](tir):
        tb.add(obj)
    return jb.compile(), tb.compile(device="cpu")


def _assert_same(a, b, where):
    """Port tensors `a` equal port tensors `b`, leaf by leaf and by name."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, TVec3):
        for axis in "xyz":
            _assert_same(getattr(a, axis), getattr(b, axis), f"{where}.{axis}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        for name in a._fields:
            _assert_same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert torch.equal(a, b), where


@pytest.mark.parametrize("name", ["knot-1440", "knot-9600", "boxes-144", "spheres-96"])
def test_packed_bvh_equals_the_jax_compile(name):
    jscene, tscene = _compile_both(name)
    # both sides built their trees with the native builder, not the numpy one
    assert jnative._lib is not None and tnative._lib is not None
    expected = scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    group = {"knot": "triangles", "boxe": "boxes", "sphe": "spheres"}[name[:4]]
    got = getattr(tscene.arrays, group)
    assert got.pk_bb is not None
    _assert_same(got, getattr(expected, group), group)
    if group == "triangles":
        assert tscene.static.tri_brute == jscene.static.tri_brute
        assert got.pk_bb.shape[0] == 8  # octant orders under the node cap


def test_book1_scene_equals_the_jax_compile():
    """The port's book1 balls (the book1-spherebvh anchor's scene): the same
    draw, tables and packed sphere BVH as the JAX compile."""
    from raysnail_tpu.scenes import book1 as jbook1
    from raysnail_tpu_torch.scenes import book1 as tbook1

    jarrays = jax.tree_util.tree_map(np.asarray, jbook1.balls_scene(7).compile().arrays)
    got = tbook1.balls_scene(7).compile(device="cpu").arrays
    assert got.spheres.pk_bb is not None
    _assert_same(got, scene_arrays_from_numpy(jarrays, "cpu"), "book1")


def test_small_groups_stay_unpacked():
    jb, tb = JBuilder(), TBuilder()
    for b, ir in ((jb, jir), (tb, tir)):
        for obj in _sphere_set(ir, 63) + _box_field(ir)[:129]:
            b.add(obj)
    tscene = tb.compile(device="cpu")
    assert tscene.arrays.spheres.pk_bb is None and tscene.arrays.boxes.pk_bb is None
    assert jb.compile().arrays.spheres.pk_bb is None


# -- the traversal: plain version vs the interpret-mode TPU kernel ----------

def _rays(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "tri":
        o = rng.uniform(-3, 3, (n, 3))
        d = rng.standard_normal((n, 3))
        # half of them aimed at the knot, from a camera-like distance
        o[: n // 2] = rng.uniform(-0.5, 0.5, (n // 2, 3)) + (0.0, 1.5, 4.0)
        d[: n // 2] = rng.uniform(-0.4, 0.4, (n // 2, 3)) - o[: n // 2] * 0.25
    elif kind == "box":
        o = rng.uniform(-8, 8, (n, 3))
        o[:, 1] = rng.uniform(0.5, 6.0, n)
        d = rng.standard_normal((n, 3))
        # a sixth start inside box (0, 0) of the grid (box.rs:131-134)
        k = n // 6
        o[:k] = rng.uniform(-5.9, -5.1, (k, 3))
        o[:k, 1] = rng.uniform(0.01, 0.09, k)
    else:
        o = rng.uniform(-6, 6, (n, 3))
        d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cap = np.full(n, BIG)
    third = rng.permutation(n)
    cap[third[: n // 3]] = rng.uniform(0.5, 6.0, n // 3)     # a finite t_cap
    cap[third[n // 3: n // 3 + n // 10]] = -1.0                # dead lanes
    return o.astype(np.float32), d.astype(np.float32), cap.astype(np.float32)


def _jax_traverse(o, d, cap, pk, kind):
    """The JAX kernel in interpret mode; its wrapper wants N % TILE_R == 0,
    so the tail is padded with dead lanes."""
    n = o.shape[0]
    pad = (-n) % bvh_pallas.TILE_R

    def col(a, fill=0.0):
        return jnp.asarray(np.concatenate([a, np.full(pad, fill, np.float32)]))

    out = bvh_pallas.bvh_traverse(
        tuple(col(o[:, i]) for i in range(3)), tuple(col(d[:, i]) for i in range(3)),
        col(cap, -1.0), *pk, jnp.float32(TMIN), jnp.float32(TMAX), kind=kind,
        interpret=True)
    return [np.asarray(a)[:n] for a in out]


def _box_ties(o, d, group):
    """Rays whose two best box candidates tie exactly (dense numpy, f32)."""
    lo = np.stack([group.p_min.x, group.p_min.y, group.p_min.z], 1).astype(np.float32)
    hi = np.stack([group.p_max.x, group.p_max.y, group.p_max.z], 1).astype(np.float32)
    dd = np.where(np.abs(d) < 1e-12, np.where(d < 0, -1e-12, 1e-12), d).astype(np.float32)
    inv = (np.float32(1.0) / dd)[:, None, :]
    ta = (lo[None] - o[:, None, :]) * inv
    tb = (hi[None] - o[:, None, :]) * inv
    near = np.minimum(ta, tb).max(2)
    far = np.maximum(ta, tb).min(2)
    ok = near < far
    near_in = ok & (near > TMIN)
    far_in = ok & (far > TMIN)
    t = np.where(near_in, near, np.where(far_in, far, np.inf))
    t.sort(axis=1)
    return np.isfinite(t[:, 0]) & (t[:, 0] == t[:, 1])


@pytest.mark.parametrize("kind,scene", [("tri", "knot-1440"), ("box", "boxes-144"),
                                        ("sphere", "spheres-700")])
def test_plain_traversal_matches_the_jax_kernel(kind, scene):
    jscene, tscene = _compile_both(scene)
    group = {"tri": "triangles", "box": "boxes", "sphere": "spheres"}[kind]
    tg = getattr(tscene.arrays, group)
    pk = (tg.pk_bb, tg.pk_links, getattr(tg, {"tri": "pk_tri", "box": "pk_box",
                                              "sphere": "pk_sph"}[kind]))
    n = 1000  # ragged: neither a multiple of 128 nor of the JAX tile
    o, d, cap = _rays(kind, n, seed=len(scene))

    jt, *jattrs = _jax_traverse(o, d, cap, [jnp.asarray(a.numpy()) for a in pk], kind)
    cols = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))
    out = bvh_traverse(cols(o), cols(d), torch.from_numpy(cap), *pk, TMIN, TMAX, kind=kind)
    tt, *tattrs = (a.numpy() for a in out)

    dead = cap <= 0
    assert (jt[dead] == BIG).all() and (tt[dead] == BIG).all()
    assert all((a[dead] == 0).all() for a in tattrs)
    seen = lambda t: (t < BIG) & (t <= cap)  # a hit the caller keeps
    jh, th = seen(jt), seen(tt)
    assert (jh != th).mean() <= MISS_SHARE, (jh != th).sum()
    both = jh & th
    assert both.sum() > n // 10
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
    keep = both
    if kind == "box":
        ties = _box_ties(o, d, jscene.arrays.boxes)
        keep = both & ~ties
        assert keep.sum() > n // 5, (ties.sum(), keep.sum())
    jmat, tmat = jattrs[4], tattrs[4]
    np.testing.assert_array_equal(tmat[keep], jmat[keep])
    ja, ta = np.stack(jattrs[:4], 1)[keep], np.stack(tattrs[:4], 1)[keep]
    if kind == "tri":
        np.testing.assert_allclose(ta[:, :3], ja[:, :3], atol=1e-4)
        assert (ta[:, 3] == 0).all()
    elif kind == "sphere":
        np.testing.assert_array_equal(ta, ja)
    else:
        np.testing.assert_array_equal(ta[:, :2], ja[:, :2])      # face axis, entry flag
        np.testing.assert_allclose(ta[:, 2:], ja[:, 2:], atol=1e-4)


def test_traversal_checks_its_inputs():
    _, tscene = _compile_both("spheres-96")
    g = tscene.arrays.spheres
    o = tuple(torch.zeros(10) for _ in range(3))
    cap = torch.full((10,), BIG)
    with pytest.raises(ValueError, match="contiguous"):
        bvh_traverse(tuple(torch.zeros(20)[::2] for _ in range(3)), o, cap, g.pk_bb,
                     g.pk_links, g.pk_sph, TMIN, TMAX, kind="sphere")
    with pytest.raises(ValueError, match="pk_links"):
        bvh_traverse(o, o, cap, g.pk_bb, g.pk_links.long(), g.pk_sph, TMIN, TMAX,
                     kind="sphere")
    with pytest.raises(ValueError, match="pk_prim"):  # a sphere block is not a tri block
        bvh_traverse(o, o, cap, g.pk_bb, g.pk_links, g.pk_sph, TMIN, TMAX, kind="tri")


def test_plain_traversal_is_reached_only_from_cpu_tensors():
    """The wrapper calls its plain version in one place, under the CPU
    branch, and nothing in the package catches an exception around it."""
    calls, handlers = [], []
    ops = os.path.join("raysnail_tpu_torch", "ops", "bvh_traverse.py")
    for path in glob.glob(os.path.join(REPO, "raysnail_tpu_torch", "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == \
                    "bvh_traverse_plain":
                calls.append(os.path.relpath(path, REPO))
            if isinstance(node, ast.ExceptHandler) and path.endswith(ops):
                handlers.append(node.lineno)
    assert calls == [ops] and not handlers, (calls, handlers)


# -- binning ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["entry", "dir", "miss", "entrydir"])
def test_binning_destinations_equal_jax_perm(mode):
    rng = np.random.default_rng(12)
    n = 2 * jbin.B
    o = rng.uniform(-3, 3, (3, n)).astype(np.float32)
    d = rng.standard_normal((3, n)).astype(np.float32)
    cap = np.full(n, BIG, np.float32)
    cap[:700] = -1.0
    cap[700:900] = 0.0
    bb = np.asarray([-1, -1, -1, 1, 1, 1], np.float32)
    jk = jbin.keys(*(jnp.asarray(a) for a in (*o, *d, cap)), jnp.asarray(bb),
                   jnp.float32(TMIN), mode)
    tk = tbin.keys(*(torch.from_numpy(a) for a in (*o, *d, cap)), torch.from_numpy(bb),
                   TMIN, mode)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    p = np.asarray(jbin.perm(jk, jbin.MODE_KEYS[mode]))          # (G, B, B) one-hot
    jdest = (p.argmax(axis=2) + np.arange(p.shape[0])[:, None] * jbin.B).reshape(-1)
    tdest = tbin.dest(tk, tbin.MODE_KEYS[mode])
    np.testing.assert_array_equal(tdest.numpy(), jdest)
    x = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)) for _ in range(3)]
    y = tbin.apply(tdest, x)
    ys = np.asarray(jbin.apply(jnp.asarray(p), [jnp.asarray(a.numpy()) for a in x]))
    for a, b in zip(y, ys):
        np.testing.assert_array_equal(a.numpy(), b)
    for a, b in zip(tbin.unapply(tdest, y), x):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bin_mode", ["never", "entry"])
def test_kernel_route_agrees_with_brute(bin_mode):
    """Through `intersect_kernel` (binned or not) a mesh gives the same
    closest hits as the dense sweep."""
    _, tscene = _compile_both("knot-1440")
    g = tscene.arrays.triangles
    o, d, _ = _rays("tri", 700, seed=4)
    ray = TRay(TVec3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])) for i in range(3))),
               TVec3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])) for i in range(3))),
               None)
    hb = ttri.intersect_brute(g, ray, TMIN, TMAX)
    hk = ttri.intersect_kernel(g, ray, TMIN, TMAX, bin_mode=bin_mode)
    assert torch.equal(hb.valid, hk.valid)
    v = hb.valid
    assert int(v.sum()) > 100
    torch.testing.assert_close(hk.t[v], hb.t[v], rtol=1e-6, atol=0)
    torch.testing.assert_close(hk.normal.to_array()[v], hb.normal.to_array()[v],
                               rtol=0, atol=1e-5)
    assert torch.equal(hk.mat_id, hb.mat_id)


# -- the dense triangle sweep ------------------------------------------------

def test_brute_matches_jax():
    jscene, tscene = _compile_both("knot-1440")
    o, d, _ = _rays("tri", 500, seed=9)
    jray = JRay(JVec3.from_array(jnp.asarray(o)), JVec3.from_array(jnp.asarray(d)),
                jnp.zeros(len(o), jnp.float32))
    jh = jtri.intersect_brute(jscene.arrays.triangles, jray, jnp.float32(TMIN),
                              jnp.float32(TMAX))
    ray = TRay(TVec3(*(torch.from_numpy(np.ascontiguousarray(o[:, i])) for i in range(3))),
               TVec3(*(torch.from_numpy(np.ascontiguousarray(d[:, i])) for i in range(3))),
               None)
    th = ttri.intersect_brute(tscene.arrays.triangles, ray, TMIN, TMAX)
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    assert valid.sum() > 100
    np.testing.assert_allclose(th.t.numpy()[valid], np.asarray(jh.t)[valid], rtol=1e-5)
    np.testing.assert_allclose(th.normal.to_array().numpy()[valid],
                               np.asarray(jh.normal.to_array())[valid], atol=1e-4)
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
