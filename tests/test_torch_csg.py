"""The port's CSG (geometry/csg.py, spheres and boxes' interval support,
scene compile of CSG objects) against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, handed to both packages. Against the
JAX functions run op by op (jax.disable_jit: every product rounded on its
own, as the port rounds): `valid`, `mat_id` and `outside` equal, t within
rtol 1e-6 (on every lane: the nodes compare and select the values of
lanes that miss, so those must agree too), normals and uv within atol 1e-5.
Oriented leaves round their world -> object transform as XLA's compiled CPU
code does (`boxes._apply_rows`), so they are held against the JAX function
under jit, with the share beyond those limits stated at the test. Whole
renders are held per pixel by the rule of tests/test_torch_primitives.py:
PIXEL_SHARE of the pixels within PIXEL_ATOL and the image mean within
MEAN_ATOL, but declares.sdl, whose lower share is shown to come from XLA's
fused multiply-adds (test_declares_hits_match_jax).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu import scene as jscene
from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.camera import build_camera as jcamera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.geometry import boxes as jbox
from raysnail_tpu.geometry import csg as jcsg
from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.geometry import transforms as jtf
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu.render import render as jrender
from raysnail_tpu.scenes.meshes import uv_sphere
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu_torch import cli
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch import scene as tscene
from raysnail_tpu_torch.camera import Ray as TRay
from raysnail_tpu_torch.camera import build_camera as tcamera
from raysnail_tpu_torch.camera import generate_rays
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import csg_trees_from_numpy, scene_arrays_from_numpy
from raysnail_tpu_torch.geometry import boxes as tbox
from raysnail_tpu_torch.geometry import csg as tcsg
from raysnail_tpu_torch.geometry import spheres as tsph
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3
from raysnail_tpu_torch.render import render as trender
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild
from raysnail_tpu_torch.utils import golden
from test_torch_scene import _assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TMIN, TMAX = 1e-3, 3e4
RTOL, NATOL = 1e-6, 1e-5
PIXEL_ATOL, PIXEL_SHARE, MEAN_ATOL = 1e-4, 0.99, 1e-4
SDL_SIZE = dict(width=96, height=64, samples=4, max_depth=8)
# declares.sdl's pixels, where XLA's fused multiply-adds move the blades'
# quadric roots and normals (reading 0.9855); its hits are held instead
DECLARES_SHARE = 0.98


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jvec(a):
    return JVec3(*(jnp.asarray(np.ascontiguousarray(a[..., i])) for i in range(3)))


def tvec(a):
    return TVec3(*(torch.from_numpy(np.ascontiguousarray(a[..., i])) for i in range(3)))


def rays(seed, n, span=3.0, target=1.0):
    """n rays with origins in [-span, span]^3 aimed at points of
    [-target, target]^3, as a JAX and a port Ray."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    d = rng.uniform(-target, target, (n, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    z = np.zeros(n, np.float32)
    return o, d, JRay(jvec(o), jvec(d), jnp.asarray(z)), TRay(tvec(o), tvec(d), torch.from_numpy(z))


def np_of(x):
    """A port or JAX value (tensor, array, Vec3) -> numpy ((..., 3) for a Vec3)."""
    if hasattr(x, "x") and hasattr(x, "y") and hasattr(x, "z"):
        return np.stack([np_of(getattr(x, a)) for a in "xyz"], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_nodes(a, b, where="tree"):
    """Two port trees (or media) equal: same classes, Python fields equal,
    tensors equal in dtype, shape and value."""
    if isinstance(a, (bool, int)) or a is None:
        assert type(a) is type(b) and a == b, where
    elif isinstance(a, TVec3):
        for axis in "xyz":
            assert_same_nodes(getattr(a, axis), getattr(b, axis), f"{where}.{axis}")
    elif isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b), where
        names = a._fields if hasattr(a, "_fields") else range(len(a))
        for i, name in enumerate(names):
            assert_same_nodes(a[i], b[i], f"{where}.{name}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert torch.equal(a, b), where


def assert_csg_hits(th, jh, min_hits, rtol=RTOL, share=0.0, fields=("t1", "t2")):
    """A port CsgHit or Hit against a JAX one: valid, mat_id and outside
    equal, the t fields within rtol on every lane, normal and uv within
    NATOL on valid lanes; with `share`, that share of the lanes may miss
    any of these (the cause stated where it is used). -> the lanes beyond."""
    valid, jvalid = np_of(th.valid), np_of(jh.valid)
    bad = valid != jvalid
    both = valid & jvalid
    bad |= both & (np_of(th.mat_id) != np_of(jh.mat_id))
    bad |= both & (np_of(th.outside) != np_of(jh.outside))
    for f in fields:
        a, b = np_of(getattr(th, f)), np_of(getattr(jh, f))
        bad |= ~np.isclose(a, b, rtol=rtol, atol=0.0)
    for f in ("normal", "u", "v"):
        a, b = np_of(getattr(th, f)), np_of(getattr(jh, f))
        err = np.abs(a - b)
        bad |= both & ((err.max(-1) if err.ndim > 1 else err) > NATOL)
    assert jvalid.sum() >= min_hits, jvalid.sum()
    assert bad.mean() <= share, (bad.sum(), bad.mean())
    return bad


# -- spheres and boxes: the interval functions ----------------------------------------------

def test_sphere_interval_contains_normal_match_jax():
    o, _, jray, tray = rays(1, 6000, span=1.6)
    c, r = (0.3, -0.2, 0.1), 1.1
    jc, tc = JVec3(*(jnp.float32(x) for x in c)), TVec3(*(torch.tensor(x) for x in c))
    with jax.disable_jit():
        j1, j2, jv = jsph.interval(jc, jnp.float32(r), jray, TMIN, TMAX)
        jin = jsph.contains(jc, jnp.float32(r), jray.origin)
        jn = jsph.normal_at(jc, jnp.float32(r), jray.origin)
    t1, t2, tv = tsph.interval(tc, torch.tensor(r), tray, TMIN, TMAX)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # all three cases: the near root in range, only the far one (inside), a miss
    inside = tv.numpy() & (t1.numpy() == t2.numpy())
    assert inside.sum() > 300 and (tv.numpy() & ~inside).sum() > 300 and (~tv.numpy()).sum() > 300
    # on every lane, those that miss too; where -half_b and the root nearly
    # cancel (t near 0), an ulp of either is a few 1e-6 of t: within 1e-5
    # there, beyond RTOL on at most 0.1% of the lanes (reading: 1 of 6,000)
    for a, b in ((t1, j1), (t2, j2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
        assert (~np.isclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=0)).mean() <= 1e-3
    got = tsph.contains(tc, torch.tensor(r), tray.origin).numpy()
    np.testing.assert_array_equal(got, np.asarray(jin))
    assert 0 < got.sum() < len(o)
    np.testing.assert_allclose(np_of(tsph.normal_at(tc, torch.tensor(r), tray.origin)), np_of(jn),
                               atol=NATOL)


def _box_rows(oriented):
    if not oriented:
        return None, None, None, None
    m = jtf.translate((0.2, -0.1, 0.3)) @ jtf.rotate_y(0.5) @ jtf.rotate_x(-0.3)
    rot, off = jtf.inverse_rows(m)
    jr = tuple(JVec3(*(jnp.float32(x) for x in rot[i])) for i in range(3))
    tr = tuple(TVec3(*(torch.tensor(float(x)) for x in rot[i])) for i in range(3))
    return jr, JVec3(*(jnp.float32(x) for x in off)), tr, TVec3(*(torch.tensor(float(x))
                                                                  for x in off))


# the oriented box's normal goes through _apply_rows_t, which XLA fuses and
# the port does not: its normals within NATOL on all lanes, but t1 and t2,
# whose rounding the port's _apply_rows follows, exactly as the compiled code
@pytest.mark.parametrize("oriented", [False, True], ids=["axis-aligned", "oriented"])
def test_box_interval_normal_contains_match_jax(oriented):
    o, _, jray, tray = rays(2, 6000, span=1.2)
    lo, hi = (-0.9, -0.7, -1.0), (0.8, 1.0, 0.6)
    jlo, jhi = (JVec3(*(jnp.float32(x) for x in v)) for v in (lo, hi))
    tlo, thi = (TVec3(*(torch.tensor(x) for x in v)) for v in (lo, hi))
    jr, joff, tr, toff = _box_rows(oriented)

    def jfun(ray):
        t1, t2, v, axis, near, d_obj, _ = jbox.interval(jlo, jhi, ray, TMIN, TMAX, jr, joff)
        return (t1, t2, v, axis, near, jbox.normal_of(axis, near, d_obj, jr),
                jbox.contains(jlo, jhi, ray.origin, jr, joff))

    if oriented:
        j = jax.jit(jfun)(jray)
    else:
        with jax.disable_jit():
            j = jfun(jray)
    t1, t2, v, axis, near, d_obj, _ = tbox.interval(tlo, thi, tray, TMIN, TMAX, tr, toff)
    t = (t1, t2, v, axis, near, tbox.normal_of(axis, near, d_obj, tr),
         tbox.contains(tlo, thi, tray.origin, tr, toff))
    for k in (2, 3, 4, 6):  # valid, face axis, entry flag, contains
        np.testing.assert_array_equal(np_of(t[k]), np_of(j[k]))
    start_inside = v.numpy() & ~near.numpy()
    assert start_inside.sum() > 300 and near.numpy().sum() > 300 and (~v.numpy()).sum() > 300
    assert (t2.numpy()[start_inside] == 1e30).all()      # BIG where the ray starts inside
    np.testing.assert_allclose(t1.numpy(), np_of(j[0]), rtol=RTOL)
    np.testing.assert_allclose(t2.numpy(), np_of(j[1]), rtol=RTOL)
    np.testing.assert_allclose(np_of(t[5]), np_of(j[5]), atol=NATOL)


# -- leaves ------------------------------------------------------------------------------------

_ROT = jir.mat4(jtf.translate((0.1, 0.2, -0.1)) @ jtf.rotate_y(0.4) @ jtf.rotate_z(0.3))
_SCALE = jir.mat4(np.diag([1.3, 0.8, 1.1, 1.0]))
_MAT = (0.4, 0.5, 0.6)

LEAVES = {
    "sphere": lambda ir: ir.Sphere((0.1, 0.0, -0.2), 1.0, ir.Lambertian(ir.Constant(_MAT))),
    "sphere-scaled": lambda ir: ir.Sphere((0.0, 0.1, 0.0), 0.9, None, transform=_SCALE),
    "box": lambda ir: ir.Box((-0.8, -0.9, -0.7), (0.9, 0.6, 0.8), ir.Metal(ir.Constant(_MAT))),
    "box-oriented": lambda ir: ir.Box((-0.8, -0.9, -0.7), (0.9, 0.6, 0.8), None, transform=_ROT),
    "rect": lambda ir: ir.Rect(2, 0.2, -0.8, 0.9, -0.7, 0.6, ir.Lambertian(ir.Constant(_MAT))),
    "rect-oriented": lambda ir: ir.Rect(1, -0.1, -0.8, 0.9, -0.7, 0.6, None, transform=_ROT),
    "quadric": lambda ir: ir.Quadric((1.0, -1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -0.3),
                                     ir.Lambertian(ir.Constant(_MAT))),
    "mesh": lambda ir: ir.Mesh(*uv_sphere(10, 14), material=ir.Lambertian(ir.Constant(_MAT))),
}
ORIENTED = ("box-oriented", "rect-oriented")


def _leaves(name):
    """(JAX leaf, port leaf, port leaf carried over from the JAX one)."""
    jleaf = jscene._leaf_of(LEAVES[name](jir), None, -1, jscene._Tables(), jnp.float32)
    tleaf = tscene._leaf_of(LEAVES[name](tir), None, -1, tscene._Tables(), torch.float32, "cpu")
    carried = csg_trees_from_numpy(jax.tree_util.tree_map(np.asarray, (jleaf,)), "cpu")[0]
    return jleaf, tleaf, carried


@pytest.mark.parametrize("name", list(LEAVES))
def test_leaf_compiles_equal_to_the_converted_jax_leaf(name):
    _, tleaf, carried = _leaves(name)
    assert_same_nodes(tleaf, carried)
    kind = {"sphere": tcsg.SphereLeaf, "sphere-scaled": tcsg.QuadricLeaf, "box": tcsg.BoxLeaf,
            "rect": tcsg.RectLeaf, "quadric": tcsg.QuadricLeaf, "mesh": tcsg.MeshLeaf}
    assert type(tleaf) is kind[name.split("-oriented")[0]]


@pytest.mark.parametrize("name", list(LEAVES))
def test_leaf_hit_contains_normal_match_jax(name):
    jleaf, tleaf, _ = _leaves(name)
    o, _, jray, tray = rays(3, 4000, span=2.5)
    pts = np.random.default_rng(4).uniform(-1.2, 1.2, (4000, 3)).astype(np.float32)

    def jfun(ray, p):
        return jleaf.hit(ray, TMIN, TMAX), jleaf.contains(p), jleaf.normal_at(p)

    if name in ORIENTED:
        jh, jin, jn = jax.jit(jfun)(jray, jvec(pts))
    else:
        with jax.disable_jit():
            jh, jin, jn = jfun(jray, jvec(pts))
    th = tleaf.hit(tray, TMIN, TMAX)
    # the oriented rect's normal comes through _apply_rows_t, its uv from
    # the object-space point: both within the limits; nothing beyond
    assert_csg_hits(th, jh, min_hits=300)
    inside = tleaf.contains(tvec(pts)).numpy()
    np.testing.assert_array_equal(inside, np.asarray(jin))
    if name.startswith(("rect", "mesh")):
        assert not inside.any()                       # contains() is always false
    else:
        assert 0 < inside.sum() < len(pts)
    np.testing.assert_allclose(np_of(tleaf.normal_at(tvec(pts))), np_of(jn), atol=NATOL)


def test_large_mesh_leaf_takes_the_traversal_route():
    """A mesh leaf above 32,768 triangles takes triangles.intersect_kernel
    (its plain version on the CPU) where the JAX package walks its thin
    BVH: the same hits as the dense sweep of the same mesh."""
    _, tleaf, _ = _leaves("mesh")
    assert tleaf.brute
    _, _, _, tray = rays(5, 3000, span=2.5)
    dense = tleaf.hit(tray, TMIN, TMAX)
    walked = tleaf._replace(brute=False).hit(tray, TMIN, TMAX)
    valid = dense.valid.numpy()
    np.testing.assert_array_equal(walked.valid.numpy(), valid)
    assert valid.sum() > 500
    for a, b in zip(walked, dense):
        np.testing.assert_allclose(np_of(a)[valid], np_of(b)[valid], rtol=1e-6, atol=1e-6)


# -- nodes -------------------------------------------------------------------------------------

def _sphere(ir, c, r, mat=None, **kw):
    return ir.Sphere(c, r, None if mat is None else ir.Lambertian(ir.Constant(mat)), **kw)


def _box(ir, lo, hi, mat=None, **kw):
    return ir.Box(lo, hi, None if mat is None else ir.Lambertian(ir.Constant(mat)), **kw)


NODES = {
    # csg.sdl's bowl: a box minus a sphere, rotated
    "bowl": lambda ir: ir.Csg("difference", _box(ir, (-1, -1, -1), (1, 0, 1), (0.0, 0.2, 0.3)),
                              _sphere(ir, (0, 0.1, 0), 0.9, (0.8, 0.8, 0.8)),
                              transform=jir.mat4(jtf.rotate_y(0.09))),
    "lens": lambda ir: ir.Csg("intersection", _sphere(ir, (0.4, 0, 0), 1.0, (0.9, 0.1, 0.1)),
                              _sphere(ir, (-0.4, 0, 0), 1.0), ir.Metal(ir.Constant(_MAT))),
    "box-minus-sphere": lambda ir: ir.Csg("difference", _box(ir, (-1, -1, -1), (1, 1, 1)),
                                          _sphere(ir, (0.3, 0.2, 0.0), 0.8, (0.2, 0.9, 0.2)),
                                          ir.Lambertian(ir.Constant((0.1, 0.1, 0.9)))),
    # declares.sdl's lemon: an intersection of an intersection and a box
    "nested-lemon": lambda ir: ir.Csg(
        "intersection",
        ir.Csg("intersection",
               ir.Quadric((1, 0, 1, 0, 0, 0, 0, 0, 0, -1.0), None,
                          transform=jir.mat4(jtf.translate((0, 0, -0.85)))),
               ir.Quadric((1, 0, 1, 0, 0, 0, 0, 0, 0, -1.0), None,
                          transform=jir.mat4(jtf.translate((0, 0, 0.85))))),
        _box(ir, (-0.6, -1.0, -0.6), (0.6, 1.0, 0.6)), ir.Metal(ir.Constant(_MAT))),
    "nested-difference": lambda ir: ir.Csg(
        "difference",
        ir.Csg("intersection", _box(ir, (-1, -1, -1), (1, 1, 1), (0.5, 0.5, 0.1)),
               _sphere(ir, (0, 0, 0), 1.3)),
        ir.Csg("difference", _sphere(ir, (0, 0, 0.5), 0.8, (0.1, 0.5, 0.5)),
               _box(ir, (-0.2, -0.2, -2), (0.2, 0.2, 2)))),
}


def _trees(names):
    """JAX and port compiles of one scene holding the named CSG objects ->
    (JAX scene, port scene)."""
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    for name in names:
        jb.add(NODES[name](jir))
        tb.add(NODES[name](tir))
    return jb.compile(), tb.compile(device="cpu")


def _difference_cases(tree, tray):
    """The four cases of difference.rs:57-106 per ray, from the port's
    child hits: plus only, plus first and outside the minus, the minus
    ending before the plus, the synthetic exit hit."""
    hp, hm = tree.plus.hit(tray, TMIN, TMAX), tree.minus.hit(tray, TMIN, TMAX)
    both = hp.valid & hm.valid
    first = hp.t1 < hm.t1
    p = tray.origin + tray.direction * hp.t1
    return {"only_plus": hp.valid & ~hm.valid,
            "plus_first": both & first & ~tree.minus.contains(p),
            "minus_before": both & ~first & (hm.t2 < hp.t1),
            "exit": both & ~first & (hm.t2 >= hp.t1) & (hm.t2 < hp.t2)}


@pytest.mark.parametrize("name", list(NODES))
def test_node_matches_jax(name):
    js, ts = _trees([name])
    (jtree,), (ttree,) = js.csg_trees, ts.csg_trees
    assert_same_nodes(ttree, csg_trees_from_numpy(jax.tree_util.tree_map(np.asarray, (jtree,)),
                                                  "cpu")[0])
    _, _, jray, tray = rays(6, 8000, span=3.0)
    pts = tvec(np.random.default_rng(7).uniform(-1.2, 1.2, (4000, 3)).astype(np.float32))
    if name == "bowl":
        # rotated: its box's transform is XLA's fused rounding (see
        # test_box_interval_normal_contains_match_jax), so against jit
        jh = jax.jit(lambda r: jtree.hit(r, TMIN, TMAX))(jray)
        jin = jax.jit(jtree.contains)(jvec(np_of(pts)))
    else:
        with jax.disable_jit():
            jh = jtree.hit(jray, TMIN, TMAX)
            jin = jtree.contains(jvec(np_of(pts)))
    th = ttree.hit(tray, TMIN, TMAX)
    # the bowl's rotated sphere is a quadric, whose roots XLA's compiled code
    # rounds with fused multiply-adds (reading: 0.44% of the rays beyond)
    assert_csg_hits(th, jh, min_hits=1000, share=0.01 if name == "bowl" else 0.0)
    np.testing.assert_array_equal(ttree.contains(pts).numpy(), np.asarray(jin))
    if isinstance(ttree, tcsg.DifferenceNode):
        cases = _difference_cases(ttree, tray)
        counts = {k: int(v.sum()) for k, v in cases.items()}
        assert all(n > 20 for n in counts.values()), counts
        # the synthetic exit hit: the minus child's material, uv (0, 0), outside
        ex = cases["exit"] & th.valid
        assert (th.u[ex] == 0).all() and th.outside[ex].all()
    np.testing.assert_allclose(np_of(ttree.normal_at(pts)),
                               np_of(jtree.normal_at(jvec(np_of(pts)))), atol=NATOL)


def test_override_material_inherits_only_where_unset():
    js, ts = _trees(["box-minus-sphere"])
    tree = ts.csg_trees[0]
    _, _, _, tray = rays(8, 4000)
    h = tree.hit(tray, TMIN, TMAX)
    cases = _difference_cases(tree, tray)
    plus_hits = h.valid & ~cases["exit"]
    # the box has no material: the node's; the sphere's exit hit keeps its own
    assert (h.mat_id[plus_hits] == tree.mat_id).all() and plus_hits.sum() > 100
    assert (h.mat_id[cases["exit"] & h.valid] == tree.minus_mat_id).all()
    assert tree.minus_mat_id != tree.mat_id


def test_intersect_trees_stacks_groups_and_matches_jax():
    """declares.sdl: ten trees in two structures (seven blades, three
    capped quadrics) evaluated as two stacked groups, and two solo trees
    (a rect child, a mesh child) beside them; the closest hit over all of
    them against the JAX package's intersect_trees."""
    path = os.path.join(REPO, "sdl", "declares.sdl")
    js, _ = jbuild(path, JConfig(**SDL_SIZE))
    ts, _ = tbuild(path, TConfig(**SDL_SIZE), "cpu")
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    for ir, b in ((jir, jb), (tir, tb)):
        b.add(ir.Csg("intersection", _box(ir, (-3, -1.5, -3), (3, 3, 3)),
                     ir.Rect(1, 0.5, -2, 2, -2, 2, ir.Lambertian(ir.Constant(_MAT)))))
        v, f, n = uv_sphere(8, 12)
        b.add(ir.Csg("intersection", ir.Mesh(v + np.asarray([0.0, 1.5, 0.0]), f, n),
                     _box(ir, (-2, -2, -2), (0, 4, 2)), ir.Metal(ir.Constant(_MAT))))
    jtrees = js.csg_trees + jb.compile().csg_trees
    ttrees = ts.csg_trees + tb.compile(device="cpu").csg_trees
    groups = tcsg.group_trees(ttrees)
    assert [k for _, k in groups] == [7, 3, None, None]
    assert groups[0][0].mat_id.shape == (7, 1)          # the blades' materials, stacked
    _, _, jray, tray = rays(9, 6000, span=6.0, target=2.0)
    jh = jax.jit(lambda r: jcsg.intersect_trees(jtrees, r, TMIN, TMAX))(jray)
    th = tcsg.intersect_trees(groups, tray, TMIN, TMAX)
    # the blades and caps are quadrics and rotated boxes, against compiled
    # code: XLA's fused quadric roots and _apply_rows_t normals move t or
    # the normal beyond the limits on 2% of the rays (reading 0.0197)
    bad = assert_csg_hits(th, jh, min_hits=1500, share=0.04, fields=("t",))
    assert len(np.unique(th.mat_id.numpy()[th.valid.numpy()])) >= 5
    # stacking changes no value: the same trees one at a time
    one = tcsg.intersect_trees(tuple((t, None) for t in ttrees), tray, TMIN, TMAX)
    for a, b in zip(th, one):
        np.testing.assert_array_equal(np_of(a), np_of(b))
    assert bad.sum() < th.valid.sum()


# -- the JAX package's CSG-child cases (tests/test_csg_children.py) -----------------------------

def _child_ray(origins, directions):
    o = np.asarray(origins, np.float32)
    d = np.asarray(directions, np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    z = np.zeros(len(o), np.float32)
    return (JRay(jvec(o), jvec(d), jnp.asarray(z)),
            TRay(tvec(o), tvec(d.astype(np.float32)), torch.from_numpy(z)))


CHILD_CASES = {
    "mesh-and-box": (lambda ir: ir.Csg("intersection", ir.Mesh(
        *uv_sphere(24, 32), material=ir.Lambertian(ir.Constant((0.8, 0.2, 0.2)))),
        ir.Box((-2.0, -2.0, -2.0), (-0.05, 2.0, 2.0))),
        [(-0.5, 0.0, 5.0), (0.5, 0.0, 5.0)], [True, False]),
    "rect-in-box": (lambda ir: ir.Csg("intersection", ir.Box((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)),
                                      ir.Rect(2, 0.0, -0.5, 0.5, -0.5, 0.5,
                                              ir.Lambertian(ir.Constant((0.2, 0.8, 0.2))))),
                    [(0.0, 0.0, 5.0), (0.75, 0.75, 5.0)], [True, False]),
    "box-minus-rect": (lambda ir: ir.Csg("difference", ir.Box(
        (-1.0, -1.0, -1.0), (1.0, 1.0, 1.0), ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))),
        ir.Rect(2, 2.0, -3.0, 3.0, -3.0, 3.0)),
        [(0.0, 0.0, 5.0), (0.0, 4.0, 5.0)], [False, False]),
}


@pytest.mark.parametrize("name", list(CHILD_CASES))
def test_csg_children_match_jax(name):
    make, origins, want = CHILD_CASES[name]
    jtree = jscene.SceneBuilder().add(make(jir)).compile().csg_trees[0]
    ttree = tscene.SceneBuilder().add(make(tir)).compile(device="cpu").csg_trees[0]
    jray, tray = _child_ray(origins, [(0.0, 0.0, -1.0)] * len(origins))
    th = ttree.hit(tray, TMIN, 1e9)
    with jax.disable_jit():
        jh = jtree.hit(jray, TMIN, 1e9)
    assert th.valid.tolist() == want
    assert_csg_hits(th, jh, min_hits=0)
    if name == "mesh-and-box":
        assert abs(float(th.t1[0]) - (5.0 - np.sqrt(0.75))) < 0.05 and float(th.t2[0]) > 1e8
    if name == "rect-in-box":
        np.testing.assert_allclose([float(th.t1[0]), float(th.u[0]), float(th.v[0])],
                                   [5.0, 0.5, 0.5], atol=1e-5)


def test_csg_mesh_renders_in_scene_as_jax():
    v, f, n = uv_sphere(12, 16)
    cfg = dict(width=32, height=24, samples=4, max_depth=3)
    imgs = []
    for ir, builder, camera, render, config, kw in (
            (jir, jscene.SceneBuilder, jcamera, jrender, JConfig, {}),
            (tir, tscene.SceneBuilder, tcamera, trender, TConfig, {"device": "cpu"})):
        b = builder()
        b.add(ir.Csg("intersection", ir.Mesh(vertices=v, indices=f, normals=n,
                                             material=ir.Lambertian(ir.Constant((0.8, 0.3, 0.2)))),
                     ir.Box((-2.0, -2.0, -2.0), (0.0, 2.0, 2.0))))
        b.set_background((0.6, 0.7, 0.9))
        cam = camera(look_from=(0, 0, 4), look_at=(0, 0, 0), fov=40, width=32, height=24, **kw)
        imgs.append(np.asarray(render(b.compile(**kw), cam, config(gamma=False, **cfg), seed=3)))
    ref, img = imgs
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE and img[:, :16, 0].max() > 0.25
    assert np.abs(img[:, 18:] - np.asarray([0.6, 0.7, 0.9])).max() < 1e-5   # background only


# -- SDL scenes: compile, hits, renders, anchors, CLI ---------------------------------------

SDL_CSG = ["quadric.sdl", "csg.sdl", "declares.sdl"]


@pytest.fixture(scope="module")
def sdl_pairs():
    cache = {}

    def get(name):
        if name not in cache:
            path = os.path.join(REPO, "sdl", name)
            cache[name] = (jbuild(path, JConfig(**SDL_SIZE)), tbuild(path, TConfig(**SDL_SIZE), "cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("name", SDL_CSG)
def test_sdl_compile_equals_the_converted_jax_compile(sdl_pairs, name):
    (jsc, _), (tsc, _) = sdl_pairs(name)
    _assert_same(tsc.arrays, scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsc.arrays), "cpu"))
    assert_same_nodes(tsc.csg_trees, csg_trees_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsc.csg_trees), "cpu"))
    for field in dataclasses.fields(tsc.static):
        if hasattr(jsc.static, field.name):
            assert getattr(tsc.static, field.name) == getattr(jsc.static, field.name), field.name
    assert tsc.static.n_csg == {"quadric.sdl": 4, "csg.sdl": 2, "declares.sdl": 10}[name]
    assert tsc.static.n_media == 0 and not tsc.media


def _primary(tcam, width, height):
    p = torch.arange(width * height)
    keys = prng.fold_all(prng.fast_streams(7, p), 0)
    zero = torch.zeros(width * height)
    return generate_rays(tcam, (p % width).float(), (p // width).float(), zero, zero, 2, width,
                         height, keys), keys


def test_declares_hits_match_jax(sdl_pairs):
    """Why declares.sdl's pixels agree with JAX's render on 0.98 of them:
    its primary hits equal the JAX package's run op by op (every mask and
    material; t within 1e-4, where a capped quadric's root cancels, the
    normal within 1e-5), and the same function compiled by XLA moves t
    beyond 1e-6 on 4-5% of the hits and the normal on 1-2%, with every mask
    and material still equal."""
    (jsc, _), (tsc, tcam) = sdl_pairs("declares.sdl")
    ray, keys = _primary(tcam, 96, 64)
    jray = JRay(jvec(np_of(ray.origin)), jvec(np_of(ray.direction)), jnp.asarray(ray.time.numpy()))
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    th = tscene.intersect(tsc, tsc.arrays, ray, TMIN, TMAX, keys)
    fn = lambda a, r, k: jscene.intersect(jsc, a, r, TMIN, TMAX, k)
    with jax.disable_jit():
        je = fn(jsc.arrays, jray, jkeys)
    jj = jax.jit(fn)(jsc.arrays, jray, jkeys)
    valid = th.valid.numpy()
    for jh in (je, jj):
        np.testing.assert_array_equal(valid, np.asarray(jh.valid))
        np.testing.assert_array_equal(th.mat_id.numpy()[valid], np.asarray(jh.mat_id)[valid])
    assert valid.sum() > 5000
    np.testing.assert_allclose(th.t.numpy(), np.asarray(je.t), rtol=1e-4)
    np.testing.assert_allclose(np_of(th.normal)[valid], np_of(je.normal)[valid], atol=NATOL)
    rel = np.abs(th.t.numpy() - np.asarray(jj.t))[valid] / np.asarray(jj.t)[valid]
    assert 0.01 < (rel > RTOL).mean() < 0.1, (rel > RTOL).mean()


@pytest.mark.parametrize("name", SDL_CSG)
def test_sdl_render_matches_jax(sdl_pairs, name):
    (jsc, jcam), (tsc, tcam) = sdl_pairs(name)
    ref = np.asarray(jrender(jsc, jcam, JConfig(gamma=False, **SDL_SIZE), seed=7))
    img = trender(tsc, tcam, TConfig(gamma=False, **SDL_SIZE), seed=7)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.std() > 0.01
    d = np.abs(img - ref).max(axis=-1)
    share = DECLARES_SHARE if name == "declares.sdl" else PIXEL_SHARE
    assert (d <= PIXEL_ATOL).mean() >= share, ((d <= PIXEL_ATOL).mean(), d.max())
    assert np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max() <= MEAN_ATOL


def test_render_of_carried_trees_equals_the_port_compile(sdl_pairs):
    """csg.sdl rendered from the JAX compile's arrays and trees, carried
    across by convert.py, equals the port's own compile, bit for bit."""
    (jsc, _), (tsc, tcam) = sdl_pairs("csg.sdl")
    cfg = TConfig(gamma=False, width=48, height=32, samples=4, max_depth=8)
    carried = dataclasses.replace(
        tsc, arrays=scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jsc.arrays), "cpu"),
        csg_trees=csg_trees_from_numpy(jax.tree_util.tree_map(np.asarray, jsc.csg_trees), "cpu"))
    tcam = tcamera(look_from=(4.5, 1.35, 1.875), look_at=(0, -0.6, 0), fov=50, aperture=0.01,
                   focus_distance=10.0, width=48, height=32, device="cpu")
    np.testing.assert_array_equal(trender(carried, tcam, cfg, seed=3),
                                  trender(tsc, tcam, cfg, seed=3))


@pytest.mark.parametrize("name", ["quadric.sdl", "csg.sdl"])
def test_anchor_holds(name):
    golden.check_anchor(name, golden.load_golden(), "cpu")


@pytest.mark.parametrize("name", SDL_CSG)
def test_cli_renders_csg_scenes(tmp_path, name):
    out = str(tmp_path / "out.png")
    rc = cli.main(["--scene", os.path.join(REPO, "sdl", name), "-w", "32", "--height", "20",
                   "--samples", "4", "--device", "cpu", "-o", out])
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert rc == 0 and img.shape == (20, 32, 3) and img.std() > 2
