"""The port's constant-density media (geometry/media.py), book 2 and the
smoke Cornell box against the JAX package, on the CPU.

Inputs are numpy arrays from a seed (uniforms too, or the counter-based
keys both packages share). Against the JAX functions run op by op: the
scatter mask and material equal, t within rtol 1e-6 (the free path goes
through the log, where torch's and XLA's differ by an ulp). Oriented box
boundaries round as XLA's compiled code (`boxes._apply_rows`) and are held
against the JAX function under jit. Renders are held per pixel as in
tests/test_torch_csg.py; book 2's lower share and its anchor's thumbnail
are shown to come from rounding (test_book2_hits_match_jax,
test_book2_thumbnail_moves_with_rounding).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raysnail_tpu import ir as jir
from raysnail_tpu import scene as jscene
from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.camera import build_camera as jcamera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.geometry import media as jmed
from raysnail_tpu.geometry import transforms as jtf
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.render import render as jrender
from raysnail_tpu.scenes import book2 as jbook2
from raysnail_tpu.scenes import cornell as jcornell
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch import scene as tscene
from raysnail_tpu_torch.camera import build_camera as tcamera
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import media_from_numpy, scene_arrays_from_numpy
from raysnail_tpu_torch.geometry import boxes as tbox
from raysnail_tpu_torch.geometry import media as tmed
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.render import render as trender
from raysnail_tpu_torch.scenes import book2 as tbook2
from raysnail_tpu_torch.scenes import cornell as tcornell
from raysnail_tpu_torch.utils import golden
from test_torch_csg import (MEAN_ATOL, NATOL, PIXEL_ATOL, PIXEL_SHARE, RTOL, TMAX, TMIN,
                            _primary, assert_same_nodes, jvec, np_of, rays, tvec)
from test_torch_scene import _assert_same

# book 2's pixels, where XLA's fused multiply-adds move its spheres' roots
# (reading 0.987); its hits are held instead
BOOK2_SHARE = 0.98


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _medium(ir, boundary):
    return ir.ConstantMedium(boundary, 0.7, (0.2, 0.4, 0.9))


BOUNDARIES = {
    "sphere": lambda ir: ir.Sphere((0.1, 0.0, -0.2), 1.0),
    "box": lambda ir: ir.Box((-0.8, -0.9, -0.7), (0.9, 0.6, 0.8)),
    "box-oriented": lambda ir: ir.Box((-0.8, -0.9, -0.7), (0.9, 0.6, 0.8), transform=jir.mat4(
        jtf.translate((0.1, 0.2, -0.1)) @ jtf.rotate_y(0.4) @ jtf.rotate_z(0.3))),
}


def _media(names):
    """JAX and port compiles of one scene holding a medium per boundary."""
    jb, tb = jscene.SceneBuilder(), tscene.SceneBuilder()
    for name in names:
        jb.add(_medium(jir, BOUNDARIES[name](jir)))
        tb.add(_medium(tir, BOUNDARIES[name](tir)))
    return jb.compile(), tb.compile(device="cpu")


@pytest.mark.parametrize("name", list(BOUNDARIES))
def test_medium_hit_matches_jax(name):
    js, ts = _media([name])
    (jm,), (tm,) = js.media, ts.media
    assert_same_nodes(tm, media_from_numpy(jax.tree_util.tree_map(np.asarray, (jm,)), "cpu")[0])
    assert tm.mat_id == 1 and ts.static.n_media == 1
    _, _, jray, tray = rays(11, 6000, span=2.0)
    u = np.random.default_rng(12).random(6000).astype(np.float32)
    u[:50] = 0.0                                       # the log's clamp at 1e-12
    if name == "box-oriented":
        jh = jax.jit(lambda r, uu: jm.hit(r, TMIN, TMAX, uu))(jray, jnp.asarray(u))
    else:
        with jax.disable_jit():
            jh = jm.hit(jray, TMIN, TMAX, jnp.asarray(u))
    th = tm.hit(tray, TMIN, TMAX, torch.from_numpy(u))
    valid = th.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    assert 300 < valid.sum() < 5700
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=RTOL)
    for f in ("mat_id", "outside", "u", "v"):
        np.testing.assert_array_equal(np_of(getattr(th, f)), np_of(getattr(jh, f)))
    np.testing.assert_array_equal(np_of(th.normal), np_of(jh.normal))


def test_intersect_media_draws_from_the_keys_as_jax():
    """Three media over one ray batch, each with the uniform that both
    packages draw from the per-ray keys (MEDIUM purpose), in compile
    order; the closest scatter as the JAX package's intersect_media."""
    js, ts = _media(list(BOUNDARIES))
    _, _, jray, tray = rays(13, 6000, span=2.0)
    keys = prng.fold_all(prng.fast_streams(5, torch.arange(6000)), 3)
    tu = prng.ray_uniforms(prng.fold_all(keys, prng.MEDIUM), 3)
    ju = jrng.ray_uniforms(jrng.fold_all(jnp.asarray(keys.numpy().astype(np.uint32)),
                                         jrng.MEDIUM), 3)
    for a, b in zip(tu, ju):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jh = jax.jit(lambda r: jmed.intersect_media(js.media, r, TMIN, TMAX, ju))(jray)
    th = tmed.intersect_media(ts.media, tray, TMIN, TMAX, tu)
    valid = th.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    np.testing.assert_array_equal(th.mat_id.numpy(), np.asarray(jh.mat_id))
    assert valid.sum() > 1000 and len(np.unique(th.mat_id.numpy()[valid])) == 1
    # compiled, t differs from the port's only by the log's ulp
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    # through the scene's intersect, from the same keys
    hit = tscene.intersect(ts, ts.arrays, tray, TMIN, TMAX, keys)
    np.testing.assert_array_equal(hit.t.numpy(), th.t.numpy())


def test_quadric_boundary_raises():
    b = tscene.SceneBuilder().add(tir.ConstantMedium(tir.Quadric(
        (1.0, 0, 0, 0, 1.0, 0, 0, 1.0, 0, -1.0)), 0.5))
    scene = b.compile(device="cpu")
    _, _, _, tray = rays(14, 10)
    with pytest.raises(TypeError, match="unsupported medium boundary"):
        scene.media[0].hit(tray, TMIN, TMAX, torch.rand(10))


def _glass_with_medium(ir, builder, **kw):
    """tests/test_absorption.py's glass sphere in front of a white sky, with
    a medium inside it: the subsurface of book 2 at the size of that test."""
    b = builder()
    b.add(ir.Sphere((0, 0, -2), 0.8, ir.Dielectric(ior=1.5)))
    b.add(ir.ConstantMedium(ir.Sphere((0, 0, -2), 0.8), 1.5, (0.9, 0.3, 0.2)))
    b.set_background((1, 1, 1), (1, 1, 1))
    return b.compile(**kw)


def test_glass_with_medium_renders_as_jax():
    cfg = dict(width=40, height=30, samples=9, max_depth=6)
    js = _glass_with_medium(jir, jscene.SceneBuilder)
    ts = _glass_with_medium(tir, tscene.SceneBuilder, device="cpu")
    cam = dict(look_from=(0, 0, 0), look_at=(0, 0, -1), fov=50, width=40, height=30)
    ref = np.asarray(jrender(js, jcamera(**cam), JConfig(gamma=False, **cfg), seed=3))
    img = trender(ts, tcamera(**cam, device="cpu"), TConfig(gamma=False, **cfg), seed=3)
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE, ((d <= PIXEL_ATOL).mean(), d.max())
    assert np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max() <= MEAN_ATOL
    # the medium tints the glass red: green and blue scatter away inside it
    c = img[11:19, 16:24].mean(axis=(0, 1))
    assert c[0] > 1.3 * c[1] and c[0] > 1.3 * c[2] and np.abs(img[:3, :3] - 1.0).max() < 1e-6


# -- book 2 and the smoke Cornell box ------------------------------------------------------

SIZES = {"cornell-smoke": dict(width=96, height=96, samples=9, max_depth=8),
         "book2": dict(width=96, height=54, samples=4, max_depth=6)}


def _scene_pair(name):
    w, h = SIZES[name]["width"], SIZES[name]["height"]
    if name == "cornell-smoke":
        return ((jcornell.cornell_box(smoke=True).compile(), jcornell.cornell_camera(w, h)),
                (tcornell.cornell_box(smoke=True).compile(device="cpu"),
                 tcornell.cornell_camera(w, h, device="cpu")))
    return ((jbook2.all_feature_scene(7).compile(), jbook2.book2_camera(w, h)),
            (tbook2.all_feature_scene(7).compile(device="cpu"),
             tbook2.book2_camera(w, h, device="cpu")))


@pytest.fixture(scope="module")
def scene_pairs():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _scene_pair(name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(SIZES))
def test_scene_compiles_equal_to_the_converted_jax_compile(scene_pairs, name):
    (jsc, _), (tsc, _) = scene_pairs(name)
    _assert_same(tsc.arrays, scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsc.arrays), "cpu"))
    assert_same_nodes(tsc.media, media_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsc.media), "cpu"))
    for field in dataclasses.fields(tsc.static):
        if hasattr(jsc.static, field.name):
            assert getattr(tsc.static, field.name) == getattr(jsc.static, field.name), field.name
    assert tsc.static.n_media == 2 and tsc.static.n_csg == 0
    a = tsc.arrays
    if name == "book2":
        # 400 ground boxes with their packed BVH (the box kernel's route on
        # the card), and the moving sphere
        assert a.boxes.pk_bb is not None and a.boxes.mat_id.shape == (400,)
        assert tsc.static.moving and a.spheres.pk_bb is None
        assert [type(m.boundary).__name__ for m in tsc.media] == ["SphereLeaf", "SphereLeaf"]
    else:
        assert a.boxes is None      # the cartons are smoke: oriented box boundaries
        assert all(m.boundary.inv_rows is not None for m in tsc.media)


def test_cornell_smoke_builds_the_reference_layout():
    """The smoke variant (scene.rs:210-334): the light at 7x over the wider
    rect, the two cartons as media of density 0.01, white and black."""
    b = tcornell.cornell_box(smoke=True)
    light = [o for o in b.objects if isinstance(o, tir.Rect) and o.k == 554.0][0]
    assert (light.a0, light.a1, light.material.multiplier) == (113.0, 443.0, 7.0)
    smoke = [o for o in b.objects if isinstance(o, tir.ConstantMedium)]
    assert [(m.density, m.rgb) for m in smoke] == [(0.01, (1.0, 1.0, 1.0)), (0.01, (0.0, 0.0, 0.0))]
    assert not any(isinstance(o, tir.Box) for o in b.objects)


def test_earth_texture_is_the_jax_package_image():
    """book 2's planet: the port writes its own file next to its module, with
    the JAX package's pixels."""
    path = tbook2._earth_texture().path
    assert os.path.dirname(path) == os.path.dirname(os.path.abspath(tbook2.__file__))
    np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                  np.asarray(Image.open(jbook2._earth_texture().path)))
    assert not [f for f in os.listdir(os.path.dirname(path)) if f.endswith(".tmp")]


def test_book2_hits_match_jax(scene_pairs):
    """Why book 2's pixels agree with JAX's render on 0.98 of them: its
    primary hits, media included, equal the JAX package's run op by op
    (every mask and material, t within 1e-6), while under jit XLA's fused
    multiply-adds move t beyond 1e-6 on a share of the sphere hits (its
    spheres are 600-900 units away: half_b^2 and c cancel)."""
    (jsc, _), (tsc, tcam) = scene_pairs("book2")
    ray, keys = _primary(tcam, 96, 54)
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
    np.testing.assert_allclose(th.t.numpy(), np.asarray(je.t), rtol=RTOL)
    np.testing.assert_allclose(np_of(th.normal)[valid], np_of(je.normal)[valid], atol=NATOL)
    mats = th.mat_id.numpy()
    spheres = valid & np.isin(mats, [3, 4, 5, 8, 9])
    assert spheres.sum() > 500 and (valid & (mats == 7)).sum() > 500   # spheres and fog seen
    rel = np.abs(th.t.numpy() - np.asarray(jj.t)) / np.asarray(jj.t)
    assert (rel[spheres] > RTOL).mean() > 0.1 and (rel[valid & ~spheres] > RTOL).sum() == 0


@pytest.mark.parametrize("name", list(SIZES))
def test_scene_render_matches_jax(scene_pairs, name):
    (jsc, jcam), (tsc, tcam) = scene_pairs(name)
    ref = np.asarray(jrender(jsc, jcam, JConfig(gamma=False, **SIZES[name]), seed=7))
    img = trender(tsc, tcam, TConfig(gamma=False, **SIZES[name]), seed=7)
    assert img.shape == ref.shape and np.isfinite(img).all() and img.std() > 0.01
    d = np.abs(img - ref).max(axis=-1)
    share = BOOK2_SHARE if name == "book2" else PIXEL_SHARE
    assert (d <= PIXEL_ATOL).mean() >= share, ((d <= PIXEL_ATOL).mean(), d.max())
    # a path that differs and then reaches the light is a firefly of 1-2
    # in one pixel, which moves the mean: cornell-smoke's 12 of 9,216
    # pixels beyond PIXEL_ATOL move it by 1.7e-4 of its 1.3 (3 x MEAN_ATOL
    # allowed, relative), book 2's by 4.7e-4 (1e-3 allowed)
    mean_atol = {"cornell-smoke": 3 * MEAN_ATOL * float(ref.mean()), "book2": 1e-3}[name]
    assert np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max() <= mean_atol


def test_render_of_carried_media_equals_the_port_compile(scene_pairs):
    """cornell-smoke rendered from the JAX compile's arrays and media,
    carried across by convert.py, equals the port's own compile, bit for bit."""
    (jsc, _), (tsc, _) = scene_pairs("cornell-smoke")
    carried = dataclasses.replace(
        tsc, arrays=scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jsc.arrays), "cpu"),
        media=media_from_numpy(jax.tree_util.tree_map(np.asarray, jsc.media), "cpu"))
    cfg = TConfig(gamma=False, width=32, height=32, samples=4, max_depth=8)
    cam = tcornell.cornell_camera(32, 32, device="cpu")
    np.testing.assert_array_equal(trender(carried, cam, cfg, seed=5), trender(tsc, cam, cfg, seed=5))


def test_book2_anchor_mean_holds():
    """book 2's anchor: its global mean within MEAN_ATOL. Its thumbnail is
    reported, not held: see test_book2_thumbnail_moves_with_rounding."""
    res = golden.anchor_drift("book2", golden.load_golden(), "cpu")
    assert res["dmean"] <= golden.MEAN_ATOL, res


def test_book2_thumbnail_moves_with_rounding(monkeypatch):
    """book 2's anchor thumbnail (4 spp, fog, glass and a subsurface medium
    under a light) moves beyond THUMB_ATOL when only the rounding of the
    sphere quadratic changes: the port's render against the same render
    with that quadratic rounded as XLA's compiled CPU code rounds it (its
    fused multiply-adds, `boxes._fma`). Both keep the global mean. So the
    committed thumbnail pins one compiler's rounding; the JAX package's own
    code run op by op misses it too (by 0.0396 in 6 blocks)."""
    base = golden.anchor_stats(golden.render_anchor("book2", "cpu"))
    fma = tbox._fma

    def fused(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max, speed_xyz=None,
              time=None):
        ox, oy, oz = (a[:, None] for a in origin_xyz)
        dx, dy, dz = (a[:, None] for a in dir_xyz)
        c = [fma(s, time[:, None], c) for s, c in zip(speed_xyz, center_xyz)] \
            if speed_xyz is not None else center_xyz
        lx, ly, lz = ox - c[0], oy - c[1], oz - c[2]
        half_b = fma(dz, lz, fma(dx, lx, dy * ly))
        delta = fma(half_b, half_b, -(fma(lz, lz, fma(lx, lx, ly * ly)) - r2))
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        t1, t2 = -half_b - sq, -half_b + sq
        ok = (delta > 0.0) & active
        in1 = ok & (t_min < t1) & (t1 < t_max)
        in2 = ok & (t_min < t2) & (t2 < t_max)
        t = torch.where(in1, t1, torch.where(in2, t2, torch.full_like(t1, 1e30)))
        idx = torch.argmin(t, dim=1)
        return torch.gather(t, 1, idx[:, None])[:, 0], idx.to(torch.int32)

    monkeypatch.setattr(smt, "sphere_min_t_plain", fused)
    moved = golden.anchor_stats(golden.render_anchor("book2", "cpu"))
    assert np.abs(moved["thumb"] - base["thumb"]).max() > golden.THUMB_ATOL
    assert np.abs(moved["mean"] - base["mean"]).max() <= golden.MEAN_ATOL
