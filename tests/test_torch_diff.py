"""The port's differentiable render (`raysnail_tpu_torch.diff`) against the
JAX package's, on the CPU.

  * The gradient image: `render_image_diff` and the gradient of its mean
    (`scalar_out`, as tests/test_diff.py) with respect to every SceneParams
    leaf, against `jax.grad` of the JAX package's, on tests/test_diff.py's
    scene at 24x16@16spp depth 4, on example.sdl at 16x10@4spp depth 4 and
    on a scene whose directions depend on the parameters (a DiffuseMetal
    and a BlinnPhong sphere, 24x16@4spp depth 4), where the rays' t reaches
    the gradient through `SphereMinT`. Each leaf:
    |g_port - g_jax| <= 1e-3 * max|g_jax| + 1e-6; the images within 1e-5.
    Both packages draw by (seed, pixel, sample, bounce), so they trace the
    same paths. The JAX package's sphere sweep gives a NaN gradient to
    every ray that misses a sphere (sqrt(max(delta, 0)) of every pair,
    ROADMAP section 3), which only the third scene reaches: there its
    `pair_t` is swapped for a NaN-safe copy for the test's duration (the
    same t). Readings: the largest leaf difference is 4.3e-7 on 0.40
    (colors), and 1.1e-6 on 8.0e-4 for the DiffuseMetal exponent, whose
    gradient of the mean is the small sum of pixel terms up to 2.2 of
    either sign (each pixel's term agrees to 1e-4 relative).
  * The port's own checks, as tests/test_diff.py: finite differences of an
    albedo (rtol 2e-2, atol 1e-5), the emitter's gradient non-zero, a mesh
    scene's gradients finite (the mesh hit is detached).
  * The dielectric's IOR: on a three-sphere scene with a Dielectric(1.5)
    (8x6@1spp) the JAX package's mat_param0 gradient is NaN in every row
    (ROADMAP section 3). So is the port's at depth 5. At depth 3 the port's
    is NaN in every row but the glass's own: no path through the glass
    reaches a term that depends on a parameter within 3 bounces, so that
    gradient is 0 (the finite difference is 0 as well), and the JAX
    package's NaN there comes from the dielectric's own sqrt(max(., 0))
    (it stays with a NaN-safe `pair_t`): `jnp.maximum`'s gradient
    multiplies the NaN of the square root at a negative argument by a 0
    mask, where `torch.clamp_min`'s selects 0. The other rows' NaN comes
    from the dielectric code run for every ray, with their ior = 0 (1 / 0),
    in both packages.
  * The cos^e lobe's square root at z = 1 gives the exponent an infinite or
    NaN gradient in both packages (a reference fault, ROADMAP section 3).
  * SceneParams carried across (`convert.scene_params_from_numpy`) and
    `utils/compare.py`'s copy (tests/test_torch_scene.py COPIES).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu.camera import build_camera as jcamera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.diff import extract_params as jextract
from raysnail_tpu.diff.train import render_image_diff as jrender_diff
from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch.camera import build_camera as tcamera
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import scene_params_from_numpy
from raysnail_tpu_torch.diff import extract_params, inject_params
from raysnail_tpu_torch.diff.params import SceneParams, from_leaves, leaves
from raysnail_tpu_torch.diff.train import render_image_diff
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild
from test_torch_sphere_grad import _safe_pair_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "sdl", "example.sdl")
SMALL = dict(width=24, height=16, samples=16, max_depth=4, ray_batch=1 << 14)
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
PIXEL_ATOL, PIXEL_SHARE, MEAN_ATOL = 1e-4, 0.99, 1e-4  # tests/test_torch_render.py's


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_scene(ir, builder, camera, device=None, middle=None, extra=()):
    """tests/test_diff.py's scene (ground, an albedo sphere, a sphere light)
    in either package; `middle` replaces the albedo sphere's material,
    `extra` adds spheres (center, radius, material)."""
    b = builder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5,
                    middle(ir) if middle else ir.Lambertian(ir.Constant((0.6, 0.3, 0.2)))))
    for center, radius, mat in extra:
        b.add(ir.Sphere(center, radius, mat(ir)))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 4.0)),
          light=True)
    b.set_background((0.1, 0.1, 0.1))
    kw = dict(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50, width=SMALL["width"],
              height=SMALL["height"])
    if device is None:
        return b.compile(), camera(**kw)
    return b.compile(device=device), camera(**kw, device=device)


def metal(ir):
    return ir.DiffuseMetal(30.0, ir.Constant((0.6, 0.3, 0.2)))


METAL_EXTRA = (((-1.0, 0.0, -1.5), 0.4,
                lambda ir: ir.BlinnPhong(0.4, 20.0, ir.Constant((0.2, 0.6, 0.3)))),)


def scenes(name, size):
    """-> (jax scene, jax camera, jax cfg, port scene, port camera, port cfg)."""
    jcfg, tcfg = JConfig(**size), TConfig(**size)
    if name == "example.sdl":
        return (*jbuild(EXAMPLE, jcfg), jcfg, *tbuild(EXAMPLE, tcfg, "cpu"), tcfg)
    kw = dict(middle=metal, extra=METAL_EXTRA) if name == "metal" else {}
    return (*small_scene(jir, JBuilder, jcamera, **kw), jcfg,
            *small_scene(tir, TBuilder, tcamera, "cpu", **kw), tcfg)


def port_grad(scene, camera, cfg, params=None, seed=0, weights=None):
    """-> (image (P, 3), gradient leaves) of the port's scalar_out, the mean
    over pixels of R + G + B (each pixel weighted by `weights`)."""
    p = params if params is not None else extract_params(scene.arrays)
    img = render_image_diff(scene, camera, cfg, p, seed, np.arange(cfg.effective_samples))
    s = img.x + img.y + img.z
    if weights is not None:
        s = s * torch.as_tensor(weights)
    torch.mean(s).backward()
    grads = [x.grad.numpy() if x.grad is not None else np.zeros(x.shape) for x in leaves(p)]
    return img.to_array().detach().numpy(), grads


def jax_grad(scene, camera, cfg, seed=0, weights=None):
    ids = jnp.arange(cfg.effective_samples, dtype=jnp.int32)
    w = 1.0 if weights is None else jnp.asarray(weights)

    def scalar_out(p):
        img = jrender_diff(scene, camera, cfg, p, jrng.key(seed), ids)
        return jnp.mean((img.x + img.y + img.z) * w), img.to_array()

    g, img = jax.grad(scalar_out, has_aux=True)(jextract(scene.arrays))
    return np.asarray(img), [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]


# paths that flip between the packages at these sizes (their pixels' radiance
# differs beyond PIXEL_ATOL): example.sdl's one is shown by its hits below
FLIPPED = {"test_diff": 0, "example.sdl": 1, "metal": 0}


@pytest.mark.parametrize("name,size", [
    ("test_diff", SMALL),
    ("example.sdl", dict(width=16, height=10, samples=4, max_depth=4)),
    ("metal", dict(SMALL, samples=4)),
])
def test_gradient_image_matches_jax(monkeypatch, name, size):
    if name == "metal":
        monkeypatch.setattr(jsph, "pair_t", _safe_pair_t)
    js, jc, jcfg, ts, tc, tcfg = scenes(name, size)
    jimg, jg = jax_grad(js, jc, jcfg)
    timg, tg = port_grad(ts, tc, tcfg)
    d = np.abs(timg - jimg).max(axis=1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE, ((d <= PIXEL_ATOL).mean(), d.max())
    assert np.abs(timg.mean(0) - jimg.mean(0)).max() <= MEAN_ATOL
    flipped = d > PIXEL_ATOL
    if flipped.any():
        # a flipped path is another path, with another gradient: the pixels
        # it lands in are left out of the scalar on both sides
        weights = (~flipped).astype(np.float32)
        _, jg = jax_grad(js, jc, jcfg, weights=weights)
        _, tg = port_grad(ts, tc, tcfg, weights=weights)
    assert flipped.sum() == FLIPPED[name], np.flatnonzero(flipped)
    assert len(jg) == len(tg) == 10
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert np.isfinite(b).all(), i
        limit = GRAD_RTOL * np.abs(b).max() + GRAD_ATOL
        assert np.abs(a - b).max() <= limit, (i, np.abs(a - b).max(), limit)
    if name == "example.sdl":  # all Lambertian plus the light: colors and emitter only
        assert np.abs(tg[0]).max() > 1e-3 and np.abs(tg[8]).max() > 1e-5
        assert all(np.abs(tg[i]).max() == 0 for i in (6, 7, 9))
    if name == "metal":  # the DiffuseMetal exponent and BlinnPhong lobe are reached
        assert np.abs(tg[6]).max() > 1e-4 and np.abs(tg[7]).max() > 1e-5


def test_example_flip_is_a_self_hit_of_the_ground_sphere():
    """The one path of example.sdl at 16x10@4spp that flips between the
    packages, shown by its hits: pixel 35, sample 1, leaves the ground
    sphere (radius 10,000) after its first bounce. The JAX package's jitted
    program lands that bounce origin 4.4e-4 inside the sphere and hits the
    sphere again at t = 0.00146, just above t_min (float32 resolves nothing
    finer on a quadratic of that size), so the path ends dark; the port's
    bounce ray misses and takes the background."""
    from raysnail_tpu import integrator as jintegrator
    from raysnail_tpu import scene as jscene
    from raysnail_tpu.camera import Ray as JRay
    from raysnail_tpu.camera import generate_rays as jgenerate
    from raysnail_tpu.prelude.vec import Vec3 as JVec3
    from raysnail_tpu_torch import integrator as tintegrator
    from raysnail_tpu_torch import scene as tscene
    from raysnail_tpu_torch.camera import Ray as TRay
    from raysnail_tpu_torch.camera import generate_rays as tgenerate
    from raysnail_tpu_torch.prelude import rng as trng
    from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3

    size = dict(width=16, height=10, samples=4, max_depth=4, sphere_bvh="never",
                path_regen="never")
    js, jc, jcfg, ts, tc, tcfg = scenes("example.sdl", size)
    n, sid, lane = 160, 1, 35

    def jax_bounce(arrays):
        pix = jnp.arange(n, dtype=jnp.int32)
        keys = jrng.fold_all(jrng.fast_streams(jrng.key(0), pix), sid)
        ray = jgenerate(jc, (pix % 16).astype(jnp.float32), (pix // 16).astype(jnp.float32),
                        jnp.full((n,), 1.0), jnp.zeros((n,)), 2, 16, 10, keys)
        shade = jintegrator._make_shade(js, jcfg, jintegrator._pallas_policy(js, arrays, jcfg))
        o, d, _, _, alive = shade(arrays, ray, JVec3.ones((n,)), JVec3.zeros((n,)),
                                  jnp.ones(n, bool), jrng.fold_all(keys, 0))
        hit = jscene.intersect(js, arrays, JRay(o, d, ray.time), jcfg.t_min, jcfg.t_max,
                               jrng.fold_all(keys, 1))
        return hit.t, hit.mat_id, alive

    jt, jm, jalive = jax.jit(jax_bounce)(js.arrays)
    pix = torch.arange(n)
    keys = trng.fold_all(trng.fast_streams(0, pix), sid)
    ray = tgenerate(tc, (pix % 16).float(), (pix // 16).float(), torch.full((n,), 1.0),
                    torch.zeros(n), 2, 16, 10, keys)
    shade = tintegrator._make_shade(ts, tcfg, tintegrator.kernel_routes(ts, ts.arrays, tcfg))
    o, d, _, _, alive = shade(ts.arrays, ray.origin, ray.direction, TVec3.ones((n,)),
                              TVec3.zeros((n,)), torch.ones(n, dtype=torch.bool),
                              trng.fold_all(keys, 0), None)
    hit = tscene.intersect(ts, ts.arrays, TRay(o, d, ray.time), tcfg.t_min, tcfg.t_max)
    ground = int(np.flatnonzero(ts.arrays.spheres.radius.numpy() == 10000.0)[0])
    ground_mat = int(ts.arrays.spheres.mat_id[ground])
    assert bool(jalive[lane]) and bool(alive[lane])
    assert int(jm[lane]) == ground_mat and tcfg.t_min < float(jt[lane]) < 2e-3
    assert not bool(hit.valid[lane])
    # every other live lane's bounce hit is the same surface in both
    live = np.asarray(jalive) & alive.numpy()
    live[lane] = False
    assert np.array_equal(np.asarray(jm)[live], hit.mat_id.numpy()[live])


def _albedo_row(params):
    c1 = params.tex_color1.x.detach().numpy()
    return int(np.flatnonzero(np.abs(c1 - 0.6) < 1e-6)[0])


def test_grad_matches_finite_difference_albedo():
    scene, cam = small_scene(tir, TBuilder, tcamera, "cpu")
    cfg = TConfig(**SMALL)
    params = extract_params(scene.arrays)
    _, g = port_grad(scene, cam, cfg, params)
    row = _albedo_row(params)
    eps = 1e-2

    def f(delta):
        xs = [x.detach().clone() for x in leaves(params)]
        xs[0][row] += delta
        with torch.no_grad():
            img = render_image_diff(scene, cam, cfg, from_leaves(xs), 0,
                                    np.arange(cfg.effective_samples))
            return float(torch.mean(img.x + img.y + img.z))

    fd = (f(eps) - f(-eps)) / (2 * eps)
    np.testing.assert_allclose(g[0][row], fd, rtol=2e-2, atol=1e-5)
    assert abs(g[0][row]) > 1e-6


def test_grad_emitter_intensity_nonzero():
    scene, cam = small_scene(tir, TBuilder, tcamera, "cpu")
    _, g = port_grad(scene, cam, TConfig(**SMALL))
    assert np.abs(g[8]).max() > 1e-5 and g[8].max() > 0


def test_mesh_scene_grads_are_finite():
    """The mesh hit is detached; the other parameters still get gradients."""
    from raysnail_tpu_torch.scenes.meshes import uv_sphere

    v, f, n = uv_sphere(8, 12, center=(0.0, 0.0, -2.0))
    b = TBuilder()
    b.add(tir.Mesh(vertices=v, indices=f, normals=n,
                   material=tir.Lambertian(tir.Constant((0.7, 0.2, 0.2)))))
    b.add(tir.Sphere((2.0, 2.0, 0.0), 0.7, tir.DiffuseLight(tir.Constant((1, 1, 1)), 4.0)),
          light=True)
    scene = b.compile(device="cpu")
    cam = tcamera(look_from=(0, 0, 1), look_at=(0, 0, -2), fov=50, width=SMALL["width"],
                  height=SMALL["height"], device="cpu")
    params = extract_params(scene.arrays)
    img = render_image_diff(scene, cam, TConfig(**SMALL), params, 0, np.arange(4))
    torch.mean(img.x + img.y + img.z).backward()
    grads = [x.grad for x in leaves(params) if x.grad is not None]
    assert all(torch.isfinite(g).all() for g in grads)
    assert params.tex_color1.x.grad.abs().max() > 1e-7


@pytest.mark.parametrize("depth", [3, 5])
def test_ior_gradient_nan_rows_against_jax(depth):
    size = dict(width=8, height=6, samples=1, max_depth=depth)
    glass = dict(middle=lambda ir: ir.Dielectric(ior=1.5))
    js, jc = small_scene(jir, JBuilder, jcamera, **glass)
    ts, tc = small_scene(tir, TBuilder, tcamera, "cpu", **glass)
    tcfg = TConfig(**size)
    _, jg = jax_grad(js, jc, JConfig(**size))
    params = extract_params(ts.arrays)
    _, tg = port_grad(ts, tc, tcfg, params)
    glass_row = int(np.flatnonzero(ts.arrays.materials.param0.numpy() == 1.5)[0])
    assert np.isnan(jg[6]).all()  # the reference's fault: every row
    others = np.arange(len(tg[6])) != glass_row
    assert np.isnan(tg[6][others]).all()
    # every other leaf agrees (finite in both)
    for i in (0, 1, 2, 8):
        assert np.isfinite(tg[i]).all() and np.isfinite(jg[i]).all()
        assert np.abs(tg[i] - jg[i]).max() <= GRAD_RTOL * np.abs(jg[i]).max() + GRAD_ATOL
    if depth == 5:
        assert np.isnan(tg[6][glass_row])
        return
    # depth 3: no path through the glass reaches a term that depends on a
    # parameter, so the true gradient is 0; the port's is 0, and so is its
    # own finite difference
    assert tg[6][glass_row] == 0.0
    eps = 1e-2

    def f(delta):
        xs = [x.detach().clone() for x in leaves(params)]
        xs[6][glass_row] += delta
        with torch.no_grad():
            img = render_image_diff(ts, tc, tcfg, from_leaves(xs), 0, np.arange(1))
            return float(torch.mean(img.x + img.y + img.z))

    assert f(eps) == f(-eps)


def test_scene_params_carry_over_from_jax():
    js, _ = small_scene(jir, JBuilder, jcamera)
    ts, _ = small_scene(tir, TBuilder, tcamera, "cpu")
    jp = jax.tree_util.tree_map(np.asarray, jextract(js.arrays))
    p = scene_params_from_numpy(jp, "cpu")
    assert isinstance(p, SceneParams)
    for a, b in zip(leaves(p), leaves(extract_params(ts.arrays))):
        assert a.requires_grad and a.is_leaf
        assert torch.equal(a.detach(), b.detach())
    arrays = inject_params(ts.arrays, p)
    assert arrays.materials.emit_mult is p.emit_mult
    assert arrays.textures.color2.z is p.tex_color2.z


def test_cosine_power_lobe_gradient_trap_in_both_packages():
    """The cos^e lobe sample takes sqrt(max(0, 1 - z * z)) with z =
    u2^(1/(e+1)) (prelude/sampling.py). Where z rounds to 1 the square
    root's derivative is infinite: a candidate direction that the rejection
    sampler drops (a zero cotangent) gives the exponent 0 * inf = NaN. A
    fault of the reference (ROADMAP section 3), which the port computes
    alike; in a train step on a DiffuseMetal or BlinnPhong scene it makes
    that exponent's gradient NaN once some draw has u2 within (e + 1) ulps
    of 1."""
    from raysnail_tpu.prelude import sampling as jsampling
    from raysnail_tpu_torch.prelude import sampling as tsampling

    u1 = np.array([0.3, 0.3, 0.3], np.float32)
    u2 = np.array([0.5, 1.0 - 2.0 ** -24, 1.0 - 2.0 ** -24], np.float32)
    e = np.full(3, 30.0, np.float32)
    w = np.array([1.0, 1.0, 0.0], np.float32)  # the third candidate is dropped

    def jf(e):
        d = jsampling.cosine_power_direction(e, jnp.asarray(u1), jnp.asarray(u2))
        return jnp.sum((d.x + d.y + d.z) * jnp.asarray(w))

    jg = np.asarray(jax.grad(jf)(jnp.asarray(e)))
    te = torch.tensor(e, requires_grad=True)
    d = tsampling.cosine_power_direction(te, torch.tensor(u1), torch.tensor(u2))
    torch.sum((d.x + d.y + d.z) * torch.tensor(w)).backward()
    tg = te.grad.numpy()
    assert float(d.z[1].detach()) == 1.0  # z rounded to 1
    assert np.isfinite(jg[0]) and np.isfinite(tg[0])
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5)
    assert np.isnan(jg[2]) and np.isnan(tg[2])  # the dropped candidate
    assert not np.isfinite(jg[1]) and not np.isfinite(tg[1])
