"""The port's scan integrator and threefry keys against the JAX package's, on
the CPU.

  * Threefry: `prelude/rng.py`'s keys and uniforms bit for bit against the
    installed JAX's `jax.random` on 10^5 ids (JAX 0.9.0 with
    jax_threefry_partitionable on, which the test pins).
  * The scan integrator (`integrator.radiance`, taken by path_regen="never"
    and by rng="threefry") on example.sdl at 96x64@4spp against the JAX
    package's render of the same configuration: the tolerances of
    tests/test_torch_render.py (|d| <= 1e-4 on 99% of the pixels, gamma
    off, channel means within 1e-4; readings: fast 0.9940 and 9.1e-6,
    threefry 0.9941 and 1.1e-5).
  * The scan against the port's regeneration integrators: with the fast RNG
    both draw from fold_all(fold_all(streams, sample), bounce), so they
    trace the same paths and differ only in summation order: the same pixel
    tolerances (reading: every pixel within 1e-4, means equal). With
    threefry the draws differ: the channel means within 0.01 of the default
    frame's (reading 8.9e-4, on means of 0.23-0.25).
  * `make_frame_step` returns None where the frame step does not apply.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import integrator as jintegrator
from raysnail_tpu.camera import generate_rays as jgenerate_rays
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.render import render as jrender
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera, generate_rays
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.painter import RenderSession
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.render import make_frame_step, render, render_passes
from raysnail_tpu_torch.scene import SceneBuilder
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "sdl", "example.sdl")
SIZE = dict(width=96, height=64, samples=4, max_depth=8, gamma=False)
SEED = 7
PIXEL_ATOL, PIXEL_SHARE, MEAN_ATOL = 1e-4, 0.99, 1e-4
THREEFRY_MEAN_ATOL = 0.01
N_IDS = 100_000


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(img, ref, mean_atol=MEAN_ATOL):
    assert img.shape == ref.shape == (SIZE["height"], SIZE["width"], 3)
    assert np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE, ((d <= PIXEL_ATOL).mean(), d.max())
    dmean = np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max()
    assert dmean <= mean_atol, dmean


def test_threefry_keys_and_uniforms_are_jax_random_bit_for_bit():
    assert jax.__version__ == "0.9.0" and jax.config.jax_threefry_partitionable, (
        "the threefry draws are pinned to JAX 0.9.0 with jax_threefry_partitionable on; "
        f"this is JAX {jax.__version__} with the flag {jax.config.jax_threefry_partitionable}")
    ids = (np.arange(N_IDS, dtype=np.uint64) * 2654435761 % 2**32).astype(np.uint32)
    tids = torch.from_numpy(ids.astype(np.int64))

    def same(t, j):
        return np.array_equal(t.numpy(), np.asarray(j).astype(np.int64))

    assert same(prng.key(5), jax.random.PRNGKey(5))
    k, tk = jax.random.fold_in(jrng.key(5), 3), prng.fold(prng.key(5), 3)
    assert same(tk, k)
    keys, tkeys = jrng.per_ray_keys(k, jnp.asarray(ids)), prng.per_ray_keys(tk, tids)
    assert same(tkeys, keys)
    assert same(prng.fold_all(tkeys, prng.SCATTER), jrng.fold_all(keys, prng.SCATTER))
    # a per-lane tag, as the regeneration loops fold sample ids
    tag = np.arange(N_IDS, dtype=np.uint32) % 97
    assert same(prng.fold_all(tkeys, torch.from_numpy(tag.astype(np.int64))),
                jax.vmap(jax.random.fold_in)(keys, jnp.asarray(tag)))
    for t, j in zip(prng.ray_uniforms(tkeys, 7), jrng.ray_uniforms(keys, 7)):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), np.asarray(j))
    u = torch.stack(prng.ray_uniforms(tkeys, 7))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.fixture(scope="module")
def scenes():
    jcfg = JConfig(**SIZE)
    cfg = TConfig(**SIZE)
    return jbuild(SCENE, jcfg), tbuild(SCENE, cfg, "cpu"), jcfg, cfg


@pytest.fixture(scope="module")
def regen_image(scenes):
    _, (scene, camera), _, cfg = scenes
    return render(scene, camera, cfg, seed=SEED)


@pytest.mark.parametrize("setting", [{"path_regen": "never"}, {"rng": "threefry"}],
                         ids=["fast", "threefry"])
def test_scan_render_matches_jax(scenes, setting):
    (jscene, jcam), (scene, camera), jcfg, cfg = scenes
    ref = jrender(jscene, jcam, jcfg.replace(**setting), seed=SEED)
    _assert_close(render(scene, camera, cfg.replace(**setting), seed=SEED), ref)


def test_scan_matches_the_regeneration_integrators(scenes, regen_image):
    (_, _), (scene, camera), _, cfg = scenes
    scan = render(scene, camera, cfg.replace(path_regen="never"), seed=SEED)
    _assert_close(scan, regen_image)
    threefry = render(scene, camera, cfg.replace(rng="threefry"), seed=SEED)
    dmean = np.abs(threefry.mean(axis=(0, 1)) - regen_image.mean(axis=(0, 1))).max()
    assert dmean <= THREEFRY_MEAN_ATOL, dmean
    assert np.abs(threefry - regen_image).max() > 0.01  # other random numbers


def _primary(camera, cfg, device="cpu"):
    w, h = cfg.width, cfg.height
    p = torch.arange(w * h)
    keys = prng.fold_all(prng.fast_streams(SEED, p), 0)
    z = torch.zeros(w * h)
    return generate_rays(camera, (p % w).float(), (p // w).float(), z, z, cfg.sqrt_spp, w, h,
                         keys), keys


def test_radiance_and_alive_counts_the_live_lanes_as_jax_does(scenes):
    (jscene, jcam), (scene, camera), jcfg, cfg = scenes
    ray, keys = _primary(camera, cfg)
    L, counts = integrator.radiance_and_alive(scene, scene.arrays, cfg, ray, keys)
    assert counts.dtype == torch.int32 and counts.shape == (cfg.max_depth,)
    assert bool((counts[1:] <= counts[:-1]).all()) and int(counts[0]) > 0
    assert torch.equal(integrator.radiance(scene, scene.arrays, cfg, ray, keys).x, L.x)
    n = cfg.width * cfg.height
    p = jnp.arange(n, dtype=jnp.uint32)
    jkeys = jrng.fold_all(jrng.fast_streams(jrng.key(SEED), p), 0)
    z = jnp.zeros(n, jnp.float32)
    jray = jgenerate_rays(jcam, (p % cfg.width).astype(jnp.float32),
                          (p // cfg.width).astype(jnp.float32), z, z, cfg.sqrt_spp,
                          cfg.width, cfg.height, jkeys)
    jL, jcounts = jintegrator.radiance_and_alive(jscene, jscene.arrays, jcfg, jray, jkeys)
    # a path whose branch flipped by an ulp may live a bounce more or less
    assert np.abs(counts.numpy() - np.asarray(jcounts)).max() <= 0.005 * n, (
        counts, np.asarray(jcounts))
    d = np.abs(L.to_array().numpy() - np.asarray(jL.to_array())).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE


def test_frame_step_is_none_where_the_sample_step_path_renders():
    cfg = TConfig(width=16, height=8, samples=4, max_depth=3)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    assert make_frame_step(scene, cfg) is not None
    assert make_frame_step(scene, cfg.replace(rng="threefry")) is None
    assert make_frame_step(scene, cfg.replace(path_regen="never")) is None
    bulb = SceneBuilder().add(ir.Mandelbulb(material=ir.Lambertian(ir.Constant((0.8, 0.7, 0.6)))))
    bulb = bulb.add(ir.Sphere((3, 5, 3), 1.0, ir.DiffuseLight(ir.Constant((1, 1, 1)), 6.0)),
                    light=True).compile(device="cpu")
    assert make_frame_step(bulb, cfg) is None
    cam = build_camera(look_from=(2.2, 1.4, 2.2), look_at=(0, 0, 0), fov=45, width=16, height=8,
                       device="cpu")
    img = render_passes(bulb, cam, cfg.replace(passes=2), seed=1)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all() and img.std() > 0.01
    for setting in ({"rng": "threefry"}, {"path_regen": "never"}):
        img = render(scene, camera, cfg.replace(**setting), seed=1)
        assert img.shape == (8, 16, 3) and np.isfinite(img).all() and img.std() > 0.01
        # the painter's session takes the same sample step, in one chunk here
        session = RenderSession(scene, camera, cfg.replace(**setting), seed=1)
        assert np.array_equal(session.render(), img)


def test_scan_sample_sums_take_any_sample_ids(scenes):
    """The scan path folds each id in turn, so ids need not be contiguous
    (only the regeneration integrator reads them as a range): the sums of
    ids {0, 2} are the sums of id 0 plus those of id 2."""
    from raysnail_tpu_torch.render import sample_sums

    (_, _), (scene, camera), _, cfg = scenes
    cfg = cfg.replace(rng="threefry", width=16, height=8)
    px = torch.arange(16, dtype=torch.float32).repeat(2)
    py = torch.arange(2, dtype=torch.float32).repeat_interleave(16)
    both = sample_sums(scene, cfg, scene.arrays, camera, 3, [0, 2], px, py)
    one = [sample_sums(scene, cfg, scene.arrays, camera, 3, [s], px, py) for s in (0, 2)]
    assert torch.equal(both.x, one[0].x + one[1].x)
