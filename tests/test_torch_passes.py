"""The port's sample-step path and adaptive passes against the JAX
package's, on the CPU.

  * `calc_noise` (PyTorch) and its mask equal the JAX package's numpy
    `calc_noise` and its threshold, and `_tile_grid` (the tile order in
    closed form) and `_sample_chunks` equal the JAX package's;
  * `render_sums` over the tile-ordered pixel list and `render_passes` with
    passes=3, example.sdl at 96x64@4spp, against the JAX package's per pixel;
  * `sample_sums` on a sparse pixel list of a small mesh scene against the
    JAX package's, and the port's two integrators against each other:
    `radiance_regen` (one lane per pixel, tile order) and
    `radiance_regen_shuffle` compute the same per-pixel sums for the same
    (pixel, sample) keys.

Tolerances. Both packages key every draw by (seed, pixel, sample, bounce),
so they trace the same paths: per pixel and channel |d| <= 1e-4 on at least
99% of the pixels and the global mean within 1e-4, as in
tests/test_torch_render.py (the rest are paths in which an ulp flipped a
branch). With passes the noise mask adds pixels whose noise lies within an
ulp of the threshold and so are redone in one package only: the share is
98% there. The port's two integrators differ in summation order only: atol
2e-5 on the sums, as the JAX package's own test of its frame step.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu import render as jrender
from raysnail_tpu.camera import build_camera as jbuild_camera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import render as trender
from raysnail_tpu_torch.camera import build_camera as tbuild_camera
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.prelude import rng as trng
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder
from raysnail_tpu_torch.scenes.meshes import uv_sphere
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "sdl", "example.sdl")
SIZE = dict(width=96, height=64, samples=4, max_depth=8)
SEED = 7
PIXEL_ATOL, MEAN_ATOL = 1e-4, 1e-4
THRESHOLD = 0.05  # flags about a third of this image's pixels


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_close(img, ref, share):
    assert img.shape == ref.shape and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= share, ((d <= PIXEL_ATOL).mean(), d.max())
    dmean = np.abs(img.reshape(-1, 3).mean(0) - ref.reshape(-1, 3).mean(0)).max()
    assert dmean <= MEAN_ATOL, dmean


# -- the noise mask, the tile order and the chunks -------------------------------

@pytest.mark.parametrize("compat_bug", [False, True])
@pytest.mark.parametrize("shape", [(40, 56), (7, 9), (9, 4)])
def test_calc_noise_equals_jax(shape, compat_bug):
    """The noise bit for bit, and the mask at a threshold that a pixel's
    noise meets exactly."""
    img = np.random.default_rng(3).random((*shape, 3)).astype(np.float32)
    got = trender.calc_noise(torch.from_numpy(img), compat_bug).numpy()
    want = jrender.calc_noise(img, compat_bug)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.max() > 0
    t = float(np.median(want))
    mask = trender.noise_mask(torch.from_numpy(img), t, compat_bug).numpy()
    assert np.array_equal(mask, want >= t) and 0 < mask.sum() < mask.size


@pytest.mark.parametrize("size", [(96, 64), (100, 37), (16, 8), (1000, 600), (5, 3)])
def test_tile_grid_and_sample_chunks_equal_jax(size):
    w, h = size
    tcfg, jcfg = TConfig(width=w, height=h, samples=36), JConfig(width=w, height=h, samples=36)
    for a, b in zip(trender._tile_grid(tcfg), jrender._tile_grid(jcfg)):
        assert np.array_equal(a, b)
    px, py, inv = trender._tile_grid(tcfg)
    if w % 16 == 0 and h % 8 == 0:  # 128 consecutive lanes are one 16x8 tile
        tile = (py[:128] // 8 * (w // 16) + px[:128] // 16)
        assert (tile == tile[0]).all()
    assert np.array_equal(np.sort(inv), np.arange(w * h))
    for n_pix, budget in ((w * h, None), (w * h, 5 * w * h), (1000, 1 << 12)):
        assert (trender._sample_chunks(tcfg, n_pix, budget=budget)
                == jrender._sample_chunks(jcfg, n_pix, budget=budget))


# -- example.sdl through the sample step and the pass loop ----------------------

@pytest.fixture(scope="module")
def jax_example():
    cfg = JConfig(gamma=False, **SIZE)
    scene, camera = jbuild(SCENE, cfg)
    return scene, camera, cfg


def test_render_sums_in_tile_order_matches_jax(jax_example):
    jscene, jcam, jcfg = jax_example
    px, py, inv = jrender._tile_grid(jcfg)
    jsums = jrender.render_sums(jscene, jcam, jcfg, SEED, px, py)
    ref = np.asarray(jsums.to_array())[inv].reshape(64, 96, 3) / jcfg.effective_samples

    cfg = TConfig(gamma=False, **SIZE)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    px, py, inv = trender._tile_grid(cfg)
    sums = trender.render_sums(scene, camera, cfg, SEED, px, py)
    img = sums.to_array().numpy()[inv].reshape(64, 96, 3) / cfg.effective_samples
    _assert_close(img, ref, share=0.99)
    # the frame step computes the same sums in another lane order
    frame, _ = trender.make_frame_step(scene, cfg)(scene.arrays, camera, SEED)
    np.testing.assert_allclose(frame.to_array().numpy().reshape(64, 96, 3) / 4, img, atol=2e-5)


def test_render_sums_chunks_by_ray_batch():
    """A small ray budget splits the samples over several steps; the sums
    are the same."""
    cfg = TConfig(gamma=False, width=32, height=16, samples=4, max_depth=4)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    px, py, _ = trender._tile_grid(cfg)
    calls = []
    step = trender.make_sample_step(scene, cfg.replace(ray_batch=32 * 16 * 2))

    def counting(arrays, cam, seed, ids, px, py):
        calls.append(list(ids))
        return step(arrays, cam, seed, ids, px, py)

    split = trender.render_sums(scene, camera, cfg.replace(ray_batch=32 * 16 * 2), SEED,
                                px, py, step=counting)
    whole = trender.render_sums(scene, camera, cfg, SEED, px, py)
    assert calls == [[0, 1], [2, 3]]
    np.testing.assert_allclose(split.to_array().numpy(), whole.to_array().numpy(), atol=2e-5)


@pytest.mark.parametrize("compat_bug", [False, True])
def test_render_passes_matches_jax(jax_example, compat_bug):
    jscene, jcam, jcfg = jax_example
    extra = dict(passes=3, noise_threshold=THRESHOLD, compat_noise_bug=compat_bug)
    done = []
    ref = jrender.render_passes(jscene, jcam, jcfg.replace(**extra), seed=SEED)
    cfg = TConfig(gamma=False, **SIZE, **extra)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    img = trender.render_passes(scene, camera, cfg, seed=SEED,
                                progress=lambda d, t, im: done.append((d, t)))
    assert done == [(4, 12), (8, 12), (12, 12)]
    _assert_close(img, ref, share=0.98)
    first = trender.render(scene, camera, cfg, seed=SEED)
    changed = (np.abs(img - first).max(axis=-1) > 0).mean()
    assert 0.05 < changed < 0.95, changed  # the later passes redid some pixels, not all


def test_render_passes_stops_when_nothing_is_noisy_or_on_cancel():
    cfg = TConfig(width=32, height=16, samples=4, max_depth=3, passes=3, noise_threshold=1e9)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    done = []
    img = trender.render_passes(scene, camera, cfg, seed=1,
                                progress=lambda d, t, im: done.append(d))
    assert done == [4] and np.array_equal(img, trender.render(scene, camera, cfg, seed=1))
    noisy = cfg.replace(noise_threshold=0.0)
    trender.render_passes(scene, camera, noisy, seed=1,
                          progress=lambda d, t, im: done.append(d) or d < 8)
    assert done == [4, 4, 8]  # cancelled after the second pass


@pytest.mark.parametrize("compat_bug", [False, True])
def test_later_passes_redo_the_host_construction_s_list(compat_bug):
    """Each later pass's pixel list, as the sample step meets it, is the one
    the host built from the pass before: the JAX package's noise of the
    program's previous image at the threshold, in row-major order, stably
    sorted by the JAX package's tile key. `progress` gets (H, W, 3) float32
    numpy images and `redone_pixels` counts the lists."""
    cfg = TConfig(gamma=False, **SIZE, passes=3, noise_threshold=THRESHOLD,
                  compat_noise_bug=compat_bug)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    inner, met, images = trender.make_sample_step(scene, cfg), {}, []

    def recording(arrays, cam, seed, ids, px, py):
        met[seed] = (np.asarray(px), np.asarray(py))
        return inner(arrays, cam, seed, ids, px, py)

    def keep(done, total, img):
        assert isinstance(img, np.ndarray) and img.dtype == np.float32
        assert img.shape == (cfg.height, cfg.width, 3)
        images.append(img.copy())

    redone = trender.render_passes.redone_pixels
    trender.render_passes(scene, camera, cfg, seed=SEED, step=recording, progress=keep)
    assert sorted(met) == [SEED, SEED + 1, SEED + 2] and len(images) == 3
    w = cfg.width
    for k in (1, 2):
        idx = np.flatnonzero(jrender.calc_noise(images[k - 1], compat_bug) >= THRESHOLD)
        idx = idx[np.argsort(jrender._tile_key(idx % w, idx // w, w), kind="stable")]
        px, py = met[SEED + k]
        assert 0 < idx.size < w * cfg.height
        assert np.array_equal(px, (idx % w).astype(np.float32))
        assert np.array_equal(py, (idx // w).astype(np.float32))
    assert trender.render_passes.redone_pixels - redone == met[SEED + 1][0].size + \
        met[SEED + 2][0].size


# -- the two integrators on a small mesh scene ----------------------------------

def _mesh_scene(ir, new_scene, build_camera, cfg, **cam_kw):
    v, f, n = uv_sphere(10, 14, center=(0.0, 0.0, -3.0))
    b = new_scene()
    b.add(ir.Mesh(vertices=v, indices=f, normals=n,
                  material=ir.Lambertian(ir.Constant((0.6, 0.4, 0.3)))))
    b.add(ir.Sphere((0, -101.0, -3), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((3, 4, 0), 0.8, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
          light=True)
    cam = build_camera((0, 0, 1), (0, 0, -3), fov=50, width=cfg.width, height=cfg.height,
                       **cam_kw)
    on = {k: v for k, v in cam_kw.items() if k == "device"}  # the port's compile takes it too
    return b.compile(**on), cam


MESH = dict(width=32, height=16, samples=4, max_depth=3, mesh_pallas="force")


@pytest.mark.parametrize("packet", ["auto", "force"])
def test_regen_per_pixel_equals_regen_shuffle(packet):
    """32x16 = 4 packets of 16x8 tiles: the frame step rotates whole tiles,
    the sample step keeps lane = pixel in tile order; same keys, same sums."""
    cfg = TConfig(**MESH, bvh_packet=packet)
    scene, cam = _mesh_scene(tir, TBuilder, tbuild_camera, cfg, device="cpu")
    frame, n_frame = integrator.radiance_regen_shuffle(scene, scene.arrays, cfg, cam, 4, 4)
    px, py, inv = trender._tile_grid(cfg)
    sums = trender.sample_sums(scene, cfg, scene.arrays, cam, 4, np.arange(4), px, py)
    # the integrator itself, for its iteration count: at least one shade per
    # sample, at most max_depth
    tpx, tpy = torch.from_numpy(px), torch.from_numpy(py)
    keys0 = trng.fast_streams(4, tpy.long() * cfg.width + tpx.long())
    again, n_step = integrator.radiance_regen(scene, scene.arrays, cfg, cam, tpx, tpy, keys0,
                                              0, 4)
    assert torch.equal(again.to_array(), sums.to_array())
    assert 4 <= n_step <= 4 * 3 and 4 <= n_frame <= 4 * 3
    np.testing.assert_allclose(sums.to_array().numpy()[inv], frame.to_array().numpy(),
                               atol=2e-5)
    assert float(frame.to_array().std()) > 0.1


def test_sample_sums_matches_jax_on_a_sparse_pixel_list():
    jcfg = JConfig(**MESH)
    jscene, jcam = _mesh_scene(jir, JBuilder, jbuild_camera, jcfg)
    rng = np.random.default_rng(9)
    idx = np.sort(rng.choice(32 * 16, 200, replace=False))
    px, py = (idx % 32).astype(np.float32), (idx // 32).astype(np.float32)
    ids = np.arange(1, 4)  # a range that does not start at 0
    want = jrender.sample_sums(jscene, jcfg, jscene.arrays, jcam, jrng.key(5),
                               jnp.asarray(ids, jnp.int32), jnp.asarray(px), jnp.asarray(py))
    cfg = TConfig(**MESH)
    scene, cam = _mesh_scene(tir, TBuilder, tbuild_camera, cfg, device="cpu")
    got = trender.sample_sums(scene, cfg, scene.arrays, cam, 5, ids, px, py)
    d = np.abs(got.to_array().numpy() - np.asarray(want.to_array())).max(axis=-1)
    assert (d <= 3 * PIXEL_ATOL).mean() >= 0.99, ((d <= 3 * PIXEL_ATOL).mean(), d.max())
    assert float(got.to_array().std()) > 0.1


def test_sample_sums_refuses_what_it_would_misread():
    cfg = TConfig(width=16, height=8, samples=4, max_depth=2)
    scene, cam = tbuild(SCENE, cfg, "cpu")
    px, py = np.zeros(4, np.float32), np.arange(4, dtype=np.float32)
    with pytest.raises(ValueError, match="contiguous"):
        trender.sample_sums(scene, cfg, scene.arrays, cam, 0, [0, 2, 3], px, py)
    with pytest.raises(NotImplementedError, match="regen_window"):
        trender.sample_sums(scene, cfg.replace(regen_window=2), scene.arrays, cam, 0, [0], px,
                            py)
    empty = trender.sample_sums(scene, cfg, scene.arrays, cam, 0, [], px, py)
    assert float(empty.to_array().abs().max()) == 0.0
