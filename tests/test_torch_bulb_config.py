"""The benchmark's Mandelbulb configuration (`mandelbulb-preview`) on the
CPU: the port against the plain reference `benchmark/reference/bulb.py`,
and the `correct` check of `benchmark/drivers/adaptive.py`.

  * the configuration lowers to the scene that `utils.golden` and the
    previewer example build;
  * `render.render_passes` on the configuration cut to 32x20 at 4 samples,
    depth 8, 3 passes, against the reference per pixel, the reference's
    redo taken from the program's own image of the pass before;
  * the reference's march against the port's plain march on seeded rays;
  * that check reads `correct` false under each planted fault.

Tolerances (tests/test_torch_passes.py's, for its reason): both sides key
every draw by (seed, pixel, sample, bounce), so they trace the same
paths; per pixel and channel |d| <= 1e-4 on at least 98% of the pixels
once passes redo (the rest are paths in which an ulp flipped a branch,
and pixels whose noise lies within an ulp of the threshold) and the mean
within 1e-4.
"""

import numpy as np
import pytest
import torch

from benchmark import harness, scenes
from benchmark.drivers import adaptive
from benchmark.reference import bulb
from benchmark.reference.vec import V3
from benchmark.tests import helpers
from raysnail_tpu_torch.ops import mandelbulb_march as mm
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.render import make_sample_step, render_passes

PIXEL_ATOL, MEAN_ATOL = 1e-4, 1e-4
CELL = "bulb-passes4"


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(**traffic):
    cell = harness.Cell(CELL)
    cell.traffic.update(traffic)
    return cell


def _arrays_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, Vec3):
        return isinstance(b, Vec3) and _arrays_equal((a.x, a.y, a.z), (b.x, b.y, b.z))
    if isinstance(a, tuple):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_arrays_equal(x, y) for x, y in zip(a, b)))
    if hasattr(a, "__dict__"):
        return type(a) is type(b) and _arrays_equal(tuple(vars(a).values()),
                                                     tuple(vars(b).values()))
    return a == b


def test_the_configuration_is_the_ports_bulb_scene():
    from raysnail_tpu_torch.examples import preview
    from raysnail_tpu_torch.utils import golden

    cell = _cell()
    cfg = adaptive.render_config(cell.config, cell.traffic)
    mine = adaptive.builder(cell.config).compile(cfg.dtype, "cpu")
    cam = scenes.camera(cell.config, cfg, "cpu")
    for scene, camera in (golden.mandelbulb_scene(cfg, "cpu"), preview.build("mandelbulb", "cpu")):
        assert _arrays_equal(scene.arrays, mine.arrays)
        assert scene.mandelbulbs == mine.mandelbulbs and scene.static == mine.static
        assert _arrays_equal(tuple(camera), tuple(cam))


@pytest.mark.parametrize("seed", [5, 2**32 - 3])
def test_passes_match_the_reference(seed):
    cell = _cell(width=32, height=20, samples=4, passes=3)
    cfg = adaptive.render_config(cell.config, cell.traffic)
    assert cfg.max_depth == 8
    scene = adaptive.builder(cell.config).compile(cfg.dtype, "cpu")
    camera = scenes.camera(cell.config, cfg, "cpu")
    images = []
    render_passes(scene, camera, cfg, seed=seed,
                  progress=lambda done, total, img: images.append(img.copy()))
    assert len(images) == cfg.passes
    imgs = [torch.from_numpy(a) for a in images]
    masks = bulb.redo_masks(imgs, cfg.noise_threshold, cfg.passes)
    assert len(masks) == cfg.passes - 1
    for k, mask in enumerate(masks, start=1):
        changed = (imgs[k] != imgs[k - 1]).any(-1).reshape(-1)
        assert 0 < int(changed.sum()) <= int(mask.sum()) < mask.numel()
        assert not bool((changed & ~mask).any())
    image = dict(width=cfg.width, height=cfg.height, samples=cfg.samples,
                 max_depth=cfg.max_depth)
    ref_scene = bulb.build(cell.config, cfg.width, cfg.height)
    pixels = torch.arange(cfg.width * cfg.height)
    (want,) = bulb.pass_averages(ref_scene, image, [(seed, pixels, masks)])
    got = images[-1].reshape(-1, 3)
    d = np.abs(got - want.numpy()).max(-1)
    assert np.isfinite(got).all() and (d <= PIXEL_ATOL).mean() >= 0.98, d.max()
    assert np.abs(got.mean(0) - want.numpy().mean(0)).max() <= MEAN_ATOL


def test_the_reference_march_is_the_ports_plain_march():
    g = torch.Generator().manual_seed(11)
    n = 3000
    o = (torch.rand(3, n, generator=g) * 2 - 1) * 3
    d = (torch.rand(3, n, generator=g) * 2 - 1) * 0.9 - o
    d = d / d.norm(dim=0)
    active = torch.rand(n, generator=g) < 0.9
    t, valid, normal, u, v, counts = mm.mandelbulb_march_plain(o, d, 1e-3, 3e4, active,
                                                               stats=True)
    rt, rvalid, rnormal, ru, rv, rcounts = bulb.march(V3(*o), V3(*d), 1e-3, 3e4, active,
                                                      counts=True)
    assert 0 < int(valid.sum()) < n
    assert torch.equal(t, rt) and torch.equal(valid, rvalid)
    assert all(torch.equal(normal[i], rnormal[i]) for i in range(3))
    assert torch.equal(u, ru) and torch.equal(v, rv) and torch.equal(counts.long(), rcounts)


def _de12(driver, seed):
    """The DE over 12 iterations instead of 24."""
    full = mm.distance_est
    mm.distance_est = lambda px, py, pz, iterations=24, counts=False: full(px, py, pz, 12,
                                                                          counts)
    try:
        return driver.passes(seed)
    finally:
        mm.distance_est = full


def _same_seed(driver, seed):
    """Every pass seeded with the frame's seed instead of seed + k."""
    step = make_sample_step(driver.scene, driver.cfg)
    return driver.passes(seed, step=lambda arrays, camera, _, ids, px, py: step(
        arrays, camera, seed, ids, px, py))


def _skipped_pass(driver, seed):
    """The last redo pass left out."""
    return driver.passes(seed, cfg=driver.cfg.replace(passes=driver.cfg.passes - 1))


@pytest.mark.parametrize("fault", [_de12, _same_seed, _skipped_pass])
def test_a_planted_fault_is_not_correct(fault):
    cell = _cell(width=16, height=10, samples=1, passes=2, check_pixels=96, check_frames=1)
    checks, failed, correct = helpers.drive(cell, units=1, fault=fault)
    assert not correct and failed == 1, checks


def test_a_sound_run_is_correct():
    cell = _cell(width=16, height=10, samples=1, passes=2, check_pixels=96, check_frames=1)
    checks, failed, correct = helpers.drive(cell, units=1)
    assert correct and failed == 0, checks
