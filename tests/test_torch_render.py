"""The port's forward render against the JAX package's, on the CPU.

example.sdl at 96x64@4spp, seed 7, through both packages' full-frame path
(shuffled path regeneration). Every draw is keyed by (seed, pixel, sample,
bounce, purpose) in both, so the two renders trace the same paths and agree
pixel for pixel up to float rounding.

Tolerances, per pixel and channel, gamma off: |d| <= 1e-4 on at least 99% of
the pixels, and the global mean of each channel within 1e-4. Most pixels
agree to a few ulps; the rest are paths in which one branch flipped, because
torch's and XLA's sin (the checker sign) or a grazing hit near t_min rounds
an ulp apart, and a flipped path moves its pixel by up to a few hundredths.
Measured on this image: 0.6% of pixels beyond 1e-4 (the largest 0.04) and a
mean difference of 9e-6. The render is held against the committed golden anchor with the JAX
package's own check_anchor tolerances as well.
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.render import render as jrender
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu.utils import golden
from raysnail_tpu_torch import cli
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import camera_from_numpy, scene_arrays_from_numpy
from raysnail_tpu_torch.render import make_frame_step, render, render_passes
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "sdl", "example.sdl")
SIZE = dict(width=96, height=64, samples=4, max_depth=8)
SEED = 7
PIXEL_ATOL = 1e-4
PIXEL_SHARE = 0.99
MEAN_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_image():
    cfg = JConfig(gamma=False, **SIZE)
    scene, camera = jbuild(SCENE, cfg)
    return scene, camera, jrender(scene, camera, cfg, seed=SEED)


def _assert_close(img, ref):
    assert img.shape == ref.shape == (SIZE["height"], SIZE["width"], 3)
    assert np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= PIXEL_SHARE, ((d <= PIXEL_ATOL).mean(), d.max())
    dmean = np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max()
    assert dmean <= MEAN_ATOL, dmean


def test_render_matches_jax(jax_image):
    """The port end to end: its own parse, compile, camera and render."""
    _, _, ref = jax_image
    cfg = TConfig(gamma=False, **SIZE)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    _assert_close(render(scene, camera, cfg, seed=SEED), ref)


def test_render_of_converted_scene_matches_jax(jax_image):
    """The JAX package's compiled arrays and camera carried over: only the
    render path differs."""
    jscene, jcam, ref = jax_image
    cfg = TConfig(gamma=False, **SIZE)
    scene, _ = tbuild(SCENE, cfg, "cpu")
    arrays = scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    camera = camera_from_numpy(jax.tree_util.tree_map(np.asarray, jcam), "cpu")
    _assert_close(render(scene, camera, cfg, seed=SEED, arrays=arrays), ref)


def test_render_holds_the_golden_anchor():
    cfg = TConfig(**SIZE)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    fresh = golden.anchor_stats(render_passes(scene, camera, cfg, seed=SEED))
    ref = golden.load_golden()["example.sdl"]
    assert fresh["thumb"].shape == ref["thumb"].shape
    assert np.abs(fresh["thumb"] - ref["thumb"]).max() <= 0.01
    assert np.abs(fresh["mean"] - ref["mean"]).max() <= 0.003


def test_frame_step_counts_iterations_and_refuses_unported_settings():
    cfg = TConfig(width=16, height=8, samples=4, max_depth=3)
    scene, camera = tbuild(SCENE, cfg, "cpu")
    sums, iterations = make_frame_step(scene, cfg)(scene.arrays, camera, 0)
    # at least one shade per cell of the one chunk, at most max_depth per cell
    assert 4 <= iterations <= 4 * 3
    assert sums.x.shape == (16 * 8,)
    with pytest.raises(NotImplementedError, match="ROADMAP M18"):
        make_frame_step(scene, cfg.replace(rng="threefry"))
    with pytest.raises(NotImplementedError, match="ROADMAP M8"):
        render_passes(scene, camera, cfg.replace(passes=2))


def test_cli_writes_a_png(tmp_path, capsys):
    out = tmp_path / "example.png"
    rc = cli.main(["--scene", SCENE, "-w", "32", "--height", "20", "--samples", "4",
                   "--device", "cpu", "-o", str(out)])
    assert rc == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (20, 32, 3) and img.dtype == np.uint8
    assert img.std() > 5  # not a flat image
    assert "Mprimary-rays/s" in capsys.readouterr().out
