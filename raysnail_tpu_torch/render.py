"""L6 execution: the full-frame render step and the pass driver.

A frame is one call of the shuffled path-regeneration integrator over every
pixel and every effective sample, then the color transform. Only the first
(full) pass is ported: adaptive redo passes need the sample-step path
(ROADMAP M8), so `render_passes` raises for passes > 1.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude import color as colorlib


def make_frame_step(scene: scenelib.Scene, cfg: RenderConfig):
    """FULL-FRAME step through the shuffled path-regeneration integrator:
    step(arrays, camera, seed) -> ((W*H,) Vec3 radiance sums in row-major
    pixel order, iteration count)."""
    problems = cfg.unsupported()
    if problems:
        raise NotImplementedError("not ported yet: " + "; ".join(problems))

    def step(arrays: scenelib.SceneArrays, camera: Camera, seed: int):
        return integrator.radiance_regen_shuffle(scene, arrays, cfg, camera, seed,
                                                 cfg.effective_samples)

    return step


def render(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
           seed: int = 0, arrays=None) -> np.ndarray:
    """Single-pass full frame -> (H, W, 3) float32 display image (numpy)."""
    accum, _ = make_frame_step(scene, cfg)(
        arrays if arrays is not None else scene.arrays, camera, seed)
    img = colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma)
    return img.to_array().cpu().numpy().reshape(cfg.height, cfg.width, 3)


def render_passes(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                  seed: int = 0, progress: Optional[Callable] = None) -> np.ndarray:
    """The pass driver for passes == 1: one full frame, then `progress(done,
    total, img)`."""
    if cfg.passes != 1:
        raise NotImplementedError(
            "passes > 1 (adaptive oversampling) needs the sample-step path, "
            "not ported yet (ROADMAP M8)")
    img = render(scene, camera, cfg, seed=seed)
    if progress is not None:
        spp = cfg.effective_samples
        progress(spp, spp, img)
    return img
