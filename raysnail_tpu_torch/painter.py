"""Render sessions: streaming, checkpoint and resume, throughput counters.

The reference's painter streams rows to the preview UI and its multi-pass
loop keeps the framebuffer as implicit state. Here, as in the JAX package's
`painter.py`, that state is explicit and serializable: a RenderState carries
(radiance sums, samples done, pass index, image, seed), so a long render can
stop at any chunk boundary and resume in a new process. The `.npz` layout is
the JAX package's: a state saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from raysnail_tpu_torch import render as renderlib
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude import color as colorlib
from raysnail_tpu_torch.prelude.vec import Vec3

log = logging.getLogger("raysnail")


@dataclasses.dataclass
class RenderState:
    """Checkpointable accumulation state."""
    accum: np.ndarray            # (H*W, 3) radiance sums of the current pass, tile order
    samples_done: int            # cells accumulated into `accum`
    pass_index: int              # completed passes folded into `image`
    image: Optional[np.ndarray]  # running-average display image of passes
    seed: int

    def save(self, path: str):
        np.savez_compressed(
            path, accum=self.accum, samples_done=self.samples_done,
            pass_index=self.pass_index,
            image=self.image if self.image is not None else np.zeros(0), seed=self.seed)

    @staticmethod
    def load(path: str) -> "RenderState":
        z = np.load(path)
        img = z["image"]
        return RenderState(accum=z["accum"], samples_done=int(z["samples_done"]),
                           pass_index=int(z["pass_index"]),
                           image=img if img.size else None, seed=int(z["seed"]))


class RenderSession:
    """Drives a render chunk by chunk through the sample step, in 16x8 tile
    order, with streaming callbacks and optional checkpointing.

    target(done_cells, total_cells, partial_image) plays the role of the
    reference's PainterTarget row stream (painter.rs:23-26); returning False
    from it cancels the render.

    `step` replaces the single-device sample step: a sharded step
    (`parallel.make_padded_sharded_step`) with `k_multiple` = the mesh's
    sample-axis size streams and checkpoints a render that runs on several
    ranks. There, give `checkpoint_path` on one rank only."""

    def __init__(self, scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 step=None, k_multiple: int = 1):
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.step = step if step is not None else renderlib.make_sample_step(scene, cfg)
        self.k_multiple = k_multiple
        self.px, self.py, self._inv = renderlib._tile_grid(cfg)
        self.rays_traced = 0
        self.wall_seconds = 0.0

    def _image(self, accum: Vec3, done: int) -> np.ndarray:
        cfg = self.cfg
        img = colorlib.into_color(accum, float(max(done, 1)), cfg.gamma)
        return img.to_array().cpu().numpy()[self._inv].reshape(cfg.height, cfg.width, 3)

    def render(self, target: Optional[Callable] = None,
               resume: Optional[RenderState] = None) -> np.ndarray:
        cfg = self.cfg
        device = self.scene.device
        spp = cfg.effective_samples
        n_pix = cfg.width * cfg.height
        # cap the dispatch size so that callbacks and checkpoints fire at a
        # useful cadence
        k = renderlib._sample_chunks(cfg, n_pix, self.k_multiple,
                                     budget=min(cfg.ray_batch, 1 << 21))

        if resume is not None:
            accum_np, start_cell = resume.accum, resume.samples_done
            log.info("resuming at %d/%d cells", start_cell, spp)
        else:
            accum_np, start_cell = np.zeros((n_pix, 3), np.float32), 0
        accum = Vec3(*(torch.as_tensor(np.ascontiguousarray(accum_np[:, c]), dtype=cfg.dtype,
                                       device=device) for c in range(3)))
        px = torch.as_tensor(self.px, dtype=cfg.dtype, device=device)
        py = torch.as_tensor(self.py, dtype=cfg.dtype, device=device)

        done = start_cell
        for start in range(start_cell, spp, k):
            t0 = time.time()
            accum = accum + self.step(self.scene.arrays, self.camera, self.seed,
                                      np.arange(start, start + k), px, py)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            done = start + k
            dt = time.time() - t0
            self.rays_traced += n_pix * k
            self.wall_seconds += dt
            log.info("cells %d-%d of %d (%.2f Mrays/s primary)", start, done, spp,
                     n_pix * k / max(dt, 1e-9) / 1e6)
            if self.checkpoint_path:
                RenderState(accum.to_array().cpu().numpy(), done, 0, None,
                            self.seed).save(self.checkpoint_path)
            if target is not None and target(done, spp, self._image(accum, done)) is False:
                log.info("render cancelled at %d/%d cells", done, spp)
                break
        return self._image(accum, done)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.wall_seconds, 1e-9) / 1e6
