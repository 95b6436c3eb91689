"""Frames of a batch render: the CLI's call, `render.render_passes`, one
whole frame a unit, each with a new seed drawn from the run's seed.

Set-up compiles the scene (its host BVH build included) and renders one
frame with a seed of its own, which builds the kernels and warms the
frame's one shape. The check takes a sample of the frames the run made,
and a sample of pixels of each, both drawn from the run's seed, renders
those pixels with the plain reference and compares the display colors:
a pixel is off where a channel differs by more than the limits' `pixel_tol`,
and `pixels_off_pct` is the share of sampled pixels that are off.
"""

from __future__ import annotations

import math
import sys

import numpy as np


class Driver:
    def __init__(self, run, fault=None):
        import torch

        from benchmark import scenes

        self.run, self.fault = run, fault
        t = run.cell.traffic
        self.cfg = scenes.render_config(run.cell.config, t)
        self.scene, self.camera, run.scene_compile_s = scenes.compile_scene(
            run.cell.config, self.cfg, run.device)
        self.work_per_unit = t["width"] * t["height"] * self.cfg.effective_samples / 1e6
        self.frames = []
        self._render(run.seeds.next_render_seed())  # warm-up: builds and warms the one shape
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        self.frames.clear()

    def _render(self, seed: int):
        from raysnail_tpu_torch.render import render_passes

        img = render_passes(self.scene, self.camera, self.cfg, seed=seed)
        if self.fault is not None:
            img = self.fault(self, seed, img)
        self.frames.append((seed, img))

    def unit(self):
        self._render(self.run.seeds.next_render_seed())

    def release(self):
        import torch

        self.scene = self.camera = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return compare(self.run, self.frames)


def compare(run, frames, dtype=None):
    """-> ({"pixels_off_pct": {"value", "limit"}}, frames with pixels off
    beyond the limit). `frames` is [(seed, display image)]; with `dtype`
    the reference computed in that precision stands in for the program's
    images (the precision control), which are then not read."""
    import torch

    from benchmark.reference import render as ref
    from benchmark.reference import scene as refscene

    t, lim, cfg = run.cell.traffic, run.cell.limits, run.cell.config
    image = dict(width=t["width"], height=t["height"], samples=t["samples"],
                 max_depth=cfg["max_depth"])
    spp = math.isqrt(t["samples"]) ** 2
    n_pix = t["width"] * t["height"]
    rng = run.seeds.check
    picked = sorted(rng.choice(len(frames), min(len(frames), t["check_frames"]), replace=False))
    want_scene = refscene.build(cfg, t["width"], t["height"], torch.float32, run.device)
    low = (refscene.build(cfg, t["width"], t["height"], dtype, run.device)
           if dtype is not None else None)
    off = checked = frames_off = 0
    worst = 0.0
    for i in picked:
        seed, img = frames[i]
        pix = np.sort(rng.choice(n_pix, min(n_pix, t["check_pixels"]), replace=False))
        pt = torch.as_tensor(pix, device=run.device)
        want = ref.display(ref.pixel_sums(want_scene, image, seed, pt), spp).cpu().numpy()
        if low is not None:
            got = ref.display(ref.pixel_sums(low, image, seed, pt), spp).float().cpu().numpy()
        else:
            got = np.asarray(img, np.float32).reshape(-1, 3)[pix]
        gap = np.nan_to_num(np.abs(got - want), nan=np.inf).max(1)
        n = int((gap > lim["pixel_tol"]).sum())
        off, checked = off + n, checked + len(pix)
        frames_off += 100.0 * n > lim["pixels_off_pct"] * len(pix)
        worst = max(worst, float(gap.max()))
    print(f"frames checked {len(picked)}, pixels {checked}, widest gap {worst!r}",
          file=sys.stderr)
    return {"pixels_off_pct": {"value": 100.0 * off / checked,
                               "limit": lim["pixels_off_pct"]}}, int(frames_off)
