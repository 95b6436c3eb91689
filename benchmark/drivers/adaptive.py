"""Frames of the CLI's adaptive passes on a Mandelbulb configuration:
`render.render_passes` with the traffic's `passes` and `noise_threshold`,
one whole frame a unit, each with a new seed drawn from the run's seed
(pass k renders with seed + k). A frame's work is its first pass's
width x height x effective samples primary rays; later passes redo the
noisy pixels only, so pixels end the frame with unequal samples.

The configuration's scene is lowered here (its Mandelbulb and BlinnPhong
kinds beside `benchmark/scenes.py`'s sphere and lights) and checked
against `benchmark/reference/bulb.py`. `Driver` keeps a copy of the
image after each pass through `render_passes`' own `progress` callback
(the next pass writes into the same array). The check takes a sample of
the frames and of pixels of each, both drawn from the run's seed:

  * `pixels_off_pct`: the share of sampled pixels whose display color
    differs from the reference's running average over the passes that
    redid the pixel by more than the limits' `pixel_tol` in a channel;
  * `redo_off_pct`: the share of all pixels of the checked frames whose
    redo in some pass differs from the reference's noise over the
    program's own image of the pass before. The image shows what a pass
    redid: the pixels it changed, and, among the pixels the reference
    redoes and the pass left as they were, those whose new average the
    reference finds equal to the old (a pixel black in both passes); that
    share is read on a sample of them.
"""

from __future__ import annotations

import sys
import time

import numpy as np

SEED_SPAN = 2**32  # the renderer takes seeds in [0, 2^32); pass k adds k


def builder(config: dict):
    """The port's SceneBuilder holding the configuration's objects: one
    Mandelbulb and sphere lights, BlinnPhong and DiffuseLight materials."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.scene import SceneBuilder

    from benchmark import scenes

    scene = config["scene"]
    b = SceneBuilder()
    for obj in scene["objects"]:
        m = obj["material"]
        if m["kind"] == "blinn_phong":
            mat = ir.BlinnPhong(float(m["k_specular"]), float(m["exponent"]),
                                scenes._texture(ir, m["texture"]))
        else:
            mat = scenes._material(ir, m)
        if obj["kind"] == "mandelbulb":
            b.add(ir.Mandelbulb(material=mat))
        elif obj["kind"] == "sphere":
            b.add(ir.Sphere(tuple(obj["center"]), float(obj["radius"]), mat),
                  light=bool(obj.get("light")))
        else:
            raise ValueError(f"unknown object kind {obj['kind']!r}")
    b.set_background(tuple(scene["background"]["bottom"]), tuple(scene["background"]["top"]))
    return b


def render_config(config: dict, traffic: dict):
    from benchmark import scenes

    return scenes.render_config(config, traffic).replace(
        noise_threshold=traffic["noise_threshold"])


class Driver:
    def __init__(self, run, fault=None):
        """`fault(driver, seed) -> the images of the passes` renders a frame
        in the program's place (the tests' planted faults)."""
        import torch

        from benchmark import scenes

        self.run, self.fault = run, fault
        t = run.cell.traffic
        self.cfg = render_config(run.cell.config, t)
        t0 = time.perf_counter()
        self.scene = builder(run.cell.config).compile(self.cfg.dtype, run.device)
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        run.scene_compile_s = time.perf_counter() - t0
        self.camera = scenes.camera(run.cell.config, self.cfg, run.device)
        self.work_per_unit = t["width"] * t["height"] * self.cfg.effective_samples / 1e6
        self.frames = []
        self._render(self.next_seed())  # warm-up: builds the kernels and warms every shape
        if run.device.type == "cuda":
            torch.cuda.synchronize()
        self.frames.clear()

    def next_seed(self) -> int:
        """A frame seed from the run's seed, low enough that seed + the last
        pass stays below 2^32."""
        return self.run.seeds.next_render_seed() % (SEED_SPAN - self.cfg.passes + 1)

    def passes(self, seed: int, cfg=None, step=None) -> list:
        """-> the images after each pass of `render_passes` (copies)."""
        from raysnail_tpu_torch.render import render_passes

        images = []
        render_passes(self.scene, self.camera, cfg or self.cfg, seed=seed, step=step,
                      progress=lambda done, total, img: images.append(img.copy()))
        return images

    def _render(self, seed: int):
        images = self.passes(seed) if self.fault is None else self.fault(self, seed)
        self.frames.append((seed, images))

    def unit(self):
        self._render(self.next_seed())

    def release(self):
        import torch

        self.scene = self.camera = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        return compare(self.run, self.frames)


def compare(run, frames, stand_in=None):
    """-> ({"pixels_off_pct", "redo_off_pct": {"value", "limit"}}, frames
    with either beyond its limit). `frames` is [(seed, the images of its
    passes)]. `stand_in([(seed, pixels, masks)])`, where given, computes
    the sampled pixels' colors of each checked frame in the program's
    place (a control), from the reference's redo masks; the program's
    images still decide the redo."""
    import torch

    from benchmark.reference import bulb

    t, lim, cfg = run.cell.traffic, run.cell.limits, run.cell.config
    image = dict(width=t["width"], height=t["height"], samples=t["samples"],
                 max_depth=cfg["max_depth"])
    n_pix = t["width"] * t["height"]
    n_kept = max(1, t["check_pixels"] // 16)
    rng, device = run.seeds.check, run.device
    picked = sorted(rng.choice(len(frames), min(len(frames), t["check_frames"]), replace=False))
    scene = bulb.build(cfg, t["width"], t["height"], torch.float32, device)
    jobs, kept, counts = [], [], []
    for i in picked:
        seed, images = frames[i]
        pix = torch.as_tensor(np.sort(rng.choice(n_pix, min(n_pix, t["check_pixels"]),
                                                 replace=False)), device=device)
        imgs = [torch.as_tensor(np.asarray(a, np.float32), device=device) for a in images]
        masks = bulb.redo_masks(imgs, t["noise_threshold"], t["passes"])
        jobs.append((seed, pix, masks))
        # a pixel the pass changed is one it redid; one it kept may be one it
        # redid to the same color, which a sample of them tells
        extra, none = 0, torch.zeros(n_pix, dtype=torch.bool, device=device)
        for k in range(1, max(len(masks), len(imgs) - 1) + 1):
            want = masks[k - 1] if k <= len(masks) else none
            changed = (imgs[k] != imgs[k - 1]).any(-1).reshape(-1) if k < len(imgs) else none
            extra += int((changed & ~want).sum())
            same = torch.nonzero(want & ~changed).reshape(-1)
            if same.numel():
                at = torch.as_tensor(np.sort(rng.choice(same.numel(), min(same.numel(), n_kept),
                                                        replace=False)), device=device)
                kept.append((len(counts), k, same.numel(), seed + k, same[at],
                             imgs[k - 1].reshape(-1, 3)[same[at]]))
        counts.append(extra)
    news = bulb.display_cells(scene, image, [(s, p) for _, _, _, s, p, _ in kept])
    for (f, k, n_same, _, _, old), new in zip(kept, news):
        moved = ((old * k + new) / torch.full_like(new, k + 1.0) != old).any(-1)
        counts[f] += round(n_same * float(moved.float().mean()))
    wants = bulb.pass_averages(scene, image, jobs)
    gots = stand_in(jobs) if stand_in is not None else None
    off = checked = frames_off = 0
    worst = 0.0
    for j, (i, (_, pix, _)) in enumerate(zip(picked, jobs)):
        want = wants[j].cpu().numpy()
        if gots is not None:
            got = gots[j].cpu().numpy()
        else:
            got = np.asarray(frames[i][1][-1], np.float32).reshape(-1, 3)[pix.cpu().numpy()]
        gap = np.nan_to_num(np.abs(got - want), nan=np.inf).max(1)
        n = int((gap > lim["pixel_tol"]).sum())
        off, checked = off + n, checked + len(gap)
        frames_off += (100.0 * n > lim["pixels_off_pct"] * len(gap)
                       or 100.0 * counts[j] > lim["redo_off_pct"] * n_pix)
        worst = max(worst, float(gap.max()))
    print(f"frames checked {len(picked)}, pixels {checked}, widest gap {worst!r}, "
          f"pixels redone otherwise {counts}", file=sys.stderr)
    return {"pixels_off_pct": {"value": 100.0 * off / checked, "limit": lim["pixels_off_pct"]},
            "redo_off_pct": {"value": 100.0 * sum(counts) / (n_pix * len(picked)),
                             "limit": lim["redo_off_pct"]}}, int(frames_off)
