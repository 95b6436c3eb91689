"""Inverse rendering demo: recover a sphere's albedo from a target image.

Renders a ground-truth image with a red sphere, re-initialises the scene
with a gray sphere, and optimises the material parameters with Adam(2e-2)
until the render matches: the gradient flows through the whole bounce loop
(`diff.make_train_step`). The counterpart of the JAX package's
examples/inverse_rendering.py, at its size (64x48@16spp, depth 4).

    python -m raysnail_tpu_torch.examples.inverse_rendering [--device cpu] [--steps N]

--device defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np

TRUE_ALBEDO = (0.8, 0.15, 0.1)
START_ALBEDO = (0.45, 0.5, 0.55)
SEED = 7
STEPS = 120
ALBEDO_ATOL = 0.08


def scene_with_albedo(rgb, device):
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    b.add(ir.Sphere((0, 0, -2.5), 1.0, ir.Lambertian(ir.Constant(rgb))))
    b.add(ir.Sphere((0, -101, -2.5), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.set_background((1.0, 1.0, 1.0), (0.6, 0.7, 1.0))
    return b.compile(device=device)


def run(device="cuda", steps: int = STEPS, lr: float = 2e-2, out=print):
    """Fit the albedo for `steps` Adam steps; -> (losses, the sphere's
    albedo after the last step)."""
    from raysnail_tpu_torch import render as renderlib
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig, entry_device
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.diff.params import leaves
    from raysnail_tpu_torch.diff.train import adam

    device = entry_device(device)
    cfg = RenderConfig(width=64, height=48, samples=16, max_depth=4)
    cam = build_camera(look_from=(0, 0.4, 1), look_at=(0, 0, -2.5), fov=45,
                       width=cfg.width, height=cfg.height, device=device)
    ids = np.arange(cfg.effective_samples)

    # ground truth: the red sphere (radiance means, not gamma'd display)
    truth = scene_with_albedo(TRUE_ALBEDO, device)
    px, py = renderlib._full_grid(cfg)
    tsum = renderlib.render_sums(truth, cam, cfg, SEED, px, py)
    target = (tsum.to_array() / cfg.effective_samples).reshape(cfg.height, cfg.width, 3)

    # start from a wrong albedo (not the ground's exact gray: the compiler
    # dedups identical constant textures into one table row)
    scene = scene_with_albedo(START_ALBEDO, device)
    step, opt_state, params = make_train_step(scene, cam, cfg, target,
                                              optimizer=adam(lr))
    # the target's own draws (common random numbers): the residual vanishes
    # at the true parameters
    losses = []
    alb = None
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, SEED, ids)
        losses.append(float(loss))
        # the sphere's albedo is row 1 of the texture table (registration
        # order: the default, the sphere, the ground)
        alb = np.array([float(c[1]) for c in leaves(params)[:3]])
        if i % 20 == 0 or i == steps - 1:
            err = np.abs(alb - np.asarray(TRUE_ALBEDO)).max()
            out(f"step {i:3d}  loss {losses[-1]:.6f}  albedo {np.round(alb, 3)}  "
                f"max|err| {err:.3f}")
    return losses, alb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--no-check", action="store_true",
                    help="do not require the albedo to be recovered (short runs)")
    args = ap.parse_args(argv)
    _, alb = run(args.device, args.steps, out=lambda s: print(s, flush=True))
    err = np.abs(alb - np.asarray(TRUE_ALBEDO)).max()
    if not args.no_check and err >= ALBEDO_ATOL:
        print(f"albedo not recovered: {alb} vs {TRUE_ALBEDO}")
        return 1
    print("recovered the target albedo." if err < ALBEDO_ATOL else
          f"albedo after {args.steps} steps: {alb}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
