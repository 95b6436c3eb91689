"""Progressive-preview render harness (the reference's examples/
preview_sdl2.rs without the SDL2 window): pick one of four test scenes and
watch the PNG refine chunk by chunk. The counterpart of the JAX package's
examples/preview.py.

    python -m raysnail_tpu_torch.examples.preview --scene {mandelbulb,csg,balls,mesh} [--device cpu]

--device defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import os

WIDTH, HEIGHT = 1000, 600
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build(which: str, device):
    """-> (scene, camera) of one of the four preview scenes on `device`."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.scene import SceneBuilder

    if which == "balls":
        from raysnail_tpu_torch.scenes import book1

        return (book1.balls_scene(7).compile(device=device),
                book1.balls_camera(WIDTH, HEIGHT, device=device))

    if which == "mandelbulb":
        from raysnail_tpu_torch.config import RenderConfig
        from raysnail_tpu_torch.utils.golden import mandelbulb_scene

        return mandelbulb_scene(RenderConfig(width=WIDTH, height=HEIGHT), device)

    if which == "csg":
        from raysnail_tpu_torch.config import RenderConfig
        from raysnail_tpu_torch.sdl.driver import build_scene

        cfg = RenderConfig(width=WIDTH, height=HEIGHT)
        return build_scene(os.path.join(ROOT, "sdl", "csg.sdl"), cfg, device)

    if which == "mesh":
        from raysnail_tpu_torch.scenes.meshes import torus_knot

        v, f, n = torus_knot(n_seg=400, n_ring=24)
        b = SceneBuilder()
        b.add(ir.Mesh(vertices=v, indices=f, normals=n,
                      material=ir.DiffuseMetal(400.0, ir.Constant((0.8, 0.6, 0.3)))))
        b.add(ir.Sphere((0, -1001.3, 0), 1000.0, ir.Lambertian(ir.Constant((0.4, 0.4, 0.45)))))
        b.add(ir.Sphere((4, 6, 3), 1.5, ir.DiffuseLight(ir.Constant((1, 0.95, 0.9)), 8.0)),
              light=True)
        b.set_background((0.05, 0.05, 0.08), (0.1, 0.12, 0.2))
        cam = build_camera(look_from=(0, 1.5, 4), look_at=(0, 0, 0), fov=45,
                           width=WIDTH, height=HEIGHT, device=device)
        return b.compile(device=device), cam
    raise SystemExit(f"unknown scene {which}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="mandelbulb",
                    choices=["mandelbulb", "csg", "balls", "mesh"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--samples", type=int, default=122)
    ap.add_argument("-o", "--outfile", default="preview.png")
    args = ap.parse_args(argv)

    from PIL import Image

    from raysnail_tpu_torch.config import RenderConfig, entry_device
    from raysnail_tpu_torch.painter import RenderSession
    from raysnail_tpu_torch.prelude import color as colorlib

    scene, camera = build(args.scene, entry_device(args.device))
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=args.samples, max_depth=8)

    def target(done, total, img):
        Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
        print(f"  {done}/{total} cells -> {args.outfile}", flush=True)

    sess = RenderSession(scene, camera, cfg, seed=0)
    sess.render(target=target)
    print(f"done: {sess.mrays_per_sec:.2f} Mprimary-rays/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
