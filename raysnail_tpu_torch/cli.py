"""CLI frontend mirroring the reference binary's flags
(src/bin/raysnail.rs:452-533): --scene/-f, --samples/-s, --passes/-p, -w,
--height, --outfile/-o. Defaults: 800x600, samples 122, passes 1,
output.png.

--device picks where the render runs: `cuda` (the default) runs the
hand-written kernels on the card; `cpu` runs their plain PyTorch versions,
which is meant for tests.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raysnail-tpu-torch",
                                 description="Monte Carlo path tracer on PyTorch and CUDA")
    ap.add_argument("--scene", "-f", required=True, help="SDL scene file")
    ap.add_argument("-w", "--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--samples", "-s", type=int, default=122)
    ap.add_argument("--passes", "-p", type=int, default=1,
                    help="only 1 is ported so far")
    ap.add_argument("--outfile", "-o", default="output.png")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--mis", action="store_true",
                    help="physically-correct one-sample MIS instead of the "
                         "reference-compat estimator")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.prelude import color as colorlib
    from raysnail_tpu_torch.render import render_passes
    from raysnail_tpu_torch.sdl.driver import build_scene

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    cfg = RenderConfig(width=args.width, height=args.height, samples=args.samples,
                       max_depth=args.depth, passes=args.passes, proper_mis=args.mis)
    t0 = time.time()
    scene, camera = build_scene(args.scene, cfg, device)
    print(f"parsed + compiled {args.scene} in {time.time() - t0:.2f}s "
          f"({cfg.effective_samples} effective spp, {args.passes} pass(es), "
          f"device {device})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def progress(done, total, img=None):
        print(f"  {done}/{total} samples", flush=True)

    sync()
    t0 = time.time()
    img = render_passes(scene, camera, cfg, seed=args.seed, progress=progress)
    sync()
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.effective_samples * args.passes
    print(f"rendered in {dt:.2f}s  ({rays / dt / 1e6:.2f} Mprimary-rays/s)")

    Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
