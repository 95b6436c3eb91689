"""Book-1 final scene (reference examples/rtow_13_1.rs): the seeded random
balls field with a light sphere, 800x500 at samples(122) -> 121 effective spp.
The counterpart of the JAX package's examples/rtow_13_1.py.

    python -m raysnail_tpu_torch.examples.rtow_13_1 [--device cpu] [--small] [-o out.png]

--device defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="400x225 @ 16 spp")
    ap.add_argument("-o", "--outfile", default="rtow_13_1.png")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from raysnail_tpu_torch.config import RenderConfig, entry_device
    from raysnail_tpu_torch.prelude import color as colorlib
    from raysnail_tpu_torch.render import render
    from raysnail_tpu_torch.scenes import book1

    device = entry_device(args.device)
    if args.small:
        cfg = RenderConfig(width=400, height=225, samples=16, max_depth=8)
    else:
        cfg = RenderConfig(width=800, height=500, samples=122, max_depth=8)
    scene = book1.balls_scene(seed=7).compile(cfg.dtype, device)
    camera = book1.balls_camera(cfg.width, cfg.height, device=device)
    t0 = time.time()
    img = render(scene, camera, cfg, seed=7)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.effective_samples
    print(f"rendered {cfg.width}x{cfg.height}@{cfg.effective_samples}spp "
          f"in {dt:.1f}s ({rays / dt / 1e6:.2f} Mprimary-rays/s)")
    Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
