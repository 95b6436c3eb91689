"""CLI frontend mirroring the reference binary's flags
(src/bin/raysnail.rs:452-533): --scene/-f, --samples/-s, --passes/-p, -w,
--height, --outfile/-o. Defaults: 800x600, samples 122, passes 1,
output.png. --checkpoint PATH (single-pass renders) writes the resumable
render state there after every chunk and resumes from it when it exists.

Instead of the reference's SDL2 preview window, --preview rewrites the
output PNG as passes (or, with --checkpoint, chunks) complete, and
--serve [PORT] serves a live HTTP preview on 127.0.0.1 (default port 8765;
`io/preview.py`), whose DELETE request cancels the render. The JAX
package's --pallas has no counterpart: on the card the kernels are the only
route.

--device picks where the render runs: `cuda` (the default) runs the
hand-written kernels on the card; `cpu` runs their plain PyTorch versions,
which is meant for tests.

The traversal kernels' switches are the JAX package's environment variables:
RAYSNAIL_MESH_SOLVER=mxu (read when the scene compiles),
RAYSNAIL_BVH_TWO_LEVEL=1 and RAYSNAIL_BVH_STREAM_BYTES (read at each call).
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
                    help="adaptive oversampling: passes after the first re-render "
                         "only the pixels whose 5x5 noise reaches the threshold")
    ap.add_argument("--outfile", "-o", default="output.png")
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--checkpoint", default=None,
                    help="write/read resumable render state (.npz) at this path")
    ap.add_argument("--mis", action="store_true",
                    help="physically-correct one-sample MIS instead of the "
                         "reference-compat estimator")
    ap.add_argument("--preview", action="store_true",
                    help="rewrite the output PNG as passes complete")
    ap.add_argument("--serve", type=int, nargs="?", const=8765, default=None,
                    metavar="PORT",
                    help="serve a live HTTP preview (the reference's SDL2 "
                         "window equivalent) on PORT [8765]")
    args = ap.parse_args(argv)

    import os

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

    server = None
    if args.serve is not None:
        from raysnail_tpu_torch.io.preview import PreviewServer

        server = PreviewServer(port=args.serve)
        print(f"live preview at http://127.0.0.1:{server.port}/")

    def progress(done, total, img=None):
        print(f"  {done}/{total} samples", flush=True)
        if args.preview and img is not None:
            Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
        if server is not None:
            return server.target(done, total, img)

    sync()
    t0 = time.time()
    try:
        if args.checkpoint and args.passes == 1:
            from raysnail_tpu_torch.painter import RenderSession, RenderState

            sess = RenderSession(scene, camera, cfg, seed=args.seed,
                                 checkpoint_path=args.checkpoint)
            resume = (RenderState.load(args.checkpoint)
                      if os.path.exists(args.checkpoint) else None)
            img = sess.render(target=progress, resume=resume)
        else:
            img = render_passes(scene, camera, cfg, seed=args.seed, progress=progress)
    finally:
        if server is not None:
            server.close()
    sync()
    dt = time.time() - t0
    rays = cfg.width * cfg.height * cfg.effective_samples * args.passes
    print(f"rendered in {dt:.2f}s  ({rays / dt / 1e6:.2f} Mprimary-rays/s)")

    Image.fromarray(colorlib.to_u8(img)).save(args.outfile)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
