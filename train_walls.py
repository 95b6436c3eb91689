"""Wall seconds of the port's gradient train steps on the card, for one
checkout or for two in turns.

  python3 train_walls.py                       # this checkout, one run
  python3 train_walls.py --ab DIR --rounds 2   # DIR and this checkout in turns

One run builds example.sdl and a DiffuseMetal/BlinnPhong "metal" scene
(chip_smoke.py's) and times `diff.make_train_step`'s steps (depth 8,
Adam(1e-2), a zero target), each ending in torch.cuda.synchronize():
  example-fwd+bwd  400x250@16 (bench.py's row): a warm-up step, then 3
  metal            400x250@16: a warm-up step, then 1
  canonical        800x500@64: 2 steps, each timed (the first warms up)
and prints one JSON line: the seconds of each step, and the card's name and
power limit. With --ab, each round runs DIR, this checkout, this checkout
and DIR, each in a child process of its own, one after another; the last
line holds the quartiles of each checkout's step seconds (every step of
every run). A card is
needed: without one the script exits with 1.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TRAIN_W, TRAIN_H, TRAIN_SPP, DEPTH = 400, 250, 16, 8
CANON_W, CANON_H, CANON_SPP = 800, 500, 65  # 64 effective, the canonical command's
EXAMPLE_STEPS = 3


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def one_run(root: str) -> dict:
    """The steps of the package under `root` -> their seconds."""
    sys.path[:] = [root] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import numpy as np
    import torch

    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.scene import SceneBuilder
    from raysnail_tpu_torch.sdl.driver import build_scene

    device = torch.device("cuda")

    def metal(cfg):
        b = SceneBuilder()
        b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0,
                        ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
        b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5,
                        ir.DiffuseMetal(30.0, ir.Constant((0.6, 0.3, 0.2)))))
        b.add(ir.Sphere((-1.0, 0.0, -1.5), 0.4,
                        ir.BlinnPhong(0.4, 20.0, ir.Constant((0.2, 0.6, 0.3)))))
        b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7,
                        ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 4.0)), light=True)
        b.set_background((0.1, 0.1, 0.1))
        cam = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50, width=cfg.width,
                           height=cfg.height, device=device)
        return b.compile(device=device), cam

    def steps(scene, camera, cfg, seeds) -> list:
        target = np.zeros((cfg.height, cfg.width, 3), np.float32)
        step, state, params = make_train_step(scene, camera, cfg, target)
        out = []
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step(params, state, seed, np.arange(cfg.effective_samples))
            float(loss)
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        return out

    sdl = os.path.join(root, "sdl", "example.sdl")
    tcfg = RenderConfig(width=TRAIN_W, height=TRAIN_H, samples=TRAIN_SPP, max_depth=DEPTH)
    ccfg = RenderConfig(width=CANON_W, height=CANON_H, samples=CANON_SPP, max_depth=DEPTH)
    t0 = time.perf_counter()
    example = steps(*build_scene(sdl, tcfg, device), tcfg, range(EXAMPLE_STEPS + 1))
    metal_s = steps(*metal(tcfg), tcfg, [0, 0])
    canonical = steps(*build_scene(sdl, ccfg, device), ccfg, [1, 1])
    return {"root": root, "card": card_line(), "example_fwd_bwd_s": example[1:],
            "example_warm_up_s": example[0], "metal_s": metal_s[1:],
            "metal_warm_up_s": metal_s[0], "canonical_s": canonical,
            "run_s": time.perf_counter() - t0}


def ab(other: str, rounds: int) -> dict:
    """Runs `other` and this checkout in turns (other, this, this, other) ->
    the quartiles (q1, median, q3) of each checkout's step seconds, after
    printing every run's record."""
    runs = {"other": [], "this": []}
    for r in range(rounds):
        for who in ("other", "this", "this", "other"):
            root = os.path.abspath(other) if who == "other" else HERE
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--root", root],
                                  capture_output=True, text=True, cwd=root)
            if proc.returncode != 0:
                raise RuntimeError(f"the run of {root} failed:\n{proc.stdout}{proc.stderr}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[who].append(rec)
            print(json.dumps({"round": r, "checkout": who, **rec}), flush=True)
    quartiles = {who: {key: statistics.quantiles([x for rec in recs for x in rec[key]], n=4)
                       for key in ("example_fwd_bwd_s", "metal_s", "canonical_s")}
                 for who, recs in runs.items()}
    return {"other": os.path.abspath(other), "this": HERE, "rounds": rounds,
            "quartiles": quartiles, "card": card_line()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="the checkout whose package to time")
    ap.add_argument("--ab", metavar="DIR", help="time DIR and this checkout in turns")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("train_walls.py: no CUDA card", file=sys.stderr)
        return 1
    out = ab(args.ab, args.rounds) if args.ab else one_run(os.path.abspath(args.root))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
