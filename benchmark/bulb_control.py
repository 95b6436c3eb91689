"""Readings that set the limits of a cell of the adaptive driver
(`bulb-passes4`), on the chip at the cell's own size: not part of a
benchmark run.

    python3 benchmark/bulb_control.py --workload bulb-passes4 --seeds <n> [<n> ...]

For each seed, a run's set-up and as many frames as a run checks, drawn as
a run with that --seed draws them, then one JSON line of checks of the
same sampled pixels:
  program         the program's frames (the lower reading);
  control_bfloat16  the reference computed in bfloat16 in the program's
                  place (the step below float32 that would tempt a later
                  change);
  de12            the reference with 12 DE iterations in the program's place;
  same_seed       the reference with every later pass seeded with the
                  frame's seed instead of seed + k;
  skipped_pass    the program's frames without their last pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(cell, seed: int, device) -> dict:
    import torch

    from benchmark import harness, inputs
    from benchmark.drivers import adaptive
    from benchmark.reference import bulb

    run = harness.Run(cell, seed, device, time.perf_counter())
    driver = cell.driver().Driver(run)
    for _ in range(cell.traffic["check_frames"]):
        driver.unit()
    driver.release()
    frames = driver.frames
    t = cell.traffic
    image = dict(width=t["width"], height=t["height"], samples=t["samples"],
                 max_depth=cell.config["max_depth"])

    def check(frames, stand_in=None):
        run.seeds.check = inputs.Seeds(seed).check  # every reading samples the same pixels
        return adaptive.compare(run, frames, stand_in)[0]

    def reference(same_seed=False, **scene):
        ref = bulb.build(cell.config, t["width"], t["height"], device=device, **scene)
        return lambda jobs: bulb.pass_averages(ref, image, jobs, same_seed)

    return {"seed": seed,
            "program": check(frames),
            "control_bfloat16": check(frames, reference(dtype=torch.bfloat16)),
            "de12": check(frames, reference(iterations=12)),
            "same_seed": check(frames, reference(same_seed=True)),
            "skipped_pass": check([(s, images[:-1]) for s, images in frames])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device(args.device))), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
