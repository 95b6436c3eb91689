"""Readings that set a cell's correctness limits, on the chip at the cell's
own size: not part of a benchmark run.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] \
        [--program] [--control] [--faults]

For each seed, as a run with that --seed draws its frames or steps:
  --program  the program's numbers (the lower reading): set-up and the
             cell's outputs in this one process, as many frames as a run
             checks or one train step past set-up, then the check;
  --control  the reference computed in bfloat16 put in the program's
             place (the step below float32 that would tempt a later
             change), held against the float32 reference;
  --faults   (train cells) the faults a train step can have, planted in
             the reference put in the program's place: half of the
             samples left out with the mean taken over the rest, and each
             step fed the next step's rows. A step that returns its state
             unchanged reads 1 on change_gap and needs no run.
One JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _run(cell, seed, device):
    from benchmark import harness

    return harness.Run(cell, seed, device, time.perf_counter())


def program(cell, seed, device) -> dict:
    run = _run(cell, seed, device)
    driver = cell.driver().Driver(run)
    n = cell.traffic.get("check_frames", 1)  # a train cell: one step past set-up
    for _ in range(n):
        driver.unit()
    driver.release()
    return driver.check()[0]


def control(cell, seed, device, dtype) -> dict:
    from benchmark.drivers import frame, train

    run = _run(cell, seed, device)
    if cell.traffic["driver"] == "train":
        ts, seeds = _train_seeds(run)
        return train.compare(run, ts, seeds, train.reference(run, ts, seeds, dtype=dtype))[0]
    run.seeds.next_render_seed()  # the warm-up frame's
    frames = [(run.seeds.next_render_seed(), None) for _ in range(cell.traffic["check_frames"])]
    return frame.compare(run, frames, dtype)[0]


def _train_seeds(run):
    from benchmark.drivers import train

    train.target_config(run)
    ts = run.seeds.next_render_seed()
    return ts, [run.seeds.next_render_seed() for _ in range(run.cell.traffic["compared_steps"])]


def faults(cell, seed, device) -> dict:
    import math

    from benchmark.drivers import train

    run = _run(cell, seed, device)
    ts, seeds = _train_seeds(run)
    spp = math.isqrt(cell.traffic["samples"]) ** 2
    half = train.reference(run, ts, seeds, samples=list(range(spp // 2)))
    shifted = train.reference(run, ts, seeds[1:] + [run.seeds.next_render_seed()])
    return {"half_batch": train.compare(run, ts, seeds, half)[0],
            "next_rows": train.compare(run, ts, seeds, shifted)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.Cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        if args.program:
            print(json.dumps({"seed": seed, "program": program(cell, seed, device)}), flush=True)
        if args.control:
            print(json.dumps({"seed": seed, "control_bfloat16":
                              control(cell, seed, device, torch.bfloat16)}), flush=True)
        if args.faults and cell.traffic["driver"] == "train":
            print(json.dumps({"seed": seed, **faults(cell, seed, device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
