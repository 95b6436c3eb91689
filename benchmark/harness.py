"""The benchmark's run: one cell of BENCHMARK.json, named by --workload.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric or cell
is found by its name:
  benchmark/configs/<file>          the configuration, as BENCHMARK.json names it
  benchmark/traffic/<traffic>.json  the mix: its driver, sizes and check sizes
  benchmark/drivers/<driver>.py     the driver that the mix names
  benchmark/metrics/<metric>.py     the reader of a per-layer metric
  benchmark/limits/<cell>.json      the limits of the cell's correctness check

A run sets the cell up (the driver builds the scene and warms up its one
shape), then with --trace 0 measures whole frames or steps back to back for
--seconds (a closed loop with one client) and reports the cell's
end-to-end metrics; with --trace 1 it profiles a bounded slice of the
traffic's `trace_units` frames or steps instead (then times its
`traced_rate_units`, if it names any, unprofiled) and reports the per-layer
metrics. Either way it then checks what the timed path produced against
the plain reference (benchmark/reference/) and prints one JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

from benchmark import inputs

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "raysnail_tpu")
GIB = float(1 << 30)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and limits."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec if spec is not None else inputs.load_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.config = inputs.config({c["name"]: c for c in spec["configs"]}[self.entry["config"]])
        self.traffic = inputs.load_json(os.path.join(BENCH, "traffic",
                                                     self.entry["traffic"] + ".json"))
        self.limits = inputs.load_json(os.path.join(BENCH, "limits", name + ".json"))
        applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]

    def driver(self):
        return importlib.import_module(f"benchmark.drivers.{self.traffic['driver']}")


def metric_reader(name: str):
    """The module benchmark/metrics/<name>.py (a name may hold dots)."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    Flax's or the JAX package's: compared whole, so the port
    raysnail_tpu_torch is not one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


class Run:
    """What the drivers and the metric readers share: the cell, the
    device, the seeds, set-up times, the slice's trace and recorded call
    shapes."""

    def __init__(self, cell: Cell, seed: int, device, t0: float):
        from benchmark import trace

        self.cell, self.device, self.t0 = cell, device, t0
        self.seeds = inputs.Seeds(seed)
        self.scene_compile_s = None
        self.trace = None
        self.traced_rate = None
        self.calls = trace.Calls()


def measure(run: Run, driver, seconds: float, traced: bool, readers: dict) -> dict:
    """The window (or the traced slice) over the driver's units. -> the
    numbers the result line needs."""
    import torch

    from benchmark import trace

    out = {}
    if traced:
        for r in readers.values():
            if hasattr(r, "instrument"):
                r.instrument(run)
        units = run.cell.traffic["trace_units"]
        run.calls.on = True
        with trace.Slice(units) as s:
            for _ in range(units):
                driver.unit()
        run.calls.on = False
        run.calls.restore()
        run.trace = s.trace
        rated = run.cell.traffic.get("traced_rate_units", 0)
        if rated:  # unprofiled units after the slice, on the host clock
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(rated):
                driver.unit()
            torch.cuda.synchronize()
            run.traced_rate = driver.work_per_unit * rated / (time.perf_counter() - start)
        out["attempted"] = units + rated
    else:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        out["setup_s"] = start - run.t0
        ends = [start]
        while ends[-1] - start < seconds:
            driver.unit()
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
        n = len(ends) - 1
        out["attempted"] = n
        out["rate"] = driver.work_per_unit * n / (ends[-1] - start)
        each = sorted(b - a for a, b in zip(ends, ends[1:]))
        print(f"window: {n} units in {ends[-1] - start!r} s; a unit min {each[0]!r} median "
              f"{each[n // 2]!r} max {each[-1]!r} s", file=sys.stderr)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def result(checks: dict, attempted: int, failed: int, metrics: dict, device: dict,
           breakdown: dict | None = None) -> dict:
    """The result line: correct (every compared number within its limit),
    attempted, failed, metrics, device, the breakdown of a traced run, and
    last the compared numbers, each with its limit."""
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    ap = argparse.ArgumentParser(description="one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch

    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f"{args.workload} needs {chips} CUDA device(s); "
                     f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if importlib.util.find_spec("raysnail_tpu_torch") is None:
        return _fail("the program (raysnail_tpu_torch) is not in this checkout")

    run = Run(cell, args.seed, torch.device("cuda", 0), t0)
    readers = {m["name"]: metric_reader(m["name"]) for m in cell.per_layer} if args.trace else {}
    driver = cell.driver().Driver(run)
    out = measure(run, driver, args.seconds, bool(args.trace), readers)
    driver.release()
    found = forbidden_modules()
    if found:
        return _fail(f"modules loaded that the port must not load: {found}", 3)
    checks, failed = driver.check()

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = readers[m["name"]].read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": out["setup_s"], "peak_mem_gib": out["memory_peak_bytes"] / GIB,
                  cell.traffic["rate_metric"]: out["rate"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if args.trace:
        device["busy_s"], device["window_s"] = run.trace.busy_s, run.trace.window_s
        breakdown = run.trace.breakdown()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result(checks, out["attempted"], failed, metrics, device, breakdown)),
          flush=True)
    return 0
