"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files plus entries in BENCHMARK.json, and edits no file
of the benchmark: the harness finds each by its name."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness

NEW_METRIC = '''"""Frames in the profiled slice (a made-up metric for the test)."""


def read(run):
    return float(run.trace.units)
'''

CHECK = """
import sys, types
from benchmark import harness, trace
from benchmark.tests import helpers
cell = harness.Cell("tiny-frame")
assert cell.config["name"] == "example-copy" and cell.traffic["width"] == 24
run = helpers.run_of(cell)
driver = cell.driver().Driver(run)
driver.unit()
driver.release()
checks, failed = driver.check()
reader = harness.metric_reader("frames_in_slice.render")
run.trace = types.SimpleNamespace(units=1)
print(checks["pixels_off_pct"]["value"], failed, reader.read(run),
      [m["name"] for m in cell.per_layer])
"""


def test_new_files_and_entries_need_no_edit(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench / "configs" / "example-sdl.json"))
    cfg["name"] = "example-copy"
    (bench / "configs" / "example-copy.json").write_text(json.dumps(cfg))
    traffic = json.load(open(bench / "traffic" / "frame-800x500-s65.json"))
    traffic.update(width=24, height=16, samples=4, check_pixels=32)
    (bench / "traffic" / "frame-24x16-s4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_in_slice.render.py").write_text(NEW_METRIC)
    (bench / "limits" / "tiny-frame.json").write_text(
        (bench / "limits" / "example-frame.json").read_text())
    spec["configs"].append({"name": "example-copy", "source": "https://example.org",
                            "file": "benchmark/configs/example-copy.json", "reduced": [],
                            "why": "a copy"})
    spec["workloads"].append({"name": "tiny-frame", "config": "example-copy",
                              "traffic": "frame-24x16-s4", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_mrays_per_s":
            m["workloads"].append("tiny-frame")
    spec["per_layer"].append({"name": "frames_in_slice.render", "unit": "frames",
                              "better": "higher", "source": "device_trace", "layer": "kernels",
                              "moves": "render_mrays_per_s", "workloads": ["tiny-frame"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), harness.ROOT]))
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    off, failed, frames, names = proc.stdout.strip().splitlines()[-1].split(" ", 3)
    assert float(off) == 0.0 and failed == "0" and frames == "1.0"
    assert names == "['frames_in_slice.render']"
