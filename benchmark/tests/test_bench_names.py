"""BENCHMARK.json against the benchmark's contract, and every name in it
found by the harness: configurations, traffic mixes, drivers, per-layer
readers and the cells' limits."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness, inputs

SPEC = inputs.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contract_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(harness.ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)


def test_names_and_units_use_the_allowed_characters():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w["traffic"]) and NAME.match(w["config"]) for w in SPEC["workloads"])
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in SPEC[k])
    assert all(m["better"] in ("lower", "higher") for k in ("end_to_end", "per_layer")
               for m in SPEC[k])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_and_reports(cell):
    c = harness.Cell(cell)
    assert c.driver().Driver
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert e2e <= {"setup_s", "peak_mem_gib", c.traffic["rate_metric"]}
    assert c.per_layer
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]).read)
        assert m["moves"] in e2e
    assert set(c.limits) >= {"pixels_off_pct"} or set(c.limits) >= {"loss_gap"}


def test_a_config_copies_its_scene_whole():
    for c in SPEC["configs"]:
        cfg = inputs.config(c)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_run_refuses_without_a_card():
    """Here there is no CUDA device: the run exits non-zero and prints no
    result line."""
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                           "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_result_line_has_the_contract_keys_with_checks_last():
    checks = {"pixels_off_pct": {"value": 0.0, "limit": 1.0}}
    device = {"platform": "gpu", "kind": "k", "count": 1, "memory_peak_bytes": 1}
    line = harness.result(checks, 3, 0, {}, device)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    traced = harness.result(checks, 1, 0, {}, device, {"device_ops": [], "idle_gaps": []})
    assert list(traced)[-2:] == ["breakdown", "checks"] and traced["correct"]
    assert not harness.result({"x": {"value": 2.0, "limit": 1.0}}, 1, 1, {}, device)["correct"]
