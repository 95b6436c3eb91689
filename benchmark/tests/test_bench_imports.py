"""What a run loads: nothing whose top-level module name is jax, jaxlib,
flax or the JAX package raysnail_tpu (compared whole: the port's name
begins with the JAX package's), and a reference that loads nothing of the
port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from benchmark import harness

REF = os.path.join(harness.BENCH, "reference")

RUN_ON_CPU = """
import glob, os, sys
from benchmark import harness
from benchmark.tests import helpers
for path in glob.glob(os.path.join(harness.BENCH, "metrics", "*.py")):
    harness.metric_reader(os.path.basename(path)[:-3])
helpers.drive(helpers.small_cell("example-frame"), units=1)
import benchmark.drivers.train, benchmark.control
print(harness.forbidden_modules())
"""


def test_a_run_loads_no_jax_and_no_jax_package():
    proc = subprocess.run([sys.executable, "-c", RUN_ON_CPU], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raysnail_tpu_torch_lookalike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raysnail_tpu.render", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["raysnail_tpu"]


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "statistics", "typing", "numpy", "torch", "benchmark"}
    for name in os.listdir(REF):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(REF, name)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] in allowed, (name, m)
                    if m.startswith("benchmark"):
                        assert m in ("benchmark", "benchmark.inputs") or m.startswith(
                            "benchmark.reference"), (name, m)
    code = ("import sys, benchmark.reference.render, benchmark.reference.train;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'raysnail_tpu_torch', 'raysnail_tpu', 'jax'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
