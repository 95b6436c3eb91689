"""Small cells on the CPU for the benchmark's tests: the port's plain
PyTorch versions at toy sizes (the kernels run only on the card)."""

from __future__ import annotations

import time

import torch

from benchmark import harness

SEED = 2**31 + 4_000_000_123  # more than 32 signed bits hold: a run takes any such seed


def small_cell(name: str) -> harness.Cell:
    """The cell of BENCHMARK.json at a toy size: 40x25, 64 checked pixels,
    16 samples a frame, 4 a train step."""
    cell = harness.Cell(name)
    cell.traffic.update(width=40, height=25, check_pixels=64)
    cell.traffic["samples"] = 16 if cell.traffic["driver"] == "frame" else 4
    return cell


def run_of(cell, seed: int = SEED) -> harness.Run:
    return harness.Run(cell, seed, torch.device("cpu"), time.perf_counter())


def drive(cell, units: int = 2, fault=None, seed: int = SEED):
    """Set-up, `units` frames or steps, release and check, as a run does
    -> (checks, failed, the result line's correct)."""
    run = run_of(cell, seed)
    driver = cell.driver().Driver(run, fault=fault)
    for _ in range(units):
        driver.unit()
    driver.release()
    checks, failed = driver.check()
    return checks, failed, harness.result(checks, units, failed, {}, {})["correct"]
