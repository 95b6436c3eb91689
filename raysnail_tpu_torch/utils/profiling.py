"""Tracing and throughput helpers: the JAX package's `utils/profiling.py` on
torch.profiler and CUDA synchronisation."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("raysnail")


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Record a torch.profiler trace of the block (host and, where CUDA is
    available, device activity) and write it as a Chrome trace under
    `trace_dir` (viewable in Perfetto). Yields the profiler, or None with a
    warning where profiling cannot start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    except Exception as e:  # pragma: no cover
        log.warning("profiler unavailable: %s", e)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            log.info("profiler trace written to %s", path)


class Throughput:
    """Accumulates (rays, seconds) per named stage and reports Mrays/s."""

    def __init__(self):
        self.stages: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str, rays: int, block_on=None):
        """Time the block; with `block_on` (a tensor, or anything on a device)
        the card is synchronised before the clock stops, so queued work is
        counted."""
        t0 = time.perf_counter()
        yield
        if block_on is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        self.stages.setdefault(name, [0, 0.0])
        self.stages[name][0] += rays
        self.stages[name][1] += dt

    def report(self) -> dict:
        return {
            name: {"rays": r, "seconds": round(s, 4),
                   "mrays_per_s": round(r / max(s, 1e-9) / 1e6, 3)}
            for name, (r, s) in self.stages.items()
        }
