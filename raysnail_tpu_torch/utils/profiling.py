"""Tracing on torch.profiler: the spans the program emits, and a Chrome-trace
exporter for a block of code.

Tracing is on exactly when a torch profiler runs (`device_trace`, or any
`torch.profiler.profile` of the caller's). A span is then a
`record_function` range among the profiler's own host events, on the same
clock as the device activity it records. With no profiler running a span
costs one flag read."""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

log = logging.getLogger("raysnail")

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context naming a stretch of the program in a running profiler's
    trace; a shared no-op context when none runs (an unguarded
    `record_function` costs tens of microseconds even then)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Record a torch.profiler trace of the block (host and, where CUDA is
    available, device activity) and write it as a Chrome trace under
    `trace_dir` (viewable in Perfetto), the program's spans among the host
    events: `render.frame` (a `render.render_passes` call), `render.pass`
    (each of its passes) and `render.noise` (a later pass's noise map, mask
    and tile sort), `integrator.iteration`, `integrator.shade`,
    `integrator.graphed` and `integrator.capture`, `geometry.march` (a
    Mandelbulb's march, K6 on the card) and the train step's `train.step`,
    `train.pass1`, `train.cell_forward` and `train.cell_backward`. Yields
    the profiler, or None with a warning where profiling cannot start."""
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
