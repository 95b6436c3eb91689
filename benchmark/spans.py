"""The program's spans in a profiled slice (`utils.profiling.span` in the
port: `record_function` ranges among the profiler's host events, on the
clock of the device's activity), and the device's idle time inside them.

A slice of a program that emits no span has none: every reader of these
returns None then.
"""

from __future__ import annotations

import bisect


def pick(trace, *names) -> dict:
    """-> {name: [(start_ns, end_ns)] in start order} of the slice's host
    events with those names."""
    out = {n: [] for n in names}
    for start, end, name in trace._host:
        if name in out:
            out[name].append((start, end))
    return out


def within(inner, outer) -> list:
    """The spans of `inner` that lie inside some span of `outer` (both in
    start order, `outer`'s disjoint)."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out.append((s, e))
    return out


class Idle:
    """The device's idle ns inside an interval: its length less its overlap
    with the union of the device's operations (`trace._merged`)."""

    def __init__(self, trace):
        self._starts = [s for s, _ in trace._merged]
        self._ends = [e for _, e in trace._merged]
        self._before = [0]  # busy ns of the intervals before the i-th
        for s, e in trace._merged:
            self._before.append(self._before[-1] + e - s)

    def _busy_until(self, t: int) -> int:
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0:
            return 0
        return self._before[i] + min(t, self._ends[i]) - self._starts[i]

    def ns(self, start: int, end: int) -> int:
        return (end - start) - (self._busy_until(end) - self._busy_until(start))

    def total_ns(self, spans) -> int:
        return sum(self.ns(s, e) for s, e in spans)


def frame_loop(trace):
    """-> (frames, their iterations, those iterations' shades), each a list
    of spans; shades and iterations counted only inside frames."""
    got = pick(trace, "render.frame", "integrator.iteration", "integrator.shade")
    frames = got["render.frame"]
    its = within(got["integrator.iteration"], frames)
    return frames, its, within(got["integrator.shade"], its)


def step_phase_s(trace, name: str):
    """Host seconds of the `name` spans inside `train.step` spans, over the
    steps; None without a step or such a span."""
    got = pick(trace, "train.step", name)
    steps = got["train.step"]
    spans = within(got[name], steps)
    if not steps or not spans:
        return None
    return sum(e - s for s, e in spans) * 1e-9 / len(steps)
