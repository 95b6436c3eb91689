"""A bounded profiler slice and what is read from it in memory: the
device's kernels with their times, the host's kernel launches, the
device's busy time (the union of its operations' intervals) and the
slice's length, the ten device operations that took most time, and the
idle gaps named by what the host was doing. No trace file is written.

`Calls` records the shapes of a program function's calls during the
slice: a wrapper put in the function's place for the slice only, which a
roofline reader turns into bytes and operations.
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict

import torch

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")
TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


class Trace:
    """What a slice read: kernels [(name, start_ns, end_ns)], every device
    operation's interval (ranges annotated on the device's timeline left
    out), launches, busy and window seconds, and the breakdown."""

    def __init__(self, events, units: int):
        self.units = units
        dev, host = [], []
        self.launches = 0
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    dev.append((name, start, end))
            else:
                if name in LAUNCHES:
                    self.launches += 1
                host.append((start, end, name))
        lo = min([s for _, s, _ in dev] + [s for s, _, _ in host], default=0)
        hi = max([e for _, _, e in dev] + [e for _, e, _ in host], default=0)
        self.window_s = (hi - lo) * 1e-9
        self.device_ops = dev
        self.kernels = [d for d in dev if not d[0].startswith(("Memcpy", "Memset"))]
        merged = []
        for _, s, e in sorted(dev, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self._merged, self._host, self._span = merged, sorted(host), (lo, hi)

    def kernel_seconds(self, match) -> float:
        return sum(e - s for n, s, e in self.kernels if match(n)) * 1e-9

    def breakdown(self) -> dict:
        by_op = defaultdict(int)
        for n, s, e in self.device_ops:
            by_op[_short(n)] += e - s
        starts = [h[0] for h in self._host]
        gaps = defaultdict(int)
        edges = [self._span[0]] + [x for iv in self._merged for x in iv] + [self._span[1]]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            name = "(nothing on the host)"
            for j in range(i, max(i - 64, -1), -1):
                if self._host[j][1] >= mid:
                    name = self._host[j][2]
                    break
            else:
                if i >= 0:
                    name = f"after {self._host[i][2]}"
            gaps[name] += b - a
        def top(d):
            return [[k, v * 1e-9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


class Slice:
    """with Slice(units) as s: ... ; then s.trace. The device is
    synchronised at both ends, so the slice holds whole frames or steps."""

    def __init__(self, units: int):
        self.units = units
        self.trace = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self.t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = Trace(self._prof.profiler.kineto_results.events(), self.units)
        return False


class Calls:
    """Shapes of a program function's calls while recording is on: put a
    recording wrapper in place of `owner.<attr>` (an attribute the function
    keeps, such as a launch counter, is shared with the wrapper) and take it
    out again with `restore`."""

    def __init__(self):
        self.shapes = defaultdict(list)
        self._undo = []
        self.on = False

    def wrap(self, owner, attr: str, key: str, shape):
        original = getattr(owner, attr)

        @functools.wraps(original)
        def recording(*args, **kwargs):
            if self.on:
                self.shapes[key].append(shape(*args, **kwargs))
            return original(*args, **kwargs)

        setattr(owner, attr, recording)
        self._undo.append((owner, attr, original, dict(vars(recording))))

    def restore(self):
        """Put the originals back, with what the calls changed in the
        attributes that the wrapper shared (a counter the function bumps
        under its module's name for itself)."""
        for owner, attr, original, before in reversed(self._undo):
            for k, v in vars(getattr(owner, attr)).items():
                if k != "__wrapped__" and before.get(k) is not v:
                    setattr(original, k, v)
            setattr(owner, attr, original)
        self._undo.clear()
