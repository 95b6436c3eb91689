"""The readers' bound arithmetic against PERF.md §6 (chip_smoke.py's
counts), and the slice reader on made-up profiler events."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark import harness, roofline, trace


def test_k1_bound_is_perf_md_s():
    k1 = harness.metric_reader("sphere_min_t_roofline.render")
    assert round(k1.least_s(400_000, 4, False) * 1e3, 6) == 0.003821


def test_k7_bound_is_perf_md_s():
    k7 = harness.metric_reader("rows_select_roofline.render")
    assert round(k7.least_s(400_000, 8, 4) * 1e3, 6) == 0.002866
    k7b = harness.metric_reader("rows_select_bwd_roofline.train")
    assert k7b.least_s(400_000, 8, 4) == k7.least_s(400_000, 8, 4)  # bound by bytes too


def test_a_share_with_nothing_measured_is_none():
    assert roofline.share_pct(0.0, 1.0) is None and roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(1.0, 2.0) == 50.0


class Ev:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU


EVENTS = [Ev("aten::mul", 0, 100, False), Ev("cudaLaunchKernel", 10, 5, False),
          Ev("void sphere_min_t_kernel<false>(float const*)", 20, 30, True),
          Ev("aten::nonzero", 100, 200, False), Ev("cudaLaunchKernel", 110, 5, False),
          Ev("void rows_select_kernel<4>(Columns)", 120, 40, True),
          Ev("void rows_select_kernel<4>(Columns)", 150, 30, True),
          Ev("Memcpy DtoH (Device -> Pinned)", 250, 10, True)]


def test_the_slice_reader():
    t = trace.Trace(EVENTS, units=2)
    assert t.launches == 2 and len(t.kernels) == 3
    assert t.window_s == pytest.approx(300e-9)
    assert t.busy_s == pytest.approx((30 + 60 + 10) * 1e-9)  # overlapping kernels merged
    assert t.kernel_seconds(lambda n: "rows_select_kernel" in n) == pytest.approx(70e-9)
    b = t.breakdown()
    assert b["device_ops"][0] == ["rows_select_kernel<4>", pytest.approx(70e-9)]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert dict((k, v) for k, v in b["idle_gaps"])["aten::nonzero"] > 0


def test_readers_on_a_slice():
    run = types.SimpleNamespace(trace=trace.Trace(EVENTS, units=2), calls=trace.Calls())
    assert harness.metric_reader("launches_per_frame.render").read(run) == 1.0
    idle = harness.metric_reader("device_idle_pct.render").read(run)
    assert idle == pytest.approx(100 * (1 - 100 / 300))
    k7 = harness.metric_reader("rows_select_roofline.render")
    assert k7.read(run) is None  # no call recorded: nothing to read
    run.calls.shapes[k7.KEY].append((1000, 8, 4))
    assert k7.read(run) == pytest.approx(100 * k7.least_s(1000, 8, 4) / 70e-9)


def test_calls_wrapper_records_and_restores():
    owner = types.SimpleNamespace()

    def f(x):
        f.launches += 1
        return x

    f.launches = 0
    owner.f = f
    calls = trace.Calls()
    calls.wrap(owner, "f", "f", lambda x: (x,))
    calls.on = True
    assert owner.f(3) == 3
    calls.on = False
    calls.restore()
    assert owner.f is f and calls.shapes["f"] == [(3,)]


def test_short_kernel_names():
    assert trace._short("void (anonymous namespace)::bvh_traverse_kernel<1, 0>(float const*, "
                        "int)") == "bvh_traverse_kernel<1, 0>"
    assert trace._short("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"
