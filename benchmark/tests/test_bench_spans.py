"""The span readers (`benchmark/spans.py` and the metrics that use it) on
made-up profiler events, and on a toy cell's real slice on the CPU."""

from __future__ import annotations

import types

import pytest

from benchmark import harness, spans, trace
from benchmark.tests import helpers
from benchmark.tests.test_bench_roofline import Ev

FRAME = ("iterations_per_frame.render", "idle_ms_per_iteration.render",
         "shade_idle_ms_per_iteration.render", "idle_ms_outside_loop.render")
TRAIN = ("pass1_s.train", "recompute_s.train", "backward_s.train")


class Annotation(Ev):
    """A span's copy on the device's timeline (a gpu_user_annotation)."""

    def is_user_annotation(self):
        return True


def host(name, start, end):
    return Ev(name, start, end - start, False)


def dev(start, end, name="void k(float*)"):
    return Ev(name, start, end - start, True)


# A frame [0, 1000] with two iterations; the device busy [150, 250] inside
# the first shade, [350, 450] across the first iteration's end, [600, 650]
# inside the second shade and [900, 950] outside the loop.
FRAME_EVENTS = [host("render.frame", 0, 1000),
                host("integrator.iteration", 100, 400), host("integrator.shade", 120, 300),
                host("integrator.iteration", 500, 800), host("integrator.shade", 520, 700),
                host("aten::mul", 130, 140),
                dev(150, 250), dev(350, 450), dev(600, 650), dev(900, 950),
                Annotation("render.frame", 0, 1000, True)]


def read(names, events, units=1):
    run = types.SimpleNamespace(trace=trace.Trace(events, units=units))
    return {n: harness.metric_reader(n).read(run) for n in names}


def test_idle_inside_an_interval():
    idle = spans.Idle(trace.Trace(FRAME_EVENTS, units=1))
    assert idle.ns(0, 1000) == 700  # the annotation is not busy time
    assert idle.ns(100, 400) == 150  # [350, 450] straddles the end
    assert idle.ns(400, 500) == 50  # and the start
    assert idle.ns(160, 240) == 0 and idle.ns(960, 990) == 30
    assert idle.ns(-50, 0) == 50  # before the first operation


def test_frame_readers_and_their_sum():
    got = read(FRAME, FRAME_EVENTS)
    assert got["iterations_per_frame.render"] == 2
    assert got["idle_ms_per_iteration.render"] == pytest.approx((150 + 250) / 2 * 1e-6)
    assert got["shade_idle_ms_per_iteration.render"] == pytest.approx((80 + 130) / 2 * 1e-6)
    assert got["idle_ms_outside_loop.render"] == pytest.approx(300e-6)
    assert got["shade_idle_ms_per_iteration.render"] <= got["idle_ms_per_iteration.render"]
    t = trace.Trace(FRAME_EVENTS, units=1)
    total_ms = (t.window_s - t.busy_s) * 1e3  # the frame spans the whole slice here
    assert (got["iterations_per_frame.render"] * got["idle_ms_per_iteration.render"]
            + got["idle_ms_outside_loop.render"]) == pytest.approx(total_ms)


def test_iterations_outside_a_frame_are_not_counted():
    events = FRAME_EVENTS + [host("integrator.iteration", 1100, 1200),
                             host("integrator.shade", 1110, 1190),
                             host("render.frame", 2000, 2400),
                             host("integrator.iteration", 2100, 2300),
                             host("integrator.shade", 2150, 2250)]
    got = read(FRAME, events, units=2)
    assert got["iterations_per_frame.render"] == 1.5
    assert got["idle_ms_per_iteration.render"] == pytest.approx((150 + 250 + 200) / 3 * 1e-6)
    assert got["idle_ms_outside_loop.render"] == pytest.approx((300 + 200) / 2 * 1e-6)


def test_step_phases():
    events = [host("train.step", 0, 10_000), host("train.pass1", 100, 2100),
              host("train.cell_forward", 3000, 3500), host("train.cell_backward", 3600, 4600),
              host("train.cell_forward", 5000, 5500), host("train.cell_backward", 5600, 6600),
              host("train.step", 20_000, 30_000), host("train.pass1", 20_100, 22_100),
              host("train.cell_forward", 22_200, 22_300),
              host("train.cell_backward", 22_400, 22_500),
              host("train.cell_forward", 40_000, 41_000),  # outside a step: not counted
              dev(150, 250)]
    got = read(TRAIN, events, units=2)
    assert got["pass1_s.train"] == pytest.approx(2000e-9)
    assert got["recompute_s.train"] == pytest.approx((500 + 500 + 100) / 2 * 1e-9)
    assert got["backward_s.train"] == pytest.approx((1000 + 1000 + 100) / 2 * 1e-9)


def test_no_span_reads_none():
    """The parent of the spans' change emits none: every reader gives
    None and raises nothing."""
    events = [e for e in FRAME_EVENTS if not e.name().startswith(("render.", "integrator."))]
    assert set(read(FRAME + TRAIN, events).values()) == {None}
    # a frame without iterations, a step without the phase
    got = read(FRAME + TRAIN, events + [host("render.frame", 0, 1000),
                                        host("train.step", 0, 1000)])
    assert set(got.values()) == {None}


@pytest.mark.parametrize("cell", ["example-frame", "example-train"])
def test_readers_on_a_toy_cells_slice(cell, monkeypatch):
    """A real slice of the port at a toy size on the CPU: the program's
    spans are there, and with no device operation every span is idle. The
    toy step takes the cell's two-pass scheme under a ray budget of one."""
    from raysnail_tpu_torch.diff import train

    monkeypatch.setattr(train, "GRAD_RAY_BUDGET", 1)
    c = helpers.small_cell(cell)
    run = helpers.run_of(c)
    driver = c.driver().Driver(run)
    with trace.Slice(1) as s:
        driver.unit()
    run.trace = s.trace
    names = FRAME if cell == "example-frame" else TRAIN
    got = {n: harness.metric_reader(n).read(run) for n in names}
    assert all(v is not None and v > 0 for v in got.values()), got
    if cell == "example-frame":
        frames, its, shades = spans.frame_loop(run.trace)
        assert len(frames) == 1 and len(its) == len(shades) == got[names[0]]
        frame_ms = (frames[0][1] - frames[0][0]) * 1e-6
        assert (got[names[0]] * got[names[1]] + got[names[3]]) == pytest.approx(frame_ms)
