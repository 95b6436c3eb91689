"""The readers of the frame loop's CUDA-graph spans
(`graphed_iterations_pct.render`, `capture_ms_per_frame.render`) on
made-up profiler events, and on a toy cell's real slice on the CPU, where
the program never captures."""

from __future__ import annotations

import pytest

from benchmark import harness, trace
from benchmark.tests import helpers
from benchmark.tests.test_bench_spans import FRAME_EVENTS, dev, host, read

GRAPH = ("graphed_iterations_pct.render", "capture_ms_per_frame.render")

# FRAME_EVENTS' frame [0, 1000] with its iterations [100, 400] and
# [500, 800]: the first captures in two stretches and both run graphed.
GRAPHED = FRAME_EVENTS + [host("integrator.graphed", 105, 395),
                          host("integrator.capture", 110, 130),
                          host("integrator.capture", 260, 290),
                          host("integrator.graphed", 505, 795)]


def test_every_iteration_graphed_and_the_capture_per_frame():
    got = read(GRAPH, GRAPHED)
    assert got["graphed_iterations_pct.render"] == 100.0
    assert got["capture_ms_per_frame.render"] == pytest.approx((20 + 30) * 1e-6)


def test_an_eager_iteration_and_spans_outside_a_frame():
    events = [e for e in GRAPHED if not (e.name() == "integrator.graphed"
                                         and e.start_ns() == 505)]
    events += [host("render.frame", 2000, 2400), host("integrator.iteration", 2100, 2300),
               host("integrator.graphed", 2110, 2290), host("integrator.capture", 2120, 2160),
               host("integrator.iteration", 3000, 3100),  # outside a frame: not counted
               host("integrator.graphed", 3010, 3090), host("integrator.capture", 3020, 3030),
               dev(2150, 2250)]
    got = read(GRAPH, events, units=2)
    assert got["graphed_iterations_pct.render"] == pytest.approx(100.0 * 2 / 3)
    assert got["capture_ms_per_frame.render"] == pytest.approx((20 + 30 + 40) / 2 * 1e-6)


def test_a_program_without_the_graphs_reads_none():
    """The parent of the graphs emits neither span: both readers give None
    and raise nothing, with or without frames and iterations."""
    assert set(read(GRAPH, FRAME_EVENTS).values()) == {None}
    assert set(read(GRAPH, [dev(0, 10)]).values()) == {None}
    # spans outside any frame are not read
    got = read(GRAPH, [host("integrator.graphed", 0, 10), host("integrator.capture", 0, 5)])
    assert set(got.values()) == {None}


def test_a_cpu_frame_has_no_graph_to_read():
    """A toy frame cell's real slice on the CPU: the iterations are there,
    the graphs are not (they capture only on the card)."""
    c = helpers.small_cell("example-frame")
    run = helpers.run_of(c)
    driver = c.driver().Driver(run)
    with trace.Slice(1) as s:
        driver.unit()
    run.trace = s.trace
    assert harness.metric_reader("iterations_per_frame.render").read(run) > 0
    assert {n: harness.metric_reader(n).read(run) for n in GRAPH} == dict.fromkeys(GRAPH)
