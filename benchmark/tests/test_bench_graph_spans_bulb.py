"""The readers of the sample step's CUDA-graph spans in the Mandelbulb's
frames (`graphed_iterations_pct.bulb`, `capture_ms_per_frame.bulb`) on
made-up profiler events: they read as their `.render` namesakes do, and
give None where the program emits no such span."""

from __future__ import annotations

import pytest

from benchmark.tests.test_bench_graph_spans import GRAPHED
from benchmark.tests.test_bench_spans import FRAME_EVENTS, dev, host, read


@pytest.mark.parametrize("name", ["graphed_iterations_pct.bulb", "capture_ms_per_frame.bulb"])
def test_a_bulb_reader_reads_as_its_render_namesake(name):
    """A Mandelbulb frame's passes run the sample step, whose trips emit the
    same spans: the `.bulb` reader gives what the `.render` one gives, and
    None where the program emits no such span, as its parent does."""
    namesake = name.replace(".bulb", ".render")
    mixed = [e for e in GRAPHED if not (e.name() == "integrator.graphed"
                                        and e.start_ns() == 505)]
    mixed += [host("render.frame", 2000, 2400), host("integrator.iteration", 2100, 2300),
              host("integrator.graphed", 2110, 2290), host("integrator.capture", 2120, 2160)]
    for events, units in ((GRAPHED, 1), (mixed, 2)):
        got = read((name, namesake), events, units=units)
        assert got[name] == got[namesake] is not None and got[name] > 0
    assert read((name,), FRAME_EVENTS)[name] is None
    assert read((name,), [dev(0, 10)])[name] is None
