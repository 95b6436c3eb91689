"""Share of a frame's shade iterations run from the program's CUDA graphs:
100 x the `integrator.iteration` spans inside the slice's `render.frame`
spans that hold an `integrator.graphed` span, over those iterations. A trip
that replays (or captures) its body launches a few dozen host calls where
an eager trip launches about a thousand. None where the program emits no
`integrator.graphed` span. Moves render_mrays_per_s."""

import bisect

from benchmark import spans


def read(run):
    got = spans.pick(run.trace, "render.frame", "integrator.iteration", "integrator.graphed")
    its = spans.within(got["integrator.iteration"], got["render.frame"])
    if not its or not got["integrator.graphed"]:
        return None
    starts = [s for s, _ in its]
    holding = set()
    for s, e in got["integrator.graphed"]:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= its[i][1]:
            holding.add(i)
    return 100.0 * len(holding) / len(its)
