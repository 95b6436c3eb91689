"""Share of a Mandelbulb frame's shade iterations run from the program's
CUDA graphs, read as `graphed_iterations_pct.render` reads it: 100 x the
`integrator.iteration` spans inside the slice's `render.frame` spans that
hold an `integrator.graphed` span, over those iterations. Every pass of a
bulb frame runs the sample step (`integrator.radiance_regen`), so this says
how often its trips run from the graphs. None where the program emits no
`integrator.graphed` span. Moves render_mrays_per_s."""

from benchmark import harness


def read(run):
    return harness.metric_reader("graphed_iterations_pct.render").read(run)
