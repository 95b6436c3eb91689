"""Host ms a Mandelbulb frame spent capturing the program's CUDA graphs,
read as `capture_ms_per_frame.render` reads it: the length of the
`integrator.capture` spans inside the slice's `render.frame` spans, over
the frames. Each pass is one call of the sample step, which captures its
first trip and replays it on every later trip, so a frame captures once a
pass. None where the program emits no `integrator.capture` span. Moves
render_mrays_per_s."""

from benchmark import harness


def read(run):
    return harness.metric_reader("capture_ms_per_frame.render").read(run)
