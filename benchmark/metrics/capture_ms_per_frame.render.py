"""Host ms a frame spent capturing the program's CUDA graphs: the length
of the `integrator.capture` spans inside the slice's `render.frame` spans,
over the frames. The frame loop captures its trip once a call and replays
it on every later trip, so this is the price of the replays. The
profiler's host cost lengthens the spans. None where the program emits no
`integrator.capture` span. Moves render_mrays_per_s."""

from benchmark import spans


def read(run):
    got = spans.pick(run.trace, "render.frame", "integrator.capture")
    frames = got["render.frame"]
    captures = spans.within(got["integrator.capture"], frames)
    if not frames or not captures:
        return None
    return sum(e - s for s, e in captures) * 1e-6 / len(frames)
