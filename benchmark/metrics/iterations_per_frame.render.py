"""Shade iterations a frame: the program's `integrator.iteration` spans
inside its `render.frame` spans in the profiled slice, over the frames.
A trip of the regeneration loop launches the bounce body and the
regeneration's bookkeeping; fewer trips, fewer launches. Moves
render_mrays_per_s."""

from benchmark import spans


def read(run):
    frames, its, _ = spans.frame_loop(run.trace)
    return len(its) / len(frames) if frames and its else None
