"""Device idle ms a frame outside its shade iterations: the slice's idle
time inside the program's `render.frame` spans less that inside their
`integrator.iteration` spans, over the frames: the rays' set-up, the
regroup's rolls, the colour transform and the copy to the host. Moves
render_mrays_per_s."""

from benchmark import spans


def read(run):
    frames, its, _ = spans.frame_loop(run.trace)
    if not frames or not its:
        return None
    idle = spans.Idle(run.trace)
    return (idle.total_ns(frames) - idle.total_ns(its)) * 1e-6 / len(frames)
