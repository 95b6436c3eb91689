"""Device idle ms a shade iteration: the slice's idle time (each span's
length less its overlap with the device's operations) inside the
program's `integrator.iteration` spans of its frames, over their count.
The profiler's host cost lengthens the spans, so this reads above an
unprofiled frame's. Moves render_mrays_per_s."""

from benchmark import spans


def read(run):
    _, its, _ = spans.frame_loop(run.trace)
    if not its:
        return None
    return spans.Idle(run.trace).total_ns(its) * 1e-6 / len(its)
