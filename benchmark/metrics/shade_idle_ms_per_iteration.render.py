"""Device idle ms a shade iteration inside its bounce body: the slice's
idle time inside the program's `integrator.shade` spans (within the
frames' iterations), over the iteration count. The rest of
`idle_ms_per_iteration.render` lies in the regeneration's bookkeeping
and the loop's condition. Moves render_mrays_per_s."""

from benchmark import spans


def read(run):
    _, its, shades = spans.frame_loop(run.trace)
    if not its or not shades:
        return None
    return spans.Idle(run.trace).total_ns(shades) * 1e-6 / len(its)
