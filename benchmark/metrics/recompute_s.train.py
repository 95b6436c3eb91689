"""Host seconds a step in the per-cell recompute, each cell's image with
the gradient on through the scan: the program's `train.cell_forward`
spans inside its `train.step` spans in the profiled slice, over the
steps. The profiler's host cost lengthens them. Moves setup_s (set-up
drives the first steps; train_mrays_per_s, which it would move, is not
end to end)."""

from benchmark import spans


def read(run):
    return spans.step_phase_s(run.trace, "train.cell_forward")
