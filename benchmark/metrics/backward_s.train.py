"""Host seconds a step in the per-cell backward passes: the program's
`train.cell_backward` spans inside its `train.step` spans in the profiled
slice, over the steps. On the card autograd's device thread does the work
while the main thread waits inside the span. The profiler's host cost
lengthens them. Moves setup_s (set-up drives the first steps;
train_mrays_per_s, which it would move, is not end to end)."""

from benchmark import spans


def read(run):
    return spans.step_phase_s(run.trace, "train.cell_backward")
