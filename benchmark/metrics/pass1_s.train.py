"""Host seconds a step in pass 1, the mean image and the loss under
no_grad through the shuffled regeneration loop: the program's
`train.pass1` spans inside its `train.step` spans in the profiled slice,
over the steps. The profiler's host cost lengthens them. Moves setup_s
(set-up drives the first steps; train_mrays_per_s, which it would move,
is not end to end)."""

from benchmark import spans


def read(run):
    return spans.step_phase_s(run.trace, "train.pass1")
