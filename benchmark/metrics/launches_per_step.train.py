"""Kernel launches a step: the host's launch calls (cudaLaunchKernel and
the driver API's cuLaunchKernel) in the profiled slice, over the steps
in it. The bounce body's many small launches are what holds the device
idle (the host is the bottleneck); moves setup_s (set-up drives the
first steps; train_mrays_per_s, which it would move, is not end to end)."""


def read(run):
    t = run.trace
    return t.launches / t.units if t.launches else None
