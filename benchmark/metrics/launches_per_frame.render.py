"""Kernel launches a frame: the host's launch calls (cudaLaunchKernel and
the driver API's cuLaunchKernel) in the profiled slice, over the frames
in it. The bounce body's many small launches are what holds the device
idle (the host is the bottleneck); moves render_mrays_per_s."""


def read(run):
    t = run.trace
    return t.launches / t.units if t.launches else None
