"""Device ms a frame in the Mandelbulb's march K6: the device time of the
slice's `mandelbulb_march_kernel` launches over its frames, each launch
as the program makes it. None where no K6 ran. Moves render_mrays_per_s."""


def read(run):
    dev = run.trace.kernel_seconds(lambda n: "mandelbulb_march_kernel" in n)
    return dev * 1e3 / run.trace.units if dev > 0 else None
