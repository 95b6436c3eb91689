"""The device's idle share of the profiled slice: 100 * (1 - the union of
its operations' intervals / the slice's length). The profiler's own cost
on the host lengthens the slice, so this reads higher than an unprofiled
run would."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
