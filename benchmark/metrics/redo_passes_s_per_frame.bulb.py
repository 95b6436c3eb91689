"""Host seconds a frame in the adaptive passes after the first: the
program's `render.pass` spans inside its `render.frame` spans in the
profiled slice, each frame's first pass left out, over the frames. The
later passes redo the noisy pixels through the sample step; the
profiler's host cost lengthens them. None where the program emits no
`render.pass` span. Moves render_mrays_per_s."""

from benchmark import spans


def read(run):
    got = spans.pick(run.trace, "render.frame", "render.pass")
    frames = got["render.frame"]
    if not frames or not got["render.pass"]:
        return None
    later = 0
    for frame in frames:
        passes = spans.within(got["render.pass"], [frame])
        later += sum(e - s for s, e in passes[1:])
    return later * 1e-9 / len(frames)
