"""Host ms a frame in the adaptive passes' noise map: the program's
`render.noise` spans (the 5x5 noise over the whole image on the host, the
redo mask and the tile sort of the pixels to redo) inside its
`render.frame` spans in the profiled slice, over the frames. None where
the program emits no such span. Moves render_mrays_per_s."""

from benchmark import spans


def read(run):
    got = spans.pick(run.trace, "render.frame", "render.noise")
    frames = got["render.frame"]
    noise = spans.within(got["render.noise"], frames)
    if not frames or not noise:
        return None
    return sum(e - s for s, e in noise) * 1e-6 / len(frames)
