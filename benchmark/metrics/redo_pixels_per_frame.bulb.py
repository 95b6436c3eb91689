"""Pixels a frame that the adaptive passes redo: the growth of the
program's counter `render.render_passes.redone_pixels` over the profiled
slice, over its frames. It moves with the image's noise, and explains a
rate that moves where no kernel got faster. None where the program keeps
no such counter. Moves render_mrays_per_s."""


def _count():
    from raysnail_tpu_torch import render

    return getattr(render.render_passes, "redone_pixels", None)


def instrument(run):
    run.redone_pixels_at_slice = _count()


def read(run):
    start, end = getattr(run, "redone_pixels_at_slice", None), _count()
    if start is None or end is None:
        return None
    return (end - start) / run.trace.units
