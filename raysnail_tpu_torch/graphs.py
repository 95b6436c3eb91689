"""One trip of a loop as piecewise CUDA graphs, with the hand-written
kernels launched eagerly in the holes between them.

A trip of a regeneration loop (`integrator.radiance_regen_shuffle`, the
frame step, and `integrator.radiance_regen`, the sample step) is about a
thousand small launches of plain PyTorch and a few of the hand-written
kernels K1, K6 and K7. `TripGraphs` captures the call's first trip
piece by piece and replays those pieces on every later trip:

  * a piece is a function of the loop's state (`TripGraphs.piece`). On the
    capturing trip its code runs under stream capture on a side stream,
    into one memory pool that all of the call's graphs share; each stretch
    between two holes becomes a graph, which is replayed at once, so the
    capturing trip computes what an eager trip computes and no kernel runs
    twice;
  * a hole is a call of one of `HOLES`, the kernels that stay outside the
    graphs. During the capture each is cut out: the graph so far ends, the
    kernel runs eagerly through the module attribute its callers use, and a
    new graph begins, reading the kernel's real outputs. A replay calls the
    kernel again through that attribute, with the same arguments, and
    copies its outputs to the addresses the next graph was captured
    reading;
  * the call's state lives in buffers that the pieces read and write in
    place, and a piece returns the same tensors on every trip.

Memory: everything a graph allocates lies in the call's pool, which stays
reserved until `release`. The holes keep only non-owning views of their
arguments and outputs (`_borrow`), and the outputs of a hole's capturing
call are allocated in the pool: a tensor that the eager loop frees early is
then freed as early during the capture, where the pool hands its memory to
later allocations only in capture order, which is replay order. So the
capture's peak is the eager trip's.

Streams: the graphs replay, and the holes run, on the stream that was
current when the `TripGraphs` was made; only the capture uses a side
stream (a capture cannot run on the legacy default stream), one a device.
"""

from __future__ import annotations

import contextlib

import torch

from raysnail_tpu_torch.geometry import spheres
from raysnail_tpu_torch.ops import mandelbulb_march, rows_select
from raysnail_tpu_torch.utils.profiling import span

# The hand-written kernels that run between the graphs, each named by the
# module attribute its callers go through: K1, the rays' closest sphere
# (`spheres.intersect`), K7, the rows' select (`prelude.vec.take_rows`), and
# K6, the Mandelbulb's march (`geometry.mandelbulb.MandelbulbNode.hit`).
# A replay calls them through these attributes, so whatever wraps an
# attribute sees every call.
HOLES = ((spheres, "sphere_min_t"), (rows_select, "rows_select"),
         (mandelbulb_march, "mandelbulb_march"))

_TYPESTR = {torch.float32: "<f4", torch.int64: "<i8", torch.int32: "<i4", torch.bool: "|b1"}


class _Memory:
    """A CUDA tensor's memory in the CUDA array interface, which
    `torch.as_tensor` reads into a tensor that does not own it."""

    def __init__(self, t: torch.Tensor):
        size = t.element_size()
        self.__cuda_array_interface__ = {
            "shape": tuple(t.shape), "strides": tuple(s * size for s in t.stride()),
            "typestr": _TYPESTR[t.dtype], "data": (t.data_ptr(), False), "version": 2}


def _borrow(tree):
    """Tensors in a nest of tuples and lists -> views of the same memory
    that do not keep it allocated."""
    if isinstance(tree, torch.Tensor):
        return torch.as_tensor(_Memory(tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_borrow(a) for a in tree)
    return tree


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for a in tree for t in _tensors(a)]
    return []


class _Hole:
    """One call of a kernel in `HOLES`, as the capture met it."""

    def __init__(self, owner, attr: str, args, kwargs, out):
        self.owner, self.attr = owner, attr
        self.args, self.kwargs = _borrow(args), {k: _borrow(v) for k, v in kwargs.items()}
        self.out = _tensors(_borrow(out))

    def __call__(self):
        got = getattr(self.owner, self.attr)(*self.args, **self.kwargs)
        for dst, src in zip(self.out, _tensors(got)):
            dst.copy_(src)


# One capture stream a device, kept across calls: a capture allocates a
# little outside its pool on the stream it captures (the generators' capture
# state), which a stream of its own each call would leave cached for good.
_SIDE_STREAMS: dict = {}


def _side_stream(index: int) -> torch.cuda.Stream:
    stream = _SIDE_STREAMS.get(index)
    if stream is None:
        stream = _SIDE_STREAMS[index] = torch.cuda.Stream(index)
    return stream


class TripGraphs:
    """The graphs of one call's trips on `device`. Run each trip's pieces
    through `piece` in the same order every trip and call `end_trip` after
    each trip: the first trip captures, every later one replays. `release`
    frees the graphs and their pool."""

    def __init__(self, device: torch.device):
        self.device = torch.device("cuda", device.index if device.index is not None
                                   else torch.cuda.current_device())
        self.main = torch.cuda.current_stream(self.device)
        self._side = _side_stream(self.device.index)
        self._pool = torch.cuda.MemPool()
        self._pieces = []      # [(steps, outputs)]: a step is a graph's replay or a _Hole
        self._captured = False
        self._next = 0
        self._steps = self._graph = self._span = None

    def piece(self, fn, *args):
        """fn(*args) as the trip's next piece -> its outputs, the same
        tensors on every trip."""
        if self._captured:
            steps, out = self._pieces[self._next]
            self._next += 1
            for step in steps:
                step()
            return out
        self._steps = []
        originals = [(owner, attr, getattr(owner, attr)) for owner, attr in HOLES]
        for owner, attr, kernel in originals:
            setattr(owner, attr, self._cutter(owner, attr, kernel))
        try:
            self._begin()
            out = fn(*args)
            self._end()
        except BaseException:
            if self._graph is not None:  # the error left the capture open
                self._abort()
            raise
        finally:
            for owner, attr, kernel in originals:
                setattr(owner, attr, kernel)
        self._pieces.append((self._steps, out))
        return out

    def end_trip(self):
        self._captured = True
        self._next = 0

    def release(self):
        """Drop the graphs, then the pool (whose memory goes back to the
        device once no graph uses it)."""
        self._pieces = self._steps = None
        self._pool = None

    def _cutter(self, owner, attr: str, kernel):
        def cut(*args, **kwargs):
            self._end()
            with torch.cuda.use_mem_pool(self._pool, self.device):
                out = kernel(*args, **kwargs)
            self._steps.append(_Hole(owner, attr, args, kwargs, out))
            self._begin()
            return out

        # one attribute dict with the kernel: its launch counters stay its
        # own whichever name a launch bumps them under (K1 bumps them under
        # its module's name, K6 and K7 under the name the cutter takes)
        cut.__dict__ = kernel.__dict__
        return cut

    def _begin(self):
        self._span = span("integrator.capture")
        self._span.__enter__()
        self._graph = torch.cuda.CUDAGraph()
        torch.cuda.set_stream(self._side)
        self._graph.capture_begin(pool=self._pool.id, capture_error_mode="thread_local")

    def _end(self):
        graph, self._graph = self._graph, None
        try:
            graph.capture_end()
        finally:
            torch.cuda.set_stream(self.main)
            self._span.__exit__(None, None, None)
        graph.replay()
        self._steps.append(graph.replay)

    def _abort(self):
        """Close a capture that an error left open, without replaying it;
        the error that did so is the one to raise."""
        graph, self._graph = self._graph, None
        try:
            with contextlib.suppress(RuntimeError):  # an invalidated capture
                graph.capture_end()
        finally:
            torch.cuda.set_stream(self.main)
            self._span.__exit__(None, None, None)
