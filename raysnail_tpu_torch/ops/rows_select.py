"""Per-ray row selects: K7, the gather of a small table's rows by per-ray
indices, and K7b, its transpose summed in one fixed order; the CUDA kernels
and their plain PyTorch versions.

The JAX package fetches every small-table row of a material or a texture on
an accelerator with a one-hot select (`raysnail_tpu/geometry/hit.py:88-104`
`onehot_of`, `select_table`, from `materials.py:94` and `textures.py:75`):
sum(where(onehot, table, 0), axis=1). No Pallas kernel: XLA fuses the
select, and its transpose reduces the rays' cotangents into the rows in
XLA's fixed order. A gather's usual backward on the card (`index_add_`)
adds with atomics in no fixed order, so the gradient's bits change from
run to run.

A table is K <= MAX_COLUMNS float columns of R entries, each its own (R,)
tensor (the port keeps a table's fields apart); the kernels take each
column's pointer and stride, so nothing stacks them first. Here:

- `rows_select_plain(table, idx)`: table (R, K), idx (N,) int64 -> (N, K),
  exactly `table[idx]`. `rows_select(columns, idx)` -> one (K, N) tensor
  whose row k is columns[k][idx] (on the CPU the plain version's result,
  transposed); on a CUDA tensor it launches K7 (`csrc/rows_select.cu`), one
  launch for the K columns. Like `index_select`, whose yardstick it is, the
  call returns one tensor: `prelude.vec.take_rows` splits it into columns.
- `rows_select_bwd_plain(g, idx, rows)`: g (N, K) -> (R, K), the sum of
  each row's rays' cotangents in this order, which depends only on N:
    1. a segment is SEGMENT = 32 consecutive rays: each row's cotangents
       summed from +0.0 in ascending ray order;
    2. a run is RUN_SEGMENTS = 8 consecutive segments (256 rays): its
       segments' sums from +0.0 in ascending order;
    3. a chunk is CHUNK_RUNS = 8 consecutive runs (2,048 rays): its runs'
       sums from +0.0 in ascending order;
    4. the result: the chunks' sums from +0.0 in ascending order.
  The last segment, run and chunk are ragged. Each level equals the
  sequential sum of where(idx == r, g, 0) over its parts: a sum begun at
  +0.0 is never -0.0, so adding the +0.0 of a ray or a part without row r
  changes no bit. A NaN cotangent therefore lands in its own row only.
  `rows_select_bwd(grads, idx, rows)` -> the K (R,) columns of it from K
  (N,) cotangents (None for zeros); on a CUDA tensor it launches K7b, a
  block a chunk, bit-equal to the plain version. For a table of at most 64
  entries (R x K) that is one launch: the block that takes the last ticket
  of a counter adds the chunks' sums; a larger table takes a second launch
  for that sum.
- `RowsSelect`: the autograd Function of the pair; the index gets no
  gradient.

K7b's ticket counter is one int32 on the card for each (device, stream)
that launches K7b, zero between launches: the last block sets it back.
Two launches at once on two streams that shared one counter would mix
their tickets, so a block could take the last ticket while the other
launch's blocks were still writing, and sum partials not yet written. So
each stream has its own counter, and launches on one stream run one after
another. A launch captured into a CUDA graph could be replayed on another
stream beside a launch on the captured counter: the wrapper raises under
capture. The ticket decides which block sums, never the order of the sums.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise (float32 only, K <= MAX_COLUMNS), never a plain
version, `index_select` or `index_add_`. Every index must lie in [0, R):
on the CPU the wrappers raise IndexError, on the card the kernels stop
with a device-side assert, as index_select does. N = 0 needs no kernel:
the wrappers return the empty gather and a zero gradient. The checks on a
CUDA tensor read each column's attributes once; the launch's arguments go
to the kernels packed into one int64 array, with the current device's raw
stream (the device is switched only when the index lies on another). A
frame pays K7's call in host time three times a shade iteration.

`rows_select.launches` and `rows_select_bwd.launches` count kernel calls
(K7b's second launch, where it takes one, counts with its first), not
plain-version calls.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from raysnail_tpu_torch.ops import _nvcc

# the order's constants; csrc/rows_select.cu's kSegment, kRunSegments and
# kChunkRuns (tests/test_torch_rows_select.py holds them equal)
SEGMENT = 32        # rays a segment (a warp's lanes)
RUN_SEGMENTS = 8    # segments a run (one warp's share of a chunk)
CHUNK_RUNS = 8      # runs a chunk (a K7b block's warps)
CHUNK = SEGMENT * RUN_SEGMENTS * CHUNK_RUNS
MAX_COLUMNS = 8

_F32, _I64 = torch.float32, torch.int64
# the entry points' int64 arguments: K7's N, R, K, idx, out and K7b's N, R,
# K, idx, part, ticket, out, each then K pointers and K element strides
_K7_ARGS = [struct.Struct(f"<{5 + 2 * k}q") for k in range(MAX_COLUMNS + 1)]
_K7B_ARGS = [struct.Struct(f"<{7 + 2 * k}q") for k in range(MAX_COLUMNS + 1)]

_lib = None
_tickets = {}  # (device index, raw stream) -> K7b's ticket counter


def build(verbose: bool = False) -> str:
    """Compile the kernels if their library is missing; -> the library path."""
    return _nvcc.build_cuda("rows_select", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for fn in (lib.rows_select_launch, lib.rows_select_bwd_launch):
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]  # the packed int64s, the stream
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def rows_select_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7's plain version: table[idx], (N, K)."""
    return table[idx]


def _fold(parts: torch.Tensor) -> torch.Tensor:
    """The sum over dim 1 from +0.0 in ascending order."""
    acc = torch.zeros_like(parts[:, 0])
    for j in range(parts.shape[1]):
        acc = acc + parts[:, j]
    return acc


def rows_select_bwd_plain(g: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """K7b's plain version: (R, K), the sums of the module docstring's order.
    Each segment's sums are built a lane at a time, one ray of every segment
    per step (so no index repeats in a step), into a spare row R that takes
    the padding; any float dtype."""
    n, k = g.shape
    if n == 0:
        return torch.zeros((rows, k), dtype=g.dtype, device=g.device)
    chunks = -(-n // CHUNK)
    segments = chunks * CHUNK // SEGMENT
    pad = chunks * CHUNK - n
    at = torch.cat([idx, torch.full((pad,), rows, dtype=idx.dtype, device=idx.device)])
    at = (at.view(segments, SEGMENT)
          + torch.arange(segments, device=idx.device)[:, None] * (rows + 1))
    gp = torch.cat([g, g.new_zeros((pad, k))]).view(segments, SEGMENT, k)
    seg = g.new_zeros(((rows + 1) * segments, k))
    for lane in range(SEGMENT):  # 1: each segment's sums in ascending ray order
        a = at[:, lane]
        seg[a] = seg[a] + gp[:, lane]
    run = _fold(seg.view(segments // RUN_SEGMENTS, RUN_SEGMENTS, rows + 1, k))  # 2
    chunk = _fold(run.view(chunks, CHUNK_RUNS, rows + 1, k))                    # 3
    return _fold(chunk[None])[0, :rows]                                        # 4


def _check(name, a, shape, dtype, device):
    if a.device != device or (dtype is not None and a.dtype != dtype) or tuple(a.shape) != shape:
        want = f"{shape} {dtype} tensor" if dtype is not None else f"{shape} tensor"
        raise ValueError(f"rows_select: {name} must be a {want} on {device}, "
                         f"got {tuple(a.shape)} {a.dtype} on {a.device}")


def _check_sizes(rows: int, k: int, n: int):
    if not 1 <= k <= MAX_COLUMNS:
        raise ValueError(f"rows_select: 1 to {MAX_COLUMNS} columns, got {k}")
    if rows == 0 and n > 0:
        raise ValueError("rows_select: an empty table has no row to select")
    if n >= 2 ** 31 or rows * k >= 2 ** 31:
        raise ValueError(f"rows_select: N = {n} or R x K = {rows * k} too large for the kernel")


def _check_range(idx: torch.Tensor, rows: int):
    """On the CPU: every index in [0, R) (the kernels assert it on the card)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
        raise IndexError(f"rows_select: an index outside [0, {rows})")


def _cpu_inputs(name, tensors, idx, length, rows, k):
    """The CPU route's checks (any float dtype)."""
    device = idx.device
    _check_sizes(rows, k, idx.shape[0])
    _check("idx", idx, (idx.shape[0],), _I64, device)
    for t in tensors:
        if t is not None:
            _check(name, t, (length,), None, device)
    if device.type != "cpu":
        raise ValueError(f"rows_select: unsupported device {device}")
    _check_range(idx, rows)


def _cuda_index(idx: torch.Tensor, rows: int, k: int) -> tuple:
    """K7's and K7b's checks of idx on the card -> (N, its device index)."""
    if idx.dtype is not _I64 or idx.dim() != 1:
        _check("idx", idx, (idx.numel(),), _I64, idx.device)
    n = idx.shape[0]
    _check_sizes(rows, k, n)
    return n, idx.get_device()


def _columns(name: str, tensors, length: int, dev: int) -> list:
    """One pass over the K tensors (None reads as zeros), each a (length,)
    float32 tensor on CUDA device `dev` -> their pointers, then their
    element strides."""
    ptrs, strides, shape = [], [], (length,)
    for t in tensors:
        if t is None:
            ptrs.append(0)
            strides.append(0)
            continue
        if t.dtype is not _F32 or t.shape != shape or t.get_device() != dev:
            raise ValueError(f"rows_select: {name} must be a {shape} torch.float32 tensor on "
                             f"cuda:{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        ptrs.append(t.data_ptr())
        strides.append(t.stride()[0])
    return ptrs + strides


def _launch(name: str, fn, dev: int, args: bytes):
    """fn(args, stream) on device `dev`'s current raw stream."""
    if torch._C._cuda_getDevice() == dev:
        err = fn(args, torch._C._cuda_getCurrentRawStream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(args, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def rows_select(columns, idx: torch.Tensor) -> torch.Tensor:
    """K7: -> a (K, N) tensor whose row k is columns[k][idx], for K <= 8
    float columns (R,) (any strides) and idx (N,) int64."""
    k = len(columns)
    rows = columns[0].shape[0] if k and columns[0].dim() else 0
    if not idx.is_cuda:
        _cpu_inputs("a column", columns, idx, rows, rows, k)
        return rows_select_plain(torch.stack(tuple(columns), dim=1), idx).t()
    n, dev = _cuda_index(idx, rows, k)
    cols = _columns("a column", columns, rows, dev)
    out = columns[0].new_empty((k, n))  # float32 on dev, as checked: no arguments to parse
    if n == 0:
        return out
    _launch("rows_select", (_lib or _load()).rows_select_launch, dev, _K7_ARGS[k].pack(
        n, rows, k, idx.contiguous().data_ptr(), out.data_ptr(), *cols))
    rows_select.launches += 1
    return out


rows_select.launches = 0


def _ticket(dev: int, stream: int) -> torch.Tensor:
    """K7b's ticket counter for launches on `stream` of device `dev` (the
    module docstring says why one a stream)."""
    ticket = _tickets.get((dev, stream))
    if ticket is None:
        ticket = _tickets[dev, stream] = torch.zeros(1, dtype=torch.int32, device=dev)
    return ticket


def rows_select_bwd(grads, idx: torch.Tensor, rows: int) -> tuple:
    """K7b: -> K (R,) tensors, the rows' sums of the cotangents grads[k]
    (N,) (any strides; None for zeros) in the module docstring's order."""
    k = len(grads)
    if all(g is None for g in grads):
        _check_sizes(rows, k, idx.shape[0])
        raise ValueError("rows_select_bwd: every cotangent is None")
    if not idx.is_cuda:
        n = idx.shape[0]
        _cpu_inputs("a cotangent", grads, idx, n, rows, k)
        given = next(x for x in grads if x is not None)
        g = torch.stack([torch.zeros_like(given) if x is None else x for x in grads], dim=1)
        return tuple(rows_select_bwd_plain(g, idx, rows).unbind(1))
    n, dev = _cuda_index(idx, rows, k)
    cols = _columns("a cotangent", grads, n, dev)
    out = torch.empty((k, rows), dtype=_F32, device=dev)
    if n == 0:
        return out.zero_().unbind(0)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("rows_select_bwd: K7b's ticket counter cannot be captured into a "
                           "CUDA graph")
    part = torch.empty(-(-n // CHUNK) * (-(-rows * k // 4) * 4), dtype=_F32, device=dev)
    ticket = _ticket(dev, torch._C._cuda_getCurrentRawStream(dev))
    _launch("rows_select_bwd", (_lib or _load()).rows_select_bwd_launch, dev,
            _K7B_ARGS[k].pack(n, rows, k, idx.contiguous().data_ptr(), part.data_ptr(),
                              ticket.data_ptr(), out.data_ptr(), *cols))
    rows_select_bwd.launches += 1
    return out.unbind(0)


rows_select_bwd.launches = 0


class RowsSelect(torch.autograd.Function):
    """apply(idx (N,) int64, *columns (R,)) -> K (N,) tensors, columns[k][idx]:
    forward K7, backward K7b (the plain versions on the CPU). An output that
    gets no gradient is passed to K7b as None (zeros), not materialised."""

    @staticmethod
    def forward(ctx, idx, *columns):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(idx)
        ctx.rows = columns[0].shape[0]
        return rows_select(columns, idx).unbind(0)

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * (1 + len(grads))
        (idx,) = ctx.saved_tensors
        return (None, *rows_select_bwd(grads, idx, ctx.rows))
