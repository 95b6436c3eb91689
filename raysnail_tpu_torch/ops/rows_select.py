"""Per-ray row selects: K7, the gather of a small table's rows by per-ray
indices, and K7b, its transpose summed in one fixed order; the CUDA kernels
and their plain PyTorch versions.

The JAX package fetches every small-table row of a material or a texture on
an accelerator with a one-hot select (`raysnail_tpu/geometry/hit.py:88-104`
`onehot_of`, `select_table`, from `materials.py:94` and `textures.py:75`):
sum(where(onehot, table, 0), axis=1). No Pallas kernel: XLA fuses the
select, and its transpose reduces the rays' cotangents into the rows in
XLA's fixed order, with no atomics. A gather's usual backward on the card
(`index_add_`) adds with atomics in no fixed order, so the gradient's bits
change from run to run.

A table is K <= MAX_COLUMNS float columns of R entries, each its own (R,)
tensor (the port keeps a table's fields apart); the kernels take each
column's pointer and stride, so nothing stacks them first. Here:

- `rows_select_plain(table, idx)`: table (R, K), idx (N,) int64 -> (N, K),
  exactly `table[idx]`. `rows_select(columns, idx)` -> the K (N,) columns
  of it; on a CUDA tensor it launches K7 (`csrc/rows_select.cu`), one
  launch for the K columns, which it writes as the rows of one (K, N)
  tensor, each a contiguous (N,) view.
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
  (N,) cotangents (None for zeros); on a CUDA tensor it launches K7b (two
  launches: the chunks' sums, then their sum, written as the rows of one
  (K, R) tensor), bit-equal to the plain version.
- `RowsSelect`: the autograd Function of the pair; the index gets no
  gradient.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor they
launch the kernel or raise (float32 only, K <= MAX_COLUMNS), never a plain
version, `index_select` or `index_add_`. Every index must lie in [0, R):
on the CPU the wrappers raise IndexError, on the card the kernels stop
with a device-side assert, as index_select does. N = 0 needs no kernel:
the wrappers return the empty gather and a zero gradient.

`rows_select.launches` and `rows_select_bwd.launches` count kernel calls
(K7b's two launches count once), not plain-version calls.
"""

from __future__ import annotations

import ctypes

import torch

from raysnail_tpu_torch.ops import _nvcc

# the order's constants; csrc/rows_select.cu's kSegment, kRunSegments and
# kWarps (tests/test_torch_rows_select.py holds them equal)
SEGMENT = 32        # rays a segment (a warp's lanes)
RUN_SEGMENTS = 8    # segments a run (one warp's share of a chunk)
CHUNK_RUNS = 8      # runs a chunk (a K7b block's warps)
CHUNK = SEGMENT * RUN_SEGMENTS * CHUNK_RUNS
MAX_COLUMNS = 8

_lib = None


def build(verbose: bool = False) -> str:
    """Compile the kernels if their library is missing; -> the library path."""
    return _nvcc.build_cuda("rows_select", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rows_select_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
        lib.rows_select_launch.restype = i32
        lib.rows_select_bwd_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr]
        lib.rows_select_bwd_launch.restype = i32
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


def _pointers(columns) -> tuple:
    """ctypes arrays of the columns' addresses (null for None) and element
    strides."""
    k = len(columns)
    ptrs = (ctypes.c_void_p * k)(*(0 if c is None else c.data_ptr() for c in columns))
    strides = (ctypes.c_longlong * k)(*(0 if c is None else c.stride(0) for c in columns))
    return ptrs, strides


def _launch(name, fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def rows_select(columns, idx: torch.Tensor) -> tuple:
    """K7: -> K (N,) tensors, columns[k][idx], for K <= 8 float columns (R,)
    (any strides) and idx (N,) int64."""
    device, n, k = idx.device, idx.shape[0], len(columns)
    rows = columns[0].shape[0] if k else 0
    _check_sizes(rows, k, n)
    _check("idx", idx, (n,), torch.int64, device)
    for c in columns:
        _check("a column", c, (rows,), None if device.type == "cpu" else torch.float32, device)
    if device.type == "cpu":
        _check_range(idx, rows)
        return tuple(rows_select_plain(torch.stack(tuple(columns), dim=1), idx).unbind(1))
    if device.type != "cuda":
        raise ValueError(f"rows_select: unsupported device {device}")
    out = torch.empty((k, n), dtype=torch.float32, device=device)
    if n == 0:
        return out.unbind(0)
    idx = idx.contiguous()
    cols, strides = _pointers(columns)
    lib = _load()
    with torch.cuda.device(device):
        _launch("rows_select", lib.rows_select_launch, cols, strides, idx.data_ptr(), n, rows,
                k, out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    rows_select.launches += 1
    return out.unbind(0)


rows_select.launches = 0


def rows_select_bwd(grads, idx: torch.Tensor, rows: int) -> tuple:
    """K7b: -> K (R,) tensors, the rows' sums of the cotangents grads[k]
    (N,) (any strides; None for zeros) in the module docstring's order."""
    device, n, k = idx.device, idx.shape[0], len(grads)
    _check_sizes(rows, k, n)
    _check("idx", idx, (n,), torch.int64, device)
    given = [g for g in grads if g is not None]
    if not given:
        raise ValueError("rows_select_bwd: every cotangent is None")
    for g in given:
        _check("a cotangent", g, (n,), None if device.type == "cpu" else torch.float32, device)
    if device.type == "cpu":
        _check_range(idx, rows)
        g = torch.stack([torch.zeros_like(given[0]) if x is None else x for x in grads], dim=1)
        return tuple(rows_select_bwd_plain(g, idx, rows).unbind(1))
    if device.type != "cuda":
        raise ValueError(f"rows_select_bwd: unsupported device {device}")
    out = torch.empty((k, rows), dtype=torch.float32, device=device)
    if n == 0:
        return out.zero_().unbind(0)
    idx = idx.contiguous()
    part = torch.empty(-(-n // CHUNK) * rows * k, dtype=torch.float32, device=device)
    gs, strides = _pointers(grads)
    lib = _load()
    with torch.cuda.device(device):
        _launch("rows_select_bwd", lib.rows_select_bwd_launch, gs, strides, idx.data_ptr(), n,
                rows, k, part.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream)
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
        return rows_select(columns, idx)

    @staticmethod
    def backward(ctx, *grads):
        if all(g is None for g in grads):
            return (None,) * (1 + len(grads))
        (idx,) = ctx.saved_tensors
        return (None, *rows_select_bwd(grads, idx, ctx.rows))
