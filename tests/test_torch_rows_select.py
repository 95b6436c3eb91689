"""The port's per-ray row selects (`ops.rows_select`): K7's gather and K7b's
fixed-order transpose, by their plain versions, on the CPU.

  * The gather is exactly table[idx], through the wrapper, the autograd
    Function and `prelude.vec.take_rows`; take_rows calls the wrapper
    directly when no gradient is wanted.
  * The transpose against the JAX package's accelerator route: `jax.vjp` of
    `geometry.hit.select_table(onehot_of(idx, R), a)` (the one-hot select
    that `materials.py:94` and `textures.py:75` take on any backend but the
    CPU), called directly, and `jax.vjp` of a[idx]. Tolerance: per row,
    4 float32 epsilons of the sum of |g| over the row's rays (two orders of
    the same sum; measured at most 1.2 of them at R = 1,024). A row no ray
    selects is 0 on both sides.
  * The order: `rows_select_bwd_plain` bit for bit against the module
    docstring's order written out densely (the sequential sums of
    where(idx == r, g, 0), level by level), and against a model of K7b's
    blocks (the staging's ranks, the walk of a segment a thread, the run
    and chunk folds, the last block's or the second launch's sum, the row
    tiles of `csrc/rows_select.cu`'s shared-memory budget), whose constants
    are read from the kernel's source, on frame-ordered, shuffled and
    many-row segments.
  * A NaN cotangent lands in its own row only; `gradcheck` in float64; R =
    1, 481 (book 1), 1,024 and 4,096, N ragged against the chunk, N = 0,
    every index on row 0 or on row R - 1.
  * An index outside [0, R) raises, as does each other check of the
    wrappers (the card's checks on CPU tensors held to the CPU's device
    index); an output that gets no gradient reaches the backward as None,
    and a broadcast cotangent reads its one value.
  * The callers: `materials.gather` and `gather_absorb` and the texture
    colors give the values of the indexing they replaced, and their
    gradients reach the leaves.
On a CUDA tensor the wrappers launch the kernels (tests/test_torch_cuda.py,
on the card); a tensor on another device raises.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.geometry import hit as jhit
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.ops import rows_select as rs
from raysnail_tpu_torch.prelude.vec import Vec3, take_rows

ULPS = 4
EPS32 = float(np.finfo(np.float32).eps)
SRC = os.path.join(os.path.dirname(rs.__file__), os.pardir, "csrc", "rows_select.cu")


def case(seed, n, rows, k, where=None):
    """Numpy table (rows, k), indices (n,) and cotangents (n, k), float32;
    where="first"/"last" puts every index on row 0 / rows - 1."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((rows, k)).astype(np.float32)
    idx = rng.integers(0, rows, n)
    if where == "first":
        idx[:] = 0
    elif where == "last":
        idx[:] = rows - 1
    g = rng.standard_normal((n, k)).astype(np.float32)
    return table, idx, g


def exact_and_scale(g, idx, rows):
    """The float64 row sums of g and of |g|."""
    exact = np.zeros((rows, g.shape[1]))
    scale = np.zeros_like(exact)
    np.add.at(exact, idx, g.astype(np.float64))
    np.add.at(scale, idx, np.abs(g.astype(np.float64)))
    return exact, scale


def bwd(g, idx, rows):
    return rs.rows_select_bwd_plain(torch.from_numpy(g), torch.from_numpy(idx), rows).numpy()


# -- the gather ------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(1, 100), (7, 5001), (481, 2049), (1024, 4099),
                                    (4096, 3000), (5, 0)])
@pytest.mark.parametrize("k", [1, 4, 6])
def test_gather_is_indexing(rows, n, k):
    table, idx, _ = case(1, n, rows, k)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    want = table[idx]
    cols = tuple(t.unbind(1))  # strided columns, as the kernels take them
    for got in (rs.rows_select_plain(t, i), rs.rows_select(cols, i).t(),
                torch.stack(rs.RowsSelect.apply(i, *cols), 1)):
        assert got.shape == (n, k) and np.array_equal(got.numpy(), want)
    cols = take_rows(tuple(t.unbind(1)), i)
    assert all(np.array_equal(c.numpy(), want[:, j]) for j, c in enumerate(cols))
    (col,) = take_rows((t[:, 0].contiguous(),), i.view(-1, 1))  # idx's shape kept
    assert np.array_equal(col.numpy(), want[:, :1])


def test_the_cpu_route_launches_nothing_and_other_devices_raise():
    table, idx, g = case(2, 300, 7, 4)
    t, i, gg = (torch.from_numpy(a) for a in (table, idx, g))
    before = (rs.rows_select.launches, rs.rows_select_bwd.launches)
    cols, gs = t.unbind(1), gg.unbind(1)
    rs.rows_select(cols, i)
    rs.rows_select_bwd(gs, i, 7)
    assert (rs.rows_select.launches, rs.rows_select_bwd.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        rs.rows_select([c.to("meta") for c in cols], i.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rs.rows_select_bwd([x.to("meta") for x in gs], i.to("meta"), 7)
    with pytest.raises(ValueError, match="columns"):
        rs.rows_select(torch.zeros(7, 9).unbind(1), i)
    with pytest.raises(ValueError, match="int64"):
        rs.rows_select(cols, i.int())
    with pytest.raises(ValueError, match="empty table"):
        rs.rows_select(torch.zeros(0, 4).unbind(1), i)
    with pytest.raises(ValueError, match="column"):
        rs.rows_select((cols[0], torch.zeros(8)), i)
    with pytest.raises(ValueError, match="None"):
        rs.rows_select_bwd((None, None), i, 7)


@pytest.mark.parametrize("bad", [-1, 7, 1000])
def test_an_index_outside_the_table_raises(bad):
    """Where table[idx] would wrap -1 to the last row and the plain backward
    would shift a large index into another segment's row, the wrappers
    raise (on the card the kernels assert)."""
    table, idx, g = case(11, 300, 7, 3)
    idx[123] = bad
    t, i, gg = (torch.from_numpy(a) for a in (table, idx, g))
    with pytest.raises(IndexError, match="outside"):
        rs.rows_select(t.unbind(1), i)
    with pytest.raises(IndexError, match="outside"):
        rs.rows_select_bwd(gg.unbind(1), i, 7)
    with pytest.raises(IndexError, match="outside"):
        take_rows(t.unbind(1), i)


def test_a_missing_or_broadcast_cotangent_reads_as_its_values():
    """An output that gets no gradient reaches the backward as None (zeros,
    not materialised); a broadcast cotangent (stride 0) reads its one value."""
    table, idx, _ = case(12, 5000, 9, 3)
    cols = [torch.from_numpy(table[:, j].copy()).requires_grad_(True) for j in range(3)]
    out = take_rows(cols, torch.from_numpy(idx))
    out[1].sum().backward()  # out[0] and out[2] get no gradient
    want = np.bincount(idx, minlength=9).astype(np.float32)
    assert np.array_equal(cols[1].grad.numpy(), want)
    assert not cols[0].grad.any() and not cols[2].grad.any()
    g1 = torch.ones(1).expand(5000)
    got = rs.rows_select_bwd((None, g1, None), torch.from_numpy(idx), 9)
    assert got[1].tolist() == want.tolist() and not got[0].any() and not got[2].any()


def test_take_rows_without_a_gradient_calls_the_gather_directly(monkeypatch):
    """Under no_grad, or with no column that requires grad, take_rows calls
    K7's wrapper and not the autograd Function: its outputs have no
    grad_fn, keep idx's shape and are the plain gather's on the CPU. With a
    gradient wanted it goes through RowsSelect."""
    table, idx, _ = case(13, 3000, 9, 4)
    i = torch.from_numpy(idx).view(50, 60)
    want = [table[idx, j].reshape(50, 60) for j in range(4)]
    leaves = [torch.from_numpy(table[:, j].copy()).requires_grad_(True) for j in range(4)]
    plain, calls = rs.rows_select_plain, []
    monkeypatch.setattr(rs, "rows_select_plain", lambda t, j: calls.append(1) or plain(t, j))

    def no_function(*args):
        raise AssertionError("take_rows went through RowsSelect")
    monkeypatch.setattr(rs.RowsSelect, "apply", no_function)
    for cols, grad in ((leaves, False), ([c.detach() for c in leaves], True)):
        with torch.set_grad_enabled(grad):
            out = take_rows(cols, i)
        assert all(o.grad_fn is None and not o.requires_grad for o in out)
        assert all(np.array_equal(o.numpy(), w) for o, w in zip(out, want))
    assert len(calls) == 2
    monkeypatch.undo()
    out = take_rows(leaves, i)
    assert all(o.grad_fn is not None and o.shape == (50, 60) for o in out)


def _raises(fn, exc, match):
    with pytest.raises(exc, match=match):
        fn()


_T7, _I300 = torch.zeros(7, 4), torch.zeros(300, dtype=torch.int64)
WRAPPER_CHECKS = {
    # the wrappers on the CPU
    "no column": (lambda: rs.rows_select((), _I300), ValueError, "1 to 8 columns"),
    "9 columns": (lambda: rs.rows_select(torch.zeros(7, 9).unbind(1), _I300), ValueError,
                  "1 to 8 columns"),
    "empty table": (lambda: rs.rows_select(torch.zeros(0, 4).unbind(1), _I300), ValueError,
                    "empty table"),
    "idx int32": (lambda: rs.rows_select(_T7.unbind(1), _I300.int()), ValueError, "int64"),
    "idx 2-D": (lambda: rs.rows_select(_T7.unbind(1), _I300.view(30, 10)), ValueError, "idx"),
    "column shape": (lambda: rs.rows_select((_T7[:, 0], torch.zeros(8)), _I300), ValueError,
                     "a column"),
    "column device": (lambda: rs.rows_select((_T7[:, 0], torch.zeros(7, device="meta")),
                                             _I300), ValueError, "a column"),
    "N >= 2^31": (lambda: rs.rows_select(_T7.unbind(1), _I300[:1].expand(2 ** 31)),
                  ValueError, "too large"),
    "R x K >= 2^31": (lambda: rs.rows_select((torch.zeros(1).expand(2 ** 31),), _I300),
                      ValueError, "too large"),
    "index outside": (lambda: rs.rows_select(_T7.unbind(1), _I300 + 7), IndexError, "outside"),
    "bwd index outside": (lambda: rs.rows_select_bwd((torch.zeros(300),), _I300 - 1, 7),
                          IndexError, "outside"),
    "bwd cotangent shape": (lambda: rs.rows_select_bwd((torch.zeros(299),), _I300, 7),
                            ValueError, "a cotangent"),
    "bwd every None": (lambda: rs.rows_select_bwd((None, None), _I300, 7), ValueError, "None"),
    "other device": (lambda: rs.rows_select(_T7.to("meta").unbind(1), _I300.to("meta")),
                     ValueError, "unsupported device"),
    # the card's checks, on CPU tensors held to device index -1 (the CPU's)
    "card dtype": (lambda: rs._columns("a column", (torch.zeros(7, dtype=torch.float64),), 7,
                                       -1), ValueError, "float32"),
    "card shape": (lambda: rs._columns("a column", (torch.zeros(8),), 7, -1), ValueError,
                   "a column"),
    "card device": (lambda: rs._columns("a column", (torch.zeros(7),), 7, 0), ValueError,
                    "cuda:0"),
    "card idx int32": (lambda: rs._cuda_index(_I300.int(), 7, 4), ValueError, "int64"),
    "card idx 2-D": (lambda: rs._cuda_index(_I300.view(30, 10), 7, 4), ValueError, "idx"),
    "card 9 columns": (lambda: rs._cuda_index(_I300, 7, 9), ValueError, "1 to 8 columns"),
}


@pytest.mark.parametrize("check", list(WRAPPER_CHECKS))
def test_each_wrapper_check_raises_its_error(check):
    _raises(*WRAPPER_CHECKS[check])


def test_the_card_route_reads_pointers_then_strides():
    """The kernels' columns: K pointers, then K element strides (0 and 0
    for a None cotangent), from one pass over the columns."""
    t = torch.zeros(7, 3)
    cols = (*t.unbind(1), None, torch.zeros(7))
    got = rs._columns("a cotangent", cols, 7, -1)
    assert got == [c.data_ptr() for c in cols[:3]] + [0, cols[4].data_ptr()] + [3, 3, 3, 0, 1]
    assert rs._cuda_index(_I300, 7, 4) == (300, -1)
    packed = rs._K7B_ARGS[5].pack(300, 7, 5, 11, 12, 13, 14, *got)
    assert np.frombuffer(packed, np.int64).tolist() == [300, 7, 5, 11, 12, 13, 14, *got]


# -- the transpose against the JAX package ---------------------------------

@pytest.mark.parametrize("rows,n", [(1, 3000), (7, 5001), (481, 6000), (1024, 4099)])
def test_bwd_matches_jax_onehot_select(rows, n):
    """jax.vjp of the accelerator route's select_table, a column at a time."""
    table, idx, g = case(3, n, rows, 3)
    got = bwd(g, idx, rows)
    onehot = jhit.onehot_of(jnp.asarray(idx), rows)
    exact, scale = exact_and_scale(g, idx, rows)
    for j in range(3):
        _, vjp = jax.vjp(lambda a: jhit.select_table(onehot, a), jnp.asarray(table[:, j]))
        want = np.asarray(vjp(jnp.asarray(g[:, j]))[0])
        assert np.all(np.abs(got[:, j] - want) <= ULPS * EPS32 * scale[:, j])
        assert np.all(np.abs(got[:, j] - exact[:, j]) <= ULPS * EPS32 * scale[:, j])


@pytest.mark.parametrize("rows,n", [(7, 5001), (4096, 9000)])
def test_bwd_matches_jax_gather_vjp(rows, n):
    """jax.vjp of a[idx] (the JAX package's CPU route), a column at a time."""
    table, idx, g = case(4, n, rows, 2)
    got = bwd(g, idx, rows)
    _, scale = exact_and_scale(g, idx, rows)
    for j in range(2):
        _, vjp = jax.vjp(lambda a: a[jnp.asarray(idx)], jnp.asarray(table[:, j]))
        want = np.asarray(vjp(jnp.asarray(g[:, j]))[0])
        assert np.all(np.abs(got[:, j] - want) <= ULPS * EPS32 * scale[:, j])


# -- the order -------------------------------------------------------------

def dense_levels(g, idx, rows):
    """The module docstring's order, written out densely: per row the
    masked cotangents where(idx == r, g, 0), padded to whole chunks with
    zeros, each level a sequential float32 sum from +0.0 -> (rows, k)."""
    n, k = g.shape
    total = -(-n // rs.CHUNK) * rs.CHUNK

    def fold(x):  # (parts, j, k) -> (parts, k), sequential from +0.0 over j
        acc = np.zeros((x.shape[0], k), np.float32)
        for j in range(x.shape[1]):
            acc = acc + x[:, j]
        return acc

    out = np.zeros((rows, k), np.float32)
    for r in range(rows):
        m = np.zeros((total, k), np.float32)
        m[:n] = np.where((idx == r)[:, None], g, np.float32(0.0))
        seg = fold(m.reshape(-1, rs.SEGMENT, k))
        run = fold(seg.reshape(-1, rs.RUN_SEGMENTS, k))
        chunk = fold(run.reshape(-1, rs.CHUNK_RUNS, k))
        out[r] = fold(chunk[None])[0]
    return out


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 31), (7, 2049), (7, 5000), (33, 4097),
                                    (5, 2048)])
def test_bwd_plain_is_the_dense_order_bit_for_bit(rows, n):
    _, idx, g = case(5, n, rows, 3)
    g[::7] *= np.float32(1e6)   # sums whose order shows in their bits
    g[3::11] = np.float32(-0.0)
    assert np.array_equal(bwd(g, idx, rows).view(np.int32),
                          dense_levels(g, idx, rows).view(np.int32))


def kernel_constants():
    src = open(SRC).read()
    get = lambda name: int(re.search(rf"constexpr int {name} = ([0-9 *]+);", src)[1]
                           .replace(" ", "").split("*")[0]) * (
        1024 if name == "kSmemBudget" else 1)
    return {n: get(n) for n in ("kSegment", "kRunSegments", "kChunkRuns", "kSmemBudget",
                                "kOneLaunchEntries", "kFoldEntries", "kFoldTile")}


def low_bits(mask):
    """The set bits of a 32-bit mask, lowest first."""
    return [b for b in range(32) if mask >> b & 1]


def k7b_model(g, idx, rows):
    """K7b as csrc/rows_select.cu computes it, in float32 numpy -> (the
    (rows, k) gradient, what it did). A block a chunk:
      (A) staging: each segment's lanes grouped by row (__match_any_sync);
          each ray ranked in the walk's order, the groups by their first
          lane (head), each group's rays by lane: the rays whose head is
          lower, then its group's rays below it;
      (B) the walk: the segment's cotangents in that order, added from
          +0.0, each step's running sum stored to its group's head slot
          (so the group's last step leaves its sum there), a step past the
          segment's rays to the pad word;
      (C) each run's row sums: its segments' heads in segment order, added
          into rows zeroed at the start;
      (D) the chunk's partials: its runs' sums from +0.0 in order;
    then the chunks' partials from +0.0 in ascending order, a piece of
    chunks at a time, by the block that took the last ticket (R x K <=
    kOneLaunchEntries) or by a second launch of kFoldEntries entries a
    block. Above kSmemBudget / (kChunkRuns * 4) entries the row tiles'
    kernel (PR 12's) sums a tile's rows per block: each segment's groups
    by their leaders in lane order, then (C) and (D) as here."""
    c = kernel_constants()
    seg_n, run_n, runs = c["kSegment"], c["kRunSegments"], c["kChunkRuns"]
    n, k = g.shape
    rt_max = min(rows, c["kSmemBudget"] // (runs * k * 4))
    tiles = -(-rows // rt_max)
    segs = runs * run_n
    chunks = -(-n // (segs * seg_n))
    part = np.zeros((chunks, rows, k), np.float32)
    seg_rows = []  # the rows of each segment of the first tile
    for b in range(chunks):
        for t in range(tiles):
            r0 = t * rt_max
            rt = min(rt_max, rows - r0)
            # (A)
            row_s = np.full((segs, seg_n), -1)
            g_s = np.zeros((segs, seg_n, k), np.float32)
            walks, heads = [], [0] * segs
            for s in range(segs):
                for lane in range(seg_n):
                    i = (b * segs + s) * seg_n + lane
                    if i < n and r0 <= idx[i] < r0 + rt:
                        row_s[s, lane] = idx[i] - r0
                        g_s[s, lane] = g[i]
                same = [sum(1 << j for j in range(seg_n) if row_s[s, j] == row_s[s, lane])
                        for lane in range(seg_n)]
                head = [low_bits(m)[0] for m in same]
                rays = [lane for lane in range(seg_n) if row_s[s, lane] >= 0]
                walk = [None] * seg_n
                for lane in rays:
                    # the rays whose head is below this one's, then this
                    # group's rays below this lane
                    rank = sum(head[j] < head[lane] for j in rays) + bin(
                        same[lane] & ((1 << lane) - 1)).count("1")
                    walk[rank] = (lane, same[lane] >> lane == 1, head[lane])
                    heads[s] |= (head[lane] == lane) << lane
                walks.append(walk[:len(rays)] + [(0, True, seg_n)] * (seg_n - len(rays)))
                if t == 0 and walks[-1]:
                    seg_rows.append(bin(heads[s]).count("1"))
            # (B) a step past the segment's rays writes the pad word (slot 32)
            g_pad = np.concatenate([g_s, np.zeros((segs, 1, k), np.float32)], axis=1)
            for s in range(segs):
                x = [g_pad[s, lane].copy() for lane, _, _ in walks[s]]  # every load first
                acc = np.zeros(k, np.float32)
                for (lane, end, head), v in zip(walks[s], x):
                    acc = acc + v
                    g_pad[s, head] = acc
                    if end:
                        acc = np.zeros(k, np.float32)
            g_s = g_pad[:, :seg_n]
            # (C)
            run_s = np.zeros((runs, rt, k), np.float32)
            for w in range(runs):
                for j in range(run_n):
                    s = w * run_n + j
                    for lane in low_bits(heads[s]):
                        r = row_s[s, lane]
                        run_s[w, r] = run_s[w, r] + g_s[s, lane]
            # (D)
            acc = np.zeros((rt, k), np.float32)
            for w in range(runs):
                acc = acc + run_s[w]
            part[b, r0:r0 + rt] = acc
    one = rows * k <= c["kOneLaunchEntries"]
    width = rows * k if one else c["kFoldEntries"]
    # the floats staged a piece: the last block's whole shared memory, or
    # the second launch's tile (the pieces keep the order)
    smem = (2 + k) * segs * (seg_n + 1) + 2 * segs + runs * rows * k
    piece = max(1, (smem if one else c["kFoldTile"]) // (-(-width // 4) * 4))
    out = np.zeros((rows, k), np.float32)
    for c0 in range(0, chunks, piece):
        for b in range(c0, min(chunks, c0 + piece)):
            out = out + part[b]
    return out, {"rt": rt_max, "tiles": tiles, "one_launch": one, "segment_rows": seg_rows}


def test_kernel_constants_are_the_plain_versions():
    c = kernel_constants()
    assert (c["kSegment"], c["kRunSegments"], c["kChunkRuns"]) == (
        rs.SEGMENT, rs.RUN_SEGMENTS, rs.CHUNK_RUNS)


def frame_order(rng, rows, n):
    """Runs of a row inside a segment, as a frame's hits come."""
    idx = np.sort(rng.integers(0, rows, n))
    idx[::3] = rng.integers(0, rows, len(idx[::3]))
    return idx


@pytest.mark.parametrize("rows,n,k", [(7, 4100, 4), (481, 2500, 4), (4096, 2100, 6),
                                      (3, 700, 8)])
def test_k7b_model_is_the_plain_version_bit_for_bit(rows, n, k):
    """The kernel's staging, walk, folds and row tiles give the plain
    version's bits (R = 4,096 at K = 6 takes 8 row tiles of 512 and the
    second launch; R = 481 one tile and the second launch; the others one
    launch)."""
    rng = np.random.default_rng(6)
    idx = frame_order(rng, rows, n)
    g = rng.standard_normal((n, k)).astype(np.float32) * np.float32(1e3)
    got, how = k7b_model(g, idx, rows)
    assert (how["tiles"], how["one_launch"]) == {7: (1, True), 481: (1, False),
                                                 4096: (8, False), 3: (1, True)}[rows]
    assert np.array_equal(got.view(np.int32), bwd(g, idx, rows).view(np.int32))


def shuffled_runs(rng, rows, n):
    """A random permutation of sorted runs: the regen-shuffle integrator's
    bounce rays, whose rows come in no order."""
    return rng.permutation(np.sort(rng.integers(0, rows, n)))


def many_rows(rng, rows, n):
    """Each segment holds at least 8 rows: 8 runs of 4 a segment, then
    random."""
    idx = rng.integers(0, rows, n)
    seg = idx[: n - n % 32].reshape(-1, 32)
    seg[:] = np.repeat(rng.permuted(np.tile(np.arange(rows), (len(seg), 1)), axis=1)[:, :8],
                       4, axis=1)
    return idx


@pytest.mark.parametrize("order", ["shuffled", "many"])
@pytest.mark.parametrize("rows,n,k", [(8, 4500, 4), (10, 2200, 6), (455, 2100, 3)])
def test_k7b_model_on_shuffled_and_many_row_segments(order, rows, n, k):
    """The same on the orders a frame's segments do not take: shuffled rows
    (up to 32 groups a segment) and segments of 8 or more rows each."""
    rng = np.random.default_rng(rows + n)
    idx = (shuffled_runs if order == "shuffled" else many_rows)(rng, rows, n)
    g = rng.standard_normal((n, k)).astype(np.float32) * np.float32(1e3)
    g[::5] = np.float32(-0.0)
    got, how = k7b_model(g, idx, rows)
    full = how["segment_rows"][: n // 32]  # the rows of each whole segment
    assert min(full) >= 8 if order == "many" else np.mean(full) > 5
    assert np.array_equal(got.view(np.int32), bwd(g, idx, rows).view(np.int32))


# -- NaN, gradcheck, edges -------------------------------------------------

def test_nan_cotangent_stays_in_its_row():
    _, idx, g = case(7, 3000, 9, 4)
    idx[100] = 2
    g[100, 1] = np.nan
    g[2500, 3] = np.inf
    got = bwd(g, idx, 9)
    assert np.isnan(got[2, 1]) and np.isnan(got).sum() == 1
    assert np.isinf(got[idx[2500], 3]) and np.isinf(got).sum() == 1
    exact, scale = exact_and_scale(np.nan_to_num(g, nan=0, posinf=0), idx, 9)
    ok = np.isfinite(got)
    assert np.all(np.abs(got - exact)[ok] <= ULPS * EPS32 * scale[ok])


def test_gradcheck_float64():
    rng = np.random.default_rng(8)
    cols = tuple(torch.from_numpy(rng.standard_normal(6)).requires_grad_(True)
                 for _ in range(3))
    idx = torch.from_numpy(rng.integers(0, 6, 50))
    assert torch.autograd.gradcheck(lambda *c: rs.RowsSelect.apply(idx, *c), cols)


@pytest.mark.parametrize("rows", [1, 481, 1024, 4096])
@pytest.mark.parametrize("n,where", [(2049 * 3 + 5, None), (0, None), (3001, "first"),
                                     (3001, "last")])
def test_rows_and_edges(rows, n, where):
    table, idx, g = case(9, n, rows, 3, where)
    cols = [torch.from_numpy(table[:, j].copy()).requires_grad_(True) for j in range(3)]
    out = rs.RowsSelect.apply(torch.from_numpy(idx), *cols)
    assert np.array_equal(torch.stack(out, 1).detach().numpy(), table[idx])
    torch.autograd.backward(out, torch.from_numpy(g).unbind(1))
    got = torch.stack([c.grad for c in cols], 1).numpy()
    exact, scale = exact_and_scale(g, idx, rows)
    assert got.shape == (rows, 3)
    assert np.all(np.abs(got - exact) <= ULPS * EPS32 * scale)
    untouched = np.setdiff1d(np.arange(rows), idx)
    assert not got[untouched].any()  # rows no ray selects get exactly 0


# -- the callers -----------------------------------------------------------

def test_material_and_texture_fetches_keep_their_values_and_reach_the_leaves():
    rng = np.random.default_rng(10)
    m, tex, n = 5, 4, 1000
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    i32 = lambda hi, *s: torch.from_numpy(rng.integers(0, hi, s).astype(np.int32))  # noqa: E731
    leaves = [f(m).requires_grad_(True) for _ in range(4)]
    table = matlib.MaterialTable(
        mtype=i32(8, m), tex_id=i32(tex, m), param0=leaves[0], param1=leaves[1],
        emit_mult=leaves[2], phong_factor=leaves[3], phong_exponent=f(m),
        mix_prob=f(m), mix_a=i32(m, m), mix_b=i32(m, m), absorb=Vec3(f(m), f(m), f(m)))
    mat_id = i32(m, n)
    rows = matlib.gather(table, mat_id)
    k = mat_id.long()
    for name in ("mtype", "tex_id", "param0", "param1", "emit_mult", "phong_factor",
                 "phong_exponent"):
        assert torch.equal(getattr(rows, name), getattr(table, name)[k]), name
    ab = matlib.gather_absorb(table, mat_id)
    assert all(torch.equal(a, b[k]) for a, b in zip(ab, table.absorb))
    w = f(n)
    sum(((c + 1) * w * getattr(rows, name)).sum() for c, name in enumerate(
        ("param0", "param1", "emit_mult", "phong_factor"))).backward()
    for c, leaf in enumerate(leaves):
        want = np.zeros(m, np.float64)
        np.add.at(want, k.numpy(), ((c + 1) * w).double().numpy())
        assert np.allclose(leaf.grad.numpy(), want, rtol=0, atol=ULPS * EPS32 * n * 10)

    # the texture colors: constant rows and one checker row
    c1 = Vec3(*(f(tex).requires_grad_(True) for _ in range(3)))
    c2 = Vec3(*(f(tex).requires_grad_(True) for _ in range(3)))
    ttab = texlib.TextureTable(
        ttype=torch.tensor([texlib.CONSTANT, texlib.CHECKER, texlib.CONSTANT,
                            texlib.CONSTANT], dtype=torch.int32),
        color1=c1, color2=c2, scale=torch.full((tex,), 3.0),
        child1=torch.full((tex,), -1, dtype=torch.int32),
        child2=torch.full((tex,), -1, dtype=torch.int32))
    tid = i32(tex, n)
    p = Vec3(f(n), f(n), f(n))
    col = texlib.evaluate(ttab, tid, f(n), f(n), p, frozenset({texlib.CONSTANT,
                                                               texlib.CHECKER}))
    tl = tid.long()
    odd = (torch.sin(3.0 * p.x) * torch.sin(3.0 * p.y) * torch.sin(3.0 * p.z)) < 0.0
    ck = ttab.ttype[tl] == texlib.CHECKER
    for a, b1, b2 in zip(col, c1, c2):
        want = torch.where(ck, torch.where(odd, b1[tl], b2[tl]), b1[tl])
        assert torch.equal(a, want.detach())
    (col.x + 2 * col.y + 3 * col.z).sum().backward()
    assert all(x.grad is not None for x in (*c1, *c2))
    assert float(c2.x.grad[1].abs()) > 0 and not c2.x.grad[[0, 2, 3]].any()

