"""The port's per-ray row selects (`ops.rows_select`): K7's gather and K7b's
fixed-order transpose, by their plain versions, on the CPU.

  * The gather is exactly table[idx], through the wrapper, the autograd
    Function and `prelude.vec.take_rows`.
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
    warps (lanes grouped by row, each group's leader summing its members in
    lane order, segments into the warp's row sums, the row tiles of
    `csrc/rows_select.cu`'s shared-memory budget), whose constants are read
    from the kernel's source.
  * A NaN cotangent lands in its own row only; `gradcheck` in float64; R =
    1, 481 (book 1), 1,024 and 4,096, N ragged against the chunk, N = 0,
    every index on row 0 or on row R - 1.
  * An index outside [0, R) raises; an output that gets no gradient reaches
    the backward as None, and a broadcast cotangent reads its one value.
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
    for got in (rs.rows_select_plain(t, i), torch.stack(rs.rows_select(cols, i), 1),
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
    return {n: get(n) for n in ("kSegment", "kRunSegments", "kWarps", "kSmemBudget")}


def k7b_model(g, idx, rows):
    """K7b as csrc/rows_select.cu computes it, in float32 numpy: blocks of
    kWarps runs by row tiles of kSmemBudget / (kWarps * K * 4) rows; a warp's
    segment grouped by row, each group's sum from +0.0 in lane order added
    to the warp's row sum; the block's warps' sums in order; the chunks'
    sums in order."""
    c = kernel_constants()
    seg_n, run_n, warps = c["kSegment"], c["kRunSegments"], c["kWarps"]
    n, k = g.shape
    rt_max = min(rows, c["kSmemBudget"] // (warps * k * 4))
    chunk_rays = seg_n * run_n * warps
    chunks = -(-n // chunk_rays)
    part = np.zeros((chunks, rows, k), np.float32)
    for b in range(chunks):
        for r0 in range(0, rows, rt_max):
            rt = min(rt_max, rows - r0)
            sums = np.zeros((warps, rt, k), np.float32)
            for w in range(warps):
                for s in range(run_n):
                    first = ((b * warps + w) * run_n + s) * seg_n
                    lanes = [(i, int(idx[i]) - r0) for i in range(first, min(first + seg_n, n))
                             if r0 <= idx[i] < r0 + rt]
                    for row in sorted({row for _, row in lanes}):
                        acc = np.zeros(k, np.float32)
                        for i, rr in lanes:  # the members in lane order
                            if rr == row:
                                acc = acc + g[i]
                        sums[w, row] = sums[w, row] + acc
            acc = np.zeros((rt, k), np.float32)
            for w in range(warps):
                acc = acc + sums[w]
            part[b, r0:r0 + rt] = acc
    out = np.zeros((rows, k), np.float32)
    for b in range(chunks):
        out = out + part[b]
    return out, rt_max


def test_kernel_constants_are_the_plain_versions():
    c = kernel_constants()
    assert (c["kSegment"], c["kRunSegments"], c["kWarps"]) == (
        rs.SEGMENT, rs.RUN_SEGMENTS, rs.CHUNK_RUNS)


@pytest.mark.parametrize("rows,n,k", [(7, 4100, 4), (481, 2500, 4), (4096, 2100, 6),
                                      (3, 700, 8)])
def test_k7b_model_is_the_plain_version_bit_for_bit(rows, n, k):
    """The kernel's grouping and row tiles give the plain version's bits
    (R = 4,096 at K = 6 takes 8 row tiles of 512)."""
    rng = np.random.default_rng(6)
    idx = np.sort(rng.integers(0, rows, n))  # runs of a row inside a warp, as in a frame
    idx[::3] = rng.integers(0, rows, len(idx[::3]))
    g = rng.standard_normal((n, k)).astype(np.float32) * np.float32(1e3)
    got, rt = k7b_model(g, idx, rows)
    assert rows <= rt or rows == 4096
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

