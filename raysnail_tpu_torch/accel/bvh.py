"""Bounding-volume hierarchy: host-side build, linearized skip-link layout.

The reference builds a BVH of trait objects with a random-axis median split
and recursive traversal (src/hittable/collection/bvh.rs:47-192). TPU-first,
the BVH is built ONCE on the host (binned SAH — higher quality than the
reference's median split, whose axis choice bug only ever picks x/y,
bvh.rs:91) and linearized into flat arrays with skip links ("threaded" BVH):

  * nodes in DFS pre-order; an interior node's left child is node+1;
  * `miss[node]` jumps over the subtree — where traversal goes when the
    node's bbox is missed, and after a leaf is processed;
  * leaves reference LEAF_SIZE-aligned runs of reordered primitives, padded
    with degenerate entries, so the device-side traversal tests a fixed-width
    block of primitives with no data-dependent shapes.

Device traversal (geometry/triangles.py) walks all rays in lockstep with
per-ray node pointers in a lax.while_loop — stackless, static shapes.

A native C++ builder (accel/native) produces the same arrays faster for large
meshes; this numpy implementation is the reference/fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

LEAF_SIZE = 4
N_BINS = 16


class BvhArrays(NamedTuple):
    """Flat BVH (numpy, host). END sentinel = len(nodes)."""
    bb_min: np.ndarray    # (M, 3) float32
    bb_max: np.ndarray    # (M, 3) float32
    first: np.ndarray     # (M,) int32: leaf -> index into padded prim order
    count: np.ndarray     # (M,) int32: 0 for interior, LEAF_SIZE run for leaf
    miss: np.ndarray      # (M,) int32: skip link
    prim_order: np.ndarray  # (P_padded,) int32 into the original prims; -1 pad


class _Node:
    __slots__ = ("bb_min", "bb_max", "left", "right", "prims")

    def __init__(self, bb_min, bb_max, left=None, right=None, prims=None):
        self.bb_min, self.bb_max = bb_min, bb_max
        self.left, self.right, self.prims = left, right, prims


def relinearize_octants(arr: BvhArrays) -> tuple[np.ndarray, np.ndarray]:
    """8 direction-octant linearizations of a skip-link BVH for front-to-back
    traversal: for each ray-direction octant, children are visited
    nearer-first along the split axis, so the packet's best_t tightens early
    and far subtrees prune (the reference's recursive traversal gets this for
    free by shrinking t_max into the second child, bvh.rs:180-188).

    The binary tree is recovered from the pre-order skip links (interior i:
    left = i+1, right = miss[i+1]); the split axis is re-derived as the
    dominant component of the child-center difference.

    -> (bb8 (8, M, 8) f32, links8 (8, M, 4) i32) where links columns are
    [leaf_first, count, miss, pad] in each octant's node order. Leaf `first`
    values are preserved (primitive storage is shared by all orders).
    """
    m = arr.count.shape[0]
    count, miss, first = arr.count, arr.miss, arr.first
    centers = 0.5 * (arr.bb_min + arr.bb_max)

    # subtree sizes in pre-order: size[i] = miss-skip distance
    size = np.empty(m, np.int64)
    for i in range(m - 1, -1, -1):
        size[i] = 1 if count[i] > 0 else 1 + size[i + 1] + size[miss[i + 1]]

    bb8 = np.zeros((8, m, 8), np.float32)
    links8 = np.zeros((8, m, 4), np.int32)
    for octant in range(8):
        neg = ((octant >> 2) & 1, (octant >> 1) & 1, octant & 1)  # x, y, z
        order = np.empty(m, np.int64)
        new_miss = np.empty(m, np.int64)
        pos = 0
        stack = [(0, m)]  # (old node, miss link in NEW numbering)
        while stack:
            i, miss_link = stack.pop()
            ni = pos
            order[ni] = i
            new_miss[ni] = miss_link
            pos += 1
            if count[i] == 0:
                left, right = i + 1, int(miss[i + 1])
                dc = centers[right] - centers[left]
                axis = int(np.argmax(np.abs(dc)))
                lo_first = dc[axis] >= 0.0  # left child is the nearer one
                near, far = (left, right) if lo_first == (not neg[axis]) \
                    else (right, left)
                # near visited first: push far (with parent's miss), then
                # near (missing into far's new position = ni+1+size[near])
                stack.append((far, miss_link))
                stack.append((near, ni + 1 + size[near]))
        bb8[octant, :, 0:3] = arr.bb_min[order]
        bb8[octant, :, 3:6] = arr.bb_max[order]
        links8[octant, :, 0] = first[order]
        links8[octant, :, 1] = count[order]
        links8[octant, :, 2] = new_miss
    return bb8, links8


def build_bvh(prim_bb_min: np.ndarray, prim_bb_max: np.ndarray,
              leaf_size: int = LEAF_SIZE, use_native: bool = True) -> BvhArrays:
    """Build from per-primitive AABBs -> linearized arrays."""
    if use_native:
        try:
            from raysnail_tpu_torch.accel.native import build as native_build
            out = native_build.build_bvh_native(prim_bb_min, prim_bb_max, leaf_size)
            if out is not None:
                return out
        except Exception:
            pass
    return build_bvh_numpy(prim_bb_min, prim_bb_max, leaf_size)


def coarse_cut(count: np.ndarray, miss: np.ndarray,
               max_entries: int = 64, min_t: int = 8) -> list[tuple[int, int]]:
    """Coarse cut for the TWO-LEVEL traversal walk (ops/bvh_pallas.py): a
    partition of the tree into <= max_entries complete subtrees, each
    spanning the contiguous DFS range [start, end). The kernel vector-tests
    the cut roots' bboxes in 8-wide windows (pure VPU work, one packed-bits
    scalar transfer per window) and only runs the serial link-resolution
    walk INSIDE admitted subtrees — replacing the scalar chase through the
    above-cut levels that every packet paid per outer round.

    Works on any DFS/skip-link linearization (miss[i] = first node after
    subtree(i)), so the per-octant orders of relinearize_octants cut the
    same subtree SIZES at different indices."""
    m = count.shape[0]
    t = min_t
    while True:
        cuts: list[tuple[int, int]] = []
        stack = [0]
        while stack:
            i = stack.pop()
            end = int(miss[i]) if int(miss[i]) > i else m
            if count[i] > 0 or end - i <= t:
                cuts.append((i, end))
            else:
                left = i + 1
                stack.append(int(miss[left]))  # right sibling (popped second)
                stack.append(left)
        if len(cuts) <= max_entries:
            return cuts
        t *= 2


def build_bvh_numpy(prim_bb_min, prim_bb_max, leaf_size: int = LEAF_SIZE) -> BvhArrays:
    prim_bb_min = np.asarray(prim_bb_min, np.float64)
    prim_bb_max = np.asarray(prim_bb_max, np.float64)
    n = prim_bb_min.shape[0]
    centroids = 0.5 * (prim_bb_min + prim_bb_max)
    indices = np.arange(n)

    def make(ids) -> _Node:
        lo = prim_bb_min[ids].min(0)
        hi = prim_bb_max[ids].max(0)
        if len(ids) <= leaf_size:
            return _Node(lo, hi, prims=ids)
        c = centroids[ids]
        c_lo, c_hi = c.min(0), c.max(0)
        extent = c_hi - c_lo
        axis = int(np.argmax(extent))
        if extent[axis] <= 1e-12:
            half = len(ids) // 2
            return _Node(lo, hi, make(ids[:half]), make(ids[half:]))
        # binned SAH
        rel = (c[:, axis] - c_lo[axis]) / extent[axis]
        bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
        best_cost, best_split = np.inf, None
        counts = np.bincount(bins, minlength=N_BINS)
        # prefix/suffix bbox areas
        b_lo = np.full((N_BINS, 3), np.inf)
        b_hi = np.full((N_BINS, 3), -np.inf)
        for b in range(N_BINS):
            sel = bins == b
            if sel.any():
                b_lo[b] = prim_bb_min[ids][sel].min(0)
                b_hi[b] = prim_bb_max[ids][sel].max(0)
        lo_acc = np.minimum.accumulate(b_lo, 0)
        hi_acc = np.maximum.accumulate(b_hi, 0)
        lo_racc = np.minimum.accumulate(b_lo[::-1], 0)[::-1]
        hi_racc = np.maximum.accumulate(b_hi[::-1], 0)[::-1]
        n_left = np.cumsum(counts)
        for s in range(1, N_BINS):
            nl, nr = n_left[s - 1], len(ids) - n_left[s - 1]
            if nl == 0 or nr == 0:
                continue
            cost = nl * _area(lo_acc[s - 1], hi_acc[s - 1]) + nr * _area(lo_racc[s], hi_racc[s])
            if cost < best_cost:
                best_cost, best_split = cost, s
        if best_split is None:
            half = len(ids) // 2
            order = np.argsort(c[:, axis], kind="stable")
            ids_sorted = ids[order]
            return _Node(lo, hi, make(ids_sorted[:half]), make(ids_sorted[half:]))
        go_left = bins < best_split
        return _Node(lo, hi, make(ids[go_left]), make(ids[~go_left]))

    root = make(indices)
    return _linearize(root, leaf_size)


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])


def _linearize(root: _Node, leaf_size: int) -> BvhArrays:
    nodes: list[_Node] = []

    def number(node):
        nodes.append(node)
        if node.prims is None:
            number(node.left)
            number(node.right)

    number(root)
    m = len(nodes)
    index_of = {id(node): i for i, node in enumerate(nodes)}

    bb_min = np.zeros((m, 3), np.float32)
    bb_max = np.zeros((m, 3), np.float32)
    first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    miss = np.full(m, m, np.int32)
    prim_order: list[int] = []

    def fill(node, miss_link):
        i = index_of[id(node)]
        bb_min[i] = node.bb_min
        bb_max[i] = node.bb_max
        miss[i] = miss_link
        if node.prims is not None:
            start = len(prim_order)
            ids = list(node.prims)
            while len(ids) % leaf_size:
                ids.append(-1)
            prim_order.extend(ids)
            first[i] = start
            count[i] = len(ids)
        else:
            left_i = index_of[id(node.left)]
            right_i = index_of[id(node.right)]
            fill(node.left, right_i)
            fill(node.right, miss_link)

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        fill(root, m)
    finally:
        sys.setrecursionlimit(old)

    return BvhArrays(
        bb_min=bb_min, bb_max=bb_max, first=first, count=count, miss=miss,
        prim_order=np.asarray(prim_order, np.int32),
    )
