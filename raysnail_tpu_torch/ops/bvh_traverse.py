"""Closest hit through the packed fat-leaf BVH: the two CUDA kernels and
their plain PyTorch version.

`bvh_traverse` is the port of the TPU kernel
`raysnail_tpu/ops/bvh_pallas.py:bvh_traverse`, over the same packed arrays
(`scene._pack_leaf_blocks`, `scene._pack_mxu_blocks`) and with the same
outputs, for any ray count (no padding to a tile). On CUDA tensors it
launches one of two kernels (each built at first use with nvcc into
`_build/`, loaded with ctypes) or raises; on CPU tensors it runs
`bvh_traverse_plain`. There is no fallback from a kernel to the plain
version: a build or launch failure raises.

  * the per-ray kernel `csrc/bvh_traverse.cu` (kinds "tri", "box",
    "sphere"): one thread owns one ray and walks the DFS order of the ray's
    own direction octant. It defers the leaves it admits (up to 8) and the
    warp sweeps them together;
  * the packet kernel `csrc/bvh_packet.cu` (kinds "tri", "tri_mxu", "box",
    "sphere", each with `stream` and `two_level` on or off): a thread block
    owns a packet of PACKET consecutive rays and picks ONE node order for
    it, the order of the sign of the packet's summed directions, as the TPU
    kernel does; each of its warps walks that order on its own. `stream`
    stages deferred leaf blocks in a shared-memory ring per warp (filled
    by the bulk copy engine);
    `two_level` walks only inside admitted entries of the coarse cut
    (`accel.bvh.coarse_cut`); "tri_mxu" solves the triangles with the
    feature product of the TPU kernel's matrix-unit kind.

Both kernels sweep a deferred leaf only for the rays that still admit it
with their fresh best t, primitive-parallel (`csrc/bvh_sweep.cuh`): the
warp sweeps for one ray at a time, each lane four primitives. How many
leaves are deferred, and the slots of a `stream` ring, are constants of the
kernels (`kDepth`, `Shape<KIND>::ring`); no result depends on them.

`packet=None` picks the packet kernel when the call needs it (kind
"tri_mxu", `stream` or `two_level`), else the per-ray kernel. `stream=None`
is the TPU wrapper's auto rule (leaf blocks above STREAM_BYTES,
RAYSNAIL_BVH_STREAM_BYTES), `two_level=None` its switch
RAYSNAIL_BVH_TWO_LEVEL=1; both are read at call time.

Every route keeps, per ray, the same rules: the admission cap, the
admission test against the ray's best t so far, the leaf sweep's formulas,
and the first winner of a tie (lowest lane in a leaf, first leaf visited).
`stream` and `two_level` change which nodes a packet touches and where the
leaf data is read from, never a result: a ray sweeps exactly the leaves that
it admits itself, in the walk's order. See the kernel sources for what they
share with the TPU kernel and where they differ. The plain version walks all
rays in lockstep, one node per step, and sweeps the leaves that rays reach
in a step as one batched (rays, 128) test.

`bvh_traverse.launches` counts kernel launches (not plain version calls) per
route: "tri", "box", "sphere" for the per-ray kernel, and
"packet/<kind>[+stream][+two_level]" for the packet kernel, so a run can
show which kernels and modes its traversals went through.

`bvh_traverse_form` reaches the two kernels' probe forms (`Form` in
`csrc/bvh_sweep.cuh`), the counterparts of the TPU kernel's switches
`_NOSWEEP` and `_NOATTR` (bvh_pallas.py:78-79), for the kinds "tri", "box"
and "sphere" with `stream` and `two_level` off. "nosweep" runs the walk,
the cap, the deferral and the drain rounds with their fresh re-test and
sweeps nothing (every ray misses); "noattr" runs all but the epilogue's
attribute reads and blend. They measure where the full kernel's time goes
(`raysnail_tpu_torch.probes`); no render path calls them.
`bvh_traverse_form_plain` is their plain version, and
`bvh_traverse_form.launches` their count, keyed "<form>/<launch key>".
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import torch

from raysnail_tpu_torch.geometry.hit import BIG
from raysnail_tpu_torch.ops import _nvcc

LANES = 128       # primitives per leaf block
PACKET = 128      # rays per packet of the packet kernel (one 16x8 image tile)
COARSE_MAX = 64   # entries of the coarse cut, padding included
MXU_LANES = 640   # lane width of a "tri_mxu" block: 512 solve + 128 attributes
# leaf-block field rows per kind (bvh_pallas.py:54-71):
#   tri:     0-2 p0 | 3-5 p0-p1 | 6-8 p0-p2 | 9 valid | 10-18 n0 n1 n2 | 19 mat
#   box:     0-2 p_min | 3-5 p_max | 6 valid | 7 mat
#   sphere:  0-2 center | 3 r^2 | 4 valid | 5 mat | 6 r
#   tri_mxu: (16, 640): lanes 0:512 the solve table F (rows 0-9; columns
#            denom | n.o - n.p0 | beta numerator | gamma numerator, 128 each),
#            lanes 512:640 the attribute table (rows 0 valid | 1 mat | 2-4 n0
#            | 5-7 n1 | 8-10 n2)
NF = {"tri": 24, "box": 8, "sphere": 8, "tri_mxu": 16}
WIDTH = {"tri": LANES, "box": LANES, "sphere": LANES, "tri_mxu": MXU_LANES}
_KIND_ID = {"tri": 0, "box": 1, "sphere": 2, "tri_mxu": 3}
_PER_RAY_KINDS = ("tri", "box", "sphere")
# floats of a leaf block that its sweep reads, which is what `stream` stages
# (Shape<KIND>::staged in csrc/bvh_sweep.cuh): tri rows 0-9 (5,120 B), box
# rows 0-6 (3,584 B), sphere rows 0-4 (2,560 B), tri_mxu the solve table and
# the valid row (20,992 B); and the words of the winner's column that the
# epilogue reads once per ray that hit
STAGED_FLOATS = {"tri": 10 * LANES, "box": 7 * LANES, "sphere": 5 * LANES,
                 "tri_mxu": 10 * 512 + LANES}
ATTR_WORDS = {"tri": 10, "box": 7, "sphere": 5, "tri_mxu": 10}
FORMS = {"nosweep": 1, "noattr": 2}  # the probe forms (csrc/bvh_sweep.cuh `Form`)
WARP = 32  # the rays that walk together in the packet kernel, and drain together in both


class FormOut(NamedTuple):
    t: torch.Tensor                 # (N,) f32: BIG on every ray (nosweep), the closest hit (noattr)
    sweeps: torch.Tensor            # (N,) i32 (ray, leaf) sweeps: run (noattr), or admitted at the
                                    # drain and skipped (nosweep)
    steps: Optional[torch.Tensor]   # nosweep: (N,) i32 node steps of the ray's walk (packet: its warp's)
    rounds: Optional[torch.Tensor]  # nosweep: (N,) i32 drain rounds of the ray's warp

_libs = {}


def stream_bytes() -> int:
    """Leaf blocks above this many bytes are streamed (bvh_pallas.py:574)."""
    return int(os.environ.get("RAYSNAIL_BVH_STREAM_BYTES", str(64 * 1024 * 1024)))


def build(verbose: bool = False) -> str:
    """Compile the per-ray kernel if its library is missing; -> the path."""
    return _nvcc.build_cuda("bvh_traverse", verbose)


def build_packet(verbose: bool = False) -> str:
    """Compile the packet kernel if its library is missing; -> the path."""
    return _nvcc.build_cuda("bvh_packet", verbose)


def _load(name: str):
    if name not in _libs:
        ptr, c_int, c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "bvh_traverse":
            lib = ctypes.CDLL(build())
            fn = lib.bvh_traverse_launch
            fn.argtypes = [c_int] + [ptr] * 10 + [c_int] * 3 + [c_float, c_float, ptr, ptr, ptr]
            form = lib.bvh_traverse_form_launch
        else:
            lib = ctypes.CDLL(build_packet())
            fn = lib.bvh_packet_launch
            fn.argtypes = ([c_int] + [ptr] * 12 + [c_int] * 5
                           + [c_float, c_float, ptr, ptr, ptr])
            form = lib.bvh_packet_form_launch
        # both form entry points: (form, kind, rays, t_cap, tree, prim, n, m,
        # k_orders, t_min, t_max, t_out, counts, stream)
        form.argtypes = [c_int] * 2 + [ptr] * 10 + [c_int] * 3 + [c_float, c_float, ptr, ptr, ptr]
        fn.restype = form.restype = c_int
        _libs[name] = lib
    return _libs[name]


def safe_inv(d):
    """1 / d, with |d| < 1e-12 replaced by +-1e-12 (bvh_pallas.py:173-174)."""
    tiny = torch.where(d < 0, torch.full_like(d, -1e-12), torch.full_like(d, 1e-12))
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def lane_caps(like, t_cap=None, active=None):
    """The traversal's t_cap per lane: `t_cap` (the best hit of cheaper
    groups; BIG when None), and -1 (a dead lane) where `active` is False."""
    cap = (torch.full_like(like, BIG, dtype=torch.float32) if t_cap is None
           else t_cap.detach().to(torch.float32))
    if active is not None:
        cap = torch.where(active, cap, torch.full_like(cap, -1.0))
    return cap


def slab(bb, o, inv):
    """Slab test of node bounds bb (n, 8) (or (1, 6), broadcast) -> (near,
    far), each (n,)."""
    a = [(bb[:, c] - o[c % 3]) * inv[c % 3] for c in range(6)]
    near = torch.maximum(torch.maximum(torch.minimum(a[0], a[3]), torch.minimum(a[1], a[4])),
                         torch.minimum(a[2], a[5]))
    far = torch.minimum(torch.minimum(torch.maximum(a[0], a[3]), torch.maximum(a[1], a[4])),
                        torch.maximum(a[2], a[5]))
    return near, far


def _sweep(kind, blk, o, d, inv, bt, t_min, t_max):
    """One leaf block per ray: blk (r, NF, LANES); o, d, inv lists of (r, 1);
    bt (r, 1) best t so far -> (t, a, b) each (r, LANES), t = BIG where the
    lane is not a closer hit. (a, b) = (beta, gamma) for tri, (face axis,
    entry flag) for box."""
    fld = lambda i: blk[:, i, :]
    if kind == "tri_mxu":
        # ray features [d | o | o x d | 1] against the solve table F: each of
        # the four 128-wide column groups is a 10-term dot product, summed
        # term by term in row order so that the kernel rounds alike
        # (bvh_pallas.py:181-189, :235-249)
        feat = [d[0], d[1], d[2], o[0], o[1], o[2],
                o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2],
                o[0] * d[1] - o[1] * d[0]]
        out4 = feat[0] * blk[:, 0, 0:512]
        for k in range(1, 9):
            out4 = out4 + feat[k] * blk[:, k, 0:512]
        out4 = out4 + blk[:, 9, 0:512]  # the constant feature 1
        den = out4[:, 0:128]
        den = torch.where(torch.abs(den) < 1e-20, torch.full_like(den, 1e-20), den)
        inv_den = 1.0 / den
        t = -out4[:, 128:256] * inv_den
        beta = out4[:, 256:384] * inv_den
        gamma = out4[:, 384:512] * inv_den
        ok = ((beta >= 0.0) & (beta < 1.0) & (gamma > 0.0) & (beta + gamma < 1.0)
              & (t >= t_min) & (t <= t_max) & (blk[:, 0, 512:640] > 0.0))
        a, b = beta, gamma
    elif kind == "tri":
        j, k, ll = fld(0) - o[0], fld(1) - o[1], fld(2) - o[2]
        ax, ay, az = fld(3), fld(4), fld(5)
        ddx, ddy, ddz = fld(6), fld(7), fld(8)
        eihf = ddy * d[2] - d[1] * ddz
        gfdi = d[0] * ddz - ddx * d[2]
        dheg = ddx * d[1] - ddy * d[0]
        denom = ax * eihf + ay * gfdi + az * dheg
        denom = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
        beta = (j * eihf + k * gfdi + ll * dheg) / denom
        akjb = ax * k - j * ay
        jcal = j * az - ax * ll
        blkc = ay * ll - k * az
        gamma = (d[2] * akjb + d[1] * jcal + d[0] * blkc) / denom
        t = -(ddz * akjb + ddy * jcal + ddx * blkc) / denom
        ok = ((beta >= 0.0) & (beta < 1.0) & (gamma > 0.0) & (beta + gamma < 1.0)
              & (t >= t_min) & (t <= t_max) & (fld(9) > 0.0))
        a, b = beta, gamma
    elif kind == "box":
        tax = (fld(0) - o[0]) * inv[0]
        tbx = (fld(3) - o[0]) * inv[0]
        tay = (fld(1) - o[1]) * inv[1]
        tby = (fld(4) - o[1]) * inv[1]
        taz = (fld(2) - o[2]) * inv[2]
        tbz = (fld(5) - o[2]) * inv[2]
        lox, hix = torch.minimum(tax, tbx), torch.maximum(tax, tbx)
        loy, hiy = torch.minimum(tay, tby), torch.maximum(tay, tby)
        loz, hiz = torch.minimum(taz, tbz), torch.maximum(taz, tbz)
        near = torch.maximum(torch.maximum(lox, loy), loz)
        far = torch.minimum(torch.minimum(hix, hiy), hiz)
        okb = (near < far) & (fld(6) > 0.0)
        near_in = okb & (t_min < near) & (near < t_max)
        far_in = okb & (t_min < far) & (far < t_max)
        t = torch.where(near_in, near, far)
        ok = near_in | far_in
        c = lambda v: torch.full_like(near, v)
        axis_near = torch.where(lox >= loy, torch.where(lox >= loz, c(0.0), c(2.0)),
                                torch.where(loy >= loz, c(1.0), c(2.0)))
        axis_far = torch.where(hix <= hiy, torch.where(hix <= hiz, c(0.0), c(2.0)),
                               torch.where(hiy <= hiz, c(1.0), c(2.0)))
        a = torch.where(near_in, axis_near, axis_far)
        b = near_in.to(near.dtype)
    else:
        lx, ly, lz = o[0] - fld(0), o[1] - fld(1), o[2] - fld(2)
        half_b = d[0] * lx + d[1] * ly + d[2] * lz
        cc = lx * lx + ly * ly + lz * lz - fld(3)
        delta = half_b * half_b - cc
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        t1 = -half_b - sq
        t2 = -half_b + sq
        okd = (delta > 0.0) & (fld(4) > 0.0)
        in1 = okd & (t_min < t1) & (t1 < t_max)
        in2 = okd & (t_min < t2) & (t2 < t_max)
        t = torch.where(in1, t1, t2)
        ok = in1 | in2
        a = b = t
    return torch.where(ok & (t < bt), t, torch.full_like(t, BIG)), a, b


def _epilogue(kind, f, o, d, t, a, b):
    """Winner attributes from its block column f (h, NF) -> (a0..a3, mat)."""
    z = torch.zeros_like(t)
    if kind == "tri_mxu":  # f: the winner's column of the attribute table
        w0 = 1.0 - a - b
        n = [f[:, 2 + c] * w0 + f[:, 5 + c] * a + f[:, 8 + c] * b for c in range(3)]
        return n[0], n[1], n[2], z, f[:, 1]
    if kind == "tri":
        w0 = 1.0 - a - b
        n = [f[:, 10 + c] * w0 + f[:, 13 + c] * a + f[:, 16 + c] * b for c in range(3)]
        return n[0], n[1], n[2], z, f[:, 19]
    if kind == "box":
        rel = []
        for c in range(3):
            den = f[:, 3 + c] - f[:, c]
            den = torch.where(torch.abs(den) < 1e-12, torch.ones_like(den), den)
            rel.append(((o[c] + d[c] * t) - f[:, c]) / den)
        pick = lambda ax: torch.where(ax < 0.5, rel[0], torch.where(ax < 1.5, rel[1], rel[2]))
        u = pick(torch.remainder(a + 1.0, 3.0))
        v = pick(torch.remainder(a + 2.0, 3.0))
        return a, b, u, v, f[:, 7]
    return f[:, 0], f[:, 1], f[:, 2], f[:, 6], f[:, 5]


def packet_octant(dx, dy, dz):
    """The packet kernel's node order per ray: the direction octant of the
    sum of the directions of the ray's packet (PACKET consecutive rays; a
    last, partial packet sums the rays it has), bvh_pallas.py:164-169. The
    sum runs in the kernel's order (halving within each 32 rays, then the
    four partial sums left to right), so that its sign is the kernel's."""
    n = dx.shape[0]
    pad = (-n) % PACKET

    def total(x):
        x = torch.nn.functional.pad(x, (0, pad)).reshape(-1, PACKET // 32, 32)
        for half in (16, 8, 4, 2, 1):
            x = x[..., :half] + x[..., half:2 * half]
        x = x[..., 0]
        return ((x[:, 0] + x[:, 1]) + x[:, 2]) + x[:, 3]

    octant = ((total(dx) < 0).long() * 4 + (total(dy) < 0).long() * 2
              + (total(dz) < 0).long())
    return octant.repeat_interleave(PACKET)[:n]


def cut_counts(crange, m: int):
    """Real (unpadded) entries of the coarse cut per node order -> (K,)
    int64: a padding entry's range starts at m."""
    return (crange[:, :, 0] < m).sum(dim=1)


def node_orders(dir_xyz, k_ord: int, packet: bool):
    """Each ray's node order: its own direction octant (the per-ray kernel)
    or its packet's (the packet kernel); 0 on a tree of one order."""
    dx, dy, dz = dir_xyz
    if k_ord != 8:
        return torch.zeros(dx.shape[0], dtype=torch.long, device=dx.device)
    if packet:
        return packet_octant(dx, dy, dz)
    return (dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long()


def admission_cap(root_bb, o, inv, t_cap, t_min, t_max):
    """The per-ray admission cap from the root's slab test
    (bvh_pallas.py:214-224): -BIG, which admits nothing, where the ray
    cannot hit. root_bb (n, 8): each ray's root bounds."""
    near0, far0 = slab(root_bb, o, inv)
    cap_in = torch.minimum(t_cap, torch.full_like(t_cap, t_max))
    can_hit = (t_cap > 0.0) & (near0 <= far0) & (far0 >= t_min) & (near0 <= cap_in)
    return torch.where(can_hit, torch.minimum(far0, cap_in) * 1.0001 + 1e-4,
                       torch.full_like(far0, -BIG))


def bvh_traverse_plain(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                       t_min, t_max, kind: str = "tri", packet: bool = False,
                       stream: bool = False, two_level: bool = False,
                       cbb=None, crange=None, stats: dict | None = None):
    """Plain PyTorch version of `bvh_traverse`: the same per-ray walk, cap
    and sweep rules, in lockstep over all rays.

    packet=False walks each ray's own direction octant (the per-ray
    kernel), packet=True the octant of the ray's packet (the packet kernel).
    two_level=True loops, per ray, over the real entries of the coarse cut
    in the octant's order and walks only inside each admitted entry's
    [start, end) range; padding entries are never tested. `stream` is
    accepted and ignored: there is nothing to stage here, and the staged
    copy changes no result.

    `stats`, when given, gains what this call's data needed: "node_tests"
    and "sweeps" (per ray), "nodes" and "leaves" (distinct ones touched)."""
    del stream
    return _lockstep(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, t_min, t_max,
                     kind, packet, two_level, cbb, crange, stats)


def _lockstep(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, t_min, t_max, kind,
              packet, two_level, cbb, crange, stats, ray_sweeps=None):
    """`bvh_traverse_plain`'s walk. ray_sweeps, an (N,) int tensor, gains
    each ray's (ray, leaf) sweeps: those of a walk with an always fresh best
    t, which are the leaves the kernels' drain sweeps."""
    ox, oy, oz = origin_xyz
    dx, dy, dz = dir_xyz
    n = ox.shape[0]
    dev, f32 = ox.device, torch.float32
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    octant = node_orders(dir_xyz, k_ord, packet)
    base = octant * m
    inv = [safe_inv(c) for c in (dx, dy, dz)]
    o_all, d_all = (ox, oy, oz), (dx, dy, dz)
    bb = pk_bb.reshape(-1, 8)
    lk = pk_links.reshape(-1, 4).long()
    cap = admission_cap(bb[base], o_all, inv, t_cap, t_min, t_max)

    best_t = torch.full((n,), BIG, dtype=f32, device=dev)
    best_blk = torch.zeros(n, dtype=torch.long, device=dev)
    best_lane = torch.zeros(n, dtype=torch.long, device=dev)
    best_a = torch.zeros(n, dtype=f32, device=dev)
    best_b = torch.zeros(n, dtype=f32, device=dev)
    if stats is not None:
        seen_node = torch.zeros(bb.shape[0], dtype=torch.bool, device=dev)
        seen_leaf = torch.zeros(pk_prim.shape[0], dtype=torch.bool, device=dev)
        node_tests = sweeps = 0

    def admits(box, idx):
        near, far = slab(box, [c[idx] for c in o_all], [c[idx] for c in inv])
        return ((near <= far) & (far >= t_min)
                & (near <= torch.minimum(best_t[idx], cap[idx])))

    idx = torch.nonzero(cap >= t_min)[:, 0]
    node = torch.zeros(n, dtype=torch.long, device=dev)
    if two_level:
        # every ray starts exhausted, before cut entry 0
        cbbf = cbb.reshape(-1, 8)
        crf = crange.reshape(-1, 4).long()
        n_cut = cut_counts(crange, m)[octant]
        cbase = octant * cbb.shape[1]
        end = torch.zeros(n, dtype=torch.long, device=dev)
        cut = torch.zeros(n, dtype=torch.long, device=dev)
        idx = idx[n_cut[idx] > 0]
    else:
        end = torch.full((n,), m, dtype=torch.long, device=dev)
    while idx.numel():
        walk = idx
        if two_level:
            # rays past their entry's range test the next entry instead of a node
            adv = node[idx] >= end[idx]
            ia, walk = idx[adv], idx[~adv]
            if ia.numel():
                row = cbase[ia] + cut[ia]
                ok = admits(cbbf[row], ia)
                node[ia] = torch.where(ok, crf[row, 0], node[ia])
                end[ia] = torch.where(ok, crf[row, 1], end[ia])
                cut[ia] += 1
        if walk.numel():
            nd = node[walk]
            row = base[walk] + nd
            links = lk[row]
            admit = admits(bb[row], walk)
            leaf = links[:, 1] > 0
            sw = torch.nonzero(admit & leaf)[:, 0]
            if stats is not None:
                node_tests += int(walk.numel())
                sweeps += int(sw.numel())
                seen_node[row] = True
                seen_leaf[links[sw, 0]] = True
            if ray_sweeps is not None:
                ray_sweeps[walk[sw]] += 1
            if sw.numel():
                rays, blocks = walk[sw], links[sw, 0]
                col = lambda v: [c[rays][:, None] for c in v]
                tm, a, b = _sweep(kind, pk_prim[blocks], col(o_all), col(d_all), col(inv),
                                  best_t[rays][:, None], t_min, t_max)
                lane = torch.argmin(tm, dim=1)  # the first lane of the minimum
                rmin = tm.gather(1, lane[:, None])[:, 0]
                take = rmin < best_t[rays]
                upd = rays[take]
                best_t[upd] = rmin[take]
                best_blk[upd] = blocks[take]
                best_lane[upd] = lane[take]
                best_a[upd] = a.gather(1, lane[:, None])[:, 0][take]
                best_b[upd] = b.gather(1, lane[:, None])[:, 0][take]
            node[walk] = torch.where(admit & ~leaf, nd + 1, links[:, 2])
        if two_level:
            idx = idx[(node[idx] < end[idx]) | (cut[idx] < n_cut[idx])]
        else:
            idx = idx[node[idx] < m]
    if stats is not None:
        for key, val in (("node_tests", node_tests), ("sweeps", sweeps),
                         ("nodes", int(seen_node.sum())), ("leaves", int(seen_leaf.sum()))):
            stats[key] = stats.get(key, 0) + val

    out = [torch.zeros(n, dtype=f32, device=dev) for _ in range(5)]
    hit = torch.nonzero(best_t < BIG)[:, 0]
    if hit.numel():
        lane0 = 512 if kind == "tri_mxu" else 0
        f = pk_prim[best_blk[hit], :, lane0 + best_lane[hit]]  # (h, NF)
        attrs = _epilogue(kind, f, [c[hit] for c in o_all], [c[hit] for c in d_all],
                          best_t[hit], best_a[hit], best_b[hit])
        for dst, src in zip(out, attrs):
            dst[hit] = src
    mat = torch.round(out[4]).to(torch.int32)
    return best_t, out[0], out[1], out[2], out[3], mat


def _check(name, a, shape, dtype, device):
    if (a.device != device or a.dtype != dtype or tuple(a.shape) != tuple(shape)
            or not a.is_contiguous()):
        raise ValueError(f"bvh_traverse: {name} must be a contiguous {tuple(shape)} {dtype} "
                         f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}{'' if a.is_contiguous() else ' (strided)'}")


def _check_call(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, kind):
    """Raise on what the kernels do not take -> (device, N, K, M)."""
    if kind not in _KIND_ID:
        raise ValueError(f"bvh_traverse: unknown kind {kind!r}")
    device = origin_xyz[0].device
    n = origin_xyz[0].shape[0]
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    for i, a in enumerate(origin_xyz):
        _check(f"origin[{i}]", a, (n,), torch.float32, device)
    for i, a in enumerate(dir_xyz):
        _check(f"direction[{i}]", a, (n,), torch.float32, device)
    _check("t_cap", t_cap, (n,), torch.float32, device)
    if k_ord not in (1, 8):
        raise ValueError(f"bvh_traverse: pk_bb holds {k_ord} node orders, not 1 or 8")
    _check("pk_bb", pk_bb, (k_ord, m, 8), torch.float32, device)
    _check("pk_links", pk_links, (k_ord, m, 4), torch.int32, device)
    _check("pk_prim", pk_prim, (pk_prim.shape[0], NF[kind], WIDTH[kind]), torch.float32,
           device)
    return device, n, k_ord, m


def launch_key(kind: str, packet: bool, stream: bool = False, two_level: bool = False) -> str:
    """The key of `bvh_traverse.launches` for one route."""
    if not packet:
        return kind
    return f"packet/{kind}" + ("+stream" if stream else "") + ("+two_level" if two_level else "")


def bvh_traverse(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, t_min, t_max,
                 kind: str = "tri", stream: bool | None = None, cbb=None, crange=None,
                 two_level: bool | None = None, packet: bool | None = None):
    """-> (t, a0, a1, a2, a3, mat), each (N,); mat is int32.

    origin_xyz, dir_xyz: three (N,) f32 tensors each; t_cap (N,) f32: the
    best hit distance of cheaper primitive groups, <= 0 for dead lanes.
    pk_bb (K, M, 8) f32, pk_links (K, M, 4) i32 with K = 8 or 1, pk_prim
    (B, NF, 128) f32 (scene._pack_leaf_blocks) or, for "tri_mxu", (B, 16, 640)
    (scene._pack_mxu_blocks). Outputs per kind:
      tri, tri_mxu: a0-2 = blended (unnormalized) vertex normal, a3 = 0
      box:          a0 = face axis, a1 = entry flag, a2, a3 = face uv
      sphere:       a0-2 = center, a3 = radius
    A miss gives t = BIG, zero attributes and mat 0.

    stream: None = auto (leaf blocks above `stream_bytes()`); True stages
    deferred leaves in the packet kernel's shared-memory rings, one per
    warp. cbb (K, 64, 8) f32 and crange (K, 64, 4) i32 are
    the coarse cut (scene._leaf_tree). two_level: None =
    RAYSNAIL_BVH_TWO_LEVEL=1 where the group has a cut, as in the TPU
    wrapper; True without both arrays raises. packet: None = the packet
    kernel when kind, stream or two_level needs it; False with such a call
    raises."""
    device, n, k_ord, m = _check_call(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                                      kind)
    if stream is None:
        stream = pk_prim.numel() * 4 > stream_bytes()
    has_cut = cbb is not None and crange is not None
    if two_level is None:
        two_level = has_cut and os.environ.get("RAYSNAIL_BVH_TWO_LEVEL", "0") == "1"
    elif two_level and not has_cut:
        raise ValueError("bvh_traverse: two_level=True needs the coarse cut (cbb and crange)")
    two_level = bool(two_level)
    if two_level:
        _check("cbb", cbb, (k_ord, COARSE_MAX, 8), torch.float32, device)
        _check("crange", crange, (k_ord, COARSE_MAX, 4), torch.int32, device)
    needs_packet = kind not in _PER_RAY_KINDS or stream or two_level
    if packet is None:
        packet = needs_packet
    elif not packet and needs_packet:
        raise ValueError(f"bvh_traverse: kind {kind!r} with stream={stream}, "
                         f"two_level={two_level} needs the packet kernel")
    if device.type == "cpu":
        return bvh_traverse_plain(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                                  t_min, t_max, kind, packet=packet, stream=stream,
                                  two_level=two_level, cbb=cbb, crange=crange)
    if device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {device}")
    aligned = [pk_bb, pk_links, pk_prim] + ([cbb, crange] if two_level else [])
    if any(a.data_ptr() % 16 for a in aligned):
        raise ValueError("bvh_traverse: the packed arrays must be 16-byte aligned")

    out = torch.empty((5, n), dtype=torch.float32, device=device)
    mat = torch.empty(n, dtype=torch.int32, device=device)
    ptrs = [a.data_ptr() for a in (*origin_xyz, *dir_xyz, t_cap, pk_bb, pk_links, pk_prim)]
    with torch.cuda.device(device):
        cu_stream = torch.cuda.current_stream(device).cuda_stream
        if packet:
            cut = [cbb.data_ptr(), crange.data_ptr()] if two_level else [None, None]
            err = _load("bvh_packet").bvh_packet_launch(
                _KIND_ID[kind], *ptrs, *cut, n, m, k_ord, int(stream), int(two_level),
                float(t_min), float(t_max), out.data_ptr(), mat.data_ptr(), cu_stream)
        else:
            err = _load("bvh_traverse").bvh_traverse_launch(
                _KIND_ID[kind], *ptrs, n, m, k_ord, float(t_min), float(t_max),
                out.data_ptr(), mat.data_ptr(), cu_stream)
    key = launch_key(kind, packet, stream, two_level)
    if err != 0:
        raise RuntimeError(f"bvh_traverse ({key}) kernel launch failed: cudaError {err}")
    bvh_traverse.launches[key] += 1
    return out[0], out[1], out[2], out[3], out[4], mat


def launch_keys() -> list:
    """Every key of `bvh_traverse.launches`."""
    return [*_PER_RAY_KINDS,
            *(launch_key(kind, True, s, t) for kind in _KIND_ID
              for s in (False, True) for t in (False, True))]


bvh_traverse.launches = {key: 0 for key in launch_keys()}


# -- the probe forms -------------------------------------------------------------

def _nosweep_walk(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, t_min, t_max, packet,
                  stats=None) -> FormOut:
    """The "nosweep" form in lockstep over groups of rays that walk
    together: a ray alone in its own order (the per-ray kernel), or a warp
    of WARP rays in its packet's order (the packet kernel), which enters a
    node when any of its rays admits it. Admission by the slab test against
    the ray's cap with best t at BIG; every leaf a group enters is deferred,
    and a ray's drain admits it where the ray itself admits it."""
    n = origin_xyz[0].shape[0]
    dev = origin_xyz[0].device
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    width = WARP if packet else 1
    inv = [safe_inv(c) for c in dir_xyz]
    bb = pk_bb.reshape(-1, 8)
    lk = pk_links.reshape(-1, 4).long()
    base = node_orders(dir_xyz, k_ord, packet) * m
    cap = admission_cap(bb[base], origin_xyz, inv, t_cap, t_min, t_max)
    pad = (-n) % width
    group = lambda x, fill: torch.nn.functional.pad(x, (0, pad), value=fill).reshape(-1, width)
    o = [group(c, 0.0) for c in origin_xyz]
    iv = [group(c, 1.0) for c in inv]
    limit = group(torch.minimum(cap, torch.full_like(cap, BIG)), -BIG)  # min(best t, cap)
    gbase = group(base, 0)[:, 0]  # a group's rays share one order
    n_grp = limit.shape[0]
    count = lambda *shape: torch.zeros(shape, dtype=torch.long, device=dev)
    node, steps, deferred, sweeps = count(n_grp), count(n_grp), count(n_grp), count(n_grp, width)
    seen = torch.zeros(bb.shape[0], dtype=torch.bool, device=dev)
    act = torch.nonzero((group(cap, -BIG) >= t_min).any(dim=1))[:, 0]
    if m == 0:
        act = act[:0]
    while act.numel():
        row = gbase[act] + node[act]
        near, far = (x.view(-1, width) for x in slab(bb[row].repeat_interleave(width, 0),
                                                      [c[act].reshape(-1) for c in o],
                                                      [c[act].reshape(-1) for c in iv]))
        admit = (near <= far) & (far >= t_min) & (near <= limit[act])
        vote = admit.any(dim=1)
        links = lk[row]
        leaf = links[:, 1] > 0
        take = vote & leaf
        deferred[act] += take
        sweeps[act] += admit & take[:, None]
        steps[act] += 1
        seen[row] = True
        node[act] = torch.where(vote & ~leaf, node[act] + 1, links[:, 2])
        act = act[node[act] < m]
    per_ray = lambda x: x.expand(-1, width).reshape(-1)[:n].to(torch.int32)
    sweeps_r = sweeps.reshape(-1)[:n].to(torch.int32)
    if packet:
        rounds = per_ray(deferred[:, None])
    else:  # a round per buffer position, over the warp's longest buffer
        warps = torch.nn.functional.pad(sweeps_r, (0, (-n) % WARP)).reshape(-1, WARP)
        rounds = warps.amax(dim=1).repeat_interleave(WARP)[:n]
    steps_r = per_ray(steps[:, None])
    if stats is not None:
        for key, val in (("node_tests", int(steps_r.sum())), ("sweeps", 0),
                         ("nodes", int(seen.sum())), ("leaves", 0)):
            stats[key] = stats.get(key, 0) + val
    return FormOut(torch.full((n,), BIG, dtype=torch.float32, device=dev), sweeps_r, steps_r,
                   rounds)


def bvh_traverse_form_plain(form: str, origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                            t_min, t_max, kind: str = "tri", packet: bool = False,
                            stats: dict | None = None) -> FormOut:
    """Plain PyTorch version of `bvh_traverse_form`. "nosweep": the walk
    with slab-and-cap admission and best t at BIG, with its counters;
    "noattr": `bvh_traverse_plain`'s t and the leaves that a walk with an
    always fresh best t sweeps, which are the ones the kernels' deferred
    drain sweeps (csrc/bvh_traverse.cu). `stats` as for
    `bvh_traverse_plain` (nosweep: no sweep, and the nodes its walk
    touched)."""
    if form == "nosweep":
        return _nosweep_walk(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, t_min, t_max, packet,
                             stats)
    ray_sweeps = torch.zeros(origin_xyz[0].shape[0], dtype=torch.int32,
                             device=origin_xyz[0].device)
    t = _lockstep(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, t_min, t_max, kind,
                  packet, False, None, None, stats, ray_sweeps)[0]
    return FormOut(t, ray_sweeps, None, None)


def form_key(form: str, kind: str, packet: bool) -> str:
    """The key of `bvh_traverse_form.launches` for one form and route."""
    return f"{form}/{launch_key(kind, packet)}"


def bvh_traverse_form(form: str, origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                      t_min, t_max, kind: str = "tri", packet: bool = False) -> FormOut:
    """A probe form of the traversal, "nosweep" or "noattr" (see the module
    docstring), through the per-ray kernel or (packet=True) the packet
    kernel with `stream` and `two_level` off; the arguments as for
    `bvh_traverse`, kinds "tri", "box" and "sphere". On CUDA tensors it
    launches the kernel's form or raises; on CPU tensors it runs
    `bvh_traverse_form_plain`."""
    if form not in FORMS:
        raise ValueError(f"bvh_traverse_form: form must be one of {tuple(FORMS)}, got {form!r}")
    if kind not in _PER_RAY_KINDS:
        raise ValueError(f"bvh_traverse_form: no probe form of kind {kind!r}")
    device, n, k_ord, m = _check_call(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                                      kind)
    if device.type == "cpu":
        return bvh_traverse_form_plain(form, origin_xyz, dir_xyz, t_cap, pk_bb, pk_links,
                                       pk_prim, t_min, t_max, kind, packet)
    if device.type != "cuda":
        raise ValueError(f"bvh_traverse_form: unsupported device {device}")
    if any(a.data_ptr() % 16 for a in (pk_bb, pk_links, pk_prim)):
        raise ValueError("bvh_traverse_form: the packed arrays must be 16-byte aligned")
    t = torch.empty(n, dtype=torch.float32, device=device)
    counts = torch.empty((3 if form == "nosweep" else 1, n), dtype=torch.int32, device=device)
    ptrs = [a.data_ptr() for a in (*origin_xyz, *dir_xyz, t_cap, pk_bb, pk_links, pk_prim)]
    with torch.cuda.device(device):
        cu_stream = torch.cuda.current_stream(device).cuda_stream
        lib = _load("bvh_packet" if packet else "bvh_traverse")
        launch = lib.bvh_packet_form_launch if packet else lib.bvh_traverse_form_launch
        err = launch(FORMS[form], _KIND_ID[kind], *ptrs, n, m, k_ord, float(t_min),
                     float(t_max), t.data_ptr(), counts.data_ptr(), cu_stream)
    key = form_key(form, kind, packet)
    if err != 0:
        raise RuntimeError(f"bvh_traverse_form ({key}) kernel launch failed: cudaError {err}")
    bvh_traverse_form.launches[key] += 1
    if form == "nosweep":
        return FormOut(t, counts[0], counts[1], counts[2])
    return FormOut(t, counts[0], None, None)


bvh_traverse_form.launches = {form_key(f, k, p): 0 for f in FORMS for p in (False, True)
                              for k in _PER_RAY_KINDS}
