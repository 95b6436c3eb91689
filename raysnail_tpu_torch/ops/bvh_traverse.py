"""Closest hit through the packed fat-leaf BVH: the CUDA kernel and its plain
PyTorch version.

`bvh_traverse` is the port of the TPU kernel
`raysnail_tpu/ops/bvh_pallas.py:bvh_traverse` for the leaf kinds "tri",
"box" and "sphere", over the same packed arrays (`scene._pack_leaf_blocks`)
and with the same outputs, for any ray count (no padding to a tile). On CUDA
tensors it launches `csrc/bvh_traverse.cu` (built at first use with nvcc
into `_build/`, loaded with ctypes) or raises; on CPU tensors it runs
`bvh_traverse_plain`. There is no fallback from the kernel to the plain
version: a build or launch failure raises.

Both walk, per ray, the skip-link DFS order of the ray's own direction
octant with a per-ray admission cap, and keep the first winner of a tie
(lowest lane in a leaf, first leaf visited); see the kernel source for what
they share with the TPU kernel and where they differ. The plain version
walks all rays in lockstep, one node per step, and sweeps the leaves that
rays reach in a step as one batched (rays, 128) test.

`bvh_traverse.launches[kind]` counts kernel launches per kind (not plain
version calls), so a run can show that its traversals went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from raysnail_tpu_torch.geometry.hit import BIG
from raysnail_tpu_torch.ops import _nvcc

LANES = 128  # primitives per leaf block
# leaf-block field rows per kind (bvh_pallas.py:54-61):
#   tri:    0-2 p0 | 3-5 p0-p1 | 6-8 p0-p2 | 9 valid | 10-18 n0 n1 n2 | 19 mat
#   box:    0-2 p_min | 3-5 p_max | 6 valid | 7 mat
#   sphere: 0-2 center | 3 r^2 | 4 valid | 5 mat | 6 r
NF = {"tri": 24, "box": 8, "sphere": 8}
_KIND_ID = {"tri": 0, "box": 1, "sphere": 2}

_lib = None


def build(verbose: bool = False) -> str:
    """Compile the kernel if its library is missing; -> the library path."""
    return _nvcc.build_cuda("bvh_traverse", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.bvh_traverse_launch
        ptr = ctypes.c_void_p
        fn.argtypes = ([ctypes.c_int] + [ptr] * 10 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_float, ptr, ptr, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    if kind == "tri":
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


def bvh_traverse_plain(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                       t_min, t_max, kind: str = "tri"):
    """Plain PyTorch version of `bvh_traverse`: the same per-ray walk, cap
    and sweep rules, in lockstep over all rays."""
    ox, oy, oz = origin_xyz
    dx, dy, dz = dir_xyz
    n = ox.shape[0]
    dev, f32 = ox.device, torch.float32
    k_ord, m = pk_bb.shape[0], pk_bb.shape[1]
    if k_ord == 8:
        octant = ((dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long())
    else:
        octant = torch.zeros(n, dtype=torch.long, device=dev)
    base = octant * m
    inv = [safe_inv(c) for c in (dx, dy, dz)]
    o_all, d_all = (ox, oy, oz), (dx, dy, dz)
    bb = pk_bb.reshape(-1, 8)
    lk = pk_links.reshape(-1, 4).long()

    near0, far0 = slab(bb[base], o_all, inv)
    cap_in = torch.minimum(t_cap, torch.full_like(t_cap, t_max))
    can_hit = (t_cap > 0.0) & (near0 <= far0) & (far0 >= t_min) & (near0 <= cap_in)
    cap = torch.where(can_hit, torch.minimum(far0, cap_in) * 1.0001 + 1e-4,
                      torch.full_like(far0, -BIG))

    best_t = torch.full((n,), BIG, dtype=f32, device=dev)
    best_blk = torch.zeros(n, dtype=torch.long, device=dev)
    best_lane = torch.zeros(n, dtype=torch.long, device=dev)
    best_a = torch.zeros(n, dtype=f32, device=dev)
    best_b = torch.zeros(n, dtype=f32, device=dev)

    node = torch.where(cap >= t_min, 0, m).long()
    idx = torch.nonzero(node < m)[:, 0]
    while idx.numel():
        nd = node[idx]
        row = base[idx] + nd
        o = [c[idx] for c in o_all]
        dv = [c[idx] for c in d_all]
        iv = [c[idx] for c in inv]
        near, far = slab(bb[row], o, iv)
        links = lk[row]
        admit = ((near <= far) & (far >= t_min)
                 & (near <= torch.minimum(best_t[idx], cap[idx])))
        leaf = links[:, 1] > 0
        sw = torch.nonzero(admit & leaf)[:, 0]
        if sw.numel():
            rays, blocks = idx[sw], links[sw, 0]
            col = lambda v: [c[sw][:, None] for c in v]
            tm, a, b = _sweep(kind, pk_prim[blocks], col(o), col(dv), col(iv),
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
        nxt = torch.where(admit & ~leaf, nd + 1, links[:, 2])
        node[idx] = nxt
        idx = idx[nxt < m]

    out = [torch.zeros(n, dtype=f32, device=dev) for _ in range(5)]
    hit = torch.nonzero(best_t < BIG)[:, 0]
    if hit.numel():
        f = pk_prim[best_blk[hit], :, best_lane[hit]]  # (h, NF)
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


def bvh_traverse(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim, t_min, t_max,
                 kind: str = "tri"):
    """-> (t, a0, a1, a2, a3, mat), each (N,); mat is int32.

    origin_xyz, dir_xyz: three (N,) f32 tensors each; t_cap (N,) f32: the
    best hit distance of cheaper primitive groups, <= 0 for dead lanes.
    pk_bb (K, M, 8) f32, pk_links (K, M, 4) i32 with K = 8 or 1, pk_prim
    (B, NF, 128) f32 (scene._pack_leaf_blocks). Outputs per kind:
      tri:    a0-2 = blended (unnormalized) vertex normal, a3 = 0
      box:    a0 = face axis, a1 = entry flag, a2, a3 = face uv
      sphere: a0-2 = center, a3 = radius
    A miss gives t = BIG, zero attributes and mat 0."""
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
    _check("pk_prim", pk_prim, (pk_prim.shape[0], NF[kind], LANES), torch.float32, device)
    if device.type == "cpu":
        return bvh_traverse_plain(origin_xyz, dir_xyz, t_cap, pk_bb, pk_links, pk_prim,
                                  t_min, t_max, kind)
    if device.type != "cuda":
        raise ValueError(f"bvh_traverse: unsupported device {device}")
    if pk_bb.data_ptr() % 16 or pk_links.data_ptr() % 16:
        raise ValueError("bvh_traverse: pk_bb and pk_links must be 16-byte aligned")

    out = torch.empty((5, n), dtype=torch.float32, device=device)
    mat = torch.empty(n, dtype=torch.int32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.bvh_traverse_launch(
            _KIND_ID[kind], *(a.data_ptr() for a in (*origin_xyz, *dir_xyz, t_cap, pk_bb,
                                                     pk_links, pk_prim)),
            n, m, k_ord, NF[kind], float(t_min), float(t_max),
            out.data_ptr(), mat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh_traverse ({kind}) kernel launch failed: cudaError {err}")
    bvh_traverse.launches[kind] += 1
    return out[0], out[1], out[2], out[3], out[4], mat


bvh_traverse.launches = {kind: 0 for kind in _KIND_ID}
