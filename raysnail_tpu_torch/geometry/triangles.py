"""Triangle meshes: SoA storage, the dense sweep, and the BVH kernel route.

The triangle test is the reference's Cramer's-rule barycentric solve with
precomputed edge coefficients (src/hittable/geometry/triangle_mesh.rs:41-60,
85-131): beta in [0,1), gamma in (0,1), beta+gamma < 1, smooth normal = the
barycentric blend of the vertex normals used AS GIVEN (HitRecord::with_normal
sets outside=true without flipping the normal toward the ray), uv = (0,0).

Two routes, as in the JAX package:
  * `intersect_brute`, the dense chunked (rays x triangles) sweep, for
    meshes of at most BRUTE_FORCE_MAX triangles on the CPU;
  * `intersect_kernel`, the fat-leaf BVH traversal kernels (`ops.bvh_traverse`
    kind "tri", or "tri_mxu" for a mesh compiled in that format), with optional supertile ray binning (`ops.binning`) in
    front. On CPU tensors the kernel's plain version runs: that is also the
    route for big meshes on the CPU, where the JAX package walks a second,
    thin (LEAF_SIZE=4) BVH in lockstep, which the port does not carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.ops import binning
from raysnail_tpu_torch.ops.bvh_traverse import MXU_LANES, bvh_traverse, lane_caps
from raysnail_tpu_torch.prelude.vec import Vec3


class TriangleGroup(NamedTuple):
    # per-triangle data in the JAX package's (thin-BVH leaf) order, padded;
    # padding entries have mat_id == -2
    p0: Vec3                # (F,)
    edge_a: Vec3            # p0 - p1 (the reference's a,b,c)
    edge_d: Vec3            # p0 - p2 (the reference's d,e,f)
    n0: Vec3                # vertex normals
    n1: Vec3
    n2: Vec3
    mat_id: torch.Tensor    # (F,) int32; -2 for padding
    # the fat-leaf BVH and its 128-wide leaf blocks (scene._pack_leaf_blocks)
    pk_bb: torch.Tensor     # (K, M, 8) f32
    pk_links: torch.Tensor  # (K, M, 4) i32
    pk_tri: torch.Tensor    # (B, 24, 128) f32, or (B, 16, 640) in the "tri_mxu" format
    pk_cbb: torch.Tensor | None = None     # (K, 64, 8) f32 coarse cut (two-level walk)
    pk_crange: torch.Tensor | None = None  # (K, 64, 4) i32 [start, end) node ranges


def intersect_brute(group: TriangleGroup, ray, t_min, t_max, chunk: int = 256) -> Hit:
    """Dense chunked triangle sweep: per chunk the first-index argmin, across
    chunks a strict `<`, so a tie goes to the lowest triangle index."""
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    n = d.x.shape[0]
    dev, dtype = d.x.device, d.x.dtype
    f = group.mat_id.shape[0]
    bt = torch.full((n,), BIG, dtype=dtype, device=dev)
    btri = torch.zeros(n, dtype=torch.long, device=dev)
    bb = torch.zeros(n, dtype=dtype, device=dev)
    bg = torch.zeros(n, dtype=dtype, device=dev)
    for base in range(0, f, chunk):
        sl = slice(base, min(base + chunk, f))
        p0 = group.p0.map(lambda a: a[sl][None, :])
        A = group.edge_a.map(lambda a: a[sl][None, :])
        D = group.edge_d.map(lambda a: a[sl][None, :])
        j, k, l = p0.x - o.x, p0.y - o.y, p0.z - o.z
        eihf = D.y * d.z - d.y * D.z
        gfdi = d.x * D.z - D.x * d.z
        dheg = D.x * d.y - D.y * d.x
        denom = A.x * eihf + A.y * gfdi + A.z * dheg
        denom = torch.where(torch.abs(denom) < 1e-20, torch.full_like(denom, 1e-20), denom)
        beta = (j * eihf + k * gfdi + l * dheg) / denom
        akjb = A.x * k - j * A.y
        jcal = j * A.z - A.x * l
        blkc = A.y * l - k * A.z
        gamma = (d.z * akjb + d.y * jcal + d.x * blkc) / denom
        t = -(D.z * akjb + D.y * jcal + D.x * blkc) / denom
        ok = ((beta >= 0.0) & (beta < 1.0) & (gamma > 0.0) & (beta + gamma < 1.0)
              & (t >= t_min) & (t <= t_max) & (group.mat_id[sl][None, :] != -2))
        t = torch.where(ok, t, torch.full_like(t, BIG))
        arg = torch.argmin(t, dim=1, keepdim=True)  # the first index of the minimum
        tc = t.gather(1, arg)[:, 0]
        take = tc < bt
        bt = torch.where(take, tc, bt)
        btri = torch.where(take, arg[:, 0] + base, btri)
        bb = torch.where(take, beta.gather(1, arg)[:, 0], bb)
        bg = torch.where(take, gamma.gather(1, arg)[:, 0], bg)

    valid = bt < BIG
    normal = (group.n0[btri] * (1.0 - bb - bg) + group.n1[btri] * bb
              + group.n2[btri] * bg).unit()
    mat_id = torch.where(valid, group.mat_id[btri], torch.full_like(group.mat_id[btri], -1))
    z = torch.zeros_like(bt)
    # with_normal semantics: normal as given, outside = true
    return Hit(t=torch.where(valid, bt, torch.full_like(bt, BIG)), valid=valid,
               normal=normal, u=z, v=z, mat_id=mat_id.to(torch.int32),
               outside=torch.ones_like(valid))


def intersect_kernel(group: TriangleGroup, ray, t_min, t_max, active=None, t_cap=None,
                     bin_mode: str = "never", packet: bool | None = None) -> Hit:
    """Closest mesh hit through the BVH traversal kernel, which returns the
    blended normal and the material itself.

    `active` is the integrator's alive mask: dead lanes admit no node.
    `t_cap` is the best hit distance of cheaper primitive groups: no node
    beyond it is admitted. bin_mode != "never" reorders the rays inside
    4096-lane supertiles by a coherence key first (ops/binning.py) and
    restores their order after. `packet` is bvh_traverse's argument of
    that name: None = the packet kernel when the call needs it."""
    d, o = ray.direction, ray.origin
    n = d.x.shape[0]
    cap = lane_caps(d.x, t_cap, active)
    fields = [o.x, o.y, o.z, d.x, d.y, d.z, cap]
    dst = None
    if bin_mode != "never":
        # pad to whole supertiles; pad lanes are dead (cap 0) -> last bin
        pad = (-n) % binning.B
        fields = [torch.nn.functional.pad(a, (0, pad)) for a in fields]
        key = binning.keys(*fields, group.pk_bb[0, 0, :6], t_min, bin_mode)
        dst = binning.dest(key, binning.MODE_KEYS[bin_mode])
        fields = binning.apply(dst, fields)
    fields = [a.contiguous() for a in fields]
    # the block's lane width tells the pack format: 640 = the feature-product
    # solve (scene._pack_mxu_blocks), 128 = Cramer (scene._pack_leaf_blocks)
    kind = "tri_mxu" if group.pk_tri.shape[2] == MXU_LANES else "tri"
    t, nx, ny, nz, _, mat = bvh_traverse(
        tuple(fields[0:3]), tuple(fields[3:6]), fields[6], group.pk_bb, group.pk_links,
        group.pk_tri, t_min, t_max, kind=kind, cbb=group.pk_cbb, crange=group.pk_crange,
        packet=packet)
    if dst is not None:
        t, nx, ny, nz, mat = (a[:n] for a in binning.unapply(dst, [t, nx, ny, nz, mat]))

    valid = t < BIG * 0.5
    # miss lanes carry zero normals; keep unit() NaN-free
    normal = Vec3(nx, ny, torch.where(valid, nz, torch.ones_like(nz))).unit()
    z = torch.zeros_like(t)
    # with_normal semantics: normal as given, outside = true
    return Hit(t=torch.where(valid, t, torch.full_like(t, BIG)), valid=valid, normal=normal,
               u=z, v=z, mat_id=torch.where(valid, mat, torch.full_like(mat, -1)),
               outside=torch.ones_like(valid))
