"""Axis-aligned and oriented box intersection (slab tests).

The branch-free slab test gives the same (t_near, t_far) interval, face
normal and uv as the reference's six-rect Box (src/hittable/geometry/
box.rs:48-149). Oriented boxes carry a per-box world->object affine; the
slab test runs in object space, with inverse-transpose normals. The winner
of the dense (rays x boxes) sweep is gathered by index.

Axis-aligned groups of BOX_BVH_MIN_BUILD (130) or more boxes also carry a
packed BVH; `intersect_kernel` runs them through the BVH traversal kernel
(`ops.bvh_traverse` kind "box"), which returns the winning face's axis, entry
flag, uv and material.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.ops.bvh_traverse import bvh_traverse, lane_caps
from raysnail_tpu_torch.prelude.vec import Vec3


class BoxGroup(NamedTuple):
    p_min: Vec3             # (B,)
    p_max: Vec3             # (B,)
    mat_id: torch.Tensor    # (B,) int32
    active: torch.Tensor    # (B,) bool
    # Optional orientation (None => all axis-aligned). inv_rows map world ->
    # object: p_obj = inv_rot @ p + inv_off; their transpose maps object
    # normals -> world.
    inv_rows: tuple | None = None  # (row0, row1, row2) Vec3s, each (B,)
    inv_off: Vec3 | None = None    # (B,)
    # packed BVH for the traversal kernel (large axis-aligned groups only)
    pk_bb: torch.Tensor | None = None     # (K, M, 8) f32
    pk_links: torch.Tensor | None = None  # (K, M, 4) i32
    pk_box: torch.Tensor | None = None    # (B', 8, 128) f32
    pk_cbb: torch.Tensor | None = None     # (K, 64, 8) f32 coarse cut (two-level walk)
    pk_crange: torch.Tensor | None = None  # (K, 64, 4) i32 [start, end) node ranges


def _fma(a, b, c):
    """a * b + c with the product kept exact, on either device: the product
    of two float32 values is exact in float64, the sum rounds to float64 and
    then to float32. That is a fused multiply-add's single rounding except
    where the exact sum lies within 2**-29 of a float32 ulp of the midpoint
    of two float32 values (two roundings can then differ from one by an
    ulp)."""
    return torch.addcmul(c.double(), a.double(), b.double()).to(a.dtype)


def _apply_rows(rows, off, v: Vec3, translate: bool) -> Vec3:
    """The world -> object affine of an oriented primitive. Each row's dot
    product rounds where the JAX package's one does when XLA compiles it for
    the CPU (x and z products fused into the sums, the y product rounded on
    its own; the pattern is that compiler's choice, not a rule of the
    arithmetic, and the package run op by op rounds every product): a ray
    that meets an oriented face 900 units away otherwise lands 1e-4 to the
    other side of it, and its path with it."""
    r0, r1, r2 = rows

    def dot(r):
        return _fma(r.z, v.z, _fma(r.x, v.x, r.y * v.y))

    out = Vec3(dot(r0), dot(r1), dot(r2))
    if translate:
        out = out + off
    return out


def _apply_rows_t(rows, v: Vec3) -> Vec3:
    """Multiply by the transpose of the 3x3 given as rows (normal transform)."""
    r0, r1, r2 = rows
    return Vec3(
        r0.x * v.x + r1.x * v.y + r2.x * v.z,
        r0.y * v.x + r1.y * v.y + r2.y * v.z,
        r0.z * v.x + r1.z * v.y + r2.z * v.z,
    )


def _safe_inv(c):
    tiny = torch.where(c < 0, torch.full_like(c, -1e-12), torch.full_like(c, 1e-12))
    return 1.0 / torch.where(torch.abs(c) < 1e-12, tiny, c)


def slab(p_min: Vec3, p_max: Vec3, o: Vec3, d: Vec3):
    """Slab test -> (t_near, t_far, axis_near, axis_far). Axes identify the
    face (0=x,1=y,2=z) attaining the near/far bound."""
    inv = d.map(_safe_inv)
    ta = (p_min - o) * inv
    tb = (p_max - o) * inv
    lo = Vec3(torch.minimum(ta.x, tb.x), torch.minimum(ta.y, tb.y), torch.minimum(ta.z, tb.z))
    hi = Vec3(torch.maximum(ta.x, tb.x), torch.maximum(ta.y, tb.y), torch.maximum(ta.z, tb.z))
    t_near = lo.max_component()
    t_far = hi.min_component()
    axis_near = torch.where(lo.x >= lo.y, torch.where(lo.x >= lo.z, 0, 2),
                            torch.where(lo.y >= lo.z, 1, 2))
    axis_far = torch.where(hi.x <= hi.y, torch.where(hi.x <= hi.z, 0, 2),
                           torch.where(hi.y <= hi.z, 1, 2))
    return t_near, t_far, axis_near, axis_far


def _axis_normal(axis, sign) -> Vec3:
    zero = torch.zeros_like(sign)
    return Vec3(torch.where(axis == 0, sign, zero), torch.where(axis == 1, sign, zero),
                torch.where(axis == 2, sign, zero))


def _select_axis(x, y, z, axis):
    return torch.where(axis == 0, x, torch.where(axis == 1, y, z))


def intersect(group: BoxGroup, ray, t_min, t_max) -> Hit:
    """Closest box hit per ray: surface t is t_near if in range else t_far
    (ray started inside — box.rs:131-134), with the face's outward normal and
    face uv."""
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    oriented = group.inv_rows is not None
    if oriented:
        rows = tuple(r.map(lambda a: a[None, :]) for r in group.inv_rows)
        off = group.inv_off.map(lambda a: a[None, :])
        o = _apply_rows(rows, off, o, translate=True)
        d = _apply_rows(rows, off, d, translate=False)

    pmin = group.p_min.map(lambda a: a[None, :])
    pmax = group.p_max.map(lambda a: a[None, :])
    t_near, t_far, axis_near, axis_far = slab(pmin, pmax, o, d)

    hit_slab = (t_near < t_far) & group.active[None, :]
    near_in = hit_slab & (t_min < t_near) & (t_near < t_max)
    far_in = hit_slab & (t_min < t_far) & (t_far < t_max)
    big = torch.full_like(t_near, BIG)
    t = torch.where(near_in, t_near, torch.where(far_in, t_far, big))

    idx = torch.argmin(t, dim=1, keepdim=True)  # first index of the minimum
    t_best = torch.gather(t, 1, idx)[:, 0]
    valid = t_best < BIG
    near_sel = torch.gather(near_in, 1, idx)[:, 0]
    axis = torch.gather(torch.where(near_in, axis_near, axis_far), 1, idx)[:, 0]
    idx = idx[:, 0]

    d_obj, o_obj = ray.direction, ray.origin
    if oriented:
        rows_sel = tuple(r[idx] for r in group.inv_rows)
        off_sel = group.inv_off[idx]
        d_obj = _apply_rows(rows_sel, off_sel, d_obj, translate=False)
        o_obj = _apply_rows(rows_sel, off_sel, o_obj, translate=True)

    d_axis = _select_axis(d_obj.x, d_obj.y, d_obj.z, axis)
    # outward normal of the entry face opposes d; of the exit face follows d
    sign = torch.where(near_sel, -torch.sign(d_axis), torch.sign(d_axis))
    n_obj = _axis_normal(axis, sign)
    geom_n = _apply_rows_t(rows_sel, n_obj).unit() if oriented else n_obj

    # face uv: fractional coords of the object-space hit in the two free axes
    p_obj = o_obj + d_obj * t_best
    pmin_sel = group.p_min[idx]
    ext = (group.p_max[idx] - pmin_sel).map(
        lambda c: torch.where(torch.abs(c) < 1e-12, torch.ones_like(c), c))
    rel = (p_obj - pmin_sel) / ext
    u = _select_axis(rel.x, rel.y, rel.z, (axis + 1) % 3)
    v = _select_axis(rel.x, rel.y, rel.z, (axis + 2) % 3)
    return hitlib.finalize(ray.direction, t_best, geom_n, u, v, group.mat_id[idx], valid)


def intersect_kernel(group: BoxGroup, ray, t_min, t_max, active=None, t_cap=None,
                     packet: bool | None = None) -> Hit:
    """Closest hit of an axis-aligned box group through the BVH traversal
    kernel; only the normal is rebuilt here, from the face axis and the
    entry flag. `active`, `t_cap` and `packet` as for
    triangles.intersect_kernel."""
    o, d = ray.origin, ray.direction
    cap = lane_caps(d.x, t_cap, active)
    t, axis_f, near_f, u, v, mat = bvh_traverse(
        (o.x, o.y, o.z), (d.x, d.y, d.z), cap, group.pk_bb, group.pk_links, group.pk_box,
        t_min, t_max, kind="box", cbb=group.pk_cbb, crange=group.pk_crange,
        packet=packet)
    valid = t < BIG * 0.5
    axis = torch.round(axis_f).to(torch.int32)
    d_axis = _select_axis(d.x, d.y, d.z, axis)
    sign = torch.where(near_f > 0.5, -torch.sign(d_axis), torch.sign(d_axis))
    return hitlib.finalize(d, torch.where(valid, t, torch.full_like(t, BIG)),
                           _axis_normal(axis, sign), u, v,
                           torch.where(valid, mat, torch.full_like(mat, -1)), valid)


# -- CSG and media support (one box, scalar params broadcast over rays) -------

def interval(p_min: Vec3, p_max: Vec3, ray, t_min, t_max, inv_rows=None, inv_off=None):
    """(t1, t2, valid, axis, near_sel, d_obj, o_obj) of one box per ray
    (box.rs:125-149): (t_near, t_far) when entering, (t_far, BIG) when the
    ray starts inside; the object-space ray comes back for the normal and
    uv."""
    o, d = ray.origin, ray.direction
    if inv_rows is not None:
        o = _apply_rows(inv_rows, inv_off, o, translate=True)
        d = _apply_rows(inv_rows, inv_off, d, translate=False)
    t_near, t_far, axis_near, axis_far = slab(p_min, p_max, o, d)
    hit_slab = t_near < t_far
    near_in = hit_slab & (t_min < t_near) & (t_near < t_max)
    far_in = hit_slab & (t_min < t_far) & (t_far < t_max)
    t1 = torch.where(near_in, t_near, t_far)
    t2 = torch.where(near_in, t_far, torch.full_like(t_far, BIG))
    axis = torch.where(near_in, axis_near, axis_far)
    return t1, t2, near_in | far_in, axis, near_in, d, o


def normal_of(axis, near_sel, d_obj: Vec3, inv_rows=None) -> Vec3:
    """Outward normal of the face `axis` (entry face if near_sel), in world
    space."""
    d_axis = _select_axis(d_obj.x, d_obj.y, d_obj.z, axis)
    sign = torch.where(near_sel, -torch.sign(d_axis), torch.sign(d_axis))
    n = _axis_normal(axis, sign)
    if inv_rows is not None:
        n = _apply_rows_t(inv_rows, n).unit()
    return n


def contains(p_min: Vec3, p_max: Vec3, p: Vec3, inv_rows=None, inv_off=None):
    """box.rs:151-156 (inclusive bounds)."""
    if inv_rows is not None:
        p = _apply_rows(inv_rows, inv_off, p, translate=True)
    return ((p.x >= p_min.x) & (p.x <= p_max.x) & (p.y >= p_min.y) & (p.y <= p_max.y)
            & (p.z >= p_min.z) & (p.z <= p_max.z))
