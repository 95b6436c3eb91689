"""Axis-aligned (and transformed) rectangle intersection.

The reference's AARect family (src/hittable/geometry/rect.rs) stores an axis
permutation (a0, a1, k); here the group keeps a per-rect k-axis index and
selects ray components by it, so XY, XZ and YZ rects share one dense test.
Transformed rects carry a per-rect world -> object affine and intersect in
object space, with inverse-transpose normals. The winner of the dense (rays
x rects) sweep is gathered by index. Light sampling on XZ rects lives in
`lights`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.boxes import _apply_rows, _apply_rows_t
from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.prelude.vec import Vec3


class RectGroup(NamedTuple):
    k_axis: torch.Tensor   # (R,) int32: 0 = YZ rect (x = k), 1 = XZ (y = k), 2 = XY (z = k)
    k: torch.Tensor        # (R,) plane coordinate
    a0: torch.Tensor       # (R,) bounds along the a-axis (rect.rs:58-80:
    a1: torch.Tensor       #      yz -> (a = y, b = z), xz -> (x, z), xy -> (x, y))
    b0: torch.Tensor       # (R,) bounds along the b-axis
    b1: torch.Tensor
    mat_id: torch.Tensor
    active: torch.Tensor
    # Optional orientation (None => all axis-aligned): world -> object rows,
    # identity for untransformed members of a mixed group
    inv_rows: tuple | None = None  # (row0, row1, row2) Vec3s, each (R,)
    inv_off: Vec3 | None = None    # (R,)


def _ab_axes(k_axis):
    """Reference axis tuples (rect.rs:58-80): k = 0 -> (1, 2); 1 -> (0, 2);
    2 -> (0, 1)."""
    one, zero, two = torch.ones_like(k_axis), torch.zeros_like(k_axis), torch.full_like(k_axis, 2)
    return torch.where(k_axis == 0, one, zero), torch.where(k_axis == 2, one, two)


def _comp(v: Vec3, axis):
    """Per-lane component by an axis index tensor (broadcasting)."""
    return torch.where(axis == 0, v.x, torch.where(axis == 1, v.y, v.z))


def intersect(group: RectGroup, ray, t_min, t_max) -> Hit:
    """Closest rect hit per ray."""
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    oriented = group.inv_rows is not None
    if oriented:
        rows = tuple(r.map(lambda a: a[None, :]) for r in group.inv_rows)
        off = group.inv_off.map(lambda a: a[None, :])
        o = _apply_rows(rows, off, o, translate=True)
        d = _apply_rows(rows, off, d, translate=False)
    k_axis = group.k_axis[None, :]
    a_axis, b_axis = _ab_axes(k_axis)

    dk = _comp(d, k_axis)
    tiny = torch.where(dk < 0, torch.full_like(dk, -1e-12), torch.full_like(dk, 1e-12))
    dk = torch.where(torch.abs(dk) < 1e-12, tiny, dk)
    t = (group.k[None, :] - _comp(o, k_axis)) / dk
    pa = _comp(o, a_axis) + t * _comp(d, a_axis)
    pb = _comp(o, b_axis) + t * _comp(d, b_axis)
    ok = (group.active[None, :] & (t_min < t) & (t < t_max)
          & (pa >= group.a0[None, :]) & (pa <= group.a1[None, :])
          & (pb >= group.b0[None, :]) & (pb <= group.b1[None, :]))
    t = torch.where(ok, t, torch.full_like(t, BIG))

    idx = torch.argmin(t, dim=1, keepdim=True)  # first index of the minimum
    t_best = torch.gather(t, 1, idx)[:, 0]
    valid = t_best < BIG
    pa_sel = torch.gather(pa, 1, idx)[:, 0]
    pb_sel = torch.gather(pb, 1, idx)[:, 0]
    idx = idx[:, 0]

    ksel = group.k_axis[idx]
    one, zero = torch.ones_like(t_best), torch.zeros_like(t_best)
    geom_n = Vec3(torch.where(ksel == 0, one, zero), torch.where(ksel == 1, one, zero),
                  torch.where(ksel == 2, one, zero))
    if oriented:
        geom_n = _apply_rows_t(tuple(r[idx] for r in group.inv_rows), geom_n).unit()
    a0, a1, b0, b1 = group.a0[idx], group.a1[idx], group.b0[idx], group.b1[idx]
    u = (pa_sel - a0) / (a1 - a0)
    v = (pb_sel - b0) / (b1 - b0)
    return hitlib.finalize(ray.direction, t_best, geom_n, u, v, group.mat_id[idx], valid)
