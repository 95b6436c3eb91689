"""Ray-sphere intersection over a static SoA sphere group.

The reference's half-b quadratic with the t1-else-t2 in-range rule
(src/hittable/geometry/sphere.rs:83-109) and spherical uv
(sphere.rs:64-71). The dense (rays x spheres) sweep with its min-t and
first-index argmin is one call of `ops.sphere_min_t`, which runs the CUDA
kernel on the card; the winner's center, radius and material are then
gathered by index.

Motion blur and the BVH route for very large groups are not ported yet
(ROADMAP M12/M13); scene compile refuses scenes that need them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.ops.sphere_min_t import sphere_min_t
from raysnail_tpu_torch.prelude.sampling import PI
from raysnail_tpu_torch.prelude.vec import Vec3


class SphereGroup(NamedTuple):
    center: Vec3            # (S,)
    radius: torch.Tensor    # (S,)
    mat_id: torch.Tensor    # (S,) int32
    active: torch.Tensor    # (S,) bool — False for padding rows


def intersect(group: SphereGroup, ray, t_min, t_max, need_uv: bool = True) -> Hit:
    """Closest sphere hit per ray."""
    o, d = ray.origin, ray.direction
    t_best, idx = sphere_min_t(
        (o.x, o.y, o.z), (d.x, d.y, d.z),
        (group.center.x, group.center.y, group.center.z),
        group.radius * group.radius, group.active, t_min, t_max)
    valid = t_best < BIG
    idx = idx.long()
    center = group.center[idx]
    radius = group.radius[idx]
    mat_id = group.mat_id[idx]

    p = o + d * t_best
    geom_n = (p - center) * (1.0 / torch.where(valid, radius, torch.ones_like(radius)))
    if need_uv:  # only image textures read sphere uv
        u, v = sphere_uv(p - center)
    else:
        u = torch.zeros_like(t_best)
        v = u
    return hitlib.finalize(d, t_best, geom_n, u, v, mat_id, valid)


def sphere_uv(offset: Vec3):
    """Spherical uv of a point relative to the center (sphere.rs:64-71)."""
    p = offset.unit()
    phi = torch.atan2(-p.z, p.x)
    theta = torch.asin(torch.clamp(p.y, -1.0, 1.0))
    return phi / (2.0 * PI) + 0.5, theta / PI + 0.5
