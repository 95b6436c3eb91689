"""Ray-sphere intersection over a SoA sphere group.

The reference's half-b quadratic with the t1-else-t2 in-range rule
(src/hittable/geometry/sphere.rs:83-109) and spherical uv
(sphere.rs:64-71). The dense (rays x spheres) sweep with its min-t and
first-index argmin is one call of `ops.sphere_min_t`, which runs the CUDA
kernel on the card; the winner's center, radius and material are then
gathered by index.

Groups of 64 or more spheres also carry a packed BVH; with `use_bvh` they
go through the BVH traversal kernel (`ops.bvh_traverse` kind "sphere"),
which returns the winner's center, radius and material itself.

With `moving`, centers move by speed * ray.time: the sweep is the kernel's
moving form, and the winner's center is moved the same way. Scene compile
leaves a moving group without a packed BVH, as the JAX package does.

Gradients: where grad mode is on and a ray or group tensor requires grad,
the sweep goes through `ops.sphere_min_t.SphereMinT`, whose backward is
the kernel K1b on the card, so t stays attached to the rays' origins and
directions (the material parameters' pathwise gradients flow through the
hit points). The BVH route is detached, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.ops.bvh_traverse import bvh_traverse, lane_caps
from raysnail_tpu_torch.ops.sphere_min_t import SphereMinT, sphere_min_t
from raysnail_tpu_torch.prelude.sampling import PI
from raysnail_tpu_torch.prelude.vec import Vec3, div_const


class SphereGroup(NamedTuple):
    center: Vec3            # (S,)
    radius: torch.Tensor    # (S,)
    mat_id: torch.Tensor    # (S,) int32
    active: torch.Tensor    # (S,) bool — False for padding rows
    speed: Vec3 | None = None  # (S,) motion-blur velocity; None reads as zero
    # packed BVH for the traversal kernel (groups of >= 64 spheres)
    pk_bb: torch.Tensor | None = None     # (K, M, 8) f32
    pk_links: torch.Tensor | None = None  # (K, M, 4) i32
    pk_sph: torch.Tensor | None = None    # (B, 8, 128) f32
    pk_cbb: torch.Tensor | None = None     # (K, 64, 8) f32 coarse cut (two-level walk)
    pk_crange: torch.Tensor | None = None  # (K, 64, 4) i32 [start, end) node ranges


def pair_t(group: SphereGroup, origin: Vec3, direction: Vec3, time, t_min, t_max,
           moving: bool):
    """Surface-hit t for every (ray, sphere) pair, in plain tensor code (the
    JAX package's function of this name; `intersect` goes through
    `ops.sphere_min_t` instead). origin and direction components are (N, 1),
    group components (S,) read as (1, S); -> (N, S). Directions must be
    unit."""
    cx, cy, cz = group.center.x, group.center.y, group.center.z
    if moving:
        cx = cx + group.speed.x * time
        cy = cy + group.speed.y * time
        cz = cz + group.speed.z * time
    lx = origin.x - cx
    ly = origin.y - cy
    lz = origin.z - cz
    half_b = direction.x * lx + direction.y * ly + direction.z * lz
    c = lx * lx + ly * ly + lz * lz - group.radius * group.radius
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    ok = (delta > 0.0) & group.active
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    return torch.where(in1, t1, torch.where(in2, t2, torch.full_like(t1, BIG)))


def intersect(group: SphereGroup, ray, t_min, t_max, need_uv: bool = True,
              use_bvh: bool = False, active=None, packet: bool | None = None,
              moving: bool = False) -> Hit:
    """Closest sphere hit per ray. use_bvh takes the BVH kernel route when
    the group has a packed BVH; `active` (the integrator's alive mask) then
    keeps dead lanes from admitting nodes, and `packet` is bvh_traverse's
    argument of that name. moving: centers move by speed * ray.time."""
    o, d = ray.origin, ray.direction
    if use_bvh and group.pk_bb is not None:
        return _intersect_bvh(group, ray, t_min, t_max, need_uv, active, packet)
    speed = (group.speed.x, group.speed.y, group.speed.z) if moving else (None,) * 3
    time = ray.time.contiguous() if moving else None
    center = (group.center.x, group.center.y, group.center.z)
    r2 = group.radius * group.radius
    tensors = (o.x, o.y, o.z, d.x, d.y, d.z, *center, r2, *speed, time)
    if torch.is_grad_enabled() and any(a is not None and a.requires_grad for a in tensors):
        t_best, idx = SphereMinT.apply(o.x, o.y, o.z, d.x, d.y, d.z, *center, r2, group.active,
                                       t_min, t_max, *speed, time)
    else:
        motion = dict(speed_xyz=speed, time=time) if moving else {}
        t_best, idx = sphere_min_t((o.x, o.y, o.z), (d.x, d.y, d.z), center, r2, group.active,
                                   t_min, t_max, **motion)
    valid = t_best < BIG
    idx = idx.long()
    center = group.center[idx]
    if moving:
        center = center + group.speed[idx] * ray.time
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


def _intersect_bvh(group: SphereGroup, ray, t_min, t_max, need_uv: bool, active,
                   packet=None) -> Hit:
    o, d = ray.origin, ray.direction
    cap = lane_caps(d.x, active=active)
    # detached, as the JAX package stops the kernel's gradient
    t, cx, cy, cz, r, mat = (a.detach() for a in bvh_traverse(
        (o.x, o.y, o.z), (d.x, d.y, d.z), cap, group.pk_bb, group.pk_links, group.pk_sph,
        t_min, t_max, kind="sphere", cbb=group.pk_cbb, crange=group.pk_crange,
        packet=packet))
    valid = t < BIG * 0.5
    center = Vec3(cx, cy, cz)
    p = o + d * t
    geom_n = (p - center) * (1.0 / torch.where(valid, r, torch.ones_like(r)))
    if need_uv:
        u, v = sphere_uv(p - center)
    else:
        u = torch.zeros_like(t)
        v = u
    return hitlib.finalize(d, t, geom_n, u, v, torch.where(valid, mat, torch.full_like(mat, -1)),
                           valid)


def sphere_uv(offset: Vec3):
    """Spherical uv of a point relative to the center (sphere.rs:64-71).
    The divisions take a tensor divisor (`prelude.vec.div_const`)."""
    p = offset.unit()
    phi = torch.atan2(-p.z, p.x)
    theta = torch.asin(torch.clamp(p.y, -1.0, 1.0))
    return div_const(phi, 2.0 * PI) + 0.5, div_const(theta, PI) + 0.5


# -- CSG and media support (one sphere, scalar params broadcast over rays) ----

def interval(center: Vec3, radius, ray, t_min, t_max):
    """(t1, t2, valid) of one sphere per ray (sphere.rs:83-109): (t1, t2)
    when the near root is in range, (t2, t2) when only the far one is; the
    lanes that miss keep the far root in both."""
    l = ray.origin - center
    half_b = ray.direction.dot(l)
    c = l.length_squared() - radius * radius
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    ok = delta > 0.0
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    return torch.where(in1, t1, t2), t2, in1 | in2


def contains(center: Vec3, radius, p: Vec3):
    """sphere.rs:111-116 (strict)."""
    return (center - p).length_squared() < radius * radius


def normal_at(center: Vec3, radius, p: Vec3) -> Vec3:
    return (p - center) * (1.0 / radius)
