"""Batched hit records and their combination.

A Hit is a batch of the reference's HitRecord (src/hittable/hit.rs:11-52)
in SoA form; `t` is the surface hit distance with misses encoded as BIG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude.vec import Vec3

# Miss sentinel: large but finite so arithmetic never produces NaN.
BIG = 1e30


class Hit(NamedTuple):
    t: torch.Tensor        # distance along ray to surface hit; BIG if miss
    valid: torch.Tensor    # bool
    normal: Vec3           # unit geometric normal, flipped to face the ray
    u: torch.Tensor
    v: torch.Tensor
    mat_id: torch.Tensor   # int32 index into the material table; -1 = world default
    outside: torch.Tensor  # True if the geometric normal faced the ray (hit.rs:36-40)


def miss(shape, dtype=torch.float32, device=None) -> Hit:
    zero = torch.zeros(shape, dtype=dtype, device=device)
    return Hit(
        t=torch.full(shape, BIG, dtype=dtype, device=device),
        valid=torch.zeros(shape, dtype=torch.bool, device=device),
        normal=Vec3(zero, zero, torch.ones(shape, dtype=dtype, device=device)),
        u=zero,
        v=zero,
        mat_id=torch.full(shape, -1, dtype=torch.int32, device=device),
        outside=torch.ones(shape, dtype=torch.bool, device=device),
    )


def finalize(ray_dir: Vec3, t, geom_normal: Vec3, u, v, mat_id, valid) -> Hit:
    """Flip the geometric normal against the ray and set the outside flag
    (hit.rs:32-52)."""
    outside = ray_dir.dot(geom_normal) < 0.0
    normal = Vec3.where(outside, geom_normal, -geom_normal)
    t = torch.where(valid, t, torch.full_like(t, BIG))
    return Hit(t=t, valid=valid, normal=normal, u=u, v=v,
               mat_id=mat_id.to(torch.int32), outside=outside)


def combine_hits(a: Hit, b: Hit) -> Hit:
    """Keep the nearer of two candidate hits (misses have t=BIG)."""
    take_b = b.t < a.t
    return Hit(
        t=torch.where(take_b, b.t, a.t),
        valid=torch.where(take_b, b.valid, a.valid),
        normal=Vec3.where(take_b, b.normal, a.normal),
        u=torch.where(take_b, b.u, a.u),
        v=torch.where(take_b, b.v, a.v),
        mat_id=torch.where(take_b, b.mat_id, a.mat_id),
        outside=torch.where(take_b, b.outside, a.outside),
    )
