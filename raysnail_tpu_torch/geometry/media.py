"""Constant-density participating media (reference:
src/hittable/medium/constant.rs), the JAX package's `geometry/media.py`.

A medium wraps a convex boundary leaf (a sphere or a box). Per ray: the
boundary's interval over the whole line (the entry may lie behind the
origin, constant.rs:46-47), clamped to [t_min, t_max], then an exponential
free path -ln(U) / density (constant.rs:60-68). A scatter inside the
interval is a hit with the medium's Isotropic material, the dummy normal
(1, 0, 0) and outside = false (constant.rs:69-79). The draw makes the hit
stochastic: the scene's intersect hands each medium one uniform per ray.
Plain PyTorch: no kernel stands behind it (XLA fused it on the TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import boxes
from raysnail_tpu_torch.geometry.csg import BoxLeaf, SphereLeaf
from raysnail_tpu_torch.geometry.hit import BIG, Hit, combine_hits, miss
from raysnail_tpu_torch.prelude.vec import Vec3


class MediumNode(NamedTuple):
    boundary: object            # csg.SphereLeaf or csg.BoxLeaf
    neg_inv_density: torch.Tensor
    mat_id: int                 # the Isotropic material's row

    def hit(self, ray, t_min, t_max, u) -> Hit:
        t1, t2, valid = _raw_interval(self.boundary, ray)
        t1 = torch.clamp_min(t1, t_min)
        t2 = torch.clamp_max(t2, t_max)
        valid = valid & (t1 < t2)
        t1 = torch.clamp_min(t1, 0.0)

        distance_inside = t2 - t1  # unit directions
        hit_distance = self.neg_inv_density * torch.log(torch.clamp_min(u, 1e-12))
        scatters = valid & (hit_distance <= distance_inside) & (t1 + hit_distance > t_min)
        t = torch.where(scatters, t1 + hit_distance, torch.full_like(t1, BIG))
        zero = torch.zeros_like(t)
        return Hit(t=t, valid=scatters,
                   normal=Vec3(torch.ones_like(t), zero, zero), u=zero, v=zero,
                   mat_id=torch.full(t.shape, self.mat_id, dtype=torch.int32, device=t.device),
                   outside=torch.zeros_like(scatters))


def _raw_interval(leaf, ray):
    """The boundary's (t_entry, t_exit, valid) over the whole line, in the
    JAX package's arithmetic (c = |l|^2 - r^2 as written, also where it
    cancels, as for book 2's world fog of radius 5,000)."""
    if isinstance(leaf, SphereLeaf):
        l = ray.origin - leaf.center
        half_b = ray.direction.dot(l)
        c = l.length_squared() - leaf.radius * leaf.radius
        delta = half_b * half_b - c
        sq = torch.sqrt(torch.clamp_min(delta, 0.0))
        return -half_b - sq, -half_b + sq, delta > 0.0
    if isinstance(leaf, BoxLeaf):
        o, d = ray.origin, ray.direction
        if leaf.inv_rows is not None:
            o = boxes._apply_rows(leaf.inv_rows, leaf.inv_off, o, translate=True)
            d = boxes._apply_rows(leaf.inv_rows, leaf.inv_off, d, translate=False)
        t_near, t_far, _, _ = boxes.slab(leaf.p_min, leaf.p_max, o, d)
        return t_near, t_far, t_near < t_far
    raise TypeError(f"unsupported medium boundary: {type(leaf)}")


def intersect_media(media, ray, t_min, t_max, uniforms) -> Hit:
    """Closest scatter over the media, one uniform per (ray, medium), in
    order."""
    d = ray.direction
    best = miss(d.x.shape, d.x.dtype, d.x.device)
    for node, u in zip(media, uniforms):
        best = combine_hits(best, node.hit(ray, t_min, t_max, u))
    return best
