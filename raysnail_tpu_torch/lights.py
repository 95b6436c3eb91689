"""Light-source direction sampling (the reference's `HittableList::random`
light list, src/hittable/collection/list.rs:49-52, plus per-shape
`random`).

The reference picks a uniform random light, then asks it for a direction:
  * Sphere (sphere.rs:149-164): ONB toward the center, a point in the UNIT
    quarter disk offset from the center, direction = (offset + center) -
    origin. Radius is ignored.
  * XZ Rect (rect.rs:141-153): uniform point on the rect, with the
    evidently-intended `root - origin` direction (the reference returns
    `origin - root`, a dead code path; PARITY.md).

The caller normalizes (camera.rs:199-201 calls .unit()).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude import sampling
from raysnail_tpu_torch.prelude.vec import Vec3, div_const

SPHERE = 0
RECT_XZ = 1


class LightArrays(NamedTuple):
    kind: torch.Tensor    # (L,) int32
    center: Vec3          # (L,) sphere center (unused for rects)
    radius: torch.Tensor  # (L,) sphere radius (the compat sampler ignores it)
    k: torch.Tensor       # (L,) rect plane y
    a0: torch.Tensor      # (L,) rect x bounds
    a1: torch.Tensor
    b0: torch.Tensor      # (L,) rect z bounds
    b1: torch.Tensor


def _pick(lights: LightArrays, u_pick):
    n_lights = lights.kind.shape[0]
    idx = torch.clamp_max((u_pick * n_lights).to(torch.int64), n_lights - 1)
    return idx, lights.kind[idx], lights.center[idx]


def _rect_dir(lights: LightArrays, idx, origin: Vec3, u1, u2) -> Vec3:
    rx = lights.a0[idx] + u1 * (lights.a1[idx] - lights.a0[idx])
    rz = lights.b0[idx] + u2 * (lights.b1[idx] - lights.b0[idx])
    return Vec3(rx, lights.k[idx], rz) - origin


def sample(lights: LightArrays, origin: Vec3, u_pick, u1, u2, kinds: frozenset) -> Vec3:
    """Unnormalized direction toward a uniformly-chosen light."""
    idx, kind, center = _pick(lights, u_pick)
    direction = center - origin  # base case; exact for a point at the center
    if SPHERE in kinds:
        onb = sampling.onb_from_w(direction)
        du, dv = sampling.quarter_disk(u1, u2)
        offset = onb.u * du + onb.v * dv
        direction = Vec3.where(kind == SPHERE, (offset + center) - origin, direction)
    if RECT_XZ in kinds:
        direction = Vec3.where(kind == RECT_XZ, _rect_dir(lights, idx, origin, u1, u2),
                               direction)
    return direction


# -- proper one-sample MIS support (cfg.proper_mis) -------------------------
# The reference has no correct light pdf (HittablePdf.value falls back to a
# cosine, pdf.rs:254-263). These are the solid-angle samplers and densities
# of the proper-MIS estimator.

def _cos_max(r, dist2):
    return torch.sqrt(torch.clamp_min(1.0 - r * r / torch.clamp_min(dist2, 1e-12), 0.0))


def sample_proper(lights: LightArrays, origin: Vec3, u_pick, u1, u2,
                  kinds: frozenset) -> Vec3:
    """Solid-angle-uniform cone sampling for sphere lights; area sampling for
    rects (same as compat). Returns an unnormalized direction."""
    idx, kind, center = _pick(lights, u_pick)
    direction = center - origin
    if SPHERE in kinds:
        to_c = center - origin
        cos_max = _cos_max(lights.radius[idx], to_c.length_squared())
        cos_t = 1.0 - u1 * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        phi = 2.0 * math.pi * u2
        onb = sampling.onb_from_w(to_c)
        cone = onb.local(Vec3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t))
        direction = Vec3.where(kind == SPHERE, cone, direction)
    if RECT_XZ in kinds:
        direction = Vec3.where(kind == RECT_XZ, _rect_dir(lights, idx, origin, u1, u2),
                               direction)
    return direction


def pdf_value(lights: LightArrays, origin: Vec3, direction: Vec3, kinds: frozenset):
    """Solid-angle pdf of sample_proper's uniform-over-lights mixture,
    evaluated at a (unit) direction."""
    n_lights = lights.kind.shape[0]
    total = torch.zeros_like(direction.x)
    zero = torch.zeros_like(total)
    for i in range(n_lights):
        p_i = zero
        if SPHERE in kinds:
            to_c = lights.center[i] - origin
            cos_max = _cos_max(lights.radius[i], to_c.length_squared())
            solid = 2.0 * math.pi * (1.0 - cos_max)
            inside = direction.dot(to_c.unit()) >= cos_max
            p_sph = torch.where(inside, 1.0 / torch.clamp_min(solid, 1e-8), zero)
            p_i = torch.where(lights.kind[i] == SPHERE, p_sph, p_i)
        if RECT_XZ in kinds:
            dy = direction.y
            dy_safe = torch.where(torch.abs(dy) < 1e-8, torch.full_like(dy, 1e-8), dy)
            t = (lights.k[i] - origin.y) / dy_safe
            hx = origin.x + t * direction.x
            hz = origin.z + t * direction.z
            on_rect = ((t > 1e-3) & (hx >= lights.a0[i]) & (hx <= lights.a1[i])
                       & (hz >= lights.b0[i]) & (hz <= lights.b1[i]))
            area = (lights.a1[i] - lights.a0[i]) * (lights.b1[i] - lights.b0[i])
            p_rect = torch.where(on_rect, t * t / torch.clamp_min(torch.abs(dy) * area, 1e-8),
                                 zero)
            p_i = torch.where(lights.kind[i] == RECT_XZ, p_rect, p_i)
        total = total + p_i
    return div_const(total, n_lights)
