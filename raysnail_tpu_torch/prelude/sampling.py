"""Analytic direction samplers and orthonormal bases.

Closed-form inverse-CDF transforms in place of the reference's rejection
loops (vec3.rs:69-147, sphere.rs:149-164), vectorized over the ray batch.
Local samplers return directions in a z-up frame; `Onb.local` rotates them
into the surface frame (reference src/prelude/onb.rs).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude.vec import Vec3

PI = math.pi
INV_PI = 1.0 / math.pi


class Onb(NamedTuple):
    """Orthonormal basis (u, v, w) with w the 'normal' axis."""

    u: Vec3
    v: Vec3
    w: Vec3

    def local(self, a: Vec3) -> Vec3:
        """Rotate local z-up vector a into this frame (onb.rs:11-23)."""
        return self.u * a.x + self.v * a.y + self.w * a.z


def onb_from_w(n: Vec3) -> Onb:
    """ONB about n (onb.rs:25-41): u = normalize(up x w) with up=(0,1,0),
    falling back to normalize((1,0,0) x w) when w is (anti)parallel to up."""
    w = n.unit()
    zero = torch.zeros_like(w.x)
    one = torch.ones_like(w.x)
    up = Vec3(zero, one, zero)
    ux = Vec3(one, zero, zero)
    uc = up.cross(w)
    degenerate = uc.length_squared() < 1e-8
    u = Vec3.where(degenerate, ux.cross(w).unit(), uc.unit())
    v = w.cross(u)
    return Onb(u, v, w)


# -- closed-form samplers (local z-up frame) -------------------------------

def cosine_direction(u1, u2) -> Vec3:
    """cos-weighted hemisphere direction, pdf = cos(theta)/pi
    (reference vec3.rs:100-111)."""
    q2 = torch.sqrt(u2)
    phi = 2.0 * PI * u1
    return Vec3(torch.cos(phi) * q2, torch.sin(phi) * q2, torch.sqrt(1.0 - u2))


def cosine_power_direction(exponent, u1, u2) -> Vec3:
    """cos^e-lobe direction about +z (reference vec3.rs:114-126):
    cos(theta) = u2^(1/(e+1))."""
    z = torch.pow(u2, 1.0 / (exponent + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u1
    return Vec3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, z)


def unit_sphere_direction(u1, u2) -> Vec3:
    """Uniform direction on S^2 (reference random_unit, vec3.rs:91-96)."""
    a = 2.0 * PI * u1
    z = 2.0 * u2 - 1.0
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return Vec3(r * torch.cos(a), r * torch.sin(a), z)


def unit_disk(u1, u2):
    """Uniform point in the unit disk (polar transform for vec3.rs:140-147)."""
    r = torch.sqrt(u1)
    theta = 2.0 * PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def quarter_disk(u1, u2):
    """Uniform point in the first-quadrant quarter of the unit disk, what the
    reference's sphere light sampler draws (sphere.rs:149-164)."""
    r = torch.sqrt(u1)
    theta = 0.5 * PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)

