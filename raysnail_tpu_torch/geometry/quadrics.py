"""General-quadric intersection.

The reference's quadric surface
qa x^2 + qe y^2 + qh z^2 + qb xy + qc xz + qf yz + qd x + qg y + qi z + qj = 0
(single cross and linear terms, NOT the POV-Ray factor-2 convention) with
its exact quadratic / degenerate-linear solve and gradient normal
(src/hittable/geometry/quadric.rs:112-182, 67-100). Affine transforms on
quadrics (and on spheres, which lower to quadrics when scaled non-uniformly)
are baked into the 10 coefficients at scene compile by the conjugation
Q' = M^-T Q M^-1 (geometry/transforms.py), so the hot path needs no
per-primitive matrices and the normals are exact. The winner of the dense
(rays x quadrics) sweep is gathered by index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import BIG, Hit
from raysnail_tpu_torch.prelude.vec import Vec3


class QuadricGroup(NamedTuple):
    # coefficient columns, each (Q,)
    qa: torch.Tensor
    qb: torch.Tensor
    qc: torch.Tensor
    qd: torch.Tensor
    qe: torch.Tensor
    qf: torch.Tensor
    qg: torch.Tensor
    qh: torch.Tensor
    qi: torch.Tensor
    qj: torch.Tensor
    mat_id: torch.Tensor
    active: torch.Tensor


class Coeffs(NamedTuple):
    """Scalar coefficient bundle (CSG leaves)."""
    qa: torch.Tensor
    qb: torch.Tensor
    qc: torch.Tensor
    qd: torch.Tensor
    qe: torch.Tensor
    qf: torch.Tensor
    qg: torch.Tensor
    qh: torch.Tensor
    qi: torch.Tensor
    qj: torch.Tensor


def _abc(q, o: Vec3, d: Vec3):
    """Quadratic coefficients along the ray (quadric.rs:112-132); the
    reference's b is the half-b (factor 0.5 folded in)."""
    a = (d.x * (q.qa * d.x + q.qb * d.y + q.qc * d.z)
         + d.y * (q.qe * d.y + q.qf * d.z)
         + d.z * q.qh * d.z)
    b = (d.x * (q.qa * o.x + 0.5 * (q.qb * o.y + q.qc * o.z + q.qd))
         + d.y * (q.qe * o.y + 0.5 * (q.qb * o.x + q.qf * o.z + q.qg))
         + d.z * (q.qh * o.z + 0.5 * (q.qc * o.x + q.qf * o.y + q.qi)))
    c = (o.x * (q.qa * o.x + q.qb * o.y + q.qc * o.z + q.qd)
         + o.y * (q.qe * o.y + q.qf * o.z + q.qg)
         + o.z * (q.qh * o.z + q.qi)
         + q.qj)
    return a, b, c


def _roots(a, b, c, t_min, t_max, lin_eps):
    """Branch-free union of the quadratic and the degenerate-linear case ->
    (t1, t2, valid) with the reference's in-range selection: quadratic t1 if
    in range else (t2, BIG); linear (-c / 2b, BIG)."""
    big = torch.full_like(a, BIG)
    is_lin = torch.abs(a) <= lin_eps
    safe_a = torch.where(is_lin, torch.ones_like(a), a)

    disc = b * b - a * c
    has_q = (~is_lin) & (disc > 0.0)
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q1 = (-b - sq) / safe_a
    q2 = (-b + sq) / safe_a
    # a < 0 flips the ordering of the roots
    lo = torch.minimum(q1, q2)
    hi = torch.maximum(q1, q2)

    safe_b = torch.where(torch.abs(b) < 1e-30, torch.full_like(b, 1e-30), b)
    t_lin = -0.5 * c / safe_b
    lin_ok = is_lin & (torch.abs(b) > lin_eps) & (t_min < t_lin) & (t_lin < t_max)

    in1 = has_q & (t_min < lo) & (lo < t_max)
    in2 = has_q & (t_min < hi) & (hi < t_max)
    t1 = torch.where(in1, lo, torch.where(in2, hi, torch.where(lin_ok, t_lin, big)))
    t2 = torch.where(in1, hi, big)
    return t1, t2, in1 | in2 | lin_ok


def normal_at(q, p: Vec3) -> Vec3:
    """Gradient normal (quadric.rs:67-100), with the arbitrary-direction
    fallback where the gradient vanishes."""
    nx = 2.0 * q.qa * p.x + q.qb * p.y + q.qc * p.z + q.qd
    ny = q.qb * p.x + 2.0 * q.qe * p.y + q.qf * p.z + q.qg
    nz = q.qc * p.x + q.qf * p.y + 2.0 * q.qh * p.z + q.qi
    n = Vec3(nx, ny, nz)
    degenerate = n.length_squared() < 1e-24
    fallback = Vec3.full((1.0, 0.0, 0.0), nx.shape, nx.dtype, nx.device)
    return Vec3.where(degenerate, fallback, n.unit())


def intersect(group: QuadricGroup, ray, t_min, t_max, lin_eps: float = 1e-12) -> Hit:
    """Closest quadric hit per ray."""
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    gq = Coeffs(*(getattr(group, f)[None, :] for f in Coeffs._fields))
    a, b, c = _abc(gq, o, d)
    t1, _, valid = _roots(a, b, c, t_min, t_max, lin_eps)
    t = torch.where(valid & group.active[None, :], t1, torch.full_like(t1, BIG))

    idx = torch.argmin(t, dim=1, keepdim=True)  # first index of the minimum
    t_best = torch.gather(t, 1, idx)[:, 0]
    idx = idx[:, 0]
    ok = t_best < BIG

    sel = Coeffs(*(getattr(group, f)[idx] for f in Coeffs._fields))
    p = ray.origin + ray.direction * t_best
    geom_n = normal_at(sel, p)
    u = torch.zeros_like(t_best)  # quadric uv is (0, 0) (quadric.rs:106-110)
    return hitlib.finalize(ray.direction, t_best, geom_n, u, u, group.mat_id[idx], ok)


# -- CSG support -----------------------------------------------------------

def interval(q: Coeffs, ray, t_min, t_max, lin_eps: float = 1e-12):
    """(t1, t2, valid) of a single quadric per ray (quadric.rs:112-182; t2 =
    BIG when only the far root was in range or the case was linear)."""
    a, b, c = _abc(q, ray.origin, ray.direction)
    return _roots(a, b, c, t_min, t_max, lin_eps)


def contains(q: Coeffs, p: Vec3):
    """Implicit-function sign test (quadric.rs:184-189, <= 0 is inside): the
    same single-cross-term polynomial as the hit."""
    val = (p.x * (q.qa * p.x + q.qb * p.y + q.qd)
           + p.y * (q.qe * p.y + q.qf * p.z + q.qg)
           + p.z * (q.qh * p.z + q.qc * p.x + q.qi)
           + q.qj)
    return val <= 0.0
