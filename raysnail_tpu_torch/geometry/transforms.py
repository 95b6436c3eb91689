"""Host-side affine transform stacks and compile-time lowering.

The reference wraps objects in a TfFacade that inverse-transforms every ray at
render time (src/hittable/transform/tf_facade.rs). TPU-first, transforms are
instead a *scene-compile lowering pass* (numpy, float64):

  * sphere  + translate/uniform-scale  -> baked center/radius (still a sphere)
  * sphere  + general affine           -> ellipsoid, lowered to a quadric
  * quadric + affine                   -> conjugated coefficients Q' = M^-T Q M^-1
  * box     + rotate/affine            -> oriented box (per-prim inverse rows)
  * CSG     + affine                   -> transform pushed down to the leaves

so the hot loop sees no generic matrix facade at all. Normals come out of the
lowered representations exactly right — by construction for quadrics
(gradient), via inverse-transpose for oriented boxes — fixing the reference's
untransformed-normal quirk (tf_facade.rs:49-53).

Matrix conventions replicate src/hittable/transform/transform.rs:16-108
exactly (row-major, v' = M v, and the reference's rotation sign, which is the
transpose of the usual right-handed Rx/Ry/Rz — SDL scenes depend on it).
"""

from __future__ import annotations

import math

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(t) -> np.ndarray:
    m = identity()
    m[0, 3], m[1, 3], m[2, 3] = t
    return m


def scale(s) -> np.ndarray:
    if np.isscalar(s):
        s = (s, s, s)
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_x(theta: float) -> np.ndarray:
    """transform.rs:36-52 (note: their sin sign = transpose of standard Rx)."""
    s, c = math.sin(theta), math.cos(theta)
    m = identity()
    m[1, 1], m[1, 2] = c, s
    m[2, 1], m[2, 2] = -s, c
    return m


def rotate_y(theta: float) -> np.ndarray:
    s, c = math.sin(theta), math.cos(theta)
    m = identity()
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotate_z(theta: float) -> np.ndarray:
    s, c = math.sin(theta), math.cos(theta)
    m = identity()
    m[0, 0], m[0, 1] = c, s
    m[1, 0], m[1, 1] = -s, c
    return m


def compose(stack: list[np.ndarray]) -> np.ndarray:
    """Combined forward matrix of a TransformStack applied in push order
    (transform.rs:133-145): p' = M_n ... M_1 p."""
    m = identity()
    for t in stack:
        m = t @ m
    return m


def is_identity(m: np.ndarray, tol: float = 1e-12) -> bool:
    return bool(np.allclose(m, np.eye(4), atol=tol))


def is_translate_uniform_scale(m: np.ndarray, tol: float = 1e-12):
    """If m = translate+uniform scale, return (scale, offset); else None."""
    lin = m[:3, :3]
    diag = np.diag(lin)
    if not np.allclose(lin, np.diag(diag), atol=tol):
        return None
    if not (abs(diag[0] - diag[1]) < tol and abs(diag[1] - diag[2]) < tol):
        return None
    return float(diag[0]), m[:3, 3].copy()


def inverse_rows(m: np.ndarray):
    """(inv_rot rows (3,3), inv_off (3,)) of the world->object map."""
    inv = np.linalg.inv(m)
    return inv[:3, :3].copy(), inv[:3, 3].copy()


# -- quadric lowering ------------------------------------------------------

def quadric_matrix(coeffs) -> np.ndarray:
    """10 SDL coefficients (qa qb qc qd qe qf qg qh qi qj, quadric.rs:15-16)
    -> symmetric homogeneous 4x4 Q with x^T Q x = the hit polynomial."""
    qa, qb, qc, qd, qe, qf, qg, qh, qi, qj = coeffs
    # The reference's polynomial has SINGLE cross/linear terms
    # (qa x^2 + qb xy + qd x + ..., see quadric.rs:112-132 _abc and the
    # gradient at quadric.rs:67-100), so off-diagonal entries are halved.
    return np.array(
        [
            [qa, qb / 2, qc / 2, qd / 2],
            [qb / 2, qe, qf / 2, qg / 2],
            [qc / 2, qf / 2, qh, qi / 2],
            [qd / 2, qg / 2, qi / 2, qj],
        ],
        dtype=np.float64,
    )


def matrix_to_coeffs(Q: np.ndarray):
    """Inverse of quadric_matrix (assumes symmetric Q)."""
    return (
        Q[0, 0], 2 * Q[0, 1], 2 * Q[0, 2], 2 * Q[0, 3],
        Q[1, 1], 2 * Q[1, 2], 2 * Q[1, 3],
        Q[2, 2], 2 * Q[2, 3],
        Q[3, 3],
    )


def transform_quadric(coeffs, m: np.ndarray):
    """Bake an affine transform into quadric coefficients:
    Q' = M^-T Q M^-1 (exact; normals stay exact via the gradient)."""
    Q = quadric_matrix(coeffs)
    minv = np.linalg.inv(m)
    Qp = minv.T @ Q @ minv
    Qp = 0.5 * (Qp + Qp.T)
    return matrix_to_coeffs(Qp)


def sphere_to_quadric(center, radius):
    """|p - c|^2 - r^2 = 0 as quadric coefficients (single-linear-term
    convention: coefficient of x is -2 cx)."""
    cx, cy, cz = center
    return (
        1.0, 0.0, 0.0, -2.0 * cx,
        1.0, 0.0, -2.0 * cy,
        1.0, -2.0 * cz,
        cx * cx + cy * cy + cz * cz - radius * radius,
    )
