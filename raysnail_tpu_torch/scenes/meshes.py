"""Procedural meshes for tests and benchmarks (the reference's OBJ demo uses
an external dragon.obj not shipped with the repo, preview_sdl2.rs:452-525; we
generate comparable triangle loads procedurally)."""

from __future__ import annotations

import numpy as np


def uv_sphere(n_lat: int = 32, n_lon: int = 64, radius: float = 1.0,
              center=(0.0, 0.0, 0.0)):
    """-> (vertices (V,3), faces (F,3), normals (V,3))."""
    lats = np.linspace(0.0, np.pi, n_lat + 1)
    lons = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    verts, norms = [], []
    for th in lats:
        for ph in lons:
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)])
            norms.append(n)
            verts.append(center + radius * n)
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    return (np.asarray(verts, np.float64), np.asarray(faces, np.int32),
            np.asarray(norms, np.float64))


def torus_knot(p: int = 2, q: int = 3, n_seg: int = 400, n_ring: int = 32,
               radius: float = 1.0, tube: float = 0.25, center=(0.0, 0.0, 0.0)):
    """Trefoil-style (p,q) torus knot tube; ~n_seg*n_ring*2 triangles."""
    t = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    r = radius * (2 + np.cos(q * t)) * 0.5
    cx = r * np.cos(p * t)
    cy = radius * 0.5 * np.sin(q * t)
    cz = r * np.sin(p * t)
    curve = np.stack([cx, cy, cz], -1)
    # frames along the curve
    tang = np.roll(curve, -1, 0) - np.roll(curve, 1, 0)
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    up = np.array([0.0, 1.0, 0.0])
    side = np.cross(tang, up)
    side /= np.maximum(np.linalg.norm(side, axis=1, keepdims=True), 1e-9)
    up2 = np.cross(side, tang)

    phis = np.linspace(0, 2 * np.pi, n_ring, endpoint=False)
    verts, norms = [], []
    for i in range(n_seg):
        for ph in phis:
            n = np.cos(ph) * side[i] + np.sin(ph) * up2[i]
            verts.append(curve[i] + tube * n + np.asarray(center))
            norms.append(n)
    faces = []
    for i in range(n_seg):
        for j in range(n_ring):
            a = i * n_ring + j
            b = i * n_ring + (j + 1) % n_ring
            c = ((i + 1) % n_seg) * n_ring + j
            d = ((i + 1) % n_seg) * n_ring + (j + 1) % n_ring
            faces.append([a, b, c])
            faces.append([b, d, c])
    return (np.asarray(verts, np.float64), np.asarray(faces, np.int32),
            np.asarray(norms, np.float64))
