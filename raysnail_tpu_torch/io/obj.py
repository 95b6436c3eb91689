"""Wavefront OBJ loader (reference: triangle_mesh.rs:166-276 via the `tobj`
crate with triangulate + single_index).

Supports v/vn/f records with v, v//vn, v/vt/vn face forms; polygons are
fan-triangulated. When the file has no normals, per-vertex normals are
computed by accumulating (area-weighted) face normals and normalizing
(triangle_mesh.rs:223-230, 241-268). Bake-in scale/offset/axis-rotation
mirrors the reference's load-time transform (triangle_mesh.rs:219-237).
"""

from __future__ import annotations

import math

import numpy as np


def load_obj(path: str):
    """-> (vertices (V,3) f64, faces (F,3) i32, normals (V,3) f64 or None)."""
    verts: list = []
    norms: list = []
    faces: list = []
    face_norm_ids: list = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                refs = [_parse_ref(p, len(verts), len(norms)) for p in parts[1:]]
                for i in range(1, len(refs) - 1):  # fan triangulation
                    tri = (refs[0], refs[i], refs[i + 1])
                    faces.append([r[0] for r in tri])
                    face_norm_ids.append([r[1] for r in tri])

    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int32)
    if norms and all(n is not None for tri in face_norm_ids for n in tri):
        # re-index so vertex i carries normal of its first reference
        n = np.zeros_like(v)
        seen = np.zeros(len(v), bool)
        norms_np = np.asarray(norms, np.float64)
        for tri, nids in zip(faces, face_norm_ids):
            for vi, ni in zip(tri, nids):
                if not seen[vi]:
                    n[vi] = norms_np[ni]
                    seen[vi] = True
        return v, f, n
    return v, f, None


def _parse_ref(token: str, n_verts: int, n_norms: int):
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' -> (vertex_idx, normal_idx|None).
    Negative indices are relative (OBJ spec)."""
    parts = token.split("/")
    vi = int(parts[0])
    vi = vi - 1 if vi > 0 else n_verts + vi
    ni = None
    if len(parts) == 3 and parts[2]:
        ni = int(parts[2])
        ni = ni - 1 if ni > 0 else n_norms + ni
    return vi, ni


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted accumulation of face normals (triangle_mesh.rs:241-268)."""
    n = np.zeros_like(vertices)
    p0 = vertices[faces[:, 0]]
    p1 = vertices[faces[:, 1]]
    p2 = vertices[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)  # magnitude = 2x area
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    lens = np.linalg.norm(n, axis=1, keepdims=True)
    lens[lens < 1e-20] = 1.0
    return n / lens


def bake_transform(vertices: np.ndarray, normals, scale=1.0, offset=(0, 0, 0),
                   rotate_deg: float = 0.0, axis: int = 1):
    """Load-time scale/offset/axis-rotation (triangle_mesh.rs:219-237)."""
    v = vertices * float(scale)
    if rotate_deg:
        th = math.radians(rotate_deg)
        c, s = math.cos(th), math.sin(th)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        r = np.eye(3)
        r[i, i], r[i, j], r[j, i], r[j, j] = c, s, -s, c
        v = v @ r.T
        if normals is not None:
            normals = normals @ r.T
    v = v + np.asarray(offset, np.float64)
    return v, normals
