"""Carry compiled scene data and cameras over from the JAX package.

The caller turns the JAX package's pytrees into numpy first (for example
`jax.tree_util.tree_map(np.asarray, scene.arrays)`); these functions then
build the port's NamedTuples field by field, by name, so both packages can
render identical scene data: the compiled arrays, the CSG trees and the
media (nodes matched by class name). Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.geometry import boxes, csg, quadrics, rects, spheres, triangles
from raysnail_tpu_torch.geometry import media as medialib
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.scene import Background, SceneArrays


def _leaf(x, device):
    if x is None:
        return None
    if hasattr(x, "x") and hasattr(x, "y") and hasattr(x, "z"):
        return Vec3(*(_leaf(c, device) for c in (x.x, x.y, x.z)))
    if isinstance(x, tuple):  # e.g. oriented boxes' inv_rows
        return tuple(_leaf(c, device) for c in x)
    x = np.array(x)  # a writable copy
    if x.dtype == np.uint32:  # Perlin seeds: uint32 values held in int64, as prelude.rng
        x = x.astype(np.int64)
    return torch.as_tensor(x, device=device)


def _by_name(cls, src, device):
    """Build NamedTuple `cls` from the same-named attributes of `src`."""
    if src is None:
        return None
    return cls(**{f: _leaf(getattr(src, f), device) for f in cls._fields})


def scene_arrays_from_numpy(arrays, device) -> SceneArrays:
    """The JAX package's compiled SceneArrays (numpy leaves) -> the port's."""
    return SceneArrays(
        spheres=_by_name(spheres.SphereGroup, arrays.spheres, device),
        boxes=_by_name(boxes.BoxGroup, arrays.boxes, device),
        rects=_by_name(rects.RectGroup, arrays.rects, device),
        quadrics=_by_name(quadrics.QuadricGroup, arrays.quadrics, device),
        triangles=_by_name(triangles.TriangleGroup, arrays.triangles, device),
        materials=_by_name(matlib.MaterialTable, arrays.materials, device),
        textures=_by_name(texlib.TextureTable, arrays.textures, device),
        lights=_by_name(lightslib.LightArrays, arrays.lights, device),
        background=_by_name(Background, arrays.background, device),
    )


def camera_from_numpy(camera, device) -> Camera:
    """The JAX package's Camera (numpy leaves) -> the port's."""
    return _by_name(Camera, camera, device)


# the node classes of CSG trees and media, matched by class name
_NODES = {c.__name__: c for c in (csg.SphereLeaf, csg.BoxLeaf, csg.RectLeaf, csg.MeshLeaf,
                                  csg.QuadricLeaf, csg.IntersectionNode, csg.DifferenceNode,
                                  medialib.MediumNode, quadrics.Coeffs,
                                  triangles.TriangleGroup)}
# the nodes' fields that the port keeps as Python values (0-d numpy arrays
# after a tree_map); a triangle group's mat_id is an array
_INT_FIELDS, _BOOL_FIELDS = ("mat_id", "minus_mat_id", "k_axis"), ("brute",)


def _node(x, device):
    cls = _NODES.get(type(x).__name__)
    if cls is None:
        return _leaf(x, device)
    fields = {}
    for f in cls._fields:
        v = getattr(x, f)
        if f in _INT_FIELDS and np.ndim(v) == 0:
            fields[f] = int(v)
        elif f in _BOOL_FIELDS:
            fields[f] = bool(v)
        else:
            fields[f] = _node(v, device)
    return cls(**fields)


def csg_trees_from_numpy(trees, device) -> tuple:
    """The JAX package's compiled `Scene.csg_trees` (numpy leaves) -> the
    port's trees."""
    return tuple(_node(t, device) for t in trees)


def media_from_numpy(media, device) -> tuple:
    """The JAX package's compiled `Scene.media` (numpy leaves) -> the port's
    MediumNodes."""
    return tuple(_node(m, device) for m in media)
