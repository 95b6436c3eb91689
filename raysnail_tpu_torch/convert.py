"""Carry compiled scene data and cameras over from the JAX package.

The caller turns the JAX package's pytrees into numpy first (for example
`jax.tree_util.tree_map(np.asarray, scene.arrays)`); these functions then
build the port's NamedTuples field by field, by name, so both packages can
render identical scene data. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.geometry import boxes, spheres, triangles
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.scene import Background, SceneArrays

# SceneArrays fields of the JAX package that this port does not carry yet
_NOT_PORTED = ("rects", "quadrics")


def _leaf(x, device):
    if x is None:
        return None
    if hasattr(x, "x") and hasattr(x, "y") and hasattr(x, "z"):
        return Vec3(*(_leaf(c, device) for c in (x.x, x.y, x.z)))
    if isinstance(x, tuple):  # e.g. oriented boxes' inv_rows
        return tuple(_leaf(c, device) for c in x)
    return torch.as_tensor(np.array(x), device=device)  # a writable copy


def _by_name(cls, src, device):
    """Build NamedTuple `cls` from the same-named attributes of `src`."""
    if src is None:
        return None
    return cls(**{f: _leaf(getattr(src, f), device) for f in cls._fields})


def scene_arrays_from_numpy(arrays, device) -> SceneArrays:
    """The JAX package's compiled SceneArrays (numpy leaves) -> the port's."""
    for name in _NOT_PORTED:
        if getattr(arrays, name, None) is not None:
            raise NotImplementedError(f"scene arrays hold {name}: not ported yet")
    if arrays.spheres is not None and np.any(np.asarray(arrays.spheres.speed.x) != 0):
        raise NotImplementedError("moving spheres are not ported yet")
    if arrays.textures.atlas is not None or arrays.textures.perlin_seed is not None:
        raise NotImplementedError("image and Perlin textures are not ported yet")
    return SceneArrays(
        spheres=_by_name(spheres.SphereGroup, arrays.spheres, device),
        boxes=_by_name(boxes.BoxGroup, arrays.boxes, device),
        triangles=_by_name(triangles.TriangleGroup, arrays.triangles, device),
        materials=_by_name(matlib.MaterialTable, arrays.materials, device),
        textures=_by_name(texlib.TextureTable, arrays.textures, device),
        lights=_by_name(lightslib.LightArrays, arrays.lights, device),
        background=_by_name(Background, arrays.background, device),
    )


def camera_from_numpy(camera, device) -> Camera:
    """The JAX package's Camera (numpy leaves) -> the port's."""
    return _by_name(Camera, camera, device)
