"""Carry compiled scene data and cameras over from the JAX package.

The caller turns the JAX package's pytrees into numpy first (for example
`jax.tree_util.tree_map(np.asarray, scene.arrays)`); these functions then
build the port's NamedTuples field by field, by name, so both packages can
render identical scene data: the compiled arrays, the CSG trees and the
media (nodes matched by class name), and the gradient step's state: the
scene parameters and optax's Adam state. Nothing here imports JAX.
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


_PARAM_FIELDS = ("tex_color1", "tex_color2", "mat_param0", "mat_param1", "emit_mult",
                 "phong_factor")


def _param_leaves(p) -> list:
    """A SceneParams-shaped object's ten leaves in `diff.params.leaves`
    order, read by field name."""
    out = []
    for f in _PARAM_FIELDS:
        v = getattr(p, f)
        out.extend((v.x, v.y, v.z) if hasattr(v, "x") else (v,))
    return out


def scene_params_from_numpy(params, device):
    """The JAX package's SceneParams (numpy leaves) -> the port's, as fresh
    leaf tensors with requires_grad=True (as `diff.extract_params`)."""
    from raysnail_tpu_torch.diff.params import from_leaves

    return from_leaves(torch.as_tensor(np.array(a), device=device).requires_grad_(True)
                       for a in _param_leaves(params))


def adam_state_from_numpy(optax_state, params) -> dict:
    """optax's Adam state (numpy leaves: `ScaleByAdamState` with count, mu
    and nu, or the chain tuple that holds it) -> the port's optimizer state
    for `diff.make_train_step`: per leaf of `params` (the port's
    SceneParams), torch.optim.Adam's step, exp_avg and exp_avg_sq. A port
    step then continues the JAX run."""
    from raysnail_tpu_torch.diff.params import leaves

    if not hasattr(optax_state, "mu"):
        optax_state = next(s for s in optax_state if hasattr(s, "mu"))
    count = float(np.asarray(optax_state.count))
    mine = leaves(params)
    mu, nu = _param_leaves(optax_state.mu), _param_leaves(optax_state.nu)
    return {i: {"step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.array(m), dtype=x.dtype, device=x.device),
                "exp_avg_sq": torch.as_tensor(np.array(v), dtype=x.dtype, device=x.device)}
            for i, (x, m, v) in enumerate(zip(mine, mu, nu))}
