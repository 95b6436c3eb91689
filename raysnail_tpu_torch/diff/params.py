"""Differentiable parameter views over SceneArrays.

The gradient targets are the continuous material and emitter knobs (albedo
colors, the DiffuseMetal fuzz exponent, the dielectric IOR, the BlinnPhong
lobe, the emitter intensity), as in the JAX package's `diff/params.py`;
geometry gradients (silhouettes) are out of scope. SceneParams is the set
of tensors the gradient step differentiates; inject_params writes it back
into a SceneArrays for rendering.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.scene import SceneArrays


class SceneParams(NamedTuple):
    tex_color1: Vec3            # constant/checker-odd colors per texture row
    tex_color2: Vec3            # checker-even colors
    mat_param0: torch.Tensor    # fuzz exponent | ior | k_specular
    mat_param1: torch.Tensor    # BlinnPhong exponent (also dielectric schlick flag)
    emit_mult: torch.Tensor     # DiffuseLight multipliers
    phong_factor: torch.Tensor


def leaves(p: SceneParams) -> list:
    """The ten tensors of `p` in field order, a Vec3 as x, y, z (the JAX
    package's pytree order)."""
    out = []
    for v in p:
        out.extend(v if isinstance(v, Vec3) else (v,))
    return out


def from_leaves(xs) -> SceneParams:
    """`leaves`' inverse."""
    xs = list(xs)
    return SceneParams(Vec3(*xs[0:3]), Vec3(*xs[3:6]), *xs[6:10])


def extract_params(arrays: SceneArrays) -> SceneParams:
    """Fresh leaf tensors (copies, requires_grad=True) of the scene's
    parameters."""
    t, m = arrays.textures, arrays.materials
    return from_leaves(a.detach().clone().requires_grad_(True) for a in leaves(SceneParams(
        t.color1, t.color2, m.param0, m.param1, m.emit_mult, m.phong_factor)))


def inject_params(arrays: SceneArrays, p: SceneParams) -> SceneArrays:
    return arrays._replace(
        textures=arrays.textures._replace(color1=p.tex_color1, color2=p.tex_color2),
        materials=arrays.materials._replace(
            param0=p.mat_param0, param1=p.mat_param1, emit_mult=p.emit_mult,
            phong_factor=p.phong_factor,
        ),
    )
