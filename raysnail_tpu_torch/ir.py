"""Host-side scene IR: plain-Python specs the user (or the SDL parser) builds,
lowered by scene.compile() into flat device arrays.

This replaces the reference's runtime object graph (Arc<dyn Hittable> /
Arc<dyn Material> / Arc<dyn Texture>) with a declarative description; all
polymorphism is resolved at scene-compile time into SoA groups + static
closures, so the device never sees a vtable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np


# -- textures (reference: src/texture/) ------------------------------------

@dataclasses.dataclass(frozen=True)
class Constant:
    rgb: tuple

    @staticmethod
    def of(r, g, b):
        return Constant((float(r), float(g), float(b)))


@dataclasses.dataclass(frozen=True)
class Checker:
    odd: "TextureSpec"
    even: "TextureSpec"
    scale: float = 10.0


@dataclasses.dataclass(frozen=True)
class ImageTex:
    path: str


@dataclasses.dataclass(frozen=True)
class Noise:
    """Perlin lattice noise (noise.rs). kind: 'normal'|'turbulence'|'marble';
    smooth: 'hermitian'|'linear'|'none' (SmoothType, noise.rs:4-8)."""
    kind: str = "marble"
    scale: float = 1.0
    depth: int = 7
    vector: bool = True
    seed: int = 0
    smooth: str = "hermitian"


TextureSpec = Union[Constant, Checker, ImageTex, Noise]


def as_texture(t) -> TextureSpec:
    if isinstance(t, (Constant, Checker, ImageTex, Noise)):
        return t
    if isinstance(t, (tuple, list)) and len(t) == 3:
        return Constant(tuple(float(c) for c in t))
    raise TypeError(f"not a texture: {t!r}")


# -- materials (reference: src/material/) ----------------------------------

@dataclasses.dataclass(frozen=True)
class Lambertian:
    texture: TextureSpec = Constant((1.0, 1.0, 1.0))
    phong_factor: float = 0.0
    phong_exponent: float = 1.0


@dataclasses.dataclass(frozen=True)
class Metal:
    texture: TextureSpec = Constant((1.0, 1.0, 1.0))
    phong_factor: float = 0.0
    phong_exponent: float = 1.0


@dataclasses.dataclass(frozen=True)
class DiffuseMetal:
    exponent: float
    texture: TextureSpec = Constant((1.0, 1.0, 1.0))
    phong_factor: float = 0.0
    phong_exponent: float = 1.0


@dataclasses.dataclass(frozen=True)
class Dielectric:
    rgb: tuple = (1.0, 1.0, 1.0)
    ior: float = 1.5
    schlick: bool = False   # .reflect_curve(Glass) in the reference
    # EXTENSION (not in the reference, which only has the flat `rgb` tint,
    # dielectric.rs:82-93): per-channel Beer-Lambert absorption coefficient;
    # interior path segments attenuate by exp(-absorption * distance)
    absorption: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class BlinnPhong:
    k_specular: float
    exponent: float
    texture: TextureSpec = Constant((1.0, 1.0, 1.0))
    phong_factor: float = 0.0
    phong_exponent: float = 1.0


@dataclasses.dataclass(frozen=True)
class DiffuseLight:
    texture: TextureSpec = Constant((1.0, 1.0, 1.0))
    multiplier: float = 1.0


@dataclasses.dataclass(frozen=True)
class Isotropic:
    rgb: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Mixed:
    """MixedMaterial: material_1 with probability_1 else material_2."""
    material_1: "MaterialSpec"
    material_2: "MaterialSpec"
    probability_1: float


MaterialSpec = Union[
    Lambertian, Metal, DiffuseMetal, Dielectric, BlinnPhong, DiffuseLight,
    Isotropic, Mixed,
]


# -- geometry (reference: src/hittable/) -----------------------------------

@dataclasses.dataclass(frozen=True)
class Sphere:
    center: tuple
    radius: float
    material: Optional[MaterialSpec] = None
    speed: tuple = (0.0, 0.0, 0.0)
    transform: Optional[tuple] = None  # flattened 4x4, row-major


@dataclasses.dataclass(frozen=True)
class Box:
    p_min: tuple
    p_max: tuple
    material: Optional[MaterialSpec] = None
    transform: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Rect:
    """Axis-aligned rect: k_axis 0=YZ(x=k), 1=XZ(y=k), 2=XY(z=k).
    (a0,a1)/(b0,b1) bounds follow the reference's axis tuples
    (rect.rs:58-80): yz->(a=y,b=z), xz->(a=x,b=z), xy->(a=x,b=y)."""
    k_axis: int
    k: float
    a0: float
    a1: float
    b0: float
    b1: float
    material: Optional[MaterialSpec] = None
    transform: Optional[tuple] = None  # flattened 4x4, row-major


@dataclasses.dataclass(frozen=True)
class Quadric:
    coeffs: tuple  # (qa qb qc qd qe qf qg qh qi qj)
    material: Optional[MaterialSpec] = None
    transform: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Triangle mesh; vertices/indices as nested tuples or arrays are fine."""
    vertices: object           # (V, 3)
    indices: object            # (F, 3) int
    normals: object = None     # (V, 3) or None -> computed from faces
    material: Optional[MaterialSpec] = None


@dataclasses.dataclass(frozen=True)
class Csg:
    """CSG node; op in {'intersection', 'difference'}; children are
    Sphere/Box/Quadric/Rect/Mesh/Csg — the reference composes any
    Arc<dyn Hittable> (intersection.rs:19-23); rect/mesh children follow
    its contains()=false, t2=MAX semantics."""
    op: str
    left: object
    right: object
    material: Optional[MaterialSpec] = None
    transform: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class ConstantMedium:
    boundary: object            # Sphere or Box
    density: float
    rgb: tuple = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class Mandelbulb:
    """Power-8 Mandelbulb distance-field (raymarching.rs)."""
    material: Optional[MaterialSpec] = None
    transform: Optional[tuple] = None


GeometrySpec = Union[Sphere, Box, Rect, Quadric, Mesh, Csg, ConstantMedium, Mandelbulb]


def mat4(m: np.ndarray) -> tuple:
    """Freeze a 4x4 numpy matrix into a hashable spec field."""
    return tuple(float(x) for x in np.asarray(m, np.float64).reshape(16))


def unmat4(t) -> np.ndarray:
    return np.asarray(t, np.float64).reshape(4, 4)
