"""Scene compilation: host IR -> flat SoA tensors on a device.

The JAX package's `scene.py` for the primitives this port carries: static
sphere groups and (oriented) box groups, the texture, material and light
tables, and the background. Transforms are baked into primitive parameters
at compile time, so the render hot path has no transform facade.

Primitives and features not ported yet raise NotImplementedError at
compile, naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from raysnail_tpu_torch import ir
from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.geometry import boxes, spheres
from raysnail_tpu_torch.geometry import transforms as tf
from raysnail_tpu_torch.geometry.hit import Hit, combine_hits, miss
from raysnail_tpu_torch.prelude.vec import Vec3

_NOT_PORTED = {
    ir.Rect: "rects (ROADMAP M4)",
    ir.Quadric: "quadrics (ROADMAP M4)",
    ir.Mesh: "triangle meshes (ROADMAP M10)",
    ir.Csg: "CSG (ROADMAP M13)",
    ir.ConstantMedium: "media (ROADMAP M13)",
    ir.Mandelbulb: "the Mandelbulb (ROADMAP M14)",
}


class Background(NamedTuple):
    """Vertical gradient c1 -> c2 on 0.5*(dir.y + 1) (world.rs:19-23; the SDL
    driver's fixed sky raysnail.rs:364-367). Solid color = c1 == c2."""
    c1: Vec3
    c2: Vec3

    def color(self, direction: Vec3) -> Vec3:
        t = 0.5 * (direction.y + 1.0)
        return self.c1 * (1.0 - t) + self.c2 * t


class SceneArrays(NamedTuple):
    spheres: Optional[spheres.SphereGroup]
    boxes: Optional[boxes.BoxGroup]
    materials: matlib.MaterialTable
    textures: texlib.TextureTable
    lights: Optional[lightslib.LightArrays]
    background: Background


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    tex_modes: frozenset
    mat_kinds: frozenset
    light_kinds: frozenset
    has_lights: bool
    has_absorb: bool = False  # any dielectric with Beer-Lambert absorption
    mix_depth: int = 1        # max Mixed-material nesting (resolve iterations)


@dataclasses.dataclass
class Scene:
    arrays: SceneArrays
    static: SceneStatic
    device: torch.device


def intersect(scene: Scene, arrays: SceneArrays, ray, t_min, t_max) -> Hit:
    """Closest hit across all primitive groups. `arrays` is passed
    separately so a caller can render other scene data (e.g. converted from
    the JAX package) with the same static structure."""
    d = ray.direction
    best = miss(d.x.shape, d.x.dtype, d.x.device)
    if arrays.spheres is not None:
        best = combine_hits(best, spheres.intersect(
            arrays.spheres, ray, t_min, t_max,
            need_uv=texlib.IMAGE in scene.static.tex_modes))
    if arrays.boxes is not None:
        best = combine_hits(best, boxes.intersect(arrays.boxes, ray, t_min, t_max))
    return best


# -- builder ---------------------------------------------------------------

class SceneBuilder:
    """Collects IR specs and lowers them to a Scene.

    `add(obj)` adds world geometry; `add(obj, light=True)` also registers the
    object in the light-sampling list (the reference adds light spheres to
    BOTH the world and `lights`, bin/raysnail.rs:353-362)."""

    def __init__(self):
        self.objects: list = []
        self.light_specs: list = []
        self.background = ((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))

    def add(self, obj, light: bool = False):
        self.objects.append(obj)
        if light:
            # the light spec describes the object's WORLD-space placement
            m = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
            ts = tf.is_translate_uniform_scale(m) if m is not None else (1.0, np.zeros(3))
            if isinstance(obj, ir.Sphere):
                if ts is None:
                    raise ValueError(
                        "light spheres only support translate/uniform-scale transforms")
                s, off = ts
                c = tuple(np.asarray(obj.center, np.float64) * s + off)
                self.light_specs.append(("sphere", c, obj.radius * abs(s)))
            elif isinstance(obj, ir.Rect) and obj.k_axis == 1:
                if ts is None:
                    raise ValueError(
                        "light rects only support translate/uniform-scale transforms")
                s, off = ts
                a0, a1 = sorted((obj.a0 * s + off[0], obj.a1 * s + off[0]))
                b0, b1 = sorted((obj.b0 * s + off[2], obj.b1 * s + off[2]))
                self.light_specs.append(("rect_xz", obj.k * s + off[1], a0, a1, b0, b1))
            else:
                raise ValueError("lights must be spheres or XZ rects (rect.rs:141-153)")
        return self

    def set_background(self, c1, c2=None):
        self.background = (tuple(c1), tuple(c2) if c2 is not None else tuple(c1))
        return self

    def compile(self, dtype=torch.float32, device="cpu") -> Scene:
        return _compile(self, dtype, torch.device(device))


class _Tables:
    """Deduplicating collectors for materials and textures."""

    def __init__(self):
        self.tex_index: dict = {}
        self.tex_rows: list = []
        self.mat_index: dict = {}
        self.mat_rows: list = []
        self.deep_checker = False  # some checker has non-constant children
        self.checker_depth = 0     # max checker nesting (1 = plain checker)
        self._row_depth: list = [] # per-row checker nesting depth
        self.mix_depth = 1         # max Mixed-material nesting
        self._mat_depth: list = [] # per-row Mixed nesting depth
        # row 0: the world default white Lambertian (world.rs:25-60)
        self.material(ir.Lambertian(ir.Constant((1.0, 1.0, 1.0))))

    def texture(self, spec) -> int:
        spec = ir.as_texture(spec)
        if spec in self.tex_index:
            return self.tex_index[spec]
        row = dict(ttype=texlib.CONSTANT, color1=(0.0, 0.0, 0.0), color2=(0.0, 0.0, 0.0),
                   scale=1.0, child1=-1, child2=-1)
        depth = 0
        if isinstance(spec, ir.Constant):
            row["color1"] = spec.rgb
        elif isinstance(spec, ir.Checker):
            # generic over child textures, checker-of-checker included
            # (checker.rs:8-28): children are rows of their own
            odd, even = ir.as_texture(spec.odd), ir.as_texture(spec.even)
            c1, c2 = self.texture(odd), self.texture(even)
            row.update(ttype=texlib.CHECKER, scale=spec.scale, child1=c1, child2=c2)
            depth = 1 + max(self._row_depth[c1], self._row_depth[c2])
            self.checker_depth = max(self.checker_depth, depth)
            if isinstance(odd, ir.Constant) and isinstance(even, ir.Constant):
                row.update(color1=odd.rgb, color2=even.rgb)
            else:
                self.deep_checker = True
        elif isinstance(spec, (ir.ImageTex, ir.Noise)):
            raise NotImplementedError(
                f"{type(spec).__name__} textures are not ported yet (ROADMAP M5)")
        else:
            raise TypeError(f"unknown texture {spec!r}")
        idx = len(self.tex_rows)
        self._row_depth.append(depth)
        self.tex_rows.append(row)
        self.tex_index[spec] = idx
        return idx

    def material(self, spec) -> int:
        if spec is None:
            return -1
        if spec in self.mat_index:
            return self.mat_index[spec]
        row = dict(mtype=matlib.LAMBERTIAN, tex_id=0, param0=0.0, param1=0.0,
                   emit_mult=0.0, phong_factor=0.0, phong_exponent=1.0,
                   mix_prob=0.0, mix_a=0, mix_b=0, absorb=(0.0, 0.0, 0.0))
        depth = 0
        common = lambda s: dict(tex_id=self.texture(s.texture), phong_factor=s.phong_factor,
                                phong_exponent=s.phong_exponent)
        if isinstance(spec, ir.Lambertian):
            row.update(mtype=matlib.LAMBERTIAN, **common(spec))
        elif isinstance(spec, ir.Metal):
            row.update(mtype=matlib.METAL, **common(spec))
        elif isinstance(spec, ir.DiffuseMetal):
            row.update(mtype=matlib.DIFFUSE_METAL, param0=spec.exponent, **common(spec))
        elif isinstance(spec, ir.Dielectric):
            row.update(mtype=matlib.DIELECTRIC, tex_id=self.texture(ir.Constant(spec.rgb)),
                       param0=spec.ior, param1=1.0 if spec.schlick else 0.0,
                       absorb=tuple(spec.absorption))
        elif isinstance(spec, ir.BlinnPhong):
            row.update(mtype=matlib.BLINN_PHONG, param0=spec.k_specular,
                       param1=spec.exponent, **common(spec))
        elif isinstance(spec, ir.DiffuseLight):
            row.update(mtype=matlib.DIFFUSE_LIGHT, tex_id=self.texture(spec.texture),
                       emit_mult=spec.multiplier)
        elif isinstance(spec, ir.Isotropic):
            row.update(mtype=matlib.ISOTROPIC, tex_id=self.texture(ir.Constant(spec.rgb)))
        elif isinstance(spec, ir.Mixed):
            # nests like the reference's Arc<dyn Material> pair
            # (mixed_material.rs:15-23): children are rows of their own
            a = self.material(spec.material_1)
            b = self.material(spec.material_2)
            row.update(mtype=matlib.MIXED, mix_prob=spec.probability_1, mix_a=a, mix_b=b)
            depth = 1 + max(self._mat_depth[a], self._mat_depth[b])
            self.mix_depth = max(self.mix_depth, depth)
        else:
            raise TypeError(f"unknown material {spec!r}")
        idx = len(self.mat_rows)
        self._mat_depth.append(depth)
        self.mat_rows.append(row)
        self.mat_index[spec] = idx
        return idx


def _compile(builder: SceneBuilder, dtype, device: torch.device) -> Scene:
    tables = _Tables()
    sph, box_list = [], []

    for obj in builder.objects:
        for kind, what in _NOT_PORTED.items():
            if isinstance(obj, kind):
                raise NotImplementedError(f"{what} are not ported yet")
        m = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
        if isinstance(obj, ir.Sphere):
            mat = tables.material(obj.material)
            if any(obj.speed):
                raise NotImplementedError(
                    "moving spheres (motion blur) are not ported yet (ROADMAP M4)")
            if m is None:
                sph.append((obj.center, obj.radius, mat))
                continue
            ts = tf.is_translate_uniform_scale(m)
            if ts is None:
                raise NotImplementedError(
                    "a sphere under a non-uniform transform lowers to a quadric: "
                    "quadrics are not ported yet (ROADMAP M4)")
            s, off = ts
            sph.append((tuple(np.asarray(obj.center) * s + off), obj.radius * s, mat))
        elif isinstance(obj, ir.Box):
            mat = tables.material(obj.material)
            inv = tf.inverse_rows(m) if m is not None else (None, None)
            box_list.append((obj.p_min, obj.p_max, mat, *inv))
        else:
            raise TypeError(f"unknown object {obj!r}")

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    def vec(x):  # (n, 3) -> Vec3 of contiguous (n,) columns
        return Vec3(*(f32(c) for c in np.asarray(x, np.float64).reshape(-1, 3).T))

    def flags(n):
        return torch.ones(n, dtype=torch.bool, device=device)

    # the kernel takes any sphere count: no padding rows
    sphere_group = None
    if sph:
        sphere_group = spheres.SphereGroup(
            center=vec([s[0] for s in sph]), radius=f32([s[1] for s in sph]),
            mat_id=i32([s[2] for s in sph]), active=flags(len(sph)))

    box_group = None
    if box_list:
        inv_rows = inv_off = None
        if any(b[3] is not None for b in box_list):
            rots = np.asarray([b[3] if b[3] is not None else np.eye(3) for b in box_list])
            offs = np.asarray([b[4] if b[4] is not None else np.zeros(3) for b in box_list])
            inv_rows = tuple(vec(rots[:, i, :]) for i in range(3))
            inv_off = vec(offs)
        box_group = boxes.BoxGroup(
            p_min=vec([b[0] for b in box_list]), p_max=vec([b[1] for b in box_list]),
            mat_id=i32([b[2] for b in box_list]), active=flags(len(box_list)),
            inv_rows=inv_rows, inv_off=inv_off)

    light_arrays = None
    light_kinds = set()
    if builder.light_specs:
        rows = []
        for spec in builder.light_specs:
            if spec[0] == "sphere":
                light_kinds.add(lightslib.SPHERE)
                rows.append((lightslib.SPHERE, spec[1], spec[2], 0.0, 0.0, 0.0, 0.0, 0.0))
            else:
                light_kinds.add(lightslib.RECT_XZ)
                rows.append((lightslib.RECT_XZ, (0.0, 0.0, 0.0), 0.0, *spec[1:]))
        cols = list(zip(*rows))
        light_arrays = lightslib.LightArrays(
            kind=i32(cols[0]), center=vec(cols[1]), radius=f32(cols[2]), k=f32(cols[3]),
            a0=f32(cols[4]), a1=f32(cols[5]), b0=f32(cols[6]), b1=f32(cols[7]))

    tr = tables.tex_rows
    tex_modes = frozenset(r["ttype"] for r in tr)
    if tables.deep_checker or tables.checker_depth > 1:
        tex_modes = tex_modes | {texlib.CHECKER_DEEP,
                                 ("checker_depth", tables.checker_depth)}
    col = lambda rows, name: [r[name] for r in rows]
    texture_table = texlib.TextureTable(
        ttype=i32(col(tr, "ttype")), color1=vec(col(tr, "color1")),
        color2=vec(col(tr, "color2")), scale=f32(col(tr, "scale")),
        child1=i32(col(tr, "child1")), child2=i32(col(tr, "child2")))

    mr = tables.mat_rows
    has_absorb = any(any(c != 0.0 for c in r["absorb"]) for r in mr)
    material_table = matlib.MaterialTable(
        mtype=i32(col(mr, "mtype")), tex_id=i32(col(mr, "tex_id")),
        param0=f32(col(mr, "param0")), param1=f32(col(mr, "param1")),
        emit_mult=f32(col(mr, "emit_mult")), phong_factor=f32(col(mr, "phong_factor")),
        phong_exponent=f32(col(mr, "phong_exponent")), mix_prob=f32(col(mr, "mix_prob")),
        mix_a=i32(col(mr, "mix_a")), mix_b=i32(col(mr, "mix_b")),
        absorb=vec(col(mr, "absorb")) if has_absorb else None)

    c1, c2 = builder.background
    arrays = SceneArrays(
        spheres=sphere_group, boxes=box_group, materials=material_table,
        textures=texture_table, lights=light_arrays,
        background=Background(c1=Vec3.full(c1, (), dtype, device),
                              c2=Vec3.full(c2, (), dtype, device)))
    static = SceneStatic(
        tex_modes=tex_modes, mat_kinds=frozenset(r["mtype"] for r in mr),
        light_kinds=frozenset(light_kinds), has_lights=light_arrays is not None,
        has_absorb=has_absorb, mix_depth=tables.mix_depth)
    return Scene(arrays=arrays, static=static, device=device)
