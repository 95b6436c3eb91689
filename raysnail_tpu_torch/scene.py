"""Scene compilation: host IR -> flat SoA tensors on a device.

The JAX package's `scene.py` for the primitives this port carries: sphere
groups (static or moving), (oriented) box groups, rect and quadric groups
and triangle meshes, the texture, material and light tables (image and
Perlin textures included), and the background. Transforms are baked into
primitive parameters at compile time, so the render hot path has no
transform facade.

Large groups are also packed for the BVH traversal kernel, with the JAX
package's host packing and gates: every mesh, static sphere groups of 64 or
more and axis-aligned box groups of BOX_BVH_MIN_BUILD or more get a fat-leaf
BVH with its coarse cut (`_leaf_tree`) and 128-wide leaf blocks
(`_pack_leaf_blocks`; `_pack_mxu_blocks` for meshes compiled with
RAYSNAIL_MESH_SOLVER=mxu), equal to the JAX compile's arrays.

CSG objects lower to static trees of `geometry.csg` nodes and constant
media to `geometry.media` nodes, their transforms pushed down to the
leaves, as the JAX package lowers them (`_leaf_of`, `_lower_csg`). A
Mandelbulb compiles to a `geometry.mandelbulb.MandelbulbNode` (its material
only: the distance field sits at the origin and, as in the JAX package,
ignores a transform), which `intersect` marches after the media.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from raysnail_tpu_torch import ir
from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.config import entry_device
from raysnail_tpu_torch.accel.bvh import build_bvh, coarse_cut, relinearize_octants
from raysnail_tpu_torch.geometry import boxes, csg, quadrics, rects, spheres, triangles
from raysnail_tpu_torch.geometry import media as medialib
from raysnail_tpu_torch.geometry.mandelbulb import MandelbulbNode
from raysnail_tpu_torch.geometry import transforms as tf
from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import Hit, combine_hits, miss
from raysnail_tpu_torch.ops.bvh_traverse import COARSE_MAX, LANES, MXU_LANES, NF
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude.vec import Vec3

# the JAX package's packing gates and layout constants, kept for parity
BOX_BVH_MIN_BUILD = 130    # axis-aligned box groups this large get a packed BVH
SPHERE_PACK_MIN = 64       # static sphere groups this large get a packed BVH
BRUTE_FORCE_MAX = 32768    # meshes up to this many triangles: dense sweep on the CPU
# trees up to this many nodes get the 8 direction-octant orders. The JAX
# package's cap, 4,600, is the size of the TPU's scalar memory; this card
# reads nodes through its 50 MB L2, so the cap is where the 8 orders' node
# arrays (8 x M x 48 bytes) reach a quarter of it. Between the two caps this
# compile has 8 orders where the JAX package's has one: the results differ
# only in the order leaves are visited, i.e. in which of two tied hits wins.
OCTANT_CAP = 32768


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
    rects: Optional[rects.RectGroup]
    quadrics: Optional[quadrics.QuadricGroup]
    triangles: Optional[triangles.TriangleGroup]
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
    tri_brute: bool = False   # dense triangle sweep on the CPU (small meshes)
    moving: bool = False      # some sphere moves (motion blur): centers follow ray.time
    n_media: int = 0
    n_csg: int = 0


@dataclasses.dataclass
class Scene:
    arrays: SceneArrays
    static: SceneStatic
    device: torch.device
    csg_trees: tuple = ()     # geometry.csg trees, in compile order
    media: tuple = ()         # geometry.media.MediumNode, in compile order
    mandelbulbs: tuple = ()   # geometry.mandelbulb.MandelbulbNode, in compile order
    # csg.group_trees(csg_trees): the trees of one structure stacked
    csg_groups: tuple = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self.csg_groups = csg.group_trees(self.csg_trees)


class Routes(NamedTuple):
    """Which primitive groups take the BVH traversal kernel
    (integrator.kernel_routes); the defaults are the dense routes."""
    mesh_kernel: bool = False
    mesh_bin: str = "never"
    sphere_bvh: bool = False
    box_bvh: bool = False
    # bvh_traverse's `packet` argument: None = its own rule at call time
    packet: Optional[bool] = None


def intersect(scene: Scene, arrays: SceneArrays, ray, t_min, t_max, key=None,
              routes: Routes = Routes(), active=None) -> Hit:
    """Closest hit across all primitive groups, in the JAX package's order:
    spheres, boxes, rects, quadrics, triangles, then the CSG trees, the
    media and the Mandelbulbs. `arrays` is passed separately so a caller can
    render other scene data (e.g. converted from the JAX package) with the
    same static structure. `key` is the per-ray key batch: only the media draw from it,
    one uniform per medium, and a scene with media needs it. `active` is the
    integrator's alive mask: on the kernel routes dead lanes admit no BVH
    node, and the box and triangle routes take the best hit so far as their
    admission cap (t_cap); the trees and media come after, uncapped, and a
    Mandelbulb's march skips the dead lanes. The triangle and Mandelbulb
    hits carry no gradient (`hit.detach`), as in the JAX package; every
    other group's hit stays attached to the rays."""
    d = ray.direction
    best = miss(d.x.shape, d.x.dtype, d.x.device)
    if arrays.spheres is not None:
        best = combine_hits(best, spheres.intersect(
            arrays.spheres, ray, t_min, t_max,
            need_uv=texlib.IMAGE in scene.static.tex_modes,
            use_bvh=routes.sphere_bvh, active=active, packet=routes.packet,
            moving=scene.static.moving))
    if arrays.boxes is not None:
        if routes.box_bvh and arrays.boxes.pk_bb is not None:
            best = combine_hits(best, boxes.intersect_kernel(
                arrays.boxes, ray, t_min, t_max, active=active, t_cap=best.t,
                packet=routes.packet))
        else:
            best = combine_hits(best, boxes.intersect(arrays.boxes, ray, t_min, t_max))
    if arrays.rects is not None:
        best = combine_hits(best, rects.intersect(arrays.rects, ray, t_min, t_max))
    if arrays.quadrics is not None:
        best = combine_hits(best, quadrics.intersect(arrays.quadrics, ray, t_min, t_max))
    if arrays.triangles is not None:
        # on the CPU a big mesh takes the kernel route's plain version: the
        # port carries no thin-BVH lockstep walk
        if routes.mesh_kernel or not scene.static.tri_brute:
            tri_hit = triangles.intersect_kernel(
                arrays.triangles, ray, t_min, t_max, active=active, t_cap=best.t,
                bin_mode=routes.mesh_bin, packet=routes.packet)
        else:
            tri_hit = triangles.intersect_brute(arrays.triangles, ray, t_min, t_max)
        # geometry gradients are out of scope: the mesh hit is detached, as
        # in the JAX package
        best = combine_hits(best, hitlib.detach(tri_hit))
    if scene.csg_trees:
        best = combine_hits(best, csg.intersect_trees(scene.csg_groups, ray, t_min, t_max))
    if scene.media:
        us = prng.ray_uniforms(prng.fold_all(key, prng.MEDIUM), len(scene.media), d.x.dtype)
        best = combine_hits(best, medialib.intersect_media(scene.media, ray, t_min, t_max, us))
    for bulb in scene.mandelbulbs:
        best = combine_hits(best, hitlib.detach(bulb.hit(ray, t_min, t_max, active=active)))
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

    def compile(self, dtype=torch.float32, device="cuda", mesh_solver=None) -> Scene:
        """Lower the scene onto `device`: the card, unless the caller names
        another (no card raises). mesh_solver: "cramer" or "mxu", the format
        of the meshes' leaf blocks; None reads RAYSNAIL_MESH_SOLVER (default
        "cramer")."""
        return _compile(self, dtype, entry_device(device), mesh_solver)


class _Tables:
    """Deduplicating collectors for materials and textures."""

    def __init__(self):
        self.tex_index: dict = {}
        self.tex_rows: list = []
        self.mat_index: dict = {}
        self.mat_rows: list = []
        self.images: list = []
        self.perlins: list = []
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
                   scale=1.0, image_id=-1, depth=0, perlin_id=-1, child1=-1, child2=-1)
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
        elif isinstance(spec, ir.ImageTex):
            from PIL import Image
            img = np.asarray(Image.open(spec.path).convert("RGB"), np.float32) / 255.0
            row.update(ttype=texlib.IMAGE, image_id=len(self.images))
            self.images.append(img)
        elif isinstance(spec, ir.Noise):
            ttype = {"normal": texlib.PERLIN, "turbulence": texlib.PERLIN_TURB,
                     "marble": texlib.PERLIN_MARBLE}[spec.kind]
            row.update(ttype=ttype, scale=spec.scale, depth=spec.depth,
                       perlin_id=len(self.perlins))
            # the lattice is hashed on the fly (textures._lattice_corner):
            # only the seed, the vector flag and the smoothing mode remain
            self.perlins.append(((spec.seed + 12345) & 0xFFFFFFFF, bool(spec.vector),
                                 {"none": 0, "linear": 1, "hermitian": 2}[spec.smooth]))
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


def _compile(builder: SceneBuilder, dtype, device: torch.device, mesh_solver=None) -> Scene:
    tables = _Tables()
    sph, box_list, rect_list, quad_list, mesh_list = [], [], [], [], []
    csg_trees, media_nodes, bulbs = [], [], []
    moving = False
    lower = dict(tables=tables, dtype=dtype, device=device, mesh_solver=mesh_solver)

    for obj in builder.objects:
        m = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
        if isinstance(obj, ir.Sphere):
            mat = tables.material(obj.material)
            ts = (1.0, np.zeros(3)) if m is None else tf.is_translate_uniform_scale(m)
            if ts is None:
                # an ellipsoid: the sphere's quadric with the transform baked in
                quad_list.append((tf.transform_quadric(
                    tf.sphere_to_quadric(obj.center, obj.radius), m), mat))
                continue
            s, off = ts
            center = obj.center if m is None else tuple(np.asarray(obj.center) * s + off)
            moving = moving or any(obj.speed)
            sph.append((center, obj.radius * s, mat, obj.speed))
        elif isinstance(obj, ir.Box):
            mat = tables.material(obj.material)
            inv = tf.inverse_rows(m) if m is not None else (None, None)
            box_list.append((obj.p_min, obj.p_max, mat, *inv))
        elif isinstance(obj, ir.Rect):
            mat = tables.material(obj.material)
            inv = tf.inverse_rows(m) if m is not None else (None, None)
            rect_list.append((obj, mat, *inv))
        elif isinstance(obj, ir.Quadric):
            mat = tables.material(obj.material)
            coeffs = tuple(float(c) for c in obj.coeffs)
            quad_list.append((tf.transform_quadric(coeffs, m) if m is not None else coeffs, mat))
        elif isinstance(obj, ir.Mesh):
            mesh_list.append((obj, tables.material(obj.material)))
        elif isinstance(obj, ir.Csg):
            csg_trees.append(_lower_csg(obj, m, **lower))
        elif isinstance(obj, ir.ConstantMedium):
            mat = tables.material(ir.Isotropic(obj.rgb))
            leaf = _leaf_of(obj.boundary, m, -1, register_material=False, **lower)
            media_nodes.append(medialib.MediumNode(
                boundary=leaf, mat_id=mat,
                neg_inv_density=torch.tensor(-1.0 / obj.density, dtype=dtype, device=device)))
        elif isinstance(obj, ir.Mandelbulb):
            bulbs.append(MandelbulbNode(mat_id=tables.material(obj.material)))
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

    def packed(arrs):  # host pk_* arrays -> tensors on the device
        return [torch.as_tensor(a, device=device) for a in arrs]

    def oriented_rows(entries):
        """(inv_rows, inv_off) of a group whose entries end in (rot, off), the
        identity for its untransformed members; (None, None) if none has one."""
        if all(e[-2] is None for e in entries):
            return None, None
        rots = np.asarray([e[-2] if e[-2] is not None else np.eye(3) for e in entries])
        offs = np.asarray([e[-1] if e[-1] is not None else np.zeros(3) for e in entries])
        return tuple(vec(rots[:, i, :]) for i in range(3)), vec(offs)

    pk_names = ("pk_bb", "pk_links", "pk_cbb", "pk_crange")

    # the kernel takes any sphere count: no padding rows
    sphere_group = None
    if sph:
        pk = [None] * 5
        # motion blur stays on the dense sweep: centers move per ray with time
        if len(sph) >= SPHERE_PACK_MIN and not moving:
            c = np.asarray([s[0] for s in sph], np.float64)
            r = np.asarray([s[1] for s in sph], np.float64)
            pk = packed(_pack_leaf_blocks(
                c - r[:, None], c + r[:, None],
                [c[:, 0], c[:, 1], c[:, 2], r * r, np.ones(len(sph)),
                 np.asarray([s[2] for s in sph], np.float64), r]))
        sphere_group = spheres.SphereGroup(
            center=vec([s[0] for s in sph]), radius=f32([s[1] for s in sph]),
            mat_id=i32([s[2] for s in sph]), active=flags(len(sph)),
            speed=vec([s[3] for s in sph]), **dict(zip(pk_names, pk)), pk_sph=pk[4])

    box_group = None
    if box_list:
        inv_rows, inv_off = oriented_rows(box_list)
        pk = [None] * 5
        if inv_rows is None and len(box_list) >= BOX_BVH_MIN_BUILD:
            lo = np.asarray([b[0] for b in box_list], np.float64)
            hi = np.asarray([b[1] for b in box_list], np.float64)
            pk = packed(_pack_leaf_blocks(
                lo, hi, [lo[:, 0], lo[:, 1], lo[:, 2], hi[:, 0], hi[:, 1], hi[:, 2],
                         np.ones(len(box_list)),
                         np.asarray([b[2] for b in box_list], np.float64)]))
        box_group = boxes.BoxGroup(
            p_min=vec([b[0] for b in box_list]), p_max=vec([b[1] for b in box_list]),
            mat_id=i32([b[2] for b in box_list]), active=flags(len(box_list)),
            inv_rows=inv_rows, inv_off=inv_off, **dict(zip(pk_names, pk)), pk_box=pk[4])

    rect_group = None
    if rect_list:
        inv_rows, inv_off = oriented_rows(rect_list)
        rect_group = rects.RectGroup(
            k_axis=i32([r.k_axis for r, *_ in rect_list]),
            **{f: f32([getattr(r, f) for r, *_ in rect_list])
               for f in ("k", "a0", "a1", "b0", "b1")},
            mat_id=i32([r[1] for r in rect_list]), active=flags(len(rect_list)),
            inv_rows=inv_rows, inv_off=inv_off)

    quad_group = None
    if quad_list:
        cols = np.asarray([q[0] for q in quad_list], np.float64).T
        quad_group = quadrics.QuadricGroup(
            *(f32(c) for c in cols), mat_id=i32([q[1] for q in quad_list]),
            active=flags(len(quad_list)))

    tri_group = _triangle_group(mesh_list, mesh_solver, dtype, device) if mesh_list else None

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
    atlas = atlas_wh = None
    if tables.images:
        mh = max(i.shape[0] for i in tables.images)
        mw = max(i.shape[1] for i in tables.images)
        atlas_np = np.zeros((len(tables.images), mh, mw, 3), np.float32)
        for i, img in enumerate(tables.images):
            atlas_np[i, :img.shape[0], :img.shape[1]] = img
        atlas = torch.as_tensor(atlas_np, device=device)
        atlas_wh = i32([(img.shape[1], img.shape[0]) for img in tables.images])
    perlin_seed = perlin_is_vec = perlin_smooth = None
    if tables.perlins:
        perlin_seed = torch.as_tensor([p[0] for p in tables.perlins], dtype=torch.int64,
                                      device=device)
        perlin_is_vec = torch.as_tensor([p[1] for p in tables.perlins], dtype=torch.bool,
                                        device=device)
        perlin_smooth = i32([p[2] for p in tables.perlins])
    texture_table = texlib.TextureTable(
        ttype=i32(col(tr, "ttype")), color1=vec(col(tr, "color1")),
        color2=vec(col(tr, "color2")), scale=f32(col(tr, "scale")),
        child1=i32(col(tr, "child1")), child2=i32(col(tr, "child2")),
        image_id=i32(col(tr, "image_id")), depth=i32(col(tr, "depth")),
        atlas=atlas, atlas_wh=atlas_wh, perlin_id=i32(col(tr, "perlin_id")),
        perlin_seed=perlin_seed, perlin_is_vec=perlin_is_vec, perlin_smooth=perlin_smooth)

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
        spheres=sphere_group, boxes=box_group, rects=rect_group, quadrics=quad_group,
        triangles=tri_group, materials=material_table,
        textures=texture_table, lights=light_arrays,
        background=Background(c1=Vec3.full(c1, (), dtype, device),
                              c2=Vec3.full(c2, (), dtype, device)))
    static = SceneStatic(
        tex_modes=tex_modes, mat_kinds=frozenset(r["mtype"] for r in mr),
        light_kinds=frozenset(light_kinds), has_lights=light_arrays is not None,
        has_absorb=has_absorb, mix_depth=tables.mix_depth,
        tri_brute=tri_group is not None and tri_group.mat_id.shape[0] <= BRUTE_FORCE_MAX,
        moving=moving, n_media=len(media_nodes), n_csg=len(csg_trees))
    return Scene(arrays=arrays, static=static, device=device, csg_trees=tuple(csg_trees),
                 media=tuple(media_nodes), mandelbulbs=tuple(bulbs))


# -- CSG and media lowering ---------------------------------------------------

def _combine_tf(parent, own):
    if parent is None:
        return own
    if own is None:
        return parent
    return parent @ own  # the child's own transform applies first


def _leaf_of(obj, m, inherit_mat, tables, dtype, device, mesh_solver=None,
             register_material=True):
    """Lower a CSG child (sphere, box, quadric, rect, mesh or CSG) to a leaf
    or node, pushing the accumulated transform m down; parameters become
    0-d tensors on `device`."""
    m = _combine_tf(m, ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None)
    mat = tables.material(obj.material) if register_material else inherit_mat

    def scal(x):
        return torch.tensor(float(x), dtype=dtype, device=device)

    def vec(c):
        return Vec3.full(tuple(float(x) for x in c), (), dtype, device)

    def rows(m):
        rot, off = tf.inverse_rows(m)
        return tuple(vec(rot[i]) for i in range(3)), vec(off)

    def quadric(coeffs):
        return csg.QuadricLeaf(coeffs=quadrics.Coeffs(*(scal(c) for c in coeffs)), mat_id=mat)

    if isinstance(obj, ir.Sphere):
        ts = (1.0, np.zeros(3)) if m is None else tf.is_translate_uniform_scale(m)
        if ts is None:
            return quadric(tf.transform_quadric(tf.sphere_to_quadric(obj.center, obj.radius), m))
        s, off = ts
        center = obj.center if m is None else np.asarray(obj.center) * s + off
        return csg.SphereLeaf(center=vec(center), radius=scal(obj.radius * s), mat_id=mat)
    if isinstance(obj, ir.Box):
        inv_rows, inv_off = rows(m) if m is not None else (None, None)
        return csg.BoxLeaf(p_min=vec(obj.p_min), p_max=vec(obj.p_max), inv_rows=inv_rows,
                           inv_off=inv_off, mat_id=mat)
    if isinstance(obj, ir.Quadric):
        coeffs = tuple(float(c) for c in obj.coeffs)
        return quadric(tf.transform_quadric(coeffs, m) if m is not None else coeffs)
    if isinstance(obj, ir.Rect):
        inv_rows, inv_off = rows(m) if m is not None else (None, None)
        return csg.RectLeaf(k_axis=int(obj.k_axis), k=scal(obj.k), a0=scal(obj.a0),
                            a1=scal(obj.a1), b0=scal(obj.b0), b1=scal(obj.b1),
                            inv_rows=inv_rows, inv_off=inv_off, mat_id=mat)
    if isinstance(obj, ir.Mesh):
        if m is not None:
            v = np.asarray(obj.vertices, np.float64)
            vh = np.concatenate([v, np.ones((len(v), 1))], 1)
            normals = None if obj.normals is None else tuple(
                map(tuple, np.asarray(obj.normals, np.float64) @ np.linalg.inv(m[:3, :3])))
            obj = dataclasses.replace(obj, vertices=tuple(map(tuple, (vh @ m.T)[:, :3])),
                                      normals=normals)
        group = _triangle_group([(obj, mat)], mesh_solver, dtype, device)
        return csg.MeshLeaf(group=group, mat_id=mat,
                            brute=int(group.mat_id.shape[0]) <= BRUTE_FORCE_MAX)
    if isinstance(obj, ir.Csg):
        return _lower_csg(obj, m, tables, dtype, device, mesh_solver)
    raise TypeError(f"unsupported CSG child {obj!r}")


def _lower_csg(obj: ir.Csg, m, tables, dtype, device, mesh_solver=None):
    """A CSG object whose own transform is folded into m already -> its node."""
    mat = tables.material(obj.material)
    lower = dict(tables=tables, dtype=dtype, device=device, mesh_solver=mesh_solver)
    left = _leaf_of(obj.left, m, -1, **lower)
    right = _leaf_of(obj.right, m, -1, **lower)
    if obj.op == "intersection":
        return csg.IntersectionNode(left=left, right=right, mat_id=mat)
    if obj.op == "difference":
        return csg.DifferenceNode(plus=left, minus=right, mat_id=mat,
                                  minus_mat_id=getattr(right, "mat_id", -1))
    raise ValueError(f"unknown csg op {obj.op}")


# -- host packing for the BVH traversal kernel -------------------------------

def _leaf_tree(bb_min, bb_max):
    """Fat-leaf BVH (leaf = LANES prims) node arrays for the traversal
    kernels -> (pk_bb (K, M, 8) f32, pk_links (K, M, 4) i32, pk_cbb
    (K, 64, 8) f32, pk_crange (K, 64, 4) i32, n_cut (K,) int, order, pad
    mask, safe indices, n_blocks), where K = 8 direction-octant node orders
    (front-to-back traversal) for trees of up to OCTANT_CAP nodes, else
    K = 1 (build order). pk_cbb and pk_crange are the two-level walk's coarse
    cut (accel.bvh.coarse_cut): at most 64 subtree roots' bounds and DFS node
    ranges per order, padded as the JAX compile pads them (an inverted box,
    a range that starts at M); n_cut counts the real entries, and the
    port's walks stop there: the padding box passes a slab test."""
    fat = build_bvh(bb_min, bb_max, leaf_size=LANES)
    order = fat.prim_order
    pad = order < 0
    safe = np.where(pad, 0, order)
    m = fat.bb_min.shape[0]
    if m <= OCTANT_CAP:
        pk_bb, pk_links = relinearize_octants(fat)
        pk_links[:, :, 0] //= LANES
    else:
        pk_bb = np.zeros((1, m, 8), np.float32)
        pk_bb[0, :, 0:3] = fat.bb_min
        pk_bb[0, :, 3:6] = fat.bb_max
        pk_links = np.zeros((1, m, 4), np.int32)
        pk_links[0, :, 0] = fat.first // LANES
        pk_links[0, :, 1] = fat.count
        pk_links[0, :, 2] = fat.miss
    k_ord = pk_bb.shape[0]
    pk_cbb = np.zeros((k_ord, COARSE_MAX, 8), np.float32)
    pk_cbb[:, :, 0:3] = 1e30
    pk_cbb[:, :, 3:6] = -1e30
    pk_crange = np.full((k_ord, COARSE_MAX, 4), m, np.int32)
    n_cut = np.zeros(k_ord, np.int64)
    for k in range(k_ord):
        cuts = coarse_cut(pk_links[k, :, 1], pk_links[k, :, 2], max_entries=COARSE_MAX)
        starts = np.asarray([c[0] for c in cuts])
        n_cut[k] = len(cuts)
        pk_cbb[k, :len(cuts), :] = pk_bb[k, starts, :]
        pk_crange[k, :len(cuts), 0] = starts
        pk_crange[k, :len(cuts), 1] = np.asarray([c[1] for c in cuts])
    return (pk_bb, pk_links, pk_cbb, pk_crange, n_cut, order, pad, safe,
            len(order) // LANES)


def _pack_leaf_blocks(bb_min, bb_max, fields):
    """Fat-leaf BVH + (B, NF, LANES) field blocks: fields on rows, primitives
    on lanes. Padding lanes are zeroed, so a `valid` field of ones marks the
    real primitives. fields: list of (P,) arrays, one per row; NF rounds up
    to a multiple of 8. -> (pk_bb, pk_links, pk_cbb, pk_crange, pk_prim)."""
    (pk_bb, pk_links, pk_cbb, pk_crange, _, order, pad, safe,
     n_blocks) = _leaf_tree(bb_min, bb_max)
    nf = -(-len(fields) // 8) * 8
    pk = np.zeros((n_blocks, nf, LANES), np.float32)
    for i, f in enumerate(fields):
        vals = np.where(pad, 0.0, np.asarray(f, np.float64)[safe])
        pk[:, i, :] = vals.reshape(n_blocks, LANES)
    return pk_bb, pk_links, pk_cbb, pk_crange, pk


def _pack_mxu_blocks(bb_min, bb_max, nrm, q, r, e1, e2, np0, attr_fields):
    """Leaf blocks of the "tri_mxu" kind, (B, 16, 640): lanes 0:512 the solve
    table F (the denom | t | beta | gamma columns of the Cramer solve written
    as one product with the ray features [d | o | o x d | 1]), lanes 512:640
    the attribute table [valid, mat, n0, n1, n2]. -> as _pack_leaf_blocks."""
    (pk_bb, pk_links, pk_cbb, pk_crange, _, order, pad, safe,
     n_blocks) = _leaf_tree(bb_min, bb_max)

    def ro(a):
        """(P,) or (P, 3) -> padded and reordered (n_blocks, LANES[, 3])."""
        vals = np.asarray(a, np.float64)[safe]
        vals[pad] = 0.0
        return vals.reshape((n_blocks, LANES) + vals.shape[1:])

    pk = np.zeros((n_blocks, NF["tri_mxu"], MXU_LANES), np.float32)
    nrm_o, q_o, r_o = ro(nrm), ro(q), ro(r)
    e1_o, e2_o, np0_o = ro(e1), ro(e2), ro(np0)
    for ax in range(3):
        pk[:, ax, 0:128] = nrm_o[:, :, ax]          # denom: d . n
        pk[:, 3 + ax, 128:256] = nrm_o[:, :, ax]    # t: o-part = n
        pk[:, ax, 256:384] = q_o[:, :, ax]          # beta: d-part
        pk[:, 6 + ax, 256:384] = e2_o[:, :, ax]     # beta: (o x d)-part = dd
        pk[:, ax, 384:512] = r_o[:, :, ax]          # gamma: d-part
        pk[:, 6 + ax, 384:512] = -e1_o[:, :, ax]    # gamma: (o x d)-part = -a
    pk[:, 9, 128:256] = -np0_o                      # t: const = -(n . p0)
    for i, f in enumerate(attr_fields):
        pk[:, i, 512:640] = ro(f)
    return pk_bb, pk_links, pk_cbb, pk_crange, pk


def _triangle_group(mesh_list, solver, dtype, device) -> triangles.TriangleGroup:
    """The merged triangle pool of `mesh_list` as tensors on `device`."""
    tri = _build_triangles(mesh_list, solver)

    def vec(x):
        return Vec3(*(torch.as_tensor(c, dtype=dtype, device=device)
                      for c in np.asarray(x, np.float64).reshape(-1, 3).T))

    names = ("pk_bb", "pk_links", "pk_cbb", "pk_crange", "pk_tri")
    return triangles.TriangleGroup(
        **{k: vec(tri[k]) for k in ("p0", "edge_a", "edge_d", "n0", "n1", "n2")},
        mat_id=torch.as_tensor(np.asarray(tri["mat_id"], np.int32), device=device),
        **{k: torch.as_tensor(tri[k], device=device) for k in names})


def _build_triangles(mesh_list, solver=None) -> dict:
    """Merge all meshes into one triangle pool -> host arrays: the
    per-triangle data in thin-BVH leaf order (padding rows get mat_id -2), as
    the JAX package orders it, and the kernels' fat-leaf BVH, coarse cut and
    leaf blocks: the Cramer format, or with solver "mxu" (None reads
    RAYSNAIL_MESH_SOLVER here, at compile time) the feature-product format."""
    from raysnail_tpu_torch.io.obj import vertex_normals

    if solver is None:
        solver = os.environ.get("RAYSNAIL_MESH_SOLVER", "cramer")
    parts = {k: [] for k in ("p0", "p1", "p2", "n0", "n1", "n2", "mat")}
    for spec, mat in mesh_list:
        v = np.asarray(spec.vertices, np.float64)
        faces = np.asarray(spec.indices, np.int32)
        n = (vertex_normals(v, faces) if spec.normals is None
             else np.asarray(spec.normals, np.float64))
        for c in range(3):
            parts[f"p{c}"].append(v[faces[:, c]])
            parts[f"n{c}"].append(n[faces[:, c]])
        parts["mat"].append(np.full(len(faces), mat, np.int32))
    p0, p1, p2, n0, n1, n2, mat = (np.concatenate(parts[k]) for k in
                                   ("p0", "p1", "p2", "n0", "n1", "n2", "mat"))

    bb_min = np.minimum(np.minimum(p0, p1), p2)
    bb_max = np.maximum(np.maximum(p0, p1), p2)
    order = build_bvh(bb_min, bb_max).prim_order
    pad = order < 0
    safe = np.where(pad, 0, order)

    def reorder(a):
        out = a[safe].copy()
        out[pad] = 0.0
        return out

    p0o, p1o, p2o = reorder(p0), reorder(p1), reorder(p2)
    e1, e2 = p0 - p1, p0 - p2
    ones = np.ones(len(p0))
    normals = [n[:, c] for n in (n0, n1, n2) for c in range(3)]
    if solver == "mxu":
        nrm = np.cross(e1, e2)          # n = a x dd
        packed = _pack_mxu_blocks(
            bb_min, bb_max, nrm, np.cross(p0, e2), np.cross(e1, p0), e1, e2,
            np.sum(nrm * p0, axis=1), [ones, mat.astype(np.float64), *normals])
    else:
        packed = _pack_leaf_blocks(
            bb_min, bb_max,
            [p0[:, 0], p0[:, 1], p0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
             e2[:, 0], e2[:, 1], e2[:, 2], ones, *normals, mat.astype(np.float64)])
    return dict(p0=p0o, edge_a=p0o - p1o, edge_d=p0o - p2o,
                n0=reorder(n0), n1=reorder(n1), n2=reorder(n2),
                mat_id=np.where(pad, -2, mat[safe]).astype(np.int32),
                **dict(zip(("pk_bb", "pk_links", "pk_cbb", "pk_crange", "pk_tri"), packed)))
