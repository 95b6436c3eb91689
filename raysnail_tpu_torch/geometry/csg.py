"""Constructive solid geometry: interval logic over static trees.

The reference's Intersection and Difference (src/hittable/csg/) hit both
children, order them by entry t, and probe `contains(point)` to pick the
visible surface. Scene compile lowers each CSG object, its transform pushed
down to the leaves, into a tree of the nodes below; evaluating a tree is a
straight-line chain of elementwise selects over the ray batch, with no
recursion at run time. This is the JAX package's `geometry/csg.py`; it
reaches no kernel of its own (XLA fused it on the TPU), so here it is plain
PyTorch, as `rects.py` and `quadrics.py` are.

Leaves hold their parameters as 0-d tensors and an int material (-1 =
inherit). Trees of one structure are evaluated together (`group_trees`):
their leaves' parameters are stacked along a leading axis K as (K, 1)
tensors, which broadcast against the N rays to (K, N), so a shade iteration
launches the ops of each distinct structure once (quadric.sdl's four capped
quadrics, declares.sdl's seven blades), not once per tree. A stacked
material is a (K, 1) tensor.

Values of lanes that miss are kept as the reference's arithmetic leaves
them, because the nodes compare and select them: a sphere's t1 is its far
root there, a box's t2 is BIG when the ray starts inside, rects and meshes
carry t2 = BIG. Only `CsgHit.to_hit`, at a tree's root, sets t = BIG.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import boxes, quadrics, spheres, triangles
from raysnail_tpu_torch.geometry.hit import BIG, Hit, combine_hits, miss
from raysnail_tpu_torch.prelude.vec import Vec3


def _full_mat(like: torch.Tensor, mat_id) -> torch.Tensor:
    """A material id (an int, or a stacked (K, 1) tensor) over `like`'s shape."""
    if isinstance(mat_id, int):
        return torch.full(like.shape, mat_id, dtype=torch.int32, device=like.device)
    return mat_id.to(torch.int32).expand(like.shape)


class CsgHit(NamedTuple):
    """A child hit inside a tree: the reference's full HitRecord with the
    exit distance t2 (hit.rs:16-17)."""
    t1: torch.Tensor
    t2: torch.Tensor
    valid: torch.Tensor
    normal: Vec3           # flipped against the ray (as HitRecord)
    u: torch.Tensor
    v: torch.Tensor
    mat_id: torch.Tensor
    outside: torch.Tensor

    def to_hit(self) -> Hit:
        t = torch.where(self.valid, self.t1, torch.full_like(self.t1, BIG))
        return Hit(t=t, valid=self.valid, normal=self.normal, u=self.u, v=self.v,
                   mat_id=self.mat_id, outside=self.outside)

    @staticmethod
    def select(mask, a: "CsgHit", b: "CsgHit") -> "CsgHit":
        return CsgHit(*(Vec3.where(mask, x, y) if isinstance(x, Vec3) else torch.where(mask, x, y)
                        for x, y in zip(a, b)))


# -- leaves ----------------------------------------------------------------

class SphereLeaf(NamedTuple):
    center: Vec3           # 0-d components
    radius: torch.Tensor
    mat_id: int            # -1 = inherit

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid = spheres.interval(self.center, self.radius, ray, t_min, t_max)
        p = ray.origin + ray.direction * t1
        geom_n = spheres.normal_at(self.center, self.radius, p)
        outside = ray.direction.dot(geom_n) < 0.0
        n = Vec3.where(outside, geom_n, -geom_n)
        u, v = spheres.sphere_uv(p - self.center)
        return CsgHit(t1, t2, valid, n, u, v, _full_mat(t1, self.mat_id), outside)

    def contains(self, p: Vec3):
        return spheres.contains(self.center, self.radius, p)

    def normal_at(self, p: Vec3) -> Vec3:
        return spheres.normal_at(self.center, self.radius, p)


class BoxLeaf(NamedTuple):
    p_min: Vec3
    p_max: Vec3
    inv_rows: tuple | None  # world -> object rows (None = axis-aligned)
    inv_off: Vec3 | None
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid, axis, near_sel, d_obj, o_obj = boxes.interval(
            self.p_min, self.p_max, ray, t_min, t_max, self.inv_rows, self.inv_off)
        # slab normals face the ray already; outside = entered from outside
        n = boxes.normal_of(axis, near_sel, d_obj, self.inv_rows)
        p_obj = o_obj + d_obj * t1
        span = (self.p_max - self.p_min).map(
            lambda c: torch.where(torch.abs(c) < 1e-12, torch.ones_like(c), c))
        rel = (p_obj - self.p_min) / span
        u = boxes._select_axis(rel.x, rel.y, rel.z, (axis + 1) % 3)
        v = boxes._select_axis(rel.x, rel.y, rel.z, (axis + 2) % 3)
        return CsgHit(t1, t2, valid, n, u, v, _full_mat(t1, self.mat_id), near_sel)

    def contains(self, p: Vec3):
        return boxes.contains(self.p_min, self.p_max, p, self.inv_rows, self.inv_off)

    def normal_at(self, p: Vec3) -> Vec3:
        # Box::normal is a fixed +y (box.rs:117-119), kept for the synthetic
        # exit hit of a difference
        return Vec3.full((0.0, 1.0, 0.0), p.x.shape, p.x.dtype, p.x.device)


class RectLeaf(NamedTuple):
    """An (optionally oriented) axis-aligned rect as a CSG child, as the
    reference's AARect behaves under CSG: its hit carries t2 = BIG
    (rect.rs:118), contains() is always false (rect.rs:122-125), normal() is
    the fixed plane-axis unit vector (rect.rs:84-88)."""
    k_axis: int            # 0 = YZ, 1 = XZ, 2 = XY
    k: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    inv_rows: tuple | None
    inv_off: Vec3 | None
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        o, d = ray.origin, ray.direction
        if self.inv_rows is not None:
            o = boxes._apply_rows(self.inv_rows, self.inv_off, o, translate=True)
            d = boxes._apply_rows(self.inv_rows, self.inv_off, d, translate=False)
        ax = self.k_axis
        ia, ib = (1, 0, 0)[ax], (2, 2, 1)[ax]
        ok_, oa, ob = tuple(o)[ax], tuple(o)[ia], tuple(o)[ib]
        dk, da, db = tuple(d)[ax], tuple(d)[ia], tuple(d)[ib]
        tiny = torch.where(dk < 0, torch.full_like(dk, -1e-12), torch.full_like(dk, 1e-12))
        dk = torch.where(torch.abs(dk) < 1e-12, tiny, dk)
        t1 = (self.k - ok_) / dk
        pa = oa + t1 * da
        pb = ob + t1 * db
        valid = ((t_min < t1) & (t1 < t_max) & (pa >= self.a0) & (pa <= self.a1)
                 & (pb >= self.b0) & (pb <= self.b1))
        n = self.normal_at(ray.origin)
        # the object-space direction against the world normal, as the JAX
        # package computes it
        outside = d.dot(n) < 0.0
        n = Vec3.where(outside, n, -n)
        u = (pa - self.a0) / (self.a1 - self.a0)
        v = (pb - self.b0) / (self.b1 - self.b0)
        big = torch.full_like(t1, BIG)
        return CsgHit(torch.where(valid, t1, big), big, valid, n, u, v,
                      _full_mat(t1, self.mat_id), outside)

    def contains(self, p: Vec3):
        return torch.zeros(p.x.shape, dtype=torch.bool, device=p.x.device)  # rect.rs:122-125

    def normal_at(self, p: Vec3) -> Vec3:
        n = Vec3.full(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))[self.k_axis],
                      p.x.shape, p.x.dtype, p.x.device)
        if self.inv_rows is not None:
            n = boxes._apply_rows_t(self.inv_rows, n).unit()
        return n


class MeshLeaf(NamedTuple):
    """A triangle mesh as a CSG child (the reference composes any
    Arc<dyn Hittable>, intersection.rs:19-23). Its hits carry t2 = BIG
    (triangle_mesh.rs:119-126) and contains() is always false
    (triangle_mesh.rs:133-136): inside CSG a mesh is a thin shell. normal_at,
    reached only as the minus child of a difference, is where the reference
    panics (hit.rs:82-87); it returns +y, as Box::normal does.

    `brute` (at most 32,768 triangles, as in the JAX package) takes the dense
    sweep. A bigger mesh takes `triangles.intersect_kernel`: the BVH
    traversal kernel on the card, its plain version on the CPU; the JAX
    package walks its thin BVH there, which the port does not carry."""
    group: triangles.TriangleGroup
    mat_id: int
    brute: bool

    def hit(self, ray, t_min, t_max) -> CsgHit:
        if self.brute:
            h = triangles.intersect_brute(self.group, ray, t_min, t_max)
        else:
            h = triangles.intersect_kernel(self.group, ray, t_min, t_max)
        return CsgHit(t1=h.t, t2=torch.full_like(h.t, BIG), valid=h.valid, normal=h.normal,
                      u=h.u, v=h.v, mat_id=h.mat_id, outside=h.outside)

    def contains(self, p: Vec3):
        return torch.zeros(p.x.shape, dtype=torch.bool, device=p.x.device)

    def normal_at(self, p: Vec3) -> Vec3:
        return Vec3.full((0.0, 1.0, 0.0), p.x.shape, p.x.dtype, p.x.device)


class QuadricLeaf(NamedTuple):
    coeffs: quadrics.Coeffs
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid = quadrics.interval(self.coeffs, ray, t_min, t_max)
        p = ray.origin + ray.direction * t1
        geom_n = quadrics.normal_at(self.coeffs, p)
        outside = ray.direction.dot(geom_n) < 0.0
        n = Vec3.where(outside, geom_n, -geom_n)
        z = torch.zeros_like(t1)
        return CsgHit(t1, t2, valid, n, z, z, _full_mat(t1, self.mat_id), outside)

    def contains(self, p: Vec3):
        return quadrics.contains(self.coeffs, p)

    def normal_at(self, p: Vec3) -> Vec3:
        return quadrics.normal_at(self.coeffs, p)


# -- internal nodes --------------------------------------------------------

class IntersectionNode(NamedTuple):
    left: object
    right: object
    mat_id: int   # applied where the child hit has mat_id < 0

    def hit(self, ray, t_min, t_max) -> CsgHit:
        """intersection.rs:58-96."""
        h1 = self.left.hit(ray, t_min, t_max)
        h2 = self.right.hit(ray, t_min, t_max)
        both = h1.valid & h2.valid
        first_is_1 = h1.t1 < h2.t1
        near = CsgHit.select(first_is_1, h1, h2)
        far = CsgHit.select(first_is_1, h2, h1)

        p_near = ray.origin + ray.direction * near.t1
        p_far = ray.origin + ray.direction * far.t1
        # contains() of the farther OBJECT at the nearer point, and vice versa
        c_other_at_near = torch.where(first_is_1, self.right.contains(p_near),
                                      self.left.contains(p_near))
        c_near_at_far = torch.where(first_is_1, self.left.contains(p_far),
                                    self.right.contains(p_far))
        use_near = both & c_other_at_near
        use_far = both & (~c_other_at_near) & c_near_at_far

        out = CsgHit.select(use_near, near, far)._replace(valid=use_near | use_far)
        return _override_material(out, self.mat_id)

    def contains(self, p: Vec3):
        return self.left.contains(p) & self.right.contains(p)

    def normal_at(self, p: Vec3) -> Vec3:
        return self.left.normal_at(p)


class DifferenceNode(NamedTuple):
    plus: object
    minus: object
    mat_id: int
    minus_mat_id: int  # the minus child's material, for the synthetic hit

    def hit(self, ray, t_min, t_max) -> CsgHit:
        """difference.rs:57-106."""
        hp = self.plus.hit(ray, t_min, t_max)
        hm = self.minus.hit(ray, t_min, t_max)

        p_plus = ray.origin + ray.direction * hp.t1
        plus_first = hp.t1 < hm.t1

        only_plus = hp.valid & (~hm.valid)
        both = hp.valid & hm.valid
        case_b = both & plus_first & (~self.minus.contains(p_plus))
        case_c = both & (~plus_first) & (hm.t2 < hp.t1)
        case_d = both & (~plus_first) & (hm.t2 >= hp.t1) & (hm.t2 < hp.t2)
        use_plus = only_plus | case_b | case_c

        # the synthetic exit-of-minus hit (difference.rs:85-105): the minus
        # child's NEGATED normal(p), uv = (0, 0), outside, the minus material
        t_syn = hm.t2
        p_syn = ray.origin + ray.direction * t_syn
        z = torch.zeros_like(t_syn)
        syn = CsgHit(t1=t_syn, t2=hp.t2, valid=case_d, normal=-self.minus.normal_at(p_syn),
                     u=z, v=z, mat_id=_full_mat(t_syn, self.minus_mat_id),
                     outside=torch.ones_like(case_d))
        out = CsgHit.select(use_plus, hp, syn)._replace(valid=use_plus | case_d)
        return _override_material(out, self.mat_id)

    def contains(self, p: Vec3):
        return self.plus.contains(p) & (~self.minus.contains(p))

    def normal_at(self, p: Vec3) -> Vec3:
        return self.plus.normal_at(p)


def _override_material(h: CsgHit, mat_id) -> CsgHit:
    """HitRecord::set_material_if_none (hit.rs:69-77); mat_id is an int or
    a stacked (K, 1) tensor."""
    if isinstance(mat_id, int) and mat_id < 0:
        return h
    mid = _full_mat(h.mat_id, mat_id)
    return h._replace(mat_id=torch.where((h.mat_id < 0) & (mid >= 0), mid, h.mat_id))


# -- trees -----------------------------------------------------------------

_CHILDREN = {SphereLeaf: (), BoxLeaf: (), RectLeaf: (), MeshLeaf: (), QuadricLeaf: (),
             IntersectionNode: ("left", "right"), DifferenceNode: ("plus", "minus")}


def _has_static_leaf(tree) -> bool:
    """Rect and mesh leaves carry fields that do not stack (the plane axis,
    the mesh and its route): trees that hold one are evaluated alone."""
    if isinstance(tree, (RectLeaf, MeshLeaf)):
        return True
    return any(_has_static_leaf(getattr(tree, f)) for f in _CHILDREN[type(tree)])


def _structure(x):
    """What must agree for two trees to stack: node types, nesting and which
    fields are None; not the parameters' or materials' values."""
    if isinstance(x, Vec3):
        return "vec3"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x),) + tuple(_structure(getattr(x, f)) for f in x._fields)
    if isinstance(x, tuple):
        return tuple(_structure(c) for c in x)
    return None if x is None else "leaf"


def _stack(xs, device):
    """Trees of one structure -> one tree whose leaves are (K, 1) tensors."""
    x = xs[0]
    if isinstance(x, Vec3):
        return Vec3(*(_stack([getattr(e, a) for e in xs], device) for a in "xyz"))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_stack([getattr(e, f) for e in xs], device) for f in x._fields))
    if isinstance(x, tuple):
        return tuple(_stack(list(c), device) for c in zip(*xs))
    if x is None:
        return None
    return torch.stack([torch.as_tensor(e, device=device) for e in xs]).reshape(len(xs), 1)


def _device(x):
    """The device of the first tensor in a tree."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, Vec3)):
        return next((dev for dev in map(_device, x) if dev is not None), None)
    return None


def group_trees(trees) -> tuple:
    """Group trees by structure, in the order each group first appears ->
    ((tree, k), ...): k is None for a tree evaluated alone, else the number
    K of trees stacked in `tree`."""
    groups: dict = {}
    for i, tree in enumerate(trees):
        key = ("solo", i) if _has_static_leaf(tree) else _structure(tree)
        groups.setdefault(key, []).append(tree)
    out = []
    for group in groups.values():
        if len(group) == 1:
            out.append((group[0], None))
        else:
            out.append((_stack(group, _device(group[0])), len(group)))
    return tuple(out)


def intersect_trees(groups, ray, t_min, t_max) -> Hit:
    """Closest hit over CSG trees grouped by `group_trees` (Scene keeps
    them as `csg_groups`): a stacked group is evaluated once over (K, N) and
    reduced with combine_hits in the order k = 0..K-1, as the JAX package
    reduces its vmapped groups."""
    d = ray.direction
    best = miss(d.x.shape, d.x.dtype, d.x.device)
    for tree, k in groups:
        h = tree.hit(ray, t_min, t_max).to_hit()
        if k is None:
            best = combine_hits(best, h)
            continue
        for i in range(k):
            best = combine_hits(best, _row(h, i))
    return best


def _row(h: Hit, i: int) -> Hit:
    """Row i of a (K, N) Hit."""
    pick = lambda a: torch.broadcast_to(a, h.t.shape)[i]
    return Hit(*(f.map(pick) if isinstance(f, Vec3) else pick(f) for f in h))
