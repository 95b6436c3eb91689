"""L1 texture table: batched texture evaluation (reference: src/texture/).

Textures live in one SoA table; evaluation computes every mode present in
the scene (static knowledge from scene compile) for the whole ray batch and
selects by the per-ray texture id. Rows are fetched with index gathers.

  CONSTANT      solid color (color.rs:61-65)
  CHECKER       3-D sign of sin(s x) sin(s y) sin(s z) (checker.rs:22-29)
  CHECKER_DEEP  checkers with non-constant or checker children, descended
                to the scene's static nesting depth (checker.rs:8-28)

  IMAGE         nearest-neighbor uv lookup in the image atlas, v flipped,
                edge clamp (image.rs:36-49)
  PERLIN*       lattice noise with none / linear / Hermitian smoothing, float
                or gradient-vector lattice, plain, turbulence and marble
                (noise.rs). The lattice values come from an fmix32 hash of
                the lattice point, as in the JAX package (whose table walk
                became this hash), bit for bit: uint32 arithmetic is
                emulated in int64 as in `prelude.rng`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude.rng import MASK, _fmix32
from raysnail_tpu_torch.prelude.vec import Vec3

CONSTANT = 0
CHECKER = 1
IMAGE = 2
PERLIN = 3
PERLIN_TURB = 4
PERLIN_MARBLE = 5
# pseudo-mode (never a row ttype): in the scene's static mode set when some
# checker has non-constant children
CHECKER_DEEP = 6


class TextureTable(NamedTuple):
    ttype: torch.Tensor     # (T,) int32
    color1: Vec3            # (T,) constant color / checker odd
    color2: Vec3            # (T,) checker even
    scale: torch.Tensor     # (T,) checker scale
    child1: torch.Tensor    # (T,) int32 checker odd-child row, -1
    child2: torch.Tensor    # (T,) int32 checker even-child row, -1
    image_id: torch.Tensor | None = None   # (T,) int32 index into atlas, -1 if none
    depth: torch.Tensor | None = None      # (T,) int32 turbulence depth
    # image atlas (None when the scene has no image textures)
    atlas: torch.Tensor | None = None      # (I, maxH, maxW, 3) float32
    atlas_wh: torch.Tensor | None = None   # (I, 2) int32 (width, height)
    # Perlin lattice parameters (None when the scene has no Perlin textures)
    perlin_id: torch.Tensor | None = None      # (T,) int32 row into them, -1
    perlin_seed: torch.Tensor | None = None    # (P,) int64 holding the uint32 seed
    perlin_is_vec: torch.Tensor | None = None  # (P,) bool
    perlin_smooth: torch.Tensor | None = None  # (P,) int32: 0 none / 1 linear / 2 hermitian


def _checker_sign(table, tid, p: Vec3):
    """True on odd cells: sin(s x) sin(s y) sin(s z) < 0 (checker.rs:22-29)."""
    s = table.scale[tid]
    return torch.sin(s * p.x) * torch.sin(s * p.y) * torch.sin(s * p.z) < 0.0


def _image(table, tid, u, v) -> Vec3:
    img_id = torch.clamp_min(table.image_id[tid], 0).long()
    w = table.atlas_wh[img_id, 0]
    h = table.atlas_wh[img_id, 1]
    vv = 1.0 - v
    px = torch.minimum(torch.clamp_min((u * w).to(torch.int32), 0), w - 1).long()
    py = torch.minimum(torch.clamp_min((vv * h).to(torch.int32), 0), h - 1).long()
    rgb = table.atlas[img_id, py, px]  # (N, 3)
    return Vec3(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def _lattice_corner(seed, xi, yi, zi):
    """(fval, gx, gy, gz) of one lattice point from an fmix32 avalanche hash:
    fval uniform [0, 1), g uniform on the unit sphere (noise.rs:41-70,
    vec3.rs:91-96). seed, xi, yi, zi: int64 tensors; the lattice indices may
    be negative and are read as uint32."""
    h = ((xi & MASK) * 0x8DA6B343) & MASK
    h = h ^ (((yi & MASK) * 0xD8163841) & MASK)
    h = h ^ (((zi & MASK) * 0xCB1AB31F) & MASK)
    h = _fmix32(h ^ seed)
    h2 = _fmix32(h ^ 0x68BC21EB)
    h3 = _fmix32(h2 ^ 0x02E5BE93)
    to_u = lambda x: (x >> 8).to(torch.float32) * (1.0 / 16777216.0)
    u1, u2, fval = to_u(h), to_u(h2), to_u(h3)
    # random_unit construction (vec3.rs:91-96): azimuth + uniform z
    a = (2.0 * math.pi) * u1
    z = 2.0 * u2 - 1.0
    rad = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return fval, rad * torch.cos(a), rad * torch.sin(a), z


def _perlin_noise(table, pid, p: Vec3):
    """Lattice noise with the reference's three smoothing modes
    (noise.rs:97-137, 156-189), the 8 corners unrolled. smooth codes: 0 =
    none (nearest lattice point at 4x scale), 1 = linear, 2 = Hermitian."""
    smooth = table.perlin_smooth[pid]
    seed = table.perlin_seed[pid]
    is_vec = table.perlin_is_vec[pid]

    fi, fj, fk = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    i, j, k = fi.to(torch.int64), fj.to(torch.int64), fk.to(torch.int64)
    u, v, w = p.x - fi, p.y - fj, p.z - fk
    hermite = smooth == 2
    uu = torch.where(hermite, u * u * (3.0 - 2.0 * u), u)
    vv = torch.where(hermite, v * v * (3.0 - 2.0 * v), v)
    ww = torch.where(hermite, w * w * (3.0 - 2.0 * w), w)

    total = torch.zeros_like(u)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                fval, gx, gy, gz = _lattice_corner(seed, i + di, j + dj, k + dk)
                weight_v = gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                corner = torch.where(is_vec, weight_v, fval)
                wgt = ((di * uu + (1 - di) * (1.0 - uu))
                       * (dj * vv + (1 - dj) * (1.0 - vv))
                       * (dk * ww + (1 - dk) * (1.0 - ww)))
                total = total + wgt * corner

    # SmoothType::None (noise.rs:99-110): nearest lattice point at 4x scale;
    # the vector branch returns v.x (noise.rs:104-108)
    nf, ngx, _, _ = _lattice_corner(seed, (4.0 * p.x).to(torch.int64),
                                    (4.0 * p.y).to(torch.int64), (4.0 * p.z).to(torch.int64))
    return torch.where(smooth == 0, torch.where(is_vec, ngx, nf), total)


MAX_TURB_DEPTH = 7


def _turbulence(table, pid, p: Vec3, depth):
    """noise.rs:139-153, unrolled to MAX_TURB_DEPTH octaves."""
    acc = torch.zeros_like(p.x)
    weight = 1.0
    q = p
    for octave in range(MAX_TURB_DEPTH):
        n = _perlin_noise(table, pid, q)
        acc = acc + torch.where(octave < depth, weight * n, torch.zeros_like(n))
        weight = weight * 0.5
        q = q * 2.0
    return torch.abs(acc)


def _eval_base(table: TextureTable, tid, u, v, p: Vec3, modes: frozenset) -> Vec3:
    """Every non-checker mode for row `tid`, selected by the row's type."""
    out = table.color1.take(tid)  # CONSTANT is the base case
    tt = table.ttype[tid]
    if IMAGE in modes:
        out = Vec3.where(tt == IMAGE, _image(table, tid, u, v), out)
    if modes & {PERLIN, PERLIN_TURB, PERLIN_MARBLE}:
        pid = torch.clamp_min(table.perlin_id[tid], 0).long()
        scale = table.scale[tid]
        if PERLIN in modes:
            n = _perlin_noise(table, pid, p * scale)
            # the vector lattice remaps to [0, 1] (noise.rs:193-199)
            n = torch.where(table.perlin_is_vec[pid], 0.5 * (n + 1.0), n)
            out = Vec3.where(tt == PERLIN, Vec3(n, n, n), out)
        if PERLIN_TURB in modes:
            n = _turbulence(table, pid, p, table.depth[tid])
            out = Vec3.where(tt == PERLIN_TURB, Vec3(n, n, n), out)
        if PERLIN_MARBLE in modes:
            n = _turbulence(table, pid, p, table.depth[tid])
            m = (torch.sin(scale * p.z + 10.0 * n) + 1.0) * 0.5
            out = Vec3.where(tt == PERLIN_MARBLE, Vec3(m, m, m), out)
    return out


def evaluate(table: TextureTable, tex_id, u, v, p: Vec3, modes: frozenset) -> Vec3:
    """Color of texture `tex_id` (per-ray int) at (u, v, p).

    `modes` is the static set of texture types in the scene; absent modes
    are not computed. With CHECKER_DEEP, evaluation descends the checker
    tree for the static max nesting depth (the ("checker_depth", d) entry
    in modes), re-deriving the cell sign with each level's own scale, and
    lands on a non-checker row evaluated by the shared base pass."""
    tid = torch.clamp_min(tex_id, 0).long()
    out = _eval_base(table, tid, u, v, p, modes)
    if CHECKER not in modes:
        return out
    is_checker = table.ttype[tid] == CHECKER
    if CHECKER_DEEP in modes:
        depth = next(m[1] for m in modes
                     if isinstance(m, tuple) and m[0] == "checker_depth")
        leaf = tid
        for _ in range(max(depth, 1)):
            is_ck = table.ttype[leaf] == CHECKER
            odd = _checker_sign(table, leaf, p)
            c1 = torch.clamp_min(table.child1[leaf], 0).long()
            c2 = torch.clamp_min(table.child2[leaf], 0).long()
            leaf = torch.where(is_ck, torch.where(odd, c1, c2), leaf)
        cval = _eval_base(table, leaf, u, v, p, modes)
    else:
        odd = _checker_sign(table, tid, p)
        cval = Vec3.where(odd, table.color1.take(tid), table.color2.take(tid))
    return Vec3.where(is_checker, cval, out)
