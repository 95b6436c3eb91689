"""L1 texture table: batched texture evaluation (reference: src/texture/).

Textures live in one SoA table; evaluation computes every mode present in
the scene (static knowledge from scene compile) for the whole ray batch and
selects by the per-ray texture id. Rows are fetched with index gathers.

  CONSTANT      solid color (color.rs:61-65)
  CHECKER       3-D sign of sin(s x) sin(s y) sin(s z) (checker.rs:22-29)
  CHECKER_DEEP  checkers with non-constant or checker children, descended
                to the scene's static nesting depth (checker.rs:8-28)

IMAGE and PERLIN textures are not ported yet (ROADMAP M5); scene compile
refuses them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude.vec import Vec3

CONSTANT = 0
CHECKER = 1
IMAGE = 2  # the JAX package's row type; the port refuses it at compile
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


def _checker_sign(table, tid, p: Vec3):
    """True on odd cells: sin(s x) sin(s y) sin(s z) < 0 (checker.rs:22-29)."""
    s = table.scale[tid]
    return torch.sin(s * p.x) * torch.sin(s * p.y) * torch.sin(s * p.z) < 0.0


def evaluate(table: TextureTable, tex_id, u, v, p: Vec3, modes: frozenset) -> Vec3:
    """Color of texture `tex_id` (per-ray int) at (u, v, p).

    `modes` is the static set of texture types in the scene; absent modes
    are not computed. With CHECKER_DEEP, evaluation descends the checker
    tree for the static max nesting depth (the ("checker_depth", d) entry
    in modes), re-deriving the cell sign with each level's own scale, and
    lands on a constant row."""
    tid = torch.clamp_min(tex_id, 0).long()
    out = table.color1[tid]  # CONSTANT is the base case
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
        cval = table.color1[leaf]
    else:
        odd = _checker_sign(table, tid, p)
        cval = Vec3.where(odd, table.color1[tid], table.color2[tid])
    return Vec3.where(is_checker, cval, out)
