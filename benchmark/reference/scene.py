"""A configuration's scene as the plain reference's tables: one material and
one texture row per object, the spheres, the axis-aligned boxes and the
camera. Built from the configuration file, never from anything the
program made.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.vec import V3

LAMBERTIAN, DIFFUSE_LIGHT = 0, 5
CONSTANT, CHECKER = 0, 1
MATERIALS = {"lambertian": LAMBERTIAN, "diffuse_light": DIFFUSE_LIGHT}


class Camera(NamedTuple):
    origin: V3
    lb: V3
    horizontal_full: V3
    vertical_full: V3
    horizontal_unit: V3
    vertical_unit: V3
    aperture: torch.Tensor


class Tables(NamedTuple):
    """The rows the gradient reaches: texture colors (odd / constant in
    color1, checker-even in color2) and the emitters' multipliers."""
    color1: V3
    color2: V3
    emit: torch.Tensor


class Scene(NamedTuple):
    dtype: torch.dtype
    device: torch.device
    kinds: frozenset           # material kinds present
    mat_kind: torch.Tensor     # (M,) int64
    mat_tex: torch.Tensor      # (M,) int64
    tex_kind: torch.Tensor     # (T,) int64
    tex_scale: torch.Tensor    # (T,)
    tables: Tables
    sph_center: V3 | None      # (S,)
    sph_r2: torch.Tensor | None
    sph_radius: torch.Tensor | None
    sph_mat: torch.Tensor | None
    box_lo: V3 | None          # (B,)
    box_hi: V3 | None
    box_mat: torch.Tensor | None
    lights: V3 | None          # (L,) sphere-light centers
    bg: tuple                  # (bottom, top) V3 of 0-d tensors
    camera: Camera


def _camera(cam: dict, width: int, height: int, dtype, device) -> Camera:
    def vec(v):
        return V3(*(torch.full((), float(c), dtype=dtype, device=device) for c in v))

    focus = float(cam.get("focus_distance", 1.0))
    lf, la, up = vec(cam["look_from"]), vec(cam["look_at"]), vec(cam.get("vup", (0, 1, 0)))
    h = math.tan(math.radians(cam["fov"]) / 2.0)
    vh = 2.0 * h * focus
    vw = vh * (width / height)
    w = (la - lf).unit()
    hu = w.cross(up).unit()
    vu = hu.cross(w).unit()
    full_u, full_v = hu * vw, vu * vh
    lb = lf - full_u * 0.5 - full_v * 0.5 + w * focus
    return Camera(lf, lb, full_u, full_v, hu, vu,
                  torch.tensor(float(cam.get("aperture", 0.0)), dtype=dtype, device=device))


def build(config: dict, width: int, height: int, dtype=torch.float32,
          device="cpu") -> Scene:
    """The reference's scene of a configuration (its "scene" object) at an
    image size, in `dtype` (float32; bfloat16 for the precision control)."""
    device = torch.device(device)
    scene = config["scene"]
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype, device=device)

    def ints(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    mats, texs, c1, c2, emit = [], [], [], [], []
    sph, box, lights = [], [], []
    for obj in scene["objects"]:
        m = obj["material"]
        tex = m["texture"]
        if m["kind"] not in MATERIALS or tex["kind"] not in ("constant", "checker"):
            raise NotImplementedError(f"the reference has no {m['kind']} / {tex['kind']}")
        row = len(mats)
        mats.append(MATERIALS[m["kind"]])
        texs.append((CONSTANT, 0.0) if tex["kind"] == "constant" else (CHECKER, tex["scale"]))
        c1.append(tex["color"] if tex["kind"] == "constant" else tex["odd"])
        c2.append(tex["color"] if tex["kind"] == "constant" else tex["even"])
        emit.append(m.get("multiplier", 0.0))
        if obj["kind"] == "sphere":
            sph.append((obj["center"], obj["radius"], row))
            if obj.get("light"):
                lights.append(obj["center"])
        elif obj["kind"] == "box":
            if "transform" in obj:
                raise NotImplementedError("the reference has no oriented box")
            box.append((obj["min"], obj["max"], row))
        else:
            raise NotImplementedError(f"the reference has no {obj['kind']}")
    c1, c2 = np.asarray(c1, np.float64), np.asarray(c2, np.float64)
    tables = Tables(V3(*(f(c1[:, i]) for i in range(3))), V3(*(f(c2[:, i]) for i in range(3))),
                    f(emit))

    def vec(rows):
        a = np.asarray(rows, np.float64).reshape(-1, 3)
        return V3(*(f(a[:, i]) for i in range(3)))

    bg = scene["background"]
    radius = f([s[1] for s in sph]) if sph else None
    return Scene(
        dtype=dtype, device=device, kinds=frozenset(mats),
        mat_kind=ints(mats), mat_tex=ints(np.arange(len(mats))),
        tex_kind=ints([t[0] for t in texs]), tex_scale=f([t[1] for t in texs]), tables=tables,
        sph_center=vec([s[0] for s in sph]) if sph else None,
        sph_r2=radius * radius if sph else None, sph_radius=radius,
        sph_mat=ints([s[2] for s in sph]) if sph else None,
        box_lo=vec([b[0] for b in box]) if box else None,
        box_hi=vec([b[1] for b in box]) if box else None,
        box_mat=ints([b[2] for b in box]) if box else None,
        lights=vec(lights) if lights else None,
        bg=(vec([bg["bottom"]]).at(0), vec([bg["top"]]).at(0)),
        camera=_camera(scene["camera"], width, height, dtype, device))
