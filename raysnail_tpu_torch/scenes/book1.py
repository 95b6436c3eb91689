"""Book-1 final scene: the random-balls field (reference examples/common/
scene.rs:23-208 + examples/rtow_13_1.rs), drawn as the JAX package's
`scenes/book1.py` draws it, on the port's builder and camera.

Layout: 22x22 jittered grid, 80/15/5 diffuse/metal/glass mix, avoid bands,
three big balls, checker ground, and rtow_13_1's light sphere and sky
gradient. The draw is numpy's `default_rng(seed)`, as in the JAX package,
so a seed gives the same balls in both packages (the reference's ChaCha12
stream is not reproduced: the scene is statistically, not bitwise, the
reference's). `need_speed` gives each small ball an upward speed, drawn
after its material, and `balls_camera(need_shutter=True)` opens the shutter
for the motion blur.
"""

from __future__ import annotations

import numpy as np

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.scene import SceneBuilder


def generate_layout(seed: int = 7, need_speed: bool = False) -> list:
    """The small-ball draw of scene.rs:23-76 as plain data. Each entry:
    {center, kind, color?, fuzz?, ior?, speed}. `rng.normal()` in the reference is
    uniform [0,1)."""
    rng = np.random.default_rng(seed)
    out = []
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array([0.9 * rng.random() + a, 0.2 + rng.random() * 0.9,
                               0.9 * rng.random() + b])
            ax = abs(center[0])
            avoid = np.array([center[0], 0.2, 0.0])
            in_band = (0.0 <= ax < 0.9) or (3.1 <= ax < 4.9)
            if (not in_band) or np.linalg.norm(center - avoid) >= 0.9:
                entry = {"center": [round(float(c), 9) for c in center]}
                mat_u = rng.random()
                if mat_u < 0.8:
                    entry["kind"] = "lambertian"
                    entry["color"] = [round(float(rng.random()), 9) for _ in range(3)]
                elif mat_u < 0.95:
                    entry["color"] = [round(0.5 + 0.5 * float(rng.random()), 9)
                                      for _ in range(3)]
                    fuzz = float(rng.random()) * 0.5
                    if fuzz < 0.1:
                        entry["kind"] = "metal"
                    else:
                        entry["kind"] = "diffuse_metal"
                        entry["fuzz"] = round(fuzz, 9)
                else:
                    entry["kind"] = "dielectric"
                    entry["ior"] = 1.5
                entry["speed"] = ([0.0, round(float(rng.random()) * 0.5, 9), 0.0]
                                  if need_speed else [0.0, 0.0, 0.0])
                out.append(entry)
    return out


def _material_of(entry: dict):
    kind = entry["kind"]
    if kind == "lambertian":
        return ir.Lambertian(ir.Constant(tuple(entry["color"])))
    if kind == "metal":
        return ir.Metal(ir.Constant(tuple(entry["color"])))
    if kind == "diffuse_metal":
        # fuzz in (0.1, 0.5) -> exponent fuzz*1000 (examples/common/scene.rs:61)
        return ir.DiffuseMetal(entry["fuzz"] * 1000.0, ir.Constant(tuple(entry["color"])))
    return ir.Dielectric((1.0, 1.0, 1.0), entry["ior"], schlick=True)


def balls_scene(seed: int = 7, need_speed: bool = False) -> SceneBuilder:
    """scene.rs:162-191 (+ rtow_13_1.rs light and sky)."""
    builder = SceneBuilder()
    ground = ir.Lambertian(ir.Checker(ir.Constant((0.3, 0.3, 0.3)),
                                      ir.Constant((0.1, 0.1, 0.1)), 10.0))
    builder.add(ir.Sphere((0.0, -1000.0, 0.0), 1000.0, ground))
    for entry in generate_layout(seed, need_speed):
        builder.add(ir.Sphere(tuple(entry["center"]), 0.2, _material_of(entry),
                              speed=tuple(entry["speed"])))
    # scene.rs:137-160, the three big balls
    builder.add(ir.Sphere((0.0, 1.0, 0.0), 1.0, ir.Dielectric((1, 1, 1), 1.5, schlick=True)))
    builder.add(ir.Sphere((-4.0, 1.0, 0.0), 1.0, ir.Lambertian(ir.Constant((0.4, 0.2, 0.1)))))
    builder.add(ir.Sphere((4.0, 1.0, 0.0), 1.0, ir.Metal(ir.Constant((0.7, 0.6, 0.5)))))
    builder.add(ir.Sphere((300.0, 400.0, 100.0), 12.0,
                          ir.DiffuseLight(ir.Constant((1.0, 0.9, 0.7)), 1.5)), light=True)
    # rtow_13_1.rs:41-45 sky
    builder.set_background((0.3, 0.4, 0.5), (0.7, 0.89, 1.0))
    return builder


def balls_camera(width: int, height: int, need_shutter: bool = False, device="cuda"):
    """scene.rs:193-208: 13,2,3 -> origin, fov 20, aperture 0.02, focus 10."""
    return build_camera(look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0), fov=20.0,
                        aperture=0.02, focus_distance=10.0,
                        shutter_speed=1.0 if need_shutter else 0.0,
                        width=width, height=height, device=device)
