"""SDL scene -> (Scene, Camera) with the reference CLI's conventions
(src/bin/raysnail.rs:311-385):

  * every `light` becomes a Sphere of radius 12 with
    DiffuseLight(color).multiplier(1.7), added to BOTH the world and the
    light-sampling list (raysnail.rs:353-362);
  * camera gets fixed aperture 0.01 and focus distance 10 (raysnail.rs:344-346);
  * fixed sky gradient (0.3,0.4,0.5) -> (0.7,0.89,1.0) (raysnail.rs:364-367);
  * max depth 8 (raysnail.rs:384).
"""

from __future__ import annotations

import torch

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.scene import SceneBuilder
from raysnail_tpu_torch.sdl.parser import SdlParser

LIGHT_RADIUS = 12.0
LIGHT_MULTIPLIER = 1.7
SKY_BOTTOM = (0.3, 0.4, 0.5)
SKY_TOP = (0.7, 0.89, 1.0)


def build_scene(filename: str, cfg: RenderConfig, device):
    """Parse an SDL file and lower it onto `device` -> (Scene, Camera)."""
    data = SdlParser.parse(filename)
    builder = SceneBuilder()
    for obj in data.objects:
        builder.add(obj)
    for light in data.lights:
        builder.add(
            ir.Sphere(tuple(light.location), LIGHT_RADIUS,
                      ir.DiffuseLight(ir.Constant(tuple(light.color)), LIGHT_MULTIPLIER)),
            light=True,
        )
    builder.set_background(SKY_BOTTOM, SKY_TOP)
    scene = builder.compile(cfg.dtype, device)

    if data.camera is None:
        raise ValueError(f"{filename}: no camera block")
    camera = build_camera(
        look_from=data.camera.location,
        look_at=data.camera.look_at,
        fov=data.camera.fov_angle,
        aperture=0.01,
        focus_distance=10.0,
        width=cfg.width,
        height=cfg.height,
        dtype=cfg.dtype,
        device=torch.device(device),
    )
    return scene, camera
