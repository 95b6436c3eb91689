"""A configuration's scene lowered onto the program: its objects through
the port's `SceneBuilder` (what `sdl.driver.build_scene` calls for an SDL
file), its camera through `build_camera`, and the cell's `RenderConfig`."""

from __future__ import annotations

import time


def _texture(ir, tex: dict):
    if tex["kind"] == "constant":
        return ir.Constant(tuple(tex["color"]))
    if tex["kind"] == "checker":
        return ir.Checker(ir.Constant(tuple(tex["odd"])), ir.Constant(tuple(tex["even"])),
                          float(tex["scale"]))
    raise ValueError(f"unknown texture kind {tex['kind']!r}")


def _material(ir, m: dict):
    tex = _texture(ir, m["texture"])
    if m["kind"] == "lambertian":
        return ir.Lambertian(tex)
    if m["kind"] == "diffuse_light":
        return ir.DiffuseLight(tex, float(m["multiplier"]))
    raise ValueError(f"unknown material kind {m['kind']!r}")


def builder(config: dict):
    """The port's SceneBuilder holding the configuration's objects."""
    from raysnail_tpu_torch import ir
    from raysnail_tpu_torch.scene import SceneBuilder

    scene = config["scene"]
    b = SceneBuilder()
    for obj in scene["objects"]:
        mat = _material(ir, obj["material"])
        if obj["kind"] == "sphere":
            b.add(ir.Sphere(tuple(obj["center"]), float(obj["radius"]), mat),
                  light=bool(obj.get("light")))
        elif obj["kind"] == "box":
            b.add(ir.Box(tuple(obj["min"]), tuple(obj["max"]), mat))
        else:
            raise ValueError(f"unknown object kind {obj['kind']!r}")
    b.set_background(tuple(scene["background"]["bottom"]), tuple(scene["background"]["top"]))
    return b


def render_config(config: dict, traffic: dict):
    from raysnail_tpu_torch.config import RenderConfig

    return RenderConfig(width=traffic["width"], height=traffic["height"],
                        samples=traffic["samples"], max_depth=config["max_depth"],
                        passes=traffic.get("passes", 1))


def camera(config: dict, cfg, device):
    from raysnail_tpu_torch.camera import build_camera

    cam = config["scene"]["camera"]
    return build_camera(look_from=tuple(cam["look_from"]), look_at=tuple(cam["look_at"]),
                        vup=tuple(cam.get("vup", (0.0, 1.0, 0.0))), fov=float(cam["fov"]),
                        aperture=float(cam.get("aperture", 0.0)),
                        focus_distance=float(cam.get("focus_distance", 1.0)),
                        width=cfg.width, height=cfg.height, dtype=cfg.dtype, device=device)


def compile_scene(config: dict, cfg, device):
    """-> (scene, camera, seconds of the host clock around the compile: the
    BVH build, the packing and the upload included)."""
    import torch

    t0 = time.perf_counter()
    scene = builder(config).compile(cfg.dtype, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return scene, camera(config, cfg, device), dt

