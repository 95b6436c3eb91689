"""Thin-lens look-at camera and batched ray generation.

The reference camera model (src/camera.rs:34-91) and the painter's
stratified subpixel sampling with its y-flipped uv mapping
(src/painter.rs:131-187), as one vectorized ray-generation stage.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude import sampling
from raysnail_tpu_torch.prelude.vec import Vec3


class Ray(NamedTuple):
    """A batch of rays (reference src/prelude/ray.rs)."""

    origin: Vec3
    direction: Vec3      # unit length
    time: torch.Tensor   # departure time in [0, shutter_speed)


class Camera(NamedTuple):
    """Precomputed camera frame (reference camera.rs:36-73): 0-d tensors."""

    origin: Vec3
    lb: Vec3                 # lower-left viewport corner
    horizontal_full: Vec3    # full viewport u edge
    vertical_full: Vec3      # full viewport v edge
    horizontal_unit: Vec3
    vertical_unit: Vec3
    aperture: torch.Tensor
    shutter_speed: torch.Tensor


def build_camera(
    look_from,
    look_at,
    vup=(0.0, 1.0, 0.0),
    fov: float = 90.0,
    aspect_ratio: float | None = None,
    aperture: float = 0.0,
    focus_distance: float = 1.0,
    shutter_speed: float = 0.0,
    width: int = 400,
    height: int = 200,
    dtype=torch.float32,
    device=None,
) -> Camera:
    """CameraBuilder equivalent (camera.rs:300-414 defaults: fov 90,
    aperture 0, focus 1, 400x200)."""
    if aspect_ratio is None:
        aspect_ratio = width / height

    def vec(v):
        return Vec3.full(tuple(v), (), dtype, device)

    lf, la, up = vec(look_from), vec(look_at), vec(vup)

    h = math.tan(math.radians(fov) / 2.0)
    viewport_height = 2.0 * h * focus_distance
    viewport_width = viewport_height * aspect_ratio

    w = (la - lf).unit()
    horizontal_unit = w.cross(up).unit()
    vertical_unit = horizontal_unit.cross(w).unit()

    viewport_u = horizontal_unit * viewport_width
    viewport_v = vertical_unit * viewport_height
    lb = lf - viewport_u * 0.5 - viewport_v * 0.5 + w * focus_distance

    return Camera(
        origin=lf,
        lb=lb,
        horizontal_full=viewport_u,
        vertical_full=viewport_v,
        horizontal_unit=horizontal_unit,
        vertical_unit=vertical_unit,
        aperture=torch.tensor(aperture, dtype=dtype, device=device),
        shutter_speed=torch.tensor(shutter_speed, dtype=dtype, device=device),
    )


def camera_ray(cam: Camera, u, v, keys) -> Ray:
    """Rays through viewport coords (u, v) with lens + time jitter
    (camera.rs:77-85). `keys` is the per-ray key batch (prelude.rng)."""
    u1, u2, u3 = prng.ray_uniforms(prng.fold_all(keys, prng.LENS), 3, u.dtype)
    dx, dy = sampling.unit_disk(u1, u2)
    half_ap = cam.aperture * 0.5
    offset = cam.horizontal_unit * (dx * half_ap) + cam.vertical_unit * (dy * half_ap)
    origin = cam.origin + offset
    direction = (
        cam.lb + cam.horizontal_full * u + cam.vertical_full * v - origin
    ).unit()
    time = cam.shutter_speed * u3
    return Ray(origin=origin, direction=direction, time=time)


def pixel_uv(px, py, s_i, s_j, sqrt_spp: int, width: int, height: int, keys):
    """Stratified subpixel -> viewport uv with y flip
    (painter.rs:131-139, 165-179)."""
    j1, j2 = prng.ray_uniforms(prng.fold_all(keys, prng.RAYGEN), 2, px.dtype)
    inv_s = 1.0 / sqrt_spp
    xo = px + (s_i + j1) * inv_s
    yo = py + (s_j + j2) * inv_s
    u = xo / width
    v = (height - 1.0 - yo) / height
    return u, v


def generate_rays(cam: Camera, px, py, s_i, s_j, sqrt_spp: int, width: int,
                  height: int, keys) -> Ray:
    """Pixel + stratification cell -> jittered camera ray. `keys` are the
    per-ray streams of (seed, pixel) folded with the sample id."""
    u, v = pixel_uv(px, py, s_i, s_j, sqrt_spp, width, height, keys)
    return camera_ray(cam, u, v, keys)
