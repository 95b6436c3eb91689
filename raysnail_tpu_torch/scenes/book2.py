"""Book-2 'all features' scene (reference examples/common/scene.rs:336-468),
the JAX package's `scenes/book2.py` on the port's builder and camera: a
ground of random-height boxes, an XZ rect light, a moving sphere, glass and
metal spheres, subsurface (a glass boundary with a medium inside), world
fog, an image-mapped planet and a Perlin sphere. The reference builds a
1000-sphere cube but never adds it to the world (its TfFacade at
scene.rs:448-453 is dropped), so it is absent here too.
"""

from __future__ import annotations

import os

import numpy as np

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.scene import SceneBuilder

WHITE_GLASS = ir.Dielectric((1.0, 1.0, 1.0), 1.5, schlick=True)
EARTH_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_earth_procedural.png")


def _earth_texture() -> ir.TextureSpec:
    """The reference loads examples/earth-map.png; this is the JAX package's
    procedural planet (same pixels), written next to this module at first
    use: to a temporary name, then renamed, so that processes building it at
    once never read a partial file."""
    if not os.path.exists(EARTH_PATH):
        from PIL import Image

        h, w = 128, 256
        yy, xx = np.mgrid[0:h, 0:w]
        lat = (yy / h - 0.5) * np.pi
        lon = (xx / w) * 2 * np.pi
        # a few blobby "continents" from low-frequency sines
        land = (np.sin(3 * lon + 1.3) * np.cos(2 * lat)
                + 0.6 * np.sin(5 * lon - 0.7) * np.cos(3 * lat + 0.4))
        ocean = np.stack([0.05 + 0 * lat, 0.2 + 0 * lat, 0.55 + 0 * lat], -1)
        landc = np.stack([0.15 + 0 * lat, 0.45 + 0 * lat, 0.15 + 0 * lat], -1)
        img = np.where((land > 0.35)[..., None], landc, ocean)
        img = np.where((np.abs(lat) > 1.25)[..., None], 0.9, img)
        tmp = f"{EARTH_PATH}.{os.getpid()}.tmp"
        Image.fromarray((img * 255).astype(np.uint8)).save(tmp, format="PNG")
        os.replace(tmp, EARTH_PATH)
    return ir.ImageTex(EARTH_PATH)


def all_feature_scene(seed: int = 7) -> SceneBuilder:
    rng = np.random.default_rng(seed)
    b = SceneBuilder()

    # ground: 20x20 boxes of random height (scene.rs:341-358)
    ground = ir.Lambertian(ir.Constant((0.48, 0.83, 0.53)))
    w = 100.0
    for i in range(20):
        for j in range(20):
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            y1 = 1.0 + rng.random() * 99.0
            b.add(ir.Box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))

    # ceiling light (scene.rs:362-366)
    b.add(ir.Rect(1, 554.0, 123.0, 423.0, 147.0, 412.0,
                  ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 7.0)), light=True)

    # moving sphere (scene.rs:368-375)
    b.add(ir.Sphere((400.0, 400.0, 200.0), 50.0, ir.Lambertian(ir.Constant((0.7, 0.3, 0.1))),
                    speed=(30.0, 0.0, 0.0)))

    b.add(ir.Sphere((260.0, 150.0, 45.0), 50.0, WHITE_GLASS))
    b.add(ir.Sphere((0.0, 150.0, 145.0), 50.0, ir.Metal(ir.Constant((0.8, 0.8, 0.9)))))

    # subsurface: glass boundary + blue interior medium (scene.rs:391-405)
    b.add(ir.Sphere((360.0, 170.0, 145.0), 70.0, WHITE_GLASS))
    b.add(ir.ConstantMedium(ir.Sphere((360.0, 170.0, 145.0), 70.0), 0.2, (0.2, 0.4, 0.9)))

    # thin world fog (scene.rs:407-415)
    b.add(ir.ConstantMedium(ir.Sphere((0.0, 0.0, 0.0), 5000.0), 0.0001, (1.0, 1.0, 1.0)))

    # image-mapped planet (scene.rs:417-421)
    b.add(ir.Sphere((400.0, 200.0, 400.0), 100.0, ir.Lambertian(_earth_texture())))

    # perlin noise sphere (scene.rs:424-430)
    b.add(ir.Sphere((220.0, 280.0, 300.0), 80.0,
                    ir.Lambertian(ir.Noise(kind="normal", scale=0.1, vector=True))))

    b.set_background((0.0, 0.0, 0.0))
    return b


def book2_camera(width: int, height: int, device="cuda"):
    """scene.rs:461-466: 478,278,-600 -> 278,278,0, fov 40, shutter 1."""
    return build_camera(look_from=(478.0, 278.0, -600.0), look_at=(278.0, 278.0, 0.0),
                        fov=40.0, shutter_speed=1.0, width=width, height=height, device=device)
