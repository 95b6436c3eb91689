"""Cornell box variants (reference examples/common/scene.rs:210-334): empty,
two cartons, rotated cartons, smoke volumes. The JAX package's
`scenes/cornell.py` on the port's builder and camera.
"""

from __future__ import annotations

import math

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.camera import build_camera
from raysnail_tpu_torch.geometry import transforms as tf
from raysnail_tpu_torch.scene import SceneBuilder

RED = ir.Lambertian(ir.Constant((0.65, 0.05, 0.05)))
GREEN = ir.Lambertian(ir.Constant((0.12, 0.45, 0.15)))
WHITE = ir.Lambertian(ir.Constant((0.73, 0.73, 0.73)))


def cornell_box(carton: bool = True, carton_rotation: bool = True,
                smoke: bool = False) -> SceneBuilder:
    b = SceneBuilder()
    light = ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 7.0 if smoke else 15.0)

    # walls (scene.rs:221-241)
    b.add(ir.Rect(0, 555.0, 0.0, 555.0, 0.0, 555.0, GREEN))   # yz at x=555
    b.add(ir.Rect(0, 0.0, 0.0, 555.0, 0.0, 555.0, RED))       # yz at x=0
    b.add(ir.Rect(1, 0.0, 0.0, 555.0, 0.0, 555.0, WHITE))     # floor
    b.add(ir.Rect(1, 555.0, 0.0, 555.0, 0.0, 555.0, WHITE))   # ceiling
    b.add(ir.Rect(2, 555.0, 0.0, 555.0, 0.0, 555.0, WHITE))   # back wall

    # ceiling light (scene.rs:243-254)
    if smoke:
        b.add(ir.Rect(1, 554.0, 113.0, 443.0, 127.0, 432.0, light), light=True)
    else:
        b.add(ir.Rect(1, 554.0, 213.0, 343.0, 227.0, 332.0, light), light=True)

    if carton:
        if carton_rotation:
            m1 = ir.mat4(tf.compose([tf.rotate_y(math.radians(-18.0)),
                                     tf.translate((130.0, 0.0, 65.0))]))
            m2 = ir.mat4(tf.compose([tf.rotate_y(math.radians(15.0)),
                                     tf.translate((265.0, 0.0, 295.0))]))
            box1 = ir.Box((0.0, 0.0, 0.0), (165.0, 165.0, 165.0), WHITE, transform=m1)
            box2 = ir.Box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), WHITE, transform=m2)
        else:
            box1 = ir.Box((130.0, 0.0, 65.0), (295.0, 165.0, 230.0), WHITE)
            box2 = ir.Box((265.0, 0.0, 295.0), (430.0, 330.0, 460.0), WHITE)
        if smoke:
            # the cartons as smoke: media over the (oriented) boxes
            b.add(ir.ConstantMedium(box1, 0.01, (1.0, 1.0, 1.0)))
            b.add(ir.ConstantMedium(box2, 0.01, (0.0, 0.0, 0.0)))
        else:
            b.add(box1)
            b.add(box2)

    b.set_background((0.0, 0.0, 0.0))
    return b


def cornell_camera(width: int, height: int, device="cuda"):
    """scene.rs:327-331: 278,278,-800 -> 278,278,0, fov 40."""
    return build_camera(look_from=(278.0, 278.0, -800.0), look_at=(278.0, 278.0, 0.0),
                        fov=40.0, width=width, height=height, device=device)
