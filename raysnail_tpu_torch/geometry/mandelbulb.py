"""Power-8 Mandelbulb distance field (reference: src/hittable/geometry/raymarching.rs).

The JAX package's `geometry/mandelbulb.py` for the port. The reference
sphere-traces with per-ray early exits (raymarching.rs:108-160); the JAX
package runs the same march as masked block loops that XLA fuses on the
TPU. Here the march is one call of `ops.mandelbulb_march`: on the card the
hand-written kernel K6 (`csrc/mandelbulb_march.cu`), one thread per ray,
each stopping at its own exit; on the CPU its plain PyTorch version, which
runs the same per-ray loops over a shrinking set of live lanes. Both give
the values the JAX package gives every valid lane, since its block-level
exits freeze the lanes that are done (see `ops/mandelbulb_march.py`).

  * clip the ray to the bounding sphere r = 1.3 (raymarching.rs:167-176);
  * sphere tracing with a surface threshold instead of the reference's
    linear and binary fine search;
  * DE = 0.5 ln(r) r / dr with the reference's iteration, including its
    quirk of starting the orbit at the origin (raymarching.rs:195-241),
    over DE_ITERATIONS = 24 iterations (the reference: 100);
  * central-difference normal with d = 0.01 (raymarching.rs:79-91),
    spherical uv.

Only the JAX package's single-phase march is ported: its lane-compacted
two-phase march (RAYSNAIL_BULB_COMPACT) is off by default and stays out
(ROADMAP "Not to port"), and RAYSNAIL_BULB_BLOCK sizes TPU lane blocks,
which have no counterpart here. The hit is computed without gradients, as
the JAX package stops them (geometry gradients are out of scope).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.geometry import hit as hitlib
from raysnail_tpu_torch.geometry.hit import Hit
from raysnail_tpu_torch.ops import mandelbulb_march as _march
from raysnail_tpu_torch.ops.mandelbulb_march import (  # noqa: F401  (the module's API)
    BAILOUT, DE_ITERATIONS, MAX_STEPS, POWER, RADIUS, STEP_SCALE, SURF_EPS)
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.utils.profiling import span


def distance_est(p: Vec3, iterations: int = DE_ITERATIONS):
    """-> (distance estimate, inside-set flag) at the points p: the trig-free
    DE (`ops.mandelbulb_march.distance_est`)."""
    return _march.distance_est(p.x, p.y, p.z, iterations)


def distance_est_trig(p: Vec3, iterations: int = DE_ITERATIONS):
    """Literal transcription of the reference's DE (raymarching.rs:188-241),
    with arctan2, pow, sin and cos: the equivalence oracle of
    `distance_est`, as in the JAX package. Runs every iteration on every
    lane, masking the escaped ones."""
    x = torch.zeros_like(p.x)
    y = torch.zeros_like(p.x)
    z = torch.zeros_like(p.x)
    r = torch.zeros_like(p.x)
    dr = torch.zeros_like(p.x)
    escaped = torch.zeros(p.x.shape, dtype=torch.bool, device=p.x.device)
    for _ in range(iterations):
        r_new = torch.sqrt(x * x + y * y + z * z)
        theta = torch.atan2(torch.sqrt(x * x + y * y), z) * POWER
        phi = torch.atan2(y, x) * POWER
        rp = torch.pow(r_new, POWER)
        dr_new = torch.pow(r_new, POWER - 1.0) * POWER * dr + 1.0
        st = torch.sin(theta)
        xn = rp * st * torch.cos(phi) + p.x
        yn = rp * st * torch.sin(phi) + p.y
        zn = rp * torch.cos(theta) + p.z
        esc_now = xn * xn + yn * yn + zn * zn > BAILOUT
        keep = ~escaped
        x, y, z = torch.where(keep, xn, x), torch.where(keep, yn, y), torch.where(keep, zn, z)
        r, dr = torch.where(keep, rp, r), torch.where(keep, dr_new, dr)
        escaped = escaped | esc_now
    r = torch.clamp_min(r, 1e-12)
    dr = torch.clamp_min(dr, 1e-12)
    de = 0.5 * torch.log(r) * r / dr
    return torch.where(torch.isnan(de), 0.1, de), ~escaped


class MandelbulbNode(NamedTuple):
    mat_id: int

    def hit(self, ray, t_min, t_max, active=None) -> Hit:
        """Closest surface hit of each ray, through `ops.mandelbulb_march`
        (the kernel K6 on the card). Lanes that miss, or hit outside
        (t_min, t_max), are invalid with t = BIG. Under a running profiler
        the march is a `geometry.march` span."""
        d = ray.direction
        with torch.no_grad(), span("geometry.march"):
            cols = torch.broadcast_tensors(*ray.origin, *d)
            o3, d3 = torch.stack(cols[:3]), torch.stack(cols[3:])
            act = None if active is None else active.contiguous()
            t, valid, n, u, v = _march.mandelbulb_march(o3, d3, t_min, t_max, act)
        mid = torch.full(t.shape, self.mat_id, dtype=torch.int32, device=t.device)
        return hitlib.finalize(d, t, Vec3(n[0], n[1], n[2]), u, v, mid, valid)
