"""The Mandelbulb march: the CUDA kernel K6 and its plain PyTorch version.

`mandelbulb_march` sphere-traces rays against the power-8 Mandelbulb of the
JAX package's `geometry/mandelbulb.py` (`_march_steps` / `_march_block`,
:159-210), which XLA fuses on the TPU: no Pallas kernel stands behind it.
Per ray: clip to the bounding sphere r = RADIUS, march with steps of
max(STEP_SCALE * DE, 1e-5) until DE < SURF_EPS (a hit), t passes the
sphere's exit (a miss) or MAX_STEPS steps, then, where the ray hit inside
(t_min, t_max), the central-difference normal (six DE evaluations, d = 0.01)
and the spherical uv of the hit point.

The JAX package's early exits are block-wide (`while any(~done)`, the DE's
`while any(~escaped)`, `cond(any(hit_mask))`), and they freeze every lane
that has finished, so a loop per ray that stops at its own exit computes the
same values for every valid lane. That per-ray loop is what the reference
itself runs (raymarching.rs:108-160). The kernel runs it in one thread per
ray; the plain version runs it over a shrinking set of live lanes. Lanes
that are not valid get t = BIG, normal (0, 0, 1) and u = v = 0, whatever
their block computed in the JAX package (`combine_hits` never takes them).

On CUDA tensors `mandelbulb_march` launches `csrc/mandelbulb_march.cu`
(built at first use with nvcc into `_build/`, loaded with ctypes) or
raises; on CPU tensors it runs `mandelbulb_march_plain`. Both round every
operation alike (the kernel is built with -fmad=false and calls sqrtf,
logf, atan2f and asinf as PyTorch's CUDA kernels do), so on the
card they agree bit for bit. `mandelbulb_march.launches` counts kernel
launches only; `mandelbulb_march.rays` counts the rays handed to the march
on either device, live or not.

Division by a constant takes a tensor divisor (`prelude.vec.div_const`), so
the plain version rounds it as the CPU, the JAX package and the kernel do.
"""

from __future__ import annotations

import ctypes

import torch

from raysnail_tpu_torch.geometry.hit import BIG
from raysnail_tpu_torch.ops import _nvcc
from raysnail_tpu_torch.prelude.sampling import PI
from raysnail_tpu_torch.prelude.vec import div_const

POWER = 8.0
BAILOUT = 8.0
RADIUS = 1.3
DE_ITERATIONS = 24
MAX_STEPS = 128
SURF_EPS = 1e-3
STEP_SCALE = 0.5
NORMAL_D = 0.01   # central-difference offset of the normal (raymarching.rs:79-91)
TINY = 1e-30      # the DE's guard of 1/r and 1/rho

# FP32 operations counted from csrc/mandelbulb_march.cu, compares and selects
# included, each division, square root, log, rsqrt, atan2 and asin as one:
# one DE iteration; the DE's tail (two guards, log, two products, the
# division, the NaN select); one march step around its DE (the point, the
# hit and overshoot tests, the step); the clip and the valid test per ray;
# the normal and uv around their six DEs, per ray that hit
DE_ITER_OPS = 72
DE_TAIL_OPS = 7
STEP_OPS = 11
CLIP_OPS = 25
NORMAL_UV_OPS = 44
# bytes a ray: origin, direction and the active flag in; t, valid, normal,
# u and v out
RAY_BYTES = 6 * 4 + 1 + 4 + 1 + 3 * 4 + 2 * 4


def operations(counts: torch.Tensor, valid: torch.Tensor) -> int:
    """The FP32 operations that rays with these `stats=True` counts and
    this valid mask take in the kernel."""
    steps, march_iters, normal_iters = (int(c.sum()) for c in counts.to(torch.int64))
    n, n_valid = counts.shape[1], int(valid.sum())
    return (n * CLIP_OPS + steps * (STEP_OPS + DE_TAIL_OPS)
            + (march_iters + normal_iters) * DE_ITER_OPS
            + n_valid * (NORMAL_UV_OPS + 6 * DE_TAIL_OPS))


_lib = None


def build(verbose: bool = False) -> str:
    """Compile the kernel if its library is missing; -> the library path."""
    return _nvcc.build_cuda("mandelbulb_march", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.mandelbulb_march_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_float, ctypes.c_float,
                       ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def distance_est(px, py, pz, iterations: int = DE_ITERATIONS, counts: bool = False):
    """The trig-free DE, 0.5 ln(r) r / dr, with the reference's orbit
    (raymarching.rs:188-241): it starts at the origin, adds p each
    iteration and bails at |v|^2 > BAILOUT. The power-8 step is three
    double-angle steps from cos/sin of theta and phi, and r^8, r^7 are
    repeated squarings (the JAX package's `distance_est`, op for op).

    Each lane stops at its own escape; the live lanes are compacted after
    every iteration that lets some escape. -> (de, inside) and, with
    counts=True, the iterations each lane ran (int32)."""
    shape = px.shape
    px, py, pz = px.reshape(-1), py.reshape(-1), pz.reshape(-1)
    n = px.shape[0]
    r_out = torch.zeros_like(px)
    dr_out = torch.zeros_like(px)
    inside = torch.ones(n, dtype=torch.bool, device=px.device)
    iters = torch.zeros(n, dtype=torch.int32, device=px.device)
    idx = torch.arange(n, device=px.device)
    x = y = z = torch.zeros_like(px)
    for _ in range(iterations):
        if idx.numel() == 0:
            break
        rho2 = x * x + y * y
        r2 = rho2 + z * z
        r_new = torch.sqrt(r2)
        rho = torch.sqrt(rho2)
        inv_r = torch.reciprocal(torch.clamp_min(r_new, TINY))
        inv_rho = torch.reciprocal(torch.clamp_min(rho, TINY))
        # when rho (or r) is 0 the angles are irrelevant: arctan2's 0
        ct = torch.where(r_new > TINY, z * inv_r, 1.0)
        st = torch.where(r_new > TINY, rho * inv_r, 0.0)
        cp = torch.where(rho > TINY, x * inv_rho, 1.0)
        sp = torch.where(rho > TINY, y * inv_rho, 0.0)
        for _i in range(3):  # (c, s) -> (cos 2a, sin 2a), 3x => 8a
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r4 = r2 * r2
        rp = r4 * r4                                    # r^8
        dr_new = (r4 * r2 * r_new) * POWER * dr_out[idx] + 1.0  # r^7 * 8 * dr + 1
        xn = rp * st * cp + px[idx]
        yn = rp * st * sp + py[idx]
        zn = rp * ct + pz[idx]
        esc = xn * xn + yn * yn + zn * zn > BAILOUT
        r_out[idx] = rp
        dr_out[idx] = dr_new
        iters[idx] += 1
        if bool(esc.any()):
            inside[idx[esc]] = False
            keep = ~esc
            idx, xn, yn, zn = idx[keep], xn[keep], yn[keep], zn[keep]
        x, y, z = xn, yn, zn
    r = torch.clamp_min(r_out, 1e-12)
    dr = torch.clamp_min(dr_out, 1e-12)
    de = 0.5 * torch.log(r) * r / dr
    de = torch.where(torch.isnan(de), 0.1, de)  # NaN guard (raymarching.rs:131-133)
    out = (de.reshape(shape), inside.reshape(shape))
    return out + (iters.reshape(shape),) if counts else out


def _unit(x, y, z):
    """The port's Vec3.unit: v * (1 / sqrt(max(|v|^2, 1e-20)))."""
    inv = torch.reciprocal(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20)))
    return x * inv, y * inv, z * inv


def mandelbulb_march_plain(origin, direction, t_min, t_max, active=None, stats=False):
    """Plain PyTorch version of the march. origin, direction: (3, N) f32;
    active: (N,) bool or None. -> (t (N,), valid (N,), normal (3, N), u (N,),
    v (N,)) and, with stats=True, (3, N) int32: each ray's march steps, the
    DE iterations of its march and those of its normal."""
    ox, oy, oz = origin
    dx, dy, dz = direction
    n = ox.shape[0]
    device = ox.device
    # clip to the bounding sphere at the origin (raymarching.rs:167-176)
    half_b = dx * ox + dy * oy + dz * oz
    c = (ox * ox + oy * oy + oz * oz) - RADIUS * RADIUS
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t_enter = torch.clamp_min(-half_b - sq, t_min)
    t_exit = -half_b + sq
    in_bbox = (delta > 0.0) & (t_exit > t_min) & (t_enter < t_max)
    if active is not None:
        in_bbox = in_bbox & active

    t = torch.where(in_bbox, t_enter, BIG)
    hit = torch.zeros(n, dtype=torch.bool, device=device)
    counts = torch.zeros((3, n), dtype=torch.int32, device=device)
    idx = torch.nonzero(in_bbox).reshape(-1)
    for _ in range(MAX_STEPS):
        if idx.numel() == 0:
            break
        tl = t[idx]
        de, _, it = distance_est(ox[idx] + dx[idx] * tl, oy[idx] + dy[idx] * tl,
                                 oz[idx] + dz[idx] * tl, counts=True)
        hit_now = de < SURF_EPS
        over = tl > t_exit[idx]
        t[idx] = tl + torch.clamp_min(de * STEP_SCALE, 1e-5)
        counts[0, idx] += 1
        counts[1, idx] += it
        hit[idx[hit_now]] = True
        idx = idx[~(hit_now | over)]

    valid = hit & (t > t_min) & (t < t_max)
    t = torch.where(valid, t, BIG)
    nx = torch.zeros(n, dtype=t.dtype, device=device)
    ny = torch.zeros_like(nx)
    nz = torch.ones_like(nx)
    u = torch.zeros_like(nx)
    v = torch.zeros_like(nx)
    idx = torch.nonzero(valid).reshape(-1)
    if idx.numel():
        tv = t[idx]
        px, py, pz = ox[idx] + dx[idx] * tv, oy[idx] + dy[idx] * tv, oz[idx] + dz[idx] * tv
        m = idx.numel()
        # the six points p +- d e_axis as one batch: +x, -x, +y, -y, +z, -z
        sx = torch.cat([px + NORMAL_D, px - NORMAL_D, px, px, px, px])
        sy = torch.cat([py, py, py + NORMAL_D, py - NORMAL_D, py, py])
        sz = torch.cat([pz, pz, pz, pz, pz + NORMAL_D, pz - NORMAL_D])
        de, _, it = distance_est(sx, sy, sz, counts=True)
        de = de.reshape(6, m)
        gx, gy, gz = _unit(de[0] - de[1], de[2] - de[3], de[4] - de[5])
        nx[idx], ny[idx], nz[idx] = gx, gy, gz
        counts[2, idx] = it.reshape(6, m).sum(0, dtype=torch.int32)
        # spherical uv of the hit point (sphere.rs:64-71)
        qx, qy, qz = _unit(px, py, pz)
        phi = torch.atan2(-qz, qx)
        theta = torch.asin(torch.clamp(qy, -1.0, 1.0))
        u[idx] = div_const(phi, 2.0 * PI) + 0.5
        v[idx] = div_const(theta, PI) + 0.5
    out = (t, valid, torch.stack([nx, ny, nz]), u, v)
    return out + (counts,) if stats else out


def _check(name, a, shape, dtype, device):
    if a.device != device or a.dtype != dtype or tuple(a.shape) != shape or \
            not a.is_contiguous():
        raise ValueError(f"mandelbulb_march: {name} must be a contiguous {shape} {dtype} "
                         f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on {a.device}"
                         f"{'' if a.is_contiguous() else ' (strided)'}")


def mandelbulb_march(origin, direction, t_min, t_max, active=None, stats=False):
    """-> (t (N,) f32, valid (N,) bool, geometric normal (3, N) f32, u (N,),
    v (N,)) of N rays against the Mandelbulb, and with stats=True the (3, N)
    int32 counts of `mandelbulb_march_plain`. origin, direction: contiguous
    (3, N) f32; active: (N,) bool or None (every ray live)."""
    device = origin.device
    n = origin.shape[-1]
    _check("origin", origin, (3, n), torch.float32, device)
    _check("direction", direction, (3, n), torch.float32, device)
    if active is not None:
        _check("active", active, (n,), torch.bool, device)
    mandelbulb_march.rays += n
    if device.type == "cpu":
        return mandelbulb_march_plain(origin, direction, t_min, t_max, active, stats)
    if device.type != "cuda":
        raise ValueError(f"mandelbulb_march: unsupported device {device}")

    t = torch.empty(n, dtype=torch.float32, device=device)
    valid = torch.empty(n, dtype=torch.bool, device=device)
    normal = torch.empty((3, n), dtype=torch.float32, device=device)
    u = torch.empty(n, dtype=torch.float32, device=device)
    v = torch.empty(n, dtype=torch.float32, device=device)
    counts = torch.empty((3, n), dtype=torch.int32, device=device) if stats else None
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.mandelbulb_march_launch(
            origin.data_ptr(), direction.data_ptr(),
            None if active is None else active.data_ptr(), float(t_min), float(t_max),
            t.data_ptr(), valid.data_ptr(), normal.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if counts is None else counts.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"mandelbulb_march kernel launch failed: cudaError {err}")
    mandelbulb_march.launches += 1
    out = (t, valid, normal, u, v)
    return out + (counts,) if stats else out


mandelbulb_march.launches = 0
mandelbulb_march.rays = 0
