"""Ray x sphere min-t and first-index argmin: the CUDA kernel and its plain
PyTorch version.

`sphere_min_t` is the port of the TPU kernel
`raysnail_tpu/ops/sphere_pallas.py:sphere_min_t` and keeps its signature.
On CUDA tensors it launches `csrc/sphere_min_t.cu` (built at first use with
nvcc into `_build/`, loaded with ctypes) or raises; on CPU tensors it runs
`sphere_min_t_plain`. There is no fallback from the kernel to the plain
version: a build or launch failure raises.

The moving form (`speed_xyz` and `time` given) moves each sphere's center
to c + speed * time for the ray's time, the reference's motion blur
(sphere.rs:50-52): static groups keep the kernel's static instantiation.

`sphere_min_t.launches` counts kernel launches (not plain-version calls), so
a run can show that its sphere sweeps went through the kernel.

The backward (K1b): `sphere_min_t_bwd` is the gradient of each ray's t with
respect to its origin and direction, which the winner's pair alone carries
(the JAX package's `jnp.min` gives its gradient to the arg-min entry). On
CUDA tensors it launches the second entry point of `csrc/sphere_min_t.cu`
or raises; on CPU tensors it runs `sphere_min_t_bwd_plain`.
`sphere_min_t_bwd.launches` counts its kernel launches. `SphereMinT` is
the autograd Function of the pair: forward `sphere_min_t`, backward
`sphere_min_t_bwd`; centers, radii and time get no gradient (geometry is
not a parameter).
"""

from __future__ import annotations

import ctypes

import torch

from raysnail_tpu_torch.geometry.hit import BIG
from raysnail_tpu_torch.ops import _nvcc

_lib = None


def build(verbose: bool = False) -> str:
    """Compile the kernel if its library is missing; -> the library path."""
    return _nvcc.build_cuda("sphere_min_t", verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.sphere_min_t_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 15 + [ctypes.c_float, ctypes.c_float, ptr, ptr,
                                    ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        bwd = lib.sphere_min_t_bwd_launch
        bwd.argtypes = [ptr] * 17 + [ctypes.c_float, ctypes.c_float] + [ptr] * 6 + [
            ctypes.c_int, ctypes.c_int, ptr]
        bwd.restype = ctypes.c_int
        lib.sphere_min_t_shape.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
        lib.sphere_min_t_shape.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch_shape(moving: bool) -> dict:
    """The kernel's launch shape on the current CUDA device: threads a
    block, rays a thread, spheres a shared-memory tile, and the blocks one
    SM holds at once (the occupancy calculator's count)."""
    out = [ctypes.c_int() for _ in range(4)]
    err = _load().sphere_min_t_shape(int(moving), *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"sphere_min_t_shape failed: cudaError {err}")
    return dict(zip(("threads", "rays", "tile", "blocks_per_sm"), (v.value for v in out)))


def sphere_min_t_plain(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max,
                       speed_xyz=None, time=None):
    """Plain PyTorch version: the dense (N, S) pair-t matrix, then min and
    first-index argmin. -> (t (N,) f32, idx (N,) i32). With speed_xyz (three
    (S,)) and time (N,), the centers move to c + speed * time."""
    ox, oy, oz = (a[:, None] for a in origin_xyz)
    dx, dy, dz = (a[:, None] for a in dir_xyz)
    cx, cy, cz = center_xyz
    if speed_xyz is not None:
        tm = time[:, None]
        cx = cx + speed_xyz[0] * tm
        cy = cy + speed_xyz[1] * tm
        cz = cz + speed_xyz[2] * tm
    lx = ox - cx
    ly = oy - cy
    lz = oz - cz
    half_b = dx * lx + dy * ly + dz * lz
    c = lx * lx + ly * ly + lz * lz - r2
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    ok = (delta > 0.0) & active
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    big = torch.full_like(t1, BIG)
    t = torch.where(in1, t1, torch.where(in2, t2, big))
    if t.shape[1] == 0:
        n = t.shape[0]
        return (torch.full((n,), BIG, dtype=t.dtype, device=t.device),
                torch.zeros(n, dtype=torch.int32, device=t.device))
    idx = torch.argmin(t, dim=1)  # the first index of the minimum
    return torch.gather(t, 1, idx[:, None])[:, 0], idx.to(torch.int32)


def _check(name, a, n, dtype, device):
    if a.device != device or a.dtype != dtype or a.shape != (n,) or not a.is_contiguous():
        raise ValueError(f"sphere_min_t: {name} must be a contiguous ({n},) {dtype} "
                         f"tensor on {device}, got {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}{'' if a.is_contiguous() else ' (strided)'}")


def sphere_min_t(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max,
                 speed_xyz=None, time=None):
    """-> (t_best (N,) f32, idx_best (N,) i32) for N rays against S spheres.

    origin_xyz, dir_xyz: three (N,) f32 tensors each; center_xyz: three (S,)
    f32; r2: (S,) f32 squared radii; active: (S,) bool. Misses give
    t = BIG and idx = 0; ties go to the first sphere index. speed_xyz (three
    (S,) f32) and time ((N,) f32), given together, select the moving form."""
    if (speed_xyz is None) != (time is None):
        raise ValueError("sphere_min_t: speed_xyz and time go together")
    moving = speed_xyz is not None
    device = origin_xyz[0].device
    n = origin_xyz[0].shape[0]
    s = r2.shape[0]
    for i, a in enumerate(origin_xyz):
        _check(f"origin[{i}]", a, n, torch.float32, device)
    for i, a in enumerate(dir_xyz):
        _check(f"direction[{i}]", a, n, torch.float32, device)
    for i, a in enumerate(center_xyz):
        _check(f"center[{i}]", a, s, torch.float32, device)
    _check("r2", r2, s, torch.float32, device)
    _check("active", active, s, torch.bool, device)
    if moving:
        for i, a in enumerate(speed_xyz):
            _check(f"speed[{i}]", a, s, torch.float32, device)
        _check("time", time, n, torch.float32, device)
    if device.type == "cpu":
        return sphere_min_t_plain(origin_xyz, dir_xyz, center_xyz, r2, active,
                                  t_min, t_max, speed_xyz, time)
    if device.type != "cuda":
        raise ValueError(f"sphere_min_t: unsupported device {device}")

    t_out = torch.empty(n, dtype=torch.float32, device=device)
    idx_out = torch.empty(n, dtype=torch.int32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sphere_min_t_launch(
            *(a.data_ptr() for a in (*origin_xyz, *dir_xyz, *center_xyz, r2, active)),
            *((a.data_ptr() for a in (*speed_xyz, time)) if moving else (None,) * 4),
            float(t_min), float(t_max), t_out.data_ptr(), idx_out.data_ptr(),
            n, s, stream)
    if err != 0:
        raise RuntimeError(f"sphere_min_t kernel launch failed: cudaError {err}")
    sphere_min_t.launches += 1
    if moving:
        sphere_min_t.moving_launches += 1
    return t_out, idx_out


sphere_min_t.launches = 0          # every launch, static and moving
sphere_min_t.moving_launches = 0   # of them, the launches of the moving form


def sphere_min_t_bwd_plain(origin_xyz, dir_xyz, t, idx, g_t, center_xyz, r2, t_min, t_max,
                           speed_xyz=None, time=None):
    """Plain PyTorch version of K1b: per ray, the winner's pair recomputed
    and the chain rule of t = -half_b -/+ sq through half_b and cc = l.l -
    r2 applied to g_t. -> (g_origin (three (N,)), g_direction (three (N,))).
    The root is the one the forward took: t1 where t_min < t1 < t_max, else
    t2 (`pair_t`'s in1/in2 rule). Rays with t = BIG get 0. Any float dtype;
    the divisions divide by tensors, so that they round as the kernel's."""
    if r2.shape[0] == 0:  # no sphere, no winner
        zeros = tuple(torch.zeros_like(t) for _ in range(6))
        return zeros[:3], zeros[3:]
    valid = t < BIG
    k = idx.long()
    cx, cy, cz = (c[k] for c in center_xyz)
    if speed_xyz is not None:
        cx = cx + speed_xyz[0][k] * time
        cy = cy + speed_xyz[1][k] * time
        cz = cz + speed_xyz[2][k] * time
    dx, dy, dz = dir_xyz
    lx = origin_xyz[0] - cx
    ly = origin_xyz[1] - cy
    lz = origin_xyz[2] - cz
    half_b = dx * lx + dy * ly + dz * lz
    c = lx * lx + ly * ly + lz * lz - r2[k]
    sq = torch.sqrt(half_b * half_b - c)
    t1 = -half_b - sq
    in1 = (t_min < t1) & (t1 < t_max)
    q = half_b / sq
    h = torch.full_like(sq, 0.5) / sq
    g_hb = g_t * (torch.where(in1, -q, q) - 1.0)
    g_cc2 = (g_t * torch.where(in1, h, -h)) * 2.0
    zero = torch.zeros_like(t)
    g_o = tuple(torch.where(valid, g_hb * dd + g_cc2 * ll, zero)
                for dd, ll in ((dx, lx), (dy, ly), (dz, lz)))
    g_d = tuple(torch.where(valid, g_hb * ll, zero) for ll in (lx, ly, lz))
    return g_o, g_d


def sphere_min_t_bwd(origin_xyz, dir_xyz, t, idx, g_t, center_xyz, r2, t_min, t_max,
                     speed_xyz=None, time=None):
    """K1b: -> (g_origin, g_direction), three (N,) f32 tensors each, the
    gradient of the sweep's t (K1's output, with its idx) under the
    cotangent g_t (N,). Inputs as `sphere_min_t`'s, with r2 (S,) f32; the
    moving form when speed_xyz and time are given."""
    if (speed_xyz is None) != (time is None):
        raise ValueError("sphere_min_t_bwd: speed_xyz and time go together")
    moving = speed_xyz is not None
    device = origin_xyz[0].device
    n = origin_xyz[0].shape[0]
    s = r2.shape[0]
    for name, group, size in (("origin", origin_xyz, n), ("direction", dir_xyz, n),
                              ("center", center_xyz, s), ("speed", speed_xyz or (), s)):
        for i, a in enumerate(group):
            _check(f"{name}[{i}]", a, size, torch.float32, device)
    _check("t", t, n, torch.float32, device)
    _check("idx", idx, n, torch.int32, device)
    _check("g_t", g_t, n, torch.float32, device)
    _check("r2", r2, s, torch.float32, device)
    if moving:
        _check("time", time, n, torch.float32, device)
    if device.type == "cpu":
        return sphere_min_t_bwd_plain(origin_xyz, dir_xyz, t, idx, g_t, center_xyz, r2,
                                      t_min, t_max, speed_xyz, time)
    if device.type != "cuda":
        raise ValueError(f"sphere_min_t_bwd: unsupported device {device}")

    out = torch.empty((6, n), dtype=torch.float32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sphere_min_t_bwd_launch(
            *(a.data_ptr() for a in (*origin_xyz, *dir_xyz, t, idx, g_t, *center_xyz, r2)),
            *((a.data_ptr() for a in (*speed_xyz, time)) if moving else (None,) * 4),
            float(t_min), float(t_max), *(out[i].data_ptr() for i in range(6)), n, s, stream)
    if err != 0:
        raise RuntimeError(f"sphere_min_t_bwd kernel launch failed: cudaError {err}")
    sphere_min_t_bwd.launches += 1
    if moving:
        sphere_min_t_bwd.moving_launches += 1
    return tuple(out[:3]), tuple(out[3:])


sphere_min_t_bwd.launches = 0          # every launch of K1b, static and moving
sphere_min_t_bwd.moving_launches = 0   # of them, the launches of the moving form


class SphereMinT(torch.autograd.Function):
    """(t, idx) of `sphere_min_t` with t differentiable in the rays' origin
    and direction: apply(ox, oy, oz, dx, dy, dz, cx, cy, cz, r2, active,
    t_min, t_max, sx, sy, sz, time), the last four None in the static
    form. idx is not differentiable."""

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, cx, cy, cz, r2, active, t_min, t_max,
                sx, sy, sz, time):
        motion = {}
        if time is not None:
            motion = dict(speed_xyz=(sx, sy, sz), time=time)
        t, idx = sphere_min_t((ox, oy, oz), (dx, dy, dz), (cx, cy, cz), r2, active,
                              t_min, t_max, **motion)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, t, idx, cx, cy, cz, r2,
                              *((sx, sy, sz, time) if motion else ()))
        ctx.t_min, ctx.t_max = t_min, t_max
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        ox, oy, oz, dx, dy, dz, t, idx, cx, cy, cz, r2, *motion = ctx.saved_tensors
        extra = dict(speed_xyz=tuple(motion[:3]), time=motion[3]) if motion else {}
        g_o, g_d = sphere_min_t_bwd((ox, oy, oz), (dx, dy, dz), t, idx, g_t.contiguous(),
                                    (cx, cy, cz), r2, ctx.t_min, ctx.t_max, **extra)
        return (*g_o, *g_d) + (None,) * 11
