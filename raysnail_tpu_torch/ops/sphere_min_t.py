"""Ray x sphere min-t and first-index argmin: the CUDA kernel and its plain
PyTorch version.

`sphere_min_t` is the port of the TPU kernel
`raysnail_tpu/ops/sphere_pallas.py:sphere_min_t` and keeps its signature.
On CUDA tensors it launches `csrc/sphere_min_t.cu` (built at first use with
nvcc into `_build/`, loaded with ctypes) or raises; on CPU tensors it runs
`sphere_min_t_plain`. There is no fallback from the kernel to the plain
version: a build or launch failure raises.

`sphere_min_t.launches` counts kernel launches (not plain-version calls), so
a run can show that its sphere sweeps went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from raysnail_tpu_torch.geometry.hit import BIG

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sphere_min_t.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no a*b+c contraction, so the kernel rounds every product and
# sum as the plain version does and the two agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the sphere_min_t kernel needs the CUDA "
                       "toolkit to build")


def library_path() -> str:
    """The shared library's path, keyed by a hash of the source and flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"sphere_min_t_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernel if its library is missing; -> the library path.
    Raises RuntimeError with nvcc's output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        fn = lib.sphere_min_t_launch
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr] * 11 + [ctypes.c_float, ctypes.c_float, ptr, ptr,
                                    ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def sphere_min_t_plain(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max):
    """Plain PyTorch version: the dense (N, S) pair-t matrix, then min and
    first-index argmin. -> (t (N,) f32, idx (N,) i32)."""
    ox, oy, oz = (a[:, None] for a in origin_xyz)
    dx, dy, dz = (a[:, None] for a in dir_xyz)
    lx = ox - center_xyz[0]
    ly = oy - center_xyz[1]
    lz = oz - center_xyz[2]
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


def sphere_min_t(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max):
    """-> (t_best (N,) f32, idx_best (N,) i32) for N rays against S spheres.

    origin_xyz, dir_xyz: three (N,) f32 tensors each; center_xyz: three (S,)
    f32; r2: (S,) f32 squared radii; active: (S,) bool. Misses give
    t = BIG and idx = 0; ties go to the first sphere index."""
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
    if device.type == "cpu":
        return sphere_min_t_plain(origin_xyz, dir_xyz, center_xyz, r2, active,
                                  t_min, t_max)
    if device.type != "cuda":
        raise ValueError(f"sphere_min_t: unsupported device {device}")

    t_out = torch.empty(n, dtype=torch.float32, device=device)
    idx_out = torch.empty(n, dtype=torch.int32, device=device)
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.sphere_min_t_launch(
            *(a.data_ptr() for a in (*origin_xyz, *dir_xyz, *center_xyz, r2, active)),
            float(t_min), float(t_max), t_out.data_ptr(), idx_out.data_ptr(),
            n, s, stream)
    if err != 0:
        raise RuntimeError(f"sphere_min_t kernel launch failed: cudaError {err}")
    sphere_min_t.launches += 1
    return t_out, idx_out


sphere_min_t.launches = 0
