"""Build a shared library with a plain C interface from one source file, for
ctypes.

The port's CUDA kernels (`csrc/*.cu`, with nvcc) and its native BVH builder
(`accel/native/bvh_builder.cpp`, with g++) are built at first use into
`_build/`, under a name keyed by a hash of the source, of the headers it may
include (`csrc/*.cuh`) and of the flags, so an edited source or header or a
changed flag builds anew and an unchanged one is reused.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")

# -fmad=false: no a*b+c contraction, so a kernel rounds every product and
# sum as its plain PyTorch version does and the two agree bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path(source: str, flags, headers=()) -> str:
    """The library's path for `source` (and the `headers` it may include)
    built with `flags`."""
    h = hashlib.sha256()
    for path in (source, *headers):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")


def build(source: str, compiler: str, flags, verbose: bool = False, headers=()) -> str:
    """Compile `source` into its library if that is missing; -> the path.
    verbose=True prints the compiler's output (e.g. nvcc's -Xptxas -v)."""
    path = library_path(source, flags, headers)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [compiler, *flags, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        if verbose:  # one print, so that concurrent builds do not interleave
            print(f"[build] {os.path.basename(source)}:\n{proc.stdout}{proc.stderr}",
                  end="", flush=True)
        os.replace(tmp, path)  # atomic: a concurrent builder sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_cuda(name: str, verbose: bool = False) -> str:
    """Build `csrc/<name>.cu` with nvcc; -> the library path."""
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return build(os.path.join(CSRC, f"{name}.cu"), nvcc(), NVCC_FLAGS, verbose, headers)
