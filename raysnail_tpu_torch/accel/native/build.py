"""ctypes loader for the native BVH builder (`bvh_builder.cpp`, a copy of the
JAX package's). It is compiled with g++ at first use into the port's
`_build/` directory, keyed by a hash of the source and flags, with the
JAX package's compiler flags, so both packages build the same trees.

As in the JAX package, `build_bvh_native` returns None when the builder
cannot be compiled or fails, and `accel.bvh.build_bvh` then takes its numpy
builder; `build()` raises instead, for callers that require the native one.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from raysnail_tpu_torch.ops import _nvcc

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvh_builder.cpp")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_failed = False


def build() -> str:
    """Compile the builder if its library is missing; -> the library path."""
    return _nvcc.build(SOURCE, "g++", GXX_FLAGS)


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError):
            _failed = True
            return None
        lib.raysnail_build_bvh.restype = ctypes.c_int
        lib.raysnail_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def build_bvh_native(prim_bb_min, prim_bb_max, leaf_size: int):
    """-> BvhArrays or None if the native builder is unavailable/failed."""
    from raysnail_tpu_torch.accel.bvh import BvhArrays

    lib = _load()
    if lib is None:
        return None

    pmin = np.ascontiguousarray(prim_bb_min, np.float32)
    pmax = np.ascontiguousarray(prim_bb_max, np.float32)
    n = pmin.shape[0]
    max_nodes = 2 * n + 2
    max_prims = (n + max_nodes) * leaf_size  # worst case padding per leaf

    bb_min = np.empty((max_nodes, 3), np.float32)
    bb_max = np.empty((max_nodes, 3), np.float32)
    first = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    miss = np.empty(max_nodes, np.int32)
    prim_order = np.empty(max_prims, np.int32)
    sizes = np.zeros(2, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    rc = lib.raysnail_build_bvh(
        pmin.ctypes.data_as(fp), pmax.ctypes.data_as(fp),
        ctypes.c_int(n), ctypes.c_int(leaf_size),
        bb_min.ctypes.data_as(fp), bb_max.ctypes.data_as(fp),
        first.ctypes.data_as(ip), count.ctypes.data_as(ip),
        miss.ctypes.data_as(ip), prim_order.ctypes.data_as(ip),
        ctypes.c_int(max_nodes), ctypes.c_int(max_prims),
        sizes.ctypes.data_as(ip),
    )
    if rc != 0:
        return None
    m, p = int(sizes[0]), int(sizes[1])
    # miss links point at m (the node count) as END — consistent already
    return BvhArrays(
        bb_min=bb_min[:m].copy(), bb_max=bb_max[:m].copy(),
        first=first[:m].copy(), count=count[:m].copy(), miss=miss[:m].copy(),
        prim_order=prim_order[:p].copy(),
    )
