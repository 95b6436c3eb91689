"""Batched 3-vectors as a struct of three tensors.

The JAX package's `Vec3` is a pytree of three same-shape arrays; here it is
the same SoA layout over torch tensors. All arithmetic is elementwise over
arbitrary batch shapes and broadcasts Python scalars and tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch


class Vec3:
    """A batch of 3-vectors (or points, or RGB colors) in SoA form."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
        self.x, self.y, self.z = x, y, z

    def __iter__(self):
        return iter((self.x, self.y, self.z))

    # -- constructors ------------------------------------------------------
    @classmethod
    def full(cls, v: Sequence[float] | float, shape=(), dtype=torch.float32,
             device=None) -> "Vec3":
        if isinstance(v, (int, float)):
            v = (v, v, v)
        return cls(*(torch.full(shape, float(c), dtype=dtype, device=device)
                     for c in v))

    @classmethod
    def zeros(cls, shape=(), dtype=torch.float32, device=None) -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(z, z, z)

    @classmethod
    def ones(cls, shape=(), dtype=torch.float32, device=None) -> "Vec3":
        o = torch.ones(shape, dtype=dtype, device=device)
        return cls(o, o, o)

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y, self.z], dim=-1)

    @property
    def shape(self):
        return self.x.shape

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    # -- arithmetic --------------------------------------------------------
    @staticmethod
    def _coerce(o):
        return o if isinstance(o, Vec3) else Vec3(o, o, o)

    def __add__(self, o):
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> torch.Tensor:
        return self.dot(self)

    def unit(self, eps: float = 1e-20) -> "Vec3":
        return self * torch.rsqrt(torch.clamp_min(self.length_squared(), eps))

    def reflect(self, n: "Vec3") -> "Vec3":
        """Mirror reflection about normal n (reference vec3.rs:170-173)."""
        return self - n * (2.0 * self.dot(n))

    def min_component(self) -> torch.Tensor:
        return torch.minimum(self.x, torch.minimum(self.y, self.z))

    def max_component(self) -> torch.Tensor:
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def isfinite(self) -> torch.Tensor:
        return torch.isfinite(self.x) & torch.isfinite(self.y) & torch.isfinite(self.z)

    # -- selection ---------------------------------------------------------
    @staticmethod
    def where(mask: torch.Tensor, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                    torch.where(mask, a.z, b.z))
