"""Batched 3-vectors as a struct of three tensors.

The JAX package's `Vec3` is a pytree of three same-shape arrays; here it is
the same SoA layout over torch tensors. All arithmetic is elementwise over
arbitrary batch shapes and broadcasts Python scalars and tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch

from raysnail_tpu_torch.ops import rows_select


def div_const(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c for a Python number c, rounded as one IEEE division on every
    device: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal instead, which can move the quotient by an ulp against the
    CPU, the JAX package and the kernels, and an ulp can send a ray along
    another path (the Mandelbulb's anchor missed its thumbnail on the card
    by the camera's division alone). So the divisor is a tensor."""
    return a / torch.full_like(a, c)


def take_rows(columns: Sequence[torch.Tensor], idx: torch.Tensor) -> tuple:
    """The rows of a table of K float columns (each (R,), K <= 8) gathered
    by per-ray indices: -> K tensors of idx's shape, each column[idx].

    One select for all K columns: on the card the gather kernel K7
    (`ops.rows_select.rows_select`) and, when a gradient is wanted (grad
    mode on and a column that requires grad, `spheres.intersect`'s rule),
    the autograd Function `RowsSelect`, whose backward K7b sums each row's
    rays' cotangents in one fixed order, so a gradient repeats bit for bit
    from run to run. A frame, and pass 1 of a train step under no_grad,
    call K7 directly. The JAX package selects these rows with a one-hot on
    an accelerator (geometry/hit.py `select_table`), whose transpose XLA
    sums in a fixed order too. A gather's usual backward, index_add_, adds
    400,000 rays into a few rows with atomics in no fixed order. The values
    are those of column[idx]; each index must lie in [0, R)."""
    flat = idx.reshape(-1)
    if flat.dtype is not torch.int64:
        flat = flat.long()
    if torch.is_grad_enabled() and any(c.requires_grad for c in columns):
        out = rows_select.RowsSelect.apply(flat, *columns)
        return out if idx.dim() == 1 else tuple(c.reshape(idx.shape) for c in out)
    return rows_select.rows_select(columns, flat).reshape(len(columns), *idx.shape).unbind(0)


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

    def take(self, idx) -> "Vec3":
        """Rows gathered by per-ray indices, the three components in one
        select (`take_rows`)."""
        return Vec3(*take_rows((self.x, self.y, self.z), idx))

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
        if isinstance(o, (int, float)):
            return Vec3(div_const(self.x, o), div_const(self.y, o), div_const(self.z, o))
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
        """self / |self|, as self * (1 / sqrt(max(|self|^2, eps))): on the
        card a correctly rounded square root and division, as the kernels
        take them, where torch.rsqrt is an approximation (it moved the
        Mandelbulb anchor's rays there). The CPU's torch.sqrt is not always
        correctly rounded."""
        return self * torch.reciprocal(torch.sqrt(torch.clamp_min(self.length_squared(), eps)))

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
