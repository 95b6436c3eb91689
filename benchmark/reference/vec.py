"""Batches of 3-vectors as three tensors, with each product and sum rounded
in the order written (x, then y, then z), so that the reference's float32
arithmetic is the plain arithmetic of the formulas."""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def _c(o):
        return o if isinstance(o, V3) else V3(o, o, o)

    def __add__(self, o):
        o = V3._c(o)
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        o = V3._c(o)
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o):
        o = V3._c(o)
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def at(self, idx) -> "V3":
        return V3(self.x[idx], self.y[idx], self.z[idx])

    def map(self, f) -> "V3":
        return V3(f(self.x), f(self.y), f(self.z))

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y, self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def unit(self) -> "V3":
        """self * (1 / sqrt(max(|self|^2, 1e-20))): a correctly rounded
        square root and division."""
        return self * torch.reciprocal(torch.sqrt(torch.clamp_min(self.dot(self), 1e-20)))

    @staticmethod
    def where(mask, a: "V3", b: "V3") -> "V3":
        return V3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y),
                  torch.where(mask, a.z, b.z))
