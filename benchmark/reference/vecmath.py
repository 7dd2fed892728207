"""[Frozen copy of ``spectral_tpu_torch/ops/vecmath.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Structure-of-arrays 3-vector math on tensors (the twin of
``spectral_tpu.ops.vecmath``): three same-shaped tensors per vector, one
elementwise op per component, evaluated in the reference's order."""

from __future__ import annotations

from typing import NamedTuple

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE correctly rounded float32 square root. PyTorch's vectorised
    float32 CPU sqrt is off by one ulp on about 0.6% of inputs (measured
    with AVX-512), while CUDA's and XLA's round correctly; one ulp decides
    the diffuse self-hit coin, so the root is taken in float64 and rounded
    once (exact: 53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


class Vec3(NamedTuple):
    """Three same-shaped tensors; broadcasts like torch."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """Split an ``[..., 3]`` tensor into components."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s) -> "Vec3":
        """Scalar (or broadcastable tensor) scaling."""
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def magnitude(self) -> torch.Tensor:
        return sqrt(self.dot(self))

    def normalize(self) -> "Vec3":
        """nalgebra-style normalize: ``v * (1 / |v|)`` (zero vectors give
        NaN, like the reference). Deliberately not ``rsqrt``."""
        return self * (1.0 / self.magnitude())

    def where(self, mask: torch.Tensor, other: "Vec3") -> "Vec3":
        """Per-lane select: ``mask ? self : other``."""
        return Vec3(
            torch.where(mask, self.x, other.x),
            torch.where(mask, self.y, other.y),
            torch.where(mask, self.z, other.z),
        )

    def take(self, idx: torch.Tensor) -> "Vec3":
        """Gather along the leading axis."""
        return Vec3(self.x[idx], self.y[idx], self.z[idx])


def rotate(m_rows: tuple[Vec3, Vec3, Vec3], v: Vec3) -> Vec3:
    """Apply a 3x3 matrix given as three row ``Vec3``s: ``out_i = row_i . v``."""
    r0, r1, r2 = m_rows
    return Vec3(r0.dot(v), r1.dot(v), r2.dot(v))


def matrix_rows(m: torch.Tensor) -> tuple[Vec3, Vec3, Vec3]:
    """``[..., 3, 3]`` tensor -> three row Vec3s."""
    return (
        Vec3(m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]),
        Vec3(m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]),
        Vec3(m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]),
    )
