"""Deterministic quasi-random numbers, bit-exact with the reference
package's ``spectral_tpu.ops.rng`` (reference ``src/shader.rs:652-705``).

PyTorch has no wrapping uint32 add or shift on every device, so the bit
arithmetic runs in int64 holding values in ``[0, 2**32)``, masked back to
32 bits after every step that can carry out. A product of two 32-bit
values could overflow int64, so ``_mul32`` multiplies by 16-bit halves.
The final int64 -> float32 cast rounds to nearest even, like Rust
``u32 as f32``. Inputs may be any integer tensor (or Python int) whose
values are uint32 bit patterns.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# 1 / 2^32 as float32 (both reference literals round to it)
INV_2_32 = 2.3283064365386963e-10


def as_u32(x, device=None) -> torch.Tensor:
    """Integer tensor or Python int -> int64 tensor of uint32 bit patterns.
    A Python int is a fill on ``device`` (the value passed as a kernel
    argument): no copy from host memory, so no wait on the card."""
    if not torch.is_tensor(x):
        return torch.full((), int(x) & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``(a * b) mod 2**32`` for uint32 bit patterns, without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def radical_inverse(bits) -> torch.Tensor:
    """Van der Corput radical inverse via bit reversal
    (reference ``src/shader.rs:655-662``). Returns float32 in [0, 1)."""
    b = as_u32(bits)
    b = ((b >> 16) | (b << 16)) & MASK32
    b = ((b & 0x55555555) << 1) | ((b & 0xAAAAAAAA) >> 1)
    b = ((b & 0x33333333) << 2) | ((b & 0xCCCCCCCC) >> 2)
    b = ((b & 0x0F0F0F0F) << 4) | ((b & 0xF0F0F0F0) >> 4)
    b = ((b & 0x00FF00FF) << 8) | ((b & 0xFF00FF00) >> 8)
    return b.to(torch.float32) * INV_2_32


def hammersley(n, capital_n, device=None):
    """2D Hammersley point ``((n + 0.5) / N, radical_inverse(n + 1))``
    (reference ``src/shader.rs:670-675``), float32 0-d tensors, on
    ``device`` where the ints are Python ints."""
    n = as_u32(n, device)
    capital_n = as_u32(capital_n, n.device)
    x = (n.to(torch.float32) + 0.5) / capital_n.to(torch.float32)
    y = radical_inverse((n + 1) & MASK32)
    return x, y


def random_pcg3d(x, y, z):
    """Jarzynski PCG3D hash (reference ``src/shader.rs:685-705``).
    Returns three float32 tensors in [0, 1]."""
    x, y, z = as_u32(x), as_u32(y), as_u32(z)
    mul, add = 1664525, 1013904223
    x = (x * mul + add) & MASK32
    y = (y * mul + add) & MASK32
    z = (z * mul + add) & MASK32
    x = (_mul32(y, z) + x) & MASK32
    y = (_mul32(z, x) + y) & MASK32
    z = (_mul32(x, y) + z) & MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (_mul32(y, z) + x) & MASK32
    y = (_mul32(z, x) + y) & MASK32
    z = (_mul32(x, y) + z) & MASK32
    f32 = torch.float32
    return x.to(f32) * INV_2_32, y.to(f32) * INV_2_32, z.to(f32) * INV_2_32
