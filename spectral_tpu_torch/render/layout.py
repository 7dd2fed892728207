"""Pixel->lane layout permutations for the wavefront kernels (the port's
copy of ``spectral_tpu.render.layout``).

The cluster cull of the many-object loop pays off when the rays that run
together head the same way: on the card a warp of 32 lanes walks a
cluster's members if any of its lanes needs them. With the default
row-major pixel order a warp is 32 pixels of one scanline, and a block a
128-pixel strip; Morton (Z-curve) order makes every aligned 1024-lane
group a compact 32x32 pixel block (a warp a 8x4 block), so its primary
rays form a tight cone, the front-to-back cluster order tightens
``t_best`` quickly, and far clusters are skipped by the whole warp.

The permutation rides the regeneration path's ``lane_perm``/``lane_inv``
(``render/cuda_integrator.py``): per-pixel results are bit-identical to
the unpermuted launch (lane position does not enter any lane's
arithmetic), only the time changes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spectral_tpu_torch.runtime.trace import span

__all__ = ["morton_layout"]


def _spread_bits(v: np.ndarray) -> np.ndarray:
    """Interleave zeros between the low 16 bits of each uint32."""
    v = v.astype(np.uint32) & np.uint32(0xFFFF)
    v = (v | (v << np.uint32(8))) & np.uint32(0x00FF00FF)
    v = (v | (v << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    v = (v | (v << np.uint32(2))) & np.uint32(0x33333333)
    v = (v | (v << np.uint32(1))) & np.uint32(0x55555555)
    return v


@functools.lru_cache(maxsize=8)
def _morton_order_np(width: int, height: int) -> np.ndarray:
    xs = _spread_bits(np.arange(width, dtype=np.uint32))
    ys = _spread_bits(np.arange(height, dtype=np.uint32))
    key = (ys[:, None].astype(np.uint64) << np.uint64(1)) | xs[None, :]
    # stable sort of the flattened keys: out-of-square pixels (W != H or
    # non-power-of-two) keep Z-curve order of the enclosing square grid
    return np.argsort(key.reshape(-1), kind="stable").astype(np.int32)


def morton_layout(width: int, height: int, device="cpu"):
    """``(lane_perm, lane_inv)`` int64 tensors on ``device`` assigning
    pixels to wavefront lanes in Morton (Z-curve) order:
    ``lane_perm[slot]`` is the flat pixel index computed by lane
    ``slot``; ``lane_inv`` is its inverse."""
    order = _morton_order_np(width, height)
    perm = torch.from_numpy(order.astype(np.int64))
    inv = torch.from_numpy(np.argsort(order).astype(np.int64))
    with span("wait.upload", arg=2):  # two copies from pageable host memory
        return perm.to(device), inv.to(device)
