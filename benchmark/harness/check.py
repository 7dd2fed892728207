"""The comparison that decides ``correct``: framebuffer values at a sample
of pixels against the plain reference's values for the same pixels."""

from __future__ import annotations

import numpy as np


def pixel_grid(width: int, height: int, stride: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Every ``stride``-th pixel in both directions from an offset drawn
    from ``seed``: a sample spread over the whole image, different for
    every seed. Returns ``(px, py)`` int64, row-major."""
    rng = np.random.default_rng([seed, 0x5EED])
    x0, y0 = (int(v) for v in rng.integers(0, stride, size=2))
    ys, xs = np.meshgrid(np.arange(y0, height, stride), np.arange(x0, width, stride),
                         indexing="ij")
    return xs.ravel().astype(np.int64), ys.ravel().astype(np.int64)


def pixel_gap(got: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap between the framebuffer's ``[P, 4]`` values and the
    reference's, per pixel over its largest reference channel (at least a
    thousandth of the sample's median pixel, so a black pixel is judged on
    that scale). ``inf`` where nothing was compared or a value is not
    finite."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.size == 0 or got.shape != ref.shape:
        return float("inf")
    if not (np.isfinite(got).all() and np.isfinite(ref).all()):
        return float("inf")
    scale = np.abs(ref).max(axis=-1)
    floor = 1e-3 * float(np.median(scale))
    gap = np.abs(got - ref).max(axis=-1) / np.maximum(scale, max(floor, 1e-30))
    return float(gap.max())
