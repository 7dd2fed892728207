"""[Frozen copy of ``spectral_tpu_torch/spectral/uplift.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

RGB -> spectral reflectance uplift.

The reference can only author spectra directly (per-sample sliders,
blackbody/band constructors — ``src/main.rs:1869-1878``); there is no way
to say "make this surface *that* RGB color", which is the workflow every
RGB-authored asset needs when moving to a spectral renderer. This module
promotes an RGB triple to a smooth reflectance spectrum that is an exact
metamer under the framework's OWN color pipeline (the reference's CIE
table, reversed-lerp interpolation, float-walk integration weights and
XYZ->RGB matrix — see ``spectral_tpu_torch.spectral.cie``), so a round trip
``rgb -> spectrum -> get_rgb_early`` reproduces the requested color.

Method: the map from the ``n`` spectrum samples to RGB is linear —
``rgb = M s`` with ``M = XYZ_TO_RGB_MATRIX @ W.T`` where ``W`` is the
per-sample XYZ integration-weight matrix. We normalize ``M`` by the white
point (the RGB of the flat unit reflector) so a requested ``(1,1,1)`` is
the flat white spectrum, then solve the smoothest non-negative metamer:

    minimize    ||D2 s||^2  (+ tiny ridge)
    subject to  M' s = rgb,   0 <= s <= 1

via the closed-form KKT solve of the equality-constrained QP; when the
unconstrained-box solution leaves [0, 1] (saturated colors near or past
the reflectance-gamut boundary) a projected-gradient polish finds the
closest-in-color smooth spectrum inside the box. This is the same family
of smoothness-maximizing uplifts as Smits (1999) / Meng et al. (2015),
solved directly against this renderer's color math instead of shipping a
foreign basis table.
"""

from __future__ import annotations

import numpy as np

from .cie import XYZ_TO_RGB_MATRIX, xyz_integration_weights

__all__ = ["uplift_rgb", "white_point"]


def _color_matrix(lo: float, hi: float, n: int) -> np.ndarray:
    """``[3, n]`` float64 map from sample values to (unnormalized) RGB.

    Samples past the float-walk's row count (K may be n-1, see
    ``xyz_integration_weights``) get zero columns — they are invisible to
    the color integral; the smoothness objective extrapolates them.
    The walk can also emit K > n rows; rows beyond n read zero-padded
    samples in the host path (``rgb_from_samples_host`` pads for exactly
    this), so truncating the weight matrix to n is exact.
    """
    weights = xyz_integration_weights(lo, hi, n)[:n]  # [K, 3], K <= n
    m = np.zeros((3, n), dtype=np.float64)
    m[:, : weights.shape[0]] = (
        XYZ_TO_RGB_MATRIX.astype(np.float64) @ weights.astype(np.float64).T
    )
    return m


def white_point(lo: float = 380.0, hi: float = 780.0, n: int = 32) -> np.ndarray:
    """RGB of the flat unit reflector under the framework's color pipeline.

    ``uplift_rgb`` targets are expressed relative to this white: a
    requested ``rgb`` lands at ``white_point() * rgb`` in raw
    ``get_rgb_early`` units.
    """
    return _color_matrix(lo, hi, n).sum(axis=1)


def _second_difference(n: int) -> np.ndarray:
    d2 = np.zeros((n - 2, n), dtype=np.float64)
    for i in range(n - 2):
        d2[i, i : i + 3] = (1.0, -2.0, 1.0)
    return d2


def uplift_rgb(
    rgb,
    lo: float = 380.0,
    hi: float = 780.0,
    n: int = 32,
    return_info: bool = False,
):
    """Smoothest reflectance in [0, 1] whose color is ``rgb``.

    Args:
      rgb: target color, each channel in [0, 1], in white-relative units
        (``(1, 1, 1)`` is the flat white reflector — see ``white_point``).
      lo/hi/n: the spectrum grid (the scene's wavelength range and sample
        count; ``n`` a multiple of 8 like every spectrum here).
      return_info: also return ``{"achieved_rgb", "max_channel_error"}``
        — nonzero error only for colors outside the smooth-reflectance
        gamut (very saturated targets), which land on the closest
        achievable color.

    Returns:
      ``[n]`` float32 reflectance values in [0, 1] (plus the info dict
      when requested).
    """
    target = np.asarray(rgb, dtype=np.float64)
    if target.shape != (3,):
        raise ValueError(f"rgb must be 3 values, got shape {target.shape}")
    if not np.isfinite(target).all() or (target < 0.0).any():
        raise ValueError(f"rgb channels must be finite and >= 0, got {target}")
    if (target > 1.0).any():
        raise ValueError(
            f"rgb channels must be <= 1 for a reflectance (got {target}); "
            "scale an EMISSIVE spectrum's factor instead for bright lights"
        )
    n = int(n)
    if n < 4:
        raise ValueError("uplift needs at least 4 samples")

    m = _color_matrix(lo, hi, n)
    white = m.sum(axis=1)
    m_norm = m / white[:, None]  # flat 1.0 -> exactly (1, 1, 1)

    d2 = _second_difference(n)
    # Equality-constrained QP via KKT: min 1/2 s^T Q s  s.t.  M' s = rgb.
    q = d2.T @ d2 + 1e-9 * np.eye(n)
    kkt = np.zeros((n + 3, n + 3), dtype=np.float64)
    kkt[:n, :n] = q
    kkt[:n, n:] = m_norm.T
    kkt[n:, :n] = m_norm
    sol = np.linalg.solve(kkt, np.concatenate([np.zeros(n), target]))
    s = sol[:n]

    box_tol = 1e-9
    if s.min() < -box_tol or s.max() > 1.0 + box_tol:
        # Saturated target: polish inside the box, weighting color fidelity
        # far above smoothness so in-gamut targets still land exactly.
        mu = 1e6
        grad_color = mu * (m_norm.T @ m_norm)
        grad_smooth = d2.T @ d2
        lips = np.linalg.norm(grad_color + grad_smooth, 2)
        step = 1.0 / lips
        s = np.clip(s, 0.0, 1.0)
        rhs = mu * (m_norm.T @ target)
        for _ in range(4000):
            grad = (grad_color + grad_smooth) @ s - rhs
            s = np.clip(s - step * grad, 0.0, 1.0)
    s = np.clip(s, 0.0, 1.0)

    values = s.astype(np.float32)
    if not return_info:
        return values
    achieved = m_norm @ s
    return values, {
        "achieved_rgb": tuple(float(c) for c in achieved),
        "max_channel_error": float(np.abs(achieved - target).max()),
    }
