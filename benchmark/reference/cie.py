"""[Frozen copy of ``spectral_tpu_torch/spectral/cie.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

CIE 1931 color matching and XYZ -> linear sRGB conversion.

Behavior-compatible with reference ``src/spectrum.rs``:

* ``WAVELENGTH_TO_XYZ_TABLE`` — the 81-entry, 5 nm-step CIE table
  (reference ``src/spectrum.rs:688-770``),
* ``wavelength_to_xyz`` — table lookup with the reference's **reversed**
  linear-interpolation weights (``lower*fract + upper*(1-fract)``,
  reference ``src/spectrum.rs:677-680``; its unit test locks the reversal
  in, so we replicate rather than fix it),
* ``XYZ_TO_RGB_MATRIX`` — the reference's sRGB-ish matrix with **no gamma
  correction** (reference ``src/spectrum.rs:12-16, 257``),
* ``xyz_integration_weights`` — reproduces the float-accumulating
  ``while wavelength <= max`` walk of ``get_rgb_early``
  (reference ``src/spectrum.rs:244-249``), which can emit one fewer sample
  than ``nbr_of_samples``; all arithmetic is done in float32 so the walk
  terminates on exactly the same step as the reference.

These run on the host (numpy). The device-side color conversion consumes
the precomputed weight matrix (see ``spectral_tpu_torch.render.color``).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32

# CIE 1931 standard observer color matching values, 380-780 nm at 5 nm steps.
# Public standard data; layout mirrors reference src/spectrum.rs:688-770.
WAVELENGTH_TO_XYZ_TABLE = np.array(
    [
        (0.00016, 0.000017, 0.000705),  # 380nm
        (0.000662, 0.000072, 0.002928),
        (0.002362, 0.000253, 0.010482),
        (0.007242, 0.000769, 0.032344),
        (0.01911, 0.002004, 0.086011),  # 400nm
        (0.0434, 0.004509, 0.197120),
        (0.084736, 0.008756, 0.389366),
        (0.140638, 0.014456, 0.656760),
        (0.204492, 0.021391, 0.972542),
        (0.264737, 0.029497, 1.28250),
        (0.314679, 0.038676, 1.55348),
        (0.357719, 0.049602, 1.79850),
        (0.383734, 0.062077, 1.96728),
        (0.386726, 0.074704, 2.02730),
        (0.370702, 0.089456, 1.99480),  # 450nm
        (0.342957, 0.106256, 1.90070),
        (0.302273, 0.128201, 1.74537),
        (0.254085, 0.152761, 1.55490),
        (0.195618, 0.18519, 1.31756),
        (0.132349, 0.21994, 1.03020),
        (0.080507, 0.253589, 0.772125),
        (0.041072, 0.297665, 0.570060),
        (0.016172, 0.339133, 0.415254),
        (0.005132, 0.395379, 0.302356),
        (0.003816, 0.460777, 0.218502),  # 500nm
        (0.015444, 0.53136, 0.159249),
        (0.037465, 0.606741, 0.112044),
        (0.071358, 0.68566, 0.082248),
        (0.117749, 0.761757, 0.060709),
        (0.172953, 0.82333, 0.043050),
        (0.236491, 0.875211, 0.030451),
        (0.304213, 0.92381, 0.020584),
        (0.376772, 0.961988, 0.013676),
        (0.451584, 0.9822, 0.007918),
        (0.529826, 0.991761, 0.003988),  # 550nm
        (0.616053, 0.99911, 0.001091),
        (0.705224, 0.99734, 0.000000),
        (0.793832, 0.98238, 0.000000),
        (0.878655, 0.955552, 0.000000),
        (0.951162, 0.915175, 0.000000),
        (1.01416, 0.868934, 0.000000),
        (1.0743, 0.825623, 0.000000),
        (1.11852, 0.777405, 0.000000),
        (1.1343, 0.720353, 0.000000),
        (1.12399, 0.658341, 0.000000),  # 600nm
        (1.0891, 0.593878, 0.000000),
        (1.03048, 0.527963, 0.000000),
        (0.95074, 0.461834, 0.000000),
        (0.856297, 0.398057, 0.000000),
        (0.75493, 0.339554, 0.000000),
        (0.647467, 0.283493, 0.000000),
        (0.53511, 0.228254, 0.000000),
        (0.431567, 0.179828, 0.000000),
        (0.34369, 0.140211, 0.000000),
        (0.268329, 0.107633, 0.000000),  # 650nm
        (0.2043, 0.081187, 0.000000),
        (0.152568, 0.060281, 0.000000),
        (0.11221, 0.044096, 0.000000),
        (0.081261, 0.0318, 0.000000),
        (0.05793, 0.022602, 0.000000),
        (0.040851, 0.015905, 0.000000),
        (0.028623, 0.01113, 0.000000),
        (0.019941, 0.007749, 0.000000),
        (0.013842, 0.005375, 0.000000),
        (0.009577, 0.003718, 0.000000),  # 700nm
        (0.006605, 0.002565, 0.000000),
        (0.004553, 0.001768, 0.000000),
        (0.003145, 0.001222, 0.000000),
        (0.002175, 0.000846, 0.000000),
        (0.001506, 0.000586, 0.000000),
        (0.001045, 0.000407, 0.000000),
        (0.000727, 0.000284, 0.000000),
        (0.000508, 0.000199, 0.000000),
        (0.000356, 0.00014, 0.000000),
        (0.000251, 0.000098, 0.000000),  # 750nm
        (0.000178, 0.00007, 0.000000),
        (0.000126, 0.00005, 0.000000),
        (0.00009, 0.000036, 0.000000),
        (0.000065, 0.000025, 0.000000),
        (0.000046, 0.000018, 0.000000),
        (0.000033, 0.000013, 0.000000),  # 780nm
    ],
    dtype=F32,
)

# XYZ -> linear sRGB (no gamma), reference src/spectrum.rs:12-16.
XYZ_TO_RGB_MATRIX = np.array(
    [
        [2.041369, -0.5649464, -0.3446944],
        [-0.969266, 1.8760108, 0.0415560],
        [0.0134474, -0.1183897, 1.0154096],
    ],
    dtype=F32,
)


def wavelength_to_xyz(wavelength: float) -> np.ndarray:
    """XYZ color of a single wavelength (nm), float32 semantics.

    Replicates reference ``src/spectrum.rs:654-681`` including:

    * zero outside [380, 780],
    * exact table hit when ``wavelength % 5.0 == 0.0`` in f32,
    * the reversed interpolation weights (``lower*fract + upper*(1-fract)``).
    """
    w = F32(wavelength)
    if not (F32(380.0) <= w <= F32(780.0)):
        return np.zeros(3, dtype=F32)

    if np.fmod(w, F32(5.0)) == F32(0.0):
        index = (int(w) - 380) // 5
        return WAVELENGTH_TO_XYZ_TABLE[index].copy()

    w_adjusted = F32(w - F32(380.0)) / F32(5.0)
    index_lower = int(w_adjusted)  # truncation, as Rust `as usize`
    index_upper = index_lower + 1

    value_lower = WAVELENGTH_TO_XYZ_TABLE[index_lower]
    value_upper = WAVELENGTH_TO_XYZ_TABLE[index_upper]
    fract = F32(w_adjusted - np.trunc(w_adjusted))
    fract_inv = F32(F32(1.0) - fract)

    # Reversed weights -- intentional compat quirk (see module docstring).
    return (value_lower * fract + value_upper * fract_inv).astype(F32)


def xyz_integration_weights(
    lowest_wavelength: float, highest_wavelength: float, nbr_of_samples: int
) -> np.ndarray:
    """Per-sample XYZ weights for spectrum -> color integration.

    Reproduces the sample walk of ``get_rgb_early`` (reference
    ``src/spectrum.rs:241-249``): starting at ``min``, stepping by
    ``(max-min)/(n-1)`` with float32 accumulation, while ``w <= max``.
    Because of f32 rounding the walk may stop one short of ``n`` samples;
    the returned matrix has exactly as many rows as the reference would
    have produced, each already divided by ``n``.

    Returns:
        ``[K, 3]`` float32, ``K <= n`` (typically ``K == n`` or ``n-1``).
    """
    lo = F32(lowest_wavelength)
    hi = F32(highest_wavelength)
    n = int(nbr_of_samples)
    step = F32(F32(hi - lo) / F32(n - 1))

    rows = []
    w = lo
    while w <= hi:
        rows.append(wavelength_to_xyz(w) / F32(n))
        w = F32(w + step)
        if len(rows) > 4 * n:  # safety against degenerate ranges
            break
    return np.stack(rows).astype(F32)


def rgb_from_samples_host(
    intensities: np.ndarray,
    lowest_wavelength: float,
    highest_wavelength: float,
    nbr_of_samples: int,
) -> tuple[float, float, float]:
    """Host-side ``get_rgb_early`` (reference ``src/spectrum.rs:238-261``).

    Sequential left fold over the per-sample XYZ contributions, then the
    XYZ->RGB matrix, all in float32, matching the reference's operation
    order exactly. Intensities beyond the sample walk are ignored; if the
    walk emits more rows than there are samples, the extra rows read the
    zero padding (the reference reads zeros from its fixed ``[f32; 128]``).
    """
    weights = xyz_integration_weights(
        lowest_wavelength, highest_wavelength, nbr_of_samples
    )
    padded = np.zeros(max(len(weights), len(intensities)), dtype=F32)
    padded[: len(intensities)] = intensities.astype(F32)

    acc = np.zeros(3, dtype=F32)
    for i in range(len(weights)):
        acc = (acc + weights[i] * padded[i]).astype(F32)

    rgb = np.zeros(3, dtype=F32)
    for r in range(3):
        # nalgebra Matrix3 * Vector3: per-row dot, f32.
        s = F32(0.0)
        for c in range(3):
            s = F32(s + F32(XYZ_TO_RGB_MATRIX[r, c] * acc[c]))
        rgb[r] = s
    return float(rgb[0]), float(rgb[1]), float(rgb[2])
