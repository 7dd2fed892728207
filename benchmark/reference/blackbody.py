"""[Frozen copy of ``spectral_tpu_torch/spectral/blackbody.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Planck blackbody spectral radiance.

Behavior-compatible with the reference implementation
(reference ``src/spectrum.rs:562-594``): float64 math, wavelength in
nanometers, temperature in Kelvin, output in W / sr / m^2 / nm.
"""

from __future__ import annotations

import numpy as np

SPEED_OF_LIGHT = 299_792_458.0  # m/s
PLANCK_CONSTANT = 6.62607015e-34
BOLTZMANN_CONSTANT = 1.380649e-23


def black_body_radiation(wavelength_nm: float, temperature_k: float) -> float:
    """Spectral radiance B_l(lambda, T) of an ideal blackbody.

    ``B_l = (2 h c^2 / l^5) * 1 / (exp(hc / (l T k_B)) - 1)``, evaluated in
    float64 and scaled by 1e-9 to convert /m to /nm, exactly like reference
    ``src/spectrum.rs:582-594``.

    Raises:
        ValueError: if wavelength or temperature is not strictly positive
            (the reference panics via ``assert!``).
    """
    if not wavelength_nm > 0.0:
        raise ValueError(
            f"Wavelengths must be physical, real, positive values. Got: {wavelength_nm}nm."
        )
    if not temperature_k > 0.0:
        raise ValueError(
            f"Temperatures in Kelvin are real, positive values. Got: {temperature_k}K."
        )

    lam = float(wavelength_nm) / 1e9  # nanometer to meter
    hc22 = 2.0 * PLANCK_CONSTANT * SPEED_OF_LIGHT * SPEED_OF_LIGHT
    l5 = lam * lam * lam * lam * lam
    hc = PLANCK_CONSTANT * SPEED_OF_LIGHT
    ltk = lam * float(temperature_k) * BOLTZMANN_CONSTANT
    big_denominator = np.exp(hc / ltk) - 1.0

    return (hc22 / l5) * (1.0 / big_denominator) * 1e-9
