"""[Frozen copy of ``spectral_tpu_torch/spectral/solar.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Measured solar spectral radiance table (1 nm steps, 1-2399 nm).

The reference embeds this table (``src/spectral_data.rs:31``, sourced from
its ``Solar_Spectrum_Data.txt``) but *bypasses* it: ``new_sunlight_spectrum``
substitutes a 6500 K blackbody "workaround" (reference
``src/spectrum.rs:73-96``). We ship the measured data as a binary asset so
the capability exists, and keep the blackbody path as the
behavior-compatible default (see ``Spectrum.new_sunlight_spectrum``).
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

F32 = np.float32

_DATA_PATH = Path(__file__).parent / "data" / "solar_spectrum.npy"


@functools.cache
def sunlight_spectrum_table() -> np.ndarray:
    """The measured table: entry ``i`` is wavelength ``i+1`` nm, W/m^2/nm."""
    arr = np.load(_DATA_PATH)
    assert arr.shape == (2399,) and arr.dtype == np.float32
    arr.setflags(write=False)
    return arr


def get_sunlight_intensity(wavelength: float) -> float:
    """Measured solar spectral radiance at ``wavelength`` nm.

    Linear interpolation with the reference's **reversed** weights
    (``lower*fract + upper*(1-fract)``, reference
    ``src/spectral_data.rs:8-26``); zero outside [1, 2399] nm.
    """
    w = F32(wavelength)
    if not (F32(1.0) <= w <= F32(2399.0)):
        return 0.0

    table = sunlight_spectrum_table()
    fract = F32(w - np.trunc(w))
    if fract == F32(0.0):
        return float(table[int(w) - 1])

    lower_index = int(w) - 1
    lower = table[lower_index]
    upper = table[lower_index + 1]
    fract_inv = F32(F32(1.0) - fract)
    return float(F32(lower * fract) + F32(upper * fract_inv))
