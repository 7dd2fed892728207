"""[Frozen copy of ``spectral_tpu_torch/spectral/spectrum.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Host-side sampled-spectrum value type.

Behavior-compatible re-design of the reference ``Spectrum``
(reference ``src/spectrum.rs:26-494``): a fixed-capacity float32 sample
array over an equidistant wavelength grid. On the host it is a small numpy
value type used for scene construction and color previews; on device the
sample axis becomes the minor (lane) dimension of ``[n_rays, n_lambda]``
wavefront arrays (see ``spectral_tpu_torch.scene.flatten``).

All arithmetic is performed in float32 with the reference's operation
order so that scene constants match the reference bit-for-bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference import cie
from benchmark.reference.blackbody import black_body_radiation

F32 = np.float32

# Reference src/spectrum.rs:5-8.
VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND = 380.0
VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND = 780.0
NBR_OF_SAMPLES_MAX = 128


def _check_samples(n: int) -> None:
    if n % 8 != 0:
        raise ValueError(f"nbr_of_samples must be a multiple of 8, got {n}")
    if not 0 < n <= NBR_OF_SAMPLES_MAX:
        raise ValueError(f"nbr_of_samples must be in (0, {NBR_OF_SAMPLES_MAX}], got {n}")


@dataclasses.dataclass
class Spectrum:
    """An equidistantly sampled spectrum over ``[lowest, highest]`` nm.

    ``intensities`` always has capacity ``NBR_OF_SAMPLES_MAX`` (padding
    beyond ``nbr_of_samples`` mirrors the reference's fixed ``[f32; 128]``
    storage; some constructors intentionally leave non-zero padding there,
    exactly like the reference).
    """

    nbr_of_samples: int
    lowest_wavelength: float
    highest_wavelength: float
    intensities: np.ndarray  # float32 [NBR_OF_SAMPLES_MAX]

    # ---------------------------------------------------------------- ctors

    @staticmethod
    def new_from_list(
        intensities: np.ndarray | list[float],
        lowest_wavelength: float,
        highest_wavelength: float,
        nbr_of_samples: int,
    ) -> "Spectrum":
        """Reference ``src/spectrum.rs:62-68`` (no sample-count assert)."""
        arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
        src = np.asarray(intensities, dtype=F32)
        arr[: len(src)] = src[:NBR_OF_SAMPLES_MAX]
        return Spectrum(nbr_of_samples, float(F32(lowest_wavelength)),
                        float(F32(highest_wavelength)), arr)

    @staticmethod
    def new_equal_size_empty_spectrum(other: "Spectrum") -> "Spectrum":
        """Zero spectrum with the same shape (reference ``src/spectrum.rs:49-58``)."""
        return Spectrum.new_singular_reflectance_factor(
            other.lowest_wavelength, other.highest_wavelength, other.nbr_of_samples, 0.0
        )

    @staticmethod
    def new_singular_reflectance_factor(
        lowest_wavelength: float, highest_wavelength: float,
        nbr_of_samples: int, reflectance_factor: float,
    ) -> "Spectrum":
        """Flat spectrum; fills the whole 128-wide array like the reference
        (``src/spectrum.rs:100-106``)."""
        arr = np.full(NBR_OF_SAMPLES_MAX, F32(reflectance_factor), dtype=F32)
        return Spectrum(nbr_of_samples, float(F32(lowest_wavelength)),
                        float(F32(highest_wavelength)), arr)

    @staticmethod
    def new_temperature_spectrum(
        lowest_wavelength: float, highest_wavelength: float,
        temp_in_kelvin: float, nbr_of_samples: int, multiplier: float,
    ) -> "Spectrum":
        """Blackbody spectrum (reference ``src/spectrum.rs:112-122``).

        Note: like the reference, the blackbody is evaluated for *all* 128
        array slots (padding beyond ``nbr_of_samples`` holds real values).
        """
        lo, hi = F32(lowest_wavelength), F32(highest_wavelength)
        step = F32(F32(hi - lo) / F32(nbr_of_samples - 1))
        mult = F32(multiplier)
        arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
        for i in range(NBR_OF_SAMPLES_MAX):
            wavelength = F32(lo + F32(step * F32(i)))
            arr[i] = F32(F32(black_body_radiation(float(wavelength), float(temp_in_kelvin))) * mult)
        return Spectrum(nbr_of_samples, float(lo), float(hi), arr)

    @staticmethod
    def new_sunlight_spectrum(
        lowest_wavelength: float, highest_wavelength: float,
        nbr_of_samples: int, multiplier: float,
    ) -> "Spectrum":
        """Solar spectrum. Like the reference (``src/spectrum.rs:73-96``)
        this is a 6500 K blackbody workaround — the measured table
        (``spectral_tpu_torch.spectral.solar``) exists but is bypassed for
        behavior compatibility."""
        return Spectrum.new_temperature_spectrum(
            lowest_wavelength, highest_wavelength, 6500.0, nbr_of_samples, multiplier
        )

    @staticmethod
    def new_measured_solar_spectrum(
        lowest_wavelength: float, highest_wavelength: float,
        nbr_of_samples: int, multiplier: float = 1.0,
        normalize: bool = True,
    ) -> "Spectrum":
        """MEASURED solar spectrum from the shipped 2,399-entry table —
        the data the reference embeds but bypasses (table
        ``src/spectral_data.rs:31``, bypass ``src/spectrum.rs:73-96``),
        un-deadened here as a first-class constructor. Lookup uses the
        table's reversed-lerp compat semantics
        (:func:`spectral_tpu_torch.spectral.solar.get_sunlight_intensity`).

        The raw table is spectral irradiance (~2 W/m^2/nm at peak) while
        the blackbody workaround the rest of the framework is calibrated
        against sits ~2e4x higher, so with ``normalize=True`` (default)
        the curve is scaled to match the 6500 K workaround's
        ``get_radiance`` at the same sampling — a drop-in replacement
        with measured SHAPE and compatible brightness. ``normalize=False``
        returns raw table units. Padding slots beyond ``nbr_of_samples``
        hold real values, mirroring ``new_temperature_spectrum``.
        """
        from benchmark.reference.solar import get_sunlight_intensity

        lo, hi = F32(lowest_wavelength), F32(highest_wavelength)
        step = F32(F32(hi - lo) / F32(nbr_of_samples - 1))
        arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
        for i in range(NBR_OF_SAMPLES_MAX):
            w = F32(lo + F32(step * F32(i)))
            arr[i] = F32(get_sunlight_intensity(float(w)))
        out = Spectrum(nbr_of_samples, float(lo), float(hi), arr)
        scale = F32(multiplier)
        if normalize:
            raw_radiance = F32(out.get_radiance())
            if raw_radiance > 0.0:
                workaround = Spectrum.new_sunlight_spectrum(
                    float(lo), float(hi), nbr_of_samples, 1.0
                )
                scale = F32(
                    scale * F32(F32(workaround.get_radiance()) / raw_radiance)
                )
        out.intensities = (out.intensities * scale).astype(F32)
        return out

    @staticmethod
    def new_normalized_white(
        lowest_wavelength: float, highest_wavelength: float, nbr_of_samples: int
    ) -> "Spectrum":
        """Reference ``src/spectrum.rs:124-137``. The in-place division only
        touches the active samples, so padding keeps unnormalized values —
        exactly like the reference's ``DivAssign``."""
        s = Spectrum.new_sunlight_spectrum(
            lowest_wavelength, highest_wavelength, nbr_of_samples, 1.0
        )
        r, g, b = s.get_rgb_early()
        factor = F32(max(r, max(g, b)))
        s.intensities[: s.nbr_of_samples] = (
            s.intensities[: s.nbr_of_samples] / factor
        ).astype(F32)
        return s

    @staticmethod
    def _band_spectrum(lo, hi, n, factor, predicate) -> "Spectrum":
        lo, hi = F32(lo), F32(hi)
        step = F32(F32(hi - lo) / F32(n - 1))
        arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
        for i in range(n):
            w = F32(lo + F32(step * F32(i)))
            if predicate(w):
                arr[i] = F32(factor)
        return Spectrum(n, float(lo), float(hi), arr)

    @staticmethod
    def new_reflective_spectrum_red(lo, hi, n, factor) -> "Spectrum":
        """factor for wavelengths > 550 nm (reference ``src/spectrum.rs:141-154``)."""
        return Spectrum._band_spectrum(lo, hi, n, factor, lambda w: F32(550.0) < w)

    @staticmethod
    def new_reflective_spectrum_green(lo, hi, n, factor) -> "Spectrum":
        """factor for 500 nm < w < 575 nm (reference ``src/spectrum.rs:158-171``)."""
        return Spectrum._band_spectrum(
            lo, hi, n, factor, lambda w: F32(500.0) < w < F32(575.0)
        )

    @staticmethod
    def new_reflective_spectrum_blue(lo, hi, n, factor) -> "Spectrum":
        """factor for wavelengths < 475 nm (reference ``src/spectrum.rs:175-187``)."""
        return Spectrum._band_spectrum(lo, hi, n, factor, lambda w: w < F32(475.0))

    # ------------------------------------------------------------- queries

    @property
    def values(self) -> np.ndarray:
        """Active samples, float32 ``[nbr_of_samples]``."""
        return self.intensities[: self.nbr_of_samples]

    def get_range(self) -> tuple[float, float]:
        return (self.lowest_wavelength, self.highest_wavelength)

    def get_nbr_of_samples(self) -> int:
        return self.nbr_of_samples

    def get_wavelengths(self) -> np.ndarray:
        """Sample wavelengths (reference ``src/spectrum.rs:347-357``)."""
        lo, hi = F32(self.lowest_wavelength), F32(self.highest_wavelength)
        step = F32(F32(hi - lo) / F32(self.nbr_of_samples - 1))
        return np.array(
            [F32(lo + F32(step * F32(i))) for i in range(self.nbr_of_samples)],
            dtype=F32,
        )

    def get_spectral_radiance_by_wavelength(self, wavelength: float) -> float:
        """Sampled lookup with the reference's **reversed** lerp weights
        (reference ``src/spectrum.rs:192-212``); zero outside the range."""
        w = F32(wavelength)
        lo, hi = F32(self.lowest_wavelength), F32(self.highest_wavelength)
        if not (lo <= w <= hi):
            return 0.0
        index_norm = F32(F32(w - lo) / F32(hi - lo))
        index_frac = F32(index_norm * F32(self.nbr_of_samples - 1))
        fract = F32(index_frac - np.trunc(index_frac))
        if fract == F32(0.0):
            return float(self.intensities[int(index_frac)])
        index_lower = int(np.floor(index_frac))
        index_upper = int(np.ceil(index_frac))
        frac_inv = F32(F32(1.0) - fract)
        return float(
            F32(self.intensities[index_lower] * fract)
            + F32(self.intensities[index_upper] * frac_inv)
        )

    def get_radiance(self) -> float:
        """Integral over the spectral radiances (reference ``src/spectrum.rs:360-365``)."""
        lo, hi = F32(self.lowest_wavelength), F32(self.highest_wavelength)
        step = F32(F32(hi - lo) / F32(self.nbr_of_samples - 1))
        acc = F32(0.0)
        for i in range(self.nbr_of_samples):
            acc = F32(acc + F32(self.intensities[i] * step))
        return float(acc)

    def get_rgb_early(self) -> tuple[float, float, float]:
        """Spectrum -> linear RGB (reference ``src/spectrum.rs:238-261``)."""
        return cie.rgb_from_samples_host(
            self.intensities,
            self.lowest_wavelength,
            self.highest_wavelength,
            self.nbr_of_samples,
        )

    # ----------------------------------------------------------- mutation

    def max0(self) -> None:
        """Clamp active samples to >= 0 (reference ``src/spectrum.rs:215-221``)."""
        n = self.nbr_of_samples
        self.intensities[:n] = np.maximum(self.intensities[:n], F32(0.0))

    def min1(self) -> None:
        """Clamp active samples to <= 1 (reference ``src/spectrum.rs:224-230``)."""
        n = self.nbr_of_samples
        self.intensities[:n] = np.minimum(self.intensities[:n], F32(1.0))

    def normalize(self) -> "Spectrum":
        """Scale so the max RGB channel is 1 (reference ``src/spectrum.rs:371-376``).
        Like the reference's ``Div<f32>``, only active samples are divided
        (padding keeps its raw values)."""
        r, g, b = self.get_rgb_early()
        factor = F32(max(r, max(g, b)))
        return self / float(factor)

    def rebound(self, lower_bound: float, upper_bound: float) -> None:
        """Re-anchor the spectrum onto new wavelength bounds, resampling
        values from the old grid (reversed-lerp lookup semantics; zero
        outside the old range). The reference declares this operation but
        leaves it ``todo!()`` (src/spectrum.rs:279-281) — implemented here.
        """
        if not lower_bound < upper_bound:
            raise ValueError("lower_bound must be below upper_bound")
        lo, hi = F32(lower_bound), F32(upper_bound)
        n = self.nbr_of_samples
        step = F32(F32(hi - lo) / F32(n - 1))
        old = self.copy()
        arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
        for i in range(n):
            w = F32(lo + F32(step * F32(i)))
            arr[i] = F32(old.get_spectral_radiance_by_wavelength(float(w)))
        self.intensities = arr
        self.lowest_wavelength = float(lo)
        self.highest_wavelength = float(hi)

    def resample(self, new_sample_amount: int) -> None:
        """Re-sample in place (reference ``src/spectrum.rs:285-325``).

        Upsampling linearly interpolates; downsampling repeatedly halves
        (``collapse_list_to_half``) then interpolates. The reference's
        downsample loop re-slices with the *original* length — a panic for
        ratios > 2x that its UI (±8 steps) can never reach; we loop on the
        current list instead (documented divergence, unreachable via the
        compat surface).
        """
        if new_sample_amount <= 1 or new_sample_amount > NBR_OF_SAMPLES_MAX:
            raise ValueError("new_sample_amount out of range")
        _check_samples(new_sample_amount)
        _check_samples(self.nbr_of_samples)
        n = self.nbr_of_samples
        if new_sample_amount == n:
            return

        if new_sample_amount < n:  # sample down
            working = self.intensities[:n].astype(F32)
            while len(working) > 2 * new_sample_amount:
                working = _collapse_list_to_half(working)
            working = _linear_interpolate_halved(working, new_sample_amount)
            arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
            arr[: len(working)] = working
            self.intensities = arr
        else:  # up-sample (linear interpolation)
            new_arr = np.zeros(NBR_OF_SAMPLES_MAX, dtype=F32)
            # padded read: index_upper can reach n (reads zero padding with
            # zero weight), mirroring the reference's fixed-width array.
            padded = np.zeros(NBR_OF_SAMPLES_MAX + 1, dtype=F32)
            padded[:NBR_OF_SAMPLES_MAX] = self.intensities
            for i in range(new_sample_amount):
                index = F32(
                    F32(F32(i) / F32(new_sample_amount - 1)) * F32(n - 1)
                )
                index_frac = F32(index - np.floor(index))
                index_lower = int(np.floor(index))
                index_upper = index_lower + 1
                frac = F32(F32(1.0) - index_frac)
                new_arr[i] = F32(
                    F32(padded[index_lower] * frac) + F32(padded[index_upper] * index_frac)
                )
            self.intensities = new_arr
        self.nbr_of_samples = new_sample_amount

    # ---------------------------------------------------------- operators

    def _binop(self, rhs: "Spectrum", op) -> "Spectrum":
        assert self.nbr_of_samples == rhs.nbr_of_samples
        out = self.copy()
        n = self.nbr_of_samples
        out.intensities[:n] = op(self.intensities[:n], rhs.intensities[:n]).astype(F32)
        return out

    def __add__(self, rhs: "Spectrum") -> "Spectrum":
        return self._binop(rhs, np.add)

    def __mul__(self, rhs):
        if isinstance(rhs, Spectrum):
            return self._binop(rhs, np.multiply)
        out = self.copy()
        n = self.nbr_of_samples
        out.intensities[:n] = (self.intensities[:n] * F32(rhs)).astype(F32)
        return out

    def __truediv__(self, rhs):
        if isinstance(rhs, Spectrum):
            return self._binop(rhs, np.divide)
        out = self.copy()
        n = self.nbr_of_samples
        out.intensities[:n] = (self.intensities[:n] / F32(rhs)).astype(F32)
        return out

    def copy(self) -> "Spectrum":
        return Spectrum(
            self.nbr_of_samples,
            self.lowest_wavelength,
            self.highest_wavelength,
            self.intensities.copy(),
        )


def _collapse_list_to_half(values: np.ndarray) -> np.ndarray:
    """Halve a sample list, rounding up to a multiple of 8
    (reference ``src/spectrum.rs:598-607``)."""
    assert len(values) > 8
    half_length = len(values) // 2
    if half_length % 8 != 0:
        half_length = (half_length // 8 + 1) * 8
    return _linear_interpolate_halved(values, half_length)


def _linear_interpolate_halved(values: np.ndarray, target_length: int) -> np.ndarray:
    """Linear shrink to ``target_length`` in [len/2, len]
    (reference ``src/spectrum.rs:611-638``)."""
    original_length = len(values)
    assert original_length > 1 and target_length > 1
    assert original_length >= target_length
    assert original_length // 2 <= target_length

    factor = F32(F32(original_length) / F32(target_length))
    out = np.zeros(target_length, dtype=F32)
    for i in range(target_length):
        pos = F32(factor * F32(i))
        index = int(np.floor(pos))
        ratio = F32(pos - np.floor(pos))
        if index + 1 < original_length:
            a, b = values[index], values[index + 1]
            out[i] = F32(F32(a * F32(F32(1.0) - ratio)) + F32(b * ratio))
        else:
            out[i] = values[index]
    return out
