"""Framebuffer conversion and image export.

Equivalent of the reference's ``CustomImage`` display/save path
(reference ``src/custom_image.rs:92-101`` and the save dialog,
``src/main.rs:2313-2331``): clamp the f32 accumulation buffer to [0, 1],
scale by 255 and truncate to u8 (Rust ``as u8`` truncates toward zero),
then export via PIL (PNG/JPG/BMP/TIFF, the formats the reference's
``image`` crate offers).

The port's copy of ``spectral_tpu.render.image``: the native converter
and PNG encoder are the port's own (``runtime/native.py``), and
``.exr`` goes to the port's copy of the EXR writer (``render/exr.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def apply_display_transform(
    accum: np.ndarray,
    exposure: float | None = None,
    gamma: float | None = None,
) -> np.ndarray:
    """Opt-in display transform on the f32 buffer (RGB channels only):
    scale by ``exposure`` then encode with ``1/gamma``. The DEFAULT
    export applies neither — the reference's linear no-gamma output
    (``src/custom_image.rs:92-101``) is a documented compat quirk; this
    exists for users who want a display-ready file instead."""
    out = np.array(accum, dtype=np.float32, copy=True)
    rgb = np.clip(out[..., :3], 0.0, None)
    if exposure is not None:
        if exposure <= 0:
            raise ValueError("exposure must be positive")
        rgb = rgb * np.float32(exposure)
    if gamma is not None:
        if gamma <= 0:
            raise ValueError("gamma must be positive")
        rgb = np.power(rgb, np.float32(1.0 / gamma))
    out[..., :3] = rgb
    return out


def accum_to_u8(accum: np.ndarray, native: bool | None = None) -> np.ndarray:
    """``[H, W, 4]`` float32 -> ``[H, W, 4]`` uint8.

    Uses the multithreaded C++ converter when available (``native=None``
    auto-detects); the numpy fallback is semantically identical.
    """
    data = np.asarray(accum, dtype=np.float32)
    if native is not False:
        try:
            from spectral_tpu_torch.runtime import native as native_mod

            return native_mod.convert_f32_rgba_to_u8(data)
        except Exception:
            if native is True:
                raise
    # NaN -> 0 to match the native C++ converter and the reference's Rust
    # `as u8` saturating cast (NaN as u8 == 0); np.clip passes NaN through
    # and NaN->uint8 is platform-undefined.
    data = np.nan_to_num(data, nan=0.0)
    return (np.clip(data, 0.0, 1.0) * 255.0).astype(np.uint8)


def save_image(
    accum: np.ndarray,
    path: str | Path,
    native: bool | None = None,
    u8: np.ndarray | None = None,
    exposure: float | None = None,
    gamma: float | None = None,
) -> Path:
    """Save the accumulation buffer; format chosen by extension.

    PNG output goes through the native C++ encoder when available; other
    formats (and the fallback) use PIL. Callers that already hold the u8
    conversion of ``accum`` may pass it to skip re-converting.
    ``exposure``/``gamma`` opt into a display transform (default: the
    reference's linear no-gamma output — see apply_display_transform).
    """
    path = Path(path)
    if exposure is not None or gamma is not None:
        if u8 is not None:
            raise ValueError(
                "pass either a precomputed u8 or a display transform, not both"
            )
        accum = apply_display_transform(accum, exposure, gamma)
    if path.suffix.lower() == ".exr":
        # HDR export: the linear float radiance, no u8 clamp (a
        # capability the reference's 8-bit-only save path lacks)
        from spectral_tpu_torch.render.exr import write_exr

        return write_exr(np.asarray(accum, np.float32), path)
    if u8 is None:
        u8 = accum_to_u8(accum, native=native)

    if path.suffix.lower() == ".png" and native is not False:
        try:
            from spectral_tpu_torch.runtime import native as native_mod

            path.write_bytes(native_mod.encode_png_rgba(u8))
            return path
        except Exception:
            if native is True:
                raise

    from PIL import Image

    img = Image.fromarray(u8, mode="RGBA")
    if path.suffix.lower() in (".jpg", ".jpeg", ".bmp"):
        img = img.convert("RGB")  # no alpha channel in these formats
    img.save(path)
    return path
