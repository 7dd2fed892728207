"""ctypes bindings for the native (C++) image codec (the port's copy of
``spectral_tpu.runtime.native``).

The shared library is built on demand with g++ from the port's own copy
of the source, ``runtime/csrc/imagecodec.cpp``, into ``build/`` inside
this package, and rebuilt when the source is newer. Each build writes a
file of its own and renames it into place, so processes that build at
once never load a half-written library. ``image.accum_to_u8`` and
``image.save_image`` fall back to numpy/PIL when the build fails,
unless the caller asks for the native path (``native=True``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG_DIR = Path(__file__).resolve().parents[1]
_SRC = _PKG_DIR / "runtime" / "csrc" / "imagecodec.cpp"
_LIB_PATH = _PKG_DIR / "build" / "libimagecodec.so"


class NativeUnavailable(RuntimeError):
    pass


def _build() -> Path:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", str(_SRC),
        "-o", str(tmp), "-lz", "-lpthread",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeUnavailable(f"native build failed: {e}") from e
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


@functools.cache
def load_imagecodec() -> ctypes.CDLL:
    """Load (building if needed) the native image codec."""
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.convert_f32_rgba_to_u8.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
    ]
    lib.convert_f32_rgba_to_u8.restype = None
    lib.encode_png_rgba.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.encode_png_rgba.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.free_buffer.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.free_buffer.restype = None
    return lib


def convert_f32_rgba_to_u8(data: np.ndarray) -> np.ndarray:
    """Multithreaded clamp/scale/truncate, same semantics as
    ``image.accum_to_u8``."""
    lib = load_imagecodec()
    src = np.ascontiguousarray(data, dtype=np.float32)
    dst = np.empty(src.shape, dtype=np.uint8)
    lib.convert_f32_rgba_to_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(src.size),
    )
    return dst


def encode_png_rgba(u8: np.ndarray) -> bytes:
    """Encode an ``[H, W, 4]`` uint8 array as PNG bytes."""
    lib = load_imagecodec()
    u8 = np.ascontiguousarray(u8, dtype=np.uint8)
    if u8.ndim != 3 or u8.shape[2] != 4:
        raise ValueError(f"expected [H, W, 4] uint8, got {u8.shape}")
    h, w, _ = u8.shape
    out_len = ctypes.c_int64(0)
    ptr = lib.encode_png_rgba(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(w),
        ctypes.c_int32(h),
        ctypes.byref(out_len),
    )
    if not ptr:
        raise NativeUnavailable("png encode failed")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.free_buffer(ptr)


def available() -> bool:
    try:
        load_imagecodec()
        return True
    except NativeUnavailable:
        return False
