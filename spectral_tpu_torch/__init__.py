"""spectral_tpu_torch — the PyTorch + CUDA port of ``spectral_tpu``.

The same spectral path tracer for one NVIDIA H100: eager PyTorch around
hand-written CUDA kernels (``ops/csrc``), held against the JAX package,
which stays the reference. This package imports torch and never jax, and
nothing of the JAX package: it keeps its own copies of the host modules it
needs (scene schema and presets, spectra, image output).

Public surface (the reference's, ``spectral_tpu/__init__.py``, and the
port's own; all but the spectrum names lazy):
    spectral_tpu_torch.Spectrum       -- host-side spectrum value type
    spectral_tpu_torch.Renderer       -- progressive renderer
    spectral_tpu_torch.flatten_scene  -- scene -> tensors on a device
    spectral_tpu_torch.presets        -- scene presets (the port's copy)
    spectral_tpu_torch.schema         -- scene schema (the port's copy)
    spectral_tpu_torch.load_scene / save_scene -- JSON scene files
    spectral_tpu_torch.animation      -- keyframe animation, motion blur
    spectral_tpu_torch.mesh           -- triangle-mesh helpers
"""

from spectral_tpu_torch.spectral.spectrum import (
    NBR_OF_SAMPLES_MAX,
    VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND,
    VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND,
    Spectrum,
)

__version__ = "0.1.0"


def __getattr__(name):
    if name == "Renderer":
        from spectral_tpu_torch.render.renderer import Renderer

        return Renderer
    if name == "flatten_scene":
        from spectral_tpu_torch.scene.flatten import flatten_scene

        return flatten_scene
    if name == "presets":
        from spectral_tpu_torch.scene import presets

        return presets
    if name == "schema":
        from spectral_tpu_torch.scene import schema

        return schema
    if name == "load_scene":
        from spectral_tpu_torch.utils.sceneio import load_scene

        return load_scene
    if name == "save_scene":
        from spectral_tpu_torch.utils.sceneio import save_scene

        return save_scene
    if name == "animation":
        from spectral_tpu_torch.render import animation

        return animation
    if name == "mesh":
        from spectral_tpu_torch.scene import mesh

        return mesh
    raise AttributeError(f"module 'spectral_tpu_torch' has no attribute {name!r}")


__all__ = [
    "Spectrum",
    "Renderer",
    "flatten_scene",
    "presets",
    "schema",
    "load_scene",
    "save_scene",
    "animation",
    "mesh",
    "VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND",
    "VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND",
    "NBR_OF_SAMPLES_MAX",
    "__version__",
]
