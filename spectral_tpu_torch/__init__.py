"""spectral_tpu_torch — the PyTorch + CUDA port of ``spectral_tpu``.

The same spectral path tracer for one NVIDIA H100: eager PyTorch around
hand-written CUDA kernels (``ops/csrc``), held against the JAX package,
which stays the reference. This package imports torch and never jax, and
nothing of the JAX package: it keeps its own copies of the host modules it
needs (scene schema and presets, spectra, image output).

Public surface (lazy):
    spectral_tpu_torch.Renderer       -- progressive renderer
    spectral_tpu_torch.flatten_scene  -- scene -> tensors on a device
    spectral_tpu_torch.presets        -- scene presets (the port's copy)
    spectral_tpu_torch.schema         -- scene schema (the port's copy)
"""

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
    raise AttributeError(f"module 'spectral_tpu_torch' has no attribute {name!r}")


__all__ = ["Renderer", "flatten_scene", "presets", "schema", "__version__"]
