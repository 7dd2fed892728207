"""[Frozen copy of ``spectral_tpu_torch/render/color.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Spectrum -> linear RGB (the twin of ``spectral_tpu.render.color``): the
per-sample CIE XYZ weights and the XYZ -> RGB matrix as two float32
matmuls. A plain matrix product outside any kernel, as the reference
package leaves it to XLA; it must not drop to TF32, which the renderer
turns off where it is built."""

from __future__ import annotations

import torch


def spectra_to_rgb(
    spectra: torch.Tensor, xyz_weights: torch.Tensor, xyz_to_rgb: torch.Tensor
) -> torch.Tensor:
    """``[..., S]`` spectra -> ``[..., 3]`` linear RGB (no gamma)."""
    xyz = torch.matmul(spectra, xyz_weights)
    return torch.matmul(xyz, xyz_to_rgb.T)
