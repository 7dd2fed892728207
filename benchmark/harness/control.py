"""The control of every cell, and the TF32 fault it stands for.

The configurations state float32 with TF32 off; the nearest precision
below is TF32. The program's RGB fold is PyTorch's float32 matmul, whose
TF32 path is the process's flag: a later change could turn it on. Whether
cuBLAS then takes TF32 products depends on the shape (on the H100 it does
for the Cornell box's fold and not for the 1,000-sphere field's), so the
control does not rely on the flag: ``program_in_tf32`` rounds the fold's
inputs to TF32's mantissa, as the tensor cores read them, on every device.
``tf32_flag_on`` is the fault itself, the flag switched on after set-up,
for the tests on the card. A run so switched has to come out not correct.

Only ``benchmark/calibrate.py --control`` and the tests use them; the
benchmark's own runs never do.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (to nearest on the 13
    dropped bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_fold(spectra, xyz_weights, xyz_to_rgb):
    xyz = torch.matmul(round_tf32(spectra), round_tf32(xyz_weights))
    return torch.matmul(round_tf32(xyz), round_tf32(xyz_to_rgb).T)


def program_in_tf32(driver, setattr_) -> None:
    """The control: the program's fold with TF32 products for ``driver``'s
    window. ``setattr_(obj, name, value)`` makes each change (the tests
    pass ``monkeypatch.setattr``, which undoes them)."""
    from spectral_tpu_torch.render import cuda_integrator, integrator

    for mod in (cuda_integrator, integrator):
        setattr_(mod, "spectra_to_rgb", _tf32_fold)


def tf32_flag_on(driver, setattr_) -> None:
    """The fault: the process's TF32 flags switched on after set-up, and
    again after every ``Renderer`` built later (its constructor turns them
    off; the live cell builds one per edit)."""
    from spectral_tpu_torch.render.renderer import Renderer

    setattr_(torch.backends.cuda.matmul, "allow_tf32", True)
    setattr_(torch.backends.cudnn, "allow_tf32", True)
    init = Renderer.__init__

    def __init__(self, *args, **kwargs):
        init(self, *args, **kwargs)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True

    setattr_(Renderer, "__init__", __init__)
