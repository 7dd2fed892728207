"""The control of every cell comes out not correct through the harness's
own comparison: the program with its RGB fold's products in TF32, the
next precision below the configurations' float32 with TF32 off
(``benchmark/harness/control.py``), switched on after set-up; the same
seeds unswitched come out correct. On the CPU at tiny sizes; on the card
(``gpu``) at a small size, where the process's TF32 flag switched on after
set-up (the fault the control stands for) fails too, and the reference
has to ignore that flag. The cells' own sizes are read on the card by
``benchmark/calibrate.py --control`` (``PERF.md`` gives the readings)."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import control, core
from benchmark.reference import paths
from benchmark.reference.color import spectra_to_rgb
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tiny.regen": "regen", "tiny.persist": "persist", "tiny.live": "live"}


def _root(tmp: Path, size: tuple) -> Path:
    scene = json.loads((REPO / "benchmark/configs/cornell512.json").read_text())["scene"]
    configs = {"tiny": tiny.tiny_config("tiny", scene, *size)}
    cells = {name: {"config": "tiny", "traffic": f"{mix}-dense", "chips": 1,
                    "like": f"cornell512.{mix}", "limits": tiny.limits(f"cornell512.{mix}")}
             for name, mix in CELLS.items()}
    return tiny.tree(tmp, cells, configs, tiny.dense_mixes())


def _sound_and_switched(root: Path, cell: str, seeds, device: str,
                        switch=control.program_in_tf32):
    for seed in seeds:
        sound = core.run_cell(root, cell, seed, 0.3, False, device=device)
        with pytest.MonkeyPatch.context() as mp:
            bad = core.run_cell(root, cell, seed, 0.3, False, device=device,
                                driver_hook=lambda d: switch(d, mp.setattr))
        assert sound["correct"] is True, sound["check"]
        assert bad["correct"] is False, bad["check"]
        gap = bad["check"]["pixel_gap"]
        assert gap["value"] > gap["limit"], gap


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_the_cpu(tmp_path, cell):
    _sound_and_switched(_root(tmp_path, (24, 16, 3, 16)), cell, (101, 102, 103), "cpu")


def test_the_reference_folds_in_full_float32(monkeypatch):
    """Whatever TF32 flags the process holds when the check runs, the
    reference's fold runs with them off and leaves them as it found them."""
    seen = []

    def fold(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return torch.zeros(3)

    monkeypatch.setattr(paths, "spectra_to_rgb", fold)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    st = type("St", (), {"xyz_weights": None, "xyz_to_rgb": None})()
    paths.to_rgb(torch.zeros(2, 2), st)
    assert seen == [(False, False)]
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 flag acts on the card's matmuls alone")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_the_card(tmp_path, cell, card):
    _sound_and_switched(_root(tmp_path, (128, 96, 8, 16)), cell, (201, 202, 203), card)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tf32_flag_switched_on_is_not_correct(tmp_path, cell, card):
    _sound_and_switched(_root(tmp_path, (128, 96, 8, 16)), cell, (211,), card,
                        switch=control.tf32_flag_on)


@pytest.mark.gpu
def test_the_reference_ignores_tf32_flags_on_the_card(card, monkeypatch):
    """At the Cornell box's fold shape (``[512 * 512, 32]`` by ``[32, 3]``),
    where cuBLAS takes TF32 products once the flag is on, the reference's
    fold still matches a float64 fold to float32's rounding."""
    g = torch.Generator(device=card).manual_seed(5)
    rad = torch.rand((32, 512 * 512), generator=g, device=card)
    st = SimpleNamespace(xyz_weights=torch.rand((32, 3), generator=g, device=card),
                         xyz_to_rgb=torch.rand((3, 3), generator=g, device=card))
    exact = (rad.double().T @ st.xyz_weights.double()) @ st.xyz_to_rgb.double().T

    def err(rgb):
        return float((rgb.double() - exact).abs().max() / exact.abs().max())

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    # the flag takes effect at this shape: a fold that obeys it is off by TF32's rounding
    assert err(spectra_to_rgb(rad.T, st.xyz_weights, st.xyz_to_rgb)) > 2e-5
    assert err(paths.to_rgb(rad, st)) < 2e-6
