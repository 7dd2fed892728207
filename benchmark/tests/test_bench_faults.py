"""A run of a cell with its timed path broken underneath comes out not
correct, for each fault a rendering cell can have; the same run unbroken
comes out correct. On the CPU, at tiny sizes, the look for a card skipped:
the harness drives the Renderer's plain versions."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import control, core
from benchmark.tests import tiny
from spectral_tpu_torch.render.renderer import Renderer

REPO = Path(__file__).resolve().parents[2]
CELLS = {"tinybox.regen": "regen", "tinybox.persist": "persist", "tinybox.live": "live"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    scene = json.loads((REPO / "benchmark/configs/cornell512.json").read_text())["scene"]
    # 16 iterations: the live mix's chunk is one 16-frame launch
    configs = {"tinybox": tiny.tiny_config("tinybox", scene, 24, 16, 3, 16)}
    cells = {name: {"config": "tinybox", "traffic": f"{mix}-dense", "chips": 1,
                    "like": f"cornell512.{mix}", "limits": tiny.limits(f"cornell512.{mix}")}
             for name, mix in CELLS.items()}
    return tiny.tree(tmp_path_factory.mktemp("bench"), cells, configs, tiny.dense_mixes())


def _unchanged(mp, driver):
    """The render step returns its state unchanged: no frame is rendered."""
    mp.setattr(Renderer, "render_frames", lambda self, n, **kw: self.framebuffer())


def _half(mp, driver):
    """Half of the frames left out, the mean taken over the rest."""
    keep = Renderer.render_frames
    mp.setattr(Renderer, "render_frames", lambda self, n, **kw: keep(self, max(1, n // 2), **kw))


def _altered(mp, driver):
    """An answer altered where it is produced: one sampled pixel 1% off."""
    keep = Renderer.framebuffer
    y, x = int(driver.py[0]), int(driver.px[0])

    def framebuffer(self):
        fb = np.array(keep(self))
        fb[y, x, 0] *= 1.01
        return fb

    mp.setattr(Renderer, "framebuffer", framebuffer)


def _tinted(mp, driver):
    """Every pixel's red channel 1% off (a wrong constant in the fold)."""
    keep = Renderer.framebuffer

    def framebuffer(self):
        fb = np.array(keep(self))
        fb[..., 0] *= 1.01
        return fb

    mp.setattr(Renderer, "framebuffer", framebuffer)


def _tf32(mp, driver):
    """The control: the program's RGB fold in TF32 (emulated on the CPU)."""
    control.program_in_tf32(driver, mp.setattr)


FAULTS = {"unchanged": _unchanged, "half_frames": _half, "pixel_altered": _altered,
          "fold_tinted": _tinted, "fold_in_tf32": _tf32}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    out = core.run_cell(root, cell, 424242, 0.5, False, device="cpu")
    assert out["correct"] is True, out["check"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    out = core.run_cell(root, cell, 424243, 0.5, False, device="cpu",
                        driver_hook=lambda d: FAULTS[fault](monkeypatch, d))
    assert out["correct"] is False, out["check"]
    assert out["check"]["pixel_gap"]["value"] > out["check"]["pixel_gap"]["limit"]
