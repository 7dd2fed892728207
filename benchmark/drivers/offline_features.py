"""Offline renders as ``offline.py`` drives them, checked against the
reference of scenes with features (``benchmark/reference/features.py``):
each bounce's sky, emission and direct light added to a lane's sum in the
kernel's order. For scenes with a sky, emission, textures or a dielectric,
whose every chunk is one regeneration launch."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.harness.core import load_module
from benchmark.reference import features, paths

offline = load_module(Path(__file__).with_name("offline.py"), "bench_driver_offline_base")


class Driver(offline.Driver):
    def reference(self, work=None) -> np.ndarray:
        """The feature reference's ``[P, 4]`` values of the sample (``work``,
        when given, counts what the sample's paths needed)."""
        import torch

        st, cfg = paths.tables(self.scene, self.device)
        px = torch.from_numpy(self.px).to(self.device)
        py = torch.from_numpy(self.py).to(self.device)
        out = features.regen_image(st, cfg, px, py, cfg.intended_frames, self.chunk, work)
        return out.cpu().numpy()
