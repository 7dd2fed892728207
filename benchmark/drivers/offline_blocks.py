"""Offline renders as ``offline.py`` drives them, checked against the
blocked reference (``benchmark/reference/blocks.py``): the renderer's own
plan of full regeneration chunks and a frame-by-frame tail, traced one
launch's worth of the sample at a time. For images too large for
``paths.regen_image``, or whose iterations are not a multiple of K."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.harness.core import load_module
from benchmark.reference import blocks, paths

offline = load_module(Path(__file__).with_name("offline.py"), "bench_driver_offline_base")


class Driver(offline.Driver):
    def reference(self, work=None) -> np.ndarray:
        """The blocked reference's ``[P, 4]`` values of the sample (``work``,
        when given, counts what every block's paths needed)."""
        import torch

        st, cfg = paths.tables(self.scene, self.device)
        px = torch.from_numpy(self.px).to(self.device)
        py = torch.from_numpy(self.py).to(self.device)
        out = blocks.regen_plan_image(st, cfg, px, py, cfg.intended_frames, self.chunk, work)
        return out.cpu().numpy()
