"""Offline renders, closed loop, one client: back to back, each image
``Renderer.reset()`` then ``Renderer.render()``, which ends in
``framebuffer()``'s copy to the host. The mix's ``renderer`` keywords
pick the path (regeneration by default, ``persist``); the cell's
``rate_metric`` names the rate it reports (``msamples_per_s`` by
default)."""

from __future__ import annotations

import math
import sys
import time
import traceback

import numpy as np

from benchmark.harness import check, scene
from benchmark.metrics import stats
from benchmark.reference import paths


class Driver:
    def __init__(self, cell, seed: int, device: str, spans):
        self.cell = cell
        self.config = cell.config
        self.params = cell.traffic
        self.device = device
        self.spans = spans
        self.scene = scene.scene_dict(self.config)
        self.px, self.py = check.pixel_grid(self.config["width"], self.config["height"],
                                            int(self.params["check"]["stride"]), seed)
        self.chunk = self.regen_chunk(self.config)
        self.renderer = None
        self.images = []  # (end, finite, sample [P, 4], persist launches)
        self.failed = 0
        self.start = None

    def setup(self) -> None:
        from spectral_tpu_torch.render.renderer import Renderer
        from spectral_tpu_torch.utils import sceneio

        self.renderer = Renderer(sceneio.scene_from_dict(self.scene), device=self.device,
                                 **self.params.get("renderer", {}))
        if not self.renderer.persist and self.renderer.regen_frames != self.chunk:
            raise RuntimeError(f"the Renderer chunks {self.renderer.regen_frames} frames, "
                               f"the reference {self.chunk}")
        self._image()  # the cell's one warm-up image
        self.images.clear()
        self.failed = 0

    def _image(self) -> None:
        r = self.renderer
        try:
            with self.spans("reset"):
                r.reset()
            with self.spans("render"):
                fb = r.render()
        except Exception:  # noqa: BLE001 -- a refused or failed render counts as failed
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            return
        end = time.perf_counter()
        finite = math.isfinite(float(fb.sum()))
        launches = (r.persist_info or {}).get("launches")
        self.images.append((end, finite, fb[self.py, self.px].copy(), launches))

    def run(self, seconds: float) -> None:
        self.start = time.perf_counter()
        deadline = self.start + seconds
        while time.perf_counter() < deadline:
            self._image()

    def summary(self) -> dict:
        ok = [im for im in self.images if im[1]]
        per = scene.samples_per_image(self.config)
        rate = stats.rate([per] * len(ok), [im[0] for im in ok], self.start)
        return {"attempted": len(self.images) + self.failed,
                "failed": self.failed + len(self.images) - len(ok),
                "metrics": {self.cell.workload.get("rate_metric", "msamples_per_s"):
                            None if rate is None else rate / 1e6}}

    def release(self) -> None:
        self.renderer = None

    def reference(self, work=None) -> np.ndarray:
        """The reference's ``[P, 4]`` values of the sample (``work``, when
        given, counts what the sample's paths needed)."""
        import torch

        st, cfg = paths.tables(self.scene, self.device)
        px = torch.from_numpy(self.px).to(self.device)
        py = torch.from_numpy(self.py).to(self.device)
        if self.params.get("renderer", {}).get("persist"):
            out = paths.persist_image(st, cfg, px, py, cfg.intended_frames, work)
        else:
            out = paths.regen_image(st, cfg, px, py, cfg.intended_frames, self.chunk, work)
        return out.cpu().numpy()

    @staticmethod
    def regen_chunk(config: dict) -> int:
        """The frames of one regeneration launch under the Renderer's
        documented ``"auto"``: 100 (64 above 64 wavelengths), at most
        ``1 + 2 GiB / (12 W H)`` and the image's iterations."""
        cap = 100 if int(config["wavelengths"]) <= 64 else 64
        cap = min(cap, 1 + 2 * 1024**3 // (12 * int(config["width"]) * int(config["height"])))
        return max(1, min(int(config["iterations"]), cap))

    def check(self, count: bool = False):
        """``({"pixel_gap": (value, limit)}, work)``: every image of the
        window against one reference computation of the sample."""
        work = paths.Work() if count else None
        ref = self.reference(work=work)
        gaps = [check.pixel_gap(im[2], ref) for im in self.images]
        gap = max(gaps) if gaps else float("inf")
        return {"pixel_gap": (gap, float(self.cell.workload["limits"]["pixel_gap"]))}, work

    def frames_rendered(self) -> int:
        return len(self.images) * int(self.config["iterations"])
