"""Edits, closed loop, one client, like a user dragging an object and
waiting for each preview. Each edit builds a ``Renderer`` from the edited
scene document (``sceneio.scene_from_dict``, the scene file's parser),
renders one chunk (``render_frames``, which ends in ``framebuffer()``'s
copy to the host) and is done when the preview is on the host. Latency
runs from the edit's submission to that moment.

The edits come from the seed: each moves one of the mix's ``objects`` to
its place in the configuration plus an offset in x and z drawn from
``[-move, move]`` (inside the box), or, every ``material_every``-th edit,
gives it another of the scene's reflective materials. Object and
material counts never change."""

from __future__ import annotations

import copy
import math
import sys
import time
import traceback

import numpy as np

from benchmark.harness import check, scene
from benchmark.metrics import stats
from benchmark.reference import paths


class Edits:
    """The seed's edit sequence over a base scene document."""

    def __init__(self, base: dict, params: dict, seed: int):
        self.rng = np.random.default_rng([seed, 0xED17])
        self.state = copy.deepcopy(base)
        names = [o["name"] for o in base["objects"]]
        self.objects = [names.index(n) for n in params["objects"]]
        self.home = {i: list(base["objects"][i]["position"]) for i in self.objects}
        self.move = float(params["move"])
        self.every = int(params["material_every"])
        emits = {int(m["emission"]) for m in base["materials"] if "emission" in m}
        self.materials = [i for i, m in enumerate(base["materials"])
                          if "emission" not in m and not m.get("transmission")
                          and int(m["spectrum"]) not in emits]
        self.count = 0

    def next(self) -> tuple[dict, bool]:
        """The next edited document, and whether the edit swapped a material."""
        self.count += 1
        i = self.objects[int(self.rng.integers(len(self.objects)))]
        obj = self.state["objects"][i]
        material = self.count % self.every == 0
        if material:
            others = [m for m in self.materials if m != int(obj["material"])]
            obj["material"] = int(others[int(self.rng.integers(len(others)))])
        else:
            dx, dz = self.rng.uniform(-self.move, self.move, size=2)
            home = self.home[i]
            obj["position"] = [home[0] + float(dx), home[1], home[2] + float(dz)]
        return copy.deepcopy(self.state), material


class Driver:
    def __init__(self, cell, seed: int, device: str, spans):
        self.cell = cell
        self.config = cell.config
        self.params = cell.traffic
        self.device = device
        self.spans = spans
        self.seed = seed
        self.base = scene.scene_dict(self.config)
        self.edits = Edits(self.base, self.params["edits"], seed)
        self.px, self.py = check.pixel_grid(self.config["width"], self.config["height"],
                                            int(self.params["check"]["stride"]), seed)
        self.chunk = int(self.params["chunk_frames"])
        self.renderer_kw = {k: tuple(v) if isinstance(v, list) else v  # JSON has no tuple
                            for k, v in self.params.get("renderer", {}).items()}
        # per edit of the window: (latency, finite, sample [P, 4], material swap);
        # the documents are not kept (a growing heap would slow the collector
        # in the window): the check draws its edits again from the seed
        self.records = []
        self.failed = 0

    def _edit(self, doc: dict, material: bool = False) -> None:
        import torch
        from spectral_tpu_torch.render.renderer import Renderer
        from spectral_tpu_torch.utils import sceneio

        submitted = time.perf_counter()
        try:
            with self.spans("rebuild"):
                r = Renderer(sceneio.scene_from_dict(doc), device=self.device,
                             **self.renderer_kw)
                if self.device == "cuda":
                    torch.cuda.synchronize()
            with self.spans("chunk"):
                fb = r.render_frames(self.chunk)
            latency = time.perf_counter() - submitted
            if r.regen_frames != min(self.chunk, r.config.intended_frames):
                raise RuntimeError(f"the Renderer chunks {r.regen_frames} frames, the "
                                   f"reference one launch of {self.chunk}")
        except Exception:  # noqa: BLE001 -- a refused or failed edit counts as failed
            traceback.print_exc(file=sys.stderr)
            self.failed += 1
            return
        finite = math.isfinite(float(fb.sum()))
        self.records.append((latency, finite, fb[self.py, self.px].copy(), material))

    def setup(self) -> None:
        self._edit(self.base)  # the cell's one warm-up edit
        self.records.clear()
        self.failed = 0

    def run(self, seconds: float) -> None:
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            self._edit(*self.edits.next())

    def summary(self) -> dict:
        ok = [r for r in self.records if r[1]]
        p95 = stats.percentile([r[0] for r in ok], 95)
        return {"attempted": len(self.records) + self.failed,
                "failed": self.failed + len(self.records) - len(ok),
                "metrics": {"preview_p95_ms": None if p95 is None else 1e3 * p95}}

    def release(self) -> None:
        pass

    def checked(self) -> list[int]:
        """The edits compared: ``check.edits`` of the window's, drawn from
        the seed, with a material swap among them."""
        n = len(self.records)
        want = min(n, int(self.params["check"]["edits"]))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        picks = sorted(int(i) for i in rng.choice(n, size=want, replace=False)) if want else []
        swaps = [i for i, r in enumerate(self.records) if r[3]]
        if picks and swaps and not any(self.records[i][3] for i in picks):
            picks[0] = swaps[int(rng.integers(len(swaps)))]
        return sorted(set(picks))

    def reference(self, doc: dict) -> np.ndarray:
        import torch

        st, cfg = paths.tables(doc, self.device)
        px = torch.from_numpy(self.px).to(self.device)
        py = torch.from_numpy(self.py).to(self.device)
        frames = min(self.chunk, cfg.intended_frames)  # one regeneration launch
        return paths.regen_image(st, cfg, px, py, frames, frames).cpu().numpy()

    def documents(self, indices) -> dict:
        """The scene documents of the window's edits ``indices``, drawn
        again from the seed (a failed edit would shift them; it fails the
        run anyway)."""
        edits = Edits(self.base, self.params["edits"], self.seed)
        docs = {}
        for i in range(max(indices, default=-1) + 1):
            doc, _material = edits.next()
            if i in indices:
                docs[i] = doc
        return docs

    def check(self, count: bool = False):
        """``({"pixel_gap": (value, limit)}, None)`` over the sampled edits."""
        docs = self.documents(self.checked())
        gaps = [check.pixel_gap(self.records[i][2], self.reference(doc))
                for i, doc in docs.items()]
        gap = max(gaps) if gaps else float("inf")
        return {"pixel_gap": (gap, float(self.cell.workload["limits"]["pixel_gap"]))}, None
