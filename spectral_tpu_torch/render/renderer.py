"""Progressive renderer (the twin of ``spectral_tpu.render.renderer`` for
the port's first slice).

``Renderer(scene, device="cuda")`` flattens the scene once onto the
device, packs the kernels' tables, and renders progressive frames into an
``[H, W, 4]`` accumulator with the reference's ``1/(frame+1)`` blend.
Frames go in K-frame chunks through the regeneration kernel
(``run_regen``); a ragged tail, ``regen_frames=1`` and single-frame
renders go frame by frame through the mono kernel (``run_mono``). On
``device="cpu"`` the same calls run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from spectral_tpu.render import image as image_mod
from spectral_tpu.scene.schema import Scene
from spectral_tpu_torch.ops.megakernel import pack_tables
from spectral_tpu_torch.render.cuda_integrator import (
    render_frame_step_cuda,
    render_frames_step_cuda_regen,
)
from spectral_tpu_torch.scene.flatten import flatten_scene

# HBM budget for the K-1 direction planes of one regeneration launch
# (3 f32 planes per frame: 12*(K-1)*W*H bytes)
REGEN_DIRECTION_BUDGET = 2 * 1024**3


@dataclasses.dataclass
class RenderProgress:
    """Per-chunk progress report."""

    frame_id: int
    total_frames: int
    elapsed_s: float
    pixels: int = 0
    n_samples: int = 0

    @property
    def fraction(self) -> float:
        return (self.frame_id + 1) / self.total_frames

    @property
    def seconds_per_frame(self) -> float:
        return self.elapsed_s / max(1, self.frame_id + 1)


def auto_regen_frames(width: int, height: int, n_samples: int, intended: int) -> int:
    """Default K: 100 frames per launch (64 above 64 wavelengths), bounded
    by the direction planes' memory budget and the frames asked for."""
    cap = 100 if n_samples <= 64 else 64
    cap = min(cap, 1 + REGEN_DIRECTION_BUDGET // (12 * width * height))
    return max(1, min(intended, cap))


class Renderer:
    """Progressive spectral renderer for one scene snapshot on one device.

    ``device``: "cuda" launches the hand-written kernels (and raises when
    no GPU is present); "cpu" runs their plain PyTorch versions.
    ``regen_frames``: "auto" (see ``auto_regen_frames``) or K >= 1 frames
    per launch; progress and abort operate at chunk granularity.
    The reference renderer's ``persist``, ``phase_split``, ``sharding``
    and ``regen_sort`` are refused with ``NotImplementedError`` until
    their slices land.
    """

    def __init__(self, scene: Scene, device: str = "cuda",
                 regen_frames: int | str = "auto", *, persist: bool = False,
                 phase_split=None, sharding=None, regen_sort: bool = False):
        later = {
            "persist": (persist, "persist/adaptive slice"),
            "phase_split": (phase_split, "the run_seg kernel's slice"),
            "sharding": (sharding, "multi-GPU slice"),
            "regen_sort": (regen_sort, "the run_cost kernel's slice"),
        }
        asked = [f"{k} ({why})" for k, (v, why) in later.items() if v not in (None, False)]
        if asked:
            raise NotImplementedError(
                "not in the PyTorch/CUDA port yet: " + "; ".join(asked)
                + " (see ROADMAP.md queue 1)"
            )
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Renderer(device='cuda') needs a CUDA GPU and "
                    "torch.cuda.is_available() is False; pass device='cpu' "
                    "for the plain PyTorch path"
                )
        elif device.type != "cpu":
            raise ValueError(f"unsupported device {device}")
        # spectra_to_rgb is a float32 matmul: never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = device
        self.scene_tensors, self.config = flatten_scene(scene, device)
        self.tables = pack_tables(self.scene_tensors, self.config)  # raises outside the slice
        cfg = self.config
        if regen_frames == "auto":
            regen_frames = auto_regen_frames(
                cfg.width, cfg.height, cfg.n_samples, cfg.intended_frames
            )
        if int(regen_frames) < 1:
            raise ValueError("regen_frames must be >= 1")
        self.regen_frames = int(regen_frames)
        self.reset()

    def reset(self) -> None:
        cfg = self.config
        self.accum = torch.zeros(
            (cfg.height, cfg.width, 4), dtype=torch.float32, device=self.device
        )
        self.next_frame = 0

    def _advance(self, frame_id: int) -> None:
        self.accum = render_frame_step_cuda(
            self.scene_tensors, self.config, self.accum, frame_id, self.tables
        )

    def _advance_regen(self, first_frame: int, k: int) -> None:
        self.accum = render_frames_step_cuda_regen(
            self.scene_tensors, self.config, self.accum, first_frame, k,
            self.tables,
        )

    def render_frames(
        self,
        n_frames: int,
        progress: Callable[[RenderProgress], None] | None = None,
        abort: Callable[[], bool] | None = None,
        check_finite: bool = False,
    ) -> np.ndarray:
        """Render up to ``n_frames`` more progressive iterations and return
        the framebuffer. ``abort`` is polled after each chunk."""
        begin = time.monotonic()
        total = self.config.intended_frames
        rendered = 0
        while rendered < n_frames and self.next_frame < total:
            k = min(self.regen_frames, n_frames - rendered, total - self.next_frame)
            if k > 1 and k == self.regen_frames:
                self._advance_regen(self.next_frame, k)
            else:
                # ragged tail (k < K) or K == 1: frame by frame on the mono
                # kernel, as the reference does
                for j in range(k):
                    self._advance(self.next_frame + j)
            self.next_frame += k
            rendered += k
            if check_finite and not bool(torch.isfinite(self.accum).all()):
                raise FloatingPointError(
                    f"non-finite accumulator after frame {self.next_frame - 1}"
                )
            if progress is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                progress(RenderProgress(
                    self.next_frame - 1, total, time.monotonic() - begin,
                    pixels=self.config.width * self.config.height,
                    n_samples=self.config.n_samples,
                ))
            if abort is not None and abort():
                break
        return self.framebuffer()

    def render(
        self,
        progress: Callable[[RenderProgress], None] | None = None,
        abort: Callable[[], bool] | None = None,
        check_finite: bool = False,
    ) -> np.ndarray:
        """Render all configured iterations."""
        return self.render_frames(
            self.config.intended_frames, progress=progress, abort=abort,
            check_finite=check_finite,
        )

    def framebuffer(self) -> np.ndarray:
        """The ``[H, W, 4]`` float32 accumulation buffer on the host."""
        return self.accum.cpu().numpy()

    def save_image(self, path, exposure=None, gamma=None) -> None:
        """Save the framebuffer (format by extension; linear, no gamma
        unless asked), through the reference package's image writer."""
        image_mod.save_image(self.framebuffer(), path, exposure=exposure, gamma=gamma)
