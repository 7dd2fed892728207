"""Progressive renderer (the twin of ``spectral_tpu.render.renderer`` for
the port's slices).

``Renderer(scene, device="cuda")`` flattens the scene once onto the
device, packs the kernels' tables, and renders progressive frames into an
``[H, W, 4]`` accumulator with the reference's ``1/(frame+1)`` blend.
Frames go in K-frame chunks through the regeneration kernel
(``run_regen``); a ragged tail, ``regen_frames=1`` and single-frame
renders go frame by frame through the mono kernel (``run_mono``).
``persist=True`` renders the whole image in one free-running persistent
batch (``run_persist``, budget from the ``run_cost`` probe), optionally
variance-adaptive. Both kinds checkpoint and resume. On ``device="cpu"``
the same calls run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable

import numpy as np
import torch

from spectral_tpu.render import image as image_mod
from spectral_tpu.scene.schema import Scene
from spectral_tpu_torch.ops.megakernel import pack_tables
from spectral_tpu_torch.render.cuda_integrator import (
    cost_sort_perm,
    probe_path_cost,
    render_frame_step_cuda,
    render_frames_step_cuda_regen,
    render_persistent,
)
from spectral_tpu_torch.render.integrator import PersistState
from spectral_tpu_torch.scene.flatten import FIELDS, RenderConfig, SceneTensors, flatten_scene

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


def scene_digest(scene: SceneTensors, config: RenderConfig) -> str:
    """sha256 of the flattened scene's host tables and the render config,
    stored in checkpoints: equal digests render identically, so they are
    exactly the resumable set (the reference's ``scene_digest``,
    ``renderer.py:296``, over the port's own ``np_fields``)."""
    h = hashlib.sha256()
    h.update(b"spectral_tpu_torch-digest-v1:")
    h.update(repr(config).encode())
    for name in FIELDS:
        v = scene.np_fields[name]
        h.update(name.encode())
        if v is None:
            h.update(b"<none>")
            continue
        a = np.asarray(v)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


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
    ``regen_sort=True`` assigns pixels to the regeneration lanes in
    descending probed path cost (pure relabeling; "auto" leaves it off,
    as the reference does).
    ``persist=True`` renders all intended frames in one free-running
    persistent batch from frame 0 (``render_persistent``): progress and
    abort at launch granularity, ``persist_budget`` bounce iterations per
    launch (default from a cost probe), ``persist_frames_per_launch`` for
    that default, and ``adaptive=(min_frames, rtol, atol)`` for
    per-pixel variance-adaptive stopping. ``persist_info`` then holds the
    render's ``info``. The carried lane state, which ``save_checkpoint``
    writes, is kept after an aborted persist render, and after a finished
    one only with ``persist_keep_state=True``.
    The reference renderer's ``phase_split`` and ``sharding`` are refused
    with ``NotImplementedError`` until their slices land.
    """

    def __init__(self, scene: Scene, device: str = "cuda",
                 regen_frames: int | str = "auto", *, persist: bool = False,
                 persist_budget: int | None = None,
                 persist_frames_per_launch: int | None = None,
                 adaptive: tuple | None = None,
                 persist_keep_state: bool = False,
                 regen_sort: bool | str = "auto",
                 phase_split=None, sharding=None):
        later = {
            "phase_split": (phase_split, "the run_seg kernel's slice"),
            "sharding": (sharding, "multi-GPU slice"),
        }
        asked = [f"{k} ({why})" for k, (v, why) in later.items() if v is not None]
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
        self.scene_digest = scene_digest(self.scene_tensors, self.config)
        cfg = self.config
        if persist and regen_frames == "auto":
            regen_frames = 1  # persist supersedes the default regen chunking
        if regen_frames == "auto":
            regen_frames = auto_regen_frames(
                cfg.width, cfg.height, cfg.n_samples, cfg.intended_frames
            )
        if int(regen_frames) < 1:
            raise ValueError("regen_frames must be >= 1")
        self.regen_frames = int(regen_frames)
        if regen_sort == "auto":
            # measured and rejected as a default by the reference (per-pixel
            # cost is mostly per-frame noise); an opt-in here too until an
            # H100 measurement says otherwise
            regen_sort = False
        if regen_sort and self.regen_frames < 2:
            raise ValueError("regen_sort requires regen_frames >= 2")
        self.regen_sort = bool(regen_sort)
        self._lane_perm = self._lane_inv = None
        self.persist = bool(persist)
        self.persist_budget = persist_budget
        self.persist_fpl = persist_frames_per_launch
        self.persist_keep_state = bool(persist_keep_state)
        self.adaptive = None
        if adaptive is not None:
            if not persist:
                raise ValueError(
                    "adaptive sampling runs on the persist kernel: pass persist=True"
                )
            self.adaptive = (int(adaptive[0]), float(adaptive[1]), float(adaptive[2]))
        if self.persist and (self.regen_frames > 1 or self.regen_sort):
            raise ValueError(
                "persist is a standalone dispatch mode: drop regen_frames/regen_sort"
            )
        self.persist_info: dict | None = None
        self._persist_resume: dict | None = None
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

    def _ensure_lane_perm(self) -> None:
        """Probe per-pixel path cost over 2 frames and build the cost-sorted
        lane permutation, once, at the first regeneration chunk."""
        if self._lane_perm is None:
            cost = probe_path_cost(self.scene_tensors, self.config, self.tables,
                                   n_probe_frames=2)
            self._lane_perm, self._lane_inv = cost_sort_perm(cost)

    def _advance_regen(self, first_frame: int, k: int) -> None:
        lanes = {}
        if self.regen_sort:
            self._ensure_lane_perm()
            lanes = dict(lane_perm=self._lane_perm, lane_inv=self._lane_inv)
        self.accum = render_frames_step_cuda_regen(
            self.scene_tensors, self.config, self.accum, first_frame, k,
            self.tables, **lanes,
        )

    def render_frames(
        self,
        n_frames: int,
        progress: Callable[[RenderProgress], None] | None = None,
        abort: Callable[[], bool] | None = None,
        check_finite: bool = False,
    ) -> np.ndarray:
        """Render up to ``n_frames`` more progressive iterations and return
        the framebuffer. ``abort`` is polled after each chunk (with
        ``persist``, after each launch)."""
        if self.persist:
            return self._render_persistent(n_frames, progress, abort, check_finite)
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

    def _render_persistent(self, n_frames, progress, abort, check_finite) -> np.ndarray:
        """The whole render as one free-running batch from frame 0; the
        carried lane state is not a frame-boundary accumulator, so only a
        full render, or the continuation of a loaded persist checkpoint,
        is expressible."""
        total = self.config.intended_frames
        resume = self._persist_resume
        self._persist_resume = None
        if (self.next_frame != 0 and resume is None) or n_frames < total:
            raise ValueError(
                "persist renders the whole image in one batch: call "
                "render()/render_frames(intended_frames) from frame 0, or load "
                "a persist checkpoint to continue an aborted one"
            )
        begin = time.monotonic()
        pixels = self.config.width * self.config.height

        def on_launch(min_done, launches):
            if progress is not None:
                progress(RenderProgress(
                    max(min_done - 1, 0), total, time.monotonic() - begin,
                    pixels=pixels, n_samples=self.config.n_samples,
                ))

        # live preview: refresh the framebuffer from the carried state at
        # most once a second, so a viewer polling it sees progress
        last_preview = [0.0]

        def on_preview(make_rgb):
            now = time.monotonic()
            if now - last_preview[0] < 1.0:
                return
            last_preview[0] = now
            self._set_rgb(make_rgb())

        rgb, info = render_persistent(
            self.scene_tensors, self.config, total, self.tables,
            budget=self.persist_budget, frames_per_launch=self.persist_fpl,
            progress=on_launch, should_abort=abort, adaptive=self.adaptive,
            preview=on_preview if progress is not None else None,
            resume_state=resume, return_state=True,
        )
        if not (info["aborted"] or self.persist_keep_state):
            del info["resume_state"]  # nothing left to resume: free the planes
        self.persist_info = info
        self._set_rgb(rgb)
        self.next_frame = total if not info["aborted"] else info["frames_done"]
        if check_finite and not bool(torch.isfinite(self.accum).all()):
            raise FloatingPointError("non-finite framebuffer after persist render")
        return self.framebuffer()

    def _set_rgb(self, rgb: torch.Tensor) -> None:
        alpha = torch.ones(rgb.shape[:2] + (1,), dtype=torch.float32, device=rgb.device)
        self.accum = torch.cat([rgb, alpha], dim=-1)

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

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, path) -> None:
        """Save the accumulator and frame counter, or, for a persist render,
        its full carried lane state (the accumulator alone cannot continue
        a lane-asynchronous render). The npz keys are the reference's
        (``renderer.py:1227``), so the file says which kind it is."""
        if self.persist:
            info = self.persist_info
            if not info or "resume_state" not in info:
                raise ValueError(
                    "no persist state to checkpoint: abort a render, or render "
                    "with persist_keep_state=True"
                )
            rs = info["resume_state"]
            meta = rs["meta"]

            def host(a):
                return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)

            payload = {f"state_{i}": host(a) for i, a in enumerate(rs["state"])}
            payload.update(
                px=host(rs["px"]), py=host(rs["py"]), kind="persist",
                frames_done=info["frames_done"],
                meta_n_frames=meta["n_frames"], meta_budget=meta["budget"],
                meta_tile=meta["tile"],
                intended_frames=self.config.intended_frames,
                width=self.config.width, height=self.config.height,
                scene_digest=self.scene_digest,
            )
            if meta["adaptive"] is not None:
                payload["meta_adaptive"] = np.asarray(meta["adaptive"], np.float64)
                payload.update(
                    stop=host(rs["stop"]), pixel_of_slot=rs["pixel_of_slot"],
                    packed_workable=rs["packed_workable"],
                    compactions=rs["compactions"],
                    **{f"stat_{i}": host(a) for i, a in enumerate(rs["stats"])},
                )
        else:
            payload = dict(
                accum=self.framebuffer(), next_frame=self.next_frame,
                intended_frames=self.config.intended_frames,
                width=self.config.width, height=self.config.height,
                scene_digest=self.scene_digest,
            )
        # through a file handle: np.savez(path) would append '.npz' to a
        # name without it, and resume-by-name would miss the file
        with open(path, "wb") as f:
            np.savez(f, **payload)

    def load_checkpoint(self, path) -> None:
        """Continue from ``save_checkpoint``'s file. Refuses another
        config, another kind (persist or accumulator) and another scene
        (digest); a persist checkpoint also must match ``adaptive``."""
        data = np.load(path)
        if (
            int(data["width"]) != self.config.width
            or int(data["height"]) != self.config.height
            or int(data["intended_frames"]) != self.config.intended_frames
        ):
            raise ValueError("checkpoint was produced by an incompatible render config")
        is_persist = "kind" in data.files and str(data["kind"]) == "persist"
        if is_persist != self.persist:
            raise ValueError(
                "checkpoint kind mismatch: "
                + ("a persist checkpoint needs persist=True" if is_persist else
                   "an accumulator checkpoint cannot continue a persist render")
            )
        if "scene_digest" not in data.files:
            raise ValueError("not a checkpoint of this renderer: it has no scene_digest")
        if str(data["scene_digest"]) != self.scene_digest:
            raise ValueError(
                "checkpoint was rendered from a DIFFERENT scene (same "
                "dimensions, different content); resuming would blend "
                "two unrelated renders"
            )
        if is_persist:
            self._load_persist_checkpoint(data)
            return
        self.accum = torch.as_tensor(data["accum"], dtype=torch.float32).to(self.device)
        self.next_frame = int(data["next_frame"])

    def _load_persist_checkpoint(self, data) -> None:
        meta_ad = None
        if "meta_adaptive" in data.files:
            a = np.asarray(data["meta_adaptive"]).tolist()
            meta_ad = (int(a[0]), float(a[1]), float(a[2]))
        if meta_ad != self.adaptive:
            raise ValueError(
                f"persist checkpoint was saved with adaptive={meta_ad}; "
                f"this renderer has adaptive={self.adaptive}"
            )
        rs = {
            "state": tuple(data[f"state_{i}"] for i in range(len(PersistState.CARRIED))),
            "px": data["px"], "py": data["py"],
            "meta": {
                "n_frames": int(data["meta_n_frames"]),
                "budget": int(data["meta_budget"]),
                "tile": int(data["meta_tile"]),
                "adaptive": meta_ad,
            },
        }
        if meta_ad is not None:
            rs.update(
                stop=data["stop"],
                stats=tuple(data[f"stat_{i}"] for i in range(5)),
                pixel_of_slot=data["pixel_of_slot"],
                packed_workable=int(data["packed_workable"]),
                compactions=int(data["compactions"]),
            )
        self._persist_resume = rs
        self.next_frame = int(data["frames_done"])  # display and ETA only
