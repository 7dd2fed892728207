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
variance-adaptive. ``phase_split`` renders each frame as bounce segments
(``run_seg``) with the live lanes compacted between them. Scenes of more
than 64 objects walk a cluster plan (``ops/clusters.py``), and their
regeneration lanes take the Morton layout (``render/layout.py``). All
kinds checkpoint and resume. A scene with a sky, checker textures,
emissive surfaces or a dielectric runs the kernels' feature builds.
``sharding=row_sharding(mesh)`` renders one row slab per mesh slot, in one
process or across processes (``parallel/``); ``frames_per_dispatch``
groups frame-by-frame renders between the host's checks; ``accel="grid"``
traces through the uniform grid on the CPU. On ``device="cpu"`` the same
calls run the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import math
import time
from typing import Callable

import numpy as np
import torch

from spectral_tpu_torch.ops.megakernel import BLOCK, pack_tables, repack_tables, with_features
from spectral_tpu_torch.parallel import distributed
from spectral_tpu_torch.parallel.mesh import RowSharding
from spectral_tpu_torch.parallel.sharding import (
    gather,
    render_frame_step_sharded,
    render_frames_step_sharded_regen,
    render_persistent_sharded,
    shard_scene,
)
from spectral_tpu_torch.render import image as image_mod
from spectral_tpu_torch.render.cuda_integrator import (
    check_splits,
    cost_sort_perm,
    default_phase_capacity,
    integrate_frame_cascade,
    integrate_frame_cuda,
    probe_path_cost,
    render_frame_step_cuda,
    render_frames_step_cuda_regen,
    render_persistent,
)
from spectral_tpu_torch.render.integrator import (
    FX_EMISSION,
    FX_TRANSMISSION,
    PersistState,
    accumulate_frame,
    integrate_frame,
)
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene.accel import build_grid
from spectral_tpu_torch.scene.flatten import (
    FIELDS,
    RenderConfig,
    SceneTensors,
    flatten_scene,
    from_numpy,
    smooth_triangles,
)
from spectral_tpu_torch.scene.schema import Scene

# The cap on K from the memory of the K-1 direction planes that the
# regeneration kernel took until it generated its primaries itself
# (12*(K-1)*W*H bytes). It no longer has a cause; it stays so that the
# default chunking, and with it the images, are what they were.
REGEN_DIRECTION_BUDGET = 2 * 1024**3

# Each Renderer's serial: the ``request`` of the trace's spans it runs
_REQUESTS = itertools.count()


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

    @property
    def mpaths_per_s(self) -> float:
        """Camera paths per second (millions)."""
        return self.pixels / max(self.seconds_per_frame, 1e-9) / 1e6

    @property
    def eta_s(self) -> float:
        done = self.fraction
        return self.elapsed_s / done * (1.0 - done) if done > 0 else float("inf")


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
    if scene.smooth_tri:
        h.update(b"smooth_tri")
    return h.hexdigest()


def choose_stages(
    occ,
    n_pad: int,
    tile: int,
    margin: float = 1.7,
    extract_slope: float = 2.4,
    extract_const: float = 0.10,
    max_cap_frac: float = 0.25,
    max_stages: int = 3,
) -> tuple | None:
    """Pick cascade compaction stages from an occupancy profile (the
    reference's ``choose_stages``, ``renderer.py:220``, copied as is).

    ``occ[b]`` is the fraction of lanes alive *entering* bounce ``b``
    (``occ[0] == 1``). Enumerates every split set of size <= ``max_stages``
    and minimizes modeled cost in full-wavefront bounce-equivalents: each
    segment costs ``capacity_fraction x n_bounces``, each extraction
    costs ``extract_slope x dest_fraction + extract_const``; splits whose
    tile-rounded capacity exceeds ``max_cap_frac`` are ineligible.
    Capacities carry ``margin`` headroom over the observed occupancy and
    are rounded up to whole tiles. Returns ``((split, capacity_lanes),
    ...)`` or None when no split beats the monolithic kernel under the
    model.

    The constants were CALIBRATED ON A TPU v5e by the reference (its
    extraction and full-wavefront bounce costs); they are not an H100
    model. On the H100 a dead lane costs little (a warp whose lanes are
    all dead retires), so the true trade differs; calibrating it is an
    open question (PERF.md section 7).
    """
    from itertools import combinations

    occ = np.asarray(occ, np.float64)
    n_bounces = len(occ)

    def cap_lanes(b: int) -> int:
        want = min(1.0, float(occ[b]) * margin)
        return max(tile, int(np.ceil(want * n_pad / tile)) * tile)

    def cap_frac(b: int) -> float:
        return min(1.0, cap_lanes(b) / n_pad)

    def cost(splits: tuple) -> float:
        bounds = (0,) + splits + (n_bounces,)
        fracs = (1.0,) + tuple(cap_frac(s) for s in splits)
        total = sum(
            f * (hi - lo) for f, lo, hi in zip(fracs, bounds, bounds[1:])
        )
        total += sum(
            extract_slope * dest + extract_const for dest in fracs[1:]
        )
        return total

    best_splits: tuple = ()
    best_cost = float(n_bounces)  # monolithic
    candidates = [
        b for b in range(1, n_bounces) if cap_frac(b) <= max_cap_frac
    ]
    for k in range(1, max_stages + 1):
        for splits in combinations(candidates, k):
            # a split that doesn't shrink the wavefront only adds overhead
            fracs = [cap_frac(s) for s in splits]
            if any(b >= a for a, b in zip([1.0] + fracs, fracs)):
                continue
            c = cost(splits)
            if c < best_cost:
                best_cost, best_splits = c, splits
    if not best_splits:
        return None
    return tuple((s, cap_lanes(s)) for s in best_splits)


def auto_regen_frames(width: int, height: int, n_samples: int, intended: int) -> int:
    """Default K: 100 frames per launch (64 above 64 wavelengths), bounded
    by ``REGEN_DIRECTION_BUDGET`` and the frames asked for."""
    cap = 100 if n_samples <= 64 else 64
    cap = min(cap, 1 + REGEN_DIRECTION_BUDGET // (12 * width * height))
    return max(1, min(intended, cap))


def _is_auto(regen_frames) -> bool:
    """``"auto"`` or ``("auto", cap)``."""
    return regen_frames == "auto" or (
        isinstance(regen_frames, tuple) and len(regen_frames) == 2
        and regen_frames[0] == "auto")


class Renderer:
    """Progressive spectral renderer for one scene snapshot on one device.

    ``device``: "cuda" launches the hand-written kernels (and raises when
    no GPU is present); "cpu" runs their plain PyTorch versions.
    ``regen_frames``: "auto" (see ``auto_regen_frames``), ``("auto",
    cap)`` (the same, at most ``cap``: the live view's 16-frame chunks,
    as the reference's ``renderer.py:620-626``) or K >= 1 frames per
    launch; progress and abort operate at chunk granularity.
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
    ``phase_split`` renders frame by frame as bounce segments with the
    live lanes compacted between them (``integrate_frame_cascade``): an
    int split (capacity ``phase_capacity``, default 1/16 of the image),
    a tuple of splits with a tuple of capacities (a cascade), or "auto"
    (stages chosen from a measured occupancy profile by
    ``choose_stages``; None when the mono kernel wins). A frame whose
    compacted wavefront overflows is rendered again by the mono kernel,
    counted in ``overflow_frames``; the overflow flag is read one frame
    late, so the host waits on no frame it has just queued.
    ``accel``: "auto" walks 64-object clusters above 64 objects, "none"
    every object. The regeneration lanes of a clustered scene take
    pixels in Morton order, row-major otherwise (``lane_layout``; pure
    relabeling, bit-identical per pixel).
    Triangle meshes render on every path, and so do the scene features
    (sky, checker, emission, the dielectric with dispersion;
    ``integrator.scene_features``) through the kernels' feature builds.
    Depth of field (a camera with ``aperture_radius > 0``) renders on
    regeneration, frame by frame and phased; ``persist=True`` refuses it
    with ``ValueError``, as the reference does. Any material count
    renders, on every path and device: the
    kernels keep the material rows in shared memory while the whole table
    fits a block's, else in global memory
    (``KernelTables.materials_shared``).
    ``sharding=row_sharding(mesh)`` (``parallel/mesh.py``; the mesh's
    slots on ``device``) renders row slabs, one per slot of the mesh,
    each with its own accumulator slab and the kernels on its global
    rows (``parallel/sharding.py``): regeneration (Morton lanes per slab
    for a clustered scene) and frame by frame with no collective,
    ``persist=True`` through ``render_persistent_sharded`` (one MIN per
    launch; ``persist_info["n_devices"]``). ``framebuffer()`` gathers
    the slabs from every process, and only the primary process writes
    images and checkpoints. It refuses ``phase_split``, ``regen_sort``
    and a scene schedule with ``ValueError``, an image height that does
    not divide over the mesh too, and a sharded persist render has no
    checkpoint.
    ``frames_per_dispatch=k`` renders k frames per dispatch on the frame
    by frame path (k ``cuda_mono`` launches with no host synchronisation
    between them); progress, abort and the finite check run between
    dispatches. It refuses ``sharding``, ``phase_split``, the grid,
    ``persist`` and ``regen_frames > 1``; "auto" becomes 1.
    ``accel="grid"`` traces through the uniform-grid DDA
    (``scene/accel.py``, ``ops/grid_trace.py``), the reference's opt-in
    eager tracer: on the CPU only (the kernels walk every object or cull
    by cluster, so ``device="cuda"`` raises ``ValueError``), frame by
    frame, and not with triangles, ``persist``, ``regen_frames > 1``,
    ``phase_split``, ``frames_per_dispatch > 1``, ``sharding`` or a scene
    schedule.
    ``_scene_schedule`` (motion blur, ``animation._motion_blur_schedule``)
    maps a frame id to that frame's host tables (``flatten_numpy``'s
    field dict, the same configuration as ``scene``): every frame is then
    one ``cuda_mono`` launch on its own tables, repacked with the first
    scene's cluster plan (``repack_tables``) and one feature build picked
    from the first scene's features and the schedule's
    ``has_transmission``/``has_emission``. It refuses ``persist``,
    ``phase_split``, ``sharding`` and an explicit ``regen_frames > 1``
    with ``ValueError``; "auto" becomes 1. ``_flattened``: the
    ``flatten_numpy`` pair the caller already made for ``scene``.
    """

    def __init__(self, scene: Scene, device: str = "cuda",
                 regen_frames: int | str | tuple = "auto", *, persist: bool = False,
                 persist_budget: int | None = None,
                 persist_frames_per_launch: int | None = None,
                 adaptive: tuple | None = None,
                 persist_keep_state: bool = False,
                 regen_sort: bool | str = "auto",
                 phase_split=None, phase_capacity=None,
                 accel: str = "auto", sharding=None, frames_per_dispatch: int = 1,
                 _scene_schedule: Callable[[int], dict] | None = None,
                 _flattened: tuple | None = None):
        self.request = next(_REQUESTS)  # this Renderer's serial in the trace
        with trace.span("renderer.init", self.request):
            if accel not in ("auto", "none", "grid"):
                raise ValueError(f"unknown accel {accel!r}")
            use_grid = accel == "grid"
            if _scene_schedule is not None:
                # the schedule changes the scene between frames, so every frame
                # is its own launch; the modes that carry one scene across
                # frames cannot take it (the reference's renderer.py:585-621)
                if (persist or phase_split is not None or sharding is not None
                        or frames_per_dispatch > 1 or use_grid):
                    raise ValueError(
                        "a per-frame scene schedule (motion blur) runs on the "
                        "frame-by-frame step only; drop persist/phase_split/"
                        "frames_per_dispatch/sharding/accel='grid'"
                    )
                if not _is_auto(regen_frames) and int(regen_frames) != 1:
                    raise ValueError(
                        "regen_frames fuses K frames of ONE scene per launch and "
                        "cannot compose with a per-frame scene schedule"
                    )
                regen_frames = 1
            if use_grid and (persist or phase_split is not None or sharding is not None):
                raise ValueError(
                    "accel='grid' is the eager frame-by-frame tracer of one device: "
                    "drop persist/phase_split/sharding"
                )
            device = torch.device(device)
            if sharding is not None and not isinstance(sharding, RowSharding):
                raise TypeError("sharding takes parallel.mesh.row_sharding(mesh), "
                                f"not {type(sharding).__name__}")
            if sharding is not None and sharding.mesh.device_type != device.type:
                raise ValueError(
                    f"the mesh's slots are on {sharding.mesh.device_type}, the renderer "
                    f"on {device.type}: make the mesh with device={device.type!r}"
                )
            if device.type == "cuda":
                if use_grid:
                    # the reference refuses the grid on its accelerator too
                    # (renderer.py:426-445): the kernels walk every object or
                    # cull by cluster, and the grid is an eager CPU tracer
                    raise ValueError(
                        "accel='grid' is CPU-only: the CUDA kernels walk every "
                        "object or cull by 64-object cluster; pass device='cpu' "
                        "for the grid or drop accel='grid'"
                    )
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
            with trace.span("scene.flatten"):
                if _flattened is not None:
                    self.scene_tensors, self.config = from_numpy(
                        *_flattened, device, smooth_triangles(scene))
                else:
                    self.scene_tensors, self.config = flatten_scene(scene, device)
            if self.config.has_dof and persist:
                # one lens point per frame: regeneration ships the per-frame
                # lens shifts, but the persist kernels restart every frame from
                # the one camera origin (the reference's renderer.py:630-641)
                raise ValueError(
                    "persist=True cannot render depth-of-field scenes (the "
                    "in-kernel frame restarts assume the pinhole camera); drop "
                    "persist or set aperture_radius=0"
                )
            self.grid = None
            if use_grid:
                if self.scene_tensors.has_triangles:
                    # the grid's cell tests treat every non-sphere as a slab
                    # box, but triangle rows keep their edges in the slab columns
                    raise ValueError(
                        "accel='grid' does not support mesh/triangle scenes; use "
                        "the default dense path (triangles cluster-cull on the kernels)"
                    )
                if self.config.n_objects > 0:
                    self.grid = build_grid(self.scene_tensors)
            with trace.span("scene.pack"):
                # raises outside the slices
                self.tables = pack_tables(self.scene_tensors, self.config,
                                          "none" if use_grid else accel)
                self._scene_schedule = _scene_schedule
                if _scene_schedule is not None:
                    # a track may raise transmission from 0 mid-shutter: the build
                    # is picked once, from the schedule's conservative flags too
                    self.tables = with_features(self.tables, (
                        (FX_TRANSMISSION if getattr(_scene_schedule, "has_transmission", False) else 0)
                        | (FX_EMISSION if getattr(_scene_schedule, "has_emission", False) else 0)))
            self.clusters = self.tables.clusters
            with trace.span("renderer.digest"):
                self.scene_digest = scene_digest(self.scene_tensors, self.config)
            cfg = self.config
            auto_cap = None
            if isinstance(regen_frames, tuple):
                if not _is_auto(regen_frames):
                    raise ValueError(f"regen_frames takes 'auto', ('auto', cap) or K >= 1, "
                                     f"not {regen_frames!r}")
                auto_cap = int(regen_frames[1])
                regen_frames = "auto"
            if frames_per_dispatch < 1:
                raise ValueError("frames_per_dispatch must be >= 1")
            if frames_per_dispatch > 1 and (phase_split is not None or sharding is not None
                                            or use_grid):
                raise ValueError(
                    "frames_per_dispatch > 1 supports the plain frame step only "
                    "(the phased pipeline needs per-frame overflow checks; the "
                    "sharded and grid steps are per-frame programs)"
                )
            self.frames_per_dispatch = int(frames_per_dispatch)
            if (persist or phase_split is not None or use_grid
                    or frames_per_dispatch > 1) and regen_frames == "auto":
                # persist, the phased path, the grid and fused dispatches
                # supersede the default chunking
                regen_frames = 1
            if regen_frames == "auto":
                regen_frames = auto_regen_frames(
                    cfg.width, cfg.height, cfg.n_samples, cfg.intended_frames
                )
                if auto_cap is not None:
                    regen_frames = max(1, min(regen_frames, auto_cap))
            if int(regen_frames) < 1:
                raise ValueError("regen_frames must be >= 1")
            self.regen_frames = int(regen_frames)
            if self.regen_frames > 1 and (phase_split is not None or use_grid
                                          or frames_per_dispatch > 1):
                raise ValueError(
                    "regen_frames composes with the plain or row-sharded frame "
                    "step only (not phase_split/grid/frames_per_dispatch)"
                )
            if regen_sort == "auto":
                # measured and rejected as a default by the reference (per-pixel
                # cost is mostly per-frame noise); an opt-in here too until an
                # H100 measurement says otherwise
                regen_sort = False
            if regen_sort and (self.regen_frames < 2 or sharding is not None):
                raise ValueError(
                    "regen_sort requires regen_frames >= 2 on the single-device path"
                )
            self.regen_sort = bool(regen_sort)
            # the reference's policy (renderer.py:719-742): Morton where the
            # cluster cull can use coherent lanes
            self.lane_layout = ("morton" if self.clusters is not None
                                and self.regen_frames > 1 and not self.regen_sort
                                else "rowmajor")
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
            if self.persist and (self.regen_frames > 1 or self.regen_sort
                                 or phase_split is not None or use_grid
                                 or frames_per_dispatch > 1):
                raise ValueError(
                    "persist is a standalone dispatch mode: drop phase_split/grid/"
                    "frames_per_dispatch/regen_frames/regen_sort"
                )
            self.persist_info: dict | None = None
            self._persist_resume: dict | None = None
            self.phase_split = phase_split
            self.phase_capacity = phase_capacity
            self.overflow_frames = 0
            self._pending: tuple | None = None
            self.phase_stages: tuple | None = None
            self.phase_occupancy = None  # the "auto" probe's profile
            if phase_split is not None:
                if sharding is not None:
                    raise ValueError(
                        "phase_split is per-device; combine it with sharding "
                        "once per-slab wavefronts exist"
                    )
                self.phase_stages = self._resolve_phase_stages(phase_split, phase_capacity)
            self.sharding = sharding
            self._slabs = None
            if sharding is not None:
                with trace.span("scene.pack"):
                    self._slabs = shard_scene(self.scene_tensors, sharding, self.config,
                                              self.tables)
                if self.lane_layout == "morton":
                    # the Z-curve over each slab's own rows, once per device
                    perms = {}
                    for sl in self._slabs:
                        dev = sl.scene.device
                        if dev not in perms:
                            perms[dev] = morton_layout(cfg.width, sl.config.height, dev)
                        sl.lane_perm, sl.lane_inv = perms[dev]
            self.reset()

    def reset(self) -> None:
        cfg = self.config
        self._pending = None  # frames before the reset are discarded
        with trace.span("renderer.reset", self.request):
            if self._slabs is not None:
                self.accum = None  # the slabs hold it
                for sl in self._slabs:
                    sl.accum = torch.zeros((sl.config.height, cfg.width, 4),
                                           dtype=torch.float32, device=sl.scene.device)
            else:
                self.accum = torch.zeros(
                    (cfg.height, cfg.width, 4), dtype=torch.float32, device=self.device
                )
        self.next_frame = 0

    def frame_tables(self, frame_id: int) -> tuple[SceneTensors, object]:
        """The scene tensors and kernel tables frame ``frame_id`` renders
        from: the schedule's snapshot of that frame, copied to the device
        and repacked on the first scene's plan, or the one scene's."""
        if self._scene_schedule is None:
            return self.scene_tensors, self.tables
        st, _ = from_numpy(self._scene_schedule(frame_id), self.config, self.device,
                           self.scene_tensors.smooth_tri)
        return st, repack_tables(self.tables, st)

    def _advance(self, frame_id: int) -> None:
        if self.phase_stages is not None:
            rgb, overflow = integrate_frame_cascade(
                self.scene_tensors, self.config, frame_id, self.phase_stages,
                self.tables,
            )
            self._resolve_pending()  # frame f-1 is done by now: no wait
            self._pending = (frame_id, rgb, overflow)
            return
        if self._slabs is not None:
            render_frame_step_sharded(self._slabs, self.config, frame_id)
            return
        if self.grid is not None:
            rgb = integrate_frame(self.scene_tensors, self.config, frame_id, grid=self.grid)
            self.accum = accumulate_frame(self.accum, rgb, frame_id)
            return
        st, tables = self.frame_tables(frame_id)
        self.accum = render_frame_step_cuda(st, self.config, self.accum, frame_id, tables)

    # ------------------------------------------------------------ phased

    def _resolve_phase_stages(self, phase_split, phase_capacity):
        """The phased request as static stages ``((split, capacity_lanes),
        ...)`` (the reference's ``_resolve_phase_stages``,
        ``renderer.py:811``); "auto" may give None (the mono kernel
        wins)."""
        n = self.config.width * self.config.height
        tile = BLOCK
        n_pad = -(-n // tile) * tile
        if phase_split == "auto":
            return self._autotune_stages(tile, n_pad)
        splits = ((int(phase_split),) if isinstance(phase_split, int)
                  else tuple(int(sp) for sp in phase_split))
        if phase_capacity is None:
            if len(splits) != 1:
                raise ValueError(
                    "multi-split phased rendering needs explicit "
                    "phase_capacity values (or phase_split='auto')"
                )
            caps = (default_phase_capacity(n),)
        elif isinstance(phase_capacity, int):
            caps = (phase_capacity,)
        else:
            caps = tuple(int(c) for c in phase_capacity)
        if len(caps) != len(splits):
            raise ValueError(
                f"{len(splits)} phase splits need {len(splits)} capacities, "
                f"got {len(caps)}"
            )
        check_splits(splits, self.config)
        return tuple(zip(splits, caps))

    def _autotune_stages(self, tile: int, n_pad: int, probe_lanes: int = 32768,
                         probe_frames: int = 3, margin: float = 1.7):
        """Stages from a measured occupancy profile (the reference's
        ``_autotune_stages``, ``renderer.py:847``): ``probe_frames``
        frames at about ``probe_lanes`` pixels (the aspect ratio kept)
        through the plain bounce loop on the renderer's device, which
        counts the lanes alive entering each bounce; occupancy is a
        per-lane statistic, so it carries over to the full resolution.
        This probe is a measurement, not a render: no frame of it is
        blended."""
        cfg = self.config
        if cfg.max_bounces < 2:
            return None
        scale = math.sqrt(probe_lanes / (cfg.width * cfg.height))
        pw = max(8, min(cfg.width, int(cfg.width * scale)))
        ph = max(8, min(cfg.height, int(cfg.height * scale)))
        probe_cfg = dataclasses.replace(cfg, width=pw, height=ph)
        occ = np.zeros((cfg.max_bounces,), np.float64)
        for f in range(probe_frames):
            *_, hist = integrate_frame(self.scene_tensors, probe_cfg, f,
                                       return_occupancy=True)
            occ = np.maximum(occ, hist.cpu().numpy().astype(np.float64) / (pw * ph))
        self.phase_occupancy = occ
        return choose_stages(occ, n_pad, tile, margin=margin)

    def _resolve_pending(self) -> None:
        """Blend the previous phased frame, rendering it again on the mono
        kernel if its compacted wavefront overflowed (the estimator is
        never truncated). Called right after the next frame is queued, so
        reading the overflow flag waits for nothing still queued."""
        if self._pending is None:
            return
        fid, rgb, overflow = self._pending
        self._pending = None
        if bool(overflow):
            self.overflow_frames += 1
            rgb = integrate_frame_cuda(self.scene_tensors, self.config, fid,
                                       self.tables)
        self.accum = accumulate_frame(self.accum, rgb, fid)

    def _ensure_lane_perm(self) -> None:
        """Probe per-pixel path cost over 2 frames and build the cost-sorted
        lane permutation, once, at the first regeneration chunk."""
        if self._lane_perm is None:
            cost = probe_path_cost(self.scene_tensors, self.config, self.tables,
                                   n_probe_frames=2)
            self._lane_perm, self._lane_inv = cost_sort_perm(cost)

    def _advance_regen(self, first_frame: int, k: int) -> None:
        if self._slabs is not None:
            render_frames_step_sharded_regen(self._slabs, self.config, first_frame, k)
            return
        lanes = {}
        if self.regen_sort:
            self._ensure_lane_perm()
            lanes = dict(lane_perm=self._lane_perm, lane_inv=self._lane_inv)
        elif self.lane_layout == "morton":
            if self._lane_perm is None:  # static Z-curve order, built once
                self._lane_perm, self._lane_inv = morton_layout(
                    self.config.width, self.config.height, self.device)
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
        ``persist``, after each launch): a regeneration launch, or
        ``frames_per_dispatch`` frames."""
        with trace.span("render.frames", self.request):
            if self.persist:
                return self._render_persistent(n_frames, progress, abort, check_finite)
            return self._render_chunks(n_frames, progress, abort, check_finite)

    def _render_chunks(self, n_frames, progress, abort, check_finite) -> np.ndarray:
        """Regeneration chunks of K frames, or frame by frame."""
        begin = time.monotonic()
        total = self.config.intended_frames
        rendered = 0
        chunk = max(self.frames_per_dispatch, self.regen_frames)
        while rendered < n_frames and self.next_frame < total:
            k = min(chunk, n_frames - rendered, total - self.next_frame)
            if k > 1 and k == self.regen_frames:
                self._advance_regen(self.next_frame, k)
            else:
                # ragged tail (k < K), K == 1 or a dispatch of k frames:
                # frame by frame on the mono kernel, as the reference does
                for j in range(k):
                    self._advance(self.next_frame + j)
            self.next_frame += k
            rendered += k
            if self.phase_stages is not None and self.next_frame >= total:
                self._resolve_pending()  # the last frame has no successor
            if check_finite and not self._finite():
                raise FloatingPointError(
                    f"non-finite accumulator after frame {self.next_frame - 1}"
                )
            if progress is not None:
                self._synchronize()
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

        kwargs = dict(budget=self.persist_budget, frames_per_launch=self.persist_fpl,
                      progress=on_launch, should_abort=abort, adaptive=self.adaptive,
                      preview=on_preview if progress is not None else None)
        if self._slabs is not None:
            if resume is not None:
                raise ValueError(
                    "persist checkpoints are single-device for now (the sharded "
                    "carried state is mesh-layout-dependent)"
                )
            rgb, info = render_persistent_sharded(
                self._slabs, self.config, self.sharding.mesh, total, **kwargs)
        else:
            rgb, info = render_persistent(
                self.scene_tensors, self.config, total, self.tables,
                resume_state=resume, return_state=True, **kwargs)
            if not (info["aborted"] or self.persist_keep_state):
                info.pop("resume_state", None)  # nothing left to resume: free the planes
        self.persist_info = info
        with trace.span("persist.finish"):
            self._set_rgb(rgb)
        self.next_frame = total if not info["aborted"] else info["frames_done"]
        if check_finite and not self._finite():
            raise FloatingPointError("non-finite framebuffer after persist render")
        return self.framebuffer()

    def _set_rgb(self, rgb) -> None:
        """The accumulator from linear RGB ``[H, W, 3]`` (a sharded render:
        one ``[h, W, 3]`` per slab), alpha 1."""
        def with_alpha(c):
            alpha = torch.ones(c.shape[:2] + (1,), dtype=torch.float32, device=c.device)
            return torch.cat([c, alpha], dim=-1)

        if self._slabs is not None:
            for sl, c in zip(self._slabs, rgb):
                sl.accum = with_alpha(c)
        else:
            self.accum = with_alpha(rgb)

    def _finite(self) -> bool:
        """Whether the accumulator is finite; a sharded render asks every
        process's slabs, so all of them raise together."""
        if self._slabs is None:
            return bool(torch.isfinite(self.accum).all())
        ok = all(bool(torch.isfinite(sl.accum).all()) for sl in self._slabs)
        return distributed.all_min([1.0 if ok else 0.0])[0] == 1.0

    def _synchronize(self) -> None:
        """Wait for the queued work of every device this renderer uses."""
        if self.device.type != "cuda":
            return
        devices = {sl.scene.device for sl in self._slabs} if self._slabs else {self.device}
        for dev in devices:
            torch.cuda.synchronize(dev)

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
        """The ``[H, W, 4]`` float32 accumulation buffer on the host (a
        phased frame still pending is blended first). A sharded render
        gathers every process's slabs: a collective that every process
        must join."""
        with trace.span("render.readback", self.request):
            self._resolve_pending()
            if self._slabs is not None:
                return gather(self._slabs)
            return self.accum.cpu().numpy()

    def save_image(self, path, exposure=None, gamma=None) -> None:
        """Save the framebuffer (format by extension; linear, no gamma
        unless asked), through the port's image writer. Multi-process safe:
        every process joins the gather, the primary one writes."""
        fb = self.framebuffer()
        if distributed.is_primary():
            image_mod.save_image(fb, path, exposure=exposure, gamma=gamma)

    # ------------------------------------------------------------ checkpoint

    def save_checkpoint(self, path) -> None:
        """Save the accumulator and frame counter, or, for a persist render,
        its full carried lane state (the accumulator alone cannot continue
        a lane-asynchronous render). The npz keys are the reference's
        (``renderer.py:1227``), so the file says which kind it is. A
        sharded accumulator is gathered (every process joins) and written
        by the primary process; a sharded persist render has no
        checkpoint."""
        if self.persist:
            info = self.persist_info
            if not info or "resume_state" not in info:
                raise ValueError(
                    "no persist state to checkpoint: sharded persist renders "
                    "carry no host-side resume state" if self._slabs is not None else
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
            fb = self.framebuffer()  # a collective when sharded
            if not distributed.is_primary():
                return
            payload = dict(
                accum=fb, next_frame=self.next_frame,
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
        self._pending = None
        accum = torch.as_tensor(data["accum"], dtype=torch.float32)
        if self._slabs is not None:
            for sl in self._slabs:  # each slot takes its own rows again
                rows = accum[sl.row_offset:sl.row_offset + sl.config.height]
                sl.accum = rows.to(sl.scene.device).contiguous()
        else:
            self.accum = accum.to(self.device)
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
