"""Frame integration through the CUDA bounce kernels (the twin of the
reference package's ``spectral_tpu.render.pallas_integrator``).

Primary rays come from the port's own raygen (``generate_primary_rays``)
for every frame, except in a regeneration launch, whose kernel generates
each frame's primaries itself from the camera table and the frames'
Hammersley offsets, in the host raygen's op order and bits (re-deriving
them in another order would flip the un-offset diffuse self-hit coin).
On CPU tensors the kernel wrappers run their plain versions.

``render_persistent`` is the persistent lane-asynchronous render
(``run_persist``): every lane walks its own frame stream with its state
carried between launches, restarting from a host-refilled ring of
primary directions or, free-running, from in-kernel raygen; with
``adaptive`` each pixel stops once its mean has converged.
``probe_path_cost`` (``run_cost``) measures per-pixel path length for
the persist budget and for cost-sorted lane assignment.

``integrate_frame_split`` and ``integrate_frame_cascade`` run one frame
as bounce segments (``run_seg``) with the live lanes compacted between
them: the phased path for many-object scenes, where few lanes survive
the first bounces. The reference's single-stage
``integrate_frame_pallas_phased`` is the cascade with one stage at
``default_phase_capacity``.
"""

from __future__ import annotations

import numpy as np
import torch

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.rng import MASK32
from spectral_tpu_torch.render.camera import (
    camera_basis_table,
    generate_primary_rays,
    hammersley_table,
    lens_table,
    pixel_coords,
    scene_dof,
)
from spectral_tpu_torch.render.color import spectra_to_rgb
from spectral_tpu_torch.render.integrator import (
    PersistState,
    Wavefront,
    accumulate_frame,
    accumulate_frames,
    lane_int_dtype,
)
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors


def primary_lanes(scene: SceneTensors, config: RenderConfig, frame_id: int,
                  full_height: int | None = None, row_offset: int = 0):
    """Lane planes for the kernels: ``(ox, oy, oz, dx, dy, dz)`` f32 and
    ``(px, py)`` int32, all contiguous ``[W*H]``. ``full_height``/
    ``row_offset``: ``config`` is the row slab of a ``full_height`` image
    from row ``row_offset`` (``generate_primary_rays``)."""
    origin, direction, px, py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame_id, config.intended_frames,
        dof=scene_dof(scene, config), full_height=full_height, row_offset=row_offset,
    )
    planes = tuple(c.contiguous() for c in (*origin, *direction))
    return planes, px.to(torch.int32), py.to(torch.int32)


def _to_rgb(rad: torch.Tensor, scene: SceneTensors, config: RenderConfig,
            lane_inv: torch.Tensor | None = None):
    with trace.span("render.fold"):
        rgb = spectra_to_rgb(rad.T, scene.xyz_weights, scene.xyz_to_rgb)
        if lane_inv is not None:
            # back to pixel order AFTER the RGB fold: one [n, 3] gather
            rgb = rgb[lane_inv]
        return rgb.reshape(config.height, config.width, 3)


def empty_frame(scene: SceneTensors, config: RenderConfig, frames: int = 1) -> torch.Tensor:
    """The linear RGB ``[H, W, 3]`` of a scene without objects (the sum of
    ``frames`` frames): every ray escapes, so each pixel is the sky colour,
    black without a sky (the reference's ``integrate_frame``). No kernel
    runs: the kernels need an object."""
    if scene.sky is None:
        return torch.zeros((config.height, config.width, 3), device=scene.device)
    n = config.width * config.height
    rad = scene.sky[None, :].expand(n, -1)
    rgb = spectra_to_rgb(rad, scene.xyz_weights, scene.xyz_to_rgb)
    return (rgb * float(frames)).reshape(config.height, config.width, 3)


def _tables(scene: SceneTensors, config: RenderConfig,
            tables: mk.KernelTables | None, shadow_interval: bool) -> mk.KernelTables:
    """The given tables (packed when None), ``with_shadow_interval`` when
    asked: raises for a scene without the many-object loop."""
    tables = tables or mk.pack_tables(scene, config)
    return mk.with_shadow_interval(tables) if shadow_interval else tables


def integrate_frame_cuda(
    scene: SceneTensors, config: RenderConfig, frame_id: int,
    tables: mk.KernelTables | None = None, shadow_interval: bool = False,
    full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """One progressive frame -> linear RGB ``[H, W, 3]`` via ``run_mono``.
    ``shadow_interval=True`` takes the opt-in sqrt-free sphere shadow test
    (``megakernel.with_shadow_interval``: many-object scenes only).
    ``full_height``/``row_offset`` render the row slab ``config`` of a
    taller image (``primary_lanes``)."""
    with trace.span("launch.mono"):  # host raygen and the launch's arguments
        tables = _tables(scene, config, tables, shadow_interval)
        if config.n_objects == 0:
            return empty_frame(scene, config)
        planes, px, py = primary_lanes(scene, config, frame_id, full_height, row_offset)
        rad = mk.run_mono(*planes, px, py, frame_id, tables)
    return _to_rgb(rad, scene, config)


def regen_args(scene: SceneTensors, config: RenderConfig, first_frame_id: int,
               k: int, lane_perm: torch.Tensor | None = None,
               full_height: int | None = None, row_offset: int = 0) -> tuple:
    """``run_regen``'s lane arguments for K frames from ``first_frame_id``:
    ``(px, py, first_frame_id, camera table, Hammersley table, lens
    table)``, lane ``p`` on pixel ``lane_perm[p]`` (row-major without
    one); the lens table (``camera.lens_table``) is None for a pinhole
    camera. ``full_height``/``row_offset``: ``config`` is a row slab, its
    lanes carry global rows and the camera table the whole image's
    height; ``lane_perm`` indexes the slab's pixels."""
    px, py = pixel_coords(config.width, config.height, scene.device, row_offset)
    if lane_perm is not None:
        px, py = px[lane_perm], py[lane_perm]
    offsets = hammersley_table(first_frame_id, k, config.intended_frames, scene.device)
    return (px.to(torch.int32), py.to(torch.int32), first_frame_id,
            camera_basis_table(scene, config, full_height), offsets,
            lens_table(scene, config, first_frame_id, k))


def regen_radiance(
    scene: SceneTensors, config: RenderConfig, first_frame_id: int, k: int,
    tables: mk.KernelTables, lane_perm: torch.Tensor | None = None,
    full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """The SUM of K frames' radiance ``[S, n]`` in one ``run_regen``
    launch, in lane order: lane ``p`` traces pixel ``lane_perm[p]``. The
    kernel generates every frame's primaries itself, elementwise in the
    lane's pixel, so each lane's paths are bit-identical to the
    unpermuted launch's and to host raygen's, and a row slab's
    (``full_height``/``row_offset``) to the whole image's."""
    with trace.span("launch.regen"):
        return mk.run_regen(*regen_args(scene, config, first_frame_id, k, lane_perm,
                                        full_height, row_offset), tables)


def integrate_frames_cuda_regen(
    scene: SceneTensors, config: RenderConfig, first_frame_id: int, k: int,
    tables: mk.KernelTables | None = None,
    lane_perm: torch.Tensor | None = None,
    lane_inv: torch.Tensor | None = None,
    shadow_interval: bool = False,
    full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """K progressive frames in one ``run_regen`` launch -> the SUM of their
    linear-RGB frames ``[H, W, 3]``. Every path is the one its frame's
    mono launch traces; only the order the K frames are summed in differs.
    ``lane_perm``/``lane_inv`` (``lane_inv = argsort(lane_perm)``) assign
    pixels to lanes (cost-sorted lane assignment): pure relabeling, and
    the RGB sum is put back in pixel order after the fold. Blend with
    ``integrator.accumulate_frames``. ``shadow_interval`` as in
    ``integrate_frame_cuda``; ``full_height``/``row_offset`` render the
    row slab ``config`` of a taller image."""
    if k < 2:
        raise ValueError("regen wants k >= 2 (use integrate_frame_cuda)")
    if (lane_perm is None) != (lane_inv is None):
        raise ValueError("lane_perm and lane_inv must be passed together")
    tables = _tables(scene, config, tables, shadow_interval)
    if config.n_objects == 0:
        return empty_frame(scene, config, k)
    rad = regen_radiance(scene, config, first_frame_id, k, tables, lane_perm,
                         full_height, row_offset)
    return _to_rgb(rad, scene, config, lane_inv)


def render_frame_step_cuda(
    scene: SceneTensors, config: RenderConfig, accum: torch.Tensor,
    frame_id: int, tables: mk.KernelTables | None = None,
    full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """One progressive frame (one ``run_mono`` launch) blended into the
    accumulator (a row slab's with ``full_height``/``row_offset``)."""
    rgb = integrate_frame_cuda(scene, config, frame_id, tables,
                               full_height=full_height, row_offset=row_offset)
    with trace.span("render.fold"):
        return accumulate_frame(accum, rgb, frame_id)


def render_frames_step_cuda_regen(
    scene: SceneTensors, config: RenderConfig, accum: torch.Tensor,
    first_frame_id: int, k: int, tables: mk.KernelTables | None = None,
    lane_perm: torch.Tensor | None = None,
    lane_inv: torch.Tensor | None = None,
    shadow_interval: bool = False,
    full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """K progressive frames (one ``run_regen`` launch) blended into the
    accumulator (a row slab's with ``full_height``/``row_offset``)."""
    rgb_sum = integrate_frames_cuda_regen(
        scene, config, first_frame_id, k, tables, lane_perm, lane_inv, shadow_interval,
        full_height, row_offset)
    with trace.span("render.fold"):
        return accumulate_frames(accum, rgb_sum, first_frame_id, k)


# ----------------------------------------------------- bounce segments


def frame_wavefront(scene: SceneTensors, config: RenderConfig,
                    frame_id: int) -> Wavefront:
    """Frame ``frame_id``'s primary lanes as a segment-0 wavefront: every
    lane alive, gate open, no hero, unit throughput, zero radiance."""
    planes, px, py = primary_lanes(scene, config, frame_id)
    n = px.shape[0]
    dev = px.device
    f32 = torch.float32
    s = config.n_samples
    return Wavefront(
        *planes, px=px, py=py,
        alive=torch.ones((n,), dtype=f32, device=dev),
        gate=torch.zeros((n,), dtype=f32, device=dev),
        hero=torch.full((n,), -1.0, dtype=f32, device=dev),
        thr=torch.ones((s, n), dtype=f32, device=dev),
        rad=torch.zeros((s, n), dtype=f32, device=dev),
    )


def _gather(wf: Wavefront, idx: torch.Tensor) -> Wavefront:
    """The wavefront of lanes ``idx`` (every plane gathered, contiguous)."""
    return Wavefront(**{k: v[..., idx].contiguous() for k, v in wf.planes().items()})


def check_splits(splits: tuple, config: RenderConfig) -> None:
    """Raise unless the stage splits increase strictly inside
    ``(0, max_bounces)``."""
    if not splits:
        raise ValueError("stages must be non-empty")
    if list(splits) != sorted(set(splits)):
        raise ValueError(f"stage splits must be strictly increasing: {splits}")
    if not (0 < splits[0] and splits[-1] < config.max_bounces):
        raise ValueError(
            f"stage splits {splits} must lie inside (0, {config.max_bounces})"
        )


def integrate_frame_split(
    scene: SceneTensors, config: RenderConfig, frame_id: int, split: int,
    tables: mk.KernelTables | None = None,
) -> torch.Tensor:
    """One frame as two segments with the live lanes permuted to the front
    between them (the reference's ``integrate_frame_pallas_split``,
    ``pallas_integrator.py:1449``): bounces ``[0, split)`` on the full
    wavefront, then a stable argsort puts the live lanes first and
    ``[split, max_bounces)`` runs on the permuted wavefront, whose dead
    lanes exit at once. Segment 2 carries segment 1's radiance, and every
    lane's arithmetic is its own, so the image is the mono frame's bit
    for bit. Returns linear RGB ``[H, W, 3]``."""
    check_splits((int(split),), config)
    if config.n_objects == 0:
        return empty_frame(scene, config)
    tables = tables or mk.pack_tables(scene, config)
    wf = frame_wavefront(scene, config, frame_id)
    mk.run_seg(wf, 0, split, frame_id, tables)
    perm = torch.argsort(-wf.alive, stable=True)
    wf = _gather(wf, perm)
    mk.run_seg(wf, split, config.max_bounces, frame_id, tables)
    # back to pixel order BEFORE the RGB fold, so that the fold sees the
    # mono frame's radiance in the mono frame's layout
    return _to_rgb(wf.rad[:, torch.argsort(perm)], scene, config)


def stage_capacities(stages: tuple, n: int) -> list[int]:
    """Each stage's compacted-wavefront capacity, rounded up to whole
    blocks of ``mk.BLOCK`` lanes and at most the block-padded image."""
    n_pad = -(-n // mk.BLOCK) * mk.BLOCK
    return [-(-min(int(c), n_pad) // mk.BLOCK) * mk.BLOCK for _, c in stages]


def compact_live(wf: Wavefront, ncap: int):
    """The live lanes of ``wf`` in a fresh ``ncap``-lane wavefront, with
    zero radiance: ``(wavefront, idx, count)``. ``idx[i]`` is the lane of
    ``wf`` that lane ``i`` carries on; ``count`` (a device scalar) the
    live lanes, of which the first ``ncap`` are kept. The live lanes are
    taken in ascending order (a cumsum of the alive mask and one scatter
    into a capacity-sized index buffer: no host synchronisation); fill
    entries point at lane 0 and stay dead."""
    dev = wf.ox.device
    cap = wf.ox.shape[0]
    live = wf.alive > 0.0
    count = live.sum()
    pos = torch.cumsum(live, 0) - 1
    dest = torch.where(live & (pos < ncap), pos, ncap)  # slot ncap: discarded
    idx = torch.zeros((ncap + 1,), dtype=torch.int64, device=dev)
    idx.scatter_(0, dest, torch.arange(cap, device=dev))
    idx = idx[:ncap]
    out = _gather(wf, idx)
    out.alive = (torch.arange(ncap, device=dev) < count).to(torch.float32)
    out.rad = torch.zeros_like(out.rad)
    return out, idx, count


def integrate_frame_cascade(
    scene: SceneTensors, config: RenderConfig, frame_id: int, stages: tuple,
    tables: mk.KernelTables | None = None, return_chains: bool = False,
):
    """N-stage occupancy-compacted frame (the reference's
    ``integrate_frame_pallas_cascade``, ``pallas_integrator.py:1615``).

    ``stages`` is ``((split, capacity_lanes), ...)`` with strictly
    increasing splits: bounces ``[0, s0)`` run on the full wavefront,
    ``[s0, s1)`` on a ``cap0``-lane wavefront of the lanes still alive,
    and so on. Each extraction (``compact_live``) takes the live lanes in
    ascending order; fill entries point at lane 0 and stay dead: no host
    synchronisation, the live count and the overflow flag stay on the
    device. Only the throughput and the ray state move; every segment
    starts from zero radiance, which is added back to the full-image
    lanes through the chain of extraction indices. The sum therefore
    runs in another order than one accumulator: within float32 rounding
    of the mono frame, with the same paths.

    Returns ``(rgb [H, W, 3], overflow)``: ``overflow`` (a device bool)
    is true when any stage's live count exceeded its capacity; the
    caller must then render the frame again with ``run_mono`` (the
    estimator is never truncated). ``return_chains=True`` appends the
    list of each compacted stage's full-image lane indices and live
    counts."""
    splits = tuple(int(sp) for sp, _ in stages)
    check_splits(splits, config)
    dev = scene.device
    if config.n_objects == 0:
        out = (empty_frame(scene, config), torch.zeros((), dtype=torch.bool, device=dev))
        return out + ([],) if return_chains else out
    tables = tables or mk.pack_tables(scene, config)
    n = config.width * config.height
    caps = stage_capacities(stages, n)
    bounds = (0,) + splits + (config.max_bounces,)
    wf = frame_wavefront(scene, config, frame_id)
    rad_t = None  # [n, S] lane-major radiance of the full image
    chain = None  # current wavefront lane -> full-image lane
    chains = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(len(bounds) - 1):
        mk.run_seg(wf, bounds[i], bounds[i + 1], frame_id, tables)
        if chain is None:
            rad_t = wf.rad.T
        else:
            rad_t.index_add_(0, chain, wf.rad.T)
        if i == len(bounds) - 2:
            break
        wf, idx, count = compact_live(wf, caps[i])
        overflow = overflow | (count > caps[i])
        chain = idx if chain is None else chain[idx]
        chains.append((chain, count))
    rgb = spectra_to_rgb(rad_t, scene.xyz_weights, scene.xyz_to_rgb)
    out = (rgb.reshape(config.height, config.width, 3), overflow)
    return out + (chains,) if return_chains else out


def default_phase_capacity(n: int) -> int:
    """The single-split default capacity: 1/16 of the block-padded
    wavefront, at least one block (the reference's ``n_pad // 16``)."""
    n_pad = -(-n // mk.BLOCK) * mk.BLOCK
    return max(mk.BLOCK, n_pad // 16)


# ------------------------------------------------------------ path cost


def probe_path_cost(
    scene: SceneTensors, config: RenderConfig,
    tables: mk.KernelTables | None = None, n_probe_frames: int = 2,
    first_frame_id: int = 0, full_height: int | None = None, row_offset: int = 0,
) -> torch.Tensor:
    """Per-pixel realized path length summed over ``n_probe_frames``
    frames, flat ``[W*H]`` float32: one ``run_cost`` launch per frame,
    each lane reporting how many bounce iterations it ran while alive
    (the reference's ``probe_path_cost``, ``pallas_integrator.py:372``);
    of the row slab ``config`` with ``full_height``/``row_offset``."""
    n = config.width * config.height
    if config.n_objects == 0:
        return torch.full((n,), float(n_probe_frames), device=scene.device)
    tables = tables or mk.pack_tables(scene, config)
    total = torch.zeros((n,), dtype=torch.float32, device=scene.device)
    for j in range(n_probe_frames):
        planes, px, py = primary_lanes(scene, config, first_frame_id + j,
                                       full_height, row_offset)
        _rad, cost = mk.run_cost(*planes, px, py, first_frame_id + j, tables)
        total = total + cost
    return total


def cost_sort_perm(cost: torch.Tensor):
    """Descending-cost STABLE pixel order and its inverse (int64, on the
    cost's device): equal-cost pixels keep image order, which makes the
    relabeling deterministic (``pallas_integrator.py:216``)."""
    order = np.argsort(-cost.cpu().numpy(), kind="stable")
    inv = np.argsort(order)
    dev = cost.device
    return torch.from_numpy(order).to(dev), torch.from_numpy(inv).to(dev)


# ------------------------------------------------------ persistent render


def persist_init(scene: SceneTensors, config: RenderConfig,
                 lane_perm: torch.Tensor | None = None,
                 full_height: int | None = None, row_offset: int = 0) -> PersistState:
    """Every lane starts frame 0 of its pixel (``pallas_integrator.py:700``):
    the frame-0 primaries, alive, gate open, no hero, the full bounce
    budget, unit throughput and zero radiance. ``full_height``/
    ``row_offset``: the lanes of the row slab ``config``, with global
    rows, as a sharded persist render carries them."""
    planes, px, py = primary_lanes(scene, config, 0, full_height, row_offset)
    if lane_perm is not None:
        planes = tuple(p[lane_perm] for p in planes)
        px, py = px[lane_perm], py[lane_perm]
    n = px.shape[0]
    dev = px.device
    s = config.n_samples
    f32 = torch.float32
    idt = lane_int_dtype(dev)
    return PersistState(
        *planes,
        alive=torch.ones((n,), dtype=f32, device=dev),
        gate=torch.zeros((n,), dtype=f32, device=dev),
        hero=torch.full((n,), -1.0, dtype=f32, device=dev),
        bl=torch.full((n,), config.max_bounces, dtype=idt, device=dev),
        fid=torch.zeros((n,), dtype=idt, device=dev),
        px=px, py=py,
        thr=torch.ones((s, n), dtype=f32, device=dev),
        rad=torch.zeros((s, n), dtype=f32, device=dev),
    )


def completed_frames(st: PersistState) -> torch.Tensor:
    """Per-lane count of COMPLETED frames, int64: a dead lane has shaded
    its path's terminal hit, so its frame ``fid`` counts."""
    return (st.fid.long() & MASK32) + (st.alive <= 0.0).long()


def persist_finish(st: PersistState, scene: SceneTensors, config: RenderConfig,
                   lane_inv: torch.Tensor | None = None) -> torch.Tensor:
    """The per-pixel average of the carried radiance over each pixel's
    completed frames, linear RGB ``[H, W, 3]`` (``pallas_integrator.py:741``)."""
    rgb = spectra_to_rgb(st.rad.T, scene.xyz_weights, scene.xyz_to_rgb)
    counts = torch.clamp_min(completed_frames(st).to(torch.float32), 1.0)
    rgb = rgb / counts[:, None]
    if lane_inv is not None:
        rgb = rgb[lane_inv]
    return rgb.reshape(config.height, config.width, 3)


def ring_refill(ring, frame: int, scene: SceneTensors, config: RenderConfig):
    """Write frame ``frame``'s host-raygen directions into ring slot
    ``frame % W`` (``pallas_integrator.py:770``)."""
    d = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame, config.intended_frames,
    )[1]
    slot = frame % ring[0].shape[0]
    for plane, comp in zip(ring, d):
        plane[slot].copy_(comp)


def _frames_done(st: PersistState, stop, end: int) -> torch.Tensor:
    """Per-lane completed frames, a stopped dead lane counted as ``end``."""
    done = completed_frames(st)
    if stop is not None:
        done = torch.where((stop > 0.0) & (st.alive <= 0.0), int(end), done)
    return done


def min_frames_done(st: PersistState, stop, end: int) -> torch.Tensor:
    """The scheduler scalar: the minimum completed-frame count over the
    lanes. A stopped lane that is dead owes no more frames and counts as
    ``end``; a stopped lane mid-path keeps its true count, so the render
    runs on until its in-flight frame completes."""
    return _frames_done(st, stop, end).min()


def lanes_working(st: PersistState, stop, end: int) -> torch.Tensor:
    """The lanes that still owe frames, counted as ``min_frames_done``
    counts them (fewer than ``end`` completed; a stopped dead lane owes
    none): an int32 device scalar."""
    return (_frames_done(st, stop, end) < int(end)).sum(dtype=torch.int32)


class _Readback:
    """A device scalar on its way to the host. The copy is queued behind
    the launch that produced it and read later, so reading it waits only
    for that launch, not for the ones queued since (the reference's
    one-launch-stale readback)."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def value(self) -> int:
        with trace.span("persist.wait"):
            if self.event is not None:
                self.event.synchronize()
            return int(self.host)


def adapt_update(rad, fid, alive, stop, prev_lum, prev_cnt, s_mean, s_m2, s_j,
                 end: int, min_frames: int, rtol: float, atol: float):
    """Between-launch convergence update of variance-adaptive sampling
    (the reference's ``_adapt_update_fn``, ``pallas_integrator.py:844``).

    Each launch's per-frame luminance mean is ONE weighted sample (weight:
    the frames the lane completed in that launch) of West's (1979)
    weighted incremental mean and M2, so ``M2 / (j - 1)`` estimates the
    per-frame variance from ``j`` launch aggregates. A lane stops once
    the standard error of its mean is under ``rtol * |mean| + atol``
    (compared squared and strict, so zero tolerances stop no lane), with
    at least ``min_frames`` completed frames and two samples. Snapshots
    move only where a sample was taken. All planes are ``[n]`` f32 except
    ``rad`` (``[S, n]``) and ``fid`` (bit patterns). Returns ``(stop,
    prev_lum, prev_cnt, mean, m2, j, n_work)``; ``n_work`` counts the
    lanes still owing frames, as a device scalar."""
    f32 = torch.float32
    dev = rad.device
    rtol_t = torch.tensor(rtol, dtype=f32, device=dev)
    atol_t = torch.tensor(atol, dtype=f32, device=dev)
    lum = rad.sum(dim=0)
    cnt = ((fid.long() & MASK32) + (alive <= 0.0).long()).to(f32)
    dc = cnt - prev_cnt
    upd = (dc > 0.0) & (stop <= 0.0)
    x = (lum - prev_lum) / torch.clamp_min(dc, 1.0)
    delta = x - s_mean
    mean_new = torch.where(upd, s_mean + (dc / torch.clamp_min(cnt, 1.0)) * delta, s_mean)
    m2_new = torch.where(upd, s_m2 + dc * delta * (x - mean_new), s_m2)
    j_new = torch.where(upd, s_j + 1.0, s_j)
    mean_frame = lum / torch.clamp_min(cnt, 1.0)
    thresh = rtol_t * torch.abs(mean_frame) + atol_t
    sigma2 = m2_new / torch.clamp_min(j_new - 1.0, 1.0)
    conv = (j_new >= 2.0) & (cnt >= float(min_frames)) & (sigma2 < thresh * thresh * cnt)
    stop_new = torch.where(upd & conv, 1.0, stop)
    lum_out = torch.where(upd, lum, prev_lum)
    cnt_out = torch.where(upd, cnt, prev_cnt)
    end_f = torch.tensor(float(int(end) & MASK32), dtype=f32, device=dev)
    workable = (alive > 0.0) | ((stop_new <= 0.0) & (cnt < end_f))
    n_work = workable.sum()
    return stop_new, lum_out, cnt_out, mean_new, m2_new, j_new, n_work


def workable_mask(alive: np.ndarray, fid: np.ndarray, stop: np.ndarray,
                  n_frames: int) -> np.ndarray:
    """Host twin of the update's ``workable`` predicate: a lane still owes
    frames if it is alive, or unstopped with frames left
    (``pallas_integrator.py:809``)."""
    done = (fid.astype(np.int64) & MASK32) + (alive <= 0.0)
    return (alive > 0.0) | ((stop <= 0.0) & (done < n_frames))


def slot_inverse(pixel_of_slot: np.ndarray, n: int) -> np.ndarray:
    """The pixel -> lane inverse of a slot map (``pallas_integrator.py:203``)."""
    inv = np.zeros(n, np.int64)
    inv[pixel_of_slot] = np.arange(len(pixel_of_slot))
    return inv


def _relabel(st: PersistState, order: torch.Tensor) -> None:
    """Gather every carried plane of ``st`` by the lane permutation
    ``order`` (the compaction relabel, ``pallas_integrator.py:820``).
    Raygen, host and in-kernel, is elementwise in the carried ``px``/``py``,
    so relabeling changes which thread computes a pixel and nothing else."""
    for name, t in st.planes().items():
        setattr(st, name, t[..., order].contiguous())


def _load_state(rs: dict, config: RenderConfig, device) -> PersistState:
    """A ``resume_state`` (tensors or numpy arrays) as a fresh state on
    ``device``, with the device's plane dtypes."""
    idt = lane_int_dtype(device)
    planes = dict(zip(PersistState.CARRIED, rs["state"]))
    planes.update(px=rs["px"], py=rs["py"])
    out = {}
    for name, a in planes.items():
        t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
        if name in ("bl", "fid"):
            t = (t.long() & MASK32).to(idt)
        elif name in ("px", "py"):
            t = t.to(torch.int32)
        else:
            t = t.to(torch.float32)
        out[name] = t.to(device).contiguous().clone()
    return PersistState(**out)


def render_persistent(
    scene: SceneTensors,
    config: RenderConfig,
    n_frames: int,
    tables: mk.KernelTables | None = None,
    ring_slots: int | None = None,
    budget: int | None = None,
    frames_per_launch: int | None = None,
    progress=None,
    should_abort=None,
    cost_sort: int = 0,
    adaptive: tuple | None = None,
    compact: bool = True,
    preview=None,
    resume_state: dict | None = None,
    return_state: bool = False,
):
    """Render ``n_frames`` progressive frames with persistent
    lane-asynchronous regeneration; returns ``(rgb [H, W, 3], info)``
    (the reference's ``render_persistent``, ``pallas_integrator.py:907``,
    whose docstring has the full design).

    Every launch (``run_persist``) runs exactly ``budget`` bounce
    iterations, and each lane advances through its own frame stream with
    its state carried between launches, so a fast lane runs ahead.
    ``ring_slots=0`` (default) is free-running: restarts recompute raygen
    in the kernel (ulps from host raygen, so held to the regen path only
    statistically; launch-split invariant). ``ring_slots=W`` (a power of
    two >= 2) restarts from a W-frame host-refilled ring of primary
    directions: every path is bit-identical to its regen rendering, and
    lanes stall at the window edge (``lead <= min_done + W``).

    ``budget=None`` takes ``max(8, round(fpl * mean_cost))`` from a
    one-frame cost probe, ``fpl`` = ``frames_per_launch`` or 64
    free-running, ``max(4, W // 4)`` ring. ``progress(min_done,
    launches)`` and ``should_abort()`` run once per launch; on abort,
    drain launches with ``end=0`` finish the paths in flight, and the
    image is each pixel's average over its completed frames.
    ``preview(make_rgb)`` gets, once per launch, a closure that is valid
    only inside the call. ``cost_sort=N`` probes N frames and assigns
    pixels to lanes by descending cost (pure relabeling).

    ``adaptive=(min_frames, rtol, atol)`` stops each pixel once its mean
    has converged (``adapt_update``, free-running only): ``n_frames`` is
    then the per-pixel cap, and with ``compact`` the lanes still working
    are packed to the front when a quarter of the last packing has
    retired. ``info`` gains ``min_counts``, ``max_counts``,
    ``mean_counts``, ``counts`` (per pixel, row-major) and
    ``compactions``.

    ``return_state=True`` puts the carried state into
    ``info["resume_state"]``; passing it back as ``resume_state``
    continues the render exactly (free-running, identity layout only).
    """
    if config.has_dof:
        raise ValueError(
            "persist cannot render depth of field: the persist kernels "
            "restart frames from the frame-constant camera, but depth of "
            "field shifts the origin per frame; render DoF scenes without "
            "persist=True"
        )
    if n_frames < 1:
        raise ValueError("n_frames must be >= 1")
    n = config.width * config.height
    dev = scene.device
    if config.n_objects == 0:
        info = {"launches": 0, "frames_done": n_frames, "budget": 0,
                "ring_slots": 0, "tile": 0, "aborted": False}
        if adaptive is not None:
            info.update(
                min_counts=n_frames, max_counts=n_frames,
                mean_counts=float(n_frames), compactions=0,
                counts=np.full(n, n_frames, np.int64), adaptive=tuple(adaptive),
            )
        return empty_frame(scene, config), info
    ring_slots = ring_slots or 0
    if ring_slots and (ring_slots < 2 or ring_slots & (ring_slots - 1)):
        raise ValueError(f"ring_slots must be 0 or a power of two >= 2, got {ring_slots}")
    if cost_sort and ring_slots:
        raise ValueError(
            "cost_sort needs the free-running variant (ring_slots=0): the "
            "ring's refill planes are row-major"
        )
    if adaptive is not None:
        if ring_slots:
            raise ValueError(
                "adaptive sampling needs the free-running variant "
                "(ring_slots=0): the ring's host refills assume uniform "
                "frame progress across lanes"
            )
        adaptive = (int(adaptive[0]), float(adaptive[1]), float(adaptive[2]))
        if adaptive[0] < 2:
            raise ValueError(
                "adaptive min_frames must be >= 2 (the variance estimate "
                "needs at least two samples)"
            )
        if not (adaptive[1] >= 0.0 and adaptive[2] >= 0.0):
            raise ValueError("adaptive rtol/atol must be >= 0")
    if (resume_state is not None or return_state) and ring_slots:
        raise ValueError(
            "persist checkpointing is free-running only (the ring's host "
            "refill window is not part of the carried state)"
        )
    if (resume_state is not None or return_state) and cost_sort:
        raise ValueError(
            "persist checkpointing does not compose with cost_sort "
            "(the saved planes' pixel relabeling cannot be undone on resume)"
        )
    if resume_state is not None:
        meta = resume_state["meta"]
        if int(meta["n_frames"]) != n_frames:
            raise ValueError(
                f"resume state was saved for a {meta['n_frames']}-frame "
                f"render, not {n_frames}"
            )
        saved_ad = meta.get("adaptive")
        if (saved_ad is None) != (adaptive is None) or (
            saved_ad is not None and tuple(saved_ad) != tuple(adaptive)
        ):
            raise ValueError(
                f"resume state was saved with adaptive={saved_ad}, not {adaptive}"
            )
        budget = int(meta["budget"])  # the same launch split continues

    tables = tables or mk.pack_tables(scene, config)
    fpl = frames_per_launch or (max(4, ring_slots // 4) if ring_slots else 64)
    lane_perm = lane_inv = None
    if budget is None or cost_sort:
        # one probe serves both: the budget needs the mean cost of one
        # frame, the sort the per-pixel rank over cost_sort frames
        with trace.span("persist.probe"):
            n_probe = max(1, int(cost_sort))
            cost = probe_path_cost(scene, config, tables, n_probe_frames=n_probe)
            if budget is None:
                mean_cost = float(cost.mean()) / n_probe
                budget = max(8, int(round(fpl * mean_cost)))
            if cost_sort:
                lane_perm, lane_inv = cost_sort_perm(cost)
    budget = int(budget)
    with trace.span("persist.init"):
        cam = tables.cam if ring_slots else camera_basis_table(scene, config)
        if resume_state is not None:
            st = _load_state(resume_state, config, dev)
            if st.ox.shape != (n,):
                raise ValueError(
                    f"resume state has {st.ox.shape[0]} lanes, this render {n}"
                )
        else:
            st = persist_init(scene, config, lane_perm)

    stop = stats = None
    if adaptive is not None:
        if resume_state is not None:
            stop = torch.as_tensor(np.asarray(resume_state["stop"]), dtype=torch.float32).to(dev)
            stats = tuple(torch.as_tensor(np.asarray(a), dtype=torch.float32).to(dev)
                          for a in resume_state["stats"])
            pixel_of_slot = np.asarray(resume_state["pixel_of_slot"], np.int64)
            packed_workable = int(resume_state["packed_workable"])
            compactions = int(resume_state["compactions"])
        else:
            stop = torch.zeros((n,), dtype=torch.float32, device=dev)
            stats = tuple(torch.zeros((n,), dtype=torch.float32, device=dev)
                          for _ in range(5))
            pixel_of_slot = (lane_perm.cpu().numpy().astype(np.int64)
                             if lane_perm is not None else np.arange(n))
            packed_workable = n
            compactions = 0

    ring = None
    lead = n_frames  # read by the ring variant only
    if ring_slots:
        ring = tuple(torch.zeros((ring_slots, n), dtype=torch.float32, device=dev)
                     for _ in range(3))
        lead = min(ring_slots, n_frames)
        for f in range(1, lead):
            ring_refill(ring, f, scene, config)

    def launch(end):
        with trace.span("launch.persist"):
            mk.run_persist(st, lead, end, tables, cam, ring=ring, stop=stop,
                           budget=budget)

    pending: list[_Readback] = []
    pending_work: list[_Readback] = []
    launches = 0
    min_done = 0
    aborted = False
    # generous runaway bound: ideal launches * 8 + slack
    max_launches = 16 + 8 * ((n_frames * config.max_bounces) // max(budget, 1) + 1)
    cur_lane_inv = lane_inv
    if adaptive is not None and compactions:
        cur_lane_inv = torch.from_numpy(slot_inverse(pixel_of_slot, n)).to(dev)
    while True:
        if trace.enabled():
            # the lanes owing frames as this launch starts: every lane of a
            # fresh render, else one reduction queued behind the last launch
            trace.count("persist.lanes_working",
                        n if launches == 0 and resume_state is None
                        else lanes_working(st, stop, n_frames))
        launch(n_frames)
        md = min_frames_done(st, stop, n_frames)
        if adaptive is not None:
            # refresh the stop mask the NEXT launch reads; the statistics
            # stay on the device, queued behind the launch
            stop, *rest = adapt_update(st.rad, st.fid, st.alive, stop, *stats,
                                       n_frames, *adaptive)
            stats, n_work_dev = tuple(rest[:5]), rest[5]
            if compact:
                pending_work.append(_Readback(n_work_dev))
            if compact and len(pending_work) >= 2:
                # one-launch-stale working count; repack when the packing
                # is a quarter hollow and at least one block would empty
                n_work = pending_work.pop(0).value()
                if 0 < n_work < packed_workable - max(packed_workable // 4, mk.BLOCK):
                    workable = workable_mask(
                        st.alive.cpu().numpy(), st.fid.cpu().numpy(),
                        stop.cpu().numpy(), n_frames)
                    order_np = np.argsort(~workable, kind="stable")
                    order = torch.from_numpy(order_np).to(dev)
                    _relabel(st, order)
                    stop = stop[order]
                    stats = tuple(a[order] for a in stats)
                    pixel_of_slot = pixel_of_slot[order_np]
                    packed_workable = int(workable.sum())
                    compactions += 1
                    cur_lane_inv = torch.from_numpy(slot_inverse(pixel_of_slot, n)).to(dev)
        pending.append(_Readback(md))
        launches += 1
        if launches > max_launches:
            raise RuntimeError(
                f"persistent render exceeded {max_launches} launches "
                f"(budget={budget}, n_frames={n_frames}): scheduler bug"
            )
        if preview is not None:
            preview(lambda inv=cur_lane_inv: persist_finish(st, scene, config, inv))
        if len(pending) >= 2:
            min_done = pending.pop(0).value()
            if min_done >= n_frames:
                break
            if ring_slots:
                new_lead = min(min_done + ring_slots, n_frames)
                while lead < new_lead:
                    ring_refill(ring, lead, scene, config)
                    lead += 1
        if progress is not None:
            progress(min_done, launches)
        if should_abort is not None and should_abort():
            aborted = True
            break
    for md in pending:
        min_done = max(min_done, md.value())

    state_pre_drain = None
    if aborted:
        # finish every path in flight before averaging: end=0 blocks all
        # restarts. The checkpoint keeps the state from BEFORE the drain,
        # so a resume replays the uninterrupted launch stream exactly.
        if return_state:
            state_pre_drain = PersistState(**{k: v.clone() for k, v in st.planes().items()})
        for _ in range(2 + config.max_bounces // max(budget, 1)):
            if not bool((st.alive > 0.0).any()):
                break
            launch(0)

    with trace.span("persist.finish"):
        rgb = persist_finish(st, scene, config, cur_lane_inv)
    info = {
        "launches": launches, "frames_done": int(min_done), "budget": budget,
        "ring_slots": ring_slots, "tile": mk.BLOCK, "aborted": aborted,
    }
    if return_state:
        saved = state_pre_drain if state_pre_drain is not None else st
        rs = {
            "state": tuple(getattr(saved, k) for k in PersistState.CARRIED),
            "px": saved.px, "py": saved.py,
            "meta": {"n_frames": n_frames, "budget": budget, "tile": mk.BLOCK,
                     "adaptive": adaptive},
        }
        if adaptive is not None:
            rs.update(stop=stop, stats=stats, pixel_of_slot=pixel_of_slot,
                      packed_workable=packed_workable, compactions=compactions)
        info["resume_state"] = rs
    if adaptive is not None:
        counts_slot = completed_frames(st).cpu().numpy()
        counts = np.empty(n, np.int64)
        counts[pixel_of_slot] = counts_slot
        info.update(
            compactions=compactions,
            min_counts=int(counts.min()),
            max_counts=int(counts.max()),
            mean_counts=float(counts.mean()),
            counts=counts,
            adaptive=adaptive,
        )
    return rgb, info
