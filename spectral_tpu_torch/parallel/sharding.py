"""Row-sharded rendering (the port of ``spectral_tpu.parallel.sharding``).

The framebuffer, and with it every lane of the wavefront, is split over
pixel rows: slot ``i`` of the mesh renders the ``i``-th slab of
``height / size`` rows with the same kernels (their plain versions on
the CPU) as the whole image, its lanes carrying **global** pixel
coordinates and the camera table the whole image's height, so every
pixel's paths are the unsharded render's bit for bit. Scene tables are
small and read by every ray: each slot's device holds a copy
(``shard_scene``). Each slot keeps its own accumulator slab.

* Frame by frame (``render_frame_step_sharded``, ``cuda_mono``) and
  regeneration (``render_frames_step_sharded_regen``, ``cuda_regen``)
  take no collective per frame.
* ``render_persistent_sharded`` carries each slab's lane state across
  launches (``cuda_cost`` probes the budget on the slabs, ``cuda_persist``
  runs the launches). The only cross-slot value is the completed-frame
  minimum: exactly one MIN per launch, on the host over the slots of a
  process and with one ``all_reduce(MIN)`` across processes. The
  adaptive update and lane compaction stay inside each slab.

Slots on one card launch on the card's current stream one after
another: two resident grids that each fill the card gain nothing from
overlapping, and one stream keeps the allocator's reuse ordered.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.parallel import distributed
from spectral_tpu_torch.parallel.mesh import Mesh, RowSharding
from spectral_tpu_torch.render import launch_inputs
from spectral_tpu_torch.render.cuda_integrator import (
    PersistLanes,
    check_adaptive,
    count_info,
    empty_frame,
    no_objects_info,
    persist_drain,
    persist_init,
    persist_loop,
    probe_path_cost,
    render_frame_step_cuda,
    render_frames_step_cuda_regen,
)
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors, from_numpy


@dataclasses.dataclass
class Slab:
    """One local slot's share of a sharded render: its rows
    ``[row_offset, row_offset + config.height)`` of the whole image, the
    scene tensors and kernel tables on its device, its accumulator slab
    ``[h, W, 4]`` and, for clustered regeneration, its Morton lanes."""

    row_offset: int
    config: RenderConfig
    scene: SceneTensors
    tables: mk.KernelTables
    accum: torch.Tensor | None = None
    lane_perm: torch.Tensor | None = None
    lane_inv: torch.Tensor | None = None


def check_rows(config: RenderConfig, mesh: Mesh) -> int:
    """The rows of one slab; raises unless the image height divides over
    the mesh (the reference's message)."""
    if config.height % mesh.size:
        raise ValueError(
            f"image height {config.height} must be divisible by the mesh "
            f"size {mesh.size} (pad the image or shrink the mesh)"
        )
    return config.height // mesh.size


def shard_scene(scene: SceneTensors, sharding: RowSharding, config: RenderConfig,
                tables: mk.KernelTables | None = None) -> list[Slab]:
    """This process's slabs of ``sharding.mesh``: each slot's rows, with the
    scene and its kernel tables on the slot's device (``scene``/``tables``
    themselves where the slot shares their device, one copy per other
    device). Raises if the row count does not divide over the mesh."""
    mesh = sharding.mesh
    local_h = check_rows(config, mesh)
    slab_cfg = dataclasses.replace(config, height=local_h)
    on_device = {scene.device: (scene, tables or mk.pack_tables(scene, config))}
    slabs = []
    for slot in mesh.local_slots():
        if slot.device.type != scene.device.type:
            raise ValueError(
                f"the mesh's slot {slot.index} is on {slot.device}, the scene on "
                f"{scene.device}: pass the renderer the mesh's device"
            )
        dev = slot.device
        if dev not in on_device:
            copy, _ = from_numpy(scene.np_fields, config, dev, scene.smooth_tri)
            base = on_device[scene.device][1]
            on_device[dev] = (copy, mk.repack_tables(base, copy))
        st, tb = on_device[dev]
        slabs.append(Slab(slot.index * local_h, slab_cfg, st, tb))
    return slabs


def gather(slabs: list[Slab]) -> np.ndarray:
    """The whole accumulator from every process's slabs (``fetch_global``)."""
    return distributed.fetch_global([s.accum for s in slabs])


def render_frame_step_sharded(slabs: list[Slab], config: RenderConfig, frame_id: int) -> None:
    """One progressive frame on every local slab (one ``cuda_mono`` launch
    each), blended into its accumulator slab. ``config`` is the whole
    image's."""
    for s in slabs:
        s.accum = render_frame_step_cuda(s.scene, s.config, s.accum, frame_id, s.tables,
                                         full_height=config.height, row_offset=s.row_offset)


def render_frames_step_sharded_regen(slabs: list[Slab], config: RenderConfig,
                                     first_frame_id: int, k: int) -> None:
    """K progressive frames on every local slab (one ``cuda_regen`` launch
    each, on the slab's Morton lanes where it has them)."""
    for s in slabs:
        s.accum = render_frames_step_cuda_regen(
            s.scene, s.config, s.accum, first_frame_id, k, s.tables,
            lane_perm=s.lane_perm, lane_inv=s.lane_inv,
            full_height=config.height, row_offset=s.row_offset)


def _min_over_slots(readbacks: list, abort: bool) -> tuple[int, bool]:
    """One MIN per launch: the least completed-frame count over this
    process's slots on the host, then over every process with one
    ``all_reduce(MIN)`` that also carries the abort request (so every
    process stops at the same launch)."""
    md = min(r.value() for r in readbacks)
    md, no_abort = distributed.all_min([md, 0.0 if abort else 1.0])
    return int(md), no_abort == 0.0


def render_persistent_sharded(
    slabs: list[Slab],
    config: RenderConfig,
    mesh: Mesh,
    n_frames: int,
    budget: int | None = None,
    frames_per_launch: int | None = None,
    adaptive: tuple | None = None,
    compact: bool = True,
    progress=None,
    should_abort=None,
    preview=None,
):
    """Row-sharded ``render_persistent`` (free-running only; the
    reference's ``render_persistent_sharded``). Returns ``(rgb, info)``:
    ``rgb`` is this process's slabs' linear RGB ``[h, W, 3]``, in slot
    order (``distributed.fetch_global`` joins them into the image), and
    ``info`` has ``render_persistent``'s keys plus ``n_devices`` (the mesh
    size) and ``min_reductions`` (the MINs taken: one per launch).

    Each slab's lanes start frame 0 of their global pixels and run
    ``cuda_persist`` launches of ``budget`` bounce iterations (default
    ``max(8, round(fpl * mean cost))`` from a one-frame ``cuda_cost``
    probe on the slabs, summed over the processes once), one set of
    lanes per slab in ``persist_loop``. The one-launch-stale minimum of
    the completed frames is ``_min_over_slots``; with ``adaptive`` each
    slab's stop mask is updated, and when a quarter of the process's last
    packing has retired (its slabs' working lanes counted together, as
    the reference counts the mesh's), every slab's working lanes are
    packed to the front of that slab. ``compactions`` counts this
    process's packings. An abort stops one process at once and a group
    at the next MIN, together, then drains the paths in flight with
    ``end = 0``. Depth of field is refused, as in the reference (the
    restarts assume the pinhole camera); the ring variant is not offered
    (its host refills assume one global frame window)."""
    if config.has_dof:
        raise ValueError(
            "the persist kernel's in-kernel restart raygen assumes the "
            "frame-constant pinhole camera, incompatible with depth of "
            "field; use the per-frame sharded step"
        )
    if n_frames < 1:
        raise ValueError("n_frames must be >= 1")
    local_h = check_rows(config, mesh)
    mesh_info = {"n_devices": mesh.size, "min_reductions": 0}
    if config.n_objects == 0:
        info = no_objects_info(n_frames, config.width * config.height, adaptive)
        return [empty_frame(s.scene, s.config) for s in slabs], dict(info, **mesh_info)
    if adaptive is not None:
        adaptive = check_adaptive(adaptive)
    full_h = config.height
    fpl = frames_per_launch or 64
    if budget is None:
        total = 0.0
        for s in slabs:
            cost = probe_path_cost(s.scene, s.config, s.tables, n_probe_frames=1,
                                   full_height=full_h, row_offset=s.row_offset)
            cost = cost.sum(dtype=torch.float64)
            with trace.span("wait.probe", arg=1):
                total += float(cost)
        mean_cost = distributed.all_sum([total])[0] / (config.width * full_h)
        budget = max(8, int(round(fpl * mean_cost)))
    budget = int(budget)

    sets = []
    cams = {}
    for s in slabs:
        if s.scene.device not in cams:
            cams[s.scene.device] = launch_inputs.camera_table(s.scene, s.config, full_h)
        lanes = PersistLanes(persist_init(s.scene, s.config, full_height=full_h,
                                          row_offset=s.row_offset),
                             s.scene, s.config, s.tables, cams[s.scene.device], lead=n_frames)
        if adaptive is not None:
            lanes.start_adaptive(np.arange(config.width * local_h))
        sets.append(lanes)

    run = persist_loop(
        sets, n_frames, budget, config.max_bounces, _min_over_slots,
        adaptive=adaptive, compact=compact, progress=progress, should_abort=should_abort,
        preview=((lambda: preview(lambda: [ls.finish() for ls in sets]))
                 if preview is not None else None),
        abort_at_once=not distributed.is_multiprocess())
    if run.aborted:
        persist_drain(sets, config.max_bounces, budget)

    rgb = [ls.finish() for ls in sets]
    info = dict(launches=run.launches, frames_done=run.min_done, budget=budget, ring_slots=0,
                tile=mk.BLOCK, aborted=run.aborted, n_devices=mesh.size,
                min_reductions=run.reductions)
    if adaptive is not None:
        counts = distributed.fetch_global([torch.from_numpy(ls.counts()) for ls in sets])
        info.update(count_info(counts, run.compactions, adaptive))
    return rgb, info
