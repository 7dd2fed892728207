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
    _Readback,
    _relabel,
    adapt_update,
    completed_frames,
    empty_frame,
    min_frames_done,
    persist_finish,
    persist_init,
    probe_path_cost,
    render_frame_step_cuda,
    render_frames_step_cuda_regen,
    slot_inverse,
    workable_mask,
)
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


@dataclasses.dataclass
class _SlabLanes:
    """A slab's carried persist state and its adaptive bookkeeping, in the
    slab's own lane order (compaction never leaves the slab)."""

    slab: Slab
    st: object
    stop: torch.Tensor | None = None
    stats: tuple = ()
    pixel_of_slot: np.ndarray | None = None
    lane_inv: torch.Tensor | None = None

    def repack(self, n_frames: int) -> int:
        """Put the slab's working lanes first (a stable, slab-local
        relabeling); returns how many it has."""
        st = self.st
        workable = workable_mask(st.alive.cpu().numpy(), st.fid.cpu().numpy(),
                                 self.stop.cpu().numpy(), n_frames)
        order_np = np.argsort(~workable, kind="stable")
        order = torch.from_numpy(order_np).to(st.ox.device)
        _relabel(st, order)
        self.stop = self.stop[order]
        self.stats = tuple(a[order] for a in self.stats)
        self.pixel_of_slot = self.pixel_of_slot[order_np]
        self.lane_inv = torch.from_numpy(
            slot_inverse(self.pixel_of_slot, len(order_np))).to(st.ox.device)
        return int(workable.sum())

    def finish(self) -> torch.Tensor:
        return persist_finish(self.st, self.slab.scene, self.slab.config, self.lane_inv)


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
    probe on the slabs, summed over the processes once). Between launches
    the host reads the one-launch-stale minimum of the completed frames;
    with ``adaptive`` each slab's stop mask is updated, and when a quarter
    of the process's last packing has retired (its slabs' working lanes
    counted together, as the reference counts the mesh's), every slab's
    working lanes are packed to the front of that slab. ``compactions``
    counts this process's packings. An abort drains the paths in flight with
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
    base_info = {"launches": 0, "frames_done": n_frames, "budget": 0, "ring_slots": 0,
                 "tile": 0, "aborted": False, "n_devices": mesh.size, "min_reductions": 0}
    local_n = config.width * local_h
    if config.n_objects == 0:
        info = dict(base_info)
        if adaptive is not None:
            info.update(min_counts=n_frames, max_counts=n_frames,
                        mean_counts=float(n_frames), compactions=0,
                        counts=np.full(config.width * config.height, n_frames, np.int64),
                        adaptive=tuple(adaptive))
        return [empty_frame(s.scene, s.config) for s in slabs], info
    if adaptive is not None:
        adaptive = (int(adaptive[0]), float(adaptive[1]), float(adaptive[2]))
        if adaptive[0] < 2:
            raise ValueError("adaptive min_frames must be >= 2")
        if not (adaptive[1] >= 0.0 and adaptive[2] >= 0.0):
            raise ValueError("adaptive rtol/atol must be >= 0")
    full_h = config.height
    fpl = frames_per_launch or 64
    if budget is None:
        total = sum(float(probe_path_cost(s.scene, s.config, s.tables, n_probe_frames=1,
                                          full_height=full_h, row_offset=s.row_offset)
                          .sum(dtype=torch.float64)) for s in slabs)
        mean_cost = distributed.all_sum([total])[0] / (config.width * full_h)
        budget = max(8, int(round(fpl * mean_cost)))
    budget = int(budget)

    lanes = []
    cams = {}
    for s in slabs:
        if s.scene.device not in cams:
            cams[s.scene.device] = launch_inputs.camera_table(s.scene, s.config, full_h)
        sl = _SlabLanes(s, persist_init(s.scene, s.config, full_height=full_h,
                                        row_offset=s.row_offset))
        if adaptive is not None:
            dev = s.scene.device
            sl.stop = torch.zeros((local_n,), dtype=torch.float32, device=dev)
            sl.stats = tuple(torch.zeros((local_n,), dtype=torch.float32, device=dev)
                             for _ in range(5))
            sl.pixel_of_slot = np.arange(local_n)
        lanes.append(sl)

    def launch(sl, end):
        mk.run_persist(sl.st, n_frames, end, sl.slab.tables, cams[sl.slab.scene.device],
                       stop=sl.stop, budget=budget)

    def adapt(sl):
        """The slab's convergence update; returns its count of working
        lanes as a readback."""
        sl.stop, *rest = adapt_update(sl.st.rad, sl.st.fid, sl.st.alive, sl.stop,
                                      *sl.stats, n_frames, *adaptive)
        sl.stats = tuple(rest[:5])
        return _Readback(rest[5])

    pending_work: list[list[_Readback]] = []
    packed_workable = local_n * len(lanes)
    compactions = 0
    multi = distributed.is_multiprocess()
    pending: list[list[_Readback]] = []
    launches = reductions = 0
    min_done = 0
    aborted = abort_req = False
    max_launches = 16 + 8 * ((n_frames * config.max_bounces) // max(budget, 1) + 1)
    while True:
        mds, works = [], []
        for sl in lanes:
            launch(sl, n_frames)
            mds.append(_Readback(min_frames_done(sl.st, sl.stop, n_frames)))
            if adaptive is not None:
                works.append(adapt(sl))
        if adaptive is not None and compact:
            pending_work.append(works)
        if len(pending_work) >= 2:
            # one-launch-stale working count of this process's slabs; the
            # repack when the packing is a quarter hollow and a block would
            # empty (render_persistent's rule), inside each slab
            n_work = sum(r.value() for r in pending_work.pop(0))
            if 0 < n_work < packed_workable - max(packed_workable // 4, mk.BLOCK):
                packed_workable = sum(sl.repack(n_frames) for sl in lanes)
                compactions += 1
        pending.append(mds)
        launches += 1
        if launches > max_launches:
            raise RuntimeError(
                f"sharded persistent render exceeded {max_launches} launches "
                f"(budget={budget}, n_frames={n_frames})"
            )
        if preview is not None:
            preview(lambda: [sl.finish() for sl in lanes])
        stop_now = False
        if len(pending) >= 2:
            min_done, abort_all = _min_over_slots(pending.pop(0), abort_req)
            reductions += 1
            if min_done >= n_frames:
                break
            stop_now = abort_all
        if progress is not None:
            progress(min_done, launches)
        abort_req = abort_req or bool(should_abort is not None and should_abort())
        # one process decides at once; a group at the next MIN, together
        if stop_now or (abort_req and not multi):
            aborted = True
            break
    for mds in pending:
        min_done = max(min_done, _min_over_slots(mds, abort_req)[0])
        reductions += 1

    if aborted:
        # finish every path in flight before averaging: end = 0 blocks all
        # restarts, so each pixel averages only completed frames
        for _ in range(2 + config.max_bounces // max(budget, 1)):
            live = [sl for sl in lanes if bool((sl.st.alive > 0.0).any())]
            if not live:
                break
            for sl in live:
                launch(sl, 0)

    rgb = [sl.finish() for sl in lanes]
    info = dict(base_info, launches=launches, frames_done=int(min_done), budget=budget,
                tile=mk.BLOCK, aborted=aborted, min_reductions=reductions)
    if adaptive is not None:
        counts = []
        for sl in lanes:
            c = np.empty(local_n, np.int64)
            c[sl.pixel_of_slot] = completed_frames(sl.st).cpu().numpy()
            counts.append(torch.from_numpy(c))
        counts = distributed.fetch_global(counts)
        info.update(
            compactions=compactions,
            min_counts=int(counts.min()), max_counts=int(counts.max()),
            mean_counts=float(counts.mean()), counts=counts, adaptive=adaptive,
        )
    return rgb, info
