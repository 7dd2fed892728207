"""Where the bounce kernels lose their lanes, on one GPU.

    python -m spectral_tpu_torch.tools.lane_stats [--only cornell512 spheres1000 mesh mesh5k seg persist persist_tables mono]

Builds the diagnostic libraries of ``regen.cu``, ``seg.cu``,
``persist.cu`` and ``mono.cu`` with ``-DSPECTRAL_STATS``
(``runtime/build.py``: ``VARIANTS``; the render paths never load them)
and launches them at the main paths' shapes:
``cuda_regen`` at cornell512 (512x512, 32 wavelengths, 30 bounces, K =
100, row-major lanes), spheres1000 (1024x768, 8 bounces, K = 100, Morton
lanes), mesh (512x512, 30 bounces, K = 100, Morton lanes) and mesh5k
(the same at K = 10), the main build timed twice; ``cuda_seg`` at spheres1000 over bounces
[0, 2) of the full wavefront and [2, 8) of the compacted survivors
(``cuda_integrator.compact_live``), these in three lane orders, the
cascade's ascending one and two that were measured and not kept
(``ray_order``, and it with each block's warps interleaved), their main
builds timed in turns too; ``cuda_persist`` (``persist``) through every
launch of a persist render (``Renderer(persist=True)``) of cornell512,
mesh (100 iterations each), mesh5k (10) and the prism, with the
spectral state in shared memory (``persist``) and in registers (the
register build ``persist_reg``, the earlier design), the renders in
turns with each launch timed alone, then once more through each stats
build, one line per launch; ``persist_tables``: the same turns, without
the stats builds, on the tables where the shared state holds no more
blocks per SM than registers do (mesh and sphere_field(1000) at 64
wavelengths, sphere_field(2400) at 32 and 64), each line naming the
library ``megakernel.persist_library`` takes; ``cuda_mono`` and ``cuda_cost``
(``mono``) on frame 0 of cornell512 and of mesh (Morton lanes), each
timed twice. Every thread records its live bounce iterations, its start and end time
(``globaltimer``) and its walk counters, every block its SM. One JSON
line per launch:

- ``lane_loop``: the SIMT efficiency of the lane loop, live lane
  iterations over the iterations its warps issue (32 times the warp's
  busiest lane) and over those its blocks hold (128 times the block's
  busiest lane), and the threads that ran a live iteration;
- ``blocks``: the resident blocks the card holds (the occupancy API), the
  waves, the blocks seen at once on one SM, the makespan, the share of SM
  slot time the blocks held, and the tail: the share of the makespan
  after the running blocks fell below 90% of the slots;
- ``walk``: per nearest-hit trace and per shadow ray, the culled runs
  (clusters) the lane needs and its warp visits, their SIMT efficiency
  (member tests needed over the lane slots the warp spends on member
  tests: a run's size per lane on it in the per-lane loop, and in a
  packed triangle run's cooperative pass its needing lanes times
  ceil(size / lanes)), and ``visited_fraction``: the
  share of clusters a trace needs, the input of ``flops.kernel_ops``;
  beside it ``root_stage_share``: of the packed sphere member tests a
  warp runs, the share in which it runs the root stage because a lane
  has a root (``bounce.cuh:sphere_t_voted``), both counted once a warp;
  and of the packed triangle runs a warp visits, ``coop_share``: the
  share it takes in the cooperative pass (``bounce.cuh:tri_run_nearest``,
  ``tri_run_blocked``), counted once a warp, and
  ``triangle_simt_efficiency``: their member tests needed over the lane
  slots spent in both branches;
- ``bound_ms``: the least time of the launch (``flops.bound_ms``): its
  live iterations at ``kernel_ops``' count with the measured visited
  fractions, or its bytes over HBM.

A last line, ``kernel_info``, gives the registers, local bytes and
resident blocks per SM of every instantiation these paths run, from
the main libraries (``spectral_regen_info``, ``spectral_seg_info``), of
every instantiation of the persist kernel in the main and the register
library and of the mono kernel (``spectral_persist_info``,
``spectral_mono_info``, at the tables of a scene of each kind, and the
many-object persist ones also at ``PACKED_SMEM_LIMIT``, the largest
tables whose records stay in shared memory), and the ``nvcc -Xptxas -v`` lines
of their builds. The stats build's own
times are longer than the main build's (counters in shared memory): read
its shares, not its milliseconds. Every line names the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

SCENES = ("cornell512", "spheres1000", "mesh", "mesh5k", "seg", "persist", "persist_tables",
          "mono")
# the designs of each source: (library timed, its stats build); None: the
# main library
DESIGNS = {
    "resident grid": (None, "regen_stats"),
}
PERSIST_DESIGNS = {
    "parent: spectral state in registers": ("persist_reg", "persist_reg_stats"),
    "spectral state in shared memory": ("persist", "persist_stats"),
}
MONO_DESIGNS = {
    "resident grid": (None, "mono_stats"),
}
# the walk counters' slots per thread, as ``bounce.cuh`` numbers them:
# the nearest trace's from 0, the shadow rays' from WALK_SHADOW
WALK_SHADOW, WALK_STATS = 12, 24


def _bind(lib, buf: dict, threads: int) -> None:
    ptrs = [ctypes.c_void_p(buf[k].data_ptr()) for k in
            ("iters", "pixels", "t0", "t1", "smid", "walk")]
    lib.spectral_stats_bind.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.spectral_stats_bind.restype = ctypes.c_int
    err = lib.spectral_stats_bind(*ptrs, threads)
    if err:
        raise RuntimeError(f"spectral_stats_bind failed: cudaError_t {err}")


def _buffers(threads: int, dev):
    import torch

    i32, i64 = torch.int32, torch.int64
    blocks = -(-threads // 128)
    return dict(iters=torch.zeros(threads, dtype=i32, device=dev),
                pixels=torch.zeros(threads, dtype=i32, device=dev),
                t0=torch.zeros(threads, dtype=i64, device=dev),
                t1=torch.zeros(threads, dtype=i64, device=dev),
                smid=torch.zeros(blocks, dtype=i32, device=dev),
                walk=torch.zeros(WALK_STATS * threads, dtype=i32, device=dev))


def summarize(buf: dict, threads: int, slots: int, n_culled: int) -> dict:
    """The lane-loop, block and walk readings of one stats launch (host
    arithmetic on the per-thread record)."""
    import numpy as np

    t1 = buf["t1"].cpu().numpy()
    threads = min(threads, (int(np.nonzero(t1 > 0)[0].max()) // 128 + 1) * 128)  # launched
    t1 = t1[:threads]
    it = buf["iters"].cpu().numpy().astype(np.int64)[:threads]
    t0 = buf["t0"].cpu().numpy()[:threads]
    walk = buf["walk"].cpu().numpy().astype(np.int64).reshape(WALK_STATS, -1)[:, :threads]
    pad = (-threads) % 128
    itp = np.concatenate([it, np.zeros(pad, np.int64)])
    warp_max = itp.reshape(-1, 32).max(axis=1)
    block_max = itp.reshape(-1, 128).max(axis=1)
    live = float(it.sum())
    lane_loop = dict(live_iterations=live,
                     simt_efficiency_warp=live / float(32 * max(int(warp_max.sum()), 1)),
                     simt_efficiency_block=live / float(128 * max(int(block_max.sum()), 1)),
                     threads_live=int((it > 0).sum()),
                     pixels_per_thread_max=int(buf["pixels"].max()))
    ran = t1 > 0
    b_of = np.arange(threads) // 128
    n_blocks = int(b_of.max()) + 1
    start = np.full(n_blocks, np.iinfo(np.int64).max)
    end = np.zeros(n_blocks, np.int64)
    np.minimum.at(start, b_of[ran], t0[ran])
    np.maximum.at(end, b_of[ran], t1[ran])
    ok = end > 0
    t_lo, t_hi = int(start[ok].min()), int(end[ok].max())
    makespan = float(t_hi - t_lo)
    held = float((end[ok] - start[ok]).sum())
    grid = np.linspace(t_lo, t_hi, 2001)
    running = ((start[ok][None, :] <= grid[:, None]) & (end[ok][None, :] > grid[:, None])).sum(1)
    full = np.nonzero(running >= 0.9 * slots)[0]
    tail_from = grid[full[-1]] if len(full) else grid[0]
    smid = buf["smid"].cpu().numpy()[:n_blocks].astype(np.int64)
    blocks = dict(grid_blocks=n_blocks, resident_slots=slots,
                  waves=n_blocks / slots, blocks_per_sm_seen=_most_at_once(
                      smid[ok], start[ok], end[ok]), makespan_ms=makespan / 1e6,
                  slot_time_held=held / (slots * makespan),
                  tail_share=(t_hi - tail_from) / makespan,
                  block_ms_min=float((end[ok] - start[ok]).min()) / 1e6,
                  block_ms_max=float((end[ok] - start[ok]).max()) / 1e6,
                  sms_seen=int(len(np.unique(smid))))
    out = dict(lane_loop=lane_loop, blocks=blocks)
    if n_culled:
        w = walk.sum(axis=1).astype(float)
        for name, base in (("nearest", 0), ("shadow", WALK_SHADOW)):
            traces = max(w[base], 1.0)
            out[f"walk_{name}"] = dict(
                traces=w[base],
                clusters_needed_per_trace=w[base + 1] / traces,
                clusters_visited_per_trace=w[base + 2] / traces,
                clusters=n_culled,
                visited_fraction=w[base + 1] / (traces * n_culled),
                warp_visited_fraction=w[base + 2] / (traces * n_culled),
                member_tests_needed_per_trace=w[base + 3] / traces,
                member_tests_run_per_trace=w[base + 4] / traces,
                simt_efficiency=w[base + 3] / max(w[base + 4], 1.0),
                warp_sphere_tests=w[base + 5],
                warp_root_stages=w[base + 6],
                root_stage_share=w[base + 6] / max(w[base + 5], 1.0),
                triangle_visits_coop=w[base + 7],
                triangle_visits_per_lane=w[base + 8],
                coop_share=w[base + 7] / max(w[base + 7] + w[base + 8], 1.0),
                triangle_tests_needed_per_trace=w[base + 9] / traces,
                triangle_slots_coop_per_trace=w[base + 10] / traces,
                triangle_slots_per_lane_per_trace=w[base + 11] / traces,
                triangle_simt_efficiency=w[base + 9] / max(w[base + 10] + w[base + 11], 1.0))
    return out


def _most_at_once(sm, start, end) -> int:
    """The most blocks that ran at once on one SM: per SM, the peak of
    its blocks' overlapping ``[start, end)`` spans."""
    import numpy as np

    peak = 0
    for one in np.unique(sm):
        mine = sm == one
        t = np.concatenate([start[mine], end[mine]])
        step = np.concatenate([np.ones(mine.sum(), np.int64), -np.ones(mine.sum(), np.int64)])
        order = np.lexsort((step, t))  # an end before a start at the same instant
        peak = max(peak, int(np.cumsum(step[order]).max()))
    return peak


def ray_order(wf, tables):
    """A lane order for a compacted wavefront that keeps a warp's cluster
    visits together: live lanes by the octant of their direction, then
    the Morton cell (10 bits an axis over the runs' union bounds) of their
    origin; dead lanes last (a stable sort on the device). Measured for
    the cascade's tail and not kept there (``PERF.md`` §6): the
    walk gains, the blocks' balance loses more."""
    import torch

    def spread3(v):  # two zero bits between each of the low 10 bits
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    runs = tables.runs
    lo = runs[:, 0:3].amin(dim=0)
    span = torch.clamp_min(runs[:, 3:6].amax(dim=0) - lo, 1e-9)
    key = torch.zeros_like(wf.px, dtype=torch.int64)
    for axis, (o, d) in enumerate(((wf.ox, wf.dx), (wf.oy, wf.dy), (wf.oz, wf.dz))):
        q = torch.clamp((o - lo[axis]) / span[axis] * 1023.0, 0.0, 1023.0)
        key = key | (spread3(torch.nan_to_num(q).to(torch.int64)) << axis)
        key = key | ((d < 0.0).to(torch.int64) << (30 + axis))
    key = torch.where(wf.alive > 0.0, key, 1 << 33)
    return torch.argsort(key, stable=True)


def kernel_info(source, tb, library=None, variant=None, samples=None, many=None, tri=None,
                smem=None, shared=None):
    """``spectral_<source>_info`` at ``tb``'s shared memory (or
    ``smem`` bytes of tables): of the instantiation ``tb`` takes, or
    of the one ``samples``, ``many``, ``tri`` name; ``variant``:
    persist's form (0 free-running, 1 ring, 2 lane-stop), mono's (0
    mono, 1 cost) or regen's build (0 the bins in registers, 1 in shared
    memory; by default the one a launch of ``tb`` takes,
    ``megakernel.shared_bins``); ``shared``: mono's build (the bins in
    shared memory or not; by default the one a launch of ``tb`` in that
    form takes)."""
    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.runtime import build

    if source == "regen" and variant is None:
        variant = int(mk.shared_bins("regen", library or source, tb))
    if source == "mono" and shared is None:
        shared = mk.shared_bins(("mono", "cost")[variant], library or source, tb)
    samples = tb.config.n_samples if samples is None else samples
    many = tb.many_objects() if many is None else many
    tri = tb.triangles if tri is None else tri
    smem = tb.smem_bytes() if smem is None else smem
    fn = getattr(build.load(library or source), f"spectral_{source}_info")
    out = (ctypes.c_int * 3)()
    head = (samples, int(many), int(tri)) + (() if variant is None else (variant,))
    if source == "mono":
        head += (int(shared),)
    err = fn(*head, smem, out)
    if err:
        raise RuntimeError(f"spectral_{source}_info: cudaError_t {err}")
    got = dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
               smem_bytes=smem, many=bool(many), triangles=int(tri),
               samples=samples)
    if variant is not None:
        got["variant"] = variant
    if source == "mono":
        got["shared_bins"] = bool(shared)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(SCENES), choices=SCENES)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from spectral_tpu_torch import presets
    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.render import cuda_integrator as ci
    from spectral_tpu_torch.render.layout import morton_layout
    from spectral_tpu_torch.render.renderer import Renderer
    from spectral_tpu_torch.runtime import build
    from spectral_tpu_torch.scene.flatten import flatten_scene
    from spectral_tpu_torch.tools.measure_persist import card
    from spectral_tpu_torch.utils import flops

    if not torch.cuda.is_available():
        print("lane_stats needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    only = set(args.only)

    def design_libs(designs):
        return {lib for pair in designs.values() for lib in pair if lib}

    libs = set()  # the libraries the chosen parts launch
    if only & {"cornell512", "spheres1000", "mesh", "mesh5k"}:
        libs |= design_libs(DESIGNS)
    if "seg" in only:
        libs.add("seg_stats")
    if "persist" in only:
        libs |= design_libs(PERSIST_DESIGNS) | {"persist_fx", "persist_fx_reg"}
    if "mono" in only:
        libs |= design_libs(MONO_DESIGNS)
    if only & {"persist", "persist_tables", "mono"}:  # kernel_info's
        libs |= set(build.REGISTER_LIBRARIES) | {"persist_tri", "mono_tri"}
    build.build_all(build.SOURCES + tuple(sorted(libs)))

    def culled(tb):
        return int((tb.runs[:, 8] > 0).sum())

    def timed(fn):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    infos = []

    def regen_case(label, sc, morton):
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        perm = morton_layout(cfg.width, cfg.height, dev)[0] if morton else None
        rargs = ci.regen_args(st, cfg, 0, cfg.intended_frames, perm)
        infos.append(dict(kernel="regen", case=label, **kernel_info("regen", tb)))
        n = cfg.width * cfg.height
        designs = DESIGNS
        launch = {d: (lambda lib=lib: mk.run_regen_variant(lib, *rargs, tb)) if lib
                  else (lambda: mk.run_regen(*rargs, tb)) for d, (lib, _) in designs.items()}
        outs = [fn() for fn in launch.values()]  # build, load and warm each library
        if not all(torch.equal(o, outs[0]) for o in outs):
            raise AssertionError(f"{label}: the regeneration designs disagree")
        del outs
        turns = {d: [] for d in designs}
        for d in (*designs, *reversed(designs)):
            turns[d].append(timed(launch[d]))
        for d, (_, lib) in designs.items():
            lib_info = kernel_info("regen", tb, lib)
            buf = _buffers(n, dev)
            _bind(build.load(lib), buf, n)
            ms = timed(lambda: mk.run_regen_variant(lib, *rargs, tb))
            got = summarize(buf, n, lib_info["blocks_per_sm"] * sms, culled(tb))
            # the bound of this launch (flops.kernel_ops): its live
            # iterations, each at the clusters its traces need
            walk = dict(visited_fraction=got["walk_nearest"]["visited_fraction"],
                        visited_fraction_shadow=got["walk_shadow"]["visited_fraction"]
                        ) if "walk_nearest" in got else {}
            ops = flops.kernel_ops(cfg, st.obj_types, cfg.n_materials, clusters=tb.clusters,
                                   **walk).per_lane_bounce * got["lane_loop"]["live_iterations"]
            b_ms, b_by = flops.bound_ms(ops, n * (8 + 4 * cfg.n_samples))
            print(json.dumps(dict(
                part="regen", case=label, design=d, library=lib, stats_build=lib_info,
                stats_build_ms=ms, main_build_turns_ms=turns, bound_ms=b_ms, bound_by=b_by,
                **got, card=gpu)), flush=True)

    def scene(maker, w, h, bounces, iters=100):
        sc = maker(n_samples=32)
        sc.width, sc.height = w, h
        sc.nbr_of_ray_bounces, sc.nbr_of_iterations = bounces, iters
        return sc

    def scene_of_s(maker, samples):  # the tables alone matter
        sc = maker(n_samples=samples)
        sc.width, sc.height = 32, 16
        return sc

    if "cornell512" in args.only:
        regen_case("cornell512 K=100", scene(presets.cornell_box, 512, 512, 30), False)
    if "spheres1000" in args.only:
        regen_case("spheres1000 K=100 Morton",
                   scene(presets.sphere_field, 1024, 768, 8), True)
    for name in ("mesh", "mesh5k"):
        if name in args.only:
            iters = 10 if name == "mesh5k" else 100
            regen_case(f"{name} 512x512 K={iters} Morton",
                       scene(presets.PRESETS[name], 512, 512, 30, iters), True)
    if "seg" in args.only:
        st, cfg = flatten_scene(scene(presets.sphere_field, 1024, 768, 8), dev)
        tb = mk.pack_tables(st, cfg)
        infos.append(dict(kernel="seg", case="spheres1000", **kernel_info("seg", tb)))
        slots = kernel_info("seg", tb, "seg_stats")["blocks_per_sm"] * sms
        full = ci.frame_wavefront(st, cfg, 0)
        mk.run_seg(full, 0, 2, 0, tb)
        live = int((full.alive > 0).sum())
        tail = ci.compact_live(full, -(-live // 128) * 128)[0]  # whole blocks, fill lanes dead
        ray = ray_order(tail, tb)
        blocks = ray.numel() // 128
        orders = {  # the tail's lane orders
            "ascending": torch.arange(ray.numel(), device=dev),
            "ray order": ray,
            # ray order, each block's four warps from four distant parts of it
            "ray order, warps interleaved over blocks":
                ray.view(4, blocks, 32).transpose(0, 1).reshape(-1),
        }
        cases = {"[0, 2) full wavefront": (ci.frame_wavefront(st, cfg, 0), 0, 2)}
        cases.update({f"[2, 8) compacted tail, {k}": (ci._gather(tail, v), 2, 8)
                      for k, v in orders.items()})

        def copy(w):
            return ci._gather(w, torch.arange(w.ox.shape[0], device=dev))

        for wf, b0, b1 in cases.values():  # load and warm both libraries
            mk.run_seg(copy(wf), b0, b1, 0, tb)
            mk.run_seg_variant("seg_stats", copy(wf), b0, b1, 0, tb)
        turns = {label: [] for label in cases}
        for label in (*cases, *reversed(cases)):
            wf, b0, b1 = cases[label]
            w = copy(wf)
            turns[label].append(timed(lambda: mk.run_seg(w, b0, b1, 0, tb)))
        for label, (wf, b0, b1) in cases.items():
            wf = copy(wf)
            threads = wf.ox.shape[0]
            buf = _buffers(threads, dev)
            _bind(build.load("seg_stats"), buf, threads)
            ms = timed(lambda: mk.run_seg_variant("seg_stats", wf, b0, b1, 0, tb))
            print(json.dumps(dict(
                part="seg", case=f"spheres1000 {label}", lanes=threads,
                live_lanes=int((cases[label][0].alive > 0).sum()), main_build_turns_ms=turns[label],
                stats_build_ms=ms, **summarize(buf, threads, slots, culled(tb)),
                card=gpu)), flush=True)
    def persist_case(label, sc, designs=PERSIST_DESIGNS):
        """Every launch of a persist render of ``sc`` in each of
        ``designs``: the renders in turns, once as they run and once with
        each launch timed alone, then once through each stats build."""
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        n = cfg.width * cfg.height
        for v in range(3):
            infos.append(dict(kernel="persist", case=label,
                              **kernel_info("persist", tb, mk.persist_library(tb), variant=v)))
        real = mk.run_persist

        def render(launch):
            """One persist render with ``launch(state, lead, end, tables,
            cam, ring, stop, budget)`` in place of ``run_persist``."""
            mk.run_persist = lambda state, lead, end, tables, cam, ring=None, stop=None, \
                budget=1: launch(state, lead, end, tables, cam, ring, stop, budget)
            try:
                r = Renderer(sc, device="cuda", persist=True)
                torch.cuda.synchronize()
                t = time.monotonic()
                img = r.render()
                return img, time.monotonic() - t
            finally:
                mk.run_persist = real

        def lanes(state):
            return dict(alive=int((state.alive > 0).sum()),
                        fid_min=int(state.fid.min()), fid_max=int(state.fid.max()))

        def run_design(lib):  # None: the main path's library (uncounted)
            def launch(state, lead, end, tables, cam, ring, stop, budget):
                mk.run_persist_variant(lib or mk.persist_library(tables), state, lead,
                                       end, tables, cam, ring, stop, budget)
            return launch

        def timed_launches(lib, rows):
            def launch(*a):
                before = lanes(a[0])
                ms = timed(lambda: run_design(lib)(*a))
                rows.append(dict(end=int(a[2]), budget=int(a[7]), before=before, ms=ms,
                                 after=lanes(a[0])))
            return launch

        images, turns = {}, {d: [] for d in designs}
        for d in (*designs, *reversed(designs)):
            img, sec = render(run_design(designs[d][0]))
            rows = []
            timed_img, _ = render(timed_launches(designs[d][0], rows))
            turns[d].append(dict(render_ms_per_frame=1e3 * sec / cfg.intended_frames,
                                 launch_ms=[row["ms"] for row in rows],
                                 kernel_ms=sum(row["ms"] for row in rows), launches=rows))
            images.setdefault(d, []).extend((img, timed_img))
        first = images[next(iter(designs))][0]  # the register build's
        same = {d: all(np.array_equal(first, img) for img in imgs) for d, imgs in images.items()}
        if not all(same.values()):
            raise AssertionError(f"{label}: the persist designs render different images")
        main_library = mk.persist_library(tb)
        for d, (timed_lib, lib) in designs.items():
            if lib is None:  # no stats build: its registers and turns alone
                print(json.dumps(dict(part="persist", case=label, design=d, library=timed_lib,
                                      main_path_library=main_library,
                                      main_build=kernel_info("persist", tb, timed_lib or main_library,
                                                      variant=0),
                                      image_equals_registers=same[d], main_build_turns=turns[d],
                                      card=gpu)), flush=True)
                continue
            lib_info = kernel_info("persist", tb, lib, variant=0)
            slots = lib_info["blocks_per_sm"] * sms
            per_launch = []

            def launch(state, lead, end, tables, cam, ring, stop, budget, lib=lib):
                buf = _buffers(n, dev)
                _bind(build.load(lib), buf, n)
                live = lanes(state)
                ms = timed(lambda: mk.run_persist_variant(lib, state, lead, end, tables, cam,
                                                          ring, stop, budget))
                per_launch.append(dict(launch=len(per_launch), end=int(end), budget=int(budget),
                                       before=live, after=lanes(state), stats_build_ms=ms,
                                       **summarize(buf, n, slots, culled(tb))))

            render(launch)
            for row in per_launch:  # the design's renders in turns on its first line
                print(json.dumps(dict(part="persist", case=label, design=d, library=lib,
                                      main_path_library=main_library,
                                      stats_build=lib_info, image_equals_registers=same[d],
                                      main_build_turns=turns[d] if row["launch"] == 0 else None,
                                      **row, card=gpu)), flush=True)

    def mono_case(label, sc, morton):
        """Frame 0 of ``sc`` through ``cuda_mono`` and ``cuda_cost`` in
        both grids: timed in turns, then once through each stats build."""
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        planes, px, py = ci.primary_lanes(st, cfg, 0)
        if morton:
            perm = morton_layout(cfg.width, cfg.height, dev)[0]
            planes, px, py = tuple(p[perm] for p in planes), px[perm], py[perm]
        args = (*planes, px, py, 0, tb)
        n = cfg.width * cfg.height
        for v in range(2):
            infos.append(dict(kernel="mono", case=label, **kernel_info("mono", tb, variant=v)))
        launch = {}
        for d, (lib, _) in MONO_DESIGNS.items():
            launch[(d, "mono")] = (lambda lib=lib: mk.run_mono_variant(lib, *args)) if lib else (
                lambda: mk.run_mono(*args))
            launch[(d, "cost")] = (lambda lib=lib: mk.run_cost_variant(lib, *args)) if lib else (
                lambda: mk.run_cost(*args))
        outs = {key: fn() for key, fn in launch.items()}  # load and warm each library
        for d in MONO_DESIGNS:
            rad, cost = outs[(d, "cost")]
            if not (torch.equal(outs[(d, "mono")], outs[(next(iter(MONO_DESIGNS)), "mono")])
                    and torch.equal(rad, outs[(d, "mono")])
                    and torch.equal(cost, outs[(next(iter(MONO_DESIGNS)), "cost")][1])):
                raise AssertionError(f"{label}: the mono designs disagree")
        cost = outs[(next(iter(MONO_DESIGNS)), "cost")][1]
        del outs
        turns = {key: [] for key in launch}
        for d in (*MONO_DESIGNS, *reversed(MONO_DESIGNS)):
            for kind in ("mono", "cost"):
                turns[(d, kind)].append(timed(lambda: [launch[(d, kind)]() for _ in range(5)]) / 5)
        for d, (_, lib) in MONO_DESIGNS.items():
            lib_info = kernel_info("mono", tb, lib, variant=0)
            buf = _buffers(n, dev)
            _bind(build.load(lib), buf, n)
            ms = timed(lambda: mk.run_mono_variant(lib, *args))
            got = summarize(buf, n, lib_info["blocks_per_sm"] * sms, culled(tb))
            # the frame's bound: its live iterations (the cost plane) at the
            # clusters its traces need
            walk = dict(visited_fraction=got["walk_nearest"]["visited_fraction"],
                        visited_fraction_shadow=got["walk_shadow"]["visited_fraction"]
                        ) if "walk_nearest" in got else {}
            ops = flops.kernel_ops(cfg, st.obj_types, cfg.n_materials, clusters=tb.clusters,
                                   **walk).per_lane_bounce * float(cost.sum())
            b_ms, b_by = flops.bound_ms(ops, n * (32 + 4 * cfg.n_samples))
            print(json.dumps(dict(
                part="mono", case=label, design=d, library=lib, stats_build=lib_info,
                stats_build_ms=ms, main_build_turns_ms={k: turns[(d, k)] for k in ("mono", "cost")},
                bound_ms=b_ms, bound_by=b_by, **got, card=gpu)), flush=True)

    if "persist" in args.only:
        persist_case("cornell512 persist render", scene(presets.cornell_box, 512, 512, 30))
        persist_case("mesh 512x512 persist render", scene(presets.mesh_demo, 512, 512, 30))
        # its records stream from global memory
        persist_case("mesh5k 512x512 10 iterations persist render",
                     scene(presets.mesh5k, 512, 512, 30, 10))
        prism = presets.prism(n_samples=64)  # bench.py:84-87, uncut
        prism.width, prism.height = 800, 600
        prism.nbr_of_ray_bounces, prism.nbr_of_iterations = 8, 200
        persist_case("prism 800x600 persist render", prism, designs={
            "parent: spectral state in registers": ("persist_fx_reg", None),
            "spectral state in shared memory": ("persist_fx", None)})
    if "persist_tables" in args.only:
        def field(n, samples):
            sc = presets.sphere_field(n, n_samples=samples)
            sc.width, sc.height, sc.nbr_of_iterations = 512, 512, 30
            return sc

        alone = {d: (lib, None) for d, (lib, _) in PERSIST_DESIGNS.items()}
        mesh64 = presets.mesh_demo(n_samples=64)
        mesh64.width, mesh64.height, mesh64.nbr_of_ray_bounces = 512, 512, 30
        persist_case("mesh64 512x512 persist render", mesh64, designs={
            "parent: spectral state in registers": ("persist_tri_reg", None),
            "spectral state in shared memory": ("persist_tri", None)})
        persist_case("sphere_field(1000) 512x512 S=64 30 iterations persist render",
                     field(1000, 64), alone)
        for samples in (32, 64):
            persist_case(f"sphere_field(2400) 512x512 S={samples} 30 iterations persist render",
                         field(2400, samples), alone)
    if "mono" in args.only:
        mono_case("cornell512 frame 0", scene(presets.cornell_box, 512, 512, 30), False)
        mono_case("mesh 512x512 frame 0 Morton", scene(presets.mesh_demo, 512, 512, 30), True)
    if {"persist", "persist_tables", "mono"} & set(args.only):
        # every instantiation of both kernels (persist's in the main and
        # the register library), at the tables of a scene of its kind and S
        for samples in (8, 16, 32, 64):
            wide = "" if samples in mk.DEFAULT_TRIANGLE_SAMPLES else "_tri"
            kinds = {(0, 0, ""): presets.cornell_box, (1, 0, ""): presets.sphere_field,
                     (0, 1, wide): presets.mesh_demo, (1, 1, wide): presets.mesh_demo}
            for (many, tri, suffix), maker in kinds.items():
                k_tb = mk.pack_tables(*flatten_scene(scene_of_s(maker, samples), dev))
                libs = {"persist": (f"persist{suffix}", f"persist{suffix}_reg"),
                        "mono": (f"mono{suffix}",)}
                for source, forms in (("persist", range(3)), ("mono", range(2))):
                    for lib in libs[source]:
                        for v in forms:
                            # mono at S = 64 in both builds (the bins in
                            # registers and in shared memory)
                            builds = (False, True) if source == "mono" and samples == 64 else (
                                None,)
                            for sh in builds:
                                infos.append(dict(kernel=source, library=lib,
                                                  every_instantiation=True,
                                                  **kernel_info(source, k_tb, lib, variant=v,
                                                                samples=samples, many=many,
                                                                tri=tri, shared=sh)))
                            if many and source == "persist" and v == 0:
                                # the largest tables whose records stay in
                                # shared memory
                                infos.append(dict(kernel=source, library=lib, at_packed_limit=True,
                                                  **kernel_info(source, k_tb, lib, variant=0,
                                                         samples=samples, many=many, tri=tri,
                                                         smem=mk.PACKED_SMEM_LIMIT)))
    ptxas = {src: [ln.strip() for ln in build.build_log(src).splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for src in ("regen", "seg", "persist", "persist_reg", "mono")
             if src in build.SOURCES or src in libs}
    print(json.dumps(dict(part="kernel_info", sms=sms, instantiations=infos,
                          ptxas=ptxas, card=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
