"""Where the regeneration and segment kernels lose their lanes, on one GPU.

    python -m spectral_tpu_torch.tools.lane_stats [--only cornell512 spheres1000 mesh mesh5k seg]

Builds the diagnostic libraries of ``regen.cu`` and ``seg.cu`` with
``-DSPECTRAL_STATS`` (``runtime/build.py``: ``VARIANTS``; the render
paths never load them) and launches them at the main paths' shapes:
``cuda_regen`` at cornell512 (512x512, 32 wavelengths, 30 bounces, K =
100, row-major lanes), spheres1000 (1024x768, 8 bounces, K = 100, Morton
lanes), mesh (512x512, 30 bounces, K = 100, Morton lanes) and mesh5k
(the same at K = 10), each in the shipped design and in the earlier
design's grid (``regen_parent_stats``, one lane per pixel), with both
main builds timed in turns; ``cuda_seg`` at spheres1000 over bounces
[0, 2) of the full wavefront and [2, 8) of the compacted survivors
(``cuda_integrator.compact_live``), these in three lane orders, the
cascade's ascending one and two that were measured and not kept
(``ray_order``, and it with each block's warps interleaved), their main
builds timed in turns too. Every thread
records its live bounce iterations, its start and end time
(``globaltimer``) and its walk counters, every block its SM. One JSON
line per launch:

- ``lane_loop``: the SIMT efficiency of the lane loop, live lane
  iterations over the iterations its warps issue (32 times the warp's
  busiest lane) and over those its blocks hold (128 times the block's
  busiest lane);
- ``blocks``: the resident blocks the card holds (the occupancy API), the
  waves, the makespan, the share of SM slot time the blocks held, and the
  tail: the share of the makespan after the running blocks fell below
  90% of the slots;
- ``walk``: per nearest-hit trace and per shadow ray, the culled runs
  (clusters) the lane needs and its warp visits, their SIMT efficiency
  (member tests needed over those run), and ``visited_fraction``: the
  share of clusters a trace needs, the input of ``flops.kernel_ops``;
- ``bound_ms``: the least time of the launch (``flops.bound_ms``): its
  live iterations at ``kernel_ops``' count with the measured visited
  fractions, or its pixel coordinates in and radiance out over HBM.

A last line, ``kernel_info``, gives the registers, local bytes and
resident blocks per SM of every instantiation these paths run, from
the main libraries (``spectral_regen_info``, ``spectral_seg_info``), and
the ``nvcc -Xptxas -v`` lines of their builds. The stats build's own
times are longer than the main build's (counters in shared memory): read
its shares, not its milliseconds. Every line names the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

SCENES = ("cornell512", "spheres1000", "mesh", "mesh5k", "seg")
# the regeneration designs: (library timed, its stats build); None: the
# main library
DESIGNS = {
    "parent: one lane per pixel": ("regen_parent", "regen_parent_stats"),
    "resident grid": (None, "regen_stats"),
}


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
                walk=torch.zeros(10 * threads, dtype=i32, device=dev))


def summarize(buf: dict, threads: int, slots: int, n_culled: int) -> dict:
    """The lane-loop, block and walk readings of one stats launch (host
    arithmetic on the per-thread record)."""
    import numpy as np

    t1 = buf["t1"].cpu().numpy()
    threads = min(threads, (int(np.nonzero(t1 > 0)[0].max()) // 128 + 1) * 128)  # launched
    t1 = t1[:threads]
    it = buf["iters"].cpu().numpy().astype(np.int64)[:threads]
    t0 = buf["t0"].cpu().numpy()[:threads]
    walk = buf["walk"].cpu().numpy().astype(np.int64).reshape(10, -1)[:, :threads]
    pad = (-threads) % 128
    itp = np.concatenate([it, np.zeros(pad, np.int64)])
    warp_max = itp.reshape(-1, 32).max(axis=1)
    block_max = itp.reshape(-1, 128).max(axis=1)
    live = float(it.sum())
    lane_loop = dict(live_iterations=live,
                     simt_efficiency_warp=live / float(32 * warp_max.sum()),
                     simt_efficiency_block=live / float(128 * block_max.sum()),
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
    blocks = dict(grid_blocks=n_blocks, resident_slots=slots,
                  waves=n_blocks / slots, makespan_ms=makespan / 1e6,
                  slot_time_held=held / (slots * makespan),
                  tail_share=(t_hi - tail_from) / makespan,
                  block_ms_min=float((end[ok] - start[ok]).min()) / 1e6,
                  block_ms_max=float((end[ok] - start[ok]).max()) / 1e6,
                  sms_seen=int(len(np.unique(buf["smid"].cpu().numpy()[: n_blocks]))))
    out = dict(lane_loop=lane_loop, blocks=blocks)
    if n_culled:
        w = walk.sum(axis=1).astype(float)
        for name, base in (("nearest", 0), ("shadow", 5)):
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
                simt_efficiency=w[base + 3] / max(w[base + 4], 1.0))
    return out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=list(SCENES), choices=SCENES)
    args = ap.parse_args(argv)

    import torch

    from spectral_tpu_torch import presets
    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.render import cuda_integrator as ci
    from spectral_tpu_torch.render.layout import morton_layout
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
    libs = {lib for pair in DESIGNS.values() for lib in pair if lib} | {"seg_stats"}
    build.build_all(build.SOURCES + tuple(sorted(libs)))

    def info(source, tb, library=None):
        fn = getattr(build.load(library or source), f"spectral_{source}_info")
        out = (ctypes.c_int * 3)()
        err = fn(tb.config.n_samples, int(tb.many_objects()), tb.triangles,
                 tb.smem_bytes(), out)
        if err:
            raise RuntimeError(f"spectral_{source}_info: cudaError_t {err}")
        return dict(blocks_per_sm=out[0], registers=out[1], local_bytes=out[2],
                    smem_bytes=tb.smem_bytes(), many=tb.many_objects(),
                    triangles=tb.triangles, samples=tb.config.n_samples)

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
        infos.append(dict(kernel="regen", case=label, **info("regen", tb)))
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
            lib_info = info("regen", tb, lib)
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
        infos.append(dict(kernel="seg", case="spheres1000", **info("seg", tb)))
        slots = info("seg", tb, "seg_stats")["blocks_per_sm"] * sms
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
    ptxas = {src: [ln.strip() for ln in build.build_log(src).splitlines()
                   if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for src in ("regen", "seg")}
    print(json.dumps(dict(part="kernel_info", sms=sms, instantiations=infos,
                          ptxas=ptxas, card=gpu)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
