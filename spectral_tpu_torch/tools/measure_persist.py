"""Measure the persist path against the regeneration path on one GPU.

    python -m spectral_tpu_torch.tools.measure_persist [--runs 5] [--trace-dir DIR]

On cornell512 (the Cornell box at 512x512, 32 wavelengths, 30 bounces,
100 iterations) it prints one JSON line per part:

1. ``one_launch``: one ``cuda_persist`` launch at the default budget, in
   the free-running, lane-stop (all-zero mask) and ring (W = 128, frames
   1-99 resident) variants, against one ``cuda_regen`` launch of 100
   frames and one ``cuda_mono`` and ``cuda_cost`` frame, in turns,
   CUDA-event times. Each row has the kernel's ms, the
   mean completed frames per lane, ms per completed frame, and the rate of
   live path iterations: the per-frame path costs of ``cuda_cost`` summed
   over the frames each lane completed, per second. Iterations that idle
   lanes spend waiting, and the persist lanes' unfinished last frame, are
   not counted. A free-running restart traces its pixel from in-kernel
   raygen, ulps from the host raygen the costs come from, so its count is
   an estimate; the regen and ring counts are exact.
   ``many_object``: at the 1000-sphere field (1024x768, 8 bounces), one
   ``cuda_regen`` launch of 100 frames on Morton lanes, ``cuda_seg`` over
   bounces [0, 2) of the full wavefront and over [2, 8) of its
   survivors, 3 times each in turns.
2. ``seconds_per_frame``: ``Renderer.render()`` wall time over 100 frames
   for regen, persist at the default budget and persist in a single
   launch (budget 3,000), ``--runs`` times each, in turns.
3. ``profile_persist`` / ``profile_regen``: two renders of each without
   the profiler (seconds per frame; the first warms up), then one under
   ``torch.profiler``: the window's wall ms (``WINDOW``), device-busy ms
   (the union of the kernels' spans inside it) and the top device-time
   ops. With
   ``--trace-dir`` the Chrome traces are written there.

Every line carries the card's name and power limit from ``nvidia-smi``.
Needs one CUDA GPU; builds the kernels at first use. ``--runs 0`` skips
part 2. The tool also times an older checkout of the package (from its
persist slice on; ``run_regen`` in either signature): run it as a file
with that checkout first on ``PYTHONPATH``, which then builds and times
its own kernels (compare two trees within one machine, in turns).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# The host span around the profiled work: the base of the busy share
WINDOW = "measure.window"


def busy_ms(events) -> tuple[float, float]:
    """The card's busy ms inside the profiled window, and the window's ms,
    from a profile's ``events()``. The window is the host span of
    ``record_function(WINDOW)`` around the measured work, so the
    host-only stretches at either end count as idle; busy is the union of
    the card's kernels and copies clipped to it. The window's annotation,
    which the profiler copies onto the card's timeline, is no work and is
    left out."""
    import torch

    window, spans = None, []
    for e in events:
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name == WINDOW:
            if not on_card:
                window = (e.time_range.start, e.time_range.end)
        elif on_card:
            spans.append((e.time_range.start, e.time_range.end))
    if window is None:
        raise ValueError(f"the profile holds no {WINDOW!r} span")
    lo, hi = window
    busy, cur_s, cur_e = 0.0, lo, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if s >= e:
            continue
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1e3, (hi - lo) / 1e3


def _regen_args(mk, ci, st, cfg, tb, k, lanes=None, perm=None) -> tuple:
    """``run_regen``'s arguments for K frames from frame 0 in the package
    on the path: lane coordinates and the camera and Hammersley tables
    where its kernel generates the primaries (``ci.regen_args``), else
    the frame-0 planes and the direction planes of frames 1..K-1 (the
    earlier signature), permuted by ``perm`` when given."""
    import torch

    if hasattr(ci, "regen_args"):
        return (*ci.regen_args(st, cfg, 0, k, perm), tb)
    lanes = lanes or [ci.primary_lanes(st, cfg, f) for f in range(k)]
    planes, px, py = lanes[0]
    dirs = [torch.stack([lanes[f][0][3 + i] for f in range(1, k)]) for i in range(3)]
    if perm is not None:
        planes = tuple(p[perm] for p in planes)
        px, py = px[perm], py[perm]
        dirs = [d[:, perm].contiguous() for d in dirs]
    return (*planes, px, py, 0, *dirs, tb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=5, help="renders per path in part 2")
    ap.add_argument("--trace-dir", help="write the profiler's Chrome traces here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from spectral_tpu_torch import presets
    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.render import cuda_integrator as ci
    from spectral_tpu_torch.render.camera import camera_basis_table
    from spectral_tpu_torch.render.layout import morton_layout
    from spectral_tpu_torch.render.renderer import Renderer
    from spectral_tpu_torch.scene.flatten import flatten_scene

    if not torch.cuda.is_available():
        print("measure_persist needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = card()
    frames, bounces = 100, 30

    def scene():
        sc = presets.cornell_box(n_samples=32)
        sc.width = sc.height = 512
        sc.nbr_of_ray_bounces, sc.nbr_of_iterations = bounces, frames
        return sc

    def timed(fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    st, cfg = flatten_scene(scene(), dev)
    tb = mk.pack_tables(st, cfg)
    n = cfg.width * cfg.height

    # ---- 1. one launch of each variant against one regen launch
    lanes = [ci.primary_lanes(st, cfg, f) for f in range(frames)]
    cost = torch.stack([mk.run_cost(*planes, px, py, f, tb)[1]
                        for f, (planes, px, py) in enumerate(lanes)])  # [frames, n]
    cum_cost = torch.cumsum(cost.double(), dim=0)
    budget = max(8, round(64 * float(cost[0].mean())))
    planes, px, py = lanes[0]
    regen_args = _regen_args(mk, ci, st, cfg, tb, frames, lanes)
    cam = camera_basis_table(st, cfg)
    ring = tuple(torch.stack([lanes[f][0][3 + i] if 0 < f < frames
                              else torch.zeros(n, device=dev) for f in range(128)])
                 for i in range(3))  # slot f holds frame f's directions
    del lanes

    def live_iterations(done):
        """Sum of the per-frame path costs over each lane's completed frames."""
        idx = (done.long() - 1).clamp_min(0)
        got = cum_cost.gather(0, idx[None, :])[0]
        return float(torch.where(done > 0, got, torch.zeros_like(got)).sum())

    variants = {  # name: (camera table, variant arguments)
        "free": (cam, {}),
        "stop0": (cam, dict(stop=torch.zeros(n, device=dev))),
        "ring128": (tb.cam, dict(ring=ring)),
    }
    mk.run_regen(*regen_args)  # build, and load each kernel before its timed launches
    mk.run_mono(*planes, px, py, 0, tb)
    mk.run_cost(*planes, px, py, 0, tb)
    for cam_t, kw in variants.values():
        mk.run_persist(ci.persist_init(st, cfg), frames, frames, tb, cam_t, budget=8, **kw)
    rows = []
    for rep in range(3):
        for name, (cam_t, kw) in variants.items():
            state = ci.persist_init(st, cfg)
            ms, _ = timed(lambda: mk.run_persist(state, frames, frames, tb, cam_t,
                                                 budget=budget, **kw))
            done = ci.completed_frames(state)
            rows.append(dict(variant=name, rep=rep, ms=ms,
                             frames_per_lane=float(done.float().mean()),
                             ms_per_frame=ms / float(done.float().mean()),
                             g_live_iterations_per_s=live_iterations(done) / ms / 1e6))
        ms, _ = timed(lambda: mk.run_regen(*regen_args))
        rows.append(dict(variant="regen K=100", rep=rep, ms=ms, frames_per_lane=frames,
                         ms_per_frame=ms / frames,
                         g_live_iterations_per_s=float(cum_cost[-1].sum()) / ms / 1e6))
        ms, _ = timed(lambda: mk.run_mono(*planes, px, py, 0, tb))
        rows.append(dict(variant="mono", rep=rep, ms=ms, frames_per_lane=1, ms_per_frame=ms,
                         g_live_iterations_per_s=float(cost[0].sum()) / ms / 1e6))
        ms, _ = timed(lambda: mk.run_cost(*planes, px, py, 0, tb))
        rows.append(dict(variant="cost", rep=rep, ms=ms, frames_per_lane=1, ms_per_frame=ms,
                         g_live_iterations_per_s=float(cost[0].sum()) / ms / 1e6))
    print(json.dumps(dict(part="one_launch", package=str(Path(mk.__file__).parents[1]),
                          budget=budget,
                          mean_cost_frame0=float(cost[0].mean()),
                          rows=rows, card=gpu)), flush=True)
    del regen_args, ring, cost, cum_cost, variants

    # ---- 1b. the many-object launches at spheres1000: cuda_regen K = 100 on
    # Morton lanes, cuda_seg [0, 2) on the full wavefront and [2, 8) on its
    # survivors (ascending, as the cascade takes them)
    sph = presets.sphere_field(n_samples=32)
    sph.width, sph.height = 1024, 768
    sph.nbr_of_ray_bounces, sph.nbr_of_iterations = 8, frames
    s_st, s_cfg = flatten_scene(sph, dev)
    s_tb = mk.pack_tables(s_st, s_cfg)
    perm = morton_layout(s_cfg.width, s_cfg.height, dev)[0]
    s_args = _regen_args(mk, ci, s_st, s_cfg, s_tb, frames, None, perm)
    mk.run_regen(*s_args)
    wf0 = ci.frame_wavefront(s_st, s_cfg, 0)
    mk.run_seg(wf0, 0, 2, 0, s_tb)
    tails = {"ascending": ci._gather(wf0, torch.nonzero(wf0.alive > 0)[:, 0])}
    s_rows = []
    for rep in range(3):
        ms, _ = timed(lambda: mk.run_regen(*s_args))
        s_rows.append(dict(kernel="regen K=100 Morton", rep=rep, ms=ms))
        wf = ci.frame_wavefront(s_st, s_cfg, 0)
        ms, _ = timed(lambda: mk.run_seg(wf, 0, 2, 0, s_tb))
        s_rows.append(dict(kernel="seg [0, 2)", rep=rep, ms=ms))
        for name, tail in tails.items():
            wf = ci._gather(tail, torch.arange(tail.ox.shape[0], device=dev))
            ms, _ = timed(lambda: mk.run_seg(wf, 2, 8, 0, s_tb))
            s_rows.append(dict(kernel=f"seg [2, 8) {name}", rep=rep, ms=ms,
                               lanes=wf.ox.shape[0]))
    print(json.dumps(dict(part="many_object", package=str(Path(mk.__file__).parents[1]),
                          config="sphere_field(1000) 1024x768 S=32 8 bounces",
                          rows=s_rows, card=gpu)), flush=True)
    del s_args, wf0, tails, wf, s_tb, s_st

    # ---- 2. seconds per frame, the three renders in turns
    kinds = {"regen": {}, "persist": dict(persist=True),
             "persist_single": dict(persist=True, persist_budget=frames * bounces)}

    def render(kw):
        r = Renderer(scene(), device="cuda", **kw)
        torch.cuda.synchronize()
        t = time.monotonic()
        r.render()
        return (time.monotonic() - t) / frames

    spread = {key: [] for key in kinds}
    for _ in range(args.runs):
        for key, kw in kinds.items():
            spread[key].append(render(kw))
    print(json.dumps(dict(part="seconds_per_frame", runs=spread, card=gpu)), flush=True)

    # ---- 3. device-busy share under the profiler, after a warm render
    for key in ("persist", "regen"):
        unprofiled = [render(kinds[key]) for _ in range(2)]  # the first warms up
        r = Renderer(scene(), device="cuda", **kinds[key])
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof,
              record_function(WINDOW)):
            r.render()
            torch.cuda.synchronize()
        busy, wall_ms = busy_ms(prof.events())
        top = sorted((k for k in prof.key_averages() if k.key != WINDOW),
                     key=lambda k: -k.device_time_total)[:8]
        print(json.dumps(dict(
            part=f"profile_{key}", seconds_per_frame_unprofiled=unprofiled,
            wall_ms=wall_ms, device_busy_ms=busy, busy_share_of_wall=busy / wall_ms,
            top=[(k.key[:60], k.device_time_total / 1e3, k.count) for k in top],
            card=gpu)), flush=True)
        if args.trace_dir:
            Path(args.trace_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(args.trace_dir) / f"trace_{key}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
