#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py          # from the repository root

Builds the port's CUDA kernels from ``spectral_tpu_torch/ops/csrc`` (one
``nvcc`` per source, all started together), holds each kernel against its
plain PyTorch version on the card, then drives the port's paths through
``Renderer``, each with every launch count zeroed just before it and read
just after: at the reference's own benchmark size, the Cornell box at
512x512, 32 wavelengths, 30 bounces, 100 iterations, the main path
(regeneration) and the persist path (``persist=True[, adaptive=...]``,
the cost probe and the persistent kernel); and at the 1000-sphere field
(``presets.sphere_field(1000)``: 1,001 objects, 1024x768, 32 wavelengths,
8 bounces, 100 iterations), the many-object main path (clusters,
regeneration, Morton lanes) and the phased path (``phase_split=2``,
``"auto"`` and an explicit cascade, ``cuda_seg``); at the mesh presets
(512x512, 32 wavelengths, 30 bounces: ``mesh``, 345 objects, 100
iterations; ``mesh5k``, 6,405 objects, iterations cut to 10) the triangle
builds of the kernels through the same main path and the persist path,
and those builds against their plain versions at 128x128 (frame 0, and
three regeneration frames on Morton lanes);
the feature builds of the kernels (``-DSPECTRAL_FX``: sky, checker
texture, emission, the dielectric with the hero wavelength) against
their plain versions on the prism, a sky scene, a checker scene and
glass meshes, and the prism preset (``presets.prism()``: 800x600, 64
wavelengths, 8 bounces, 200 iterations) through the main path
(regeneration), the persist path and the phased path;
the Cornell box at the main path's size with a thin lens (aperture
0.05, focus 2.0: depth of field) on regeneration, frame by frame and
phased, each lens kernel path against its plain version and the blur of
the right front box's near edge against the pinhole image; the mesh at
64 wavelengths (the triangle builds at S = 16 and 64) on regeneration
and persist; the opt-in shadow interval (the ``mono_si``/``regen_si``
builds) against its plain version and, on the 1000-sphere field, timed
in turns with the default shadow test;
what follows a render: the Cornell box at the main path's size saved
as a scene file, loaded back and rendered through the CLI's render
command with ``--out x.exr --aovs aov.exr --denoise 5`` (each file read
back against the Renderer's framebuffer, ``compute_aovs`` and
``atrous_denoise`` on the card; the native u8 converter and PNG encoder
against numpy/PIL; the card's AOVs and denoiser against the port's on
the CPU; a denoised 16-iteration render against the 100-iteration one;
the AOVs, the denoiser and the EXR writer timed at 512x512 and
1920x1080), the AOVs of the 1000-sphere field and of mesh5k (time and
peak memory), a 4-frame orbit of the Cornell box (each frame equal to a
Renderer of that frame alone) and motion blur on ``cuda_mono`` (static
tracks equal to the unblurred render, a moving sphere smeared, a sphere
that leaves its cluster with the clustered walk equal to the flat one,
ms per frame and the device-busy share against the static mono render);
the live render: the Cornell box at the main path's size through
``Renderer(regen_frames=("auto", 16))`` against "auto" (K = 100) in
turns (ms per frame, the device-busy share, the two images), K = 1 and
10 for the share of K = 100's gain, the cost of one ``viewer.update``
and one ``--preview-every`` save; more than 256 materials on
``cuda_regen`` and ``cuda_mono`` against their plain versions
(``sphere_field(300)`` with a material per object, its table in shared
memory, and ``sphere_field(1000)`` at 64 wavelengths, in global memory),
with ms per frame, registers and blocks per SM beside the preset's
materials; the default scene at 160x90, 150 iterations, on 16-frame
chunks against the reference's published image (RMSE under 0.030); and
``python -m spectral_tpu_torch render --serve 0`` on the card, driven
over HTTP (frames, the page's endpoints, an object edit that restarts
the count, an illegal scene refused with 400, the Abort button, and the
checkpoint resumed and served again);
the row-sharded render on one card: cornell512 over ``make_mesh(2)`` and
``make_mesh(4)`` (each slab's ``cuda_regen`` ``torch.equal`` to the
unsharded launch's columns, the images against one slot, ms per frame at
1, 2 and 4 slots) and spheres1000 on Morton lanes per slab (iterations
cut to 10); cornell512 with the lens frame by frame over 2 slots (each
slab's ``cuda_mono`` ``torch.equal`` to its plain version) and cornell512
``persist=True`` over 2 slots (``cuda_cost`` and ``cuda_persist`` on the
slabs, one MIN per launch, the mean within 2% of one slot's); the CLI's
``render --mesh 2`` in two processes sharing the card over gloo and in
one NCCL process, each image against the in-process render;
``render_batch_spmd`` of 4 scenes over 2 slots against their own renders,
and ``frames_per_dispatch=4`` against 1;
and the trace probe at its full shape (196,608 rays, 1,024 spheres)
through its tool, ``python -m spectral_tpu_torch.tools.mxu_trace_probe``
(``cuda_probe_fori``, ``cuda_probe_mma``). ``cuda_regen`` is also held
to the sum of its K frames as ``cuda_mono`` traces them from host
raygen (its kernel generates the primaries itself), and two redesigns
are timed in turns beside the earlier design they replaced, each held
``torch.equal`` to it: ``cuda_seg`` (tables without packed walk records)
at spheres1000, and one ``cuda_persist`` launch (the register build
``persist_reg``: the spectral state in registers, the earlier design) at
the persist path's budget on cornell512, mesh, mesh64
(``persist_tri_reg``), mesh5k and the prism (``persist_fx_reg``). The
two probe kernels at the probe's full shape are held to the plain
version (the loop kernel ``torch.equal``, the tensor-core kernel to
``trace_probe``'s ``MMA_*`` limits). After the build, the
``kernels_regen_bins`` line gives both builds of ``regen_kernel<64,...>``
(the radiance bins in registers and in shared memory) at the hero
frame's tables: registers, spills, blocks per SM, and the build
``megakernel.shared_bins`` takes, which must be the shared one;
one launch at the hero shape (K = 3) is counted as a shared launch and
is ``torch.equal`` to the plain version and to the register build. Prints one JSON line per
phase, then the kernel table, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero and prints no result; so does a machine
without CUDA, or a directory without the rest of the repository. Nothing
here imports jax or the JAX package (checked at the end): the scene
schema and presets are the port's own copies.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import math
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN = dict(width=512, height=512, n_samples=32, bounces=30, iterations=100)
# BASELINE config 4 (bench.py): the 1000-sphere field
SPHERES = dict(n_spheres=1000, width=1024, height=768, n_samples=32, bounces=8,
               iterations=100)
# bench.py's mesh configs: 512x512, 30 bounces, 100 iterations; mesh5k's
# iterations cut to 10 here (one 10-frame regeneration launch); the mesh
# also at 64 wavelengths, the prism's (the triangle builds at S = 64)
MESHES = (("mesh", "mesh", 100, 32), ("mesh5k", "mesh5k", 10, 32), ("mesh64", "mesh", 100, 64))
# BASELINE config 3 (bench.py:84-87): the prism, uncut
PRISM = dict(width=800, height=600, n_samples=64, bounces=8, iterations=200)
# the thin lens of the depth-of-field render: the left back box's front
# face near focus, the right front box about 1.15-1.6 from the camera
LENS = dict(aperture=0.05, focus=2.0)
# edges of the right front box in the 512x512 Cornell image, as
# (rows, first column, last column + 1) of the window the profile is
# averaged over: its nearest vertical edge (the corner about 1.15 from
# the camera, between its lit and its shadowed front face; the lens's
# circle of confusion there is about 16 px) and its left silhouette
# against the floor (about 1.58 away, about 6 px)
EDGES = {"near_edge": ((456, 512), 380, 470), "left_silhouette": ((440, 512), 260, 340)}
BLUR_MIN_PX = 4.0  # the near edge's rise with the lens over the pinhole's
# the prism with no Cauchy term must read a red/blue split under half the
# dispersive limit (0.2 px) on the same measure
CONTROL_LIMIT_PX = 0.1


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def rise_widths(pinhole, image):
    """Each of ``EDGES``' 10-90% rise width in px, in the pinhole image
    and in ``image``: the window's rows averaged into one profile across
    the columns; the edge at the pinhole profile's steepest step (a 3-tap
    smoothing); the profile scaled to 0 and 1 at the medians 10-18 px
    either side of the edge; each level's crossing the one nearest the
    edge, interpolated linearly between the two columns it falls
    between."""
    import numpy as np

    def profile(img, rows, x0, x1):
        return img[rows[0]:rows[1], x0:x1, :3].mean(axis=(0, 2)).astype(np.float64)

    def width(prof, c):
        a, b = np.median(prof[c - 18:c - 10]), np.median(prof[c + 11:c + 19])
        t = (prof - a) / (b - a)

        def crossing(level):
            ks = np.nonzero((t[:-1] < level) != (t[1:] < level))[0]
            k = int(ks[np.argmin(np.abs(ks - c))])
            return k + (level - t[k]) / (t[k + 1] - t[k])

        return float(abs(crossing(0.9) - crossing(0.1)))

    out = {}
    for name, (rows, x0, x1) in EDGES.items():
        pin = profile(pinhole, rows, x0, x1)
        smooth = np.convolve(pin, np.ones(3) / 3, mode="same")
        c = int(np.argmax(np.abs(np.diff(smooth[1:-1])))) + 1
        out[name] = dict(column=x0 + c, pinhole_px=width(pin, c),
                         lens_px=width(profile(image, rows, x0, x1), c))
    return out




def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from spectral_tpu_torch import cli as port_cli
        from spectral_tpu_torch import presets, schema
        from spectral_tpu_torch.ops import megakernel as mk
        from spectral_tpu_torch.ops import trace_probe as tp
        from spectral_tpu_torch.ops.vecmath import Vec3
        from spectral_tpu_torch.ops.geometry import BROADCAST_BUDGET
        from spectral_tpu_torch.parallel.mesh import make_mesh, row_sharding
        from spectral_tpu_torch.render import animation as anim_mod
        from spectral_tpu_torch.render import aov as aov_mod
        from spectral_tpu_torch.render import cuda_integrator as ci
        from spectral_tpu_torch.render import denoise as dn_mod
        from spectral_tpu_torch.render import image as image_mod
        from spectral_tpu_torch.render import integrator as ti
        from spectral_tpu_torch.render.camera import camera_basis_table
        from spectral_tpu_torch.render.color import spectra_to_rgb
        from spectral_tpu_torch.render.layout import morton_layout
        from spectral_tpu_torch.render.renderer import Renderer
        from spectral_tpu_torch.runtime import build, trace
        from spectral_tpu_torch.scene import mesh as tmesh
        from spectral_tpu_torch.scene.flatten import flatten_numpy, flatten_scene
        from spectral_tpu_torch.tools import mxu_trace_probe as probe_tool
        from spectral_tpu_torch.tools import shadow_interval_bench as si_bench
        from spectral_tpu_torch.tools.measure_persist import WINDOW as PROFILE_WINDOW
        from spectral_tpu_torch.tools.measure_persist import busy_ms
        from spectral_tpu_torch.tools.lane_stats import kernel_info
        from spectral_tpu_torch.tools.measure_persist import card as read_card
        from spectral_tpu_torch.utils import flops, sceneio
        from spectral_tpu_torch.utils.viewer import LiveViewer
        from tests import torch_scenes as ts
        from tests.torch_exr import read_exr
        from tests.torch_live import LiveRender, http_post
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = read_card()
    t_all = time.monotonic()

    # ---------------------------------------------------------- 1. environment
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), card=card)

    # ---------------------------------------------------------------- 2. build
    t0 = time.monotonic()
    # from source, one nvcc per library, in parallel: every library a
    # render path loads (the main ones; the feature, wide-triangle, lens,
    # shadow-interval and register builds)
    fx_libs = tuple(build.FEATURE_LIBRARIES)
    build.build_all(build.RENDER_LIBRARIES, force=True)
    build_s = time.monotonic() - t0
    resources = {name: build.kernel_resources(name) for name in build.RENDER_LIBRARIES}
    emit(phase="build", seconds=round(build_s, 3), libraries=list(build.RENDER_LIBRARIES),
         library_seconds={n: build.build_seconds(n) for n in build.RENDER_LIBRARIES},
         kernels=resources, card=card)

    def scene_of(maker, w, h, s, bounces, iters):
        sc = maker(n_samples=s)
        sc.width, sc.height = w, h
        sc.nbr_of_ray_bounces, sc.nbr_of_iterations = bounces, iters
        return sc

    # ------------------------------------------ 2b. cuda_regen's bins at S = 64
    # both builds of regen_kernel<64,0,0,*> at the hero frame's tables
    # (presets.cornell_box, 1920x1080, 64 lambda): blocks per SM and
    # registers (the occupancy API), spills (nvcc's report), and the build
    # megakernel.shared_bins takes there; the S <= 32 instantiations
    # as nvcc reports them (the build line has every library's). Then one
    # launch of the hero shape (30 bounces, K = 3: each lane takes further
    # pixels from the counter) in the build the rule takes, which must be
    # the shared one and counted once, torch.equal to the plain version
    # and to the register build
    t0 = time.monotonic()
    hero_st, hero_cfg = flatten_scene(scene_of(presets.cornell_box, 1920, 1080, 64, 30, 1000),
                                      dev)
    hero_tb = mk.pack_tables(hero_st, hero_cfg)
    regen_nvcc = {r["entry"]: r for r in resources["regen"]}
    regen_builds = {}
    for shared, label in ((0, "registers"), (1, "shared_bins")):
        nv = regen_nvcc[f"regen_kernel<64,0,0,{shared}>"]
        regen_builds[label] = dict(kernel_info("regen", hero_tb, variant=shared),
                                   spill_stores=nv["spill_stores"], spill_loads=nv["spill_loads"])
    takes_shared = mk.shared_bins("regen", "regen", hero_tb)
    assert takes_shared == (regen_builds["shared_bins"]["blocks_per_sm"]
                            > regen_builds["registers"]["blocks_per_sm"]), regen_builds
    assert takes_shared, regen_builds
    hero_args = (*ci.regen_args(hero_st, hero_cfg, 0, 3), hero_tb)
    counted = trace.total("launch.regen_shared_bins")
    hero_got = mk.run_regen(*hero_args)
    counted = trace.total("launch.regen_shared_bins") - counted
    rule = mk.shared_bins
    mk.shared_bins = lambda kernel, library, tables: False  # the register build
    try:
        hero_reg = mk.run_regen(*hero_args)
    finally:
        mk.shared_bins = rule
    hero_bits = dict(shared_launches=counted,
                     equal_plain=bool(torch.equal(hero_got, mk.run_regen_plain(*hero_args))),
                     equal_registers=bool(torch.equal(hero_got, hero_reg)),
                     nonzero=bool(hero_got.abs().max() > 0))
    assert hero_bits == dict(shared_launches=1, equal_plain=True, equal_registers=True,
                             nonzero=True), hero_bits
    emit(phase="kernels_regen_bins", seconds=round(time.monotonic() - t0, 3),
         tables="hero: cornell_box 1920x1080, 64 lambda", builds=regen_builds,
         takes="shared_bins" if takes_shared else "registers",
         hero_launch="1920x1080 b30 K=3", hero_bits=hero_bits,
         regen_s_le_32=[r for r in resources["regen"]
                        if int(r["entry"].split("<")[1].split(",")[0]) <= 32],
         card=card)
    del hero_tb, hero_st, hero_args, hero_got, hero_reg

    def rgb_of(rad, st):
        return spectra_to_rgb(rad.T, st.xyz_weights, st.xyz_to_rgb)

    def mono_pair(sc, frame):
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        planes, px, py = ci.primary_lanes(st, cfg, frame)
        got = mk.run_mono(*planes, px, py, frame, tb)
        want = mk.run_mono_plain(*planes, px, py, frame, tb)
        torch.cuda.synchronize()
        return got, want, st

    def regen_inputs(sc, first, k, perm=None):
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        return (*ci.regen_args(st, cfg, first, k, perm), tb), st

    def morton_regen_inputs(sc, k):
        """``cuda_regen``'s arguments as the Renderer gives a clustered
        scene: K frames from frame 0, lanes in Morton order."""
        return regen_inputs(sc, 0, k, morton_layout(sc.width, sc.height, dev)[0])

    def regen_mono_sum_err(rad, sc, first, k, perm=None):
        """``cuda_regen``'s radiance against the sum of its K frames as
        ``cuda_mono`` traces them from host raygen (the same paths; only
        the summation order differs): the largest error over the scale."""
        st_, cfg_ = flatten_scene(sc, dev)
        tb_ = mk.pack_tables(st_, cfg_)
        total = torch.zeros_like(rad)
        for j in range(first, first + k):
            planes_, px_, py_ = ci.primary_lanes(st_, cfg_, j)
            if perm is not None:
                planes_, px_, py_ = tuple(p[perm] for p in planes_), px_[perm], py_[perm]
            total += mk.run_mono(*planes_, px_, py_, j, tb_)
        err = float((rad - total).abs().max()) / max(1.0, float(total.abs().max()))
        assert err <= 1e-5, ("cuda_regen against the sum of its cuda_mono frames", err)
        return err

    def rel_err(got_rgb, want_rgb):
        scale = max(1.0, float(want_rgb.abs().max()))
        return ((got_rgb - want_rgb).abs().amax(dim=-1) / scale)

    def in_turns(what, new, parent, same):
        """A redesigned kernel and its earlier design (each a timed run
        returning (ms, output)) in turns, after one untimed run of each
        (a library's first launch of a kernel loads it): new, parent,
        parent, new. Every parent output is held to the first new one
        with ``same``. Returns the new output and the turns with both
        means."""
        new(), parent()
        turns, ref = {"new": [], "parent": []}, None
        for key in ("new", "parent", "parent", "new"):
            ms, out = (new if key == "new" else parent)()
            turns[key].append(ms)
            if ref is None:
                ref = out
            elif key == "parent":
                assert same(out, ref), f"{what}: the earlier design differs from the new one"
            del out
        return ref, dict(ms=sum(turns["new"]) / 2, parent_design_ms=sum(turns["parent"]) / 2,
                         turns_ms=turns)

    def persist_turns(what, p_st, p_cfg, p_tb, budget, parent):
        """One free-running persist launch from frame 0 at ``budget``: the
        new design and the ``parent`` library in turns (``in_turns``)."""
        p_cam, frames_ = camera_basis_table(p_st, p_cfg), p_cfg.intended_frames

        def launch(run):
            state = ci.persist_init(p_st, p_cfg)
            ms, _ = cuda_span(lambda: run(state, frames_, frames_, p_tb, p_cam, budget=budget))
            return ms, state

        return in_turns(what, lambda: launch(mk.run_persist),
                        lambda: launch(functools.partial(mk.run_persist_variant, parent)),
                        same_state)[1]

    # ------------------------------- 3. kernels vs plain on the card, small size
    t0 = time.monotonic()
    small = []
    for name in ("default", "cornell"):  # direct only: deterministic
        got, want, st = mono_pair(scene_of(presets.PRESETS[name], 16, 8, 8, 1, 2), 0)
        err = float(rel_err(rgb_of(got, st), rgb_of(want, st)).max())
        small.append(dict(case=f"mono {name} 16x8 b1", max_rel=err, limit=1e-5))
        assert err <= 1e-5, small[-1]
    got, want, st = mono_pair(ts.periscope(schema, presets), 0)
    err = float(rel_err(rgb_of(got, st), rgb_of(want, st)).max())
    small.append(dict(case="mono periscope 12x8 b3", max_rel=err, limit=1e-5))
    assert err <= 1e-5, small[-1]
    for frame in (0, 1):
        got, want, st = mono_pair(scene_of(presets.cornell_box, 16, 8, 8, 3, 2), frame)
        err = rel_err(rgb_of(got, st), rgb_of(want, st))
        flips = float((err > 1e-5).float().mean())
        small.append(dict(case=f"mono cornell 16x8 b3 f{frame}",
                          flipped_fraction=flips, limit=0.15))
        assert flips <= 0.15, small[-1]
    args, st = regen_inputs(ts.regen_scene(presets), 0, 3)
    got = mk.run_regen(*args)
    want = mk.run_regen_plain(*args)
    err = float((rgb_of(got, st) - rgb_of(want, st)).abs().max())
    small.append(dict(case="regen K=3 default 16x128 b4", max_abs=err, limit=1e-4))
    assert err <= 1e-4, small[-1]
    emit(phase="kernels_small", seconds=round(time.monotonic() - t0, 3),
         checks=small, card=card)

    # ---------------- 3a. the persist and cost kernels vs plain, small size
    def persist_drive(sc, budget, ring_w=0, plain=False, stop=None, launches_max=None):
        """One carried state through the persist scheduler's launches."""
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        frames = cfg.intended_frames
        state = ci.persist_init(st, cfg)
        cam = tb.cam if ring_w else camera_basis_table(st, cfg)
        ring, lead = None, frames
        if ring_w:
            ring = tuple(torch.zeros((ring_w, cfg.width * cfg.height), device=dev)
                         for _ in range(3))
            lead = min(ring_w, frames)
            for f in range(1, lead):
                ci.ring_refill(ring, f, st, cfg)
        run = mk.run_persist_plain if plain else mk.run_persist
        n_launch = 0
        while True:
            run(state, lead, frames, tb, cam, ring=ring, stop=stop, budget=budget)
            n_launch += 1
            done = int(ci.min_frames_done(state, stop, frames))
            if done >= frames or n_launch == launches_max:
                break
            while ring_w and lead < min(done + ring_w, frames):
                ci.ring_refill(ring, lead, st, cfg)
                lead += 1
        torch.cuda.synchronize()
        return state, st, cfg, tb, n_launch

    def same_state(a, b):
        return all(torch.equal(x, getattr(b, k)) for k, x in a.planes().items())

    t0 = time.monotonic()
    psmall = []
    ring_sc = ts.regen_scene(presets)
    ring_sc.nbr_of_iterations = 6
    got, st, cfg, tb, nl = persist_drive(ring_sc, 13, ring_w=4)
    want, *_ = persist_drive(ring_sc, 13, ring_w=4, plain=True)
    regen_rad = ci.regen_radiance(st, cfg, 0, 6, tb)
    err = float((got.rad - regen_rad).abs().max())
    psmall.append(dict(case="persist ring W=4 budget 13 default 16x128 b4 6 frames",
                       launches=nl, state_equals_plain=same_state(got, want),
                       max_abs_vs_regen_k6=err, limit=0.0))
    assert same_state(got, want) and torch.equal(got.rad, regen_rad), psmall[-1]
    cb = scene_of(presets.cornell_box, 16, 8, 8, 3, 6)
    split = [persist_drive(cb, b)[0] for b in (11, 64)]
    psmall.append(dict(case="persist free-running cornell 16x8 b3: budget 11 vs 64",
                       bit_identical=same_state(split[0], split[1])))
    assert torch.equal(split[0].rad, split[1].rad) and torch.equal(split[0].fid, split[1].fid)
    for bounces, limit in ((1, 1e-5), (3, 0.15)):
        sc = scene_of(presets.cornell_box, 16, 8, 8, bounces, 6)
        got, st, *_ = persist_drive(sc, 11)
        want, *_ = persist_drive(sc, 11, plain=True)
        err = rel_err(rgb_of(got.rad, st), rgb_of(want.rad, st))
        if bounces == 1:
            psmall.append(dict(case="persist free-running cornell 16x8 b1 vs plain",
                               max_rel=float(err.max()), limit=limit))
            assert float(err.max()) <= limit, psmall[-1]
        else:
            flips = float((err > 1e-5).float().mean())
            psmall.append(dict(case="persist free-running cornell 16x8 b3 vs plain",
                               flipped_fraction=flips, bit_identical=same_state(got, want),
                               limit=limit))
            assert flips <= limit, psmall[-1]
    n_cb = 16 * 8
    zero, *_ = persist_drive(cb, 11, stop=torch.zeros(n_cb, device=dev))
    psmall.append(dict(case="lane-stop, all-zero mask vs free-running",
                       bit_identical=same_state(zero, split[0])))
    assert same_state(zero, split[0]), psmall[-1]
    # checkerboard mask set after launch 1: a stopped lane finishes its
    # in-flight frame and never starts another
    state, st, cfg, tb, _ = persist_drive(cb, 4, launches_max=1)
    fid1 = state.fid.clone()
    lane = torch.arange(n_cb, device=dev)
    stop = ((lane % 16 + lane // 16) % 2).float()
    cam = camera_basis_table(st, cfg)
    for _ in range(8):
        mk.run_persist(state, 6, 6, tb, cam, stop=stop, budget=4)
    held = stop > 0
    frozen = bool(torch.equal(state.fid[held], fid1[held]))
    psmall.append(dict(case="lane-stop, checkerboard set after launch 1",
                       stopped_fids_frozen=frozen,
                       stopped_lanes_dead=bool((state.alive[held] == 0).all()),
                       others_done=int(state.fid[~held].min()) + 1))
    assert frozen and bool((state.alive[held] == 0).all()), psmall[-1]
    for sc, name in ((ts.periscope(schema, presets), "periscope 12x8 b3"),
                     (scene_of(presets.cornell_box, 16, 8, 8, 3, 2), "cornell 16x8 b3")):
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        planes, px, py = ci.primary_lanes(st, cfg, 1)
        rad, cost = mk.run_cost(*planes, px, py, 1, tb)
        prad, pcost = mk.run_cost_plain(*planes, px, py, 1, tb)
        mono = mk.run_mono(*planes, px, py, 1, tb)
        torch.cuda.synchronize()
        psmall.append(dict(case=f"cost {name}", radiance_equals_mono=bool(torch.equal(rad, mono)),
                           cost_equals_plain=bool(torch.equal(cost, pcost)),
                           radiance_max_abs_vs_plain=float((rad - prad).abs().max())))
        assert torch.equal(rad, mono), psmall[-1]
        if name.startswith("periscope"):
            assert torch.equal(cost, pcost) and torch.equal(rad, prad), psmall[-1]
    emit(phase="kernels_persist_small", seconds=round(time.monotonic() - t0, 3),
         checks=psmall, card=card)

    # ------------ 3b. the many-object walk and cuda_seg vs plain, small size
    def field_of(n_spheres, w, h, s, bounces, iters):
        sc = presets.sphere_field(n_spheres=n_spheres, n_samples=s)
        sc.width, sc.height = w, h
        sc.nbr_of_ray_bounces, sc.nbr_of_iterations = bounces, iters
        return sc

    t0 = time.monotonic()
    msmall = []
    for bounces in (1, 3):
        sc = field_of(100, 32, 16, 8, bounces, 4)
        st, cfg = flatten_scene(sc, dev)
        tb = mk.pack_tables(st, cfg)
        flat = mk.pack_tables(st, cfg, accel="none")
        assert tb.clusters is not None and flat.clusters is None
        planes, px, py = ci.primary_lanes(st, cfg, 1)
        mono = mk.run_mono(*planes, px, py, 1, tb)
        checks = dict(
            mono=torch.equal(mono, mk.run_mono_plain(*planes, px, py, 1, tb)),
            mono_flat_walk=torch.equal(mono, mk.run_mono(*planes, px, py, 1, flat)))
        rad, cost = mk.run_cost(*planes, px, py, 1, tb)
        prad, pcost = mk.run_cost_plain(*planes, px, py, 1, tb)
        checks["cost"] = torch.equal(rad, mono) and torch.equal(cost, pcost)
        args, _ = regen_inputs(sc, 1, 3)
        checks["regen"] = torch.equal(mk.run_regen(*args), mk.run_regen_plain(*args))
        got, pst, *_ = persist_drive(sc, 5)
        want = persist_drive(sc, 5, plain=True)[0]
        # free-running restarts recompute raygen on each side: held to the
        # coin-flip envelope beyond one bounce, like the Cornell checks
        persist_flips = float((rel_err(rgb_of(got.rad, pst), rgb_of(want.rad, pst))
                               > 1e-5).float().mean())
        persist_exact = same_state(got, want)
        if bounces == 1:
            checks["persist"] = persist_exact
        wf, pwf = ci.frame_wavefront(st, cfg, 1), ci.frame_wavefront(st, cfg, 1)
        seg_eq = True
        for b0, b1 in ((0, 1), (1, cfg.max_bounces)):
            if b0 < b1:
                mk.run_seg(wf, b0, b1, 1, tb)
                mk.run_seg_plain(pwf, b0, b1, 1, tb)
                seg_eq = seg_eq and same_state(wf, pwf)
        checks["seg"] = seg_eq and torch.equal(wf.rad, mono)
        torch.cuda.synchronize()
        msmall.append(dict(case=f"sphere_field(100) 32x16 S=8 b{bounces}", objects=cfg.n_objects,
                           runs=tb.runs.shape[0], bit_identical=checks,
                           persist_bit_identical=persist_exact,
                           persist_flipped=persist_flips, flipped_limit=0.15))
        assert all(checks.values()) and persist_flips <= 0.15, msmall[-1]
    emit(phase="kernels_many_small", seconds=round(time.monotonic() - t0, 3),
         checks=msmall, card=card)

    # ------- 3b. kernels vs plain at the main path's shapes (512^2, S=32, K=100)
    def cuda_ms(fn, reps, warmup=True):
        if warmup:
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    def envelope(got, want, st):
        # flipped: a lane whose last-ulp self-hit coin fell the other way
        err = rel_err(rgb_of(got, st), rgb_of(want, st))
        flips = float((err > 1e-5).float().mean())
        return flips, float((got - want).abs().max())

    t0 = time.monotonic()
    k_main = MAIN["iterations"]
    # direct only: deterministic, so the kernels must match to rounding
    b1 = scene_of(presets.cornell_box, 512, 512, 32, 1, k_main)
    got, want, st = mono_pair(b1, 0)
    mono_b1_rel = float(rel_err(rgb_of(got, st), rgb_of(want, st)).max())
    assert mono_b1_rel <= 1e-5, ("mono 512^2 b1", mono_b1_rel)
    args, st = regen_inputs(b1, 0, k_main)
    got, want = mk.run_regen(*args), mk.run_regen_plain(*args)
    regen_b1_rel = float(rel_err(rgb_of(got, st), rgb_of(want, st)).max())
    assert regen_b1_rel <= 1e-5, ("regen 512^2 b1 K=100", regen_b1_rel)
    del args, got, want
    # the main config, 30 bounces: timed, and held to the coin-flip envelope
    full = scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], k_main)
    st, cfg = flatten_scene(full, dev)
    tb = mk.pack_tables(st, cfg)
    planes, px, py = ci.primary_lanes(st, cfg, 0)
    mono_ms, got = cuda_ms(lambda: mk.run_mono(*planes, px, py, 0, tb), 5)
    mono_plain_ms, want = cuda_ms(lambda: mk.run_mono_plain(*planes, px, py, 0, tb), 2)
    mono_flips, mono_err = envelope(got, want, st)
    assert mono_flips <= 0.15, ("mono 512^2 b30 flipped", mono_flips)
    args, _ = regen_inputs(full, 0, k_main)
    regen_ms, got = cuda_ms(lambda: mk.run_regen(*args), 2)
    regen_plain_ms, want = cuda_ms(lambda: mk.run_regen_plain(*args), 1, warmup=False)
    regen_flips, regen_err = envelope(got, want, st)
    assert regen_flips <= 0.15, ("regen 512^2 b30 K=100 flipped", regen_flips)
    regen_vs_mono = regen_mono_sum_err(got, full, 0, k_main)
    del args, got, want
    emit(phase="kernels_main_shape", seconds=round(time.monotonic() - t0, 3),
         b1_mono_max_rel=mono_b1_rel, b1_regen_k100_max_rel=regen_b1_rel,
         b1_limit=1e-5, b30_mono_flipped=mono_flips, b30_mono_max_abs=mono_err,
         b30_regen_k100_flipped=regen_flips, b30_regen_k100_max_abs=regen_err,
         b30_regen_k100_vs_sum_of_100_mono_max_rel=regen_vs_mono, sum_of_mono_limit=1e-5,
         flipped_limit=0.15, mono_ms=mono_ms, mono_plain_ms=mono_plain_ms,
         regen_k100_ms=regen_ms, regen_k100_plain_ms=regen_plain_ms, card=card)

    # -------- 3c. persist and cost at the main path's shapes (512^2, S=32)
    t0 = time.monotonic()
    b1_4 = scene_of(presets.cornell_box, 512, 512, 32, 1, 4)
    got, pst, pcfg, ptb, nl = persist_drive(b1_4, 2, ring_w=4)
    ring_b1_equal = bool(torch.equal(got.rad, ci.regen_radiance(pst, pcfg, 0, 4, ptb)))
    assert nl >= 2 and ring_b1_equal, ("persist ring 512^2 b1 vs cuda_regen K=4", nl)
    del got
    # b30: one free-running launch at the main path's default budget
    budget_main = max(8, round(64 * float(ci.probe_path_cost(st, cfg, tb, 1).mean())))
    cam_main = camera_basis_table(st, cfg)

    def persist_once(run, reps, stop=None):
        times = []
        for _ in range(reps):
            state = ci.persist_init(st, cfg)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(state, cfg.intended_frames, cfg.intended_frames, tb, cam_main,
                stop=stop, budget=budget_main)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sum(times) / reps, state

    # the spectral state in shared memory and the earlier design's in
    # registers (persist_reg), in turns, 3 launches a turn
    got, persist_main_turns = in_turns(
        "cuda_persist", lambda: persist_once(mk.run_persist, 3),
        lambda: persist_once(functools.partial(mk.run_persist_variant, "persist_reg"), 3),
        same_state)
    persist_ms = persist_main_turns["ms"]
    persist_plain_ms, want = persist_once(mk.run_persist_plain, 1)
    persist_flips, persist_err = envelope(got.rad, want.rad, st)
    assert persist_flips <= 0.15, ("persist 512^2 b30 flipped", persist_flips)
    persist_frames_one_launch = float(ci.completed_frames(got).float().mean())
    # every iteration of the launch is a bounce or a restart, and a lane
    # restarted fid times from frame 0 (no lane reaches the end here)
    persist_iters = float((budget_main - got.fid.long()).sum())
    # the lane-stop kernel at the same shape: an all-zero mask must leave
    # the free-running launch's state bit for bit; a checkerboard from
    # frame 0 is held to the plain version, and its stopped lanes finish
    # frame 0 and start no other
    n_main = cfg.width * cfg.height
    stop0_ms, stop0 = persist_once(mk.run_persist, 1, stop=torch.zeros(n_main, device=dev))
    stop0_identical = same_state(stop0, got)
    assert stop0_identical, "lane-stop 512^2 b30, zero mask: differs from free-running"
    lane = torch.arange(n_main, device=dev)
    checker = ((lane % cfg.width + lane // cfg.width) % 2).float()
    checker_ms, chk = persist_once(mk.run_persist, 1, stop=checker)
    checker_plain_ms, chk_plain = persist_once(mk.run_persist_plain, 1, stop=checker)
    checker_flips, checker_err = envelope(chk.rad, chk_plain.rad, st)
    held = checker > 0
    checker_held = bool((chk.fid[held] == 0).all() and (chk.alive[held] == 0).all())
    assert checker_flips <= 0.15 and checker_held, (
        "lane-stop 512^2 b30, checkerboard", checker_flips, checker_held)
    del got, want, stop0, chk, chk_plain
    cost_ms, (crad, cost) = cuda_ms(lambda: mk.run_cost(*planes, px, py, 0, tb), 5)
    cost_plain_ms, (prad, pcost) = cuda_ms(
        lambda: mk.run_cost_plain(*planes, px, py, 0, tb), 1, warmup=False)
    mono_rad = mk.run_mono(*planes, px, py, 0, tb)
    torch.cuda.synchronize()
    assert torch.equal(crad, mono_rad), "cuda_cost radiance differs from cuda_mono"
    cost_err = float((crad - prad).abs().max())
    cost_equal = float((cost == pcost).float().mean())
    assert cost_err == 0.0 and cost_equal == 1.0, (
        "cuda_cost 512^2 b30 vs plain", cost_err, cost_equal)
    del crad, prad, mono_rad
    emit(phase="kernels_persist_main_shape", seconds=round(time.monotonic() - t0, 3),
         b1_ring_w4_vs_regen_k4_bit_identical=ring_b1_equal, b1_ring_launches=nl,
         budget=budget_main, b30_persist_flipped=persist_flips,
         b30_persist_max_abs=persist_err, flipped_limit=0.15,
         persist_ms=persist_ms, persist_plain_ms=persist_plain_ms,
         persist_turns=persist_main_turns,
         persist_mean_frames_per_launch=persist_frames_one_launch,
         lane_stop_zero_ms=stop0_ms, lane_stop_zero_bit_identical=stop0_identical,
         lane_stop_checker_ms=checker_ms, lane_stop_checker_plain_ms=checker_plain_ms,
         lane_stop_checker_flipped=checker_flips, lane_stop_checker_max_abs=checker_err,
         lane_stop_checker_stopped_lanes_held=checker_held,
         cost_ms=cost_ms, cost_plain_ms=cost_plain_ms, cost_radiance_max_abs=cost_err,
         cost_share_equal_to_plain=cost_equal, mean_cost=float(cost.mean()), card=card)

    # ------- 3d. cuda_seg at the phased shapes: cornell512, spheres 256x192
    def cuda_span(fn):
        """Run fn once between two CUDA events: (ms, fn's result)."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def split_check(sc, split):
        """The first cuda_seg segment against its plain version (both
        timed), the two-segment driver ``integrate_frame_split`` against
        the cuda_mono frame (bit for bit), and a one-stage cascade sized
        to the live count against the mono frame (float32 summation
        order)."""
        s_st, s_cfg = flatten_scene(sc, dev)
        s_tb = mk.pack_tables(s_st, s_cfg)
        wf = ci.frame_wavefront(s_st, s_cfg, 0)
        ms0, _ = cuda_span(lambda: mk.run_seg(wf, 0, split, 0, s_tb))
        pwf = ci.frame_wavefront(s_st, s_cfg, 0)
        plain0_ms, _ = cuda_span(lambda: mk.run_seg_plain(pwf, 0, split, 0, s_tb))
        seg0_exact = same_state(wf, pwf)
        seg0_err = float((wf.rad - pwf.rad).abs().max())
        live = int((wf.alive > 0).sum())
        mono_rgb = ci.integrate_frame_cuda(s_st, s_cfg, 0, s_tb)
        split_ms, split_rgb = cuda_ms(
            lambda: ci.integrate_frame_split(s_st, s_cfg, 0, split, s_tb), 2)
        split_exact = bool(torch.equal(split_rgb, mono_rgb))
        cap = ci.stage_capacities(((split, live * 5 // 4),), s_cfg.width * s_cfg.height)[0]
        rgb, overflow = ci.integrate_frame_cascade(s_st, s_cfg, 0, ((split, cap),), s_tb)
        scale = max(1.0, float(mono_rgb.abs().max()))
        cascade_rel = float((rgb - mono_rgb).abs().max()) / scale
        # the compacted wavefront's segment, timed on its own
        cwf = ci.frame_wavefront(s_st, s_cfg, 0)
        mk.run_seg(cwf, 0, split, 0, s_tb)
        cwf = ci._gather(cwf, torch.nonzero(cwf.alive > 0)[:, 0])
        ms1c, _ = cuda_span(lambda: mk.run_seg(cwf, split, s_cfg.max_bounces, 0, s_tb))
        out = dict(lanes=s_cfg.width * s_cfg.height, objects=s_cfg.n_objects, split=split,
                   live_after_split=live, seg0_ms=ms0, seg0_plain_ms=plain0_ms,
                   seg0_bit_identical=seg0_exact, seg0_max_abs=seg0_err,
                   split_frame_ms=split_ms, seg1_compacted_ms=ms1c,
                   split_bit_identical_to_mono=split_exact, cascade_capacity=cap,
                   cascade_overflow=bool(overflow), cascade_max_rel=cascade_rel,
                   cascade_limit=1e-6)
        assert seg0_exact and split_exact and not bool(overflow), out
        assert cascade_rel <= 1e-6, out
        return out, (s_st, s_cfg, s_tb)

    t0 = time.monotonic()
    seg_cornell, _ = split_check(full, 2)
    sph256 = field_of(SPHERES["n_spheres"], 256, 192, 32, SPHERES["bounces"],
                      SPHERES["iterations"])
    seg_sph256, (f_st, f_cfg, f_tb) = split_check(sph256, 2)
    f_planes, f_px, f_py = ci.primary_lanes(f_st, f_cfg, 0)
    sph256_mono_ms, f_mono = cuda_ms(lambda: mk.run_mono(*f_planes, f_px, f_py, 0, f_tb), 5)
    sph256_plain_ms, f_plain = cuda_ms(
        lambda: mk.run_mono_plain(*f_planes, f_px, f_py, 0, f_tb), 1, warmup=False)
    sph256_flat_ms, f_flat = cuda_ms(
        lambda: mk.run_mono(*f_planes, f_px, f_py, 0, mk.pack_tables(f_st, f_cfg, "none")), 2)
    sph256_mono_exact = bool(torch.equal(f_mono, f_plain)) and bool(torch.equal(f_mono, f_flat))
    assert sph256_mono_exact, "spheres 256x192: cuda_mono differs from plain or the flat walk"
    del f_mono, f_plain, f_flat
    # cuda_regen's many-object build as the spheres main path runs it:
    # clustered tables, every lane plane permuted to the Morton order the
    # Renderer gives a clustered scene, K = 4 frames
    k_sph = 4
    args, _ = morton_regen_inputs(sph256, k_sph)
    sph256_regen_ms, f_regen = cuda_ms(lambda: mk.run_regen(*args), 2)
    sph256_regen_plain_ms, f_regen_plain = cuda_ms(
        lambda: mk.run_regen_plain(*args), 1, warmup=False)
    sph256_regen_exact = bool(torch.equal(f_regen, f_regen_plain))
    sph256_regen_err = float((f_regen - f_regen_plain).abs().max())
    assert sph256_regen_exact, (
        "spheres 256x192: many-object cuda_regen (K=4, Morton) differs from plain",
        sph256_regen_err)
    sph256_regen_vs_mono = regen_mono_sum_err(f_regen, sph256, 0, k_sph,
                                              morton_layout(256, 192, dev)[0])
    del args, f_regen, f_regen_plain
    emit(phase="kernels_seg_main_shape", seconds=round(time.monotonic() - t0, 3),
         cornell512_b30=seg_cornell, spheres_256x192_b8=seg_sph256,
         spheres_256x192_mono_ms=sph256_mono_ms, spheres_256x192_mono_plain_ms=sph256_plain_ms,
         spheres_256x192_mono_flat_walk_ms=sph256_flat_ms,
         spheres_256x192_mono_bit_identical=sph256_mono_exact,
         spheres_256x192_regen_k4_morton_ms=sph256_regen_ms,
         spheres_256x192_regen_k4_morton_plain_ms=sph256_regen_plain_ms,
         spheres_256x192_regen_k4_morton_bit_identical=sph256_regen_exact,
         spheres_256x192_regen_k4_vs_sum_of_mono_max_rel=sph256_regen_vs_mono, card=card)

    # the feature builds' and the lens's checks, shared by 3e-3g
    def timed_into(times):
        """A ``timed`` hook for ``feature_kernel_checks``: each launch
        alone between two CUDA events, its ms appended under its key."""
        def timed(key, fn):
            ms, out = cuda_span(fn)
            times.setdefault(key, []).append(ms)
            return out
        return timed

    def feature_check(sc, label):
        """Each bounce kernel's feature build from frame 1, bit for bit to
        its plain version (``torch_scenes.feature_kernel_checks``: mono,
        cost, regen K = 3, seg [0, 2) and its compacted tail, lane-stop
        persist over two launches), after one untimed pass that loads
        each kernel; every launch timed alone."""
        f_tb = mk.pack_tables(*flatten_scene(sc, dev))
        ts.feature_kernel_checks(f_tb)
        times = {}
        checks, info = ts.feature_kernel_checks(f_tb, timed=timed_into(times))
        out = dict(case=label, features=f_tb.features, many_objects=f_tb.many_objects(),
                   triangles=f_tb.triangles, **info, ms=times, bit_identical=checks)
        assert all(checks.values()), out
        return out

    # ---------- 3e. the kernels' triangle builds vs plain (the mesh slice)
    def mesh_check(sc, label, persist_budget=None):
        """mono, cost and regen (K = 3) from frame 1, bit for bit to their
        plain versions; for a clustered scene also the flat walk; with a
        budget, the free-running persist kernel and a two-segment cuda_seg
        frame (bit for bit at one bounce; the coin-flip envelope beyond,
        where free-running restarts recompute raygen on each side)."""
        m_st, m_cfg = flatten_scene(sc, dev)
        m_tb = mk.pack_tables(m_st, m_cfg)
        planes_, px_, py_ = ci.primary_lanes(m_st, m_cfg, 1)
        mono_ms_, mono_ = cuda_ms(lambda: mk.run_mono(*planes_, px_, py_, 1, m_tb), 3)
        plain_ms_, plain_ = cuda_ms(
            lambda: mk.run_mono_plain(*planes_, px_, py_, 1, m_tb), 1, warmup=False)
        checks = dict(mono=bool(torch.equal(mono_, plain_)))
        out = dict(case=label, objects=m_cfg.n_objects, runs=m_tb.runs.shape[0],
                   triangles=m_tb.triangles, many_objects=m_tb.many_objects(),
                   mono_ms=mono_ms_, mono_plain_ms=plain_ms_)
        if m_tb.clusters is not None:
            flat_tb = mk.pack_tables(m_st, m_cfg, accel="none")
            out["mono_flat_walk_ms"], flat_ = cuda_ms(
                lambda: mk.run_mono(*planes_, px_, py_, 1, flat_tb), 3)
            checks["clustered_equals_flat"] = bool(torch.equal(mono_, flat_))
        rad_, cost_ = mk.run_cost(*planes_, px_, py_, 1, m_tb)
        prad_, pcost_ = mk.run_cost_plain(*planes_, px_, py_, 1, m_tb)
        checks["cost"] = bool(torch.equal(rad_, mono_) and torch.equal(rad_, prad_)
                              and torch.equal(cost_, pcost_))
        args_, _ = regen_inputs(sc, 1, 3)
        checks["regen"] = bool(torch.equal(mk.run_regen(*args_), mk.run_regen_plain(*args_)))
        if persist_budget is not None:
            wf_, pwf_ = ci.frame_wavefront(m_st, m_cfg, 1), ci.frame_wavefront(m_st, m_cfg, 1)
            for b0, b1 in ((0, 1), (1, m_cfg.max_bounces)):
                if b0 < b1:
                    mk.run_seg(wf_, b0, b1, 1, m_tb)
                    mk.run_seg_plain(pwf_, b0, b1, 1, m_tb)
            checks["seg"] = same_state(wf_, pwf_) and bool(torch.equal(wf_.rad, mono_))
            got_, pst_, *_ = persist_drive(sc, persist_budget)
            want_ = persist_drive(sc, persist_budget, plain=True)[0]
            out["persist_bit_identical"] = same_state(got_, want_)
            out["persist_flipped"] = float((rel_err(rgb_of(got_.rad, pst_), rgb_of(
                want_.rad, pst_)) > 1e-5).float().mean())
            out["persist_flipped_limit"] = 0.15
            if m_cfg.max_bounces == 1:
                checks["persist"] = out["persist_bit_identical"]
            assert out["persist_flipped"] <= 0.15, out
        torch.cuda.synchronize()
        out["bit_identical"] = checks
        assert all(checks.values()), out
        return out

    t0 = time.monotonic()
    tri = []
    for s in (8, 16, 32, 64):  # every S has its triangle builds
        for bounces in (1, 3):
            tri.append(mesh_check(scene_of(presets.mesh_demo, 128, 128, s, bounces, 4),
                                  f"mesh 128x128 S={s} b{bounces}",
                                  persist_budget=5 if s in (32, 64) else None))
    for sub in (0, 1):  # a smooth icosphere: the small-scene and the many-object build
        for bounces in (1, 3):
            sc = ts.smooth_mesh(presets, tmesh, 64, 64, bounces, sub, iters=4)
            tri.append(mesh_check(sc, f"smooth icosphere({sub}) 64x64 S=8 b{bounces}",
                                  persist_budget=5))
    # the feature builds' triangles at S = 16 and 64: glass meshes
    tri_fx = [feature_check(ts.glass_meshes(schema, presets, "mesh", 64, 64, 4, samples=s,
                                            iters=3),
                            f"mesh, glass meshes (transmission 0.9), 64x64 S={s} b4")
              for s in (16, 64)]
    emit(phase="kernels_triangles_small", seconds=round(time.monotonic() - t0, 3),
         checks=tri, feature_checks=tri_fx, card=card)

    # ------ 3f. the feature builds vs plain (sky, checker, emission, glass)
    t0 = time.monotonic()
    feats = []
    for s in (8, 64):
        feats.append(feature_check(scene_of(presets.prism, 64, 48, s, 8, 3),
                                   f"prism 64x48 S={s} b8"))
        assert feats[-1]["survivors_with_hero"] > 0 and feats[-1]["persist_heroes"] > 0, feats[-1]
    feats.append(feature_check(ts.open_sky(schema, 16, 3, 64, 48, iters=3),
                               "open sphere under a sky 64x48 S=16 b3"))
    feats.append(feature_check(ts.textured(schema, presets, 8, 3, 64, 48, iters=3),
                               "default scene, checker floor, 64x48 S=8 b3"))
    feats.append(feature_check(ts.glass_meshes(schema, presets, "mesh", 64, 64, 4,
                                               samples=32, iters=3),
                               "mesh, glass meshes (transmission 0.9), 64x64 S=32 b4"))
    assert feats[-1]["many_objects"] and feats[-1]["triangles"]
    emit(phase="kernels_features_small", seconds=round(time.monotonic() - t0, 3),
         checks=feats, card=card)

    # ------------- 3g. depth of field: each lens kernel path vs plain
    def lens_of(sc):
        return ts.with_lens(sc, **LENS)

    t0 = time.monotonic()
    dof_small = []
    for label, sc in (("cornell 32x16 S=8 b4", scene_of(presets.cornell_box, 32, 16, 8, 4, 4)),
                      ("sphere_field(100) 32x16 S=8 b3", field_of(100, 32, 16, 8, 3, 4)),
                      ("mesh 32x16 S=64 b3", scene_of(presets.mesh_demo, 32, 16, 64, 3, 4)),
                      ("prism 32x24 S=16 b8", scene_of(presets.prism, 32, 24, 16, 8, 4))):
        lens_of(sc)
        d_st, d_cfg = flatten_scene(sc, dev)
        d_tb = mk.pack_tables(d_st, d_cfg)
        perm = (morton_layout(sc.width, sc.height, dev)[0] if d_tb.clusters is not None
                else None)
        # mono, cost and seg on host raygen's lens rays, regen (K = 3) on
        # its lens table, from frame 1
        checks, info = ts.kernel_checks(d_tb, lane_perm=perm, persist_launches=0)
        rad = mk.run_regen(*ci.regen_args(d_st, d_cfg, 0, 3, perm), d_tb)
        dof_small.append(dict(case=f"{label}, lens {LENS}", features=d_tb.features,
                              many_objects=d_tb.many_objects(), triangles=d_tb.triangles,
                              bit_identical=checks, **info,
                              regen_k3_vs_sum_of_mono_max_rel=regen_mono_sum_err(
                                  rad, sc, 0, 3, perm)))
        assert all(checks.values()), dof_small[-1]
    emit(phase="kernels_dof_small", seconds=round(time.monotonic() - t0, 3),
         checks=dof_small, card=card)

    # the lens at the main path's shape (cornell 512^2, S = 32, 30 bounces),
    # frame 0: mono, cost, regen K = 3, seg [0, 2) and its compacted tail
    t0 = time.monotonic()
    full_dof = lens_of(scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], k_main))
    fd_st, fd_cfg = flatten_scene(full_dof, dev)
    fd_tb = mk.pack_tables(fd_st, fd_cfg)
    dof_times = {}
    dof_checks, dof_info = ts.kernel_checks(fd_tb, frame=0, persist_launches=0,
                                            timed=timed_into(dof_times))
    dof_main_shape = dict(case=f"cornell 512x512 S=32 b30, lens {LENS}: frame 0; regen K=3; "
                               "seg [0, 2) and the compacted [2, 30)",
                          **dof_info, ms=dof_times, bit_identical=dof_checks)
    assert all(dof_checks.values()), dof_main_shape
    emit(phase="kernels_dof_main_shape", seconds=round(time.monotonic() - t0, 3),
         **dof_main_shape, card=card)

    # ------------------------------------------- 4. the main path at full size
    # each kernel's launch count in the tracer (runtime/trace.py)
    counters = {"cuda_mono": "launch.mono", "cuda_regen": "launch.regen",
                "cuda_persist": "launch.persist", "cuda_cost": "launch.cost",
                "cuda_seg": "launch.seg", "cuda_probe_fori": "launch.probe_fori",
                "cuda_probe_mma": "launch.probe_mma"}
    launches = dict.fromkeys(counters, 0)

    def count_launches(fn):
        """fn's result and the launches of each kernel while it ran."""
        base = {key: trace.total(c) for key, c in counters.items()}
        out = fn()
        return out, {key: trace.total(c) - base[key] for key, c in counters.items()}

    def main_path_run(sc, regen="auto", render=None, **kw):
        """Build a Renderer, zero every count, render, read the counts."""
        r = Renderer(sc, device="cuda", regen_frames=regen, **kw)
        t = time.monotonic()
        # ends in a device -> host copy
        img, counts = count_launches(lambda: (render or Renderer.render)(r))
        dt = time.monotonic() - t
        for key in launches:
            launches[key] += counts[key]
        return r, img, dt, counts

    def profiled_render(sc, **kw):
        """One more render of ``sc`` under the profiler: (the profiled
        window's wall ms, the device-busy ms of its kernel spans in it)."""
        from torch.profiler import ProfilerActivity, profile, record_function

        r_prof = Renderer(sc, device="cuda", **kw)
        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof,
              record_function(PROFILE_WINDOW)):
            r_prof.render()
            torch.cuda.synchronize()
        busy, wall_ms = busy_ms(prof.events())
        return wall_ms, busy

    def check_image(img, w, h):
        assert img.shape == (h, w, 4), img.shape
        assert np.isfinite(img).all(), "non-finite pixels"
        assert float(img[..., :3].mean()) > 0.0, "black image"
        assert abs(float(img[..., 3].mean()) - 1.0) < 1e-5, "alpha"

    t0 = time.monotonic()
    r, img, dt, counts = main_path_run(full)
    assert r.regen_frames == k_main, r.regen_frames
    assert counts["cuda_regen"] > 0, counts
    check_image(img, 512, 512)
    regen_img = img
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "cornell512.png"
        r.save_image(png)
        png_bytes = png.stat().st_size
    assert png_bytes > 0
    frames = r.next_frame
    _, rays = ti.bounce_loop(
        Vec3(*planes[:3]), Vec3(*planes[3:]), px.long(), py.long(), 0,
        st, cfg, return_stats=True,
    )
    rays_per_frame = float(rays)
    s_per_frame = dt / frames
    emit(phase="main_path", config="cornell 512x512, 32 lambda, 30 bounces, "
         "100 iterations", regen_frames=r.regen_frames, frames=frames,
         seconds=dt, seconds_per_frame=s_per_frame, launches=counts,
         rays_per_frame_plain_f0=rays_per_frame,
         mrays_lambda_per_s=rays_per_frame * cfg.n_samples / s_per_frame / 1e6,
         png_bytes=png_bytes, mean_rgb=float(img[..., :3].mean()), card=card)

    # the Renderer against the plain path on the card, 4 frames
    def plain_render(sc, n):
        pst, pcfg = flatten_scene(sc, dev)
        accum = torch.zeros((pcfg.height, pcfg.width, 4), device=dev)
        for f in range(n):
            accum = ti.accumulate_frame(accum, ti.integrate_frame(pst, pcfg, f), f)
        return accum.cpu().numpy()

    b1_4 = scene_of(presets.cornell_box, 512, 512, 32, 1, 4)
    got = Renderer(b1_4, device="cuda").render()
    want = plain_render(b1_4, 4)
    scale = max(1.0, float(np.abs(want).max()))
    b1_rel = float(np.abs(got - want).max() / scale)
    assert b1_rel <= 1e-5, ("renderer b1 vs plain", b1_rel)
    b30_4 = scene_of(presets.cornell_box, 512, 512, 32, 30, 4)
    t = time.monotonic()
    want = plain_render(b30_4, 4)
    plain_s_per_frame = (time.monotonic() - t) / 4
    got = Renderer(b30_4, device="cuda").render()
    mean_got, mean_want = float(got[..., :3].mean()), float(want[..., :3].mean())
    mean_rel = abs(mean_got - mean_want) / mean_want
    assert mean_rel <= 0.02, ("renderer b30 mean vs plain", mean_got, mean_want)
    emit(phase="main_path_vs_plain", seconds=round(time.monotonic() - t0, 3),
         b1_max_rel=b1_rel, b1_limit=1e-5, b30_mean_kernel=mean_got,
         b30_mean_plain=mean_want, b30_mean_rel=mean_rel, b30_limit=0.02,
         plain_seconds_per_frame=plain_s_per_frame, card=card)

    # ------------- 4b. the persist path at full size (persist=True, adaptive)
    t0 = time.monotonic()
    r, img, dt, counts = main_path_run(full, persist=True)
    info = r.persist_info
    assert counts["cuda_cost"] == 1 and counts["cuda_persist"] > 1, counts
    assert counts["cuda_mono"] == counts["cuda_regen"] == 0, counts
    assert info["frames_done"] >= k_main and not info["aborted"], info
    check_image(img, 512, 512)
    persist_mean = float(img[..., :3].mean())
    regen_mean = float(regen_img[..., :3].mean())
    persist_mean_rel = abs(persist_mean - regen_mean) / regen_mean
    assert persist_mean_rel <= 0.02, ("persist mean vs regen", persist_mean, regen_mean)
    budget_default = info["budget"]
    default_run = dict(budget=budget_default, launches=counts, seconds=dt,
                       seconds_per_frame=dt / k_main)
    # one launch does the whole render
    _, img, dt, counts = main_path_run(full, persist=True,
                                       persist_budget=k_main * MAIN["bounces"])
    check_image(img, 512, 512)
    single_run = dict(budget=k_main * MAIN["bounces"], launches=counts, seconds=dt,
                      seconds_per_frame=dt / k_main)
    # variance-adaptive
    r, img, dt, counts = main_path_run(full, persist=True, adaptive=(16, 0.02, 1e-4))
    info = r.persist_info
    adaptive_run = dict(min_counts=info["min_counts"], mean_counts=info["mean_counts"],
                        max_counts=info["max_counts"], compactions=info["compactions"],
                        launches=counts, seconds=dt)
    assert info["min_counts"] >= 16 and counts["cuda_persist"] > 0, adaptive_run
    check_image(img, 512, 512)
    # abort after launch 2, checkpoint, resume: bit-identical to the
    # uninterrupted render at the same budget (a quarter of the default,
    # so that launch 2 leaves frames to do)
    budget_abort = max(8, budget_default // 4)
    _, persist_img, _, _ = main_path_run(full, persist=True, persist_budget=budget_abort)
    polls = {"n": 0}

    def abort_second():
        polls["n"] += 1
        return polls["n"] >= 2

    r, img, _, _ = main_path_run(full, persist=True, persist_budget=budget_abort,
                                 render=lambda rr: rr.render(abort=abort_second))
    aborted_info = dict(aborted=r.persist_info["aborted"],
                        launches=r.persist_info["launches"],
                        frames_done=r.persist_info["frames_done"])
    assert r.persist_info["aborted"] and r.persist_info["launches"] == 2, aborted_info
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "persist.ckpt.npz"
        r.save_checkpoint(ckpt)
        ckpt_bytes = ckpt.stat().st_size
        r2 = Renderer(full, device="cuda", persist=True, persist_budget=budget_abort)
        r2.load_checkpoint(ckpt)
    resumed = r2.render()
    resume_identical = bool((resumed == persist_img).all())
    assert resume_identical, "resumed persist render differs from the uninterrupted one"
    # regen_sort: pure relabeling of the regeneration lanes
    r, img, _, counts = main_path_run(full, regen_sort=True)
    assert counts["cuda_cost"] == 2 and counts["cuda_regen"] == 1, counts
    sort_rel = float(np.abs(img - regen_img).max() / max(1.0, float(np.abs(regen_img).max())))
    assert sort_rel <= 1e-6, ("regen_sort image vs unsorted", sort_rel)
    rad_sorted = ci.regen_radiance(st, cfg, 0, k_main, tb, r._lane_perm)[:, r._lane_inv]
    sort_rad_identical = bool(torch.equal(rad_sorted, ci.regen_radiance(st, cfg, 0, k_main, tb)))
    assert sort_rad_identical, "regen_sort radiance differs from the unsorted launch"
    del rad_sorted
    emit(phase="persist_path", seconds=round(time.monotonic() - t0, 3),
         config="cornell 512x512, 32 lambda, 30 bounces, 100 iterations, persist=True",
         default_budget=default_run, single_launch=single_run,
         regen_seconds_per_frame=s_per_frame, persist_mean=persist_mean,
         regen_mean=regen_mean, persist_mean_rel=persist_mean_rel, mean_limit=0.02,
         adaptive_16_0p02_1em4=adaptive_run, abort_after_2=aborted_info,
         checkpoint_bytes=ckpt_bytes, resume_bit_identical=resume_identical,
         regen_sort_image_max_rel=sort_rel, regen_sort_limit=1e-6,
         regen_sort_radiance_bit_identical=sort_rad_identical, card=card)

    # ---- 4c. depth of field at full size: regen, frame by frame, phased
    t0 = time.monotonic()
    dof_runs = {}
    r, dof_img, dt, counts = main_path_run(full_dof)
    assert r.regen_frames == k_main and counts["cuda_regen"] == 1, (r.regen_frames, counts)
    check_image(dof_img, 512, 512)
    dof_mean = float(dof_img[..., :3].mean())
    dof_runs["regen"] = dict(seconds=dt, seconds_per_frame=dt / k_main, launches=counts,
                             mean_rgb=dof_mean)
    for label, kw in (("mono", dict(regen=1)), ("phased_auto", dict(phase_split="auto"))):
        rr, img, dt, counts = main_path_run(full_dof, **kw)
        check_image(img, 512, 512)
        mean_rel = abs(float(img[..., :3].mean()) - dof_mean) / dof_mean
        dof_runs[label] = dict(seconds=dt, seconds_per_frame=dt / k_main, launches=counts,
                               mean_rgb=float(img[..., :3].mean()),
                               mean_rel_vs_regen=mean_rel, mean_limit=0.02)
        if label == "mono":
            assert counts["cuda_mono"] == k_main and counts["cuda_regen"] == 0, counts
        else:
            dof_runs[label].update(stages=rr.phase_stages, overflow_frames=rr.overflow_frames)
            assert rr.phase_stages is None or counts["cuda_seg"] > 0, counts
        assert mean_rel <= 0.02, (label, dof_runs[label])
    try:
        Renderer(full_dof, device="cuda", persist=True)
        persist_refused = None
    except ValueError as e:
        persist_refused = str(e)
    assert persist_refused and "persist" in persist_refused, persist_refused
    # rays per frame from the plain frame 0 with the lens, at 512^2 itself
    lp, lpx, lpy = ci.primary_lanes(fd_st, fd_cfg, 0)
    _, d_rays = ti.bounce_loop(Vec3(*lp[:3]), Vec3(*lp[3:]), lpx.long(), lpy.long(), 0,
                               fd_st, fd_cfg, return_stats=True)
    d_rays = float(d_rays)
    # one regeneration launch alone (K = 100, its lens table), and the
    # device-busy share of one more regen render under the profiler
    d_args = ci.regen_args(fd_st, fd_cfg, 0, k_main)
    d_regen_ms, _ = cuda_span(lambda: mk.run_regen(*d_args, fd_tb))
    del d_args
    d_wall_ms, d_busy_ms = profiled_render(full_dof)
    # the lens changed the image, and blurred the right front box
    assert not np.array_equal(dof_img, regen_img), "the lens image is the pinhole image"
    blur = rise_widths(regen_img, dof_img)
    near = blur["near_edge"]
    assert near["lens_px"] - near["pinhole_px"] >= BLUR_MIN_PX, blur
    d_spf = dof_runs["regen"]["seconds_per_frame"]
    emit(phase="dof_main_path",
         config=f"cornell 512x512, 32 lambda, 30 bounces, 100 iterations, lens {LENS}",
         runs=dof_runs, persist_refused=persist_refused,
         rays_per_frame_plain_f0=d_rays,
         mrays_lambda_per_s=d_rays * fd_cfg.n_samples / d_spf / 1e6,
         regen_k100_launch_ms=d_regen_ms, profiled_wall_ms=d_wall_ms,
         device_busy_ms=d_busy_ms, device_busy_share=d_busy_ms / d_wall_ms,
         pinhole_mean_rgb=float(regen_img[..., :3].mean()), rise_widths=blur,
         blur_min_px=BLUR_MIN_PX, seconds=round(time.monotonic() - t0, 3), card=card)

    # ------------------------ 5. ragged tail and single iteration (main path)
    t0 = time.monotonic()
    _, img, _, counts = main_path_run(
        scene_of(presets.cornell_box, 512, 512, 32, 30, 6), regen=4)
    assert counts == {"cuda_mono": 2, "cuda_regen": 1, "cuda_persist": 0, "cuda_cost": 0,
                      "cuda_seg": 0, "cuda_probe_fori": 0, "cuda_probe_mma": 0}, counts
    check_image(img, 512, 512)
    tail_counts = counts
    _, img, _, counts = main_path_run(
        scene_of(presets.default_scene, 320, 240, 32, 30, 1))
    assert counts == {"cuda_mono": 1, "cuda_regen": 0, "cuda_persist": 0, "cuda_cost": 0,
                      "cuda_seg": 0, "cuda_probe_fori": 0, "cuda_probe_mma": 0}, counts
    check_image(img, 320, 240)
    emit(phase="tail_and_single", seconds=round(time.monotonic() - t0, 3),
         cornell_6_iter_k4=tail_counts, default_320x240_1_iter=counts, card=card)

    # the repository's goldens: direct-only 32x24 frames (tests/test_goldens.py)
    for name in ("default", "cornell"):
        data = np.load(ROOT / "tests" / "goldens" / f"{name}_32x24_b1.npz")
        want = data["frames"].astype(np.float32)
        sc = scene_of(presets.PRESETS[name], 32, 24, 32, 1, 4)
        gst, gcfg = flatten_scene(sc, dev)
        got = np.stack([ci.integrate_frame_cuda(gst, gcfg, f).cpu().numpy()
                        for f in range(2)])
        err = np.abs(got - want) / max(1.0, float(np.abs(want).max()))
        assert float(err.max()) < 2e-3 and math.sqrt(float((err**2).mean())) < 2e-4, name
    emit(phase="goldens", checked=["default_32x24_b1", "cornell_32x24_b1"],
         max_rel_limit=2e-3, rmse_limit=2e-4, card=card)

    # -------------------- 6. the 1000-sphere field: the many-object main path
    t0 = time.monotonic()
    sph = field_of(SPHERES["n_spheres"], SPHERES["width"], SPHERES["height"],
                   SPHERES["n_samples"], SPHERES["bounces"], SPHERES["iterations"])
    r, img, dt, counts = main_path_run(sph)
    assert r.regen_frames == SPHERES["iterations"] and r.lane_layout == "morton", (
        r.regen_frames, r.lane_layout)
    assert r.clusters is not None and counts["cuda_regen"] == 1, counts
    check_image(img, SPHERES["width"], SPHERES["height"])
    sph_regen_img = img
    sph_frames = r.next_frame
    sph_s_per_frame = dt / sph_frames
    s_st, s_cfg, s_tb = r.scene_tensors, r.config, r.tables
    # rays per frame from the plain frame 0 at 256x192, the same camera,
    # times 16 (rays per pixel is a per-lane statistic)
    _, f_rays = ti.bounce_loop(Vec3(*f_planes[:3]), Vec3(*f_planes[3:]), f_px.long(),
                               f_py.long(), 0, f_st, f_cfg, return_stats=True)
    sph_rays = float(f_rays) * (s_cfg.width * s_cfg.height) / (f_cfg.width * f_cfg.height)
    # one regeneration launch timed alone, K = 100, Morton lanes
    s_args = ci.regen_args(s_st, s_cfg, 0, SPHERES["iterations"], r._lane_perm)
    sph_regen_ms, _ = cuda_ms(lambda: mk.run_regen(*s_args, s_tb), 2)
    del s_args, _
    s_planes, s_px, s_py = ci.primary_lanes(s_st, s_cfg, 0)
    sph_mono_ms, _ = cuda_ms(lambda: mk.run_mono(*s_planes, s_px, s_py, 0, s_tb), 3)
    emit(phase="spheres_main_path",
         config="sphere_field(1000): 1001 objects, 1024x768, 32 lambda, 8 bounces, "
                "100 iterations", clusters=len(r.clusters[1]), lane_layout=r.lane_layout,
         regen_frames=r.regen_frames, frames=sph_frames, seconds=dt,
         seconds_per_frame=sph_s_per_frame, launches=counts,
         rays_per_frame_plain_f0_scaled_from_256x192=sph_rays,
         mrays_lambda_per_s=sph_rays * s_cfg.n_samples / sph_s_per_frame / 1e6,
         regen_k100_morton_launch_ms=sph_regen_ms,
         mono_ms=sph_mono_ms,
         mean_rgb=float(img[..., :3].mean()), card=card)

    # ------------------------------ 7. the phased path on the 1000-sphere field
    regen_mean = float(sph_regen_img[..., :3].mean())
    phased = {}
    for label, kw in (("split_2", dict(phase_split=2)), ("auto", dict(phase_split="auto"))):
        r, img, dt, counts = main_path_run(sph, **kw)
        check_image(img, SPHERES["width"], SPHERES["height"])
        mean_rel = abs(float(img[..., :3].mean()) - regen_mean) / regen_mean
        phased[label] = dict(stages=r.phase_stages, overflow_frames=r.overflow_frames,
                             launches=counts, seconds=dt,
                             seconds_per_frame=dt / r.next_frame, mean_rel_vs_regen=mean_rel,
                             mean_limit=0.02)
        if r.phase_occupancy is not None:
            phased[label]["occupancy"] = [float(x) for x in r.phase_occupancy]
            occupancy = r.phase_occupancy
        assert mean_rel <= 0.02, (label, phased[label])
        assert r.phase_stages is None or counts["cuda_seg"] > 0, (label, counts)
    # an explicit cascade: splits at bounces 2 and 4, capacities from the
    # probe's occupancy with the reference's 1.7x margin
    n_lanes = SPHERES["width"] * SPHERES["height"]
    caps = tuple(min(n_lanes, int(math.ceil(1.7 * float(occupancy[b]) * n_lanes)))
                 for b in (2, 4))
    r, img, dt, counts = main_path_run(sph, phase_split=(2, 4), phase_capacity=caps)
    check_image(img, SPHERES["width"], SPHERES["height"])
    mean_rel = abs(float(img[..., :3].mean()) - regen_mean) / regen_mean
    phased["cascade_2_4"] = dict(stages=r.phase_stages, overflow_frames=r.overflow_frames,
                                 launches=counts, seconds=dt,
                                 seconds_per_frame=dt / r.next_frame,
                                 mean_rel_vs_regen=mean_rel, mean_limit=0.02)
    assert mean_rel <= 0.02 and counts["cuda_seg"] > 0, phased["cascade_2_4"]
    # cuda_seg alone at the full shape: [0, 2) on the whole wavefront, then
    # [2, 8) on the compacted live lanes (ascending, as the cascade takes
    # them); the first against its plain version. The new walk (packed
    # records) and the earlier one (tables without records) in turns:
    # new, parent, parent, new
    s_unpacked = s_tb.unpacked()
    seg_turns = {"new": [], "parent": []}
    tail_turns = {"new": [], "parent": []}
    for key in ("new", "parent", "parent", "new"):
        tb_k = s_tb if key == "new" else s_unpacked
        wf = ci.frame_wavefront(s_st, s_cfg, 0)
        t_ms, _ = cuda_span(lambda: mk.run_seg(wf, 0, 2, 0, tb_k))
        seg_turns[key].append(t_ms)
        cwf = ci._gather(wf, torch.nonzero(wf.alive > 0)[:, 0])
        t_ms, _ = cuda_span(lambda: mk.run_seg(cwf, 2, SPHERES["bounces"], 0, tb_k))
        tail_turns[key].append(t_ms)
        if key == "new":
            seg_new, tail_new = wf, cwf
        else:
            assert same_state(wf, seg_new) and same_state(cwf, tail_new), (
                "cuda_seg: the earlier walk changed a lane")
    seg_ms = sum(seg_turns["new"]) / 2
    seg_parent_ms = sum(seg_turns["parent"]) / 2
    seg_tail_ms = sum(tail_turns["new"]) / 2
    seg_tail_parent_ms = sum(tail_turns["parent"]) / 2
    wf = seg_new
    pwf = ci.frame_wavefront(s_st, s_cfg, 0)
    seg_plain_ms, _ = cuda_span(lambda: mk.run_seg_plain(pwf, 0, 2, 0, s_tb))
    seg_err = float((wf.rad - pwf.rad).abs().max())
    seg_exact = same_state(wf, pwf)
    assert seg_exact, "cuda_seg [0, 2) at 1024x768 differs from its plain version"
    del pwf, seg_new, tail_new, cwf
    live2 = int((wf.alive > 0).sum())
    emit(phase="spheres_phased", runs=phased, regen_mean=regen_mean,
         seg_0_2_full_ms=seg_ms, seg_0_2_full_plain_ms=seg_plain_ms,
         seg_0_2_bit_identical=seg_exact, live_after_bounce_2=live2,
         seg_2_8_compacted_ms=seg_tail_ms, seg_0_2_turns_ms=seg_turns,
         seg_2_8_turns_ms=tail_turns, seconds=round(time.monotonic() - t0, 3),
         card=card)

    # --------- 7b. the opt-in shadow interval (mono_si, regen_si) vs plain
    t0 = time.monotonic()
    si_checks = []
    for label, sc, k_si in (("sphere_field(100) 32x16 S=8 b3", field_of(100, 32, 16, 8, 3, 4), 3),
                            ("mesh 64x64 S=16 b3", scene_of(presets.mesh_demo, 64, 64, 16, 3, 4),
                             3),
                            ("sphere_field(1000) 256x192 S=32 b8", sph256, 4)):
        si_st, si_cfg = flatten_scene(sc, dev)
        si_tb = mk.with_shadow_interval(mk.pack_tables(si_st, si_cfg))
        planes_, px_, py_ = ci.primary_lanes(si_st, si_cfg, 1)
        mono_ms_, mono_ = cuda_ms(lambda: mk.run_mono(*planes_, px_, py_, 1, si_tb), 2)
        mono_plain_ms_, plain_ = cuda_span(lambda: mk.run_mono_plain(*planes_, px_, py_, 1,
                                                                      si_tb))
        rad_, cost_ = mk.run_cost(*planes_, px_, py_, 1, si_tb)
        prad_, pcost_ = mk.run_cost_plain(*planes_, px_, py_, 1, si_tb)
        args_ = (*ci.regen_args(si_st, si_cfg, 1, k_si,
                                morton_layout(sc.width, sc.height, dev)[0]), si_tb)
        regen_ms_, regen_ = cuda_ms(lambda: mk.run_regen(*args_), 2)
        regen_plain_ms_, rplain_ = cuda_span(lambda: mk.run_regen_plain(*args_))
        checks = dict(mono=bool(torch.equal(mono_, plain_)),
                      cost=bool(torch.equal(rad_, mono_) and torch.equal(rad_, prad_)
                                and torch.equal(cost_, pcost_)),
                      regen=bool(torch.equal(regen_, rplain_)))
        si_checks.append(dict(case=f"{label}, regen K={k_si} Morton lanes", objects=si_cfg.n_objects,
                              triangles=si_tb.triangles, bit_identical=checks,
                              mono_ms=mono_ms_, mono_plain_ms=mono_plain_ms_,
                              regen_ms=regen_ms_, regen_plain_ms=regen_plain_ms_))
        assert all(checks.values()), si_checks[-1]
    del mono_, plain_, regen_, rplain_, args_
    # the 1000-sphere field with and without the option, in turns
    si_timing = si_bench.bench(SPHERES["n_spheres"], SPHERES["iterations"], launches=2)
    assert si_timing["mean_rel"] <= 0.02, si_timing
    emit(phase="shadow_interval", seconds=round(time.monotonic() - t0, 3), checks=si_checks,
         spheres1000_regen_turns=si_timing, mean_limit=0.02, card=card)

    # ------------------------- 8. the mesh presets through the main path
    mesh_runs = {}
    for label, name, iters, n_s in MESHES:
        t0 = time.monotonic()
        sc = scene_of(presets.PRESETS[name], 512, 512, n_s, 30, iters)
        r, img, dt, counts = main_path_run(sc)
        assert r.regen_frames == iters and r.lane_layout == "morton", (
            r.regen_frames, r.lane_layout)
        assert r.tables.triangles == 1 and r.clusters is not None, name
        assert counts["cuda_regen"] == 1, counts
        check_image(img, 512, 512)
        m_st, m_cfg, m_tb = r.scene_tensors, r.config, r.tables
        m_frames = r.next_frame
        m_s_per_frame = dt / m_frames
        # rays per frame from the plain frame 0 at 128x128, the same
        # camera, times 16 (rays per pixel is a per-lane statistic)
        small = scene_of(presets.PRESETS[name], 128, 128, n_s, 30, iters)
        small_st, small_cfg = flatten_scene(small, dev)
        sp, spx, spy = ci.primary_lanes(small_st, small_cfg, 0)
        _, m_rays = ti.bounce_loop(Vec3(*sp[:3]), Vec3(*sp[3:]), spx.long(), spy.long(), 0,
                                   small_st, small_cfg, return_stats=True)
        m_rays = float(m_rays) * 16
        # the triangle kernels as this path runs them (clustered, its S,
        # 30 bounces, Morton lanes for regen), cut to 128x128, against
        # their plain versions bit for bit: cuda_mono frame 0, cuda_regen K = 3
        small_tb = mk.pack_tables(small_st, small_cfg)
        assert small_tb.triangles == 1 and small_tb.clusters is not None, name
        ms128, got = cuda_ms(lambda: mk.run_mono(*sp, spx, spy, 0, small_tb), 2)
        plain_ms128, want = cuda_span(lambda: mk.run_mono_plain(*sp, spx, spy, 0, small_tb))
        mono128 = dict(case=f"{label} 128x128 S={n_s} b30 frame 0", ms=ms128, plain_ms=plain_ms128,
                       bit_identical=bool(torch.equal(got, want)),
                       max_abs=float((got - want).abs().max()))
        assert mono128["bit_identical"], mono128
        args, _ = morton_regen_inputs(small, 3)
        ms128, got = cuda_ms(lambda: mk.run_regen(*args), 2)
        plain_ms128, want = cuda_span(lambda: mk.run_regen_plain(*args))
        regen128 = dict(case=f"{label} 128x128 S={n_s} b30 K=3 Morton lanes", ms=ms128,
                        plain_ms=plain_ms128, bit_identical=bool(torch.equal(got, want)),
                        max_abs=float((got - want).abs().max()),
                        vs_sum_of_mono_max_rel=regen_mono_sum_err(
                            got, small, 0, 3, morton_layout(128, 128, dev)[0]))
        assert regen128["bit_identical"], regen128
        del args, got, want
        m_regen_ms, _ = cuda_span(lambda: ci.regen_radiance(
            m_st, m_cfg, 0, iters, m_tb, r._lane_perm))
        m_planes, m_px, m_py = ci.primary_lanes(m_st, m_cfg, 0)
        m_mono_ms, _ = cuda_ms(lambda: mk.run_mono(*m_planes, m_px, m_py, 0, m_tb), 2)
        # the persist path on the same scene: the image mean within 2%
        pr, pimg, pdt, pcounts = main_path_run(sc, persist=True)
        check_image(pimg, 512, 512)
        assert pcounts["cuda_persist"] > 0 and pcounts["cuda_cost"] == 1, pcounts
        regen_mean = float(img[..., :3].mean())
        persist_mean = float(pimg[..., :3].mean())
        mean_rel = abs(persist_mean - regen_mean) / regen_mean
        assert mean_rel <= 0.02, (label, persist_mean, regen_mean)
        # one persist launch at the path's budget beside the earlier design
        # (the register build, with the wide triangles at S = 64)
        m_persist = persist_turns(
            f"cuda_persist ({label})", m_st, m_cfg, m_tb, pr.persist_info["budget"],
            "persist_reg" if n_s in mk.DEFAULT_TRIANGLE_SAMPLES else "persist_tri_reg")
        m_persist["library"] = mk.persist_library(m_tb)
        mesh_runs[label] = dict(regen_k_launch_ms=m_regen_ms, mono_ms=m_mono_ms,
                               seconds_per_frame=m_s_per_frame, mono_128=mono128,
                               regen_128=regen128, persist_launch=m_persist)
        emit(phase=f"{label}_main_path",
             config=f"presets.{presets.PRESETS[name].__name__}: {m_cfg.n_objects} objects, "
                    f"512x512, {n_s} lambda, 30 bounces, {iters} iterations",
             clusters=len(r.clusters[1]), lane_layout=r.lane_layout,
             regen_frames=r.regen_frames, frames=m_frames, seconds=dt,
             seconds_per_frame=m_s_per_frame, launches=counts,
             rays_per_frame_plain_f0_scaled_from_128x128=m_rays,
             mrays_lambda_per_s=m_rays * m_cfg.n_samples / m_s_per_frame / 1e6,
             regen_launch_ms=m_regen_ms, mono_ms=m_mono_ms, mean_rgb=regen_mean,
             kernels_vs_plain_128=[mono128, regen128],
             persist=dict(seconds=pdt, seconds_per_frame=pdt / iters, launches=pcounts,
                          budget=pr.persist_info["budget"], mean_rgb=persist_mean,
                          mean_rel_vs_regen=mean_rel, mean_limit=0.02,
                          one_launch_turns=m_persist),
             phase_seconds=round(time.monotonic() - t0, 3), card=card)

    # --------- 8b. the prism preset (BASELINE config 3) through the main path
    t0 = time.monotonic()
    prism = scene_of(presets.prism, PRISM["width"], PRISM["height"], PRISM["n_samples"],
                     PRISM["bounces"], PRISM["iterations"])
    r, img, dt, counts = main_path_run(prism)
    p_st, p_cfg, p_tb = r.scene_tensors, r.config, r.tables
    assert p_tb.features and r.regen_frames == 100, (p_tb.features, r.regen_frames)
    assert counts["cuda_regen"] == 2 and counts["cuda_mono"] == 0, counts
    check_image(img, PRISM["width"], PRISM["height"])
    prism_img = img
    p_s_per_frame = dt / r.next_frame
    # rays per frame from the plain frame 0 at 200x150, the same camera,
    # times 16 (rays per pixel is a per-lane statistic)
    small = scene_of(presets.prism, 200, 150, PRISM["n_samples"], PRISM["bounces"],
                     PRISM["iterations"])
    sp_st, sp_cfg = flatten_scene(small, dev)
    sp, spx, spy = ci.primary_lanes(sp_st, sp_cfg, 0)
    _, p_rays = ti.bounce_loop(Vec3(*sp[:3]), Vec3(*sp[3:]), spx.long(), spy.long(), 0,
                               sp_st, sp_cfg, return_stats=True)
    p_rays = float(p_rays) * 16
    # one regeneration launch alone (K = 100) and the live path iterations
    # of its frames (cuda_cost), for the bound
    p_regen_ms, _ = cuda_span(lambda: ci.regen_radiance(p_st, p_cfg, 0, 100, p_tb))
    p_iters = 0.0
    for j in range(100):
        j_planes, j_px, j_py = ci.primary_lanes(p_st, p_cfg, j)
        p_iters += float(mk.run_cost(*j_planes, j_px, j_py, j, p_tb)[1].sum())
    # the device-busy share of one more regen render under the profiler
    p_wall_ms, p_busy_ms = profiled_render(prism)
    # persist and phased "auto" on the same scene: the image means within 2%
    regen_mean = float(img[..., :3].mean())
    p_paths = {}
    for label, kw in (("persist", dict(persist=True)), ("phased_auto", dict(phase_split="auto"))):
        rr, pimg, pdt, pcounts = main_path_run(prism, **kw)
        check_image(pimg, PRISM["width"], PRISM["height"])
        mean_rel = abs(float(pimg[..., :3].mean()) - regen_mean) / regen_mean
        p_paths[label] = dict(seconds=pdt, seconds_per_frame=pdt / PRISM["iterations"],
                              launches=pcounts, mean_rgb=float(pimg[..., :3].mean()),
                              mean_rel_vs_regen=mean_rel, mean_limit=0.02)
        if label == "persist":
            p_paths[label]["budget"] = rr.persist_info["budget"]
            assert pcounts["cuda_persist"] > 0 and pcounts["cuda_cost"] == 1, pcounts
        else:
            p_paths[label].update(stages=rr.phase_stages, overflow_frames=rr.overflow_frames)
            assert rr.phase_stages is None or pcounts["cuda_seg"] > 0, pcounts
        assert mean_rel <= 0.02, (label, p_paths[label])
    # each feature build against its plain version at this shape, on the
    # Renderer's lanes: cuda_mono and cuda_cost frame 0, cuda_regen K = 3
    # (its resident grid hands a lane several pixels here), cuda_seg
    # [0, 2) and its compacted tail, one free-running persist launch at
    # the persist path's budget
    p_times = {}
    p_checks, p_info = ts.feature_kernel_checks(
        p_tb, frame=0, lane_perm=r._lane_perm, persist_launches=1,
        persist_budget=p_paths["persist"]["budget"], persist_stop=0,
        timed=timed_into(p_times))
    prism_kernels = dict(
        case=f"prism 800x600 S=64 b8, {r.lane_layout} lanes: frame 0; regen K=3; seg [0, 2) "
             f"and the compacted [2, 8); one free-running persist launch at budget "
             f"{p_paths['persist']['budget']}", **p_info, ms=p_times, bit_identical=p_checks)
    assert all(p_checks.values()), prism_kernels
    # one persist launch at the path's budget beside the earlier design's
    # feature build (persist_fx_reg)
    prism_kernels["persist_launch_turns"] = persist_turns(
        "cuda_persist (prism)", p_st, p_cfg, p_tb, p_paths["persist"]["budget"],
        "persist_fx_reg")
    emit(phase="kernels_features_main_shape", **prism_kernels, card=card)

    # the strip's image disperses: the red and blue centroids along x of
    # its middle rows (tests/test_dispersion.py:189-198), background
    # masked. The slab shows the strip twice, dispersed in opposite
    # directions, so one centroid over the whole band cancels: each image
    # (a run of lit columns) is measured on its own, the two holding the
    # most light. The control, the same glass with no Cauchy term
    # (cauchy_b = 0), must read achromatic on the same measure
    def strip_split(image):
        h0, h1 = PRISM["height"] // 4, 3 * PRISM["height"] // 4
        band = image[h0:h1, :, :3].copy()
        band[band < 0.1 * band.max()] = 0.0
        lit = band.sum(axis=(0, 2)) > 0
        found, x = [], 0
        while x < len(lit):
            if not lit[x]:
                x += 1
                continue
            x1 = x
            while x1 < len(lit) and lit[x1]:
                x1 += 1
            seg, xs = band[:, x:x1], np.arange(x, x1)
            w_r, w_b = seg[..., 0].sum(axis=0), seg[..., 2].sum(axis=0)
            if float(w_r.sum()) > 0.0 and float(w_b.sum()) > 0.0:
                found.append(dict(
                    columns=[x, x1], light=float(seg.sum()),
                    red_minus_blue_px=float((xs * w_r).sum() / w_r.sum()
                                            - (xs * w_b).sum() / w_b.sum())))
            x = x1
        found = sorted(found, key=lambda im: -im["light"])[:2]
        return found, max((abs(im["red_minus_blue_px"]) for im in found), default=0.0)

    strip_images, split_px = strip_split(prism_img)
    assert split_px > 0.2, ("no chromatic separation", strip_images)
    achromatic = scene_of(presets.prism, PRISM["width"], PRISM["height"], PRISM["n_samples"],
                          PRISM["bounces"], PRISM["iterations"])
    for obj in achromatic.objects:
        if obj.material.transmission > 0.0:
            obj.material.cauchy_b_um2 = 0.0
    _, c_img, _, c_counts = main_path_run(achromatic)
    check_image(c_img, PRISM["width"], PRISM["height"])
    control_images, control_px = strip_split(c_img)
    assert control_images and control_px < CONTROL_LIMIT_PX, (
        "the achromatic control reads a split", control_images)
    s64 = {k: [e for e in v if e["entry"].split("<")[1].startswith("64,")]
           for k, v in resources.items() if k in fx_libs}
    emit(phase="prism_main_path",
         config="presets.prism(): 4 objects, 800x600, 64 lambda, 8 bounces, 200 iterations",
         features=p_tb.features, regen_frames=r.regen_frames, frames=r.next_frame, seconds=dt,
         seconds_per_frame=p_s_per_frame, ms_per_frame=1e3 * p_s_per_frame, launches=counts,
         rays_per_frame_plain_f0_scaled_from_200x150=p_rays,
         mrays_lambda_per_s=p_rays * p_cfg.n_samples / p_s_per_frame / 1e6,
         regen_k100_launch_ms=p_regen_ms, live_iterations_k100=p_iters,
         profiled_wall_ms=p_wall_ms, device_busy_ms=p_busy_ms,
         device_busy_share=p_busy_ms / p_wall_ms, mean_rgb=regen_mean, paths=p_paths,
         strip_images=strip_images, split_px=split_px, split_limit_px=0.2,
         control_cauchy_b_0=dict(strip_images=control_images, split_px=control_px,
                                 limit_px=CONTROL_LIMIT_PX, launches=c_counts),
         build_seconds_all=build_s, feature_kernels_s64=s64,
         phase_seconds=round(time.monotonic() - t0, 3), card=card)

    # ------------- 9. the trace probe at full shape, then through its tool
    t0 = time.monotonic()
    p_in = tp.make_inputs(0)
    fori = tuple(torch.from_numpy(a).to(dev) for a in p_in["fori"])
    mma = tuple(torch.from_numpy(a).to(dev) for a in p_in["mma"])
    fori_plain_ms, (gp_t, gp_w) = cuda_ms(lambda: tp.probe_fori_plain(*fori), 1, warmup=False)
    mma_plain_ms, (hp_t, hp_w) = cuda_ms(lambda: tp.probe_mma_plain(*mma), 1, warmup=False)
    ex_t, ex_w = tp.probe_exact(*mma)
    mma_bound = tp.error_bound(*mma, ex_w, tp.MMA_DOT_GAMMA)

    # 30 launches each, after one
    fori_ms, (g_t, g_w) = cuda_ms(lambda: tp.cuda_probe_fori(*fori), 30)
    assert torch.equal(g_t, gp_t) and torch.equal(g_w, gp_w), (
        "cuda_probe_fori differs from its plain version")
    mma_ms, (h_t, h_w) = cuda_ms(lambda: tp.cuda_probe_mma(*mma), 30)
    mma_vs_plain = tp.compare(h_t, h_w, hp_t, hp_w)
    mma_vs_exact = tp.compare(h_t, h_w, ex_t, ex_w, mma_bound)
    assert mma_vs_plain["winner_agreement"] >= tp.MMA_WINNERS_MIN, mma_vs_plain
    # the formula cancels (b = 2 (d.o - d.c)): t agrees with the plain
    # version only to float32's error, so each hit is held to its own
    # error bound against a float64 evaluation (trace_probe.error_bound)
    assert mma_vs_exact["max_err_over_bound"] <= 1.0, mma_vs_exact
    assert mma_vs_exact["share_within_1e5"] >= tp.MMA_SHARE_1E5_MIN, mma_vs_exact
    fori_err = float(torch.where(torch.isfinite(gp_t), (g_t - gp_t).abs(), 0.0).max())
    plain_vs_exact = tp.compare(hp_t, hp_w, ex_t, ex_w,
                                tp.error_bound(*mma, ex_w, tp.PLAIN_DOT_GAMMA))
    assert plain_vs_exact["max_err_over_bound"] <= 1.0, plain_vs_exact
    crosscheck = tp.compare(h_t, h_w, g_t.reshape(-1, 1), g_w.reshape(-1, 1))
    mma_err = float(torch.where(torch.isfinite(hp_t) & (h_w == hp_w),
                                (h_t - hp_t).abs(), 0.0).max())
    # the pairs that need the root stage, for the bounds below
    root_pairs = dict(fori=tp.fori_root_pairs(*fori), mma=tp.mma_root_pairs(*mma))
    probe_out = dict(rays=fori[1].numel(), objects=tp.N_OBJ, fori_ms=fori_ms,
                     fori_plain_ms=fori_plain_ms, fori_bit_identical=True, mma_ms=mma_ms,
                     mma_plain_ms=mma_plain_ms, mma_vs_plain=mma_vs_plain,
                     mma_vs_float64=mma_vs_exact, plain_vs_float64=plain_vs_exact,
                     fori_vs_mma=crosscheck,
                     root_pairs=root_pairs, winner_limit=tp.MMA_WINNERS_MIN,
                     err_over_bound_limit=1.0, share_within_1e5_limit=tp.MMA_SHARE_1E5_MIN)
    del ex_t, ex_w, hp_t, hp_w, gp_t, gp_w, mma_bound
    # the probe's entry point: the tool at its full shape, seed 0
    _, probe_counts = count_launches(lambda: probe_tool.main([]))
    assert probe_counts["cuda_probe_fori"] > 0 and probe_counts["cuda_probe_mma"] > 0
    for key in launches:
        launches[key] += probe_counts[key]
    emit(phase="trace_probe", seconds=round(time.monotonic() - t0, 3), **probe_out,
         tool_launches=probe_counts, card=card)

    # ------ 11. what follows a render: scene files, EXR, AOVs, the denoiser,
    # the u8 codec, animation and motion blur (cuda_regen and cuda_mono)
    slice_launches = {}

    def counted(phase_name, fn):
        """Zero every count, run fn, read the counts (added to the main
        path's launches and kept under ``phase_name``)."""
        out, counts = count_launches(fn)
        for key in launches:
            launches[key] += counts[key]
        slice_launches[phase_name] = {k: n for k, n in counts.items() if n}
        return out, counts

    def host_ms(fn, reps=1):
        """The least wall ms of ``reps`` runs of fn, each ended by a
        device synchronize: (ms, fn's last result)."""
        best, out = float("inf"), None
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.monotonic()
            out = fn()
            torch.cuda.synchronize()
            best = min(best, (time.monotonic() - t) * 1e3)
        return best, out

    def same_bits(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()

    def display_rmse(a, b):
        """The ``compare`` command's RMSE: the 8-bit display images as
        [0, 1] RGB."""
        ua = image_mod.accum_to_u8(a)[..., :3].astype(np.float32) / 255.0
        ub = image_mod.accum_to_u8(b)[..., :3].astype(np.float32) / 255.0
        return float(np.sqrt(np.mean((ua - ub) ** 2)))

    def linear_rmse(a, b):
        return float(np.sqrt(np.mean((a[..., :3] - b[..., :3]) ** 2)))

    def denoise_times(label, fb_, aovs_):
        """``atrous_denoise`` (5 levels) from host arrays to a host array,
        and ``atrous_filter`` alone on device tensors (CUDA events)."""
        args_ = (fb_[..., :3], aovs_["depth"], aovs_["normal"], aovs_["albedo"])
        dn_mod.atrous_denoise(*args_, device="cuda")  # first launches
        ms, _ = host_ms(lambda: dn_mod.atrous_denoise(*args_, device="cuda"), reps=3)
        f_in = dn_mod.filter_inputs(*args_, device="cuda")
        f_ms = min(cuda_span(lambda: dn_mod.atrous_filter(*f_in[:3], 5, f_in[3]))[0]
                   for _ in range(3))
        return {f"{label}_atrous_denoise_ms": ms, f"{label}_atrous_filter_ms": f_ms}

    rgba = ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3))
    t0 = time.monotonic()
    post = {}
    p_ref = scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], k_main)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene_file = tmp / "cornell512.json"
        sceneio.save_scene(p_ref, scene_file)
        p_scene = sceneio.load_scene(scene_file)
        assert json.dumps(sceneio.scene_to_dict(p_scene)) == json.dumps(
            sceneio.scene_to_dict(p_ref)), "the scene file does not round-trip"
        out_exr, aov_exr = tmp / "x.exr", tmp / "aov.exr"

        def run_cli():
            t = time.monotonic()
            rc = port_cli.main(["render", "--scene", str(scene_file), "--out", str(out_exr),
                                "--aovs", str(aov_exr), "--denoise", "5", "--quiet"])
            torch.cuda.synchronize()
            return rc, time.monotonic() - t

        (rc, cli_s), post_counts = counted("post_main_path", run_cli)
        assert rc == 0 and post_counts["cuda_regen"] == 1, post_counts
        r_post = Renderer(p_scene, device="cuda")
        fb = r_post.render()
        assert r_post.regen_frames == k_main
        check_image(fb, 512, 512)
        planes, _, (w_x, h_x) = read_exr(out_exr)
        assert (w_x, h_x) == (512, 512)
        for name, ch in rgba:  # --out x.exr: the writer's default half precision
            assert same_bits(planes[name], fb[..., ch].astype(np.float16).astype(np.float32)), (
                "beauty EXR", name)
        aovs = aov_mod.compute_aovs(p_scene, "cuda")
        planes, _, _ = read_exr(aov_exr)
        for name, ch in rgba:
            assert same_bits(planes[name], fb[..., ch]), ("AOV EXR beauty", name)
        assert same_bits(planes[b"depth.Z"], aovs["depth"])
        assert same_bits(planes[b"obj_id.Z"], aovs["obj_id"].astype(np.float32))
        for layer in ("normal", "albedo"):
            for i, c in enumerate("RGB"):
                assert same_bits(planes[f"{layer}.{c}".encode()], aovs[layer][..., i]), layer
        dn_gpu = dn_mod.atrous_denoise(fb[..., :3], aovs["depth"], aovs["normal"],
                                       aovs["albedo"], device="cuda")
        planes, _, _ = read_exr(tmp / "x.denoised.exr")
        for name, ch in rgba[:3]:
            assert same_bits(planes[name], dn_gpu[..., ch].astype(np.float16).astype(np.float32))
        # the u8 codec: native=True (g++ at first use; a failed build raises)
        u8_native = image_mod.accum_to_u8(fb, native=True)
        assert same_bits(u8_native, image_mod.accum_to_u8(fb, native=False))
        png_n = image_mod.save_image(fb, tmp / "native.png", native=True)
        png_p = image_mod.save_image(fb, tmp / "pil.png", native=False)
        from PIL import Image

        assert same_bits(np.asarray(Image.open(png_n)), np.asarray(Image.open(png_p)))
        assert same_bits(np.asarray(Image.open(png_n)), u8_native)
        post.update(
            cli_render_s=cli_s, launches=post_counts, native_png_bytes=png_n.stat().st_size,
            pil_png_bytes=png_p.stat().st_size,
            native_png_bytes_equal_pil=png_n.read_bytes() == png_p.read_bytes(),
            u8_native_ms=host_ms(lambda: image_mod.accum_to_u8(fb, native=True), 5)[0],
            u8_numpy_ms=host_ms(lambda: image_mod.accum_to_u8(fb, native=False), 5)[0],
            png_native_ms=host_ms(lambda: image_mod.save_image(fb, tmp / "n2.png",
                                                               native=True), 3)[0],
            png_pil_ms=host_ms(lambda: image_mod.save_image(fb, tmp / "p2.png",
                                                            native=False), 3)[0],
            exr_beauty_half_zip_ms=host_ms(lambda: image_mod.save_image(fb, tmp / "b.exr"), 3)[0],
            exr_beauty_half_zip_bytes=(tmp / "b.exr").stat().st_size,
            exr_aov_float_zip_ms=host_ms(lambda: aov_mod.save_aovs_exr(
                aovs, tmp / "a.exr", beauty=fb), 3)[0],
            exr_aov_float_zip_bytes=(tmp / "a.exr").stat().st_size)
    # the card's AOVs against the port's CPU AOVs from the same primaries
    st_c, cfg_c = flatten_scene(p_scene, "cpu")
    o_c, d_c = aov_mod.pixel_centre_rays(st_c, cfg_c)
    want_aov = {k: v.numpy() for k, v in aov_mod.aov_buffers(st_c, cfg_c, o_c, d_c).items()}
    st_g, cfg_g = flatten_scene(p_scene, dev)
    got_aov = {k: v.cpu().numpy() for k, v in aov_mod.aov_buffers(
        st_g, cfg_g, Vec3(*(c.to(dev) for c in o_c)), Vec3(*(c.to(dev) for c in d_c))).items()}
    assert same_bits(got_aov["obj_id"], want_aov["obj_id"]), "AOV obj_id card vs CPU"
    hit = want_aov["obj_id"] >= 0
    aov_vs_cpu = {"obj_id_equal": True, "hit_fraction": float(hit.mean())}
    for k in ("depth", "normal", "albedo"):
        scale = max(1.0, float(np.abs(want_aov[k][hit]).max()))
        err = float(np.abs(got_aov[k][hit] - want_aov[k][hit]).max()) / scale
        aov_vs_cpu[k] = dict(max_rel=err, bit_equal=same_bits(got_aov[k], want_aov[k]),
                             limit=1e-5)
        assert err <= 1e-5, (k, err)
    aov_vs_cpu["card_rays_same_obj_id"] = same_bits(aovs["obj_id"], got_aov["obj_id"])
    # the card's denoiser against the port's on the CPU, same inputs
    dn_cpu = dn_mod.atrous_denoise(fb[..., :3], aovs["depth"], aovs["normal"],
                                   aovs["albedo"], device="cpu")
    dn_err = float(np.abs(dn_gpu - dn_cpu).max()) / float(np.abs(dn_cpu).max())
    assert dn_err <= 1e-4, ("denoiser card vs CPU", dn_err)
    # 16 iterations, denoised, against the 100-iteration render
    s16 = scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], 16)
    raw16 = Renderer(s16, device="cuda").render()
    dn16 = np.concatenate([dn_mod.atrous_denoise(raw16[..., :3], aovs["depth"], aovs["normal"],
                                                 aovs["albedo"], device="cuda"),
                           raw16[..., 3:]], axis=-1)
    rmse = dict(display_raw16=display_rmse(raw16, fb), display_denoised16=display_rmse(dn16, fb),
                linear_raw16=linear_rmse(raw16, fb), linear_denoised16=linear_rmse(dn16, fb))
    assert rmse["display_denoised16"] < rmse["display_raw16"], rmse
    # times: the AOVs and the denoiser at 512x512 and at the hero size
    times = {"aov_512_ms": host_ms(lambda: aov_mod.compute_aovs(p_scene, "cuda"), 3)[0]}
    times.update(denoise_times("512", fb, aovs))
    hero = scene_of(presets.cornell_box, 1920, 1080, 32, MAIN["bounces"], 4)
    hero_fb = Renderer(hero, device="cuda").render()
    times["aov_1920x1080_ms"], hero_aovs = host_ms(lambda: aov_mod.compute_aovs(hero, "cuda"), 3)
    times.update(denoise_times("1920x1080", hero_fb, hero_aovs))
    with tempfile.TemporaryDirectory() as tmp:
        times["exr_1920x1080_half_zip_ms"] = host_ms(
            lambda: image_mod.save_image(hero_fb, Path(tmp) / "h.exr"), 3)[0]
        times["exr_1920x1080_half_zip_bytes"] = (Path(tmp) / "h.exr").stat().st_size
    emit(phase="post_main_path", seconds=round(time.monotonic() - t0, 3),
         config="cornell 512x512, 32 lambda, 30 bounces, 100 iterations, from a scene file; "
         "render --out x.exr --aovs aov.exr --denoise 5", **post, aov_vs_cpu=aov_vs_cpu,
         denoise_vs_cpu=dict(max_rel=dn_err, limit=1e-4), rmse_vs_100=rmse, times=times,
         card=card)
    del hero_fb, hero_aovs, dn_cpu, want_aov, got_aov

    # ---------------- 12. AOVs of the many-object scenes: time and memory
    t0 = time.monotonic()
    aov_many = {}
    for label, sc in (("spheres1000_1024x768",
                       field_of(SPHERES["n_spheres"], SPHERES["width"], SPHERES["height"],
                                SPHERES["n_samples"], SPHERES["bounces"], 1)),
                      ("mesh5k_512x512", scene_of(presets.PRESETS["mesh5k"], 512, 512, 32, 30, 1))):
        aov_mod.compute_aovs(sc, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        ms, a = host_ms(lambda: aov_mod.compute_aovs(sc, "cuda"))
        peak = torch.cuda.max_memory_allocated()
        n_obj = flatten_numpy(sc)[1].n_objects
        n_rays = sc.width * sc.height
        assert (a["obj_id"] >= 0).any() and np.isfinite(a["normal"]).all(), label
        aov_many[label] = dict(ms=ms, max_memory_allocated=peak,
                               peak_over_resident_bytes=peak - base_mem, rays=n_rays,
                               objects=n_obj,
                               chunks=-(-n_rays // max(128, BROADCAST_BUDGET // n_obj)),
                               hit_fraction=float((a["obj_id"] >= 0).mean()))
    emit(phase="aov_many", seconds=round(time.monotonic() - t0, 3), **aov_many, card=card)

    # --------------------------- 13. animation and motion blur (cuda_mono)
    t0 = time.monotonic()
    anim_out = {}
    orbit_base = scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], 8)
    orbit = anim_mod.Animation(orbit_base, 4, anim_mod.orbit_tracks(orbit_base, 360.0, 4))
    (orbit_ms, frames), orbit_counts = counted(
        "animation_orbit", lambda: host_ms(lambda: anim_mod.render_animation(orbit)))
    assert orbit_counts["cuda_regen"] == 4, orbit_counts
    for f in range(4):
        alone = Renderer(orbit.scene_at(f), device="cuda").render()
        assert same_bits(image_mod.accum_to_u8(alone)[..., :3], frames[f]), ("orbit frame", f)
    assert not same_bits(frames[0], frames[1])
    anim_out["orbit_cornell512_4x8"] = dict(ms_per_frame=orbit_ms / 4, launches=orbit_counts)

    def blur_schedule(anim, shutter):
        cfg0 = flatten_numpy(anim.scene_at(0))[1]
        return anim_mod._motion_blur_schedule(anim, 0, shutter, cfg0, lambda s: s)

    # static tracks: every shutter sample is the same scene
    static = anim_mod.Animation(orbit_base, 1, [anim_mod.Track(
        "camera.fov_y_deg", [(0.0, 60.0), (1.0, 60.0)])])
    blurred, mb_counts = counted("motion_blur_static", lambda: Renderer(
        static.scene_at(0), device="cuda", _scene_schedule=blur_schedule(static, 0.5)).render())
    assert mb_counts["cuda_mono"] == 8 and mb_counts["cuda_regen"] == 0, mb_counts
    assert same_bits(blurred, Renderer(static.scene_at(0), device="cuda",
                                       regen_frames=1).render()), "static shutter"
    # a moving sphere spreads along its path
    d_scene = scene_of(presets.default_scene, 320, 240, 32, 8, 8)
    moving = anim_mod.Animation(d_scene, 1, [anim_mod.Track(
        "objects[0].position", [(0.0, (-1.5, 0.0, 2.0)), (1.0, (1.5, 0.0, 2.0))])])
    still = anim_mod.render_animation(moving)
    smeared, _ = counted("motion_blur_moving",
                         lambda: anim_mod.render_animation(moving, shutter=1.0))
    moved_px = int((smeared != still).any(axis=-1).sum())
    assert moved_px > 0, "motion blur left the moving sphere where it was"
    # a sphere leaves its cluster early in the shutter: clustered == flat
    field = field_of(SPHERES["n_spheres"], 256, 192, SPHERES["n_samples"],
                     SPHERES["bounces"], 8)
    cam_pos = np.asarray(field.camera.position, np.float64)
    target = tuple(float(v) for v in cam_pos + 2.5 * np.asarray(field.camera.direction))
    jump = anim_mod.Animation(field, 1, [anim_mod.Track(
        "objects[1].position", [(0.0, tuple(field.objects[1].position)), (0.1, target)])])
    jump_imgs = {}
    for accel in ("auto", "none"):
        jump_imgs[accel], jc = counted(f"motion_blur_clusters_{accel}", lambda: Renderer(
            jump.scene_at(0), device="cuda", accel=accel,
            _scene_schedule=blur_schedule(jump, 1.0)).render())
        assert jc["cuda_mono"] == 8, jc
    assert same_bits(jump_imgs["auto"], jump_imgs["none"]), "clustered != flat under motion blur"
    anim_out["motion_blur_checks"] = dict(
        static_equals_unblurred=True, moving_sphere_pixels_changed=moved_px,
        clustered_equals_flat=True)
    # ms per frame and the device-busy share against the static mono render
    for label, sc_, anim_ in (("cornell512", orbit_base, static),
                              ("spheres1000_256x192", field, jump)):
        mb_wall, mb_busy = profiled_render(anim_.scene_at(0),
                                           _scene_schedule=blur_schedule(anim_, 1.0))
        st_wall, st_busy = profiled_render(anim_.scene_at(0), regen_frames=1)
        mb_ms, _ = host_ms(lambda: Renderer(anim_.scene_at(0), device="cuda",
                                            _scene_schedule=blur_schedule(anim_, 1.0)).render())
        st_ms, _ = host_ms(lambda: Renderer(anim_.scene_at(0), device="cuda",
                                            regen_frames=1).render())
        frames_n = sc_.nbr_of_iterations
        anim_out[f"motion_blur_{label}"] = dict(
            frames=frames_n, ms_per_frame=mb_ms / frames_n, static_mono_ms_per_frame=st_ms / frames_n,
            busy_share=mb_busy / mb_wall, static_busy_share=st_busy / st_wall,
            profiled_wall_ms=mb_wall, static_profiled_wall_ms=st_wall)
    emit(phase="animation", seconds=round(time.monotonic() - t0, 3), **anim_out,
         launches={k: v for k, v in slice_launches.items() if k != "post_main_path"},
         card=card)

    # ------------------ 14. the live render: cadence, the viewer's and the
    # preview's cost, many materials, the reference's image, the live view
    def live_run(name, sc, regen="auto"):
        """``main_path_run``, its counts also kept under ``name``."""
        r_, img_, dt_, counts_ = main_path_run(sc, regen=regen)
        slice_launches[name] = {k: n for k, n in counts_.items() if n}
        return r_, img_, dt_, counts_

    t0 = time.monotonic()
    cadence = {"turns": []}
    cad_imgs = {}

    def cornell512(iters=MAIN["iterations"]):
        return scene_of(presets.cornell_box, 512, 512, 32, MAIN["bounces"], iters)

    # K = 16 (the live view's chunk cap) against "auto" (K = 100), in turns
    for turn, regen in enumerate((("auto", 16), "auto", "auto", ("auto", 16))):
        key = "k16" if isinstance(regen, tuple) else "k100"
        r_c, img_c, dt_c, counts_c = live_run(f"live_cadence_{turn}", cornell512(), regen)
        check_image(img_c, 512, 512)
        wall_c, busy_c = profiled_render(cornell512(), regen_frames=regen)
        cadence["turns"].append(dict(
            regen=key, k=r_c.regen_frames, ms_per_frame=dt_c * 1e3 / r_c.next_frame,
            profiled_wall_ms=wall_c, busy_share=busy_c / wall_c, launches=counts_c))
        cad_imgs.setdefault(key, img_c)
    assert cadence["turns"][0]["k"] == 16 and cadence["turns"][1]["k"] == 100
    assert cadence["turns"][0]["launches"]["cuda_regen"] == 6
    assert cadence["turns"][0]["launches"]["cuda_mono"] == 4  # the ragged tail
    for key in ("k16", "k100"):
        rows = [t for t in cadence["turns"] if t["regen"] == key]
        cadence[key] = dict(ms_per_frame=sum(t["ms_per_frame"] for t in rows) / 2,
                            busy_share=sum(t["busy_share"] for t in rows) / 2)
    # the same paths, frames summed per chunk: only the float32 order of
    # the chunk sums and the blend differs (the bound of
    # test_plain_regen_is_the_sum_of_mono_frames, 1e-4 of the scale)
    scale = max(1.0, float(np.abs(cad_imgs["k100"]).max()))
    k16_vs_k100 = float(np.abs(cad_imgs["k16"] - cad_imgs["k100"]).max()) / scale
    cadence["k16_vs_k100_max_rel"] = k16_vs_k100
    cadence["k16_vs_k100_bit_identical"] = same_bits(cad_imgs["k16"], cad_imgs["k100"])
    assert k16_vs_k100 <= 1e-4, ("K=16 against K=100", k16_vs_k100)
    # the reference's note that K = 10 holds ~60% of the K = 100 gain over
    # frame-by-frame (measured on its TPU): the H100's share, one pass each
    gain = {}
    for k in (1, 10):
        r_k, img_k, dt_k, _ = live_run(f"live_cadence_k{k}", cornell512(), k)
        check_image(img_k, 512, 512)
        gain[f"k{k}_ms_per_frame"] = dt_k * 1e3 / r_k.next_frame
    k1, k10 = gain["k1_ms_per_frame"], gain["k10_ms_per_frame"]
    k100 = cadence["k100"]["ms_per_frame"]
    gain["k10_share_of_k100_gain"] = (k1 - k10) / (k1 - k100)
    gain["k16_share_of_k100_gain"] = (k1 - cadence["k16"]["ms_per_frame"]) / (k1 - k100)
    cadence["gain_over_frame_by_frame"] = gain
    # one viewer.update (the device -> host copy and the 512x512 PNG
    # encode) and one --preview-every save (the copy, u8 and the PNG write)
    r_v = Renderer(cornell512(16), device="cuda", regen_frames=16)
    r_v.render()
    viewer = LiveViewer(port=0)
    try:
        fb_ms, fb = host_ms(r_v.framebuffer, reps=5)
        update_ms, _ = host_ms(lambda: viewer.update(r_v.framebuffer(), 16, 16, 1.0), reps=5)
        encode_ms, _ = host_ms(lambda: viewer.update(fb, 16, 16, 1.0), reps=5)
        png_bytes = len(urllib.request.urlopen(viewer.url + "frame.png", timeout=10).read())
    finally:
        viewer.close()
    with tempfile.TemporaryDirectory() as tmp:
        preview_ms, _ = host_ms(lambda: r_v.save_image(Path(tmp) / "preview.png"), reps=5)
    cadence["viewer_update_ms"] = update_ms
    cadence["framebuffer_copy_ms"] = fb_ms
    cadence["png_encode_ms"] = encode_ms
    cadence["png_bytes"] = png_bytes
    cadence["preview_save_ms"] = preview_ms
    emit(phase="live_cadence", seconds=round(time.monotonic() - t0, 3),
         config="cornell 512x512, 32 lambda, 30 bounces, 100 iterations", **cadence,
         card=card)

    # more than 256 materials: sphere_field(300) with a material of its own
    # per object (301 rows in shared memory) and sphere_field(1000) at 64
    # lambda (1,001 rows, 256 KB of albedo: global memory)
    t0 = time.monotonic()
    many_mat = []
    for n_sph, s_mm in ((300, 32), (1000, 64)):
        case = {"case": f"sphere_field({n_sph}) one material per object, S={s_mm}"}
        for label, own in (("materials", True), ("preset_materials", False)):
            def field_mm(w, h, iters):
                sc = field_of(n_sph, w, h, s_mm, SPHERES["bounces"], iters)
                return ts.one_material_each(schema, sc) if own else sc

            st_mm, cfg_mm = flatten_scene(field_mm(256, 192, 2), dev)
            tb_mm = mk.pack_tables(st_mm, cfg_mm)
            row = dict(n_materials=cfg_mm.n_materials, materials_shared=tb_mm.materials_shared(),
                       smem_bytes=tb_mm.smem_bytes())
            if own:
                assert tb_mm.materials_shared() is (n_sph == 300), row
                planes_mm, px_mm, py_mm = ci.primary_lanes(st_mm, cfg_mm, 0)
                mono_ms_mm, got = cuda_ms(
                    lambda: mk.run_mono(*planes_mm, px_mm, py_mm, 0, tb_mm), 3)
                want = mk.run_mono_plain(*planes_mm, px_mm, py_mm, 0, tb_mm)
                assert torch.equal(got, want), (case, "cuda_mono against plain")
                args_mm = (*ci.regen_args(st_mm, cfg_mm, 0, 2,
                                          morton_layout(256, 192, dev)[0]), tb_mm)
                regen_ms_mm, got = cuda_ms(lambda: mk.run_regen(*args_mm), 2)
                assert torch.equal(got, mk.run_regen_plain(*args_mm)), (
                    case, "cuda_regen against plain")
                del got, want
                row.update(bit_identical=dict(cuda_mono=True, cuda_regen=True),
                           check="256x192, cuda_mono frame 0, cuda_regen K=2 Morton",
                           cuda_mono_ms_256x192=mono_ms_mm, cuda_regen_k2_ms_256x192=regen_ms_mm)
            full_mm = field_mm(SPHERES["width"], SPHERES["height"], 20)
            r_mm, img_mm, dt_mm, counts_mm = live_run(f"many_materials_{n_sph}_{label}",
                                                      full_mm)
            check_image(img_mm, SPHERES["width"], SPHERES["height"])
            row.update(ms_per_frame_1024x768=dt_mm * 1e3 / r_mm.next_frame,
                       regen_frames=r_mm.regen_frames, launches=counts_mm,
                       regen_info=kernel_info("regen", r_mm.tables),
                       mono_info=kernel_info("mono", r_mm.tables, variant=0))
            case[label] = row
        many_mat.append(case)
    emit(phase="many_materials", seconds=round(time.monotonic() - t0, 3),
         bounces=SPHERES["bounces"], iterations=20, cases=many_mat, card=card)

    # the reference's one published image (tests/test_reference_rmse.py):
    # the default scene at 160x90, 150 iterations, on 16-frame chunks
    t0 = time.monotonic()
    from PIL import Image

    golden = ROOT / "tests" / "goldens" / "example_image_160x90.png"
    ref_img = np.asarray(Image.open(golden).convert("RGB"), np.float32) / 255.0
    rm_scene = presets.default_scene()
    rm_scene.width, rm_scene.height, rm_scene.nbr_of_iterations = 160, 90, 150
    r_rm, img_rm, dt_rm, counts_rm = live_run("reference_rmse", rm_scene, ("auto", 16))
    assert r_rm.regen_frames == 16 and counts_rm["cuda_regen"] == 9, counts_rm
    ours = image_mod.accum_to_u8(img_rm)[..., :3].astype(np.float32) / 255.0
    rmse = float(np.sqrt(np.mean((ours - ref_img) ** 2)))
    ref_rms = float(np.sqrt(np.mean(ref_img**2)))
    assert rmse < 0.030 and rmse < 0.5 * ref_rms, ("RMSE against the reference image", rmse)
    emit(phase="reference_rmse", seconds=round(time.monotonic() - t0, 3), rmse=rmse,
         limit=0.030, reference_rms=ref_rms, iterations=150, regen_frames=16,
         launches=counts_rm, card=card)

    # the live view: the CLI with --serve on the card, driven over HTTP
    t0 = time.monotonic()
    live = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out_png = tmp / "img.png"
        base = ["--out", out_png, "--serve", "0", "--quiet"]
        first = LiveRender(base + ["--preset", "cornell", "--width", "512", "--height",
                                   "512", "--bounces", "30", "--iterations", "100000"],
                           deadline_s=400, cwd=ROOT)
        try:
            url = first.url(deadline_s=180)
            live["startup_s"] = time.monotonic() - t0
            st0 = first.wait_status(url, lambda s: s["frame"] >= 32, 60)
            live["first_status"] = st0
            png = urllib.request.urlopen(url + "frame.png", timeout=10).read()
            assert Image.open(io.BytesIO(png)).size == (512, 512)
            for path in ("scene", "spectra", "objects"):
                with urllib.request.urlopen(url + path, timeout=10) as resp:
                    assert resp.status == 200, path
            # a legal per-object edit (the cornell box has no sphere: move
            # the right front box), two seconds and four chunks in, so that
            # the count and the seconds after the restart read lower for a
            # while (the page updates at most once a second)
            before = first.wait_status(
                url, lambda s: s["elapsed_s"] >= 2.0 and s["frame"] >= 64, 60)
            objs = json.loads(urllib.request.urlopen(url + "objects", timeout=10).read())
            idx = next(o["index"] for o in objs["objects"] if o["name"] == "Right front box")
            moved = [c + 0.1 for c in objs["objects"][idx]["position"]]
            code, msg = http_post(url + "object", json.dumps(
                {"kind": "object", "index": idx, "action": "update",
                 "fields": {"position": moved}}).encode())
            assert code == 200, msg
            first.wait(lambda: "restarting render" in first.text, "the restart", 60)
            after = first.wait_status(url, lambda s: s["frame"] < before["frame"]
                                      and s["elapsed_s"] < before["elapsed_s"], 60)
            live["edit"] = dict(before=before, after=after)
            edited = urllib.request.urlopen(url + "scene", timeout=10).read()
            bad = json.loads(edited)
            bad["settings"]["iterations"] = 0
            code, msg = http_post(url + "scene", json.dumps(bad).encode())
            assert code == 400 and b"iterations" in msg, (code, msg)
            code, _ = http_post(url + "abort", b"")
            assert code == 200
            text = first.finish()
        finally:
            first.close()
        assert first.proc.returncode == 0, text
        assert "aborted after" in text and out_png.exists(), text
        ckpt = tmp / "img.png.ckpt.npz"
        assert ckpt.exists(), text
        done = int(np.load(ckpt)["next_frame"])
        live["aborted_at_frame"] = done
        # resume the edited scene's checkpoint, three 16-frame chunks on
        scene_json = tmp / "edited.json"
        scene_json.write_bytes(edited)
        second = LiveRender(base + ["--scene", scene_json, "--iterations", "100000",
                                    "--resume", ckpt], deadline_s=300, cwd=ROOT)
        try:
            url = second.url(deadline_s=180)
            assert f"resumed at frame {done}" in second.text, second.text
            second.wait_status(url, lambda s: s["frame"] >= done + 48, 60)
            code, _ = http_post(url + "abort", b"")
            assert code == 200
            text = second.finish()
        finally:
            second.close()
        assert second.proc.returncode == 0, text
        resumed = np.load(ckpt)
        accum = resumed["accum"]
        assert int(resumed["next_frame"]) >= done + 48
        assert np.isfinite(accum).all() and float(accum[..., :3].mean()) > 0.0
        live["resumed_to_frame"] = int(resumed["next_frame"])
        live["resumed_mean_rgb"] = float(accum[..., :3].mean())
    emit(phase="live_view", seconds=round(time.monotonic() - t0, 3), **live,
         launches="not counted: the render runs in its own process, on --device cuda "
                  "(the default), where the Renderer launches the kernels or raises",
         card=card)

    # ------ 12. the multi-GPU slice: row slabs on one card (each slab's
    # kernels on its global rows), processes in one group, the batch over
    # a mesh's slots and fused dispatches
    def slabs_of(cfg_, n):
        """``(row_offset, slab config)`` of each of ``n`` row slabs."""
        h = cfg_.height // n
        return [(i * h, dataclasses.replace(cfg_, height=h)) for i in range(n)]

    def timed_render(sc, **kw):
        """A Renderer of ``sc`` on the card: (renderer, image, render seconds)."""
        r = Renderer(sc, device="cuda", **kw)
        torch.cuda.synchronize()
        t = time.monotonic()
        img = r.render()  # ends in a device -> host copy
        return r, img, time.monotonic() - t

    def same_or_within(a, b, rel=1e-6):
        """``"bit-equal"``, or the max difference over the image scale when
        it is within ``rel`` (else raises)."""
        if same_bits(a, b):
            return "bit-equal"
        err = float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
        assert err <= rel, err
        return err

    t0 = time.monotonic()
    mg_st, mg_cfg = flatten_scene(cornell512(), dev)
    mg_tb = mk.pack_tables(mg_st, mg_cfg)
    k_mg = MAIN["iterations"]
    # each slab's cuda_regen launch against the unsharded launch's columns
    mg_rad = ci.regen_radiance(mg_st, mg_cfg, 0, k_mg, mg_tb)
    mg_slab_equal = {}
    for n in (2, 4):
        ok = True
        for off, s_cfg in slabs_of(mg_cfg, n):
            rad_s = ci.regen_radiance(mg_st, s_cfg, 0, k_mg, mg_tb, full_height=mg_cfg.height,
                                      row_offset=off)
            cols = slice(off * mg_cfg.width, (off + s_cfg.height) * mg_cfg.width)
            ok = ok and torch.equal(rad_s, mg_rad[:, cols])
        mg_slab_equal[f"{n}_slots"] = ok
    assert all(mg_slab_equal.values()), mg_slab_equal
    del mg_rad
    mg_runs, mg_imgs = {}, {}
    for n in (1, 2, 4):
        sharding = None if n == 1 else row_sharding(make_mesh(n))
        (r_mg, img_mg, dt_mg), c_mg = counted(
            f"sharded_regen_cornell512_{n}", lambda s=sharding: timed_render(cornell512(),
                                                                             sharding=s))
        check_image(img_mg, 512, 512)
        assert c_mg["cuda_regen"] == n, c_mg  # one K = 100 launch per slab
        mg_imgs[n] = img_mg
        mg_runs[f"{n}_slots"] = dict(ms_per_frame=dt_mg * 1e3 / r_mg.next_frame,
                                     launches={k: v for k, v in c_mg.items() if v})
    mg_image = {f"{n}_slots": same_or_within(mg_imgs[n], mg_imgs[1]) for n in (2, 4)}
    # spheres1000 on Morton lanes per slab, iterations cut to 10
    sp_it = 10
    sp_st, sp_cfg = flatten_scene(field_of(SPHERES["n_spheres"], SPHERES["width"],
                                           SPHERES["height"], SPHERES["n_samples"],
                                           SPHERES["bounces"], sp_it), dev)
    sp_tb = mk.pack_tables(sp_st, sp_cfg)
    perm_f, inv_f = morton_layout(sp_cfg.width, sp_cfg.height, dev)
    sp_rad = ci.regen_radiance(sp_st, sp_cfg, 0, sp_it, sp_tb, perm_f)[:, inv_f]
    sp_slab_equal = True
    for off, s_cfg in slabs_of(sp_cfg, 4):
        perm_s, inv_s = morton_layout(sp_cfg.width, s_cfg.height, dev)
        rad_s = ci.regen_radiance(sp_st, s_cfg, 0, sp_it, sp_tb, perm_s,
                                  full_height=sp_cfg.height, row_offset=off)[:, inv_s]
        cols = slice(off * sp_cfg.width, (off + s_cfg.height) * sp_cfg.width)
        sp_slab_equal = sp_slab_equal and torch.equal(rad_s, sp_rad[:, cols])
    assert sp_slab_equal, "a spheres1000 slab's cuda_regen differs from its columns"
    del sp_rad

    def spheres10():
        return field_of(SPHERES["n_spheres"], SPHERES["width"], SPHERES["height"],
                        SPHERES["n_samples"], SPHERES["bounces"], sp_it)

    sp_runs, sp_imgs = {}, {}
    for n in (1, 4):
        sharding = None if n == 1 else row_sharding(make_mesh(n))
        (r_sp, img_sp, dt_sp), c_sp = counted(
            f"sharded_regen_spheres1000_{n}", lambda s=sharding: timed_render(spheres10(),
                                                                              sharding=s))
        check_image(img_sp, SPHERES["width"], SPHERES["height"])
        assert c_sp["cuda_regen"] == n, c_sp
        if n > 1:
            assert r_sp.lane_layout == "morton" and all(
                sl.lane_perm is not None for sl in r_sp._slabs)
        sp_imgs[n] = img_sp
        sp_runs[f"{n}_slots"] = dict(ms_per_frame=dt_sp * 1e3 / r_sp.next_frame,
                                     launches={k: v for k, v in c_sp.items() if v})
    emit(phase="sharded_regen", seconds=round(time.monotonic() - t0, 3),
         cornell512=dict(case="cornell512 K=100, make_mesh(n) on cuda:0",
                         slab_cuda_regen_equal_to_unsharded_columns=mg_slab_equal,
                         image_against_1_slot=mg_image, runs=mg_runs),
         spheres1000=dict(case="sphere_field(1000) 1024x768 S=32 b8, Morton lanes per slab",
                          cut="iterations 100 -> 10 (one K = 10 launch per slab)",
                          slab_cuda_regen_equal_to_unsharded_columns=sp_slab_equal,
                          image_against_1_slot=same_or_within(sp_imgs[4], sp_imgs[1]),
                          runs=sp_runs),
         card=card)

    # cornell512 with the lens frame by frame over 2 slots (host raygen on
    # the slabs), then persist over 2 slots (cuda_cost, cuda_persist)
    t0 = time.monotonic()
    dof_it = 8

    def dof512():
        return lens_of(cornell512(dof_it))

    dm_st, dm_cfg = flatten_scene(dof512(), dev)
    dm_tb = mk.pack_tables(dm_st, dm_cfg)
    mono_slab_equal = True
    for off, s_cfg in slabs_of(dm_cfg, 2):
        planes, px, py = ci.primary_lanes(dm_st, s_cfg, 1, dm_cfg.height, off)
        got = mk.run_mono(*planes, px, py, 1, dm_tb)
        want = mk.run_mono_plain(*planes, px, py, 1, dm_tb)
        mono_slab_equal = mono_slab_equal and torch.equal(got, want)
    assert mono_slab_equal, "a slab's cuda_mono differs from its plain version"
    (r_d1, img_d1, dt_d1), c_d1 = counted("sharded_mono_dof_cornell512_1",
                                          lambda: timed_render(dof512(), regen_frames=1))
    (r_d2, img_d2, dt_d2), c_d2 = counted(
        "sharded_mono_dof_cornell512_2",
        lambda: timed_render(dof512(), regen_frames=1, sharding=row_sharding(make_mesh(2))))
    check_image(img_d2, 512, 512)
    assert c_d2["cuda_mono"] == 2 * dof_it, c_d2
    (r_p1, img_p1, dt_p1), c_p1 = counted("sharded_persist_cornell512_1",
                                          lambda: timed_render(cornell512(), persist=True))
    (r_p2, img_p2, dt_p2), c_p2 = counted(
        "sharded_persist_cornell512_2",
        lambda: timed_render(cornell512(), persist=True, sharding=row_sharding(make_mesh(2))))
    check_image(img_p2, 512, 512)
    p_info = r_p2.persist_info
    assert p_info["n_devices"] == 2 and not p_info["aborted"], p_info
    assert p_info["min_reductions"] == p_info["launches"], p_info  # one MIN per launch
    assert c_p2["cuda_cost"] == 2 and c_p2["cuda_persist"] == 2 * p_info["launches"], c_p2
    p_mean = float(img_p2[..., :3].mean()) / float(img_p1[..., :3].mean())
    assert abs(p_mean - 1.0) <= 0.02, p_mean
    emit(phase="sharded_mono_persist", seconds=round(time.monotonic() - t0, 3),
         dof=dict(case=f"cornell512 aperture {LENS['aperture']} focus {LENS['focus']}, "
                       "frame by frame", cut=f"iterations 100 -> {dof_it}",
                  slab_cuda_mono_equal_to_plain=mono_slab_equal,
                  image_against_1_slot=same_or_within(img_d2, img_d1),
                  ms_per_frame={"1_slot": dt_d1 * 1e3 / dof_it, "2_slots": dt_d2 * 1e3 / dof_it},
                  launches={"1_slot": {k: v for k, v in c_d1.items() if v},
                            "2_slots": {k: v for k, v in c_d2.items() if v}}),
         persist=dict(case="cornell512 persist=True, the default budget (cuda_cost on the slabs)",
                      mean_ratio_2_slots_to_1=p_mean,
                      bit_equal=same_bits(img_p2, img_p1),
                      budget={"1_slot": r_p1.persist_info["budget"], "2_slots": p_info["budget"]},
                      launches_2_slots=p_info["launches"],
                      min_reductions_2_slots=p_info["min_reductions"],
                      ms_per_frame={"1_slot": dt_p1 * 1e3 / MAIN["iterations"],
                                    "2_slots": dt_p2 * 1e3 / MAIN["iterations"]},
                      kernel_launches={"1_slot": {k: v for k, v in c_p1.items() if v},
                                       "2_slots": {k: v for k, v in c_p2.items() if v}}),
         card=card)

    # two processes sharing cuda:0 over gloo, and one NCCL process, through
    # the CLI (the libraries are built: the processes load them)
    t0 = time.monotonic()
    dist_args = ["render", "--preset", "cornell", "--width", "256", "--height", "256",
                 "--bounces", "30", "--samples", "32", "--iterations", "16", "--mesh", "2",
                 "--quiet"]

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def cli_group(n, out_dir):
        """The CLI in ``n`` processes of one group: (stderr texts, the
        checkpoint's accumulator, wall seconds)."""
        port = free_port()
        ckpt = out_dir / f"group{n}.npz"
        t = time.monotonic()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "spectral_tpu_torch", *dist_args,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(i), "--out", str(out_dir / f"group{n}.png"),
             "--checkpoint", str(ckpt)],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE) for i in range(n)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=300)[1].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.monotonic() - t
        for p, text in zip(procs, texts):
            assert p.returncode == 0, text
        return texts, np.load(ckpt)["accum"], wall

    def dist_scene():
        return scene_of(presets.cornell_box, 256, 256, 32, 30, 16)

    (_, img_dist_ref, dt_dist_ref), c_dist = counted("distributed_reference_1_process",
                                                     lambda: timed_render(dist_scene()))
    dist = {}
    with tempfile.TemporaryDirectory() as tmp:
        texts2, acc2, wall2 = cli_group(2, Path(tmp))
        assert "distributed: process 0/2 (gloo)" in texts2[0], texts2[0]
        assert "distributed: process 1/2 (gloo)" in texts2[1], texts2[1]
        texts1, acc1, wall1 = cli_group(1, Path(tmp))
        assert "distributed: process 0/1 (nccl)" in texts1[0], texts1[0]
    dist["gloo_2_processes"] = dict(image_against_1_process=same_or_within(acc2, img_dist_ref),
                                    wall_s=wall2)
    dist["nccl_1_process"] = dict(image_against_1_process=same_or_within(acc1, img_dist_ref),
                                  wall_s=wall1)
    emit(phase="distributed", seconds=round(time.monotonic() - t0, 3),
         case="cornell 256x256 S=32 b30, 16 iterations, --mesh 2, the CLI",
         in_process_render_s=dt_dist_ref, **dist,
         launches="the processes' own (not counted here; each launches cuda_regen on "
                  "its slab or raises)", card=card)

    # render_batch_spmd of 4 scenes over 2 slots, and frames_per_dispatch
    t0 = time.monotonic()

    def batch_scenes():
        out = []
        for k in range(4):
            sc = scene_of(presets.cornell_box, 256, 256, 32, 30, 16)
            sc.camera.fov_y_deg = 50.0 + 5.0 * k
            out.append(sc)
        return out

    (batch, dt_batch), c_batch = counted("batch_spmd_4_scenes_2_slots", lambda: host_ms(
        lambda: anim_mod.render_batch_spmd(batch_scenes(), mesh=make_mesh(2)))[::-1])
    assert batch.shape == (4, 256, 256, 4) and c_batch["cuda_regen"] == 4, c_batch
    batch_equal = [same_bits(batch[k], Renderer(sc, device="cuda").render())
                   for k, sc in enumerate(batch_scenes())]
    assert all(batch_equal), batch_equal
    fpd = {}
    fpd_imgs = {}
    for turn, k in enumerate((1, 4, 4, 1)):
        (r_f, img_f, dt_f), c_f = counted(
            f"frames_per_dispatch_{k}_turn_{turn}",
            lambda k=k: timed_render(cornell512(8), regen_frames=1, frames_per_dispatch=k))
        assert c_f["cuda_mono"] == 8, c_f
        fpd.setdefault(f"k{k}", []).append(dt_f * 1e3 / 8)
        fpd_imgs[k] = img_f
    assert same_bits(fpd_imgs[4], fpd_imgs[1]), "frames_per_dispatch=4 differs from 1"
    emit(phase="batch_and_dispatch", seconds=round(time.monotonic() - t0, 3),
         batch=dict(case="4 cornell 256x256 S=32 b30 16 iterations (fov 50-65), "
                         "make_mesh(2) on cuda:0", ms=dt_batch,
                    each_equal_to_its_own_render=batch_equal,
                    launches={k: v for k, v in c_batch.items() if v}),
         frames_per_dispatch=dict(case="cornell512 8 iterations, regen_frames=1, in turns "
                                       "1, 4, 4, 1", bit_equal=True, ms_per_frame=fpd),
         card=card)

    for key, n in launches.items():
        assert n > 0, f"{key} was never launched by the main path"
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "spectral_tpu"))
    assert not bad, f"the port imported {bad}"

    # ------------------------------------------------ bounds (flops.bound_ms)
    def ops_per_iteration(b_st, b_cfg, b_tb):
        """Ops of one live bounce iteration (``flops.kernel_ops``). A
        clustered walk is counted at its least: one cluster's members per
        nearest-hit trace, none per shadow ray, plus every pre-test."""
        runs = b_tb.clusters[1] if b_tb.clusters else ()
        n_clustered = sum(1 for run in runs if run[3])
        return flops.kernel_ops(
            b_cfg, b_st.obj_types, b_cfg.n_materials, clusters=b_tb.clusters,
            visited_fraction=1.0 / n_clustered if n_clustered else 1.0,
            visited_fraction_shadow=0.0 if n_clustered else None,
            **b_tb.feature_gates()).per_lane_bounce

    s32 = 4 * cfg.n_samples  # bytes of one lane's [S] plane
    n_main = cfg.width * cfg.height
    lane_in = 4 * 8  # six ray planes, px, py
    iters_f0 = float(cost.sum())  # live iterations of frame 0 (cuda_cost)
    iters_regen = 0.0  # frame j of the launch is frame j's primaries
    for j in range(k_main):
        j_planes, j_px, j_py = ci.primary_lanes(st, cfg, j)
        iters_regen += float(mk.run_cost(*j_planes, j_px, j_py, j, tb)[1].sum())
    opi = ops_per_iteration(st, cfg, tb)
    bounds = {
        "cuda_mono": flops.bound_ms(iters_f0 * opi, n_main * (lane_in + s32)),
        "cuda_cost": flops.bound_ms(iters_f0 * opi, n_main * (lane_in + s32 + 4)),
        "cuda_regen": flops.bound_ms(iters_regen * opi, n_main * (8 + s32)),
        "cuda_persist": flops.bound_ms(
            persist_iters * opi, 2 * n_main * (4 * 13 + 2 * s32)),
    }
    s_cost = mk.run_cost(*s_planes, s_px, s_py, 0, s_tb)[1]
    seg_iters = float(torch.clamp(s_cost, max=2.0).sum())
    n_sph = s_cfg.width * s_cfg.height
    bounds["cuda_seg"] = flops.bound_ms(
        seg_iters * ops_per_iteration(s_st, s_cfg, s_tb),
        n_sph * (4 * 10 + 2 * s32 + 4 * 8 + 2 * s32))
    torch.cuda.synchronize()
    # the probes: every pair's test, the root stage of this run's pairs with
    # disc > 0, kernel B's 3xTF32 products (flops.probe_terms)
    n_pairs = fori[1].numel() * tp.N_OBJ  # every ray against every sphere
    n_pr = fori[1].numel()
    probe_bytes = dict(fori=4 * (8 * n_pr + 4 * tp.N_OBJ), mma=4 * (21 * n_pr + 9 * tp.N_OBJ))
    probe_terms = {}
    for key in ("fori", "mma"):
        b_ms, b_by, b_term = flops.probe_bound_ms(key, n_pairs, root_pairs[key],
                                                  probe_bytes[key])
        bounds[f"cuda_probe_{key}"] = (b_ms, b_by)
        probe_terms[f"cuda_probe_{key}"] = dict(
            bound_term=b_term, pairs=n_pairs, root_pairs=root_pairs[key],
            terms_ms=flops.probe_terms(key, n_pairs, root_pairs[key], probe_bytes[key]))
    library = None  # no single PyTorch call computes a bounce loop or a nearest hit
    timings = {
        "cuda_mono": ("spectral_tpu/ops/pallas/megakernel.py:2113", mono_err, mono_ms,
                      mono_plain_ms),
        "cuda_regen": ("spectral_tpu/ops/pallas/megakernel.py:2153", regen_err, regen_ms,
                       regen_plain_ms),
        "cuda_persist": ("spectral_tpu/ops/pallas/megakernel.py:2198", persist_err,
                         persist_ms, persist_plain_ms),
        "cuda_cost": ("spectral_tpu/ops/pallas/megakernel.py:2288", cost_err, cost_ms,
                      cost_plain_ms),
        "cuda_seg": ("spectral_tpu/ops/pallas/megakernel.py:2342", seg_err, seg_ms,
                     seg_plain_ms),
        "cuda_probe_fori": ("tools/mxu_trace_probe.py:78", fori_err, fori_ms, fori_plain_ms),
        "cuda_probe_mma": ("tools/mxu_trace_probe.py:172", mma_err, mma_ms, mma_plain_ms),
    }
    sources = {"cuda_mono": "mono", "cuda_cost": "mono", "cuda_regen": "regen",
               "cuda_persist": "persist", "cuda_seg": "seg", "cuda_probe_fori": "probe",
               "cuda_probe_mma": "probe"}
    # each kernel's many-object build against its plain version: at the
    # spheres shape where the plain side is affordable, else sphere_field(100)
    sph256_case = "sphere_field(1000) 256x192 S=32 b8"
    many_object = {
        "cuda_mono": dict(case=sph256_case, bit_identical=sph256_mono_exact,
                          ms=sph256_mono_ms, plain_ms=sph256_plain_ms),
        "cuda_regen": dict(case=f"{sph256_case} K={k_sph} Morton lanes",
                           bit_identical=sph256_regen_exact, ms=sph256_regen_ms,
                           plain_ms=sph256_regen_plain_ms),
        "cuda_seg": dict(case=f"{sph256_case} bounces [0, 2)",
                         bit_identical=seg_sph256["seg0_bit_identical"],
                         ms=seg_sph256["seg0_ms"], plain_ms=seg_sph256["seg0_plain_ms"]),
        "cuda_persist": dict(case="sphere_field(100) 32x16 S=8 b1",
                             bit_identical=msmall[0]["bit_identical"]["persist"]),
        "cuda_cost": dict(case="sphere_field(100) 32x16 S=8 b1, b3",
                          bit_identical=all(m["bit_identical"]["cost"] for m in msmall)),
    }
    # each bounce kernel's triangle builds against its plain version, and
    # its times at the mesh presets' main shapes
    tri_cases = [t["case"] for t in tri]
    triangles = {
        "cuda_mono": dict(cases=tri_cases, bit_identical=all(t["bit_identical"]["mono"]
                                                             for t in tri),
                          main_path_128={k: v["mono_128"] for k, v in mesh_runs.items()},
                          ms_512={k: v["mono_ms"] for k, v in mesh_runs.items()}),
        "cuda_cost": dict(cases=tri_cases, bit_identical=all(t["bit_identical"]["cost"]
                                                             for t in tri)),
        "cuda_regen": dict(cases=tri_cases, bit_identical=all(t["bit_identical"]["regen"]
                                                              for t in tri),
                           main_path_128={k: v["regen_128"] for k, v in mesh_runs.items()},
                           launch_ms_512={k: v["regen_k_launch_ms"]
                                          for k, v in mesh_runs.items()}),
        "cuda_persist": dict(cases=[t["case"] for t in tri if "persist_bit_identical" in t],
                             bit_identical_b1=all(t["bit_identical"].get("persist", True)
                                                  for t in tri)),
        "cuda_seg": dict(cases=[t["case"] for t in tri if "seg" in t["bit_identical"]],
                         bit_identical=all(t["bit_identical"].get("seg", True) for t in tri)),
    }
    for name, key in (("cuda_mono", "mono"), ("cuda_cost", "cost"), ("cuda_regen", "regen"),
                      ("cuda_seg", "seg"), ("cuda_persist", "persist")):
        triangles[name]["feature_builds_s16_s64"] = dict(
            cases=[t["case"] for t in tri_fx],
            bit_identical=all(t["bit_identical"][key] for t in tri_fx))
    # the redesigned kernels beside the earlier design, timed in this run in
    # turns (new, parent, parent, new; the means of each)
    parent_design = {
        "cuda_persist": dict(
            design="the persist_reg build: the spectral state in registers",
            cornell512_budget=dict(budget=budget_main, **persist_main_turns),
            mesh_budget=mesh_runs["mesh"]["persist_launch"],
            mesh64_budget=dict(parent_library="persist_tri_reg",
                               **mesh_runs["mesh64"]["persist_launch"]),
            prism_budget=dict(parent_library="persist_fx_reg",
                              **prism_kernels["persist_launch_turns"])),
        "cuda_seg": dict(
            design="tables without packed records (the earlier walk)",
            spheres1000_0_2=dict(ms=seg_ms, parent_design_ms=seg_parent_ms),
            spheres1000_2_8_compacted=dict(ms=seg_tail_ms,
                                           parent_design_ms=seg_tail_parent_ms)),
    }
    # each bounce kernel's feature build against its plain version, and
    # at the prism's main shape its launch beside its bound
    s_prism = 4 * p_cfg.n_samples
    n_prism = p_cfg.width * p_cfg.height
    prism_regen_bound = flops.bound_ms(p_iters * ops_per_iteration(p_st, p_cfg, p_tb),
                                       n_prism * (8 + s_prism))
    feature_cases = [f["case"] for f in feats]
    features = {}
    for name, key in (("cuda_mono", "mono"), ("cuda_cost", "cost"), ("cuda_regen", "regen"),
                      ("cuda_seg", "seg"), ("cuda_persist", "persist")):
        features[name] = dict(
            cases=feature_cases, bit_identical=all(f["bit_identical"][key] for f in feats),
            ms={f["case"]: f["ms"][key] for f in feats},
            plain_ms={f["case"]: f["ms"][f"{key}_plain"] for f in feats},
            prism_800x600=dict(case=prism_kernels["case"], bit_identical=p_checks[key],
                               ms=p_times[key], plain_ms=p_times[f"{key}_plain"]))
        if key == "seg":
            features[name]["prism_800x600"].update(
                tail_ms=p_times["seg_tail"], tail_plain_ms=p_times["seg_tail_plain"])
    features["cuda_regen"]["prism_800x600_k100"] = dict(
        ms=p_regen_ms, bound_ms=prism_regen_bound[0], bound_by=prism_regen_bound[1],
        live_iterations=p_iters)
    # each bounce kernel with the lens (its host raygen's lens rays; regen
    # its lens table) against its plain version, and at cornell512's shape
    lens = {}
    for name, key in (("cuda_mono", "mono"), ("cuda_cost", "cost"), ("cuda_regen", "regen"),
                      ("cuda_seg", "seg")):
        lens[name] = dict(
            cases=[d["case"] for d in dof_small],
            bit_identical=all(d["bit_identical"][key] for d in dof_small),
            cornell512=dict(case=dof_main_shape["case"], bit_identical=dof_checks[key],
                            ms=dof_times[key], plain_ms=dof_times[f"{key}_plain"]))
    lens["cuda_regen"]["cornell512_k100_launch_ms"] = d_regen_ms
    lens["cuda_persist"] = dict(refused=persist_refused)
    # the shadow-interval builds against the plain path with the option
    shadow_interval = {
        "cuda_mono": dict(library="mono_si", checks=[
            dict(case=c["case"], bit_identical=c["bit_identical"]["mono"], ms=c["mono_ms"],
                 plain_ms=c["mono_plain_ms"]) for c in si_checks]),
        "cuda_cost": dict(library="mono_si", bit_identical=all(
            c["bit_identical"]["cost"] for c in si_checks)),
        "cuda_regen": dict(library="regen_si", checks=[
            dict(case=c["case"], bit_identical=c["bit_identical"]["regen"], ms=c["regen_ms"],
                 plain_ms=c["regen_plain_ms"]) for c in si_checks],
            spheres1000_k100_turns=si_timing),
    }
    kernels = []
    for name, (replaces, err, ms, plain_ms) in timings.items():
        b_ms, b_by = bounds[name]
        entry = dict(
            name=name, route="cuda",
            source=f"spectral_tpu_torch/ops/csrc/{sources[name]}.cu",
            replaces=replaces, launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library)
        if name in many_object:
            entry.update(many_object=many_object[name], triangles=triangles[name],
                         features=features[name])
        if name in parent_design:
            entry.update(parent_design=parent_design[name])
        if name in lens:
            entry.update(lens=lens[name])
        if name in shadow_interval:
            entry.update(shadow_interval=shadow_interval[name])
        if name in probe_terms:
            entry.update(bound_terms=probe_terms[name])
        if name in ("cuda_regen", "cuda_mono", "cuda_persist", "cuda_cost"):
            # the launches of this kernel in the later phases (after a
            # render, the live render's, the sharded ones), by counted run
            entry.update(post_render_launches={
                phase: c[name] for phase, c in slice_launches.items() if name in c})
        if name in ("cuda_regen", "cuda_mono"):
            # more than 256 materials: bit for bit with the plain version,
            # the material rows in shared or in global memory
            entry.update(many_materials=[dict(
                case=m["case"], materials_shared=m["materials"]["materials_shared"],
                bit_identical=m["materials"]["bit_identical"][name],
                ms_256x192=m["materials"][("cuda_mono_ms_256x192" if name == "cuda_mono"
                                           else "cuda_regen_k2_ms_256x192")])
                for m in many_mat])
        kernels.append(entry)
    emit(phase="done", seconds=round(time.monotonic() - t_all, 3), card=card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
