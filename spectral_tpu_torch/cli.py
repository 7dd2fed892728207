"""Command-line entry point of the PyTorch/CUDA port (the twin of the reference
package's ``spectral_tpu.cli``: ``render``, ``animate``, ``scene dump``,
``describe`` and ``compare``, same flag names):

    python -m spectral_tpu_torch render --preset cornell --out cornell.png
    python -m spectral_tpu_torch render --preset default --width 320 \\
        --height 240 --iterations 1 --device cpu
    python -m spectral_tpu_torch render --preset cornell --persist \\
        --adaptive 16,0.02,1e-4 --out adaptive.png
    python -m spectral_tpu_torch render --preset spheres --iterations 100 \\
        --out spheres.png
    python -m spectral_tpu_torch render --preset spheres --phase-split auto \\
        --out spheres_phased.png
    python -m spectral_tpu_torch render --preset mesh5k --width 512 \\
        --height 512 --bounces 30 --iterations 100 --out mesh5k.png
    python -m spectral_tpu_torch render --preset prism --out prism.png
    python -m spectral_tpu_torch render --preset cornell --aperture 0.05 \\
        --focus-distance 2.0 --out cornell_dof.png
    python -m spectral_tpu_torch scene dump --preset cornell --out s.json
    python -m spectral_tpu_torch render --scene s.json --out x.exr \\
        --aovs aov.exr --denoise
    python -m spectral_tpu_torch animate --preset cornell --orbit 360 \\
        --frames 4 --gif x.gif
    python -m spectral_tpu_torch describe --scene s.json
    python -m spectral_tpu_torch compare a.png b.png

    python -m spectral_tpu_torch render --preset cornell --width 512 \\
        --height 512 --iterations 100000 --serve 8000 --quiet
    python -m spectral_tpu_torch render --preset cornell --mesh 4 \\
        --out sharded.png
    python -m spectral_tpu_torch render --preset cornell --mesh 2 \\
        --num-processes 2 --process-id 0 --coordinator 127.0.0.1:29500
    python -m spectral_tpu_torch render --preset cornell --mesh 2 \\
        --num-processes 2 --process-id 1 --coordinator 127.0.0.1:29500

The first Ctrl-C, or the live view's Abort button (``--serve``), finishes
the current chunk (persist: launch), saves the image and a resumable
checkpoint (``--checkpoint``, else ``<out>.ckpt.npz``), and exits;
``--resume`` continues from it. ``--serve`` and ``--preview-every`` cap
the default chunk at 16 frames.

``--mesh N`` renders N row slabs (``parallel/mesh.py``); with
``--coordinator``, ``--num-processes`` and ``--process-id`` (or
torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``) the
processes join one group first, split the slabs evenly, and only process
0 logs and writes files. The group's backend is NCCL where each process
has a card of its own, gloo on the CPU or on a shared card
(``distributed.choose_backend``).
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

from spectral_tpu_torch.scene.presets import PRESETS as _PRESET_MAKERS
from spectral_tpu_torch.utils.text_resources import HELP

# every preset renders through the port
PRESETS = tuple(_PRESET_MAKERS)


def _parse_phase(value, allow_auto: bool = True):
    """--phase-split / --phase-capacity: int, comma list of ints, or
    'auto' (split only), passed through to Renderer (the reference's
    ``cli._parse_phase``)."""
    if value is None:
        return value
    if value == "auto":
        if not allow_auto:
            raise SystemExit(
                "--phase-capacity does not accept 'auto'; use "
                "--phase-split auto to tune splits AND capacities together"
            )
        return value
    parts = [int(p) for p in str(value).split(",") if p != ""]
    return parts[0] if len(parts) == 1 else tuple(parts)


def _add_render_overrides(p: argparse.ArgumentParser) -> None:
    p.add_argument("--width", type=int, help=HELP["width"])
    p.add_argument("--height", type=int, help=HELP["height"])
    p.add_argument("--iterations", type=int, help=HELP["iterations"])
    p.add_argument("--bounces", type=int, help=HELP["max_bounces"])
    p.add_argument("--samples", type=int, help=HELP["spectrum_samples"])
    p.add_argument("--aperture", type=float,
                   help="thin-lens aperture radius (world units); 0 = "
                        "pinhole (depth of field, beyond the reference)")
    p.add_argument("--focus-distance", type=float,
                   help="focus-plane distance along the view axis "
                        "(with --aperture > 0)")


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the hand-written kernels; cpu their "
                        "plain PyTorch versions")


def _load_scene(args):
    from spectral_tpu_torch.scene import presets
    from spectral_tpu_torch.utils import sceneio

    if args.scene:
        scene = sceneio.load_scene(args.scene)
    else:
        scene = presets.PRESETS[args.preset]()
    if args.width is not None:
        scene.width = args.width
    if args.height is not None:
        scene.height = args.height
    if args.iterations is not None:
        scene.nbr_of_iterations = args.iterations
    if args.bounces is not None:
        scene.nbr_of_ray_bounces = args.bounces
    if args.samples is not None:
        scene.spectrum_number_of_samples = args.samples
        scene.update_all_spectrum_sample_sizes()
    # "is not None": an explicit 0 must reach Scene.validate()
    if args.aperture is not None:
        scene.camera.aperture_radius = args.aperture
    if args.focus_distance is not None:
        scene.camera.focus_distance = args.focus_distance
    return scene


def cmd_render(args) -> int:
    """The reference's ``cmd_render`` (``spectral_tpu/cli.py:82-342``):
    the progress line, ``--preview-every``, the live view (``--serve``:
    frames at most once a second, abort from the page, a scene edit
    rebuilds the Renderer and restarts), ``--profile``, a resumable
    abort, and the row-sharded render over ``--mesh`` slots in one or
    more processes."""
    from spectral_tpu_torch.parallel import distributed

    multi = bool(args.coordinator or args.num_processes or distributed.env_configured())
    if args.serve is not None and multi:
        raise SystemExit(
            "--serve is single-process only (the live framebuffer fetch "
            "cannot be time-gated deterministically across processes); use "
            "--preview-every instead"
        )
    if args.persist and args.mesh and (args.resume or args.checkpoint):
        print("--persist checkpoints are single-device: drop --mesh or "
              "--resume/--checkpoint", file=sys.stderr)
        return 2
    if multi:
        # join the process group before any device use
        backend = distributed.initialize(args.coordinator, args.num_processes,
                                         args.process_id, device=args.device)
        print(f"distributed: process {distributed.rank()}/{distributed.world_size()} "
              f"({backend})", file=sys.stderr, flush=True)
    try:
        return _render(args)
    finally:
        distributed.shutdown()


def _render(args) -> int:
    from spectral_tpu_torch.parallel import distributed
    from spectral_tpu_torch.render.renderer import Renderer

    adaptive = None
    if args.adaptive is not None:
        if not args.persist:
            print("--adaptive requires --persist (it runs on the "
                  "free-running persist kernel)", file=sys.stderr)
            return 2
        try:
            mn, rt, at = args.adaptive.split(",")
            adaptive = (int(mn), float(rt), float(at))
        except ValueError:
            print(f"--adaptive expects MIN,RTOL,ATOL (got {args.adaptive!r})",
                  file=sys.stderr)
            return 2
    phase_split = _parse_phase(args.phase_split)
    phase_capacity = _parse_phase(args.phase_capacity, allow_auto=False)
    scene = _load_scene(args)
    regen = args.regen_frames if args.regen_frames == "auto" else int(args.regen_frames)
    if regen == "auto" and (args.serve is not None or args.preview_every):
        # progress, previews and abort act at chunk granularity: 16-frame
        # chunks update a live view about six times as often as the
        # default 100 (PERF.md section 6 measures what they cost on the
        # H100); an explicit --regen-frames overrides this
        regen = ("auto", 16)

    sharding = None
    if args.mesh:
        from spectral_tpu_torch.parallel.mesh import make_mesh, row_sharding

        sharding = row_sharding(make_mesh(args.mesh, device=args.device))
    primary = distributed.is_primary()  # only process 0 logs and saves

    def build_renderer(sc):
        return Renderer(
            sc, device=args.device, regen_frames=1 if args.persist else regen,
            regen_sort={"auto": "auto", "on": True, "off": False}[args.regen_sort],
            persist=args.persist, persist_budget=args.persist_budget,
            adaptive=adaptive, persist_keep_state=bool(args.checkpoint),
            phase_split=phase_split, phase_capacity=phase_capacity,
            sharding=sharding, frames_per_dispatch=args.frames_per_dispatch,
        )

    t0 = time.monotonic()
    renderer = build_renderer(scene)
    if args.resume:
        renderer.load_checkpoint(args.resume)
        if primary:
            print(f"resumed at frame {renderer.next_frame}", file=sys.stderr)

    viewer = None
    if args.serve is not None:
        from spectral_tpu_torch.utils.viewer import LiveViewer

        try:
            viewer = LiveViewer(port=args.serve)
        except OSError as e:
            print(f"--serve: cannot serve the live view on port {args.serve}: {e}",
                  file=sys.stderr)
            return 1
    try:
        if viewer is not None:
            viewer.publish_scene(scene)
            print(f"live view at {viewer.url}", file=sys.stderr, flush=True)
        renderer, scene, aborted = _run_render(args, build_renderer, renderer, scene,
                                               viewer, primary)
    finally:
        if viewer is not None:
            viewer.close()
    # a collective under a process group: every process joins, 0 writes
    renderer.save_image(args.out, exposure=args.exposure, gamma=args.gamma)
    checkpoint = args.checkpoint
    if checkpoint is None and aborted:
        if args.persist and args.mesh:
            # a sharded persist render carries no host-side resume state:
            # the partial image is saved, the auto-checkpoint skipped
            if primary:
                print("sharded persist aborts are not resumable; partial image saved",
                      file=sys.stderr)
        else:
            checkpoint = f"{args.out}.ckpt.npz"  # auto-save: a resumable abort
    if checkpoint:
        renderer.save_checkpoint(checkpoint)
        if primary:
            print(f"checkpoint -> {checkpoint}", file=sys.stderr)
    fb = renderer.framebuffer() if (args.aovs or args.denoise is not None) else None
    if not primary:
        return 0
    verb = "aborted after" if aborted else "rendered"
    print(f"{verb} {renderer.next_frame} iterations in {time.monotonic() - t0:.1f}s "
          f"on {args.device} -> {args.out} ({scene.width}x{scene.height})",
          file=sys.stderr)
    if renderer.phase_split is not None:
        print(f"phased: stages {renderer.phase_stages}, "
              f"{renderer.overflow_frames} overflow frames rendered again "
              "on the mono kernel", file=sys.stderr)
    info = renderer.persist_info
    if info is not None and "mean_counts" in info:
        cap = renderer.config.intended_frames
        print(
            f"adaptive: {info['mean_counts']:.1f} frames/pixel mean "
            f"(min {info['min_counts']}, max {info['max_counts']}, cap "
            f"{cap}, compactions {info['compactions']}): "
            f"{100.0 * (1.0 - info['mean_counts'] / cap):.0f}% of frame "
            "work saved against the fixed-count render",
            file=sys.stderr,
        )
    if aborted and checkpoint:
        print(f"resume with --resume {checkpoint}", file=sys.stderr)
    if fb is not None:
        _post_process(args, scene, fb)
    return 0


def _run_render(args, build_renderer, renderer, scene, viewer, primary=True):
    """Render until the last frame, an abort or the end of the live
    view's edits; returns the renderer and scene it ended on and whether
    the render was aborted. The first Ctrl-C, the page's Abort button and
    a pending scene edit each end the render at the next chunk (persist:
    launch); a second Ctrl-C raises as usual. A submitted edit rebuilds
    the renderer and restarts accumulation (the reference's edit-then-
    Start cycle); ``--profile`` traces all of it."""
    stop = {"requested": False}

    def on_sigint(_sig, _frame):
        if stop["requested"]:
            raise KeyboardInterrupt
        stop["requested"] = True
        print("\nabort requested: finishing the current chunk "
              "(Ctrl-C again to force quit)", file=sys.stderr)

    last_view = [0.0]
    last_preview = [time.monotonic()]

    def progress(p):
        if viewer is not None and time.monotonic() - last_view[0] > 1.0:
            viewer.update(renderer.framebuffer(), p.frame_id + 1, p.total_frames,
                          p.elapsed_s)
            last_view[0] = time.monotonic()
        if not args.quiet and primary:
            print(
                f"\rframe {p.frame_id + 1}/{p.total_frames} "
                f"({p.fraction:5.1%})  elapsed {p.elapsed_s:6.1f}s  "
                f"eta {p.eta_s:6.1f}s  {p.mpaths_per_s:7.1f} Mpaths/s  "
                f"{p.seconds_per_frame * 1e3:.2f} ms/frame",
                end="", file=sys.stderr, flush=True,
            )
        if args.preview_every and time.monotonic() - last_preview[0] > args.preview_every:
            renderer.save_image(args.out, exposure=args.exposure, gamma=args.gamma)
            last_preview[0] = time.monotonic()

    def abort():  # polled once per chunk
        return stop["requested"] or (
            viewer is not None
            and (viewer.abort_requested() or viewer.scene_edit_pending()))

    def run():
        nonlocal renderer, scene
        while True:
            renderer.render(progress=progress, abort=abort,
                            check_finite=args.check_finite)
            if viewer is None or stop["requested"] or viewer.abort_requested():
                return
            edited = viewer.take_scene_edit()
            if edited is None:
                return
            scene = edited
            renderer = build_renderer(scene)
            viewer.publish_scene(scene)
            print("\nscene edited via live view — restarting render", file=sys.stderr)

    prev_handler = signal.signal(signal.SIGINT, on_sigint)
    try:
        if args.profile:
            _profiled(run, args.profile, args.device)
        else:
            run()
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    if not args.quiet and primary:
        print(file=sys.stderr)
    return renderer, scene, abort()


def _profiled(fn, out_dir, device) -> None:
    """Run ``fn`` under ``torch.profiler`` (the host's activity, and the
    card's kernels when the device is the card) and write the Chrome
    trace into ``out_dir``, with the program's spans and counts
    (``runtime/trace.py``, on while the profiler records) as host events
    ``spectral.<name>`` on a track of their own."""
    import json
    import os
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from spectral_tpu_torch.runtime import trace

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    trace.clear()
    with profile(activities=activities) as prof:
        # one paired reading of the spans' clock and the wall clock that
        # the trace's times are taken from
        perf0, wall0_ns = time.perf_counter(), time.time_ns()
        fn()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "render_trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    origin_us = (wall0_ns - int(doc.get("baseTimeNanoseconds", 0))) / 1e3
    doc["traceEvents"].extend(trace.chrome_events(
        trace.rows(), lambda t: origin_us + (t - perf0) * 1e6, os.getpid(), 0))
    path.write_text(json.dumps(doc))
    print(f"\nprofile -> {path}", file=sys.stderr)


def _post_process(args, scene, fb) -> None:
    """``--aovs`` and ``--denoise`` after the render, in the reference's
    order (``spectral_tpu/cli.py:302-340``): the G-buffers into DIR (.npy
    and .png previews) or one multi-layer EXR with the beauty pass, then
    the denoised copy next to ``--out`` (``<stem>.denoised<ext>``, the
    display transform applied as to ``--out``). The AOVs are computed
    once, on ``--device``, for both."""
    from pathlib import Path

    import numpy as np

    from spectral_tpu_torch.render import image as image_mod
    from spectral_tpu_torch.render.aov import compute_aovs, save_aovs, save_aovs_exr
    from spectral_tpu_torch.render.denoise import atrous_denoise

    aovs = compute_aovs(scene, args.device)
    if args.aovs:
        if str(args.aovs).endswith(".exr"):
            save_aovs_exr(aovs, args.aovs, beauty=np.asarray(fb, np.float32))
            what = "multi-layer EXR (beauty+depth/normal/albedo/obj_id)"
        else:
            save_aovs(aovs, args.aovs)
            what = "AOVs (depth/normal/albedo/obj_id)"
        if not args.quiet:
            print(f"{what} -> {args.aovs}", file=sys.stderr)
    if args.denoise is not None:
        out = Path(args.out)
        dn_path = out.with_name(out.stem + ".denoised" + out.suffix)
        rgb = atrous_denoise(fb[..., :3], aovs["depth"], aovs["normal"], aovs["albedo"],
                             iterations=args.denoise, device=args.device)
        denoised = np.concatenate([rgb, fb[..., 3:4]], axis=-1)
        image_mod.save_image(denoised, dn_path, exposure=args.exposure, gamma=args.gamma)
        if not args.quiet:
            print(f"denoised ({args.denoise} a-trous levels) -> {dn_path}",
                  file=sys.stderr)


def cmd_animate(args) -> int:
    """Render a keyframe animation (the reference's ``cmd_animate``)."""
    import dataclasses as dc
    import json as json_mod
    from pathlib import Path

    from spectral_tpu_torch.render import animation as anim_mod

    if not (args.out_dir or args.gif or args.dump_anim):
        print("animate: no output requested — pass --out-dir and/or --gif",
              file=sys.stderr)
        return 2

    # --scene/--preset override an embedded base scene; with neither
    # given, an --anim file's embedded scene is used as-is (the preset
    # default only applies when there is nothing embedded to use)
    explicit_scene = args.scene is not None or args.preset is not None
    if args.preset is None:
        args.preset = "default"
    scene = _load_scene(args)

    if args.anim:
        anim = anim_mod.load_animation(
            args.anim, scene=scene if explicit_scene else None
        )
        if not explicit_scene:
            # size/quality overrides still apply to the embedded scene
            for attr, val in (
                ("width", args.width), ("height", args.height),
                ("nbr_of_iterations", args.iterations),
                ("nbr_of_ray_bounces", args.bounces),
            ):
                if val is not None:
                    setattr(anim.scene, attr, val)
            if args.samples is not None:
                anim.scene.spectrum_number_of_samples = args.samples
                anim.scene.update_all_spectrum_sample_sizes()
        # dataclasses.replace re-runs __post_init__ validation on the
        # overridden frame count / playback rate
        anim = dc.replace(
            anim,
            n_frames=args.frames if args.frames is not None else anim.n_frames,
            fps=args.fps if args.fps is not None else anim.fps,
        )
    elif args.orbit is not None:
        n = args.frames if args.frames is not None else 48
        center = (
            tuple(float(c) for c in args.orbit_center.split(","))
            if args.orbit_center
            else (0.0, 0.0, 0.0)
        )
        anim = anim_mod.Animation(
            scene,
            n_frames=n,
            tracks=anim_mod.orbit_tracks(
                scene, degrees=args.orbit, n_frames=n, center=center
            ),
            fps=args.fps if args.fps is not None else 12.0,
        )
    else:
        print("animate: pass --anim tracks.json or --orbit DEGREES",
              file=sys.stderr)
        return 2

    t0 = time.monotonic()

    def progress(done, total):
        if args.quiet:
            return
        dt = time.monotonic() - t0
        eta = dt / done * (total - done) if done else 0.0
        print(
            f"\rframe {done}/{total}  {dt:6.1f}s elapsed  eta {eta:6.1f}s",
            end="", file=sys.stderr, flush=True,
        )

    frames = anim_mod.render_animation(
        anim,
        iterations=args.iterations,
        devices=[args.device],
        out_dir=args.out_dir,
        progress=progress,
        shutter=args.shutter,
    )
    if not args.quiet:
        print(file=sys.stderr)
    if args.gif:
        anim_mod.save_gif(frames, args.gif, fps=anim.fps)
        if not args.quiet:
            print(f"wrote {args.gif}", file=sys.stderr)
    if args.dump_anim:
        Path(args.dump_anim).write_text(
            json_mod.dumps(anim_mod.animation_to_dict(anim), indent=2)
        )
        if not args.quiet:
            print(f"wrote {args.dump_anim}", file=sys.stderr)
    return 0


def cmd_scene_dump(args) -> int:
    from spectral_tpu_torch.scene import presets
    from spectral_tpu_torch.utils import sceneio

    scene = presets.PRESETS[args.preset]()
    sceneio.save_scene(scene, args.out)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_describe(args) -> int:
    if args.help_for is not None:
        key = args.help_for
        if key == "list":
            for k in sorted(HELP):
                print(k)
            return 0
        if key not in HELP:
            near = ", ".join(k for k in sorted(HELP) if key in k) or "none"
            print(f"no help entry {key!r} (close: {near})", file=sys.stderr)
            return 2
        print(HELP[key])
        return 0
    scene = _load_scene(args)
    scene.validate()
    print(f"{scene.width}x{scene.height}, {scene.nbr_of_iterations} iterations, "
          f"{scene.nbr_of_ray_bounces} bounces, "
          f"{scene.spectrum_number_of_samples} wavelength samples "
          f"({scene.spectrum_lower_bound:.0f}-{scene.spectrum_upper_bound:.0f} nm)")
    print(f"camera: pos {scene.camera.position} dir {scene.camera.direction} "
          f"fov {scene.camera.fov_y_deg} deg")
    print(f"{len(scene.lights)} lights:")
    for light in scene.lights:
        tag = " [hidden]" if light.hidden else ""
        print(f"  {light.name}: at {light.position}, spectrum {light.spectrum.name!r}{tag}")
    print(f"{len(scene.objects)} objects:")
    for o in scene.objects:
        tag = " [hidden]" if o.hidden else ""
        kind = type(o.object_type).__name__
        if hasattr(o.object_type, "n_triangles"):
            kind += f" ({o.object_type.n_triangles} triangles)"
        print(f"  {o.name}: {kind} at {o.position}, "
              f"material {o.material.name!r}{tag}")
    print(f"{len(scene.materials)} materials:")
    for m in scene.materials:
        extra = ""
        if m.transmission:
            extra += (f", transmission {m.transmission} (ior {m.ior}"
                      f"{', cauchy ' + str(m.cauchy_b_um2) if m.cauchy_b_um2 else ''})")
        if m.emission is not None:
            extra += f", emission {m.emission.name!r}"
        if m.texture is not None:
            extra += (f", checker texture (scale {m.texture.scale}, "
                      f"low {m.texture.low})")
        print(f"  {m.name}: metallicness {m.metallicness}, "
              f"roughness {m.roughness}{extra}")
    print(f"{len(scene.spectra)} spectra")
    return 0


def cmd_compare(args) -> int:
    """Pixel RMSE between two images (the BASELINE accuracy metric)."""
    import numpy as np
    from PIL import Image

    def load(p):
        return np.asarray(Image.open(p).convert("RGB"), dtype=np.float32) / 255.0

    a, b = load(args.a), load(args.b)
    if a.shape != b.shape:
        print(f"size mismatch: {a.shape} vs {b.shape}", file=sys.stderr)
        return 1
    diff = a - b
    rmse = float(np.sqrt(np.mean(diff**2)))
    mae = float(np.abs(diff).mean())
    p99 = float(np.quantile(np.abs(diff).max(axis=-1), 0.99))
    print(f"rmse {rmse:.5f}  mae {mae:.5f}  p99|diff| {p99:.5f}  "
          f"(units: [0,1] pixel intensity)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="spectral_tpu_torch",
        description="Spectral path tracer, PyTorch + CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("render", help="render a scene progressively")
    src = pr.add_mutually_exclusive_group()
    src.add_argument("--preset", choices=PRESETS, default="default")
    src.add_argument("--scene", help="path to a scene JSON file")
    _add_render_overrides(pr)
    pr.add_argument("--out", default="render.png",
                    help="output image by extension: png/jpg/bmp/tiff "
                         "(8-bit, the reference's formats) or exr "
                         "(linear HDR float, beyond the reference)")
    _add_device(pr)
    pr.add_argument("--regen-frames", default="auto", metavar="K",
                    help="frames per regeneration launch ('auto' or K >= 1)")
    pr.add_argument("--regen-sort", choices=("auto", "on", "off"), default="auto",
                    help="cost-sorted pixel->lane assignment for the "
                         "regeneration kernel, from a 2-frame path-cost probe "
                         "(bit-exact per pixel); 'auto' leaves it off")
    pr.add_argument("--persist", action="store_true",
                    help="free-running lane-asynchronous batch render: every "
                         "lane advances through its own frame stream with its "
                         "state carried between launches. Whole-render batch; "
                         "an abort returns the per-pixel average of completed "
                         "frames, and --checkpoint/--resume save and restore "
                         "the carried lane state (pass --persist to resume)")
    pr.add_argument("--persist-budget", type=int, default=None, metavar="B",
                    help="bounce iterations per persist launch (default: "
                         "~64 frames' worth from a one-frame cost probe)")
    pr.add_argument("--adaptive", default=None, metavar="MIN,RTOL,ATOL",
                    help="(with --persist) per-pixel variance-adaptive "
                         "stopping: each pixel renders until the standard "
                         "error of its per-frame luminance mean is under "
                         "RTOL*|mean|+ATOL, with at least MIN frames; "
                         "iterations becomes the cap. E.g. --adaptive 16,0.02,1e-4")
    pr.add_argument("--phase-split",
                    help="occupancy-compacted rendering (many-object scenes): "
                         "bounces [0,N) on the full wavefront, the surviving "
                         "lanes compacted for the tail bounces; a comma list "
                         "(e.g. 1,3) cascades through successively smaller "
                         "wavefronts; 'auto' probes the scene's occupancy and "
                         "chooses splits and capacities; a frame that "
                         "overflows is rendered again on the mono kernel")
    pr.add_argument("--phase-capacity",
                    help="compacted-wavefront lane capacity (default: 1/16 "
                         "of the image); comma list, one per split")
    pr.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="render N row slabs, one per mesh slot (0 = one "
                         "device); the slots split evenly over the processes "
                         "and go to each process's GPUs round-robin")
    pr.add_argument("--coordinator", metavar="HOST:PORT",
                    help="multi-process: the process group's address (or set "
                         "MASTER_ADDR and MASTER_PORT)")
    pr.add_argument("--num-processes", type=int,
                    help="multi-process: total process count (or WORLD_SIZE)")
    pr.add_argument("--process-id", type=int,
                    help="multi-process: this process's index (or RANK)")
    pr.add_argument("--frames-per-dispatch", type=int, default=1, metavar="K",
                    help="render K progressive frames per dispatch on the frame "
                         "by frame path (K mono launches with no host "
                         "synchronisation between them); progress and abort "
                         "act every K frames")
    pr.add_argument("--checkpoint", help=HELP["checkpoint"])
    pr.add_argument("--resume", help="resume from a checkpoint file")
    pr.add_argument("--preview-every", type=float, default=0.0, metavar="SECONDS",
                    help="write the output image every SECONDS while rendering")
    pr.add_argument("--serve", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve a live progressive view over HTTP (frame, "
                         "progress, abort button, scene editor); PORT 0 or "
                         "omitted picks a free port")
    pr.add_argument("--profile", metavar="DIR",
                    help="trace the render with torch.profiler (the host, and "
                         "the card's kernels on --device cuda) and write a "
                         "Chrome trace into DIR")
    pr.add_argument("--quiet", action="store_true")
    pr.add_argument("--check-finite", action="store_true",
                    help="validate the accumulator each chunk; abort on NaN/Inf")
    pr.add_argument("--exposure", type=float, default=None,
                    help="opt-in display transform: scale linear RGB by "
                         "this factor before u8 conversion (default: the "
                         "reference's straight linear output)")
    pr.add_argument("--gamma", type=float, default=None,
                    help="opt-in display transform: encode with 1/gamma "
                         "(e.g. 2.2) before u8 conversion (default: the "
                         "reference's no-gamma output, a documented quirk)")
    pr.add_argument("--aovs", metavar="DIR|FILE.exr",
                    help="also write first-hit feature buffers (depth, "
                         "shading normal, albedo, object id) as .npy + .png "
                         "previews into DIR, or, when the argument ends in "
                         ".exr, as ONE multi-layer ZIP-compressed EXR with "
                         "the beauty pass")
    pr.add_argument("--denoise", nargs="?", const=5, default=None,
                    type=int, metavar="LEVELS",
                    help="also write an AOV-guided a-trous denoised copy "
                         "of the render next to --out (<stem>.denoised<ext>); "
                         "LEVELS a-trous passes (default 5). Post-process "
                         "only: the beauty image and checkpoints are "
                         "untouched")
    pr.set_defaults(func=cmd_render)

    pa = sub.add_parser("animate", help="render a keyframe animation, "
                        "optionally motion-blurred")
    srca = pa.add_mutually_exclusive_group()
    srca.add_argument("--preset", choices=PRESETS, default=None,
                      help="base scene preset; with --anim and neither "
                           "--preset nor --scene, the animation file's "
                           "embedded scene is used")
    srca.add_argument("--scene", help="path to a scene JSON file")
    _add_render_overrides(pa)
    pa.add_argument("--anim", help="animation JSON: {n_frames, fps, tracks:"
                    " [{path, keys: [[t, value], ...]}]}; an embedded "
                    "scene is overridden by --scene/--preset")
    pa.add_argument("--orbit", type=float, metavar="DEGREES",
                    help="turntable: orbit the camera by DEGREES around "
                         "--orbit-center, always looking at it")
    pa.add_argument("--orbit-center", metavar="X,Y,Z",
                    help="orbit center (default 0,0,0)")
    pa.add_argument("--frames", type=int, help="number of animation frames")
    pa.add_argument("--fps", type=float, help="GIF playback rate")
    pa.add_argument("--out-dir", help="write frame_NNNN.png files here")
    pa.add_argument("--gif", help="write an animated GIF here")
    pa.add_argument("--dump-anim", help="write the resolved animation "
                    "(including the generated orbit tracks) as JSON")
    pa.add_argument("--shutter", type=float, default=0.0,
                    help="motion blur: shutter width in frame-intervals "
                         "(0.5 = 180-degree shutter; 0 = off). Each "
                         "progressive iteration samples the tracks at one "
                         "deterministic time in a centered window, so the "
                         "accumulated frame integrates the shutter")
    _add_device(pa)
    pa.add_argument("--quiet", action="store_true")
    pa.set_defaults(func=cmd_animate)

    ps = sub.add_parser("scene", help="scene file utilities")
    pssub = ps.add_subparsers(dest="scene_command", required=True)
    pd = pssub.add_parser("dump", help="write a preset as an editable JSON scene")
    pd.add_argument("--preset", choices=PRESETS, default="default")
    pd.add_argument("--out", required=True)
    pd.set_defaults(func=cmd_scene_dump)

    pc = sub.add_parser("compare", help="pixel RMSE between two images")
    pc.add_argument("a")
    pc.add_argument("b")
    pc.set_defaults(func=cmd_compare)

    pdesc = sub.add_parser("describe", help="validate and summarize a scene")
    srcd = pdesc.add_mutually_exclusive_group()
    srcd.add_argument("--preset", choices=PRESETS, default="default")
    srcd.add_argument("--scene", help="path to a scene JSON file")
    _add_render_overrides(pdesc)
    pdesc.add_argument(
        "--help-for", metavar="KEY", dest="help_for",
        help="print the help entry for a scene/spectrum knob "
             "('list' shows all keys); the reference's tooltip catalog "
             "(text_resources.rs) surfaced headlessly",
    )
    pdesc.set_defaults(func=cmd_describe)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
