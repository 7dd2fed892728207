"""Command-line entry point of the PyTorch/CUDA port (the twin of the reference
package's ``spectral_tpu.cli`` render command, same flag names):

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
    python -m spectral_tpu_torch render --preset cornell --aperture 0.05 \
        --focus-distance 2.0 --out cornell_dof.png

The first Ctrl-C finishes the current chunk (persist: launch), saves the
image and a resumable checkpoint (``--checkpoint``, else
``<out>.ckpt.npz``), and exits; ``--resume`` continues from it.
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
# image formats the port writes (render/image.py: .exr is not ported)
UNWRITABLE = (".exr",)


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


def _load_scene(args):
    from spectral_tpu_torch.scene import presets

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
    from spectral_tpu_torch.render.renderer import Renderer

    if args.out.lower().endswith(UNWRITABLE):
        # refused before the render, not after it
        print(f"--out {args.out}: .exr output is not in the PyTorch/CUDA port "
              "yet (ROADMAP.md queue 1); save .png/.jpg/.bmp/.tiff", file=sys.stderr)
        return 2
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
    begin = time.monotonic()
    renderer = Renderer(
        scene, device=args.device, regen_frames=1 if args.persist else regen,
        regen_sort={"auto": "auto", "on": True, "off": False}[args.regen_sort],
        persist=args.persist, persist_budget=args.persist_budget,
        adaptive=adaptive, persist_keep_state=bool(args.checkpoint),
        phase_split=phase_split, phase_capacity=phase_capacity,
    )
    if args.resume:
        renderer.load_checkpoint(args.resume)
        print(f"resumed at frame {renderer.next_frame}", file=sys.stderr)

    # the first Ctrl-C ends the render at the next chunk (persist: launch)
    # and saves a resumable checkpoint; a second one raises as usual
    stop = {"requested": False}

    def on_sigint(_sig, _frame):
        if stop["requested"]:
            raise KeyboardInterrupt
        stop["requested"] = True
        print("\nabort requested: finishing the current chunk "
              "(Ctrl-C again to force quit)", file=sys.stderr)

    def progress(p):
        if not args.quiet:
            print(
                f"\rframe {p.frame_id + 1}/{p.total_frames} "
                f"{p.seconds_per_frame * 1e3:.2f} ms/frame",
                end="", file=sys.stderr, flush=True,
            )

    prev_handler = signal.signal(signal.SIGINT, on_sigint)
    try:
        renderer.render(progress=progress, abort=lambda: stop["requested"])
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    aborted = stop["requested"]
    renderer.save_image(args.out)
    checkpoint = args.checkpoint
    if checkpoint is None and aborted:
        checkpoint = f"{args.out}.ckpt.npz"  # auto-save: a resumable abort
    if checkpoint:
        renderer.save_checkpoint(checkpoint)
        if not args.quiet:
            print(f"\ncheckpoint -> {checkpoint}", file=sys.stderr)
    if not args.quiet:
        verb = "aborted after" if aborted else "wrote"
        print(
            f"\n{verb} {renderer.next_frame} frames in "
            f"{time.monotonic() - begin:.2f} s on {args.device} -> {args.out} "
            f"({scene.width}x{scene.height})",
            file=sys.stderr,
        )
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
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="spectral_tpu_torch",
        description="Spectral path tracer, PyTorch + CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("render", help="render a preset progressively")
    pr.add_argument("--preset", choices=PRESETS, default="default")
    pr.add_argument("--width", type=int, help=HELP["width"])
    pr.add_argument("--height", type=int, help=HELP["height"])
    pr.add_argument("--iterations", type=int, help=HELP["iterations"])
    pr.add_argument("--bounces", type=int, help=HELP["max_bounces"])
    pr.add_argument("--samples", type=int, help=HELP["spectrum_samples"])
    pr.add_argument("--aperture", type=float,
                    help="thin-lens aperture radius (world units); 0 = "
                         "pinhole (depth of field, beyond the reference)")
    pr.add_argument("--focus-distance", type=float,
                    help="focus-plane distance along the view axis "
                         "(with --aperture > 0)")
    pr.add_argument("--out", default="render.png", help="output image (png/jpg/bmp/tiff)")
    pr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
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
    pr.add_argument("--checkpoint", help=HELP["checkpoint"])
    pr.add_argument("--resume", help="resume from a checkpoint file")
    pr.add_argument("--quiet", action="store_true")
    pr.set_defaults(func=cmd_render)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
