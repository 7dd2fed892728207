"""Command-line entry point of the PyTorch/CUDA port (the twin of the reference
package's ``spectral_tpu.cli`` render command, same flag names):

    python -m spectral_tpu_torch render --preset cornell --out cornell.png
    python -m spectral_tpu_torch render --preset default --width 320 \\
        --height 240 --iterations 1 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

from spectral_tpu.utils.text_resources import HELP

# the presets the port's first slice renders
PRESETS = ("default", "cornell")


def _load_scene(args):
    from spectral_tpu.scene import presets

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
    return scene


def cmd_render(args) -> int:
    from spectral_tpu_torch.render.renderer import Renderer

    scene = _load_scene(args)
    regen = args.regen_frames if args.regen_frames == "auto" else int(args.regen_frames)
    begin = time.monotonic()
    renderer = Renderer(scene, device=args.device, regen_frames=regen)

    def progress(p):
        if not args.quiet:
            print(
                f"\rframe {p.frame_id + 1}/{p.total_frames} "
                f"{p.seconds_per_frame * 1e3:.2f} ms/frame",
                end="", file=sys.stderr, flush=True,
            )

    renderer.render(progress=progress)
    renderer.save_image(args.out)
    if not args.quiet:
        print(
            f"\nwrote {args.out} ({scene.width}x{scene.height}, "
            f"{renderer.next_frame} frames, {time.monotonic() - begin:.2f} s "
            f"on {args.device})",
            file=sys.stderr,
        )
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
    pr.add_argument("--out", default="render.png", help="output image (png/jpg/bmp/tiff/exr)")
    pr.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the hand-written kernels; cpu their "
                         "plain PyTorch versions")
    pr.add_argument("--regen-frames", default="auto", metavar="K",
                    help="frames per regeneration launch ('auto' or K >= 1)")
    pr.add_argument("--quiet", action="store_true")
    pr.set_defaults(func=cmd_render)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
