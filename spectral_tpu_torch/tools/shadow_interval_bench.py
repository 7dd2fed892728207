"""Time the opt-in sqrt-free shadow test (``shadow_interval``) on the card:
the port's twin of the JAX package's ``tools/shadow_interval_bench.py``.

    python -m spectral_tpu_torch.tools.shadow_interval_bench [--spheres 1000]
        [--k 100] [--launches 2]

Renders ``presets.sphere_field(N)`` at 1024x768, 32 wavelengths, 8
bounces (``bench.py``'s config 4) on the regeneration path as the
Renderer runs it (clustered tables, Morton lanes, K frames per launch,
``render_frames_step_cuda_regen``), with the option off and on in turns
(off, on, on, off): each turn one untimed launch, then ``--launches``
launches between two CUDA events. Prints one JSON line: ms per frame of
each turn, the option's change of the mean, the image means and their
relative difference (the option is not bit-identical: a blocker within
rounding of t = 0 or t = maxd can flip), and the card's name and power
limit. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json


def bench(spheres: int = 1000, k: int = 100, launches: int = 2) -> dict:
    import torch

    from spectral_tpu_torch.ops import megakernel as mk
    from spectral_tpu_torch.render import cuda_integrator as ci
    from spectral_tpu_torch.render.layout import morton_layout
    from spectral_tpu_torch.scene import presets
    from spectral_tpu_torch.scene.flatten import flatten_scene

    if not torch.cuda.is_available():
        raise RuntimeError("shadow_interval_bench times the CUDA kernels: it needs a GPU")
    dev = torch.device("cuda")
    scene = presets.sphere_field(n_spheres=spheres, n_samples=32)
    scene.width, scene.height = 1024, 768
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = 8, k * (launches + 1)
    st, cfg = flatten_scene(scene, dev)
    tables = {"off": mk.pack_tables(st, cfg)}
    tables["on"] = mk.with_shadow_interval(tables["off"])
    perm, inv = morton_layout(cfg.width, cfg.height, dev)

    def render(key):
        accum = torch.zeros((cfg.height, cfg.width, 4), device=dev)
        accum = ci.render_frames_step_cuda_regen(st, cfg, accum, 0, k, tables[key], perm, inv)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(launches):
            accum = ci.render_frames_step_cuda_regen(st, cfg, accum, (i + 1) * k, k,
                                                     tables[key], perm, inv)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (launches * k), accum

    turns = {"off": [], "on": []}
    means, images = {}, {}
    for key in ("off", "on", "on", "off"):
        ms, images[key] = render(key)
        turns[key].append(ms)
        means[key] = float(images[key][..., :3].mean())
    diff = (images["on"] - images["off"])[..., :3].abs()
    off_ms = sum(turns["off"]) / 2
    on_ms = sum(turns["on"]) / 2
    return dict(
        config=f"sphere_field({spheres}): {cfg.n_objects} objects, 1024x768, 32 lambda, "
               f"8 bounces, regen K={k}, Morton lanes, {launches} timed launches per turn",
        ms_per_frame_turns=turns, off_ms_per_frame=off_ms, on_ms_per_frame=on_ms,
        change=on_ms / off_ms - 1.0, mean_off=means["off"], mean_on=means["on"],
        mean_rel=abs(means["on"] - means["off"]) / means["off"],
        pixels_differing=float((diff.amax(-1) > 0).float().mean()),
        max_abs=float(diff.max()))


def main(argv=None) -> int:
    from spectral_tpu_torch.tools.measure_persist import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spheres", type=int, default=1000)
    ap.add_argument("--k", type=int, default=100, help="frames per regeneration launch")
    ap.add_argument("--launches", type=int, default=2, help="timed launches per turn")
    args = ap.parse_args(argv)
    print(json.dumps(dict(bench(args.spheres, args.k, args.launches), card=card())),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
