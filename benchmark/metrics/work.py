"""The work of a window's renders and its least time on the card.

Operations are the frozen op table's per-lane-bounce counts
(``ops_table.kernel_ops``) times the live lane-bounce iterations that the
benchmark's reference counted on its pixel sample, scaled to the image
and to the frames the window rendered; a clustered walk is counted at the
members of the clusters each trace enters before its nearest hit (each
shadow ray: before its blocker or the light), as the reference found
them. Bytes are each launch's inputs read and outputs written once."""

from __future__ import annotations

import math
import sys

from benchmark.metrics import ops_table
from benchmark.reference import clusters, paths


def _tables(view):
    from benchmark.harness import scene

    return paths.tables(scene.scene_dict(view.cell.config), "cpu")


def per_frame_ops(view) -> tuple[float, object]:
    """``(ops of one frame of the whole image, the RenderConfig)`` from the
    reference's sample."""
    st, cfg = _tables(view)
    work = view.work
    if work is None or work.lanes == 0:
        raise ValueError("no reference work was counted")
    iters = work.iterations / work.lanes
    plan = clusters.renderer_plan(st.np_fields, cfg.n_objects)
    vf = vfs = 1.0
    if plan is not None:
        clustered = sum(stop - start for _t, start, stop, cl in plan[1] if cl)
        vf = work.nearest_members / (work.iterations * clustered)
        vfs = work.shadow_members / (work.iterations * max(cfg.n_lights, 1) * clustered)
    per_bounce = ops_table.kernel_ops(cfg, st.obj_types, cfg.n_materials, clusters=plan,
                                      visited_fraction=vf,
                                      visited_fraction_shadow=vfs).per_lane_bounce
    pixels = cfg.width * cfg.height
    frame = pixels * (iters * per_bounce + 6 * cfg.n_samples + 10)
    return frame, cfg


def roofline_pct(name: str, ops: float, n_bytes: float, kernel_s: float) -> float | None:
    """The least time over the kernels' summed device time, in percent;
    the bounding term goes to standard error."""
    if kernel_s <= 0.0 or not math.isfinite(ops):
        return None
    ms, term = ops_table.bound_ms(ops, n_bytes)
    print(f"{name}: least time {ms:.6f} ms bound by {term}, kernels {1e3 * kernel_s:.6f} ms",
          file=sys.stderr)
    return 100.0 * 1e-3 * ms / kernel_s


def regen_roofline_pct(view, name: str) -> float | None:
    """``cuda_regen``'s least time over its device time in the window: the
    larger of the window's operations over 67 TFLOP/s FP32 and its bytes
    (per launch: the lanes' pixel coordinates in, their [S] radiance out)
    over 3.35 TB/s, over the summed device time of ``regen_kernel``."""
    kernel_s = view.kernel_seconds("regen_kernel")
    if not kernel_s:
        return None
    frame_ops, cfg = per_frame_ops(view)
    frames = view.driver.frames_rendered()
    launches = len(view.driver.images) * -(-cfg.intended_frames // view.driver.chunk)
    n_bytes = launches * cfg.width * cfg.height * (8 + 4 * cfg.n_samples)
    return roofline_pct(name, frames * frame_ops, n_bytes, kernel_s)
