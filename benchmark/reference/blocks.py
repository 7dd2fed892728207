"""The plain reference of a render of many launches, block by block.

``paths.regen_image`` traces every frame of the sample at once and treats
every chunk as one launch. At the hero frame's size that is more memory
than a card holds (1,000 frames of the sample, one ``[lanes, S]`` term per
bounce), and its last chunk is not what the renderer does: the renderer
(``Renderer._render_chunks``) runs full chunks of K frames as one
regeneration launch each and then renders each remaining frame alone on
the mono kernel, blending it with ``accumulate_frame``'s ``1 - ratio``
form. This module follows that plan: it traces one block of frames at a
time (a full chunk, then the remaining frames together, fewer than one
chunk), so peak memory is one launch's worth of the sample. Each lane's
sum keeps ``paths.trace_sample``'s order, frame after frame and bounce
after bounce, so every chunk's sum keeps its bits.

It imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import camera
from benchmark.reference.flatten import RenderConfig, SceneTensors
from benchmark.reference.paths import Work, _f32, accumulate_frames, to_rgb, trace_sample
from benchmark.reference.rng import MASK32


def chunk_plan(n_frames: int, chunk: int) -> list[tuple[int, int]]:
    """The renderer's ``(first, k)`` launches of ``n_frames`` frames at K =
    ``chunk``: full chunks of ``chunk`` frames (when ``chunk`` > 1), then
    every remaining frame alone."""
    full = n_frames // chunk if chunk > 1 else 0
    return ([(c * chunk, chunk) for c in range(full)]
            + [(f, 1) for f in range(full * chunk, n_frames)])


def accumulate_frame(accum, rgb, frame_id: int):
    """The renderer's blend of one frame's RGB into the running average
    (``1 / (frame + 1)`` weights in the ``1 - ratio`` form; frozen copy of
    the program's formula)."""
    ratio = 1.0 / _f32((int(frame_id) + 1) & MASK32, accum.device)
    old_factor = 1.0 - ratio
    new_rgb = accum[..., :3] * old_factor + rgb * ratio
    new_a = accum[..., 3] * old_factor + ratio
    return torch.cat([new_rgb, new_a[..., None]], dim=-1)


def regen_plan_image(st: SceneTensors, cfg: RenderConfig, px, py, n_frames: int, chunk: int,
                     work: Work | None = None) -> torch.Tensor:
    """``[P, 4]`` framebuffer values of a render of ``n_frames`` frames
    with ``regen_frames=chunk`` (``chunk_plan``): each full chunk's sum
    blended with ``accumulate_frames``, each remaining frame with
    ``accumulate_frame``. ``work``, when given, adds up what every block's
    paths needed."""
    table = camera.camera_basis_table(st, cfg)
    offsets = camera.hammersley_table(0, n_frames, cfg.intended_frames, st.device)

    def directions(fr):
        return camera.primary_directions(px.long(), py.long(), table,
                                         offsets[fr, 0], offsets[fr, 1])

    plan = chunk_plan(n_frames, chunk)
    full = [c for c in plan if c[1] > 1]
    tail = [c for c in plan if c[1] == 1]
    blocks = [[c] for c in full] + ([tail] if tail else [])
    accum = torch.zeros((px.shape[0], 4), dtype=torch.float32, device=st.device)
    for block in blocks:
        frames = [f for first, k in block for f in range(first, first + k)]
        sums = trace_sample(st, cfg, px, py, frames, directions, block, work)
        for (first, k), rad in zip(block, sums):
            rgb = to_rgb(rad, st)
            accum = (accumulate_frames(accum, rgb, first, k) if k > 1
                     else accumulate_frame(accum, rgb, first))
    return accum
