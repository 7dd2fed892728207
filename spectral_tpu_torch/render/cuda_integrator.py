"""Frame integration through the CUDA bounce kernels (the twin of the
reference package's ``spectral_tpu.render.pallas_integrator``).

Primary rays come from the port's own raygen for every frame, including
the K-1 later frames of a regeneration launch, which are precomputed here
as direction planes (the reference does the same: re-deriving raygen
inside the kernel flips the un-offset diffuse self-hit coin). On CPU
tensors the kernel wrappers run their plain versions.
"""

from __future__ import annotations

import torch

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render.camera import generate_primary_rays
from spectral_tpu_torch.render.color import spectra_to_rgb
from spectral_tpu_torch.render.integrator import accumulate_frame, accumulate_frames
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors


def primary_lanes(scene: SceneTensors, config: RenderConfig, frame_id: int):
    """Lane planes for the kernels: ``(ox, oy, oz, dx, dy, dz)`` f32 and
    ``(px, py)`` int32, all contiguous ``[W*H]``."""
    origin, direction, px, py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame_id, config.intended_frames,
    )
    planes = tuple(c.contiguous() for c in (*origin, *direction))
    return planes, px.to(torch.int32), py.to(torch.int32)


def _to_rgb(rad: torch.Tensor, scene: SceneTensors, config: RenderConfig):
    rgb = spectra_to_rgb(rad.T, scene.xyz_weights, scene.xyz_to_rgb)
    return rgb.reshape(config.height, config.width, 3)


def integrate_frame_cuda(
    scene: SceneTensors, config: RenderConfig, frame_id: int,
    tables: mk.KernelTables | None = None,
) -> torch.Tensor:
    """One progressive frame -> linear RGB ``[H, W, 3]`` via ``run_mono``."""
    if config.n_objects == 0:
        return torch.zeros((config.height, config.width, 3), device=scene.device)
    tables = tables or mk.pack_tables(scene, config)
    planes, px, py = primary_lanes(scene, config, frame_id)
    rad = mk.run_mono(*planes, px, py, frame_id, tables)
    return _to_rgb(rad, scene, config)


def integrate_frames_cuda_regen(
    scene: SceneTensors, config: RenderConfig, first_frame_id: int, k: int,
    tables: mk.KernelTables | None = None,
) -> torch.Tensor:
    """K progressive frames in one ``run_regen`` launch -> the SUM of their
    linear-RGB frames ``[H, W, 3]``. Every path is the one its frame's
    mono launch traces; only the order the K frames are summed in differs.
    Blend with ``integrator.accumulate_frames``."""
    if k < 2:
        raise ValueError("regen wants k >= 2 (use integrate_frame_cuda)")
    if config.n_objects == 0:
        return torch.zeros((config.height, config.width, 3), device=scene.device)
    tables = tables or mk.pack_tables(scene, config)
    planes, px, py = primary_lanes(scene, config, first_frame_id)
    later = [
        generate_primary_rays(
            scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
            config.width, config.height, first_frame_id + j,
            config.intended_frames,
        )[1]
        for j in range(1, k)
    ]
    dirx = torch.stack([d.x for d in later])
    diry = torch.stack([d.y for d in later])
    dirz = torch.stack([d.z for d in later])
    del later
    rad = mk.run_regen(*planes, px, py, first_frame_id, dirx, diry, dirz, tables)
    return _to_rgb(rad, scene, config)


def render_frame_step_cuda(
    scene: SceneTensors, config: RenderConfig, accum: torch.Tensor,
    frame_id: int, tables: mk.KernelTables | None = None,
) -> torch.Tensor:
    """One progressive frame (one ``run_mono`` launch) blended into the
    accumulator."""
    rgb = integrate_frame_cuda(scene, config, frame_id, tables)
    return accumulate_frame(accum, rgb, frame_id)


def render_frames_step_cuda_regen(
    scene: SceneTensors, config: RenderConfig, accum: torch.Tensor,
    first_frame_id: int, k: int, tables: mk.KernelTables | None = None,
) -> torch.Tensor:
    """K progressive frames (one ``run_regen`` launch) blended into the
    accumulator."""
    rgb_sum = integrate_frames_cuda_regen(scene, config, first_frame_id, k, tables)
    return accumulate_frames(accum, rgb_sum, first_frame_id, k)
