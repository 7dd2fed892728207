"""Arbitrary output variables (AOVs): first-hit G-buffers (the port of
``spectral_tpu.render.aov``).

Per-pixel depth, shading normal, first-hit albedo colour and object id
from one primary-ray trace over pixel-centre rays
(``generate_primary_rays`` at frame 0 of 1, whose screen-wide Hammersley
offset is exactly (0.5, 0.5)), with the render path's own intersection
tests and normal dispatch, so the buffers are geometrically consistent
with the beauty render. The reference's ``_aov_program`` is a plain jnp
program outside any Pallas kernel; its port is the same eager ops on the
renderer's device: the dense trace (``ops/geometry.trace``, in ray chunks
above ``BROADCAST_BUDGET``), ``surface_normal``, ``spectra_to_rgb`` and
``checker_factor``. No kernel of its own.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spectral_tpu_torch.ops.geometry import surface_normal, trace
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render.camera import generate_primary_rays
from spectral_tpu_torch.render.color import spectra_to_rgb
from spectral_tpu_torch.render.integrator import FX_TEXTURE, checker_factor, scene_features
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors

__all__ = ["compute_aovs", "aov_buffers", "pixel_centre_rays", "save_aovs", "save_aovs_exr"]


def pixel_centre_rays(scene: SceneTensors, config: RenderConfig) -> tuple[Vec3, Vec3]:
    """The AOVs' primary rays: frame 0 of 1 (pixel centres). No lens even
    when the camera has an aperture: G-buffers are defined at the pinhole
    view (a lens-averaged "first hit" is not a geometric quantity)."""
    origin, direction, _px, _py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, 0, 1,
    )
    return origin, direction


def aov_buffers(scene: SceneTensors, config: RenderConfig,
                origin: Vec3, direction: Vec3) -> dict:
    """The G-buffers of the rays ``origin``/``direction`` (``[H*W]`` lane
    planes, row-major) as tensors on the scene's device, in the
    reference's op order: ``depth`` ``[H, W]`` (+inf on miss), ``normal``
    and ``albedo`` ``[H, W, 3]`` (zeros on miss), ``obj_id`` ``[H, W]``
    int32 (-1 on miss)."""
    h, w = config.height, config.width
    res = trace(origin, direction, scene)
    hit = res.hit
    depth = torch.where(hit, res.t, torch.inf).reshape(h, w)

    ip = origin + direction * res.t
    n = surface_normal(ip, res.obj_idx, scene, origin=origin, direction=direction)
    normal = torch.stack([n.x, n.y, n.z], dim=-1)
    normal = torch.where(hit[:, None], normal, 0.0).reshape(h, w, 3)

    # the hit object's albedo spectrum through the beauty image's CIE
    # pipeline (linear RGB, out-of-gamut values may be negative)
    albedo = spectra_to_rgb(scene.albedo[res.obj_idx], scene.xyz_weights, scene.xyz_to_rgb)
    if scene_features(scene) & FX_TEXTURE:
        # the checker modulation, so a denoiser demodulating by this
        # buffer keeps the texture pattern exactly
        texf = checker_factor(ip.x, ip.y, ip.z, scene.tex_scale[res.obj_idx],
                              scene.tex_low[res.obj_idx])
        albedo = albedo * texf[:, None]
    albedo = torch.where(hit[:, None], albedo, 0.0).reshape(h, w, 3)

    obj_id = torch.where(hit, res.obj_idx, -1).to(torch.int32).reshape(h, w)
    return {"depth": depth, "normal": normal, "albedo": albedo, "obj_id": obj_id}


def compute_aovs(scene, device: str | torch.device = "cuda") -> dict:
    """First-hit feature buffers for ``scene`` (a schema ``Scene``),
    computed on ``device`` and returned as numpy arrays: ``depth``
    ``[H, W]`` f32 ray-parameter distance (+inf where nothing is hit),
    ``normal`` ``[H, W, 3]`` f32 unit shading normal (zeros on miss),
    ``albedo`` ``[H, W, 3]`` f32 linear RGB first-hit reflectance (zeros
    on miss), and ``obj_id`` ``[H, W]`` int32 index into the flattened
    object rows (-1 on miss): the ``scene.objects`` index for scenes
    without meshes, one id per triangle for mesh faces."""
    from spectral_tpu_torch.scene.flatten import flatten_scene

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("compute_aovs(device='cuda') needs a CUDA GPU; pass device='cpu'")
    st, config = flatten_scene(scene, device)
    h, w = config.height, config.width
    if config.n_objects == 0:
        return {
            "depth": np.full((h, w), np.inf, np.float32),
            "normal": np.zeros((h, w, 3), np.float32),
            "albedo": np.zeros((h, w, 3), np.float32),
            "obj_id": np.full((h, w), -1, np.int32),
        }
    if device.type == "cuda":
        # the albedo's matmuls must not drop to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    out = aov_buffers(st, config, *pixel_centre_rays(st, config))
    return {k: v.cpu().numpy() for k, v in out.items()}


def save_aovs(aovs: dict, out_dir) -> list:
    """Write each buffer as ``.npy`` (exact) plus a ``.png`` preview
    (depth: normalized over the finite range, misses white; normal:
    ``0.5 + 0.5 n``; albedo: clamped; obj_id: hashed to colors).
    Returns the written paths."""
    from spectral_tpu_torch.render import image as image_mod

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, arr in aovs.items():
        p = out / f"{name}.npy"
        np.save(p, arr)
        written.append(p)

    def _png(name: str, rgb: np.ndarray):
        rgba = np.concatenate(
            [rgb.astype(np.float32), np.ones_like(rgb[..., :1])], axis=-1
        )
        p = out / f"{name}.png"
        image_mod.save_image(rgba, p)
        written.append(p)

    depth = aovs["depth"]
    finite = np.isfinite(depth)
    if finite.any():
        lo = float(depth[finite].min())
        hi = float(depth[finite].max())
        span = (hi - lo) or 1.0
        vis = np.where(finite, (depth - lo) / span, 1.0).astype(np.float32)
    else:
        vis = np.ones_like(depth, np.float32)
    _png("depth", np.repeat(vis[..., None], 3, axis=-1))

    _png("normal", 0.5 + 0.5 * aovs["normal"])
    _png("albedo", np.clip(aovs["albedo"], 0.0, 1.0))

    oid = aovs["obj_id"].astype(np.int64)
    # deterministic color hash; id -1 (miss) maps to black
    r = ((oid * 2654435761) % 255) / 255.0
    g = ((oid * 40503 + 17) % 255) / 255.0
    b = ((oid * 69069 + 101) % 255) / 255.0
    ids = np.stack([r, g, b], axis=-1).astype(np.float32)
    ids[oid < 0] = 0.0
    _png("obj_id", ids)
    return written


def save_aovs_exr(aovs: dict, path, beauty: np.ndarray | None = None):
    """Write the AOVs (plus an optional beauty pass) as ONE multi-layer
    ZIP-compressed EXR: base ``R/G/B/A`` = beauty, ``depth.Z``,
    ``normal.RGB``, ``albedo.RGB``, ``obj_id.Z`` (ids as floats; -1 =
    miss). The beauty and AOV layers are written as f32 so they
    round-trip bit-exactly."""
    from spectral_tpu_torch.render.exr import write_exr_layers

    layers: dict = {
        "depth": aovs["depth"],
        "normal": aovs["normal"],
        "albedo": aovs["albedo"],
        "obj_id": aovs["obj_id"].astype(np.float32),
    }
    if beauty is not None:
        layers[""] = np.asarray(beauty, np.float32)
    return write_exr_layers(layers, path, pixel_type="float")
