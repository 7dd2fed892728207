"""Primary ray generation (the twin of ``spectral_tpu.render.camera``),
keeping the reference's quirks: flipped NDC y, the minus on the right
axis, and one Hammersley sub-pixel offset per frame for every pixel
(reference ``src/shader.rs:271-293``). Pinhole only: depth of field
raises until its slice lands."""

from __future__ import annotations

import math

import torch

from spectral_tpu_torch.ops.rng import MASK32, as_u32, hammersley, radical_inverse
from spectral_tpu_torch.ops.vecmath import Vec3

PI = math.pi


def camera_basis(cam_dir, cam_up, fov_y_deg, width: int, height: int):
    """``(forward, right, true_up, focal_distance, aspect_ratio)`` as
    float32 0-d tensors on the camera tables' device, in the exact op
    order of the reference package's ``camera_basis``."""
    dev = cam_dir.device
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(height), dtype=torch.float32, device=dev)
    aspect_ratio = w / h
    fov_half_rad = (fov_y_deg / 2.0) / 180.0 * PI
    focal_distance = 1.0 / torch.tan(fov_half_rad)
    up = Vec3(cam_up[0], cam_up[1], cam_up[2]).normalize()
    forward = Vec3(cam_dir[0], cam_dir[1], cam_dir[2]).normalize()
    right = forward.cross(up).normalize()
    true_up = right.cross(forward)
    return forward, right, true_up, focal_distance, aspect_ratio


def pixel_coords(width: int, height: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major ``(px, py)`` int64 lane planes of a ``width x height``
    image (uint32 bit patterns for the RNG seeds)."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    return idx % width, idx // width


def generate_primary_rays(
    cam_pos: torch.Tensor,
    cam_dir: torch.Tensor,
    cam_up: torch.Tensor,
    fov_y_deg: torch.Tensor,
    width: int,
    height: int,
    frame_id: int,
    intended_frames: int,
    dof=None,
) -> tuple[Vec3, Vec3, torch.Tensor, torch.Tensor]:
    """The ``[height * width]`` wavefront of camera rays for one frame.

    Returns ``(origins, directions, px, py)``; ``px``/``py`` are int64
    row-major pixel coordinates."""
    if dof is not None:
        raise NotImplementedError(
            "depth of field is not in the port yet (queued: scene-feature "
            "slice, ROADMAP queue 1 item 11)"
        )
    dev = cam_pos.device
    px, py = pixel_coords(width, height, dev)
    n = px.shape[0]
    xf = px.to(torch.float32)
    yf = py.to(torch.float32)
    w = torch.tensor(float(width), dtype=torch.float32, device=dev)
    h = torch.tensor(float(height), dtype=torch.float32, device=dev)
    forward, right, true_up, focal_distance, aspect_ratio = camera_basis(
        cam_dir, cam_up, fov_y_deg, width, height
    )
    off_x, off_y = hammersley(frame_id, intended_frames, device=dev)

    y_ndc = -(((yf + off_y) / h) * 2.0 - 1.0)
    x_ndc = (((xf + off_x) / w) * 2.0 - 1.0) * aspect_ratio

    d = forward * focal_distance - right * x_ndc + true_up * y_ndc
    # the reference normalizes in raygen AND in Ray::new
    d = d.normalize().normalize()
    origin = Vec3(
        cam_pos[0].expand(n), cam_pos[1].expand(n), cam_pos[2].expand(n)
    )
    return origin, d, px, py


# camera_basis_table columns (csrc/megakernel.cuh CB_*)
CAM_BASIS = 20


def camera_basis_table(scene, config) -> torch.Tensor:
    """The free-running persist kernel's ``[20]`` float32 camera table on
    the scene's device (the reference's ``pack_camera_basis``,
    ``megakernel.py:2545-2572``): position (0-2), forward (3-5), right
    (6-8), true up (9-11), focal distance (12), aspect ratio (13), width
    and height (14-15), the Hammersley denominator ``intended_frames``
    (16), and three pad columns. The basis is ``camera_basis``'s, in the
    host raygen's op order."""
    fwd, right, true_up, focal, aspect = camera_basis(
        scene.cam_dir, scene.cam_up, scene.fov_y_deg, config.width, config.height
    )
    dev = scene.cam_pos.device
    cols = [
        *scene.cam_pos, *fwd, *right, *true_up, focal, aspect,
        float(config.width), float(config.height), float(config.intended_frames),
        0.0, 0.0, 0.0,
    ]
    return torch.stack([
        torch.as_tensor(c, dtype=torch.float32, device=dev) for c in cols
    ])


def hammersley_table(first_frame: int, k: int, intended_frames: int,
                     device=None) -> torch.Tensor:
    """``[k, 2]`` float32 ``(off_x, off_y)`` of frames ``first_frame`` ..
    ``first_frame + k - 1``: ``hammersley`` on the host, one copy to
    ``device``. The regeneration kernel's per-frame sub-pixel offsets."""
    off_x, off_y = hammersley(torch.arange(first_frame, first_frame + k), intended_frames)
    return torch.stack([off_x, off_y], dim=1).to(device)


def primary_directions(px, py, table: torch.Tensor, off_x, off_y) -> Vec3:
    """Primary directions at pixels ``(px, py)`` from the camera table
    (``camera_basis_table``) and one frame's Hammersley offsets: the plain
    twin of the regeneration kernel's in-kernel raygen
    (``csrc/regen.cu:primary_direction``), in the op order of
    ``generate_primary_rays``, whose bits it gives (divisions, not the
    reciprocal products of ``restart_directions``)."""
    focal, aspect, w, h = table[12], table[13], table[14], table[15]
    y_ndc = -(((py.to(torch.float32) + off_y) / h) * 2.0 - 1.0)
    x_ndc = (((px.to(torch.float32) + off_x) / w) * 2.0 - 1.0) * aspect
    forward = Vec3(table[3], table[4], table[5])
    right = Vec3(table[6], table[7], table[8])
    true_up = Vec3(table[9], table[10], table[11])
    d = forward * focal - right * x_ndc + true_up * y_ndc
    return d.normalize().normalize()


def restart_directions(px, py, nf, table: torch.Tensor) -> Vec3:
    """Primary directions of frames ``nf`` at pixels ``(px, py)`` from the
    camera table: the plain twin of the free-running persist kernel's
    in-kernel raygen (reference ``megakernel.py:1677-1713``), in its op
    order. The frame-independent scalars are formed first (``sx``, ``sy``,
    ``1/N``, ``megakernel.py:1981-1987``), then the jittered NDC and two
    normalizes. Where the TPU kernel takes ``rsqrt`` this takes the
    correctly rounded ``1 / sqrt``, as the CUDA kernel does, so the two
    compute the same bits. The result lands ulps from host raygen
    (``generate_primary_rays``), which divides where this multiplies."""
    cb = table
    focal, aspect = cb[12], cb[13]
    sx = 2.0 * (1.0 / cb[14]) * aspect
    sy = 2.0 * (1.0 / cb[15])
    inv_n = 1.0 / cb[16]
    nf = as_u32(nf)
    off_x = (nf.to(torch.float32) + 0.5) * inv_n
    off_y = radical_inverse((nf + 1) & MASK32)
    x_ndc = (px.to(torch.float32) + off_x) * sx - aspect
    y_ndc = 1.0 - (py.to(torch.float32) + off_y) * sy
    d = Vec3(
        cb[3] * focal - cb[6] * x_ndc + cb[9] * y_ndc,
        cb[4] * focal - cb[7] * x_ndc + cb[10] * y_ndc,
        cb[5] * focal - cb[8] * x_ndc + cb[11] * y_ndc,
    )
    # the reference normalizes in raygen AND in Ray::new
    return d.normalize().normalize()
