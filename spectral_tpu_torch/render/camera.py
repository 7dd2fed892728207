"""Primary ray generation (the twin of ``spectral_tpu.render.camera``),
keeping the reference's quirks: flipped NDC y, the minus on the right
axis, and one Hammersley sub-pixel offset per frame for every pixel
(reference ``src/shader.rs:271-293``), and the JAX package's thin-lens
depth of field (``lens_point``): one lens point per frame, every ray
re-aimed at its pinhole ray's point on the focus plane."""

from __future__ import annotations

import math

import numpy as np
import torch

from spectral_tpu_torch.ops.rng import (
    MASK32,
    as_u32,
    hammersley,
    radical_inverse,
    random_pcg3d,
)
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.runtime.trace import span

PI = math.pi


def camera_basis(cam_dir, cam_up, fov_y_deg, width: int, height: int):
    """``(forward, right, true_up, focal_distance, aspect_ratio)`` as
    float32 0-d tensors on the camera tables' device, in the exact op
    order of the reference package's ``camera_basis``."""
    dev = cam_dir.device
    # fills, the sizes passed as kernel arguments: no copy, no wait on the card
    w = torch.full((), float(width), dtype=torch.float32, device=dev)
    h = torch.full((), float(height), dtype=torch.float32, device=dev)
    aspect_ratio = w / h
    fov_half_rad = (fov_y_deg / 2.0) / 180.0 * PI
    focal_distance = 1.0 / torch.tan(fov_half_rad)
    up = Vec3(cam_up[0], cam_up[1], cam_up[2]).normalize()
    forward = Vec3(cam_dir[0], cam_dir[1], cam_dir[2]).normalize()
    right = forward.cross(up).normalize()
    true_up = right.cross(forward)
    return forward, right, true_up, focal_distance, aspect_ratio


def scene_dof(scene, config):
    """``(aperture, focus)`` for ``generate_primary_rays`` when the config
    enables depth of field, else None (the pinhole path)."""
    return (scene.cam_aperture, scene.cam_focus) if config.has_dof else None


def lens_shifts(right, true_up, aperture, frame_ids) -> np.ndarray:
    """``[k, 3]`` float32 thin-lens origin shifts of frames ``frame_ids``
    on the host (the JAX package's ``lens_point``, same op order): one
    lens point per frame, from the PCG3D stream of ``(frame_id,
    0x9E3779B9, 0x85EBCA6B)``, ``r = aperture * sqrt(u1)``, ``theta = 2 pi
    u2``, ``shift = right r cos(theta) + true_up r sin(theta)``, in
    float32 with the root, cosine and sine taken in float64 and rounded
    once. The basis and the aperture come to the host in one copy. Host
    raygen, the regeneration kernel's lens table and its plain twin all
    take their shifts from here, so they share its bits on every
    device."""
    f32 = np.float32
    dev = right[0].device
    f32_t = torch.float32
    basis = torch.stack([*(c.to(f32_t) for c in (*right, *true_up)),
                         torch.as_tensor(aperture, dtype=f32_t, device=dev)])
    with span("wait.raygen", arg=1):
        basis = basis.cpu().numpy()
    rt, aperture = basis[:6], basis[6]
    ids = torch.as_tensor(list(frame_ids), dtype=torch.int64) & MASK32
    u1, u2, _ = random_pcg3d(ids, 0x9E3779B9, 0x85EBCA6B)
    two_pi = f32(2.0 * f32(math.pi))
    out = np.empty((ids.shape[0], 3), np.float32)
    for i, (a, b) in enumerate(zip(u1.tolist(), u2.tolist())):
        r = aperture * f32(math.sqrt(a))
        theta = two_pi * f32(b)
        lens_x = r * f32(math.cos(float(theta)))
        lens_y = r * f32(math.sin(float(theta)))
        out[i] = rt[:3] * lens_x + rt[3:] * lens_y
    return out


def lens_point(right, true_up, aperture, frame_id) -> Vec3:
    """Frame ``frame_id``'s lens shift (``lens_shifts``) as 0-d float32
    tensors on the basis's device."""
    t = torch.from_numpy(lens_shifts(right, true_up, aperture, [frame_id])[0])
    with span("wait.raygen", arg=1):
        t = t.to(right[0].device)
    return Vec3(t[0], t[1], t[2])


def refocus(d: Vec3, forward: Vec3, shift: Vec3, focus) -> Vec3:
    """The thin-lens direction from an origin moved by ``shift``: through
    the pinhole ray ``d``'s point on the plane ``focus`` along the view
    axis, ``normalize(normalize(d * t_f - shift))`` with ``t_f = focus /
    d.forward`` (the JAX package's ``generate_primary_rays``)."""
    t_f = focus / d.dot(forward)
    return (d * t_f - shift).normalize().normalize()


def pixel_coords(width: int, height: int, device,
                 row_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major ``(px, py)`` int64 lane planes of a ``width x height``
    image, or of the ``height``-row slab of a taller image that starts at
    row ``row_offset`` (``py`` is then the global row): uint32 bit
    patterns for the RNG seeds."""
    idx = torch.arange(width * height, dtype=torch.int64, device=device)
    py = idx // width
    if row_offset:
        py = py + int(row_offset)
    return idx % width, py


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
    full_height: int | None = None,
    row_offset: int = 0,
) -> tuple[Vec3, Vec3, torch.Tensor, torch.Tensor]:
    """The ``[height * width]`` wavefront of camera rays for one frame.

    Returns ``(origins, directions, px, py)``; ``px``/``py`` are int64
    row-major pixel coordinates. ``dof = (aperture_radius,
    focus_distance)`` (``scene_dof``) moves every origin by the frame's
    ``lens_point`` and re-aims each ray at its pinhole ray's point on the
    focus plane; None is the pinhole. ``full_height``/``row_offset``
    generate the ``height``-row slab of a ``full_height`` image that
    starts at row ``row_offset``, in the whole image's coordinates
    (row-sharded rendering): the NDC mapping and the aspect ratio are the
    whole image's, and each ray is its unsharded twin bit for bit."""
    dev = cam_pos.device
    px, py = pixel_coords(width, height, dev, row_offset)
    height = full_height or height
    n = px.shape[0]
    xf = px.to(torch.float32)
    yf = py.to(torch.float32)
    w = torch.full((), float(width), dtype=torch.float32, device=dev)
    h = torch.full((), float(height), dtype=torch.float32, device=dev)
    forward, right, true_up, focal_distance, aspect_ratio = camera_basis(
        cam_dir, cam_up, fov_y_deg, width, height
    )
    off_x, off_y = hammersley(frame_id, intended_frames, device=dev)

    y_ndc = -(((yf + off_y) / h) * 2.0 - 1.0)
    x_ndc = (((xf + off_x) / w) * 2.0 - 1.0) * aspect_ratio

    d = forward * focal_distance - right * x_ndc + true_up * y_ndc
    # the reference normalizes in raygen AND in Ray::new
    d = d.normalize().normalize()
    pos = Vec3(cam_pos[0], cam_pos[1], cam_pos[2])
    if dof is not None:
        aperture, focus = dof
        shift = lens_point(right, true_up, aperture, frame_id)
        d = refocus(d, forward, shift, focus)
        pos = pos + shift
    origin = Vec3(pos.x.expand(n), pos.y.expand(n), pos.z.expand(n))
    return origin, d, px, py


# camera_basis_table columns (csrc/megakernel.cuh CB_*)
CAM_BASIS = 20
CB_FOCUS = 17


def camera_basis_table(scene, config, full_height: int | None = None) -> torch.Tensor:
    """The free-running persist kernel's ``[20]`` float32 camera table on
    the scene's device (the reference's ``pack_camera_basis``,
    ``megakernel.py:2545-2572``): position (0-2), forward (3-5), right
    (6-8), true up (9-11), focal distance (12), aspect ratio (13), width
    and height (14-15), the Hammersley denominator ``intended_frames``
    (16), the focus distance with depth of field (17; else 0, like the
    reference's pad) and two pad columns. The basis is ``camera_basis``'s,
    in the host raygen's op order. ``full_height`` is the whole image's
    height when ``config`` is a row slab's: the kernels map a lane's
    global ``py`` through the whole image's height and aspect ratio."""
    height = full_height or config.height
    fwd, right, true_up, focal, aspect = camera_basis(
        scene.cam_dir, scene.cam_up, scene.fov_y_deg, config.width, height
    )
    dev = scene.cam_pos.device
    cols = [
        *scene.cam_pos, *fwd, *right, *true_up, focal, aspect,
        float(config.width), float(height), float(config.intended_frames),
        scene.cam_focus if config.has_dof else 0.0, 0.0, 0.0,
    ]
    # each host number is a copy from pageable memory (a launch input's miss)
    with span("wait.upload", arg=sum(not torch.is_tensor(c) for c in cols)):
        cols = [torch.as_tensor(c, dtype=torch.float32, device=dev) for c in cols]
    return torch.stack(cols)


def hammersley_table(first_frame: int, k: int, intended_frames: int,
                     device=None) -> torch.Tensor:
    """``[k, 2]`` float32 ``(off_x, off_y)`` of frames ``first_frame`` ..
    ``first_frame + k - 1``: ``hammersley`` on the host, one copy to
    ``device``. The regeneration kernel's per-frame sub-pixel offsets."""
    off_x, off_y = hammersley(torch.arange(first_frame, first_frame + k), intended_frames)
    table = torch.stack([off_x, off_y], dim=1)
    with span("wait.upload", arg=1):
        return table.to(device)


def lens_table(scene, config, first_frame: int, k: int):
    """``[k, 4]`` float32 ``(shift x, y, z, 0)`` of frames ``first_frame``
    .. ``first_frame + k - 1`` (``lens_shifts``; the reference's
    ``pack_camera_frames`` ships the shifted origins instead) on the
    scene's device, or None for a pinhole camera: the regeneration
    kernel's per-frame lens shifts."""
    if not config.has_dof:
        return None
    _fwd, right, true_up, _focal, _aspect = camera_basis(
        scene.cam_dir, scene.cam_up, scene.fov_y_deg, config.width, config.height
    )
    table = np.zeros((k, 4), np.float32)
    table[:, :3] = lens_shifts(right, true_up, scene.cam_aperture,
                               range(first_frame, first_frame + k))
    with span("wait.upload", arg=1):
        return torch.from_numpy(table).to(scene.cam_pos.device)


def primary_origin(table: torch.Tensor, lens_row=None) -> Vec3:
    """A frame's camera origin: the table's position, moved by the frame's
    lens shift (a ``lens_table`` row) with depth of field."""
    pos = Vec3(table[0], table[1], table[2])
    if lens_row is None:
        return pos
    return pos + Vec3(lens_row[0], lens_row[1], lens_row[2])


def primary_directions(px, py, table: torch.Tensor, off_x, off_y, lens_row=None) -> Vec3:
    """Primary directions at pixels ``(px, py)`` from the camera table
    (``camera_basis_table``) and one frame's Hammersley offsets: the plain
    twin of the regeneration kernel's in-kernel raygen
    (``csrc/regen.cu:primary_direction``), in the op order of
    ``generate_primary_rays``, whose bits it gives (divisions, not the
    reciprocal products of ``restart_directions``). With a ``lens_table``
    row, the thin-lens direction (``refocus``) at the table's focus."""
    focal, aspect, w, h = table[12], table[13], table[14], table[15]
    y_ndc = -(((py.to(torch.float32) + off_y) / h) * 2.0 - 1.0)
    x_ndc = (((px.to(torch.float32) + off_x) / w) * 2.0 - 1.0) * aspect
    forward = Vec3(table[3], table[4], table[5])
    right = Vec3(table[6], table[7], table[8])
    true_up = Vec3(table[9], table[10], table[11])
    d = (forward * focal - right * x_ndc + true_up * y_ndc).normalize().normalize()
    if lens_row is None:
        return d
    shift = Vec3(lens_row[0], lens_row[1], lens_row[2])
    return refocus(d, forward, shift, table[CB_FOCUS])


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
