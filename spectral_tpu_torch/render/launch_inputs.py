"""The launches' camera-derived inputs, built once per camera.

A regeneration launch needs the lanes' pixel planes, the ``[20]`` camera
table (``camera.camera_basis_table``), the frames' ``[K, 2]`` Hammersley
table and, with depth of field, the ``[K, 4]`` lens table; the persist
path needs the camera table and frame 0's primary lanes. Each depends
only on the camera, the image (or its row slab) and the frame window,
which repeat from launch to launch, from image to image, and from one
``Renderer`` to the next when an edit leaves the camera alone.

``LaunchInputs`` builds each with the build function it names, the same
function in the same op order on the same device, the first time a key
asks for it, and returns the same tensors to every later ask. The key is
host values only: the camera's fields from the scene's ``np_fields``
(their dtype and bytes), the config's sizes, the slab, the device and
the frame window; never a device readback. A scene without the camera in
``np_fields`` gets its tensors built on every ask. The memo keeps at
most ``max_entries`` entries and ``max_bytes`` of tensors, dropping the
least recently used first. Lookups count ``launch.inputs_hit`` and
``launch.inputs_miss`` (``runtime.trace``).

Callers read what they get and never write into it: ``persist_init``
copies the frame-0 planes before the persist kernel updates them in
place. Frame-by-frame raygen, whose frame changes on every call, calls
``primary_lanes``, which builds every time.
"""

from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from spectral_tpu_torch.render.camera import (
    camera_basis_table,
    generate_primary_rays,
    hammersley_table,
    lens_table,
    pixel_coords,
    scene_dof,
)
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors

CAMERA_FIELDS = ("cam_pos", "cam_dir", "cam_up", "fov_y_deg", "cam_aperture", "cam_focus")


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, tuple):
        return sum(_nbytes(v) for v in value)
    return 0


class LaunchInputs:
    """A bounded memo of device tensors under host keys (least recently
    used out first). Thread-safe; a miss builds outside the lock."""

    def __init__(self, max_entries: int = 64, max_bytes: int = 256 << 20):
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key, build):
        """The value kept under ``key``, else ``build()``, kept. A None
        key builds and keeps nothing."""
        if key is None:
            return build()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is not None:
            trace.count("launch.inputs_hit")
            return entry[0]
        trace.count("launch.inputs_miss")
        value = build()
        size = _nbytes(value)
        if size <= self.max_bytes:
            with self._lock:
                old = self._entries.pop(key, None)
                if old is not None:
                    self._bytes -= old[1]
                self._entries[key] = (value, size)
                self._bytes += size
                while len(self._entries) > self.max_entries or self._bytes > self.max_bytes:
                    self._bytes -= self._entries.popitem(last=False)[1][1]
        return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def nbytes(self) -> int:
        """The bytes of the tensors kept."""
        return self._bytes


MEMO = LaunchInputs()  # the process's: the inputs outlive each Renderer


def camera_key(scene: SceneTensors, config: RenderConfig,
               full_height: int | None = None, row_offset: int = 0) -> tuple | None:
    """The host key of everything a launch's camera inputs depend on, or
    None where ``np_fields`` lacks the camera."""
    f = scene.np_fields
    if any(f.get(name) is None for name in CAMERA_FIELDS):
        return None
    cam = tuple((a.dtype.str, a.tobytes()) for a in (np.asarray(f[n]) for n in CAMERA_FIELDS))
    return (cam, config.width, config.height, full_height or config.height, int(row_offset),
            config.intended_frames, config.has_dof, scene.device)


def _key(kind: str, base: tuple | None, *rest) -> tuple | None:
    return None if base is None else (kind, base, *rest)


def pixel_planes(scene: SceneTensors, config: RenderConfig,
                 lane_perm: torch.Tensor | None = None,
                 full_height: int | None = None, row_offset: int = 0):
    """The lanes' ``(px, py)`` int32 planes (``camera.pixel_coords``), lane
    ``p`` on pixel ``lane_perm[p]`` (row-major without one). A permuted
    pair is kept per permutation tensor, by identity: its entry holds the
    permutation, so the identity is not reused while the entry lives."""
    base = camera_key(scene, config, full_height, row_offset)

    def rowmajor():
        px, py = pixel_coords(config.width, config.height, scene.device, row_offset)
        return px.to(torch.int32), py.to(torch.int32)

    px, py = MEMO.get(_key("pixels", base), rowmajor)
    if lane_perm is None:
        return px, py
    _perm, ppx, ppy = MEMO.get(_key("lane_pixels", base, id(lane_perm)),
                               lambda: (lane_perm, px[lane_perm], py[lane_perm]))
    return ppx, ppy


def camera_table(scene: SceneTensors, config: RenderConfig,
                 full_height: int | None = None, row_offset: int = 0) -> torch.Tensor:
    """``camera.camera_basis_table`` of the scene, config and image height."""
    return MEMO.get(_key("camera", camera_key(scene, config, full_height, row_offset)),
                    lambda: camera_basis_table(scene, config, full_height))


def frame_tables(scene: SceneTensors, config: RenderConfig, first_frame: int, k: int,
                 full_height: int | None = None, row_offset: int = 0):
    """``(Hammersley table, lens table)`` of frames ``first_frame`` ..
    ``first_frame + k - 1`` (``camera.hammersley_table``,
    ``camera.lens_table``: None for a pinhole)."""
    return MEMO.get(
        _key("frames", camera_key(scene, config, full_height, row_offset),
             int(first_frame), int(k)),
        lambda: (hammersley_table(first_frame, k, config.intended_frames, scene.device),
                 lens_table(scene, config, first_frame, k)))


def primary_lanes(scene: SceneTensors, config: RenderConfig, frame_id: int,
                  full_height: int | None = None, row_offset: int = 0):
    """Lane planes for the kernels: ``(ox, oy, oz, dx, dy, dz)`` f32 and
    ``(px, py)`` int32, all contiguous ``[W*H]``. ``full_height``/
    ``row_offset``: ``config`` is the row slab of a ``full_height`` image
    from row ``row_offset`` (``generate_primary_rays``). Built on every
    call: the frame-by-frame paths' frame changes from call to call."""
    origin, direction, px, py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame_id, config.intended_frames,
        dof=scene_dof(scene, config), full_height=full_height, row_offset=row_offset,
    )
    planes = tuple(c.contiguous() for c in (*origin, *direction))
    return planes, px.to(torch.int32), py.to(torch.int32)


def frame0_lanes(scene: SceneTensors, config: RenderConfig,
                 full_height: int | None = None, row_offset: int = 0):
    """Frame 0's ``primary_lanes``: read them, never write into them."""
    return MEMO.get(_key("lanes0", camera_key(scene, config, full_height, row_offset)),
                    lambda: primary_lanes(scene, config, 0, full_height, row_offset))
