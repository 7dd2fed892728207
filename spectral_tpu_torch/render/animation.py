"""Keyframe animation and motion blur (the port of
``spectral_tpu.render.animation``).

Declarative keyframe tracks over the scene schema, and a renderer that
deals whole animation frames over devices: frames are independent renders
of the same-shaped scene, so each device renders whole frames on the
single-scene path (``Renderer``) with no collectives.
:func:`render_animation` takes a list of torch devices and runs one host
thread per device. :func:`render_batch_spmd` splits a batch of
same-shaped scenes over a mesh's slots (``parallel/mesh.py``), in one
process or across processes.

Tracks address scene fields by path (``camera.position``,
``objects[2].object_type.radius``, ``materials[0].roughness``, ...) with
linear interpolation between keyframes; a track only rewrites schema
fields, so an animated frame is validated by the same
``Scene.validate()`` the static path uses. The track and JSON functions
are copies of the reference's with only the imports changed.

Motion blur (``shutter > 0``) renders every progressive iteration of a
frame from the scene at one shutter time (``_motion_blur_schedule``):
the Renderer flattens that time's scene on the host, copies its tables
to the device and launches one ``cuda_mono`` on them
(``Renderer(_scene_schedule=)``), with the cluster plan and the feature
build fixed from the first scene and the schedule's flags.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from spectral_tpu_torch.scene.schema import Scene, SceneError

__all__ = [
    "Track",
    "Animation",
    "orbit_tracks",
    "render_animation",
    "save_gif",
    "animation_from_dict",
    "animation_to_dict",
    "load_animation",
    "save_animation",
]


_INDEXED = re.compile(r"^(objects|lights|materials)\[(\d+)\]$")

# Paths a track may animate. Everything here changes scene *values* only
# — never array shapes — so every frame of an animation flattens to the
# same RenderConfig and shares one compiled render program.
_CAMERA_VECS = ("position", "direction", "up")
_OBJECT_TYPE_FIELDS = (
    "radius",
    "x_length",
    "y_length",
    "z_length",
    "x_rotation",
    "y_rotation",
    "z_rotation",
)
_MATERIAL_SCALARS = (
    "metallicness",
    "roughness",
    "transmission",
    "ior",
    "cauchy_b_um2",
)


@dataclasses.dataclass
class Track:
    """One animated scene field.

    ``path``: dotted field path into the scene schema, with ``[i]`` list
    indexing — e.g. ``camera.position``, ``objects[3].position``,
    ``objects[3].object_type.y_rotation``, ``lights[0].position``,
    ``materials[1].roughness``, ``camera.fov_y_deg``.

    ``keys``: ``[(t, value), ...]`` with ``t`` in [0, 1] ascending and
    ``value`` a float or a length-3 sequence, matching the field. Values
    are linearly interpolated; outside the keyed range the end values
    hold.
    """

    path: str
    keys: list

    def __post_init__(self) -> None:
        if not self.keys:
            raise ValueError(f"track {self.path!r} has no keyframes")
        ts = [float(t) for t, _ in self.keys]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise ValueError(
                f"track {self.path!r} keyframe times must be ascending"
            )

    def value_at(self, t: float):
        """Linearly interpolate the track at time ``t`` (clamped)."""
        keys = [(float(kt), _as_value(v)) for kt, v in self.keys]
        if t <= keys[0][0]:
            return keys[0][1]
        if t >= keys[-1][0]:
            return keys[-1][1]
        for (t0, v0), (t1, v1) in zip(keys, keys[1:]):
            if t0 <= t <= t1:
                if t1 == t0:
                    return v1
                w = (t - t0) / (t1 - t0)
                if isinstance(v0, tuple):
                    return tuple(a + (b - a) * w for a, b in zip(v0, v1))
                return v0 + (v1 - v0) * w
        return keys[-1][1]  # unreachable; keys are ascending


def _as_value(v):
    if isinstance(v, (int, float)):
        return float(v)
    v = tuple(float(x) for x in v)
    if len(v) != 3:
        raise ValueError(f"vector keyframe values must have length 3, got {v}")
    return v


def _apply_path(scene: Scene, path: str, value) -> None:
    """Write ``value`` at ``path`` into ``scene`` (mutating it)."""
    parts = path.split(".")
    if parts[0] == "camera":
        if len(parts) != 2:
            raise ValueError(f"unsupported track path {path!r}")
        if parts[1] in _CAMERA_VECS:
            if not isinstance(value, tuple):
                raise ValueError(f"{path!r} expects a 3-vector keyframe")
            setattr(scene.camera, parts[1], value)
            return
        if parts[1] in ("fov_y_deg", "aperture_radius", "focus_distance"):
            # aperture/focus tracks animate depth of field (rack focus);
            # note aperture must stay on one side of 0 across the whole
            # animation — has_dof is static, and crossing it would split
            # the frames over two compiled programs (the same-RenderConfig
            # check below rejects that loudly)
            setattr(scene.camera, parts[1], float(value))
            return
        raise ValueError(f"unsupported track path {path!r}")

    m = _INDEXED.match(parts[0])
    if not m:
        raise ValueError(f"unsupported track path {path!r}")
    kind, idx = m.group(1), int(m.group(2))
    seq = getattr(scene, kind)
    if idx >= len(seq):
        raise ValueError(
            f"track path {path!r}: index {idx} out of range "
            f"({len(seq)} {kind})"
        )
    target = seq[idx]

    if kind in ("objects", "lights") and parts[1:] == ["position"]:
        if not isinstance(value, tuple):
            raise ValueError(f"{path!r} expects a 3-vector keyframe")
        target.position = value
        return
    if kind == "objects" and len(parts) == 3 and parts[1] == "object_type":
        field = parts[2]
        if field not in _OBJECT_TYPE_FIELDS or not hasattr(
            target.object_type, field
        ):
            raise ValueError(
                f"track path {path!r}: {type(target.object_type).__name__} "
                f"has no animatable field {field!r}"
            )
        # geometry variants are frozen dataclasses — replace, don't mutate
        target.object_type = dataclasses.replace(
            target.object_type, **{field: float(value)}
        )
        return
    if kind == "materials" and len(parts) == 2 and parts[1] in _MATERIAL_SCALARS:
        setattr(target, parts[1], float(value))
        return
    raise ValueError(f"unsupported track path {path!r}")


@dataclasses.dataclass
class Animation:
    """A base scene plus keyframe tracks over ``n_frames`` time steps.

    Frame ``f`` is the base scene with every track evaluated at
    ``t = f / (n_frames - 1)`` (``t = 0`` for a single frame). The base
    scene is never mutated — each frame is built on a deep copy, which
    preserves the schema's identity-based spectrum/material references
    (``Scene.validate``, schema.py).
    """

    scene: Scene
    n_frames: int
    tracks: list[Track] = dataclasses.field(default_factory=list)
    fps: float = 12.0

    def __post_init__(self) -> None:
        if self.n_frames < 1:
            raise ValueError("n_frames must be >= 1")
        if self.fps <= 0:
            raise ValueError("fps must be positive")

    def time_at(self, frame: int) -> float:
        if self.n_frames == 1:
            return 0.0
        return frame / (self.n_frames - 1)

    def scene_at(self, frame: int) -> Scene:
        """The fully-evaluated scene for animation frame ``frame``."""
        if not 0 <= frame < self.n_frames:
            raise ValueError(
                f"frame {frame} out of range [0, {self.n_frames})"
            )
        return self.scene_at_time(self.time_at(frame))

    def scene_at_time(self, t: float) -> Scene:
        """The fully-evaluated scene at normalized track time ``t`` in
        [0, 1] — continuous sampling between frames is what motion blur
        integrates over."""
        out = copy.deepcopy(self.scene)
        for track in self.tracks:
            _apply_path(out, track.path, track.value_at(t))
        out.validate()
        return out


def orbit_tracks(
    scene: Scene,
    degrees: float = 360.0,
    n_frames: int = 48,
    center: Sequence[float] = (0.0, 0.0, 0.0),
    axis: str = "y",
) -> list[Track]:
    """Turntable helper: camera position/direction tracks orbiting
    ``center`` by ``degrees`` around a world axis, starting at the base
    scene's camera pose and always looking at ``center``. One keyframe
    per frame, so linear interpolation is exact at frame times."""
    if axis not in ("x", "y", "z"):
        raise ValueError("axis must be 'x', 'y' or 'z'")
    c = np.asarray(center, dtype=np.float64)
    p0 = np.asarray(scene.camera.position, dtype=np.float64)
    pos_keys, dir_keys = [], []
    n = max(n_frames, 1)
    # a whole number of full turns loops: sample the circle half-open
    # (frame n-1 stops one step short of the start pose) so a looping
    # GIF has no duplicated frame; partial arcs sample inclusively
    rem = abs(degrees) % 360.0
    loop = degrees != 0.0 and min(rem, 360.0 - rem) < 1e-9
    for f in range(n):
        t = 0.0 if n == 1 else f / (n - 1)
        ang = math.radians(degrees) * (f / n if loop else t)
        ca, sa = math.cos(ang), math.sin(ang)
        r = p0 - c
        if axis == "y":
            rot = np.array(
                [ca * r[0] + sa * r[2], r[1], -sa * r[0] + ca * r[2]]
            )
        elif axis == "x":
            rot = np.array(
                [r[0], ca * r[1] - sa * r[2], sa * r[1] + ca * r[2]]
            )
        else:  # z
            rot = np.array(
                [ca * r[0] - sa * r[1], sa * r[0] + ca * r[1], r[2]]
            )
        p = c + rot
        d = c - p
        norm = float(np.linalg.norm(d))
        if norm < 1e-12:
            raise ValueError("camera position coincides with orbit center")
        d = d / norm
        pos_keys.append((t, tuple(float(x) for x in p)))
        dir_keys.append((t, tuple(float(x) for x in d)))
    return [
        Track("camera.position", pos_keys),
        Track("camera.direction", dir_keys),
    ]


# ----------------------------------------------------------------- JSON IO

ANIMATION_FORMAT_VERSION = 1


def animation_to_dict(anim: Animation, include_scene: bool = True) -> dict:
    from spectral_tpu_torch.utils.sceneio import scene_to_dict

    out = {
        "format": "spectral_tpu.animation",
        "version": ANIMATION_FORMAT_VERSION,
        "n_frames": anim.n_frames,
        "fps": anim.fps,
        "tracks": [
            {"path": t.path, "keys": [[kt, v] for kt, v in t.keys]}
            for t in anim.tracks
        ],
    }
    if include_scene:
        out["scene"] = scene_to_dict(anim.scene)
    return out


def animation_from_dict(data: dict, scene: Scene | None = None) -> Animation:
    """Build an :class:`Animation` from its JSON form. ``scene``
    overrides any embedded base scene (the CLI's ``--scene`` flag)."""
    from spectral_tpu_torch.utils.sceneio import scene_from_dict

    if data.get("format") not in (None, "spectral_tpu.animation"):
        raise ValueError(f"not an animation file: format={data.get('format')!r}")
    if scene is None:
        if "scene" not in data:
            raise ValueError(
                "animation JSON embeds no scene; pass one explicitly"
            )
        scene = scene_from_dict(data["scene"])
    tracks = [
        Track(t["path"], [(float(k[0]), k[1]) for k in t["keys"]])
        for t in data.get("tracks", [])
    ]
    return Animation(
        scene=scene,
        n_frames=int(data.get("n_frames", 1)),
        tracks=tracks,
        fps=float(data.get("fps", 12.0)),
    )


def save_animation(anim: Animation, path) -> None:
    Path(path).write_text(json.dumps(animation_to_dict(anim), indent=2))


def load_animation(path, scene: Scene | None = None) -> Animation:
    return animation_from_dict(
        json.loads(Path(path).read_text()), scene=scene
    )


# -------------------------------------------------------------- rendering


def _vdc_base3(n: int) -> float:
    """Base-3 van der Corput radical inverse (host-side float64).

    The shutter-time stream for motion blur: a low-discrepancy sequence
    over [0, 1) chosen in a base COPRIME to the render's own base-2
    streams (the sub-pixel jitter is radical-inverse base 2, reference
    ``src/shader.rs:655``; the DoF lens point is PCG3D) so time samples
    decorrelate from both."""
    f, inv = 0.0, 1.0 / 3.0
    while n:
        f += (n % 3) * inv
        n //= 3
        inv /= 3.0
    return f


def _tracks_can_enable(anim: Animation, field: str) -> bool:
    """True if any track writes ``field`` with a nonzero key value —
    conservative: interpolation between keys never leaves the convex
    hull, so all-zero keys (plus an all-zero base) keep the field off."""
    for tr in anim.tracks:
        if tr.path.endswith("." + field):
            for _t, v in tr.keys:
                if float(np.max(np.abs(np.atleast_1d(np.asarray(v, float))))) > 0:
                    return True
    return False


def _motion_blur_schedule(
    anim: Animation, frame: int, shutter: float, cfg0, scene_prep
):
    """``frame_id -> host tables`` (``flatten.flatten_numpy``'s field
    dict) sampling the shutter around animation frame ``frame``.

    Screen-wide sampling, as the reference does: each progressive
    iteration draws ONE shutter time for the whole image (like the
    sub-pixel jitter and the thin-lens point), so accumulation over
    iterations integrates the shutter interval, and iteration ``k`` is
    deterministic (``_vdc_base3(k + 1)``).

    The shutter is centered on the frame time and spans ``shutter``
    frame-intervals (0.5 = a 180-degree shutter; with ``n_frames == 1``
    the unit is the whole track, rendering a motion-blurred still).
    ``scene_prep(scene)`` applies the caller's per-frame overrides
    (iteration count) before flattening. The schedule's
    ``has_transmission``/``has_emission`` are conservative flags the
    Renderer adds to the first scene's features when it picks the build.
    """
    from spectral_tpu_torch.scene.flatten import flatten_numpy

    dt = 1.0 if anim.n_frames == 1 else 1.0 / (anim.n_frames - 1)
    t0 = anim.time_at(frame)

    def schedule(frame_id: int):
        u = _vdc_base3(int(frame_id) + 1)
        t = min(max(t0 + (u - 0.5) * shutter * dt, 0.0), 1.0)
        sc = scene_prep(anim.scene_at_time(t))
        np_fields, cfg = flatten_numpy(sc)
        if cfg != cfg0:
            raise SceneError(
                f"shutter sample at t={t:.4f} changes the render "
                f"configuration ({cfg} != {cfg0}); tracks may only "
                "animate scene values"
            )
        return np_fields

    schedule.has_transmission = _tracks_can_enable(anim, "transmission")
    schedule.has_emission = False  # emission spectra are not animatable
    return schedule


def render_animation(
    anim: Animation,
    iterations: int | None = None,
    devices: list | None = None,
    out_dir: str | Path | None = None,
    progress: Callable[[int, int], None] | None = None,
    shutter: float = 0.0,
    **renderer_kwargs,
) -> np.ndarray:
    """Render every animation frame; returns u8 ``[F, H, W, 3]``.

    Frames are dealt round-robin over ``devices`` (torch devices or their
    names; default ``["cuda"]``) and rendered concurrently, one host
    thread per device, each frame on the Renderer's default path.
    ``iterations`` overrides the scene's progressive iteration count.
    ``out_dir`` additionally writes ``frame_0000.png`` .. per frame.
    ``progress(done, total)`` is called after each completed frame (from
    worker threads, serialized by a lock). Extra kwargs reach each
    ``Renderer``.

    ``shutter > 0`` enables motion blur: each progressive iteration of a
    frame samples the tracks at one deterministic low-discrepancy time in
    a centered window of ``shutter`` frame-intervals (0.5 = 180-degree
    shutter; with a single frame the window spans ``shutter`` of the
    whole track: a motion-blurred still). Each iteration is one
    ``cuda_mono`` launch on its own scene (regeneration fuses one scene
    across K frames and is turned off).
    """
    import threading

    from spectral_tpu_torch.render import image as image_mod
    from spectral_tpu_torch.render.renderer import Renderer
    from spectral_tpu_torch.scene.flatten import flatten_numpy

    if shutter < 0:
        raise ValueError("shutter must be >= 0")
    devices = list(devices) if devices else ["cuda"]
    scenes = [anim.scene_at(f) for f in range(anim.n_frames)]
    if iterations is not None:
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        for s in scenes:
            s.nbr_of_iterations = iterations

    def _scene_prep(s: Scene) -> Scene:
        if iterations is not None:
            s.nbr_of_iterations = iterations
        return s

    # every frame must share one configuration (shapes, kernel build):
    # flatten once here and hand the host tables to the Renderers below
    flattened = [flatten_numpy(s) for s in scenes]
    cfg0 = flattened[0][1]
    for f, (_, cfg) in enumerate(flattened[1:], start=1):
        if cfg != cfg0:
            raise SceneError(
                f"animation frame {f} changes the render configuration "
                f"({cfg} != {cfg0}); tracks may only animate scene values"
            )

    out_dir_path = Path(out_dir) if out_dir is not None else None
    if out_dir_path is not None:
        out_dir_path.mkdir(parents=True, exist_ok=True)

    frames_u8: list = [None] * anim.n_frames
    done = [0]
    lock = threading.Lock()

    def _render_one(f: int, dev) -> None:
        kw = dict(renderer_kwargs)
        if shutter > 0:
            kw["_scene_schedule"] = _motion_blur_schedule(
                anim, f, shutter, cfg0, _scene_prep
            )
        r = Renderer(scenes[f], device=dev, _flattened=flattened[f], **kw)
        r.render()
        fb = r.framebuffer()
        u8 = image_mod.accum_to_u8(fb)
        frames_u8[f] = u8[..., :3]
        if out_dir_path is not None:
            image_mod.save_image(
                fb, out_dir_path / f"frame_{f:04d}.png", u8=u8
            )
        if progress is not None:
            with lock:
                done[0] += 1
                progress(done[0], anim.n_frames)

    if len(devices) == 1 or anim.n_frames == 1:
        for f in range(anim.n_frames):
            _render_one(f, devices[0])
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(devices)) as pool:
            futures = [
                pool.submit(_render_one, f, devices[f % len(devices)])
                for f in range(anim.n_frames)
            ]
            for fut in futures:
                fut.result()  # re-raise worker errors

    return np.stack(frames_u8)


def render_batch_spmd(
    scenes: Sequence[Scene],
    mesh=None,
    iterations: int | None = None,
) -> np.ndarray:
    """Render B same-shaped scenes split over a mesh's slots by scene and
    return every process the float32 ``[B, H, W, 4]`` accumulation
    buffers (the reference's ``render_batch_spmd``, whose jit program
    shards a batch axis over a device mesh).

    ``mesh`` (``parallel.mesh.make_mesh``; default one slot on the card)
    must split the B scenes evenly: slot ``i`` renders scenes ``i * B/n``
    .. ``(i + 1) * B/n - 1``, each through the Renderer's default path on
    the slot's device (the kernels on the card, their plain versions on
    the CPU), and the processes join their results with one all-gather.
    Outputs partition by scene, so no render crosses slots.
    ``iterations`` overrides every scene's iteration count before
    flattening, so the screen-wide Hammersley denominator
    (``intended_frames``) follows it, as in ``render_animation``; the
    caller's scenes are not changed. Raises ``SceneError`` for scenes of
    different configurations and ``ValueError`` for an empty list.
    """
    import torch

    from spectral_tpu_torch.parallel import distributed
    from spectral_tpu_torch.parallel.mesh import make_mesh
    from spectral_tpu_torch.render.renderer import Renderer
    from spectral_tpu_torch.scene.flatten import flatten_numpy

    if not scenes:
        raise ValueError("render_batch_spmd needs at least one scene")
    if iterations is not None:
        if iterations < 1:
            raise ValueError("iterations must be >= 1")
        scenes = [copy.deepcopy(s) for s in scenes]
        for s in scenes:
            s.nbr_of_iterations = iterations
    flat = [flatten_numpy(s) for s in scenes]
    cfg = flat[0][1]
    for f, (_, c) in enumerate(flat[1:], start=1):
        if c != cfg:
            raise SceneError(f"batch scene {f} has a different render configuration")
    mesh = mesh if mesh is not None else make_mesh(1)
    if len(scenes) % mesh.size:
        raise ValueError(
            f"{len(scenes)} scenes do not split evenly over {mesh.size} mesh slots"
        )
    per = len(scenes) // mesh.size
    mine = []
    for slot in mesh.local_slots():
        for b in range(slot.index * per, (slot.index + 1) * per):
            r = Renderer(scenes[b], device=slot.device, _flattened=flat[b])
            r.render()
            mine.append(torch.from_numpy(r.framebuffer())[None])
    return distributed.fetch_global(mine)


def save_gif(frames_u8: np.ndarray, path, fps: float = 12.0) -> Path:
    """Write u8 ``[F, H, W, 3]`` frames as an animated GIF."""
    from PIL import Image

    path = Path(path)
    if frames_u8.ndim != 4 or frames_u8.shape[0] < 1:
        raise ValueError("expected [F, H, W, 3] u8 frames")
    imgs = [Image.fromarray(f, mode="RGB") for f in np.asarray(frames_u8)]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=max(int(round(1000.0 / fps)), 1),
        loop=0,
    )
    return path
