"""The benchmark's plain reference: the framebuffer values of a sample of
pixels, worked out again from the scene file.

Every pixel of the renderer's image is a function of the pixel and its
frames alone (the RNG is a counter hash of pixel, frame and bounce), so a
sample of pixels can be recomputed on its own. This module traces the
sample's paths with the frozen bounce step (``bounce.py``) in plain
PyTorch: all frames of the sample at once, one lane per pixel and frame,
and then adds each lane's per-bounce radiance in the order a lane of the
regeneration and persist kernels carries it, frame after frame and bounce
after bounce within a frame. So each pixel's sum has the bits of a
renderer that traces the same paths; the RGB fold and the blend follow
the renderer's formulas (``color.spectra_to_rgb``, ``accumulate_frames``
and the persist render's per-pixel average).

It imports nothing of the program: the scene is parsed, flattened and
turned into spectra and CIE weights by this package's own copies.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark.reference import camera, clusters, sceneio
from benchmark.reference.bounce import BounceState, _bounce, scene_features
from benchmark.reference.color import spectra_to_rgb
from benchmark.reference.flatten import RenderConfig, SceneTensors, flatten_scene
from benchmark.reference.geometry import ray_slabs, surface_normal, trace
from benchmark.reference.rng import MASK32
from benchmark.reference.vecmath import Vec3

NEW_RAY_POSITION_OFFSET_DISTANCE = 1e-5


def tables(scene_dict: dict, device) -> tuple[SceneTensors, RenderConfig]:
    """The scene file's flattened tables on ``device``."""
    return flatten_scene(sceneio.scene_from_dict(scene_dict), device)


@dataclasses.dataclass
class Work:
    """What the sample's paths needed: live lane-bounce iterations, and
    for a clustered scene the members of the clusters that each nearest-hit
    trace and each shadow ray enters before its nearest hit (or the light),
    summed over the same lane-bounces."""

    lanes: int = 0
    iterations: float = 0.0
    nearest_members: float = 0.0
    shadow_members: float = 0.0


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


def accumulate_frames(accum, rgb_sum, first_frame_id: int, k: int):
    """The renderer's blend of a K-frame RGB sum into the running average
    (``1 / (first + k)`` weights, frozen copy of the program's formula)."""
    inv = 1.0 / _f32((int(first_frame_id) + k) & MASK32, accum.device)
    old_factor = _f32(first_frame_id, accum.device) * inv
    new_rgb = accum[..., :3] * old_factor + rgb_sum * inv
    new_a = accum[..., 3] * old_factor + float(k) * inv
    return torch.cat([new_rgb, new_a[..., None]], dim=-1)


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls in full float32, whatever TF32 flags the process
    holds (the program's own, or a change's): the flags are restored after.
    Turning ``allow_tf32`` off also sets the float32 matmul precision to
    "highest"."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def to_rgb(rad_sp: torch.Tensor, st: SceneTensors) -> torch.Tensor:
    """``[S, P]`` radiance -> ``[P, 3]`` linear RGB, as the renderer folds
    its lane-minor sums, in full float32 (the configurations' precision)."""
    with full_float32():
        return spectra_to_rgb(rad_sp.T, st.xyz_weights, st.xyz_to_rgb)


def cluster_boxes(st: SceneTensors, cfg: RenderConfig):
    """The clustered runs' union boxes ``(min [C, 3], max [C, 3], members
    [C])`` of the 64-object cluster plan, or None below 65 objects."""
    plan = clusters.renderer_plan(st.np_fields, cfg.n_objects)
    if plan is None:
        return None
    sigma, runs = plan
    bounds = clusters.pack_cluster_bounds(st.np_fields["aabb_min"], st.np_fields["aabb_max"],
                                          sigma, runs)
    keep = [i for i, r in enumerate(runs) if r[3]]
    dev = st.device
    lo = torch.from_numpy(np.ascontiguousarray(bounds[0:3, keep].T)).to(dev)
    hi = torch.from_numpy(np.ascontiguousarray(bounds[3:6, keep].T)).to(dev)
    members = torch.tensor([float(runs[i][2] - runs[i][1]) for i in keep], device=dev)
    return lo, hi, members


def _members_entered(o: Vec3, d: Vec3, t_stop: torch.Tensor, boxes) -> torch.Tensor:
    """Per ray, the members of the clusters whose box it enters at or
    before ``t_stop``."""
    lo, hi, members = boxes
    col = lambda v: v[:, None]  # noqa: E731
    row = lambda v: v[None, :]  # noqa: E731
    t_min, _t_max, hit = ray_slabs(
        Vec3(col(o.x), col(o.y), col(o.z)), Vec3(col(d.x), col(d.y), col(d.z)),
        Vec3(row(lo[:, 0]), row(lo[:, 1]), row(lo[:, 2])),
        Vec3(row(hi[:, 0]), row(hi[:, 1]), row(hi[:, 2])))
    entered = hit & (t_min <= t_stop[:, None])
    return (entered.to(torch.float32) * members[None, :]).sum(dim=1)


def _count(state: BounceState, st: SceneTensors, cfg: RenderConfig, boxes, work: Work):
    """Add one bounce's needs to ``work``: the live lanes, and with
    ``boxes`` the cluster members their nearest-hit and shadow rays enter."""
    alive = state.alive
    work.iterations += float(alive.sum())
    if boxes is None:
        return
    idx = torch.nonzero(alive)[:, 0]
    if idx.numel() == 0:
        return
    o = Vec3(*(c[idx] for c in state.origin))
    d = Vec3(*(c[idx] for c in state.direction))
    res = trace(o, d, st)
    work.nearest_members += float(_members_entered(o, d, res.t, boxes).sum())
    hit = torch.nonzero(res.hit)[:, 0]
    if hit.numel() == 0:
        return
    o, d = Vec3(*(c[hit] for c in o)), Vec3(*(c[hit] for c in d))
    ip = o + d * res.t[hit]
    normal = surface_normal(ip, res.obj_idx[hit], st, origin=o, direction=d)
    pos = ip + normal * NEW_RAY_POSITION_OFFSET_DISTANCE
    for li in range(cfg.n_lights):
        lp = st.light_pos[li]
        ldir = Vec3(lp[0] - pos.x, lp[1] - pos.y, lp[2] - pos.z)
        dist = ldir.magnitude()
        ldn = ldir.normalize()
        block = trace(pos, ldn, st).t
        work.shadow_members += float(
            _members_entered(pos, ldn, torch.minimum(block, dist), boxes).sum())


def trace_sample(st: SceneTensors, cfg: RenderConfig, px: torch.Tensor, py: torch.Tensor,
                 frames: list[int], directions, chunks: list[tuple[int, int]],
                 work: Work | None = None) -> list[torch.Tensor]:
    """The radiance sums ``[S, P]`` of pixels ``(px, py)``, one per chunk
    ``(first, k)`` of ``frames``, each added up frame after frame and
    bounce after bounce as a kernel lane carries it. ``directions(f)``
    gives frame ``f``'s primary directions at the sample; every frame
    starts at the camera position. ``work``, when given, counts what the
    paths needed (``Work``)."""
    if scene_features(st):
        raise ValueError("the reference adds one radiance term per bounce: a scene with "
                         "sky, emission, textures or a dielectric is not covered")
    dev = st.device
    p = px.shape[0]
    f = len(frames)
    n = p * f
    s = cfg.n_samples
    dirs = [directions(fr) for fr in frames]
    direction = Vec3(*(torch.cat([dd[i] for dd in dirs]) for i in range(3)))
    cam = st.cam_pos
    origin = Vec3(cam[0].expand(n).contiguous(), cam[1].expand(n).contiguous(),
                  cam[2].expand(n).contiguous())
    lane_px, lane_py = px.long().repeat(f), py.long().repeat(f)
    fid = torch.tensor(frames, dtype=torch.int64, device=dev).repeat_interleave(p) & MASK32
    state = BounceState(
        origin=origin, direction=direction,
        throughput=torch.ones((n, s), dtype=torch.float32, device=dev),
        radiance=None,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        pending_gate=torch.zeros((n,), dtype=torch.bool, device=dev),
        ray_count=torch.zeros((), dtype=torch.float32, device=dev),
        hero=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    boxes = cluster_boxes(st, cfg) if work is not None else None
    if work is not None:
        work.lanes += n
    bl = torch.full((n,), cfg.max_bounces, dtype=torch.int64, device=dev)
    terms = []
    for _ in range(cfg.max_bounces):
        if work is not None:
            _count(state, st, cfg, boxes, work)
        state = _bounce(state._replace(radiance=torch.zeros((n, s), device=dev)),
                        bl, fid, lane_px, lane_py, st, cfg)
        terms.append(state.radiance)  # 0 + this bounce's term: the term's bits
        bl = torch.where(state.alive, bl - 1, bl)
        if not bool(state.alive.any()):
            break
    pos = {fr: i for i, fr in enumerate(frames)}
    sums = []
    for first, k in chunks:
        rad = torch.zeros((p, s), dtype=torch.float32, device=dev)
        for fr in range(first, first + k):
            lanes = slice(pos[fr] * p, (pos[fr] + 1) * p)
            for term in terms:
                rad = rad + term[lanes]
        sums.append(rad.T.contiguous())
    return sums


def regen_image(st: SceneTensors, cfg: RenderConfig, px, py, n_frames: int, chunk: int,
                work: Work | None = None) -> torch.Tensor:
    """``[P, 4]`` framebuffer values of a render of ``n_frames`` frames in
    regeneration chunks of ``chunk`` frames (the renderer's ``render_frames``
    with ``regen_frames=chunk``; every chunk here is one launch)."""
    table = camera.camera_basis_table(st, cfg)
    offsets = camera.hammersley_table(0, n_frames, cfg.intended_frames, st.device)

    def directions(fr):
        return camera.primary_directions(px.long(), py.long(), table,
                                         offsets[fr, 0], offsets[fr, 1])

    chunks = [(c, min(chunk, n_frames - c)) for c in range(0, n_frames, chunk)]
    if any(k < 2 for _c, k in chunks):
        raise ValueError("a one-frame chunk is the mono kernel's: not covered")
    sums = trace_sample(st, cfg, px, py, list(range(n_frames)), directions, chunks, work)
    accum = torch.zeros((px.shape[0], 4), dtype=torch.float32, device=st.device)
    for (first, k), rad in zip(chunks, sums):
        accum = accumulate_frames(accum, to_rgb(rad, st), first, k)
    return accum


def persist_image(st: SceneTensors, cfg: RenderConfig, px, py, n_frames: int,
                  work: Work | None = None) -> torch.Tensor:
    """``[P, 4]`` framebuffer values of a free-running persist render of
    ``n_frames`` frames: frame 0 from the camera's primaries, every later
    frame from the persist kernel's restart raygen, the pixel's radiance
    summed over all its frames and averaged in RGB, alpha 1."""
    table = camera.camera_basis_table(st, cfg)
    offsets = camera.hammersley_table(0, 1, cfg.intended_frames, st.device)

    def directions(fr):
        if fr == 0:
            return camera.primary_directions(px.long(), py.long(), table,
                                             offsets[0, 0], offsets[0, 1])
        nf = torch.full_like(px.long(), fr)
        return camera.restart_directions(px.long(), py.long(), nf, table)

    (rad,) = trace_sample(st, cfg, px, py, list(range(n_frames)), directions,
                          [(0, n_frames)], work)
    count = torch.full((px.shape[0],), float(n_frames), dtype=torch.float32, device=st.device)
    rgb = to_rgb(rad, st) / count[:, None]
    return torch.cat([rgb, torch.ones_like(rgb[:, :1])], dim=1)
