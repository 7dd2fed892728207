"""The plain reference of scenes with features: the sky, emission, the
checker texture and the dielectric with its hero wavelength (the
``FX_*`` bits of ``bounce.scene_features``).

``paths.trace_sample`` adds one radiance term per bounce to a lane's sum.
A lane of the feature build adds up to three (``bounce.cuh:bounce_step``):
the sky of a miss, then the hit's emission, then its direct light, each
to the lane's running sum. ``(r + e) + d`` is not ``r + (e + d)`` in
float32, so this module's bounce step, a frozen copy of
``bounce._bounce`` (the same ops in the same order, the shadow interval
left out), returns each term apart, and the sums add them in the kernel's
order: frame after frame, bounce after bounce, and within a bounce the
sky, the emission, the direct light. On a scene without features the
only term is the direct light, and the sums are ``paths.regen_image``'s
bits. The fold and the blend are ``paths``'.

It imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import camera
from benchmark.reference.bounce import (
    D_LINE_NM,
    FX_EMISSION,
    FX_SKY,
    FX_TEXTURE,
    FX_TRANSMISSION,
    NEW_RAY_POSITION_OFFSET_DISTANCE,
    SPECULAR_MIN_RAY_DISTANCE,
    BounceState,
    _direct_lighting,
    checker_factor,
    scene_features,
)
from benchmark.reference.flatten import RenderConfig, SceneTensors
from benchmark.reference.geometry import surface_normal, trace
from benchmark.reference.paths import (
    Work,
    _count,
    accumulate_frames,
    cluster_boxes,
    to_rgb,
)
from benchmark.reference.rng import MASK32, random_pcg3d
from benchmark.reference.sampling import (
    cosine_hemisphere_bounce,
    reflect_vec,
    refract_or_reflect,
    sample_in_cone,
)
from benchmark.reference.vecmath import Vec3


class Terms(NamedTuple):
    """One bounce's radiance terms ``[N, S]``, in the order a lane adds
    them; None for a feature the scene lacks."""

    sky: torch.Tensor | None
    emission: torch.Tensor | None
    direct: torch.Tensor


def bounce_terms(state: BounceState, bounces_left: torch.Tensor, frame_id: torch.Tensor,
                 px: torch.Tensor, py: torch.Tensor, scene: SceneTensors,
                 config: RenderConfig) -> tuple[BounceState, Terms]:
    """``bounce._bounce`` with its radiance terms returned apart: the new
    state (its ``radiance`` passed through) and the bounce's ``Terms``."""
    o, d, throughput, radiance, alive, pending_gate, ray_count, hero = state
    fx = scene_features(scene)
    ray_count = ray_count + alive.sum(dtype=torch.float32)

    res = trace(o, d, scene)
    gate_ok = (~pending_gate) | (res.t > SPECULAR_MIN_RAY_DISTANCE)
    sky = None
    if fx & FX_SKY:
        sky_mask = alive & gate_ok & ~res.hit
        sky = torch.where(sky_mask[:, None], throughput * scene.sky[None, :], 0.0)
    alive = alive & res.hit & gate_ok

    obj = res.obj_idx
    t_safe = torch.where(alive, res.t, 0.0)
    ip = o + d * t_safe
    normal = surface_normal(ip, obj, scene, origin=o, direction=d)
    m_metal = scene.metallicness[obj]
    m_rough = scene.roughness[obj]
    m_albedo = scene.albedo[obj]
    if fx & FX_TEXTURE:
        texf = checker_factor(ip.x, ip.y, ip.z, scene.tex_scale[obj], scene.tex_low[obj])
        m_albedo = m_albedo * texf[:, None]

    seed = (frame_id + bounces_left) & MASK32
    rx, ry, rz = random_pcg3d(px, py, seed)
    spec = rz < m_metal
    trans = torch.zeros_like(spec)
    if fx & FX_TRANSMISSION:
        trans = (~spec) & (rz < m_metal + scene.transmission[obj])
    emission = None
    if fx & FX_EMISSION:
        emission = torch.where(alive[:, None], throughput * scene.emission[obj], 0.0)

    offset_pos = ip + normal * NEW_RAY_POSITION_OFFSET_DISTANCE
    direct = _direct_lighting(offset_pos, normal, d, scene, config)
    diffuse = alive & ~spec & ~trans
    ray_count = ray_count + float(config.n_lights) * diffuse.sum(dtype=torch.float32)
    direct = torch.where(diffuse[:, None], throughput * m_albedo * direct, 0.0)

    refl = reflect_vec(d, normal)
    cone = sample_in_cone(refl, m_rough, rx, ry)
    spec_dir = cone.where(m_rough >= 0.001, refl)
    diff_dir = cosine_hemisphere_bounce(rx, ry, normal)
    diff_origin = offset_pos if fx & FX_SKY else ip
    new_dir = spec_dir.where(spec, diff_dir)
    new_origin = offset_pos.where(spec, diff_origin)
    if fx & FX_TRANSMISSION:
        s = throughput.shape[1]
        needs_hero = alive & trans & (scene.cauchy_b[obj] > 0.0) & (hero < 0)
        h_new = torch.clamp_max((ry * s).long(), s - 1)
        bins = torch.arange(s, device=hero.device)
        onehot = (bins[None, :] == h_new[:, None]).to(torch.float32)
        throughput = torch.where(
            needs_hero[:, None], throughput * onehot * float(s), throughput
        )
        hero = torch.where(needs_hero, h_new, hero)
        lam_nm = torch.where(hero >= 0, scene.lambda_grid[torch.clamp_min(hero, 0)],
                             D_LINE_NM)
        lam_um = lam_nm * 1e-3
        n_lam = scene.ior[obj] + scene.cauchy_b[obj] / (lam_um * lam_um)
        trans_dir, reflects, n_or = refract_or_reflect(d, normal, n_lam, rx)
        off = n_or * NEW_RAY_POSITION_OFFSET_DISTANCE
        trans_origin = (ip + off).where(reflects, ip - off)
        new_dir = spec_dir.where(spec, trans_dir.where(trans, diff_dir))
        new_origin = offset_pos.where(spec, trans_origin.where(trans, diff_origin))
    new_dir = new_dir.normalize()

    cont = alive & (bounces_left > 1)
    o = new_origin.where(cont, o)
    d = new_dir.where(cont, d)
    throughput = torch.where(cont[:, None], throughput * m_albedo, throughput)
    pending_gate = torch.where(cont, spec, pending_gate)
    state = BounceState(o, d, throughput, radiance, cont, pending_gate, ray_count, hero)
    return state, Terms(sky, emission, direct)


def trace_sample(st: SceneTensors, cfg: RenderConfig, px: torch.Tensor, py: torch.Tensor,
                 frames: list[int], directions, chunks: list[tuple[int, int]],
                 work: Work | None = None) -> list[torch.Tensor]:
    """``paths.trace_sample`` for scenes with features: the radiance sums
    ``[S, P]`` of pixels ``(px, py)``, one per chunk ``(first, k)`` of
    ``frames``, each lane's terms added frame after frame, bounce after
    bounce, and within a bounce in ``Terms``' order. ``work`` counts as
    ``paths`` does."""
    if cfg.n_objects == 0:
        raise ValueError("a scene without objects is not covered")
    dev = st.device
    p = px.shape[0]
    n = p * len(frames)
    s = cfg.n_samples
    dirs = [directions(fr) for fr in frames]
    direction = Vec3(*(torch.cat([dd[i] for dd in dirs]) for i in range(3)))
    cam = st.cam_pos
    origin = Vec3(cam[0].expand(n).contiguous(), cam[1].expand(n).contiguous(),
                  cam[2].expand(n).contiguous())
    lane_px, lane_py = px.long().repeat(len(frames)), py.long().repeat(len(frames))
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
    bounces = []
    for _ in range(cfg.max_bounces):
        if work is not None:
            _count(state, st, cfg, boxes, work)
        state, terms = bounce_terms(state, bl, fid, lane_px, lane_py, st, cfg)
        bounces.append([t for t in terms if t is not None])
        bl = torch.where(state.alive, bl - 1, bl)
        if not bool(state.alive.any()):
            break
    pos = {fr: i for i, fr in enumerate(frames)}
    sums = []
    for first, k in chunks:
        rad = torch.zeros((p, s), dtype=torch.float32, device=dev)
        for fr in range(first, first + k):
            lanes = slice(pos[fr] * p, (pos[fr] + 1) * p)
            for terms in bounces:
                for term in terms:
                    rad = rad + term[lanes]
        sums.append(rad.T.contiguous())
    return sums


def regen_image(st: SceneTensors, cfg: RenderConfig, px, py, n_frames: int, chunk: int,
                work: Work | None = None) -> torch.Tensor:
    """``paths.regen_image`` through this module's ``trace_sample``: the
    ``[P, 4]`` framebuffer values of a render of ``n_frames`` frames in
    regeneration chunks of ``chunk`` frames, every chunk one launch."""
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
