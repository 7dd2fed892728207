"""Wavefront spectral path integrator in eager PyTorch (the twin of the
reference package's jnp integrator, ``spectral_tpu.render.integrator``).

The reference's recursive closest-hit shading flattens into an iterative
loop over batched ray state:

    L(pixel) = sum_d  T_d * albedo_d * direct_d
    T_0 = 1,  T_{d+1} = T_d * albedo_d * g_{d+1}

where ``direct_d`` is next-event estimation over the lights on diffuse
lanes and ``g`` is the specular child-distance gate (children shorter
than 1e-4 are discarded). The reference's quirks are kept: the RNG seed
``pcg3d(px, py, frame_id + bounces_left)`` with a count-down budget, the
offset shadow/specular origins but **un-offset** diffuse continuation,
the outgoing-cosine factor on direct light, and the stochastic
specular/diffuse branch on ``rz < metallicness``.

The reference's beyond-reference scene features are here too, each
behind the reference's own static gate (``scene_features``): the sky on
the alive -> miss transition, checker textures on the albedo, emissive
surfaces, and the dielectric (Snell, Schlick-Fresnel, total internal
reflection) with the hero-wavelength collapse and the Cauchy index at the
first dispersive refraction. A scene without a feature computes none of
its arithmetic, exactly as the reference's gates compile none of it.

``bounce_loop`` runs that loop over lane planes; it is also the plain
version of the CUDA kernels (``spectral_tpu_torch.ops.megakernel``), so
there is one bounce implementation in torch. It takes any material
count: materials are gathered by id.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from spectral_tpu_torch.ops.geometry import surface_normal, trace, trace_shadow
from spectral_tpu_torch.ops.grid_trace import trace_grid
from spectral_tpu_torch.ops.rng import MASK32, as_u32, random_pcg3d
from spectral_tpu_torch.ops.sampling import (
    cosine_hemisphere_bounce,
    reflect_vec,
    refract_or_reflect,
    sample_in_cone,
)
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render.camera import (
    generate_primary_rays,
    restart_directions,
    scene_dof,
)
from spectral_tpu_torch.render.color import spectra_to_rgb
from spectral_tpu_torch.scene.flatten import RenderConfig, SceneTensors

# reference src/shader.rs:8 and :14
NEW_RAY_POSITION_OFFSET_DISTANCE = 1e-5
SPECULAR_MIN_RAY_DISTANCE = 1e-4
# the Fraunhofer d line, the wavelength of a lane without a hero bin
# (irrelevant where cauchy_b == 0)
D_LINE_NM = 587.6

# scene feature bits (csrc/megakernel.cuh FX_*): the reference's static
# gates has_transmission, has_emission, textured_static and sky
FX_TRANSMISSION = 1
FX_EMISSION = 2
FX_TEXTURE = 4
FX_SKY = 8


def scene_features(scene: SceneTensors) -> int:
    """The ``FX_*`` bits of the features the scene uses; 0 for a scene the
    reference renders without any of them."""
    f = scene.np_fields
    return ((FX_TRANSMISSION if f["transmission"].any() else 0)
            | (FX_EMISSION if f["emission"].any() else 0)
            | (FX_TEXTURE if f["tex_scale"].any() else 0)
            | (FX_SKY if f["sky"] is not None else 0))


def checker_factor(ipx, ipy, ipz, scale, low):
    """World-space checker albedo factor (the reference's
    ``integrator.checker_factor``, same op order): cells of side ``scale``
    alternate 1 and ``low`` by the parity of the floored coordinates;
    ``scale == 0`` is untextured (factor 1)."""
    inv = 1.0 / scale  # scale == 0 -> inf, masked by the outer where
    p = torch.floor(ipx * inv) + torch.floor(ipy * inv) + torch.floor(ipz * inv)
    odd = (p - 2.0 * torch.floor(p * 0.5)) != 0.0
    return torch.where(scale > 0.0, torch.where(odd, low, 1.0), 1.0)


class BounceState(NamedTuple):
    origin: Vec3  # [N]
    direction: Vec3  # [N]
    throughput: torch.Tensor  # [N, S]
    radiance: torch.Tensor  # [N, S]
    alive: torch.Tensor  # [N] bool
    pending_gate: torch.Tensor  # [N] bool: the parent bounce was specular
    ray_count: torch.Tensor  # [] f32: reference-equivalent rays submitted
    hero: torch.Tensor  # [N] int64: hero wavelength bin, -1 until a
    # dispersive refraction


def _direct_lighting(
    offset_pos: Vec3, normal: Vec3, incoming: Vec3, scene: SceneTensors,
    config: RenderConfig, shadow_interval: bool = False, grid=None,
) -> torch.Tensor:
    """Next-event estimation over all lights (reference
    ``src/shader.rs:420-439``): unoccluded lights contribute
    ``spectrum / dist^2 * cos_in * cos_out``. ``shadow_interval`` takes
    the sqrt-free sphere occlusion test (``geometry.trace_shadow``);
    ``grid`` (``scene.accel.build_grid``) traces the shadow ray through
    the uniform grid (``ops.grid_trace``), blocked by a hit within
    ``dist``."""
    n = offset_pos.x.shape[0]
    direct = torch.zeros((n, config.n_samples), dtype=torch.float32,
                         device=offset_pos.x.device)
    cos_out = torch.clamp_min((-incoming).dot(normal), 0.0)
    for li in range(config.n_lights):
        lp = scene.light_pos[li]
        ldir = Vec3(lp[0] - offset_pos.x, lp[1] - offset_pos.y, lp[2] - offset_pos.z)
        dist2 = ldir.dot(ldir)
        dist = ldir.magnitude()
        ldn = ldir.normalize()
        if grid is None:
            blocked = trace_shadow(offset_pos, ldn, dist, scene, interval=shadow_interval)
        else:
            hit = trace_grid(offset_pos, ldn, scene, grid)
            blocked = hit.hit & (hit.t <= dist)
        # the reference re-normalizes the already-normalized direction
        cos_in = torch.clamp_min(ldn.normalize().dot(normal), 0.0)
        scale = (cos_in * cos_out) / dist2
        contrib = scene.light_spec[li][None, :] * scale[:, None]
        direct = direct + torch.where(blocked[:, None], 0.0, contrib)
    return direct


def _bounce(
    state: BounceState,
    bounces_left: torch.Tensor,
    frame_id: torch.Tensor,
    px: torch.Tensor,
    py: torch.Tensor,
    scene: SceneTensors,
    config: RenderConfig,
    shadow_interval: bool = False,
    grid=None,
) -> BounceState:
    """One bounce iteration of every lane. ``bounces_left`` and
    ``frame_id`` are per-lane int64 ``[N]`` (uint32 bit patterns; callers
    with one value broadcast it); they seed the RNG and end a path whose
    budget is spent. The returned ``alive`` is the lanes that continue.
    The reference's ``_bounce``, op for op, with its feature branches
    behind ``scene_features``."""
    o, d, throughput, radiance, alive, pending_gate, ray_count, hero = state
    fx = scene_features(scene)
    # one submit_ray per live lane
    ray_count = ray_count + alive.sum(dtype=torch.float32)

    res = trace(o, d, scene) if grid is None else trace_grid(o, d, scene, grid)
    gate_ok = (~pending_gate) | (res.t > SPECULAR_MIN_RAY_DISTANCE)
    if fx & FX_SKY:
        # an escaping live ray collects throughput * sky (t is inf on a
        # miss, so gate_ok holds there: a gated-out short hit gets none)
        sky_mask = alive & gate_ok & ~res.hit
        radiance = radiance + torch.where(
            sky_mask[:, None], throughput * scene.sky[None, :], 0.0
        )
    alive = alive & res.hit & gate_ok

    obj = res.obj_idx
    t_safe = torch.where(alive, res.t, 0.0)
    ip = o + d * t_safe
    normal = surface_normal(ip, obj, scene, origin=o, direction=d)
    m_metal = scene.metallicness[obj]
    m_rough = scene.roughness[obj]
    m_albedo = scene.albedo[obj]  # [N, S]
    if fx & FX_TEXTURE:
        texf = checker_factor(ip.x, ip.y, ip.z, scene.tex_scale[obj], scene.tex_low[obj])
        m_albedo = m_albedo * texf[:, None]

    seed = (frame_id + bounces_left) & MASK32
    rx, ry, rz = random_pcg3d(px, py, seed)
    spec = rz < m_metal
    trans = torch.zeros_like(spec)
    if fx & FX_TRANSMISSION:
        trans = (~spec) & (rz < m_metal + scene.transmission[obj])
    if fx & FX_EMISSION:
        radiance = radiance + torch.where(
            alive[:, None], throughput * scene.emission[obj], 0.0
        )

    offset_pos = ip + normal * NEW_RAY_POSITION_OFFSET_DISTANCE
    direct = _direct_lighting(offset_pos, normal, d, scene, config, shadow_interval, grid)
    diffuse = alive & ~spec & ~trans
    # one shadow ray per light per live diffuse lane
    ray_count = ray_count + float(config.n_lights) * diffuse.sum(dtype=torch.float32)
    radiance = radiance + torch.where(
        diffuse[:, None], throughput * m_albedo * direct, 0.0
    )

    # continuation rays
    refl = reflect_vec(d, normal)
    cone = sample_in_cone(refl, m_rough, rx, ry)
    spec_dir = cone.where(m_rough >= 0.001, refl)
    diff_dir = cosine_hemisphere_bounce(rx, ry, normal)
    # the diffuse continuation starts at the UN-offset hit point, except in
    # sky scenes, where the self-hit coin would pay throughput * sky
    diff_origin = offset_pos if fx & FX_SKY else ip
    new_dir = spec_dir.where(spec, diff_dir)
    new_origin = offset_pos.where(spec, diff_origin)
    if fx & FX_TRANSMISSION:
        # the first dispersive refraction commits the path to one
        # uniformly chosen wavelength bin with an S-fold weight
        s = throughput.shape[1]
        needs_hero = alive & trans & (scene.cauchy_b[obj] > 0.0) & (hero < 0)
        h_new = torch.clamp_max((ry * s).long(), s - 1)
        bins = torch.arange(s, device=hero.device)
        onehot = (bins[None, :] == h_new[:, None]).to(torch.float32)
        throughput = torch.where(
            needs_hero[:, None], throughput * onehot * float(s), throughput
        )
        hero = torch.where(needs_hero, h_new, hero)
        # the Cauchy index at the hero wavelength
        lam_nm = torch.where(hero >= 0, scene.lambda_grid[torch.clamp_min(hero, 0)],
                             D_LINE_NM)
        lam_um = lam_nm * 1e-3
        n_lam = scene.ior[obj] + scene.cauchy_b[obj] / (lam_um * lam_um)
        trans_dir, reflects, n_or = refract_or_reflect(d, normal, n_lam, rx)
        # the child leaves on the side it goes to
        off = n_or * NEW_RAY_POSITION_OFFSET_DISTANCE
        trans_origin = (ip + off).where(reflects, ip - off)
        new_dir = spec_dir.where(spec, trans_dir.where(trans, diff_dir))
        new_origin = offset_pos.where(spec, trans_origin.where(trans, diff_origin))
    new_dir = new_dir.normalize()  # Ray::new normalizes

    cont = alive & (bounces_left > 1)
    o = new_origin.where(cont, o)
    d = new_dir.where(cont, d)
    throughput = torch.where(cont[:, None], throughput * m_albedo, throughput)
    pending_gate = torch.where(cont, spec, pending_gate)
    return BounceState(o, d, throughput, radiance, cont, pending_gate, ray_count, hero)


def _bounce_loop(origin, direction, px, py, frame_id, scene, config,
                 radiance=None, occupancy=None, shadow_interval=False, grid=None):
    """The one-frame loop over lane planes; returns the final state and
    the per-lane bounces left (frozen when a path ends). The frame's
    radiance is added bounce by bounce to ``radiance`` (``[N, S]``, zeros
    if None), as the kernels add a K-frame sum. ``occupancy`` (f32
    ``[max_bounces]``) gets the count of lanes alive entering each
    bounce; ``shadow_interval`` and ``grid`` are ``_direct_lighting``'s,
    and ``grid`` traces the continuation rays too (the reference's
    ``make_tracers``)."""
    n = origin.x.shape[0]
    s = config.n_samples
    dev = origin.x.device
    if radiance is None:
        radiance = torch.zeros((n, s), dtype=torch.float32, device=dev)
    state = BounceState(
        origin=origin,
        direction=direction,
        throughput=torch.ones((n, s), dtype=torch.float32, device=dev),
        radiance=radiance,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        pending_gate=torch.zeros((n,), dtype=torch.bool, device=dev),
        ray_count=torch.zeros((), dtype=torch.float32, device=dev),
        hero=torch.full((n,), -1, dtype=torch.int64, device=dev),
    )
    bl = torch.full((n,), config.max_bounces, dtype=torch.int64, device=dev)
    fid = as_u32(frame_id, dev).expand(n)
    px, py = px.long(), py.long()
    if config.n_objects == 0 and scene.sky is not None:
        # every primary ray escapes: the frame is the sky colour
        state = state._replace(radiance=state.radiance + scene.sky[None, :])
    if config.n_objects > 0:
        for b in range(config.max_bounces):
            if occupancy is not None:
                occupancy[b] = state.alive.sum(dtype=torch.float32)
            state = _bounce(state, bl, fid, px, py, scene, config, shadow_interval, grid)
            bl = torch.where(state.alive, bl - 1, bl)
            # a dead lane adds nothing, so an all-dead wavefront is done
            if not bool(state.alive.any()):
                break
    return state, bl


def bounce_loop(
    origin: Vec3,
    direction: Vec3,
    px: torch.Tensor,
    py: torch.Tensor,
    frame_id,
    scene: SceneTensors,
    config: RenderConfig,
    return_stats: bool = False,
    radiance: torch.Tensor | None = None,
    shadow_interval: bool = False,
):
    """Trace one frame's paths from the given primary lanes; returns the
    radiance ``[N, S]`` (and the reference-equivalent ray count). A given
    ``radiance`` is carried: the frame is added to it bounce by bounce.
    ``shadow_interval`` takes the sqrt-free sphere shadow test."""
    state, _ = _bounce_loop(origin, direction, px, py, frame_id, scene, config,
                            radiance, shadow_interval=shadow_interval)
    if return_stats:
        return state.radiance, state.ray_count
    return state.radiance


def bounce_loop_cost(origin, direction, px, py, frame_id, scene, config,
                     shadow_interval=False):
    """``bounce_loop`` plus each lane's live iteration count, the path
    cost ``max_bounces + 1 - bounces_left`` with the budget frozen at the
    path's end (the reference's ``kernel_cost``, ``megakernel.py:1887-1892``):
    returns ``(radiance [N, S], cost [N] f32)``."""
    state, bl = _bounce_loop(origin, direction, px, py, frame_id, scene, config,
                             shadow_interval=shadow_interval)
    top = torch.tensor(float(config.max_bounces + 1), device=bl.device)
    return state.radiance, top - bl.to(torch.float32)


@dataclasses.dataclass
class PersistState:
    """The carried lane state of a persistent render (the reference's
    ``make_body`` carry plus throughput and radiance, ``megakernel.py:
    1928-1935, 2001-2006``), one lane per pixel slot. ``alive``/``gate``
    are 1.0/0.0 and ``hero`` the hero-wavelength bin (-1: none). ``bl``
    (bounces left) and ``fid`` (the frame of the path in flight) are
    uint32 bit patterns: int32 on the card, as the kernel reads them, and
    int64 on the CPU, as ``ops/rng.py`` computes. ``px``/``py`` are int32.
    ``thr`` and ``rad`` are ``[S, n]``, lane-minor."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    alive: torch.Tensor
    gate: torch.Tensor
    hero: torch.Tensor
    bl: torch.Tensor
    fid: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    thr: torch.Tensor
    rad: torch.Tensor

    # the reference's carried-state order (its checkpoint's state_0..12)
    CARRIED = ("ox", "oy", "oz", "dx", "dy", "dz", "alive", "gate", "hero",
               "bl", "fid", "thr", "rad")

    def planes(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def lane_int_dtype(device) -> torch.dtype:
    """The dtype of the ``bl``/``fid`` planes on ``device``."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


def persist_iterations(
    st: PersistState,
    lead: int,
    end: int,
    scene: SceneTensors,
    config: RenderConfig,
    cam: torch.Tensor,
    ring=None,
    stop: torch.Tensor | None = None,
    budget: int = 1,
) -> None:
    """Exactly ``budget`` iterations of the carried-state bounce step
    (``_bounce``) over every lane, updating ``st`` IN PLACE: the plain
    version of the persist kernel.

    A lane whose path ends this iteration, or that idles, restarts its
    pixel's next frame ``nf = fid + 1`` when ``nf < end``, and also
    ``nf < lead`` when a ring is given and its ``stop`` flag is clear
    when a stop mask is given (``megakernel.py:1406-1420``); the restart
    takes the iteration, as in the reference. On restart the throughput
    goes back to 1, the lane comes alive from the camera position
    ``cam[0:3]``, with ``max_bounces`` left, hero -1 and the gate open
    (``:1549-1552, 1752-1769``). The direction comes from the ring slot
    ``nf % W`` (``ring = (x, y, z)``, ``[W, n]`` each) or, free-running,
    from ``camera.restart_directions`` with ``cam`` the camera table.
    Once no lane is alive or restartable every later iteration is a
    no-op, so the loop stops early; that is exact."""
    n = st.ox.shape[0]
    dev = st.ox.device
    bl = st.bl.long()
    fid = st.fid.long() & MASK32
    px, py = st.px.long(), st.py.long()
    state = BounceState(
        origin=Vec3(st.ox, st.oy, st.oz),
        direction=Vec3(st.dx, st.dy, st.dz),
        throughput=st.thr.T,
        radiance=st.rad.T,
        alive=st.alive > 0.0,
        pending_gate=st.gate > 0.0,
        ray_count=torch.zeros((), dtype=torch.float32, device=dev),
        hero=st.hero.long(),
    )
    held = torch.zeros((n,), dtype=torch.bool, device=dev)
    if stop is not None:
        held = stop > 0.0
    lanes = torch.arange(n, device=dev)

    def restartable(fid):
        nf = (fid + 1) & MASK32
        ok = (nf < int(end)) & ~held
        if ring is not None:
            ok &= nf < int(lead)
        return ok

    for _ in range(int(budget)):
        ok = restartable(fid)
        if not bool((state.alive | ok).any()):
            break
        state = _bounce(state, bl, fid, px, py, scene, config)
        cont = state.alive
        new_path = ~cont & ok
        bl = torch.where(cont, bl - 1,
                         torch.where(new_path, config.max_bounces, bl))
        if not bool(new_path.any()):
            continue
        nf = (fid + 1) & MASK32
        if ring is not None:
            slot = nf & (ring[0].shape[0] - 1)
            rd = Vec3(ring[0][slot, lanes], ring[1][slot, lanes], ring[2][slot, lanes])
        else:
            rd = restart_directions(px, py, nf, cam)
        cam_o = Vec3(cam[0].expand(n), cam[1].expand(n), cam[2].expand(n))
        state = BounceState(
            origin=cam_o.where(new_path, state.origin),
            direction=rd.where(new_path, state.direction),
            throughput=torch.where(new_path[:, None], 1.0, state.throughput),
            radiance=state.radiance,
            alive=cont | new_path,
            pending_gate=state.pending_gate & ~new_path,
            ray_count=state.ray_count,
            hero=torch.where(new_path, -1, state.hero),
        )
        fid = torch.where(new_path, nf, fid)

    st.ox.copy_(state.origin.x)
    st.oy.copy_(state.origin.y)
    st.oz.copy_(state.origin.z)
    st.dx.copy_(state.direction.x)
    st.dy.copy_(state.direction.y)
    st.dz.copy_(state.direction.z)
    st.alive.copy_(state.alive.to(torch.float32))
    st.gate.copy_(state.pending_gate.to(torch.float32))
    st.hero.copy_(state.hero.to(torch.float32))
    st.bl.copy_(bl)
    st.fid.copy_(fid)
    st.thr.copy_(state.throughput.T)
    st.rad.copy_(state.radiance.T)


@dataclasses.dataclass
class Wavefront:
    """One frame's lane state between bounce segments (the reference's
    ``kernel_seg`` state in and out, ``megakernel.py:2071-2110``).
    ``alive``/``gate`` are 1.0/0.0 and ``hero`` the hero-wavelength bin
    (-1: none); ``px``/``py`` are int32; ``thr`` and ``rad`` are
    ``[S, n]``, lane-minor. Every live lane is at the same bounce: the
    one its segment starts at."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    px: torch.Tensor
    py: torch.Tensor
    alive: torch.Tensor
    gate: torch.Tensor
    hero: torch.Tensor
    thr: torch.Tensor
    rad: torch.Tensor

    def planes(self) -> dict:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def segment_iterations(wf: Wavefront, b_start: int, b_stop: int, frame_id,
                       scene: SceneTensors, config: RenderConfig) -> None:
    """Bounces ``[b_start, b_stop)`` of every live lane of ``wf``, updated
    IN PLACE: the plain version of the segment kernel. A live lane enters
    with ``max_bounces - b_start`` bounces left (``megakernel.py:2104``)
    and the wavefront's frame id, so its path is the one the whole-frame
    loop traces; dead lanes stay as they are."""
    n = wf.ox.shape[0]
    dev = wf.ox.device
    state = BounceState(
        origin=Vec3(wf.ox, wf.oy, wf.oz),
        direction=Vec3(wf.dx, wf.dy, wf.dz),
        throughput=wf.thr.T,
        radiance=wf.rad.T,
        alive=wf.alive > 0.0,
        pending_gate=wf.gate > 0.0,
        ray_count=torch.zeros((), dtype=torch.float32, device=dev),
        hero=wf.hero.long(),
    )
    bl = torch.full((n,), config.max_bounces - int(b_start), dtype=torch.int64,
                    device=dev)
    fid = as_u32(frame_id, dev).expand(n)
    px, py = wf.px.long(), wf.py.long()
    if config.n_objects > 0:
        for _ in range(int(b_start), int(b_stop)):
            if not bool(state.alive.any()):
                break  # a dead lane adds nothing
            state = _bounce(state, bl, fid, px, py, scene, config)
            bl = torch.where(state.alive, bl - 1, bl)
    wf.ox.copy_(state.origin.x)
    wf.oy.copy_(state.origin.y)
    wf.oz.copy_(state.origin.z)
    wf.dx.copy_(state.direction.x)
    wf.dy.copy_(state.direction.y)
    wf.dz.copy_(state.direction.z)
    wf.alive.copy_(state.alive.to(torch.float32))
    wf.gate.copy_(state.pending_gate.to(torch.float32))
    wf.hero.copy_(state.hero.to(torch.float32))
    wf.thr.copy_(state.throughput.T)
    wf.rad.copy_(state.radiance.T)


def integrate_frame(
    scene: SceneTensors,
    config: RenderConfig,
    frame_id,
    return_stats: bool = False,
    return_occupancy: bool = False,
    full_height: int | None = None,
    row_offset: int = 0,
    grid=None,
):
    """Trace one progressive frame; returns linear RGB ``[H, W, 3]``, then
    the reference-equivalent submitted-ray count if ``return_stats``, then
    the per-bounce live-lane counts ``[max_bounces]`` f32 (lanes entering
    each bounce, the reference's ``return_occupancy``) if asked.
    ``full_height``/``row_offset`` trace the row slab ``config`` of a
    taller image in its global coordinates; ``grid`` traces every ray
    through the uniform grid (``scene.accel.build_grid``) instead of
    testing every object."""
    origin, direction, px, py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame_id, config.intended_frames,
        dof=scene_dof(scene, config), full_height=full_height, row_offset=row_offset,
    )
    hist = None
    if return_occupancy:
        hist = torch.zeros((config.max_bounces,), dtype=torch.float32,
                           device=origin.x.device)
    state, _ = _bounce_loop(origin, direction, px, py, frame_id, scene, config,
                            occupancy=hist, grid=grid)
    rgb = spectra_to_rgb(state.radiance, scene.xyz_weights, scene.xyz_to_rgb)
    out = (rgb.reshape(config.height, config.width, 3),)
    if return_stats:
        out += (state.ray_count,)
    if return_occupancy:
        out += (hist,)
    return out if len(out) > 1 else out[0]


def _f32(v: int, device) -> torch.Tensor:
    # a fill, the value passed as a kernel argument: torch.tensor(float(v))'s
    # bits without its copy from pageable host memory, so no wait on the card
    return torch.full((), float(v), dtype=torch.float32, device=device)


def accumulate_frame(accum: torch.Tensor, rgb: torch.Tensor, frame_id: int) -> torch.Tensor:
    """Progressive running-average blend into the ``[H, W, 4]`` buffer with
    weight ``1 / (frame_id + 1)`` (reference ``src/main.rs:1316-1317``)."""
    ratio = 1.0 / _f32((int(frame_id) + 1) & MASK32, accum.device)
    old_factor = 1.0 - ratio
    new_rgb = accum[..., :3] * old_factor + rgb * ratio
    new_a = accum[..., 3] * old_factor + ratio
    return torch.cat([new_rgb, new_a[..., None]], dim=-1)


def accumulate_frames(
    accum: torch.Tensor, rgb_sum: torch.Tensor, first_frame_id: int, k: int
) -> torch.Tensor:
    """Blend the SUM of k consecutive frames' RGB into the running average
    in one step (k sequential ``accumulate_frame`` calls in exact
    arithmetic). Consumes the regeneration kernel's summed output."""
    inv = 1.0 / _f32((int(first_frame_id) + k) & MASK32, accum.device)
    old_factor = _f32(first_frame_id, accum.device) * inv
    new_rgb = accum[..., :3] * old_factor + rgb_sum * inv
    new_a = accum[..., 3] * old_factor + float(k) * inv
    return torch.cat([new_rgb, new_a[..., None]], dim=-1)


def render_frame_step(
    scene: SceneTensors, config: RenderConfig, accum: torch.Tensor, frame_id: int
) -> torch.Tensor:
    """One full progressive iteration: trace + blend (the reference's
    ``apply_shader2``, ``src/main.rs:1280-1322``)."""
    return accumulate_frame(accum, integrate_frame(scene, config, frame_id), frame_id)
