"""The bounce step of the wavefront integrator: a frozen copy of
``spectral_tpu_torch/render/integrator.py`` from ``NEW_RAY_POSITION_OFFSET_DISTANCE``
to ``_bounce`` (imports changed, the uniform-grid tracer left out: the
benchmark's scenes trace every object). The benchmark's reference must
not import the program, so it keeps its own copy.

One bounce of every lane: trace, next-event estimation over the lights
on diffuse lanes, the specular/diffuse branch on ``rz < metallicness``
with the PCG3D seed ``pcg3d(px, py, frame_id + bounces_left)``, and the
un-offset diffuse continuation, as the reference renderer does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.geometry import surface_normal, trace, trace_shadow
from benchmark.reference.rng import MASK32, random_pcg3d
from benchmark.reference.sampling import (
    cosine_hemisphere_bounce,
    reflect_vec,
    refract_or_reflect,
    sample_in_cone,
)
from benchmark.reference.vecmath import Vec3
from benchmark.reference.flatten import RenderConfig, SceneTensors

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
    config: RenderConfig, shadow_interval: bool = False,
) -> torch.Tensor:
    """Next-event estimation over all lights (reference
    ``src/shader.rs:420-439``): unoccluded lights contribute
    ``spectrum / dist^2 * cos_in * cos_out``. ``shadow_interval`` takes
    the sqrt-free sphere occlusion test (``geometry.trace_shadow``)."""
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
        blocked = trace_shadow(offset_pos, ldn, dist, scene, interval=shadow_interval)
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

    res = trace(o, d, scene)
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
    direct = _direct_lighting(offset_pos, normal, d, scene, config, shadow_interval)
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
