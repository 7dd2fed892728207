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

``bounce_loop`` runs that loop over lane planes; it is also the plain
version of the CUDA kernels (``spectral_tpu_torch.ops.megakernel``), so
there is one bounce implementation in torch. Scene features outside the
port's first slice raise ``NotImplementedError`` (``require_slice``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spectral_tpu_torch.ops.geometry import surface_normal, trace, trace_shadow
from spectral_tpu_torch.ops.rng import MASK32, as_u32, random_pcg3d
from spectral_tpu_torch.ops.sampling import (
    cosine_hemisphere_bounce,
    reflect_vec,
    sample_in_cone,
)
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render.camera import generate_primary_rays
from spectral_tpu_torch.render.color import spectra_to_rgb
from spectral_tpu_torch.scene.flatten import OBJ_TRIANGLE, RenderConfig, SceneTensors

# reference src/shader.rs:8 and :14
NEW_RAY_POSITION_OFFSET_DISTANCE = 1e-5
SPECULAR_MIN_RAY_DISTANCE = 1e-4
# the unrolled object loop of the reference package's kernels
MAX_OBJECTS = 64


def require_slice(scene: SceneTensors, config: RenderConfig) -> None:
    """Raise ``NotImplementedError`` for scene features the port does not
    render yet, naming the slice that will bring each. Never falls back."""
    f = scene.np_fields
    later = []
    if f["transmission"].any() or f["cauchy_b"].any():
        later.append("transmission/dispersion (dielectric slice)")
    if f["emission"].any():
        later.append("emissive surfaces (emission slice)")
    if f["sky"] is not None:
        later.append("sky emission (sky slice)")
    if f["tex_scale"].any():
        later.append("checker textures (texture slice)")
    if config.has_dof:
        later.append("depth of field (DoF slice)")
    if OBJ_TRIANGLE in scene.obj_types:
        later.append("triangle meshes (mesh slice)")
    if config.n_objects > MAX_OBJECTS:
        later.append(
            f"more than {MAX_OBJECTS} objects (many-object slice: the "
            "type-run and cluster-culled object loops)"
        )
    if later:
        raise NotImplementedError(
            "not in the PyTorch/CUDA port yet: " + "; ".join(later)
            + " (see ROADMAP.md queue 1)"
        )


class BounceState(NamedTuple):
    origin: Vec3  # [N]
    direction: Vec3  # [N]
    throughput: torch.Tensor  # [N, S]
    radiance: torch.Tensor  # [N, S]
    alive: torch.Tensor  # [N] bool
    pending_gate: torch.Tensor  # [N] bool: the parent bounce was specular
    ray_count: torch.Tensor  # [] f32: reference-equivalent rays submitted


def _direct_lighting(
    offset_pos: Vec3, normal: Vec3, incoming: Vec3, scene: SceneTensors,
    config: RenderConfig,
) -> torch.Tensor:
    """Next-event estimation over all lights (reference
    ``src/shader.rs:420-439``): unoccluded lights contribute
    ``spectrum / dist^2 * cos_in * cos_out``."""
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
        blocked = trace_shadow(offset_pos, ldn, dist, scene)
        # the reference re-normalizes the already-normalized direction
        cos_in = torch.clamp_min(ldn.normalize().dot(normal), 0.0)
        scale = (cos_in * cos_out) / dist2
        contrib = scene.light_spec[li][None, :] * scale[:, None]
        direct = direct + torch.where(blocked[:, None], 0.0, contrib)
    return direct


def _bounce(
    state: BounceState,
    bounces_left: int,
    frame_id,
    px: torch.Tensor,
    py: torch.Tensor,
    scene: SceneTensors,
    config: RenderConfig,
) -> BounceState:
    o, d, throughput, radiance, alive, pending_gate, ray_count = state
    # one submit_ray per live lane
    ray_count = ray_count + alive.sum(dtype=torch.float32)

    res = trace(o, d, scene)
    gate_ok = (~pending_gate) | (res.t > SPECULAR_MIN_RAY_DISTANCE)
    alive = alive & res.hit & gate_ok

    t_safe = torch.where(alive, res.t, 0.0)
    ip = o + d * t_safe
    normal = surface_normal(ip, res.obj_idx, scene)
    m_metal = scene.metallicness[res.obj_idx]
    m_rough = scene.roughness[res.obj_idx]
    m_albedo = scene.albedo[res.obj_idx]  # [N, S]

    seed = (as_u32(frame_id, px.device) + bounces_left) & MASK32
    rx, ry, rz = random_pcg3d(px, py, seed)
    spec = rz < m_metal

    offset_pos = ip + normal * NEW_RAY_POSITION_OFFSET_DISTANCE
    direct = _direct_lighting(offset_pos, normal, d, scene, config)
    diffuse = alive & ~spec
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
    new_dir = spec_dir.where(spec, diff_dir).normalize()  # Ray::new normalizes
    # the diffuse continuation starts at the UN-offset hit point
    new_origin = offset_pos.where(spec, ip)

    cont = alive & (bounces_left > 1)
    o = new_origin.where(cont, o)
    d = new_dir.where(cont, d)
    throughput = torch.where(cont[:, None], throughput * m_albedo, throughput)
    pending_gate = torch.where(cont, spec, pending_gate)
    return BounceState(o, d, throughput, radiance, cont, pending_gate, ray_count)


def bounce_loop(
    origin: Vec3,
    direction: Vec3,
    px: torch.Tensor,
    py: torch.Tensor,
    frame_id,
    scene: SceneTensors,
    config: RenderConfig,
    return_stats: bool = False,
):
    """Trace one frame's paths from the given primary lanes; returns the
    radiance ``[N, S]`` (and the reference-equivalent ray count)."""
    require_slice(scene, config)
    n = origin.x.shape[0]
    s = config.n_samples
    dev = origin.x.device
    state = BounceState(
        origin=origin,
        direction=direction,
        throughput=torch.ones((n, s), dtype=torch.float32, device=dev),
        radiance=torch.zeros((n, s), dtype=torch.float32, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        pending_gate=torch.zeros((n,), dtype=torch.bool, device=dev),
        ray_count=torch.zeros((), dtype=torch.float32, device=dev),
    )
    if config.n_objects > 0:
        for i in range(config.max_bounces):
            state = _bounce(
                state, config.max_bounces - i, frame_id, px, py, scene, config
            )
            # a dead lane adds nothing, so an all-dead wavefront is done
            if not bool(state.alive.any()):
                break
    if return_stats:
        return state.radiance, state.ray_count
    return state.radiance


def integrate_frame(
    scene: SceneTensors,
    config: RenderConfig,
    frame_id,
    return_stats: bool = False,
):
    """Trace one progressive frame; returns linear RGB ``[H, W, 3]`` (and
    the reference-equivalent submitted-ray count if requested)."""
    origin, direction, px, py = generate_primary_rays(
        scene.cam_pos, scene.cam_dir, scene.cam_up, scene.fov_y_deg,
        config.width, config.height, frame_id, config.intended_frames,
    )
    out = bounce_loop(
        origin, direction, px, py, frame_id, scene, config,
        return_stats=return_stats,
    )
    rad = out[0] if return_stats else out
    rgb = spectra_to_rgb(rad, scene.xyz_weights, scene.xyz_to_rgb)
    rgb = rgb.reshape(config.height, config.width, 3)
    return (rgb, out[1]) if return_stats else rgb


def _f32(v: int, device) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=device)


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
