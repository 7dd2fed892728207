"""[Frozen copy of ``spectral_tpu_torch/ops/sampling.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Direction sampling on tensors (the twin of ``spectral_tpu.ops.sampling``):
mirror reflection, the cosine hemisphere in its ``asin`` form, roughness
cones, and the dielectric branch. The bases replicate nalgebra's
``Rotation3::face_towards`` column convention."""

from __future__ import annotations

import math

import torch

from benchmark.reference.vecmath import Vec3, sqrt

PI = math.pi  # rounds to float32 pi where it meets a float32 tensor


def reflect_vec(incident: Vec3, normal: Vec3) -> Vec3:
    """Mirror reflection (reference ``src/shader.rs:709-711``)."""
    return incident - normal * (2.0 * normal.dot(incident))


def cosine_hemisphere_bounce(random_x, random_y, normal: Vec3) -> Vec3:
    """Cosine-importance bounce about ``normal`` (reference
    ``src/shader.rs:717-729``): ``theta = asin(sqrt(rx))``,
    ``phi = 2 pi ry``, rotated by ``face_towards(normal, up)``."""
    theta = torch.asin(sqrt(random_x))
    phi = (2.0 * PI) * random_y
    sin_t = torch.sin(theta)
    local = Vec3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta))
    near_y = torch.abs(normal.y) > 0.9999
    one = torch.ones_like(random_x)
    zero = torch.zeros_like(random_x)
    up = Vec3(torch.where(near_y, one, zero), torch.where(near_y, zero, one), zero)
    z = normal.normalize()
    x = up.cross(z).normalize()
    y = z.cross(x).normalize()
    return x * local.x + y * local.y + z * local.z


def refract_or_reflect(d: Vec3, normal: Vec3, n_lambda, random_fresnel):
    """Dielectric interaction: Snell refraction, Schlick-Fresnel
    reflectance and total internal reflection. Returns
    ``(direction, reflected_mask, oriented_normal)``; the oriented normal
    faces against the incident ray. The reference's integer powers are
    products in jnp (``x ** 5`` is ``x * ((x*x) * (x*x))``), which
    ``torch.pow`` does not round alike, so they are written out here, as
    in the kernels (``csrc/bounce.cuh:refract_or_reflect``): one ulp of
    the reflectance decides the branch."""
    cosi_signed = -d.dot(normal)
    entering = cosi_signed > 0.0
    sgn = torch.where(entering, 1.0, -1.0)
    n_or = normal * sgn
    cosi = torch.abs(cosi_signed)
    eta = torch.where(entering, 1.0 / n_lambda, n_lambda)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    cos_t = sqrt(torch.clamp_min(k, 0.0))
    q = (n_lambda - 1.0) / (n_lambda + 1.0)
    r0 = q * q
    cos_x = torch.where(entering, cosi, cos_t)
    m = 1.0 - cos_x
    m2 = m * m
    fresnel = r0 + (1.0 - r0) * (m2 * m2 * m)  # x**5 as x^4 * x
    reflected = tir | (random_fresnel < fresnel)
    refr = d * eta + n_or * (eta * cosi - cos_t)
    refl = reflect_vec(d, n_or)
    return refl.where(reflected, refr), reflected, n_or


def sample_in_cone(original_direction: Vec3, roughness, random_x, random_y) -> Vec3:
    """Perturb a direction within the roughness cone (reference
    ``src/shader.rs:736-755``): half-angle ``roughness^2 * pi/2``."""
    theta_max = roughness * roughness * (PI / 2.0)
    cos_theta = (1.0 - random_x) + random_x * torch.cos(theta_max)
    sin_theta = sqrt(1.0 - cos_theta * cos_theta)
    phi = (2.0 * PI) * random_y
    local = Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta)
    w = original_direction.normalize()
    near_z = torch.abs(w.z) < 0.999
    one = torch.ones_like(w.x)
    zero = torch.zeros_like(w.x)
    a = Vec3(torch.where(near_z, zero, one), zero, torch.where(near_z, one, zero))
    v = w.cross(a).normalize()
    u = v.cross(w)
    return (u * local.x + v * local.y + w * local.z).normalize()
