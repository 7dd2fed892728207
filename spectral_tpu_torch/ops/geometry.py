"""Ray-primitive intersection and surface normals on tensors (the twin of
``spectral_tpu.ops.geometry``): every ray tests every object over a
broadcast ``[n_rays, n_objects]`` grid, and the nearest positive hit wins
with ties going to the lowest object index (the reference's stable sort).
Above ``BROADCAST_BUDGET`` grid elements the rays are traced in
sequential chunks, so that many-object scenes keep their temporaries
bounded.

The slice covers plain boxes, spheres and rotated boxes. Triangle rows
raise ``NotImplementedError`` until the mesh slice lands.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spectral_tpu_torch.ops.vecmath import Vec3, matrix_rows, rotate, sqrt
from spectral_tpu_torch.scene.flatten import (
    OBJ_PLAIN_BOX,
    OBJ_SPHERE,
    OBJ_TRIANGLE,
    SceneTensors,
)

F32_DELTA = 1e-5  # reference src/shader.rs:7
INF = float("inf")
# Cap on the [n_rays, n_objects] broadcast temporaries (elements), the
# reference's _BROADCAST_BUDGET (ops/geometry.py:198): above it, rays are
# traced in sequential chunks.
BROADCAST_BUDGET = 32 * 1024 * 1024


def require_no_triangles(scene: SceneTensors) -> None:
    if OBJ_TRIANGLE in scene.obj_types:
        raise NotImplementedError(
            "triangle meshes are not in the port yet (queued: the mesh "
            "slice, ROADMAP queue 1 item 11)"
        )


def ray_slabs(origin: Vec3, direction: Vec3, smin: Vec3, smax: Vec3):
    """Slab-method ray/AABB test (reference ``src/shader.rs:531-556``).
    Returns ``(t_min, t_max, hit)``; NaN-ignoring min/max like Rust's
    ``f32::min/max``, strict ``t_max > t_min`` and ``t_max >= 0``."""
    t_min = t_max = None
    for lo, hi, o, d in (
        (smin.x, smax.x, origin.x, direction.x),
        (smin.y, smax.y, origin.y, direction.y),
        (smin.z, smax.z, origin.z, direction.z),
    ):
        iv = 1.0 / d
        t1 = (lo - o) * iv
        t2 = (hi - o) * iv
        swap = iv < 0.0
        t_near = torch.where(swap, t2, t1)
        t_far = torch.where(swap, t1, t2)
        if t_min is None:
            # fmax(-inf, x) == x and fmin(inf, x) == x, NaN included
            t_min = torch.fmax(torch.full_like(t_near, -INF), t_near)
            t_max = torch.fmin(torch.full_like(t_far, INF), t_far)
        else:
            t_min = torch.fmax(t_min, t_near)
            t_max = torch.fmin(t_max, t_far)
    hit = (t_max > t_min) & (t_max >= 0.0)
    return t_min, t_max, hit


def sphere_nearest_t(oc: Vec3, d: Vec3, radius):
    """Nearest non-negative sphere intersection in the reference's
    division form (``src/shader.rs:302-327, 508-527``). Returns
    ``(t, valid)``; the caller applies the strict ``t > 0`` rule."""
    a = d.dot(d)
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 >= 0.0, t1, t2)
    return t, (disc >= 0.0) & (t >= 0.0)


def _col(v: torch.Tensor) -> torch.Tensor:
    return v[:, None]


def _row(v: torch.Tensor) -> torch.Tensor:
    return v[None, :]


def _box_t(origin: Vec3, direction: Vec3, scene: SceneTensors):
    """Entry distance for both box types over ``[n_rays, n_objects]``: the
    ray is moved into each box's frame (identity for plain boxes) and
    tested against its slabs; the exit is taken when the origin is inside."""
    smin = Vec3.from_array(scene.slab_min)
    smax = Vec3.from_array(scene.slab_max)
    shift = Vec3.from_array(scene.shift)
    inv_rows = tuple(
        Vec3(_row(r.x), _row(r.y), _row(r.z)) for r in matrix_rows(scene.inv_rot)
    )
    o_rel = Vec3(
        _col(origin.x) - _row(shift.x),
        _col(origin.y) - _row(shift.y),
        _col(origin.z) - _row(shift.z),
    )
    local_o = rotate(inv_rows, o_rel)
    d_b = Vec3(_col(direction.x), _col(direction.y), _col(direction.z))
    local_d = rotate(inv_rows, d_b)
    t_min, t_max, hit = ray_slabs(
        local_o, local_d,
        Vec3(_row(smin.x), _row(smin.y), _row(smin.z)),
        Vec3(_row(smax.x), _row(smax.y), _row(smax.z)),
    )
    return torch.where(t_min >= 0.0, t_min, t_max), hit


def _sphere_t(origin: Vec3, direction: Vec3, scene: SceneTensors):
    sp = Vec3.from_array(scene.sphere_pos)
    oc = Vec3(
        _col(origin.x) - _row(sp.x),
        _col(origin.y) - _row(sp.y),
        _col(origin.z) - _row(sp.z),
    )
    d_b = Vec3(_col(direction.x), _col(direction.y), _col(direction.z))
    return sphere_nearest_t(oc, d_b, _row(scene.radius))


class TraceResult(NamedTuple):
    t: torch.Tensor  # [N] nearest hit distance (+inf on miss)
    obj_idx: torch.Tensor  # [N] int64 index of the nearest object (0 on miss)
    hit: torch.Tensor  # [N] bool


def trace(origin: Vec3, direction: Vec3, scene: SceneTensors) -> TraceResult:
    """The reference's ``submit_ray`` trace (``src/shader.rs:468-483``):
    test all objects, keep ``t > 0``, nearest wins, lowest index on ties.
    Rays x objects is one dense broadcast when it fits
    ``BROADCAST_BUDGET``, otherwise sequential ray chunks (every ray's
    result is its own, so chunking changes no bit)."""
    require_no_triangles(scene)
    n = origin.x.shape[0]
    n_obj = scene.obj_type.shape[0]
    if n_obj == 0:
        dev = origin.x.device
        return TraceResult(
            torch.full((n,), INF, device=dev),
            torch.zeros((n,), dtype=torch.int64, device=dev),
            torch.zeros((n,), dtype=torch.bool, device=dev),
        )
    if n * n_obj <= BROADCAST_BUDGET:
        return _trace_dense(origin, direction, scene)
    chunk = max(128, BROADCAST_BUDGET // n_obj)
    parts = [
        _trace_dense(Vec3(*(c[lo:lo + chunk] for c in origin)),
                     Vec3(*(c[lo:lo + chunk] for c in direction)), scene)
        for lo in range(0, n, chunk)
    ]
    return TraceResult(*(torch.cat(f) for f in zip(*parts)))


def _trace_dense(origin: Vec3, direction: Vec3, scene: SceneTensors) -> TraceResult:
    # dense ray planes: a broadcast (stride-0) origin, such as the camera
    # position of a regenerated frame, would give the [n_rays, n_objects]
    # temporaries a column-major layout and slow every op on them
    origin = Vec3(*(c.contiguous() for c in origin))
    direction = Vec3(*(c.contiguous() for c in direction))
    t_box, hit_box = _box_t(origin, direction, scene)
    t_sph, hit_sph = _sphere_t(origin, direction, scene)
    is_sphere = _row(scene.obj_type == OBJ_SPHERE)
    t = torch.where(is_sphere, t_sph, t_box)
    valid = torch.where(is_sphere, hit_sph, hit_box) & (t > 0.0)
    t_all = torch.where(valid, t, INF)
    # argmin returns the first minimal index: the lowest-index tie rule
    obj_idx = torch.argmin(t_all, dim=1)
    t_hit = torch.gather(t_all, 1, obj_idx[:, None])[:, 0]
    return TraceResult(t_hit, obj_idx, torch.isfinite(t_hit))


def trace_shadow(
    origin: Vec3, direction: Vec3, max_distance: torch.Tensor, scene: SceneTensors
) -> torch.Tensor:
    """Occlusion: true iff the nearest positive hit lies within
    ``max_distance`` (reference ``src/shader.rs:484-489``)."""
    res = trace(origin, direction, scene)
    return res.hit & (res.t <= max_distance)


def _plain_box_normal(ip: Vec3, amin: Vec3, amax: Vec3) -> Vec3:
    """Face normal from proximity to the AABB planes (reference
    ``src/shader.rs:582-605``): min face first, then max face."""

    def axis(p, lo, hi):
        one = torch.ones_like(p)
        return torch.where(
            torch.abs(p - lo) < F32_DELTA,
            -one,
            torch.where(torch.abs(p - hi) < F32_DELTA, one, torch.zeros_like(p)),
        )

    n = Vec3(axis(ip.x, amin.x, amax.x), axis(ip.y, amin.y, amax.y),
             axis(ip.z, amin.z, amax.z))
    return n.normalize()


def _rotated_box_normal(ip: Vec3, pos: Vec3, half: Vec3, rot_rows, inv_rows) -> Vec3:
    """Closest local face, rotated back to world (reference
    ``src/shader.rs:608-650``); strict ``<`` in the reference's scan order."""
    local = rotate(inv_rows, ip - pos)
    dx = torch.abs(half.x - local.x)
    one = torch.ones_like(dx)
    zero = torch.zeros_like(dx)
    min_dist = dx
    n = Vec3(one, zero, zero)
    for dist, cand in (
        (torch.abs(-half.x - local.x), Vec3(-one, zero, zero)),
        (torch.abs(half.y - local.y), Vec3(zero, one, zero)),
        (torch.abs(-half.y - local.y), Vec3(zero, -one, zero)),
        (torch.abs(half.z - local.z), Vec3(zero, zero, one)),
        (torch.abs(-half.z - local.z), Vec3(zero, zero, -one)),
    ):
        n = cand.where(dist < min_dist, n)
        min_dist = torch.fmin(min_dist, dist)
    return rotate(rot_rows, n)


def surface_normal(ip: Vec3, obj_idx: torch.Tensor, scene: SceneTensors) -> Vec3:
    """Per-ray surface normal at hit points (reference ``hit_shader``
    normal dispatch, ``src/shader.rs:366-378``)."""
    require_no_triangles(scene)
    amin = Vec3.from_array(scene.aabb_min).take(obj_idx)
    amax = Vec3.from_array(scene.aabb_max).take(obj_idx)
    pos = Vec3.from_array(scene.center).take(obj_idx)
    half = Vec3.from_array(scene.half_dim).take(obj_idx)
    sp = Vec3.from_array(scene.sphere_pos).take(obj_idx)
    rot_rows = tuple(r.take(obj_idx) for r in matrix_rows(scene.rot))
    inv_rows = tuple(r.take(obj_idx) for r in matrix_rows(scene.inv_rot))
    otype = scene.obj_type[obj_idx]

    n_box = _plain_box_normal(ip, amin, amax)
    n_sphere = (ip - sp).normalize()
    n_rot = _rotated_box_normal(ip, pos, half, rot_rows, inv_rows)
    n = n_box.where(otype == OBJ_PLAIN_BOX, n_rot)
    return n_sphere.where(otype == OBJ_SPHERE, n)
