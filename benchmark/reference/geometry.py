"""[Frozen copy of ``spectral_tpu_torch/ops/geometry.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Ray-primitive intersection and surface normals on tensors (the twin of
``spectral_tpu.ops.geometry``): every ray tests every object over a
broadcast ``[n_rays, n_objects]`` grid, and the nearest positive hit wins
with ties going to the lowest object index (the reference's stable sort).
Above ``BROADCAST_BUDGET`` grid elements the rays are traced in
sequential chunks, so that many-object scenes keep their temporaries
bounded.

Plain boxes, spheres, rotated boxes and triangles (mesh faces,
Moller-Trumbore in the reference's op order).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.vecmath import Vec3, matrix_rows, rotate, sqrt
from benchmark.reference.flatten import (
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


def triangle_t(origin: Vec3, direction: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Moller-Trumbore ray/triangle intersection in the reference's op
    order (``spectral_tpu/ops/geometry.py:134-157``); inputs broadcast to
    a common shape. Two-sided, no epsilon: a zero determinant makes
    ``inv_det`` inf, and the inf/NaN barycentrics fail the ``>= 0`` box
    conditions. Returns ``(t, valid, u, v)``; the caller applies the
    strict ``t > 0`` rule."""
    p = direction.cross(e2)
    det = e1.dot(p)
    inv_det = 1.0 / det
    s = origin - v0
    u = s.dot(p) * inv_det
    q = s.cross(e1)
    v = direction.dot(q) * inv_det
    t = e2.dot(q) * inv_det
    valid = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
    return t, valid, u, v


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


def _triangle_t(origin: Vec3, direction: Vec3, scene: SceneTensors):
    """Triangle candidates over ``[n_rays, n_objects]``: triangle rows
    store v0 in ``shift`` and e1/e2 in ``slab_min``/``slab_max``."""
    v0, e1, e2 = (Vec3.from_array(a) for a in (scene.shift, scene.slab_min, scene.slab_max))
    t, valid, _u, _v = triangle_t(
        Vec3(_col(origin.x), _col(origin.y), _col(origin.z)),
        Vec3(_col(direction.x), _col(direction.y), _col(direction.z)),
        Vec3(_row(v0.x), _row(v0.y), _row(v0.z)),
        Vec3(_row(e1.x), _row(e1.y), _row(e1.z)),
        Vec3(_row(e2.x), _row(e2.y), _row(e2.z)),
    )
    return t, valid


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


def candidates(origin: Vec3, direction: Vec3, scene: SceneTensors) -> torch.Tensor:
    """``[n_rays, n_objects]`` hit distances of every ray against every
    object: t where the object's test is valid and ``t > 0``, else +inf."""
    # dense ray planes: a broadcast (stride-0) origin, such as the camera
    # position of a regenerated frame, would give the [n_rays, n_objects]
    # temporaries a column-major layout and slow every op on them
    origin = Vec3(*(c.contiguous() for c in origin))
    direction = Vec3(*(c.contiguous() for c in direction))
    t_box, hit_box = _box_t(origin, direction, scene)
    t_sph, hit_sph = _sphere_t(origin, direction, scene)
    is_sphere = _row(scene.obj_type == OBJ_SPHERE)
    t = torch.where(is_sphere, t_sph, t_box)
    valid = torch.where(is_sphere, hit_sph, hit_box)
    if scene.has_triangles:
        # triangle rows reuse the slab columns for e1/e2, so their t_box
        # is meaningless: selected out here, as the sphere rows are
        t_tri, hit_tri = _triangle_t(origin, direction, scene)
        is_tri = _row(scene.obj_type == OBJ_TRIANGLE)
        t = torch.where(is_tri, t_tri, t)
        valid = torch.where(is_tri, hit_tri, valid)
    return torch.where(valid & (t > 0.0), t, INF)


def _trace_dense(origin: Vec3, direction: Vec3, scene: SceneTensors) -> TraceResult:
    t_all = candidates(origin, direction, scene)
    # argmin returns the first minimal index: the lowest-index tie rule
    obj_idx = torch.argmin(t_all, dim=1)
    t_hit = torch.gather(t_all, 1, obj_idx[:, None])[:, 0]
    return TraceResult(t_hit, obj_idx, torch.isfinite(t_hit))


def trace_shadow(
    origin: Vec3, direction: Vec3, max_distance: torch.Tensor, scene: SceneTensors,
    interval: bool = False,
) -> torch.Tensor:
    """Occlusion: true iff the nearest positive hit lies within
    ``max_distance`` (reference ``src/shader.rs:484-489``). With
    ``interval``, a sphere occludes by ``sphere_interval_blocked`` and
    every other object by its hit ``t <= max_distance`` (the reference's
    opt-in ``shadow_interval``, the plain twin of the kernels'
    ``-DSPECTRAL_SHADOW_INTERVAL`` builds)."""
    if not interval:
        res = trace(origin, direction, scene)
        return res.hit & (res.t <= max_distance)
    n = origin.x.shape[0]
    n_obj = scene.obj_type.shape[0]
    if n_obj == 0:
        return torch.zeros((n,), dtype=torch.bool, device=origin.x.device)
    chunk = n if n * n_obj <= BROADCAST_BUDGET else max(128, BROADCAST_BUDGET // n_obj)
    parts = [
        _shadow_interval_dense(Vec3(*(c[lo:lo + chunk] for c in origin)),
                               Vec3(*(c[lo:lo + chunk] for c in direction)),
                               max_distance[lo:lo + chunk], scene)
        for lo in range(0, n, chunk)
    ]
    return torch.cat(parts)


def sphere_interval_blocked(oc: Vec3, d: Vec3, r, maxd) -> torch.Tensor:
    """Whether the reference's chosen sphere root (``t1`` if ``t1 >= 0``,
    else ``t2``) lies in ``(0, maxd]``, without a root: sign tests on
    ``f(t) = a t^2 + b t + c`` (``oc`` = origin - centre), in the op order
    of the reference's ``shadow_interval`` body (``megakernel.py:
    1148-1172``): ``t1`` in range iff ``b < 0``, ``c > 0`` and (the vertex
    ``-b / 2a <= maxd`` or ``f(maxd) <= 0``); ``t2`` (``t1 < 0``) iff
    ``c < 0``, the vertex test and ``f(maxd) >= 0``; both need ``disc >=
    0``. Within rounding of ``t = 0`` or ``t = maxd`` it can differ from
    the root test."""
    a = d.dot(d)
    foura = 4.0 * a
    g0 = 2.0 * a * maxd
    amax2 = a * maxd * maxd
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - r * r
    disc = b * b - foura * c
    fm = amax2 + b * maxd + c
    v_ok = b + g0 >= 0.0
    near = (b < 0.0) & (c > 0.0) & (v_ok | (fm <= 0.0))
    far = (c < 0.0) & v_ok & (fm >= 0.0)
    return (disc >= 0.0) & (near | far)


def _shadow_interval_dense(origin: Vec3, direction: Vec3, max_distance: torch.Tensor,
                           scene: SceneTensors) -> torch.Tensor:
    origin = Vec3(*(c.contiguous() for c in origin))
    direction = Vec3(*(c.contiguous() for c in direction))
    maxd = _col(max_distance)
    others = candidates(origin, direction, scene) <= maxd
    sp = Vec3.from_array(scene.sphere_pos)
    oc = Vec3(_col(origin.x) - _row(sp.x), _col(origin.y) - _row(sp.y),
              _col(origin.z) - _row(sp.z))
    d_b = Vec3(_col(direction.x), _col(direction.y), _col(direction.z))
    spheres = sphere_interval_blocked(oc, d_b, _row(scene.radius), maxd)
    return torch.where(_row(scene.obj_type == OBJ_SPHERE), spheres, others).any(dim=1)


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


def surface_normal(ip: Vec3, obj_idx: torch.Tensor, scene: SceneTensors,
                   origin: Vec3 | None = None,
                   direction: Vec3 | None = None) -> Vec3:
    """Per-ray surface normal at hit points (reference ``hit_shader``
    normal dispatch, ``src/shader.rs:366-378``). A triangle's normal is
    its stored winding normal ``n0`` (the ``inv_rot`` rows hold ``n0,
    n1-n0, n2-n0``); in a scene with vertex normals (``smooth_tri``) it
    is ``normalize(n0 + dn1*u + dn2*v)`` at the winner's barycentrics,
    recomputed from the ray ``origin``/``direction`` that made ``ip`` in
    the trace's op order (the jnp form, ``spectral_tpu/ops/geometry.py:
    364-382``). Never flipped toward the ray."""
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
    n = n_sphere.where(otype == OBJ_SPHERE, n)
    if scene.has_triangles:
        n0, dn1, dn2 = inv_rows
        n_tri = n0
        if scene.smooth_tri and origin is not None and direction is not None:
            v0, e1, e2 = (Vec3.from_array(a).take(obj_idx)
                          for a in (scene.shift, scene.slab_min, scene.slab_max))
            _t, _ok, u, v = triangle_t(origin, direction, v0, e1, e2)
            n_tri = (n0 + dn1 * u + dn2 * v).normalize()
        n = n_tri.where(otype == OBJ_TRIANGLE, n)
    return n
