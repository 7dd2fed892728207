"""Uniform-grid traced intersection, 3D-DDA over the wavefront (the port
of ``spectral_tpu.ops.grid_trace``, in eager PyTorch).

The opt-in alternative to the brute-force ``ops.geometry.trace``: every
lane walks the grid front to back with masked DDA steps, testing only
the objects binned into its current cell. The state per lane is fixed
(cell coordinates, per-axis crossing distances, best hit), the step loop
is bounded by ``rx + ry + rz + 2`` steps, and each cell's objects are
visited in ascending index order, so the reference's lowest-index tie
rule holds within a cell.

Known divergence from brute force (the reference's, documented there):
two objects touching exactly on a shared cell boundary at identical
``t`` may resolve to the object in the nearer cell rather than the
globally lowest index, a measure-zero case for real scenes. Boxes and
spheres only: a triangle row keeps its edges in the slab columns, so
``Renderer(accel="grid")`` refuses triangle scenes.
"""

from __future__ import annotations

import torch

from spectral_tpu_torch.ops.geometry import TraceResult, ray_slabs, sphere_nearest_t
from spectral_tpu_torch.ops.vecmath import Vec3, matrix_rows, rotate
from spectral_tpu_torch.scene.accel import UniformGrid
from spectral_tpu_torch.scene.flatten import OBJ_SPHERE, SceneTensors

INF = float("inf")


def _intersect_gathered(origin: Vec3, direction: Vec3, obj: torch.Tensor,
                        scene: SceneTensors):
    """Per-lane intersection with one gathered object per lane: the slab
    test in the box's frame for both box types (the exit when the origin
    is inside), the quadratic for spheres; the same math as the
    broadcast tests of ``ops.geometry``."""
    shift = Vec3.from_array(scene.shift).take(obj)
    inv_rows = tuple(r.take(obj) for r in matrix_rows(scene.inv_rot))
    smin = Vec3.from_array(scene.slab_min).take(obj)
    smax = Vec3.from_array(scene.slab_max).take(obj)

    local_o = rotate(inv_rows, origin - shift)
    local_d = rotate(inv_rows, direction)
    t_min, t_max, hit_slab = ray_slabs(local_o, local_d, smin, smax)
    t_box = torch.where(t_min >= 0.0, t_min, t_max)

    sp = Vec3.from_array(scene.sphere_pos).take(obj)
    t_sph, hit_sph = sphere_nearest_t(origin - sp, direction, scene.radius[obj])

    is_sphere = scene.obj_type[obj] == OBJ_SPHERE
    t = torch.where(is_sphere, t_sph, t_box)
    ok = torch.where(is_sphere, hit_sph, hit_slab) & (t > 0.0)
    return t, ok


def _cell_of(p, lo, inv, r: int) -> torch.Tensor:
    """The clamped cell index along one axis (non-finite coordinates, which
    only inactive lanes carry, land in cell 0)."""
    c = torch.floor((p - lo) * inv)
    c = torch.nan_to_num(c, nan=0.0, posinf=float(r - 1), neginf=0.0)
    return torch.clamp(c, 0, r - 1).to(torch.int64)


def _axis_setup(d, o, lo, cs, c):
    step = torch.where(d >= 0.0, 1, -1)
    next_b = lo + (c + (d >= 0.0).to(torch.int64)).to(torch.float32) * cs
    t_axis = (next_b - o) / d  # d == 0 gives +-inf or NaN, sanitized below
    t_axis = torch.where(torch.isfinite(t_axis), t_axis, INF)
    t_delta = torch.abs(cs / d)
    t_delta = torch.where(torch.isfinite(t_delta), t_delta, INF)
    return step, t_axis, t_delta


def trace_grid(origin: Vec3, direction: Vec3, scene: SceneTensors,
               grid: UniformGrid) -> TraceResult:
    """Nearest positive hit by DDA traversal of ``grid``
    (``scene.accel.build_grid``): ``t`` (+inf on a miss), the object
    index (0 on a miss) and the hit mask."""
    rx, ry, rz = grid.res
    n = origin.x.shape[0]
    dev = origin.x.device
    origin = Vec3(*(c.contiguous() for c in origin))
    direction = Vec3(*(c.contiguous() for c in direction))

    g_lo = Vec3(grid.origin[0], grid.origin[1], grid.origin[2])
    csize = Vec3(grid.cell_size[0], grid.cell_size[1], grid.cell_size[2])
    g_hi = Vec3(g_lo.x + csize.x * rx, g_lo.y + csize.y * ry, g_lo.z + csize.z * rz)

    t_min, t_max, hit_grid = ray_slabs(
        origin, direction,
        Vec3(*(c.expand(n) for c in g_lo)), Vec3(*(c.expand(n) for c in g_hi)))
    t_enter = torch.fmax(t_min, torch.zeros_like(t_min))
    active = hit_grid & (t_max >= t_enter)

    # the entry point nudged inside; cell coordinates clamped to the grid
    p = origin + direction * (t_enter + 1e-6)
    cx = _cell_of(p.x, g_lo.x, grid.inv_cell[0], rx)
    cy = _cell_of(p.y, g_lo.y, grid.inv_cell[1], ry)
    cz = _cell_of(p.z, g_lo.z, grid.inv_cell[2], rz)

    sx, tax, tdx = _axis_setup(direction.x, origin.x, g_lo.x, csize.x, cx)
    sy, tay, tdy = _axis_setup(direction.y, origin.y, g_lo.y, csize.y, cy)
    sz, taz, tdz = _axis_setup(direction.z, origin.z, g_lo.z, csize.z, cz)

    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    top_item = max(grid.n_items - 1, 0)
    for _step in range(rx + ry + rz + 2):
        if not bool(active.any()):
            break
        cid = torch.clamp((cx * ry + cy) * rz + cz, 0, rx * ry * rz - 1)
        start = grid.cell_start[cid]
        count = torch.where(active, grid.cell_start[cid + 1] - start, 0)
        for m in range(int(count.max())):
            valid = active & (m < count)
            obj = grid.items[torch.clamp(start + m, 0, top_item)]
            t, ok = _intersect_gathered(origin, direction, obj, scene)
            better = valid & ok & ((t < best_t) | ((t == best_t) & (obj < best_i)))
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, obj, best_i)

        t_exit = torch.fmin(tax, torch.fmin(tay, taz))
        finished = best_t <= t_exit
        # the DDA step along the nearest crossing axis
        is_x = (tax <= tay) & (tax <= taz)
        is_y = ~is_x & (tay <= taz)
        is_z = ~is_x & ~is_y
        cx = cx + torch.where(is_x, sx, 0)
        cy = cy + torch.where(is_y, sy, 0)
        cz = cz + torch.where(is_z, sz, 0)
        tax = tax + torch.where(is_x, tdx, 0.0)
        tay = tay + torch.where(is_y, tdy, 0.0)
        taz = taz + torch.where(is_z, tdz, 0.0)
        out = (cx < 0) | (cx >= rx) | (cy < 0) | (cy >= ry) | (cz < 0) | (cz >= rz)
        active = active & ~finished & ~out
    return TraceResult(best_t, best_i, torch.isfinite(best_t))
