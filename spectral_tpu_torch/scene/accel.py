"""Uniform-grid acceleration structure (the port's copy of
``spectral_tpu.scene.accel``).

The reference traces by brute force: every ray tests every object
(reference ``src/shader.rs:471``). The opt-in alternative is a uniform
grid with 3D-DDA traversal (``ops/grid_trace.py``): fixed-size state per
lane, a bounded loop, and per-cell object lists visited in index order,
which keeps the reference's lowest-index tie rule.

The grid is built on the host from the flattened scene's object AABBs
(object/cell overlap into CSR lists) and copied to the scene's device as
three tables. It is an eager tracer of the CPU path only: the CUDA
kernels walk every object or cull by 64-object cluster
(``ops/clusters.py``), and ``Renderer(accel="grid")`` refuses the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spectral_tpu_torch.scene.flatten import SceneTensors

F32 = np.float32


@dataclasses.dataclass
class UniformGrid:
    origin: torch.Tensor  # f32 [3] grid minimum corner
    cell_size: torch.Tensor  # f32 [3]
    inv_cell: torch.Tensor  # f32 [3]
    cell_start: torch.Tensor  # int64 [n_cells + 1] CSR offsets (x-major)
    items: torch.Tensor  # int64 [n_items] object indices, ascending per cell
    res: tuple[int, int, int]
    max_items_per_cell: int
    n_items: int


def build_grid(scene: SceneTensors, res: tuple[int, int, int] | None = None) -> UniformGrid:
    """Host-side build: bin every object's world AABB into the cells it
    overlaps (the reference's ``build_grid``, same arithmetic).

    ``res`` defaults to a cube-root heuristic (about 4 objects per
    occupied cell for uniformly spread scenes)."""
    aabb_min = np.asarray(scene.np_fields["aabb_min"], dtype=F32)
    aabb_max = np.asarray(scene.np_fields["aabb_max"], dtype=F32)
    n_obj = len(aabb_min)
    if n_obj == 0:
        raise ValueError("cannot build a grid for an empty scene")

    lo = aabb_min.min(axis=0)
    hi = aabb_max.max(axis=0)
    extent = np.maximum(hi - lo, F32(1e-4))
    # pad so boundary geometry is strictly inside
    lo = (lo - extent * F32(1e-3)).astype(F32)
    hi = (hi + extent * F32(1e-3)).astype(F32)
    extent = (hi - lo).astype(F32)

    if res is None:
        r = max(2, min(64, int(round(float(n_obj) ** (1 / 3) * 2))))
        res = (r, r, r)
    rx, ry, rz = res
    cell = (extent / np.array(res, dtype=F32)).astype(F32)

    cells: list[list[int]] = [[] for _ in range(rx * ry * rz)]
    top = np.array(res) - 1
    for o in range(n_obj):
        c0 = np.clip(((aabb_min[o] - lo) / cell).astype(np.int64), 0, top)
        c1 = np.clip(((aabb_max[o] - lo) / cell).astype(np.int64), 0, top)
        for ix in range(c0[0], c1[0] + 1):
            for iy in range(c0[1], c1[1] + 1):
                for iz in range(c0[2], c1[2] + 1):
                    cells[(ix * ry + iy) * rz + iz].append(o)

    counts = np.array([len(c) for c in cells], dtype=np.int64)
    cell_start = np.zeros(len(cells) + 1, dtype=np.int64)
    np.cumsum(counts, out=cell_start[1:])
    items = np.fromiter((o for c in cells for o in c), dtype=np.int64,
                        count=int(counts.sum()))
    dev = scene.device
    return UniformGrid(
        origin=torch.from_numpy(lo).to(dev),
        cell_size=torch.from_numpy(cell).to(dev),
        inv_cell=torch.from_numpy((F32(1.0) / cell).astype(F32)).to(dev),
        cell_start=torch.from_numpy(cell_start).to(dev),
        items=torch.from_numpy(items).to(dev),
        res=(int(rx), int(ry), int(rz)),
        max_items_per_cell=int(counts.max()) if len(counts) else 0,
        n_items=int(counts.sum()),
    )
