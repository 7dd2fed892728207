"""[Frozen copy of ``spectral_tpu_torch/ops/clusters.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

The cluster plan of the many-object object loop (host side, numpy).

The port's copy of the JAX package's ``plan_clusters``, ``_morton3`` and
``pack_cluster_bounds`` (``spectral_tpu/ops/pallas/megakernel.py:
2395-2494``) and of its Renderer's policy (``render/renderer.py:486-513``):
a scene of more than 64 objects is Morton-sorted by type into clusters of
64 objects, visited front to back from the camera, each pre-tested
against its union AABB (``csrc/bounce.cuh``: ``run_reachable``).

``run_tables`` turns a plan into the two tables the kernels walk
(``csrc/megakernel.cuh``): ``order``, the object indices in visit order,
and ``runs``, one row per run with its union AABB, its slice of
``order``, whether it is culled, and its object type (-1 for the one
mixed run of an unclustered walk). The TPU kernel's compile-size
segmentation of the cluster walk (``_cluster_segments``, megakernel.py:
235) and its SMEM row compaction (``geom_layout``, :105-163) have no
counterpart here: a CUDA loop over a cluster table compiles to the same
code for any scene, and large geometry is read from global memory.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.flatten import OBJ_SPHERE, OBJ_TRIANGLE

# the Renderer's policy: clusters above this many objects, of this size
CLUSTER_ABOVE = 64
CLUSTER_SIZE = 64

# csrc/megakernel.cuh: the columns of a run row
RUN_MIN, RUN_MAX, RUN_START, RUN_STOP, RUN_CULL, RUN_TYPE, RUN_PACK, RUN_COLS = (
    0, 3, 6, 7, 8, 9, 10, 11)


def _morton3(q: np.ndarray) -> np.ndarray:
    """Interleave 10-bit xyz quantized coordinates into a Morton key."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )


def plan_clusters(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    obj_types: tuple[int, ...],
    cluster_size: int = 32,
    min_run: int = 8,
    camera_pos=None,
):
    """Host-side cluster plan for the culled many-object loop.

    Objects are partitioned by type, Morton-sorted by world-AABB center
    within each type, and chunked into clusters of ``cluster_size``. Runs
    smaller than ``min_run`` stay unclustered (always visited).
    ``camera_pos`` orders the clusters front-to-back from the camera, so
    near clusters tighten every lane's ``t_best`` early and the relevance
    test skips far ones. Pure visit-order change: results stay identical
    (original-index tie rule).

    Returns ``(sigma, runs)``: ``sigma``, the original object indices in
    visit order; ``runs``, one ``(type_tag, start, stop, clustered)`` per
    cluster (or per unclustered type run), in ``sigma``'s index space.
    """
    amin = np.asarray(aabb_min, np.float64)
    amax = np.asarray(aabb_max, np.float64)
    centers = (amin + amax) * 0.5
    types = np.asarray(obj_types, np.int32)
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, 1e-9)
    q = np.clip(((centers - lo) / span * 1023.0), 0, 1023).astype(np.uint32)
    keys = _morton3(q)

    sigma: list[int] = []
    runs: list[tuple[int, int, int, bool]] = []
    for tag in sorted(set(obj_types)):
        idx = np.nonzero(types == tag)[0]
        if len(idx) < min_run:
            start = len(sigma)
            sigma.extend(int(i) for i in idx)
            runs.append((int(tag), start, len(sigma), False))
            continue
        order = idx[np.argsort(keys[idx], kind="stable")]
        chunks = [
            order[c0:c0 + cluster_size]
            for c0 in range(0, len(order), cluster_size)
        ]
        if camera_pos is not None:
            cam = np.asarray(camera_pos, np.float64)
            chunks.sort(
                key=lambda ch: float(
                    np.linalg.norm(centers[ch].mean(axis=0) - cam)
                )
            )
        for chunk in chunks:
            start = len(sigma)
            sigma.extend(int(i) for i in chunk)
            runs.append((int(tag), start, len(sigma), True))
    return tuple(sigma), tuple(runs)


def pack_cluster_bounds(aabb_min, aabb_max, sigma: tuple, runs: tuple) -> np.ndarray:
    """``[8, n_runs]`` float32 world-AABB union per run (min xyz, max xyz,
    two pad rows), laid out like the reference's (unclustered runs get
    columns too)."""
    sig = np.asarray(sigma, np.int64)
    amin = np.asarray(aabb_min, np.float32)[sig]
    amax = np.asarray(aabb_max, np.float32)[sig]
    cols = [
        np.concatenate([amin[start:stop].min(axis=0), amax[start:stop].max(axis=0),
                        np.zeros(2, np.float32)])
        for _tag, start, stop, _clustered in runs
    ]
    return np.stack(cols).astype(np.float32).T


def renderer_plan(np_fields: dict, n_objects: int, accel: str = "auto"):
    """The Renderer's cluster policy: a plan of 64-object clusters, front
    to back from the camera, when the scene has more than 64 objects and
    ``accel`` is not "none"; else None (one always-visited run)."""
    if accel not in ("auto", "none"):
        raise ValueError(f"unknown accel {accel!r} (the port has 'auto' and 'none')")
    if n_objects <= CLUSTER_ABOVE or accel == "none":
        return None
    return plan_clusters(
        np_fields["aabb_min"], np_fields["aabb_max"],
        tuple(int(t) for t in np_fields["obj_type"]),
        cluster_size=CLUSTER_SIZE, camera_pos=np_fields["cam_pos"][:3],
    )


def run_tables(np_fields: dict, n_objects: int, plan) -> tuple[np.ndarray, np.ndarray]:
    """The kernels' walk tables for a plan (None: every object in index
    order, one unculled run): ``(order int32 [n_objects], runs float32
    [n_runs, RUN_COLS])``."""
    if plan is None:
        runs = np.zeros((1, RUN_COLS), np.float32)
        runs[0, RUN_MIN:RUN_MIN + 3] = -np.inf
        runs[0, RUN_MAX:RUN_MAX + 3] = np.inf
        runs[0, RUN_STOP] = n_objects
        runs[0, RUN_TYPE] = -1
        runs[0, RUN_PACK] = -1
        return np.arange(n_objects, dtype=np.int32), runs
    sigma, plan_runs = plan
    bounds = pack_cluster_bounds(np_fields["aabb_min"], np_fields["aabb_max"],
                                 sigma, plan_runs)
    runs = np.zeros((len(plan_runs), RUN_COLS), np.float32)
    runs[:, RUN_MIN:RUN_MIN + 6] = bounds[:6].T
    for r, (tag, start, stop, clustered) in enumerate(plan_runs):
        runs[r, RUN_START] = start
        runs[r, RUN_STOP] = stop
        runs[r, RUN_CULL] = 1.0 if clustered else 0.0
        runs[r, RUN_TYPE] = tag
        runs[r, RUN_PACK] = -1  # set by the packer (megakernel.pack_walk)
    return np.asarray(sigma, np.int32), runs


def pack_walk(np_fields: dict, order: np.ndarray, runs: np.ndarray) -> np.ndarray:
    """The walk's packed records (``csrc/megakernel.cuh``: packed): for
    every sphere run, one ``(centre, radius)`` row per member, and for
    every triangle run three rows per member, ``(v0, 0)``, ``(e1, 0)``,
    ``(e2, 0)``, each run's members in visit order (``order``). Sets each
    run's ``RUN_PACK`` column in ``runs`` (in place) to its first record,
    -1 for runs without records (boxes, the mixed run of an unclustered
    walk). Returns float32 ``[n_records, 4]``; the values are the 47-row
    table's, bit for bit."""
    def field(name, width):
        return np.asarray(np_fields[name], np.float32).reshape(-1, width)

    centre, radius = field("sphere_pos", 3), field("radius", 1)
    v0, e1, e2 = field("shift", 3), field("slab_min", 3), field("slab_max", 3)
    pad = np.zeros((len(order), 1), np.float32)
    sphere = np.concatenate([centre, radius], axis=1)
    tri = np.stack([np.concatenate([v, pad[:len(v)]], axis=1) for v in (v0, e1, e2)], axis=1)
    records = []
    at = 0
    for r in range(runs.shape[0]):
        members = order[int(runs[r, RUN_START]):int(runs[r, RUN_STOP])]
        tag = int(runs[r, RUN_TYPE])
        if tag == OBJ_SPHERE:
            rec = sphere[members]
        elif tag == OBJ_TRIANGLE:
            rec = tri[members].reshape(-1, 4)
        else:
            runs[r, RUN_PACK] = -1
            continue
        runs[r, RUN_PACK] = at
        records.append(rec)
        at += len(rec)
    if not records:
        return np.zeros((0, 4), np.float32)
    return np.ascontiguousarray(np.concatenate(records), np.float32)
