"""The many-object walk's packed records (``ops/clusters.py:pack_walk``)
on the CPU.

The packed table holds, at each visit slot of every sphere and triangle
run, the 47-row table's own values for the object ``order`` names there
(exact: copies of float32 values). A plain walk over the packed table,
the kernel's (``csrc/bounce.cuh: trace_nearest``: each cluster culled
against its union AABB at ``<=`` the best hit, members read from their
records, ties to the lowest original index), equals the flat loop
(``ops/geometry.py:trace``, every object in index order) on
``sphere_field(80)`` and on the mesh preset: winners exact, t bit for
bit, with duplicated objects so that exact ties occur, in the planner's
visit order and with every run's members reversed. The same walk with
the kernels' warp vote on the packed sphere tests
(``bounce.cuh:sphere_t_voted``) equals it on the tangent field
(``tests/torch_scenes.py:tangent_field``), whose tangent lanes read a
discriminant of exactly 0. The cooperative pass of the triangle runs
(``bounce.cuh:tri_run_nearest``: a needing lane's run folded chunk by
chunk, 32 members a chunk, each chunk the lexicographic minimum of
(t, original index) over its candidates and the lane's best so far)
equals the flat loop on the mesh preset with ties, in both visit orders.
"""

import copy

import numpy as np
import pytest
import torch

from spectral_tpu_torch.ops import clusters as cl
from spectral_tpu_torch.ops import geometry as tgeom
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.ops.vecmath import sqrt as vsqrt
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import OBJ_SPHERE, OBJ_TRIANGLE, flatten_scene
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _scene(kind, dup=False):
    """sphere_field(80) or the mesh preset at 16x12, 3 bounces; ``dup``
    appends copies of some objects (exact ties for every ray that hits
    them)."""
    if kind == "field":
        scene = ts.sphere_field(presets, 80, 16, 12, 3)
        copies = [scene.objects[i] for i in (5, 17, 40)]
    else:
        scene = ts.preset(presets, "mesh", 16, 12, 3)
        copies = [scene.objects[6]]  # the 20-face icosahedron
    if dup:
        scene.objects.extend(copy.copy(o) for o in copies)
    return scene


def _tables(kind, dup=False):
    st, cfg = flatten_scene(_scene(kind, dup), "cpu")
    return st, cfg, mk.pack_tables(st, cfg)


@pytest.mark.parametrize("kind", ["field", "mesh"])
def test_packed_records_equal_the_table_at_each_visit_slot(kind):
    st, cfg, tb = _tables(kind)
    geom, order, runs = tb.geom.numpy(), tb.order.numpy(), tb.runs.numpy()
    packed = tb.packed.numpy()
    assert sorted(order.tolist()) == list(range(cfg.n_objects))
    used = 0
    for start, stop, tag, at in runs[:, [cl.RUN_START, cl.RUN_STOP, cl.RUN_TYPE, cl.RUN_PACK]]:
        start, stop, tag, at = int(start), int(stop), int(tag), int(at)
        if tag not in (OBJ_SPHERE, OBJ_TRIANGLE):
            assert at == -1
            continue
        assert at == used
        for k in range(start, stop):
            o = order[k]
            assert int(geom[0, o]) == tag  # the run holds its own type only
            if tag == OBJ_SPHERE:
                np.testing.assert_array_equal(packed[at + k - start], geom[40:44, o])
            else:
                rec = packed[at + 3 * (k - start):at + 3 * (k - start) + 3]
                for row, first in zip(rec, (7, 1, 4)):  # v0, e1, e2
                    np.testing.assert_array_equal(row, np.append(geom[first:first + 3, o], 0.0))
        used += (stop - start) * (3 if tag == OBJ_TRIANGLE else 1)
    assert used == len(packed) > 0
    flat = mk.pack_tables(st, cfg, accel="none")
    assert flat.packed.shape == (0, 4) and int(flat.runs[0, cl.RUN_PACK]) == -1


def _rays(st, cfg, n_random=512, seed=0):
    """The frame-1 primaries and random rays from inside the scene."""
    planes, _, _ = ci.primary_lanes(st, cfg, 1)
    rng = np.random.default_rng(seed)
    lo = st.np_fields["aabb_min"].min(axis=0)
    hi = st.np_fields["aabb_max"].max(axis=0)
    o = rng.uniform(lo, hi, (n_random, 3)).astype(np.float32)
    d = rng.normal(size=(n_random, 3)).astype(np.float32)
    origin = Vec3(*(torch.cat([planes[i], torch.from_numpy(o[:, i])]) for i in range(3)))
    direction = Vec3(*(torch.cat([planes[3 + i], torch.from_numpy(d[:, i])]) for i in range(3)))
    return origin, direction.normalize()


def _sphere_voted(oc, d, r, lanes):
    """``bounce.cuh:sphere_t_voted`` over warps of 32 consecutive rays:
    the discriminant on every ray, the root stage only in the warps where
    a ray of ``lanes`` (those that run the test) has disc >= 0, with
    sqrt(1) for a ray without a root. Returns ``(t, valid, vote)``, the
    vote per ray."""
    a = d.dot(d)
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - r * r
    disc = b * b - 4.0 * a * c
    root = disc >= 0.0
    n = root.shape[0]
    vote = torch.nn.functional.pad(root & lanes, (0, (-n) % 32)).view(-1, 32).any(1)
    vote = vote.repeat_interleave(32)[:n]
    sq = vsqrt(torch.where(root, disc, 1.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 >= 0.0, t1, t2)
    return t, vote & root & (t >= 0.0), vote


def _coop_triangle_run(t_best, win, reach, t, valid, o, lanes=32):
    """``bounce.cuh:tri_run_nearest``'s cooperative branch for every ray
    that reaches the run: ``t``/``valid`` ``[rays, size]`` the members'
    tests, ``o`` ``[size]`` their original indices. Chunk by chunk (one
    member a lane), a ray's best becomes the lexicographic minimum of
    (t, o) over the chunk's candidates (valid, t > 0, t <= its best) and
    its best so far."""
    big = torch.iinfo(torch.int64).max
    for first in range(0, o.shape[0], lanes):
        tc, vc, oc = t[:, first:first + lanes], valid[:, first:first + lanes], o[first:first + lanes]
        cand = vc & (tc > 0.0) & (tc <= t_best[:, None])
        t_min = torch.where(cand, tc, torch.tensor(float("inf"))).amin(1)
        o_min = torch.where(cand & (tc == t_min[:, None]), oc, big).amin(1)
        take = reach & ((t_min < t_best) | ((t_min == t_best) & (o_min < win)))
        t_best, win = torch.where(take, t_min, t_best), torch.where(take, o_min, win)
    return t_best, win


def _walk_packed(st, order, runs, packed, origin, direction, votes=None, coop=False):
    """The kernel's nearest-hit walk over the run table and the packed
    records, vectorized over rays; boxes (no records) take the flat
    loop's candidate t of their object. With ``votes`` (a list) the packed
    sphere tests take the warp vote (``_sphere_voted``), and each test's
    votes are appended to it. With ``coop`` every packed triangle run
    takes the cooperative pass (``_coop_triangle_run``)."""
    dense = tgeom.candidates(origin, direction, st)
    n = origin.x.shape[0]
    t_best = torch.full((n,), float("inf"))
    win = torch.full((n,), -1, dtype=torch.int64)
    P = torch.from_numpy(packed)
    for row in runs:
        start, stop = int(row[cl.RUN_START]), int(row[cl.RUN_STOP])
        tag, at = int(row[cl.RUN_TYPE]), int(row[cl.RUN_PACK])
        reach = torch.ones((n,), dtype=torch.bool)
        if row[cl.RUN_CULL] > 0:
            box = [Vec3(*(torch.tensor(float(v)) for v in row[i:i + 3])) for i in (0, 3)]
            t_min, _, hit = tgeom.ray_slabs(origin, direction, *box)
            reach = hit & (t_min <= t_best)
        if coop and at >= 0 and tag == OBJ_TRIANGLE:
            tests = [tgeom.triangle_t(origin, direction, *(Vec3(*r[:3]) for r in
                                                           P[at + 3 * (k - start):][:3]))
                     for k in range(start, stop)]
            t_best, win = _coop_triangle_run(
                t_best, win, reach, torch.stack([x[0] for x in tests], 1),
                torch.stack([x[1] for x in tests], 1),
                torch.from_numpy(order[start:stop].astype(np.int64)))
            continue
        for k in range(start, stop):
            o = int(order[k])
            if at >= 0 and tag == OBJ_SPHERE:
                c = P[at + k - start]
                oc = origin - Vec3(c[0], c[1], c[2])
                if votes is None:
                    t, valid = tgeom.sphere_nearest_t(oc, direction, c[3])
                else:
                    t, valid, vote = _sphere_voted(oc, direction, c[3], reach)
                    votes.append((o, vote))
            elif at >= 0 and tag == OBJ_TRIANGLE:
                v0, e1, e2 = (Vec3(*r[:3]) for r in P[at + 3 * (k - start):][:3])
                t, valid, _, _ = tgeom.triangle_t(origin, direction, v0, e1, e2)
            else:
                t = dense[:, o]
                valid = torch.isfinite(t)
            take = (reach & valid & (t > 0.0) & (t <= t_best)
                    & ((t < t_best) | (o < win)))
            t_best = torch.where(take, t, t_best)
            win = torch.where(take, o, win)
    return t_best, win


@pytest.mark.parametrize("visit", ["planned", "reversed"])
@pytest.mark.parametrize("kind", ["field", "mesh"])
def test_plain_packed_walk_equals_the_flat_loop(kind, visit):
    st, cfg, tb = _tables(kind, dup=True)
    assert tb.clusters is not None
    order, runs = tb.order.numpy().copy(), tb.runs.numpy().copy()
    if visit == "reversed":  # the tie rule must not depend on the visit order
        for start, stop in runs[:, [cl.RUN_START, cl.RUN_STOP]].astype(int):
            order[start:stop] = order[start:stop][::-1].copy()
    packed = cl.pack_walk(st.np_fields, order, runs)
    origin, direction = _rays(st, cfg)
    t, win = _walk_packed(st, order, runs, packed, origin, direction)
    want = tgeom.trace(origin, direction, st)
    hit = want.hit
    assert 0.2 < float(hit.float().mean()) < 1.0
    assert torch.equal(win, torch.where(hit, want.obj_idx, -1))
    assert torch.equal(t[hit], want.t[hit]) and bool(torch.isinf(t[~hit]).all())
    # the duplicates tie: each loses to its original, the lower index
    dups = range(cfg.n_objects - (3 if kind == "field" else 20), cfg.n_objects)
    assert not bool(np.isin(win.numpy(), list(dups)).any())


@pytest.mark.parametrize("visit", ["planned", "reversed"])
def test_cooperative_triangle_pass_equals_the_flat_loop(visit):
    """The mesh preset with a duplicated icosahedron (exact ties at every
    ray that hits it): the walk whose packed triangle runs take the
    cooperative pass equals the per-lane walk and the flat loop, winners
    exact and t bit for bit, each duplicate losing to its original."""
    st, cfg, tb = _tables("mesh", dup=True)
    order, runs = tb.order.numpy().copy(), tb.runs.numpy().copy()
    assert (runs[:, cl.RUN_TYPE] == OBJ_TRIANGLE).sum() >= 3
    if visit == "reversed":
        for start, stop in runs[:, [cl.RUN_START, cl.RUN_STOP]].astype(int):
            order[start:stop] = order[start:stop][::-1].copy()
    packed = cl.pack_walk(st.np_fields, order, runs)
    origin, direction = _rays(st, cfg)
    t, win = _walk_packed(st, order, runs, packed, origin, direction, coop=True)
    lane_t, lane_win = _walk_packed(st, order, runs, packed, origin, direction)
    assert torch.equal(win, lane_win) and torch.equal(t, lane_t)
    want = tgeom.trace(origin, direction, st)
    hit = want.hit
    assert torch.equal(win, torch.where(hit, want.obj_idx, -1))
    assert torch.equal(t[hit], want.t[hit]) and bool(torch.isinf(t[~hit]).all())
    dups = list(range(cfg.n_objects - 20, cfg.n_objects))
    tied = (tgeom.candidates(origin, direction, st)[:, dups] == t[:, None]).any(1) & hit
    assert int(tied.sum()) > 0  # rays whose winner ties a duplicate
    assert not bool(np.isin(win.numpy(), dups).any())


def test_voted_walk_on_the_tangent_field_equals_the_flat_loop():
    """The tangent field of the card tests on the CPU: both added spheres
    sit in packed sphere runs, and the walk with the warp vote equals the
    flat loop on the frame's primaries and on bounce 0's shadow rays to
    light 0 (winners exact, t bit for bit), the tangent lanes' winners the
    tangent spheres. The vote is true in the tangent lanes' warps at their
    spheres and false in most warp tests."""
    scene, info = ts.tangent_field(presets, "cpu", 32, 16, 3, iters=4)
    st, cfg = flatten_scene(scene, "cpu")
    tb = mk.pack_tables(st, cfg)
    assert tb.clusters is not None and tb.packed_shared
    order, runs = tb.order.numpy(), tb.runs.numpy()
    for obj in (info["tangent"], info["shadow_tangent"]):
        slot = int(np.nonzero(order == obj)[0][0])
        run = runs[(runs[:, cl.RUN_START] <= slot) & (slot < runs[:, cl.RUN_STOP])][0]
        assert int(run[cl.RUN_TYPE]) == OBJ_SPHERE and run[cl.RUN_PACK] >= 0
    planes, _, _ = ci.primary_lanes(st, cfg, 1)
    so, sd = (torch.from_numpy(a) for a in info["shadow_rays"])
    cases = ((Vec3(*planes[:3]), Vec3(*planes[3:]), info["lane"], info["tangent"]),
             (Vec3(*so.T), Vec3(*sd.T), info["shadow_lane"], info["shadow_tangent"]))
    tests = warp_votes = 0
    for origin, direction, lane, obj in cases:
        votes = []
        t, win = _walk_packed(st, order, runs, tb.packed.numpy(), origin, direction, votes)
        want = tgeom.trace(origin, direction, st)
        hit = want.hit
        assert torch.equal(win, torch.where(hit, want.obj_idx, -1))
        assert torch.equal(t[hit], want.t[hit]) and bool(torch.isinf(t[~hit]).all())
        assert int(win[lane]) == obj
        assert any(o == obj and bool(v[lane]) for o, v in votes)
        tests += sum(v[::32].numel() for _, v in votes)
        warp_votes += sum(int(v[::32].sum()) for _, v in votes)
    assert 0 < warp_votes < 0.5 * tests
