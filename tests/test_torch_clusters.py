"""The many-object path's host side on the CPU against the JAX package:
the cluster plan, its bounds and the Morton lane layout equal the
reference's outputs exactly; the chunked eager trace over a 100-sphere
scene equals the reference's jnp trace (winners exact, t within 1 ulp);
and the kernels' tables follow the reference Renderer's cluster policy.

Inputs come from a seed with numpy. Tolerances: the plan, bounds and
layout are integer or copied float32 values (exact); the trace's t may
differ by 1 ulp (both round the sphere quadratic's sqrt and division
correctly, but XLA may fuse or reorder the products around them).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.ops import geometry as jgeom
from spectral_tpu.ops.pallas import megakernel as jmk
from spectral_tpu.ops.vecmath import Vec3 as JVec3
from spectral_tpu.render.layout import morton_layout as jax_morton
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import clusters as cl
from spectral_tpu_torch.ops import geometry as tgeom
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _pair(n_spheres):
    arrays, config = jax_flatten(ts.sphere_field(jax_presets, n_spheres, 16, 12, 2))
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg


@pytest.mark.parametrize("n_spheres,cluster_size,camera", [
    (100, 64, True), (100, 32, False), (300, 64, True), (7, 64, True),
])
def test_plan_and_bounds_equal_the_reference(n_spheres, cluster_size, camera):
    arrays, _config, port, cfg = _pair(n_spheres)
    f = port.np_fields
    types = tuple(int(t) for t in f["obj_type"])
    cam = f["cam_pos"][:3] if camera else None
    want = jmk.plan_clusters(f["aabb_min"], f["aabb_max"], types,
                             cluster_size=cluster_size, camera_pos=cam)
    got = cl.plan_clusters(f["aabb_min"], f["aabb_max"], types,
                           cluster_size=cluster_size, camera_pos=cam)
    assert got == want
    sigma, runs = got
    assert sorted(sigma) == list(range(cfg.n_objects))
    assert np.array_equal(cl.pack_cluster_bounds(f["aabb_min"], f["aabb_max"], sigma, runs),
                          np.asarray(jmk.pack_cluster_bounds(arrays, sigma, runs)))


def test_morton3_equals_the_reference():
    q = np.random.default_rng(3).integers(0, 1024, size=(500, 3)).astype(np.uint32)
    assert np.array_equal(cl._morton3(q), jmk._morton3(q))


@pytest.mark.parametrize("w,h", [(16, 16), (24, 10), (1024, 768)])
def test_morton_layout_equals_the_reference(w, h):
    perm, inv = morton_layout(w, h)
    jperm, jinv = jax_morton(w, h)
    assert np.array_equal(perm.numpy(), np.asarray(jperm))
    assert np.array_equal(inv.numpy(), np.asarray(jinv))
    assert torch.equal(perm[inv], torch.arange(w * h))


def test_renderer_policy_and_run_tables():
    """Above 64 objects: 64-object clusters, front to back, the floor an
    always-visited run; at or below 64 or with accel='none': one
    unculled run over every object in index order."""
    port, cfg = flatten_scene(ts.sphere_field(presets, 100, 8, 6, 1), "cpu")
    tb = mk.pack_tables(port, cfg)
    plan = cl.plan_clusters(port.np_fields["aabb_min"], port.np_fields["aabb_max"],
                            port.obj_types, cluster_size=64,
                            camera_pos=port.np_fields["cam_pos"][:3])
    assert tb.clusters == plan
    sigma, runs = plan
    assert [r[3] for r in runs] == [False, True, True]  # floor, 64 + 36 spheres
    assert torch.equal(tb.order, torch.tensor(sigma, dtype=torch.int32))
    r = tb.runs.numpy()
    assert r.shape == (len(runs), cl.RUN_COLS)
    for row, (_tag, start, stop, clustered) in zip(r, runs):
        assert (row[cl.RUN_START], row[cl.RUN_STOP], row[cl.RUN_CULL]) == (start, stop, clustered)
        members = np.asarray(sigma[start:stop])
        assert np.array_equal(row[cl.RUN_MIN:cl.RUN_MIN + 3],
                              port.np_fields["aabb_min"][members].min(0))
        assert np.array_equal(row[cl.RUN_MAX:cl.RUN_MAX + 3],
                              port.np_fields["aabb_max"][members].max(0))
    flat = mk.pack_tables(port, cfg, accel="none")
    assert flat.clusters is None and flat.runs.shape == (1, cl.RUN_COLS)
    assert torch.equal(flat.order, torch.arange(cfg.n_objects, dtype=torch.int32))
    small, scfg = flatten_scene(ts.preset(presets, "cornell", 8, 6, 1), "cpu")
    assert mk.pack_tables(small, scfg).clusters is None
    with pytest.raises(ValueError, match="accel"):
        mk.pack_tables(port, cfg, accel="grid")


def test_more_than_256_materials_raise():
    """No material count raises any more. sphere_field(300) with a
    material of its own per object (301 rows) keeps its material rows in
    shared memory; sphere_field(1000) at 64 wavelengths (1,001 rows, 256 KB
    of albedo alone) leaves them in global memory, and the shared memory
    the kernels take then holds a staging slot of S + 1 floats per thread
    in their place (``csrc/bounce.cuh:materials_shared``, ``smem_bytes``).
    Both render a plain frame."""
    from spectral_tpu_torch.scene import schema

    for n, samples, shared in ((300, 8, True), (1000, 64, False)):
        scene = ts.one_material_each(schema, ts.sphere_field(presets, n, 8, 6, 1, samples=samples))
        port, cfg = flatten_scene(scene, "cpu")
        assert cfg.n_materials == n + 1
        tb = mk.pack_tables(port, cfg)
        assert tb.materials_shared() is shared
        rows = 4 * tb.mat_albedo.numel()
        without = dataclasses.replace(tb, mat_albedo=tb.mat_albedo[:0]).smem_bytes()
        slots = 4 * mk.BLOCK * (samples + 1)
        assert tb.smem_bytes() == without + (rows if shared else slots)
        assert tb.smem_bytes() <= mk.MAX_SMEM
        planes, px, py = ci.primary_lanes(port, cfg, 0)
        rad = mk.run_mono(*planes, px, py, 0, tb)
        assert rad.shape == (samples, 48) and bool(torch.isfinite(rad).all())


@pytest.mark.parametrize("budget", [None, 4096])
def test_chunked_trace_equals_the_reference_trace(budget, monkeypatch):
    """4096 rays over the 101-object field, one dense broadcast and (with
    a 4096-element budget) 32 sequential chunks of the 128-ray minimum:
    the same winners as the reference's jnp trace, t within 1 ulp."""
    if budget is not None:
        monkeypatch.setattr(tgeom, "BROADCAST_BUDGET", budget)
    arrays, _config, port, _cfg = _pair(100)
    rng = np.random.default_rng(11)
    n = 4096
    o = np.stack([rng.uniform(-20, 20, n), rng.uniform(-1, 3, n), rng.uniform(-4, 30, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[2] = np.abs(d[2])
    d /= np.linalg.norm(d, axis=0)
    want = jgeom.trace(JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)), arrays)
    got = tgeom.trace(Vec3(*map(torch.from_numpy, o)), Vec3(*map(torch.from_numpy, d)), port)
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.3
    assert np.array_equal(got.hit.numpy(), hit)
    assert np.array_equal(got.obj_idx.numpy()[hit], np.asarray(want.obj_idx)[hit])
    ulp = np.abs(got.t.numpy()[hit].view(np.int32) - np.asarray(want.t)[hit].view(np.int32))
    assert int(ulp.max()) <= 1
