"""The port's intersection, normals and samplers against the reference
package's jnp functions, on the same rays and random numbers made with
numpy from a seed.

Tolerances: the trace's winner index and hit flag must match exactly and
t within 1 ulp; box normals are exact, rotated-box and sphere normals
within 1e-6 (unit vectors). The samplers use sin/cos/asin, whose float32
implementations differ by up to 2 ulp between XLA's and PyTorch's CPU
math, so their unit-vector outputs are held to 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.ops import geometry as jgeo
from spectral_tpu.ops import sampling as jsamp
from spectral_tpu.ops.vecmath import Vec3 as JVec3
from spectral_tpu.scene import presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import geometry as tgeo
from spectral_tpu_torch.ops import sampling as tsamp
from spectral_tpu_torch.ops.vecmath import Vec3 as TVec3
from spectral_tpu_torch.scene.flatten import RenderConfig, from_numpy

torch.set_num_threads(1)

N = 4096


def _pair(name):
    arrays, config = jax_flatten(presets.PRESETS[name](n_samples=8))
    scene, _ = from_numpy(
        arrays.host.np_fields, RenderConfig(**vars(config)), "cpu"
    )
    return arrays, scene


def _j(v):
    return JVec3(*(jnp.asarray(c) for c in v))


def _t(v):
    return TVec3(*(torch.from_numpy(np.array(c)) for c in v))


def _unit(rng, n):
    d = rng.normal(size=(3, n)).astype(np.float32)
    return (d / np.linalg.norm(d, axis=0)).astype(np.float32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_trace_winner_exact_t_within_one_ulp(name):
    arrays, scene = _pair(name)
    rng = np.random.default_rng(11)
    o = rng.uniform(-1.5, 1.5, size=(3, N)).astype(np.float32)
    d = _unit(rng, N)
    want = jgeo.trace(_j(o), _j(d), arrays)
    got = tgeo.trace(_t(o), _t(d), scene)
    hit = np.asarray(want.hit)
    assert hit.mean() > 0.5  # the rays really hit things
    assert np.array_equal(got.hit.numpy(), hit)
    assert np.array_equal(got.obj_idx.numpy()[hit], np.asarray(want.obj_idx)[hit])
    assert _ulps(got.t.numpy()[hit], np.asarray(want.t)[hit]).max() <= 1
    assert np.isinf(got.t.numpy()[~hit]).all()


def test_trace_lowest_index_wins_ties():
    """Two identical boxes: every hit must go to the lower index."""
    from spectral_tpu.scene import schema as S

    scene = presets.cornell_box(n_samples=8)
    twin = S.SceneObject(scene.objects[0].position, scene.objects[0].object_type,
                         scene.objects[0].material, "twin")
    scene.objects = [scene.objects[0], twin] + scene.objects[1:]
    arrays, config = jax_flatten(scene)
    port, _ = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    rng = np.random.default_rng(3)
    o = np.zeros((3, N), np.float32)
    d = _unit(rng, N)
    d[2] = np.abs(d[2])  # towards the back wall (objects 0 and 1)
    got = tgeo.trace(_t(o), _t(d), port)
    want = jgeo.trace(_j(o), _j(d), arrays)
    assert np.array_equal(got.obj_idx.numpy(), np.asarray(want.obj_idx))
    assert not (got.obj_idx.numpy() == 1).any()
    assert (got.obj_idx.numpy() == 0).any()


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_trace_shadow_matches(name):
    arrays, scene = _pair(name)
    rng = np.random.default_rng(12)
    o = rng.uniform(-1.5, 1.5, size=(3, N)).astype(np.float32)
    d = _unit(rng, N)
    maxd = rng.uniform(0.05, 4.0, size=N).astype(np.float32)
    want = np.asarray(jgeo.trace_shadow(_j(o), _j(d), jnp.asarray(maxd), arrays))
    got = tgeo.trace_shadow(_t(o), _t(d), torch.from_numpy(maxd), scene).numpy()
    assert 0.05 < want.mean() < 0.95
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_surface_normals(name):
    arrays, scene = _pair(name)
    rng = np.random.default_rng(13)
    o = rng.uniform(-1.5, 1.5, size=(3, N)).astype(np.float32)
    d = _unit(rng, N)
    res = jgeo.trace(_j(o), _j(d), arrays)
    hit = np.asarray(res.hit)
    t = np.where(hit, np.asarray(res.t), 0).astype(np.float32)
    ip = (o + d * t).astype(np.float32)
    idx = np.asarray(res.obj_idx)
    want = np.stack([np.asarray(c) for c in jgeo.surface_normal(_j(ip), jnp.asarray(idx), arrays)])
    got = torch.stack(list(tgeo.surface_normal(
        _t(ip), torch.from_numpy(idx.astype(np.int64)), scene))).numpy()
    otype = arrays.host.obj_type[idx]
    box = hit & (otype == 0)
    assert box.any()
    assert np.array_equal(got[:, box], want[:, box])  # face normals: exact
    assert np.abs(got[:, hit] - want[:, hit]).max() <= 1e-6


def test_cosine_hemisphere_matches():
    rng = np.random.default_rng(14)
    rx = rng.random(N, dtype=np.float32)
    ry = rng.random(N, dtype=np.float32)
    nrm = _unit(rng, N)
    nrm[:, :64] = np.array([[0.0], [1.0], [0.0]], np.float32)  # near_y branch
    want = jsamp.cosine_hemisphere_bounce(jnp.asarray(rx), jnp.asarray(ry), _j(nrm))
    got = tsamp.cosine_hemisphere_bounce(torch.from_numpy(rx), torch.from_numpy(ry), _t(nrm))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6


def test_sample_in_cone_matches():
    """Roughness >= 0.3: below it, sin = sqrt(1 - cos^2) cancels and turns
    the samplers' 1-ulp cos difference into ~1e-4 (both are then equally
    far from the float64 value; the port's own kernel matches the port)."""
    rng = np.random.default_rng(15)
    rx = rng.random(N, dtype=np.float32)
    ry = rng.random(N, dtype=np.float32)
    rough = rng.uniform(0.3, 1.0, N).astype(np.float32)
    d = _unit(rng, N)
    d[:, :64] = np.array([[0.0], [0.0], [1.0]], np.float32)  # near_z branch
    want = jsamp.sample_in_cone(_j(d), jnp.asarray(rough), jnp.asarray(rx), jnp.asarray(ry))
    got = tsamp.sample_in_cone(_t(d), torch.from_numpy(rough),
                               torch.from_numpy(rx), torch.from_numpy(ry))
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6


def test_reflect_and_refract_match():
    rng = np.random.default_rng(16)
    d = _unit(rng, N)
    nrm = _unit(rng, N)
    n_lam = rng.uniform(1.3, 1.8, N).astype(np.float32)
    u = rng.random(N, dtype=np.float32)
    for g, w in zip(tsamp.reflect_vec(_t(d), _t(nrm)), jsamp.reflect_vec(_j(d), _j(nrm))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    gd, gm, gn = tsamp.refract_or_reflect(_t(d), _t(nrm), torch.from_numpy(n_lam),
                                          torch.from_numpy(u))
    wd, wm, wn = jsamp.refract_or_reflect(_j(d), _j(nrm), jnp.asarray(n_lam), jnp.asarray(u))
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert 0.05 < float(np.asarray(wm).mean()) < 0.95
    for g, w in zip((*gd, *gn), (*wd, *wn)):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-6


def test_triangles_are_refused():
    """Degenerate triangles are refused: with both edges of every triangle
    of the mesh preset collapsed to zero, det is 0 and Moller-Trumbore's
    u, v and t are NaN, so no triangle is ever a candidate; the trace
    finds the room's boxes alone, exactly where jnp does (a NaN never
    wins the nearest-hit minimum)."""
    arrays, config = jax_flatten(presets.PRESETS["mesh"](n_samples=8))
    fields = dict(arrays.host.np_fields)
    tri = fields["obj_type"] == 3  # OBJ_TRIANGLE
    assert tri.sum() == 340
    for key in ("slab_min", "slab_max"):  # a triangle's e1 and e2
        fields[key] = np.where(tri[:, None], np.float32(0), fields[key]).astype(np.float32)
    arrays = dataclasses.replace(arrays, slab_min=jnp.asarray(fields["slab_min"]),
                                 slab_max=jnp.asarray(fields["slab_max"]))
    scene, _ = from_numpy(fields, RenderConfig(**vars(config)), "cpu")
    rng = np.random.default_rng(17)
    o = np.zeros((3, N), np.float32)
    d = _unit(rng, N)
    d[2] = np.abs(d[2])  # toward the back wall and the meshes
    got = tgeo.trace(_t(o), _t(d), scene)
    want = jgeo.trace(_j(o), _j(d), arrays)
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit) and hit.mean() > 0.5
    widx = np.asarray(want.obj_idx)[hit]
    assert np.array_equal(got.obj_idx.numpy()[hit], widx) and not tri[widx].any()
    assert np.array_equal(got.t.numpy()[hit], np.asarray(want.t)[hit])


def test_mesh_trace_matches_jnp():
    """The mesh preset traces with the reference's winners and t within 1
    ulp (``tests/test_torch_mesh.py`` holds the rest of the mesh slice)."""
    arrays, config = jax_flatten(presets.PRESETS["mesh"](n_samples=8))
    scene, _ = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    rng = np.random.default_rng(17)
    o = np.zeros((3, N), np.float32)
    d = _unit(rng, N)
    d[2] = np.abs(d[2])  # toward the back wall and the meshes
    got = tgeo.trace(_t(o), _t(d), scene)
    want = jgeo.trace(_j(o), _j(d), arrays)
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit) and hit.mean() > 0.5
    widx = np.asarray(want.obj_idx)[hit]
    assert np.array_equal(got.obj_idx.numpy()[hit], widx)
    assert (arrays.host.np_fields["obj_type"][widx] == 3).mean() > 0.05
    assert int(_ulps(got.t.numpy()[hit], np.asarray(want.t)[hit]).max()) <= 1
