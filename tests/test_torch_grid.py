"""The uniform-grid DDA (``scene/accel.py``, ``ops/grid_trace.py``) on the
CPU: the twins of ``tests/test_grid_trace.py`` (the grid against brute
force, rays from inside objects, the build's shapes, ``Renderer(accel=
"grid")`` and the policy), the port's build and traversal against the
JAX package's on the same inputs, and the refusals.

Tolerances: the build is the reference's exactly (the same float32
arithmetic on the same AABBs). The traversal against the reference's:
the same hits and objects, ``t`` within the reference test's 1e-4
relative (XLA's sphere quadratic lands a few rays 2e-5 from the port's,
whose grid equals its own brute force exactly). The grid against brute
force keeps the reference test's allowances (a few boundary ties), and
a grid render against the brute-force render, or against the
reference's grid render, its 10% of flipped coins.
"""

import numpy as np
import pytest
import torch

from spectral_tpu.ops.grid_trace import trace_grid as jax_trace_grid
from spectral_tpu.ops.vecmath import Vec3 as JVec3
from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.accel import build_grid as jax_build_grid
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops.geometry import trace
from spectral_tpu_torch.ops.grid_trace import trace_grid
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.parallel.mesh import make_mesh, row_sharding
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.accel import build_grid
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _rays(n, seed, spread=25.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _vec(a):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _scene(P, preset, n_obj):
    return P.sphere_field(n_spheres=n_obj) if preset == "spheres" else P.PRESETS[preset]()


@pytest.mark.parametrize("preset,n_obj", [("spheres", 200), ("cornell", None)])
def test_grid_matches_brute_force(preset, n_obj):
    st, _ = flatten_scene(_scene(presets, preset, n_obj), "cpu")
    grid = build_grid(st)
    o, d = _rays(1024, seed=7)
    want = trace(_vec(o), _vec(d), st)
    got = trace_grid(_vec(o), _vec(d), st, grid)
    w_hit, g_hit = want.hit.numpy(), got.hit.numpy()
    assert int((w_hit != g_hit).sum()) <= 2
    both = w_hit & g_hit
    w_t, g_t = want.t.numpy()[both], got.t.numpy()[both]
    assert int((np.abs(w_t - g_t) > 1e-4 * np.maximum(1, w_t)).sum()) <= 2
    idx_bad = int((want.obj_idx.numpy()[both] != got.obj_idx.numpy()[both]).sum())
    assert idx_bad <= 0.01 * both.sum() + 2


@pytest.mark.parametrize("preset,n_obj,res", [("spheres", 200, None), ("cornell", None, None),
                                              ("spheres", 300, (8, 8, 8))])
def test_grid_matches_reference_grid(preset, n_obj, res):
    st, _ = flatten_scene(_scene(presets, preset, n_obj), "cpu")
    arrays, _ = jax_flatten(_scene(jax_presets, preset, n_obj))
    grid = build_grid(st, res)
    jgrid, jstatic = jax_build_grid(arrays, res)
    # the build: the reference's, exactly
    assert grid.res == jstatic.res and grid.n_items == jstatic.n_items
    assert grid.max_items_per_cell == jstatic.max_items_per_cell
    for name in ("origin", "cell_size", "inv_cell", "cell_start", "items"):
        assert np.array_equal(getattr(grid, name).numpy(), np.asarray(getattr(jgrid, name))), name
    # the traversal: the same hits and objects on the same rays
    o, d = _rays(1024, seed=11)
    got = trace_grid(_vec(o), _vec(d), st, grid)
    want = jax_trace_grid(JVec3.from_array(o), JVec3.from_array(d), arrays, jgrid, jstatic)
    assert np.array_equal(got.hit.numpy(), np.asarray(want.hit))
    assert np.array_equal(got.obj_idx.numpy(), np.asarray(want.obj_idx))
    hit = got.hit.numpy()
    assert np.allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-4, atol=0)
    brute = trace(_vec(o), _vec(d), st)
    assert torch.equal(brute.t[got.hit], got.t[got.hit])  # the port's own, exactly


def test_grid_rays_from_inside_objects():
    st, _ = flatten_scene(presets.sphere_field(n_spheres=100), "cpu")
    grid = build_grid(st)
    centers = st.np_fields["sphere_pos"][1:65].astype(np.float32)
    d = np.tile(np.float32([0.267, 0.534, 0.802]), (len(centers), 1))
    want = trace(_vec(centers), _vec(d), st)
    got = trace_grid(_vec(centers), _vec(d), st, grid)
    assert torch.equal(want.hit, got.hit)
    assert np.allclose(want.t.numpy(), got.t.numpy(), rtol=1e-5)


def test_grid_build_shapes():
    st, _ = flatten_scene(presets.sphere_field(n_spheres=300), "cpu")
    grid = build_grid(st, res=(8, 8, 8))
    assert grid.res == (8, 8, 8)
    cs = grid.cell_start.numpy()
    assert cs[0] == 0 and cs[-1] == grid.n_items and len(cs) == 8 ** 3 + 1
    assert (np.diff(cs) >= 0).all()
    assert int(grid.items.max()) < 301


def test_renderer_grid_accel_matches_brute_force():
    def scene():
        return ts.sphere_field(presets, 150, 48, 32, 3)

    brute = Renderer(scene(), device="cpu", accel="none").render()
    r = Renderer(scene(), device="cpu", accel="grid")
    assert r.grid is not None and r.regen_frames == 1
    grid = r.render()
    # multi-bounce diffuse chains flip on last-ulp differences; the
    # overwhelming majority must agree
    err = np.abs(brute - grid).max(axis=-1)
    assert int((err > 1e-3).sum()) <= 0.1 * err.size
    assert float(err[err <= 1e-3].max()) < 1e-3


def test_renderer_grid_matches_reference_grid():
    """A 1-bounce grid render against the reference's ``accel="grid"``
    render: the reference test's envelope (shadow rays that graze a
    sphere flip with the quadratic's last bits), and the port's grid
    render against its brute-force render within 1e-5 of the scale."""
    def scene(P):
        s = ts.sphere_field(P, 60, 16, 12, 1, iters=2)
        s.camera.fov_y_deg = 45.0
        return s

    want = JaxRenderer(scene(jax_presets), accel="grid").render()
    got = Renderer(scene(presets), device="cpu", accel="grid").render()
    assert got.shape == want.shape
    err = np.abs(got - want).max(axis=-1)
    assert int((err > 1e-3).sum()) <= 0.1 * err.size
    assert float(err[err <= 1e-3].max()) < 1e-3
    brute = Renderer(scene(presets), device="cpu", accel="none", regen_frames=1).render()
    assert np.abs(got - brute).max() <= 1e-5 * max(1.0, float(np.abs(brute).max()))


def test_accel_policy():
    small = ts.preset(presets, "cornell", 8, 8, 1)
    assert Renderer(small, device="cpu").grid is None
    # measured slower than brute force by the reference, so never automatic
    big = ts.sphere_field(presets, 400, 8, 8, 1)
    assert Renderer(big, device="cpu").grid is None
    assert Renderer(big, device="cpu", accel="grid").grid is not None  # opt-in, CPU
    with pytest.raises(ValueError, match="accel"):
        Renderer(small, device="cpu", accel="bvh")


def test_grid_is_refused_on_the_card():
    """The kernels walk every object or cull by cluster: the grid on
    ``device="cuda"`` raises ``ValueError`` (before any device use, so on
    every machine) and never renders quietly on the CPU."""
    with pytest.raises(ValueError, match="CPU-only"):
        Renderer(ts.preset(presets, "cornell", 8, 8, 1), device="cuda", accel="grid")


def test_grid_refuses_triangles():
    with pytest.raises(ValueError, match="triangle"):
        Renderer(ts.preset(presets, "mesh", 8, 8, 1), device="cpu", accel="grid")


@pytest.mark.parametrize("kw", [
    dict(persist=True), dict(regen_frames=2), dict(phase_split=1),
    dict(frames_per_dispatch=2), dict(sharding=None), dict(_scene_schedule=lambda f: None),
], ids=["persist", "regen_frames", "phase_split", "frames_per_dispatch", "sharding",
        "schedule"])
def test_grid_refuses_what_the_reference_refuses(kw):
    if "sharding" in kw:
        kw = dict(sharding=row_sharding(make_mesh(2, device="cpu")))
    with pytest.raises(ValueError):
        Renderer(ts.preset(presets, "cornell", 8, 8, 2, iters=4), device="cpu",
                 accel="grid", **kw)
