"""Triangles in the port against the JAX package on the CPU: Moller-Trumbore
(``triangle_t``), the triangle branch of the nearest-hit trace and of the
surface normal (flat and smooth), the flattened mesh tables, direct-only
and multi-bounce mesh frames, the cluster walk over triangle runs, and the
slice gate that no longer refuses meshes.

Inputs come from a seed with numpy. Tolerances: masks and winners exact,
t and the barycentrics within 1 ulp (both sides compute the same float32
ops; XLA may reorder the products around the division); flat normals are
the stored winding normal bit for bit, smooth ones within 1e-6 (unit
vectors); tables bitwise; direct-only frames to 1e-5 of the image scale;
3-bounce frames from primaries shared with the jnp bounce loop to the
envelope of ROADMAP queue 3 (at most 15% of pixels off by more than 1e-5:
diffuse self-hit coins flip between compilations), and whole frames
against the compiled jnp integrator pooled to their image mean (5%).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.ops import geometry as jgeo
from spectral_tpu.ops.vecmath import Vec3 as JVec3
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import integrator as jint
from spectral_tpu.render.color import spectra_to_rgb as jrgb
from spectral_tpu.scene import mesh as jmesh
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import clusters as cl
from spectral_tpu_torch.ops import geometry as tgeo
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.scene import flatten as tflat
from spectral_tpu_torch.scene import mesh as tmesh
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _j(v):
    return JVec3(*(jnp.asarray(np.asarray(c, np.float32)) for c in v))


def _t(v):
    return Vec3(*(torch.from_numpy(np.array(c, np.float32)) for c in v))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _pair(scene):
    """The reference's flatten of a scene built with its own presets, and
    the port's tensors from those very tables (with its smooth flag)."""
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu",
                           smooth_tri=arrays.smooth_tri_static)
    return arrays, config, port, cfg


def _mesh(w, h, bounces, iters=2, P=jax_presets):
    return ts.preset(P, "mesh", w, h, bounces, iters)


# ------------------------------------------------------------- primitives


def test_triangle_t_analytic_cases():
    """``tests/test_mesh.py``'s analytic cases, through both packages."""
    v0, e1, e2 = (0, 0, 5), (2, 0, 0), (0, 2, 0)
    cases = [  # origin, direction, hit, t
        ((0.5, 0.5, 0), (0, 0, 1), True, 5.0),     # inside
        ((1.9, 1.9, 0), (0, 0, 1), False, None),   # outside the barycentric box
        ((0.5, 0.5, 10), (0, 0, 1), False, None),  # behind the origin
        ((0.5, 0.5, 10), (0, 0, -1), True, 5.0),   # two-sided: the back face
        ((0.5, 0.5, 0), (1, 0, 0), False, None),   # parallel: det == 0
    ]
    for o, d, hit, t_want in cases:
        t, ok, u, v = tgeo.triangle_t(_t(o), _t(d), _t(v0), _t(e1), _t(e2))
        jt, jok, ju, jv = jgeo.triangle_t(_j(o), _j(d), _j(v0), _j(e1), _j(e2))
        assert bool(ok) == bool(jok) == hit, (o, d)
        if hit:
            assert float(t) == pytest.approx(t_want)
            assert float(t) == float(jt) and float(u) == float(ju) and float(v) == float(jv)
            assert float(u) == pytest.approx(0.25) and float(v) == pytest.approx(0.25)


def test_triangle_t_random_rays_match_jnp():
    """10^4 seeded rays against as many random triangles (some
    degenerate): masks exact, t/u/v within 1 ulp where valid."""
    rng = np.random.default_rng(41)
    n = 10_000
    o = rng.uniform(-2, 2, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    e1 = rng.uniform(-2, 2, (3, n)).astype(np.float32)
    e2 = rng.uniform(-2, 2, (3, n)).astype(np.float32)
    # aimed near each triangle: about half of the rays hit, some from behind
    aim = o + d * rng.uniform(-1, 4, n) - (e1 + e2) * rng.uniform(0.1, 0.6, n)
    v0 = aim.astype(np.float32)
    e2[:, :100] = e1[:, :100] * np.float32(2)  # zero area: det == 0
    got = tgeo.triangle_t(_t(o), _t(d), _t(v0), _t(e1), _t(e2))
    want = jgeo.triangle_t(_j(o), _j(d), _j(v0), _j(e1), _j(e2))
    ok = np.asarray(want[1])
    assert np.array_equal(got[1].numpy(), ok)
    assert 0.05 < ok.mean() < 0.95 and not ok[:100].any()
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        assert int(_ulps(g.numpy()[ok], np.asarray(w)[ok]).max()) <= 1


def _mesh_rays(rng, n):
    """Rays from inside the mesh preset's room in all directions."""
    o = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.9, 0.9, n),
                  rng.uniform(-1.5, 0.9, n)]).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    return o, d


@pytest.mark.parametrize("smooth", [False, True])
def test_trace_and_surface_normal_match_jnp(smooth):
    """The nearest-hit trace over a mesh scene (winners exact, t within 1
    ulp), then the normal at the hit: the stored winding normal bit for
    bit on a flat mesh, the interpolated one within 1e-6 on a smooth
    mesh (barycentrics recomputed from the ray, as jnp does)."""
    scene = (ts.smooth_mesh(jax_presets, jmesh, 8, 8, 1) if smooth
             else _mesh(8, 8, 1))
    arrays, _config, port, _cfg = _pair(scene)
    assert port.smooth_tri == smooth == arrays.smooth_tri_static
    o, d = _mesh_rays(np.random.default_rng(5), 4096)
    want = jgeo.trace(_j(o), _j(d), arrays)
    got = tgeo.trace(_t(o), _t(d), port)
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit) and hit.mean() > 0.5
    o, d = o[:, hit], d[:, hit]  # the room is open toward the camera
    widx = np.asarray(want.obj_idx)[hit]
    assert np.array_equal(got.obj_idx.numpy()[hit], widx)
    assert int(_ulps(got.t.numpy()[hit], np.asarray(want.t)[hit]).max()) <= 1
    tri = port.np_fields["obj_type"][widx] == tflat.OBJ_TRIANGLE
    assert tri.mean() > 0.05
    ip = o + d * np.asarray(want.t)[hit][None, :]
    jn = jgeo.surface_normal(_j(ip), jnp.asarray(widx), arrays, origin=_j(o), direction=_j(d))
    tn = tgeo.surface_normal(_t(ip), torch.from_numpy(widx.astype(np.int64)), port,
                             origin=_t(o), direction=_t(d))
    jn = np.stack([np.asarray(c) for c in jn])
    tn = np.stack([c.numpy() for c in tn])
    if smooth:
        assert np.abs(tn - jn).max() <= 1e-6
        n0 = port.np_fields["inv_rot"][widx, 0].T
        assert np.abs(tn[:, tri] - n0[:, tri]).max() > 1e-3  # really interpolated
    else:
        assert np.array_equal(tn[:, tri], port.np_fields["inv_rot"][widx[tri], 0].T)
        assert np.array_equal(tn, jn)


@pytest.mark.parametrize("name", ["mesh", "mesh5k", "smooth"])
def test_mesh_tables_bitwise_equal(name):
    if name == "smooth":
        want_scene = ts.smooth_mesh(jax_presets, jmesh, 8, 8, 1)
        got_scene = ts.smooth_mesh(presets, tmesh, 8, 8, 1)
    else:
        want_scene = jax_presets.PRESETS[name]()
        got_scene = presets.PRESETS[name]()
    arrays, config = jax_flatten(want_scene)
    got, got_cfg = tflat.flatten_numpy(got_scene)
    for key in tflat.FIELDS:
        a, b = got[key], arrays.host.np_fields[key]
        if a is None or b is None:
            assert a is None and b is None, key
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), key
    assert vars(got_cfg) == vars(config)
    st, _ = flatten_scene(got_scene, "cpu")
    assert st.has_triangles and st.smooth_tri == arrays.smooth_tri_static == (name == "smooth")


# ------------------------------------------------------------ the integrator


@pytest.mark.parametrize("smooth", [False, True])
def test_direct_only_mesh_frame_matches_jnp(smooth):
    scene = (ts.smooth_mesh(jax_presets, jmesh, 32, 32, 1) if smooth
             else _mesh(32, 32, 1))
    arrays, config, port, cfg = _pair(scene)
    for frame in (0, 1):
        want, want_rays = jint.integrate_frame(arrays, config, np.uint32(frame),
                                               return_stats=True)
        got, got_rays = tint.integrate_frame(port, cfg, frame, return_stats=True)
        want = np.asarray(want)
        assert float(want.max()) > 0.01
        err = np.abs(got.numpy() - want).max() / max(1.0, float(np.abs(want).max()))
        assert float(err) <= 1e-5
        assert float(got_rays) == float(want_rays)


def test_multibounce_mesh_frames_mean_matches_jnp():
    """3 bounces (the mirror icosphere's cone reflections and diffuse
    chains), 4 frames pooled: image means within 5%."""
    arrays, config, port, cfg = _pair(_mesh(32, 24, 3, iters=4))
    want = np.stack([np.asarray(jint.integrate_frame(arrays, config, np.uint32(f)))
                     for f in range(4)])
    got = np.stack([tint.integrate_frame(port, cfg, f).numpy() for f in range(4)])
    assert np.isfinite(got).all()
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) <= 0.05


@pytest.mark.parametrize("kind", ["mesh", "smooth"])
def test_multibounce_mesh_within_coin_flip_envelope(kind):
    """3 bounces from the same primary lanes into both bounce loops (the
    jnp one op by op, as the port's runs), so only self-hit coins can
    differ: at most 15% of pixels off by more than 1e-5 of the image
    scale (``tests/test_torch_integrator.py``'s envelope, ROADMAP queue
    3). On the mesh preset the rays reach the mirror icosphere's cone
    reflections and diffuse chains; the smooth scene interpolates its
    normals at every bounce."""
    w, h, bounces = 32, 16, 3
    scene = (ts.smooth_mesh(jax_presets, jmesh, w, h, bounces) if kind == "smooth"
             else _mesh(w, h, bounces))
    arrays, config, port, cfg = _pair(scene)
    n, s = w * h, config.n_samples
    for frame in (0, 1):
        o, d, px, py = jcam.generate_primary_rays(
            arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg,
            w, h, jnp.uint32(frame), config.intended_frames)
        state = jint._BounceState(
            o, d, jnp.ones((n, s), jnp.float32), jnp.zeros((n, s), jnp.float32),
            jnp.ones((n,), bool), jnp.zeros((n,), bool), jnp.float32(0.0),
            jnp.full((n,), -1, jnp.int32))
        for i in range(bounces):
            state = jint._bounce(state, jnp.uint32(bounces - i), jnp.uint32(frame),
                                 px, py, arrays, config)
        want = np.asarray(jrgb(state.radiance, arrays.xyz_weights, arrays.xyz_to_rgb))

        def t(a):
            return torch.from_numpy(np.array(a))

        rad = tint.bounce_loop(Vec3(*map(t, o)), Vec3(*map(t, d)), t(px).long(),
                               t(py).long(), frame, port, cfg)
        got = np.asarray(jrgb(jnp.asarray(rad.numpy()), arrays.xyz_weights, arrays.xyz_to_rgb))
        assert float(want.max()) > 0.05 and np.isfinite(got).all()
        err = np.abs(got - want).max(axis=-1) / max(1.0, float(np.abs(want).max()))
        assert float((err > 1e-5).mean()) <= 0.15


# ------------------------------------------------------ clusters and tables


def _walk_trace(origin, direction, scene, tables):
    """The kernels' object walk (``csrc/bounce.cuh:trace_nearest``) in
    torch: runs in table order, a culled run skipped unless the ray
    enters its union AABB at or before its best hit (``<=``), members in
    visit order over the eager per-object tests, ties to the lowest
    original index. Returns ``(t, winner)``, winner -1 on a miss."""
    n = origin.x.shape[0]
    t_all = tgeo.candidates(origin, direction, scene)
    t_best = torch.full((n,), float("inf"))
    win = torch.full((n,), -1, dtype=torch.int64)
    for row in tables.runs:
        reach = torch.ones((n,), dtype=torch.bool)
        if float(row[cl.RUN_CULL]) > 0.0:
            t_min, _t_max, hit = tgeo.ray_slabs(
                origin, direction, Vec3(*row[cl.RUN_MIN:cl.RUN_MIN + 3]),
                Vec3(*row[cl.RUN_MAX:cl.RUN_MAX + 3]))
            reach = hit & (t_min <= t_best)
        for k in range(int(row[cl.RUN_START]), int(row[cl.RUN_STOP])):
            o = int(tables.order[k])
            t = t_all[:, o]
            better = reach & ((t < t_best) | ((t == t_best) & (o < win) & torch.isfinite(t)))
            t_best = torch.where(better, t, t_best)
            win = torch.where(better, o, win)
    return t_best, win


def test_clustered_walk_equals_flat_trace_on_mesh():
    """The cluster plan over the mesh preset's triangle runs is exact: its
    union AABBs, built from the padded triangle AABBs, never cull a hit,
    also of the room's axis-aligned faces; the walk finds the flat dense
    trace's winner and t bit for bit, on camera rays and on rays from
    inside the room."""
    port, cfg = flatten_scene(ts.preset(presets, "mesh", 16, 12, 1), "cpu")
    tb = mk.pack_tables(port, cfg)
    sigma, runs = tb.clusters
    assert {r[0] for r in runs} == {0, 3}
    assert sum(1 for r in runs if r[0] == 3 and r[3]) == 6  # 340 triangles / 64
    planes, _px, _py = ci.primary_lanes(port, cfg, 0)
    ro, rd = _mesh_rays(np.random.default_rng(9), 512)
    o = Vec3(*(torch.cat([c, torch.from_numpy(r)]) for c, r in zip(planes[:3], ro)))
    d = Vec3(*(torch.cat([c, torch.from_numpy(r)]) for c, r in zip(planes[3:], rd)))
    flat = tgeo.trace(o, d, port)
    t, win = _walk_trace(o, d, port, tb)
    assert torch.equal(win >= 0, flat.hit)
    assert torch.equal(win[flat.hit], flat.obj_idx[flat.hit])
    assert torch.equal(t[flat.hit], flat.t[flat.hit])


def test_pack_tables_mesh_runs_and_shared_memory():
    """Triangle scenes pack: each run row carries its type tag (-1 for the
    one mixed run of an unclustered walk), the kernels' triangle flag is
    set from the tables (2 with vertex normals), and mesh5k's walk
    tables fit a block's shared memory."""
    port, cfg = flatten_scene(presets.mesh5k(), "cpu")
    tb = mk.pack_tables(port, cfg)
    assert tb.triangles == 1
    runs = tb.runs.numpy()
    assert 95 <= runs.shape[0] <= 110
    for row, (tag, _s, _e, _c) in zip(runs, tb.clusters[1]):
        assert row[cl.RUN_TYPE] == tag
    assert tb.smem_bytes() <= mk.MAX_SMEM
    assert tb.smem_bytes() >= 4 * (cfg.n_objects + runs.size)
    flat = mk.pack_tables(port, cfg, accel="none")
    assert flat.runs.shape == (1, cl.RUN_COLS) and flat.runs[0, cl.RUN_TYPE] == -1
    smooth, scfg = flatten_scene(ts.smooth_mesh(presets, tmesh, 8, 8, 1, subdivisions=0), "cpu")
    stb = mk.pack_tables(smooth, scfg)
    assert stb.triangles == 2 and not stb.many_objects()
    cornell, ccfg = flatten_scene(ts.preset(presets, "cornell", 8, 8, 1), "cpu")
    assert mk.pack_tables(cornell, ccfg).triangles == 0


def test_require_slice_takes_triangles_refuses_the_dielectric():
    """Triangles are inside the slices, the dielectric too since the
    feature slice (glass meshes, the prism), and depth of field since the
    lens slice: a mesh with a lens renders a frame."""
    port, cfg = flatten_scene(presets.mesh_demo(n_samples=8), "cpu")
    mk.pack_tables(port, cfg)
    mk.pack_tables(*flatten_scene(ts.glass_meshes(schema, presets, "mesh", 8, 8, 1), "cpu"))
    scene = ts.with_lens(ts.preset(presets, "mesh", 8, 6, 1), 0.05, 3.0)
    port, cfg = flatten_scene(scene, "cpu")
    mk.pack_tables(port, cfg)
    rgb = tint.integrate_frame(port, cfg, 0)
    assert rgb.shape == (6, 8, 3) and bool(torch.isfinite(rgb).all())


@pytest.mark.parametrize("samples", [16, 64])
def test_triangle_tables_at_16_and_64_wavelengths(samples):
    """The kernels build triangles at every S since the lens slice (S = 8
    and 32 before): the host packs and passes a mesh at 16 and 64
    wavelengths, and the plain path renders it like the jnp integrator
    (direct-only, to 1e-5 of the image scale)."""
    port, cfg = flatten_scene(ts.preset(presets, "mesh", 16, 12, 1, samples=samples), "cpu")
    tb = mk.pack_tables(port, cfg)
    assert tb.triangles == 1 and tb.many_objects() and cfg.n_samples == samples
    planes, px, py = ci.primary_lanes(port, cfg, 0)
    mk._check_lanes(dict(zip(("ox", "oy", "oz", "dx", "dy", "dz"), planes)),
                    dict(px=px, py=py), tb, px.shape[0])
    arrays, config = jax_flatten(ts.preset(jax_presets, "mesh", 16, 12, 1, samples=samples))
    want = np.asarray(jint.integrate_frame(arrays, config, np.uint32(0)))
    got = ci.integrate_frame_cuda(port, cfg, 0, tb).numpy()
    assert float(np.abs(got - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))


def test_unknown_object_type_is_refused():
    port, cfg = flatten_scene(ts.preset(presets, "cornell", 8, 8, 1), "cpu")
    port.np_fields["obj_type"] = port.np_fields["obj_type"].copy()
    port.np_fields["obj_type"][0] = 7
    with pytest.raises(ValueError, match="type tag"):
        mk.pack_tables(port, cfg)


def test_cpu_renderer_renders_mesh_like_the_jnp_renderer():
    """``Renderer(device="cpu")`` renders the mesh preset through the plain
    path, clustered with Morton lanes: direct-only, 3 frames in one
    regeneration chunk, to 1e-5 of the image scale."""
    from spectral_tpu.render.renderer import Renderer as JaxRenderer
    from spectral_tpu_torch.render.renderer import Renderer

    want = JaxRenderer(_mesh(16, 12, 1, iters=3), backend="jnp").render()
    r = Renderer(ts.preset(presets, "mesh", 16, 12, 1, 3), device="cpu")
    assert r.regen_frames == 3 and r.lane_layout == "morton"
    got = r.render()
    assert got.shape == want.shape == (12, 16, 4)
    assert float(np.abs(got - want).max()) <= 1e-5 * max(1.0, float(np.abs(want).max()))
