"""The opt-in sqrt-free shadow test (``shadow_interval``) in the port
(``ops/geometry.py:sphere_interval_blocked``, the ``mono_si`` and
``regen_si`` builds of the kernels, ``megakernel.with_shadow_interval``)
on the CPU, against the JAX package's (``ops/pallas/megakernel.py:
390-411``, ``tests/test_many_objects.py:312-400``).

The predicate's algebra is held in float64 against the root test, as the
reference's own test holds it. On the reference's 100-sphere 16x16 scene
no shadow ray ends on a boundary, so the port's plain regeneration sum
with the option equals the one without it bit for bit, as the JAX test
finds for its kernel. Against the JAX package's Pallas kernel with the
option (interpret mode, its fori loop), two direct-light frames: the
option changes no lane on either side, so the two images differ exactly
where the options-off images differ, on the silhouette pixels where the
Pallas loop's reciprocal sphere test (<= 1 ulp from the port's division
form, ROADMAP queue 3) flips a primary hit: measured 2.0% of the pixels
(held to 5%), the image mean 1.1% apart (held to 2%).
"""

import numpy as np
import pytest
import torch

from spectral_tpu.render.pallas_integrator import integrate_frames_pallas_regen
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import geometry
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.runtime import build
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _cluster_scene(P=presets, n_spheres=100, bounces=3):
    """tests/test_many_objects.py's ``_cluster_scene``: sphere_field(100)
    at 16x16, 3 frames, 8 wavelengths."""
    return ts.sphere_field(P, n_spheres, 16, 16, bounces, iters=3)


def test_shadow_interval_predicate_algebra():
    """The twin of the reference's property test, on the port's function:
    blocked iff the reference-chosen root lies in (0, maxd], in float64
    for random coefficients (a from ``d.d``, b and c from ``oc``)."""
    rng = np.random.default_rng(7)
    n = 200_000
    f64 = torch.float64
    d = Vec3(*(torch.from_numpy(rng.normal(size=n)) for _ in range(3)))
    oc = Vec3(*(torch.from_numpy(rng.uniform(-3.0, 3.0, n)) for _ in range(3)))
    r = torch.from_numpy(rng.uniform(0.1, 3.0, n))
    maxd = torch.from_numpy(rng.uniform(0.1, 5.0, n))
    a = d.dot(d)
    b = 2.0 * oc.dot(d)
    c = oc.dot(oc) - r * r
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    t = torch.where(t1 >= 0.0, t1, t2)
    blocked_root = (disc >= 0.0) & (t > 0.0) & (t <= maxd)
    got = geometry.sphere_interval_blocked(oc, d, r, maxd)
    assert got.dtype == torch.bool and a.dtype == f64
    assert torch.equal(got, blocked_root)
    assert 0.05 < float(got.double().mean()) < 0.95  # both outcomes exercised


@pytest.mark.parametrize("bounces", [1, 3])
def test_plain_regen_shadow_interval_equals_root_test(bounces):
    port, cfg = flatten_scene(_cluster_scene(bounces=bounces), "cpu")
    tb = mk.pack_tables(port, cfg)
    si = mk.with_shadow_interval(tb)
    assert si.shadow_interval and not tb.shadow_interval and si.many_objects()
    args = ci.regen_args(port, cfg, 0, 3)
    base = mk.run_regen(*args, tb)
    got = mk.run_regen(*args, si)
    assert torch.equal(got, base)
    # the entry points: off by default, and the option reaches the plain path
    assert torch.equal(ci.integrate_frames_cuda_regen(port, cfg, 0, 3, tb),
                       ci.integrate_frames_cuda_regen(port, cfg, 0, 3, tb,
                                                      shadow_interval=True))
    accum = torch.zeros((16, 16, 4))
    assert torch.equal(ci.render_frames_step_cuda_regen(port, cfg, accum, 0, 3),
                       ci.render_frames_step_cuda_regen(port, cfg, accum, 0, 3,
                                                        shadow_interval=True))


def test_shadow_interval_matches_pallas_kernel():
    arrays, config = jax_flatten(_cluster_scene(jax_presets, bounces=1))
    obj_types = tuple(np.asarray(arrays.obj_type).tolist())
    want = np.asarray(integrate_frames_pallas_regen(
        arrays, config, np.uint32(0), obj_types, 2, interpret=True, object_loop="fori",
        shadow_interval=True))
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    got = ci.integrate_frames_cuda_regen(port, cfg, 0, 2, shadow_interval=True).numpy()
    base = ci.integrate_frames_cuda_regen(port, cfg, 0, 2).numpy()
    assert np.array_equal(got, base)
    err = np.abs(got - want).max(axis=-1) / max(1.0, float(np.abs(want).max()))
    assert float((err > 1e-5).mean()) <= 0.05
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) <= 0.02


def test_shadow_interval_blocks_like_the_root_test_on_shadow_rays():
    """Shadow rays from the floor around the spheres of the 100-sphere
    field toward its overhead light, many of them grazing a sphere: the
    interval test and the root test (``trace_shadow``) agree on every
    ray."""
    port, cfg = flatten_scene(_cluster_scene(), "cpu")
    rng = np.random.default_rng(3)
    n = 4096
    f = port.np_fields
    spheres = np.nonzero(f["obj_type"] == 1)[0]
    pick = rng.choice(spheres, n)
    reach = 1.3 * f["radius"][pick]
    o = Vec3(*(torch.from_numpy(a.astype(np.float32)) for a in (
        f["sphere_pos"][pick, 0] + rng.uniform(-1, 1, n) * reach, np.full(n, 0.01),
        f["sphere_pos"][pick, 2] + rng.uniform(-1, 1, n) * reach)))
    lp = port.light_pos[0]
    ldir = Vec3(lp[0] - o.x, lp[1] - o.y, lp[2] - o.z)
    dist = ldir.magnitude()
    d = ldir.normalize()
    root = geometry.trace_shadow(o, d, dist, port)
    interval = geometry.trace_shadow(o, d, dist, port, interval=True)
    assert torch.equal(interval, root)
    assert 0.2 < float(root.float().mean()) < 0.8


def test_shadow_interval_refused_without_the_many_object_loop():
    port, cfg = flatten_scene(ts.preset(presets, "cornell", 8, 6, 2), "cpu")
    with pytest.raises(ValueError, match="many-object"):
        ci.integrate_frame_cuda(port, cfg, 0, shadow_interval=True)
    with pytest.raises(ValueError, match="many-object"):
        ci.integrate_frames_cuda_regen(port, cfg, 0, 2, shadow_interval=True)
    glass = ts.glass_meshes(schema, presets, "mesh", 8, 6, 2)
    with pytest.raises(ValueError, match="feature"):
        mk.with_shadow_interval(mk.pack_tables(*flatten_scene(glass, "cpu")))


def test_shadow_interval_runs_on_mono_and_regen_only():
    port, cfg = flatten_scene(_cluster_scene(bounces=2), "cpu")
    si = mk.with_shadow_interval(mk.pack_tables(port, cfg))
    wf = ci.frame_wavefront(port, cfg, 0)
    with pytest.raises(ValueError, match="cuda_seg"):
        mk.run_seg(wf, 0, 1, 0, si)
    state = ci.persist_init(port, cfg)
    with pytest.raises(ValueError, match="cuda_persist"):
        mk.run_persist(state, 3, 3, si, si.cam, budget=2)
    # the cost kernel's radiance is the mono frame's, with the option too
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    rad, cost = mk.run_cost(*planes, px, py, 1, si)
    assert torch.equal(rad, mk.run_mono(*planes, px, py, 1, si))
    assert cost.shape == (256,)


def test_shadow_interval_libraries():
    """The option has libraries of its own, loaded only for its tables: a
    mix-up raises before any build."""
    assert set(build.SHADOW_INTERVAL_LIBRARIES) == {"mono_si", "regen_si"}
    assert build.has_shadow_interval("regen_si") and not build.has_shadow_interval("regen")
    assert not build.has_features("mono_si")
    tb = mk.pack_tables(*flatten_scene(_cluster_scene(bounces=1), "cpu"))
    with pytest.raises(ValueError, match="shadow-interval"):
        mk._entry("spectral_regen", mk.with_shadow_interval(tb), "regen")
    with pytest.raises(ValueError, match="shadow-interval"):
        mk._entry("spectral_mono", tb, "mono_si")


def test_every_kind_of_scene_takes_its_library():
    """``library_for``: the default libraries for the pinhole, feature-free
    scenes with triangles at S = 8 and 32; the wide triangle builds at 16
    and 64; the lens builds of regen for a lens table; the feature builds
    of each; the shadow-interval builds for the option. A library of
    another kind is refused before any build, and each kind is built with
    the others of its defines."""
    def tables(scene):
        return mk.pack_tables(*flatten_scene(scene, "cpu"))

    mesh = {s: tables(ts.preset(presets, "mesh", 8, 6, 1, samples=s)) for s in (8, 16, 32, 64)}
    assert [mk.library_for("mono", mesh[s]) for s in (8, 16, 32, 64)] == [
        "mono", "mono_tri", "mono", "mono_tri"]
    glass = tables(ts.glass_meshes(schema, presets, "mesh", 8, 6, 1, samples=64))
    assert mk.library_for("seg", glass) == "seg_fx_tri"
    assert mk.library_for("regen", glass, lens=True) == "regen_fx_lens"
    assert mk.library_for("regen", mesh[64], lens=True) == "regen_lens"
    field = mk.with_shadow_interval(tables(_cluster_scene(bounces=1)))
    assert mk.library_for("regen", field, lens=True) == "regen_si"
    assert build.has_lens("regen_si") and build.has_lens("regen_fx_lens")
    assert not build.has_lens("regen") and not build.has_lens("regen_tri")
    with pytest.raises(ValueError, match="lens"):
        mk._entry("spectral_regen", mesh[8], "regen_stats", lens=True)
    assert set(build.kind_of("persist_tri")) == {"mono_tri", "regen_tri", "persist_tri",
                                                 "seg_tri"}
    assert build.kind_of("regen") == build.SOURCES
    assert build.kind_of("regen_stats") == ("regen_stats",)
    assert set(build.RENDER_LIBRARIES) >= set(build.TRIANGLE_LIBRARIES) | set(
        build.LENS_LIBRARIES) | set(build.SHADOW_INTERVAL_LIBRARIES) | set(
        build.FEATURE_LIBRARIES) | set(build.SOURCES)
