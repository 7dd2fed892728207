"""The scene-feature branches of the port's bounce step (the sky, checker
textures, emissive surfaces, the dielectric with the hero wavelength)
against the reference package's jnp integrator and its Pallas kernel in
interpret mode, and the port's render paths on the prism preset.

Tolerances. The dielectric sampler and the checker factor are held bit
for bit (the Fresnel power is a product in both packages). One bounce of
lanes aimed at the prism's glass, and the next, equal the reference's
``_bounce`` bit for bit: hero bin, one-hot throughput, refracted rays.
Direct-only frames of the emissive panel and the checker scene are held
to 1e-6 of the image scale from shared primaries (measured: equal); the
sky scene at 3 bounces too (its diffuse children start offset, so no
self-hit coin flips: measured equal). The prism at 4 bounces is
statistical: its floor and backdrop start their diffuse children
un-offset, so one ulp flips a self-hit coin (as it does for the jnp
integrator against itself compiled another way). Per frame at most 20%
of pixels may differ by more than 1e-3 of the scale (measured 6-10% at
16x12), and over 4 frames the means of the images clipped to the display
range [.., 1] agree within 3% with the jnp integrator and with the
Pallas kernel (measured 0.04% and 0.006%; up to 1.2% at other sizes).
The clip keeps one flipped pixel of the emissive strip, hundreds of
times brighter than the rest, from moving the mean by percents. The
render paths' image means on the prism agree within 2%.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.ops import sampling as jsamp
from spectral_tpu.ops.vecmath import Vec3 as JVec3
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import integrator as jint
from spectral_tpu.render.color import spectra_to_rgb as jrgb
from spectral_tpu.render.pallas_integrator import integrate_frame_pallas
from spectral_tpu.render.renderer import RenderProgress as JaxProgress
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene import schema as jax_schema
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch import cli
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops import sampling as tsamp
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.render import renderer as trender
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(rng, n):
    v = rng.normal(size=(3, n)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def test_refract_or_reflect_bitwise():
    rng = np.random.default_rng(0)
    n = 4096
    d, nrm = _unit(rng, n), _unit(rng, n)
    n_lam = rng.uniform(1.3, 1.9, n).astype(np.float32)
    rf = rng.uniform(0.0, 1.0, n).astype(np.float32)
    want = jsamp.refract_or_reflect(JVec3(*map(jnp.asarray, d)), JVec3(*map(jnp.asarray, nrm)),
                                    jnp.asarray(n_lam), jnp.asarray(rf))
    got = tsamp.refract_or_reflect(Vec3(*map(_t, d)), Vec3(*map(_t, nrm)), _t(n_lam), _t(rf))
    for w, g in zip((*want[0], want[1], *want[2]), (*got[0], got[1], *got[2])):
        assert np.array_equal(np.asarray(w), g.numpy())
    cosi = -(d * nrm).sum(0)
    eta = np.where(cosi > 0, 1.0 / n_lam, n_lam)
    tir = 1.0 - eta * eta * (1.0 - cosi * cosi) < 0.0
    # both sides of the surface, total internal reflection, and both
    # Fresnel outcomes are covered
    assert (cosi > 0).any() and (cosi < 0).any() and tir.any()
    reflected = got[1].numpy()
    assert reflected[~tir].any() and not reflected[~tir].all()


def test_fresnel_power_is_a_product():
    """jnp's ``x ** 5`` multiplies (x * ((x*x) * (x*x))); ``torch.pow``
    does not round the same way, so the port writes the product out."""
    x = np.random.default_rng(1).uniform(0.0, 1.0, 100_000).astype(np.float32)
    want = np.asarray(jnp.asarray(x) ** 5)
    xt = _t(x)
    x2 = xt * xt
    assert np.array_equal((x2 * x2 * xt).numpy(), want)


def test_checker_factor_bitwise():
    rng = np.random.default_rng(2)
    n = 4096
    p = rng.uniform(-5.0, 5.0, (3, n)).astype(np.float32)
    scale = rng.choice(np.float32([0.0, 0.25, 0.7, 1.3]), n)
    low = rng.uniform(0.0, 1.0, n).astype(np.float32)
    want = jint.checker_factor(*map(jnp.asarray, p), jnp.asarray(scale), jnp.asarray(low))
    got = tint.checker_factor(*map(_t, p), _t(scale), _t(low))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert (got.numpy() == 1.0).any() and (got.numpy() != 1.0).any()


def test_scene_features():
    def fx(scene):
        return tint.scene_features(flatten_scene(scene, "cpu")[0])

    assert fx(ts.preset(presets, "cornell", 8, 6, 1)) == 0
    assert fx(presets.prism(n_samples=8)) == tint.FX_TRANSMISSION | tint.FX_EMISSION
    assert fx(ts.open_sky(schema, 8)) == tint.FX_SKY
    assert fx(ts.textured(schema, presets)) == tint.FX_TEXTURE
    assert fx(ts.emissive_panel(schema, 8)) == tint.FX_EMISSION


@pytest.mark.parametrize("samples", [16, 64])
def test_prism_bounce_matches_jnp_bitwise(samples):
    """tests/test_dispersion.py's hero-collapse setup, widened: lanes
    flying at the glass front face collapse onto one bin with an S-fold
    weight, and refract; two bounces equal the reference's bit for bit."""
    arrays, config, port, cfg = _pair(ts.preset(jax_presets, "prism", 4, 2, 8, samples=samples))
    n, s = 64, samples
    rng = np.random.default_rng(3)
    o = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  np.full(n, -2.0)]).astype(np.float32)
    d = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n), np.ones(n)])
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    px, py = np.arange(n, dtype=np.uint32), np.zeros(n, np.uint32)
    want = jint._BounceState(
        JVec3(*map(jnp.asarray, o)), JVec3(*map(jnp.asarray, d)),
        jnp.ones((n, s), jnp.float32), jnp.zeros((n, s), jnp.float32),
        jnp.ones(n, bool), jnp.zeros(n, bool), jnp.float32(0.0), jnp.full(n, -1, jnp.int32))
    got = tint.BounceState(
        Vec3(*map(_t, o)), Vec3(*map(_t, d)), torch.ones(n, s), torch.zeros(n, s),
        torch.ones(n, dtype=torch.bool), torch.zeros(n, dtype=torch.bool), torch.zeros(()),
        torch.full((n,), -1))
    for b in range(2):
        want = jint._bounce(want, jnp.uint32(4 - b), jnp.uint32(0), jnp.asarray(px),
                            jnp.asarray(py), arrays, config)
        got = tint._bounce(got, torch.full((n,), 4 - b), torch.zeros(n, dtype=torch.long),
                           _t(px).long(), _t(py).long(), port, cfg)
        for w, g in ((want.throughput, got.throughput), (want.radiance, got.radiance),
                     (want.hero_idx, got.hero), (want.alive, got.alive),
                     (want.pending_gate, got.pending_gate), (want.ray_count, got.ray_count),
                     *zip(want.origin, got.origin), *zip(want.direction, got.direction)):
            assert np.array_equal(np.asarray(w), g.numpy())
        if b == 0:
            hero, thr = got.hero.numpy(), got.throughput.numpy()
            assert (hero >= 0).all()  # every lane hit dispersive glass
            for i in range(n):
                assert np.nonzero(thr[i])[0].tolist() == [hero[i]]
                assert thr[i, hero[i]] == s


def _shared_primaries(jscene, bounces, frame):
    """The radiance of ``bounces`` bounces from the same primary lanes: the
    reference's ``_bounce`` op by op and the port's loop, as linear RGB,
    with their ray counts."""
    arrays, config, port, cfg = _pair(jscene)
    w, h, s = config.width, config.height, config.n_samples
    n = w * h
    o, d, px, py = jcam.generate_primary_rays(
        arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg, w, h,
        jnp.uint32(frame), config.intended_frames)
    st = jint._BounceState(o, d, jnp.ones((n, s), jnp.float32), jnp.zeros((n, s), jnp.float32),
                           jnp.ones((n,), bool), jnp.zeros((n,), bool), jnp.float32(0.0),
                           jnp.full((n,), -1, jnp.int32))
    for i in range(bounces):
        st = jint._bounce(st, jnp.uint32(bounces - i), jnp.uint32(frame), px, py,
                          arrays, config)
    rad, rays = tint.bounce_loop(Vec3(*map(_t, o)), Vec3(*map(_t, d)), _t(px).long(),
                                 _t(py).long(), frame, port, cfg, return_stats=True)
    want = np.asarray(jrgb(st.radiance, arrays.xyz_weights, arrays.xyz_to_rgb))
    got = np.asarray(jrgb(jnp.asarray(rad.numpy()), arrays.xyz_weights, arrays.xyz_to_rgb))
    return got, want, float(rays), float(st.ray_count)


@pytest.mark.parametrize("name,bounces", [("panel", 1), ("checker", 1), ("sky", 3)])
def test_feature_frames_match_jnp_from_shared_primaries(name, bounces):
    jscene = {"panel": lambda: ts.emissive_panel(jax_schema, 16),
              "checker": lambda: ts.textured(jax_schema, jax_presets, bounces=1),
              "sky": lambda: ts.open_sky(jax_schema, 16, 3)}[name]()
    for frame in (0, 1):
        got, want, rays, want_rays = _shared_primaries(jscene, bounces, frame)
        assert float(want.max()) > 0.1
        assert float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max())) <= 1e-6
        assert rays == want_rays


def test_emissive_panel_frame_is_its_spectrum():
    """Every camera ray hits the panel head on: pure emission at unit
    throughput (tests/test_dispersion.py), through the whole frame."""
    scene = ts.emissive_panel(schema, 16)
    port, cfg = flatten_scene(scene, "cpu")
    want = np.array(scene.materials[0].emission.spectrum.get_rgb_early(), np.float32)
    got = tint.integrate_frame(port, cfg, 0).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=1e-4)


def test_prism_frames_match_jnp_and_pallas_statistically():
    arrays, config, port, cfg = _pair(ts.preset(jax_presets, "prism", 16, 12, 4, iters=8,
                                                samples=8))
    obj_types = tuple(np.asarray(arrays.obj_type).tolist())
    got, want, pallas = [], [], []
    for f in range(4):
        want.append(np.asarray(jint.integrate_frame(arrays, config, np.uint32(f))))
        got.append(tint.integrate_frame(port, cfg, f).numpy())
        pallas.append(np.asarray(integrate_frame_pallas(
            arrays, config, np.uint32(f), obj_types, interpret=True,
            has_transmission=True, has_emission=True)))
        scale = max(1.0, float(np.abs(want[-1]).max()))
        for ref in (want[-1], pallas[-1]):
            err = np.abs(got[-1] - ref).max(axis=-1) / scale
            assert float((err > 1e-3).mean()) <= 0.20
    got, want, pallas = (np.minimum(np.stack(a), 1.0) for a in (got, want, pallas))
    assert np.isfinite(got).all() and float(got.mean()) > 0.01
    for ref in (want, pallas):
        assert abs(float(got.mean()) / float(ref.mean()) - 1.0) <= 0.03


def test_prism_renders_on_every_path_on_the_cpu():
    """regen (the default), persist (adaptive) and phased on the plain
    versions: the image means agree within 2%, and the image disperses."""
    scene = ts.preset(presets, "prism", 32, 24, 4, iters=8, samples=8)
    means = {}
    for kind, kw in (("regen", {}), ("persist", dict(persist=True)),
                     ("adaptive", dict(persist=True, adaptive=(4, 0.05, 1e-3))),
                     ("phased", dict(phase_split=2))):
        r = trender.Renderer(scene, device="cpu", **kw)
        assert r.tables.features == tint.FX_TRANSMISSION | tint.FX_EMISSION
        img = r.render()
        assert img.shape == (24, 32, 4) and np.isfinite(img).all()
        means[kind] = float(img[..., :3].mean())
    for kind in ("persist", "adaptive", "phased"):
        assert abs(means[kind] / means["regen"] - 1.0) <= 0.02, means


@pytest.mark.parametrize("kw", [{}, dict(regen_frames=1), dict(persist=True),
                                dict(phase_split=1)])
def test_empty_scene_renders_its_sky_everywhere(kw):
    """tests/test_sky.py:199 on the port's render paths."""
    scene = ts.open_sky(schema, 16, bounces=2, iters=3)
    scene.objects = []
    img = trender.Renderer(scene, device="cpu", **kw).render()
    want = np.array(scene.sky.spectrum.get_rgb_early(), np.float32)
    np.testing.assert_allclose(img[..., :3], np.broadcast_to(want, img[..., :3].shape),
                               rtol=1e-5)
    jscene = ts.open_sky(jax_schema, 16, bounces=2)
    jscene.objects = []
    arrays, config, port, cfg = _pair(jscene)
    np.testing.assert_allclose(tint.integrate_frame(port, cfg, 0).numpy(),
                               np.asarray(jint.integrate_frame(arrays, config, np.uint32(0))),
                               rtol=1e-6)


def test_kernel_tables_carry_the_features():
    port, cfg = flatten_scene(presets.prism(n_samples=8), "cpu")
    tb = mk.pack_tables(port, cfg)
    f = port.np_fields
    assert tb.features == tint.FX_TRANSMISSION | tint.FX_EMISSION
    assert tb.mat_fx.shape == (cfg.n_materials, mk.MAT_FX_COLS)
    # per material, the per-object values bit for bit through mat_id
    for col, name in enumerate(("transmission", "ior", "cauchy_b", "tex_scale", "tex_low")):
        assert np.array_equal(tb.mat_fx[:, col].numpy()[f["mat_id"]], f[name])
    assert np.array_equal(tb.mat_emission.numpy()[f["mat_id"]], f["emission"])
    assert np.array_equal(tb.lam.numpy(), f["lambda_grid"])
    assert not tb.sky.any()
    assert tb.feature_gates() == dict(has_transmission=True, has_emission=True,
                                      has_texture=False, has_sky=False)
    plain = mk.pack_tables(*flatten_scene(ts.preset(presets, "cornell", 8, 6, 1), "cpu"))
    assert plain.features == 0
    # the feature tables count in the shared memory of a feature build only
    n_mat, s = cfg.n_materials, cfg.n_samples
    extra = 4 * (n_mat * (mk.MAT_FX_COLS + s) + 2 * s)
    assert tb.smem_bytes() - extra == mk.dataclasses.replace(tb, features=0).smem_bytes()
    sky_tb = mk.pack_tables(*flatten_scene(ts.open_sky(schema, 8), "cpu"))
    assert np.array_equal(sky_tb.sky.numpy(), sky_tb.scene.np_fields["sky"])


def test_library_and_features_must_agree():
    """A feature scene runs on the feature builds only, and the reverse:
    the mix-up raises before any build or launch."""
    prism = mk.pack_tables(*flatten_scene(presets.prism(n_samples=8), "cpu"))
    cornell = mk.pack_tables(*flatten_scene(ts.preset(presets, "cornell", 8, 6, 1), "cpu"))
    with pytest.raises(ValueError, match="feature"):
        mk._entry("spectral_regen", prism, "regen_stats")
    with pytest.raises(ValueError, match="feature"):
        mk._entry("spectral_seg", cornell, "seg_fx")


def test_require_slice_refuses_only_dof_and_material_count():
    """Nothing is refused any more: every feature scene packs, depth of
    field since the lens slice (the prism with a lens renders a frame),
    and a material count above the 256 that was refused (the prism with
    its materials repeated into 300 rows renders a frame)."""
    for scene in (presets.prism(n_samples=8), ts.open_sky(schema, 8),
                  ts.textured(schema, presets), ts.emissive_panel(schema, 8)):
        mk.pack_tables(*flatten_scene(scene, "cpu"))
    scene = ts.with_lens(ts.preset(presets, "prism", 8, 6, 2), 0.05, 3.0)
    port, cfg = flatten_scene(scene, "cpu")
    mk.pack_tables(port, cfg)
    rgb = tint.integrate_frame(port, cfg, 0)
    assert rgb.shape == (6, 8, 3) and bool(torch.isfinite(rgb).all())
    f = dict(port.np_fields)
    reps = -(-300 // cfg.n_materials)
    for key in ("mat_albedo", "mat_emission", "mat_scalars"):
        f[key] = np.tile(f[key], (reps, 1))[:300]
    many = dataclasses.replace(cfg, n_materials=300)
    port300, cfg300 = from_numpy(f, many, "cpu")
    tb = mk.pack_tables(port300, cfg300)
    assert tb.mat_albedo.shape[0] == 300 and tb.materials_shared()
    assert torch.equal(tint.integrate_frame(port300, cfg300, 0), rgb)


@pytest.mark.parametrize("name", cli.PRESETS)
def test_cli_renders_every_preset(name, tmp_path):
    out = tmp_path / f"{name}.png"
    rc = cli.main(["render", "--preset", name, "--width", "8", "--height", "6",
                   "--iterations", "1", "--bounces", "2", "--device", "cpu",
                   "--quiet", "--out", str(out)])
    assert rc == 0 and out.stat().st_size > 0


def test_cli_refuses_exr_before_rendering(tmp_path):
    """Named for the refusal it replaces: ``--out x.exr`` renders the
    feature scene and writes its linear framebuffer (half precision)."""
    from tests.torch_exr import read_exr

    out = tmp_path / "x.exr"
    rc = cli.main(["render", "--preset", "prism", "--width", "8", "--height", "6",
                   "--iterations", "2", "--bounces", "2", "--samples", "8",
                   "--device", "cpu", "--quiet", "--out", str(out)])
    assert rc == 0
    scene = presets.prism(n_samples=8)
    scene.width, scene.height, scene.nbr_of_iterations, scene.nbr_of_ray_bounces = 8, 6, 2, 2
    fb = trender.Renderer(scene, device="cpu").render()
    planes, _, (w, h) = read_exr(out)
    assert (w, h) == (8, 6)
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3)):
        assert np.array_equal(planes[name], fb[..., ch].astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("fields", [(0, 10, 1.5, 64, 16), (9, 10, 3.0, 64, 16),
                                    (4, 200, 0.25, 480_000, 64), (0, 1, 0.0, 8, 8)])
def test_render_progress_matches_the_reference(fields):
    got, want = trender.RenderProgress(*fields), JaxProgress(*fields)
    assert got.mpaths_per_s == want.mpaths_per_s
    assert got.eta_s == want.eta_s


def test_build_runs_one_nvcc_per_library(tmp_path, monkeypatch):
    """A library named twice (a render path asks for the main libraries
    and its own) is compiled once: two compilers writing one file would
    race. Each library gets its defines, its log and its seconds."""
    import subprocess

    from spectral_tpu_torch.runtime import build

    calls = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

        def communicate(self, timeout=None):
            return ("ptxas info    : Used 1 registers\n", None)

        def poll(self):
            return 0

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    paths = build.build_all(build.SOURCES + ("mono", "regen_fx", "regen_fx"), force=True)
    assert len(calls) == len(build.SOURCES) + 1
    assert [p.name for p in paths] == [f"lib{n}.so" for n in build.SOURCES + ("regen_fx",)]
    fx = [c for c in calls if "-DSPECTRAL_FX" in c]
    assert len(fx) == 1 and fx[0][-1].endswith("regen.cu")
    assert (tmp_path / "libregen_fx.log").exists()
    assert build.build_seconds("regen_fx") >= 0.0
    assert build.has_features("seg_fx") and not build.has_features("seg")
    assert not build.has_features("regen_stats")
