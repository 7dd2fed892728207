"""Thin-lens depth of field in the port (``render/camera.py``:
``lens_point``, ``generate_primary_rays(dof=...)``, ``lens_table``) on
the CPU, against the JAX package's (``spectral_tpu.render.camera``,
``tests/test_dof.py``).

Tolerances, as measured: the lens shift is computed on the host with the
root, cosine and sine in float64 rounded once; XLA's float32 cosine and
sine are not always correctly rounded, so a shift component lands within
half an ulp of the aperture radius of the reference's (10 of 768
components differ over frames 0-255 at radius 0.08); the test holds one
ulp of the radius. Lens rays: origins within that ulp, directions within
2 ulp of 1.0 (1.5 measured; the pinhole's own bound at 60 degrees, where
XLA's ``tan`` is one ulp off, ``tests/test_torch_camera_color.py``).
Inside the port every path takes its shift from the one host
computation, so the regeneration kernel's plain twin equals host raygen
bit for bit, and the K-frame sum equals the sum of the mono frames to
float32 reassociation (< 1e-4, the reference's own bound).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import integrator as jint
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch import cli
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import camera as tcam
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts

torch.set_num_threads(1)

ULP1 = float(np.spacing(np.float32(1.0)))


def _dof_scene(P=presets, aperture=0.08, focus=2.0):
    """tests/test_dof.py's ``_dof_scene``: the default scene at 32x24, 4
    frames, 2 bounces, with a lens."""
    scene = P.default_scene()
    scene.width, scene.height = 32, 24
    scene.nbr_of_iterations = 4
    scene.nbr_of_ray_bounces = 2
    return ts.with_lens(scene, aperture, focus)


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg


@pytest.mark.parametrize("aperture", [0.08, 0.5])
def test_lens_point_matches_reference(aperture):
    arrays, config, port, cfg = _pair(_dof_scene(jax_presets, aperture))
    _f, jr, ju, *_ = jcam.camera_basis(arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg,
                                       config.width, config.height)
    _f, tr, tu, *_ = tcam.camera_basis(port.cam_dir, port.cam_up, port.fov_y_deg,
                                       cfg.width, cfg.height)
    ulp = float(np.spacing(np.float32(aperture)))
    diffs = []
    for frame in range(256):
        want = jcam.lens_point(jr, ju, arrays.cam_aperture, jnp.uint32(frame))
        got = tcam.lens_point(tr, tu, port.cam_aperture, frame)
        diffs += [abs(float(g) - float(w)) for g, w in zip(got, want)]
        assert all(g.dtype == torch.float32 and g.shape == () for g in got)
    diffs = np.asarray(diffs)
    assert float(diffs.max()) <= ulp
    assert float((diffs == 0).mean()) >= 0.95


@pytest.mark.parametrize("frame", [0, 1, 7])
def test_lens_rays_match_reference(frame):
    arrays, config, port, cfg = _pair(_dof_scene(jax_presets))
    jo, jd, jpx, jpy = jcam.generate_primary_rays(
        arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg, 32, 24,
        jnp.uint32(frame), config.intended_frames, dof=jcam.scene_dof(arrays, config))
    to, td, tpx, tpy = tcam.generate_primary_rays(
        port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg, 32, 24, frame,
        cfg.intended_frames, dof=tcam.scene_dof(port, cfg))
    assert np.array_equal(tpx.numpy(), np.asarray(jpx))
    assert np.array_equal(tpy.numpy(), np.asarray(jpy))
    ulp = float(np.spacing(np.float32(0.08)))
    for a, b in zip(to, jo):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= ulp
    for a, b in zip(td, jd):
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 2 * ULP1
    # a real lens offset: the origins moved off the camera, within the aperture
    shift = np.hypot(float(to.x[0] - port.cam_pos[0]), float(to.y[0] - port.cam_pos[1]))
    assert 0.0 < shift <= 0.08 * 1.0001


def test_lens_rays_converge_on_the_focus_plane():
    """The twin of tests/test_dof.py's: for every frame (lens point), each
    pixel's lens ray passes through its own pinhole ray's point on the
    focus plane."""
    port, cfg = flatten_scene(_dof_scene(aperture=0.15, focus=3.0), "cpu")
    forward, *_ = tcam.camera_basis(port.cam_dir, port.cam_up, port.fov_y_deg,
                                    cfg.width, cfg.height)

    def focal_points(o, d):
        t = 3.0 / d.dot(forward)
        return torch.stack([o.x + d.x * t, o.y + d.y * t, o.z + d.z * t], dim=1)

    for frame in range(3):
        args = (port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg,
                cfg.width, cfg.height, frame, cfg.intended_frames)
        o0, d0, _, _ = tcam.generate_primary_rays(*args)
        o1, d1, _, _ = tcam.generate_primary_rays(*args, dof=tcam.scene_dof(port, cfg))
        shift = float(torch.hypot(o1.x[0] - o0.x[0], o1.y[0] - o0.y[0]))
        assert 0.0 < shift <= 0.15 * 1.0001
        assert float((focal_points(o0, d0) - focal_points(o1, d1)).abs().max()) <= 2e-4


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
def test_primary_directions_with_lens_equal_host_raygen(layout):
    """The regeneration kernel's plain raygen (``primary_directions`` and
    ``primary_origin`` with a ``lens_table`` row) gives host raygen's bits
    for every frame of a K = 6 window."""
    w, h = 37, 23
    port, cfg = flatten_scene(ts.with_lens(ts.preset(presets, "cornell", w, h, 3, iters=8)),
                              "cpu")
    table = tcam.camera_basis_table(port, cfg)
    assert float(table[tcam.CB_FOCUS]) == 2.0
    offsets = tcam.hammersley_table(2, 6, cfg.intended_frames)
    lens = tcam.lens_table(port, cfg, 2, 6)
    assert lens.shape == (6, 4) and lens.dtype == torch.float32
    assert bool((lens[:, 3] == 0).all()) and bool((lens[:, :3] != 0).any())
    perm = morton_layout(w, h)[0] if layout == "morton" else torch.arange(w * h)
    px, py = (c[perm] for c in tcam.pixel_coords(w, h, "cpu"))
    for j in range(6):
        o, d, _, _ = tcam.generate_primary_rays(
            port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg, w, h, 2 + j,
            cfg.intended_frames, dof=tcam.scene_dof(port, cfg))
        got = tcam.primary_directions(px, py, table, offsets[j, 0], offsets[j, 1], lens[j])
        pos = tcam.primary_origin(table, lens[j])
        for a, b in zip(got, d):
            assert torch.equal(a, b[perm]), (j, layout)
        for a, b in zip(pos, o):
            assert bool((b == a).all()), j


def test_pinhole_tables_are_unchanged():
    """Without a lens the regeneration arguments carry no lens table and
    the camera table's focus column stays 0 (the reference's pad)."""
    port, cfg = flatten_scene(ts.preset(presets, "cornell", 8, 6, 1), "cpu")
    args = ci.regen_args(port, cfg, 0, 3)
    assert len(args) == 6 and args[5] is None
    assert float(args[3][tcam.CB_FOCUS]) == 0.0


def test_dof_regen_matches_per_frame_sum():
    """The twin of tests/test_dof.py's: the K-frame regeneration sum
    (``run_regen_plain``, lens table) against the sum of K mono frames
    (``run_mono_plain`` on host raygen's lens rays), to float32
    reassociation."""
    scene = _dof_scene()
    scene.spectrum_number_of_samples = 8
    scene.update_all_spectrum_sample_sizes()
    port, cfg = flatten_scene(scene, "cpu")
    tb = mk.pack_tables(port, cfg)
    mono = sum(mk.run_mono_plain(*ci.primary_lanes(port, cfg, f)[0],
                                 *ci.primary_lanes(port, cfg, f)[1:], f, tb).double()
               for f in range(4))
    args = ci.regen_args(port, cfg, 0, 4)
    regen = mk.run_regen_plain(*args, tb).double()
    assert float((regen - mono).abs().max()) < 1e-4
    # the lens moved the paths: the pinhole sum differs
    pin_args = (*args[:5], None)
    assert not torch.equal(mk.run_regen_plain(*pin_args, tb), regen.float())


def test_dof_direct_light_matches_the_jnp_integrator():
    """One direct-light frame with a lens, the port's eager integrator
    against the JAX package's jnp one (the rays differ by ulps, so the
    image is held to 1e-5 of its scale, the direct-only bound of
    tests/test_torch_megakernel.py, on all but the silhouette pixels an
    ulp can move: at most 2%)."""
    scene = _dof_scene(jax_presets)
    scene.nbr_of_ray_bounces = 1
    arrays, config, port, cfg = _pair(scene)
    for frame in (0, 3):
        want = np.asarray(jint.integrate_frame(arrays, config, np.uint32(frame)))
        got = ci.integrate_frame_cuda(port, cfg, frame).numpy()
        err = np.abs(got - want).max(axis=-1) / max(1.0, float(np.abs(want).max()))
        assert float((err > 1e-5).mean()) <= 0.02, frame


def test_dof_rejects_persist():
    with pytest.raises(ValueError, match="persist"):
        Renderer(_dof_scene(), device="cpu", persist=True)
    r = Renderer(_dof_scene(), device="cpu", regen_frames=4)
    assert r.regen_frames == 4
    port, cfg = flatten_scene(_dof_scene(), "cpu")
    with pytest.raises(ValueError, match="persist"):
        ci.render_persistent(port, cfg, 2)


def test_dof_renderer_paths_agree():
    """Regeneration (K = 4), frame by frame (``regen_frames=1``) and the
    phased path render the same lens image on the CPU: the same paths,
    summed in another order."""
    scene = _dof_scene()
    scene.nbr_of_ray_bounces = 3
    regen = Renderer(scene, device="cpu").render()
    mono = Renderer(scene, device="cpu", regen_frames=1).render()
    phased = Renderer(scene, device="cpu", phase_split=1, phase_capacity=768).render()
    pin = Renderer(ts.with_lens(_dof_scene(), 0.0), device="cpu").render()
    assert np.isfinite(regen).all() and float(regen[..., :3].max()) > 0.01
    for img in (mono, phased):
        assert float(np.abs(img - regen).max()) <= 1e-5 * max(1.0, float(np.abs(regen).max()))
    assert not np.array_equal(regen, pin)


def test_cli_renders_with_a_lens(tmp_path):
    out = tmp_path / "dof.png"
    rc = cli.main(["render", "--preset", "cornell", "--width", "16", "--height", "12",
                   "--iterations", "2", "--bounces", "2", "--samples", "8",
                   "--aperture", "0.05", "--focus-distance", "2.0", "--device", "cpu",
                   "--quiet", "--out", str(out)])
    assert rc == 0 and out.stat().st_size > 0
    args = cli.build_parser().parse_args(["render", "--aperture", "0.1"])
    assert args.aperture == 0.1 and args.focus_distance is None
    # --persist refuses the lens before any frame is rendered
    with pytest.raises(ValueError, match="persist"):
        cli.main(["render", "--preset", "cornell", "--width", "8", "--height", "6",
                  "--iterations", "2", "--aperture", "0.05", "--persist", "--device",
                  "cpu", "--quiet", "--out", str(tmp_path / "p.png")])
