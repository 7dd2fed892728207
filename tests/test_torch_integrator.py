"""The port's eager PyTorch integrator against the reference package's jnp
integrator (``spectral_tpu.render.integrator``).

Deterministic paths must agree to float32 rounding: direct-only frames
and the periscope's mirror -> mirror -> diffuse chain, max error <= 1e-5
of the image scale. Diffuse chains start from the un-offset hit point, so
one ulp decides a self-hit and two compilations flip some pixels: the
3-bounce Cornell box is compared from the same primary lanes against the
jnp bounce run op by op, and no more than 15% of pixels may disagree by
more than 1e-5 (measured: about 1%). Whole frames against the compiled jnp
integrator flip about as often as that integrator flips against itself
compiled another way (12-15% of pixels, measured jit against eager), so
they are held to the image mean. Goldens at ``tests/test_goldens.py``'s
bounds.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import integrator as jint
from spectral_tpu.render.color import spectra_to_rgb as jrgb
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from spectral_tpu_torch.scene import presets
from tests.test_pallas_megakernel import _periscope_scene

torch.set_num_threads(1)

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _scene(name, w, h, bounces, samples=8, iters=2, P=presets):
    """A preset built with the port's presets (``P=jax_presets`` for the
    reference's)."""
    scene = P.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg


def _rel_err(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return np.abs(got - want).max(axis=-1) / scale


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_direct_only_matches_jnp(name):
    arrays, config, port, cfg = _pair(_scene(name, 16, 8, bounces=1, P=jax_presets))
    for frame in (0, 1):
        want, want_rays = jint.integrate_frame(arrays, config, np.uint32(frame), return_stats=True)
        got, got_rays = tint.integrate_frame(port, cfg, frame, return_stats=True)
        assert float(_rel_err(got.numpy(), np.asarray(want)).max()) <= 1e-5
        assert float(got_rays) == float(want_rays)  # live-lane ray accounting


def test_periscope_three_bounces_matches_jnp():
    arrays, config, port, cfg = _pair(_periscope_scene())
    for frame in (0, 1):
        want = np.asarray(jint.integrate_frame(arrays, config, np.uint32(frame)))
        got = tint.integrate_frame(port, cfg, frame).numpy()
        assert float(want.max()) > 0.1  # the chain is really traced
        assert float(_rel_err(got, want).max()) <= 1e-5


@pytest.mark.parametrize("name", ["cornell", "default"])
def test_diffuse_bounces_within_coin_flip_envelope(name):
    """Same primary lanes into both bounce loops; the jnp bounce runs op by
    op (as the port's does), so only self-hit coins can differ."""
    w, h, bounces = 32, 16, 3
    arrays, config, port, cfg = _pair(_scene(name, w, h, bounces, P=jax_presets))
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
        assert float(want.max()) > 0.05
        assert float((_rel_err(got, want) > 1e-5).mean()) <= 0.15


@pytest.mark.parametrize("name", ["cornell", "default"])
def test_multibounce_frames_mean_matches_jnp(name):
    arrays, config, port, cfg = _pair(_scene(name, 32, 24, bounces=3, iters=4, P=jax_presets))
    want = np.stack([np.asarray(jint.integrate_frame(arrays, config, np.uint32(f)))
                     for f in range(4)])
    got = np.stack([tint.integrate_frame(port, cfg, f).numpy() for f in range(4)])
    assert np.isfinite(got).all()
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) <= 0.05


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_direct_only_golden(name):
    data = np.load(GOLDEN_DIR / f"{name}_32x24_b1.npz")
    want = data["frames"].astype(np.float32)
    scene = presets.PRESETS[name]()
    scene.width, scene.height = 32, 24
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = 1, 4
    port, cfg = flatten_scene(scene, "cpu")
    got = np.stack([tint.integrate_frame(port, cfg, f).numpy() for f in range(2)])
    err = np.abs(got - want) / max(1.0, float(np.abs(want).max()))
    assert float(err.max()) < 2e-3
    assert float(np.sqrt(np.mean(err**2))) < 2e-4


def test_render_frame_step_blends():
    port, cfg = flatten_scene(_scene("cornell", 8, 6, bounces=1), "cpu")
    accum = torch.zeros((6, 8, 4))
    frames = []
    for f in range(3):
        accum = tint.render_frame_step(port, cfg, accum, f)
        frames.append(tint.integrate_frame(port, cfg, f))
    mean = torch.stack(frames).mean(0)
    assert torch.allclose(accum[..., :3], mean, rtol=1e-6, atol=1e-7)
    assert torch.allclose(accum[..., 3], torch.ones(6, 8))


@pytest.mark.parametrize("name,feature", [
    ("prism", "transmission"), ("measured_sun", None), ("spheres", None),
    pytest.param("mesh", None, id="mesh-triangle"),  # triangles render now
    pytest.param("cornell", "depth of field", id="cornell-dof"),
])
def test_out_of_slice_features_raise(name, feature):
    """Every preset is inside the port's slices, the prism's dielectric,
    dispersion and emission too (it renders a frame here), and depth of
    field since the lens slice: nothing raises, and each feature case
    renders a finite frame."""
    scene = _scene(name, 8, 6, bounces=3, samples=8)
    if feature == "depth of field":
        scene.camera.aperture_radius, scene.camera.focus_distance = 0.05, 3.0
    port, cfg = flatten_scene(scene, "cpu")
    mk.pack_tables(port, cfg)
    if feature is not None:
        rgb = tint.integrate_frame(port, cfg, 0)
        assert rgb.shape == (6, 8, 3) and bool(torch.isfinite(rgb).all())
