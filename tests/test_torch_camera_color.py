"""The port's raygen, spectrum -> RGB and progressive blends against the
reference package's jnp functions.

Primaries: bit-equal when the two frameworks' float32 ``tan`` agree on the
camera's half field of view (45 degrees here); at the presets' 60 degrees
XLA's CPU ``tan`` is one ulp away from the correctly rounded value (the
port's), which moves the focal distance by 2 ulp and every direction by at
most 2 ulp of 1.0. RGB: two float32 matmuls whose summation order differs
between the libraries, held to 1e-6 of the largest magnitude.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import color as jcolor
from spectral_tpu.render import integrator as jint
from spectral_tpu.scene import presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.render import camera as tcam
from spectral_tpu_torch.render import color as tcolor
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.scene.flatten import RenderConfig, from_numpy

torch.set_num_threads(1)

ULP1 = float(np.spacing(np.float32(1.0)))  # 2^-23


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, port, cfg


def _rays(arrays, port, w, h, frame, n_frames):
    jo, jd, jpx, jpy = jcam.generate_primary_rays(
        arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg,
        w, h, jnp.uint32(frame), n_frames)
    to, td, tpx, tpy = tcam.generate_primary_rays(
        port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg,
        w, h, frame, n_frames)
    assert np.array_equal(tpx.numpy(), np.asarray(jpx))
    assert np.array_equal(tpy.numpy(), np.asarray(jpy))
    for a, b in zip(to, jo):
        assert np.array_equal(a.numpy(), np.asarray(b))  # origins: exact
    return np.stack([c.numpy() for c in td]), np.stack([np.asarray(c) for c in jd])


@pytest.mark.parametrize("frame", [0, 1, 7])
def test_primaries_bit_equal_when_tan_agrees(frame):
    scene = presets.cornell_box(n_samples=8)
    scene.camera.fov_y_deg = 45.0
    scene.camera.direction = (0.2, -0.1, 1.0)
    arrays, port, _ = _pair(scene)
    got, want = _rays(arrays, port, 24, 16, frame, 10)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_primaries_within_two_ulp_at_preset_fov(name):
    arrays, port, _ = _pair(presets.PRESETS[name](n_samples=8))
    for frame in (0, 3):
        got, want = _rays(arrays, port, 32, 24, frame, 4)
        assert np.abs(got - want).max() <= 2 * ULP1


def test_camera_basis_matches():
    arrays, port, _ = _pair(presets.default_scene(n_samples=8))
    want = jcam.camera_basis(arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg, 32, 24)
    got = tcam.camera_basis(port.cam_dir, port.cam_up, port.fov_y_deg, 32, 24)
    for g, w in zip(got[:3], want[:3]):  # forward, right, true_up: exact
        for gc, wc in zip(g, w):
            assert gc.item() == float(wc)
    assert got[4].item() == float(want[4])  # aspect ratio: exact
    # focal distance 1/tan(30 deg): correctly rounded here, 2 ulp from XLA's
    assert abs(got[3].item() - float(want[3])) <= 2 * float(np.spacing(np.float32(want[3])))
    f32 = np.float32
    half = f32(f32(f32(60.0) / f32(2.0)) / f32(180.0)) * f32(np.pi)
    assert got[3].item() == f32(1.0) / f32(np.tan(np.float64(half)))


def test_depth_of_field_is_refused():
    """Depth of field renders since the lens slice (it was refused): the
    port's lens rays against the reference's on the Cornell camera,
    origins within an ulp of the aperture, directions within the
    pinhole's 2 ulp (tests/test_torch_dof.py has the derivation)."""
    arrays, port, _ = _pair(presets.cornell_box(n_samples=8))
    dof = (np.float32(0.1), np.float32(2.0))
    for frame in (0, 5):
        jo, jd, _, _ = jcam.generate_primary_rays(
            arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg, 4, 4,
            jnp.uint32(frame), 1, dof=tuple(jnp.float32(v) for v in dof))
        to, td, _, _ = tcam.generate_primary_rays(
            port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg, 4, 4, frame, 1,
            dof=tuple(torch.tensor(v) for v in dof))
        for a, b in zip(to, jo):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= float(np.spacing(dof[0]))
        for a, b in zip(td, jd):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 2 * ULP1


@pytest.mark.parametrize("s", [8, 32, 64])
def test_spectra_to_rgb(s):
    arrays, port, _ = _pair(presets.cornell_box(n_samples=s))
    rng = np.random.default_rng(s)
    spectra = rng.uniform(0.0, 2.0, size=(2048, s)).astype(np.float32)
    want = np.asarray(jcolor.spectra_to_rgb(
        jnp.asarray(spectra), arrays.xyz_weights, arrays.xyz_to_rgb))
    got = tcolor.spectra_to_rgb(torch.from_numpy(spectra), port.xyz_weights,
                                port.xyz_to_rgb).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_accumulate_frame_and_frames_match():
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 2, size=(6, 6, 8, 3)).astype(np.float32)
    accum_j = jnp.zeros((6, 8, 4), jnp.float32)
    accum_t = torch.zeros((6, 8, 4))
    for i in range(6):
        accum_j = jint.accumulate_frame(accum_j, jnp.asarray(frames[i]), np.uint32(i))
        accum_t = tint.accumulate_frame(accum_t, torch.from_numpy(frames[i]), i)
    assert np.array_equal(accum_t.numpy(), np.asarray(accum_j))
    # the K-frame blend of a summed chunk
    start = rng.uniform(0, 1, size=(6, 8, 4)).astype(np.float32)
    rgb_sum = frames[:4].sum(0)
    want = np.asarray(jint.accumulate_frames(jnp.asarray(start), jnp.asarray(rgb_sum), np.uint32(3), 4))
    got = tint.accumulate_frames(torch.from_numpy(start), torch.from_numpy(rgb_sum), 3, 4).numpy()
    assert np.array_equal(got, want)
