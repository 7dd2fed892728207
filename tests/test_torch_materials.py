"""Scenes with more than 256 materials, on the port's CPU path, against
the reference's jnp integrator: ``sphere_field(300)`` at 16x12 with a
material of its own for every object (301 rows, each its own albedo;
``torch_scenes.one_material_each``).

The reference's jnp path renders any material count, and so does the
port now (its kernels keep the rows in shared memory while the table
fits a block's, else in global memory; the card tests hold both against
the plain version). Both bounce loops start from the same primary lanes
(the reference's ``generate_primary_rays``), the reference's bounce run
op by op as the port's is: the jitted reference rounds its primaries
apart (XLA's ``tan``) and flips about 7% of a sphere field's pixels at
16x12 against itself. So a direct-only frame is held exactly, and three
bounces, where one ulp decides a diffuse self-hit, by the reference's
coin-flip envelope and the mean of the frames. The Renderer renders the
scene on its regeneration path too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from spectral_tpu.render import camera as jcam
from spectral_tpu.render import integrator as jint
from spectral_tpu.render.color import spectra_to_rgb as jrgb
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene import schema as jax_schema
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes as ts

W, H, N_SPHERES = 16, 12, 300


def _field(S, P, bounces, iters=3):
    return ts.one_material_each(S, ts.sphere_field(P, N_SPHERES, W, H, bounces, iters=iters))


def _frames(bounces, frames):
    """Each frame's RGB from the reference's bounce and the port's, from
    the same primaries: ``[(got, want), ...]``."""
    arrays, config = jax_flatten(_field(jax_schema, jax_presets, bounces))
    port, cfg = flatten_scene(_field(schema, presets, bounces), "cpu")
    assert cfg.n_materials == config.n_materials == N_SPHERES + 1
    assert port.np_fields["mat_albedo"].tobytes() == np.asarray(arrays.mat_albedo).tobytes()
    n, s = W * H, config.n_samples
    out = []
    for frame in frames:
        o, d, px, py = jcam.generate_primary_rays(
            arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg,
            W, H, jnp.uint32(frame), config.intended_frames)
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
        got = np.asarray(jrgb(jnp.asarray(rad.numpy()), arrays.xyz_weights,
                              arrays.xyz_to_rgb))
        out.append((got, want))
    return out


def test_301_materials_direct_only_equal_the_reference():
    for got, want in _frames(1, (0, 1)):
        assert float(want.max()) > 0.05
        assert np.array_equal(got, want)


def test_301_materials_three_bounces_match_the_reference():
    pairs = _frames(3, (0, 1, 2))
    for got, want in pairs:
        scale = max(1.0, float(np.abs(want).max()))
        err = np.abs(got - want).max(axis=-1) / scale
        assert float((err > 1e-5).mean()) <= 0.15
    got = np.stack([g for g, _ in pairs])
    want = np.stack([w for _, w in pairs])
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) <= 0.05


@pytest.mark.parametrize("bounces", [1, 3])
def test_301_materials_render_through_the_renderer(bounces):
    """The Renderer's regeneration path on the CPU: every material row is
    the kernels' table (in shared memory at this size), and the render
    equals the preset's own field bit for bit where each object's new
    material keeps its spectrum (a relabeling of the rows)."""
    r = Renderer(_field(schema, presets, bounces), device="cpu")
    assert r.config.n_materials == N_SPHERES + 1 and r.regen_frames == 3
    assert r.tables.mat_albedo.shape[0] == N_SPHERES + 1 and r.tables.materials_shared()
    img = r.render()
    assert np.isfinite(img).all() and float(img[..., :3].max()) > 0.05

    relabeled = ts.one_material_each(
        schema, ts.sphere_field(presets, N_SPHERES, W, H, bounces, iters=3), own_spectra=False)
    same = Renderer(relabeled, device="cpu")
    assert same.config.n_materials == N_SPHERES + 1
    preset = Renderer(ts.sphere_field(presets, N_SPHERES, W, H, bounces, iters=3), device="cpu")
    assert preset.config.n_materials < 8
    assert np.array_equal(same.render(), preset.render())
