"""``Renderer(frames_per_dispatch=k)`` and ``render_batch_spmd`` on the CPU,
against the port's own renders and the JAX package's.

``frames_per_dispatch`` only groups the frame-by-frame path's frames
between the host's checks, so k frames per dispatch equal one per
dispatch bit for bit; progress, abort and the finite check act every k
frames. ``render_batch_spmd`` renders each scene on its slot through the
Renderer's default path, so each image equals a Renderer of that scene
alone bit for bit (the twins of ``tests/test_animation.py:260-297``).
Against the JAX package the tolerance is the 1-bounce renders' 1e-5 of
the image scale (``tests/test_torch_renderer.py``).
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh
from spectral_tpu.render.animation import render_batch_spmd as jax_render_batch_spmd
from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu_torch import cli
from spectral_tpu_torch.parallel.mesh import make_mesh
from spectral_tpu_torch.render.animation import render_batch_spmd
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.schema import SceneError
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------- frames_per_dispatch


@pytest.mark.parametrize("k", [2, 4])
def test_frames_per_dispatch_equals_one_frame_per_dispatch(k):
    def make():
        return ts.preset(presets, "cornell", 16, 12, 3, iters=10)

    want = Renderer(make(), device="cpu", regen_frames=1).render()
    r = Renderer(make(), device="cpu", frames_per_dispatch=k)
    assert r.regen_frames == 1 and r.frames_per_dispatch == k  # "auto" becomes 1
    assert np.array_equal(r.render(), want)


def test_frames_per_dispatch_progress_and_abort_between_dispatches():
    sc = ts.preset(presets, "cornell", 8, 8, 2, iters=10)
    seen = []
    r = Renderer(sc, device="cpu", frames_per_dispatch=4)
    r.render(progress=lambda p: seen.append(p.frame_id))
    assert seen == [3, 7, 9]  # every 4 frames, then the ragged tail
    r2 = Renderer(ts.preset(presets, "cornell", 8, 8, 2, iters=10), device="cpu",
                  frames_per_dispatch=4)
    r2.render(abort=lambda: True)
    assert r2.next_frame == 4  # abort acts after the first dispatch


def test_frames_per_dispatch_matches_reference():
    want = JaxRenderer(ts.preset(jax_presets, "default", 16, 12, 1, iters=5),
                       backend="jnp", frames_per_dispatch=3).render()
    got = Renderer(ts.preset(presets, "default", 16, 12, 1, iters=5), device="cpu",
                   frames_per_dispatch=3).render()
    assert _max_rel(got, want) <= 1e-5


@pytest.mark.parametrize("kw,match", [
    (dict(frames_per_dispatch=0), ">= 1"),
    (dict(frames_per_dispatch=2, regen_frames=2), "regen_frames"),
    (dict(frames_per_dispatch=2, persist=True), "standalone"),
    (dict(frames_per_dispatch=2, phase_split=1), "frames_per_dispatch"),
    (dict(frames_per_dispatch=2, accel="grid"), "frames_per_dispatch"),
], ids=["zero", "regen_frames", "persist", "phase_split", "grid"])
def test_frames_per_dispatch_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        Renderer(ts.preset(presets, "cornell", 8, 8, 2, iters=4), device="cpu", **kw)


def test_cli_frames_per_dispatch(tmp_path):
    out = tmp_path / "fpd.exr"
    rc = cli.main(["render", "--preset", "cornell", "--width", "16", "--height", "12",
                   "--iterations", "5", "--bounces", "2", "--samples", "8", "--device", "cpu",
                   "--frames-per-dispatch", "2", "--quiet", "--out", str(out),
                   "--checkpoint", str(tmp_path / "c.npz")])
    assert rc == 0 and out.exists()
    want = Renderer(ts.preset(presets, "cornell", 16, 12, 2, iters=5), device="cpu",
                    regen_frames=1).render()
    assert np.array_equal(np.load(tmp_path / "c.npz")["accum"], want)


# ------------------------------------------------------ render_batch_spmd


def _small(P, w=16, h=12, iters=2, bounces=1, fov=None):
    s = P.default_scene()
    s.width, s.height = w, h
    s.nbr_of_iterations, s.nbr_of_ray_bounces = iters, bounces
    if fov is not None:
        s.camera.fov_y_deg = fov
    return s


@pytest.mark.parametrize("slots", [1, 2, 4])
def test_render_batch_spmd_matches_individual_renders(slots):
    scenes = [_small(presets, bounces=2, fov=50.0 + 5.0 * k) for k in range(4)]
    batch = render_batch_spmd(scenes, mesh=make_mesh(slots, device="cpu"))
    assert batch.shape == (4, 12, 16, 4) and batch.dtype == np.float32
    for k, s in enumerate(scenes):
        assert np.array_equal(batch[k], Renderer(s, device="cpu").render())


def test_render_batch_spmd_matches_reference():
    jscenes = [_small(jax_presets, fov=50.0 + 5.0 * k) for k in range(4)]
    want = jax_render_batch_spmd(jscenes, mesh=Mesh(np.array(jax.devices()[:4]), ("anim",)))
    got = render_batch_spmd([_small(presets, fov=50.0 + 5.0 * k) for k in range(4)],
                            mesh=make_mesh(4, device="cpu"))
    assert got.shape == np.asarray(want).shape == (4, 12, 16, 4)
    for k in range(4):
        assert _max_rel(got[k], np.asarray(want[k])) <= 1e-5


def test_render_batch_spmd_iterations_override():
    """An iterations override changes the Hammersley jitter stream exactly
    like setting nbr_of_iterations on the scene (the denominator is
    intended_frames), and leaves the caller's scenes alone."""
    scenes = [_small(presets, bounces=2, fov=50.0)]
    got = render_batch_spmd(scenes, mesh=make_mesh(1, device="cpu"), iterations=1)
    want = Renderer(_small(presets, iters=1, bounces=2, fov=50.0), device="cpu").render()
    assert np.array_equal(got[0], want)
    assert scenes[0].nbr_of_iterations == 2


def test_render_batch_spmd_rejects_mismatched_configs():
    mesh = make_mesh(1, device="cpu")
    with pytest.raises(SceneError):
        render_batch_spmd([_small(presets, w=16), _small(presets, w=20)], mesh=mesh)
    with pytest.raises(ValueError):
        render_batch_spmd([], mesh=mesh)
    with pytest.raises(ValueError, match="iterations"):
        render_batch_spmd([_small(presets)], mesh=mesh, iterations=0)
    with pytest.raises(ValueError, match="evenly"):
        render_batch_spmd([_small(presets)] * 3, mesh=make_mesh(2, device="cpu"))
