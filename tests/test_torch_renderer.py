"""The port's ``Renderer`` and CLI on the CPU (plain versions of the
kernels) against the reference package's ``Renderer(backend="jnp")``,
plus the port's contract: it never imports jax, ``device="cuda"`` without
a GPU raises, and scene features outside the slice raise.

Tolerances: direct-only and periscope renders are deterministic, so the
framebuffers agree to 1e-5 of the image scale (the port blends a K-frame
chunk in one step where the reference blends frame by frame: float32
rounding only). The 3-bounce Cornell box is held to its image mean (5%),
because diffuse self-hit coins flip between compilations.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu_torch import cli
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.render import renderer as trender
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene import schema
from tests import torch_scenes
from tests.test_pallas_megakernel import _periscope_scene

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _scene(name, w, h, bounces, iters, samples=8, P=presets):
    """A preset built with the port's presets (``P=jax_presets`` for the
    reference's)."""
    scene = P.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_direct_only_render_matches_jnp_renderer(name):
    want = JaxRenderer(_scene(name, 16, 12, 1, 3, P=jax_presets), backend="jnp").render()
    r = trender.Renderer(_scene(name, 16, 12, 1, 3), device="cpu")
    assert r.regen_frames == 3  # the whole render in one regeneration chunk
    got = r.render()
    assert got.shape == want.shape == (12, 16, 4) and got.dtype == np.float32
    assert _max_rel(got, want) <= 1e-5


def test_periscope_render_matches_jnp_renderer():
    scene = _periscope_scene()
    scene.nbr_of_iterations = 3
    want = JaxRenderer(scene, backend="jnp").render()
    tscene = torch_scenes.periscope(schema, presets, iters=3)
    got = trender.Renderer(tscene, device="cpu", regen_frames=2).render()  # 2 + tail
    assert float(want[..., :3].max()) > 0.1
    assert _max_rel(got, want) <= 1e-5


def test_multibounce_render_mean_matches_jnp_renderer():
    want = JaxRenderer(_scene("cornell", 32, 24, 3, 4, P=jax_presets), backend="jnp").render()
    got = trender.Renderer(_scene("cornell", 32, 24, 3, 4), device="cpu").render()
    assert np.isfinite(got).all()
    assert abs(float(got[..., :3].mean()) / float(want[..., :3].mean()) - 1.0) <= 0.05
    assert np.allclose(got[..., 3], 1.0, atol=1e-6)


def test_ragged_tail_goes_frame_by_frame(monkeypatch):
    calls = []
    real_mono, real_regen = trender.render_frame_step_cuda, trender.render_frames_step_cuda_regen

    def mono(scene, config, accum, frame_id, tables):
        calls.append(("mono", frame_id))
        return real_mono(scene, config, accum, frame_id, tables)

    def regen(scene, config, accum, first, k, tables):
        calls.append(("regen", first, k))
        return real_regen(scene, config, accum, first, k, tables)

    monkeypatch.setattr(trender, "render_frame_step_cuda", mono)
    monkeypatch.setattr(trender, "render_frames_step_cuda_regen", regen)
    r = trender.Renderer(_scene("cornell", 8, 6, 2, 6), device="cpu", regen_frames=4)
    seen = []
    r.render(progress=lambda p: seen.append(p.frame_id))
    assert calls == [("regen", 0, 4), ("mono", 4), ("mono", 5)]
    assert seen == [3, 5] and r.next_frame == 6
    calls.clear()
    r1 = trender.Renderer(_scene("cornell", 8, 6, 2, 1), device="cpu")
    assert r1.regen_frames == 1
    r1.render()
    assert calls == [("mono", 0)]


def test_abort_stops_at_a_chunk_boundary():
    r = trender.Renderer(_scene("cornell", 8, 6, 1, 8), device="cpu", regen_frames=2)
    r.render(abort=lambda: True)
    assert r.next_frame == 2
    r.render_frames(4, check_finite=True)
    assert r.next_frame == 6


def test_auto_regen_frames():
    assert trender.auto_regen_frames(512, 512, 32, 100) == 100
    assert trender.auto_regen_frames(512, 512, 32, 6) == 6
    assert trender.auto_regen_frames(320, 240, 32, 1) == 1
    assert trender.auto_regen_frames(512, 512, 128, 1000) == 64
    # the direction planes' budget: 1 + 2 GiB // (12 * W * H)
    assert trender.auto_regen_frames(1920, 1080, 64, 1000) == 1 + 2 * 1024**3 // (12 * 1920 * 1080)


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is expected to work here")
    with pytest.raises(RuntimeError, match="CUDA"):
        trender.Renderer(_scene("cornell", 8, 6, 1, 1), device="cuda")


@pytest.mark.parametrize("name", ["prism", "mesh5k", "mesh"])
def test_out_of_slice_scene_raises(name):
    """Depth of field is inside the port's slices since the lens slice:
    the glass presets with an aperture on their camera render on the
    CPU; only persist raises, with ValueError, as the reference does."""
    scene = torch_scenes.glass_meshes(schema, presets, name, 8, 6, 3, samples=8, iters=2)
    torch_scenes.with_lens(scene, 0.05, 3.0)
    img = trender.Renderer(scene, device="cpu").render()
    assert img.shape == (6, 8, 4) and np.isfinite(img).all()
    with pytest.raises(ValueError, match="persist"):
        trender.Renderer(scene, device="cpu", persist=True)


@pytest.mark.parametrize("name", ["prism", "mesh5k", "mesh"])
def test_glass_presets_build_and_render_on_cpu(name):
    """The prism, and the mesh presets with glass on their meshes, build a
    Renderer with the feature tables and render a frame on the CPU."""
    scene = torch_scenes.glass_meshes(schema, presets, name, 8, 6, 3, samples=8, iters=1)
    r = trender.Renderer(scene, device="cpu")
    assert r.tables.features & tint.FX_TRANSMISSION
    img = r.render()
    assert img.shape == (6, 8, 4) and np.isfinite(img).all()


@pytest.mark.parametrize("name", ["mesh5k", "mesh"])
def test_mesh_presets_build_clustered_renderer(name):
    """The mesh presets are inside the port since the mesh slice: they
    build a clustered Renderer with the triangle tables and Morton lanes."""
    r = trender.Renderer(presets.PRESETS[name](n_samples=8), device="cpu")
    assert r.tables.triangles == 1 and r.clusters is not None
    assert r.lane_layout == "morton" and r.regen_frames > 1


@pytest.mark.parametrize("option,error,match", [
    (dict(persist=True, regen_frames=4), ValueError, "standalone"),
    (dict(phase_split=2, regen_frames=4), ValueError, "phase_split"),
    (dict(sharding=object()), TypeError, "row_sharding"),
    (dict(adaptive=(2, 0, 0)), ValueError, "persist=True"),
])
def test_out_of_slice_modes_raise(option, error, match):
    """Every mode renders now (sharding since the multi-GPU slice, which
    takes a ``parallel.mesh.row_sharding``); persist, adaptive, phase_split
    and sharding refuse what the reference refuses."""
    with pytest.raises(error, match=match):
        trender.Renderer(_scene("cornell", 8, 6, 1, 1), device="cpu", **option)


def test_persist_renderer_matches_jax_persist_renderer():
    """Renderer(persist=True) on the periscope against the reference's
    Renderer(persist=True) in interpret mode: the same budget, the whole
    image in one batch, 1e-5 of the image scale (deterministic paths)."""
    scene = _periscope_scene()
    scene.nbr_of_iterations = 4
    want = JaxRenderer(scene, backend="jnp", persist=True, persist_budget=5,
                       _interpret=True).render()
    tscene = torch_scenes.periscope(schema, presets, iters=4)
    r = trender.Renderer(tscene, device="cpu", persist=True, persist_budget=5)
    assert r.regen_frames == 1
    got = r.render()
    assert r.persist_info["budget"] == 5 and r.next_frame == 4
    assert got.shape == want.shape and np.allclose(got[..., 3], 1.0)
    assert _max_rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="whole image"):
        r.render_frames(2)


def test_persist_adaptive_renderer_reports_counts():
    r = trender.Renderer(_scene("cornell", 16, 12, 3, 16), device="cpu", persist=True,
                         persist_budget=6, adaptive=(4, 1e9, 1e9))
    img = r.render()
    info = r.persist_info
    assert np.isfinite(img).all() and float(img[..., :3].mean()) > 0.0
    assert 4 <= info["min_counts"] <= info["max_counts"] < 16
    assert info["counts"].shape == (16 * 12,) and info["adaptive"] == (4, 1e9, 1e9)


def test_persist_checkpoint_roundtrip(tmp_path):
    """Abort mid-render, save, load into a FRESH renderer, resume:
    bit-identical to the uninterrupted render; the file refuses the wrong
    kind, the wrong adaptive settings and another scene (the reference's
    tests/test_persist.py:284)."""
    kw = dict(device="cpu", persist=True, persist_budget=4)
    want = trender.Renderer(_scene("cornell", 16, 8, 3, 8), **kw).render()
    r1 = trender.Renderer(_scene("cornell", 16, 8, 3, 8), **kw)
    r1.render(abort=lambda: True)
    assert r1.persist_info["aborted"]
    path = tmp_path / "persist.ckpt.npz"
    r1.save_checkpoint(path)
    r2 = trender.Renderer(_scene("cornell", 16, 8, 3, 8), **kw)
    r2.load_checkpoint(path)
    got = r2.render()
    assert not r2.persist_info["aborted"]
    assert (got == want).all()
    with pytest.raises(ValueError, match="persist=True"):
        trender.Renderer(_scene("cornell", 16, 8, 3, 8), device="cpu").load_checkpoint(path)
    with pytest.raises(ValueError, match="adaptive"):
        trender.Renderer(_scene("cornell", 16, 8, 3, 8), adaptive=(2, 0.1, 0.0),
                         **kw).load_checkpoint(path)
    other = _scene("cornell", 16, 8, 3, 8)
    other.camera.fov_y_deg += 1.0
    with pytest.raises(ValueError, match="DIFFERENT scene"):
        trender.Renderer(other, **kw).load_checkpoint(path)


def test_adaptive_persist_checkpoint_roundtrip(tmp_path):
    kw = dict(device="cpu", persist=True, persist_budget=3, adaptive=(2, 1e9, 1e9))
    r0 = trender.Renderer(_scene("cornell", 16, 8, 3, 16), **kw)
    want = r0.render()
    r1 = trender.Renderer(_scene("cornell", 16, 8, 3, 16), **kw)
    r1.render(abort=lambda: True)
    path = tmp_path / "adaptive.ckpt.npz"
    r1.save_checkpoint(path)
    r2 = trender.Renderer(_scene("cornell", 16, 8, 3, 16), **kw)
    r2.load_checkpoint(path)
    assert (r2.render() == want).all()
    assert (r2.persist_info["counts"] == r0.persist_info["counts"]).all()


def test_persist_state_kept_only_on_abort_or_when_asked(tmp_path):
    """A finished persist render frees its carried state unless
    ``persist_keep_state``; a checkpoint without a scene digest is refused."""
    kw = dict(device="cpu", persist=True, persist_budget=4)
    r = trender.Renderer(_scene("cornell", 8, 6, 2, 4), **kw)
    r.render()
    assert "resume_state" not in r.persist_info
    with pytest.raises(ValueError, match="persist_keep_state"):
        r.save_checkpoint(tmp_path / "none.npz")
    kept = trender.Renderer(_scene("cornell", 8, 6, 2, 4), persist_keep_state=True, **kw)
    want = kept.render()
    path = tmp_path / "done.npz"
    kept.save_checkpoint(path)
    again = trender.Renderer(_scene("cornell", 8, 6, 2, 4), **kw)
    again.load_checkpoint(path)
    assert (again.render() == want).all()
    data = dict(np.load(path))
    del data["scene_digest"]
    with open(tmp_path / "old.npz", "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ValueError, match="scene_digest"):
        trender.Renderer(_scene("cornell", 8, 6, 2, 4), **kw).load_checkpoint(tmp_path / "old.npz")


def test_accumulator_checkpoint_roundtrip(tmp_path):
    want = trender.Renderer(_scene("cornell", 8, 6, 2, 8), device="cpu", regen_frames=2).render()
    r1 = trender.Renderer(_scene("cornell", 8, 6, 2, 8), device="cpu", regen_frames=2)
    r1.render(abort=lambda: True)
    path = tmp_path / "accum.npz"
    r1.save_checkpoint(path)
    r2 = trender.Renderer(_scene("cornell", 8, 6, 2, 8), device="cpu", regen_frames=2)
    r2.load_checkpoint(path)
    assert r2.next_frame == 2
    assert (r2.render() == want).all()
    with pytest.raises(ValueError, match="cannot continue a persist"):
        trender.Renderer(_scene("cornell", 8, 6, 2, 8), device="cpu",
                         persist=True).load_checkpoint(path)
    with pytest.raises(ValueError, match="incompatible"):
        trender.Renderer(_scene("cornell", 8, 6, 2, 9), device="cpu").load_checkpoint(path)


def test_save_image_and_cli(tmp_path):
    r = trender.Renderer(_scene("cornell", 16, 12, 2, 2), device="cpu")
    r.render()
    out = tmp_path / "r.png"
    r.save_image(out)
    assert out.stat().st_size > 0
    cli_out = tmp_path / "cli.png"
    rc = cli.main(["render", "--preset", "default", "--width", "16", "--height", "12",
                   "--iterations", "2", "--bounces", "2", "--samples", "8",
                   "--device", "cpu", "--quiet", "--out", str(cli_out)])
    assert rc == 0 and cli_out.stat().st_size > 0


def test_cli_persist_adaptive_checkpoint_and_resume(tmp_path, capsys):
    base = ["render", "--preset", "cornell", "--width", "16", "--height", "8",
            "--iterations", "8", "--bounces", "3", "--samples", "8", "--device", "cpu"]
    out, ckpt = tmp_path / "p.png", tmp_path / "p.ckpt.npz"
    assert cli.main(base + ["--persist", "--persist-budget", "4", "--adaptive", "2,1e9,1e9",
                            "--checkpoint", str(ckpt), "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "adaptive:" in err and "frames/pixel" in err
    assert out.stat().st_size > 0 and ckpt.stat().st_size > 0
    again = tmp_path / "again.png"
    assert cli.main(base + ["--persist", "--persist-budget", "4", "--adaptive", "2,1e9,1e9",
                            "--resume", str(ckpt), "--out", str(again), "--quiet"]) == 0
    assert again.read_bytes() == out.read_bytes()
    assert cli.main(base + ["--adaptive", "2,0.1,0", "--out", str(out)]) == 2
    assert "--adaptive requires --persist" in capsys.readouterr().err
    assert cli.main(base + ["--persist", "--adaptive", "2,0.1", "--out", str(out)]) == 2
    assert "MIN,RTOL,ATOL" in capsys.readouterr().err
    sorted_out = tmp_path / "sorted.png"
    assert cli.main(base + ["--regen-sort", "on", "--regen-frames", "4", "--quiet",
                            "--out", str(sorted_out)]) == 0
    assert sorted_out.stat().st_size > 0


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spectral_tpu_torch as st\n"
        "for m in pkgutil.walk_packages(st.__path__, 'spectral_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "from spectral_tpu_torch.scene import presets\n"
        "sc = presets.cornell_box()\n"
        "sc.width, sc.height, sc.nbr_of_iterations = 16, 12, 2\n"
        "img = st.Renderer(sc, device='cpu').render()\n"
        "assert img.shape == (12, 16, 4) and img[..., :3].max() > 0\n"
        "r = st.Renderer(sc, device='cpu', persist=True, adaptive=(2, 0.5, 1e-3))\n"
        "img = r.render()\n"
        "assert img.shape == (12, 16, 4) and img[..., :3].max() > 0\n"
        "assert r.persist_info['min_counts'] >= 2\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'spectral_tpu'], "
        "'the JAX package was imported'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
