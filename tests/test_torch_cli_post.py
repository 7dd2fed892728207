"""The port's CLI for what follows a render, with ``--device cpu`` (the
plain versions of the kernels): ``render --scene/--exposure/--gamma/
--check-finite/--aovs/--denoise``, ``animate``, ``scene dump``,
``describe`` and ``compare``, against the port's library calls and, where
no render is involved, the reference CLI's own output.

Exact throughout: the CLI must write what the library calls it stands
for write (the ``.exr`` beauty at half precision, as ``save_image``
writes it; the AOV file's beauty and layers as float32).
"""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from spectral_tpu import cli as jcli
from spectral_tpu.render import animation as janim
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu_torch import cli
from spectral_tpu_torch.render import animation as tanim
from spectral_tpu_torch.render import image as timage
from spectral_tpu_torch.render.aov import compute_aovs
from spectral_tpu_torch.render.denoise import atrous_denoise
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.utils import sceneio
from tests.torch_exr import read_exr

torch.set_num_threads(1)

SMALL = ["--width", "24", "--height", "16", "--iterations", "2", "--bounces", "2",
         "--samples", "8"]


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _scene(name="cornell"):
    scene = presets.PRESETS[name](n_samples=8)
    scene.width, scene.height = 24, 16
    scene.nbr_of_iterations, scene.nbr_of_ray_bounces = 2, 2
    return scene


def _render(args):
    assert cli.main(["render", *args, "--device", "cpu", "--quiet"]) == 0


def test_scene_dump_equals_the_reference_and_renders_like_the_preset(tmp_path):
    got, want = tmp_path / "p.json", tmp_path / "r.json"
    assert cli.main(["scene", "dump", "--preset", "cornell", "--out", str(got)]) == 0
    assert jcli.main(["scene", "dump", "--preset", "cornell", "--out", str(want)]) == 0
    assert got.read_bytes() == want.read_bytes()
    _render(["--scene", str(got), *SMALL, "--out", str(tmp_path / "s.png")])
    _render(["--preset", "cornell", *SMALL, "--out", str(tmp_path / "p.png")])
    assert (tmp_path / "s.png").read_bytes() == (tmp_path / "p.png").read_bytes()
    with pytest.raises(SystemExit):
        cli.main(["render", "--preset", "cornell", "--scene", str(got), "--device", "cpu"])


def test_render_exr_aovs_exr_and_denoise(tmp_path):
    """``--out x.exr --aovs aov.exr --denoise 3``: the beauty EXR is the
    framebuffer at half precision, the AOV file holds the framebuffer
    and ``compute_aovs`` bit for bit, and the denoised EXR is
    ``atrous_denoise`` of the framebuffer with those AOVs."""
    scene_file = tmp_path / "s.json"
    sceneio.save_scene(_scene(), scene_file)
    out, aov = tmp_path / "x.exr", tmp_path / "aov.exr"
    _render(["--scene", str(scene_file), "--out", str(out), "--aovs", str(aov),
             "--denoise", "3"])
    fb = Renderer(sceneio.load_scene(scene_file), device="cpu").render()
    planes, channels, (w, h) = read_exr(out)
    assert (w, h) == (24, 16) and all(pt == 1 for _, pt in channels)
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3)):
        assert _bits(planes[name], fb[..., ch].astype(np.float16).astype(np.float32))
    aovs = compute_aovs(sceneio.load_scene(scene_file), device="cpu")
    planes, _, _ = read_exr(aov)
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3)):
        assert _bits(planes[name], fb[..., ch])
    assert _bits(planes[b"depth.Z"], aovs["depth"])
    assert _bits(planes[b"obj_id.Z"], aovs["obj_id"].astype(np.float32))
    for layer in ("normal", "albedo"):
        for name, ch in (("R", 0), ("G", 1), ("B", 2)):
            assert _bits(planes[f"{layer}.{name}".encode()], aovs[layer][..., ch])
    dn = atrous_denoise(fb[..., :3], aovs["depth"], aovs["normal"], aovs["albedo"],
                        iterations=3, device="cpu")
    planes, _, _ = read_exr(tmp_path / "x.denoised.exr")
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2)):
        assert _bits(planes[name], dn[..., ch].astype(np.float16).astype(np.float32))
    assert _bits(planes[b"A"], fb[..., 3].astype(np.float16).astype(np.float32))


def test_render_png_with_display_transform_aov_dir_and_check_finite(tmp_path):
    out = tmp_path / "img.png"
    _render(["--preset", "default", *SMALL, "--out", str(out), "--exposure", "2",
             "--gamma", "2.2", "--check-finite", "--aovs", str(tmp_path / "aovs"),
             "--denoise"])
    scene = _scene("default")
    fb = Renderer(scene, device="cpu").render()
    want = timage.save_image(fb, tmp_path / "want.png", exposure=2.0, gamma=2.2)
    assert out.read_bytes() == want.read_bytes()
    aovs = compute_aovs(scene, device="cpu")
    for name in aovs:
        assert _bits(np.load(tmp_path / "aovs" / f"{name}.npy"), aovs[name])
        assert (tmp_path / "aovs" / f"{name}.png").exists()
    dn = atrous_denoise(fb[..., :3], aovs["depth"], aovs["normal"], aovs["albedo"],
                        device="cpu")
    want_dn = timage.save_image(np.concatenate([dn, fb[..., 3:]], axis=-1),
                                tmp_path / "want_dn.png", exposure=2.0, gamma=2.2)
    assert (tmp_path / "img.denoised.png").read_bytes() == want_dn.read_bytes()


def test_check_finite_aborts_a_non_finite_render(tmp_path, monkeypatch):
    from spectral_tpu_torch.render import renderer as trender

    real = trender.render_frames_step_cuda_regen

    def poison(*args, **kw):
        return real(*args, **kw) * float("nan")

    monkeypatch.setattr(trender, "render_frames_step_cuda_regen", poison)
    with pytest.raises(FloatingPointError):
        _render(["--preset", "default", *SMALL, "--out", str(tmp_path / "x.png"),
                 "--check-finite"])
    _render(["--preset", "default", *SMALL, "--out", str(tmp_path / "y.png")])


@pytest.mark.parametrize("args", [["--preset", "cornell"], ["--preset", "prism", "--samples", "8"],
                                  ["--help-for", "list"], ["--help-for", "iterations"]])
def test_describe_prints_what_the_reference_prints(args, capsys):
    assert cli.main(["describe", *args]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["describe", *args]) == 0
    assert got == capsys.readouterr().out and got


def test_describe_scene_file_and_unknown_help_key(tmp_path, capsys):
    p = tmp_path / "s.json"
    sceneio.save_scene(_scene(), p)
    assert cli.main(["describe", "--scene", str(p)]) == 0
    assert "24x16, 2 iterations" in capsys.readouterr().out
    assert cli.main(["describe", "--help-for", "zzz"]) == 2


def test_compare(tmp_path, capsys):
    a = np.zeros((8, 8, 3), np.uint8)
    b = a.copy()
    b[0, 0] = 255
    Image.fromarray(a).save(tmp_path / "a.png")
    Image.fromarray(b).save(tmp_path / "b.png")
    assert cli.main(["compare", str(tmp_path / "a.png"), str(tmp_path / "b.png")]) == 0
    out = capsys.readouterr().out
    assert "rmse" in out and "0.125" in out
    Image.fromarray(np.zeros((4, 8, 3), np.uint8)).save(tmp_path / "c.png")
    assert cli.main(["compare", str(tmp_path / "a.png"), str(tmp_path / "c.png")]) == 1


ANIM = ["--preset", "default", "--width", "16", "--height", "12", "--iterations", "1",
        "--bounces", "2", "--samples", "8", "--device", "cpu", "--quiet"]


def test_animate_orbit_writes_frames_gif_and_the_reference_dump(tmp_path):
    out_dir, gif, dump = tmp_path / "frames", tmp_path / "orbit.gif", tmp_path / "anim.json"
    assert cli.main(["animate", *ANIM, "--orbit", "90", "--frames", "2", "--out-dir",
                     str(out_dir), "--gif", str(gif), "--dump-anim", str(dump)]) == 0
    scene = presets.default_scene(n_samples=8)
    scene.width, scene.height, scene.nbr_of_iterations, scene.nbr_of_ray_bounces = 16, 12, 1, 2
    anim = tanim.Animation(scene, 2, tanim.orbit_tracks(scene, 90.0, 2))
    for f in range(2):
        fb = Renderer(anim.scene_at(f), device="cpu").render()
        got = np.asarray(Image.open(out_dir / f"frame_{f:04d}.png"))
        assert _bits(got, timage.accum_to_u8(fb))
    with Image.open(gif) as im:
        assert im.n_frames == 2
    jscene = jax_presets.default_scene(n_samples=8)
    jscene.width, jscene.height = 16, 12
    jscene.nbr_of_iterations, jscene.nbr_of_ray_bounces = 1, 2
    want = janim.animation_to_dict(janim.Animation(jscene, 2, janim.orbit_tracks(jscene, 90.0, 2)))
    assert json.loads(dump.read_text()) == json.loads(json.dumps(want))


def test_animate_tracks_file_embedded_scene_and_shutter(tmp_path):
    anim_json = tmp_path / "anim.json"
    anim_json.write_text(json.dumps({"n_frames": 2, "tracks": [
        {"path": "camera.fov_y_deg", "keys": [[0.0, 50.0], [1.0, 70.0]]}]}))
    assert cli.main(["animate", *ANIM, "--anim", str(anim_json), "--out-dir",
                     str(tmp_path / "a")]) == 0
    assert (tmp_path / "a" / "frame_0001.png").exists()
    scene = presets.default_scene(n_samples=8)
    scene.width, scene.height, scene.nbr_of_iterations, scene.nbr_of_ray_bounces = 16, 12, 1, 2
    scene.camera.fov_y_deg = 25.0
    embedded = tmp_path / "embedded.json"
    anim = tanim.Animation(scene, 2, [tanim.Track("camera.fov_y_deg", [(0.0, 25.0), (1.0, 30.0)])])
    tanim.save_animation(anim, embedded)
    assert cli.main(["animate", "--anim", str(embedded), "--device", "cpu", "--quiet",
                     "--out-dir", str(tmp_path / "b")]) == 0
    fb = Renderer(anim.scene_at(0), device="cpu").render()
    assert _bits(np.asarray(Image.open(tmp_path / "b" / "frame_0000.png")),
                 timage.accum_to_u8(fb))
    assert cli.main(["animate", *ANIM, "--orbit", "30", "--frames", "2", "--shutter", "0.5",
                     "--gif", str(tmp_path / "mb.gif")]) == 0
    assert (tmp_path / "mb.gif").exists()


def test_animate_refuses_before_rendering(tmp_path):
    assert cli.main(["animate", "--preset", "default", "--gif", str(tmp_path / "x.gif"),
                     "--device", "cpu"]) == 2
    assert cli.main(["animate", "--preset", "default", "--orbit", "90", "--device", "cpu"]) == 2
    anim_json = tmp_path / "anim.json"
    scene = presets.default_scene()
    scene.width, scene.height, scene.nbr_of_iterations = 8, 8, 1
    tanim.save_animation(tanim.Animation(scene, 2), anim_json)
    with pytest.raises(ValueError, match="n_frames"):
        cli.main(["animate", "--anim", str(anim_json), "--frames", "0", "--device", "cpu",
                  "--gif", str(tmp_path / "x.gif")])
    with pytest.raises(ValueError, match="fps"):
        cli.main(["animate", "--anim", str(anim_json), "--fps", "0", "--device", "cpu",
                  "--gif", str(tmp_path / "x.gif")])
