"""The port's ``render`` command while it renders: twins of
``tests/test_cli_and_io.py``'s ``test_cli_profile_writes_trace`` and
``test_cli_sigint_aborts_gracefully_and_resumes``, ``--preview-every``,
the progress line, and the live view's chunk cap ``regen_frames=("auto",
16)`` against the reference's resolution of it. On the CPU; every
subprocess (``tests/torch_live.py``) has its own deadline and is killed
on the way out.
"""

import json
import signal

import numpy as np
import pytest

import spectral_tpu.render.renderer as jax_renderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu_torch import cli
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from tests.torch_live import LiveRender

DEADLINE_S = 120
SMALL = ["--preset", "default", "--width", "16", "--height", "8", "--bounces", "2",
         "--samples", "8", "--device", "cpu"]


def test_cli_profile_writes_trace(tmp_path):
    """``--profile DIR`` writes torch.profiler's Chrome trace of the
    render (the host's activity on the CPU) into DIR."""
    out, prof = tmp_path / "img.png", tmp_path / "trace"
    rc = cli.main(["render", *SMALL, "--iterations", "2", "--bounces", "1", "--out", str(out),
                   "--profile", str(prof), "--quiet"])
    assert rc == 0 and out.exists()
    traces = list(prof.rglob("*.json"))
    assert traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)  # spans were recorded


def test_cli_sigint_aborts_gracefully_and_resumes(tmp_path):
    """The first Ctrl-C finishes the current chunk, saves the image and
    the auto checkpoint, and exits 0; the checkpoint then resumes to
    completion. Chunks of 4 frames, so the signal lands mid-render."""
    out = tmp_path / "img.png"
    base = [*SMALL, "--iterations", "400", "--regen-frames", "4", "--out", str(out)]
    with LiveRender(base, DEADLINE_S) as p:
        p.wait(lambda: "frame " in p.text, "the first progress line")
        p.proc.send_signal(signal.SIGINT)
        text = p.finish()
    assert p.proc.returncode == 0, text
    assert "abort requested" in text and "aborted after" in text
    assert out.exists()
    ckpt = tmp_path / "img.png.ckpt.npz"
    assert ckpt.exists(), text
    frames_done = int(np.load(ckpt)["next_frame"])
    assert 0 < frames_done < 400

    rc = cli.main(["render", *base, "--resume", str(ckpt), "--quiet"])
    assert rc == 0


def test_preview_every_writes_the_image_during_a_render(tmp_path):
    """``--preview-every`` saves the output image while the render runs
    (and caps the chunk at 16 frames); Ctrl-C then ends it."""
    out = tmp_path / "img.png"
    with LiveRender([*SMALL, "--iterations", "100000", "--preview-every", "0.5", "--out", out,
                     "--quiet"], DEADLINE_S) as p:
        p.wait(out.exists, "the first preview")
        first = out.stat().st_mtime_ns
        p.wait(lambda: out.stat().st_mtime_ns != first, "a second preview")
        p.proc.send_signal(signal.SIGINT)
        text = p.finish()
    assert p.proc.returncode == 0, text
    frames = int(np.load(tmp_path / "img.png.ckpt.npz")["next_frame"])
    assert frames % 16 == 0  # the preview's 16-frame chunks


def test_progress_line_carries_eta_and_mpaths(tmp_path, capsys):
    rc = cli.main(["render", *SMALL, "--iterations", "3", "--regen-frames", "1",
                   "--out", str(tmp_path / "img.png")])
    assert rc == 0
    err = capsys.readouterr().err
    assert "frame 3/3 (100.0%)" in err
    assert "eta " in err and "Mpaths/s" in err and "ms/frame" in err
    assert "rendered 3 iterations in" in err


@pytest.mark.parametrize("name,width,height", [
    ("default", 16, 8), ("default", 1920, 1080), ("cornell", 512, 512),
    ("cornell", 1920, 1080)])
def test_auto_16_resolves_as_the_reference(name, width, height, monkeypatch):
    """``regen_frames=("auto", 16)`` picks the reference Renderer's K for
    each frame count (the reference resolved as on its TPU: its platform
    check patched, its interpret flag set; it compiles nothing at
    construction). Its v5e single-launch time cap, which the port does
    not copy, binds at neither preset."""
    monkeypatch.setattr(jax_renderer, "_is_tpu_platform", lambda: True)
    for frames in (1, 2, 10, 16, 17, 100):
        want_scene = jax_presets.PRESETS[name]()
        got_scene = presets.PRESETS[name]()
        for sc in (want_scene, got_scene):
            sc.width, sc.height, sc.nbr_of_iterations = width, height, frames
        want = jax_renderer.Renderer(want_scene, backend="pallas", regen_frames=("auto", 16),
                                     _interpret=True).regen_frames
        got = Renderer(got_scene, device="cpu", regen_frames=("auto", 16)).regen_frames
        assert got == want == min(frames, 16), (frames, got, want)
    persist = Renderer(got_scene, device="cpu", regen_frames=("auto", 16), persist=True)
    assert persist.regen_frames == 1
    with pytest.raises(ValueError, match="regen_frames"):
        Renderer(got_scene, device="cpu", regen_frames=("every", 16))
