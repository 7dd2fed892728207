"""Multi-process rendering on the CPU: processes joined by
``torch.distributed`` over gloo, each rendering its share of the mesh's
row slabs (the twins of ``tests/test_distributed.py``: 2 processes x 4
slots through the CLI, where the reference runs 2 processes x 4 virtual
devices), and ``parallel/distributed.py``'s rules in one process.

Every subprocess gets a free port of its own, a ``communicate`` timeout
and a small image. A row-sharded render equals the single-process render
bit for bit (``tests/test_torch_sharding.py``), so the two-process image
is held to it exactly; the single-process render is held to the JAX
package's there and in ``tests/test_torch_renderer.py``.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from spectral_tpu_torch import cli
from spectral_tpu_torch.parallel import distributed
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BASE = ["render", "--preset", "default", "--width", "16", "--height", "24",
        "--bounces", "2", "--samples", "8", "--quiet", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scene(iters=2):
    scene = presets.default_scene()
    scene.width, scene.height = 16, 24
    scene.nbr_of_iterations = iters
    scene.nbr_of_ray_bounces = 2
    scene.spectrum_number_of_samples = 8
    scene.update_all_spectrum_sample_sizes()
    return scene


def _group(args, n, timeout=45):
    """Run the CLI in ``n`` processes of one gloo group; returns their
    stderr texts (asserting every process exited 0)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spectral_tpu_torch", *BASE, *args,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(n),
         "--process-id", str(pid)],
        env=env, cwd=REPO, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL)
        for pid in range(n)]
    texts = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            texts.append(err.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text
    return texts


def test_two_process_render_matches_single_process(tmp_path):
    out, ckpt = tmp_path / "dist.png", tmp_path / "dist.ckpt.npz"
    err0, err1 = _group(["--iterations", "2", "--mesh", "8", "--out", str(out),
                         "--checkpoint", str(ckpt)], 2)
    assert "distributed: process 0/2 (gloo)" in err0
    assert "distributed: process 1/2 (gloo)" in err1
    assert "rendered" in err0 and "rendered" not in err1  # only process 0 logs
    assert out.exists()
    got = np.load(ckpt)["accum"]
    want = Renderer(_scene(), device="cpu").render()
    assert got.shape == want.shape == (24, 16, 4)
    assert np.array_equal(got, want)


def test_two_process_persist_adaptive(tmp_path):
    """Sharded persist with adaptive stopping across two processes: one MIN
    per launch crosses the processes, each compacts its own slabs, and the
    counts are gathered for process 0's report."""
    out = tmp_path / "dist_persist.png"
    err0, _ = _group(["--iterations", "8", "--mesh", "8", "--persist",
                      "--persist-budget", "4", "--adaptive", "2,1e9,1e9",
                      "--out", str(out)], 2)
    assert out.exists()
    assert "adaptive:" in err0  # the per-pixel count report reached stderr
    assert "compactions" in err0


def test_two_process_persist_image_matches_single_process(tmp_path):
    dist, single = tmp_path / "dist.png", tmp_path / "single.png"
    _group(["--iterations", "6", "--mesh", "4", "--persist", "--persist-budget", "5",
            "--out", str(dist)], 2)
    assert cli.main([*BASE, "--iterations", "6", "--persist", "--persist-budget", "5",
                     "--out", str(single)]) == 0
    assert np.array_equal(np.asarray(Image.open(dist)), np.asarray(Image.open(single)))


def test_one_process_group(tmp_path):
    """One process in a group of one (the card's NCCL run takes this path
    with its card): the mesh's slots all local, the image the plain
    render's."""
    out, ckpt = tmp_path / "one.png", tmp_path / "one.ckpt.npz"
    (err,) = _group(["--iterations", "2", "--mesh", "2", "--out", str(out),
                     "--checkpoint", str(ckpt)], 1)
    assert "distributed: process 0/1 (gloo)" in err
    assert np.array_equal(np.load(ckpt)["accum"], Renderer(_scene(), device="cpu").render())


def test_backend_rule():
    assert distributed.choose_backend("cpu", 2) == "gloo"
    if torch.cuda.is_available():
        want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
        assert distributed.choose_backend("cuda", 2) == want
        assert distributed.choose_backend("cuda", 1) == "nccl"
    else:  # never a quiet switch to the CPU
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            distributed.choose_backend("cuda", 1)


def test_single_process_collectives(monkeypatch):
    assert not distributed.is_multiprocess() and distributed.is_primary()
    assert distributed.world_size() == 1 and distributed.rank() == 0
    slabs = [torch.full((2, 3), float(i)) for i in range(3)]
    got = distributed.fetch_global(slabs)
    assert got.shape == (6, 3) and np.array_equal(got[:, 0], [0, 0, 1, 1, 2, 2])
    assert distributed.all_min([3, 1.5]) == [3, 1.5]
    assert distributed.all_sum([2.0]) == [2.0]
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.env_configured()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="process id"):
        distributed.initialize("127.0.0.1:1", num_processes=2, process_id=2, device="cpu")


def test_cli_refusals(tmp_path, capsys):
    with pytest.raises(SystemExit, match="single-process"):
        cli.main([*BASE, "--serve", "0", "--num-processes", "2",
                  "--coordinator", "127.0.0.1:1", "--process-id", "0"])
    rc = cli.main([*BASE, "--persist", "--mesh", "2", "--checkpoint",
                   str(tmp_path / "c.npz"), "--out", str(tmp_path / "x.png")])
    assert rc == 2 and "single-device" in capsys.readouterr().err


def test_cli_sharded_persist_abort_saves_image_without_checkpoint(tmp_path, monkeypatch, capsys):
    """An aborted sharded persist render (the first Ctrl-C) saves its
    partial image and skips the auto-checkpoint, which it could not write
    (the reference's ``cli.py:262-275``)."""
    import signal

    from spectral_tpu_torch.render import renderer as trender

    real = trender.Renderer.render

    def interrupted(self, *a, **kw):
        os.kill(os.getpid(), signal.SIGINT)  # the CLI's handler asks for an abort
        return real(self, *a, **kw)

    monkeypatch.setattr(trender.Renderer, "render", interrupted)
    out = tmp_path / "aborted.png"
    rc = cli.main([*BASE, "--iterations", "8", "--mesh", "4", "--persist",
                   "--persist-budget", "2", "--out", str(out)])
    err = capsys.readouterr().err
    assert rc == 0 and out.exists()
    assert "sharded persist aborts are not resumable; partial image saved" in err
    assert "aborted after" in err
    assert not (tmp_path / "aborted.png.ckpt.npz").exists()
