"""The hero frame's configuration and the blocked reference that checks it
(``benchmark/reference/blocks.py``), on the CPU at tiny sizes: the
blocked reference against the one-pass reference and against the
Renderer's plan of full regeneration chunks and a frame-by-frame tail,
the hero frame's plan, the ``render.tail`` span and count, the cell
``hero.regen`` as the harness loads and runs it, and its reader of the
mono launches' shared-bins share."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import check, core
from benchmark.harness import scene as bench_scene
from benchmark.reference import blocks, paths
from benchmark.tests import tiny
from spectral_tpu_torch.render.renderer import Renderer, auto_regen_frames
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.utils import sceneio

REPO = Path(__file__).resolve().parents[1]
HERO = json.loads((REPO / "benchmark/configs/hero.json").read_text())
HERO_METRICS = {"regen.roofline_pct.hero", "render.tail_pct.hero", "device.idle_pct.hero",
                "mono.shared_bins_pct.hero", "render.waits_per_image", "render.wait_idle_pct"}

torch.set_num_threads(1)


def _doc(width=16, height=12, bounces=3, iterations=11) -> dict:
    """A tiny Cornell box at the hero frame's 64 wavelengths."""
    scene = presets.cornell_box(n_samples=64)
    scene.width, scene.height = width, height
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iterations
    return sceneio.scene_to_dict(scene)


def _sample(doc, seed, stride=3):
    st = doc["settings"]
    px, py = check.pixel_grid(st["width"], st["height"], stride, seed)
    return torch.from_numpy(px), torch.from_numpy(py)


def test_blocked_reference_equals_the_one_pass_reference_without_a_tail():
    """Two full chunks and no tail: block by block, the same bits as all
    frames at once."""
    doc = _doc(iterations=4)
    st, cfg = paths.tables(doc, "cpu")
    assert cfg.n_samples == 64
    px, py = _sample(doc, 5)
    w1, w2 = paths.Work(), paths.Work()
    got = blocks.regen_plan_image(st, cfg, px, py, 4, 2, w1)
    want = paths.regen_image(st, cfg, px, py, 4, 2, w2)
    assert torch.equal(got, want)
    assert float(want[:, :3].abs().max()) > 0.0
    assert (w1.lanes, w1.iterations) == (w2.lanes, w2.iterations)
    assert w1.lanes == 4 * px.numel()


def test_blocked_reference_matches_a_render_with_a_ragged_tail():
    """K = 4 and 2K + 3 frames: two regeneration chunks, then three frames
    one at a time blended with the frame-by-frame formula."""
    doc = _doc(iterations=11)
    r = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=4)
    fb = r.render()
    px, py = _sample(doc, 9)
    st, cfg = paths.tables(doc, "cpu")
    work = paths.Work()
    ref = blocks.regen_plan_image(st, cfg, px, py, cfg.intended_frames, 4, work).numpy()
    # the same paths and sums; only the RGB fold's matmul sees another row count
    assert check.pixel_gap(fb[py.numpy(), px.numpy()], ref) <= 1e-6
    assert work.lanes == 11 * px.numel()
    # the tail's blend is not the chunk's: one 3-frame chunk would read otherwise
    one_pass = paths.regen_image(st, cfg, px, py, 11, 4).numpy()
    assert not np.array_equal(one_pass, ref)


def test_hero_plan_is_eleven_launches_and_a_tail():
    offline = core.load_module(REPO / "benchmark/drivers/offline.py", "hero_test_offline")
    assert auto_regen_frames(1920, 1080, 64, 1000) == 87
    assert offline.Driver.regen_chunk(HERO) == 87
    plan = blocks.chunk_plan(1000, 87)
    assert plan[:11] == [(87 * i, 87) for i in range(11)]
    assert plan[11:] == [(f, 1) for f in range(957, 1000)]
    assert blocks.chunk_plan(5, 1) == [(f, 1) for f in range(5)]
    assert blocks.chunk_plan(6, 3) == [(0, 3), (3, 3)]


@pytest.mark.parametrize("iterations,tail", [(11, 3), (8, 0)], ids=["ragged", "whole"])
def test_render_tail_span_and_count(iterations, tail):
    """While tracing, the frame-by-frame branch leaves one ``render.tail``
    span (its frames in ``arg``) and a ``render.tail_frames`` count; a
    render of whole chunks leaves neither."""
    r = Renderer(sceneio.scene_from_dict(_doc(8, 6, 2, iterations)), device="cpu",
                 regen_frames=4)
    before = trace.total("render.tail_frames")
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        r.render()
    rows = trace.rows()
    spans = [s for s in rows if isinstance(s, trace.Span) and s.name == "render.tail"]
    counts = [c for c in rows if isinstance(c, trace.Count) and c.name == "render.tail_frames"]
    if tail:
        (span,) = spans
        assert span.arg == tail
        assert [c.value for c in counts] == [tail]
        (frames,) = [s for s in rows if isinstance(s, trace.Span) and s.name == "render.frames"]
        assert span.parent == frames.id
    else:
        assert spans == [] and counts == []
    assert trace.total("render.tail_frames") == before + tail


def test_hero_configuration_and_cell():
    doc = bench_scene.scene_dict(HERO)
    assert doc["settings"]["width"] == 1920 and doc["settings"]["height"] == 1080
    assert doc["settings"]["spectrum_samples"] == 64 and doc["settings"]["max_bounces"] == 30
    assert doc["settings"]["iterations"] == 1000 and HERO["reduced"] == []
    # the published Cornell box: only the sizes differ from cornell512's scene
    cornell = json.loads((REPO / "benchmark/configs/cornell512.json").read_text())["scene"]
    assert {k: v for k, v in doc.items() if k != "settings"} == \
        {k: v for k, v in cornell.items() if k != "settings"}
    cell = core.load_cell(REPO, "hero.regen")
    assert {m["name"] for m in cell.end_to_end} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == HERO_METRICS
    assert cell.traffic["driver"] == "offline_blocks"


@pytest.fixture(scope="module")
def hero_root(tmp_path_factory):
    """A tree with a tiny copy of the hero cell: 8x6, 64 wavelengths, one
    bounce, 101 iterations, so the Renderer's "auto" K of 100 leaves a
    one-frame tail (the plain regeneration path is slow under the CPU
    profiler: one bounce keeps the traced run short)."""
    configs = {"tinyhero": tiny.tiny_config("tinyhero", HERO["scene"], 8, 6, 1, 101)}
    cells = {"tinyhero.regen": {"config": "tinyhero", "traffic": "regen_blocks-dense",
                                "chips": 1, "why": "tests", "like": "hero.regen",
                                "limits": tiny.limits("hero.regen")}}
    return tiny.tree(tmp_path_factory.mktemp("hero"), cells, configs, tiny.dense_mixes())


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_tiny_hero_cell_runs(hero_root, traced):
    out = core.run_cell(hero_root, "tinyhero.regen", 2**31 + 4242, 0.3, traced, device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1, out["check"]
    if traced:
        # the program's span is read on any device; the card's metrics are not
        assert set(out["metrics"]) == {"render.tail_pct.hero"}
        assert 0.0 < out["metrics"]["render.tail_pct.hero"]["value"] < 100.0
    else:
        assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}


# ------------------------------------------------ the tail's shared-bins share


def _read_mono_share(rows, monkeypatch):
    """``mono.shared_bins_pct.hero`` over a traced window of [0, 10] s on
    the profiler's clock, whose program clock runs 1,000 s ahead, with
    the program's ``rows``."""
    shift = 1000.0
    monkeypatch.setattr(trace, "rows", lambda: [r._replace(time=r.time + shift) for r in rows])
    driver = SimpleNamespace(spans=SimpleNamespace(rows=[("window", shift, 10.0 + shift)]))
    view = core.TraceView(SimpleNamespace(config=HERO), 0.0, 10.0, [], [], driver, None)
    return core.load_module(REPO / "benchmark/metrics/mono.shared_bins_pct.hero.py",
                            "t_mono_shared_bins_pct_hero").read(view)


def test_mono_shared_bins_share_of_mono_launches(monkeypatch):
    rows = [trace.Count("launch.regen", t, 1, 1) for t in (1.0, 2.0)]
    rows += [trace.Count("launch.regen_shared_bins", t, 1, 1) for t in (1.0, 2.0)]
    rows += [trace.Count("launch.mono", t, 1, 1) for t in (3.0, 4.0, 5.0, 6.0)]
    rows += [trace.Count("launch.mono_shared_bins", t, 1, 1) for t in (3.0, 4.0, 5.0)]
    rows.append(trace.Count("launch.mono_shared_bins", 12.0, 1, 1))  # after the window
    assert _read_mono_share(rows, monkeypatch) == pytest.approx(75.0)


def test_mono_shared_bins_share_needs_a_mono_launch(monkeypatch):
    """A window without a mono launch, or without the program's rows,
    gives None and raises nothing; a program without the shared-bins
    count (the parent of the count) reads 0."""
    rows = [trace.Count("launch.regen", 1.0, 1, 1),
            trace.Count("launch.regen_shared_bins", 1.0, 1, 1)]
    assert _read_mono_share(rows, monkeypatch) is None
    assert _read_mono_share([], monkeypatch) is None
    assert _read_mono_share([trace.Count("launch.mono", 1.0, 1, 1)], monkeypatch) == 0.0
