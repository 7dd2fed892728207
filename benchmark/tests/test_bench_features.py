"""The reference of scenes with features (``benchmark/reference/features.py``)
against the port on the CPU, at tiny sizes, and the prism's configuration,
cell and per-layer readers.

The reference traces the same paths as the renderer's plain regeneration
path and adds each bounce's sky, emission and direct light to a lane's
sum in the kernel's order, so the sampled framebuffer values agree to
``test_bench_reference.py``'s 1e-6 (only the RGB fold's matmul sees
another row count; measured 0). On a scene without features it gives
``paths.regen_image``'s bits. Its controls: the prism's reference with
the glass's Cauchy term set to 0, far from the render, and, on a scene
whose emitters also reflect light, each bounce's terms added as one, off
the render's bits."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import check, core
from benchmark.harness import scene as bench_scene
from benchmark.reference import bounce, features, paths
from benchmark.tests import tiny
from spectral_tpu_torch.render.renderer import Renderer, auto_regen_frames
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.utils import sceneio
from tests import torch_scenes

REPO = Path(__file__).resolve().parents[2]
METRICS = REPO / "benchmark" / "metrics"
PRISM = json.loads((REPO / "benchmark/configs/prism.json").read_text())
PRISM_METRICS = {"regen.roofline_pct.prism", "regen.shared_bins_pct.prism",
                 "device.idle_pct.prism"}

torch.set_num_threads(1)


def _doc(scene, width, height, bounces, iterations) -> dict:
    scene.width, scene.height = width, height
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iterations
    return sceneio.scene_to_dict(scene)


def _glowing_cornell():
    """The Cornell box with its grey walls and boxes glowing: surfaces
    that emit and reflect the lamp, met again after the first bounce, so
    a bounce adds two terms to a lane's running sum."""
    scene = presets.cornell_box(n_samples=16)
    glow = schema.SceneSpectrum.new("glow", schema.Temperature(4000.0, 0.5),
                                    schema.SpectrumEffectType.EMISSIVE, n=16)
    scene.spectra.append(glow)
    scene.materials[0].emission = glow
    return scene


CASES = {  # name: (scene document, FX bits)
    "prism64": (lambda: _doc(presets.prism(n_samples=64), 40, 30, 8, 4),
                bounce.FX_TRANSMISSION | bounce.FX_EMISSION),
    "prism16": (lambda: _doc(presets.prism(n_samples=16), 40, 30, 8, 4),
                bounce.FX_TRANSMISSION | bounce.FX_EMISSION),
    "sky": (lambda: _doc(torch_scenes.open_sky(schema, 16, bounces=3), 24, 16, 3, 4),
            bounce.FX_SKY),
    "checker": (lambda: _doc(torch_scenes.textured(schema, presets, 16, 3), 24, 16, 3, 4),
                bounce.FX_TEXTURE),
    "glowing_cornell": (lambda: _doc(_glowing_cornell(), 24, 16, 3, 4), bounce.FX_EMISSION),
}


def _sample(doc, seed, stride=3):
    st = doc["settings"]
    px, py = check.pixel_grid(st["width"], st["height"], stride, seed)
    return px, py


def _render_and_reference(doc, seed, st=None):
    """The CPU render's sampled values at K = 2 and the reference's (of
    ``st``, the scene's own tables by default)."""
    fb = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=2).render()
    px, py = _sample(doc, seed)
    own, cfg = paths.tables(doc, "cpu")
    ref = features.regen_image(st or own, cfg, torch.from_numpy(px), torch.from_numpy(py),
                               cfg.intended_frames, 2).numpy()
    return fb[py, px], ref


def test_featureless_scene_gives_the_paths_bits():
    doc = _doc(presets.cornell_box(), 32, 24, 3, 2)
    st, cfg = paths.tables(doc, "cpu")
    assert bounce.scene_features(st) == 0
    px, py = (torch.from_numpy(a) for a in _sample(doc, 7))
    w1, w2 = paths.Work(), paths.Work()
    got = features.regen_image(st, cfg, px, py, 2, 2, w1)
    want = paths.regen_image(st, cfg, px, py, 2, 2, w2)
    assert torch.equal(got, want)
    assert float(want[:, :3].abs().max()) > 0.0
    assert w1 == w2 and w1.lanes == 2 * px.numel()
    assert w1.lanes <= w1.iterations <= w1.lanes * cfg.max_bounces


@pytest.mark.parametrize("case", sorted(CASES))
def test_feature_scene_matches_the_renderer(case):
    make, bits = CASES[case]
    doc = make()
    st, _cfg = paths.tables(doc, "cpu")
    assert bounce.scene_features(st) == bits
    got, ref = _render_and_reference(doc, 5)
    # the same paths and sums; only the RGB fold's matmul sees another row count
    assert check.pixel_gap(got, ref) <= 1e-6
    assert float(np.abs(ref[:, :3]).max()) > 0.0


def test_paths_refuses_what_features_covers():
    doc = CASES["prism16"][0]()
    st, cfg = paths.tables(doc, "cpu")
    px, py = (torch.from_numpy(a) for a in _sample(doc, 5))
    with pytest.raises(ValueError, match="not covered"):
        paths.regen_image(st, cfg, px, py, 4, 2)


@pytest.mark.parametrize("case", ["prism64", "prism16"])
def test_control_without_dispersion_fails(case):
    """The reference with the glass's Cauchy term set to 0 in its tables
    only (no hero wavelength, one index for every bin) reads far above the
    cell's 1e-5 limit."""
    doc = CASES[case][0]()
    st, _cfg = paths.tables(doc, "cpu")
    assert float(st.cauchy_b.max()) == pytest.approx(0.035)
    flat = dataclasses.replace(st, cauchy_b=torch.zeros_like(st.cauchy_b))
    got, ref = _render_and_reference(doc, 5, st=flat)
    assert check.pixel_gap(got, ref) > 1e-2


def test_control_terms_added_as_one_fails(monkeypatch):
    """A surface that emits and reflects: each bounce's terms added
    together first, then to the lane's sum (``paths``' one term a bounce),
    no longer gives the render's bits."""
    doc = CASES["glowing_cornell"][0]()
    got, ref = _render_and_reference(doc, 5)
    assert check.pixel_gap(got, ref) == 0.0
    step = features.bounce_terms

    def lumped(*args):
        state, terms = step(*args)
        one = torch.zeros_like(terms.direct)
        for t in terms:
            if t is not None:
                one = one + t
        return state, features.Terms(None, None, one)

    monkeypatch.setattr(features, "bounce_terms", lumped)
    _got, lumped_ref = _render_and_reference(doc, 5)
    assert check.pixel_gap(got, lumped_ref) > 0.0


def test_prism_configuration_and_cell():
    doc = bench_scene.scene_dict(PRISM)
    want = presets.prism(n_samples=64)
    want.nbr_of_ray_bounces = 8
    assert doc == sceneio.scene_to_dict(want)
    assert (PRISM["width"], PRISM["height"], PRISM["wavelengths"], PRISM["bounces"],
            PRISM["iterations"]) == (800, 600, 64, 8, 200)
    assert PRISM["reduced"] == []
    cell = core.load_cell(REPO, "prism.regen")
    assert {m["name"] for m in cell.end_to_end} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == PRISM_METRICS
    assert cell.traffic["driver"] == "offline_features"
    offline = core.load_module(REPO / "benchmark/drivers/offline.py", "prism_test_offline")
    # two launches of K = 100 an image, no tail
    assert offline.Driver.regen_chunk(PRISM) == auto_regen_frames(800, 600, 64, 200) == 100


@pytest.fixture(scope="module")
def prism_root(tmp_path_factory):
    """A tree with a tiny copy of the prism cell: 12x9, 64 wavelengths,
    3 bounces, 4 iterations (one launch of K = 4 under "auto")."""
    configs = {"tinyprism": tiny.tiny_config("tinyprism", PRISM["scene"], 12, 9, 3, 4)}
    cells = {"tinyprism.regen": {"config": "tinyprism", "traffic": "regen_features-dense",
                                 "chips": 1, "why": "tests", "like": "prism.regen",
                                 "limits": tiny.limits("prism.regen")}}
    return tiny.tree(tmp_path_factory.mktemp("prism"), cells, configs, tiny.dense_mixes())


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_tiny_prism_cell_runs(prism_root, traced):
    out = core.run_cell(prism_root, "tinyprism.regen", 2**31 + 2121, 0.3, traced,
                        device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1, out["check"]
    assert out["check"]["pixel_gap"]["value"] <= 1e-6
    if traced:
        # a CPU run has no card's metric, and the plain path counts no launch
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}


# ------------------------------------------------ the prism's per-layer readers


def _read(name: str, view):
    return core.load_module(METRICS / f"{name}.py", f"t_{name}".replace(".", "_")).read(view)


def _view(rows, monkeypatch, config=None, work=None, images=2, chunk=100,
          device_spans=(("regen_kernel<64,false,false,true>", 1.0, 2.0),
                        ("regen_kernel<64,false,false,true>", 3.0, 4.5))):
    """A traced window of [0, 10] s on the profiler's clock, whose program
    clock runs 1,000 s ahead: ``images`` images of the configuration at
    ``chunk`` frames a launch, the program's ``rows``, the reference's
    ``work``."""
    shift = 1000.0
    monkeypatch.setattr(trace, "rows", lambda: [
        r._replace(time=r.time + shift) for r in rows])
    config = config or PRISM
    driver = SimpleNamespace(
        spans=SimpleNamespace(rows=[("window", shift, 10.0 + shift)]),
        images=[None] * images, chunk=chunk,
        frames_rendered=lambda: images * int(config["iterations"]))
    cell = SimpleNamespace(config=config)
    return core.TraceView(cell, 0.0, 10.0, list(device_spans), [], driver, work)


def test_shared_bins_share_of_feature_launches(monkeypatch):
    rows = [trace.Count("launch.regen", t, 1, 1) for t in (1.0, 2.0, 3.0, 4.0)]
    rows += [trace.Count("launch.regen_features", t, 1, 1) for t in (1.0, 2.0, 3.0, 4.0)]
    rows += [trace.Count("launch.regen_shared_bins", t, 1, 1) for t in (1.0, 2.0, 3.0)]
    rows.append(trace.Count("launch.regen_shared_bins", 12.0, 1, 1))  # after the window
    assert _read("regen.shared_bins_pct.prism", _view(rows, monkeypatch)) == \
        pytest.approx(75.0)


def test_shared_bins_share_needs_the_feature_count(monkeypatch):
    """A program that counts no feature launch (the parent of the count)
    gives None and raises nothing."""
    rows = [trace.Count("launch.regen", 1.0, 1, 1),
            trace.Count("launch.regen_shared_bins", 1.0, 1, 1)]
    assert _read("regen.shared_bins_pct.prism", _view(rows, monkeypatch)) is None
    assert _read("regen.shared_bins_pct.prism", _view([], monkeypatch)) is None


def test_prism_roofline_counts_the_feature_build(monkeypatch):
    """The same window and work read by the feature-less reader and by
    the prism's: the feature terms raise the operations a lane-bounce,
    so the prism's share is higher, by exactly those terms; the bytes of
    two launches an image bound neither. The idle share is the view's."""
    work = paths.Work(lanes=1000, iterations=3500.0)
    view = _view([], monkeypatch, work=work)
    plain = _read("regen.roofline_pct", view)
    prism = _read("regen.roofline_pct.prism", view)
    assert 0.0 < plain < prism
    reader = core.load_module(METRICS / "regen.roofline_pct.prism.py", "t_prism_roofline")
    st, cfg = paths.tables(bench_scene.scene_dict(PRISM), "cpu")
    extra = reader.feature_lane_bounce_ops(st, cfg)
    assert extra > 0.0
    from benchmark.metrics import work as work_mod

    frame, _ = work_mod.per_frame_ops(view)
    assert prism / plain == pytest.approx((frame + 480_000 * 3.5 * extra) / frame)
    assert _read("device.idle_pct.prism", view) == pytest.approx(75.0)
    assert _read("regen.roofline_pct.prism", _view([], monkeypatch, work=work,
                                                   device_spans=())) is None
