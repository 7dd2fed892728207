"""The program's spans and counters (``runtime/trace.py``) on the CPU: off
without a profiler, the regeneration path's spans and their nesting under
one, the persist scheduler's working lanes, the collector's passes, and
the launch counts that are always kept."""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.utils import sceneio

torch.set_num_threads(1)

REGEN_SPANS = {"scene.parse", "renderer.init", "scene.flatten", "scene.pack",
               "renderer.digest", "renderer.reset", "render.frames", "launch.regen",
               "launch.mono", "render.fold", "render.readback"}


def _cornell(w=16, h=12, bounces=3, iters=5):
    scene = presets.PRESETS["cornell"](n_samples=8)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _profiled(fn):
    """fn's result, run under a CPU profile, and the rows it left."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, trace.rows()


def _spans(rows):
    return [r for r in rows if isinstance(r, trace.Span)]


def test_off_without_a_profiler_records_nothing():
    """No profiler: build, render and read back leave no row, ``span``
    hands out its one shared no-op, and ``count`` only adds to the total."""
    trace.clear()
    assert not trace.enabled()
    r = Renderer(_cornell(), device="cpu", regen_frames=2)
    r.render_frames(3)
    r.framebuffer()
    gc.collect()
    assert trace.rows() == []
    assert trace.span("a") is trace.span("b", 3)
    before = trace.total("test.off")
    trace.count("test.off", 2)
    assert trace.total("test.off") == before + 2 and trace.rows() == []


def test_regen_path_spans_nest_and_share_their_request():
    """Under a profiler one edit (parse, build, a chunk of 2 frames and a
    ragged frame, read back) records every span of the regeneration path;
    the build's and the render's spans nest under ``renderer.init`` and
    ``render.frames``, inside them in time, and carry the Renderer's
    serial; a second edit gets another."""
    doc = sceneio.scene_to_dict(_cornell())

    def edit():
        r = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=("auto", 2))
        fb = r.render_frames(3)
        return r, fb

    (r, fb), rows = _profiled(edit)
    spans = _spans(rows)
    assert {s.name for s in spans} == REGEN_SPANS
    by_id = {s.id: s for s in spans}
    (init,) = [s for s in spans if s.name == "renderer.init"]
    (frames,) = [s for s in spans if s.name == "render.frames"]
    (parse,) = [s for s in spans if s.name == "scene.parse"]
    assert init.parent is frames.parent is parse.parent is None
    assert parse.end <= init.start and init.end <= frames.start
    for s in spans:
        if s.name in ("scene.flatten", "scene.pack", "renderer.digest", "renderer.reset"):
            assert s.parent == init.id, s
        elif s.name in ("launch.regen", "launch.mono", "render.fold", "render.readback"):
            assert s.parent == frames.id, s
        if s.parent is not None:
            outer = by_id[s.parent]
            assert outer.start <= s.start <= s.end <= outer.end
    assert [s.name for s in spans].count("launch.regen") == 1
    assert [s.name for s in spans].count("launch.mono") == 1
    assert {s.request for s in spans if s is not parse} == {r.request}
    assert fb.shape == (12, 16, 4)
    (r2, _), rows2 = _profiled(edit)
    assert r2.request != r.request
    assert {s.request for s in _spans(rows2) if s.name != "scene.parse"} == {r2.request}


@pytest.mark.parametrize("adaptive", [None, (2, 0.5, 1e-2)], ids=["plain", "adaptive"])
def test_persist_counts_the_lanes_working_at_each_launch(monkeypatch, adaptive):
    """One ``persist.lanes_working`` row per launch: every lane at the
    first, then the lanes that owe frames as the launch starts, which a
    copy of the state taken then gives through ``completed_frames`` (a
    stopped lane that is dead owes none)."""
    want = []
    real = mk.run_persist

    def spy(state, lead, end, tables, cam, ring=None, stop=None, budget=1):
        done = ci.completed_frames(state).clone()
        if stop is not None:
            done[(stop > 0.0) & (state.alive <= 0.0)] = end
        want.append(int((done < end).sum()))
        return real(state, lead, end, tables, cam, ring=ring, stop=stop, budget=budget)

    monkeypatch.setattr(mk, "run_persist", spy)
    scene = _cornell(iters=6)
    r = Renderer(scene, device="cpu", persist=True, persist_budget=4, adaptive=adaptive)
    _, rows = _profiled(r.render)
    got = [c.value for c in rows if isinstance(c, trace.Count)
           and c.name == "persist.lanes_working"]
    assert len(got) == r.persist_info["launches"] == len(want) > 2
    assert got[0] == want[0] == scene.width * scene.height
    assert got == want
    assert got[-1] < got[0]
    assert all(c.request == r.request for c in rows if isinstance(c, trace.Count))
    names = {s.name for s in _spans(rows)}
    assert {"persist.init", "launch.persist", "persist.wait", "persist.finish"} <= names


def test_persist_probe_span_holds_the_budget_probe():
    r = Renderer(_cornell(iters=4), device="cpu", persist=True)
    _, rows = _profiled(r.render)
    spans = _spans(rows)
    (probe,) = [s for s in spans if s.name == "persist.probe"]
    (first,) = [s for s in spans if s.name == "launch.persist"][:1]
    assert probe.end <= first.start


def test_a_collection_under_the_profiler_is_a_gc_span():
    def collect():
        with trace.span("outer", 7):
            gc.collect()

    _, rows = _profiled(collect)
    spans = _spans(rows)
    (outer,) = [s for s in spans if s.name == "outer"]
    passes = [s for s in spans if s.name == "gc"]
    assert any(s.arg == 2 and s.parent == outer.id and s.request == 7 for s in passes)
    assert all(outer.start <= s.start <= s.end <= outer.end for s in passes
               if s.parent == outer.id)


def test_counts_keep_a_total_and_rows_while_tracing():
    before = trace.total("test.on")

    def counted():
        with trace.span("outer", 5):
            trace.count("test.on", 3)
            trace.count("test.device", torch.tensor(11, dtype=torch.int32))

    _, rows = _profiled(counted)
    counts = {c.name: c for c in rows if isinstance(c, trace.Count)}
    assert counts["test.on"].value == 3 and counts["test.on"].request == 5
    assert counts["test.device"].value == 11
    assert trace.total("test.on") == before + 3 and trace.total("test.device") == 0


def test_chrome_events_put_the_rows_on_one_track():
    rows = [trace.Span("render.frames", 10.0, 10.5, None, 4, 1),
            trace.Span("gc", 10.1, 10.2, 1, 4, 2, 0),
            trace.Count("launch.regen", 10.05, 1, 4)]
    events = trace.chrome_events(rows, lambda t: (t - 10.0) * 1e6 + 100.0, 9, 0)
    assert events[0]["ph"] == "M"
    x = [e for e in events if e["ph"] == "X"]
    assert [e["name"] for e in x] == ["spectral.render.frames", "spectral.gc"]
    assert x[0]["ts"] == pytest.approx(100.0) and x[0]["dur"] == pytest.approx(5e5)
    assert x[1]["args"] == {"request": 4, "id": 2, "parent": 1, "generation": 0}
    (i,) = [e for e in events if e["ph"] == "i"]
    assert i["name"] == "spectral.launch.regen" and i["args"]["value"] == 1
    assert {(e["pid"], e["tid"]) for e in events} == {(9, 0)}
    assert np.isclose(i["ts"], 5e4 + 100.0)
