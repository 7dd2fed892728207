"""The readers of the program's own spans and counts
(``benchmark/metrics/program.py`` and the metrics that use it) on a
synthetic window whose program clock runs 1,000 s ahead of the
profiler's."""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark.harness import core
from benchmark.metrics import program

from spectral_tpu_torch import runtime
from spectral_tpu_torch.runtime import trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SHIFT = 1000.0  # the program's clock minus the profiler's


def _read(name: str, view):
    return core.load_module(METRICS / f"{name}.py", f"t_{name}".replace(".", "_")).read(view)


def _span(name, s, e, parent=None, request=1, id_=0, arg=None):
    return trace.Span(name, s + SHIFT, e + SHIFT, parent, request, id_, arg)


def _view(rows, monkeypatch, device_spans=(("k", 1.0, 2.0), ("k", 6.0, 9.0)),
          lo=0.0, hi=10.0, width=4, height=4):
    monkeypatch.setattr(trace, "rows", lambda: list(rows))
    driver = SimpleNamespace(spans=SimpleNamespace(
        rows=[("chunk", 3.0 + SHIFT, 4.0 + SHIFT), ("window", lo + SHIFT, hi + SHIFT)]))
    cell = SimpleNamespace(config={"width": width, "height": height})
    return core.TraceView(cell, lo, hi, list(device_spans), [], driver, None)


def test_rows_move_onto_the_profilers_clock_through_the_window(monkeypatch):
    rows = [_span("scene.flatten", 0.5, 0.7, id_=1), _span("scene.flatten", 3.0, 3.4, id_=2),
            _span("scene.flatten", 5.0, 5.3, id_=3),
            _span("scene.flatten", -1.0, -0.5, id_=4),  # before the window
            trace.Count("persist.lanes_working", 2.0 + SHIFT, 16, 1)]
    view = _view(rows, monkeypatch)
    spans, counts = program.rows(view)
    assert [(r.start, r.end) for r in spans] == [pytest.approx((0.5, 0.7)),
                                                 pytest.approx((3.0, 3.4)),
                                                 pytest.approx((5.0, 5.3))]
    assert counts[0].time == pytest.approx(2.0)
    assert _read("live.flatten_ms", view) == pytest.approx(300.0)
    assert _read("live.pack_ms", view) is None  # no such span in the window


def test_idle_in_program_counts_nested_spans_once_and_leaves_gc_out(monkeypatch):
    """The card is busy in [1, 2] and [6, 9] of a 10 s window (60% idle).
    The outermost spans cover [0.5, 3] and [5, 7]; a nested span and a gc
    pass inside the first add nothing, a gc pass at the top level (the
    benchmark's own time) adds nothing: idle and in the program are
    [0.5, 1], [2, 3] and [5, 6], 2.5 s."""
    rows = [_span("render.frames", 0.5, 3.0, id_=1),
            _span("launch.regen", 0.6, 2.5, parent=1, id_=2),
            _span("gc", 2.6, 2.9, parent=1, id_=3, arg=0),
            _span("renderer.init", 5.0, 7.0, id_=4),
            _span("gc", 3.5, 4.5, id_=5, arg=2)]
    view = _view(rows, monkeypatch)
    got = _read("device.idle_pct.live.program", view)
    assert got == pytest.approx(25.0)
    assert got <= _read("device.idle_pct.live", view) == pytest.approx(60.0)
    for cell in ("persist", "render"):
        assert _read(f"device.idle_pct.{cell}.program", view) == pytest.approx(25.0)


def test_idle_in_program_needs_device_spans_and_program_rows(monkeypatch):
    assert _read("device.idle_pct.render.program",
                 _view([], monkeypatch)) is None  # a program that kept nothing
    view = _view([_span("render.frames", 0.5, 3.0, id_=1)], monkeypatch, device_spans=())
    assert _read("device.idle_pct.render.program", view) is None  # a CPU run


def test_lanes_working_share(monkeypatch):
    rows = [trace.Count("persist.lanes_working", t + SHIFT, v, 1)
            for t, v in ((1.0, 16), (2.0, 8), (3.0, 4), (4.0, 4), (11.0, 16))]
    rows.append(trace.Count("launch.persist", 1.0 + SHIFT, 1, 1))
    view = _view(rows, monkeypatch, width=4, height=4)
    assert _read("persist.lanes_working_pct", view) == pytest.approx(100.0 * 32 / 64)


def test_launch_host_median(monkeypatch):
    rows = [_span("launch.regen", t, t + d, id_=i)
            for i, (t, d) in enumerate(((1.0, 0.001), (2.0, 0.003), (3.0, 0.002)))]
    assert _read("live.launch_host_ms", _view(rows, monkeypatch)) == pytest.approx(2.0)


def test_a_program_without_the_tracer_gives_nothing(monkeypatch):
    """An older checkout of the program has no ``runtime.trace``: every
    reader returns None and none raises."""
    view = _view([_span("render.frames", 0.5, 3.0, id_=1)], monkeypatch)
    monkeypatch.delattr(runtime, "trace")
    monkeypatch.setitem(sys.modules, "spectral_tpu_torch.runtime.trace", None)
    for name in ("live.flatten_ms", "live.pack_ms", "live.launch_host_ms",
                 "device.idle_pct.live.program", "device.idle_pct.persist.program",
                 "device.idle_pct.render.program", "persist.lanes_working_pct"):
        assert _read(name, view) is None, name
