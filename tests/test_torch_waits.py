"""The program's ``wait.*`` spans (``runtime/trace.py``) on the CPU: where
each render path waits on the card, how many blocking calls each span
holds per image, launch, tail frame and edit, and the readings that the
benchmark's cells get from them; ``trace.clock_map``; the readers of
``render.waits_per_image``, ``render.wait_idle_pct`` and ``live.wait_ms``
on fake views; and ``render --profile``'s Chrome trace of the waits.

The spans are kept on every device, so the counts here are the card's:
on the CPU the same calls run, and none of them blocks."""

from __future__ import annotations

import collections
import gc
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import core
from spectral_tpu_torch import cli
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import FIELDS, flatten_numpy
from spectral_tpu_torch.utils import sceneio

REPO = Path(__file__).resolve().parents[1]
METRICS = REPO / "benchmark" / "metrics"
OFFLINE = core.load_module(REPO / "benchmark/drivers/offline.py", "t_waits_offline")

# the blocking calls of an offline image once the memo is warm: none per
# regeneration launch (its blend's two scalars are fills on the device,
# not copies), none per frame of the frame-by-frame tail (the blend's
# scalar and host raygen's six likewise) and one per copy of the
# framebuffer to the host
PER_LAUNCH, PER_TAIL_FRAME, PER_READBACK = 0, 0, 1

torch.set_num_threads(1)


def _scene(name="cornell", w=8, h=6, bounces=2, iters=4, samples=8):
    scene = presets.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _profiled(fn):
    """fn's result, run under a CPU profile with the collector held off,
    and the spans it left."""
    trace.clear()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
    finally:
        gc.enable()
    return out, [r for r in trace.rows() if isinstance(r, trace.Span)]


def _waits(spans):
    """``{(site, parent's name): summed arg}`` of the ``wait.*`` spans."""
    by_id = {s.id: s for s in spans}
    out = collections.Counter()
    for s in spans:
        if s.name.startswith("wait."):
            out[(s.name, by_id[s.parent].name if s.parent in by_id else None)] += s.arg
    return dict(out)


def _image(r):
    """The waits of one offline image after a first one (the memo warm)."""
    r.reset()
    r.render()
    r.reset()
    _, spans = _profiled(r.render)
    return _waits(spans)


def _sum(waits):
    return sum(waits.values())


# ---------------------------------------------------------------- the paths


@pytest.mark.parametrize("iters, k, launches, tail", [
    (4, 2, 2, 0),  # full launches only
    (5, 2, 2, 1),  # and a one-frame tail
    (7, 3, 2, 1),
    (2, 2, 1, 0),
])
def test_regen_image_waits_per_launch_tail_frame_and_readback(iters, k, launches, tail):
    """An offline image on the regeneration path waits only for the copy
    to the host: ``accumulate_frames``' two scalars (under
    ``render.fold``), a tail frame's ``accumulate_frame`` scalar and host
    raygen's six scalars (under ``launch.mono``: the two sizes in
    ``generate_primary_rays``, two in ``camera_basis``, the Hammersley
    pair) are fills on the device, not copies, and a warm memo copies
    no camera input."""
    got = _image(Renderer(_scene(iters=iters), device="cpu", regen_frames=k))
    want = {("wait.readback", "render.readback"): PER_READBACK}
    assert got == want
    assert _sum(got) == PER_LAUNCH * launches + PER_TAIL_FRAME * tail + PER_READBACK


@pytest.mark.parametrize("name, samples, bounces, check", [
    ("prism", 64, 2, lambda r: r.tables.features),
    ("mesh5k", 32, 1, lambda r: r.lane_layout == "morton"),
    ("cornell", 64, 2, lambda r: r.config.n_samples == 64),
])
def test_feature_triangle_and_wide_builds_wait_alike(name, samples, bounces, check):
    """The prism's feature build, mesh5k's Morton lanes and the hero
    frame's 64 wavelengths wait where cornell does, as often: a K = 2
    launch and a one-frame tail an image, and only the readback waits."""
    r = Renderer(_scene(name, bounces=bounces, iters=3, samples=samples), device="cpu",
                 regen_frames=2)
    assert check(r)
    got = _image(r)
    assert got == {("wait.readback", "render.readback"): PER_READBACK}


def test_the_first_image_copies_the_tables_and_camera_inputs():
    """A Renderer's build copies every table of the scene and of the
    kernels once (``from_numpy``'s fields, ``_pack``'s twelve); its first
    launch on a cold memo copies the camera inputs, and Morton lanes copy
    their permutation pair once. The camera table's basis, the fold and
    the tail's raygen copy nothing: their scalars are fills on the
    device."""
    from spectral_tpu_torch.render import launch_inputs

    launch_inputs.MEMO.clear()
    scene = _scene("mesh5k", bounces=1, iters=2, samples=32)
    fields = sum(flatten_numpy(scene)[0][n] is not None for n in FIELDS)

    def first():
        r = Renderer(scene, device="cpu", regen_frames=2)
        r.render()

    _, spans = _profiled(first)
    got = _waits(spans)
    assert got[("wait.upload", "scene.flatten")] == fields
    assert got[("wait.upload", "scene.pack")] == 12
    assert got[("wait.upload", "render.frames")] == 2  # the Morton pair
    # the camera table's host numbers and the Hammersley table
    assert got[("wait.upload", "launch.regen")] == 6 + 1
    assert not {site for site, _parent in got} & {"wait.raygen", "wait.scalar"}
    assert {parent for _site, parent in got} == {"scene.flatten", "scene.pack",
                                                 "render.frames", "launch.regen",
                                                 "render.readback"}


def test_the_first_image_builds_its_launch_inputs_once():
    """A Renderer's first image on an empty memo builds its camera inputs
    once (the pixel planes, the camera table, one frame window a launch)
    under ``wait.upload``; a second image builds nothing and looks up the
    same entries, three a launch. The fold and the tail's raygen keep
    nothing in the memo and wait for nothing."""
    from spectral_tpu_torch.render import launch_inputs

    def counts():
        return trace.total("launch.inputs_miss"), trace.total("launch.inputs_hit")

    launch_inputs.MEMO.clear()
    r = Renderer(_scene(iters=5), device="cpu", regen_frames=2)  # 2 launches, 1 tail frame
    miss0, hit0 = counts()
    _, spans = _profiled(r.render)
    miss1, hit1 = counts()
    assert miss1 - miss0 == 1 + 1 + 2
    assert len(launch_inputs.MEMO) == 4
    # the camera table's six host numbers, a Hammersley table a frame window
    assert _waits(spans) == {("wait.upload", "launch.regen"): 6 + 2,
                             ("wait.readback", "render.readback"): PER_READBACK}
    r.reset()
    _, spans = _profiled(r.render)
    miss2, hit2 = counts()
    assert miss2 == miss1
    assert hit2 - hit1 == 3 * 2
    assert _waits(spans) == {("wait.readback", "render.readback"): PER_READBACK}


# the hero frame's plan (1000 frames: 11 launches of 87, a 43-frame tail)
# and its sizes; a float32 that rounds (2**24 + 1); frame ids at the top
# of uint32 (a resumed or phased blend reads ``(fid + 1) & MASK32``)
SCALARS = sorted({*range(0, 1001), 270, 1080, 1920, 4095, 4096, (1 << 24) + 1,
                  0xFFFFFFFE, 0xFFFFFFFF})


@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_the_fold_and_raygen_scalars_equal_the_copies_they_replace(dtype):
    """Every scalar the fold (``integrator._f32``) and host raygen (the
    image sizes, ``as_u32``'s Hammersley ints) now fill on the device,
    ``0 ..`` the hero's 1000 frames, its sizes and the edges, equals the
    ``torch.tensor`` copy it replaces bit for bit."""
    from spectral_tpu_torch.ops.rng import MASK32, as_u32
    from spectral_tpu_torch.render.integrator import _f32

    for v in SCALARS:
        if dtype == torch.float32:
            got = _f32(v, "cpu").view(torch.int32)
            want = torch.tensor(float(v), dtype=torch.float32).view(torch.int32)
        else:
            got, want = as_u32(v, "cpu"), torch.tensor(v & MASK32, dtype=torch.int64)
        assert got.dtype == want.dtype and got.shape == () and torch.equal(got, want), v


@pytest.mark.parametrize("first, k", [(0, 87), (870, 87), (957, 1), (999, 1), (4, 3),
                                      (4094, 2), (0xFFFFFFFE, 1), (0xFFFFFFFF, 2)])
def test_fold_and_hammersley_take_the_copies_bits(first, k):
    """``accumulate_frames``/``accumulate_frame`` and device Hammersley
    points give the bits of their former copies on a hero launch, its tail
    frames, a resume past 4096 frames and frame ids at the top of
    uint32."""
    from spectral_tpu_torch.ops import rng
    from spectral_tpu_torch.render import integrator

    mask = rng.MASK32

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32)

    gen = torch.Generator().manual_seed(first % 1000 + k)
    accum, rgb = torch.rand((3, 5, 4), generator=gen), torch.rand((3, 5, 3), generator=gen)
    if k > 1:
        inv = 1.0 / f32((first + k) & mask)
        old = f32(first) * inv
        got = integrator.accumulate_frames(accum, rgb, first, k)
        want_rgb, want_a = accum[..., :3] * old + rgb * inv, accum[..., 3] * old + float(k) * inv
    else:
        ratio = 1.0 / f32((first + 1) & mask)
        got = integrator.accumulate_frame(accum, rgb, first)
        want_rgb = accum[..., :3] * (1.0 - ratio) + rgb * ratio
        want_a = accum[..., 3] * (1.0 - ratio) + ratio
    want = torch.cat([want_rgb, want_a[..., None]], dim=-1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for n in (first, first + k - 1):
        got = rng.hammersley(n, 1000, device="cpu")
        want = rng.hammersley(torch.tensor(n & mask), 1000)
        assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want))


def test_persist_image_waits_for_its_probe_each_launch_and_the_copy():
    """The persist path waits once for the budget's probe (under
    ``persist.probe``), once a launch for the one-launch-stale minimum
    (``wait.persist``, the former ``persist.wait``) and once for the
    copy to the host."""
    r = Renderer(_scene(iters=6), device="cpu", persist=True)
    got = _image(r)
    launches = r.persist_info["launches"]
    assert launches >= 2
    assert got == {("wait.probe", "persist.probe"): 1,
                   ("wait.persist", "render.frames"): launches,
                   ("wait.readback", "render.readback"): PER_READBACK}


def test_adaptive_persist_waits_for_its_state():
    """With ``adaptive`` each launch's update copies its three scalars, and
    the per-pixel counts come to the host once (``wait.state``)."""
    r = Renderer(_scene(iters=6), device="cpu", persist=True, persist_budget=4,
                 adaptive=(2, 0.5, 1e-2))
    _, spans = _profiled(r.render)
    got = _waits(spans)
    launches = r.persist_info["launches"]
    assert got[("wait.scalar", "render.frames")] == 3 * launches
    assert got[("wait.state", "render.frames")] >= 1
    assert got[("wait.persist", "render.frames")] >= launches


def test_live_edit_waits_per_edit():
    """One edit (``Renderer(...)``, ``render_frames(16)``, the preview):
    the build's copies of every table and the copy to the host, all under
    the edit's Renderer; a second edit on the same camera takes its camera
    inputs and the fold's scalars from the memo."""
    doc = sceneio.scene_to_dict(_scene(iters=100))
    fields = sum(flatten_numpy(sceneio.scene_from_dict(doc))[0][n] is not None for n in FIELDS)

    def edit():
        r = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=("auto", 16))
        r.render_frames(16)
        return r

    edit()
    r, spans = _profiled(edit)
    got = _waits(spans)
    assert got == {("wait.upload", "scene.flatten"): fields,
                   ("wait.upload", "scene.pack"): 12,
                   ("wait.readback", "render.readback"): PER_READBACK}
    assert {s.request for s in spans if s.name.startswith("wait.")} == {r.request}


def test_progress_waits_for_the_card_once_a_chunk():
    r = Renderer(_scene(iters=4), device="cpu", regen_frames=2)
    _, spans = _profiled(lambda: r.render(progress=lambda p: None))
    assert _waits(spans)[("wait.progress", "render.frames")] == 2


@pytest.mark.parametrize("cell, reading", [
    ("cornell512.regen", 1),
    ("prism.regen", 1),
    ("mesh5k.regen", 1),
    ("hero.regen", 1),
])
def test_the_cells_plans_give_their_waits_per_image(cell, reading):
    """``render.waits_per_image`` in each offline cell, from its plan
    (the Renderer's K, as the offline driver computes it, the launches and
    the tail) and the counts per launch, tail frame and readback above:
    the hero frame's 11 launches of 87 frames and 43 tail frames wait
    for nothing but the copy to the host."""
    workload = json.loads((REPO / f"benchmark/workloads/{cell}.json").read_text())
    config = json.loads((REPO / f"benchmark/configs/{workload['config']}.json").read_text())
    k = OFFLINE.Driver.regen_chunk(config)
    launches, tail = divmod(int(config["iterations"]), k)
    assert PER_LAUNCH * launches + PER_TAIL_FRAME * tail + PER_READBACK == reading
    if cell == "hero.regen":
        assert (k, launches, tail) == (87, 11, 43)


# ---------------------------------------------------------------- the clock


def test_clock_map_is_linear_through_its_two_pairs():
    to = trace.clock_map(100.0, 5.0, 110.0, 15.001)
    assert to(100.0) == pytest.approx(5.0) and to(110.0) == pytest.approx(15.001)
    assert to(105.0) == pytest.approx(10.0005)
    us = trace.clock_map(2.0, 1e6, 3.0, 2e6)  # seconds onto microseconds
    assert us(2.5) == pytest.approx(1.5e6)


# ------------------------------------------------------------- the readers


def _reader(name):
    return core.load_module(METRICS / f"{name}.py", f"t_{name}".replace(".", "_"))


def _view(monkeypatch, spans, device_spans, images=2, shift=1000.0):
    """A traced window of [0, 10] s on the profiler's clock, whose program
    clock runs ``shift`` s ahead, holding the program's ``spans`` (given
    on the profiler's clock)."""
    def program(t):
        return shift + t

    rows = [s._replace(start=program(s.start), end=program(s.end)) for s in spans]
    monkeypatch.setattr(trace, "rows", lambda: rows)
    driver = SimpleNamespace(spans=SimpleNamespace(rows=[("window", program(0.0),
                                                          program(10.0))]),
                             images=[None] * images)
    return core.TraceView(SimpleNamespace(config={}), 0.0, 10.0, device_spans, [], driver,
                          None)


def _span(name, start, end, arg=None, request=1, id_=0, parent=None):
    return trace.Span(name, start, end, parent, request, id_, arg)


KERNEL = [("regen_kernel<32, false, false>", 0.0, 1.0)]


def test_waits_per_image_sums_the_window_args(monkeypatch):
    spans = [_span("render.frames", 0.5, 9.5),
             _span("wait.scalar", 1.0, 1.1, 1), _span("wait.scalar", 1.2, 1.3, 1),
             _span("wait.raygen", 2.0, 2.1, 6), _span("wait.readback", 3.0, 3.1, 1),
             _span("wait.upload", 11.0, 11.5, 48)]  # after the window
    reader = _reader("render.waits_per_image")
    assert reader.read(_view(monkeypatch, spans, KERNEL)) == pytest.approx(9 / 2)
    # no wait span (the parent), no device trace (a CPU run), no image
    assert reader.read(_view(monkeypatch, spans[:1], KERNEL)) is None
    assert reader.read(_view(monkeypatch, spans, [])) is None
    assert reader.read(_view(monkeypatch, spans, KERNEL, images=0)) is None


def test_readers_return_none_without_wait_spans(monkeypatch):
    """A program without the ``wait.*`` spans (the parent of the readers)
    or without rows in the window gives None and raises nothing."""
    spans = [_span("render.frames", 0.5, 9.5), _span("launch.regen", 1.0, 1.1)]
    for rows in (spans, []):
        view = _view(monkeypatch, rows, KERNEL)
        for name in ("render.waits_per_image", "render.wait_idle_pct", "live.wait_ms"):
            assert _reader(name).read(view) is None


def test_wait_idle_counts_the_idle_behind_the_renders_waits(monkeypatch):
    """A wait at 0.5 s on a kernel that ends at 1.0 exposes the idle to the
    next bounce kernel at 1.2; a wait at 4.0 exposes the idle to the end
    of its ``render.frames`` at 4.5, not the idle after it; a wait outside
    ``render.frames`` and copies on the card count for nothing."""
    spans = [_span("render.frames", 0.1, 2.0), _span("render.frames", 3.0, 4.5),
             _span("wait.scalar", 0.5, 1.02, 1), _span("wait.raygen", 1.05, 1.1, 2),
             _span("wait.scalar", 4.0, 4.1, 1), _span("wait.upload", 6.0, 6.1, 12)]
    device = [("regen_kernel<32, false, false>", 0.0, 1.0),
              ("Memcpy HtoD (Pageable -> Device)", 1.05, 1.06),
              ("mono_kernel<64, false, false, false, true>", 1.2, 3.8),
              ("Memcpy DtoH (Device -> Pageable)", 4.2, 4.3)]
    got = _reader("render.wait_idle_pct").read(_view(monkeypatch, spans, device))
    # idle [1.0, 1.05] + [1.06, 1.2] + [3.8, 4.2] + [4.3, 4.5] of a 10 s window
    assert got == pytest.approx(100.0 * (0.05 + 0.14 + 0.2 + 0.2) / 10.0, abs=1e-6)
    assert _reader("render.wait_idle_pct").read(_view(monkeypatch, spans, [])) is None
    assert _reader("render.wait_idle_pct").read(
        _view(monkeypatch, spans[:2], device)) is None


def test_live_wait_ms_is_the_median_edits_waiting(monkeypatch):
    spans = [_span("scene.parse", 0.0, 0.1, request=None),
             _span("wait.upload", 0.2, 0.2015, 48, request=1),
             _span("wait.readback", 0.3, 0.3005, 1, request=1),
             _span("wait.upload", 1.2, 1.201, 48, request=2),
             _span("wait.upload", 2.2, 2.203, 48, request=3),
             _span("wait.scalar", 2.5, 2.6, 1, request=None)]  # of no Renderer
    got = _reader("live.wait_ms").read(_view(monkeypatch, spans, KERNEL))
    assert got == pytest.approx(2.0, rel=1e-4)
    assert _reader("live.wait_ms").read(_view(monkeypatch, spans, [])) is None
    assert _reader("live.wait_ms").read(_view(monkeypatch, spans[:1], KERNEL)) is None


def test_the_waits_metrics_are_the_cells():
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in manifest["per_layer"]}
    offline = ["cornell512.regen", "hero.regen", "prism.regen", "mesh5k.regen"]
    assert got["render.waits_per_image"]["workloads"] == offline
    assert got["render.wait_idle_pct"]["workloads"] == offline
    assert got["live.wait_ms"]["workloads"] == ["cornell512.live"]
    for name in ("render.waits_per_image", "render.wait_idle_pct", "live.wait_ms"):
        assert (METRICS / f"{name}.py").is_file()


# ------------------------------------------------------------- --profile


def test_profile_trace_shows_the_waits_inside_the_render(tmp_path):
    """``render --profile DIR`` writes the ``wait.*`` spans as
    ``spectral.wait.*`` events on the trace's clock (``clock_map`` of the
    pairs read before and after the render), the copy to the host inside
    the render's span; the fold and raygen wait for nothing."""
    out, prof = tmp_path / "img.png", tmp_path / "trace"
    rc = cli.main(["render", "--preset", "cornell", "--width", "8", "--height", "6",
                   "--samples", "8", "--device", "cpu", "--iterations", "3",
                   "--regen-frames", "2", "--bounces", "1", "--out", str(out),
                   "--profile", str(prof), "--quiet"])
    assert rc == 0
    events = json.loads((prof / "render_trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "spectral" and e["ph"] == "X"]
    waits = [e for e in ours if e["name"].startswith("spectral.wait.")]
    names = {e["name"] for e in waits}
    assert {"spectral.wait.upload", "spectral.wait.readback"} <= names
    assert not names & {"spectral.wait.scalar", "spectral.wait.raygen"}
    (frames,) = [e for e in ours if e["name"] == "spectral.render.frames"]
    inside = [e for e in waits if e["name"] == "spectral.wait.readback"
              and frames["ts"] <= e["ts"] and e["ts"] + e["dur"] <= frames["ts"] + frames["dur"]]
    assert len(inside) == 1
    assert all(e["args"]["arg"] >= 1 for e in waits)
