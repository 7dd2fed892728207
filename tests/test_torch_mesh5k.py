"""The triangle mesh's configuration (``benchmark/configs/mesh5k.json``:
``presets.mesh5k()``, 6,405 objects in 100 clusters) on the CPU at tiny
sizes: the benchmark's plain reference against the Renderer's plain
versions on the published geometry and on a coarser one, with a control;
the configuration and the cell ``mesh5k.regen`` as the harness loads and
runs them; the launch counts of triangle walks and of walks whose packed
records stay in global memory; and the readers of the cell's per-layer
metrics on fake views."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import check, core
from benchmark.harness import scene as bench_scene
from benchmark.reference import paths
from benchmark.tests import tiny
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import flatten_scene
from spectral_tpu_torch.utils import sceneio

REPO = Path(__file__).resolve().parents[1]
MESH5K = json.loads((REPO / "benchmark/configs/mesh5k.json").read_text())
MESH5K_METRICS = {"regen.roofline_pct.mesh5k", "regen.packed_global_pct.mesh5k",
                  "device.idle_pct.mesh5k", "render.waits_per_image", "render.wait_idle_pct"}

torch.set_num_threads(1)


def _doc(scene, width, height, bounces, iterations) -> dict:
    scene.width, scene.height = width, height
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iterations
    return sceneio.scene_to_dict(scene)


def _reference(doc, px, py, chunk, work=None) -> np.ndarray:
    st, cfg = paths.tables(doc, "cpu")
    return paths.regen_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py),
                             cfg.intended_frames, chunk, work).numpy()


def _render(doc, chunk=2):
    """The Renderer's framebuffer on the CPU and its every other pixel."""
    r = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=chunk)
    assert r.clusters is not None and r.lane_layout == "morton"
    st = doc["settings"]
    return r.render(), check.pixel_grid(st["width"], st["height"], 2, 2**31 + 23)


CASES = {
    # the published geometry: 6,405 objects, 100 clusters of triangles
    "published": lambda: _doc(presets.mesh5k(), 16, 12, 3, 4),
    # 405 objects, still clustered; the control below renders it
    "subdivisions2": lambda: _doc(presets.mesh5k(subdivisions=2), 24, 16, 3, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_renderer(case):
    doc = CASES[case]()
    fb, (px, py) = _render(doc)
    ref = _reference(doc, px, py, 2)
    # the same paths and sums; only the RGB fold's matmul sees another row count
    gap = check.pixel_gap(fb[py, px], ref)
    assert gap <= 1e-6, gap
    assert float(np.abs(ref[:, :3]).max()) > 0.0


def test_the_comparison_sees_a_coarser_mesh():
    """The control: the reference given ``subdivisions=1`` (80 and 20
    faces) for the program's render at ``subdivisions=2`` misses by far
    more than any limit of the benchmark."""
    fb, (px, py) = _render(CASES["subdivisions2"]())
    coarse = _reference(_doc(presets.mesh5k(subdivisions=1), 24, 16, 3, 4), px, py, 2)
    assert check.pixel_gap(fb[py, px], coarse) > 1e-3


def test_mesh5k_configuration_and_cell():
    doc = bench_scene.scene_dict(MESH5K)
    assert (MESH5K["width"], MESH5K["height"], MESH5K["wavelengths"]) == (512, 512, 32)
    assert (MESH5K["bounces"], MESH5K["iterations"], MESH5K["reduced"]) == (30, 100, [])
    # the published scene, as bench.py's mesh5k config builds it (through
    # JSON: the document's tuples are the file's lists)
    assert doc == json.loads(json.dumps(_doc(presets.mesh5k(), 512, 512, 30, 100)))
    tb = mk.pack_tables(*flatten_scene(sceneio.scene_from_dict(doc), "cpu"))
    assert tb.config.n_objects == 6405 and tb.triangles == 1
    assert sum(1 for *_r, clustered in tb.clusters[1] if clustered) == 100
    assert tb.many_objects() and not tb.packed_shared and tb.packed.shape == (19200, 4)
    cell = core.load_cell(REPO, "mesh5k.regen")
    assert {m["name"] for m in cell.end_to_end} == {"msamples_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == MESH5K_METRICS
    assert cell.traffic["driver"] == "offline" and cell.traffic["check"]["stride"] == 32
    assert cell.workload["limits"] == {"pixel_gap": 1e-5} and cell.workload["chips"] == 1
    driver = core.load_module(REPO / "benchmark/drivers/offline.py", "t_offline_mesh5k")
    assert driver.Driver.regen_chunk(MESH5K) == 100  # one launch an image, no tail


@pytest.fixture(scope="module")
def mesh5k_root(tmp_path_factory):
    """A tree with a tiny copy of the mesh cell: the published geometry at
    8x6, one bounce, 2 iterations (one K = 2 launch an image)."""
    configs = {"tinymesh5k": tiny.tiny_config("tinymesh5k", MESH5K["scene"], 8, 6, 1, 2)}
    cells = {"tinymesh5k.regen": {"config": "tinymesh5k", "traffic": "regen_stride32-dense",
                                  "chips": 1, "why": "tests", "like": "mesh5k.regen",
                                  "limits": tiny.limits("mesh5k.regen")}}
    return tiny.tree(tmp_path_factory.mktemp("mesh5k"), cells, configs, tiny.dense_mixes())


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_tiny_mesh5k_cell_runs(mesh5k_root, traced):
    out = core.run_cell(mesh5k_root, "tinymesh5k.regen", 2**31 + 5005, 0.3, traced,
                        device="cpu")
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1, out["check"]
    assert out["check"]["pixel_gap"]["value"] <= 1e-6
    if traced:
        # the plain path counts no launch and the CPU has no device trace:
        # every reader returns None, and the line leaves its metric out
        assert out["metrics"] == {}
    else:
        assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}


# ------------------------------------------------------------ the launch counts


@pytest.mark.parametrize("name,triangles,packed_global", [
    ("mesh5k", 1, 1),  # 6,400 triangles: records in global memory
    ("mesh", 1, 0),  # 340 triangles: records in shared memory
    ("spheres1000", 0, 0),  # records in shared memory
    ("cornell", 0, 0),  # no walk records
])
def test_launches_count_their_triangle_walks(monkeypatch, name, triangles, packed_global):
    """``run_regen`` counts ``launch.regen_triangles`` for each launch on
    tables with triangles, and ``launch.regen_packed_global`` for each
    launch of a many-object walk whose packed records stay in global
    memory (the launches stubbed: the CPU has no kernel)."""
    scene = presets.sphere_field(1000) if name == "spheres1000" else presets.PRESETS[name]()
    scene.width, scene.height, scene.nbr_of_ray_bounces = 8, 4, 1
    tb = mk.pack_tables(*flatten_scene(scene, "cpu"))
    assert tb.packed_shared is not bool(packed_global)
    monkeypatch.setattr(mk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(mk, "_launch_regen", lambda library, px, *rest: (
        torch.zeros((tb.config.n_samples, px.shape[0])), False))
    kinds = ("regen", "regen_triangles", "regen_packed_global")
    before = [trace.total(f"launch.{k}") for k in kinds]
    for first in (0, 2):
        mk.run_regen(*ci.regen_args(tb.scene, tb.config, first, 2), tb)
    got = [trace.total(f"launch.{k}") - b for k, b in zip(kinds, before)]
    assert got == [2, 2 * triangles, 2 * packed_global]


# -------------------------------------------------------------- the readers


def _read_packed_global(rows, monkeypatch):
    """``regen.packed_global_pct.mesh5k`` over a traced window of [0, 10] s
    on the profiler's clock, whose program clock runs 1,000 s ahead, with
    the program's ``rows``."""
    shift = 1000.0
    monkeypatch.setattr(trace, "rows", lambda: [r._replace(time=r.time + shift) for r in rows])
    driver = SimpleNamespace(spans=SimpleNamespace(rows=[("window", shift, 10.0 + shift)]))
    view = core.TraceView(SimpleNamespace(config=MESH5K), 0.0, 10.0, [], [], driver, None)
    return core.load_module(REPO / "benchmark/metrics/regen.packed_global_pct.mesh5k.py",
                            "t_regen_packed_global_pct_mesh5k").read(view)


def test_packed_global_share_of_triangle_launches(monkeypatch):
    def rows(kinds):
        return [trace.Count(f"launch.{k}", t, 1, 1) for t in (1.0, 2.0) for k in kinds]

    every = rows(("regen", "regen_triangles", "regen_packed_global"))
    assert _read_packed_global(every, monkeypatch) == pytest.approx(100.0)
    after = [trace.Count("launch.regen_packed_global", 12.0, 1, 1)]  # after the window
    assert _read_packed_global(rows(("regen", "regen_triangles")) + after,
                               monkeypatch) == 0.0
    # no triangle launch in the window, or no program rows (the parent of the count)
    assert _read_packed_global(rows(("regen",)), monkeypatch) is None
    assert _read_packed_global([], monkeypatch) is None


def test_roofline_of_a_counted_walk():
    """``regen.roofline_pct.mesh5k`` on a counted ``Work`` of the published
    scene (8 pixels, 2 frames) and two images' worth of ``regen_kernel``
    at 48 ms a frame reads a share in (0, 100]; without the kernel, None."""
    doc = bench_scene.scene_dict(MESH5K)
    px, py = check.pixel_grid(512, 512, 181, 2**31 + 77)
    work = paths.Work()
    st, cfg = paths.tables(doc, "cpu")
    paths.regen_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py), 2, 2, work)
    assert work.lanes == 2 * px.size and work.nearest_members > 0 and work.shadow_members > 0
    driver = SimpleNamespace(images=[None, None], chunk=100, frames_rendered=lambda: 200)
    reader = core.load_module(REPO / "benchmark/metrics/regen.roofline_pct.mesh5k.py",
                              "t_regen_roofline_pct_mesh5k")

    def view(spans):
        return core.TraceView(SimpleNamespace(config=MESH5K), 0.0, 10.0, spans, [], driver, work)

    share = reader.read(view([("regen_kernel<32, true, true, false>", 0.0, 200 * 0.048)]))
    assert 0.0 < share <= 100.0
    assert reader.read(view([("Memcpy DtoH", 0.0, 1.0)])) is None
