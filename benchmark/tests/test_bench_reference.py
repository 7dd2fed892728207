"""The benchmark's plain reference against the port on the CPU, at tiny
sizes: the same pixels' framebuffer values, from the same scene
document, through the Renderer's plain versions (regeneration and
persist) and frame by frame through its eager path."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import check
from benchmark.reference import paths
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.utils import sceneio


def _doc(scene, width, height, bounces, iterations) -> dict:
    scene.width, scene.height = width, height
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iterations
    return sceneio.scene_to_dict(scene)


CASES = {
    "cornell": lambda: _doc(presets.cornell_box(), 32, 24, 3, 2),
    # 101 objects: above 64, so the Renderer walks 64-object clusters and
    # its regeneration lanes take the Morton layout
    "field101": lambda: _doc(presets.sphere_field(100), 32, 24, 3, 2),
}


def _sample(doc, seed=7, stride=3):
    st = doc["settings"]
    px, py = check.pixel_grid(st["width"], st["height"], stride, seed)
    return px, py


@pytest.mark.parametrize("case", sorted(CASES))
def test_regen_matches_the_renderer(case):
    doc = CASES[case]()
    r = Renderer(sceneio.scene_from_dict(doc), device="cpu")
    if case == "field101":
        assert r.clusters is not None and r.lane_layout == "morton"
    fb = r.render()
    px, py = _sample(doc)
    st, cfg = paths.tables(doc, "cpu")
    ref = paths.regen_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py),
                            cfg.intended_frames, r.regen_frames).numpy()
    gap = check.pixel_gap(fb[py, px], ref)
    # the same paths and sums; only the RGB fold's matmul sees another row count
    assert gap <= 1e-6, gap
    assert float(np.abs(ref[:, :3]).max()) > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_regen_matches_the_eager_frames(case):
    """Frame by frame (``regen_frames=1``: the eager bounce loop once a
    frame, blended per frame) traces the same paths; only the order of
    the frames' sum differs."""
    doc = CASES[case]()
    fb = Renderer(sceneio.scene_from_dict(doc), device="cpu", regen_frames=1).render()
    px, py = _sample(doc, seed=11)
    st, cfg = paths.tables(doc, "cpu")
    ref = paths.regen_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py),
                            cfg.intended_frames, cfg.intended_frames).numpy()
    assert check.pixel_gap(fb[py, px], ref) <= 1e-5


def test_persist_matches_the_renderer():
    doc = _doc(presets.cornell_box(), 32, 24, 3, 3)
    r = Renderer(sceneio.scene_from_dict(doc), device="cpu", persist=True)
    fb = r.render()
    assert r.persist_info["launches"] >= 1
    px, py = _sample(doc, seed=3)
    st, cfg = paths.tables(doc, "cpu")
    ref = paths.persist_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py),
                              cfg.intended_frames).numpy()
    assert check.pixel_gap(fb[py, px], ref) <= 1e-6


def test_reference_tables_equal_the_ports():
    """The reference's own flatten gives the port's tables bit for bit."""
    from spectral_tpu_torch.scene.flatten import FIELDS, flatten_numpy

    doc = CASES["field101"]()
    mine, cfg = paths.tables(doc, "cpu")
    theirs, cfg2 = flatten_numpy(sceneio.scene_from_dict(doc))
    assert cfg.width == cfg2.width and cfg.n_objects == cfg2.n_objects
    for name in FIELDS:
        a, b = mine.np_fields[name], theirs[name]
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), name


def test_work_counts_clusters_entered():
    """On the clustered field, a trace enters some clusters and not all."""
    doc = CASES["field101"]()
    st, cfg = paths.tables(doc, "cpu")
    px, py = _sample(doc)
    work = paths.Work()
    paths.regen_image(st, cfg, torch.from_numpy(px), torch.from_numpy(py), 2, 2, work=work)
    boxes = paths.cluster_boxes(st, cfg)
    total = float(boxes[2].sum())
    assert work.lanes == 2 * px.size
    assert work.lanes <= work.iterations <= work.lanes * cfg.max_bounces
    assert 0.0 < work.nearest_members < work.iterations * total
    assert 0.0 <= work.shadow_members < work.iterations * total * cfg.n_lights
