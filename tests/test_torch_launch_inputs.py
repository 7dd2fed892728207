"""The launches' camera-derived inputs (``render/launch_inputs.py``) on
the CPU: what the memo hands a launch is, tensor for tensor, what the
build functions return (``torch.equal``), at the first ask and at every later
one; an edit that leaves the camera alone hits; a change to any input of
the key misses and returns the new values; the memo keeps to its bound;
nothing written into a persist state reaches the memo; the hit and miss
counts (``runtime.trace``) are one per lookup.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import camera
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render import launch_inputs as li
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes as ts

torch.set_num_threads(1)

HIT, MISS = "launch.inputs_hit", "launch.inputs_miss"


@pytest.fixture(autouse=True)
def empty_memo():
    li.MEMO.clear()
    yield
    li.MEMO.clear()


def _scene(w=16, h=12, iters=8, lens=False):
    scene = presets.cornell_box(n_samples=8)
    scene.width, scene.height = w, h
    scene.nbr_of_iterations, scene.nbr_of_ray_bounces = iters, 2
    return ts.with_lens(scene) if lens else scene


def _counts():
    return trace.total(HIT), trace.total(MISS)


def _built_regen_args(st, cfg, first, k, perm=None, full_height=None, row_offset=0):
    """``regen_args`` from the build functions, as the integrator built it before
    the memo."""
    px, py = camera.pixel_coords(cfg.width, cfg.height, st.device, row_offset)
    if perm is not None:
        px, py = px[perm], py[perm]
    return (px.to(torch.int32), py.to(torch.int32), first,
            camera.camera_basis_table(st, cfg, full_height),
            camera.hammersley_table(first, k, cfg.intended_frames, st.device),
            camera.lens_table(st, cfg, first, k))


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("case", ["pinhole", "lens", "slab", "morton"])
def test_regen_args_equal_fresh_builds(case):
    """A launch's arguments, first built and then from the memo, equal
    the build functions': pinhole, depth of field (the lens table), a row slab
    of a taller image and a Morton lane order."""
    st, cfg = flatten_scene(_scene(lens=case == "lens"), "cpu")
    kw = {}
    if case == "slab":
        cfg = dataclasses.replace(cfg, height=4)
        kw = dict(full_height=12, row_offset=4)
    perm = morton_layout(cfg.width, cfg.height, "cpu")[0] if case == "morton" else None
    want = _built_regen_args(st, cfg, 2, 4, perm, **kw)
    first = ci.regen_args(st, cfg, 2, 4, perm, **kw)
    again = ci.regen_args(st, cfg, 2, 4, perm, **kw)
    _equal(first, want)
    _equal(again, want)
    assert all(a is b for a, b in zip(first, again))
    assert (want[5] is None) == (case != "lens")


@pytest.mark.parametrize("slab", [False, True])
def test_persist_inputs_equal_fresh_builds(slab):
    """The persist path's camera table and frame-0 lanes, from the memo,
    equal the build functions'; ``persist_init``'s planes equal frame 0's."""
    st, cfg = flatten_scene(_scene(), "cpu")
    kw = {}
    if slab:
        cfg = dataclasses.replace(cfg, height=6)
        kw = dict(full_height=12, row_offset=6)
    for _ in range(2):
        got = li.camera_table(st, cfg, kw.get("full_height"))
        assert torch.equal(got, camera.camera_basis_table(st, cfg, kw.get("full_height")))
        planes, px, py = li.frame0_lanes(st, cfg, **kw)
        want_planes, want_px, want_py = li.primary_lanes(st, cfg, 0, **kw)
        _equal((*planes, px, py), (*want_planes, want_px, want_py))
        state = ci.persist_init(st, cfg, **kw)
        _equal([getattr(state, n) for n in ("ox", "oy", "oz", "dx", "dy", "dz", "px", "py")],
               (*want_planes, want_px, want_py))


def test_persist_init_gives_copies():
    """Writing into a ``PersistState`` from ``persist_init``, and a whole
    persist render, leave the memo's frame-0 lanes as built."""
    st, cfg = flatten_scene(_scene(), "cpu")
    want = li.primary_lanes(st, cfg, 0)
    state = ci.persist_init(st, cfg)
    for name in ("ox", "oy", "oz", "dx", "dy", "dz", "px", "py"):
        getattr(state, name).add_(1)
    ci.render_persistent(st, cfg, 2, budget=8)
    planes, px, py = li.frame0_lanes(st, cfg)
    _equal((*planes, px, py), (*want[0], want[1], want[2]))
    kept = {id(t) for t in (*planes, px, py)}
    fresh = ci.persist_init(st, cfg)
    assert not kept & {id(t) for t in fresh.planes().values()}


def test_probe_frame0_from_the_memo():
    """The cost probe's frame 0 takes the memo's lanes, frame 1 the
    build function's: the probe's sum is the build functions' sum."""
    st, cfg = flatten_scene(_scene(), "cpu")
    tb = mk.pack_tables(st, cfg)
    want = torch.zeros(cfg.width * cfg.height)
    for f in range(2):
        planes, px, py = li.primary_lanes(st, cfg, f)
        want = want + mk.run_cost(*planes, px, py, f, tb)[1]
    before = _counts()
    assert torch.equal(ci.probe_path_cost(st, cfg, tb, n_probe_frames=2), want)
    assert np.subtract(_counts(), before).tolist() == [0, 1]
    assert torch.equal(ci.probe_path_cost(st, cfg, tb, n_probe_frames=2), want)
    assert np.subtract(_counts(), before).tolist() == [1, 1]


@pytest.mark.parametrize("edit", ["move", "material"])
def test_scene_edit_hits(edit):
    """An edit that moves a box or swaps its material leaves the camera
    alone: the new scene's launch takes the same tensors."""
    scene = _scene()
    st, cfg = flatten_scene(scene, "cpu")
    args = ci.regen_args(st, cfg, 0, 4)
    box = next(o for o in scene.objects if "box" in o.name.lower())
    if edit == "move":
        box.position = (box.position[0] + 0.1, box.position[1], box.position[2] - 0.1)
    else:
        box.material = next(m for m in scene.materials
                            if m.id != box.material.id and m.emission is None)
    st2, cfg2 = flatten_scene(scene, "cpu")
    assert cfg2 == cfg
    before = _counts()
    again = ci.regen_args(st2, cfg2, 0, 4)
    assert np.subtract(_counts(), before).tolist() == [3, 0]
    assert all(a is b for a, b in zip(args, again))


def _set(scene, field, value):
    if field in ("width", "height", "nbr_of_iterations"):
        setattr(scene, field, value)
    else:
        setattr(scene.camera, field, value)


CHANGES = [
    ("position", (0.1, 0.0, -2.0)), ("direction", (0.05, 0.0, 1.0)),
    ("up", (0.1, 1.0, 0.0)), ("fov_y_deg", 50.0), ("aperture_radius", 0.08),
    ("focus_distance", 2.5), ("width", 12), ("height", 8), ("nbr_of_iterations", 6),
]


@pytest.mark.parametrize("field,value", CHANGES, ids=[c[0] for c in CHANGES])
def test_camera_change_misses(field, value):
    """A change to the camera's position, direction, up, field of view,
    aperture or focus, to the image's size or to its iterations misses
    every table, and the launch gets the new values."""
    scene = _scene(lens=True)
    st, cfg = flatten_scene(scene, "cpu")
    old = ci.regen_args(st, cfg, 0, 4)
    _set(scene, field, value)
    st2, cfg2 = flatten_scene(scene, "cpu")
    before = _counts()
    new = ci.regen_args(st2, cfg2, 0, 4)
    assert np.subtract(_counts(), before).tolist() == [0, 3]
    _equal(new, _built_regen_args(st2, cfg2, 0, 4))
    assert not any(a is b for a, b in zip(old[:2] + old[3:], new[:2] + new[3:]))


@pytest.mark.parametrize("first,k", [(4, 4), (0, 3)])
def test_frame_window_change_misses(first, k):
    """Another first frame or another K misses the frame tables only."""
    st, cfg = flatten_scene(_scene(lens=True), "cpu")
    old = ci.regen_args(st, cfg, 0, 4)
    before = _counts()
    new = ci.regen_args(st, cfg, first, k)
    assert np.subtract(_counts(), before).tolist() == [2, 1]
    _equal(new, _built_regen_args(st, cfg, first, k))
    assert new[0] is old[0] and new[3] is old[3] and new[4] is not old[4]


def test_scene_without_host_camera_builds_every_time():
    """Tensors without ``np_fields``: the build functions run, nothing is kept
    or counted."""
    st, cfg = flatten_scene(_scene(), "cpu")
    bare = dataclasses.replace(st, np_fields={})
    before = _counts()
    a, b = ci.regen_args(bare, cfg, 0, 4), ci.regen_args(bare, cfg, 0, 4)
    _equal(a, _built_regen_args(st, cfg, 0, 4))
    _equal(b, a)
    assert a[3] is not b[3]
    assert _counts() == before and len(li.MEMO) == 0


def test_bounds():
    """The memo drops its least recently used entries beyond its entry
    count or its bytes; a value larger than the byte bound is returned
    and not kept. The process's memo stays within its bound over many
    cameras."""
    memo = li.LaunchInputs(max_entries=3, max_bytes=64)
    t = lambda n: torch.zeros(n, dtype=torch.uint8)  # noqa: E731
    for key in "abc":
        memo.get(key, lambda: t(8))
    memo.get("a", lambda: t(8))  # a becomes the newest
    memo.get("d", lambda: t(8))  # b goes
    assert len(memo) == 3 and memo.nbytes == 24
    kept = memo.get("b", lambda: t(1))
    assert kept.numel() == 1  # rebuilt: it had gone
    memo.get("e", lambda: t(60))  # a and d go: b and e are 61 bytes
    assert len(memo) == 2 and memo.nbytes == 61
    big = memo.get("f", lambda: t(65))
    assert big.numel() == 65 and len(memo) == 2 and memo.nbytes == 61

    scene = _scene(w=8, h=4)
    for i in range(li.MEMO.max_entries + 8):
        scene.camera.position = (0.01 * i, 0.0, -2.0)
        ci.regen_args(*flatten_scene(scene, "cpu"), 0, 2)
        assert len(li.MEMO) <= li.MEMO.max_entries
        assert li.MEMO.nbytes <= li.MEMO.max_bytes


def test_counts_per_lookup():
    """One count per lookup: a launch looks up the pixel planes, the
    frame tables and the camera table (and the lane order's planes);
    the first launch misses each, every later one hits. A Renderer's
    images after its first hit throughout, as do a new Renderer's."""
    st, cfg = flatten_scene(_scene(), "cpu")
    before = _counts()
    ci.regen_args(st, cfg, 0, 4)
    assert np.subtract(_counts(), before).tolist() == [0, 3]
    perm = morton_layout(cfg.width, cfg.height, "cpu")[0]
    ci.regen_args(st, cfg, 0, 4, perm)
    assert np.subtract(_counts(), before).tolist() == [3, 4]
    ci.regen_args(st, cfg, 0, 4, perm)
    assert np.subtract(_counts(), before).tolist() == [7, 4]

    li.MEMO.clear()
    scene = _scene(iters=4)
    r = Renderer(scene, device="cpu", regen_frames=4)
    before = _counts()
    r.render()
    assert np.subtract(_counts(), before).tolist() == [0, 3]
    for renderer in (r, Renderer(scene, device="cpu", regen_frames=4)):
        renderer.reset()
        renderer.render()
    assert np.subtract(_counts(), before).tolist() == [6, 3]
