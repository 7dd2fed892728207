"""Row-sharded rendering on the CPU: the port's mesh (``parallel/mesh.py``)
and sharded renders (``parallel/sharding.py``, ``Renderer(sharding=)``)
against the JAX package's, and against the port's own unsharded render.

Tolerances: a slab's raygen is its unsharded rows' exactly (the slab's
lanes carry global rows, the camera table the whole image's height), so
a sharded render equals the unsharded one bit for bit on every path:
regeneration (with Morton lanes per slab for a clustered scene), frame
by frame, depth of field and persist. Against the JAX package's sharded
render the tolerance is its own test's, ``atol=1e-5``
(``tests/test_renderer.py:158-169``), on 1-bounce renders, whose paths
are deterministic, through a camera whose raygen the two packages
compute bit for bit (``_camera``: at the presets' 60 degrees the
focal distance's ``tan`` differs by 2 ulp, ``tests/
test_torch_camera_color.py``). The sharded persist twins of
``tests/test_sharded_persist.py`` keep its 1-bounce, 1e-4 envelope
against the reference's ``render_persistent_sharded``, run as its tests
run it (8 virtual devices, ``interpret=True``).
"""

import numpy as np
import pytest
import torch

from spectral_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spectral_tpu.parallel.mesh import row_sharding as jax_row_sharding
from spectral_tpu.parallel.sharding import render_persistent_sharded as jax_persist_sharded
from spectral_tpu.render.camera import generate_primary_rays as jax_raygen
from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.parallel import distributed
from spectral_tpu_torch.parallel import mesh as pmesh
from spectral_tpu_torch.parallel.mesh import make_mesh, row_sharding
from spectral_tpu_torch.parallel.sharding import render_persistent_sharded, shard_scene
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.camera import (
    camera_basis_table,
    generate_primary_rays,
    pixel_coords,
)
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes as ts

torch.set_num_threads(1)


def _camera(scene):
    """The camera of ``tests/test_torch_camera_color.py``'s bit-equal
    primaries: fov 45 degrees, looking a little to the side and down."""
    scene.camera.fov_y_deg = 45.0
    scene.camera.direction = (0.2, -0.1, 1.0)
    return scene


def _cpu_sharding(n=8):
    return row_sharding(make_mesh(n, device="cpu"))


def _render(scene, n=None, **kw):
    if n:
        kw["sharding"] = _cpu_sharding(n)
    return Renderer(scene, device="cpu", **kw).render()


# ------------------------------------------------------------------- mesh


def test_mesh_on_the_cpu():
    m = make_mesh(8, device="cpu")
    assert m.size == 8 and pmesh.ROW_AXIS == "rows"
    assert [s.index for s in m.slots] == list(range(8))
    assert all(s.device == torch.device("cpu") and s.rank == 0 for s in m.slots)
    assert m.local_slots() == m.slots
    assert make_mesh(device="cpu").size == 1  # one slot per device
    assert pmesh.row_sharding(m).mesh is m and pmesh.replicated(m).mesh is m
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without CUDA")
def test_mesh_never_falls_back_to_the_cpu():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        make_mesh(4)
    with pytest.raises(RuntimeError):
        make_mesh(4, device="cuda")


def test_renderer_refuses_a_mesh_of_another_device():
    sc = ts.preset(presets, "cornell", 8, 8, 1)
    with pytest.raises(ValueError, match="mesh"):
        # a cpu mesh for a card renderer: refused before any device use
        Renderer(sc, device="cuda", sharding=_cpu_sharding(2))


# ------------------------------------------------------------ slab raygen


@pytest.mark.parametrize("offset,rows", [(0, 6), (6, 6), (18, 6), (8, 16)])
def test_slab_raygen_matches_reference(offset, rows):
    w, full_h = 16, 24
    sc = _camera(ts.preset(presets, "cornell", w, full_h, 1, iters=5))
    st, cfg = flatten_scene(sc, "cpu")
    arrays, _ = jax_flatten(_camera(ts.preset(jax_presets, "cornell", w, full_h, 1, iters=5)))
    for frame in (0, 3):
        o, d, px, py = generate_primary_rays(
            st.cam_pos, st.cam_dir, st.cam_up, st.fov_y_deg, w, rows, frame,
            cfg.intended_frames, full_height=full_h, row_offset=offset)
        jo, jd, jpx, jpy = jax_raygen(
            arrays.cam_pos, arrays.cam_dir, arrays.cam_up, arrays.fov_y_deg, w, rows,
            np.uint32(frame), cfg.intended_frames, full_height=full_h, row_offset=offset)
        assert np.array_equal(px.numpy(), np.asarray(jpx))
        assert np.array_equal(py.numpy(), np.asarray(jpy))
        for a, b in zip((*o, *d), (*jo, *jd)):
            assert np.array_equal(np.broadcast_to(a.numpy(), (w * rows,)), np.asarray(b))
        # and the slab is its rows of the whole image, bit for bit
        _, d_all, _, py_all = generate_primary_rays(
            st.cam_pos, st.cam_dir, st.cam_up, st.fov_y_deg, w, full_h, frame,
            cfg.intended_frames)
        rows_of = slice(offset * w, (offset + rows) * w)
        assert torch.equal(py, py_all[rows_of])
        for a, b in zip(d, d_all):
            assert torch.equal(a, b[rows_of])


def test_slab_camera_table_and_pixels():
    sc = ts.preset(presets, "cornell", 16, 24, 1)
    st, cfg = flatten_scene(sc, "cpu")
    import dataclasses

    slab = dataclasses.replace(cfg, height=6)
    assert torch.equal(camera_basis_table(st, slab, full_height=24), camera_basis_table(st, cfg))
    px, py = pixel_coords(16, 6, "cpu", row_offset=12)
    assert int(py.min()) == 12 and int(py.max()) == 17 and torch.equal(px[:16], torch.arange(16))
    # row_offset=0 and full_height=height are today's code, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(pixel_coords(16, 24, "cpu"),
                                                  pixel_coords(16, 24, "cpu", 0)))


# --------------------------------------------------- renders against JAX


@pytest.mark.parametrize("name", ["default", "cornell"])
@pytest.mark.parametrize("regen", [1, "auto"])
def test_sharded_render_matches_reference_sharded(regen, name):
    want = JaxRenderer(_camera(ts.preset(jax_presets, name, 16, 24, 1, iters=3)),
                       sharding=jax_row_sharding(jax_make_mesh(8))).render()
    got = _render(_camera(ts.preset(presets, name, 16, 24, 1, iters=3)), 8,
                  regen_frames=regen)
    assert got.shape == want.shape == (24, 16, 4)
    assert np.allclose(got, want, atol=1e-5)


# ------------------------------------------------- sharded against unsharded


@pytest.mark.parametrize("case", ["regen", "mono", "ragged_tail", "dof", "clustered_morton"])
def test_sharded_render_equals_unsharded(case):
    kw = {}
    n = 4
    if case == "clustered_morton":
        def make():
            return ts.sphere_field(presets, 80, 16, 16, 2, iters=3)
    elif case == "dof":
        def make():
            return ts.with_lens(ts.preset(presets, "cornell", 16, 16, 3, iters=3))
    else:
        def make():
            return ts.preset(presets, "cornell", 16, 16, 3, iters=5)
        kw = {"regen": {}, "mono": {"regen_frames": 1},
              "ragged_tail": {"regen_frames": 2}}[case]
        n = 8
    want = _render(make(), **kw)
    r = Renderer(make(), device="cpu", sharding=_cpu_sharding(n), **kw)
    if case == "clustered_morton":
        assert r.clusters is not None and r.lane_layout == "morton"
        assert all(sl.lane_perm is not None and sl.lane_perm.numel() == 16 * 4
                   for sl in r._slabs)
    got = r.render()
    assert np.array_equal(got, want)


def test_sharded_checkpoint_gathers_and_splits(tmp_path):
    def make():
        return ts.preset(presets, "cornell", 16, 16, 2, iters=4)

    want = _render(make(), regen_frames=1)
    r = Renderer(make(), device="cpu", regen_frames=1, sharding=_cpu_sharding(4))
    r.render_frames(2)
    ckpt = tmp_path / "s.npz"
    r.save_checkpoint(ckpt)
    assert np.load(ckpt)["accum"].shape == (16, 16, 4)
    r2 = Renderer(make(), device="cpu", regen_frames=1, sharding=_cpu_sharding(2))
    r2.load_checkpoint(ckpt)
    assert r2.next_frame == 2
    assert np.array_equal(r2.render(), want)


# --------------------------------------------------------------- refusals


def test_sharding_rejects_indivisible_height():
    sc = ts.preset(presets, "cornell", 16, 12, 1)
    with pytest.raises(ValueError, match="divisible"):
        Renderer(sc, device="cpu", sharding=_cpu_sharding(8))


@pytest.mark.parametrize("kw", [
    dict(phase_split=1), dict(regen_sort=True), dict(frames_per_dispatch=2),
    dict(accel="grid"),
], ids=["phase_split", "regen_sort", "frames_per_dispatch", "grid"])
def test_sharding_refuses_what_the_reference_refuses(kw):
    sc = ts.preset(presets, "cornell", 16, 16, 2, iters=4)
    with pytest.raises(ValueError):
        Renderer(sc, device="cpu", sharding=_cpu_sharding(2), **kw)


def test_sharding_refuses_a_scene_schedule():
    sc = ts.preset(presets, "cornell", 16, 16, 1)
    with pytest.raises(ValueError, match="schedule"):
        Renderer(sc, device="cpu", sharding=_cpu_sharding(2),
                 _scene_schedule=lambda f: None)


# ------------------------------------------ sharded persist (the twins)


def _setup(w=16, h=16, bounces=1, samples=8, iters=8):
    sc = ts.preset(presets, "cornell", w, h, bounces, iters=iters, samples=samples)
    st, cfg = flatten_scene(sc, "cpu")
    jsc = ts.preset(jax_presets, "cornell", w, h, bounces, iters=iters, samples=samples)
    arrays, jcfg = jax_flatten(jsc)
    jax_args = (arrays, jcfg, tuple(np.asarray(arrays.obj_type).tolist()))
    jax_kw = dict(interpret=True, has_transmission=bool(np.asarray(arrays.transmission).any()),
                  has_emission=bool(np.asarray(arrays.emission).any()))
    return st, cfg, jax_args, jax_kw


def _port_sharded(st, cfg, n, **kw):
    mesh = make_mesh(n, device="cpu")
    slabs = shard_scene(st, row_sharding(mesh), cfg)
    rgb, info = render_persistent_sharded(slabs, cfg, mesh, **kw)
    return distributed.fetch_global(rgb), info


def test_sharded_persist_matches_reference_sharded():
    st, cfg, jax_args, jax_kw = _setup()
    want, _ = jax_persist_sharded(*jax_args, jax_make_mesh(8), n_frames=4, tile=256,
                                  budget=12, **jax_kw)
    got, info = _port_sharded(st, cfg, 8, n_frames=4, budget=12)
    single, _ = ci.render_persistent(st, cfg, 4, budget=12)
    assert info["n_devices"] == 8
    assert info["min_reductions"] == info["launches"]  # one MIN per launch
    assert got.shape == np.asarray(want).shape == (16, 16, 3)
    assert np.abs(got - np.asarray(want)).max() < 1e-4
    assert np.array_equal(got, single.numpy())  # and the port's own, bit for bit


def _abort_on_call(k):
    """A ``should_abort`` that asks on its ``k``-th call (once per launch)."""
    calls = []
    return lambda: calls.append(1) or len(calls) >= k


@pytest.mark.parametrize("kw", [
    pytest.param(dict(bounces=1, iters=4, budget=12), id="plain"),
    pytest.param(dict(bounces=4, iters=16, budget=3, adaptive=(2, 1e9, 1e9)), id="adaptive"),
    pytest.param(dict(bounces=2, iters=6, budget=2, abort=2), id="abort"),
])
def test_one_slot_persist_is_the_unsharded_loop(kw):
    """A one-slot mesh is one set of lanes, the whole image's, in the one
    persist loop: the sharded render makes the unsharded render's
    launches, its repacks and its abort, bit for bit."""
    kw = dict(kw)
    bounces, iters, abort = kw.pop("bounces"), kw.pop("iters"), kw.pop("abort", None)
    st, cfg, _, _ = _setup(bounces=bounces, iters=iters)

    def run(render):
        stop = _abort_on_call(abort) if abort else None
        return render(n_frames=iters, should_abort=stop, **kw)

    want, info_w = run(lambda **k: ci.render_persistent(st, cfg, **k))
    got, info_g = run(lambda **k: _port_sharded(st, cfg, 1, **k))
    assert np.array_equal(got, want.numpy())
    for key in ("launches", "frames_done", "aborted", "compactions", "budget"):
        assert info_g.get(key) == info_w.get(key), key
    assert info_g["min_reductions"] == info_g["launches"]
    if "adaptive" in kw:
        assert info_w["compactions"] >= 1  # the repack ran, in both
        assert np.array_equal(info_g["counts"], info_w["counts"])
    if abort:
        assert info_w["aborted"] and info_w["launches"] == abort


def test_sharded_persist_adaptive_stops():
    st, cfg, jax_args, jax_kw = _setup(iters=16)
    _, want = jax_persist_sharded(*jax_args, jax_make_mesh(8), n_frames=16, tile=256,
                                  budget=4, adaptive=(3, 1e9, 1e9), **jax_kw)
    rgb, info = _port_sharded(st, cfg, 8, n_frames=16, budget=4, adaptive=(3, 1e9, 1e9))
    assert info["min_counts"] >= 3 and info["max_counts"] < 16
    assert info["counts"].shape == (cfg.width * cfg.height,)
    assert np.array_equal(info["counts"], want["counts"])  # in global pixel order
    assert np.isfinite(rgb).all()


def test_sharded_compaction_is_bit_exact():
    st, cfg, _, _ = _setup(bounces=4, iters=16)
    kw = dict(n_frames=16, budget=3, adaptive=(2, 1e9, 1e9))
    plain, info_p = _port_sharded(st, cfg, 8, compact=False, **kw)
    packed, info_c = _port_sharded(st, cfg, 8, compact=True, **kw)
    assert info_p["compactions"] == 0 and info_c["compactions"] >= 1
    assert np.array_equal(plain, packed)
    assert np.array_equal(info_p["counts"], info_c["counts"])


def test_renderer_sharded_persist():
    def make():
        return ts.preset(presets, "cornell", 16, 16, 1, iters=4)

    want = Renderer(make(), device="cpu", persist=True, persist_budget=12).render()
    r = Renderer(make(), device="cpu", persist=True, sharding=_cpu_sharding(8))
    got = r.render()  # the default budget: the cost probe on the slabs
    assert r.persist_info["n_devices"] == 8 and r.persist_info["budget"] >= 8
    assert np.abs(got - want).max() < 1e-4


def test_sharded_persist_validates_height():
    st, cfg, _, _ = _setup(h=12)
    with pytest.raises(ValueError, match="divisible"):
        _port_sharded(st, cfg, 8, n_frames=2, budget=8)


def test_sharded_persist_abort_drains_and_refuses_checkpoint(tmp_path):
    sc = ts.preset(presets, "cornell", 16, 16, 2, iters=6)
    r = Renderer(sc, device="cpu", persist=True, persist_budget=2, sharding=_cpu_sharding(8))
    got = r.render(abort=lambda: True)
    assert r.persist_info["aborted"]
    assert np.isfinite(got).all() and got.max() > 0.0
    with pytest.raises(ValueError, match="sharded persist"):
        r.save_checkpoint(tmp_path / "never_written.npz")
    assert not (tmp_path / "never_written.npz").exists()


def test_sharded_persist_refuses_depth_of_field():
    sc = ts.with_lens(ts.preset(presets, "cornell", 16, 16, 1))
    st, cfg = flatten_scene(sc, "cpu")
    with pytest.raises(ValueError, match="depth of field"):
        mesh = make_mesh(2, device="cpu")
        render_persistent_sharded(shard_scene(st, row_sharding(mesh), cfg), cfg, mesh,
                                  n_frames=2, budget=8)
