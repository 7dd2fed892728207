"""Keyframe animation and motion blur in the port (``render/animation.py``
and ``Renderer(_scene_schedule=)``) against the JAX package on the CPU.

Exact: track values, orbit keys, the JSON form, every frame's flattened
tables (``scene_at``) and the shutter stream (``_vdc_base3``). Renders on
the plain versions of the kernels: ``render_animation`` equals per-frame
``Renderer`` renders bit for bit, on one device or dealt over two; a
motion-blurred direct-only render equals the reference's within 1e-5 of
the image scale, the renderer twins' tolerance
(``test_torch_renderer.py``); static tracks under a shutter reproduce the
unblurred render exactly.

The clustered walk under a schedule: a track moves one sphere of
``sphere_field(100)`` out of its cluster's first bound, and each frame's
tables, walked as the kernels walk them (``test_torch_packed_walk``'s
plain walk over the run bounds and packed records), must find what the
flat trace finds. Tables packed once, from the first scene, cull the
moved sphere and fail it.
"""

import json

import numpy as np
import pytest
import torch

from spectral_tpu.render import animation as janim
from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene import schema as jschema
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import geometry as tgeom
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import animation as tanim
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render import image as timage
from spectral_tpu_torch.render.integrator import FX_TRANSMISSION
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import FIELDS, flatten_numpy
from spectral_tpu_torch.scene.schema import SceneError, Sphere
from tests import torch_scenes as ts
from tests.test_torch_packed_walk import _walk_packed

torch.set_num_threads(1)


def _small_scene(P=presets, w=16, h=12, iters=2, bounces=2):
    scene = P.default_scene()
    scene.width, scene.height = w, h
    scene.nbr_of_iterations = iters
    scene.nbr_of_ray_bounces = bounces
    return scene


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _tracks(A):
    return [
        A.Track("camera.position", [(0.0, (0, 0, -4)), (1.0, (0, 0, -2))]),
        A.Track("camera.fov_y_deg", [(0.0, 40.0), (1.0, 80.0)]),
        A.Track("objects[0].position", [(0.0, (0, 0, 2)), (1.0, (2, 0, 2))]),
        A.Track("objects[0].object_type.radius", [(0.0, 0.5), (1.0, 1.5)]),
        A.Track("lights[0].position", [(0.0, (0, 2, 0)), (1.0, (0, 4, 0))]),
        A.Track("materials[0].roughness", [(0.0, 0.0), (1.0, 1.0)]),
        A.Track("materials[1].transmission", [(0.0, 0.0), (1.0, 0.5)]),
    ]


def _animation(A, P, n_frames=3):
    scene = _small_scene(P)
    scene.objects[0].object_type = (Sphere if P is presets else jschema.Sphere)(radius=1.0)
    return A.Animation(scene, n_frames=n_frames, tracks=_tracks(A))


# ------------------------------------------------------------ host copies

def test_track_values_equal_the_reference():
    for tp, tj in zip(_tracks(tanim), _tracks(janim)):
        for t in (-0.5, 0.0, 0.2, 0.5, 0.77, 1.0, 2.0):
            assert tp.value_at(t) == tj.value_at(t), (tp.path, t)
    with pytest.raises(ValueError):
        tanim.Track("camera.fov_y_deg", [])
    with pytest.raises(ValueError):
        tanim.Track("camera.fov_y_deg", [(0.5, 1.0), (0.2, 2.0)])
    with pytest.raises(ValueError):
        tanim.Track("camera.position", [(0.0, (1, 2))]).value_at(0.0)


def test_scene_at_flattens_to_the_reference_tables():
    got, want = _animation(tanim, presets, 5), _animation(janim, jax_presets, 5)
    for f in range(5):
        fields = flatten_numpy(got.scene_at(f))[0]
        ref = jax_flatten(want.scene_at(f))[0].host.np_fields
        for name in FIELDS:
            assert (fields[name] is None and ref[name] is None) or _bits(
                fields[name], ref[name]), (f, name)
    for t in (0.0, 0.13, 0.5, 1.0):
        assert _bits(flatten_numpy(got.scene_at_time(t))[0]["sphere_pos"],
                     jax_flatten(want.scene_at_time(t))[0].host.np_fields["sphere_pos"])
    assert got.scene.objects[0].object_type.radius == 1.0  # the base is untouched


def test_scene_at_rejects_bad_paths_and_frames():
    scene = _small_scene()
    for path, value in (("camera.nope", 1.0), ("objects[99].position", (0, 0, 0)),
                        ("objects[0].object_type.radius", 1.0)):
        with pytest.raises(ValueError):
            tanim.Animation(scene, 2, [tanim.Track(path, [(0, value)])]).scene_at(0)
    with pytest.raises(ValueError):
        tanim.Animation(scene, 2).scene_at(2)
    with pytest.raises(ValueError):
        tanim.Animation(scene, 0)
    one = tanim.Animation(scene, 1, [tanim.Track("camera.fov_y_deg", [(0.0, 10.0), (1.0, 99.0)])])
    assert one.scene_at(0).camera.fov_y_deg == 10.0


@pytest.mark.parametrize("degrees,n,center", [(360.0, 9, (0, 1, 0)), (180.0, 5, (0, 0, 0)),
                                              (-45.0, 4, (0.3, -0.2, 1.0))])
def test_orbit_tracks_equal_the_reference(degrees, n, center):
    got = tanim.orbit_tracks(_small_scene(), degrees=degrees, n_frames=n, center=center)
    want = janim.orbit_tracks(_small_scene(jax_presets), degrees=degrees, n_frames=n,
                              center=center)
    assert [(t.path, t.keys) for t in got] == [(t.path, t.keys) for t in want]
    with pytest.raises(ValueError):
        tanim.orbit_tracks(_small_scene(), center=_small_scene().camera.position, n_frames=2)


def test_animation_json_equals_the_reference_and_round_trips(tmp_path):
    got, want = _animation(tanim, presets), _animation(janim, jax_presets)
    assert json.dumps(tanim.animation_to_dict(got)) == json.dumps(janim.animation_to_dict(want))
    p = tmp_path / "anim.json"
    janim.save_animation(want, p)
    loaded = tanim.load_animation(p)
    assert (loaded.n_frames, loaded.fps, [t.path for t in loaded.tracks]) == (
        3, 12.0, [t.path for t in want.tracks])
    assert _bits(flatten_numpy(loaded.scene_at(1))[0]["cam_pos"],
                 flatten_numpy(got.scene_at(1))[0]["cam_pos"])
    with pytest.raises(ValueError):
        tanim.animation_from_dict({"n_frames": 2, "tracks": []})
    override = _small_scene(w=8, h=8)
    assert tanim.animation_from_dict(tanim.animation_to_dict(got), scene=override).scene.width == 8


def test_vdc_base3_and_transmission_flag_equal_the_reference():
    assert [tanim._vdc_base3(n) for n in range(200)] == [janim._vdc_base3(n) for n in range(200)]
    for keys in ([(0.0, 0.0), (1.0, 0.8)], [(0.0, 0.0), (1.0, 0.0)]):
        got = tanim._tracks_can_enable(
            tanim.Animation(_small_scene(), 2, [tanim.Track("materials[0].transmission", keys)]),
            "transmission")
        want = janim._tracks_can_enable(
            janim.Animation(_small_scene(jax_presets), 2,
                            [janim.Track("materials[0].transmission", keys)]), "transmission")
        assert got == want == (keys[1][1] > 0)


def test_save_gif_round_trip(tmp_path):
    from PIL import Image

    frames = np.zeros((3, 8, 8, 3), np.uint8)
    frames[1], frames[2] = 128, 255
    with Image.open(tanim.save_gif(frames, tmp_path / "a.gif", fps=10)) as im:
        assert im.n_frames == 3
    with pytest.raises(ValueError):
        tanim.save_gif(np.zeros((8, 8, 3), np.uint8), tmp_path / "b.gif")


# -------------------------------------------------------------- rendering

def test_render_animation_matches_per_frame_renders(tmp_path):
    anim = tanim.Animation(_small_scene(iters=2), n_frames=3, tracks=[
        tanim.Track("camera.position", [(0.0, (0, 0, -4)), (1.0, (0.5, 0, -4))])])
    calls = []
    frames = tanim.render_animation(anim, devices=["cpu"], out_dir=tmp_path,
                                    progress=lambda d, t: calls.append((d, t)))
    assert frames.shape == (3, 12, 16, 3) and frames.dtype == np.uint8
    assert calls[-1] == (3, 3) and len(calls) == 3
    for f in range(3):
        assert (tmp_path / f"frame_{f:04d}.png").exists()
        fb = Renderer(anim.scene_at(f), device="cpu").render()
        assert _bits(frames[f], timage.accum_to_u8(fb)[..., :3])
    assert (frames[0] != frames[2]).any()
    assert _bits(tanim.render_animation(anim, devices=["cpu", "cpu"]), frames)


def test_render_animation_rejects_config_changes():
    anim = tanim.Animation(_small_scene(), 2)
    anim.scene_at = lambda f: _small_scene(w=16 + 4 * f)
    with pytest.raises(SceneError):
        tanim.render_animation(anim, devices=["cpu"])
    with pytest.raises(ValueError):
        tanim.render_animation(tanim.Animation(_small_scene(), 1), devices=["cpu"], shutter=-1)


def _schedule(A, anim, frame, shutter, flatten):
    cfg0 = flatten(anim.scene_at(frame))[1]
    return A._motion_blur_schedule(anim, frame, shutter, cfg0, lambda s: s)


def test_motion_blur_equals_the_reference():
    """A sphere sweeping across the view, 1 bounce (deterministic), each
    iteration from its own shutter time: the port's schedule and Renderer
    against the reference's, frame by frame."""
    def anim(A, P):
        return A.Animation(_small_scene(P, w=24, h=16, iters=6, bounces=1), n_frames=3, tracks=[
            A.Track("objects[0].position", [(0.0, (-1.5, 0.0, 2.0)), (1.0, (1.5, 0.0, 2.0))])])

    got_anim, want_anim = anim(tanim, presets), anim(janim, jax_presets)
    for frame in (0, 1):
        sched = _schedule(tanim, got_anim, frame, 0.5, flatten_numpy)
        got = Renderer(got_anim.scene_at(frame), device="cpu", _scene_schedule=sched).render()
        jsched = _schedule(janim, want_anim, frame, 0.5, jax_flatten)
        want = JaxRenderer(want_anim.scene_at(frame), backend="jnp",
                           _scene_schedule=jsched).render()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= 1e-5 * scale
        static = Renderer(got_anim.scene_at(frame), device="cpu", regen_frames=1).render()
        assert not np.array_equal(got, static)


def test_shutter_on_static_tracks_matches_unblurred():
    scene = _small_scene(iters=3)
    anim = tanim.Animation(scene, n_frames=2, tracks=[
        tanim.Track("camera.fov_y_deg", [(0.0, 60.0), (1.0, 60.0)])])
    plain = tanim.render_animation(anim, devices=["cpu"])
    assert _bits(tanim.render_animation(anim, devices=["cpu"], shutter=0.5), plain)
    sched = _schedule(tanim, anim, 0, 0.5, flatten_numpy)
    blurred = Renderer(anim.scene_at(0), device="cpu", _scene_schedule=sched).render()
    assert _bits(blurred, Renderer(anim.scene_at(0), device="cpu", regen_frames=1).render())


def test_motion_blur_spreads_a_moving_object():
    scene = _small_scene(w=24, h=16, iters=8, bounces=2)
    anim = tanim.Animation(scene, n_frames=1, tracks=[tanim.Track(
        "objects[0].position", [(0.0, (-1.5, 0.0, 2.0)), (1.0, (1.5, 0.0, 2.0))])])
    static = tanim.render_animation(anim, devices=["cpu"])
    blurred = tanim.render_animation(anim, devices=["cpu"], shutter=1.0)
    assert blurred.shape == static.shape and (blurred != static).any()


def test_schedule_refuses_the_fused_modes():
    scene = _small_scene()

    def sched(fid):
        raise AssertionError("never called")

    for kw in (dict(persist=True), dict(phase_split=1), dict(sharding=object()),
               dict(regen_frames=5)):
        with pytest.raises(ValueError):
            Renderer(scene, device="cpu", _scene_schedule=sched, **kw)
    assert Renderer(scene, device="cpu", _scene_schedule=sched).regen_frames == 1
    assert Renderer(scene, device="cpu", regen_frames=1, _scene_schedule=sched).regen_frames == 1


def test_schedule_takes_the_feature_build_once():
    """A track that raises transmission mid-shutter: the feature build is
    picked from the first scene and the schedule's flag, for every frame,
    although the first frames have no transmission."""
    scene = _small_scene(iters=4)
    anim = tanim.Animation(scene, n_frames=1, tracks=[
        tanim.Track("materials[0].transmission", [(0.0, 0.0), (1.0, 0.9)])])
    sched = _schedule(tanim, anim, 0, 1.0, flatten_numpy)
    r = Renderer(anim.scene_at(0), device="cpu", _scene_schedule=sched)
    assert r.tables.features & FX_TRANSMISSION
    assert not flatten_numpy(anim.scene_at(0))[0]["transmission"].any()
    for f in range(4):
        _st, tables = r.frame_tables(f)
        assert tables.features == r.tables.features
    img = r.render()
    assert np.isfinite(img).all() and float(img[..., :3].mean()) > 0.0


def test_clustered_frames_find_a_sphere_that_left_its_cluster():
    """Trouble 1: the first scene's plan, with each frame's own bounds and
    records. Sphere 1 of ``sphere_field(100)`` (object 0 is the floor)
    jumps early in the shutter to where the camera looks, out of its
    cluster's first bound; every frame's tables, walked as the kernels
    walk them, find what the flat trace finds, the moved sphere included;
    and the clustered render equals ``accel="none"`` bit for bit."""
    scene = ts.sphere_field(presets, 100, 32, 24, 2, iters=8)
    start = tuple(scene.objects[1].position)
    cam = np.asarray(scene.camera.position, np.float64)
    target = tuple(float(v) for v in cam + 2.5 * np.asarray(scene.camera.direction))
    anim = tanim.Animation(scene, n_frames=1, tracks=[
        tanim.Track("objects[1].position", [(0.0, start), (0.1, target)])])
    images = {}
    for accel in ("auto", "none"):
        sched = _schedule(tanim, anim, 0, 1.0, flatten_numpy)
        r = Renderer(anim.scene_at(0), device="cpu", accel=accel, _scene_schedule=sched)
        if accel == "auto":
            assert r.clusters is not None
            base = r.scene_tensors.np_fields["sphere_pos"][1]
            moved_hits = 0
            for f in range(8):
                st, tables = r.frame_tables(f)
                assert tables.clusters is r.tables.clusters
                assert torch.equal(tables.order, r.tables.order)
                planes, _, _ = ci.primary_lanes(st, r.config, f)
                origin, direction = Vec3(*planes[:3]), Vec3(*planes[3:])
                t, win = _walk_packed(st, tables.order.numpy(), tables.runs.numpy(),
                                      tables.packed.numpy(), origin, direction)
                want = tgeom.trace(origin, direction, st)
                assert torch.equal(win, torch.where(want.hit, want.obj_idx, -1)), f
                assert torch.equal(t[want.hit], want.t[want.hit]), f
                if not np.array_equal(st.np_fields["sphere_pos"][1], base):
                    moved_hits += int((win == 1).sum())
            assert moved_hits > 0, "the moved sphere is in view"
        images[accel] = r.render()
    assert _bits(images["auto"], images["none"])
