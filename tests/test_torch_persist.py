"""The port's persistent render (``render_persistent`` over the plain
version of ``run_persist``) against the reference package's
``render_persistent``, run as its own tests run it (``interpret=True``,
eager ring refill), and against the port's own regen path.

Tolerances: the ring variant restarts from host-raygen primaries and
carries one radiance accumulator per lane through its frames, as
``run_regen_plain`` does, so it is bit-identical to it; against the
reference's ring on the periscope (deterministic paths) it agrees to
1e-5 of the image scale. Free-running restarts recompute raygen from the
camera table (the reference multiplies by reciprocals and takes rsqrt,
the port divides and takes a rounded 1/sqrt), so restart primaries sit
ulps apart: on the periscope at least 99% of pixels agree to 1e-4 rel,
and the 3-bounce Cornell box is held to the reference's own coin-flip
envelope (tests/test_persist.py:132-154). Launch splits, the single-frame
render and abort/resume are bit-identical within the port.
"""

import numpy as np
import pytest
import torch

from spectral_tpu.render.pallas_integrator import render_persistent as jax_persist
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import camera as tcam
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from spectral_tpu_torch.scene import presets
from tests.test_pallas_megakernel import _periscope_scene

torch.set_num_threads(1)


def _cornell(w=32, h=24, bounces=4, iters=8, P=presets):
    """The Cornell box, built with the port's presets (``P=jax_presets``
    for the reference's)."""
    scene = P.PRESETS["cornell"](n_samples=8)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _periscope(iters=6):
    scene = _periscope_scene()
    scene.nbr_of_iterations = iters
    return scene


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg, tuple(np.asarray(arrays.obj_type).tolist())


def _port(scene):
    port, cfg = flatten_scene(scene, "cpu")
    return port, cfg, mk.pack_tables(port, cfg)


def _rel_err(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return np.abs(got - want).max(axis=-1) / scale


# ------------------------------------------------- ring: bit-exact to regen


@pytest.mark.parametrize("ring,budget", [(2, 5), (8, 64)])
def test_ring_persist_bit_identical_to_regen_plain(ring, budget):
    """W=2, budget 5: lanes stall on `lead` over many launches; W=8,
    budget 64: one launch does it all."""
    port, cfg, tb = _port(_cornell())
    n_frames = 6
    want = (ci.integrate_frames_cuda_regen(port, cfg, 0, n_frames, tb) / n_frames).numpy()
    got, info = ci.render_persistent(port, cfg, n_frames, tb, ring_slots=ring, budget=budget)
    assert info["frames_done"] >= n_frames and info["ring_slots"] == ring
    assert (got.numpy() == want).all()


def test_ring_persist_matches_jax_ring_on_periscope():
    arrays, config, port, cfg, obj_types = _pair(_periscope())
    want, jinfo = jax_persist(arrays, config, obj_types, n_frames=6, interpret=True,
                              ring_slots=4, budget=13, jit_refill=False)
    got, info = ci.render_persistent(port, cfg, 6, ring_slots=4, budget=13)
    want = np.asarray(want)
    assert float(want.max()) > 0.1  # the mirror chain is really traced
    assert float(_rel_err(got.numpy(), want).max()) <= 1e-5
    assert info["frames_done"] == jinfo["frames_done"] == 6


# ------------------------------------------------------------ free-running


def test_free_running_matches_jax_on_periscope():
    """budget=None on both sides: the one-frame cost probe picks the same
    budget (the periscope's paths are deterministic), then the images
    agree to 1e-4 rel on at least 99% of pixels (measured: all of them)."""
    arrays, config, port, cfg, obj_types = _pair(_periscope())
    want, jinfo = jax_persist(arrays, config, obj_types, n_frames=6, interpret=True,
                              ring_slots=0, budget=None)
    got, info = ci.render_persistent(port, cfg, 6)
    assert info["budget"] == jinfo["budget"]
    err = np.abs(got.numpy() - np.asarray(want)).max(axis=-1) / np.maximum(
        np.abs(np.asarray(want)).max(axis=-1), 1e-6)
    share = float((err <= 1e-4).mean())
    assert share >= 0.99, f"{share:.4f} of pixels within 1e-4 rel"


def test_free_running_within_jax_coinflip_envelope_on_cornell():
    """The reference's envelope for free-running against another raygen
    program (tests/test_persist.py:132-154): at most half the pixels of a
    6-frame 3-bounce Cornell average diverge by more than 1e-3."""
    arrays, config, port, cfg, obj_types = _pair(_cornell(bounces=3, P=jax_presets))
    want, _ = jax_persist(arrays, config, obj_types, n_frames=6, tile=256,
                          interpret=True, ring_slots=0, budget=64)
    got, _ = ci.render_persistent(port, cfg, 6, budget=64)
    err = _rel_err(got.numpy(), np.asarray(want))
    assert (err > 1e-3).sum() <= 0.5 * err.size
    assert (err <= 1e-3).sum() >= 0.5 * err.size


def test_free_running_launch_split_invariant():
    port, cfg, tb = _port(_cornell())
    imgs = []
    for budget in (11, 64):
        rgb, info = ci.render_persistent(port, cfg, 6, tb, budget=budget)
        assert info["frames_done"] >= 6
        imgs.append(rgb.numpy())
    assert (imgs[0] == imgs[1]).all()


@pytest.mark.parametrize("ring", [0, 2])
def test_single_frame_is_the_mono_frame(ring):
    """n_frames=1: no restart is owed, so the image is run_mono_plain's."""
    port, cfg, tb = _port(_cornell(16, 8, bounces=3))
    want = ci.integrate_frame_cuda(port, cfg, 0, tb).numpy()
    got, _ = ci.render_persistent(port, cfg, 1, tb, ring_slots=ring, budget=5)
    assert (got.numpy() == want).all()


def test_restart_directions_twin_host_raygen_and_the_jax_table():
    """The camera table equals the reference's pack_camera_basis to 2 ulp
    (XLA's tan is 1 ulp off at 60 degrees); restart raygen lands within a
    few ulps of host raygen, which divides where it multiplies."""
    from spectral_tpu.ops.pallas.megakernel import pack_camera_basis

    arrays, config, port, cfg, _ = _pair(_cornell(16, 8, P=jax_presets))
    table = tcam.camera_basis_table(port, cfg)
    assert table.shape == (tcam.CAM_BASIS,) and table.dtype == torch.float32
    np.testing.assert_allclose(table.numpy(), np.asarray(pack_camera_basis(arrays, config))[0],
                               rtol=3e-7, atol=0)
    for frame in (1, 5):
        _, d, px, py = tcam.generate_primary_rays(
            port.cam_pos, port.cam_dir, port.cam_up, port.fov_y_deg,
            cfg.width, cfg.height, frame, cfg.intended_frames)
        r = tcam.restart_directions(px, py, torch.full_like(px, frame), table)
        for a, b in zip(r, d):
            assert float((a - b).abs().max()) <= 4e-7


# ----------------------------------------------------------- abort, resume


def test_abort_then_resume_bit_identical():
    port, cfg, tb = _port(_cornell(16, 8, bounces=3))
    full, _ = ci.render_persistent(port, cfg, 8, tb, budget=4)
    part, info = ci.render_persistent(port, cfg, 8, tb, budget=4, should_abort=lambda: True,
                                      return_state=True)
    assert info["aborted"] and info["frames_done"] < 8 and info["launches"] == 1
    assert np.isfinite(part.numpy()).all() and float(part.max()) > 0.0
    resumed, info2 = ci.render_persistent(port, cfg, 8, tb, budget=4,
                                          resume_state=info["resume_state"])
    assert not info2["aborted"]
    assert torch.equal(resumed, full)
    with pytest.raises(ValueError, match="8-frame"):
        ci.render_persistent(port, cfg, 12, tb, resume_state=info["resume_state"])
    with pytest.raises(ValueError, match="adaptive"):
        ci.render_persistent(port, cfg, 8, tb, adaptive=(2, 0.1, 0.0),
                             resume_state=info["resume_state"])


def test_abort_drain_leaves_no_live_lane(monkeypatch):
    """The drain (end=0 launches) walks every in-flight path to its end,
    so the finished image holds no partial path: each pixel is exactly
    the mean of its first 1 or 2 frames (the reference's
    tests/test_persist.py:323 pattern; budget 1 maximizes mid-path aborts)."""
    port, cfg, tb = _port(_cornell(16, 8, bounces=3))
    kw = dict(budget=1, adaptive=(2, 0.0, 0.0))
    full1, _ = ci.render_persistent(port, cfg, 1, tb, **kw)
    full2, _ = ci.render_persistent(port, cfg, 2, tb, **kw)
    alive_at_finish = []
    finish = ci.persist_finish

    def spy(st, *a, **k):
        alive_at_finish.append(float(st.alive.max()))
        return finish(st, *a, **k)

    monkeypatch.setattr(ci, "persist_finish", spy)
    got, info = ci.render_persistent(port, cfg, 2, tb, should_abort=lambda: True, **kw)
    assert info["aborted"] and alive_at_finish == [0.0]
    counts = info["counts"].reshape(cfg.height, cfg.width)
    assert set(np.unique(counts)) <= {1, 2} and (counts == 1).any()
    g, f1, f2 = got.numpy(), full1.numpy(), full2.numpy()
    assert (g[counts == 1] == f1[counts == 1]).all()
    assert (g[counts == 2] == f2[counts == 2]).all()


def test_progress_and_preview():
    port, cfg, tb = _port(_cornell(16, 8, bounces=3))
    seen, previews = [], []
    rgb, info = ci.render_persistent(
        port, cfg, 5, tb, ring_slots=4, budget=9,
        progress=lambda done, launches: seen.append((done, launches)),
        preview=lambda make_rgb: previews.append(make_rgb().clone()))
    dones = [d for d, _ in seen]
    assert dones == sorted(dones)
    assert [n for _, n in seen] == list(range(1, len(seen) + 1))
    assert len(previews) == info["launches"] >= 2
    assert torch.equal(previews[-1], rgb)


def test_persist_rejects_what_the_reference_rejects():
    port, cfg, tb = _port(_cornell(8, 4, bounces=1))
    for kw, match in ((dict(ring_slots=3), "power of two"),
                      (dict(ring_slots=4, adaptive=(2, 0.1, 0.0)), "free-running"),
                      (dict(ring_slots=4, cost_sort=2), "free-running"),
                      (dict(adaptive=(1, 0.1, 0.0)), "min_frames"),
                      (dict(ring_slots=4, return_state=True), "free-running"),
                      (dict(cost_sort=2, return_state=True), "cost_sort")):
        with pytest.raises(ValueError, match=match):
            ci.render_persistent(port, cfg, 4, tb, budget=4, **kw)


# --------------------------------------------------------- wrapper contract


def test_run_persist_on_cpu_runs_the_plain_version_in_place():
    port, cfg, tb = _port(_cornell(8, 4, bounces=2))
    a = ci.persist_init(port, cfg)
    b = ci.persist_init(port, cfg)
    assert a.bl.dtype == a.fid.dtype == torch.int64 and a.px.dtype == torch.int32
    rad_buffer = a.rad
    cam = tcam.camera_basis_table(port, cfg)
    before = mk.run_persist.launches
    mk.run_persist(a, 4, 4, tb, cam, budget=3)
    mk.run_persist_plain(b, 4, 4, tb, cam, budget=3)
    assert mk.run_persist.launches == before
    assert a.rad is rad_buffer  # updated in place
    for name, t in a.planes().items():
        assert torch.equal(t, getattr(b, name)), name
    meta = ci.persist_init(port, cfg)
    meta.ox = meta.ox.to("meta")
    with pytest.raises(ValueError, match="no bounce kernel"):
        mk.run_persist(meta, 4, 4, tb, cam, budget=1)


@pytest.mark.parametrize("variant", ["free-running", "ring", "lane-stop"])
def test_plain_persist_per_pixel_state_ignores_the_lane_order(variant):
    """What any regrouping of the persist lanes relies on: the carried
    state of a pixel after two launches is the same bits whatever lane
    carries it. The state, ring planes and stop mask under a random
    pixel-to-lane permutation (numpy, seeded), un-permuted, equal the
    identity layout's, in every variant."""
    port, cfg, tb = _port(_cornell(16, 8, bounces=3, iters=6))
    n = cfg.width * cfg.height
    perm = torch.from_numpy(np.random.default_rng(7).permutation(n))
    inv = torch.argsort(perm)
    ring = stop = None
    lead, cam = cfg.intended_frames, tcam.camera_basis_table(port, cfg)
    if variant == "ring":
        ring = tuple(torch.zeros((4, n)) for _ in range(3))
        lead, cam = 4, tb.cam
        for f in range(1, lead):
            ci.ring_refill(ring, f, port, cfg)
    if variant == "lane-stop":
        stop = torch.from_numpy((np.random.default_rng(3).random(n) < 0.3).astype(np.float32))
    want = ci.persist_init(port, cfg)
    got = ci.persist_init(port, cfg, lane_perm=perm)
    for _ in range(2):
        mk.run_persist_plain(want, lead, cfg.intended_frames, tb, cam, ring=ring, stop=stop,
                             budget=5)
        mk.run_persist_plain(got, lead, cfg.intended_frames, tb, cam,
                             ring=None if ring is None else tuple(r[:, perm] for r in ring),
                             stop=None if stop is None else stop[perm], budget=5)
    assert int(want.fid.max()) >= 1  # lanes restarted
    for name, t in got.planes().items():
        assert torch.equal(t[..., inv], getattr(want, name)), name
