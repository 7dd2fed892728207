"""The phased/cascade path (``run_seg`` and the segment drivers) and the
many-object Renderer on the CPU, through the plain versions, against the
port's own mono path and the JAX package.

Scenes: ``sphere_field(80)`` (81 objects, so the clustered walk is
planned) at 24x16, 2-3 bounces. Tolerances:

* the two-segment split carries one radiance accumulator and every
  lane's arithmetic is its own: bit-identical to the mono frame;
* a cascade starts each segment from zero radiance and adds it back
  through the chain of extraction indices, so it sums in another order:
  the same lanes alive at every stage (exact), radiance within 1e-6 of
  the image scale (float32 rounding of a few terms);
* against the reference's jnp path: primary-bounce occupancy exact,
  later bounces within a 15% coin-flip envelope (diffuse self-hit coins
  flip between compilers, ``tests/test_torch_integrator.py``),
  direct-only renders within a 5% silhouette-pixel envelope and 1% in
  the mean, multi-bounce means within 5%.
"""

import numpy as np
import pytest
import torch

from spectral_tpu.render import integrator as jint
from spectral_tpu.render import renderer as jrender
from spectral_tpu.render.renderer import Renderer as JaxRenderer
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch import cli
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.render import renderer as trender
from spectral_tpu_torch.scene import presets
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes as ts

torch.set_num_threads(1)

N_SPHERES = 80


def _field(w=24, h=16, bounces=3, iters=4, P=presets):
    return ts.sphere_field(P, N_SPHERES, w, h, bounces, iters=iters)


def _port(**kw):
    port, cfg = flatten_scene(_field(**kw), "cpu")
    return port, cfg, mk.pack_tables(port, cfg)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, float(np.abs(want).max())))


# ------------------------------------------------------------ stage choice


def test_choose_stages_equals_the_reference():
    rng = np.random.default_rng(4)
    profiles = [np.array([1.0, 0.6, 0.2, 0.1, 0.05, 0.03, 0.02, 0.01]),
                np.array([1.0, 0.9, 0.85, 0.8]), np.array([1.0, 0.02])]
    for _ in range(6):
        occ = np.sort(rng.uniform(0.0, 1.0, int(rng.integers(2, 10))))[::-1]
        occ[0] = 1.0
        profiles.append(occ)
    for occ in profiles:
        for n_pad, tile in ((786432, 128), (49152, 128), (786432, 8192)):
            assert (trender.choose_stages(occ, n_pad, tile)
                    == jrender.choose_stages(occ, n_pad, tile)), (occ, n_pad, tile)


def test_occupancy_matches_the_reference():
    """Lanes entering each bounce at 48x32, 4 bounces, pooled over 2
    frames. All lanes enter bounce 0 and the primary hits bounce 1
    (geometry only: exact). Bounce 2 is decided by the un-offset diffuse
    continuation's self-hit coin, which the two compilers round apart:
    at most 15% of the lanes entering bounce 1 may fall the other way
    (measured 8.3%: 260 against 113 of 1780). From bounce 3 on the chains
    agree again, within the same 15% envelope (measured 53 against 48)."""
    kw = dict(w=48, h=32, bounces=4)
    arrays, config = jax_flatten(_field(P=jax_presets, **kw))
    port, cfg, _ = _port(**kw)
    want = sum(np.asarray(jint.integrate_frame(arrays, config, np.uint32(f),
                                               return_occupancy=True)[1]) for f in range(2))
    got = sum(tint.integrate_frame(port, cfg, f, return_occupancy=True)[1].numpy()
              for f in range(2))
    rgb, rays, hist = tint.integrate_frame(port, cfg, 0, return_stats=True,
                                           return_occupancy=True)
    assert rgb.shape == (32, 48, 3) and float(rays) > 0 and hist.shape == (4,)
    assert got[0] == want[0] == 2 * 48 * 32
    assert got[1] == want[1]
    assert abs(got[2] - want[2]) <= 0.15 * got[1]
    assert abs(got[3:].sum() / want[3:].sum() - 1.0) <= 0.15


# ------------------------------------------------------- split and cascade


@pytest.mark.parametrize("split", [1, 2])
def test_plain_split_is_mono_bit_for_bit(split):
    port, cfg, tb = _port()
    for frame in (0, 3):
        want = ci.integrate_frame_cuda(port, cfg, frame, tb)
        got = ci.integrate_frame_split(port, cfg, frame, split, tb)
        assert torch.equal(got, want)


def test_plain_segments_compose_to_the_mono_radiance():
    """run_seg over [0, 1) then [1, max) from one wavefront carries the
    mono frame's radiance bit for bit; dead lanes are left untouched."""
    port, cfg, tb = _port()
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    want = mk.run_mono(*planes, px, py, 1, tb)
    wf = ci.frame_wavefront(port, cfg, 1)
    mk.run_seg(wf, 0, 1, 1, tb)
    dead = wf.alive == 0.0
    frozen = {k: v[..., dead].clone() for k, v in wf.planes().items()}
    mk.run_seg(wf, 1, cfg.max_bounces, 1, tb)
    assert torch.equal(wf.rad, want)
    for k, v in frozen.items():
        assert torch.equal(getattr(wf, k)[..., dead], v), k
    with pytest.raises(ValueError, match="segment"):
        mk.run_seg(wf, 1, cfg.max_bounces + 1, 1, tb)


@pytest.mark.parametrize("stages", [((1, 384),), ((1, 384), (2, 256))])
def test_plain_cascade_tracks_the_mono_frame(stages):
    """Every stage holds exactly the lanes the full wavefront has alive at
    its split (ascending); the radiance is mono's to float32 rounding."""
    port, cfg, tb = _port()
    frame = 2
    mono = ci.integrate_frame_cuda(port, cfg, frame, tb).numpy()
    rgb, overflow, chains = ci.integrate_frame_cascade(port, cfg, frame, stages, tb,
                                                       return_chains=True)
    assert not bool(overflow)
    full = ci.frame_wavefront(port, cfg, frame)
    start = 0
    for (split, _cap), (chain, count) in zip(stages, chains):
        mk.run_seg(full, start, split, frame, tb)
        start = split
        live = torch.nonzero(full.alive > 0.0)[:, 0]
        assert int(count) == live.numel() > 0
        assert torch.equal(chain[:int(count)], live)
    assert _max_rel(rgb.numpy(), mono) <= 1e-6


def test_cascade_overflow_flag():
    """A capacity below the live count sets the flag on the device; the
    same stages with room leave it clear."""
    port, cfg, tb = _port()
    _, _, chains = ci.integrate_frame_cascade(port, cfg, 0, ((1, 384),), tb,
                                              return_chains=True)
    live = int(chains[0][1])
    assert 128 < live <= 384
    _, small = ci.integrate_frame_cascade(port, cfg, 0, ((1, 128),), tb)
    _, roomy = ci.integrate_frame_cascade(port, cfg, 0, ((1, live),), tb)
    assert small.dtype == torch.bool and bool(small) and not bool(roomy)
    # the single-split default capacity is the overflowing one here
    assert ci.default_phase_capacity(24 * 16) == 128
    assert ci.stage_capacities(((1, 1), (2, 10**9)), 24 * 16) == [128, 384]
    with pytest.raises(ValueError, match="increasing"):
        ci.integrate_frame_cascade(port, cfg, 0, ((2, 128), (1, 128)), tb)
    with pytest.raises(ValueError, match="inside"):
        ci.integrate_frame_cascade(port, cfg, 0, ((3, 128),), tb)


# ------------------------------------------------------------- Renderer


def test_phased_renderer_matches_mono_renderer():
    """phase_split=1 with room: the cascade frames equal the mono frames
    to float32 rounding, nothing overflows; a capacity below every
    frame's live count re-renders every frame on the mono path, counted,
    and the image is the mono render's bit for bit."""
    kw = dict(w=24, h=16, bounces=3, iters=3)
    want = trender.Renderer(_field(**kw), device="cpu", regen_frames=1).render()
    r = trender.Renderer(_field(**kw), device="cpu", phase_split=1, phase_capacity=384)
    assert r.regen_frames == 1 and r.phase_stages == ((1, 384),)
    got = r.render()
    assert r.overflow_frames == 0 and _max_rel(got, want) <= 1e-6
    r = trender.Renderer(_field(**kw), device="cpu", phase_split=1, phase_capacity=128)
    assert (r.render() == want).all() and r.overflow_frames == 3
    r = trender.Renderer(_field(**kw), device="cpu", phase_split=(1, 2),
                         phase_capacity=(384, 256))
    assert _max_rel(r.render(), want) <= 1e-6


def test_phased_renderer_pipelines_the_overflow_check(monkeypatch):
    """Frame f's flag is read after frame f+1 is queued; the last frame's
    on the way out; abort and checkpoint see every queued frame blended."""
    calls = []
    real = trender.integrate_frame_cascade

    def cascade(*a, **k):
        calls.append(("cascade", a[2]))
        return real(*a, **k)

    def blend(accum, rgb, fid):
        calls.append(("blend", fid))
        return tint.accumulate_frame(accum, rgb, fid)

    monkeypatch.setattr(trender, "integrate_frame_cascade", cascade)
    monkeypatch.setattr(trender, "accumulate_frame", blend)
    r = trender.Renderer(_field(iters=3), device="cpu", phase_split=1, phase_capacity=384)
    r.render_frames(2)
    assert calls == [("cascade", 0), ("cascade", 1), ("blend", 0), ("blend", 1)]
    calls.clear()
    r.render()
    assert calls == [("cascade", 2), ("blend", 2)] and r.next_frame == 3


def test_phase_auto_chooses_stages_from_the_probe():
    r = trender.Renderer(_field(w=48, h=32, bounces=4, iters=2), device="cpu",
                         phase_split="auto")
    occ = r.phase_occupancy
    assert occ.shape == (4,) and occ[0] == 1.0 and 0.0 < occ[1] < 1.0
    assert r.phase_stages == trender.choose_stages(occ, 48 * 32, mk.BLOCK)
    img = r.render()
    assert np.isfinite(img).all() and float(img[..., :3].mean()) > 0.0


@pytest.mark.parametrize("option,match", [
    (dict(phase_split=(1, 2)), "capacity"),
    (dict(phase_split=(1, 2), phase_capacity=(256,)), "capacities"),
    (dict(phase_split=3), "inside"),
    (dict(phase_split=2, persist=True), "standalone"),
    (dict(phase_split=2, regen_frames=2), "not phase_split"),
    (dict(regen_sort=True, regen_frames=1), "regen_sort"),
])
def test_phased_refusals(option, match):
    with pytest.raises(ValueError, match=match):
        trender.Renderer(_field(), device="cpu", **option)


def test_clustered_renderer_matches_the_reference_direct_only():
    """The many-object default path (clusters, regeneration, Morton
    lanes) against the reference's jnp Renderer, direct light only. A
    sphere's silhouette pixel is decided by the sign of the discriminant
    b*b - 4ac, which the two compilers round apart: at most 5% of pixels
    may be off by more than 1e-5 of the scale (measured 13 of 384), and
    the image mean is within 1%. Without clusters the port's image is the
    clustered one's bit for bit."""
    kw = dict(w=24, h=16, bounces=1, iters=3)
    r = trender.Renderer(_field(**kw), device="cpu")
    assert r.clusters is not None and r.lane_layout == "morton" and r.regen_frames == 3
    got = r.render()
    want = JaxRenderer(_field(P=jax_presets, **kw), backend="jnp").render()
    err = np.abs(got - want).max(-1) / max(1.0, float(np.abs(want).max()))
    assert float((err > 1e-5).mean()) <= 0.05
    assert abs(float(got[..., :3].mean()) / float(want[..., :3].mean()) - 1.0) <= 0.01
    flat = trender.Renderer(_field(**kw), device="cpu", accel="none")
    assert flat.clusters is None and flat.lane_layout == "rowmajor"
    assert (flat.render() == got).all()


def test_many_object_renderers_match_the_reference_mean():
    """Three bounces: the regeneration path and the phased path against
    the reference's jnp Renderer, image means within 5%."""
    kw = dict(w=24, h=16, bounces=3, iters=4)
    want = JaxRenderer(_field(P=jax_presets, **kw), backend="jnp").render()
    for opts in ({}, dict(phase_split=1, phase_capacity=384)):
        got = trender.Renderer(_field(**kw), device="cpu", **opts).render()
        assert np.isfinite(got).all()
        assert abs(float(got[..., :3].mean()) / float(want[..., :3].mean()) - 1.0) <= 0.05


def test_cli_spheres_with_phase_split(tmp_path, capsys):
    base = ["render", "--preset", "spheres", "--width", "24", "--height", "16",
            "--iterations", "2", "--bounces", "3", "--samples", "8", "--device", "cpu"]
    out = tmp_path / "p.png"
    assert cli.main(base + ["--phase-split", "1,2", "--phase-capacity", "384,256",
                            "--out", str(out)]) == 0
    assert out.stat().st_size > 0
    assert "phased: stages ((1, 384), (2, 256))" in capsys.readouterr().err
    assert cli._parse_phase("auto") == "auto" and cli._parse_phase("2") == 2
    with pytest.raises(SystemExit):
        cli._parse_phase("auto", allow_auto=False)
