"""The CUDA bounce kernels against their plain PyTorch versions on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false. The module imports no jax, so it
also runs on a machine without it (``tests/conftest.py`` imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Tolerances: direct-only radiance to 1e-5 of the image scale; multi-bounce
frames to the coin-flip envelope (at most 15% of pixels off by more than
1e-5; the kernels are built without FMA contraction precisely so that they
match the eager path, and on an H100 they match it bit for bit); the
regeneration sum to 1e-4. The persist and cost kernels are held bit for
bit: the ring variant to its plain version and to ``cuda_regen``, the
free-running variant across launch splits and to its plain version, the
all-zero stop mask to the free-running variant, and ``cuda_cost``'s
radiance to ``cuda_mono``'s. The many-object variants (a 101-object
sphere field, clustered) and ``cuda_seg`` are held bit for bit to their
plain versions, the clustered walk to the flat one, and the split frame
to the mono frame; the cascade to the mono frame within 1e-6 of the
image scale (it sums each segment's radiance separately). The triangle
builds (the mesh preset, clustered and flat, and a smooth mesh in the
small-scene and the many-object build) are held bit for bit to their
plain versions, at every S since the lens slice. Depth of field: each
kernel on lens rays (regen on its lens table) bit for bit to its plain
version. The shadow-interval builds bit for bit to the plain path with
the option. The trace probe: ``cuda_probe_fori`` bit for bit to its
plain version; ``cuda_probe_mma`` (3xTF32 products) with the same
winners on 99.99% of rays and, against a float64 evaluation, every hit
within its own first-order error bound (``trace_probe.error_bound``:
the 3xTF32 dot products err by at most 22 float32 roundings of their
terms' magnitudes, the rest as the plain version) and 98% of hits within
1e-5. The formula cancels, so t agrees with the plain version only to
float32's error. The earlier probe designs (the ``probe_parent`` build)
are held to the same, at ragged ray and sphere counts. Motion blur on
``cuda_mono``: a clustered render equals ``accel="none"`` bit for bit
with a sphere leaving its cluster, and static tracks equal the unblurred
render. The AOVs on the card against the CPU: ``obj_id`` exactly, depth,
normal and albedo within 1e-5 of their scale; the denoiser within 1e-4
of the image's. Row slabs on one card (``make_mesh(4)``): regeneration,
frame by frame, a clustered scene on Morton lanes per slab and persist
each equal to the unsharded render bit for bit; ``frames_per_dispatch``
equal to one frame per dispatch; the grid refused.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops import trace_probe as tp
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.camera import camera_basis_table
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.render.renderer import Renderer
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import mesh as tmesh
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import flatten_scene
from tests import torch_scenes

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU build)")
    return torch.device("cuda")


def _scene(name, w, h, bounces, samples=8, iters=2):
    scene = presets.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


class _Launches:
    """The kernel launches counted since it was made, by kind (the
    tracer's always-kept ``launch.<kind>`` totals)."""

    def __init__(self):
        self.base = self._now()

    @staticmethod
    def _now():
        return {k: trace.total(f"launch.{k}") for k in ("mono", "regen", "persist", "cost", "seg")}

    def __call__(self, *kinds):
        now = self._now()
        got = tuple(now[k] - self.base[k] for k in kinds)
        return got if len(got) > 1 else got[0]


def _lanes(scene, device, frame=0):
    port, cfg = flatten_scene(scene, device)
    tb = mk.pack_tables(port, cfg)
    planes, px, py = ci.primary_lanes(port, cfg, frame)
    return planes, px, py, tb


@pytest.mark.parametrize("samples", [8, 16, 32, 64])
@pytest.mark.parametrize("name,bounces", [("default", 1), ("cornell", 1), ("cornell", 3),
                                          ("default", 4)])
def test_cuda_mono_matches_plain(cuda, name, bounces, samples):
    planes, px, py, tb = _lanes(_scene(name, 32, 16, bounces, samples), cuda, frame=1)
    before = trace.total("launch.mono")
    got = mk.run_mono(*planes, px, py, 1, tb)
    assert trace.total("launch.mono") == before + 1
    want = mk.run_mono_plain(*planes, px, py, 1, tb)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (samples, 32 * 16)
    err = (got - want).abs().amax(0) / max(1.0, float(want.abs().max()))
    if bounces == 1:
        assert float(err.max()) <= 1e-5
    assert float((err > 1e-5).float().mean()) <= 0.15


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_cuda_regen_matches_sum_of_mono(cuda, name):
    port, cfg = flatten_scene(_scene(name, 16, 128, 4, iters=3), cuda)
    tb = mk.pack_tables(port, cfg)
    before = trace.total("launch.regen")
    got = ci.integrate_frames_cuda_regen(port, cfg, 0, 3, tb)
    assert trace.total("launch.regen") == before + 1
    want = sum(ci.integrate_frame_cuda(port, cfg, f, tb) for f in range(3))
    # and the kernel's radiance sum against the plain version's
    args = (*ci.regen_args(port, cfg, 0, 3), tb)
    rad_kernel, rad_plain = mk.run_regen(*args), mk.run_regen_plain(*args)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    assert float((rad_kernel - rad_plain).abs().max()) <= 1e-4 * max(
        1.0, float(rad_plain.abs().max()))


def test_cuda_renderer_counts_launches(cuda):
    n = _Launches()
    img = Renderer(_scene("cornell", 32, 16, 3, iters=6), device="cuda",
                   regen_frames=4).render()
    assert n("regen", "mono") == (1, 2)
    assert img.shape == (16, 32, 4) and float(img[..., :3].mean()) > 0


def test_cuda_wrapper_checks_inputs(cuda):
    planes, px, py, tb = _lanes(_scene("cornell", 16, 8, 1), cuda)
    with pytest.raises(TypeError, match="int32"):
        mk.run_mono(*planes, px.long(), py, 0, tb)
    strided = torch.stack([planes[0], planes[0]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        mk.run_mono(strided, *planes[1:], px, py, 0, tb)
    with pytest.raises(ValueError, match="lanes"):
        mk.run_mono(*(p[:-1] for p in planes), px, py, 0, tb)
    cpu_planes = [p.cpu() for p in planes]
    with pytest.raises(ValueError, match="tables"):
        mk.run_mono(planes[0], *cpu_planes[1:], px, py, 0, tb)


def _drive(scene, device, budget, ring_w=0, plain=False, stop=None):
    """One carried state through the persist scheduler's launches."""
    port, cfg = flatten_scene(scene, device)
    tb = mk.pack_tables(port, cfg)
    frames = cfg.intended_frames
    st = ci.persist_init(port, cfg)
    cam = tb.cam if ring_w else camera_basis_table(port, cfg)
    ring, lead = None, frames
    if ring_w:
        ring = tuple(torch.zeros((ring_w, cfg.width * cfg.height), device=device)
                     for _ in range(3))
        lead = min(ring_w, frames)
        for f in range(1, lead):
            ci.ring_refill(ring, f, port, cfg)
    run = mk.run_persist_plain if plain else mk.run_persist
    while True:
        run(st, lead, frames, tb, cam, ring=ring, stop=stop, budget=budget)
        done = int(ci.min_frames_done(st, stop, frames))
        if done >= frames:
            break
        while ring_w and lead < min(done + ring_w, frames):
            ci.ring_refill(ring, lead, port, cfg)
            lead += 1
    torch.cuda.synchronize()
    return st, port, cfg, tb


def _equal(a, b):
    return all(torch.equal(t, getattr(b, k)) for k, t in a.planes().items())


def test_cuda_persist_ring_bit_identical_to_plain_and_regen(cuda):
    scene = _scene("default", 16, 128, 4, iters=6)
    before = trace.total("launch.persist")
    got, port, cfg, tb = _drive(scene, cuda, 13, ring_w=4)
    assert trace.total("launch.persist") > before + 1
    want, *_ = _drive(scene, cuda, 13, ring_w=4, plain=True)
    assert _equal(got, want)
    assert torch.equal(got.rad, ci.regen_radiance(port, cfg, 0, 6, tb))


@pytest.mark.parametrize("bounces", [1, 3])
def test_cuda_persist_free_running_matches_plain_and_splits(cuda, bounces):
    scene = _scene("cornell", 16, 8, bounces, iters=6)
    a, *_ = _drive(scene, cuda, 11)
    b, *_ = _drive(scene, cuda, 64)
    assert torch.equal(a.rad, b.rad) and torch.equal(a.fid, b.fid)
    want, *_ = _drive(scene, cuda, 11, plain=True)
    err = (a.rad - want.rad).abs().amax(0) / max(1.0, float(want.rad.abs().max()))
    if bounces == 1:
        assert float(err.max()) <= 1e-5
    assert float((err > 1e-5).float().mean()) <= 0.15


def test_cuda_persist_lane_stop(cuda):
    scene = _scene("cornell", 16, 8, 3, iters=6)
    n = 16 * 8
    free, *_ = _drive(scene, cuda, 11)
    zero, *_ = _drive(scene, cuda, 11, stop=torch.zeros(n, device=cuda))
    assert _equal(zero, free)
    port, cfg = flatten_scene(scene, cuda)
    tb = mk.pack_tables(port, cfg)
    cam = camera_basis_table(port, cfg)
    st = ci.persist_init(port, cfg)
    mk.run_persist(st, 6, 6, tb, cam, budget=4)
    fid1 = st.fid.clone()
    lane = torch.arange(n, device=cuda)
    stop = ((lane % 16 + lane // 16) % 2).float()
    for _ in range(8):
        mk.run_persist(st, 6, 6, tb, cam, stop=stop, budget=4)
    held = stop > 0
    assert torch.equal(st.fid[held], fid1[held])
    assert bool((st.alive[held] == 0).all())
    assert int(st.fid[~held].min()) == 5 and bool((st.alive[~held] == 0).all())


@pytest.mark.parametrize("name,bounces", [("cornell", 3), ("default", 4)])
def test_cuda_cost_matches_mono_and_plain(cuda, name, bounces):
    planes, px, py, tb = _lanes(_scene(name, 32, 16, bounces), cuda, frame=1)
    before = trace.total("launch.cost")
    rad, cost = mk.run_cost(*planes, px, py, 1, tb)
    assert trace.total("launch.cost") == before + 1
    mono = mk.run_mono(*planes, px, py, 1, tb)
    prad, pcost = mk.run_cost_plain(*planes, px, py, 1, tb)
    torch.cuda.synchronize()
    assert torch.equal(rad, mono)
    assert torch.equal(rad, prad) and torch.equal(cost, pcost)


def test_cuda_renderer_persist_counts_launches(cuda):
    n = _Launches()
    r = Renderer(_scene("cornell", 32, 16, 3, iters=6), device="cuda", persist=True)
    img = r.render()
    assert n("cost") == 1 and n("persist") > 1
    assert r.persist_info["frames_done"] >= 6
    assert img.shape == (16, 32, 4) and float(img[..., :3].mean()) > 0
    want = Renderer(_scene("cornell", 32, 16, 3, iters=6), device="cpu", persist=True,
                    persist_budget=r.persist_info["budget"]).render()
    assert abs(float(img[..., :3].mean()) / float(want[..., :3].mean()) - 1.0) <= 0.05


# ------------------------------------------------- many objects, cuda_seg


def _field(w, h, bounces, samples=8, iters=2):
    return torch_scenes.sphere_field(presets, 100, w, h, bounces, iters=iters,
                                     samples=samples)


@pytest.mark.parametrize("bounces", [1, 3])
def test_cuda_many_object_kernels_match_plain(cuda, bounces):
    """mono, cost, regen and persist on the clustered 101-object walk."""
    port, cfg = flatten_scene(_field(32, 16, bounces, iters=4), cuda)
    tb = mk.pack_tables(port, cfg)
    assert tb.clusters is not None
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    mono = mk.run_mono(*planes, px, py, 1, tb)
    assert torch.equal(mono, mk.run_mono_plain(*planes, px, py, 1, tb))
    assert torch.equal(mono, mk.run_mono(*planes, px, py, 1, mk.pack_tables(port, cfg, "none")))
    rad, cost = mk.run_cost(*planes, px, py, 1, tb)
    prad, pcost = mk.run_cost_plain(*planes, px, py, 1, tb)
    assert torch.equal(rad, mono) and torch.equal(cost, pcost)
    args = (*ci.regen_args(port, cfg, 1, 3), tb)
    assert torch.equal(mk.run_regen(*args), mk.run_regen_plain(*args))
    got, *_ = _drive(_field(32, 16, bounces, iters=4), cuda, 5)
    want, *_ = _drive(_field(32, 16, bounces, iters=4), cuda, 5, plain=True)
    assert _equal(got, want)
    torch.cuda.synchronize()


def test_cuda_many_object_regen_on_morton_lanes(cuda):
    """The many-object regen build at S = 32 on the Morton lane order the
    Renderer gives a clustered scene, bit for bit to its plain version."""
    port, cfg = flatten_scene(_field(32, 16, 3, samples=32, iters=3), cuda)
    tb = mk.pack_tables(port, cfg)
    assert tb.clusters is not None
    perm, _ = morton_layout(cfg.width, cfg.height, cuda)
    args = (*ci.regen_args(port, cfg, 0, 3, perm), tb)
    assert torch.equal(mk.run_regen(*args), mk.run_regen_plain(*args))
    torch.cuda.synchronize()


@pytest.mark.parametrize("scene", ["cornell", "field"])
def test_cuda_seg_matches_plain_and_composes_to_mono(cuda, scene):
    sc = (_scene("cornell", 32, 16, 4) if scene == "cornell" else _field(32, 16, 4))
    port, cfg = flatten_scene(sc, cuda)
    tb = mk.pack_tables(port, cfg)
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    mono = mk.run_mono(*planes, px, py, 1, tb)
    got, want = ci.frame_wavefront(port, cfg, 1), ci.frame_wavefront(port, cfg, 1)
    before = trace.total("launch.seg")
    for b0, b1 in ((0, 1), (1, 2), (2, 4)):
        mk.run_seg(got, b0, b1, 1, tb)
        mk.run_seg_plain(want, b0, b1, 1, tb)
        assert all(torch.equal(v, getattr(want, k)) for k, v in got.planes().items())
    assert trace.total("launch.seg") == before + 3
    assert torch.equal(got.rad, mono)
    split = ci.integrate_frame_split(port, cfg, 1, 2, tb)
    assert torch.equal(split, ci.integrate_frame_cuda(port, cfg, 1, tb))
    rgb, overflow = ci.integrate_frame_cascade(port, cfg, 1, ((1, 512), (2, 512)), tb)
    mono_rgb = ci.integrate_frame_cuda(port, cfg, 1, tb)
    assert not bool(overflow)
    assert float((rgb - mono_rgb).abs().max()) <= 1e-6 * max(1.0, float(mono_rgb.abs().max()))


def test_cuda_renderer_phased_counts_launches(cuda):
    n = _Launches()
    r = Renderer(_field(32, 16, 3, iters=3), device="cuda", phase_split=1,
                 phase_capacity=512)
    img = r.render()
    assert n("seg", "mono", "regen") == (6, 0, 0)
    assert r.overflow_frames == 0 and img.shape == (16, 32, 4)
    r = Renderer(_field(32, 16, 3, iters=3), device="cuda", phase_split=1,
                 phase_capacity=128)
    r.render()
    assert r.overflow_frames == 3 and n("mono") == 3
    want = Renderer(_field(32, 16, 3, iters=3), device="cuda", regen_frames=1).render()
    assert (r.framebuffer() == want).all()


# ------------------------------------------------------------ triangles


def _mesh(kind, w, h, bounces, samples=8, iters=4):
    """The mesh preset, or a smooth icosphere of subdivision 0 (45 objects:
    the small-scene build) or 1 (105: clusters) beside a flat icosahedron."""
    if kind == "mesh":
        return torch_scenes.preset(presets, "mesh", w, h, bounces, iters, samples)
    return torch_scenes.smooth_mesh(presets, tmesh, w, h, bounces,
                                    subdivisions=int(kind[-1]), iters=iters,
                                    samples=samples)


@pytest.mark.parametrize("samples", [8, 32])
@pytest.mark.parametrize("bounces", [1, 3])
@pytest.mark.parametrize("kind", ["mesh", "smooth0", "smooth1"])
def test_cuda_triangle_kernels_match_plain(cuda, kind, bounces, samples):
    """mono, cost, regen, persist and seg in their triangle builds."""
    port, cfg = flatten_scene(_mesh(kind, 32, 16, bounces, samples), cuda)
    tb = mk.pack_tables(port, cfg)
    assert tb.triangles == (1 if kind == "mesh" else 2)
    assert tb.many_objects() == (kind != "smooth0")
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    mono = mk.run_mono(*planes, px, py, 1, tb)
    assert torch.equal(mono, mk.run_mono_plain(*planes, px, py, 1, tb))
    if kind == "mesh":  # the clustered walk against the flat one
        assert torch.equal(mono, mk.run_mono(*planes, px, py, 1,
                                             mk.pack_tables(port, cfg, "none")))
    rad, cost = mk.run_cost(*planes, px, py, 1, tb)
    prad, pcost = mk.run_cost_plain(*planes, px, py, 1, tb)
    assert torch.equal(rad, mono) and torch.equal(cost, pcost)
    args = (*ci.regen_args(port, cfg, 1, 3), tb)
    assert torch.equal(mk.run_regen(*args), mk.run_regen_plain(*args))
    got, want = ci.frame_wavefront(port, cfg, 1), ci.frame_wavefront(port, cfg, 1)
    for b0, b1 in ((0, 1), (1, bounces)):
        if b0 < b1:
            mk.run_seg(got, b0, b1, 1, tb)
            mk.run_seg_plain(want, b0, b1, 1, tb)
    assert _equal(got, want) and torch.equal(got.rad, mono)
    sc = _mesh(kind, 32, 16, bounces, samples)
    pgot, *_ = _drive(sc, cuda, 5)
    pwant, *_ = _drive(sc, cuda, 5, plain=True)
    assert _equal(pgot, pwant)
    torch.cuda.synchronize()


@pytest.mark.parametrize("samples", [16, 64])
def test_cuda_triangles_need_a_triangle_build(cuda, samples):
    """Triangle builds exist at every S since the lens slice (at S = 16
    they were refused on the host): a mesh at 16 and 64 wavelengths
    launches each bounce kernel's triangle build (mono, cost, regen K = 3
    on Morton lanes, seg [0, 2) and its compacted tail), and with glass
    meshes the feature build's (persist lane-stop too), bit for bit to
    the plain versions."""
    port, cfg = flatten_scene(_mesh("mesh", 32, 16, 3, samples=samples), cuda)
    tb = mk.pack_tables(port, cfg)
    assert tb.triangles == 1 and cfg.n_samples == samples
    before = trace.total("launch.mono")
    checks, info = torch_scenes.kernel_checks(tb, lane_perm=morton_layout(32, 16, cuda)[0],
                                              persist_launches=0)
    assert all(checks.values()), (checks, info)
    assert trace.total("launch.mono") == before + 1
    glass = torch_scenes.glass_meshes(schema, presets, "mesh", 32, 16, 4, samples=samples)
    checks, info = torch_scenes.feature_kernel_checks(
        mk.pack_tables(*flatten_scene(glass, cuda)))
    assert all(checks.values()), (checks, info)


def test_cuda_renderer_mesh_counts_launches(cuda):
    n = _Launches()
    r = Renderer(_mesh("mesh", 32, 16, 3, samples=32, iters=5), device="cuda", regen_frames=4)
    img = r.render()
    assert n("regen", "mono") == (1, 1)
    assert r.clusters is not None and r.lane_layout == "morton"
    assert img.shape == (16, 32, 4) and np.isfinite(img).all()


# ------------------------------------------------------------ trace probe


def test_cuda_probe_fori_bit_identical_to_plain(cuda):
    args = tuple(torch.from_numpy(a).to(cuda) for a in tp.make_inputs(0, 4, 1024)["fori"])
    before = trace.total("launch.probe_fori")
    t, win = tp.cuda_probe_fori(*args)
    assert trace.total("launch.probe_fori") == before + 1
    pt, pwin = tp.probe_fori_plain(*args)
    assert torch.equal(win, pwin) and torch.equal(t, pt)
    assert 0.05 < float(torch.isfinite(t).float().mean()) < 0.95


def test_cuda_probe_mma_matches_plain_to_float32_error(cuda):
    args = tuple(torch.from_numpy(a).to(cuda) for a in tp.make_inputs(0, 4, 1024)["mma"])
    before = trace.total("launch.probe_mma")
    t, win = tp.cuda_probe_mma(*args)
    assert trace.total("launch.probe_mma") == before + 1
    pt, pwin = tp.probe_mma_plain(*args)
    et, ewin = tp.probe_exact(*args)
    vs_plain = tp.compare(t, win, pt, pwin)
    assert vs_plain["winner_agreement"] >= tp.MMA_WINNERS_MIN
    kernel = tp.compare(t, win, et, ewin, tp.error_bound(*args, ewin, tp.MMA_DOT_GAMMA))
    plain = tp.compare(pt, pwin, et, ewin, tp.error_bound(*args, ewin, tp.PLAIN_DOT_GAMMA))
    assert kernel["max_err_over_bound"] <= 1.0 and plain["max_err_over_bound"] <= 1.0
    assert kernel["share_within_1e5"] >= tp.MMA_SHARE_1E5_MIN, (kernel, plain)


def test_cuda_probe_refuses_spheres_beyond_shared_memory(cuda):
    """Every sphere sits in a block's shared memory, as far as the build's
    own layout leaves room (``trace_probe.probe_layout``, from
    ``probe.cu``): kernel B's table holds 3,392 spheres (68 B per sphere of
    a table padded to a multiple of 32, after a 128-byte head), kernel A
    14,271 (16 B each, one more slot, and its second share's minima); the
    earlier design 3,416 and 14,528. Kernel B at 3,400 spheres and kernel
    A at one more than it holds raise on the host and launch nothing."""
    assert tp.probe_layout("probe", 1000) == {"fori": 14271, "mma": 3392,
                                              "mma_scratch": 17 * 1024 + 4}
    assert tp.probe_layout("probe_parent", 1000) == {"fori": 14528, "mma": 3416,
                                                     "mma_scratch": 0}
    before = trace.total("launch.probe_mma")
    for n_obj, fits in ((3392, True), (3400, False)):
        args = tuple(torch.from_numpy(a).to(cuda) for a in tp.make_inputs(0, 1, n_obj)["mma"])
        if fits:
            tp.cuda_probe_mma(*args)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tp.cuda_probe_mma(*args)
    assert trace.total("launch.probe_mma") == before + 1
    n_max = tp.probe_layout("probe", 0)["fori"]
    before = trace.total("launch.probe_fori")
    for n_obj, fits in ((n_max, True), (n_max + 1, False)):
        args = tuple(torch.from_numpy(a).to(cuda) for a in tp.make_inputs(0, 1, n_obj)["fori"])
        if fits:
            t, win = tp.cuda_probe_fori(*args)
            pt, pwin = tp.probe_fori_plain(*args)
            assert torch.equal(t, pt) and torch.equal(win, pwin)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                tp.cuda_probe_fori(*args)
    assert trace.total("launch.probe_fori") == before + 1


def _ragged_probe(device, n_obj, tiles=8, extra=77):
    """The probe's inputs at ``tiles`` x 4,096 + ``extra`` rays (not a
    multiple of any ray tile of the kernels: the loop kernel's planes
    flat) against ``n_obj`` spheres, seed 1."""
    inputs = tp.make_inputs(1, tiles + 1, n_obj)
    n = tiles * tp.N_RAYS + extra
    geom, *planes = (torch.from_numpy(a).to(device) for a in inputs["fori"])
    fori = (geom, *(p.reshape(-1)[:n].contiguous() for p in planes))
    dmat, omat, cmat, cc, do, oo, a = (torch.from_numpy(x).to(device) for x in inputs["mma"])
    mma = (*(x[:n].contiguous() for x in (dmat, omat)), cmat, cc,
           *(x[:n].contiguous() for x in (do, oo, a)))
    return fori, mma


@pytest.mark.parametrize("n_obj", [8, 128, 1000, 1024])
def test_cuda_probe_kernels_match_parent_and_plain_ragged(cuda, n_obj):
    """The redesigned probe kernels and their earlier design (the
    ``probe_parent`` build) at a ragged ray count and sphere counts that
    fill the tensor-core kernel's padded table (1,024), leave it partly
    padding (8, 1,000) or fill one of the earlier design's 128-sphere
    blocks:
    ``cuda_probe_fori`` and its parent ``torch.equal`` to the plain
    version; ``cuda_probe_mma`` and its parent within the ``MMA_*``
    limits against the plain version and float64."""
    fori, mma = _ragged_probe(cuda, n_obj)
    pt, pwin = tp.probe_fori_plain(*fori)
    for t, win in (tp.cuda_probe_fori(*fori), tp.probe_fori_variant("probe_parent", *fori)):
        assert torch.equal(t, pt) and torch.equal(win, pwin)
    assert bool(torch.isfinite(pt).any())
    mt, mwin = tp.probe_mma_plain(*mma)
    et, ewin = tp.probe_exact(*mma)
    bound = tp.error_bound(*mma, ewin, tp.MMA_DOT_GAMMA)
    for t, win in (tp.cuda_probe_mma(*mma), tp.probe_mma_variant("probe_parent", *mma)):
        vs_plain = tp.compare(t, win, mt, mwin)
        vs_exact = tp.compare(t, win, et, ewin, bound)
        assert vs_plain["winner_agreement"] >= tp.MMA_WINNERS_MIN, vs_plain
        assert vs_exact["max_err_over_bound"] <= 1.0, vs_exact
        assert vs_exact["share_within_1e5"] >= tp.MMA_SHARE_1E5_MIN, vs_exact


def test_cuda_probe_kernels_match_parent_at_full_shape(cuda):
    """At the probe tool's full shape (196,608 rays, 1,024 spheres, seed
    0): the redesigned loop kernel bit for bit its earlier design's and
    the plain version's output, the tensor-core kernel's winners the
    plain version's on ``MMA_WINNERS_MIN`` of rays, as its parent's."""
    inputs = tp.make_inputs(0)
    fori = tuple(torch.from_numpy(a).to(cuda) for a in inputs["fori"])
    mma = tuple(torch.from_numpy(a).to(cuda) for a in inputs["mma"])
    t, win = tp.cuda_probe_fori(*fori)
    qt, qwin = tp.probe_fori_variant("probe_parent", *fori)
    pt, pwin = tp.probe_fori_plain(*fori)
    assert torch.equal(t, qt) and torch.equal(win, qwin)
    assert torch.equal(t, pt) and torch.equal(win, pwin)
    mt, mwin = tp.probe_mma_plain(*mma)
    for got in (tp.cuda_probe_mma(*mma), tp.probe_mma_variant("probe_parent", *mma)):
        assert tp.compare(*got, mt, mwin)["winner_agreement"] >= tp.MMA_WINNERS_MIN


# ------------------------------------- the redesigned regen and the packed walk


@pytest.mark.parametrize("kind", ["cornell", "field", "mesh", "mesh5k"])
def test_cuda_regen_equals_plain_and_sum_of_mono_frames(cuda, kind):
    """``cuda_regen``, whose kernel generates every frame's primaries, bit
    for bit to its plain version, and to the sum of its K frames as
    ``cuda_mono`` traces them from host raygen (every path the same: only
    the summation order differs, 1e-5 of the scale); many-object scenes on
    the Renderer's Morton lanes, S = 32."""
    if kind == "cornell":
        scene, morton = _scene("cornell", 64, 32, 30, samples=32, iters=3), False
    elif kind == "field":
        scene, morton = _field(64, 48, 8, samples=32, iters=3), True
    else:
        scene = torch_scenes.preset(presets, kind, 32, 32, 30, 3, 32)
        morton = True
    port, cfg = flatten_scene(scene, cuda)
    tb = mk.pack_tables(port, cfg)
    perm = morton_layout(cfg.width, cfg.height, cuda)[0] if morton else None
    args = (*ci.regen_args(port, cfg, 0, 3, perm), tb)
    got = mk.run_regen(*args)
    assert torch.equal(got, mk.run_regen_plain(*args))
    mono = 0.0
    for j in range(3):
        planes, px, py = ci.primary_lanes(port, cfg, j)
        if perm is not None:
            planes, px, py = tuple(p[perm] for p in planes), px[perm], py[perm]
        mono = mono + mk.run_mono(*planes, px, py, j, tb)
    torch.cuda.synchronize()
    assert float((got - mono).abs().max()) <= 1e-5 * max(1.0, float(mono.abs().max()))


def test_cuda_regen_resident_grid_hands_out_pixels(cuda):
    """More lanes than the card holds at once (132 SMs x 4 blocks x 128
    lanes = 67,584): lanes take further pixels from the counter. The image
    is the plain version's bit for bit, and the earlier design's grid (the
    ``regen_parent`` diagnostic build, one lane per pixel) gives the same
    bits."""
    port, cfg = flatten_scene(_scene("cornell", 384, 256, 3, samples=8, iters=3), cuda)
    tb = mk.pack_tables(port, cfg)
    args = (*ci.regen_args(port, cfg, 0, 3), tb)
    got = mk.run_regen(*args)
    assert torch.equal(got, mk.run_regen_plain(*args))
    assert torch.equal(got, mk.run_regen_variant("regen_parent", *args))


def test_cuda_packed_walk_from_global_memory(cuda):
    """The packed records read from global memory (as mesh5k's, which do
    not fit shared memory) give the same bits as from shared memory, and
    tables without records (every run through the 47-row table) too."""
    port, cfg = flatten_scene(_mesh("mesh", 32, 16, 3, samples=8), cuda)
    tb = mk.pack_tables(port, cfg)
    assert tb.packed_shared and tb.packed.shape[0] > 0
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    want = mk.run_mono(*planes, px, py, 1, tb)
    for t in (dataclasses.replace(tb, packed_shared=False), tb.unpacked()):
        assert torch.equal(mk.run_mono(*planes, px, py, 1, t), want)
    mesh5k = torch_scenes.preset(presets, "mesh5k", 8, 8, 1, 1, 8)
    assert not mk.pack_tables(*flatten_scene(mesh5k, cuda)).packed_shared


# ------------------------------------------------------- scene features


def _feature_scene(kind, samples=8):
    """The feature cases: the prism (dielectric, dispersion, emission), the
    open sphere under a sky, the checker floor, the emissive panel, and the
    mesh preset with glass meshes (the triangle builds' dielectric)."""
    if kind == "prism":
        return _scene("prism", 32, 24, 8, samples=samples, iters=3)
    if kind == "sky":
        return torch_scenes.open_sky(schema, samples, 3, iters=3)
    if kind == "checker":
        return torch_scenes.textured(schema, presets, samples, 3, iters=3)
    if kind == "panel":
        return torch_scenes.emissive_panel(schema, samples)
    return torch_scenes.glass_meshes(schema, presets, "mesh", 32, 16, 4, samples=samples,
                                     iters=3)


@pytest.mark.parametrize("kind,samples", [("prism", 8), ("prism", 64), ("sky", 16),
                                          ("checker", 8), ("panel", 16), ("glass_mesh", 32)])
def test_cuda_feature_kernels_match_plain(cuda, kind, samples):
    """Every bounce kernel's feature build, bit for bit to its plain
    version (``torch_scenes.feature_kernel_checks``): mono, cost, regen
    (K = 3), seg [0, 2) and the compacted [2, B) with the hero bin
    carried, and persist lane-stop over two launches."""
    tb = mk.pack_tables(*flatten_scene(_feature_scene(kind, samples), cuda))
    checks, info = torch_scenes.feature_kernel_checks(tb)
    assert all(checks.values()), (checks, info)
    if kind == "prism":
        assert info["survivors_with_hero"] > 0 and info["persist_heroes"] > 0, info


def test_cuda_feature_scenes_load_feature_builds_only(cuda, monkeypatch):
    """A feature scene launches the feature builds and never the others;
    a feature-free scene the reverse."""
    loaded = []
    real = mk._load_entry
    monkeypatch.setattr(mk, "_load_entry", lambda fn, lib: loaded.append(lib) or real(fn, lib))
    n = _Launches()
    img = Renderer(_scene("prism", 32, 24, 8, iters=5), device="cuda", regen_frames=4).render()
    assert n("regen", "mono") == (1, 1)
    assert np.isfinite(img).all() and set(loaded) == {"regen_fx", "mono_fx"}
    loaded.clear()
    Renderer(_scene("cornell", 16, 8, 3, iters=5), device="cuda", regen_frames=4).render()
    assert set(loaded) == {"regen", "mono"}
    prism = mk.pack_tables(*flatten_scene(_scene("prism", 8, 8, 2), cuda))
    with pytest.raises(ValueError, match="feature"):
        mk.run_regen_variant("regen_parent", *ci.regen_args(prism.scene, prism.config, 0, 2),
                             prism)


def test_cuda_cli_refuses_exr_before_any_launch(cuda, tmp_path):
    """Named for the refusal it replaces: ``--out x.exr`` on the card
    launches the feature build's regeneration kernel and writes the
    framebuffer (half precision) that a Renderer of the scene gives."""
    from spectral_tpu_torch import cli
    from tests.torch_exr import read_exr

    n = _Launches()
    out = tmp_path / "x.exr"
    rc = cli.main(["render", "--preset", "prism", "--width", "16", "--height", "12",
                   "--iterations", "2", "--out", str(out), "--quiet"])
    assert rc == 0 and n("regen") == 1
    scene = presets.prism()
    scene.width, scene.height, scene.nbr_of_iterations = 16, 12, 2
    fb = Renderer(scene, device="cuda").render()
    planes, _, _ = read_exr(out)
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3)):
        assert np.array_equal(planes[name], fb[..., ch].astype(np.float16).astype(np.float32))


def test_cuda_prism_paths_agree(cuda):
    """The prism through regen, persist and phased: image means within 2%."""
    sc = _scene("prism", 64, 48, 8, samples=16, iters=8)
    means = {}
    for kind, kw in (("regen", {}), ("persist", dict(persist=True)),
                     ("phased", dict(phase_split=2))):
        means[kind] = float(Renderer(sc, device="cuda", **kw).render()[..., :3].mean())
    for kind in ("persist", "phased"):
        assert abs(means[kind] / means["regen"] - 1.0) <= 0.02, means


# ------------------------------------------------------------ depth of field


def _lens_scene(kind):
    """A lens on the Cornell box, the 101-object field and the mesh at 64
    wavelengths (the regeneration kernel's lens table in its small-scene,
    many-object and triangle builds)."""
    if kind == "cornell":
        sc = _scene("cornell", 32, 16, 4, iters=4)
    elif kind == "field":
        sc = _field(32, 16, 3, iters=4)
    else:
        sc = _mesh("mesh", 32, 16, 3, samples=64)
    return torch_scenes.with_lens(sc, 0.05, 2.0)


@pytest.mark.parametrize("kind", ["cornell", "field", "mesh64"])
def test_cuda_lens_kernels_match_plain(cuda, kind):
    """mono, cost and seg on host raygen's lens rays, and regen (K = 3) on
    its lens table, bit for bit to their plain versions; the regeneration
    sum equals the sum of its mono frames to float32 reassociation."""
    port, cfg = flatten_scene(_lens_scene(kind), cuda)
    assert cfg.has_dof
    tb = mk.pack_tables(port, cfg)
    perm = morton_layout(32, 16, cuda)[0] if tb.many_objects() else None
    checks, info = torch_scenes.kernel_checks(tb, lane_perm=perm, persist_launches=0)
    assert all(checks.values()), (checks, info)
    regen = ci.integrate_frames_cuda_regen(port, cfg, 0, 3, tb)
    mono = sum(ci.integrate_frame_cuda(port, cfg, f, tb) for f in range(3))
    pin = ci.integrate_frames_cuda_regen(
        *flatten_scene(torch_scenes.with_lens(_lens_scene(kind), 0.0), cuda), 0, 3)
    torch.cuda.synchronize()
    assert float((regen - mono).abs().max()) <= 1e-4 * max(1.0, float(mono.abs().max()))
    assert not torch.equal(regen, pin)


def test_cuda_lens_renderer_paths_agree(cuda):
    """Regeneration, frame by frame and phased with a lens: image means
    within 2%; persist refuses the lens."""
    sc = torch_scenes.with_lens(_scene("cornell", 64, 48, 6, iters=8), 0.05, 2.0)
    means = {}
    for kind, kw in (("regen", {}), ("mono", dict(regen_frames=1)),
                     ("phased", dict(phase_split=2))):
        means[kind] = float(Renderer(sc, device="cuda", **kw).render()[..., :3].mean())
    for kind in ("mono", "phased"):
        assert abs(means[kind] / means["regen"] - 1.0) <= 0.02, means
    with pytest.raises(ValueError, match="persist"):
        Renderer(sc, device="cuda", persist=True)


# ---------------------------------------------------------- shadow interval


@pytest.mark.parametrize("kind", ["field", "mesh16"])
def test_cuda_shadow_interval_matches_plain(cuda, kind, monkeypatch):
    """The shadow-interval builds (mono_si, regen_si) bit for bit to the
    plain path with the option, and loaded only for it."""
    loaded = []
    real = mk._load_entry
    monkeypatch.setattr(mk, "_load_entry", lambda fn, lib: loaded.append(lib) or real(fn, lib))
    sc = _field(32, 16, 3, iters=4) if kind == "field" else _mesh("mesh", 32, 16, 3, samples=16)
    port, cfg = flatten_scene(sc, cuda)
    si = mk.with_shadow_interval(mk.pack_tables(port, cfg))
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    mono = mk.run_mono(*planes, px, py, 1, si)
    assert torch.equal(mono, mk.run_mono_plain(*planes, px, py, 1, si))
    rad, cost = mk.run_cost(*planes, px, py, 1, si)
    prad, pcost = mk.run_cost_plain(*planes, px, py, 1, si)
    assert torch.equal(rad, mono) and torch.equal(rad, prad) and torch.equal(cost, pcost)
    args = (*ci.regen_args(port, cfg, 1, 3, morton_layout(32, 16, cuda)[0]), si)
    assert torch.equal(mk.run_regen(*args), mk.run_regen_plain(*args))
    torch.cuda.synchronize()
    assert set(loaded) == {"mono_si", "regen_si"}


# --------------------------- the redesigned persist and mono kernels


def _parent_cases(device):
    """Tables each diagnostic parent build holds (no features, triangles
    at S = 8 and 32 only): the Cornell box at 384x256 (98,304 lanes, more
    than the resident grid holds at once, so threads take further lanes
    from the counter), the clustered 101-object field, the mesh at S = 32
    and a smooth icosphere at S = 8 (the small-scene triangle build)."""
    scenes = {"cornell": _scene("cornell", 384, 256, 3, samples=8, iters=4),
              "field": _field(32, 16, 3, samples=16, iters=4),
              "mesh": _mesh("mesh", 64, 64, 3, samples=32),
              "smooth0": _mesh("smooth0", 32, 16, 3, samples=8)}
    return {k: mk.pack_tables(*flatten_scene(sc, device)) for k, sc in scenes.items()}


@pytest.mark.parametrize("kind", ["cornell", "field", "mesh", "smooth0"])
def test_cuda_mono_resident_grid_matches_parent_and_plain(cuda, kind):
    """``cuda_mono`` and ``cuda_cost`` on the resident grid: bit for bit
    the earlier grid's (``mono_parent``, one lane per pixel) and the plain
    version's, the cost radiance the mono radiance."""
    tb = _parent_cases(cuda)[kind]
    planes, px, py = ci.primary_lanes(tb.scene, tb.config, 1)
    args = (*planes, px, py, 1, tb)
    mono = mk.run_mono(*args)
    rad, cost = mk.run_cost(*args)
    assert torch.equal(mono, mk.run_mono_variant("mono_parent", *args))
    prad, pcost = mk.run_cost_variant("mono_parent", *args)
    assert torch.equal(rad, mono) and torch.equal(rad, prad) and torch.equal(cost, pcost)
    want, want_cost = mk.run_cost_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(mono, want) and torch.equal(cost, want_cost)


@pytest.mark.parametrize("variant", ["free-running", "ring", "lane-stop"])
@pytest.mark.parametrize("kind", ["cornell", "field", "mesh", "smooth0"])
def test_cuda_persist_shared_state_matches_parent_and_plain(cuda, kind, variant):
    """``cuda_persist`` with its spectral state in shared memory, two
    launches in each variant: the state bit for bit the earlier design's
    (the register build ``persist_reg``), the main path's (whichever of
    the two ``persist_library`` takes) and, where every restart is host
    raygen's (the ring) or the paths are the plain version's too, the
    plain version's."""
    tb = _parent_cases(cuda)[kind]
    port, cfg = tb.scene, tb.config
    n = cfg.width * cfg.height
    ring = stop = None
    lead, cam = cfg.intended_frames, camera_basis_table(port, cfg)
    if variant == "ring":
        ring = tuple(torch.zeros((4, n), device=cuda) for _ in range(3))
        lead, cam = 4, tb.cam
        for f in range(1, lead):
            ci.ring_refill(ring, f, port, cfg)
    if variant == "lane-stop":
        stop = torch.from_numpy((np.random.default_rng(5).random(n) < 0.3)
                                .astype(np.float32)).to(cuda)
    got, parent, main, plain = (ci.persist_init(port, cfg) for _ in range(4))
    assert mk.library_for("persist", tb) == "persist"
    for _ in range(2):
        kw = dict(ring=ring, stop=stop, budget=7)
        mk.run_persist_variant("persist", got, lead, cfg.intended_frames, tb, cam, **kw)
        mk.run_persist_variant("persist_reg", parent, lead, cfg.intended_frames, tb, cam, **kw)
        mk.run_persist(main, lead, cfg.intended_frames, tb, cam, **kw)
        mk.run_persist_plain(plain, lead, cfg.intended_frames, tb, cam, **kw)
    torch.cuda.synchronize()
    assert int(got.fid.max()) >= 1 and _equal(got, parent) and _equal(got, main)
    if variant == "ring":
        assert _equal(got, plain)
    else:  # free-running restarts recompute raygen: the coin-flip envelope
        err = (got.rad - plain.rad).abs().amax(0) / max(1.0, float(plain.rad.abs().max()))
        assert float((err > 1e-5).float().mean()) <= 0.15


def test_cuda_persist_abort_drain_matches_parent(cuda):
    """The abort drain (``end = 0``: no lane restarts) after a launch,
    on the Cornell box: the new design's state the earlier design's."""
    tb = _parent_cases(cuda)["cornell"]
    port, cfg = tb.scene, tb.config
    cam = camera_basis_table(port, cfg)
    got, parent = ci.persist_init(port, cfg), ci.persist_init(port, cfg)
    for end in (cfg.intended_frames, 0, 0):
        mk.run_persist(got, end, end, tb, cam, budget=2)
        mk.run_persist_variant("persist_reg", parent, end, end, tb, cam, budget=2)
    torch.cuda.synchronize()
    assert _equal(got, parent)


@pytest.mark.parametrize("kind", ["prism", "mesh64"])
def test_cuda_redesigned_kernels_in_feature_and_wide_triangle_builds(cuda, kind):
    """The feature builds (the prism at S = 64) and the wide triangle
    builds (the mesh at S = 64), which have no parent library: mono, cost
    and persist against their plain versions (``kernel_checks``)."""
    if kind == "prism":
        tb = mk.pack_tables(*flatten_scene(torch_scenes.preset(presets, "prism", 64, 48, 8, 3,
                                                               64), cuda))
    else:
        tb = mk.pack_tables(*flatten_scene(_mesh("mesh", 32, 32, 3, samples=64), cuda))
    checks, _ = torch_scenes.kernel_checks(tb)
    assert all(checks[k] for k in ("mono", "cost", "persist")), checks


def test_cuda_persist_info_and_mono_info(cuda):
    """The measurement entries: the new persist kernel holds 4 blocks of
    128 per SM at S = 32 where the earlier design holds fewer, and the
    entries refuse an S without a kernel."""
    import ctypes

    from spectral_tpu_torch.runtime import build

    def info(lib, fn, *head):
        out = (ctypes.c_int * 3)()
        err = getattr(build.load(lib), fn)(*head, 4096, out)
        return err, tuple(out)

    err, new = info("persist", "spectral_persist_info", 32, 0, 0, 0)
    assert err == 0 and new[0] >= 4 and new[1] <= 128
    err, parent = info("persist_reg", "spectral_persist_info", 32, 0, 0, 0)
    assert err == 0 and parent[0] < new[0]
    assert info("persist", "spectral_persist_info", 12, 0, 0, 0)[0] != 0
    err, mono = info("mono", "spectral_mono_info", 32, 0, 0, 1)
    assert err == 0 and mono[0] >= 1


def test_cuda_persist_register_build_matches_shared_and_plain(cuda):
    """mesh5k's packed records stay in global memory, so ``cuda_persist``
    runs its register build (the spectral state in registers): its state
    after two launches is the shared-state build's and the plain
    version's bit for bit."""
    tb = mk.pack_tables(*flatten_scene(torch_scenes.preset(presets, "mesh5k", 32, 16, 3, 4, 32),
                                       cuda))
    assert not tb.packed_shared and mk.library_for("persist", tb) == "persist_reg"
    port, cfg = tb.scene, tb.config
    cam = camera_basis_table(port, cfg)
    stop = (torch.arange(32 * 16, device=cuda) % 3 == 0).float()
    got, parent, plain = (ci.persist_init(port, cfg) for _ in range(3))
    for _ in range(2):
        mk.run_persist(got, 4, 4, tb, cam, stop=stop, budget=7)
        mk.run_persist_variant("persist", parent, 4, 4, tb, cam, stop=stop, budget=7)
        mk.run_persist_plain(plain, 4, 4, tb, cam, stop=stop, budget=7)
    torch.cuda.synchronize()
    assert int(got.fid.max()) >= 1 and _equal(got, parent) and _equal(got, plain)


@pytest.mark.parametrize("name", ["cornell", "prism"])
def test_cuda_persist_register_build_where_the_state_leaves_no_room(cuda, name):
    """240 lights at S = 64: the tables fit a block's shared memory and
    the spectral state after them does not, so ``cuda_persist`` runs the
    register build's small-scene kernel; the state after two ring
    launches is the plain version's bit for bit."""
    sc = torch_scenes.many_lights(schema, presets, name, 240, 16, 8, 3, 64, 4)
    tb = mk.pack_tables(*flatten_scene(sc, cuda))
    fx = "_fx" if name == "prism" else ""
    assert mk.persist_library(tb) == f"persist{fx}_reg"
    port, cfg = tb.scene, tb.config
    n = cfg.width * cfg.height
    ring = tuple(torch.zeros((4, n), device=cuda) for _ in range(3))
    for f in range(1, 4):
        ci.ring_refill(ring, f, port, cfg)
    got, plain = ci.persist_init(port, cfg), ci.persist_init(port, cfg)
    for _ in range(2):
        mk.run_persist(got, 4, 4, tb, tb.cam, ring=ring, budget=5)
        mk.run_persist_plain(plain, 4, 4, tb, tb.cam, ring=ring, budget=5)
    torch.cuda.synchronize()
    assert int(got.fid.max()) >= 1 and _equal(got, plain)


def test_cuda_persist_library_follows_blocks_per_sm(cuda):
    """``persist_library`` keeps the shared state where the tables cost
    it no block per SM (the Cornell box), and else takes whichever build
    holds more blocks per SM, the register build on a tie."""
    cornell = mk.pack_tables(*flatten_scene(_scene("cornell", 16, 8, 3, samples=32), cuda))
    assert mk.persist_library(cornell) == "persist"
    for n, samples in ((1000, 32), (1000, 64), (2400, 32), (2400, 64)):
        sc = presets.sphere_field(n, n_samples=samples)
        sc.width, sc.height = 16, 8
        tb = mk.pack_tables(*flatten_scene(sc, cuda))
        shared = mk._persist_blocks("persist", tb, tb.smem_bytes())
        reg = mk._persist_blocks("persist_reg", tb, tb.smem_bytes())
        assert mk.persist_library(tb) == ("persist" if shared > reg else "persist_reg"), (
            n, samples, shared, reg)


def _blur_schedule(anim, shutter=1.0):
    from spectral_tpu_torch.render import animation as tanim
    from spectral_tpu_torch.scene.flatten import flatten_numpy

    cfg0 = flatten_numpy(anim.scene_at(0))[1]
    return tanim._motion_blur_schedule(anim, 0, shutter, cfg0, lambda s: s)


def test_cuda_motion_blur_clustered_equals_flat(cuda):
    """Motion blur on ``cuda_mono``: a sphere of ``sphere_field(100)``
    leaves its cluster's first bound early in the shutter; the clustered
    render equals ``accel="none"`` bit for bit, one launch a frame."""
    from spectral_tpu_torch.render import animation as tanim

    scene = torch_scenes.sphere_field(presets, 100, 32, 24, 2, iters=8)
    cam = np.asarray(scene.camera.position, np.float64)
    target = tuple(float(v) for v in cam + 2.5 * np.asarray(scene.camera.direction))
    anim = tanim.Animation(scene, 1, [tanim.Track(
        "objects[1].position", [(0.0, tuple(scene.objects[1].position)), (0.1, target)])])
    images = {}
    for accel in ("auto", "none"):
        n = _Launches()
        r = Renderer(anim.scene_at(0), device="cuda", accel=accel,
                     _scene_schedule=_blur_schedule(anim))
        images[accel] = r.render()
        assert n("mono", "regen") == (8, 0)
    assert np.array_equal(images["auto"], images["none"])


def test_cuda_motion_blur_static_tracks_equal_the_unblurred_render(cuda):
    from spectral_tpu_torch.render import animation as tanim

    anim = tanim.Animation(_scene("cornell", 32, 24, 3, iters=4), 1, [
        tanim.Track("camera.fov_y_deg", [(0.0, 60.0), (1.0, 60.0)])])
    blurred = Renderer(anim.scene_at(0), device="cuda",
                       _scene_schedule=_blur_schedule(anim, 0.5)).render()
    assert np.array_equal(blurred, Renderer(anim.scene_at(0), device="cuda",
                                            regen_frames=1).render())


def test_cuda_aovs_and_denoiser_match_the_cpu(cuda):
    """AOVs on the card against the CPU from the same primaries (each
    device's own raygen may differ by an ulp, which can flip a silhouette
    pixel): obj_id exactly, the rest within 1e-5 of their scale; the
    denoiser within 1e-4 of the image's scale."""
    from spectral_tpu_torch.ops.vecmath import Vec3
    from spectral_tpu_torch.render import aov, denoise

    scene = _scene("cornell", 48, 32, 3)
    st_c, cfg = flatten_scene(scene, "cpu")
    o, d = aov.pixel_centre_rays(st_c, cfg)
    want = {k: v.numpy() for k, v in aov.aov_buffers(st_c, cfg, o, d).items()}
    st_g, _ = flatten_scene(scene, cuda)
    got = {k: v.cpu().numpy() for k, v in aov.aov_buffers(
        st_g, cfg, Vec3(*(c.to(cuda) for c in o)), Vec3(*(c.to(cuda) for c in d))).items()}
    assert np.array_equal(got["obj_id"], want["obj_id"])
    hit = want["obj_id"] >= 0
    for k in ("depth", "normal", "albedo"):
        scale = max(1.0, float(np.abs(want[k][hit]).max()))
        assert float(np.abs(got[k][hit] - want[k][hit]).max()) <= 1e-5 * scale, k
    rgb = np.random.default_rng(0).uniform(0, 2, (32, 48, 3)).astype(np.float32)
    args = (rgb, want["depth"], want["normal"], want["albedo"])
    dn_cuda = denoise.atrous_denoise(*args, device="cuda")
    dn_cpu = denoise.atrous_denoise(*args, device="cpu")
    assert float(np.abs(dn_cuda - dn_cpu).max()) <= 1e-4 * float(np.abs(dn_cpu).max())


def _many_materials(n, samples, features=False):
    """sphere_field(n) with a material of its own per object; with
    ``features`` every 7th sphere glass and every 11th emissive (the
    feature build, whose material rows are 2S + 5 floats)."""
    scene = torch_scenes.one_material_each(
        schema, torch_scenes.sphere_field(presets, n, 32, 24, 3, samples=samples))
    if features:
        sky = scene.spectra[0]
        for i, obj in enumerate(scene.objects[1:], start=1):
            if i % 7 == 0:
                obj.material.transmission, obj.material.ior = 1.0, 1.5
            if i % 11 == 0:
                obj.material.emission = sky
    return scene


@pytest.mark.parametrize("n,samples,features,shared", [
    (300, 32, False, True), (1000, 64, False, False), (500, 64, True, False),
    (100, 64, True, True)])
def test_cuda_kernels_with_many_materials_match_plain(cuda, n, samples, features, shared):
    """More than 256 materials on every bounce kernel, bit for bit with
    the plain versions: the material rows in shared memory while the
    whole table fits a block's, else read from global memory (albedo,
    and in the feature build the feature scalars and emission)."""
    port, cfg = flatten_scene(_many_materials(n, samples, features), cuda)
    tb = mk.pack_tables(port, cfg)
    assert cfg.n_materials == n + 1 and tb.materials_shared() is shared
    assert bool(tb.features) is features
    checks, _ = torch_scenes.kernel_checks(tb, lane_perm=morton_layout(32, 24, cuda)[0])
    assert all(checks.values()), checks


@pytest.mark.parametrize("case", ["regen", "mono", "clustered_morton", "persist"])
def test_cuda_sharded_render_equals_unsharded(cuda, case):
    """Row slabs on one card (``make_mesh(4)``): each slab's kernels on its
    global rows give the unsharded render bit for bit (regeneration, frame
    by frame, a clustered scene on Morton lanes per slab, and persist with
    one MIN per launch), and every slab launches its own kernels."""
    from spectral_tpu_torch.parallel.mesh import make_mesh, row_sharding

    kw = {"regen": {}, "mono": {"regen_frames": 1}, "clustered_morton": {},
          "persist": {"persist": True, "persist_budget": 40}}[case]

    def make():
        if case == "clustered_morton":
            return torch_scenes.sphere_field(presets, 100, 32, 32, 3, iters=3)
        return _scene("cornell", 32, 32, 4, iters=5)

    want = Renderer(make(), device="cuda", **kw).render()
    mesh = make_mesh(4)
    assert mesh.size == 4 and all(s.device.type == "cuda" for s in mesh.slots)
    n = _Launches()
    r = Renderer(make(), device="cuda", sharding=row_sharding(mesh), **kw)
    got = r.render()
    assert np.array_equal(got, want)
    counts = {f"run_{k}": n(k) for k in ("regen", "mono", "persist", "cost")}
    if case == "persist":
        info = r.persist_info
        assert info["n_devices"] == 4 and info["min_reductions"] == info["launches"]
        assert counts["run_persist"] >= 4 * info["launches"]
    elif case == "mono":
        assert counts["run_mono"] == 4 * 5
    else:
        assert counts["run_regen"] == 4


def test_cuda_frames_per_dispatch_equals_one(cuda):
    want = Renderer(_scene("cornell", 32, 16, 4, iters=6), device="cuda",
                    regen_frames=1).render()
    got = Renderer(_scene("cornell", 32, 16, 4, iters=6), device="cuda",
                   frames_per_dispatch=4).render()
    assert np.array_equal(got, want)


def test_cuda_refuses_the_grid(cuda):
    with pytest.raises(ValueError, match="CPU-only"):
        Renderer(_scene("cornell", 8, 8, 1), device="cuda", accel="grid")
