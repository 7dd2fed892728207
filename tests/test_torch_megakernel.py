"""The port's bounce kernels (``spectral_tpu_torch.ops.megakernel``).

On the CPU the wrappers run their plain versions (the eager bounce loop),
which are held here against the reference package's Pallas kernels, run
the way its own tests run them (``interpret=True``): direct-only and the
periscope's specular chain to 1e-5 of the image scale; the 3-bounce
Cornell box to the coin-flip envelope of tests/test_pallas_megakernel.py
(at most 15% of pixels off by more than 1e-3), and at least 80% of pixels
to 1e-5 (the Pallas kernel's asin-free sampler and rsqrt flip 7-13% of
these pixels against the port's jnp-form sampler, measured); the
regeneration sum (K=3) to 1e-4 where paths are deterministic and to 2% of
the image mean on the 4-bounce scene.

The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu.render.pallas_integrator import (
    integrate_frame_pallas,
    integrate_frames_pallas_regen,
)
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.runtime import build, trace
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from spectral_tpu_torch.scene import presets, schema
from tests import torch_scenes
from tests.test_pallas_megakernel import _periscope_scene, _regen_scene

torch.set_num_threads(1)


def _scene(name, w, h, bounces, samples=8, iters=2, P=presets):
    """A preset built with the port's presets (``P=jax_presets`` for the
    reference's)."""
    scene = P.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg, tuple(arrays.host.obj_type.tolist())


def _rel_err(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    return np.abs(got - want).max(axis=-1) / scale


# ----------------------------------------------------------------- packing


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_pack_tables_layout(name):
    port, cfg = flatten_scene(_scene(name, 4, 4, 1), "cpu")
    tb = mk.pack_tables(port, cfg)
    assert tb.geom.shape == (mk.GEOM_ROWS, cfg.n_objects)
    rows = sorted(r for _, row, w in mk.GEOM_LAYOUT for r in range(row, row + w))
    assert rows == list(range(mk.GEOM_ROWS))  # every row owned exactly once
    for field, row, width in mk.GEOM_LAYOUT:
        want = np.asarray(port.np_fields[field], np.float32).reshape(cfg.n_objects, width)
        assert np.array_equal(tb.geom[row:row + width].T.numpy(), want), field
    # the kernels read albedo through the material id: the per-object
    # albedo bit for bit
    assert torch.equal(tb.mat_albedo[port.mat_id.long()], port.albedo)
    assert torch.equal(tb.lspec, port.light_spec)
    assert torch.equal(tb.lpos[:, :3], port.light_pos)
    assert torch.equal(tb.cam[:3], port.cam_pos)
    for t in (tb.geom, tb.mat_albedo, tb.runs, tb.lpos, tb.lspec, tb.cam):
        assert t.dtype == torch.float32 and t.is_contiguous()


def test_geom_rows_mirror_the_cuda_header():
    """The packer's rows and the kernel's G_* constants are one layout."""
    import re

    header = (mk.build.CSRC_DIR / "megakernel.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (G_\w+) = (\d+);", header)}
    names = {
        "obj_type": "G_TYPE", "slab_min": "G_SLAB_MIN", "slab_max": "G_SLAB_MAX",
        "shift": "G_SHIFT", "inv_rot": "G_INV_ROT", "rot": "G_ROT",
        "aabb_min": "G_AABB_MIN", "aabb_max": "G_AABB_MAX", "center": "G_CENTER",
        "half_dim": "G_HALF", "sphere_pos": "G_SPHERE_POS", "radius": "G_RADIUS",
        "metallicness": "G_METAL", "roughness": "G_ROUGH", "mat_id": "G_MATID",
    }
    for field, row, _ in mk.GEOM_LAYOUT:
        assert consts[names[field]] == row, field
    assert int(re.search(r"GEOM_ROWS = (\d+);", header).group(1)) == mk.GEOM_ROWS


# ------------------------------------------- plain versions vs the Pallas kernels


@pytest.mark.parametrize("name", ["default", "cornell"])
def test_plain_mono_direct_only_matches_pallas(name):
    arrays, config, port, cfg, obj_types = _pair(_scene(name, 16, 8, bounces=1, P=jax_presets))
    want = np.asarray(integrate_frame_pallas(arrays, config, np.uint32(0), obj_types,
                                             interpret=True))
    got = ci.integrate_frame_cuda(port, cfg, 0).numpy()
    assert float(_rel_err(got, want).max()) <= 1e-5


def test_plain_mono_periscope_matches_pallas():
    arrays, config, port, cfg, obj_types = _pair(_periscope_scene())
    for frame in (0, 1):
        want = np.asarray(integrate_frame_pallas(arrays, config, np.uint32(frame),
                                                 obj_types, interpret=True))
        got = ci.integrate_frame_cuda(port, cfg, frame).numpy()
        assert float(want.max()) > 0.1
        assert float(_rel_err(got, want).max()) <= 1e-5


def test_plain_mono_multibounce_within_coin_flip_envelope():
    """Pooled over 4 frames of 32x16 (a single 128-pixel frame is too few
    to bound a rate near 10%: measured pooled 10.3% flipped, 88.8% to
    1e-5, 4-frame mean within 2%)."""
    arrays, config, port, cfg, obj_types = _pair(_scene("cornell", 32, 16, bounces=3, P=jax_presets))
    errs = []
    for frame in range(4):
        want = np.asarray(integrate_frame_pallas(arrays, config, np.uint32(frame),
                                                 obj_types, interpret=True))
        got = ci.integrate_frame_cuda(port, cfg, frame).numpy()
        errs.append(_rel_err(got, want))
    err = np.concatenate(errs)
    assert float((err > 1e-3).mean()) <= 0.15
    assert float((err <= 1e-5).mean()) >= 0.80


@pytest.mark.parametrize("case", ["direct", "periscope", "four_bounces"])
def test_plain_regen_matches_pallas_regen(case):
    scene = _periscope_scene() if case == "periscope" else _regen_scene()
    if case == "direct":
        scene.nbr_of_ray_bounces = 1
    scene.nbr_of_iterations = 3
    arrays, config, port, cfg, obj_types = _pair(scene)
    want = np.asarray(integrate_frames_pallas_regen(
        arrays, config, np.uint32(0), obj_types, 3, interpret=True), np.float64)
    got = ci.integrate_frames_cuda_regen(port, cfg, 0, 3).numpy().astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    if case == "four_bounces":  # mirror cones: chaotic across compilers
        assert abs(got.mean() / want.mean() - 1.0) <= 0.02
    else:
        assert float(np.abs(got - want).max()) <= 1e-4


def test_plain_regen_is_the_sum_of_mono_frames():
    port, cfg = flatten_scene(torch_scenes.regen_scene(presets), "cpu")
    mono = sum(ci.integrate_frame_cuda(port, cfg, f).double() for f in range(3))
    regen = ci.integrate_frames_cuda_regen(port, cfg, 0, 3).double()
    assert float((regen - mono).abs().max()) <= 1e-4  # f32 summation order only


# ---------------------------------------------------------- wrapper contract


def _lanes(scene, frame=0, device="cpu"):
    port, cfg = flatten_scene(scene, device)
    tb = mk.pack_tables(port, cfg)
    planes, px, py = ci.primary_lanes(port, cfg, frame)
    return planes, px, py, tb


def test_cpu_tensors_run_the_plain_version_without_counting():
    planes, px, py, tb = _lanes(_scene("cornell", 8, 4, bounces=2))
    mono0, regen0 = trace.total("launch.mono"), trace.total("launch.regen")
    got = mk.run_mono(*planes, px, py, 0, tb)
    assert torch.equal(got, mk.run_mono_plain(*planes, px, py, 0, tb))
    assert got.shape == (8, 32)
    args = ci.regen_args(tb.scene, tb.config, 0, 2)
    got = mk.run_regen(*args, tb)
    assert torch.equal(got, mk.run_regen_plain(*args, tb))
    assert (trace.total("launch.mono"), trace.total("launch.regen")) == (mono0, regen0)


def test_regen_wants_two_frames_and_known_devices():
    planes, px, py, tb = _lanes(_scene("cornell", 8, 4, bounces=1))
    with pytest.raises(ValueError, match="k >= 2"):
        mk.run_regen(*ci.regen_args(tb.scene, tb.config, 0, 1), tb)
    meta = [p.to("meta") for p in planes]
    with pytest.raises(ValueError, match="no bounce kernel"):
        mk.run_mono(*meta, px, py, 0, tb)


def _lane_permutation(n, seed):
    """A random lane order (numpy, seeded) and its inverse: lane j of the
    permuted layout carries the identity layout's lane perm[j]."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(n))
    assert not torch.equal(perm, torch.arange(n))
    return perm, torch.argsort(perm)


@pytest.mark.parametrize("name,bounces", [("cornell", 3), ("default", 4)])
def test_plain_mono_per_pixel_results_ignore_the_lane_order(name, bounces):
    """What ``cuda_mono``'s resident grid relies on: a pixel's path is the
    same bits whatever lane carries it, so lanes may take their pixels in
    any order. The plain version under a random pixel-to-lane permutation,
    un-permuted, equals the identity layout's."""
    planes, px, py, tb = _lanes(_scene(name, 16, 8, bounces=bounces), frame=1)
    perm, inv = _lane_permutation(px.numel(), seed=8)
    want = mk.run_mono_plain(*planes, px, py, 1, tb)
    got = mk.run_mono_plain(*(p[perm] for p in planes), px[perm], py[perm], 1, tb)
    assert torch.equal(got[:, inv], want)


def test_persist_streams_in_its_register_build_where_records_stay_in_global_memory():
    """``cuda_persist`` keeps its spectral state in shared memory, except
    on many-object tables whose packed records stay in global memory
    (mesh5k's): there the register build, with the state in registers,
    at every S and with features; the other kernels keep their library."""
    mesh5k = {s: mk.pack_tables(*flatten_scene(torch_scenes.preset(presets, "mesh5k", 8, 8, 1,
                                                                   1, s), "cpu"))
              for s in (32, 64)}
    mesh = mk.pack_tables(*flatten_scene(torch_scenes.preset(presets, "mesh", 8, 8, 1, 1, 32),
                                         "cpu"))
    assert not mesh5k[32].packed_shared and mesh.packed_shared and mesh.many_objects()
    assert mk.library_for("persist", mesh5k[32]) == "persist_reg"
    assert mk.library_for("persist", mesh5k[64]) == "persist_tri_reg"
    glass = dataclasses.replace(mesh5k[64], features=1)  # the dielectric's feature bit
    assert mk.library_for("persist", glass) == "persist_fx_tri_reg"
    assert mk.library_for("mono", mesh5k[32]) == "mono"
    assert mk.library_for("persist", mesh) == "persist"
    small = mk.pack_tables(*flatten_scene(_scene("cornell", 8, 4, 1), "cpu"))
    assert mk.library_for("persist", dataclasses.replace(small, packed_shared=False)) == "persist"
    assert build.kind_of("persist_reg") == ("persist_reg",)
    assert set(build.REGISTER_LIBRARIES) <= set(build.RENDER_LIBRARIES)


@pytest.mark.parametrize("name,samples,fits,crowded", [
    ("cornell", 64, 200, 240), ("prism", 64, 200, 240), ("cornell", 32, 280, 320)])
def test_persist_takes_its_register_build_where_the_state_leaves_no_room(
        name, samples, fits, crowded):
    """Small-scene tables that fit a block's shared memory but leave no
    room for the spectral state after them (some hundreds of lights) take
    the register build, with features too; a few lights fewer keep the
    default build, and the other kernels keep theirs."""
    def tables(n_lights):
        sc = torch_scenes.many_lights(schema, presets, name, n_lights, 8, 4, 1, samples)
        return mk.pack_tables(*flatten_scene(sc, "cpu"))

    room, full = tables(fits), tables(crowded)
    state = mk.persist_state_bytes(samples)
    assert state == 2 * samples * mk.BLOCK * 4
    assert not full.many_objects() and full.smem_bytes() <= mk.MAX_SMEM
    assert full.smem_bytes() + state > mk.MAX_SMEM >= room.smem_bytes() + state
    fx = "_fx" if name == "prism" else ""
    assert mk.library_for("persist", full) == f"persist{fx}_reg"
    assert mk.library_for("persist", room) == f"persist{fx}"
    assert mk.library_for("mono", full) == f"mono{fx}"


# ------------------------------------ the radiance bins of regen, mono and cost at S = 64

KERNELS = ("regen", "mono", "cost")
LIBRARIES = {"regen": ("regen", "regen_lens"), "mono": ("mono", "mono_fx"),
             "cost": ("mono", "mono_fx")}


@pytest.fixture
def bins_blocks(monkeypatch):
    """Stub occupancy counts for ``shared_bins`` (the CPU has no kernel
    to ask): ``counts[shared]`` blocks per SM, each query recorded; the
    rule's cache is emptied before and after."""
    counts, asked = {}, []

    def blocks(kernel, library, n_samples, many, tri, shared, smem):
        asked.append((kernel, library, n_samples, many, tri, shared, smem))
        return counts[shared]

    monkeypatch.setattr(mk, "_bins_blocks", blocks)
    mk._shared_bins.cache_clear()
    yield counts, asked
    mk._shared_bins.cache_clear()


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shared,registers,takes", [(3, 2, True), (4, 2, True), (2, 2, False),
                                                    (1, 2, False)])
def test_regen_takes_shared_bins_where_they_hold_more_blocks(bins_blocks, shared, registers,
                                                             takes, kernel):
    """At S = 64 ``cuda_regen``, ``cuda_mono`` and ``cuda_cost`` take the
    build with their radiance bins in shared memory where the occupancy
    API gives it more resident blocks per SM than the register build; a
    tie or fewer keep registers. The answer is cached per kernel,
    library, S, kind and table bytes: asked once."""
    counts, asked = bins_blocks
    counts.update({True: shared, False: registers})
    tb = mk.pack_tables(*flatten_scene(_scene("cornell", 8, 4, 1, samples=64), "cpu"))
    libraries = LIBRARIES[kernel]
    for library in (libraries[0], *libraries):
        assert mk.shared_bins(kernel, library, tb) is takes
    smem = tb.smem_bytes()
    assert sorted(asked) == sorted((kernel, lib, 64, False, 0, sh, smem)
                                   for lib in libraries for sh in (False, True))


@pytest.mark.parametrize("kernel", KERNELS)
def test_regen_keeps_registers_without_room_or_below_s64(bins_blocks, kernel):
    """Where the kernel's info entry counts no resident block of the
    shared-bins build (tables that leave its bins no room, as 280 lights
    at S = 64 do; every S below 64, which has no such build) the launch
    keeps the register build, after that one query, once per key."""
    counts, asked = bins_blocks
    counts.update({True: 0, False: 1})
    sc = torch_scenes.many_lights(schema, presets, "cornell", 280, 8, 4, 1, 64)
    full = mk.pack_tables(*flatten_scene(sc, "cpu"))
    tables = [full] + [mk.pack_tables(*flatten_scene(_scene("cornell", 8, 4, 1, samples=s),
                                                     "cpu")) for s in (8, 16, 32)]
    library = LIBRARIES[kernel][0]
    for tb in tables + tables:
        assert not mk.shared_bins(kernel, library, tb)
    assert asked == [(kernel, library, tb.config.n_samples, False, 0, True, tb.smem_bytes())
                     for tb in tables]
    assert full.smem_bytes() <= mk.MAX_SMEM


def _stub_launch(kernel, taken):
    """A stand-in for ``_launch_regen`` or ``_launch_mono`` (the CPU has no
    kernel): zeros, and the build ``shared_bins`` takes; each library
    recorded in ``taken``."""
    if kernel == "regen":
        def launch(library, px, *rest):
            taken.append(library)
            tables = rest[-1]
            out = torch.zeros((tables.config.n_samples, px.shape[0]))
            return out, mk.shared_bins("regen", library, tables)
        return launch

    def launch(library, ox, *rest, cost=False):
        taken.append(library)
        tables = rest[-1]
        out = torch.zeros((tables.config.n_samples, ox.shape[0]))
        plane = torch.zeros((ox.shape[0],)) if cost else None
        return out, plane, mk.shared_bins("cost" if cost else "mono", library, tables)
    return launch


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("samples,shared", [(64, True), (64, False), (32, False)])
def test_regen_counts_its_shared_bins_launches(bins_blocks, monkeypatch, samples, shared,
                                               kernel):
    """``run_regen``, ``run_mono`` and ``run_cost`` count ``launch.<kernel>``
    for every launch and ``launch.<kernel>_shared_bins`` for each that
    takes the shared build (the launch itself stubbed: the CPU has no
    kernel), exactly at S = 64 where it holds more blocks, never at
    S = 32."""
    counts, _ = bins_blocks
    counts.update({True: (3 if shared else 2) if samples == 64 else 0, False: 2})
    tb = mk.pack_tables(*flatten_scene(_scene("cornell", 8, 4, 1, samples=samples), "cpu"))
    taken = []
    monkeypatch.setattr(mk, "_on_cuda", lambda t: True)
    if kernel == "regen":
        monkeypatch.setattr(mk, "_launch_regen", _stub_launch(kernel, taken))
        args = (*ci.regen_args(tb.scene, tb.config, 0, 2), tb)
    else:
        monkeypatch.setattr(mk, "_launch_mono", _stub_launch(kernel, taken))
        planes, px, py = ci.primary_lanes(tb.scene, tb.config, 0)
        args = (*planes, px, py, 0, tb)
    run = {"regen": mk.run_regen, "mono": mk.run_mono, "cost": mk.run_cost}[kernel]
    names = (f"launch.{kernel}", f"launch.{kernel}_shared_bins")
    others = [f"launch.{k}_shared_bins" for k in KERNELS if k != kernel]
    before = [trace.total(n) for n in (*names, *others)]
    for _ in range(2):
        run(*args)
    assert taken == [LIBRARIES[kernel][0]] * 2
    got = [trace.total(n) - b for n, b in zip((*names, *others), before)]
    assert got == [2, 2 * int(shared), 0, 0]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shared", [True, False])
def test_launches_pass_their_build_to_the_entry(bins_blocks, monkeypatch, kernel, shared):
    """A launch passes the build the rule takes to its C entry as the int
    after the frame (``cuda_mono``, ``cuda_cost``) or after ``k``
    (``cuda_regen``), in the argument count ``_SIGNATURES`` declares (the
    entry stubbed: the CPU has no kernel)."""
    counts, _ = bins_blocks
    counts.update({True: 4 if shared else 2, False: 2})
    tb = mk.pack_tables(*flatten_scene(_scene("cornell", 8, 4, 1, samples=64), "cpu"))
    calls = []

    def entry(fn, tables, library=None, lens=False):
        calls.append(fn)
        return lambda *args: calls.append(args) or 0

    monkeypatch.setattr(mk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(mk, "_entry", entry)
    monkeypatch.setattr(mk, "_stream", lambda t: None)
    if kernel == "regen":
        mk.run_regen(*ci.regen_args(tb.scene, tb.config, 0, 2), tb)
    else:
        planes, px, py = ci.primary_lanes(tb.scene, tb.config, 0)
        (mk.run_mono if kernel == "mono" else mk.run_cost)(*planes, px, py, 3, tb)
    fn, args = calls
    head, n_ptrs = mk._SIGNATURES[fn][1]
    assert fn == f"spectral_{kernel}"
    assert len(args) == len(head) + len(mk._TABLE_ARGTYPES) + n_ptrs
    assert args[len(head) - 1] == int(shared)
    assert args[:4] == (32, 64, 1, 0 if kernel == "regen" else 3)


@pytest.mark.parametrize("kernel", KERNELS)
def test_bins_blocks_ask_the_kernels_info_entry(monkeypatch, kernel):
    """``_bins_blocks`` asks ``spectral_regen_info`` (S, kind, build,
    table bytes) or ``spectral_mono_info`` (S, kind, the cost form,
    build, table bytes) of the library, and reads its blocks per SM."""
    asked = []

    def info(src, library):
        def f(*args):
            asked.append((src, library, args[:-1]))
            args[-1][0] = 7
            return 0
        return f

    monkeypatch.setattr(mk, "_bins_info", info)
    library = LIBRARIES[kernel][1]
    assert mk._bins_blocks(kernel, library, 64, True, 1, True, 4096) == 7
    form = () if kernel == "regen" else (int(kernel == "cost"),)
    src = "regen" if kernel == "regen" else "mono"
    assert asked == [(src, library, (64, 1, 1, *form, 1, 4096))]


@pytest.mark.parametrize("name,features", [("prism", True), ("cornell", False)])
def test_launches_count_their_feature_builds(monkeypatch, name, features):
    """``run_regen`` counts ``launch.regen_features`` and ``run_mono``
    ``launch.mono_features`` for each launch of a feature build (the
    prism's), and none for a scene without features (the launches
    stubbed: the CPU has no kernel)."""
    tb = mk.pack_tables(*flatten_scene(_scene(name, 8, 4, 1, samples=64), "cpu"))
    assert bool(tb.features) is features

    def launch(library, px, *rest):
        assert build.has_features(library) is features
        return torch.zeros((tb.config.n_samples, px.shape[0])), True

    def launch_mono(library, ox, *rest):
        assert build.has_features(library) is features
        return torch.zeros((tb.config.n_samples, ox.shape[0])), None, False

    monkeypatch.setattr(mk, "_on_cuda", lambda t: True)
    monkeypatch.setattr(mk, "_launch_regen", launch)
    monkeypatch.setattr(mk, "_launch_mono", launch_mono)
    kinds = ("regen", "regen_features", "regen_shared_bins", "mono", "mono_features")
    before = [trace.total(f"launch.{k}") for k in kinds]
    mk.run_regen(*ci.regen_args(tb.scene, tb.config, 0, 2), tb)
    planes, px, py = ci.primary_lanes(tb.scene, tb.config, 0)
    for frame in range(2):
        mk.run_mono(*planes, px, py, frame, tb)
    got = [trace.total(f"launch.{k}") - b for k, b in zip(kinds, before)]
    assert got == [1, int(features), 1, 2, 2 * int(features)]
