"""What follows a render, in the port, against the JAX package on the CPU:
scene files (``utils/sceneio.py``), the EXR writer (``render/exr.py``),
the native u8 converter and PNG encoder (``runtime/native.py`` over the
port's own ``runtime/csrc/imagecodec.cpp``), the first-hit AOVs
(``render/aov.py``) and the à-trous denoiser (``render/denoise.py``).

Inputs come from a seed with numpy, at 32x24 to 64x48. Tolerances:

* scene dicts, flattened tables and EXR bytes: exact (copies of the same
  numpy code);
* the u8 conversion: exact; PNG: the native encoder and PIL's write other
  bytes for the same pixels (their own filters and deflate settings), so
  the PNGs are held pixel for pixel, and the port's native PNG byte for
  byte to a second native write;
* AOVs: given the reference's primary rays, ``obj_id``, ``depth`` and
  ``normal`` exactly equal to the reference's ops run op by op
  (``jax.disable_jit``), ``albedo`` within 1e-6 of its largest value (the
  CIE fold is a matmul whose summation order differs between the two
  libraries, as in ``test_torch_camera_color.py``). The reference's
  jitted ``compute_aovs`` is not its own ops: XLA's fusion moves t by
  ulps, which flips ``obj_id`` on a few silhouette pixels (6 of 1,536 on
  the Cornell box at 48x32). Against it, and whenever each package makes
  its own primaries (XLA's CPU ``tan`` is 1 ulp off at 60 degrees),
  ``obj_id`` may differ only on pixels next to another id, and depth,
  normal and albedo agree wherever both ids agree and no neighbour's
  differs, within 1e-3 relative, 1e-4 and 1e-6;
* the denoiser: against the reference's filter run op by op, rtol 1e-6
  and atol 1e-7; against its jitted filter rtol 5e-5 and atol 1e-6 (the
  jit itself differs from its ops by up to 1.8e-5 relative on these
  images: XLA fuses exp and pow into other roundings).
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from spectral_tpu.render import aov as jaov
from spectral_tpu.render import denoise as jdn
from spectral_tpu.render import exr as jexr
from spectral_tpu.render import image as jimage
from spectral_tpu.render.camera import generate_primary_rays as jax_rays
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene import schema as jschema
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu.utils import sceneio as jio
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import aov as taov
from spectral_tpu_torch.render import denoise as tdn
from spectral_tpu_torch.render import exr as texr
from spectral_tpu_torch.render import image as timage
from spectral_tpu_torch.runtime import native
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import FIELDS, flatten_numpy, flatten_scene
from spectral_tpu_torch.utils import sceneio
from tests import torch_scenes as ts
from tests.torch_exr import read_exr

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _tables_equal(got: dict, want: dict) -> None:
    for name in FIELDS:
        if want[name] is None:
            assert got[name] is None, name
        else:
            assert _bits(got[name], want[name]), name


# ------------------------------------------------------------------ sceneio

@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_scene_to_dict_equals_the_reference(name):
    got = sceneio.scene_to_dict(presets.PRESETS[name]())
    want = jio.scene_to_dict(jax_presets.PRESETS[name]())
    assert json.dumps(got) == json.dumps(want)


@pytest.mark.parametrize("name", ["default", "cornell", "prism", "mesh", "measured_sun"])
def test_save_load_round_trip_flattens_to_the_reference_tables(name, tmp_path):
    """The port's file, loaded by the port and by the reference, flattens
    to the reference preset's tables bit for bit, and the reference's
    file loads in the port the same way."""
    want = jax_flatten(jax_presets.PRESETS[name]())[0].host.np_fields
    path = tmp_path / "s.json"
    sceneio.save_scene(presets.PRESETS[name](), path)
    _tables_equal(flatten_numpy(sceneio.load_scene(path))[0], want)
    _tables_equal(jax_flatten(jio.load_scene(path))[0].host.np_fields, want)
    jio.save_scene(jax_presets.PRESETS[name](), path)
    _tables_equal(flatten_numpy(sceneio.load_scene(path))[0], want)


def test_custom_spectrum_and_edits_round_trip(tmp_path):
    """Twin of the reference's custom-spectrum and spectrum-edit cases."""
    def build(pres, sch):
        scene = pres.default_scene()
        n = scene.spectrum_number_of_samples
        vals = np.linspace(0.2, 0.8, n).astype(np.float32)
        custom = sch.SceneSpectrum.new("my custom", sch.Custom(),
                                       sch.SpectrumEffectType.REFLECTIVE, values=vals)
        scene.spectra.append(custom)
        scene.materials[0].spectrum = custom
        edited = np.zeros(n, np.float32)
        edited[: n // 2] = 1.0
        custom.edit(edited)
        custom.edit_sample(n - 1, 0.5)
        return scene

    path = tmp_path / "s.json"
    sceneio.save_scene(build(presets, schema), path)
    loaded = sceneio.load_scene(path)
    assert loaded.spectra[-1].name == "my custom"
    want = build(jax_presets, jschema)
    assert json.dumps(sceneio.scene_to_dict(loaded)) == json.dumps(jio.scene_to_dict(want))
    _tables_equal(flatten_numpy(loaded)[0], jax_flatten(want)[0].host.np_fields)


def test_dielectric_fields_round_trip_and_unknown_format():
    scene = presets.default_scene()
    scene.materials[0].ior = 1.8
    scene.materials[0].cauchy_b_um2 = 0.01
    loaded = sceneio.scene_from_dict(sceneio.scene_to_dict(scene))
    assert (loaded.materials[0].ior, loaded.materials[0].cauchy_b_um2) == (1.8, 0.01)
    with pytest.raises(ValueError, match="unsupported scene format"):
        sceneio.scene_from_dict({"format": "something/v9"})


# ---------------------------------------------------------------------- exr

def _hdr_image(h=37, w=11, c=4, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((h, w, c)).astype(np.float32) * 10.0
    img[0, 0, 0] = 1e6
    img[0, 1, 1] = -3.5
    img[1, 0, 2] = np.inf
    img[1, 1, 0] = np.nan
    return img


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("pixel_type", ["half", "float"])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_bytes_equal_the_reference(compression, pixel_type, channels, tmp_path):
    img = _hdr_image(c=channels, seed=channels)
    got = texr.write_exr(img, tmp_path / "port.exr", pixel_type=pixel_type,
                         compression=compression)
    want = jexr.write_exr(img, tmp_path / "ref.exr", pixel_type=pixel_type,
                          compression=compression)
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_exr_layers_bytes_equal_the_reference_and_read_back(compression, tmp_path):
    rng = np.random.default_rng(7)
    layers = {"": rng.standard_normal((20, 13, 4)).astype(np.float32),
              "normal": rng.standard_normal((20, 13, 3)).astype(np.float32),
              "depth": rng.standard_normal((20, 13)).astype(np.float32) * 100.0}
    got = texr.write_exr_layers(layers, tmp_path / "p.exr", pixel_type="float",
                                compression=compression)
    want = jexr.write_exr_layers(layers, tmp_path / "r.exr", pixel_type="float",
                                 compression=compression)
    assert got.read_bytes() == want.read_bytes()
    planes, channels, (w, h) = read_exr(got)
    assert (w, h) == (13, 20)
    assert [n for n, _ in channels] == sorted(
        [b"R", b"G", b"B", b"A", b"normal.R", b"normal.G", b"normal.B", b"depth.Z"])
    assert _bits(planes[b"R"], layers[""][..., 0])
    assert _bits(planes[b"normal.B"], layers["normal"][..., 2])
    assert _bits(planes[b"depth.Z"], layers["depth"])


def test_exr_half_saturates_and_float_is_bit_exact(tmp_path):
    img = _hdr_image(seed=1)
    planes, channels, _ = read_exr(texr.write_exr(img, tmp_path / "h.exr"))
    assert all(pt == 1 for _, pt in channels) and np.isposinf(planes[b"R"][0, 0])
    planes, _, _ = read_exr(texr.write_exr(img, tmp_path / "f.exr", pixel_type="float"))
    for name, ch in ((b"R", 0), (b"G", 1), (b"B", 2), (b"A", 3)):
        assert _bits(planes[name].view(np.uint32), img[..., ch].view(np.uint32))


def test_exr_validates(tmp_path):
    with pytest.raises(ValueError, match="H, W"):
        texr.write_exr(np.zeros((4, 4)), tmp_path / "x.exr")
    with pytest.raises(ValueError, match="pixel_type"):
        texr.write_exr(np.zeros((2, 2, 3)), tmp_path / "x.exr", pixel_type="double")
    with pytest.raises(ValueError, match="compression"):
        texr.write_exr(np.zeros((2, 2, 3)), tmp_path / "x.exr", compression="piz")
    with pytest.raises(ValueError, match="resolution"):
        texr.write_exr_layers({"": np.zeros((2, 2, 3)), "d": np.zeros((3, 2))},
                              tmp_path / "x.exr")
    with pytest.raises(ValueError, match="empty"):
        texr.write_exr_layers({}, tmp_path / "x.exr")


def test_save_image_exr_equals_the_reference(tmp_path):
    """``save_image`` dispatches ``.exr`` as the reference does: the
    linear buffer (display transform first when asked), same bytes."""
    accum = _hdr_image(h=12, w=16, seed=4)
    for kw in ({}, {"exposure": 2.0, "gamma": 2.2}):
        got = timage.save_image(accum, tmp_path / "p.exr", **kw)
        want = jimage.save_image(accum, tmp_path / "r.exr", **kw)
        assert got.read_bytes() == want.read_bytes(), kw


# ------------------------------------------------------------------- native

def test_native_source_is_the_reference_copy():
    port = REPO / "spectral_tpu_torch" / "runtime" / "csrc" / "imagecodec.cpp"
    assert port.read_text() == (REPO / "native" / "imagecodec.cpp").read_text()
    assert native._SRC == port  # built from the port's copy, never from native/
    assert native._LIB_PATH.parent == REPO / "spectral_tpu_torch" / "build"


def test_native_builds_and_converts_like_numpy():
    assert native.available(), "g++ could not build the port's imagecodec.cpp"
    rng = np.random.default_rng(0)
    data = rng.uniform(-0.5, 1.5, size=(33, 47, 4)).astype(np.float32)
    data[0, 0, 0], data[5, 5, 2], data[7, 3, 1] = np.nan, np.inf, -np.inf
    got = native.convert_f32_rgba_to_u8(data)
    want = jimage.accum_to_u8(data, native=False)
    assert got[0, 0, 0] == 0 and got[5, 5, 2] == 255 and got[7, 3, 1] == 0
    assert _bits(got, want)
    assert _bits(timage.accum_to_u8(data, native=True), want)
    assert _bits(timage.accum_to_u8(data, native=False), want)
    big = rng.uniform(0, 1, size=(512, 512, 4)).astype(np.float32)  # the threaded path
    assert _bits(native.convert_f32_rgba_to_u8(big), jimage.accum_to_u8(big, native=False))


def test_native_png_decodes_to_the_pil_pixels(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, size=(21, 37, 4), dtype=np.uint8)
    png = native.encode_png_rgba(u8)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert _bits(np.asarray(Image.open(io.BytesIO(png))), u8)
    accum = rng.uniform(-0.2, 1.3, (24, 32, 4)).astype(np.float32)
    n1 = timage.save_image(accum, tmp_path / "n1.png", native=True)
    n0 = timage.save_image(accum, tmp_path / "auto.png")
    pil = timage.save_image(accum, tmp_path / "pil.png", native=False)
    assert n1.read_bytes() == n0.read_bytes() == native.encode_png_rgba(
        jimage.accum_to_u8(accum, native=False))
    assert _bits(np.asarray(Image.open(n1)), np.asarray(Image.open(pil)))
    with pytest.raises(ValueError):
        native.encode_png_rgba(u8[..., :3])


def test_native_true_raises_when_the_build_fails(monkeypatch, tmp_path):
    def fail():
        raise native.NativeUnavailable("no compiler")

    monkeypatch.setattr(native, "load_imagecodec", fail)
    accum = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(native.NativeUnavailable):
        timage.accum_to_u8(accum, native=True)
    with pytest.raises(native.NativeUnavailable):
        timage.save_image(accum, tmp_path / "x.png", native=True)
    timage.save_image(accum, tmp_path / "y.png")  # None falls back to PIL
    assert timage.accum_to_u8(accum).dtype == np.uint8


# ---------------------------------------------------------------------- aov

def _aov_scene(pres, sch, name, w=48, h=32):
    if name == "field":
        return ts.sphere_field(pres, 100, w, h, 2)
    if name == "textured":
        return ts.textured(sch, pres, w=w, h=h)
    if name == "dof":
        return ts.with_lens(ts.preset(pres, "cornell", w, h, 2))
    return ts.preset(pres, name, w, h, 2)


def _ref_rays(scene):
    arrays, cfg = jax_flatten(scene)
    o, d, _px, _py = jax_rays(arrays.cam_pos, arrays.cam_dir, arrays.cam_up,
                              arrays.fov_y_deg, cfg.width, cfg.height,
                              frame_id=jnp.uint32(0), intended_frames=1)
    return (Vec3(*(torch.from_numpy(np.array(c)) for c in o)),
            Vec3(*(torch.from_numpy(np.array(c)) for c in d)))


def _edge(ids: np.ndarray) -> np.ndarray:
    """Pixels with a 4-neighbour of another id."""
    p = np.pad(ids, 1, mode="edge")
    c = p[1:-1, 1:-1]
    return ((p[:-2, 1:-1] != c) | (p[2:, 1:-1] != c)
            | (p[1:-1, :-2] != c) | (p[1:-1, 2:] != c))


AOV_SCENES = ["default", "cornell", "textured", "mesh", "field", "dof"]


@pytest.mark.parametrize("name", AOV_SCENES)
def test_aovs_equal_the_reference_ops_given_its_primaries(name):
    scene = _aov_scene(jax_presets, jschema, name)
    with jax.disable_jit():
        want = jaov.compute_aovs(scene)
    st, cfg = flatten_scene(_aov_scene(presets, schema, name), "cpu")
    got = {k: v.numpy() for k, v in taov.aov_buffers(st, cfg, *_ref_rays(scene)).items()}
    assert _bits(got["obj_id"], want["obj_id"])
    assert _bits(got["depth"], want["depth"])
    assert _bits(got["normal"], want["normal"])
    scale = max(1.0, float(np.abs(want["albedo"]).max()))
    assert float(np.abs(got["albedo"] - want["albedo"]).max()) <= 1e-6 * scale
    assert (got["obj_id"] >= 0).any() and (got["obj_id"] == -1).any() == np.isinf(
        got["depth"]).any()


@pytest.mark.parametrize("name", AOV_SCENES)
def test_compute_aovs_matches_the_reference_off_id_edges(name):
    want = jaov.compute_aovs(_aov_scene(jax_presets, jschema, name))
    got = taov.compute_aovs(_aov_scene(presets, schema, name), device="cpu")
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == {
        k: (v.dtype, v.shape) for k, v in want.items()}
    edge = _edge(want["obj_id"])
    differ = got["obj_id"] != want["obj_id"]
    assert not (differ & ~edge).any(), "obj_id differs off an id edge"
    ok = ~(differ | _edge(got["obj_id"]) | edge)
    d_got, d_want = got["depth"][ok], want["depth"][ok]
    fin = np.isfinite(d_want)
    assert _bits(np.isfinite(d_got), fin)
    assert np.allclose(d_got[fin], d_want[fin], rtol=1e-3, atol=0)
    assert np.abs(got["normal"][ok] - want["normal"][ok]).max() <= 1e-4
    assert np.abs(got["albedo"][ok] - want["albedo"][ok]).max() <= 1e-6 * max(
        1.0, float(np.abs(want["albedo"]).max()))


def test_aov_geometry_facts():
    """Twins of the reference's geometry cases: on the default preset at
    17x13 the optical-axis pixel hits the left sphere's front pole at
    depth 2 with normal (0, 0, -1); the top-centre ray misses; the
    bottom-centre ray lands on the floor; normals are unit where hit."""
    scene = presets.default_scene()
    scene.width, scene.height = 17, 13
    a = taov.compute_aovs(scene, device="cpu")
    assert a["obj_id"][6, 8] == 1
    assert a["depth"][6, 8] == pytest.approx(2.0, abs=1e-5)
    assert a["normal"][6, 8] == pytest.approx((0, 0, -1), abs=1e-5)
    assert a["obj_id"][0, 8] == -1 and np.isinf(a["depth"][0, 8])
    assert (a["normal"][0, 8] == 0).all() and (a["albedo"][0, 8] == 0).all()
    assert a["obj_id"][12, 8] == 3 and np.isfinite(a["depth"][12, 8])
    hit = a["obj_id"] >= 0
    assert np.allclose(np.linalg.norm(a["normal"][hit], axis=-1), 1.0, atol=1e-4)
    scene.objects = []
    empty = taov.compute_aovs(scene, device="cpu")
    assert (empty["obj_id"] == -1).all() and np.isinf(empty["depth"]).all()


def test_save_aovs_npy_png_and_exr_equal_the_reference(tmp_path):
    scene = presets.default_scene()
    scene.width, scene.height = 17, 13
    aovs = taov.compute_aovs(scene, device="cpu")
    written = taov.save_aovs(aovs, tmp_path / "p")
    jaov.save_aovs(aovs, tmp_path / "r")
    assert {p.name for p in written} == {f"{b}.{e}" for b in aovs for e in ("npy", "png")}
    for p in written:
        if p.suffix == ".npy":
            assert p.read_bytes() == (tmp_path / "r" / p.name).read_bytes(), p.name
    beauty = np.random.default_rng(0).random((13, 17, 4)).astype(np.float32)
    got = taov.save_aovs_exr(aovs, tmp_path / "p.exr", beauty=beauty)
    want = jaov.save_aovs_exr(aovs, tmp_path / "r.exr", beauty=beauty)
    assert got.read_bytes() == want.read_bytes()
    planes, channels, _ = read_exr(got)
    assert {b"R", b"A", b"depth.Z", b"normal.R", b"albedo.G", b"obj_id.Z"} <= {
        n for n, _ in channels}
    assert _bits(planes[b"depth.Z"], aovs["depth"])
    assert _bits(planes[b"obj_id.Z"], aovs["obj_id"].astype(np.float32))
    assert _bits(planes[b"R"], beauty[..., 0])


# ------------------------------------------------------------------ denoise

def _noisy_inputs(h, w, seed):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 2, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, (h, w)).astype(np.float32)
    depth[:3, :5] = np.inf
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[~np.isfinite(depth)] = 0.0
    albedo = rng.uniform(-0.1, 1, (h, w, 3)).astype(np.float32)
    return rgb, depth, n, albedo


@pytest.mark.parametrize("h,w,levels,demodulate", [
    (24, 32, 1, True), (24, 32, 5, True), (48, 64, 3, True), (48, 64, 5, False),
])
def test_atrous_denoise_matches_the_reference(h, w, levels, demodulate):
    args = _noisy_inputs(h, w, seed=h + levels)
    kw = dict(iterations=levels, demodulate=demodulate)
    got = tdn.atrous_denoise(*args, device="cpu", **kw)
    with jax.disable_jit():
        want_ops = jdn.atrous_denoise(*args, **kw)
    want_jit = jdn.atrous_denoise(*args, **kw)
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    assert np.allclose(got, want_ops, rtol=1e-6, atol=1e-7)
    assert np.allclose(got, want_jit, rtol=5e-5, atol=1e-6)


def test_taps_replicate_past_the_image_and_pow_keeps_zero():
    """At 5 levels the stride-16 stencil reaches 32 px past a 24-px image:
    replicate padding repeats the edge row as the reference's edge pad
    does; and a normal dot of 0 gives weight pow(0, 128) == 0."""
    a = torch.arange(24 * 8, dtype=torch.float32).reshape(24, 8)
    want = np.pad(a.numpy(), 32, mode="edge")
    for (k, view), (dy, dx) in zip(tdn._taps(a, 16, 24, 8),
                                   [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]):
        y0, x0 = 32 + 16 * dy, 32 + 16 * dx
        assert _bits(view.numpy(), want[y0:y0 + 24, x0:x0 + 8])
    assert float(torch.pow(torch.tensor(0.0), torch.tensor(128.0))) == 0.0
    assert float(jnp.power(jnp.float32(0.0), jnp.float32(128.0))) == 0.0


def _split_scene(h=64, w=64, noise=0.2, seed=0):
    rng = np.random.RandomState(seed)
    left = np.arange(w) < w // 2
    albedo = np.where(left[None, :, None], np.float32([0.8, 0.2, 0.2]),
                      np.float32([0.2, 0.2, 0.8])) * np.ones((h, w, 3), np.float32)
    illum = np.where(left[None, :, None], 0.5, 1.5).astype(np.float32) * np.ones(
        (h, w, 3), np.float32)
    depth = np.broadcast_to(np.where(left[None, :], 5.0, 11.0), (h, w)).astype(np.float32)
    normal = np.where(left[None, :, None], np.float32([0.0, 0.0, 1.0]),
                      np.float32([0.0, 1.0, 0.0])) * np.ones((h, w, 3), np.float32)
    clean = illum * albedo
    noisy = clean + rng.normal(0.0, noise, clean.shape).astype(np.float32)
    return noisy, clean, depth, normal, albedo


def test_denoise_reduces_noise_and_keeps_the_edge():
    """Twins of the reference's noise-reduction, edge and texture cases."""
    noisy, clean, depth, normal, albedo = _split_scene()
    out = tdn.atrous_denoise(noisy, depth, normal, albedo, device="cpu")
    assert float(np.mean((out - clean) ** 2)) < float(np.mean((noisy - clean) ** 2)) / 10
    w = depth.shape[1]
    np.testing.assert_allclose(out[:, : w // 2].mean(axis=(0, 1)),
                               clean[:, : w // 2].mean(axis=(0, 1)), atol=0.02)
    np.testing.assert_allclose(out[:, w // 2 - 1].mean(axis=0),
                               clean[:, : w // 2].mean(axis=(0, 1)), atol=0.06)
    checker = ((np.arange(32)[:, None] // 4 + np.arange(32)[None, :] // 4) % 2).astype(
        np.float32)
    alb = (0.2 + 0.6 * checker)[..., None] * np.ones((32, 32, 3), np.float32)
    nrm = np.zeros((32, 32, 3), np.float32)
    nrm[..., 2] = 1.0
    flat = tdn.atrous_denoise(alb, np.full((32, 32), 3.0, np.float32), nrm, alb,
                              device="cpu")
    np.testing.assert_allclose(flat, alb, atol=1e-5)
    with pytest.raises(ValueError):
        tdn.atrous_denoise(np.zeros((4, 4), np.float32), np.zeros((4, 4), np.float32),
                           nrm[:4, :4], alb[:4, :4], device="cpu")
    with pytest.raises(ValueError):
        tdn.atrous_denoise(alb[:4, :4], np.zeros((5, 4), np.float32), nrm[:4, :4],
                           alb[:4, :4], device="cpu")


def test_denoise_render_equals_the_reference_from_the_same_aovs():
    """A real render's framebuffer, denoised by each package from its own
    AOVs of the same scene: alpha passes through, the input is untouched,
    and the two agree within the jitted tolerance off the AOV id edges."""
    from spectral_tpu_torch.render.renderer import Renderer

    scene = ts.preset(presets, "default", 64, 48, 3)
    fb = Renderer(scene, device="cpu").render()
    before = fb.copy()
    got = tdn.denoise_render(scene, fb, device="cpu", iterations=3)
    assert _bits(fb, before) and _bits(got[..., 3], fb[..., 3])
    assert not np.array_equal(got[..., :3], fb[..., :3])
    want = jdn.denoise_render(ts.preset(jax_presets, "default", 64, 48, 3), fb, iterations=3)
    assert abs(float(got[..., :3].mean()) - float(fb[..., :3].mean())) < 0.05
    assert np.allclose(got, want, rtol=5e-5, atol=1e-6)
