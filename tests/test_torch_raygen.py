"""The regeneration kernel's own raygen (``cuda_regen`` computes every
frame's primaries from the camera table and the frames' Hammersley
offsets) on the CPU.

``camera.primary_directions``, the plain twin of the kernel's
``primary_direction``, equals ``generate_primary_rays`` bit for bit for
every frame of a K = 8 window, on row-major and Morton-permuted lanes:
one ulp would flip an un-offset diffuse self-hit. ``run_regen_plain`` with
its new arguments (lane pixels, camera table, Hammersley table) equals
its earlier plane-fed form (frame 0's primary planes, then the camera and
the direction planes of frames 1..K-1, as the earlier kernel took them)
bit for bit, and the reference package's Pallas regeneration kernel (run
as its own tests run it, ``interpret=True``) to 1e-4 where paths are
deterministic, as ``tests/test_torch_megakernel.py`` holds it.
"""

import numpy as np
import pytest
import torch

from spectral_tpu.render.pallas_integrator import integrate_frames_pallas_regen
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.ops.vecmath import Vec3
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render.camera import (
    camera_basis_table,
    generate_primary_rays,
    hammersley_table,
    pixel_coords,
    primary_directions,
)
from spectral_tpu_torch.render.integrator import bounce_loop
from spectral_tpu_torch.render.layout import morton_layout
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from tests import torch_scenes as ts
from tests.test_pallas_megakernel import _periscope_scene, _regen_scene

torch.set_num_threads(1)


@pytest.mark.parametrize("layout", ["rowmajor", "morton"])
@pytest.mark.parametrize("size", [(64, 48), (37, 23)])
def test_primary_directions_equal_host_raygen(size, layout):
    w, h = size
    st, cfg = flatten_scene(ts.preset(presets, "cornell", w, h, 3, iters=8), "cpu")
    table = camera_basis_table(st, cfg)
    offsets = hammersley_table(0, 8, cfg.intended_frames)
    assert offsets.shape == (8, 2) and offsets.dtype == torch.float32
    perm = morton_layout(w, h)[0] if layout == "morton" else torch.arange(w * h)
    px, py = (c[perm] for c in pixel_coords(w, h, "cpu"))
    for j in range(8):
        _, d, _, _ = generate_primary_rays(st.cam_pos, st.cam_dir, st.cam_up, st.fov_y_deg,
                                           w, h, j, cfg.intended_frames)
        got = primary_directions(px, py, table, offsets[j, 0], offsets[j, 1])
        for a, b in zip(got, d):
            assert torch.equal(a, b[perm]), (j, layout)


def _plane_fed(st, cfg, first, k, perm):
    """The earlier ``run_regen_plain``: frame 0 from its primary planes,
    frame j from the camera position and frame j's direction planes,
    one radiance accumulator through the K frames."""
    planes, px, py = ci.primary_lanes(st, cfg, first)
    px, py = px.long()[perm], py.long()[perm]
    rad = bounce_loop(Vec3(*(p[perm] for p in planes[:3])),
                      Vec3(*(p[perm] for p in planes[3:])), px, py, first, st, cfg)
    n = px.shape[0]
    cam = Vec3(*(c.expand(n) for c in st.cam_pos[:3]))
    for j in range(1, k):
        d = ci.primary_lanes(st, cfg, first + j)[0][3:]
        rad = bounce_loop(cam, Vec3(*(c[perm] for c in d)), px, py, first + j, st, cfg,
                          radiance=rad)
    return rad.T.contiguous()


@pytest.mark.parametrize("case", ["cornell_rowmajor", "field_morton", "periscope"])
def test_plain_regen_equals_plane_fed_form(case):
    if case == "cornell_rowmajor":
        scene, morton = ts.preset(presets, "cornell", 16, 12, 3, iters=4), False
    elif case == "field_morton":
        scene, morton = ts.sphere_field(presets, 80, 16, 12, 3, iters=4), True
    else:
        scene, morton = ts.periscope(schema, presets), False
    st, cfg = flatten_scene(scene, "cpu")
    tb = mk.pack_tables(st, cfg)
    n = cfg.width * cfg.height
    perm = morton_layout(cfg.width, cfg.height)[0] if morton else torch.arange(n)
    args = ci.regen_args(st, cfg, 1, 3, perm if morton else None)
    got = mk.run_regen(*args, tb)  # CPU tensors: the plain version, uncounted
    assert torch.equal(got, mk.run_regen_plain(*args, tb))
    assert torch.equal(got, _plane_fed(st, cfg, 1, 3, perm))


@pytest.mark.parametrize("case", ["direct", "periscope"])
def test_plain_regen_new_arguments_match_pallas_regen(case):
    scene = _periscope_scene() if case == "periscope" else _regen_scene()
    if case == "direct":
        scene.nbr_of_ray_bounces = 1
    scene.nbr_of_iterations = 3
    arrays, config = jax_flatten(scene)
    st, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    want = np.asarray(integrate_frames_pallas_regen(
        arrays, config, np.uint32(0), tuple(arrays.host.obj_type.tolist()), 3,
        interpret=True), np.float64)
    rad = mk.run_regen_plain(*ci.regen_args(st, cfg, 0, 3), mk.pack_tables(st, cfg))
    got = ci._to_rgb(rad, st, cfg).numpy().astype(np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4
