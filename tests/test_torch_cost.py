"""The port's path-cost probe (``probe_path_cost`` over the plain version of
``run_cost``) against the reference package's ``probe_path_cost`` run in
interpret mode, and the two consumers of its permutation, which must be
pure relabelings.

Tolerances: on the periscope every path is deterministic, so per-pixel
costs are equal; on the 3-bounce Cornell box diffuse self-hit coins flip
between the two samplers (see tests/test_torch_megakernel.py), so the
mean cost is held to 5%. ``cost_sort`` (persist) and ``regen_sort``
(Renderer) only change which lane traces a pixel, and raygen and the RNG
are elementwise in the pixel, so their images are bit-identical to the
unsorted ones on the CPU.
"""

import numpy as np
import pytest
import torch

from spectral_tpu.render.pallas_integrator import probe_path_cost as jax_probe
from spectral_tpu.scene import presets as jax_presets
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.ops import megakernel as mk
from spectral_tpu_torch.render import cuda_integrator as ci
from spectral_tpu_torch.render import renderer as trender
from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene.flatten import RenderConfig, flatten_scene, from_numpy
from spectral_tpu_torch.scene import presets
from tests.test_pallas_megakernel import _periscope_scene

torch.set_num_threads(1)


def _cornell(w=32, h=24, bounces=3, iters=8, P=presets):
    """The Cornell box, built with the port's presets (``P=jax_presets``
    for the reference's)."""
    scene = P.PRESETS["cornell"](n_samples=8)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def _pair(scene):
    arrays, config = jax_flatten(scene)
    port, cfg = from_numpy(arrays.host.np_fields, RenderConfig(**vars(config)), "cpu")
    return arrays, config, port, cfg, tuple(np.asarray(arrays.obj_type).tolist())


def test_probe_matches_jax_on_periscope():
    scene = _periscope_scene()
    scene.nbr_of_iterations = 6
    arrays, config, port, cfg, obj_types = _pair(scene)
    want = np.asarray(jax_probe(arrays, config, obj_types, n_probe_frames=2, interpret=True))
    got = ci.probe_path_cost(port, cfg, n_probe_frames=2)
    assert got.shape == (cfg.width * cfg.height,) and got.dtype == torch.float32
    assert (got.numpy() == want).all()
    assert set(np.unique(want)) > {2.0}  # mirror chains cost more than one bounce


def test_probe_mean_within_five_percent_on_cornell():
    arrays, config, port, cfg, obj_types = _pair(_cornell(P=jax_presets))
    want = np.asarray(jax_probe(arrays, config, obj_types, n_probe_frames=1, interpret=True))
    got = ci.probe_path_cost(port, cfg, n_probe_frames=1).numpy()
    assert abs(got.mean() / want.mean() - 1.0) <= 0.05
    assert got.min() >= 1.0 and got.max() <= cfg.max_bounces


def test_run_cost_radiance_is_the_mono_radiance():
    port, cfg = flatten_scene(_cornell(16, 8, bounces=4), "cpu")
    tb = mk.pack_tables(port, cfg)
    planes, px, py = ci.primary_lanes(port, cfg, 1)
    before = trace.total("launch.cost")
    rad, cost = mk.run_cost(*planes, px, py, 1, tb)
    assert trace.total("launch.cost") == before  # CPU tensors: the plain version
    assert torch.equal(rad, mk.run_mono_plain(*planes, px, py, 1, tb))
    # every live iteration decrements the budget once, frozen at death
    assert cost.dtype == torch.float32
    assert float(cost.min()) >= 1.0 and float(cost.max()) <= cfg.max_bounces


def test_cost_sort_is_pure_relabeling():
    port, cfg = flatten_scene(_cornell(bounces=4), "cpu")
    tb = mk.pack_tables(port, cfg)
    plain, _ = ci.render_persistent(port, cfg, 6, tb, budget=64)
    sorted_, _ = ci.render_persistent(port, cfg, 6, tb, budget=64, cost_sort=2)
    assert torch.equal(plain, sorted_)
    order, inv = ci.cost_sort_perm(torch.tensor([1.0, 3.0, 3.0, 2.0]))
    assert order.tolist() == [1, 2, 3, 0] and inv.tolist() == [3, 0, 1, 2]  # stable


def test_regen_sort_is_pure_relabeling():
    def render(sort):
        r = trender.Renderer(_cornell(bounces=3, iters=4), device="cpu", regen_sort=sort)
        return r, r.render()

    r0, want = render(False)
    r1, got = render(True)
    assert r1.regen_sort and r1._lane_perm is not None
    assert not torch.equal(r1._lane_perm, torch.arange(r1._lane_perm.numel()))
    assert (got == want).all()
    # the radiance itself, un-permuted, is the unsorted launch's bit for bit
    port, cfg, tb = r1.scene_tensors, r1.config, r1.tables
    rad = ci.regen_radiance(port, cfg, 0, 4, tb, r1._lane_perm)
    assert torch.equal(rad[:, r1._lane_inv], ci.regen_radiance(port, cfg, 0, 4, tb))


@pytest.mark.parametrize("bounces", [3, 6])
def test_plain_cost_per_pixel_results_ignore_the_lane_order(bounces):
    """``cuda_cost`` shares ``cuda_mono``'s resident grid: its radiance and
    cost planes under a random pixel-to-lane permutation (numpy, seeded),
    un-permuted, equal the identity layout's bit for bit."""
    port, cfg = flatten_scene(_cornell(16, 8, bounces=bounces), "cpu")
    tb = mk.pack_tables(port, cfg)
    planes, px, py = ci.primary_lanes(port, cfg, 2)
    perm = torch.from_numpy(np.random.default_rng(bounces).permutation(px.numel()))
    inv = torch.argsort(perm)
    want_rad, want_cost = mk.run_cost_plain(*planes, px, py, 2, tb)
    rad, cost = mk.run_cost_plain(*(p[perm] for p in planes), px[perm], py[perm], 2, tb)
    assert torch.equal(rad[:, inv], want_rad) and torch.equal(cost[inv], want_cost)
    assert len(set(want_cost.tolist())) > 1  # paths of unequal length
