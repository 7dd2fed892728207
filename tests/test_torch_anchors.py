"""The reference's correctness anchors, twinned for the port: its eager
integrator on the CPU (the plain path of every kernel) against the
scalar oracle's goldens and the seeded random scenes, with the
reference's own bounds (``tests/test_oracle_goldens.py``,
``tests/test_fuzz_scenes.py``).

* ``oracle_{default,cornell}_32x24_b1.npz``: direct-only frames are
  deterministic, held to 1e-3 of the scale;
* ``_b3.npz``: diffuse continuations start from the un-offset hit point,
  so one ulp decides a self-hit: at most 15% of pixels flip, and the rest
  are held to an RMSE under 2e-4;
* the fuzz scenes, built with the port's own schema: their tables equal
  the reference's bit for bit, and the port's frames are held to the
  oracle (``tests/oracle.py``) to 1e-3 direct-only (seeds 7, 23, 101) and
  along mirror chains (seeds 7, 23).

The 150-iteration anchor against the reference's published image
(``tests/test_reference_rmse.py``) runs on the card, in ``chip_smoke.py``
(phase ``reference_rmse``).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from spectral_tpu.scene import schema as jax_schema
from spectral_tpu.scene.flatten import flatten_scene as jax_flatten
from spectral_tpu_torch.render import integrator as tint
from spectral_tpu_torch.scene import presets, schema
from spectral_tpu_torch.scene.flatten import FIELDS, flatten_scene
from tests import torch_scenes as ts
from tests.oracle import OracleRenderer

GOLDEN_DIR = Path(__file__).parent / "goldens"


def _frames(preset, bounces):
    scene = presets.PRESETS[preset]()
    scene.width, scene.height = 32, 24
    scene.nbr_of_ray_bounces = bounces
    scene.nbr_of_iterations = 4
    port, cfg = flatten_scene(scene, "cpu")
    return np.stack([tint.integrate_frame(port, cfg, f).numpy() for f in range(2)])


@pytest.mark.parametrize("preset", ["default", "cornell"])
def test_direct_only_matches_oracle_golden(preset):
    want = np.load(GOLDEN_DIR / f"oracle_{preset}_32x24_b1.npz")["frames"].astype(np.float32)
    got = _frames(preset, 1)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(want.max()) > 0.05  # the frames are lit
    assert np.abs(got - want).max() / scale < 1e-3


@pytest.mark.parametrize("preset", ["default", "cornell"])
def test_multibounce_matches_oracle_golden(preset):
    want = np.load(GOLDEN_DIR / f"oracle_{preset}_32x24_b3.npz")["frames"].astype(np.float32)
    got = _frames(preset, 3)
    scale = max(1.0, float(np.abs(want).max()))
    err = np.abs(got - want).max(axis=-1) / scale
    flips = int((err > 1e-3).sum())
    assert flips <= 0.15 * err.size, f"{flips}/{err.size} coin-flip pixels"
    ok = err[err <= 1e-3]
    assert float(np.sqrt(np.mean(ok**2))) < 2e-4


def _oracle(port, cfg):
    """The scalar oracle over the port's own host tables."""
    return OracleRenderer(SimpleNamespace(**port.np_fields), cfg)


def _fuzz(seed, bounces, mirrors=False):
    scenes = []
    for S in (schema, jax_schema):
        scene = ts.random_scene(S, seed, bounces)
        if mirrors:
            for m in scene.materials:
                m.metallicness, m.roughness = 1.0, 0.0
        scenes.append(scene)
    port, cfg = flatten_scene(scenes[0], "cpu")
    arrays, _config = jax_flatten(scenes[1])
    for name in FIELDS:  # the port's copy of the scene is the reference's
        want = arrays.host.np_fields[name]
        if want is None:
            assert port.np_fields[name] is None, name
        else:
            assert np.asarray(port.np_fields[name]).tobytes() == np.asarray(want).tobytes(), name
    return port, cfg


@pytest.mark.parametrize("seed", [7, 23, 101])
def test_fuzz_direct_only_oracle(seed):
    port, cfg = _fuzz(seed, 1)
    oracle = _oracle(port, cfg)
    for frame in (0, 3):
        want = oracle.render_frame(frame)
        got = tint.integrate_frame(port, cfg, frame).numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) / scale < 1e-3


@pytest.mark.parametrize("seed", [7, 23])
def test_fuzz_specular_chain_oracle(seed):
    """Three bounces with every material a mirror: specular children
    start from offset origins, so the chain has no coin flip and matches
    the recursion tightly."""
    port, cfg = _fuzz(seed, 3, mirrors=True)
    want = _oracle(port, cfg).render_frame(1)
    got = tint.integrate_frame(port, cfg, 1).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) / scale < 1e-3
