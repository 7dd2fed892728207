"""The port's jax-free scene flattening against the reference package's:
every table bitwise equal (dtype, shape and bytes) on every preset, each
preset built with its own package's presets, the ``RenderConfig``
field-equal, and the tensors bit-for-bit copies."""

import dataclasses

import numpy as np
import pytest
import torch

from spectral_tpu.scene import flatten as jflat
from spectral_tpu.scene import presets
from spectral_tpu_torch.scene import flatten as tflat
from spectral_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)


def _same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_np_fields_and_config_bitwise_equal(name):
    arrays, config = jflat.flatten_scene(presets.PRESETS[name]())
    want = arrays.host.np_fields
    got, got_config = tflat.flatten_numpy(tpresets.PRESETS[name]())
    assert set(got) == set(want) == set(tflat.FIELDS)
    for key in tflat.FIELDS:
        assert _same_bits(got[key], want[key]), key
    assert dataclasses.asdict(got_config) == dataclasses.asdict(config)


@pytest.mark.parametrize("name", ["default", "cornell", "prism"])
def test_tensors_copy_reference_tables(name):
    arrays, config = jflat.flatten_scene(presets.PRESETS[name]())
    np_fields = arrays.host.np_fields
    port_config = tflat.RenderConfig(**dataclasses.asdict(config))
    scene, cfg = tflat.from_numpy(np_fields, port_config, "cpu")
    assert cfg == port_config
    for key in tflat.FIELDS:
        t = getattr(scene, key)
        if np_fields[key] is None:
            assert t is None
            continue
        assert t.device.type == "cpu"
        assert _same_bits(t.numpy(), np_fields[key]), key
    assert scene.obj_types == tuple(int(x) for x in np_fields["obj_type"])
    # the scene's own flatten gives the same tensors
    own, own_cfg = tflat.flatten_scene(tpresets.PRESETS[name](), "cpu")
    assert own_cfg == port_config
    for key in tflat.FIELDS:
        a, b = getattr(own, key), getattr(scene, key)
        assert (a is None and b is None) or torch.equal(a, b), key


def test_hidden_objects_and_lights_are_dropped():
    scenes = []
    for P in (tpresets, presets):
        scene = P.cornell_box()
        scene.objects[0].hidden = True
        scene.lights[0].hidden = True
        scenes.append(scene)
    got, cfg = tflat.flatten_numpy(scenes[0])
    arrays, config = jflat.flatten_scene(scenes[1])
    assert cfg.n_objects == config.n_objects == 6
    assert cfg.n_lights == 0
    for key in tflat.FIELDS:
        assert _same_bits(got[key], arrays.host.np_fields[key]), key


def test_euler_rotation_bitwise():
    rng = np.random.default_rng(7)
    for roll, pitch, yaw in rng.uniform(-np.pi, np.pi, size=(50, 3)):
        assert _same_bits(
            tflat.euler_to_rotation_matrix(roll, pitch, yaw),
            jflat.euler_to_rotation_matrix(roll, pitch, yaw),
        )


@pytest.mark.parametrize("name", ["sky", "checker", "panel", "glass_mesh"])
def test_feature_scene_tables_bitwise_equal(name):
    """The feature tables (sky, tex_*, emission, transmission and their
    material rows) of scenes built by each package, bitwise equal."""
    from spectral_tpu.scene import schema as jschema
    from spectral_tpu_torch.scene import schema as tschema
    from tests import torch_scenes as ts

    def build(schema, pre):
        return {"sky": lambda: ts.open_sky(schema, 16),
                "checker": lambda: ts.textured(schema, pre),
                "panel": lambda: ts.emissive_panel(schema, 16),
                "glass_mesh": lambda: ts.glass_meshes(schema, pre, "mesh", 8, 8, 2)}[name]()

    arrays, config = jflat.flatten_scene(build(jschema, presets))
    want = arrays.host.np_fields
    got, got_config = tflat.flatten_numpy(build(tschema, tpresets))
    for key in tflat.FIELDS:
        assert _same_bits(got[key], want[key]), key
    assert dataclasses.asdict(got_config) == dataclasses.asdict(config)
    feature = {"sky": "sky", "checker": "tex_scale", "panel": "mat_emission",
               "glass_mesh": "transmission"}[name]
    assert np.asarray(got[feature]).any()
