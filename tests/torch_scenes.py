"""Scene builders shared by the port's tests.

Each builder takes the scene modules it builds with: the JAX package's
(``spectral_tpu.scene.schema`` / ``presets``) or the port's own copies
(``spectral_tpu_torch.scene.schema`` / ``presets``), so that a test that
compares the two packages builds the same scene in each. This module
imports neither package, so the jax-free card tests can use it.
"""

from __future__ import annotations

import math


def preset(presets, name, w, h, bounces, iters=2, samples=8):
    """A named preset at a test size."""
    scene = presets.PRESETS[name](n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def periscope(schema, presets, bounces=3, samples=8, iters=2):
    """The deterministic 3-bounce periscope of tests/test_pallas_megakernel.py
    (``_periscope_scene``): mirror -> mirror -> diffuse wall, no self-hit
    coin on any lane."""
    S = schema
    base = presets.default_scene()
    refl = [sp for sp in base.spectra if sp.effect_type.name == "REFLECTIVE"][0]
    emis = [sp for sp in base.spectra if sp.effect_type.name == "EMISSIVE"][0]
    mirror = S.Material(1.0, 0.0, refl, "mirror")
    diffuse = S.Material(0.0, 0.0, refl, "wall")
    quarter = float(math.pi / 4)
    scene = S.Scene(
        width=12, height=8, nbr_of_iterations=iters, nbr_of_ray_bounces=bounces,
        camera=S.Camera(position=(0.0, 0.0, 0.0), direction=(0.0, 0.0, 1.0),
                        up=(0.0, 1.0, 0.0), fov_y_deg=30.0),
        lights=[S.Light((0.0, 4.0, 9.0), emis, "lamp")],
        objects=[
            S.SceneObject((0.0, 0.0, 6.0),
                          S.RotatedBox(4.0, 4.0, 0.2, quarter, 0.0, 0.0), mirror, "M1"),
            S.SceneObject((0.0, 4.0, 6.0),
                          S.RotatedBox(4.0, 4.0, 0.2, quarter, 0.0, 0.0), mirror, "M2"),
            S.SceneObject((0.0, 4.0, 12.0), S.PlainBox(8.0, 8.0, 0.2), diffuse, "wall"),
        ],
        spectra=base.spectra, materials=[mirror, diffuse],
        spectrum_number_of_samples=samples,
    )
    scene.update_all_spectrum_sample_sizes()
    scene.validate()
    return scene


def regen_scene(presets):
    """The regeneration check's scene (tests/test_pallas_megakernel.py
    ``_regen_scene``): the default scene at 16x128, 8 wavelengths, 4
    bounces, 3 iterations."""
    sc = presets.default_scene()
    sc.spectrum_number_of_samples = 8
    sc.update_all_spectrum_sample_sizes()
    sc.width, sc.height = 16, 128
    sc.nbr_of_ray_bounces = 4
    sc.nbr_of_iterations = 3
    return sc


def sphere_field(presets, n_spheres, w, h, bounces, iters=2, samples=8):
    """The many-object preset (``presets.sphere_field``: a seeded field of
    spheres on a plain-box floor) at a test size."""
    scene = presets.sphere_field(n_spheres=n_spheres, n_samples=samples)
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    return scene


def smooth_mesh(presets, mesh, w, h, bounces, subdivisions=1, iters=2, samples=8):
    """``presets.mesh_demo`` with its mirror icosphere swapped for a
    DIFFUSE icosphere of ``subdivisions`` carrying vertex normals
    (``mesh.icosphere(..., smooth=True)``; ``mesh`` is the scene.mesh
    module of the same package), beside the flat icosahedron: a smooth
    and a flat mesh in one scene. Subdivision 0 keeps the scene at 45
    objects (the kernels' small-scene build), 1 gives 105 (clusters)."""
    scene = presets.mesh_demo(n_samples=samples)
    ball, blue = scene.objects[5], scene.objects[6]
    ball.object_type = mesh.icosphere(0.55, subdivisions, smooth=True)
    ball.material = blue.material
    scene.width, scene.height = w, h
    scene.nbr_of_ray_bounces, scene.nbr_of_iterations = bounces, iters
    scene.validate()
    return scene
