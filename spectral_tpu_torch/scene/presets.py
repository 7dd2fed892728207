"""Built-in preset scenes, value-for-value reproductions of the
reference's two presets (``UIFields::default`` src/main.rs:1638-1759 and
``UIFields::cornell_box`` src/main.rs:1538-1635)."""

from __future__ import annotations

from spectral_tpu_torch.scene.schema import (
    Camera,
    Light,
    Material,
    PlainBox,
    PlainReflective,
    ReflectiveGreen,
    ReflectiveRed,
    RotatedBox,
    Scene,
    SceneObject,
    SceneSpectrum,
    Solar,
    Sphere,
    SpectrumEffectType,
    NBR_OF_SPECTRUM_SAMPLES_DEFAULT,
)


def default_scene(n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT) -> Scene:
    """Two solar lights, a mirror box, two grey spheres and a floor
    (reference ``UIFields::default``, src/main.rs:1638-1759)."""
    sun10 = SceneSpectrum.new(
        "Close light spectrum", Solar(0.001), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    sun1mil = SceneSpectrum.new(
        "Far away sun spectrum", Solar(100.0), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    grey = SceneSpectrum.new(
        "Grey reflecting spectrum", PlainReflective(0.7),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    white = SceneSpectrum.new(
        "White reflecting spectrum", PlainReflective(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )

    material_mirror = Material(1.0, 0.2, white, "Perfect Mirror")
    material_grey = Material(0.0, 0.0, grey, "Grey plastic")

    scene = Scene(
        camera=Camera(),
        lights=[
            Light((0.0, 2.0, -1.0), sun10, "Close light"),
            Light((0.0, 1_000.0, 0.0), sun1mil, "Far away sun light"),
        ],
        objects=[
            SceneObject((-1.5, 0.0, 1.0), PlainBox(0.25, 3.0, 30.0),
                        material_mirror, "Left mirror"),
            SceneObject((0.0, 0.0, 1.0), Sphere(1.0), material_grey, "Left sphere"),
            SceneObject((1.0, 0.0, 1.0), Sphere(1.0), material_grey, "Right sphere"),
            SceneObject((0.0, -1.0, 0.0), PlainBox(50.0, 0.1, 50.0),
                        material_grey, "Floor"),
        ],
        spectra=[sun10, sun1mil, grey, white],
        materials=[material_mirror, material_grey],
        spectrum_number_of_samples=n_samples,
    )
    return scene


def cornell_box(n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT) -> Scene:
    """The Cornell box preset (reference ``UIFields::cornell_box``,
    src/main.rs:1538-1635): grey walls, red/green side walls, one dim solar
    top light and two rotated boxes."""
    solar = SceneSpectrum.new(
        "Solar light spectrum", Solar(0.0001), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    grey = SceneSpectrum.new(
        "Reflective gray", PlainReflective(0.7),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    red = SceneSpectrum.new(
        "Reflective red", ReflectiveRed(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    green = SceneSpectrum.new(
        "Reflective green", ReflectiveGreen(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )

    material_grey = Material(0.0, 0.0, grey, "Grey plastic")
    material_green = Material(0.0, 0.0, green, "Green plastic")
    material_red = Material(0.0, 0.0, red, "Red plastic")

    scene = Scene(
        camera=Camera(),
        lights=[Light((0.0, 0.9, 0.0), solar, "Top light")],
        objects=[
            SceneObject((0.0, 0.0, 2.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Central wall"),
            SceneObject((0.0, 2.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Ceiling"),
            SceneObject((0.0, -2.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Floor"),
            SceneObject((-2.0, 0.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_red, "Left wall"),
            SceneObject((2.0, 0.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_green, "Right wall"),
            SceneObject((0.5, -0.75, -0.5), RotatedBox(0.5, 0.5, 0.5, 0.0, 1.0, 0.0),
                        material_grey, "Right front box"),
            SceneObject((-0.5, -0.4, 0.5), RotatedBox(0.5, 1.2, 0.5, 0.0, -0.5, 0.0),
                        material_grey, "Left back box"),
        ],
        spectra=[solar, grey, red, green],
        materials=[material_grey, material_green, material_red],
        spectrum_number_of_samples=n_samples,
    )
    return scene


def prism(n_samples: int = 64) -> Scene:
    """Glass-prism dispersion demo (beyond-reference capability,
    BASELINE.json config #3; the reference motivates dispersion in its
    README but never implements refraction, SURVEY.md §2.12).

    A BK7-like glass slab, rotated so refraction deviates rays, stands
    between the camera and a narrow bright emissive strip. Viewed through
    the glass, the strip's image disperses into a spectrum; the scene
    defaults to 64 wavelength bins so the rainbow is smooth.
    """
    from spectral_tpu_torch.scene.schema import Temperature

    emissive = SceneSpectrum.new(
        "Strip emission", Temperature(6500.0, 0.02),
        SpectrumEffectType.EMISSIVE, n=n_samples,
    )
    fill_light = SceneSpectrum.new(
        "Fill light", Solar(0.003), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    white = SceneSpectrum.new(
        "Glass tint", PlainReflective(1.0), SpectrumEffectType.REFLECTIVE,
        n=n_samples,
    )
    grey = SceneSpectrum.new(
        "Screen grey", PlainReflective(0.7), SpectrumEffectType.REFLECTIVE,
        n=n_samples,
    )
    black = SceneSpectrum.new(
        "Strip body", PlainReflective(0.0), SpectrumEffectType.REFLECTIVE,
        n=n_samples,
    )

    # Strongly dispersive dense-flint-like glass: real BK7's ~1 degree of
    # angular dispersion is sub-pixel at demo resolutions, so the preset
    # ships an exaggerated Cauchy term that fans the spectrum visibly
    # (physically-accurate BK7 is cauchy_b_um2=0.0042)
    glass = Material(
        0.0, 0.0, white, "Dense flint glass",
        transmission=1.0, ior=1.52, cauchy_b_um2=0.035,
    )
    screen = Material(0.0, 0.0, grey, "Screen")
    strip = Material(0.0, 0.0, black, "Emissive strip", emission=emissive)

    return Scene(
        width=800,
        height=600,
        nbr_of_iterations=200,
        nbr_of_ray_bounces=8,
        camera=Camera(position=(0.0, 0.0, -3.0)),
        lights=[Light((0.0, 4.0, -4.0), fill_light, "Fill light")],
        objects=[
            # glass slab turned 40 deg about the vertical axis; the
            # refraction angle difference across 380-780 nm (~1 deg for
            # BK7) is levered by the strip's distance behind the glass
            SceneObject((0.0, 0.0, 0.5), RotatedBox(1.4, 2.0, 1.4, 0.0, 0.698, 0.0),
                        glass, "Prism"),
            # narrow emissive strip: its refracted image fans into a
            # spectrum because the chromatic deviation exceeds the width
            SceneObject((0.0, 0.0, 5.0), PlainBox(0.1, 2.4, 0.05),
                        strip, "Emissive strip"),
            # matte backdrop and floor
            SceneObject((0.0, 0.0, 8.0), PlainBox(40.0, 10.0, 0.2),
                        screen, "Backdrop"),
            SceneObject((0.0, -2.0, 0.0), PlainBox(40.0, 0.2, 40.0),
                        screen, "Floor"),
        ],
        spectra=[emissive, fill_light, white, grey, black],
        materials=[glass, screen, strip],
        spectrum_number_of_samples=n_samples,
    )


def sphere_field(
    n_spheres: int = 1000, n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT
) -> Scene:
    """1000-sphere stress scene (BASELINE.json config #4): a deterministic
    pseudo-random field of spheres with mixed diffuse/mirror materials
    under two lights — exercises many-object tracing throughput."""
    import numpy as np

    sun = SceneSpectrum.new(
        "Sky light", Solar(1.0), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    sun2 = SceneSpectrum.new(
        "Back light", Solar(0.2), SpectrumEffectType.EMISSIVE, n=n_samples
    )
    grey = SceneSpectrum.new(
        "Grey", PlainReflective(0.65), SpectrumEffectType.REFLECTIVE, n=n_samples
    )
    red = SceneSpectrum.new(
        "Red", ReflectiveRed(0.9), SpectrumEffectType.REFLECTIVE, n=n_samples
    )
    green = SceneSpectrum.new(
        "Green", ReflectiveGreen(0.9), SpectrumEffectType.REFLECTIVE, n=n_samples
    )
    white = SceneSpectrum.new(
        "White", PlainReflective(1.0), SpectrumEffectType.REFLECTIVE, n=n_samples
    )

    materials = [
        Material(0.0, 0.0, grey, "Matte grey"),
        Material(0.0, 0.0, red, "Matte red"),
        Material(0.0, 0.0, green, "Matte green"),
        Material(1.0, 0.05, white, "Mirror"),
    ]
    floor_mat = Material(0.0, 0.0, grey, "Floor")

    rng = np.random.default_rng(1234)
    objects = [
        SceneObject((0.0, -1.2, 0.0), PlainBox(200.0, 0.2, 200.0),
                    floor_mat, "Floor"),
    ]
    for i in range(n_spheres):
        x = float(rng.uniform(-20, 20))
        z = float(rng.uniform(2, 60))
        r = float(rng.uniform(0.15, 0.5))
        y = float(-1.1 + r + rng.uniform(0.0, 1.5))
        mat = materials[int(rng.integers(0, len(materials)))]
        objects.append(
            SceneObject((x, y, z), Sphere(r), mat, f"Sphere {i}")
        )

    return Scene(
        width=1024,
        height=768,
        nbr_of_iterations=50,
        nbr_of_ray_bounces=8,
        camera=Camera(position=(0.0, 1.5, -4.0), direction=(0.0, -0.12, 1.0)),
        lights=[
            Light((0.0, 40.0, 0.0), sun, "Sky light"),
            Light((-15.0, 10.0, -10.0), sun2, "Back light"),
        ],
        objects=objects,
        spectra=[sun, sun2, grey, red, green, white],
        materials=materials + [floor_mat],
        spectrum_number_of_samples=n_samples,
    )


def mesh_demo(n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT) -> Scene:
    """Triangle-mesh showcase (beyond-reference geometry — the
    reference's object catalog stops at boxes and spheres): the Cornell
    room walls around a 320-triangle mirror icosphere and a diffuse
    blue icosahedron."""
    from spectral_tpu_torch.scene.mesh import icosahedron, icosphere
    from spectral_tpu_torch.scene.schema import ReflectiveBlue

    solar = SceneSpectrum.new(
        "Solar light spectrum", Solar(0.0001),
        SpectrumEffectType.EMISSIVE, n=n_samples,
    )
    grey = SceneSpectrum.new(
        "Reflective gray", PlainReflective(0.7),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    red = SceneSpectrum.new(
        "Reflective red", ReflectiveRed(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    green = SceneSpectrum.new(
        "Reflective green", ReflectiveGreen(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )
    blue = SceneSpectrum.new(
        "Reflective blue", ReflectiveBlue(1.0),
        SpectrumEffectType.REFLECTIVE, n=n_samples,
    )

    material_grey = Material(0.0, 0.0, grey, "Grey plastic")
    material_red = Material(0.0, 0.0, red, "Red plastic")
    material_green = Material(0.0, 0.0, green, "Green plastic")
    material_blue = Material(0.0, 0.3, blue, "Blue plastic")
    material_mirror = Material(1.0, 0.05, grey, "Brushed mirror")

    scene = Scene(
        camera=Camera(),
        lights=[Light((0.0, 0.9, 0.0), solar, "Top light")],
        objects=[
            SceneObject((0.0, 0.0, 2.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Central wall"),
            SceneObject((0.0, 2.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Ceiling"),
            SceneObject((0.0, -2.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_grey, "Floor"),
            SceneObject((-2.0, 0.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_red, "Left wall"),
            SceneObject((2.0, 0.0, 0.0), PlainBox(2.0, 2.0, 2.0),
                        material_green, "Right wall"),
            SceneObject((0.42, -0.45, -0.15), icosphere(0.55, 2),
                        material_mirror, "Mirror icosphere"),
            SceneObject((-0.55, -0.72, 0.45), icosahedron(0.38),
                        material_blue, "Blue icosahedron"),
        ],
        spectra=[solar, grey, red, green, blue],
        materials=[
            material_grey, material_red, material_green, material_blue,
            material_mirror,
        ],
        spectrum_number_of_samples=n_samples,
    )
    return scene


def mesh5k(
    n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT,
    subdivisions: int = 4,
) -> Scene:
    """Production-scale mesh config: ``mesh_demo``'s Cornell room, but the
    mirror icosphere subdivided to 20 * 4^subdivisions faces (default
    5,120) and the icosahedron to 1,280 — ~6.4k triangle rows total, the
    many-object stress case for the clustered object loop."""
    from spectral_tpu_torch.scene.mesh import icosphere

    scene = mesh_demo(n_samples)
    mirror = scene.objects[5]
    assert mirror.name == "Mirror icosphere"
    mirror.object_type = icosphere(0.55, subdivisions)
    blue = scene.objects[6]
    assert blue.name == "Blue icosahedron"
    blue.object_type = icosphere(0.38, subdivisions - 1)
    return scene


def measured_sun(n_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT) -> Scene:
    """The default scene relit by the MEASURED solar table instead of the
    6500 K blackbody workaround — the reference's dead data
    (``src/spectral_data.rs:31``, bypassed at ``src/spectrum.rs:73-96``)
    un-deadened. Geometry and every other value match ``default_scene``;
    only the two Solar light spectra switch type."""
    from spectral_tpu_torch.scene.schema import MeasuredSolar, Solar

    scene = default_scene(n_samples)
    for sp in scene.spectra:
        if isinstance(sp.spectrum_type, Solar):
            sp.spectrum_type = MeasuredSolar(sp.spectrum_type.factor)
            sp.regenerate(
                sp.spectrum.lowest_wavelength,
                sp.spectrum.highest_wavelength,
                sp.spectrum.nbr_of_samples,
            )
    return scene


PRESETS = {
    "default": default_scene,
    "cornell": cornell_box,
    "prism": prism,
    "spheres": sphere_field,
    "mesh": mesh_demo,
    "mesh5k": mesh5k,
    "measured_sun": measured_sun,
}
