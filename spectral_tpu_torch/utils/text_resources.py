"""User-facing help text.

The framework equivalent of the reference's tooltip catalog
(reference ``src/text_resources.rs:1-125``): one help string per
UI-facing knob, surfaced through the CLI's ``--help`` and the scene
schema docs. Wording is our own; coverage mirrors the reference's.
"""

HELP = {
    "width": "Output image width in pixels.",
    "height": "Output image height in pixels.",
    "iterations": (
        "Number of progressive refinement passes. Each pass renders the "
        "whole image once and blends it into the running average; more "
        "passes mean less noise. Decent results above 100, good above 1000."
    ),
    "max_bounces": (
        "Maximum path depth per camera ray (1-100). A value of 1 gives "
        "direct lighting only; higher values add indirect illumination at "
        "increasing cost."
    ),
    "spectrum_samples": (
        "Number of wavelength samples per spectrum (multiple of 8, between "
        "8 and 128). Spectra are sampled equidistantly over 380-780 nm. "
        "More samples give smoother color at higher cost."
    ),
    "threads": (
        "Accepted for scene-file compatibility with the reference desktop "
        "app; on TPU parallelism comes from the device mesh instead."
    ),
    "camera.position": "World-space position of the pinhole camera.",
    "camera.direction": "View direction; must not be parallel to 'up'.",
    "camera.up": "Approximate up direction used to build the camera basis.",
    "camera.fov_y_deg": "Vertical field of view in degrees.",
    "light.position": "World-space position of the point light.",
    "light.spectrum": (
        "Emission spectrum of the light. Intensity falls off with the "
        "squared distance."
    ),
    "material.metallicness": (
        "Probability in [0,1] that a ray reflects specularly instead of "
        "diffusely at each hit (stochastic branch per bounce)."
    ),
    "material.roughness": (
        "Specular cone width in [0,1]: 0 is a perfect mirror; larger values "
        "spread reflected rays within a cone of half-angle roughness^2 * 90 "
        "degrees."
    ),
    "material.spectrum": (
        "Per-wavelength reflectance (albedo). Reflective spectra are "
        "clamped to at most 1 when the render starts."
    ),
    "object.plain_box": (
        "Axis-aligned box given by center and edge lengths — the cheapest "
        "primitive to intersect."
    ),
    "object.sphere": "Mathematically exact sphere given by center and radius.",
    "object.rotated_box": (
        "Box with extra Euler rotation (roll, pitch, yaw in radians) "
        "applied about its center."
    ),
    "spectrum.solar": (
        "Sunlight-like emission spectrum scaled by a brightness factor. "
        "Matches the reference's 6500 K blackbody workaround (its measured "
        "solar table is shipped but bypassed, like upstream)."
    ),
    "spectrum.measured_solar": (
        "Emission spectrum sampled from the MEASURED solar irradiance "
        "table (the data the reference ships but never uses), scaled by a "
        "brightness factor and radiance-normalized to the Solar "
        "workaround's output so the two swap cleanly."
    ),
    "spectrum.temperature": (
        "Blackbody (Planck) emission spectrum for a temperature in Kelvin, "
        "scaled by a brightness factor."
    ),
    "spectrum.plain_reflective": "Flat spectrum: the same value at every wavelength.",
    "spectrum.reflective_red": "Reflects wavelengths above 550 nm (red-ish).",
    "spectrum.reflective_green": "Reflects wavelengths between 500 and 575 nm.",
    "spectrum.reflective_blue": "Reflects wavelengths below 475 nm.",
    "spectrum.custom": (
        "Free-form per-sample values; resampled (lossily) when the sample "
        "count changes."
    ),
    "spectrum.from_rgb": (
        "Author a spectrum from an RGB color (SceneSpectrum.from_rgb): the "
        "smoothest reflectance matching that color exactly under the "
        "renderer's color pipeline. (1,1,1) is flat white; very saturated "
        "colors land on the closest achievable color."
    ),
    "object.type": (
        "Shape of the object; the type sets the intersection cost. Many "
        "expensive types in one scene slow rendering down."
    ),
    "object.position": (
        "World-space position of the object: the point its local origin "
        "lands on."
    ),
    "object.material": (
        "Material assigned to the object; it determines how the object "
        "looks when rendered."
    ),
    "object.plain_box.dimensions": (
        "Width, height and depth of the axis-aligned box."
    ),
    "object.sphere.radius": "Radius of the sphere.",
    "object.rotated_box.dimensions": (
        "Width, height and depth of the box, defined BEFORE the rotation "
        "is applied."
    ),
    "object.rotated_box.angles": (
        "Euler rotation angles about the X, Y and Z axes, in radians."
    ),
    "spectrum.range": (
        "Lower and upper wavelength bound of every spectrum; fixed to the "
        "visible range (380-780 nm), like the reference."
    ),
    "spectrum.type": (
        "Initial shape of the spectrum, regenerated when the sample count "
        "changes. Switch to 'custom' to edit samples directly — but avoid "
        "changing the sample count afterwards: custom values are resampled "
        "lossily."
    ),
    "spectrum.effect_type": (
        "How the spectrum is used. Emitting: a light-source spectrum, "
        "values may exceed 1. Reflecting: the per-wavelength share that is "
        "reflected, clamped to [0, 1] at render start — 0.5 everywhere "
        "reads as medium grey under white light."
    ),
    "spectrum.radiance": (
        "Integrated emitted energy of the spectrum — its apparent "
        "brightness. Shorter wavelengths carry more energy per photon, "
        "which skews the number slightly."
    ),
    "spectrum.observed_color": (
        "Color when looking straight at the emitter. A bright enough "
        "source of any hue appears white, like welding sparks."
    ),
    "spectrum.normalized_color": (
        "Color after normalizing brightness: the hue this light would "
        "throw onto a distant object."
    ),
    "spectrum.reflected_color": (
        "Color of a roughly white illuminant after reflecting off a "
        "surface with this reflective spectrum."
    ),
    "spectrum.wavelength_edit": (
        "Editing the wavelength bounds is not supported; every spectrum "
        "spans the full visible range."
    ),
    "spectrum.edit": (
        "Per-sample editing requires the 'custom' spectrum type; other "
        "types are generated from their parameters."
    ),
    "spectrum.factor": (
        "Multiply every sample of the spectrum by this factor (the editor "
        "applies it on request, not live)."
    ),
    "spectrum.base": (
        "Spectrum that serves as the base (to-be-reflected) illuminant for "
        "the reflected-color preview."
    ),
    "spectrum.normalize_base": (
        "Normalize the base spectrum's brightness first so the reflected "
        "color is comparable across illuminants."
    ),
    "render.start_disabled": (
        "Rendering cannot start: the scene failed validation (dangling "
        "spectrum/material references, sample-count mismatch) or a render "
        "is already in progress. Scene.validate() names the exact problem."
    ),
    "viewer.image": (
        "The live HTTP viewer shows the progressive framebuffer; it "
        "refreshes once per second and offers an Abort button."
    ),
    "copy_suffix": (
        "Copied scene elements get a ' (copy)' name suffix, like the "
        "reference's duplicate action."
    ),
    "abort": (
        "Rendering aborts at frame granularity: the current progressive "
        "pass finishes before the render stops."
    ),
    "checkpoint": (
        "Progressive renders can be checkpointed (accumulator + frame "
        "counter) and resumed later — useful for long hero renders."
    ),
    "element.rename": "Change the name of this element.",
    "help": (
        "See README.md for a tutorial; every scene and spectrum knob has "
        "a help entry here (`describe --help-for <key>`)."
    ),
}
