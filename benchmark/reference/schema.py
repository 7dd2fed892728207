"""[Frozen copy of ``spectral_tpu_torch/scene/schema.py`` for the benchmark's plain
reference, imports changed: the reference imports nothing of the program.]

Scene description schema.

The UI-facing state of the reference (``UIFields`` and friends,
reference ``src/main.rs:1511-2167``) re-designed as plain Python
dataclasses. The field set is the compatibility surface: a reference scene
maps 1:1 onto these types, and the two built-in presets
(``spectral_tpu_torch.scene.presets``) reproduce the reference's exactly.

Referential structure (the reference's ``Rc<RefCell<...>>`` graph) is
plain Python object identity: a ``Light`` holds *the* ``SceneSpectrum``
object, a ``SceneObject`` holds *the* ``Material``. Legality checking
(``Scene.validate``) verifies membership by identity, like the reference's
``check_render_legality`` (``src/main.rs:1452-1484``).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Union

import numpy as np

from benchmark.reference.spectrum import (
    Spectrum,
    VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND,
    VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND,
)

# Reference src/main.rs:29-34.
NBR_OF_ITERATIONS_DEFAULT = 100
NBR_OF_SPECTRUM_SAMPLES_DEFAULT = 32
NEW_RAY_MAX_BOUNCES_DEFAULT = 30
NEW_RAY_MAX_BOUNCES_MAX = 100

_id_counter = itertools.count(1)


class SceneError(ValueError):
    """Raised when a scene is in a state the renderer would reject."""


class SpectrumEffectType(enum.Enum):
    """Emissive = true light spectrum; Reflective = per-wavelength albedo
    (clamped to <= 1 when snapshotted for rendering). Reference
    ``src/main.rs:1845-1848`` and ``src/spectrum.rs:486-494``."""

    EMISSIVE = "emissive"
    REFLECTIVE = "reflective"


# --- spectrum *type* variants (reference UISpectrumType, src/main.rs:1869-1878)

@dataclasses.dataclass(frozen=True)
class Custom:
    """Free-form samples; resampled (lossily) on sample-count change."""


@dataclasses.dataclass(frozen=True)
class Solar:
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class MeasuredSolar:
    """Measured solar spectrum from the shipped irradiance table — the
    data the reference embeds but bypasses with a 6500 K blackbody
    (``src/spectral_data.rs:31``; bypass ``src/spectrum.rs:73-96``).
    ``Solar`` keeps the blackbody workaround for behavior compatibility;
    this type is the un-deadened measured curve, radiance-normalized to
    the workaround's brightness so the two are drop-in interchangeable."""

    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class PlainReflective:
    factor: float = 0.0


@dataclasses.dataclass(frozen=True)
class Temperature:
    kelvin: float = 6500.0
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class ReflectiveRed:
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class ReflectiveGreen:
    factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class ReflectiveBlue:
    factor: float = 1.0


SpectrumType = Union[
    Custom, Solar, MeasuredSolar, PlainReflective, Temperature,
    ReflectiveRed, ReflectiveGreen, ReflectiveBlue,
]


def _regenerate(
    spectrum_type: SpectrumType,
    current: Spectrum,
    lo: float,
    hi: float,
    n: int,
) -> Spectrum:
    """Regenerate a spectrum for a new sample count
    (reference ``update_all_spectrum_sample_sizes``, src/main.rs:1186-1228)."""
    if isinstance(spectrum_type, Custom):
        out = current.copy()
        out.resample(n)
        return out
    if isinstance(spectrum_type, Solar):
        return Spectrum.new_sunlight_spectrum(lo, hi, n, spectrum_type.factor)
    if isinstance(spectrum_type, MeasuredSolar):
        return Spectrum.new_measured_solar_spectrum(
            lo, hi, n, spectrum_type.factor
        )
    if isinstance(spectrum_type, PlainReflective):
        return Spectrum.new_singular_reflectance_factor(lo, hi, n, spectrum_type.factor)
    if isinstance(spectrum_type, Temperature):
        return Spectrum.new_temperature_spectrum(
            lo, hi, spectrum_type.kelvin, n, spectrum_type.factor
        )
    if isinstance(spectrum_type, ReflectiveRed):
        return Spectrum.new_reflective_spectrum_red(lo, hi, n, spectrum_type.factor)
    if isinstance(spectrum_type, ReflectiveGreen):
        return Spectrum.new_reflective_spectrum_green(lo, hi, n, spectrum_type.factor)
    if isinstance(spectrum_type, ReflectiveBlue):
        return Spectrum.new_reflective_spectrum_blue(lo, hi, n, spectrum_type.factor)
    raise TypeError(f"unknown spectrum type {spectrum_type!r}")


@dataclasses.dataclass
class SceneSpectrum:
    """A named spectrum (reference ``UISpectrum``, src/main.rs:1775-1802)."""

    name: str
    spectrum_type: SpectrumType
    effect_type: SpectrumEffectType
    spectrum: Spectrum
    id: int = dataclasses.field(default_factory=lambda: next(_id_counter))

    @staticmethod
    def new(
        name: str,
        spectrum_type: SpectrumType,
        effect_type: SpectrumEffectType,
        lo: float = VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND,
        hi: float = VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND,
        n: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT,
        values: np.ndarray | None = None,
    ) -> "SceneSpectrum":
        if isinstance(spectrum_type, Custom):
            if values is None:
                raise SceneError("Custom spectra require explicit values")
            spectrum = Spectrum.new_from_list(values, lo, hi, n)
        else:
            spectrum = _regenerate(spectrum_type, None, lo, hi, n)
        return SceneSpectrum(name, spectrum_type, effect_type, spectrum)

    @staticmethod
    def from_rgb(
        name: str,
        rgb,
        effect_type: SpectrumEffectType = SpectrumEffectType.REFLECTIVE,
        lo: float = VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND,
        hi: float = VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND,
        n: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT,
        factor: float = 1.0,
    ) -> "SceneSpectrum":
        """Author a spectrum from an RGB color (capability beyond the
        reference, whose spectra are built only from physical constructors
        or per-sample sliders, src/main.rs:1869-1878).

        The result is a Custom spectrum holding the smoothest reflectance
        in [0, 1] that is an exact metamer of ``rgb`` under this
        framework's own color pipeline (``spectral_tpu_torch.spectral.uplift``);
        ``(1, 1, 1)`` is the flat white reflector. Colors outside the
        smooth-reflectance gamut (e.g. pure sRGB primaries) land on the
        closest achievable color. For EMISSIVE spectra the curve is scaled
        by ``factor`` (reflectance-shaped emission; use a large factor for
        bright lights)."""
        from benchmark.reference.uplift import uplift_rgb

        values = uplift_rgb(rgb, lo, hi, n)
        if effect_type == SpectrumEffectType.EMISSIVE:
            if factor < 0.0:
                raise SceneError("emissive factor must be >= 0")
            values = values * np.float32(factor)
        elif factor != 1.0:
            raise SceneError(
                "factor only applies to EMISSIVE uplifts; reflective "
                "spectra are already bounded by [0, 1]"
            )
        return SceneSpectrum.new(name, Custom(), effect_type, lo, hi, n, values)

    def regenerate(self, lo: float, hi: float, n: int) -> None:
        self.spectrum = _regenerate(self.spectrum_type, self.spectrum, lo, hi, n)

    def edit(self, values) -> None:
        """Overwrite the per-sample values (the reference's spectrum-editor
        sliders, ``UISpectrum::edit`` src/main.rs:1799 + the per-sample
        slider loop src/main.rs:1048-1064).

        Only ``Custom`` spectra are editable — the reference disables the
        sliders for every generated type. Values are validated against the
        slider bounds: reflective samples lie in [0, 1]; emissive samples
        are non-negative.
        """
        if not isinstance(self.spectrum_type, Custom):
            raise SceneError(
                f"spectrum {self.name!r} is a generated "
                f"{type(self.spectrum_type).__name__} spectrum; only Custom "
                "spectra have editable samples (reference main.rs:1041)"
            )
        vals = np.asarray(values, dtype=np.float32)
        n = self.spectrum.nbr_of_samples
        if vals.shape != (n,):
            raise SceneError(
                f"expected {n} samples (the spectrum's current sample "
                f"count), got shape {vals.shape}"
            )
        if not np.isfinite(vals).all():
            raise SceneError("spectrum samples must be finite")
        if (vals < 0.0).any():
            raise SceneError("spectrum samples must be non-negative")
        if self.effect_type == SpectrumEffectType.REFLECTIVE and (vals > 1.0).any():
            raise SceneError(
                "reflective spectrum samples must be <= 1 (the reference's "
                "slider bound, src/main.rs:1044)"
            )
        self.spectrum = Spectrum.new_from_list(
            vals,
            self.spectrum.lowest_wavelength,
            self.spectrum.highest_wavelength,
            n,
        )

    def edit_sample(self, index: int, value: float) -> None:
        """Edit one sample (one slider) of a Custom spectrum."""
        n = self.spectrum.nbr_of_samples
        if not 0 <= index < n:
            raise SceneError(f"sample index {index} out of range 0..{n - 1}")
        vals = np.array(self.spectrum.intensities[:n], dtype=np.float32)
        vals[index] = value
        self.edit(vals)

    def render_spectrum(self) -> Spectrum:
        """Snapshot for rendering: reflective spectra are clamped to <= 1
        (reference ``From<&UISpectrum> for Spectrum``, src/spectrum.rs:486-494)."""
        s = self.spectrum.copy()
        if self.effect_type == SpectrumEffectType.REFLECTIVE:
            s.min1()
        return s

    def copy(self) -> "SceneSpectrum":
        return SceneSpectrum(
            self.name, self.spectrum_type, self.effect_type, self.spectrum.copy()
        )

    def preview_colors(
        self, white_reference: Spectrum | None = None
    ) -> dict[str, tuple[float, float, float]]:
        """The color previews the reference's spectrum editor shows
        (src/main.rs:898-1036): the spectrum's own ('observed') color, the
        normalized color, and — for reflective spectra — its color under a
        normalized-white illuminant."""
        observed = self.spectrum.get_rgb_early()
        normalized = self.spectrum.normalize().get_rgb_early()
        out = {"observed": observed, "normalized": normalized}
        if self.effect_type == SpectrumEffectType.REFLECTIVE:
            white = white_reference or Spectrum.new_normalized_white(
                self.spectrum.lowest_wavelength,
                self.spectrum.highest_wavelength,
                self.spectrum.nbr_of_samples,
            )
            out["reflected"] = (self.render_spectrum() * white).get_rgb_early()
        return out


@dataclasses.dataclass(frozen=True)
class Checker:
    """World-space procedural checker texture (beyond-reference — the
    reference's materials are spatially uniform, src/main.rs:2092).

    Modulates the material's reflective spectrum by a scalar: cells of
    side ``scale`` alternate between a factor of 1.0 and ``low``
    (parity of ``floor(p/scale)`` summed over xyz). Scalar modulation
    keeps the albedo physically plausible at every wavelength — the
    spectral shape is untouched, only its magnitude varies."""

    scale: float = 1.0
    low: float = 0.25


@dataclasses.dataclass
class Material:
    """Reference ``UIMaterial`` (src/main.rs:2092-2111): stochastic
    metallic/diffuse branch weight, specular cone roughness, and a
    reflective spectrum (the per-wavelength albedo).

    Beyond-reference extensions (all default to the reference's behavior
    when left at zero; SURVEY.md §2.12 — the reference motivates
    dispersion in its README but never implements refraction):

    * ``transmission``: probability in [0,1] that a non-metallic
      interaction refracts through the surface instead of scattering
      diffusely (with Schlick-Fresnel reflection and total internal
      reflection).
    * ``ior`` + ``cauchy_b_um2``: Cauchy dispersion model
      ``n(lambda) = ior + cauchy_b_um2 / lambda_um^2``. A non-zero
      Cauchy term makes refraction wavelength-dependent; paths collapse
      to a hero wavelength at their first dispersive event.
    * ``emission``: emitted spectrum (area light) added when a path hits
      the surface — the only way refracted paths can reach light in a
      next-event-estimation tracer.
    * ``texture``: optional :class:`Checker` modulating the reflective
      spectrum's magnitude by hit position (emission is untouched).
    """

    metallicness: float
    roughness: float
    spectrum: SceneSpectrum
    name: str = "New Material"
    transmission: float = 0.0
    ior: float = 1.5
    cauchy_b_um2: float = 0.0
    emission: SceneSpectrum | None = None
    texture: Checker | None = None
    id: int = dataclasses.field(default_factory=lambda: next(_id_counter))

    def copy(self) -> "Material":
        return Material(
            self.metallicness, self.roughness, self.spectrum, self.name,
            self.transmission, self.ior, self.cauchy_b_um2, self.emission,
            self.texture,
        )


@dataclasses.dataclass
class Light:
    """Point light (reference ``UILight``, src/main.rs:1917-1938). The
    light's spectrum is used *unclamped* regardless of effect type
    (reference ``From<&UILight> for Light``, src/shader.rs:205-210)."""

    position: tuple[float, float, float]
    spectrum: SceneSpectrum
    name: str = "New Light"
    hidden: bool = False


# --- object geometry variants (reference UIObjectType, src/main.rs:2070-2076)

@dataclasses.dataclass(frozen=True)
class PlainBox:
    x_length: float = 2.0
    y_length: float = 2.0
    z_length: float = 2.0


@dataclasses.dataclass(frozen=True)
class Sphere:
    radius: float = 1.0


@dataclasses.dataclass(frozen=True)
class RotatedBox:
    x_length: float = 2.0
    y_length: float = 2.0
    z_length: float = 2.0
    x_rotation: float = 0.0
    y_rotation: float = 0.0
    z_rotation: float = 0.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Indexed triangle mesh — a geometry class beyond the reference
    (its ``UIObjectType`` has only boxes and spheres,
    src/main.rs:2070-2076).

    ``vertices`` is a tuple of ``(x, y, z)`` tuples in object space
    (the owning ``SceneObject.position`` translates them to world
    space); ``faces`` is a tuple of ``(i0, i1, i2)`` vertex-index
    triples. Triangles are single-sided in the reference's own normal
    convention: the geometric normal is ``normalize((v1 - v0) x
    (v2 - v0))`` — counter-clockwise winding faces the normal — and is
    never flipped toward the ray (exactly like the reference's sphere/
    box normals, which also stay geometric when hit from behind).

    Flattening expands each face into one first-class object row, so
    meshes trace through the same brute-force/clustered kernels, NEE,
    dispersion and AOV machinery as every other object type, and scale
    with the measured many-object path (Morton clustering groups
    spatially-local triangles automatically).

    ``normals`` (optional, one per vertex) enables smooth shading:
    shading normals are barycentrically interpolated across each face
    (Phong normal interpolation) — the Moller-Trumbore test already
    produces the barycentrics, so interpolation is nearly free in every
    backend. Empty (the default) keeps flat winding normals. Use
    ``scene.mesh.smooth_normals()`` to derive area-weighted ones."""

    vertices: tuple = ()
    faces: tuple = ()
    normals: tuple = ()

    def __post_init__(self):
        # normalize to hashable nested tuples (frozen dataclass: set via
        # object.__setattr__, the standard idiom)
        object.__setattr__(
            self, "vertices",
            tuple(tuple(float(c) for c in v) for v in self.vertices),
        )
        object.__setattr__(
            self, "faces",
            tuple(tuple(int(i) for i in f) for f in self.faces),
        )
        object.__setattr__(
            self, "normals",
            tuple(tuple(float(c) for c in n) for n in self.normals),
        )

    @property
    def n_triangles(self) -> int:
        return len(self.faces)


ObjectType = Union[PlainBox, Sphere, RotatedBox, Mesh]


@dataclasses.dataclass
class SceneObject:
    """Reference ``UIObject`` (src/main.rs:1991-2038)."""

    position: tuple[float, float, float]
    object_type: ObjectType
    material: Material
    name: str = "New Object"
    hidden: bool = False


@dataclasses.dataclass
class Camera:
    """Pinhole camera (reference ``UICamera``, src/main.rs:1957-1985),
    plus an optional thin-lens aperture the reference lacks.

    ``aperture_radius`` > 0 enables depth of field: each progressive
    frame samples ONE lens point (screen-wide, like the reference's
    screen-wide sub-pixel jitter) on a disk of this radius in the
    camera's right/true-up plane, and every pixel ray is re-aimed at
    its pinhole ray's intersection with the focus plane
    ``focus_distance`` along the view axis — accumulation over frames
    integrates the aperture. At the default 0.0 the camera is the
    reference-exact pinhole (bit-identical ray generation)."""

    position: tuple[float, float, float] = (0.0, 0.0, -2.0)
    direction: tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov_y_deg: float = 60.0
    aperture_radius: float = 0.0
    focus_distance: float = 1.0


F32_DELTA = 1e-5  # reference src/shader.rs:7


def are_linear_dependent(a, b) -> bool:
    """Reference ``are_linear_dependent`` (src/main.rs:2198-2203)."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    cross = np.cross(a, b)
    return bool(np.all(np.abs(cross) < F32_DELTA))


@dataclasses.dataclass
class Scene:
    """The full render configuration (reference ``UIFields``,
    src/main.rs:1511-1535). ``nbr_of_threads`` has no TPU meaning and is
    accepted for scene-file compatibility only."""

    width: int = 600
    height: int = 400
    nbr_of_iterations: int = NBR_OF_ITERATIONS_DEFAULT
    nbr_of_ray_bounces: int = NEW_RAY_MAX_BOUNCES_DEFAULT
    camera: Camera = dataclasses.field(default_factory=Camera)
    lights: list[Light] = dataclasses.field(default_factory=list)
    objects: list[SceneObject] = dataclasses.field(default_factory=list)
    spectra: list[SceneSpectrum] = dataclasses.field(default_factory=list)
    materials: list[Material] = dataclasses.field(default_factory=list)
    spectrum_lower_bound: float = VISIBLE_LIGHT_WAVELENGTH_LOWER_BOUND
    spectrum_upper_bound: float = VISIBLE_LIGHT_WAVELENGTH_UPPER_BOUND
    spectrum_number_of_samples: int = NBR_OF_SPECTRUM_SAMPLES_DEFAULT
    nbr_of_threads: int = 0  # compat only; parallelism is the device mesh
    # beyond-reference: environment emission. A ray that escapes the scene
    # collects ``throughput * sky`` instead of the reference's zero miss
    # shader (src/shader.rs:460-463); ``None`` keeps the reference-exact
    # black background. Must reference an EMISSIVE spectrum in ``spectra``.
    sky: SceneSpectrum | None = None

    # ------------------------------------------------------------- updates

    def update_all_spectrum_sample_sizes(self, n: int | None = None) -> None:
        """Regenerate every spectrum at the configured sample count
        (reference src/main.rs:1186-1228)."""
        if n is not None:
            self.spectrum_number_of_samples = n
        n = self.spectrum_number_of_samples
        for s in self.spectra:
            s.regenerate(self.spectrum_lower_bound, self.spectrum_upper_bound, n)

    # ------------------------------------------------------------ legality

    def validate(self) -> None:
        """Raise ``SceneError`` on states the reference's
        ``check_render_legality`` (src/main.rs:1452-1484) rejects, plus the
        camera linear-dependence assert (src/main.rs:1407-1412)."""
        spectra_ids = {id(s) for s in self.spectra}
        material_ids = {id(m) for m in self.materials}

        for light in self.lights:
            if id(light.spectrum) not in spectra_ids:
                raise SceneError(
                    f"light {light.name!r} references a spectrum not in the scene"
                )
        if self.sky is not None:
            if id(self.sky) not in spectra_ids:
                raise SceneError(
                    "scene sky references a spectrum not in the scene"
                )
            if self.sky.effect_type != SpectrumEffectType.EMISSIVE:
                raise SceneError(
                    f"sky spectrum {self.sky.name!r} must be EMISSIVE "
                    "(it is collected as environment emission on miss)"
                )
        for obj in self.objects:
            if id(obj.material) not in material_ids:
                raise SceneError(
                    f"object {obj.name!r} references a material not in the scene"
                )
            if isinstance(obj.object_type, Mesh):
                m = obj.object_type
                nv = len(m.vertices)
                if not m.faces:
                    raise SceneError(
                        f"mesh object {obj.name!r} has no faces"
                    )
                for f in m.faces:
                    if len(f) != 3:
                        raise SceneError(
                            f"mesh object {obj.name!r} has a non-triangle "
                            f"face {f} (triangulate on import)"
                        )
                    if any(not 0 <= i < nv for i in f):
                        raise SceneError(
                            f"mesh object {obj.name!r} face {f} references "
                            f"a vertex outside [0, {nv})"
                        )
                for v in m.vertices:
                    if len(v) != 3:
                        raise SceneError(
                            f"mesh object {obj.name!r} has a non-3D vertex"
                        )
                if m.normals and len(m.normals) != nv:
                    raise SceneError(
                        f"mesh object {obj.name!r} has {len(m.normals)} "
                        f"normals for {nv} vertices (one per vertex, or "
                        "none for flat shading)"
                    )
                for n_ in m.normals:
                    if len(n_) != 3:
                        raise SceneError(
                            f"mesh object {obj.name!r} has a non-3D normal"
                        )
        for mat in self.materials:
            if id(mat.spectrum) not in spectra_ids:
                raise SceneError(
                    f"material {mat.name!r} references a spectrum not in the scene"
                )
            if mat.emission is not None and id(mat.emission) not in spectra_ids:
                raise SceneError(
                    f"material {mat.name!r} references an emission spectrum "
                    "not in the scene"
                )
            if not 0.0 <= mat.transmission <= 1.0:
                raise SceneError(
                    f"material {mat.name!r} transmission must be in [0, 1]"
                )
            if mat.transmission > 0.0 and mat.ior <= 0.0:
                raise SceneError(f"material {mat.name!r} needs a positive ior")
            if mat.texture is not None:
                if mat.texture.scale <= 0.0:
                    raise SceneError(
                        f"material {mat.name!r} texture scale must be > 0"
                    )
                if not 0.0 <= mat.texture.low <= 1.0:
                    raise SceneError(
                        f"material {mat.name!r} texture low factor must "
                        "be in [0, 1]"
                    )
        n = self.spectrum_number_of_samples
        for s in self.spectra:
            if s.spectrum.get_nbr_of_samples() != n:
                raise SceneError(
                    f"spectrum {s.name!r} has {s.spectrum.get_nbr_of_samples()} "
                    f"samples, scene expects {n}"
                )
        if n % 8 != 0 or not 8 <= n <= 128:
            raise SceneError("spectrum sample count must be a multiple of 8 in [8, 128]")
        if are_linear_dependent(self.camera.direction, self.camera.up):
            raise SceneError(
                "camera view direction and up direction are linearly dependent"
            )
        if self.camera.aperture_radius < 0.0:
            raise SceneError("camera aperture_radius must be >= 0")
        if self.camera.aperture_radius > 0.0 and self.camera.focus_distance <= 0.0:
            raise SceneError(
                "depth of field (aperture_radius > 0) needs a positive "
                "focus_distance"
            )
        if self.width <= 0 or self.height <= 0:
            raise SceneError("image dimensions must be positive")
        if self.nbr_of_iterations < 1:
            # iterations=0 would reach hammersley(frame, N=0) -> NaN jitter
            # if frames are ever forced; the reference UI slider floors at 1
            raise SceneError("nbr_of_iterations must be >= 1")
        if not 1 <= self.nbr_of_ray_bounces <= NEW_RAY_MAX_BOUNCES_MAX:
            raise SceneError(
                f"ray bounces must be in [1, {NEW_RAY_MAX_BOUNCES_MAX}]"
            )

    def visible_objects(self) -> list[SceneObject]:
        return [o for o in self.objects if not o.hidden]

    def visible_lights(self) -> list[Light]:
        return [l for l in self.lights if not l.hidden]
