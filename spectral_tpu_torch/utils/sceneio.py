"""Scene (de)serialization to JSON.

The declarative config surface the reference lacks (its settings
serialization is an explicit TODO, reference ``src/main.rs:73``): every
UI-facing knob of the scene schema round-trips through a plain JSON
document, with spectra/materials referenced by list index (the JSON
analog of the reference's ``Rc`` identity graph).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from spectral_tpu_torch.runtime import trace
from spectral_tpu_torch.scene import schema as S


_SPECTRUM_TYPES = {
    "custom": S.Custom,
    "solar": S.Solar,
    "measured_solar": S.MeasuredSolar,
    "plain_reflective": S.PlainReflective,
    "temperature": S.Temperature,
    "reflective_red": S.ReflectiveRed,
    "reflective_green": S.ReflectiveGreen,
    "reflective_blue": S.ReflectiveBlue,
}
_SPECTRUM_NAMES = {v: k for k, v in _SPECTRUM_TYPES.items()}

_OBJECT_TYPES = {
    "plain_box": S.PlainBox,
    "sphere": S.Sphere,
    "rotated_box": S.RotatedBox,
    "mesh": S.Mesh,  # vertices/faces round-trip as nested JSON lists
}
_OBJECT_NAMES = {v: k for k, v in _OBJECT_TYPES.items()}


def _spectrum_type_to_json(t) -> dict:
    d = {"kind": _SPECTRUM_NAMES[type(t)]}
    for field in t.__dataclass_fields__:
        d[field] = getattr(t, field)
    return d


def _spectrum_type_from_json(d: dict):
    d = dict(d)
    cls = _SPECTRUM_TYPES[d.pop("kind")]
    return cls(**d)


def scene_to_dict(scene: S.Scene) -> dict:
    spectrum_index = {id(sp): i for i, sp in enumerate(scene.spectra)}
    material_index = {id(m): i for i, m in enumerate(scene.materials)}

    def spectrum_json(sp: S.SceneSpectrum) -> dict:
        d = {
            "name": sp.name,
            "type": _spectrum_type_to_json(sp.spectrum_type),
            "effect": sp.effect_type.value,
        }
        if isinstance(sp.spectrum_type, S.Custom):
            d["values"] = [float(v) for v in sp.spectrum.values]
        return d

    return {
        "format": "spectral_tpu.scene/v1",
        "settings": {
            "width": scene.width,
            "height": scene.height,
            "iterations": scene.nbr_of_iterations,
            "max_bounces": scene.nbr_of_ray_bounces,
            "spectrum_samples": scene.spectrum_number_of_samples,
            "spectrum_lower_bound": scene.spectrum_lower_bound,
            "spectrum_upper_bound": scene.spectrum_upper_bound,
            # reference-app compat only; TPU parallelism is the mesh
            "threads": scene.nbr_of_threads,
        },
        "camera": {
            "position": list(scene.camera.position),
            "direction": list(scene.camera.direction),
            "up": list(scene.camera.up),
            "fov_y_deg": scene.camera.fov_y_deg,
            "aperture_radius": scene.camera.aperture_radius,
            "focus_distance": scene.camera.focus_distance,
        },
        "spectra": [spectrum_json(sp) for sp in scene.spectra],
        "materials": [
            {
                "name": m.name,
                "metallicness": m.metallicness,
                "roughness": m.roughness,
                "spectrum": spectrum_index[id(m.spectrum)],
                **(
                    {
                        "transmission": m.transmission,
                        "ior": m.ior,
                        "cauchy_b_um2": m.cauchy_b_um2,
                    }
                    # keep the round trip lossless whenever any dielectric
                    # field differs from its default
                    if (m.transmission or m.ior != 1.5 or m.cauchy_b_um2)
                    else {}
                ),
                **(
                    {"emission": spectrum_index[id(m.emission)]}
                    if m.emission is not None
                    else {}
                ),
                **(
                    {"texture": {"kind": "checker",
                                 "scale": m.texture.scale,
                                 "low": m.texture.low}}
                    if m.texture is not None
                    else {}
                ),
            }
            for m in scene.materials
        ],
        "lights": [
            {
                "name": l.name,
                "position": list(l.position),
                "spectrum": spectrum_index[id(l.spectrum)],
                "hidden": l.hidden,
            }
            for l in scene.lights
        ],
        # beyond-reference environment emission; absent = the reference's
        # black background (pre-sky scene files load unchanged)
        **(
            {"sky": spectrum_index[id(scene.sky)]}
            if scene.sky is not None
            else {}
        ),
        "objects": [
            {
                "name": o.name,
                "position": list(o.position),
                "type": {
                    "kind": _OBJECT_NAMES[type(o.object_type)],
                    **{
                        f: getattr(o.object_type, f)
                        for f in o.object_type.__dataclass_fields__
                    },
                },
                "material": material_index[id(o.material)],
                "hidden": o.hidden,
            }
            for o in scene.objects
        ],
    }


def scene_from_dict(data: dict) -> S.Scene:
    with trace.span("scene.parse"):
        return _parse(data)


def _parse(data: dict) -> S.Scene:
    if data.get("format") != "spectral_tpu.scene/v1":
        raise ValueError(
            f"unsupported scene format {data.get('format')!r} "
            "(expected 'spectral_tpu.scene/v1')"
        )
    st = data["settings"]
    n = int(st["spectrum_samples"])
    lo = float(st.get("spectrum_lower_bound", 380.0))
    hi = float(st.get("spectrum_upper_bound", 780.0))

    spectra = []
    for d in data["spectra"]:
        stype = _spectrum_type_from_json(d["type"])
        values = np.asarray(d["values"], dtype=np.float32) if "values" in d else None
        spectra.append(
            S.SceneSpectrum.new(
                d["name"],
                stype,
                S.SpectrumEffectType(d["effect"]),
                lo=lo,
                hi=hi,
                n=n,
                values=values,
            )
        )

    materials = [
        S.Material(
            float(m["metallicness"]),
            float(m["roughness"]),
            spectra[int(m["spectrum"])],
            m["name"],
            transmission=float(m.get("transmission", 0.0)),
            ior=float(m.get("ior", 1.5)),
            cauchy_b_um2=float(m.get("cauchy_b_um2", 0.0)),
            emission=(
                spectra[int(m["emission"])] if "emission" in m else None
            ),
            texture=(
                S.Checker(float(m["texture"]["scale"]),
                          float(m["texture"]["low"]))
                if "texture" in m
                else None
            ),
        )
        for m in data["materials"]
    ]
    lights = [
        S.Light(
            tuple(l["position"]),
            spectra[int(l["spectrum"])],
            l["name"],
            bool(l.get("hidden", False)),
        )
        for l in data["lights"]
    ]

    objects = []
    for o in data["objects"]:
        td = dict(o["type"])
        cls = _OBJECT_TYPES[td.pop("kind")]
        objects.append(
            S.SceneObject(
                tuple(o["position"]),
                cls(**td),
                materials[int(o["material"])],
                o["name"],
                bool(o.get("hidden", False)),
            )
        )

    cam = data["camera"]
    return S.Scene(
        width=int(st["width"]),
        height=int(st["height"]),
        nbr_of_iterations=int(st["iterations"]),
        nbr_of_ray_bounces=int(st["max_bounces"]),
        camera=S.Camera(
            tuple(cam["position"]),
            tuple(cam["direction"]),
            tuple(cam["up"]),
            float(cam["fov_y_deg"]),
            # absent in pre-DoF scene files: default to the pinhole
            float(cam.get("aperture_radius", 0.0)),
            float(cam.get("focus_distance", 1.0)),
        ),
        lights=lights,
        objects=objects,
        spectra=spectra,
        materials=materials,
        spectrum_lower_bound=lo,
        spectrum_upper_bound=hi,
        spectrum_number_of_samples=n,
        nbr_of_threads=int(st.get("threads", 0)),
        sky=(spectra[int(data["sky"])] if "sky" in data else None),
    )


def save_scene(scene: S.Scene, path: str | Path) -> None:
    Path(path).write_text(json.dumps(scene_to_dict(scene), indent=2))


def load_scene(path: str | Path) -> S.Scene:
    return scene_from_dict(json.loads(Path(path).read_text()))
