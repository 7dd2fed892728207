"""A configuration's scene document, checked against its stated sizes."""

from __future__ import annotations

import copy

SIZE_KEYS = {"width": "width", "height": "height", "wavelengths": "spectrum_samples",
             "bounces": "max_bounces", "iterations": "iterations"}


def scene_dict(config: dict) -> dict:
    """A copy of the configuration's scene (the port's scene-file format),
    after checking that its settings are the sizes the file states."""
    scene = copy.deepcopy(config["scene"])
    for key, setting in SIZE_KEYS.items():
        if int(scene["settings"][setting]) != int(config[key]):
            raise ValueError(f"{config['name']}: the scene's {setting} is "
                             f"{scene['settings'][setting]}, the configuration states {config[key]}")
    return scene


def samples_per_image(config: dict) -> int:
    """Spectral samples of one image: pixels x wavelengths x iterations."""
    return (int(config["width"]) * int(config["height"]) * int(config["wavelengths"])
            * int(config["iterations"]))
