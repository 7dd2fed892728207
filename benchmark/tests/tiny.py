"""A copy of the benchmark's files with tiny cells added as files only,
for runs on the CPU: the harness finds them by name like any other."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def tiny_config(name: str, scene: dict, width: int, height: int, bounces: int,
                iterations: int) -> dict:
    """A configuration file at a tiny size from a scene document."""
    scene = json.loads(json.dumps(scene))
    st = scene["settings"]
    st.update(width=width, height=height, max_bounces=bounces, iterations=iterations)
    return {"name": name, "source": "a tiny copy for the tests", "width": width,
            "height": height, "wavelengths": st["spectrum_samples"], "bounces": bounces,
            "iterations": iterations, "reduced": ["width", "height"], "scene": scene}


def tree(tmp: Path, cells: dict, configs: dict, traffic: dict | None = None) -> Path:
    """``tmp`` with ``BENCHMARK.json`` and ``benchmark/``'s data, drivers
    and metric readers copied, plus ``configs`` ({name: config}),
    ``traffic`` ({name: mix}) and ``cells`` ({name: workload}) added as
    files and manifest entries."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "traffic", "workloads", "drivers", "metrics"):
        shutil.copytree(REPO / "benchmark" / sub, tmp / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    for name, cfg in configs.items():
        path = f"benchmark/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        manifest["configs"].append({"name": name, "source": cfg["source"], "file": path,
                                    "reduced": cfg["reduced"], "why": "tests"})
    for name, mix in (traffic or {}).items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, w in cells.items():
        like = w.get("like")
        rate = like and _json(REPO / "benchmark" / "workloads" / f"{like}.json").get("rate_metric")
        if rate:  # it reports the rate of the cell it is like
            w = dict(w, rate_metric=rate)
        (tmp / "benchmark" / "workloads" / f"{name}.json").write_text(json.dumps(w))
        manifest["workloads"].append({"name": name, "config": w["config"],
                                      "traffic": w["traffic"], "chips": w["chips"],
                                      "why": "tests"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like and like in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def dense_mixes(stride: int = 2) -> dict:
    """Copies of the repository's traffic mixes, named ``<mix>-dense``,
    comparing every ``stride``-th pixel: a tiny image still compares
    dozens of pixels."""
    out = {}
    for path in sorted((REPO / "benchmark" / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        mix["check"] = dict(mix["check"], stride=stride)
        out[f"{path.stem}-dense"] = mix
    return out


def limits(cell: str) -> dict:
    """The limits of the repository's cell ``cell``."""
    return json.loads((REPO / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]
