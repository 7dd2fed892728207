"""``BENCHMARK.json`` against the benchmark's contract, every cell's files,
and a cell added as files only that the harness finds and runs (on the
CPU, at a tiny size, its look for a card skipped)."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from benchmark.harness import core
from benchmark.tests import tiny

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    m = MANIFEST
    assert set(m) == KEYS["top"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p.split("/")
        assert (REPO / p).is_dir()
    assert 1 <= len(m["command"]) <= 32 and all(_line(w) for w in m["command"])
    for word in m["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in m["paths"])
            assert (REPO / word).is_file()
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # the check's time: 2 + 14 runs per cell at 24 cells must fit in 43,200 s
    assert (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    m = MANIFEST
    names = [c["name"] for c in m["configs"]]
    names += [w["name"] for w in m["workloads"]]
    metrics = m["end_to_end"] + m["per_layer"]
    for group in (names, [x["name"] for x in metrics]):
        assert len(group) == len(set(group))
    for n in names + [x["name"] for x in metrics]:
        assert NAME.match(n), n
    for c in m["configs"]:
        assert set(c) == KEYS["config"]
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert (REPO / c["file"]).is_file()
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
    assert len({c["file"] for c in m["configs"]}) == len(m["configs"])
    for kind in ("end_to_end", "per_layer"):
        assert 1 <= len(m[kind]) <= (16 if kind == "end_to_end" else 128)
        for x in m[kind]:
            assert set(x) - {"workloads"} == KEYS[kind], x["name"]
            assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(x["layer"])


def test_cells():
    m = MANIFEST
    configs = {c["name"] for c in m["configs"]}
    assert 1 <= len(m["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])
    assert configs == {w["config"] for w in m["workloads"]}
    four = sum(1 for w in m["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(m["workloads"]) // 4)
    for w in m["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4)
        assert _line(w["why"]) and NAME.match(w["traffic"])
        own = json.loads((REPO / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        assert {k: own[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        assert set(own["limits"]) == {"pixel_gap"}
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        cell = core.load_cell(REPO, w["name"])
        reported = {x["name"] for x in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        driver = json.loads((REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (REPO / "benchmark" / "drivers" / f"{driver['driver']}.py").is_file()


def test_per_layer_metrics_move_what_their_cells_report():
    m = MANIFEST
    cells = {w["name"] for w in m["workloads"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    layers = {}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert x["workloads"] and set(x["workloads"]) <= cells
        for c in x["workloads"]:
            assert c in e2e[x["moves"]].get("workloads", cells), (x["name"], c)
        assert (REPO / "benchmark" / "metrics" / f"{x['name']}.py").is_file()
        layers.setdefault(x["layer"].lower(), set()).add(x["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_configs_state_their_sizes():
    from benchmark.harness import scene

    for c in MANIFEST["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        doc = scene.scene_dict(cfg)
        assert doc["format"] == "spectral_tpu.scene/v1"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    scene = json.loads((REPO / "benchmark/configs/cornell512.json").read_text())["scene"]
    configs = {"tinybox": tiny.tiny_config("tinybox", scene, 24, 16, 3, 4)}
    cells = {"tinybox.regen": {"config": "tinybox", "traffic": "regen", "chips": 1,
                               "why": "tests", "like": "cornell512.regen",
                               "limits": tiny.limits("cornell512.regen")}}
    return tiny.tree(tmp_path_factory.mktemp("bench"), cells, configs)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_a_cell_added_as_files_runs(tiny_root, traced):
    out = core.run_cell(tiny_root, "tinybox.regen", 2**31 + 12345, 0.3, traced, device="cpu")
    assert list(out) == (["correct", "attempted", "failed", "metrics", "device"]
                         + (["breakdown"] if traced else []) + ["check"])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["check"]["pixel_gap"]["value"] <= out["check"]["pixel_gap"]["limit"]
    if traced:
        # a CPU run writes no device metric
        assert "regen.roofline_pct" not in out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0.0
    else:
        assert set(out["metrics"]) == {"msamples_per_s", "setup_s"}
        assert out["metrics"]["msamples_per_s"]["unit"] == "Msamples/s"


def test_a_missing_cell_is_refused(tiny_root):
    with pytest.raises(core.SetupError):
        core.run_cell(tiny_root, "nosuch.cell", 1, 0.1, False, device="cpu")


def test_no_card_no_result(tiny_root, monkeypatch, capsys):
    """Without a card the command prints no result and exits non-zero."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = core.main(["--workload", "tinybox.regen", "--seed", "1", "--seconds", "0.1",
                    "--trace", "0"], root=tiny_root)
    assert rc != 0
    assert capsys.readouterr().out == ""
