"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program either. Names are compared
whole, by the part before the first dot: the program's name,
``spectral_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import core

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "spectral_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (NEVER | {"spectral_tpu_torch"})


def test_reference_loads_nothing_of_the_program():
    """Importing the reference, and running it, loads no module of the
    program, JAX or the JAX package."""
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from benchmark.reference import paths\n"
        "import json\n"
        "doc = json.load(open(sys.argv[1] + '/benchmark/configs/cornell512.json'))['scene']\n"
        "doc['settings'].update(width=8, height=8, max_bounces=2, iterations=2)\n"
        "st, cfg = paths.tables(doc, 'cpu')\n"
        "px = torch.arange(4); py = torch.arange(4)\n"
        "paths.regen_image(st, cfg, px, py, 2, 2)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'spectral_tpu', 'spectral_tpu_torch'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(REPO)], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_the_run_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spectral_tpu_torch_fake", object())
    assert "spectral_tpu_torch_fake" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spectral_tpu.fake", object())
    assert "spectral_tpu.fake" in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib_fake.x", object())
    assert "jaxlib_fake.x" not in core.forbidden_modules()
