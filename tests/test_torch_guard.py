"""The port stands alone: no module of ``spectral_tpu_torch``, and not
``chip_smoke.py``, imports ``jax``, anything of the JAX package
``spectral_tpu`` or the reference's ``tools/`` (the port's probe keeps
its own copy of ``tools/mxu_trace_probe.py``'s inputs and kernels),
neither at the top of a module nor inside a function.

Two checks: every ``import`` statement of every source file, parsed with
``ast`` (one case per file), and every module imported in a fresh
interpreter, after which neither package may be in ``sys.modules``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SOURCES = sorted((REPO / "spectral_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "spectral_tpu", "tools")


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_no_module_reaches_jax_at_import():
    code = (
        "import importlib, pkgutil, sys\n"
        "import spectral_tpu_torch as st\n"
        "for m in pkgutil.walk_packages(st.__path__, 'spectral_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "st.presets.sphere_field(100); st.schema.Scene\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'spectral_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
