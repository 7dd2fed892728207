"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes`` (the pattern of ``spectral_tpu.runtime.native``).

Each ``ops/csrc/<name>.cu`` becomes ``build/lib<name>.so`` inside this
package, rebuilt when the ``.cu`` or any ``.cuh`` beside it is newer than
the library. ``build_all`` starts one ``nvcc`` per out-of-date source,
all at once, and waits for them. The sources expose a plain C interface,
so the build does not include PyTorch's headers and takes seconds.
``nvcc -Xptxas -v``'s report of registers, shared memory and spills is
kept next to each library (``build_log``). Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "ops" / "csrc"
BUILD_DIR = PKG_DIR / "build"

# Hopper only (`a` keeps wgmma/setmaxnreg available to later kernels).
# -fmad=false and no --use_fast_math: the kernels are held to the eager
# PyTorch path, which contracts nothing and rounds division and sqrt.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_log(name: str) -> str:
    """The compiler's report from the last build of ``name`` (registers,
    shared memory and spills per kernel), or '' if never built here."""
    log = BUILD_DIR / f"lib{name}.log"
    return log.read_text() if log.exists() else ""


# the kernel sources under ops/csrc, one library each
SOURCES = ("mono", "regen", "persist", "seg", "probe")
# the feature builds: each bounce kernel's source with the scene-feature
# branches (-DSPECTRAL_FX, ops/csrc/bounce.cuh), the same instantiations.
# The render paths load them for a scene that uses a feature (sky,
# checker texture, emission, dielectric), and the others without
# features, so that a feature-free scene keeps the code, registers and
# bits of the builds without them. Built together at the first launch
# for such a scene.
FEATURE_DEFINES = ("-DSPECTRAL_FX",)
FEATURE_LIBRARIES = {f"{src}_fx": (src, FEATURE_DEFINES)
                     for src in ("mono", "regen", "persist", "seg")}
# diagnostic libraries, never loaded by the render paths: a source built
# with extra defines (its source note says what each changes). The
# measurement tools and chip_smoke.py build them beside the main ones.
VARIANTS = {
    "regen_parent": ("regen", ("-DSPECTRAL_PARENT_DESIGN",)),
    "regen_stats": ("regen", ("-DSPECTRAL_STATS",)),
    "regen_parent_stats": ("regen", ("-DSPECTRAL_PARENT_DESIGN", "-DSPECTRAL_STATS")),
    "seg_stats": ("seg", ("-DSPECTRAL_STATS",)),
}


def _source(name: str) -> tuple[Path, tuple]:
    src, defines = {**FEATURE_LIBRARIES, **VARIANTS}.get(name, (name, ()))
    return CSRC_DIR / f"{src}.cu", defines


def has_features(name: str) -> bool:
    """Whether library ``name`` is built with the scene-feature branches."""
    return FEATURE_DEFINES[0] in _source(name)[1]


def kernel_resources(name: str) -> list[dict]:
    """Each kernel instantiation of library ``name`` as ``nvcc -Xptxas
    -v`` reported it at its last build here: the kernel with its template
    arguments (``regen_kernel<64,0,0>``: S, then the flags in source
    order), registers, and spill stores and loads in bytes."""
    out, entry = [], None
    for ln in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"([a-z]+_kernel)I((?:L[ib]\d+E)+)E", m.group(1))
            plain = re.search(r"([a-z]+_kernel)E", m.group(1))
            entry = (f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2)))}>"
                     if k else plain.group(1) if plain else m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            out.append(dict(entry=entry, registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            entry = None
    return out


def _stale(name: str) -> bool:
    src, _ = _source(name)
    lib = library_path(name)
    newest = max(p.stat().st_mtime for p in (src, *CSRC_DIR.glob("*.cuh")))
    return not lib.exists() or lib.stat().st_mtime < newest


def build_all(names=SOURCES, force: bool = False) -> list[Path]:
    """Compile every out-of-date library of ``names`` (sources of
    ``ops/csrc``, ``FEATURE_LIBRARIES`` or ``VARIANTS``; all of them with
    ``force``), one ``nvcc`` per library, started together."""
    names = tuple(dict.fromkeys(names))  # one nvcc per library, however often named
    jobs = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path() if force or any(map(_stale, names)) else None
    try:
        for name in names:
            if not (force or _stale(name)):
                continue
            src, defines = _source(name)
            lib = library_path(name)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)]
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise BuildError(f"nvcc failed to run: {e}") from e
            jobs.append((name, src, lib, tmp, proc))
        failed = []
        for name, src, lib, tmp, proc in jobs:
            try:
                out, _ = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n{out}")
                continue
            (BUILD_DIR / f"lib{name}.log").write_text(out)
            os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    finally:
        for *_, proc in jobs:  # no nvcc outlives the build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise BuildError("\n".join(failed))
    return [library_path(name) for name in names]


def build(name: str) -> Path:
    """Compile library ``name`` unless it is up to date."""
    return build_all((name,))[0]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so`` once per process."""
    return ctypes.CDLL(str(build(name)))
