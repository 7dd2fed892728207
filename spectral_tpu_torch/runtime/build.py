"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes`` (the pattern of ``spectral_tpu.runtime.native``).

Each ``ops/csrc/<name>.cu`` becomes ``build/lib<name>.so`` inside this
package, rebuilt when the ``.cu`` or any ``.cuh`` beside it is newer than
the library. ``build_all`` starts one ``nvcc`` per out-of-date source,
all at once, and waits for them. The sources expose a plain C interface,
so the build does not include PyTorch's headers and takes seconds.
``nvcc -Xptxas -v``'s report of registers, shared memory and spills is
kept next to each library (``build_log``), with its compile seconds
(``build_seconds``). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
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


def build_seconds(name: str) -> float | None:
    """The seconds the last build of ``name`` here took, from the common
    start of its build's compilers to its own end (``build_all``)."""
    m = re.search(r"^build seconds: ([0-9.]+)$", build_log(name), re.M)
    return float(m.group(1)) if m else None


# the kernel sources under ops/csrc, one library each
SOURCES = ("mono", "regen", "persist", "seg", "probe")
BOUNCE_SOURCES = ("mono", "regen", "persist", "seg")
# The opt-in builds of the bounce sources, each a library of its own that
# the render paths load only for the scenes that need it, so that the
# others keep the code, registers and bits of the default libraries
# (ops/csrc/bounce.cuh; the host picks one with megakernel.library_for):
# - the feature builds (-DSPECTRAL_FX): the scene-feature branches (sky,
#   checker texture, emission, dielectric), the same instantiations;
# - the wide triangle builds (-DSPECTRAL_TRI_WIDE): the triangle
#   instantiations at S = 16 and 64 and nothing else (the default
#   libraries build triangles at S = 8 and 32; all four S in them made
#   their longest build more than a quarter slower, PERF.md section 6);
# - the lens builds of regen.cu (-DSPECTRAL_LENS): the per-frame lens
#   table of depth of field, every instantiation, triangles at every S
#   (-DSPECTRAL_TRI_ALL);
# - the shadow-interval builds of mono.cu and regen.cu
#   (-DSPECTRAL_SHADOW_INTERVAL): the sqrt-free sphere shadow test,
#   many-object instantiations only, with the lens and triangles at
#   every S.
# - the register builds of persist.cu (-DSPECTRAL_PERSIST_REGISTERS): the
#   spectral state in registers (the earlier design, every
#   instantiation), for the tables where that holds more blocks per SM or
#   the walk streams its records from global memory (persist.cu's source
#   note; megakernel.persist_library), with and without features and
#   wide triangles.
# A library of each kind is built together with the others of its kind
# (the same defines) at the first launch that needs one.
FEATURE_DEFINES = ("-DSPECTRAL_FX",)
TRI_WIDE_DEFINES = ("-DSPECTRAL_TRI_WIDE",)
LENS_DEFINES = ("-DSPECTRAL_LENS", "-DSPECTRAL_TRI_ALL")
SHADOW_INTERVAL_DEFINES = ("-DSPECTRAL_SHADOW_INTERVAL",) + LENS_DEFINES
FEATURE_LIBRARIES = {f"{src}_fx": (src, FEATURE_DEFINES) for src in BOUNCE_SOURCES}
TRIANGLE_LIBRARIES = {f"{src}{fx}_tri": (src, defs + TRI_WIDE_DEFINES)
                      for fx, defs in (("", ()), ("_fx", FEATURE_DEFINES))
                      for src in BOUNCE_SOURCES}
LENS_LIBRARIES = {"regen_lens": ("regen", LENS_DEFINES),
                  "regen_fx_lens": ("regen", FEATURE_DEFINES + LENS_DEFINES)}
SHADOW_INTERVAL_LIBRARIES = {f"{src}_si": (src, SHADOW_INTERVAL_DEFINES)
                             for src in ("mono", "regen")}
REGISTER_DEFINES = ("-DSPECTRAL_PERSIST_REGISTERS",)
REGISTER_LIBRARIES = {f"persist{fx}{tri}_reg": ("persist", d1 + d2 + REGISTER_DEFINES)
                    for fx, d1 in (("", ()), ("_fx", FEATURE_DEFINES))
                    for tri, d2 in (("", ()), ("_tri", TRI_WIDE_DEFINES))}
# diagnostic libraries, never loaded by the render paths: a source built
# with extra defines (its source note says what each changes). The
# measurement tools and chip_smoke.py build them beside the main ones.
VARIANTS = {
    **{f"{src}_stats": (src, ("-DSPECTRAL_STATS",)) for src in ("regen", "persist", "mono", "seg")},
    "persist_reg_stats": ("persist", REGISTER_DEFINES + ("-DSPECTRAL_STATS",)),
}
LIBRARIES = {**{src: (src, ()) for src in SOURCES}, **FEATURE_LIBRARIES,
             **TRIANGLE_LIBRARIES, **LENS_LIBRARIES, **SHADOW_INTERVAL_LIBRARIES,
             **REGISTER_LIBRARIES, **VARIANTS}
# every library a render path can load (chip_smoke.py builds them up front)
RENDER_LIBRARIES = tuple(n for n in LIBRARIES if n not in VARIANTS)


def _source(name: str) -> tuple[Path, tuple]:
    src, defines = LIBRARIES[name]
    return CSRC_DIR / f"{src}.cu", defines


def kind_of(name: str) -> tuple[str, ...]:
    """The render libraries built with ``name``'s defines: the ones a
    first launch of ``name`` builds together."""
    defines = _source(name)[1]
    return tuple(n for n in RENDER_LIBRARIES if LIBRARIES[n][1] == defines) or (name,)


def has_features(name: str) -> bool:
    """Whether library ``name`` is built with the scene-feature branches."""
    return FEATURE_DEFINES[0] in _source(name)[1]


def has_shadow_interval(name: str) -> bool:
    """Whether library ``name`` is built with the sqrt-free shadow test."""
    return SHADOW_INTERVAL_DEFINES[0] in _source(name)[1]


def has_lens(name: str) -> bool:
    """Whether library ``name`` takes the regeneration kernel's lens table."""
    return LENS_DEFINES[0] in _source(name)[1]


def kernel_resources(name: str) -> list[dict]:
    """Each kernel instantiation of library ``name`` as ``nvcc -Xptxas
    -v`` reported it at its last build here: the kernel with its template
    arguments (``regen_kernel<64,0,0>``: S, then the flags in source
    order), registers, and spill stores and loads in bytes."""
    return parse_resources(build_log(name))


def parse_resources(log: str) -> list[dict]:
    """``kernel_resources`` of one ``nvcc -Xptxas -v`` report."""
    out, entry = [], None
    for ln in log.splitlines():
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


def compile_parallel(jobs: dict, timeout: float = 900) -> dict:
    """Run one compiler command per entry of ``jobs`` (name: argv), all
    started together, each one's output to a file. Returns name:
    ``(returncode, output, seconds)``, the seconds from the common start
    to that process's end. No process outlives the call."""
    procs = {}
    start = time.monotonic()
    try:
        for name, cmd in jobs.items():
            log = open(BUILD_DIR / f".{name}.{os.getpid()}.out", "w+")
            try:
                procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log)
            except OSError as e:
                log.close()
                raise BuildError(f"nvcc failed to run: {e}") from e
        done = {}
        while len(done) < len(procs):
            for name, (proc, log) in procs.items():
                if name in done:
                    continue
                if proc.poll() is None:
                    if time.monotonic() - start <= timeout:
                        continue
                    proc.kill()
                    proc.wait()
                log.seek(0)
                done[name] = (proc.returncode, log.read(), time.monotonic() - start)
            time.sleep(0.05)
        return done
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            Path(log.name).unlink(missing_ok=True)


def build_all(names=SOURCES, force: bool = False) -> list[Path]:
    """Compile every out-of-date library of ``names`` (of ``LIBRARIES``;
    all of them with ``force``), one ``nvcc`` per library, started
    together."""
    names = tuple(dict.fromkeys(names))  # one nvcc per library, however often named
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [name for name in names if force or _stale(name)]
    if not todo:
        return [library_path(name) for name in names]
    nvcc = nvcc_path()
    tmp = {name: library_path(name).with_name(f"lib{name}.so.{os.getpid()}.tmp")
           for name in todo}
    jobs = {}
    for name in todo:
        src, defines = _source(name)
        jobs[name] = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp[name]), str(src)]
    failed = []
    for name, (rc, out, seconds) in compile_parallel(jobs).items():
        if rc != 0:
            tmp[name].unlink(missing_ok=True)
            failed.append(f"nvcc failed ({rc}) on {_source(name)[0].name} for {name}:\n{out}")
            continue
        (BUILD_DIR / f"lib{name}.log").write_text(f"build seconds: {seconds:.3f}\n{out}")
        os.replace(tmp[name], library_path(name))  # atomic: a concurrent loader never sees half a file
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
