"""Compile seconds, registers and spills of every CUDA library of one or
more checkouts of the port, on the machine with the card.

    python -m spectral_tpu_torch.tools.build_times [--checkout DIR ...]
        [--extra]

For each checkout (default: this one), in the order given, builds its
default and feature libraries (``SOURCES`` and ``FEATURE_LIBRARIES``:
the set every checkout with feature builds has)
into a temporary directory (this package's own into its build
directory, where its loader finds them), one ``nvcc`` per library, all
started together, with the checkout's own flags and sources; ``--extra``
then builds the rest of the checkout's ``RENDER_LIBRARIES`` the same
way, as a second wave. Prints one JSON line per checkout and wave: the
wall seconds, per library the seconds from the common start to its end,
and each kernel instantiation's registers and spills (``nvcc -Xptxas
-v``). Two checkouts in one call give a parent-against-change comparison
on one host.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import tempfile
import time
from pathlib import Path

from spectral_tpu_torch.runtime import build


def _build_module(checkout: Path):
    """The checkout's ``runtime/build.py``, loaded from its file."""
    path = checkout / "spectral_tpu_torch" / "runtime" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{abs(hash(path))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_build(checkout: Path, names, mod) -> dict:
    """Build ``names`` of the checkout's build module ``mod`` together
    into a temporary directory; raises if one fails."""
    nvcc = build.nvcc_path()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name in names:
            src, defines = mod._source(name)
            jobs[name] = [nvcc, *mod.NVCC_FLAGS, *defines, "-o",
                          str(Path(tmp) / f"lib{name}.so"), str(src)]
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.monotonic()
        done = build.compile_parallel(jobs)
        wall = time.monotonic() - t0
    failed = {n: out for n, (rc, out, _s) in done.items() if rc != 0}
    if failed:
        raise build.BuildError(f"{checkout}: nvcc failed on {sorted(failed)}:\n"
                               + "\n".join(failed.values()))
    return dict(checkout=str(checkout), wall_seconds=wall,
                seconds={n: s for n, (_rc, _out, s) in done.items()},
                kernels={n: build.parse_resources(out) for n, (_rc, out, _s) in done.items()})


def own_build(names) -> dict:
    """``build.build_all`` of this package's libraries ``names``, forced,
    into its build directory (a later launch in the process loads them),
    reported like ``time_build``."""
    t0 = time.monotonic()
    build.build_all(names, force=True)
    return dict(checkout=str(build.PKG_DIR.parent), wall_seconds=time.monotonic() - t0,
                seconds={n: build.build_seconds(n) for n in names},
                kernels={n: build.kernel_resources(n) for n in names})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", action="append", type=Path,
                    help="root of a checkout of the port (repeatable; default: this one)")
    ap.add_argument("--extra", action="store_true",
                    help="also build the checkout's other render libraries, as a second wave")
    args = ap.parse_args(argv)
    for checkout in args.checkout or [build.PKG_DIR.parent]:
        checkout = checkout.resolve()
        mod = _build_module(checkout)
        waves = [("main", tuple(mod.SOURCES) + tuple(mod.FEATURE_LIBRARIES))]
        extra = tuple(n for n in getattr(mod, "RENDER_LIBRARIES", ()) if n not in waves[0][1])
        if args.extra and extra:
            waves.append(("extra", extra))
        for wave, names in waves:
            if checkout == build.PKG_DIR.parent:
                out = own_build(names)  # this package: built where its loader finds it
            else:
                out = time_build(checkout, names, mod)
            print(json.dumps(dict(wave=wave, **out)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
