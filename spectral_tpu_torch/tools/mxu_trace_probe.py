"""Is the nearest ray-sphere hit faster as tensor-core products than as a
scalar loop? The port of the JAX package's ``tools/mxu_trace_probe.py``:
the same inputs from the same seed, its two kernels as CUDA kernels
(``ops/trace_probe.py``: ``cuda_probe_fori``, the loop over spheres in
shared memory, and ``cuda_probe_mma``, 3xTF32 ``wgmma`` products per
chunk of spheres), and the reference tool's three JSON lines:

    python -m spectral_tpu_torch.tools.mxu_trace_probe
    python -m spectral_tpu_torch.tools.mxu_trace_probe --device cpu --tiles 1

``crosscheck`` holds the two kernels' winners and hit t against each
other, ``vpu_fori`` and ``mxu_blocks`` give each kernel's time per trace
of all rays (CUDA events around 30 launches, after one warm-up) at the
tool's full shape by default: 48 x 4,096 rays, 1,024 spheres, seed 0.
A fourth line, ``accuracy``, holds the tensor-core kernel and the plain
float32 version against a float64 evaluation (``trace_probe.compare``
against ``probe_exact``, each hit's error also over its own
``error_bound``) and checks nothing; with several ``--seed`` values every
seed prints its four lines, which is how the limits ``trace_probe.MMA_*``
were read. On the card each line also names the
card; ``--device cpu`` runs the plain versions and reports no time:

    python -m spectral_tpu_torch.tools.mxu_trace_probe --reps 1 --seed 0 1 2 3

``--sass DIR`` writes ``cuobjdump -sass`` of the ``probe`` library into
DIR and prints a ``sass`` line of instruction counts per kernel (the
toolkit's ``cuobjdump`` beside ``nvcc``).
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from spectral_tpu_torch.ops import trace_probe as tp
from spectral_tpu_torch.runtime import build
from spectral_tpu_torch.tools.measure_persist import card


def time_ms(fn, args, reps: int) -> float:
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiles", type=int, default=tp.N_TILES,
                    help="tiles of 4,096 rays (default 48)")
    ap.add_argument("--objects", type=int, default=tp.N_OBJ)
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sass", type=Path, default=None, metavar="DIR",
                    help="write the SASS of the probe library into DIR")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mxu_trace_probe: no CUDA GPU (pass --device cpu for "
                         "the plain versions)")
    where = {"device": str(dev)}
    if dev.type == "cuda":
        where["card"] = card()
    for seed in args.seed:
        probe(seed, args.tiles, args.objects, args.reps, dev, where)
    if args.sass is not None:
        sass(args.sass, where)


def probe(seed: int, tiles: int, objects: int, reps: int, dev, where: dict) -> None:
    """The four lines of one seed."""
    inputs = tp.make_inputs(seed, tiles, objects)
    fori = tuple(torch.from_numpy(a).to(dev) for a in inputs["fori"])
    mma = tuple(torch.from_numpy(a).to(dev) for a in inputs["mma"])
    ta, ia = tp.cuda_probe_fori(*fori)
    tb, ib = tp.cuda_probe_mma(*mma)
    pt, pw = tp.probe_mma_plain(*mma)
    et, ew = tp.probe_exact(*mma)
    mma_err = tp.compare(tb, ib, et, ew, tp.error_bound(*mma, ew, tp.MMA_DOT_GAMMA))
    plain_err = tp.compare(pt, pw, et, ew, tp.error_bound(*mma, ew, tp.PLAIN_DOT_GAMMA))
    ta, ia, tb, ib = (x.reshape(-1).cpu().numpy() for x in (ta, ia, tb, ib))
    hit = np.isfinite(ta)
    agree = (ia == ib) | (~hit & ~np.isfinite(tb))
    both = hit & np.isfinite(tb)
    diff = np.zeros_like(ta)
    diff[both] = ta[both] - tb[both]
    print(json.dumps({
        "name": "crosscheck",
        "winner_agreement": round(float(agree.mean()), 6),
        "max_t_rel_diff": float(np.max(np.abs(diff) / np.maximum(np.abs(ta), 1e-3))),
        "hit_rate": round(float(hit.mean()), 4), "seed": seed, **where,
    }), flush=True)
    n_rays = tiles * tp.N_RAYS
    for name, fn, fargs in (("vpu_fori", tp.cuda_probe_fori, fori),
                            ("mxu_blocks", tp.cuda_probe_mma, mma)):
        ms = time_ms(fn, fargs, reps) if dev.type == "cuda" else None
        print(json.dumps({"name": name, "ms_per_trace": ms, "rays": n_rays,
                          "objects": objects, "seed": seed, **where}), flush=True)
    print(json.dumps({
        "name": "accuracy", "rays": n_rays, "objects": objects, "seed": seed,
        "mma_vs_float64": mma_err, "plain_vs_float64": plain_err,
        **where,
    }), flush=True)


def sass(directory: Path, where: dict) -> None:
    """``cuobjdump -sass`` of the library ``probe`` into ``directory``, and
    per kernel the count of each instruction kind that the probe's loops
    are made of."""
    directory.mkdir(parents=True, exist_ok=True)
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    kinds = ("FFMA", "FADD", "FMUL", "FSETP", "FSEL", "MUFU", "CALL", "VOTE", "BRA",
             "LDS", "HGMMA", "HMMA", "SHFL")
    name = "probe"
    build.build(name)
    text = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    (directory / f"lib{name}.sass").write_text(text)
    counts, kernel = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            kernel = m.group(1)
            counts[kernel] = dict.fromkeys(("instructions",) + kinds, 0)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", ln)
        if m and kernel:
            counts[kernel]["instructions"] += 1
            if m.group(1) in counts[kernel]:
                counts[kernel][m.group(1)] += 1
    print(json.dumps({"name": "sass", "library": name, "kernels": counts, **where}),
          flush=True)


if __name__ == "__main__":
    main()
