"""One run of one cell: load its files by name, set up, measure a window,
check the window's output against the plain reference, print one line.

``BENCHMARK.json`` is the manifest. A cell's files are found by name:
``benchmark/workloads/<cell>.json`` (configuration, traffic mix, chips,
the limits of its comparison), the configuration's ``file`` (scene and
sizes), ``benchmark/traffic/<mix>.json`` (the mix's parameters and the
driver that reads them), ``benchmark/drivers/<driver>.py`` and, for each
per-layer metric, ``benchmark/metrics/<metric>.py``, whose ``read(view)``
returns the metric or None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

from benchmark.metrics import timeline

FORBIDDEN = ("jax", "jaxlib", "flax", "spectral_tpu")
BENCH_DIR = "benchmark"


class SetupError(RuntimeError):
    """The cell cannot run here: no card, too few cards, a missing file."""


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    if not path.is_file():
        raise SetupError(f"missing file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module of its own."""
    if not path.is_file():
        raise SetupError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of the manifest at ``root``, with its files."""
    manifest = _json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SetupError(f"no cell {name!r} in BENCHMARK.json")
    workload = _json(root / BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SetupError(f"{name}: {key} differs between BENCHMARK.json and its file")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    config = _json(root / cfg_entry["file"])
    traffic = _json(root / BENCH_DIR / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, workload, config, traffic, e2e, per_layer)


class Spans:
    """Host spans around the calls the window makes into the program:
    ``(name, start, end)`` on the host's monotonic clock, and with a
    profiler running a ``record_function("bench.<name>")`` each, so the
    trace can label what the host was doing."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.rows: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.traced:
            import torch

            ctx = torch.profiler.record_function(f"bench.{name}")
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.rows.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> list[float]:
        return [e - s for n, s, e in self.rows if n == name]


def require_cards(chips: int) -> None:
    """Refuse to run without ``chips`` CUDA cards: never a CPU fallback."""
    import torch

    if not torch.cuda.is_available():
        raise SetupError("torch.cuda.is_available() is False: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise SetupError(f"the cell needs {chips} cards, {torch.cuda.device_count()} visible")


def power_limit_w() -> float | None:
    """The card's power limit from nvidia-smi (None where it cannot say)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def synchronize(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the traced window ``[lo, hi]`` (s),
    the device's spans ``(kernel name, start, end)`` in it, the host spans
    on the same clock, the driver (its records and the program's counters)
    and the work its reference counted."""

    cell: Cell
    lo: float
    hi: float
    device_spans: list
    host_spans: list
    driver: object
    work: object

    def kernel_seconds(self, *names: str) -> float:
        """Summed device time of the kernels whose name holds any of ``names``."""
        return sum(e - s for n, s, e in self.device_spans if any(k in n for k in names))

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return timeline.busy([(s, e) for _n, s, e in self.device_spans], self.lo, self.hi)

    def idle_pct(self) -> float | None:
        """Percent of the window with no kernel or copy on the card; None
        without device spans (a run on the CPU)."""
        if not self.device_spans:
            return None
        return timeline.idle_pct([(s, e) for _n, s, e in self.device_spans], self.lo, self.hi)


def _profiler_view(prof, cell, driver, work) -> TraceView:
    """The profiler's events as a ``TraceView`` (seconds on its clock)."""
    import torch

    dev_spans, host_spans, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if e.name.startswith("bench."):
            # the spans' annotations appear on the card's timeline too: no work
            if on_card:
                continue
            if e.name == "bench.window":
                window = (s, t)
            else:
                host_spans.append((e.name[len("bench."):], s, t))
        elif on_card:
            dev_spans.append((e.name, s, t))
    if window is None:
        raise RuntimeError("the trace lost the window's span")
    lo, hi = window
    dev_spans = [(n, max(s, lo), min(t, hi)) for n, s, t in dev_spans if t > lo and s < hi]
    return TraceView(cell, lo, hi, dev_spans, host_spans, driver, work)


def breakdown(view: TraceView) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps labelled with the host span they fell in."""
    per_kernel: dict[str, float] = {}
    for n, s, e in view.device_spans:
        per_kernel[n] = per_kernel.get(n, 0.0) + (e - s)
    ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    gaps = timeline.gaps([(s, e) for _n, s, e in view.device_spans], view.lo, view.hi)
    return {"device_ops": [[n, t] for n, t in ops],
            "idle_gaps": timeline.label_gaps(gaps, view.host_spans, view.lo)}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(root: Path, name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             driver_hook=None) -> dict:
    """Run cell ``name`` once and return the result line's object.
    ``device="cpu"`` skips the look for a card (the tests' tiny cells);
    ``driver_hook(driver)``, when given, is called after set-up (the tests
    break the timed path there)."""
    t_start = time.monotonic() if t_start is None else t_start
    cell = load_cell(root, name)
    chips = int(cell.workload["chips"])
    if device == "cuda":
        require_cards(chips)
    import torch

    drv_mod = load_module(root / BENCH_DIR / "drivers" / f"{cell.traffic['driver']}.py",
                          f"bench_driver_{cell.traffic['driver']}".replace(".", "_"))
    spans = Spans(traced)
    driver = drv_mod.Driver(cell, seed, device, spans)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_card = time.monotonic()
    driver.setup()
    synchronize(device)
    print(f"setup: {t_card - t_start:.3f} s to the card, {time.monotonic() - t_card:.3f} s "
          "the driver's set-up (the Renderer, one warm-up image or edit)", file=sys.stderr)
    spans.rows.clear()  # the window's spans only
    if driver_hook is not None:
        driver_hook(driver)
    setup_s = time.monotonic() - t_start

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    try:
        with spans("window"):
            driver.run(seconds)
            synchronize(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    summary = driver.summary()
    driver.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    compared, work = driver.check(count=traced)
    correct = summary["failed"] == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in compared.values())

    metrics = {}
    if traced:
        view = _profiler_view(prof, cell, driver, work)
        for m in cell.per_layer:
            reader = load_module(root / BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 f"bench_metric_{m['name']}".replace(".", "_"))
            value = reader.read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = dict(summary["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": chips if device == "cuda" else 0,
           "memory_peak_bytes": int(memory_peak),
           "power_limit_w": power_limit_w() if device == "cuda" else None}
    out = {"correct": bool(correct), "attempted": int(summary["attempted"]),
           "failed": int(summary["failed"]), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        out["breakdown"] = breakdown(view)
    out["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return out


def main(argv=None, root: Path | None = None, t_start: float | None = None) -> int:
    """The command line of ``benchmark/run.py``; ``t_start`` is the
    process's start on the monotonic clock, where ``setup_s`` begins."""
    import argparse

    t_start = time.monotonic() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = root or Path(__file__).resolve().parents[2]
    try:
        out = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=t_start)
    except SetupError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 -- report any failure of the run, print no result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, row in out["check"].items():
        print(f"check {k} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
