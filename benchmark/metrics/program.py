"""The program's own spans and counts (``spectral_tpu_torch.runtime.trace``)
on the traced window's clock.

The program keeps its rows on ``time.perf_counter()``, the clock of the
benchmark's own spans. The window's row ``("window", t0, t1)`` in
``view.driver.spans.rows`` and ``view.lo``/``view.hi`` are one span on
the two clocks, so ``view.lo - t0`` moves a row onto the profiler's. A
program without the tracer, or one that kept no row in the window, gives
None, and each reader then returns None.
"""

from __future__ import annotations

from benchmark.metrics import stats, timeline


def rows(view):
    """``(spans, counts)``: the program's spans that lie inside the window
    and its counts taken in it, their times on the profiler's clock; None
    where the program keeps no rows there."""
    try:
        from spectral_tpu_torch.runtime import trace
    except ImportError:  # a program without the tracer
        return None
    window = [(s, e) for n, s, e in view.driver.spans.rows if n == "window"]
    if not window:
        return None
    shift = view.lo - window[-1][0]
    spans, counts = [], []
    for r in trace.rows():
        if hasattr(r, "end"):
            r = r._replace(start=r.start + shift, end=r.end + shift)
            if view.lo <= r.start and r.end <= view.hi:
                spans.append(r)
        else:
            r = r._replace(time=r.time + shift)
            if view.lo <= r.time <= view.hi:
                counts.append(r)
    if not spans and not counts:
        return None
    return spans, counts


def median_ms(view, name: str) -> float | None:
    """The median of the window's spans ``name``, in ms."""
    got = rows(view)
    if got is None:
        return None
    ms = stats.median([r.end - r.start for r in got[0] if r.name == name])
    return None if ms is None else 1e3 * ms


def overlap(a, b) -> float:
    """The time two lists of sorted disjoint intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_in_program_pct(view) -> float | None:
    """Percent of the window in which the card runs no kernel or copy and
    the host is inside an outermost program span other than ``gc``: the
    union of those spans, so nested spans count once. The same base as
    ``device.idle_pct.*``: the difference is the idle time outside the
    program (the benchmark's own work, the collector between calls)."""
    if not view.device_spans:
        return None
    got = rows(view)
    if got is None:
        return None
    outer = [(r.start, r.end) for r in got[0] if r.parent is None and r.name != "gc"]
    idle = timeline.gaps([(s, e) for _n, s, e in view.device_spans], view.lo, view.hi)
    busy_host = timeline.merge(outer, view.lo, view.hi)
    return 100.0 * overlap(idle, busy_host) / view.window_s
