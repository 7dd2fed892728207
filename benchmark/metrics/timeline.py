"""Busy time, idle share and idle gaps of a traced window.

The busy time is the union of the device's spans (kernels and copies)
clipped to the window; the idle share divides what is left by the
window's wall time, not by the span from the first device event to the
last, so the host-only stretches at either end count as idle.
"""

from __future__ import annotations


def merge(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` spans clipped to ``[lo, hi]``, as
    sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(float(s), lo), min(float(e), hi)) for s, e in spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(spans, lo: float, hi: float) -> float:
    """Time in ``[lo, hi]`` covered by at least one span."""
    return sum(e - s for s, e in merge(spans, lo, hi))


def idle_pct(spans, lo: float, hi: float) -> float:
    """Percent of the window ``[lo, hi]`` in which no span runs."""
    if hi <= lo:
        raise ValueError("an empty window")
    return 100.0 * (1.0 - busy(spans, lo, hi) / (hi - lo))


def gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle intervals of ``[lo, hi]``: before the first span, between
    spans and after the last."""
    out = []
    cur = lo
    for s, e in merge(spans, lo, hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def label_gaps(gap_list, host_spans, origin: float, top: int = 10) -> list[list]:
    """The ``top`` longest gaps, longest first, each as ``[label,
    seconds]``: the label is the innermost host span (``(name, start,
    end)``) that covers the gap's midpoint ("harness" where the host was
    in none of them: the benchmark's own work between calls), with the
    gap's start in seconds from ``origin``."""
    rows = []
    for s, e in sorted(gap_list, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inner = None
        for name, hs, he in host_spans:
            if hs <= mid <= he and (inner is None or he - hs < inner[2] - inner[1]):
                inner = (name, hs, he)
        label = inner[0] if inner else "harness"
        rows.append([f"{label}@{s - origin:.6f}s", e - s])
    return rows
