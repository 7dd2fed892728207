"""Rates and percentiles over every request of a window.

A rate is the work of every item finished in the window over the time
from the window's start to the end of its last finished item; a
percentile is taken over all items, never over medians of chunks.
"""

from __future__ import annotations

import math


def percentile(values, q: float) -> float | None:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it. None
    for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    if not 0.0 < q <= 100.0:
        raise ValueError(f"percentile {q} outside (0, 100]")
    rank = math.ceil(q / 100.0 * len(xs))
    return xs[max(rank, 1) - 1]


def median(values) -> float | None:
    """The median (the mean of the two middle values for an even count)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def rate(work, ends, start: float) -> float | None:
    """Work per second: the sum of ``work`` over every finished item, over
    the time from ``start`` to the latest of their ``ends``. None when
    nothing finished."""
    work = [float(w) for w in work]
    ends = [float(e) for e in ends]
    if len(work) != len(ends):
        raise ValueError("one end per item")
    if not ends:
        return None
    span = max(ends) - start
    if span <= 0.0:
        raise ValueError("the last item ends before the window starts")
    return sum(work) / span
