"""Median over the window's edits of the span around the first
``render_frames(16)``, which ends in ``framebuffer()``'s copy to the host."""

from benchmark.metrics import stats


def read(view):
    ms = stats.median(view.driver.spans.durations("chunk"))
    return None if ms is None else 1e3 * ms
