"""Median over the window's edits of the span around building the
``Renderer`` from the edited scene, closed by ``torch.cuda.synchronize()``."""

from benchmark.metrics import stats


def read(view):
    ms = stats.median(view.driver.spans.durations("rebuild"))
    return None if ms is None else 1e3 * ms
