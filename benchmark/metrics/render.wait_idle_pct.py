"""Percent of the traced window in which the card idles behind the
render's own waits. Each ``wait.*`` span inside a ``render.frames`` span
opens an interval at its start, which runs to the start of the next
bounce kernel on the card or to the end of that ``render.frames``,
whichever comes first: a wait drains the stream, and the host work after
it runs while the card idles until the next bounce launch reaches it.
The metric is the card's idle time inside the union of those intervals.
None without device spans, or where the program keeps no ``wait.*``
span."""

import bisect

from benchmark.metrics import program, timeline, waits


def read(view):
    if not view.device_spans:
        return None
    got = waits.spans(view)
    if got is None:
        return None
    frames = [(r.start, r.end) for r in got if r.name == "render.frames"]
    kernels = sorted(s for n, s, _e in view.device_spans
                     if any(k in n for k in waits.BOUNCE_KERNELS))
    intervals = []
    for w in got:
        if not w.name.startswith("wait."):
            continue
        outer = [end for start, end in frames if start <= w.start and w.end <= end]
        if not outer:
            continue
        i = bisect.bisect_right(kernels, w.start)
        stop = min(outer[0], kernels[i]) if i < len(kernels) else outer[0]
        intervals.append((w.start, stop))
    if not intervals:
        return None
    idle = timeline.gaps([(s, e) for _n, s, e in view.device_spans], view.lo, view.hi)
    return 100.0 * program.overlap(idle, timeline.merge(intervals, view.lo, view.hi)) / view.window_s
