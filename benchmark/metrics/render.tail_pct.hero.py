"""Percent of the traced window that the host spends inside the program's
``render.tail`` spans: the frames of an image that follow its last full
regeneration launch, rendered one at a time on the mono kernel (the union
of the spans over the window). None where the program keeps no such span."""

from benchmark.metrics import program, timeline


def read(view):
    got = program.rows(view)
    if got is None:
        return None
    tail = [(r.start, r.end) for r in got[0] if r.name == "render.tail"]
    if not tail:
        return None
    return 100.0 * timeline.busy(tail, view.lo, view.hi) / view.window_s
