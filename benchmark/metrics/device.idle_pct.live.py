"""Percent of the traced window's wall time in which no kernel or copy
runs on the card: the union of the profiler's device spans over the
window (not over the first-to-last device event). The live cell."""


def read(view):
    return view.idle_pct()
