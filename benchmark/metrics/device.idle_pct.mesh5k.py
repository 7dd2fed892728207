"""Percent of the traced window's wall time in which no kernel or copy
runs on the card (``view.idle_pct()``): the triangle mesh's cells."""


def read(view):
    return view.idle_pct()
