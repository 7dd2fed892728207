"""Median over the window's edits of the program's ``launch.regen`` span:
the regeneration launch's host arguments and its enqueue, the host time
before the card can start the chunk."""

from benchmark.metrics import program


def read(view):
    return program.median_ms(view, "launch.regen")
