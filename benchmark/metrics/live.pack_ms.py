"""Median over the window's edits of the program's ``scene.pack`` span:
the kernels' tables (``pack_tables``) inside ``Renderer(...)``."""

from benchmark.metrics import program


def read(view):
    return program.median_ms(view, "scene.pack")
