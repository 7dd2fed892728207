"""Median over the window's edits of the program's ``scene.flatten`` span:
the scene's host tables and their copies to the card, inside
``Renderer(...)``."""

from benchmark.metrics import program


def read(view):
    return program.median_ms(view, "scene.flatten")
