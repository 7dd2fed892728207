"""Persist launches per image: the mean of ``Renderer.persist_info
["launches"]``, the program's own counter, over the window's images."""


def read(view):
    counts = [im[3] for im in view.driver.images if im[3] is not None]
    return sum(counts) / len(counts) if counts else None
