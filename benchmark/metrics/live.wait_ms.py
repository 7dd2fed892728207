"""Median over the window's edits of the host's time in the program's
``wait.*`` spans of the edit (the spans grouped by their ``request``, the
edit's Renderer): the blocking copies of the scene's tables to the card,
the blend's scalars and the preview's copy to the host. Spans of no
Renderer (``scene.parse`` runs before it exists) are left out. None where
the program keeps no ``wait.*`` span, and without device spans (a run on
the CPU, where no call blocks on a card)."""

from benchmark.metrics import stats, waits


def read(view):
    if not view.device_spans:
        return None
    got = waits.waits(view)
    if got is None:
        return None
    per_edit = {}
    for r in got:
        if r.request is not None:
            per_edit[r.request] = per_edit.get(r.request, 0.0) + (r.end - r.start)
    ms = stats.median(per_edit.values())
    return None if ms is None else 1e3 * ms
