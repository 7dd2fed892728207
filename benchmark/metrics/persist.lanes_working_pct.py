"""Mean over the window's persist launches of the program's
``persist.lanes_working`` count (the lanes that still owe frames as the
launch starts) over the image's lanes, times 100."""

from benchmark.metrics import program


def read(view):
    got = program.rows(view)
    if got is None:
        return None
    lanes = int(view.cell.config["width"]) * int(view.cell.config["height"])
    values = [r.value for r in got[1] if r.name == "persist.lanes_working"]
    return 100.0 * sum(values) / (len(values) * lanes) if values else None
