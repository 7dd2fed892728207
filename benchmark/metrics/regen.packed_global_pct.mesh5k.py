"""The share of the window's triangle ``cuda_regen`` launches whose
many-object walk streamed its packed records from global memory, as they
outgrow the block's shared memory: the program's
``launch.regen_packed_global`` counts over its ``launch.regen_triangles``
counts, in percent. None where the program counts no triangle launch (a
program without that count)."""

from benchmark.metrics import program


def read(view):
    got = program.rows(view)
    if got is None:
        return None
    total = {}
    for c in got[1]:
        total[c.name] = total.get(c.name, 0) + c.value
    triangles = total.get("launch.regen_triangles", 0)
    if not triangles:
        return None
    return 100.0 * total.get("launch.regen_packed_global", 0) / triangles
