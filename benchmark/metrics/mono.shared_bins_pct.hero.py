"""The share of the window's ``cuda_mono`` launches that took the build
with the lanes' radiance bins in shared memory: the program's
``launch.mono_shared_bins`` counts over its ``launch.mono`` counts, in
percent. In the hero frame's cell every mono launch is a tail frame at
S = 64. None where the program counts no mono launch."""

from benchmark.metrics import program


def read(view):
    got = program.rows(view)
    if got is None:
        return None
    total = {}
    for c in got[1]:
        total[c.name] = total.get(c.name, 0) + c.value
    mono = total.get("launch.mono", 0)
    if not mono:
        return None
    return 100.0 * total.get("launch.mono_shared_bins", 0) / mono
