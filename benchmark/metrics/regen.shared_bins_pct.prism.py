"""The share of the window's feature-build ``cuda_regen`` launches that
took the build with the lanes' radiance bins in shared memory: the
program's ``launch.regen_shared_bins`` counts over its
``launch.regen_features`` counts, in percent. In the prism's cells every
launch is a feature build at S = 64. None where the program counts no
feature launch (a program without that count)."""

from benchmark.metrics import program


def read(view):
    got = program.rows(view)
    if got is None:
        return None
    total = {}
    for c in got[1]:
        total[c.name] = total.get(c.name, 0) + c.value
    features = total.get("launch.regen_features", 0)
    if not features:
        return None
    return 100.0 * total.get("launch.regen_shared_bins", 0) / features
