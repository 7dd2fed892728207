"""``cuda_regen``'s share of its roofline in the small-object
regeneration cells (``work.regen_roofline_pct``)."""

from benchmark.metrics import work


def read(view):
    return work.regen_roofline_pct(view, "regen.roofline_pct")
