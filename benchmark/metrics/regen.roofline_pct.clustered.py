"""``cuda_regen``'s share of its roofline in the clustered-walk
regeneration cells (``work.regen_roofline_pct``): its operations count
the members of the clusters each trace enters."""

from benchmark.metrics import work


def read(view):
    return work.regen_roofline_pct(view, "regen.roofline_pct.clustered")
