"""``cuda_regen``'s share of its roofline in the triangle mesh's cells
(``work.regen_roofline_pct``): its operations are the op table's
triangle, box and cluster pre-test costs at the members of the clusters
each trace enters, as the reference counted them."""

from benchmark.metrics import work


def read(view):
    return work.regen_roofline_pct(view, "regen.roofline_pct.mesh5k")
