"""The benchmark's metric arithmetic on synthetic spans and counts."""

from __future__ import annotations

import math

import pytest

from benchmark.harness import check
from benchmark.metrics import ops_table, stats, timeline


def test_percentile_is_nearest_rank_over_all_items():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None
    # 200 requests: the 95th percentile leaves ten beyond it
    ys = [float(i) for i in range(200)]
    p = stats.percentile(ys, 95)
    assert sum(1 for y in ys if y > p) == 10
    with pytest.raises(ValueError):
        stats.percentile(xs, 0)


def test_percentile_is_not_a_median_of_chunks():
    """A tail in one chunk shows: the percentile reads every item."""
    chunks = [[1.0] * 18 + [50.0] * 2, [1.0] * 20, [1.0] * 20, [1.0] * 20, [1.0] * 20]
    items = [x for c in chunks for x in c]
    assert stats.percentile(items, 99) == 50.0
    assert stats.median([stats.percentile(c, 99) for c in chunks]) == 1.0


def test_median():
    assert stats.median([3, 1, 2]) == 2
    assert stats.median([4, 1, 2, 3]) == 2.5
    assert stats.median([]) is None


def test_rate_runs_to_the_last_finished_item():
    # three images of 10 units each, the window starts at 1.0
    assert stats.rate([10, 10, 10], [2.0, 3.0, 4.0], 1.0) == pytest.approx(10.0)
    assert stats.rate([], [], 1.0) is None
    with pytest.raises(ValueError):
        stats.rate([1], [0.5], 1.0)


def test_busy_is_the_union_clipped_to_the_window():
    spans = [(1.0, 3.0), (2.0, 4.0), (6.0, 7.0), (9.5, 12.0)]
    assert timeline.merge(spans, 0.0, 10.0) == [(1.0, 4.0), (6.0, 7.0), (9.5, 10.0)]
    assert timeline.busy(spans, 0.0, 10.0) == pytest.approx(4.5)
    assert timeline.idle_pct(spans, 0.0, 10.0) == pytest.approx(55.0)


def test_idle_share_counts_the_host_only_ends():
    """The base is the window, not the span from the first device event
    to the last (which would read 0% idle here)."""
    spans = [(2.0, 8.0)]
    assert timeline.idle_pct(spans, 0.0, 10.0) == pytest.approx(40.0)
    first_to_last = 100.0 * (1.0 - timeline.busy(spans, 2.0, 8.0) / 6.0)
    assert first_to_last == pytest.approx(0.0)


def test_gaps_and_their_labels():
    spans = [(1.0, 2.0), (2.5, 3.0), (6.0, 9.0)]
    gaps = timeline.gaps(spans, 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (2.0, 2.5), (3.0, 6.0), (9.0, 10.0)]
    host = [("render", 0.0, 5.5), ("reset", 5.5, 6.5), ("chunk", 2.9, 5.0)]
    rows = timeline.label_gaps(gaps, host, 0.0, top=2)
    assert rows[0] == ["chunk@3.000000s", pytest.approx(3.0)]
    assert rows[1][0] in ("render@0.000000s", "harness@9.000000s")
    assert len(timeline.label_gaps(gaps, host, 0.0)) == 4


def test_op_table_frozen_values():
    """The frozen table's counts for a 7-box dense scene and a clustered
    field (numbers of the table as copied, so a change to the copy shows)."""
    class Cfg:
        n_samples, n_lights, width, height, max_bounces = 32, 1, 512, 512, 30

    dense = ops_table.kernel_ops(Cfg, (0, 0, 0, 0, 0, 2, 2), 3)
    assert dense.trace == 5 * 91 + 2 * 149 + 20 + 6 * 3
    assert dense.shadow == 5 * 34 + 2 * 67 + 37 + 7
    assert dense.shading == (2 + 6 + 5) * 32 + 3
    assert dense.per_lane_bounce == (dense.trace + dense.shadow + dense.shading
                                     + dense.continuation + dense.fixed)
    runs = ((0, 0, 1, False), (1, 1, 65, True), (1, 65, 129, True))
    half = ops_table.kernel_ops(Cfg, (0,) + (1,) * 128, 4, clusters=((), runs),
                                visited_fraction=0.5, visited_fraction_shadow=0.25)
    assert half.trace == 91 + 2 * (34 + 64 * 44 * 0.5) + 20 + 24
    assert half.shadow == 34 + 2 * (34 + 64 * 36 * 0.25) + 37 + 7


def test_bound_names_its_term():
    ms, term = ops_table.bound_ms(67e12, 1.0)
    assert term == "operations" and ms == pytest.approx(1e3)
    ms, term = ops_table.bound_ms(1.0, 3.35e12)
    assert term == "bytes" and ms == pytest.approx(1e3)


def test_pixel_gap():
    ref = [[1.0, 0.5, 0.25, 1.0], [0.0, 0.0, 0.0, 1.0]]
    assert check.pixel_gap(ref, ref) == 0.0
    got = [[1.0, 0.5, 0.25 + 1e-3, 1.0], [0.0, 0.0, 0.0, 1.0]]
    assert check.pixel_gap(got, ref) == pytest.approx(1e-3)
    assert math.isinf(check.pixel_gap([], []))
    assert math.isinf(check.pixel_gap([[math.nan] * 4] * 2, ref))
    px, py = check.pixel_grid(64, 48, 16, 5)
    assert px.size == 12 and (px % 16 == px[0] % 16).all() and (py % 16 == py[0] % 16).all()
    assert not all((check.pixel_grid(64, 48, 16, s)[0] == px).all() for s in range(6, 12))
