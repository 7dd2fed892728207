"""The summaries of ``tools/lane_stats.py`` on synthetic counter buffers
(the per-thread record its stats builds write on the card): the lane
loop's SIMT efficiency, the waves, the blocks seen at once on one SM,
the slot time held and the tail, and the walk's clusters and the share
of packed sphere member tests that ran their root stage, and the packed
triangle runs' cooperative share and SIMT efficiency over lane slots,
each against its value worked out by hand or counted directly."""

import numpy as np
import pytest
import torch

from spectral_tpu_torch.tools import lane_stats


def _buffers(iters, t0, t1, smid, pixels=None, walk=None):
    n = len(iters)
    walk = np.zeros((lane_stats.WALK_STATS, n)) if walk is None else walk
    return dict(iters=torch.tensor(iters, dtype=torch.int32),
                pixels=torch.tensor(pixels if pixels is not None else [1] * n,
                                    dtype=torch.int32),
                t0=torch.tensor(t0, dtype=torch.int64), t1=torch.tensor(t1, dtype=torch.int64),
                smid=torch.tensor(smid, dtype=torch.int32),
                walk=torch.tensor(np.asarray(walk).reshape(-1), dtype=torch.int32))


def test_summaries_of_four_blocks_on_two_sms():
    """Four blocks of 128 threads, two slots: blocks 0 and 1 on SM 0 at
    once ([0, 100) and [0, 50) ns), block 2 on SM 1 ([0, 100)), block 3
    on SM 0 after block 1 ([50, 200)). Every thread runs 10 iterations
    but one thread per warp, which runs 20; block 3's threads run none."""
    iters = np.full(512, 10)
    iters[::32] = 20
    iters[384:] = 0
    span = {0: (0, 100), 1: (0, 50), 2: (0, 100), 3: (50, 200)}
    t0 = np.repeat([span[b][0] for b in range(4)], 128)
    t1 = np.repeat([span[b][1] for b in range(4)], 128)
    got = lane_stats.summarize(_buffers(iters, t0, t1, [0, 0, 1, 0]), 512, slots=2,
                               n_culled=0)
    loop, blocks = got["lane_loop"], got["blocks"]
    live = 12 * 31 * 10 + 12 * 20  # 12 warps with work, each 31 x 10 + 20
    assert loop["live_iterations"] == live
    assert loop["simt_efficiency_warp"] == pytest.approx(live / (32 * 20 * 12))
    assert loop["simt_efficiency_block"] == pytest.approx(live / (128 * 20 * 3))
    assert loop["threads_live"] == 384
    assert blocks["grid_blocks"] == 4 and blocks["waves"] == 2.0
    assert blocks["blocks_per_sm_seen"] == 2  # SM 0: blocks 0 and 1 at once
    assert blocks["sms_seen"] == 2
    assert blocks["makespan_ms"] == pytest.approx(200 / 1e6)
    # held: 100 + 50 + 100 + 150 ns of 2 slots x 200 ns
    assert blocks["slot_time_held"] == pytest.approx(400 / 400)
    assert blocks["block_ms_min"] == pytest.approx(50 / 1e6)
    assert blocks["block_ms_max"] == pytest.approx(150 / 1e6)
    # running blocks fall below 90% of 2 slots (to 1) at t = 100
    assert blocks["tail_share"] == pytest.approx(0.5, abs=1e-3)
    assert "walk_nearest" not in got


def test_a_resident_grid_of_fewer_threads_than_lanes():
    """A resident grid launches fewer threads than the buffers hold (the
    lanes): the threads that never wrote are not counted, and a thread
    that took three lanes reports them."""
    n, ran = 1024, 256
    iters = np.zeros(n, np.int64)
    iters[:ran] = 30
    t0 = np.zeros(n, np.int64)
    t1 = np.zeros(n, np.int64)
    t1[:ran] = 1000
    pixels = np.zeros(n, np.int64)
    pixels[:ran] = 3
    smid = np.arange(n // 128)
    got = lane_stats.summarize(_buffers(iters, t0, t1, smid, pixels), n, slots=2, n_culled=0)
    assert got["blocks"]["grid_blocks"] == 2 and got["blocks"]["waves"] == 1.0
    assert got["lane_loop"]["simt_efficiency_warp"] == 1.0
    assert got["lane_loop"]["pixels_per_thread_max"] == 3
    assert got["blocks"]["blocks_per_sm_seen"] == 1 and got["blocks"]["slot_time_held"] == 1.0


def test_blocks_back_to_back_on_one_sm_are_not_at_once():
    sm = np.array([5, 5, 5])
    start = np.array([0, 10, 20])
    end = np.array([10, 20, 30])
    assert lane_stats._most_at_once(sm, start, end) == 1
    assert lane_stats._most_at_once(sm, np.array([0, 5, 9]), end) == 3


def test_walk_summaries_and_the_root_stage_share():
    """One block of four warps, each thread one nearest trace and one
    shadow ray over a plan of 4 clusters. Each warp runs 50 packed sphere
    member tests per kind with a random set of active lanes, each lane
    with its discriminant (some exactly 0: a tangent lane has a root).
    The stats build counts a test once a warp, in its lowest active
    lane's slot, and counts its root stage where the vote finds a lane
    with disc >= 0; the share is the direct count of such tests."""
    rng = np.random.default_rng(20)
    n, warps, tests, clusters = 128, 4, 50, 4
    walk = np.zeros((lane_stats.WALK_STATS, n), np.int64)
    want = {}
    for name, base in (("nearest", 0), ("shadow", lane_stats.WALK_SHADOW)):
        disc = np.round(rng.normal(-6.0, 3.0, size=(warps, tests, 32)))  # many exact zeros
        active = rng.random((warps, tests, 32)) < 0.5
        active[:, :, 31] = True
        need = rng.integers(0, clusters + 1, size=n)
        walk[base + 0] = 1  # traces
        walk[base + 1] = need  # culled runs each lane needs
        walk[base + 2] = clusters  # its warp visits all of them
        walk[base + 3] = need * 64
        walk[base + 4] = clusters * 64
        for w in range(warps):
            for k in range(tests):
                lanes = np.nonzero(active[w, k])[0]
                leader = 32 * w + lanes[0]
                walk[base + 5, leader] += 1
                walk[base + 6, leader] += int(any(disc[w, k, j] >= 0.0 for j in lanes))
        rooted = ((disc >= 0.0) & active).any(axis=2)
        want[name] = (float(rooted.sum()), float(rooted.mean()), need.sum() / (n * clusters))
    assert 0.05 < want["nearest"][1] < 0.95 and 0.05 < want["shadow"][1] < 0.95
    got = lane_stats.summarize(
        _buffers(np.full(n, 8), np.zeros(n, np.int64), np.full(n, 100), [0], walk=walk),
        n, slots=1, n_culled=clusters)
    for name, (roots, share, visited) in want.items():
        w = got[f"walk_{name}"]
        assert w["traces"] == n
        assert w["warp_sphere_tests"] == warps * tests
        assert w["warp_root_stages"] == roots
        assert w["root_stage_share"] == pytest.approx(share)
        assert w["visited_fraction"] == pytest.approx(visited)
        assert w["warp_visited_fraction"] == 1.0
        assert w["simt_efficiency"] == pytest.approx(visited)


def _triangle_pass(walk, base, warp, lanes, need, size, coop):
    """Count one warp's pass over a packed triangle run as the stats build
    does (``bounce.cuh:walk_run``, ``walk_tri``): the visit once a warp in
    its lowest lane's slot; per lane on the run its need and the lane slots
    the warp spends, ``size`` per lane in the per-lane loop, the needing
    lanes times ceil(size / lanes) in the cooperative pass."""
    n, k = len(lanes), len(need)
    slots = k * -(-size // n) if coop else size
    walk[base + (7 if coop else 8), 32 * warp + min(lanes)] += 1
    for lane in lanes:
        t = 32 * warp + lane
        walk[base + 3, t] += size if lane in need else 0
        walk[base + 9, t] += size if lane in need else 0
        walk[base + (10 if coop else 11), t] += slots
        walk[base + 4, t] += slots


def _walk_of(passes, n=128):
    walk = np.zeros((lane_stats.WALK_STATS, n), np.int64)
    for base in (0, lane_stats.WALK_SHADOW):
        walk[base + 0] = 1  # one trace a thread
        for p in passes:
            _triangle_pass(walk, base, *p)
    return walk


def _summarize_walk(walk, n=128):
    return lane_stats.summarize(
        _buffers(np.full(n, 8), np.zeros(n, np.int64), np.full(n, 100), [0], walk=walk),
        n, slots=1, n_culled=100)


def test_coop_share_and_the_slot_based_simt_efficiency():
    """Warp 0 takes three runs of 64 members with all 32 lanes on them:
    one per lane (20 lanes need it: 32 x 64 = 2048 slots), two
    cooperatively (2 and 5 needing lanes: 2 x 2 x 32 = 128 and 5 x 2 x 32
    = 320 slots); warp 1 one run of 40 members cooperatively with 10 lanes
    on it, 3 needing (3 x 4 x 10 = 120 slots). Needed: (20 + 2 + 5) x 64 +
    3 x 40 = 1848 tests, of 2048 + 448 + 120 = 2616 slots, 568 of them in
    the pass; 3 of the 4 visits cooperative. Per trace: over 128 threads."""
    all32, ten = list(range(32)), list(range(4, 14))
    passes = [(0, all32, list(range(20)), 64, False),
              (0, all32, [3, 9], 64, True),
              (0, all32, [0, 1, 2, 30, 31], 64, True),
              (1, ten, [4, 8, 13], 40, True)]
    got = _summarize_walk(_walk_of(passes))
    for name in ("nearest", "shadow"):
        w = got[f"walk_{name}"]
        assert w["triangle_visits_coop"] == 3 and w["triangle_visits_per_lane"] == 1
        assert w["coop_share"] == pytest.approx(0.75)
        assert w["triangle_simt_efficiency"] == pytest.approx(1848 / 2616)
        assert w["simt_efficiency"] == pytest.approx(1848 / 2616)
        assert w["triangle_tests_needed_per_trace"] == pytest.approx(1848 / 128)
        assert w["triangle_slots_coop_per_trace"] == pytest.approx(568 / 128)
        assert w["triangle_slots_per_lane_per_trace"] == pytest.approx(2048 / 128)


def test_the_simt_efficiency_of_the_same_needs_before_and_after_the_pass():
    """The same needs as a parent build counts them (every visited run per
    lane: 3 x 32 x 64 + 10 x 40 = 6544 slots) and with the pass: the
    efficiency over slots rises from 1848 / 6544 to 1848 / 2616, and a
    build without the pass reads no triangle visits (coop share 0)."""
    all32, ten = list(range(32)), list(range(4, 14))
    needs = [(0, all32, list(range(20)), 64), (0, all32, [3, 9], 64),
             (0, all32, [0, 1, 2, 30, 31], 64), (1, ten, [4, 8, 13], 40)]
    walk = _walk_of([(*p, False) for p in needs])
    parent = walk.copy()
    for base in (0, lane_stats.WALK_SHADOW):
        parent[base + 7:base + 12] = 0  # a parent build has no triangle counts
    before = _summarize_walk(parent)["walk_nearest"]
    assert before["simt_efficiency"] == pytest.approx(1848 / 6544)
    assert before["coop_share"] == 0.0 and before["triangle_simt_efficiency"] == 0.0
    after = _summarize_walk(_walk_of([(*p, p[2] != list(range(20))) for p in needs]))
    assert after["walk_nearest"]["simt_efficiency"] == pytest.approx(1848 / 2616)
    assert _summarize_walk(walk)["walk_shadow"]["coop_share"] == 0.0
