"""The op table of the bounce kernels, frozen for the benchmark.

A copy of ``spectral_tpu_torch/utils/flops.py`` up to ``bound_ms`` (the
probe's terms left out): the per-lane-bounce op counts of the
regeneration, persist and mono kernels, counted from the reference
renderer's kernel bodies, within about 10%, and the H100's published
peaks. The benchmark keeps its own copy so that a change to the program
cannot move the yardstick; the work it multiplies (live lane-bounce
iterations, clusters entered) is counted by the benchmark's reference
(``benchmark/reference/paths.py``), never by the program.

Counting convention: every elementwise f32/u32 lane operation -- add,
sub, mul, div, sqrt, rsqrt, compare, select, min/max, and/or, int
mul/xor/shift -- counts as ONE op; a transcendental counts as one op
too. Peak: an H100 SXM runs 67e12 FP32 flop/s outside the tensor cores
(NVIDIA's data sheet, 700 W), counting a fused multiply-add as two, so
the bound is a floor: the kernels are built with -fmad=false.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM (data sheet, 700 W): FP32 outside the tensor cores,
# an FMA counted as two ops, and the HBM3 rate
H100_FP32_PEAK_OPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# --- per-member op counts in the fori/clustered nearest-hit loop
# (intersection + winner-accumulate per lane), counted from
# megakernel.trace_tile_fori bodies
NEAREST_MEMBER_OPS = {
    "sphere": 44,  # _sphere_t 30 + clustered accum 14
    "plain_box": 91,  # slab 32 + face normal 39 + ip 6 + accum 14
    "rotated_box": 149,  # rotate 30 + slab 32 + face-scan normal 64 + ...
    "triangle": 87,  # Moller-Trumbore 52 + Phong normal 21 + accum 14
}
# per-member, PER SHADOW RAY (one fused loop serves all lights)
SHADOW_MEMBER_OPS = {
    "sphere": 36,  # sqrt-free interval test + latch
    "plain_box": 34,
    "rotated_box": 67,
    "triangle": 54,
}
CLUSTER_PRETEST_OPS = 34  # slab 28 + relevance mask + tile reduction
SHADOW_CLUSTER_PRETEST_OPS = 34  # per light

_TYPE_NAME = {0: "plain_box", 1: "sphere", 2: "rotated_box", 3: "triangle"}


@dataclasses.dataclass(frozen=True)
class OpsBreakdown:
    trace: float  # nearest-hit object loop (incl. cluster pre-tests)
    shadow: float  # NEE occlusion object loop
    shading: float  # per-wavelength radiance/throughput math
    continuation: float  # cone/hemisphere/refract continuation rays
    fixed: float  # RNG, raygen, masks, bookkeeping
    per_lane_bounce: float  # total of the above
    per_frame: float  # n_lanes * bounces * per_lane_bounce + frame-fixed

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def kernel_ops(
    config,
    obj_types: tuple[int, ...],
    n_materials: int,
    clusters=None,
    has_transmission: bool = False,
    has_emission: bool = False,
    has_sky: bool = False,
    has_texture: bool = False,
    visited_fraction: float = 1.0,
    visited_fraction_shadow: float | None = None,
    bounce_iters: float | None = None,
) -> OpsBreakdown:
    """Executed VPU ops for ONE progressive frame of the regen/persist
    megakernel. ``clusters`` is the ``plan_clusters`` result (or None for
    the dense loop); ``visited_fraction`` scales clustered member loops
    (1.0 = every cluster visited every bounce = dense upper bound).
    ``visited_fraction_shadow`` scales the NEE occlusion member loops
    separately (the shadow walk's segment culling + blocked-latch dropout
    visit far fewer clusters than the nearest-hit walk — measured by
    the reference's tools/visit_replay.py); defaults to ``visited_fraction``.

    ``bounce_iters`` overrides the per-frame executed iteration count:
    the monolithic kernel executes exactly ``max_bounces`` iterations per
    frame, but the regeneration/persist kernels skip iterations once a
    tile's lanes are all done — their executed count per frame lies in
    [sum of per-bounce live fractions, max_bounces] (straggler lanes keep
    whole tiles running). Pass the occupancy sum for the zero-straggler
    lower bound."""
    s = config.n_samples
    if visited_fraction_shadow is None:
        visited_fraction_shadow = visited_fraction
    n_lights = max(config.n_lights, 1)
    n_lanes = config.width * config.height
    bounces = config.max_bounces if bounce_iters is None else bounce_iters

    counts = {k: 0 for k in _TYPE_NAME.values()}
    for t in obj_types:
        counts[_TYPE_NAME[int(t)]] += 1

    # --- nearest trace per lane-bounce
    trace = 0.0
    if clusters is not None:
        _sigma, runs = clusters
        typed = [_TYPE_NAME[int(tag)] for tag, _s, _e, _c in runs]
        for (tag, start, stop, is_cl), tname in zip(runs, typed):
            members = (stop - start) * NEAREST_MEMBER_OPS[tname]
            if is_cl:
                trace += CLUSTER_PRETEST_OPS + members * visited_fraction
            else:
                trace += members
    else:
        for tname, c in counts.items():
            trace += c * NEAREST_MEMBER_OPS[tname]
    # post-loop winner resolution: sphere-normal derivation + material
    # scalar selects over the material table
    trace += 20 + 6 * n_materials

    # --- NEE shadow loop per lane-bounce (all lights share one loop)
    shadow = 0.0
    if clusters is not None:
        _sigma, runs = clusters
        for (tag, start, stop, is_cl) in runs:
            tname = _TYPE_NAME[int(tag)]
            members = (
                (stop - start) * SHADOW_MEMBER_OPS[tname] * n_lights
            )
            if is_cl:
                shadow += (
                    SHADOW_CLUSTER_PRETEST_OPS * n_lights
                    + members * visited_fraction_shadow
                )
            else:
                shadow += members
    else:
        for tname, c in counts.items():
            shadow += c * SHADOW_MEMBER_OPS[tname] * n_lights
    # per-light setup (direction/dist/normalize) + scale (renorm/cosines)
    shadow += n_lights * (18 + 19) + 7

    # --- per-wavelength shading: direct fold, albedo select, throughput
    per_s = 2 * n_lights + 2 * n_materials + 5
    if has_sky:
        per_s += 3
    if has_emission:
        per_s += 3 + 2 * n_materials
    if has_transmission:
        per_s += 4  # hero-collapse pick
    shading = per_s * s + n_materials  # + mat-mask precompute per bounce

    # --- continuation rays: specular cone + diffuse hemisphere ( +
    # dielectric branch), direction/origin selects, final normalize
    continuation = 95 + 75 + 20
    if has_transmission:
        continuation += 60  # Snell/Fresnel/TIR + extra selects
    if has_texture:
        continuation += 14  # checker factor (floors + parity)

    # --- fixed per lane-bounce: PCG3D, gate/alive/cont logic, hit point,
    # offsets, cos_out, regen restart raygen (Hammersley bits + basis FMAs)
    fixed = 45 + 15 + 6 + 6 + 7 + 70

    per_lane_bounce = trace + shadow + shading + continuation + fixed
    # frame-fixed: per-s RGB fold + progressive blend
    per_frame = n_lanes * (bounces * per_lane_bounce + 6 * s + 10)
    return OpsBreakdown(
        trace=trace,
        shadow=shadow,
        shading=shading,
        continuation=continuation,
        fixed=fixed,
        per_lane_bounce=per_lane_bounce,
        per_frame=per_frame,
    )


def bound_ms(ops: float, n_bytes: float) -> tuple[float, str]:
    """The least time (ms) the H100 could take for ``ops`` operations on
    ``n_bytes`` bytes moved once, and which of the two bounds it:
    ``(ms, "operations" | "bytes")``."""
    t_ops = ops / H100_FP32_PEAK_OPS
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S
    if t_ops >= t_bytes:
        return 1e3 * t_ops, "operations"
    return 1e3 * t_bytes, "bytes"
