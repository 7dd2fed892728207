"""Analytic op accounting for the bounce and probe kernels (roofline bounds).

The port's copy of the JAX package's ``spectral_tpu.utils.flops``: the
per-lane-bounce op counts of the megakernel (``kernel_ops``), counted
from the reference's Pallas kernel bodies, with the H100's FP32 peak in
place of the v5e VPU peak. The port's kernels (``ops/csrc``) run the
same per-lane arithmetic, one thread per lane, so the counts carry over
to within their stated ~10%.

Counting convention (the reference's): every elementwise f32/u32 lane
operation -- add, sub, mul, div, sqrt, rsqrt, compare, select, min/max,
and/or, int mul/xor/shift -- counts as ONE op; a transcendental counts
as one op too.

Peak: an H100 SXM runs 67e12 FP32 flop/s outside the tensor cores
(NVIDIA's data sheet, 700 W), counting a fused multiply-add as two --
the same convention as the reference's FMA-fused v5e figure, so the
bound is a conservative floor: the kernels are built with -fmad=false
and integer, compare and select ops do not fuse.

``bound_ms`` is the least time the card could take for a launch: the
larger of its bytes over the HBM rate (3.35 TB/s) and its operations
over the FP32 peak.
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


# --- the trace probe (ops/trace_probe.py), counted for what a launch's
# inputs need, per ray-sphere pair. Every pair needs its test:
# - kernel A (cuda_probe_fori): the offsets o - c (3), b = 2 dot3(d, r)
#   (6: a dot3 is a multiply and two FMAs, 5 ops), c = dot3(r, r) - r^2
#   (6), disc = fma(b, b, -(4a c)) (4) and the test disc > 0 (1): 20;
# - kernel B (cuda_probe_mma): from its two products, b = 2 (d.o - d.c)
#   (2), c = o.o - 2 o.c + cc (3), disc (4) and the test (1): 10.
# The root stage only for the pairs with disc > 0
# (trace_probe.fori_root_pairs / mma_root_pairs count them): the square
# root's argument and the root (2), the two roots (5), the pick (2), t > 0
# and the validity select (3), the running minimum (3): 15.
# Kernel B's d.c and o.c are 3xTF32 tensor-core products over the 3
# components the rays and centres carry (its inputs pad them to 8 with
# zeros, which the count leaves out): 3 products x 2 dot products x 3
# multiply-adds x 2 flops, at the H100's dense TF32 tensor rate (NVIDIA's
# data sheet, 700 W).
PROBE_TEST_OPS = {"fori": 20, "mma": 10}
PROBE_ROOT_OPS = 15
PROBE_DOT_COMPONENTS = 3
PROBE_MMA_TENSOR_FLOPS = 3 * 2 * PROBE_DOT_COMPONENTS * 2
H100_TF32_TENSOR_FLOPS = 495e12


def probe_terms(kernel: str, n_pairs: float, n_root_pairs: float, n_bytes: float) -> dict:
    """The least time (ms) of one probe launch (``kernel`` "fori" or
    "mma") per resource: ``fp32`` its tests and root stages over the FP32
    peak, ``tf32`` kernel B's products over the TF32 tensor peak (0 for
    kernel A), ``bytes`` its inputs read and outputs written once over the
    HBM rate. The pipes run side by side, so the largest bounds it."""
    fp32 = n_pairs * PROBE_TEST_OPS[kernel] + n_root_pairs * PROBE_ROOT_OPS
    tf32 = n_pairs * PROBE_MMA_TENSOR_FLOPS if kernel == "mma" else 0.0
    return {"fp32": 1e3 * fp32 / H100_FP32_PEAK_OPS,
            "tf32": 1e3 * tf32 / H100_TF32_TENSOR_FLOPS,
            "bytes": 1e3 * n_bytes / H100_HBM_BYTES_PER_S}


def probe_bound_ms(kernel: str, n_pairs: float, n_root_pairs: float,
                   n_bytes: float) -> tuple[float, str, str]:
    """``bound_ms`` of one probe launch (``probe_terms``): ``(ms,
    "operations" | "bytes", the term that sets it)``."""
    terms = probe_terms(kernel, n_pairs, n_root_pairs, n_bytes)
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term
