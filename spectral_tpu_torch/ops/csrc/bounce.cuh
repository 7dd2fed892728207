// The per-iteration bounce step shared by every bounce kernel (mono.cu,
// regen.cu, persist.cu, seg.cu): the counterpart of the TPU kernels' one
// body, `make_body.bounce` in spectral_tpu/ops/pallas/megakernel.py
// (:1313), over one lane-state struct.
//
// The object loop is the counterpart of both of the TPU kernels' loops:
// the unrolled one for small scenes (`_candidate_t` :554, `trace_tile`
// :605, `shadow_blocked` :714) and the cluster-culled many-object one
// (`trace_tile_fori` :888 with `_sphere_t` :738, `_plain_box_t` :806,
// `_rot_box_t` :817 and the member loops :838-886; the all-lights shadow
// loop `shadow_blocked_fori_multi` :1124; the cluster pre-test `_slab_t`
// :217). Every kernel is instantiated twice, on MANY. A small scene
// (MANY = false: at most SMEM_OBJECTS objects in one unculled run) loops
// over its objects in index order, geometry in shared memory. A
// many-object scene (MANY = true) walks runs of objects (megakernel.cuh:
// order, runs), the Morton-sorted, front-to-back cluster plan of
// ops/clusters.py. Two instantiations and not a runtime branch: one
// kernel with both loops spilled registers and ran 17% slower on
// cornell512 than the small-scene loop alone.
//
// The many-object walk reads what bounds it the way the card reads best:
// a sphere run's members as one 16-byte record each and a triangle run's
// as three (megakernel.cuh: packed), laid out in visit order, in shared
// memory where they fit (spheres1000's 16 KB, mesh's 16 KB) and else
// streamed from global memory (mesh5k's 307 KB); no order[] load comes
// before a member test, and the 47-row table in global memory serves the
// winner's shading, box runs and an unclustered mixed run. A sphere
// member's root stage runs only under a warp vote (sphere_t_voted).
//
// Triangle runs (TRI builds, tri_run_nearest and tri_run_blocked). A warp's
// 32 lanes are unrelated paths: in a warp that visits a cluster, few lanes
// may need it, and the per-lane loop runs all its member tests (up to
// 64, each a Moller-Trumbore of about 70 instructions and three loads of
// one broadcast record) for them. At each packed triangle run every lane
// on it takes the ballot of its cull; when the k needing lanes are few for
// the run's size and the n lanes on it (coop_pays: k * (ceil(size / n) + 1)
// < size, in member tests run), the warp takes the needing lanes one at
// a time: each lane loads its own member's records (start + rank + i * n)
// once, tests them against the needing lane's ray and best hit, which it
// receives by shuffles, and the warp reduces the result to that lane (a
// lexicographic minimum of (t, original index), or any hit for a shadow
// ray). Otherwise, coherent warps say, the per-lane loop runs. A shadow
// ray's lane that is blocked stays in the run loop as a helper rather
// than returning. Sphere runs, box runs, the mixed run and every build
// without TRI keep their loops.
//
// Exactness. A cluster is skipped only when the ray cannot enter its
// union AABB at or before its current best hit (`<=`, not `<`: a member
// may tie t_best bitwise), and an exact tie goes to the lowest ORIGINAL
// object index (`_ORIG`, megakernel.py:923-943), so the winner is the
// brute-force loop's whatever the visit order. The cull is per thread:
// a warp runs a cluster's members if any of its lanes needs them, the
// SIMT form of the TPU kernel's tile-uniform lax.cond. Every object test
// is `candidate_t`, the division form of the eager trace, where the TPU
// kernel's many-object loop multiplies by a reciprocal (<= 1 ulp apart).
// The triangle runs' cooperative pass keeps these bits: a lane visits the
// same runs in the same order and culls each with the same t_best; every
// (ray, member) test the per-lane loop runs for a needing lane runs in the
// pass with the same tri_t, the same operations in the same order, with
// the same filter t > 0 && t <= t_best. The sequential rule over one run,
// t <= t_best && (t < t_best || o < win), keeps the lexicographic minimum
// of (t, o) over the run's candidates and the incoming (t_best, win): a
// candidate that ties the incoming t with win = -1 does not replace it,
// and -1 is the least int; t > 0 (or +inf) so its bits order as its
// value. The minimum does not depend on the order the candidates come in,
// so the pass's per-lane folds and warp reduction give the same pair.
// A shadow ray stops at its first blocker: occlusion is an any-hit
// question, so the walk order cannot change it. That per-light early
// exit is this loop's design in place of the TPU kernel's fused
// all-lights walk, which carries a nearest t per light to the end.
//
// The TPU kernel also splits its cluster walk into compile-size segments
// (`_cluster_segments`, megakernel.py:235) and compacts its geometry rows
// to fit SMEM (`geom_layout`, :105-163). A CUDA loop over a cluster
// table needs neither: its code size does not grow with the scene, and
// records that do not fit shared memory are read from global memory
// through L1 (a warp's lanes all read the same record: a broadcast).
//
// Triangles (mesh faces; `_tri_t` :759, `_tri_normal` :793) are a third
// instantiation flag, TRI, and not a runtime branch of the existing
// builds: a kernel built without it has no triangle code at all, and the
// host never hands it a triangle scene. The default libraries build TRI
// at S = 8 and 32, libraries of their own at 16 and 64 (tri_built). With TRI, a cluster plan's
// triangle run (runs hold one type) walks a loop of Moller-Trumbore
// tests over its records alone, other runs dispatch per object, and the
// triangle normal is the stored winding normal, or, for a mesh with
// vertex normals, the interpolated one at barycentrics recomputed for
// the winner (the jnp form, spectral_tpu/ops/geometry.py:364-382).
// Möller-Trumbore rejects a degenerate triangle through inf/NaN
// barycentrics, which needs IEEE division and no FMA: the same build
// flags as the rest.
//
// Scene features (the reference's beyond-reference branches of
// `make_body`, gated there on has_transmission, has_emission, has_texture
// and has_sky, megakernel.py:1365-1653): the sky on the alive -> miss
// transition, the checker factor on the albedo, emissive surfaces, and
// the dielectric with the hero-wavelength collapse and the Cauchy index
// at the hero bin. They are compiled only with -DSPECTRAL_FX, into
// libraries of their own (runtime/build.py: mono_fx, regen_fx,
// persist_fx, seg_fx), which take the feature tables (megakernel.cuh:
// FX_*, MF_*) and refuse a scene without features; inside them each
// feature is a branch on the scene's feature mask, uniform across the
// launch. The builds without the flag have none of this code, so the
// reference-style scenes keep their registers and bits (the reference's
// static gates: "reference-style scenes pay nothing").
//
// The shadow interval (the reference's opt-in `shadow_interval`,
// megakernel.py:390-411, body :1148-1172): built with
// -DSPECTRAL_SHADOW_INTERVAL, into libraries of their own (runtime/
// build.py: mono_si, regen_si) that hold the many-object loop only
// (dispatch_tables), the
// many-object shadow loop decides whether a sphere's chosen root lies in
// (0, maxd] by sign tests on its quadratic, without the root
// (sphere_interval_blocked); boxes and triangles keep their t <= maxd
// test. It is not bit-identical to the root test, so it is never a
// default, and the default libraries have none of its code.
//
// Numerics. The arithmetic follows the torch-eager bounce loop
// (spectral_tpu_torch/render/integrator.py) op for op: the reference-exact
// division form of the quadratic and slabs, normalize as v * (1 /
// sqrtf(v.v)), the asin form of the cosine sampler, PCG3D seeded with
// (px, py, frame + bounces_left). The diffuse continuation starts from
// the UN-offset hit point, so one ulp decides a self-hit: the sources
// are built with -fmad=false and without --use_fast_math, so no FMA
// contraction or approximate division/sqrt flips those coins where the
// plain version does not.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "megakernel.cuh"

namespace spectral {
namespace {

constexpr float kOffset = 1e-5f;        // reference src/shader.rs:8
constexpr float kSpecMin = 1e-4f;       // reference src/shader.rs:14
constexpr float kDelta = 1e-5f;         // reference src/shader.rs:7
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInv2_32 = 2.3283064365386963e-10f;

// The scene tables as the kernels read them (see megakernel.cuh).
struct TableArgs {
  const float* geom;        // [GEOM_ROWS][n_obj]
  const float* mat_albedo;  // [n_mat][S]
  const int* order;         // [n_obj]
  const float* runs;        // [n_runs][RUN_COLS]
  const float* lpos;        // [n_lights][4]
  const float* lspec;       // [n_lights][S]
  const float4* packed;     // [n_packed]: the packed walk records
  int n_obj;
  int n_mat;
  int n_runs;
  int n_lights;
  int tri;                  // 0: no triangles, 1: flat meshes, 2: vertex normals
  int n_packed;
  int packed_shared;        // 1: the block copies `packed` to shared memory
  // The material rows the block copies to shared memory: n_mat, or 0 where
  // they stay in global memory (the host's choice, ops/megakernel.py:
  // KernelTables.materials_shared); then stage_floats is BLOCK *
  // stage_stride(S), the staging slots, else 0.
  int mat_rows;
  int stage_floats;
#ifdef SPECTRAL_FX
  int features;             // FX_* bits, never 0 in a feature build
  const float* mat_fx;      // [n_mat][MAT_FX_COLS]
  const float* mat_emission;  // [n_mat][S]
  const float* lambda;      // [S] wavelengths, nm
  const float* sky;         // [S]
#endif
};

struct Tables {
  const float* geom;        // shared (MANY = false) or global
  const float* mat_albedo;  // shared (mat_rows rows; else the staging slots)
  const int* order;         // shared (MANY only)
  const float* runs;        // shared (MANY only)
  const float4* packed;     // shared or global (MANY only)
  const float* lpos;        // shared
  const float* lspec;       // shared
  float* scale;             // [n_lights][BLOCK] this thread's NEE scales
  // where the material rows stay in global memory (staged: mat_rows is
  // 0), the rows; a bounce copies its material's rows into the thread's
  // slot of shared memory (stage_slot)
  const float* g_albedo;
  bool staged;
  int n_obj;
  int n_runs;
  int n_lights;
  bool smooth;              // interpolate triangle normals (tri == 2)
#ifdef SPECTRAL_FX
  int features;             // FX_* bits
  const float* mat_fx;      // shared, like mat_albedo
  const float* mat_emission;  // shared, like mat_albedo
  const float* g_fx;
  const float* g_emission;
  const float* lambda;      // shared
  const float* sky;         // shared
#endif
};

__device__ __forceinline__ float G(const Tables& tb, int row, int o) {
  return tb.geom[row * tb.n_obj + o];
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// max(x, 0) with NaN passing through, like torch.clamp_min
__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }

__device__ __forceinline__ void pcg3d(uint32_t x, uint32_t y, uint32_t z,
                                      float& rx, float& ry, float& rz) {
  const uint32_t mul = 1664525u, add = 1013904223u;
  x = x * mul + add;
  y = y * mul + add;
  z = z * mul + add;
  x = y * z + x;
  y = z * x + y;
  z = x * y + z;
  x = x ^ (x >> 16);
  y = y ^ (y >> 16);
  z = z ^ (z >> 16);
  x = y * z + x;
  y = z * x + y;
  z = x * y + z;
  // (float)u32 rounds to nearest, like Rust `u32 as f32`
  rx = (float)x * kInv2_32;
  ry = (float)y * kInv2_32;
  rz = (float)z * kInv2_32;
}

// Moller-Trumbore in the eager trace's op order (ops/geometry.py:
// triangle_t) on the triangle's v0, e1 = v1 - v0 and e2 = v2 - v0:
// two-sided, no epsilon; returns valid with t >= 0 (the caller applies
// t > 0) and the barycentrics u, v.
__device__ __forceinline__ bool tri_t(float v0x, float v0y, float v0z,
                                      float e1x, float e1y, float e1z,
                                      float e2x, float e2y, float e2z,
                                      float ox, float oy, float oz, float dx,
                                      float dy, float dz, float& t, float& u,
                                      float& v) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float inv_det = 1.0f / dot3(e1x, e1y, e1z, px, py, pz);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  u = dot3(sx, sy, sz, px, py, pz) * inv_det;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = dot3(dx, dy, dz, qx, qy, qz) * inv_det;
  t = dot3(e2x, e2y, e2z, qx, qy, qz) * inv_det;
  return (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t >= 0.0f);
}

// tri_t for triangle o of the 47-row table (megakernel.cuh: v0 in
// G_SHIFT, e1 in G_SLAB_MIN, e2 in G_SLAB_MAX)
__device__ __forceinline__ bool tri_t(const Tables& tb, int o, float ox,
                                      float oy, float oz, float dx, float dy,
                                      float dz, float& t, float& u, float& v) {
  return tri_t(G(tb, G_SHIFT, o), G(tb, G_SHIFT + 1, o), G(tb, G_SHIFT + 2, o),
               G(tb, G_SLAB_MIN, o), G(tb, G_SLAB_MIN + 1, o),
               G(tb, G_SLAB_MIN + 2, o), G(tb, G_SLAB_MAX, o),
               G(tb, G_SLAB_MAX + 1, o), G(tb, G_SLAB_MAX + 2, o), ox, oy, oz,
               dx, dy, dz, t, u, v);
}

// The quadratic of the sphere (centre c, radius r) in the eager trace's
// division form: valid (disc >= 0 and t >= 0) with the nearer root that
// is >= 0 (the caller applies t > 0).
__device__ __forceinline__ bool sphere_t(float cx, float cy, float cz,
                                         float r, float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float b = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
  const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
  const float disc = b * b - 4.0f * a * c;
  const float sq = sqrtf(max0(disc));
  const float t1 = (-b - sq) / (2.0f * a);
  const float t2 = (-b + sq) / (2.0f * a);
  t = t1 >= 0.0f ? t1 : t2;
  return (disc >= 0.0f) && (t >= 0.0f);
}

#ifdef SPECTRAL_SHADOW_INTERVAL
// Does the chosen root of the sphere (centre c, radius r) lie in
// (0, maxd]? Sign tests on f(t) = a t^2 + b t + c, with the light's
// invariants foura = 4a, g0 = 2 a maxd and amax2 = a maxd^2, in the op
// order of the plain twin (ops/geometry.py:sphere_interval_blocked): t1
// iff b < 0, c > 0 and (the vertex -b / 2a <= maxd or f(maxd) <= 0); t2
// (t1 < 0) iff c < 0, the vertex test and f(maxd) >= 0; both need disc >= 0.
__device__ __forceinline__ bool sphere_interval_blocked(
    float cx, float cy, float cz, float r, float ox, float oy, float oz,
    float dx, float dy, float dz, float maxd, float foura, float g0,
    float amax2) {
  const float rx = ox - cx, ry = oy - cy, rz = oz - cz;
  const float b = 2.0f * dot3(rx, ry, rz, dx, dy, dz);
  const float c = dot3(rx, ry, rz, rx, ry, rz) - r * r;
  const float disc = b * b - foura * c;
  const float fm = amax2 + b * maxd + c;
  const bool v_ok = b + g0 >= 0.0f;
  const bool near = (b < 0.0f) && (c > 0.0f) && (v_ok || fm <= 0.0f);
  const bool far = (c < 0.0f) && v_ok && (fm >= 0.0f);
  return (disc >= 0.0f) && (near || far);
}
#endif

// Candidate hit of object o (reference src/shader.rs:508-560): valid and
// t > 0. One definition for the nearest-hit trace and the shadow test.
// Spheres and triangles by their tags; every other tag the host lets
// through (plain and rotated boxes) is a box.
template <bool TRI>
__device__ __forceinline__ bool candidate_t(const Tables& tb, int o, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& t) {
  const int type = (int)G(tb, G_TYPE, o);
  bool valid;
  if (TRI && type == OBJ_TRIANGLE) {
    float u, v;
    valid = tri_t(tb, o, ox, oy, oz, dx, dy, dz, t, u, v);
  } else if (type == OBJ_SPHERE) {
    valid = sphere_t(G(tb, G_SPHERE_POS, o), G(tb, G_SPHERE_POS + 1, o),
                     G(tb, G_SPHERE_POS + 2, o), G(tb, G_RADIUS, o), ox, oy,
                     oz, dx, dy, dz, t);
  } else {
    // both box types: into the object frame (identity for plain boxes),
    // then the slab test with NaN-ignoring min/max
    const float rx = ox - G(tb, G_SHIFT, o);
    const float ry = oy - G(tb, G_SHIFT + 1, o);
    const float rz = oz - G(tb, G_SHIFT + 2, o);
    float lo[3], ld[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float i0 = G(tb, G_INV_ROT + 3 * k, o);
      const float i1 = G(tb, G_INV_ROT + 3 * k + 1, o);
      const float i2 = G(tb, G_INV_ROT + 3 * k + 2, o);
      lo[k] = i0 * rx + i1 * ry + i2 * rz;
      ld[k] = i0 * dx + i1 * dy + i2 * dz;
    }
    float t_min = -INFINITY, t_max = INFINITY;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float iv = 1.0f / ld[k];
      const float t1 = (G(tb, G_SLAB_MIN + k, o) - lo[k]) * iv;
      const float t2 = (G(tb, G_SLAB_MAX + k, o) - lo[k]) * iv;
      const bool swap = iv < 0.0f;
      t_min = fmaxf(t_min, swap ? t2 : t1);
      t_max = fminf(t_max, swap ? t1 : t2);
    }
    t = t_min >= 0.0f ? t_min : t_max;
    valid = (t_max > t_min) && (t_max >= 0.0f);
  }
  return valid && (t > 0.0f);
}

// Can a ray (origin o, reciprocal direction iv) reach run R's members at
// or before `limit`? An unculled run always can; a cluster needs a hit of
// its union AABB (the slab test of megakernel.py:217) whose entry t is
// <= limit. Conservative: a member hit t is never below the entry t.
__device__ __forceinline__ bool run_reachable(const float* R, float ox,
                                              float oy, float oz, float ivx,
                                              float ivy, float ivz,
                                              float limit) {
  if (!(R[RUN_CULL] > 0.0f)) return true;
  const float o[3] = {ox, oy, oz};
  const float iv[3] = {ivx, ivy, ivz};
  float t_min = -INFINITY, t_max = INFINITY;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float t1 = (R[RUN_MIN + k] - o[k]) * iv[k];
    const float t2 = (R[RUN_MAX + k] - o[k]) * iv[k];
    const bool swap = iv[k] < 0.0f;
    t_min = fmaxf(t_min, swap ? t2 : t1);
    t_max = fminf(t_max, swap ? t1 : t2);
  }
  return (t_max > t_min) && (t_max >= 0.0f) && (t_min <= limit);
}

// The walk over a run's members reads its packed records (megakernel.cuh:
// RUN_PACK) when it has them: a sphere run one float4 per member, a
// triangle run three, in visit order, so the members stream through
// 16-byte loads without the order[] indirection; order[] gives the
// original index only where a hit ties or beats t_best. Any other run
// (boxes, an unclustered mixed run) dispatches each member of the 47-row
// table on its type tag. Both read the same values in the same op order:
// the winner and its t are the same bits either way.
__device__ __forceinline__ int packed_kind(const float* R) {
  if (!(R[RUN_PACK] >= 0.0f)) return -1;
  return (int)R[RUN_TYPE];
}

#ifdef SPECTRAL_STATS
// The diagnostic build's walk counters (tools/lane_stats.py), per thread
// in shared memory, flushed by the kernel at its end. For the nearest
// trace (base 0) and the shadow rays (base WALK_SHADOW): the traces, the
// culled runs the lane needs and those its warp visits (any of its
// active lanes needs them), the member tests the lane needs and those
// its warp runs (lane slots: a packed triangle run adds what its pass
// spends, walk_tri); then, once a warp (in its lowest active lane's
// slot), the packed sphere member tests the warp runs and those whose
// root stage it runs (sphere_t_voted); then the packed triangle runs:
// once a warp, the visits its pass takes cooperatively and those it takes
// per lane; per lane, the member tests the lane needs, and the lane slots
// the warp spends on member tests in each branch.
constexpr int WALK_TRACES = 0, WALK_RUNS_NEED = 1, WALK_RUNS_VISIT = 2,
              WALK_MEMB_NEED = 3, WALK_MEMB_VISIT = 4, WALK_SPHERE_TESTS = 5,
              WALK_ROOT_STAGES = 6, WALK_TRI_COOP = 7, WALK_TRI_LANE = 8,
              WALK_TRI_NEED = 9, WALK_TRI_SLOTS_COOP = 10,
              WALK_TRI_SLOTS_LANE = 11, WALK_SHADOW = 12, WALK_STATS = 24;

__device__ __forceinline__ unsigned* walk_slots() {
  __shared__ unsigned slots[WALK_STATS * BLOCK];
  return slots;
}

__device__ __forceinline__ void walk_count(int base, int what, unsigned v) {
  walk_slots()[(base + what) * BLOCK + threadIdx.x] += v;
}

// `members`: count the lane slots of the run's member tests here (a
// packed triangle run's pass counts its own)
__device__ __forceinline__ void walk_run(int base, const float* R, bool reach,
                                         bool members) {
  const bool any = __ballot_sync(__activemask(), reach) != 0u;
  const unsigned size = (unsigned)((int)R[RUN_STOP] - (int)R[RUN_START]);
  if (R[RUN_CULL] > 0.0f) {
    walk_count(base, WALK_RUNS_NEED, reach ? 1u : 0u);
    walk_count(base, WALK_RUNS_VISIT, any ? 1u : 0u);
  }
  walk_count(base, WALK_MEMB_NEED, reach ? size : 0u);
  if (members) walk_count(base, WALK_MEMB_VISIT, any ? size : 0u);
}

__device__ __forceinline__ void walk_sphere(int base, unsigned lanes, bool rooted) {
  if ((int)(threadIdx.x & 31u) == __ffs(lanes) - 1) {
    walk_count(base, WALK_SPHERE_TESTS, 1u);
    walk_count(base, WALK_ROOT_STAGES, rooted ? 1u : 0u);
  }
}

// a packed triangle run's pass over the warp's `lanes`: the branch it
// took, the lane's need and the lane slots the warp spends
__device__ __forceinline__ void walk_tri(int base, unsigned lanes, bool coop,
                                         bool reach, unsigned size,
                                         unsigned slots) {
  if ((int)(threadIdx.x & 31u) == __ffs(lanes) - 1) {
    walk_count(base, coop ? WALK_TRI_COOP : WALK_TRI_LANE, 1u);
  }
  walk_count(base, WALK_TRI_NEED, reach ? size : 0u);
  walk_count(base, coop ? WALK_TRI_SLOTS_COOP : WALK_TRI_SLOTS_LANE, slots);
  walk_count(base, WALK_MEMB_VISIT, slots);
}
#define SPECTRAL_WALK_TRACE(base) walk_count(base, WALK_TRACES, 1u)
#define SPECTRAL_WALK_RUN(base, R, reach) walk_run(base, R, reach, true)
#define SPECTRAL_WALK_TRI_RUN(base, R, reach) walk_run(base, R, reach, false)
#define SPECTRAL_WALK_SPHERE(shadow, lanes, rooted) \
  walk_sphere((shadow) ? WALK_SHADOW : 0, lanes, rooted)
#define SPECTRAL_WALK_TRI(shadow, lanes, coop, reach, size, slots) \
  walk_tri((shadow) ? WALK_SHADOW : 0, lanes, coop, reach, size, slots)
#else
#define SPECTRAL_WALK_TRACE(base) ((void)0)
#define SPECTRAL_WALK_RUN(base, R, reach) ((void)0)
#define SPECTRAL_WALK_TRI_RUN(base, R, reach) ((void)0)
#define SPECTRAL_WALK_SPHERE(shadow, lanes, rooted) ((void)0)
#define SPECTRAL_WALK_TRI(shadow, lanes, coop, reach, size, slots) ((void)0)
#endif

// sphere_t in two stages, for the packed sphere runs of the many-object
// walk, where most lanes of a warp miss most of a cluster's members: the
// discriminant on every lane, then the root stage only where a warp vote
// finds a lane with disc >= 0. A lane votes whenever it runs the test, so
// a lane with a root always gets its root stage. Inside it a lane without
// one takes sqrtf(1), not sqrtf(0): zero is off the IEEE square root's
// fast path, and one such lane would hold its warp on the slow path. Its
// roots are discarded as before. A lane with disc >= 0 takes sqrtf(disc),
// which is sqrtf(max0(disc)) there (a -0.0 keeps its sign), so valid and
// t are sphere_t's bits. The trace probe's roots do the same (probe.cu).
template <bool SHADOW>
__device__ __forceinline__ bool sphere_t_voted(float cx, float cy, float cz,
                                               float r, float ox, float oy,
                                               float oz, float dx, float dy,
                                               float dz, float& t) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float b = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
  const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
  const float disc = b * b - 4.0f * a * c;
  const bool root = disc >= 0.0f;
  const unsigned lanes = __activemask();
  const bool any = __any_sync(lanes, root);
  SPECTRAL_WALK_SPHERE(SHADOW, lanes, any);
  if (!any) return false;
  const float sq = sqrtf(root ? disc : 1.0f);
  const float t1 = (-b - sq) / (2.0f * a);
  const float t2 = (-b + sq) / (2.0f * a);
  t = t1 >= 0.0f ? t1 : t2;
  return root && (t >= 0.0f);
}

// The cooperative pass over a packed triangle run (TRI builds; the header's
// "Triangle runs"). Its cost rule, in member tests a lane slot runs: the
// per-lane loop costs the warp the run's `size` tests whatever the
// number k of lanes that need them; the pass costs ceil(size / n) per
// needing lane over the n lanes on the run, plus the exchange of the
// needing lane's ray and best hit and the warp's reduction, which weigh
// about one test (kCoopOverhead, in quarters of a test). Measured on an
// H100 (PERF.md section 6): 4, 8 and 16 quarters within 4% of each
// other on mesh5k, 4 the fastest on the mesh preset at 32 wavelengths.
constexpr int kCoopOverhead = 4;

__device__ __forceinline__ bool coop_pays(int k, int n, int size) {
  return k * (4 * ((size + n - 1) / n) + kCoopOverhead) < 4 * size;
}

// The nearest trace's packed triangle run R (run index r) for every lane
// of the warp on it, needed (reach) or not: where the rule pays, the warp
// takes its needing lanes one at a time and spreads the run's members over
// its lanes (member start + rank + i * n), each lane testing its member
// against the needing lane's ray with tri_t as the per-lane loop does;
// the needing lane takes the lexicographic minimum of (t, original index)
// over the warp, its incoming (t_best, win) included. Else the per-lane
// loop. `lanes` matches on r, so every lane of the pass reads one run.
__device__ __forceinline__ void tri_run_nearest(const Tables& tb, const float* R,
                                                int r, bool reach, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                float& t_best, int& win) {
  const int start = (int)R[RUN_START], stop = (int)R[RUN_STOP];
  const int at = (int)R[RUN_PACK] - 3 * start;  // slot k: at + 3k..
  const unsigned lanes = __match_any_sync(__activemask(), r);
  const unsigned need = __ballot_sync(lanes, reach);
  if (need == 0u) return;
  const int n = __popc(lanes), size = stop - start;
  if (coop_pays(__popc(need), n, size)) {
    const int me = (int)(threadIdx.x & 31u);
    const int rank = __popc(lanes & ((1u << me) - 1u));
    for (int first = start; first < stop; first += n) {
      const int k = first + rank;
      const bool has = k < stop;
      const int slot = has ? k : start;
      const float4 a = tb.packed[at + 3 * slot], b = tb.packed[at + 3 * slot + 1],
                   c = tb.packed[at + 3 * slot + 2];
      for (unsigned left = need; left != 0u; left &= left - 1u) {
        const int j = __ffs(left) - 1;
        const float jox = __shfl_sync(lanes, ox, j), joy = __shfl_sync(lanes, oy, j),
                    joz = __shfl_sync(lanes, oz, j), jdx = __shfl_sync(lanes, dx, j),
                    jdy = __shfl_sync(lanes, dy, j), jdz = __shfl_sync(lanes, dz, j);
        float jt = __shfl_sync(lanes, t_best, j);
        int jwin = __shfl_sync(lanes, win, j);
        float t, u, v;
        if (has &&
            tri_t(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, jox, joy, joz,
                  jdx, jdy, jdz, t, u, v) &&
            t > 0.0f && t <= jt) {
          const int o = tb.order[k];
          if (t < jt || o < jwin) {
            jt = t;
            jwin = o;
          }
        }
        // t > 0 or +inf: the bits order as the values
        const unsigned t_min = __reduce_min_sync(lanes, __float_as_uint(jt));
        const int w_min =
            __reduce_min_sync(lanes, __float_as_uint(jt) == t_min ? jwin : 0x7fffffff);
        if (me == j) {
          t_best = __uint_as_float(t_min);
          win = w_min;
        }
      }
    }
    SPECTRAL_WALK_TRI(false, lanes, true, reach, size,
                      __popc(need) * ((size + n - 1) / n));
    return;
  }
  SPECTRAL_WALK_TRI(false, lanes, false, reach, size, size);
  if (!reach) return;
  for (int k = start; k < stop; ++k) {
    const float4 a = tb.packed[at + 3 * k], b = tb.packed[at + 3 * k + 1],
                 c = tb.packed[at + 3 * k + 2];
    float t, u, v;
    if (tri_t(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, ox, oy, oz, dx, dy,
              dz, t, u, v) &&
        t > 0.0f && t <= t_best) {
      const int o = tb.order[k];  // ties: the lowest original index wins
      if (t < t_best || o < win) {
        t_best = t;
        win = o;
      }
    }
  }
}

// The shadow rays' packed triangle run R, as tri_run_nearest: a needing
// lane is blocked if any lane's member test finds a hit in (0, max_dist];
// a blocked lane needs no further test. Lanes already blocked take part
// as helpers (their reach is false).
__device__ __forceinline__ void tri_run_blocked(const Tables& tb, const float* R,
                                                int r, bool reach, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz,
                                                float max_dist, bool& blocked) {
  const int start = (int)R[RUN_START], stop = (int)R[RUN_STOP];
  const int at = (int)R[RUN_PACK] - 3 * start;  // slot k: at + 3k..
  const unsigned lanes = __match_any_sync(__activemask(), r);
  unsigned need = __ballot_sync(lanes, reach);
  if (need == 0u) return;
  const int n = __popc(lanes), size = stop - start;
  if (coop_pays(__popc(need), n, size)) {
    // the slots as the rule counts them, a blocked lane's early end aside
    // (the per-lane loop's count takes none either)
    SPECTRAL_WALK_TRI(true, lanes, true, reach, size,
                      __popc(need) * ((size + n - 1) / n));
    const int me = (int)(threadIdx.x & 31u);
    const int rank = __popc(lanes & ((1u << me) - 1u));
    for (int first = start; first < stop && need != 0u; first += n) {
      const int k = first + rank;
      const bool has = k < stop;
      const int slot = has ? k : start;
      const float4 a = tb.packed[at + 3 * slot], b = tb.packed[at + 3 * slot + 1],
                   c = tb.packed[at + 3 * slot + 2];
      for (unsigned left = need; left != 0u; left &= left - 1u) {
        const int j = __ffs(left) - 1;
        const float jox = __shfl_sync(lanes, ox, j), joy = __shfl_sync(lanes, oy, j),
                    joz = __shfl_sync(lanes, oz, j), jdx = __shfl_sync(lanes, dx, j),
                    jdy = __shfl_sync(lanes, dy, j), jdz = __shfl_sync(lanes, dz, j);
        const float jmax = __shfl_sync(lanes, max_dist, j);
        float t, u, v;
        const bool hit = has &&
                         tri_t(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, jox,
                               joy, joz, jdx, jdy, jdz, t, u, v) &&
                         t > 0.0f && t <= jmax && t < INFINITY;
        if (__any_sync(lanes, hit) && me == j) blocked = true;
      }
      need = __ballot_sync(lanes, reach && !blocked);
    }
    return;
  }
  SPECTRAL_WALK_TRI(true, lanes, false, reach, size, size);
  if (!reach) return;
  for (int k = start; k < stop; ++k) {
    const float4 a = tb.packed[at + 3 * k], b = tb.packed[at + 3 * k + 1],
                 c = tb.packed[at + 3 * k + 2];
    float t, u, v;
    if (tri_t(a.x, a.y, a.z, b.x, b.y, b.z, c.x, c.y, c.z, ox, oy, oz, dx, dy,
              dz, t, u, v) &&
        t > 0.0f && t <= max_dist && t < INFINITY) {
      blocked = true;
      return;
    }
  }
}

// Nearest positive hit: returns the winner's original index (-1: miss).
// A small scene loops over its objects in index order, where strict <
// alone keeps the lowest index on ties, and without the run table.
template <bool MANY, bool TRI>
__device__ __forceinline__ int trace_nearest(const Tables& tb, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             float& t_best) {
  t_best = INFINITY;
  int win = -1;
  if constexpr (!MANY) {
    for (int o = 0; o < tb.n_obj; ++o) {
      float t;
      if (candidate_t<TRI>(tb, o, ox, oy, oz, dx, dy, dz, t) && t < t_best) {
        t_best = t;
        win = o;
      }
    }
    return win;
  }
  SPECTRAL_WALK_TRACE(0);
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
  for (int r = 0; r < tb.n_runs; ++r) {
    const float* R = tb.runs + r * RUN_COLS;
    const bool reach = run_reachable(R, ox, oy, oz, ivx, ivy, ivz, t_best);
    if constexpr (TRI) {
      if (packed_kind(R) == OBJ_TRIANGLE) {  // every lane on the run takes part
        SPECTRAL_WALK_TRI_RUN(0, R, reach);
        tri_run_nearest(tb, R, r, reach, ox, oy, oz, dx, dy, dz, t_best, win);
        continue;
      }
    }
    SPECTRAL_WALK_RUN(0, R, reach);
    if (!reach) continue;
    const int start = (int)R[RUN_START], stop = (int)R[RUN_STOP];
    const int kind = packed_kind(R);
    if (kind == OBJ_SPHERE) {
      const int at = (int)R[RUN_PACK] - start;  // record of slot k: at + k
      for (int k = start; k < stop; ++k) {
        const float4 c = tb.packed[at + k];
        float t;
        if (sphere_t_voted<false>(c.x, c.y, c.z, c.w, ox, oy, oz, dx, dy,
                                  dz, t) &&
            t > 0.0f && t <= t_best) {
          const int o = tb.order[k];  // ties: the lowest original index wins
          if (t < t_best || o < win) {
            t_best = t;
            win = o;
          }
        }
      }
      continue;
    }
    for (int k = start; k < stop; ++k) {
      const int o = tb.order[k];
      float t;
      if (candidate_t<TRI>(tb, o, ox, oy, oz, dx, dy, dz, t) &&
          (t < t_best || (t == t_best && o < win))) {
        t_best = t;  // ties: the lowest original index wins
        win = o;
      }
    }
  }
  return win;
}

// Is there a positive hit within max_dist (reference src/shader.rs:484-489)?
template <bool MANY, bool TRI>
__device__ __forceinline__ bool shadow_blocked(const Tables& tb, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               float max_dist) {
  if constexpr (!MANY) {
    for (int o = 0; o < tb.n_obj; ++o) {
      float t;
      if (candidate_t<TRI>(tb, o, ox, oy, oz, dx, dy, dz, t) && t <= max_dist &&
          t < INFINITY) {
        return true;
      }
    }
    return false;
  }
  SPECTRAL_WALK_TRACE(WALK_SHADOW);
  const float ivx = 1.0f / dx, ivy = 1.0f / dy, ivz = 1.0f / dz;
#ifdef SPECTRAL_SHADOW_INTERVAL
  const float a = dot3(dx, dy, dz, dx, dy, dz);
  const float foura = 4.0f * a, g0 = 2.0f * a * max_dist,
              amax2 = a * max_dist * max_dist;
#endif
  // TRI: a blocked lane keeps to the run loop, a helper of its warp's
  // triangle passes (tri_run_blocked), until every lane with it is blocked
  bool blocked = false;
  for (int r = 0; r < tb.n_runs; ++r) {
    if constexpr (TRI) {
      if (__all_sync(__activemask(), blocked)) break;
    }
    const float* R = tb.runs + r * RUN_COLS;
    const bool reach =
        !blocked && run_reachable(R, ox, oy, oz, ivx, ivy, ivz, max_dist);
    if constexpr (TRI) {
      if (packed_kind(R) == OBJ_TRIANGLE) {  // every lane on the run takes part
        if (!blocked) SPECTRAL_WALK_TRI_RUN(WALK_SHADOW, R, reach);
        tri_run_blocked(tb, R, r, reach, ox, oy, oz, dx, dy, dz, max_dist, blocked);
        continue;
      }
    }
    if (!blocked) SPECTRAL_WALK_RUN(WALK_SHADOW, R, reach);
    if (!reach) continue;
    const int start = (int)R[RUN_START], stop = (int)R[RUN_STOP];
    const int kind = packed_kind(R);
    if (kind == OBJ_SPHERE) {
      const int at = (int)R[RUN_PACK] - start;  // record of slot k: at + k
      for (int k = start; k < stop; ++k) {
        const float4 c = tb.packed[at + k];
#ifdef SPECTRAL_SHADOW_INTERVAL
        if (sphere_interval_blocked(c.x, c.y, c.z, c.w, ox, oy, oz, dx, dy, dz,
                                    max_dist, foura, g0, amax2)) {
          if constexpr (!TRI) return true;
          blocked = true;
          break;
        }
#else
        float t;
        if (sphere_t_voted<true>(c.x, c.y, c.z, c.w, ox, oy, oz, dx, dy,
                                 dz, t) &&
            t > 0.0f && t <= max_dist && t < INFINITY) {
          if constexpr (!TRI) return true;
          blocked = true;
          break;
        }
#endif
      }
      continue;
    }
    for (int k = start; k < stop; ++k) {
      const int o = tb.order[k];
#ifdef SPECTRAL_SHADOW_INTERVAL
      if ((int)G(tb, G_TYPE, o) == OBJ_SPHERE) {
        if (sphere_interval_blocked(G(tb, G_SPHERE_POS, o), G(tb, G_SPHERE_POS + 1, o),
                                    G(tb, G_SPHERE_POS + 2, o), G(tb, G_RADIUS, o),
                                    ox, oy, oz, dx, dy, dz, max_dist, foura, g0,
                                    amax2)) {
          if constexpr (!TRI) return true;
          blocked = true;
          break;
        }
        continue;
      }
#endif
      float t;
      if (candidate_t<TRI>(tb, o, ox, oy, oz, dx, dy, dz, t) &&
          t <= max_dist && t < INFINITY) {
        if constexpr (!TRI) return true;
        blocked = true;
        break;
      }
    }
  }
  return blocked;
}

__device__ __forceinline__ float box_axis(float p, float lo, float hi) {
  return fabsf(p - lo) < kDelta ? -1.0f : (fabsf(p - hi) < kDelta ? 1.0f : 0.0f);
}

// Surface normal of object o at ip (reference src/shader.rs:366-378,
// 582-650), which the ray (o, d) hit. A triangle's is its stored winding
// normal n0, or with vertex normals normalize(n0 + dn1*u + dn2*v) at the
// ray's barycentrics, recomputed here rather than carried through the
// walk (spectral_tpu/ops/geometry.py:364-382); never flipped.
template <bool TRI>
__device__ __forceinline__ void surface_normal(const Tables& tb, int o,
                                               float ipx, float ipy, float ipz,
                                               float rox, float roy,
                                               float roz, float rdx,
                                               float rdy, float rdz,
                                               float& nx, float& ny,
                                               float& nz) {
  const int type = (int)G(tb, G_TYPE, o);
  if (TRI && type == OBJ_TRIANGLE) {
    nx = G(tb, G_INV_ROT, o);
    ny = G(tb, G_INV_ROT + 1, o);
    nz = G(tb, G_INV_ROT + 2, o);
    if (tb.smooth) {
      float t, u, v;
      tri_t(tb, o, rox, roy, roz, rdx, rdy, rdz, t, u, v);
      nx = (nx + G(tb, G_INV_ROT + 3, o) * u) + G(tb, G_INV_ROT + 6, o) * v;
      ny = (ny + G(tb, G_INV_ROT + 4, o) * u) + G(tb, G_INV_ROT + 7, o) * v;
      nz = (nz + G(tb, G_INV_ROT + 5, o) * u) + G(tb, G_INV_ROT + 8, o) * v;
      normalize3(nx, ny, nz);
    }
  } else if (type == OBJ_SPHERE) {
    nx = ipx - G(tb, G_SPHERE_POS, o);
    ny = ipy - G(tb, G_SPHERE_POS + 1, o);
    nz = ipz - G(tb, G_SPHERE_POS + 2, o);
    normalize3(nx, ny, nz);
  } else if (type == OBJ_PLAIN_BOX) {
    nx = box_axis(ipx, G(tb, G_AABB_MIN, o), G(tb, G_AABB_MAX, o));
    ny = box_axis(ipy, G(tb, G_AABB_MIN + 1, o), G(tb, G_AABB_MAX + 1, o));
    nz = box_axis(ipz, G(tb, G_AABB_MIN + 2, o), G(tb, G_AABB_MAX + 2, o));
    normalize3(nx, ny, nz);
  } else {  // rotated box: closest local face, strict < in scan order
    const float rx = ipx - G(tb, G_CENTER, o);
    const float ry = ipy - G(tb, G_CENTER + 1, o);
    const float rz = ipz - G(tb, G_CENTER + 2, o);
    float l[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      l[k] = G(tb, G_INV_ROT + 3 * k, o) * rx +
             G(tb, G_INV_ROT + 3 * k + 1, o) * ry +
             G(tb, G_INV_ROT + 3 * k + 2, o) * rz;
    }
    const float hx = G(tb, G_HALF, o), hy = G(tb, G_HALF + 1, o),
                hz = G(tb, G_HALF + 2, o);
    float min_d = fabsf(hx - l[0]);
    float lnx = 1.0f, lny = 0.0f, lnz = 0.0f;
    const float dists[5] = {fabsf(-hx - l[0]), fabsf(hy - l[1]),
                            fabsf(-hy - l[1]), fabsf(hz - l[2]),
                            fabsf(-hz - l[2])};
    const float cand[5][3] = {{-1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                              {0.0f, -1.0f, 0.0f}, {0.0f, 0.0f, 1.0f},
                              {0.0f, 0.0f, -1.0f}};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if (dists[k] < min_d) {
        lnx = cand[k][0];
        lny = cand[k][1];
        lnz = cand[k][2];
      }
      min_d = fminf(min_d, dists[k]);
    }
    nx = G(tb, G_ROT, o) * lnx + G(tb, G_ROT + 1, o) * lny +
         G(tb, G_ROT + 2, o) * lnz;
    ny = G(tb, G_ROT + 3, o) * lnx + G(tb, G_ROT + 4, o) * lny +
         G(tb, G_ROT + 5, o) * lnz;
    nz = G(tb, G_ROT + 6, o) * lnx + G(tb, G_ROT + 7, o) * lny +
         G(tb, G_ROT + 8, o) * lnz;
  }
}

// Roughness-cone perturbation of (wx, wy, wz) (reference src/shader.rs:736-755).
__device__ __forceinline__ void sample_in_cone(float& x, float& y, float& z,
                                               float rough, float rx,
                                               float ry) {
  const float theta_max = rough * rough * kHalfPi;
  const float cos_theta = (1.0f - rx) + rx * cosf(theta_max);
  const float sin_theta = sqrtf(1.0f - cos_theta * cos_theta);
  const float phi = kTwoPi * ry;
  const float lx = sin_theta * cosf(phi);
  const float ly = sin_theta * sinf(phi);
  const float lz = cos_theta;
  float wx = x, wy = y, wz = z;
  normalize3(wx, wy, wz);
  const bool near_z = fabsf(wz) < 0.999f;
  const float ax = near_z ? 0.0f : 1.0f, ay = 0.0f, az = near_z ? 1.0f : 0.0f;
  float vx = wy * az - wz * ay, vy = wz * ax - wx * az, vz = wx * ay - wy * ax;
  normalize3(vx, vy, vz);
  const float ux = vy * wz - vz * wy, uy = vz * wx - vx * wz,
              uz = vx * wy - vy * wx;
  x = ux * lx + vx * ly + wx * lz;
  y = uy * lx + vy * ly + wy * lz;
  z = uz * lx + vz * ly + wz * lz;
  normalize3(x, y, z);
}

// Cosine-importance bounce about n, asin form (reference src/shader.rs:717-729).
__device__ __forceinline__ void cosine_hemisphere(float rx, float ry, float nx,
                                                  float ny, float nz,
                                                  float& x, float& y,
                                                  float& z) {
  const float theta = asinf(sqrtf(rx));
  const float phi = kTwoPi * ry;
  const float sin_t = sinf(theta);
  const float lx = sin_t * cosf(phi);
  const float ly = sin_t * sinf(phi);
  const float lz = cosf(theta);
  const bool near_y = fabsf(ny) > 0.9999f;
  const float upx = near_y ? 1.0f : 0.0f, upy = near_y ? 0.0f : 1.0f,
              upz = 0.0f;
  float zx = nx, zy = ny, zz = nz;
  normalize3(zx, zy, zz);
  float xx = upy * zz - upz * zy, xy = upz * zx - upx * zz,
        xz = upx * zy - upy * zx;
  normalize3(xx, xy, xz);
  float yx = zy * xz - zz * xy, yy = zz * xx - zx * xz, yz = zx * xy - zy * xx;
  normalize3(yx, yy, yz);
  x = xx * lx + yx * ly + zx * lz;
  y = xy * lx + yy * ly + zy * lz;
  z = xz * lx + yz * ly + zz * lz;
}

#ifdef SPECTRAL_FX
constexpr float kDLine = 587.6f;  // nm: the IOR's wavelength without a hero bin

// World-space checker albedo factor (integrator.checker_factor's op
// order): cells of side `scale` alternate 1 and `low` by the parity of
// the floored coordinates; scale == 0 is untextured.
__device__ __forceinline__ float checker_factor(float x, float y, float z,
                                                float scale, float low) {
  const float inv = 1.0f / scale;  // scale == 0: inf, masked below
  const float p = floorf(x * inv) + floorf(y * inv) + floorf(z * inv);
  const bool odd = (p - 2.0f * floorf(p * 0.5f)) != 0.0f;
  return scale > 0.0f ? (odd ? low : 1.0f) : 1.0f;
}

// The dielectric (ops/sampling.py:refract_or_reflect, op for op): Snell
// refraction of d at the outward normal n and index n_lam, the Schlick
// reflectance with its fifth power as products, and total internal
// reflection. rf in [0, 1) picks reflection with the reflectance's
// probability. Out: the (unnormalized) direction, whether it reflects,
// and the normal oriented against d.
__device__ __forceinline__ void refract_or_reflect(
    float dx, float dy, float dz, float nx, float ny, float nz, float n_lam,
    float rf, float& x, float& y, float& z, float& nox, float& noy,
    float& noz, bool& reflects) {
  const float cosi_signed = -(dx * nx + dy * ny + dz * nz);
  const bool entering = cosi_signed > 0.0f;
  const float sgn = entering ? 1.0f : -1.0f;
  nox = nx * sgn;
  noy = ny * sgn;
  noz = nz * sgn;
  const float cosi = fabsf(cosi_signed);
  const float eta = entering ? 1.0f / n_lam : n_lam;
  const float k = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const float cos_t = sqrtf(max0(k));
  const float q = (n_lam - 1.0f) / (n_lam + 1.0f);
  const float r0 = q * q;
  const float m = 1.0f - (entering ? cosi : cos_t);
  const float m2 = m * m;
  const float fresnel = r0 + (1.0f - r0) * (m2 * m2 * m);
  reflects = (k < 0.0f) || (rf < fresnel);
  if (reflects) {  // the mirror about the oriented normal
    const float k2 = 2.0f * (nox * dx + noy * dy + noz * dz);
    x = dx - nox * k2;
    y = dy - noy * k2;
    z = dz - noz * k2;
  } else {
    const float c = eta * cosi - cos_t;
    x = dx * eta + nox * c;
    y = dy * eta + noy * c;
    z = dz * eta + noz * c;
  }
}
#endif

// A lane's S spectral bins in the block's shared memory, lane-minor: bin
// s of thread t at base[s * BLOCK + t], so that a warp's 32 threads read
// 32 consecutive words of one bin (no bank conflicts). Indexed like the
// register array it stands in for.
struct SharedBins {
  float* p;  // this thread's bin 0
  __device__ __forceinline__ float& operator[](int s) const { return p[s * BLOCK]; }
};

// The S whose regen and mono kernels have a build with the lanes'
// radiance bins in shared memory (regen.cu, mono.cu), and the bytes those
// bins take after the tables: [S][BLOCK] floats (none in the register
// build).
constexpr int kSharedBinsSamples = 64;
constexpr size_t shared_bins_bytes(int S, bool shared) {
  return shared ? sizeof(float) * (size_t)S * BLOCK : 0;
}

// The carried lane state of `make_body.bounce` (megakernel.py:1928-1935,
// :2001-2006): the ray, the flags, the count-down bounce budget, the frame
// of the path in flight, and the spectral throughput and radiance. Every
// kernel runs its lanes through `bounce_step` on this one struct. The
// spectral throughput and radiance are S floats each of registers, or
// (SHARED_THR, SHARED_RAD) rows of the block's shared memory: both in
// persist.cu, the radiance alone in the S = 64 builds of regen.cu and
// mono.cu; the same arithmetic either way.
template <int S, bool SHARED_THR = false, bool SHARED_RAD = SHARED_THR>
struct Lane {
  float ox, oy, oz, dx, dy, dz;
  bool alive;     // a path is in flight
  bool gate;      // the parent bounce was specular
  float hero;     // hero wavelength bin, -1 until a dispersive event
  int bl;         // bounces left: max_bounces at a path's first trace
  uint32_t fid;   // frame id of the path in flight
  std::conditional_t<SHARED_THR, SharedBins, float[S]> thr;
  std::conditional_t<SHARED_RAD, SharedBins, float[S]> rad;
};

// A new path of frame `fid` from (o, d) at unit throughput; the radiance
// sum is kept (the restart rule of megakernel.py:1549-1552, :1752-1769).
template <int S, bool ST, bool SR>
__device__ __forceinline__ void start_path(Lane<S, ST, SR>& L, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, uint32_t fid,
                                           int max_bounces) {
  L.ox = ox;
  L.oy = oy;
  L.oz = oz;
  L.dx = dx;
  L.dy = dy;
  L.dz = dz;
  L.alive = true;
  L.gate = false;
  L.hero = -1.0f;
  L.bl = max_bounces;
  L.fid = fid;
#pragma unroll
  for (int s = 0; s < S; ++s) L.thr[s] = 1.0f;
}

// Floats of one thread's staging slot (the material rows in global
// memory): its material's albedo, and in a feature build its emission and
// feature scalars; an odd stride, so a warp's slots fall in distinct banks.
__host__ __device__ constexpr int stage_stride(int S) {
#ifdef SPECTRAL_FX
  return 2 * S + MAT_FX_COLS;
#else
  return S + 1;
#endif
}

// The thread's staging slot: the slots lie just before the NEE scales
// (load_tables), so the address follows from tb.scale and holds no
// register of its own.
__device__ __forceinline__ float* stage_slot(const Tables& tb, int S) {
  return tb.scale - (BLOCK - (int)threadIdx.x) * stage_stride(S);
}

// One material row of S floats from global memory into a thread's
// staging slot of shared memory, four floats a load, one load in flight
// (the loop is not unrolled): the copy adds a few registers beside the
// thread's spectral state, where an unrolled copy would hold the row.
template <int S>
__device__ __forceinline__ void stage_row(float* slot, const float* row) {
#pragma unroll 1
  for (int i = 0; i < S; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + i));
    slot[i] = v.x;
    slot[i + 1] = v.y;
    slot[i + 2] = v.z;
    slot[i + 3] = v.w;
  }
}

// One bounce iteration of a live lane (`make_body.bounce`): trace, add the
// hit's direct light to rad, and either set up the continuation ray
// (returns true) or end the path (returns false with alive cleared; the
// ray, gate, bl and thr stay as they were, like the reference's
// where(cont, ...)). The feature build adds, in the reference's order:
// the sky of a miss, the checker factor, the hero collapse, emission
// (added before the direct light: its lanes and the sky's are disjoint
// from each other, so the order of the three sums is the jnp one), and
// the dielectric continuation; a lane whose hero collapses keeps the
// collapsed thr even when its path ends, as the reference's does.
template <int S, bool MANY, bool TRI, bool ST, bool SR>
__device__ __forceinline__ bool bounce_step(const Tables& tb, Lane<S, ST, SR>& L,
                                            uint32_t px, uint32_t py) {
  float t;
  const int win =
      trace_nearest<MANY, TRI>(tb, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, t);
#ifdef SPECTRAL_FX
  if (win < 0 && (tb.features & FX_SKY)) {
    // the escaping ray collects thr * sky (t is inf on a miss, so the
    // gate holds: a gated-out short hit collects none)
#pragma unroll
    for (int s = 0; s < S; ++s) L.rad[s] = L.rad[s] + L.thr[s] * tb.sky[s];
  }
#endif
  if (win < 0 || (L.gate && !(t > kSpecMin))) {  // miss or gated out
    L.alive = false;
    return false;
  }
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  const float ipx = L.ox + dx * t, ipy = L.oy + dy * t, ipz = L.oz + dz * t;
  float nx, ny, nz;
  surface_normal<TRI>(tb, win, ipx, ipy, ipz, L.ox, L.oy, L.oz, dx, dy, dz,
                      nx, ny, nz);
  const float metal = G(tb, G_METAL, win);
  const float rough = G(tb, G_ROUGH, win);
  // the material's albedo row: the winner's per-object albedo bit for bit
  const int mat = (int)G(tb, G_MATID, win);
  const float* alb = tb.mat_albedo + mat * S;
#ifdef SPECTRAL_FX
  // the material's feature row and emission, read like the albedo
  const float* mf = tb.mat_fx + mat * MAT_FX_COLS;
  const float* emis = tb.mat_emission + mat * S;
#endif
  if (tb.staged) {  // the rows stay in global memory
    float* slot = stage_slot(tb, S);
    stage_row<S>(slot, tb.g_albedo + mat * S);
    alb = slot;
#ifdef SPECTRAL_FX
    stage_row<S>(slot + S, tb.g_emission + mat * S);
    for (int c = 0; c < MAT_FX_COLS; ++c) slot[2 * S + c] = tb.g_fx[mat * MAT_FX_COLS + c];
    emis = slot + S;
    mf = slot + 2 * S;
#endif
  }
#ifdef SPECTRAL_FX
  const bool textured = (tb.features & FX_TEXTURE) != 0;
  const float texf =
      textured ? checker_factor(ipx, ipy, ipz, mf[MF_TEX_SCALE], mf[MF_TEX_LOW])
               : 1.0f;
#endif

  float rx, ry, rz;
  pcg3d(px, py, L.fid + (uint32_t)L.bl, rx, ry, rz);
  const bool spec = rz < metal;
#ifdef SPECTRAL_FX
  const bool trans = !spec && (tb.features & FX_TRANSMISSION) &&
                     rz < metal + mf[MF_TRANSMISSION];
  // the first dispersive refraction commits the path to one uniformly
  // chosen wavelength bin, with an S-fold weight on it
  const bool needs_hero = trans && mf[MF_CAUCHY] > 0.0f && L.hero < 0.0f;
  if (needs_hero) L.hero = (float)min((int)(ry * (float)S), S - 1);
  const int hero = (int)L.hero;
  const bool diffuse = !spec && !trans;
#else
  const bool diffuse = !spec;
#endif
  const float offx = ipx + nx * kOffset, offy = ipy + ny * kOffset,
              offz = ipz + nz * kOffset;

  if (diffuse) {
    // next-event estimation: per-light occlusion and scale
    const float cos_out = max0((-dx) * nx + (-dy) * ny + (-dz) * nz);
    for (int l = 0; l < tb.n_lights; ++l) {
      const float ldx = tb.lpos[4 * l] - offx;
      const float ldy = tb.lpos[4 * l + 1] - offy;
      const float ldz = tb.lpos[4 * l + 2] - offz;
      const float dist2 = dot3(ldx, ldy, ldz, ldx, ldy, ldz);
      const float dist = sqrtf(dist2);
      float lnx = ldx, lny = ldy, lnz = ldz;
      normalize3(lnx, lny, lnz);
      const bool blocked =
          shadow_blocked<MANY, TRI>(tb, offx, offy, offz, lnx, lny, lnz, dist);
      normalize3(lnx, lny, lnz);  // the reference re-normalizes
      const float cos_in = max0(lnx * nx + lny * ny + lnz * nz);
      const float scale = (cos_in * cos_out) / dist2;
      tb.scale[l * BLOCK + threadIdx.x] = blocked ? 0.0f : scale;
    }
  }

  const bool cont = L.bl > 1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
#ifdef SPECTRAL_FX
    float thr_s = L.thr[s];
    if (tb.features & FX_EMISSION) L.rad[s] = L.rad[s] + thr_s * emis[s];
    if (needs_hero) thr_s = (thr_s * (s == hero ? 1.0f : 0.0f)) * (float)S;
    const float ta = thr_s * (textured ? alb[s] * texf : alb[s]);
#else
    const float ta = L.thr[s] * alb[s];
#endif
    if (diffuse) {
      float direct = 0.0f;
      for (int l = 0; l < tb.n_lights; ++l) {
        direct = direct + tb.lspec[l * S + s] * tb.scale[l * BLOCK + threadIdx.x];
      }
      L.rad[s] = L.rad[s] + ta * direct;
    }
#ifdef SPECTRAL_FX
    L.thr[s] = cont ? ta : thr_s;
#else
    if (cont) L.thr[s] = ta;
#endif
  }
  if (!cont) {
    L.alive = false;
    return false;
  }

  // continuation ray
  float ndx, ndy, ndz;
  if (spec) {
    const float k = 2.0f * (nx * dx + ny * dy + nz * dz);
    ndx = dx - nx * k;
    ndy = dy - ny * k;
    ndz = dz - nz * k;
    if (rough >= 0.001f) sample_in_cone(ndx, ndy, ndz, rough, rx, ry);
    L.ox = offx;
    L.oy = offy;
    L.oz = offz;
#ifdef SPECTRAL_FX
  } else if (trans) {
    // the Cauchy index at the hero wavelength, from the scene's grid
    const float lam_um = (hero >= 0 ? tb.lambda[hero] : kDLine) * 1e-3f;
    const float n_lam = mf[MF_IOR] + mf[MF_CAUCHY] / (lam_um * lam_um);
    float nox, noy, noz;
    bool reflects;
    refract_or_reflect(dx, dy, dz, nx, ny, nz, n_lam, rx, ndx, ndy, ndz, nox,
                       noy, noz, reflects);
    // the child leaves on the side it goes to
    const float ox = nox * kOffset, oy = noy * kOffset, oz = noz * kOffset;
    L.ox = reflects ? ipx + ox : ipx - ox;
    L.oy = reflects ? ipy + oy : ipy - oy;
    L.oz = reflects ? ipz + oz : ipz - oz;
  } else if (tb.features & FX_SKY) {
    // sky scenes offset the diffuse child too: a self-hit there would
    // trade the sky for a bounce on one ulp
    cosine_hemisphere(rx, ry, nx, ny, nz, ndx, ndy, ndz);
    L.ox = offx;
    L.oy = offy;
    L.oz = offz;
#endif
  } else {
    cosine_hemisphere(rx, ry, nx, ny, nz, ndx, ndy, ndz);
    L.ox = ipx;  // the diffuse continuation starts UN-offset
    L.oy = ipy;
    L.oz = ipz;
  }
  normalize3(ndx, ndy, ndz);  // Ray::new normalizes
  L.dx = ndx;
  L.dy = ndy;
  L.dz = ndz;
  L.gate = spec;
  L.bl -= 1;
  return true;
}

// Van der Corput radical inverse (reference src/shader.rs:655-662).
__device__ __forceinline__ float radical_inverse(uint32_t bits) {
  return (float)__brev(bits) * kInv2_32;
}

// Free-running restart raygen: the primary direction of frame nf at
// pixel (px, py) from the 20-float camera basis (megakernel.py:1677-1713,
// table :2545-2572), in the op order of the plain twin
// render/camera.py:restart_directions, with 1/sqrtf where the TPU kernel
// takes rsqrt so that both compute the same bits.
__device__ __forceinline__ void restart_direction(const float* cb,
                                                  uint32_t px, uint32_t py,
                                                  uint32_t nf, float& x,
                                                  float& y, float& z) {
  const float focal = cb[CB_FOCAL], aspect = cb[CB_ASPECT];
  const float sx = 2.0f * (1.0f / cb[CB_WIDTH]) * aspect;
  const float sy = 2.0f * (1.0f / cb[CB_HEIGHT]);
  const float inv_n = 1.0f / cb[CB_FRAMES];
  const float off_x = ((float)nf + 0.5f) * inv_n;
  const float off_y = radical_inverse(nf + 1u);
  const float x_ndc = ((float)px + off_x) * sx - aspect;
  const float y_ndc = 1.0f - ((float)py + off_y) * sy;
  x = cb[CB_FWD] * focal - cb[CB_RIGHT] * x_ndc + cb[CB_UP] * y_ndc;
  y = cb[CB_FWD + 1] * focal - cb[CB_RIGHT + 1] * x_ndc + cb[CB_UP + 1] * y_ndc;
  z = cb[CB_FWD + 2] * focal - cb[CB_RIGHT + 2] * x_ndc + cb[CB_UP + 2] * y_ndc;
  normalize3(x, y, z);  // the reference normalizes in raygen AND in Ray::new
  normalize3(x, y, z);
}

// Which instantiation the tables take: the many-object loop above
// SMEM_OBJECTS objects or for a cluster plan, else the small-scene one.
inline bool many_objects(const TableArgs& a) {
  return a.n_obj > SMEM_OBJECTS || a.n_runs > 1;
}

// Floats of one material's rows: the albedo, and in a feature build the
// feature scalars and the emission.
constexpr int material_row_floats(int S) {
#ifdef SPECTRAL_FX
  return S + MAT_FX_COLS + S;
#else
  return S;
#endif
}

// Bytes of dynamic shared memory a block takes for these tables, in
// load_tables' order: the packed walk records first (16-byte aligned)
// when the host put them there, then the walk tables or the small scene's
// geometry, the material rows the host put there (mat_rows), the lights,
// in a feature build the wavelengths and the sky, the staging slots, and
// the NEE scales.
//
// The material rows go to shared memory while the whole table fits a
// block's MAX_SMEM (ops/megakernel.py:KernelTables.materials_shared).
// Beyond that (a scene with one material per object and a thousand objects
// at S = 64 holds 256 KB of albedo alone) they stay in global memory, and
// each bounce copies its material's rows into the thread's staging slot
// (stage_row), so the shading reads shared memory either way. The host
// decides and passes mat_rows and stage_floats; the kernels' layout is
// the one of a table that always holds its rows, sized by them: rows read
// through a pointer to either memory (a generic load), or a layout the
// block decided itself, each cost the persist and segment kernels 24-40
// registers (PERF.md section 6).
inline size_t smem_bytes(const TableArgs& a, int S) {
  const bool many = many_objects(a);
  const size_t walk = many ? (size_t)a.n_obj + (size_t)a.n_runs * RUN_COLS
                           : (size_t)GEOM_ROWS * a.n_obj;
  const size_t packed = many && a.packed_shared ? 4 * (size_t)a.n_packed : 0;
#ifdef SPECTRAL_FX
  const size_t fx = 2 * (size_t)S;
#else
  const size_t fx = 0;
#endif
  return sizeof(float) * (packed + walk + (size_t)a.mat_rows * material_row_floats(S) +
                          4 * (size_t)a.n_lights + (size_t)a.n_lights * S + fx +
                          (size_t)a.stage_floats + (size_t)a.n_lights * BLOCK);
}

// The block's cooperative copy of the tables into shared memory: the
// geometry of a small scene, the walk tables (and the packed records,
// where they fit) of a many-object one, and the material rows the host
// put there (mat_rows).
template <bool MANY>
__device__ __forceinline__ Tables load_tables(float* smem, const TableArgs& a,
                                              int S) {
  Tables tb;
  float* p = smem;
  if constexpr (MANY) {
    tb.geom = a.geom;
    tb.packed = a.packed;
    if (a.packed_shared) {
      float4* s_packed = reinterpret_cast<float4*>(p);
      for (int i = threadIdx.x; i < a.n_packed; i += blockDim.x) s_packed[i] = a.packed[i];
      tb.packed = s_packed;
      p += 4 * a.n_packed;
    }
    int* s_order = reinterpret_cast<int*>(p);
    for (int i = threadIdx.x; i < a.n_obj; i += blockDim.x) s_order[i] = a.order[i];
    p += a.n_obj;
    for (int i = threadIdx.x; i < a.n_runs * RUN_COLS; i += blockDim.x) p[i] = a.runs[i];
    tb.order = s_order;
    tb.runs = p;
    p += a.n_runs * RUN_COLS;
  } else {
    for (int i = threadIdx.x; i < GEOM_ROWS * a.n_obj; i += blockDim.x) p[i] = a.geom[i];
    tb.geom = p;
    tb.order = nullptr;
    tb.runs = nullptr;
    tb.packed = nullptr;
    p += GEOM_ROWS * a.n_obj;
  }
  float* s_alb = p;
  p += a.mat_rows * S;
  float* s_lpos = p;
  p += 4 * a.n_lights;
  float* s_lspec = p;
  p += a.n_lights * S;
  for (int i = threadIdx.x; i < a.mat_rows * S; i += blockDim.x) s_alb[i] = a.mat_albedo[i];
  for (int i = threadIdx.x; i < 4 * a.n_lights; i += blockDim.x) s_lpos[i] = a.lpos[i];
  for (int i = threadIdx.x; i < a.n_lights * S; i += blockDim.x) s_lspec[i] = a.lspec[i];
#ifdef SPECTRAL_FX
  float* s_fx = p;
  p += a.mat_rows * MAT_FX_COLS;
  float* s_emis = p;
  p += a.mat_rows * S;
  float* s_lambda = p;
  p += S;
  float* s_sky = p;
  p += S;
  for (int i = threadIdx.x; i < a.mat_rows * MAT_FX_COLS; i += blockDim.x) s_fx[i] = a.mat_fx[i];
  for (int i = threadIdx.x; i < a.mat_rows * S; i += blockDim.x) s_emis[i] = a.mat_emission[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_lambda[i] = a.lambda[i];
    s_sky[i] = a.sky[i];
  }
  tb.features = a.features;
  tb.mat_fx = s_fx;
  tb.mat_emission = s_emis;
  tb.g_fx = a.mat_fx;
  tb.g_emission = a.mat_emission;
  tb.lambda = s_lambda;
  tb.sky = s_sky;
#endif
#ifdef SPECTRAL_STATS
  for (int i = 0; i < WALK_STATS; ++i) walk_slots()[i * BLOCK + threadIdx.x] = 0u;
#endif
  p += a.stage_floats;  // the staging slots (stage_slot)
  __syncthreads();
  tb.mat_albedo = s_alb;
  tb.g_albedo = a.mat_albedo;
  tb.staged = a.stage_floats > 0;
  tb.lpos = s_lpos;
  tb.lspec = s_lspec;
  tb.scale = p;
  tb.n_obj = a.n_obj;
  tb.n_runs = a.n_runs;
  tb.n_lights = a.n_lights;
  tb.smooth = a.tri == 2;
  return tb;
}

#ifdef SPECTRAL_STATS
// The diagnostic build's per-thread record (tools/lane_stats.py binds
// the buffers with spectral_stats_bind): each thread's live bounce
// iterations, pixels finished, start and end time (globaltimer, ns) and
// walk counters, and each block's SM. Threads are numbered blockIdx.x *
// BLOCK + threadIdx.x.
struct StatsBuf {
  unsigned* iters;
  unsigned* pixels;
  unsigned long long* t0;
  unsigned long long* t1;
  unsigned* smid;
  unsigned* walk;  // [WALK_STATS][threads]
  int threads;
};
__device__ StatsBuf g_stats;

__device__ __forceinline__ unsigned long long stats_clock() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stats_begin() {
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  if (tid >= g_stats.threads) return;
  g_stats.t0[tid] = stats_clock();
  if (threadIdx.x == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    g_stats.smid[blockIdx.x] = id;
  }
}

__device__ __forceinline__ void stats_end(unsigned iters, unsigned pixels) {
  const int tid = blockIdx.x * BLOCK + threadIdx.x;
  if (tid >= g_stats.threads) return;
  g_stats.t1[tid] = stats_clock();
  g_stats.iters[tid] = iters;
  g_stats.pixels[tid] = pixels;
  for (int i = 0; i < WALK_STATS; ++i) {
    g_stats.walk[(size_t)i * g_stats.threads + tid] = walk_slots()[i * BLOCK + threadIdx.x];
  }
}
#endif

// Checks every launch shares: the table sizes, and the shared memory the
// tables take, plus `extra` bytes after them (persist.cu's spectral
// state), raised above 48 KB for the kernel when needed.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, const TableArgs& a, int S, size_t& smem,
                    size_t extra = 0) {
  if (a.n_obj < 1 || a.n_runs < 1 || a.n_mat < 1 ||
      a.n_lights < 0 || a.tri < 0 || a.tri > 2 || a.n_packed < 0 ||
      (a.n_packed > 0 && a.packed == nullptr) ||
      !((a.mat_rows == a.n_mat && a.stage_floats == 0) ||
        (a.mat_rows == 0 && a.stage_floats == BLOCK * stage_stride(S)))) {
    return cudaErrorInvalidValue;
  }
#ifdef SPECTRAL_FX
  // a feature build takes feature scenes only (the host loads the build
  // without features for the others)
  if (a.features <= 0 || a.features > (FX_TRANSMISSION | FX_EMISSION | FX_TEXTURE | FX_SKY) ||
      a.mat_fx == nullptr || a.mat_emission == nullptr || a.lambda == nullptr ||
      a.sky == nullptr) {
    return cudaErrorInvalidValue;
  }
#endif
  smem = smem_bytes(a, S) + extra;
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

// The next lane index for every calling thread of a resident grid: one
// atomicAdd per group of threads that ask together, each taking its
// rank's index.
__device__ __forceinline__ int next_lane(unsigned* counter, int first) {
  namespace cg = cooperative_groups;
  const cg::coalesced_group g = cg::coalesced_threads();
  const unsigned rank = (unsigned)g.thread_rank();
  unsigned base = 0;
  if (rank == 0) base = atomicAdd(counter, (unsigned)g.size());
  base = g.shfl(base, 0);
  return first + (int)(base + rank);
}

// The resident grid of `kernel` for n lanes at `smem` bytes: as many
// blocks as the card holds at once (the occupancy API), no more than the
// lanes need. Zeroes `counter` on the stream: the kernel's threads start
// on lanes blockIdx.x * BLOCK + threadIdx.x and take the next ones from
// gridDim.x * BLOCK on (next_lane).
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, size_t smem, int n, unsigned* counter,
                          cudaStream_t stream, int& blocks) {
  blocks = (n + BLOCK - 1) / BLOCK;
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = blocks < per_sm * sms ? blocks : per_sm * sms;
  return cudaMemsetAsync(counter, 0, sizeof(unsigned), stream);
}

// The S a library builds with triangles (runtime/build.py): 8 and 32 in
// the default libraries, 16 and 64 in the -DSPECTRAL_TRI_WIDE ones (which
// hold nothing else), every S in the opt-in lens and shadow-interval ones
// (-DSPECTRAL_TRI_ALL).
template <int S>
constexpr bool tri_built() {
#if defined(SPECTRAL_TRI_ALL)
  return true;
#elif defined(SPECTRAL_TRI_WIDE)
  return S == 16 || S == 64;
#else
  return S == 8 || S == 32;
#endif
}

// The many-object loop alone: a shadow-interval library (the host
// refuses the option for a small scene).
#ifdef SPECTRAL_SHADOW_INTERVAL
constexpr bool kSmallLoopBuilt = false;
#else
constexpr bool kSmallLoopBuilt = true;
#endif

// The instantiation the tables take, as
// launch(std::bool_constant<MANY>{}, std::bool_constant<TRI>{}): MANY
// from many_objects, TRI when the scene has triangles; tables this
// library has no instantiation for (a triangle scene at an S it does not
// build, any scene without triangles in a wide triangle library, a small
// scene in a shadow-interval library) are refused, never run on another.
template <int S, typename Launch>
cudaError_t dispatch_tables(const TableArgs& ta, Launch&& launch) {
  const bool many = many_objects(ta);
  if (!many && !kSmallLoopBuilt) return cudaErrorInvalidValue;
  if (ta.tri != 0) {
    if constexpr (tri_built<S>()) {
      if constexpr (kSmallLoopBuilt) {
        if (!many) return launch(std::false_type{}, std::true_type{});
      }
      return launch(std::true_type{}, std::true_type{});
    } else {
      return cudaErrorInvalidValue;
    }
  }
#ifdef SPECTRAL_TRI_WIDE
  return cudaErrorInvalidValue;
#else
  if constexpr (kSmallLoopBuilt) {
    if (!many) return launch(std::false_type{}, std::false_type{});
  }
  return launch(std::true_type{}, std::false_type{});
#endif
}

}  // namespace
}  // namespace spectral

// The table arguments every C entry point takes, in this order; a
// feature build takes the feature mask and tables after them.
#ifdef SPECTRAL_FX
#define SPECTRAL_FX_PARAMS                                                  \
  , int features, const void *mat_fx, const void *mat_emission,             \
      const void *lambda, const void *sky
#define SPECTRAL_FX_ARGS                                                    \
  , features, static_cast<const float*>(mat_fx),                            \
      static_cast<const float*>(mat_emission),                              \
      static_cast<const float*>(lambda), static_cast<const float*>(sky)
#else
#define SPECTRAL_FX_PARAMS
#define SPECTRAL_FX_ARGS
#endif
#define SPECTRAL_TABLE_PARAMS                                               \
  int n_obj, int n_mat, int n_runs, int n_lights, int tri, int n_packed,   \
      int packed_shared, int mat_rows, int stage_floats,                   \
      const void *geom, const void *mat_albedo,                            \
      const void *order, const void *runs, const void *lpos,               \
      const void *lspec, const void *packed SPECTRAL_FX_PARAMS
#define SPECTRAL_TABLE_ARGS                                                 \
  spectral::TableArgs {                                                     \
    static_cast<const float*>(geom), static_cast<const float*>(mat_albedo), \
        static_cast<const int*>(order), static_cast<const float*>(runs),    \
        static_cast<const float*>(lpos), static_cast<const float*>(lspec),  \
        static_cast<const float4*>(packed), n_obj, n_mat, n_runs, n_lights, \
        tri, n_packed, packed_shared, mat_rows, stage_floats SPECTRAL_FX_ARGS \
  }

#ifdef SPECTRAL_STATS
// Binds the diagnostic build's per-thread buffers (StatsBuf order) for
// the next launches of this library's kernels.
extern "C" int spectral_stats_bind(void* iters, void* pixels, void* t0,
                                   void* t1, void* smid, void* walk,
                                   int threads) {
  const spectral::StatsBuf b{
      static_cast<unsigned*>(iters), static_cast<unsigned*>(pixels),
      static_cast<unsigned long long*>(t0), static_cast<unsigned long long*>(t1),
      static_cast<unsigned*>(smid), static_cast<unsigned*>(walk), threads};
  return (int)cudaMemcpyToSymbol(spectral::g_stats, &b, sizeof(b));
}
#endif

// Registers, local memory and resident blocks per SM of one kernel
// instantiation at `smem` bytes of dynamic shared memory:
// out = {blocks per SM, registers per thread, local bytes per thread}.
template <typename Kernel>
cudaError_t spectral_kernel_info(Kernel kernel, int smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, spectral::BLOCK,
                                                      (size_t)smem);
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return err;
}
