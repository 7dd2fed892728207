// Spectral path-tracing bounce kernels for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_mono    <- `run` -> `kernel` (pallas_call at :2127, body :1845 via
//                   `_trace_tile` :1803): one progressive frame from the
//                   given primary rays, the whole bounce loop resident.
//   cuda_regen   <- `run_regen` -> `kernel_regen` (pallas_call at :2171, body
//                   :1894): K frames per launch; a lane whose path ends starts
//                   its pixel's next frame, and the output is the SUM of the
//                   K frames' radiance.
//   cuda_persist <- `run_persist` -> `kernel_persist` / `_persist_core`
//                   (pallas_call at :2246, body :1941-2069): exactly `budget`
//                   bounce iterations over lane state carried in HBM between
//                   launches, in three variants: the primary-direction ring,
//                   free-running (in-kernel restart raygen), and
//                   free-running with a host stop mask (adaptive sampling).
//   cuda_cost    <- `run_cost` -> `kernel_cost` (pallas_call at :2302, body
//                   :1868): cuda_mono plus each lane's live iteration count.
// All four run one per-iteration step, `bounce_step`, over one lane-state
// struct, as the four Pallas entry points share `make_body.bounce` (:1313),
// with its unrolled object loop for scenes of up to 64 objects:
// `_candidate_t` (:554), `trace_tile` (:605) and `shadow_blocked` (:714).
//
// Design. One thread per pixel-lane runs its own paths, in a block of 128
// threads, masked by gidx < n; a warp retires lanes on its own, so the TPU
// kernel's fixed iteration count and tile-wide all-dead guards are not
// needed. The per-object, per-lambda and light tables (at most 64 objects)
// are loaded into shared memory at block start, and the winner's albedo
// row is indexed directly. The spectral state thr[S] and rad[S] lives in
// registers, the kernels templated on S in {8,16,32,64}.
//
// Numerics. The arithmetic follows the torch-eager bounce loop
// (spectral_tpu_torch/render/integrator.py) op for op: the reference-exact
// division form of the quadratic and slabs, the lowest-index tie rule
// (forward loop, strict <), normalize as v * (1 / sqrtf(v.v)), the asin form
// of the cosine sampler, PCG3D seeded with (px, py, frame + bounces_left).
// The diffuse continuation starts from the UN-offset hit point, so one ulp
// decides a self-hit: the file is built with -fmad=false and without
// --use_fast_math, so no FMA contraction or approximate division/sqrt
// flips those coins where the plain version does not.
//
// What bounds it on the H100: divergent FP32 ALU work per lane (per bounce,
// every object is tested twice, for the nearest hit and the shadow ray,
// plus S-wide shading) and register pressure from the 2*S floats of
// spectral state. cuda_mono, cuda_cost and cuda_regen read the primary rays
// and write [S, n] radiance once, so HBM is not the limit.
// cuda_persist is bounded the same way; its extra traffic is the state
// round trip, (13 + 2S) * 4 B per lane per launch (about 80 MB at 512^2,
// S = 32), noise beside the ~64 frames of bounce work a launch carries.
// Its design: the state is loaded once into registers (the [S, n] planes
// are lane-minor, so the loads coalesce) and stored once; a lane that is
// dead and cannot restart leaves its loop, the exact per-thread form of the
// TPU kernel's tile skip; a ring restart reads its direction plane by
// slot, and a free-running one recomputes raygen from the basis table in
// shared memory. Making them fast (occupancy tuning, wavefront compaction
// of live lanes, FMA) is later work, measured against these.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "megakernel.cuh"

namespace spectral {
namespace {

constexpr float kOffset = 1e-5f;        // reference src/shader.rs:8
constexpr float kSpecMin = 1e-4f;       // reference src/shader.rs:14
constexpr float kDelta = 1e-5f;         // reference src/shader.rs:7
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kInv2_32 = 2.3283064365386963e-10f;

struct Tables {
  const float* geom;    // [GEOM_ROWS][n_obj]
  const float* albedo;  // [n_obj][S]
  const float* lpos;    // [n_lights][4]
  const float* lspec;   // [n_lights][S]
  float* scale;         // [n_lights][BLOCK] this thread's NEE scales
  int n_obj;
  int n_lights;
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

// Candidate hit of object o (reference src/shader.rs:508-560): valid and
// t > 0. One definition for the nearest-hit trace and the shadow test.
__device__ __forceinline__ bool candidate_t(const Tables& tb, int o, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& t) {
  const int type = (int)G(tb, G_TYPE, o);
  bool valid;
  if (type == OBJ_SPHERE) {
    const float ocx = ox - G(tb, G_SPHERE_POS, o);
    const float ocy = oy - G(tb, G_SPHERE_POS + 1, o);
    const float ocz = oz - G(tb, G_SPHERE_POS + 2, o);
    const float r = G(tb, G_RADIUS, o);
    const float a = dot3(dx, dy, dz, dx, dy, dz);
    const float b = 2.0f * dot3(ocx, ocy, ocz, dx, dy, dz);
    const float c = dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r;
    const float disc = b * b - 4.0f * a * c;
    const float sq = sqrtf(max0(disc));
    const float t1 = (-b - sq) / (2.0f * a);
    const float t2 = (-b + sq) / (2.0f * a);
    t = t1 >= 0.0f ? t1 : t2;
    valid = (disc >= 0.0f) && (t >= 0.0f);
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

__device__ __forceinline__ int trace_nearest(const Tables& tb, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz,
                                             float& t_best) {
  t_best = INFINITY;
  int win = -1;
  for (int o = 0; o < tb.n_obj; ++o) {
    float t;
    if (candidate_t(tb, o, ox, oy, oz, dx, dy, dz, t) && t < t_best) {
      t_best = t;  // strict <: the lowest index wins ties
      win = o;
    }
  }
  return win;
}

// Nearest positive hit within max_dist (reference src/shader.rs:484-489).
__device__ __forceinline__ bool shadow_blocked(const Tables& tb, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               float max_dist) {
  for (int o = 0; o < tb.n_obj; ++o) {
    float t;
    if (candidate_t(tb, o, ox, oy, oz, dx, dy, dz, t) && t <= max_dist &&
        t < INFINITY) {
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ float box_axis(float p, float lo, float hi) {
  return fabsf(p - lo) < kDelta ? -1.0f : (fabsf(p - hi) < kDelta ? 1.0f : 0.0f);
}

// Surface normal of object o at ip (reference src/shader.rs:366-378, 582-650).
__device__ __forceinline__ void surface_normal(const Tables& tb, int o,
                                               float ipx, float ipy, float ipz,
                                               float& nx, float& ny,
                                               float& nz) {
  const int type = (int)G(tb, G_TYPE, o);
  if (type == OBJ_SPHERE) {
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

// The carried lane state of `make_body.bounce` (megakernel.py:1928-1935,
// :2001-2006): the ray, the flags, the count-down bounce budget, the frame
// of the path in flight, and the spectral throughput and radiance. Every
// kernel below runs its lanes through `bounce_step` on this one struct.
template <int S>
struct Lane {
  float ox, oy, oz, dx, dy, dz;
  bool alive;     // a path is in flight
  bool gate;      // the parent bounce was specular
  float hero;     // hero wavelength bin, -1 until a dispersive event
  int bl;         // bounces left: max_bounces at a path's first trace
  uint32_t fid;   // frame id of the path in flight
  float thr[S];
  float rad[S];
};

// A new path of frame `fid` from (o, d) at unit throughput; the radiance
// sum is kept (the restart rule of megakernel.py:1549-1552, :1752-1769).
template <int S>
__device__ __forceinline__ void start_path(Lane<S>& L, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, uint32_t fid,
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

// One bounce iteration of a live lane (`make_body.bounce`): trace, add the
// hit's direct light to rad, and either set up the continuation ray
// (returns true) or end the path (returns false with alive cleared; the
// ray, gate, bl and thr stay as they were, like the reference's
// where(cont, ...)).
template <int S>
__device__ __forceinline__ bool bounce_step(const Tables& tb, Lane<S>& L,
                                            uint32_t px, uint32_t py) {
  float t;
  const int win = trace_nearest(tb, L.ox, L.oy, L.oz, L.dx, L.dy, L.dz, t);
  if (win < 0 || (L.gate && !(t > kSpecMin))) {  // miss or gated out
    L.alive = false;
    return false;
  }
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  const float ipx = L.ox + dx * t, ipy = L.oy + dy * t, ipz = L.oz + dz * t;
  float nx, ny, nz;
  surface_normal(tb, win, ipx, ipy, ipz, nx, ny, nz);
  const float metal = G(tb, G_METAL, win);
  const float rough = G(tb, G_ROUGH, win);
  const float* alb = tb.albedo + win * S;

  float rx, ry, rz;
  pcg3d(px, py, L.fid + (uint32_t)L.bl, rx, ry, rz);
  const bool spec = rz < metal;
  const float offx = ipx + nx * kOffset, offy = ipy + ny * kOffset,
              offz = ipz + nz * kOffset;

  if (!spec) {
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
          shadow_blocked(tb, offx, offy, offz, lnx, lny, lnz, dist);
      normalize3(lnx, lny, lnz);  // the reference re-normalizes
      const float cos_in = max0(lnx * nx + lny * ny + lnz * nz);
      const float scale = (cos_in * cos_out) / dist2;
      tb.scale[l * BLOCK + threadIdx.x] = blocked ? 0.0f : scale;
    }
  }

  const bool cont = L.bl > 1;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float ta = L.thr[s] * alb[s];
    if (!spec) {
      float direct = 0.0f;
      for (int l = 0; l < tb.n_lights; ++l) {
        direct = direct + tb.lspec[l * S + s] * tb.scale[l * BLOCK + threadIdx.x];
      }
      L.rad[s] = L.rad[s] + ta * direct;
    }
    if (cont) L.thr[s] = ta;
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

__device__ __forceinline__ Tables load_tables(float* smem, const float* geom,
                                              const float* albedo,
                                              const float* lpos,
                                              const float* lspec, int n_obj,
                                              int n_lights, int S) {
  Tables tb;
  float* s_geom = smem;
  float* s_alb = s_geom + GEOM_ROWS * n_obj;
  float* s_lpos = s_alb + n_obj * S;
  float* s_lspec = s_lpos + 4 * n_lights;
  for (int i = threadIdx.x; i < GEOM_ROWS * n_obj; i += blockDim.x) s_geom[i] = geom[i];
  for (int i = threadIdx.x; i < n_obj * S; i += blockDim.x) s_alb[i] = albedo[i];
  for (int i = threadIdx.x; i < 4 * n_lights; i += blockDim.x) s_lpos[i] = lpos[i];
  for (int i = threadIdx.x; i < n_lights * S; i += blockDim.x) s_lspec[i] = lspec[i];
  __syncthreads();
  tb.geom = s_geom;
  tb.albedo = s_alb;
  tb.lpos = s_lpos;
  tb.lspec = s_lspec;
  tb.scale = s_lspec + n_lights * S;
  tb.n_obj = n_obj;
  tb.n_lights = n_lights;
  return tb;
}

// cuda_mono (COST = false) and cuda_cost (COST = true): one path per lane
// from the given primaries. The cost variant also stores the lane's live
// iteration count, max_bounces + 1 - bl with bl frozen at death
// (megakernel.py:1887-1892); its radiance is cuda_mono's bit for bit.
template <int S, bool COST>
__global__ void __launch_bounds__(BLOCK)
mono_kernel(int n, int n_obj, int n_lights, int max_bounces, uint32_t frame_id,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const int* __restrict__ px, const int* __restrict__ py,
            const float* __restrict__ geom, const float* __restrict__ albedo,
            const float* __restrict__ lpos, const float* __restrict__ lspec,
            float* __restrict__ out, float* __restrict__ cost) {
  extern __shared__ float smem[];
  const Tables tb =
      load_tables(smem, geom, albedo, lpos, lspec, n_obj, n_lights, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;
  Lane<S> L;
  start_path(L, ox[gidx], oy[gidx], oz[gidx], dx[gidx], dy[gidx], dz[gidx],
             frame_id, max_bounces);
#pragma unroll
  for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
  const uint32_t ux = (uint32_t)px[gidx], uy = (uint32_t)py[gidx];
  while (bounce_step(tb, L, ux, uy)) {
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = L.rad[s];
  if constexpr (COST) cost[gidx] = (float)(max_bounces + 1) - (float)L.bl;
}

template <int S>
__global__ void __launch_bounds__(BLOCK)
regen_kernel(int n, int n_obj, int n_lights, int max_bounces,
             uint32_t first_frame, int k, const float* __restrict__ ox,
             const float* __restrict__ oy, const float* __restrict__ oz,
             const float* __restrict__ dx, const float* __restrict__ dy,
             const float* __restrict__ dz, const int* __restrict__ px,
             const int* __restrict__ py, const float* __restrict__ cam,
             const float* __restrict__ dirx, const float* __restrict__ diry,
             const float* __restrict__ dirz, const float* __restrict__ geom,
             const float* __restrict__ albedo, const float* __restrict__ lpos,
             const float* __restrict__ lspec, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Tables tb =
      load_tables(smem, geom, albedo, lpos, lspec, n_obj, n_lights, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;
  const uint32_t ux = (uint32_t)px[gidx], uy = (uint32_t)py[gidx];
  Lane<S> L;
  start_path(L, ox[gidx], oy[gidx], oz[gidx], dx[gidx], dy[gidx], dz[gidx],
             first_frame, max_bounces);
#pragma unroll
  for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
  // frame 0 from the given primaries; when a path ends, frame j starts
  // from the camera origin and the host-precomputed direction plane j-1;
  // the K radiances are summed in frame order
  for (int j = 1;;) {
    if (bounce_step(tb, L, ux, uy)) continue;
    if (j == k) break;
    const size_t at = (size_t)(j - 1) * n + gidx;
    start_path(L, cam[0], cam[1], cam[2], dirx[at], diry[at], dirz[at],
               first_frame + (uint32_t)j, max_bounces);
    ++j;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = L.rad[s];
}

// cuda_persist: exactly `budget` bounce iterations over the carried lane
// state, updated in place. A lane whose path ends (or that idles) starts
// its pixel's next frame nf = fid + 1 when nf < end, and also nf < lead
// (RING) and its stop flag is clear (STOP); the restart uses the
// iteration. A lane that is dead and not restartable stays so for the
// rest of the launch (lead, end and stop are launch constants), so it
// leaves its loop: the per-thread form of the TPU kernel's tile skip.
template <int S, bool RING, bool STOP>
__global__ void __launch_bounds__(BLOCK)
persist_kernel(int n, int n_obj, int n_lights, int max_bounces, int budget,
               uint32_t lead, uint32_t end, int ring_w,
               float* __restrict__ ox, float* __restrict__ oy,
               float* __restrict__ oz, float* __restrict__ dx,
               float* __restrict__ dy, float* __restrict__ dz,
               float* __restrict__ alive, float* __restrict__ gate,
               float* __restrict__ hero, int* __restrict__ bl,
               int* __restrict__ fid, const int* __restrict__ px,
               const int* __restrict__ py, const float* __restrict__ stop,
               const float* __restrict__ cam, const float* __restrict__ ringx,
               const float* __restrict__ ringy,
               const float* __restrict__ ringz,
               const float* __restrict__ geom,
               const float* __restrict__ albedo,
               const float* __restrict__ lpos,
               const float* __restrict__ lspec, float* __restrict__ thr,
               float* __restrict__ rad) {
  extern __shared__ float smem[];
  __shared__ float s_cam[CAM_BASIS];
  constexpr int cam_len = RING ? 3 : CAM_BASIS;
  if (threadIdx.x < cam_len) s_cam[threadIdx.x] = cam[threadIdx.x];
  const Tables tb =  // its __syncthreads also publishes s_cam
      load_tables(smem, geom, albedo, lpos, lspec, n_obj, n_lights, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;

  Lane<S> L;
  L.ox = ox[gidx];
  L.oy = oy[gidx];
  L.oz = oz[gidx];
  L.dx = dx[gidx];
  L.dy = dy[gidx];
  L.dz = dz[gidx];
  L.alive = alive[gidx] > 0.0f;
  L.gate = gate[gidx] > 0.0f;
  L.hero = hero[gidx];
  L.bl = bl[gidx];
  L.fid = (uint32_t)fid[gidx];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    L.thr[s] = thr[(size_t)s * n + gidx];
    L.rad[s] = rad[(size_t)s * n + gidx];
  }
  const uint32_t ux = (uint32_t)px[gidx], uy = (uint32_t)py[gidx];
  const bool stopped = STOP && stop[gidx] > 0.0f;

  for (int it = 0; it < budget; ++it) {
    if (L.alive && bounce_step(tb, L, ux, uy)) continue;
    const uint32_t nf = L.fid + 1u;
    if (!(nf < end) || (RING && !(nf < lead)) || stopped) break;
    float rdx, rdy, rdz;
    if constexpr (RING) {
      const size_t at = (size_t)(nf & (uint32_t)(ring_w - 1)) * n + gidx;
      rdx = ringx[at];
      rdy = ringy[at];
      rdz = ringz[at];
    } else {
      restart_direction(s_cam, ux, uy, nf, rdx, rdy, rdz);
    }
    start_path(L, s_cam[CB_POS], s_cam[CB_POS + 1], s_cam[CB_POS + 2], rdx,
               rdy, rdz, nf, max_bounces);
  }

  ox[gidx] = L.ox;
  oy[gidx] = L.oy;
  oz[gidx] = L.oz;
  dx[gidx] = L.dx;
  dy[gidx] = L.dy;
  dz[gidx] = L.dz;
  alive[gidx] = L.alive ? 1.0f : 0.0f;
  gate[gidx] = L.gate ? 1.0f : 0.0f;
  hero[gidx] = L.hero;
  bl[gidx] = L.bl;
  fid[gidx] = (int)L.fid;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    thr[(size_t)s * n + gidx] = L.thr[s];
    rad[(size_t)s * n + gidx] = L.rad[s];
  }
}

size_t smem_bytes(int n_obj, int n_lights, int S) {
  return sizeof(float) * ((size_t)GEOM_ROWS * n_obj + (size_t)n_obj * S +
                          4 * (size_t)n_lights + (size_t)n_lights * S +
                          (size_t)n_lights * BLOCK);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  return cudaSuccess;
}

template <int S, bool COST>
cudaError_t launch_mono(int n, int n_obj, int n_lights, int max_bounces,
                        uint32_t frame_id, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const int* px, const int* py,
                        const float* geom, const float* albedo,
                        const float* lpos, const float* lspec, float* out,
                        float* cost, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_obj, n_lights, S);
  cudaError_t err = prepare(mono_kernel<S, COST>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  mono_kernel<S, COST><<<blocks, BLOCK, smem, stream>>>(
      n, n_obj, n_lights, max_bounces, frame_id, ox, oy, oz, dx, dy, dz, px,
      py, geom, albedo, lpos, lspec, out, cost);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_regen(int n, int n_obj, int n_lights, int max_bounces,
                         uint32_t first_frame, int k, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const int* px,
                         const int* py, const float* cam, const float* dirx,
                         const float* diry, const float* dirz,
                         const float* geom, const float* albedo,
                         const float* lpos, const float* lspec, float* out,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(n_obj, n_lights, S);
  cudaError_t err = prepare(regen_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  regen_kernel<S><<<blocks, BLOCK, smem, stream>>>(
      n, n_obj, n_lights, max_bounces, first_frame, k, ox, oy, oz, dx, dy, dz,
      px, py, cam, dirx, diry, dirz, geom, albedo, lpos, lspec, out);
  return cudaGetLastError();
}

// The persist kernel's planes, in the order of its parameters.
struct PersistArgs {
  float *ox, *oy, *oz, *dx, *dy, *dz, *alive, *gate, *hero;
  int *bl, *fid;
  const int *px, *py;
  const float *stop, *cam, *ringx, *ringy, *ringz;
  const float *geom, *albedo, *lpos, *lspec;
  float *thr, *rad;
};

template <int S, bool RING, bool STOP>
cudaError_t launch_persist(int n, int n_obj, int n_lights, int max_bounces,
                           int budget, uint32_t lead, uint32_t end,
                           int ring_w, const PersistArgs& a,
                           cudaStream_t stream) {
  const size_t smem = smem_bytes(n_obj, n_lights, S);
  cudaError_t err = prepare(persist_kernel<S, RING, STOP>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  persist_kernel<S, RING, STOP><<<blocks, BLOCK, smem, stream>>>(
      n, n_obj, n_lights, max_bounces, budget, lead, end, ring_w, a.ox, a.oy,
      a.oz, a.dx, a.dy, a.dz, a.alive, a.gate, a.hero, a.bl, a.fid, a.px,
      a.py, a.stop, a.cam, a.ringx, a.ringy, a.ringz, a.geom, a.albedo,
      a.lpos, a.lspec, a.thr, a.rad);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch_persist(int n, int n_obj, int n_lights, int max_bounces,
                             int budget, uint32_t lead, uint32_t end,
                             int ring_w, const PersistArgs& a,
                             cudaStream_t stream) {
  if (ring_w > 0) {
    return launch_persist<S, true, false>(n, n_obj, n_lights, max_bounces,
                                          budget, lead, end, ring_w, a, stream);
  }
  if (a.stop != nullptr) {
    return launch_persist<S, false, true>(n, n_obj, n_lights, max_bounces,
                                          budget, lead, end, 0, a, stream);
  }
  return launch_persist<S, false, false>(n, n_obj, n_lights, max_bounces,
                                         budget, lead, end, 0, a, stream);
}

}  // namespace
}  // namespace spectral

using spectral::dispatch_persist;
using spectral::launch_mono;
using spectral::launch_regen;

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)
#define SPECTRAL_INT(p) static_cast<const int*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success).
static int spectral_mono_or_cost(int n, int n_obj, int n_lights,
                                 int n_samples, int max_bounces,
                                 unsigned int frame_id, const void* ox,
                                 const void* oy, const void* oz,
                                 const void* dx, const void* dy,
                                 const void* dz, const void* px,
                                 const void* py, const void* geom,
                                 const void* albedo, const void* lpos,
                                 const void* lspec, void* out, void* cost,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 1 || n_obj > spectral::MAX_OBJECTS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_MONO(S, COST)                                               \
  return (int)launch_mono<S, COST>(                                          \
      n, n_obj, n_lights, max_bounces, frame_id, SPECTRAL_FLOAT(ox),         \
      SPECTRAL_FLOAT(oy), SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx),            \
      SPECTRAL_FLOAT(dy), SPECTRAL_FLOAT(dz), SPECTRAL_INT(px),              \
      SPECTRAL_INT(py), SPECTRAL_FLOAT(geom), SPECTRAL_FLOAT(albedo),        \
      SPECTRAL_FLOAT(lpos), SPECTRAL_FLOAT(lspec), static_cast<float*>(out), \
      static_cast<float*>(cost), st)
#define SPECTRAL_MONO_S(S) \
  if (cost != nullptr) SPECTRAL_MONO(S, true); else SPECTRAL_MONO(S, false)
  switch (n_samples) {
    case 8: SPECTRAL_MONO_S(8);
    case 16: SPECTRAL_MONO_S(16);
    case 32: SPECTRAL_MONO_S(32);
    case 64: SPECTRAL_MONO_S(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_MONO_S
#undef SPECTRAL_MONO
}

extern "C" int spectral_mono(int n, int n_obj, int n_lights, int n_samples,
                             int max_bounces, unsigned int frame_id,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* px, const void* py, const void* geom,
                             const void* albedo, const void* lpos,
                             const void* lspec, void* out, void* stream) {
  return spectral_mono_or_cost(n, n_obj, n_lights, n_samples, max_bounces,
                               frame_id, ox, oy, oz, dx, dy, dz, px, py, geom,
                               albedo, lpos, lspec, out, nullptr, stream);
}

extern "C" int spectral_cost(int n, int n_obj, int n_lights, int n_samples,
                             int max_bounces, unsigned int frame_id,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* px, const void* py, const void* geom,
                             const void* albedo, const void* lpos,
                             const void* lspec, void* out, void* cost,
                             void* stream) {
  if (cost == nullptr) return (int)cudaErrorInvalidValue;
  return spectral_mono_or_cost(n, n_obj, n_lights, n_samples, max_bounces,
                               frame_id, ox, oy, oz, dx, dy, dz, px, py, geom,
                               albedo, lpos, lspec, out, cost, stream);
}

extern "C" int spectral_regen(int n, int n_obj, int n_lights, int n_samples,
                              int max_bounces, unsigned int first_frame, int k,
                              const void* ox, const void* oy, const void* oz,
                              const void* dx, const void* dy, const void* dz,
                              const void* px, const void* py, const void* cam,
                              const void* dirx, const void* diry,
                              const void* dirz, const void* geom,
                              const void* albedo, const void* lpos,
                              const void* lspec, void* out, void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 1 || n_obj > spectral::MAX_OBJECTS || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_REGEN(S)                                                    \
  return (int)launch_regen<S>(                                               \
      n, n_obj, n_lights, max_bounces, first_frame, k, SPECTRAL_FLOAT(ox),   \
      SPECTRAL_FLOAT(oy), SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx),            \
      SPECTRAL_FLOAT(dy), SPECTRAL_FLOAT(dz), SPECTRAL_INT(px),              \
      SPECTRAL_INT(py), SPECTRAL_FLOAT(cam), SPECTRAL_FLOAT(dirx),           \
      SPECTRAL_FLOAT(diry), SPECTRAL_FLOAT(dirz), SPECTRAL_FLOAT(geom),      \
      SPECTRAL_FLOAT(albedo), SPECTRAL_FLOAT(lpos), SPECTRAL_FLOAT(lspec),   \
      static_cast<float*>(out), st)
  switch (n_samples) {
    case 8: SPECTRAL_REGEN(8);
    case 16: SPECTRAL_REGEN(16);
    case 32: SPECTRAL_REGEN(32);
    case 64: SPECTRAL_REGEN(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_REGEN
}

// ring_w > 0 selects the ring variant (ring_w a power of two, the ring
// planes [ring_w][n]); otherwise a non-null stop selects lane-stop, and
// null the plain free-running variant. cam is 3 floats (ring) or the
// CAM_BASIS-float basis table (free-running). State planes update in place.
extern "C" int spectral_persist(
    int n, int n_obj, int n_lights, int n_samples, int max_bounces,
    int budget, unsigned int lead, unsigned int end, int ring_w, void* ox,
    void* oy, void* oz, void* dx, void* dy, void* dz, void* alive,
    void* gate, void* hero, void* bl, void* fid, const void* px,
    const void* py, const void* stop, const void* cam, const void* ringx,
    const void* ringy, const void* ringz, const void* geom,
    const void* albedo, const void* lpos, const void* lspec, void* thr,
    void* rad, void* stream) {
  if (n <= 0 || budget <= 0) return 0;
  if (n_obj < 1 || n_obj > spectral::MAX_OBJECTS || ring_w < 0 ||
      (ring_w & (ring_w - 1)) != 0 || (ring_w > 0 && stop != nullptr))
    return (int)cudaErrorInvalidValue;
  const spectral::PersistArgs a{
      static_cast<float*>(ox),    static_cast<float*>(oy),
      static_cast<float*>(oz),    static_cast<float*>(dx),
      static_cast<float*>(dy),    static_cast<float*>(dz),
      static_cast<float*>(alive), static_cast<float*>(gate),
      static_cast<float*>(hero),  static_cast<int*>(bl),
      static_cast<int*>(fid),     SPECTRAL_INT(px),
      SPECTRAL_INT(py),           SPECTRAL_FLOAT(stop),
      SPECTRAL_FLOAT(cam),        SPECTRAL_FLOAT(ringx),
      SPECTRAL_FLOAT(ringy),      SPECTRAL_FLOAT(ringz),
      SPECTRAL_FLOAT(geom),       SPECTRAL_FLOAT(albedo),
      SPECTRAL_FLOAT(lpos),       SPECTRAL_FLOAT(lspec),
      static_cast<float*>(thr),   static_cast<float*>(rad)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_PERSIST(S)                                                  \
  return (int)dispatch_persist<S>(n, n_obj, n_lights, max_bounces, budget,   \
                                  lead, end, ring_w, a, st)
  switch (n_samples) {
    case 8: SPECTRAL_PERSIST(8);
    case 16: SPECTRAL_PERSIST(16);
    case 32: SPECTRAL_PERSIST(32);
    case 64: SPECTRAL_PERSIST(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_PERSIST
}
