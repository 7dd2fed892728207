// Spectral path-tracing bounce kernels for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_mono   <- `run` -> `kernel` (pallas_call at :2127, body :1845 via
//                  `_trace_tile` :1803): one progressive frame from the
//                  given primary rays, the whole bounce loop resident.
//   cuda_regen  <- `run_regen` -> `kernel_regen` (pallas_call at :2171, body
//                  :1894): K frames per launch; a lane whose path ends starts
//                  its pixel's next frame, and the output is the SUM of the
//                  K frames' radiance.
// Both run the bounce body of `make_body.bounce` (:1313) with its unrolled
// object loop for scenes of up to 64 objects: `_candidate_t` (:554),
// `trace_tile` (:605) and `shadow_blocked` (:714).
//
// Design. One thread per pixel-lane runs its own paths to completion, in a
// block of 128 threads, masked by gidx < n; a warp retires lanes on its own,
// so the TPU kernel's fixed K*max_bounces iteration count and tile-wide
// all-dead guard are not needed. The per-object, per-lambda and light tables
// (at most 64 objects) are loaded into shared memory at block start, and the
// winner's albedo row is indexed directly. The spectral state thr[S] and
// rad[S] lives in registers, the kernels templated on S in {8,16,32,64}.
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
// spectral state. It reads the
// primary rays and writes [S, n] radiance once, so HBM is not the limit.
// Making it fast (occupancy tuning, persistent threads, wavefront
// compaction of live lanes, FMA) is later work, measured against this one.

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

// One path of frame `fid` from (o, d); its radiance is ADDED to rad.
template <int S>
__device__ __forceinline__ void trace_path(const Tables& tb, float ox, float oy, float oz,
                           float dx, float dy, float dz, uint32_t px,
                           uint32_t py, uint32_t fid, int max_bounces,
                           float (&rad)[S]) {
  float thr[S];
#pragma unroll
  for (int s = 0; s < S; ++s) thr[s] = 1.0f;
  bool gate = false;  // the parent bounce was specular
  for (int bl = max_bounces; bl >= 1; --bl) {
    float t;
    const int win = trace_nearest(tb, ox, oy, oz, dx, dy, dz, t);
    if (win < 0 || (gate && !(t > kSpecMin))) break;  // miss or gated out

    const float ipx = ox + dx * t, ipy = oy + dy * t, ipz = oz + dz * t;
    float nx, ny, nz;
    surface_normal(tb, win, ipx, ipy, ipz, nx, ny, nz);
    const float metal = G(tb, G_METAL, win);
    const float rough = G(tb, G_ROUGH, win);
    const float* alb = tb.albedo + win * S;

    float rx, ry, rz;
    pcg3d(px, py, fid + (uint32_t)bl, rx, ry, rz);
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

    const bool cont = bl > 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float ta = thr[s] * alb[s];
      if (!spec) {
        float direct = 0.0f;
        for (int l = 0; l < tb.n_lights; ++l) {
          direct = direct + tb.lspec[l * S + s] * tb.scale[l * BLOCK + threadIdx.x];
        }
        rad[s] = rad[s] + ta * direct;
      }
      if (cont) thr[s] = ta;
    }
    if (!cont) break;

    // continuation ray
    float ndx, ndy, ndz;
    if (spec) {
      const float k = 2.0f * (nx * dx + ny * dy + nz * dz);
      ndx = dx - nx * k;
      ndy = dy - ny * k;
      ndz = dz - nz * k;
      if (rough >= 0.001f) sample_in_cone(ndx, ndy, ndz, rough, rx, ry);
      ox = offx;
      oy = offy;
      oz = offz;
    } else {
      cosine_hemisphere(rx, ry, nx, ny, nz, ndx, ndy, ndz);
      ox = ipx;  // the diffuse continuation starts UN-offset
      oy = ipy;
      oz = ipz;
    }
    normalize3(ndx, ndy, ndz);  // Ray::new normalizes
    dx = ndx;
    dy = ndy;
    dz = ndz;
    gate = spec;
  }
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

template <int S>
__global__ void __launch_bounds__(BLOCK)
mono_kernel(int n, int n_obj, int n_lights, int max_bounces, uint32_t frame_id,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const int* __restrict__ px, const int* __restrict__ py,
            const float* __restrict__ geom, const float* __restrict__ albedo,
            const float* __restrict__ lpos, const float* __restrict__ lspec,
            float* __restrict__ out) {
  extern __shared__ float smem[];
  const Tables tb =
      load_tables(smem, geom, albedo, lpos, lspec, n_obj, n_lights, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;
  float rad[S];
#pragma unroll
  for (int s = 0; s < S; ++s) rad[s] = 0.0f;
  trace_path<S>(tb, ox[gidx], oy[gidx], oz[gidx], dx[gidx], dy[gidx], dz[gidx],
                (uint32_t)px[gidx], (uint32_t)py[gidx], frame_id, max_bounces,
                rad);
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = rad[s];
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
  float rad[S];
#pragma unroll
  for (int s = 0; s < S; ++s) rad[s] = 0.0f;
  // frame 0 from the given primaries, frame j from the camera origin and
  // the host-precomputed direction plane j-1; the K radiances are summed
  for (int j = 0; j < k; ++j) {
    const size_t at = (size_t)(j > 0 ? j - 1 : 0) * n + gidx;
    trace_path<S>(tb, j > 0 ? cam[0] : ox[gidx], j > 0 ? cam[1] : oy[gidx],
                  j > 0 ? cam[2] : oz[gidx], j > 0 ? dirx[at] : dx[gidx],
                  j > 0 ? diry[at] : dy[gidx], j > 0 ? dirz[at] : dz[gidx], ux,
                  uy, first_frame + (uint32_t)j, max_bounces, rad);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = rad[s];
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

template <int S>
cudaError_t launch_mono(int n, int n_obj, int n_lights, int max_bounces,
                        uint32_t frame_id, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const int* px, const int* py,
                        const float* geom, const float* albedo,
                        const float* lpos, const float* lspec, float* out,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(n_obj, n_lights, S);
  cudaError_t err = prepare(mono_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  mono_kernel<S><<<blocks, BLOCK, smem, stream>>>(
      n, n_obj, n_lights, max_bounces, frame_id, ox, oy, oz, dx, dy, dz, px,
      py, geom, albedo, lpos, lspec, out);
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

}  // namespace
}  // namespace spectral

using spectral::launch_mono;
using spectral::launch_regen;

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)
#define SPECTRAL_INT(p) static_cast<const int*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success).
extern "C" int spectral_mono(int n, int n_obj, int n_lights, int n_samples,
                             int max_bounces, unsigned int frame_id,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* px, const void* py, const void* geom,
                             const void* albedo, const void* lpos,
                             const void* lspec, void* out, void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 1 || n_obj > spectral::MAX_OBJECTS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_MONO(S)                                                     \
  return (int)launch_mono<S>(                                                \
      n, n_obj, n_lights, max_bounces, frame_id, SPECTRAL_FLOAT(ox),         \
      SPECTRAL_FLOAT(oy), SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx),            \
      SPECTRAL_FLOAT(dy), SPECTRAL_FLOAT(dz), SPECTRAL_INT(px),              \
      SPECTRAL_INT(py), SPECTRAL_FLOAT(geom), SPECTRAL_FLOAT(albedo),        \
      SPECTRAL_FLOAT(lpos), SPECTRAL_FLOAT(lspec), static_cast<float*>(out), \
      st)
  switch (n_samples) {
    case 8: SPECTRAL_MONO(8);
    case 16: SPECTRAL_MONO(16);
    case 32: SPECTRAL_MONO(32);
    case 64: SPECTRAL_MONO(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_MONO
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
