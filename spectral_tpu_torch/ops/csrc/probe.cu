// cuda_probe_fori and cuda_probe_mma for Hopper (sm_90a): the trace probe.
//
// Replace, from the JAX package's tools/mxu_trace_probe.py:
//   cuda_probe_fori <- `build_a.run` -> `kernel` (pallas_call at :81): the
//                      nearest ray-sphere hit as a scalar loop over the
//                      spheres, geometry in SMEM.
//   cuda_probe_mma  <- `build_b.run` -> `kernel` (pallas_call at :179): the
//                      same contract with d.c and o.c as matrix products
//                      per 128-sphere block, then a lane argmin.
//
// The contract (spectral_tpu_torch/ops/trace_probe.py): disc > 0 and a root
// > 0, both strict; roots (-b -+ sqrt(disc)) * inv2a with inv2a = 1 / 2a;
// the nearest sphere wins, ties to the lowest index; t = +inf and winner
// -1 on a miss. The plain versions take the fused multiply-adds of the
// reference's CPU build, and so do these kernels (fmaf, which -fmad=false
// keeps; no other product is contracted).
//
// cuda_probe_fori: one ray per thread, the spheres in shared memory (16 B
// each), walked in index order with strict <, op for op as
// probe_fori_plain: bit-identical to it.
//
// cuda_probe_mma: the tensor-core form, which is why kernel B exists. A
// warp takes 16 rays. Per 8 spheres it forms d.c and o.c with
// mma.sync.m16n8k8 TF32 (16 rays x 8 components, dx dy dz and zero
// padding, times 8 components x 8 spheres), f32 accumulate. TF32 keeps 10
// mantissa bits, so each operand is split into a TF32 high part and a
// TF32 residual and three products are summed (3xTF32: lo*hi + hi*lo +
// hi*hi). That drops lo*lo (2^-22 of a product), and the tensor cores
// accumulate with truncation: a few float32 roundings, not one. The
// quadratic runs on the accumulator fragment (each thread holds 2 rays x
// 2 spheres), a thread keeps its
// running minimum over a 128-sphere block, the four threads of a quad
// (the same rays) merge theirs with shuffles, lowest index on ties, and
// the block's minimum replaces the ray's best only if strictly smaller.
// The products differ from the plain version's float32 chain in the last
// bits, and b = 2 (d.o - d.c) cancels, so t agrees with it only to about
// float32's own error against an exact evaluation (chip_smoke.py holds
// the kernel's error to 4x the plain version's).
//
// What bounds them on the H100: operations. 196,608 rays x 1,024 spheres
// is 2.0e8 tests of 35 FP32 operations each (utils/flops.py:
// PROBE_TEST_OPS; 0.105 ms at 67 TFLOP/s); the rays are 4.7 MB in and
// 1.6 MB out (2 us at 3.35 TB/s). The MMA form moves the two dot
// products of a test (10 of the 35) onto the tensor cores, 6 MMAs per
// 16 x 8 tile, and leaves the quadratic, 25, on the FP32 pipes. Both are first
// versions: wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace spectral_probe {
namespace {

constexpr int FORI_BLOCK = 256;
constexpr int MMA_WARPS = 8;
constexpr int MMA_BLOCK = 32 * MMA_WARPS;  // 128 rays per block
constexpr int BLOCK_OBJ = 128;             // kernel B's sphere block
constexpr int MAX_SMEM = 232448;

__device__ __forceinline__ float dot3f(float x0, float x1, float x2, float y0,
                                       float y1, float y2) {
  return fmaf(x2, y2, fmaf(x0, y0, x1 * y1));
}

// The probe's quadratic for one ray-sphere pair: t, or +inf.
__device__ __forceinline__ float probe_root(float b, float c, float foura,
                                            float inv2a) {
  const float disc = fmaf(b, b, -(foura * c));
  const float sq = sqrtf(disc < 0.0f ? 0.0f : disc);
  const float t1 = (-b - sq) * inv2a;
  const float t2 = (-b + sq) * inv2a;
  const float t = t1 > 0.0f ? t1 : t2;
  return (disc > 0.0f && t > 0.0f) ? t : INFINITY;
}

__global__ void __launch_bounds__(FORI_BLOCK)
fori_kernel(int n, int n_obj, const float* __restrict__ geom,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            float* __restrict__ t_out, float* __restrict__ w_out) {
  extern __shared__ float s_geom[];  // [n_obj][4]: cx, cy, cz, r^2
  for (int i = threadIdx.x; i < 4 * n_obj; i += blockDim.x) s_geom[i] = geom[i];
  __syncthreads();
  const int i = blockIdx.x * FORI_BLOCK + threadIdx.x;
  if (i >= n) return;
  const float x = ox[i], y = oy[i], z = oz[i];
  const float u = dx[i], v = dy[i], w = dz[i];
  const float a = dot3f(u, v, w, u, v, w);
  const float inv2a = 1.0f / (2.0f * a);
  const float foura = 4.0f * a;
  float t_best = INFINITY, win = -1.0f;
  for (int o = 0; o < n_obj; ++o) {
    const float* g = s_geom + 4 * o;
    const float rx = x - g[0], ry = y - g[1], rz = z - g[2];
    const float b = 2.0f * dot3f(u, v, w, rx, ry, rz);
    const float c = dot3f(rx, ry, rz, rx, ry, rz) - g[3];
    const float t = probe_root(b, c, foura, inv2a);
    if (t < t_best) {
      t_best = t;
      win = (float)o;
    }
  }
  t_out[i] = t_best;
  w_out[i] = win;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
#endif
  return r;
}

// d += A * B, one m16n8k8 TF32 tile, f32 accumulate. Fragments (PTX ISA,
// m16n8k8 .tf32; g = lane / 4, q = lane % 4): a = A[g][q], A[g+8][q],
// A[g][q+4], A[g+8][q+4]; b = B[q][g], B[q+4][g]; d = D[g][2q], D[g][2q+1],
// D[g+8][2q], D[g+8][2q+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// x as TF32 high part and TF32 residual (x - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// (t, i) of the smaller, the lower index on a tie
__device__ __forceinline__ void take_min(float& t, int& i, float t2, int i2) {
  if (t2 < t || (t2 == t && i2 < i)) {
    t = t2;
    i = i2;
  }
}

__global__ void __launch_bounds__(MMA_BLOCK)
mma_kernel(int n, int n_obj, const float* __restrict__ dmat,
           const float* __restrict__ omat, const float* __restrict__ cmat,
           const float* __restrict__ cc, const float* __restrict__ dov,
           const float* __restrict__ oov, const float* __restrict__ av,
           float* __restrict__ t_out, float* __restrict__ w_out) {
  // the spheres, split once per block: c_hi, c_lo [8][n_obj], cc [n_obj]
  extern __shared__ uint32_t s_c[];
  uint32_t* s_hi = s_c;
  uint32_t* s_lo = s_c + 8 * n_obj;
  float* s_cc = reinterpret_cast<float*>(s_c + 16 * n_obj);
  for (int i = threadIdx.x; i < 8 * n_obj; i += blockDim.x) {
    split_tf32(cmat[i], s_hi[i], s_lo[i]);
  }
  for (int i = threadIdx.x; i < n_obj; i += blockDim.x) s_cc[i] = cc[i];
  __syncthreads();

  // every thread runs to the end: the MMAs and shuffles are warp-wide
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = (blockIdx.x * MMA_WARPS + (threadIdx.x >> 5)) * 16;
  const int rows[2] = {row0 + g, row0 + g + 8};
  uint32_t dh[4], dl[4], oh[4], ol[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = rows[k & 1], col = q + 4 * (k >> 1);
    const bool in = r < n;
    split_tf32(in ? dmat[(size_t)r * 8 + col] : 0.0f, dh[k], dl[k]);
    split_tf32(in ? omat[(size_t)r * 8 + col] : 0.0f, oh[k], ol[k]);
  }
  float dor[2], oor[2], inv2a[2], foura[2], t_best[2], win[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < n;
    const float a = in ? av[rows[h]] : 1.0f;
    dor[h] = in ? dov[rows[h]] : 0.0f;
    oor[h] = in ? oov[rows[h]] : 0.0f;
    inv2a[h] = 1.0f / (2.0f * a);
    foura[h] = 4.0f * a;
    t_best[h] = INFINITY;
    win[h] = -1.0f;
  }

  for (int blk = 0; blk < n_obj; blk += BLOCK_OBJ) {
    const int stop = min(blk + BLOCK_OBJ, n_obj);
    float bt[2] = {INFINITY, INFINITY};
    int bi[2] = {n_obj, n_obj};
    for (int j0 = blk; j0 < stop; j0 += 8) {
      const int s0 = q * n_obj + j0 + g, s1 = (q + 4) * n_obj + j0 + g;
      const uint32_t bh[2] = {s_hi[s0], s_hi[s1]};
      const uint32_t bl[2] = {s_lo[s0], s_lo[s1]};
      float dc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float oc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_tf32(dc, dl, bh);  // the small terms first
      mma_tf32(dc, dh, bl);
      mma_tf32(dc, dh, bh);
      mma_tf32(oc, ol, bh);
      mma_tf32(oc, oh, bl);
      mma_tf32(oc, oh, bh);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = j0 + 2 * q + (e & 1);
        const float b = 2.0f * (dor[h] - dc[e]);
        const float c = (oor[h] - 2.0f * oc[e]) + s_cc[col];
        take_min(bt[h], bi[h], probe_root(b, c, foura[h], inv2a[h]), col);
      }
    }
    // the quad's four threads hold the same two rays
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float t2 = __shfl_xor_sync(0xffffffffu, bt[h], off);
        const int i2 = __shfl_xor_sync(0xffffffffu, bi[h], off);
        take_min(bt[h], bi[h], t2, i2);
      }
      if (bt[h] < t_best[h]) {  // strict across blocks: the earlier wins ties
        t_best[h] = bt[h];
        win[h] = (float)bi[h];
      }
    }
  }
  if (q == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] < n) {
        t_out[rows[h]] = t_best[h];
        w_out[rows[h]] = win[h];
      }
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace spectral_probe

#define PROBE_F(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). Rays are planes
// of n floats (kernel A) or rows of 8 (kernel B, dmat/omat [n][8]).
extern "C" int spectral_probe_fori(int n, int n_obj, const void* geom,
                                   const void* ox, const void* oy,
                                   const void* oz, const void* dx,
                                   const void* dy, const void* dz, void* t,
                                   void* win, void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = 16 * (size_t)n_obj;
  cudaError_t err = spectral_probe::set_smem(spectral_probe::fori_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + spectral_probe::FORI_BLOCK - 1) / spectral_probe::FORI_BLOCK;
  spectral_probe::fori_kernel<<<blocks, spectral_probe::FORI_BLOCK, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      n, n_obj, PROBE_F(geom), PROBE_F(ox), PROBE_F(oy), PROBE_F(oz),
      PROBE_F(dx), PROBE_F(dy), PROBE_F(dz), static_cast<float*>(t),
      static_cast<float*>(win));
  return (int)cudaGetLastError();
}

extern "C" int spectral_probe_mma(int n, int n_obj, const void* dmat,
                                  const void* omat, const void* cmat,
                                  const void* cc, const void* dov,
                                  const void* oov, const void* av, void* t,
                                  void* win, void* stream) {
  if (n <= 0) return 0;
  if (n_obj < 8 || n_obj % 8 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * 17 * (size_t)n_obj;
  cudaError_t err = spectral_probe::set_smem(spectral_probe::mma_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int rays_per_block = 16 * spectral_probe::MMA_WARPS;
  const int blocks = (n + rays_per_block - 1) / rays_per_block;
  spectral_probe::mma_kernel<<<blocks, spectral_probe::MMA_BLOCK, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      n, n_obj, PROBE_F(dmat), PROBE_F(omat), PROBE_F(cmat), PROBE_F(cc),
      PROBE_F(dov), PROBE_F(oov), PROBE_F(av), static_cast<float*>(t),
      static_cast<float*>(win));
  return (int)cudaGetLastError();
}
