// cuda_mono and cuda_cost for Hopper (sm_90a).
//
// Replace, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_mono <- `run` -> `kernel` (pallas_call at :2127, body :1845 via
//                `_trace_tile` :1803): one progressive frame from the given
//                primary rays, the whole bounce loop resident.
//   cuda_cost <- `run_cost` -> `kernel_cost` (pallas_call at :2302, body
//                :1868): cuda_mono plus each lane's live iteration count.
//
// Design. One thread per pixel-lane runs its own path, in a block of 128
// threads, masked by gidx < n; a warp retires lanes on its own, so the TPU
// kernel's fixed iteration count and tile-wide all-dead guards are not
// needed. The tables go to shared memory at block start (bounce.cuh:
// load_tables; geometry of more than 64 objects stays in global memory).
// The spectral state thr[S] and rad[S] lives in registers, the kernels
// templated on S in {8,16,32,64}.
//
// What bounds it on the H100: divergent FP32 ALU work per lane (per
// bounce, the object loop twice, for the nearest hit and each light's
// shadow ray, plus S-wide shading) and register pressure from the 2*S
// floats of spectral state. It reads the primary rays and writes [S, n]
// radiance once, so HBM is not the limit. Making it fast (occupancy
// tuning, wavefront compaction, FMA) is later work, measured against this.

#include "bounce.cuh"

namespace spectral {
namespace {

// cuda_mono (COST = false) and cuda_cost (COST = true): one path per lane
// from the given primaries. The cost variant also stores the lane's live
// iteration count, max_bounces + 1 - bl with bl frozen at death
// (megakernel.py:1887-1892); its radiance is cuda_mono's bit for bit.
template <int S, bool COST, bool MANY, bool TRI>
__global__ void __launch_bounds__(BLOCK)
mono_kernel(int n, TableArgs ta, int max_bounces, uint32_t frame_id,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const int* __restrict__ px, const int* __restrict__ py,
            float* __restrict__ out, float* __restrict__ cost) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<MANY>(smem, ta, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;
  Lane<S> L;
  start_path(L, ox[gidx], oy[gidx], oz[gidx], dx[gidx], dy[gidx], dz[gidx],
             frame_id, max_bounces);
#pragma unroll
  for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
  const uint32_t ux = (uint32_t)px[gidx], uy = (uint32_t)py[gidx];
  while (bounce_step<S, MANY, TRI>(tb, L, ux, uy)) {
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = L.rad[s];
  if constexpr (COST) cost[gidx] = (float)(max_bounces + 1) - (float)L.bl;
}

template <int S, bool COST, bool MANY, bool TRI>
cudaError_t launch_mono(int n, const TableArgs& ta, int max_bounces,
                        uint32_t frame_id, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const int* px, const int* py,
                        float* out, float* cost, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(mono_kernel<S, COST, MANY, TRI>, ta, S, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  mono_kernel<S, COST, MANY, TRI><<<blocks, BLOCK, smem, stream>>>(
      n, ta, max_bounces, frame_id, ox, oy, oz, dx, dy, dz, px, py, out, cost);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success).
static int spectral_mono_or_cost(int n, int n_samples, int max_bounces,
                                 unsigned int frame_id,
                                 const spectral::TableArgs& ta,
                                 const void* ox, const void* oy,
                                 const void* oz, const void* dx,
                                 const void* dy, const void* dz,
                                 const void* px, const void* py, void* out,
                                 void* cost, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_MONO_L(COST)                                                 \
  spectral::launch_mono<S, COST, decltype(many)::value, decltype(tri)::value>( \
      n, ta, max_bounces, frame_id, SPECTRAL_FLOAT(ox), SPECTRAL_FLOAT(oy),   \
      SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx), SPECTRAL_FLOAT(dy),             \
      SPECTRAL_FLOAT(dz), static_cast<const int*>(px),                        \
      static_cast<const int*>(py), static_cast<float*>(out),                  \
      static_cast<float*>(cost), st)
#define SPECTRAL_MONO_S(SS)                                                \
  {                                                                        \
    constexpr int S = SS;                                                  \
    return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) { \
      return cost != nullptr ? SPECTRAL_MONO_L(true) : SPECTRAL_MONO_L(false); \
    });                                                                    \
  }
  switch (n_samples) {
    case 8: SPECTRAL_MONO_S(8);
    case 16: SPECTRAL_MONO_S(16);
    case 32: SPECTRAL_MONO_S(32);
    case 64: SPECTRAL_MONO_S(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_MONO_S
#undef SPECTRAL_MONO_L
}

extern "C" int spectral_mono(int n, int n_samples, int max_bounces,
                             unsigned int frame_id, SPECTRAL_TABLE_PARAMS,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* px, const void* py, void* out,
                             void* stream) {
  return spectral_mono_or_cost(n, n_samples, max_bounces, frame_id,
                               SPECTRAL_TABLE_ARGS, ox, oy, oz, dx, dy, dz,
                               px, py, out, nullptr, stream);
}

extern "C" int spectral_cost(int n, int n_samples, int max_bounces,
                             unsigned int frame_id, SPECTRAL_TABLE_PARAMS,
                             const void* ox, const void* oy, const void* oz,
                             const void* dx, const void* dy, const void* dz,
                             const void* px, const void* py, void* out,
                             void* cost, void* stream) {
  if (cost == nullptr) return (int)cudaErrorInvalidValue;
  return spectral_mono_or_cost(n, n_samples, max_bounces, frame_id,
                               SPECTRAL_TABLE_ARGS, ox, oy, oz, dx, dy, dz,
                               px, py, out, cost, stream);
}
