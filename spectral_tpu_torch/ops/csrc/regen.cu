// cuda_regen for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_regen <- `run_regen` -> `kernel_regen` (pallas_call at :2171, body
//                 :1894): K frames per launch; a lane whose path ends starts
//                 its pixel's next frame, and the output is the SUM of the
//                 K frames' radiance.
//
// Design: cuda_mono's (mono.cu), with the restart inside the lane's own
// loop, so no lane waits for its block. Frame j > 0 starts from the camera
// and the host-precomputed direction plane j-1 (re-deriving raygen in the
// kernel would flip the un-offset diffuse self-hit coin against the host
// raygen of the mono frames). What bounds it on the H100: the same FP32
// ALU work and register pressure; it reads 3*(K-1) direction planes and
// writes [S, n] once, a few ms of HBM time beside K frames of bounces.

#include "bounce.cuh"

namespace spectral {
namespace {

template <int S, bool MANY, bool TRI>
__global__ void __launch_bounds__(BLOCK)
regen_kernel(int n, TableArgs ta, int max_bounces, uint32_t first_frame,
             int k, const float* __restrict__ ox,
             const float* __restrict__ oy, const float* __restrict__ oz,
             const float* __restrict__ dx, const float* __restrict__ dy,
             const float* __restrict__ dz, const int* __restrict__ px,
             const int* __restrict__ py, const float* __restrict__ cam,
             const float* __restrict__ dirx, const float* __restrict__ diry,
             const float* __restrict__ dirz, float* __restrict__ out) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<MANY>(smem, ta, S);
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
    if (bounce_step<S, MANY, TRI>(tb, L, ux, uy)) continue;
    if (j == k) break;
    const size_t at = (size_t)(j - 1) * n + gidx;
    start_path(L, cam[0], cam[1], cam[2], dirx[at], diry[at], dirz[at],
               first_frame + (uint32_t)j, max_bounces);
    ++j;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) out[(size_t)s * n + gidx] = L.rad[s];
}

template <int S, bool MANY, bool TRI>
cudaError_t launch_regen(int n, const TableArgs& ta, int max_bounces,
                         uint32_t first_frame, int k, const float* ox,
                         const float* oy, const float* oz, const float* dx,
                         const float* dy, const float* dz, const int* px,
                         const int* py, const float* cam, const float* dirx,
                         const float* diry, const float* dirz, float* out,
                         cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(regen_kernel<S, MANY, TRI>, ta, S, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  regen_kernel<S, MANY, TRI><<<blocks, BLOCK, smem, stream>>>(
      n, ta, max_bounces, first_frame, k, ox, oy, oz, dx, dy, dz, px, py,
      cam, dirx, diry, dirz, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success).
extern "C" int spectral_regen(int n, int n_samples, int max_bounces,
                              unsigned int first_frame, int k,
                              SPECTRAL_TABLE_PARAMS, const void* ox,
                              const void* oy, const void* oz, const void* dx,
                              const void* dy, const void* dz, const void* px,
                              const void* py, const void* cam,
                              const void* dirx, const void* diry,
                              const void* dirz, void* out, void* stream) {
  if (n <= 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  const spectral::TableArgs ta = SPECTRAL_TABLE_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_REGEN(S)                                                      \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) {     \
    return spectral::launch_regen<S, decltype(many)::value,                   \
                                  decltype(tri)::value>(                      \
        n, ta, max_bounces, first_frame, k, SPECTRAL_FLOAT(ox),               \
        SPECTRAL_FLOAT(oy), SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx),           \
        SPECTRAL_FLOAT(dy), SPECTRAL_FLOAT(dz), static_cast<const int*>(px),  \
        static_cast<const int*>(py), SPECTRAL_FLOAT(cam), SPECTRAL_FLOAT(dirx), \
        SPECTRAL_FLOAT(diry), SPECTRAL_FLOAT(dirz), static_cast<float*>(out), \
        st);                                                                  \
  })
  switch (n_samples) {
    case 8: SPECTRAL_REGEN(8);
    case 16: SPECTRAL_REGEN(16);
    case 32: SPECTRAL_REGEN(32);
    case 64: SPECTRAL_REGEN(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_REGEN
}
