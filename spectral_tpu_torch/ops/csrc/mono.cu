// cuda_mono and cuda_cost for Hopper (sm_90a).
//
// Replace, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_mono <- `run` -> `kernel` (pallas_call at :2127, body :1845 via
//                `_trace_tile` :1803): one progressive frame from the given
//                primary rays, the whole bounce loop resident.
//   cuda_cost <- `run_cost` -> `kernel_cost` (pallas_call at :2302, body
//                :1868): cuda_mono plus each lane's live iteration count.
//
// What bounds it on the H100: the FP32 ALU work of the bounce step (per
// bounce, the object loop for the nearest hit and again for each light's
// shadow ray, plus S-wide shading; PERF.md counts this frame's live path
// iterations), in a lane loop whose lanes do unequal work: a path ends
// after 1 to max_bounces iterations. It reads the primary rays and writes
// [S, n] radiance once, so HBM is not the limit.
//
// Design: regen.cu's resident grid and its flat lane loop. The grid is as
// many blocks as fit the card at once (the occupancy API, resident_grid),
// and a thread whose path ends stores it and takes the next lane index
// from a global counter, one atomic per group of threads that ask
// together (next_lane), in the same loop iteration: one loop whose every
// iteration is a bounce, so no thread waits at a loop's end for the
// longest path of its warp. Measured on the earlier grid (one thread per
// lane, ceil(n / BLOCK) blocks; PERF.md section 6): the blocks held
// 92% of the SM slot time, but the lane loop's warp SIMT efficiency was
// 0.31, each warp waiting on its longest path; a resident grid with a
// loop nested per path kept that 0.49 and gained 2%. Each lane's one path
// runs in one thread from its primary ray to its end, so the radiance and
// cost are the plain version's bit for bit whatever thread takes a lane.
// The tables go to shared memory at block start (bounce.cuh: load_tables),
// and the spectral state thr[S], rad[S] lives in registers, templated on S
// in {8,16,32,64}, except in the S = 64 build with the radiance bins in
// shared memory (SHARED), regen.cu's move: rad[64] after the tables,
// lane-minor ([S][BLOCK] floats, bounce.cuh:SharedBins), thr[64] in
// registers. The register build held mono_kernel<64,0,0,0> at 190
// registers and 2 blocks of 128 per SM, the shared build 128 and 4 (the
// many-object builds 3 against 2), and a frame at the hero frame's shape
// took 7.29 ms against 10.34 on an H100 (PERF.md section 6). The
// arithmetic and its order are the register build's, so the radiance
// and the cost plane are its bits. The host takes it per launch where it
// holds more resident blocks per SM than the register build at the
// launch's tables (megakernel.shared_bins, the rule of cuda_regen); at
// S <= 32 only the register build exists. -DSPECTRAL_STATS adds the
// per-thread counters of tools/lane_stats.py.

#include "bounce.cuh"

namespace spectral {
namespace {

// cuda_mono (COST = false) and cuda_cost (COST = true): one path per lane
// from the given primaries. The cost variant also stores the lane's live
// iteration count, max_bounces + 1 - bl with bl frozen at death
// (megakernel.py:1887-1892); its radiance is cuda_mono's bit for bit.
// SHARED: the radiance bins in shared memory (S = 64 only).
template <int S, bool COST, bool MANY, bool TRI, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
mono_kernel(int n, TableArgs ta, int max_bounces, uint32_t frame_id,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const int* __restrict__ px, const int* __restrict__ py,
            float* __restrict__ out, float* __restrict__ cost,
            unsigned* __restrict__ counter) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<MANY>(smem, ta, S);
#ifdef SPECTRAL_STATS
  stats_begin();
  unsigned stat_iters = 0, stat_pixels = 0;
#endif
  int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane < n) {
    Lane<S, false, SHARED> L;
    if constexpr (SHARED) {  // rad after the NEE scales, the last of the tables
      L.rad.p = tb.scale + tb.n_lights * BLOCK + threadIdx.x;
    }
    uint32_t ux, uy;
    // lane `lane`'s path from its primary ray, at zero radiance
    const auto start = [&] {
      start_path(L, ox[lane], oy[lane], oz[lane], dx[lane], dy[lane], dz[lane],
                 frame_id, max_bounces);
#pragma unroll
      for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
      ux = (uint32_t)px[lane];
      uy = (uint32_t)py[lane];
    };
    start();
    for (;;) {  // one bounce, or one path's end and the next path's start
#ifdef SPECTRAL_STATS
      ++stat_iters;
#endif
      if (bounce_step<S, MANY, TRI>(tb, L, ux, uy)) continue;
#pragma unroll
      for (int s = 0; s < S; ++s) out[(size_t)s * n + lane] = L.rad[s];
      if constexpr (COST) cost[lane] = (float)(max_bounces + 1) - (float)L.bl;
#ifdef SPECTRAL_STATS
      ++stat_pixels;
#endif
      lane = next_lane(counter, gridDim.x * BLOCK);
      if (lane >= n) break;
      start();
    }
  }
#ifdef SPECTRAL_STATS
  stats_end(stat_iters, stat_pixels);
#endif
}

template <int S, bool COST, bool MANY, bool TRI, bool SHARED>
cudaError_t launch_mono(int n, const TableArgs& ta, int max_bounces,
                        uint32_t frame_id, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const int* px, const int* py,
                        float* out, float* cost, unsigned* counter,
                        cudaStream_t stream) {
  const auto kernel = mono_kernel<S, COST, MANY, TRI, SHARED>;
  size_t smem;
  cudaError_t err = prepare(kernel, ta, S, smem, shared_bins_bytes(S, SHARED));
  if (err != cudaSuccess) return err;
  int blocks = (n + BLOCK - 1) / BLOCK;
  if ((err = resident_grid(kernel, smem, n, counter, stream, blocks)) != cudaSuccess) return err;
  kernel<<<blocks, BLOCK, smem, stream>>>(n, ta, max_bounces, frame_id, ox, oy,
                                          oz, dx, dy, dz, px, py, out, cost,
                                          counter);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). `shared_bins`
// selects the build with the radiance bins in shared memory (S = 64
// only). `counter` is one unsigned of device scratch, which the launch
// zeroes on its stream.
static int spectral_mono_or_cost(int n, int n_samples, int max_bounces,
                                 unsigned int frame_id, int shared_bins,
                                 const spectral::TableArgs& ta,
                                 const void* ox, const void* oy,
                                 const void* oz, const void* dx,
                                 const void* dy, const void* dz,
                                 const void* px, const void* py, void* out,
                                 void* cost, void* counter, void* stream) {
  if (n <= 0) return 0;
  if (shared_bins && n_samples != spectral::kSharedBinsSamples)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_MONO_L(COST, SHARED)                                         \
  spectral::launch_mono<S, COST, decltype(many)::value, decltype(tri)::value, \
                        SHARED>(                                              \
      n, ta, max_bounces, frame_id, SPECTRAL_FLOAT(ox), SPECTRAL_FLOAT(oy),   \
      SPECTRAL_FLOAT(oz), SPECTRAL_FLOAT(dx), SPECTRAL_FLOAT(dy),             \
      SPECTRAL_FLOAT(dz), static_cast<const int*>(px),                        \
      static_cast<const int*>(py), static_cast<float*>(out),                  \
      static_cast<float*>(cost), static_cast<unsigned*>(counter), st)
#define SPECTRAL_MONO_S(SS, SHARED)                                        \
  {                                                                        \
    constexpr int S = SS;                                                  \
    return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) { \
      return cost != nullptr ? SPECTRAL_MONO_L(true, SHARED)               \
                             : SPECTRAL_MONO_L(false, SHARED);             \
    });                                                                    \
  }
  switch (n_samples) {
    case 8: SPECTRAL_MONO_S(8, false);
    case 16: SPECTRAL_MONO_S(16, false);
    case 32: SPECTRAL_MONO_S(32, false);
    case 64:
      if (shared_bins) SPECTRAL_MONO_S(64, true);
      SPECTRAL_MONO_S(64, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_MONO_S
#undef SPECTRAL_MONO_L
}

extern "C" int spectral_mono(int n, int n_samples, int max_bounces,
                             unsigned int frame_id, int shared_bins,
                             SPECTRAL_TABLE_PARAMS, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz, const void* px,
                             const void* py, void* out, void* counter,
                             void* stream) {
  return spectral_mono_or_cost(n, n_samples, max_bounces, frame_id,
                               shared_bins, SPECTRAL_TABLE_ARGS, ox, oy, oz,
                               dx, dy, dz, px, py, out, nullptr, counter,
                               stream);
}

extern "C" int spectral_cost(int n, int n_samples, int max_bounces,
                             unsigned int frame_id, int shared_bins,
                             SPECTRAL_TABLE_PARAMS, const void* ox,
                             const void* oy, const void* oz, const void* dx,
                             const void* dy, const void* dz, const void* px,
                             const void* py, void* out, void* cost,
                             void* counter, void* stream) {
  if (cost == nullptr) return (int)cudaErrorInvalidValue;
  return spectral_mono_or_cost(n, n_samples, max_bounces, frame_id,
                               shared_bins, SPECTRAL_TABLE_ARGS, ox, oy, oz,
                               dx, dy, dz, px, py, out, cost, counter,
                               stream);
}

// The registers, local bytes and resident blocks per SM of the mono
// (cost = 0) or cost instantiation that tables of this kind take, in the
// register build or (shared_bins) the shared-bins build, at `smem` bytes
// of tables plus the build's radiance bins (spectral_kernel_info's out):
// the host's choice of build (megakernel.shared_bins) and the
// measurement tools. A shared-bins build that does not exist (S != 64)
// or whose bins the tables leave no room reads all zeros: no block of it
// is resident.
extern "C" int spectral_mono_info(int n_samples, int many, int tri, int cost,
                                  int shared_bins, int smem, int* out) {
  if (shared_bins && (n_samples != spectral::kSharedBinsSamples ||
                      smem + spectral::shared_bins_bytes(n_samples, true) >
                          (size_t)spectral::MAX_SMEM)) {
    out[0] = out[1] = out[2] = 0;
    return 0;
  }
  spectral::TableArgs ta{};
  ta.n_obj = many ? spectral::SMEM_OBJECTS + 1 : 1;
  ta.n_runs = 1;
  ta.tri = tri;
#define SPECTRAL_MONO_INFO(S, SHARED)                                          \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto m, auto t) {          \
    constexpr bool M = decltype(m)::value, T = decltype(t)::value;            \
    const int bytes = smem + (int)spectral::shared_bins_bytes(S, SHARED);     \
    return cost ? spectral_kernel_info(                                       \
                      spectral::mono_kernel<S, true, M, T, SHARED>, bytes,    \
                      out)                                                    \
                : spectral_kernel_info(                                       \
                      spectral::mono_kernel<S, false, M, T, SHARED>, bytes,   \
                      out);                                                   \
  })
  switch (n_samples) {
    case 8: SPECTRAL_MONO_INFO(8, false);
    case 16: SPECTRAL_MONO_INFO(16, false);
    case 32: SPECTRAL_MONO_INFO(32, false);
    case 64:
      if (shared_bins) SPECTRAL_MONO_INFO(64, true);
      SPECTRAL_MONO_INFO(64, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_MONO_INFO
}
