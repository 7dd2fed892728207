// cuda_seg for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_seg <- `run_seg` -> `kernel_seg` (pallas_call at :2360, body
//               :2071-2110): one bounce segment [b_start, b_stop) over a
//               full wavefront state in and out, so that the host can
//               compact the live lanes between segments (the phased and
//               cascade frame paths, render/cuda_integrator.py).
//
// Design: another loop around the same `bounce_step` (bounce.cuh). A live
// lane enters with bounces_left = max_bounces - b_start (megakernel.py:
// :2104), the frame id of the whole wavefront, and its carried ray,
// gate, hero bin, throughput and radiance; it runs until its path ends or the
// segment does. The state is updated in place, where the TPU kernel
// writes eleven fresh outputs: a dead lane (a compacted wavefront's fill
// lanes among them) reads and writes nothing after its alive flag.
//
// What bounds it on the H100: the FP32 ALU work of the bounce step, like
// the others (mono.cu), and on the many-object scenes it serves, the
// cluster walk inside it: a trace of the 1000-sphere field tests about
// 120-240 members (PERF.md §6). The state round trip is (9 + 2S) * 4 B
// per live lane per launch, noise beside that. The segment split exists
// to keep the wavefront dense: a compacted wavefront puts the survivors
// of the first bounces (about 3% of lanes entering bounce 2 in the
// 1000-sphere scene, pallas_integrator.py:1579) into few, full warps
// instead of leaving them scattered across all.
//
// Design for the walk (bounce.cuh): the members of a sphere or triangle
// run are read as packed 16-byte records in visit order, from shared
// memory where they fit, with no order[] load before a test; the
// earlier walk read five or nine scalars of the 47-row global table
// behind each order[] load. The survivors stay in ascending lane order:
// grouping them by ray (direction octant, then origin cell) raised the
// walk's SIMT efficiency but unbalanced the blocks and ran slower.

#include "bounce.cuh"

namespace spectral {
namespace {

// x, through a move the compiler cannot see through. The state stores
// index with it, so that their addresses are computed after the bounce
// loop instead of being kept live from the loads across it: 2*S 64-bit
// addresses, which spilled registers (seg_kernel<32> 168 registers and
// 328 B of spills; 128 and none with this).
__device__ __forceinline__ int opaque(int x) {
#if defined(__CUDA_ARCH__)
  asm volatile("mov.b32 %0, %0;" : "+r"(x));
#endif
  return x;
}

struct SegArgs {
  float *ox, *oy, *oz, *dx, *dy, *dz, *alive, *gate, *hero;
  const int *px, *py;
  float *thr, *rad;
};

template <int S, bool MANY, bool TRI>
__global__ void __launch_bounds__(BLOCK)
seg_kernel(int n, TableArgs ta, int max_bounces, int b_start, int b_stop,
           uint32_t frame_id, SegArgs a) {
  extern __shared__ float smem[];
  const Tables tb = load_tables<MANY>(smem, ta, S);
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
#ifdef SPECTRAL_STATS
  stats_begin();
  unsigned stat_iters = 0;
  if (gidx >= n || !(a.alive[gidx] > 0.0f)) {
    stats_end(0u, 0u);
    return;
  }
#endif
  if (gidx >= n || !(a.alive[gidx] > 0.0f)) return;

  Lane<S> L;
  L.ox = a.ox[gidx];
  L.oy = a.oy[gidx];
  L.oz = a.oz[gidx];
  L.dx = a.dx[gidx];
  L.dy = a.dy[gidx];
  L.dz = a.dz[gidx];
  L.alive = true;
  L.gate = a.gate[gidx] > 0.0f;
#ifdef SPECTRAL_FX
  L.hero = a.hero[gidx];
#else
  L.hero = -1.0f;  // a build without features never sets a hero bin
#endif
  L.bl = max_bounces - b_start;
  L.fid = frame_id;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    L.thr[s] = a.thr[(size_t)s * n + gidx];
    L.rad[s] = a.rad[(size_t)s * n + gidx];
  }
  const uint32_t ux = (uint32_t)a.px[gidx], uy = (uint32_t)a.py[gidx];
  for (int b = b_start; b < b_stop; ++b) {
#ifdef SPECTRAL_STATS
    ++stat_iters;
#endif
    if (!bounce_step<S, MANY, TRI>(tb, L, ux, uy)) break;
  }
#ifdef SPECTRAL_STATS
  stats_end(stat_iters, 1u);
#endif

  const int gq = opaque(gidx);
  const size_t nq = (size_t)opaque(n);
  a.ox[gq] = L.ox;
  a.oy[gq] = L.oy;
  a.oz[gq] = L.oz;
  a.dx[gq] = L.dx;
  a.dy[gq] = L.dy;
  a.dz[gq] = L.dz;
  a.alive[gq] = L.alive ? 1.0f : 0.0f;
  a.gate[gq] = L.gate ? 1.0f : 0.0f;
#ifdef SPECTRAL_FX
  a.hero[gq] = L.hero;
#endif
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a.thr[(size_t)s * nq + gq] = L.thr[s];
    a.rad[(size_t)s * nq + gq] = L.rad[s];
  }
}

template <int S, bool MANY, bool TRI>
cudaError_t launch_seg(int n, const TableArgs& ta, int max_bounces,
                       int b_start, int b_stop, uint32_t frame_id,
                       const SegArgs& a, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(seg_kernel<S, MANY, TRI>, ta, S, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  seg_kernel<S, MANY, TRI><<<blocks, BLOCK, smem, stream>>>(
      n, ta, max_bounces, b_start, b_stop, frame_id, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). The state planes
// update in place; a build without features leaves hero as it is (it
// never sets a hero bin).
extern "C" int spectral_seg(int n, int n_samples, int max_bounces,
                            int b_start, int b_stop, unsigned int frame_id,
                            SPECTRAL_TABLE_PARAMS, void* ox, void* oy,
                            void* oz, void* dx, void* dy, void* dz,
                            void* alive, void* gate, void* hero, const void* px,
                            const void* py, void* thr, void* rad,
                            void* stream) {
  if (n <= 0 || b_stop <= b_start) return 0;
  if (b_start < 0 || b_start >= max_bounces || b_stop > max_bounces)
    return (int)cudaErrorInvalidValue;
  const spectral::TableArgs ta = SPECTRAL_TABLE_ARGS;
  const spectral::SegArgs a{
      static_cast<float*>(ox),    static_cast<float*>(oy),
      static_cast<float*>(oz),    static_cast<float*>(dx),
      static_cast<float*>(dy),    static_cast<float*>(dz),
      static_cast<float*>(alive), static_cast<float*>(gate),
      static_cast<float*>(hero),
      static_cast<const int*>(px), static_cast<const int*>(py),
      static_cast<float*>(thr),   static_cast<float*>(rad)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_SEG(S)                                                      \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) {   \
    return spectral::launch_seg<S, decltype(many)::value,                   \
                                decltype(tri)::value>(                      \
        n, ta, max_bounces, b_start, b_stop, frame_id, a, st);              \
  })
  switch (n_samples) {
    case 8: SPECTRAL_SEG(8);
    case 16: SPECTRAL_SEG(16);
    case 32: SPECTRAL_SEG(32);
    case 64: SPECTRAL_SEG(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_SEG
}

// The registers, local bytes and resident blocks per SM of the segment
// instantiation that tables of this kind take (spectral_kernel_info's
// out), for the measurement tools.
extern "C" int spectral_seg_info(int n_samples, int many, int tri, int smem,
                                 int* out) {
  spectral::TableArgs ta{};
  ta.n_obj = many ? spectral::SMEM_OBJECTS + 1 : 1;
  ta.n_runs = 1;
  ta.tri = tri;
#define SPECTRAL_SEG_INFO(S)                                                   \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto m, auto t) {          \
    return spectral_kernel_info(                                              \
        spectral::seg_kernel<S, decltype(m)::value, decltype(t)::value>,      \
        smem, out);                                                           \
  })
  switch (n_samples) {
    case 8: SPECTRAL_SEG_INFO(8);
    case 16: SPECTRAL_SEG_INFO(16);
    case 32: SPECTRAL_SEG_INFO(32);
    case 64: SPECTRAL_SEG_INFO(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_SEG_INFO
}
