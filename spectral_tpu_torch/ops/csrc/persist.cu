// cuda_persist for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_persist <- `run_persist` -> `kernel_persist` / `_persist_core`
//                   (pallas_call at :2246, body :1941-2069): exactly `budget`
//                   bounce iterations over lane state carried in HBM between
//                   launches, in three variants: the primary-direction ring,
//                   free-running (in-kernel restart raygen), and
//                   free-running with a host stop mask (adaptive sampling).
//
// What bounds it on the H100: the FP32 ALU work of the bounce step, like
// the others (mono.cu), at the occupancy its registers allow. Every lane
// of a launch runs the same `budget` iterations, so the launch runs in
// whole waves of blocks: the blocks the card holds at once set how many
// waves a launch takes and how much of the last one idles. Its extra
// traffic is the state round trip, (13 + 2S) * 4 B per lane per launch
// (about 80 MB at 512^2, S = 32), noise beside the ~64 frames of bounce
// work a launch carries.
//
// Design, measured first (PERF.md section 6). The scalar state is
// loaded once into registers and stored once; the spectral state thr[S],
// rad[S] lives in the block's shared memory, lane-minor ([2S][BLOCK]
// after the tables: a warp reads 32 consecutive words of one bin, no bank
// conflicts), loaded from and stored to the lane-minor [S, n] planes,
// coalesced. In registers, as in the earlier design, those 2S floats gave
// persist_kernel<32> 158-167 registers and 3 blocks of 128 per SM, and a
// cornell512 launch ran 5.17 waves as 6; in shared memory it takes 64-94
// registers, shared memory sets the blocks per SM (6 at cornell512, 4 at
// mesh) and the launch ran 28% faster; the bounce step touches each bin a
// few times a bounce against about a thousand operations of trace and
// shadow. A lane that is dead and cannot restart leaves its loop, the
// exact per-thread form of the TPU kernel's tile skip; a ring restart
// reads its direction plane by slot, and a free-running one recomputes
// raygen from the basis table in shared memory. The restart rule is the
// earlier design's iteration for iteration, so the state after a launch
// is the plain version's bit for bit.
//
// The register builds (-DSPECTRAL_PERSIST_REGISTERS: runtime/build.py
// persist_reg, persist_fx_reg, persist_tri_reg,
// persist_fx_tri_reg) keep the spectral state in registers, as the
// earlier design did; they are that design, every instantiation, and the
// earlier design's measurements run on them. The host loads them
// (megakernel.persist_library) where the shared state loses:
// - a many-object walk that streams its packed records from global
//   memory (mesh5k's 300 KB): the shared state gains no block per SM
//   there (3 either way at S = 32) and shrinks the L1 that caches the
//   records (the two share an SM's 256 KB), and that launch ran 16%
//   slower than in registers;
// - tables that leave no room for the state under a block's shared
//   memory (a small scene with some hundreds of lights);
// - tables that leave the shared state fewer blocks per SM than the
//   register build holds (the occupancy API's count for each).
// -DSPECTRAL_STATS adds the per-thread counters of tools/lane_stats.py.

#include "bounce.cuh"

namespace spectral {
namespace {

// The persist kernel's planes, in the order of its parameters.
struct PersistArgs {
  float *ox, *oy, *oz, *dx, *dy, *dz, *alive, *gate, *hero;
  int *bl, *fid;
  const int *px, *py;
  const float *stop, *cam, *ringx, *ringy, *ringz;
  float *thr, *rad;
};

// Bytes of the spectral state after the tables: [2S][BLOCK] floats, or
// none in the register builds.
constexpr size_t persist_state_bytes(int S) {
#ifdef SPECTRAL_PERSIST_REGISTERS
  return 0;
#else
  return sizeof(float) * 2 * (size_t)S * BLOCK;
#endif
}

// Exactly `budget` bounce iterations over the carried lane state, updated
// in place. A lane whose path ends (or that idles) starts its pixel's
// next frame nf = fid + 1 when nf < end, and also nf < lead (RING) and
// its stop flag is clear (STOP); the restart uses the iteration. A lane
// that is dead and not restartable stays so for the rest of the launch
// (lead, end and stop are launch constants), so it leaves its loop: the
// per-thread form of the TPU kernel's tile skip.
template <int S, bool RING, bool STOP, bool MANY, bool TRI>
__global__ void __launch_bounds__(BLOCK)
persist_kernel(int n, TableArgs ta, int max_bounces, int budget,
               uint32_t lead, uint32_t end, int ring_w, PersistArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_cam[CAM_BASIS];
  constexpr int cam_len = RING ? 3 : CAM_BASIS;
  if (threadIdx.x < cam_len) s_cam[threadIdx.x] = a.cam[threadIdx.x];
  const Tables tb = load_tables<MANY>(smem, ta, S);  // its __syncthreads also publishes s_cam
#ifdef SPECTRAL_STATS
  stats_begin();
  unsigned stat_iters = 0, stat_restarts = 0;
#endif
  const int gidx = blockIdx.x * BLOCK + threadIdx.x;
  if (gidx >= n) return;

#ifdef SPECTRAL_PERSIST_REGISTERS
  Lane<S> L;
#else
  Lane<S, true> L;  // the bins after the NEE scales, the last of the tables
  L.thr.p = tb.scale + tb.n_lights * BLOCK + threadIdx.x;
  L.rad.p = L.thr.p + S * BLOCK;
#endif
  L.ox = a.ox[gidx];
  L.oy = a.oy[gidx];
  L.oz = a.oz[gidx];
  L.dx = a.dx[gidx];
  L.dy = a.dy[gidx];
  L.dz = a.dz[gidx];
  L.alive = a.alive[gidx] > 0.0f;
  L.gate = a.gate[gidx] > 0.0f;
  L.hero = a.hero[gidx];
  L.bl = a.bl[gidx];
  L.fid = (uint32_t)a.fid[gidx];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    L.thr[s] = a.thr[(size_t)s * n + gidx];
    L.rad[s] = a.rad[(size_t)s * n + gidx];
  }
  const uint32_t ux = (uint32_t)a.px[gidx], uy = (uint32_t)a.py[gidx];
  const bool stopped = STOP && a.stop[gidx] > 0.0f;

  for (int it = 0; it < budget; ++it) {
#ifdef SPECTRAL_STATS
    stat_iters += L.alive ? 1u : 0u;
#endif
    if (L.alive && bounce_step<S, MANY, TRI>(tb, L, ux, uy)) continue;
    const uint32_t nf = L.fid + 1u;
    if (!(nf < end) || (RING && !(nf < lead)) || stopped) break;
#ifdef SPECTRAL_STATS
    ++stat_restarts;
#endif
    float rdx, rdy, rdz;
    if constexpr (RING) {
      const size_t at = (size_t)(nf & (uint32_t)(ring_w - 1)) * n + gidx;
      rdx = a.ringx[at];
      rdy = a.ringy[at];
      rdz = a.ringz[at];
    } else {
      restart_direction(s_cam, ux, uy, nf, rdx, rdy, rdz);
    }
    start_path(L, s_cam[CB_POS], s_cam[CB_POS + 1], s_cam[CB_POS + 2], rdx,
               rdy, rdz, nf, max_bounces);
  }

#ifdef SPECTRAL_STATS
  stats_end(stat_iters, stat_restarts);
#endif
  a.ox[gidx] = L.ox;
  a.oy[gidx] = L.oy;
  a.oz[gidx] = L.oz;
  a.dx[gidx] = L.dx;
  a.dy[gidx] = L.dy;
  a.dz[gidx] = L.dz;
  a.alive[gidx] = L.alive ? 1.0f : 0.0f;
  a.gate[gidx] = L.gate ? 1.0f : 0.0f;
  a.hero[gidx] = L.hero;
  a.bl[gidx] = L.bl;
  a.fid[gidx] = (int)L.fid;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a.thr[(size_t)s * n + gidx] = L.thr[s];
    a.rad[(size_t)s * n + gidx] = L.rad[s];
  }
}

template <int S, bool RING, bool STOP, bool MANY, bool TRI>
cudaError_t launch_persist(int n, const TableArgs& ta, int max_bounces,
                           int budget, uint32_t lead, uint32_t end,
                           int ring_w, const PersistArgs& a,
                           cudaStream_t stream) {
  size_t smem;
  cudaError_t err = prepare(persist_kernel<S, RING, STOP, MANY, TRI>, ta, S,
                            smem, persist_state_bytes(S));
  if (err != cudaSuccess) return err;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  persist_kernel<S, RING, STOP, MANY, TRI><<<blocks, BLOCK, smem, stream>>>(
      n, ta, max_bounces, budget, lead, end, ring_w, a);
  return cudaGetLastError();
}

template <int S, bool MANY, bool TRI>
cudaError_t dispatch_persist(int n, const TableArgs& ta, int max_bounces,
                             int budget, uint32_t lead, uint32_t end,
                             int ring_w, const PersistArgs& a,
                             cudaStream_t stream) {
  if (ring_w > 0) {
    return launch_persist<S, true, false, MANY, TRI>(
        n, ta, max_bounces, budget, lead, end, ring_w, a, stream);
  }
  if (a.stop != nullptr) {
    return launch_persist<S, false, true, MANY, TRI>(
        n, ta, max_bounces, budget, lead, end, 0, a, stream);
  }
  return launch_persist<S, false, false, MANY, TRI>(
      n, ta, max_bounces, budget, lead, end, 0, a, stream);
}

}  // namespace
}  // namespace spectral

#define SPECTRAL_FLOAT(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). ring_w > 0
// selects the ring variant (ring_w a power of two, the ring planes
// [ring_w][n]); otherwise a non-null stop selects lane-stop, and null the
// plain free-running variant. cam is 3 floats (ring) or the
// CAM_BASIS-float basis table (free-running). State planes update in place.
extern "C" int spectral_persist(
    int n, int n_samples, int max_bounces, int budget, unsigned int lead,
    unsigned int end, int ring_w, SPECTRAL_TABLE_PARAMS, void* ox, void* oy,
    void* oz, void* dx, void* dy, void* dz, void* alive, void* gate,
    void* hero, void* bl, void* fid, const void* px, const void* py,
    const void* stop, const void* cam, const void* ringx, const void* ringy,
    const void* ringz, void* thr, void* rad, void* stream) {
  if (n <= 0 || budget <= 0) return 0;
  if (ring_w < 0 || (ring_w & (ring_w - 1)) != 0 ||
      (ring_w > 0 && stop != nullptr))
    return (int)cudaErrorInvalidValue;
  const spectral::TableArgs ta = SPECTRAL_TABLE_ARGS;
  const spectral::PersistArgs a{
      static_cast<float*>(ox),    static_cast<float*>(oy),
      static_cast<float*>(oz),    static_cast<float*>(dx),
      static_cast<float*>(dy),    static_cast<float*>(dz),
      static_cast<float*>(alive), static_cast<float*>(gate),
      static_cast<float*>(hero),  static_cast<int*>(bl),
      static_cast<int*>(fid),     static_cast<const int*>(px),
      static_cast<const int*>(py), SPECTRAL_FLOAT(stop),
      SPECTRAL_FLOAT(cam),        SPECTRAL_FLOAT(ringx),
      SPECTRAL_FLOAT(ringy),      SPECTRAL_FLOAT(ringz),
      static_cast<float*>(thr),   static_cast<float*>(rad)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_PERSIST(S)                                                \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) { \
    return spectral::dispatch_persist<S, decltype(many)::value,           \
                                      decltype(tri)::value>(              \
        n, ta, max_bounces, budget, lead, end, ring_w, a, st);            \
  })
  switch (n_samples) {
    case 8: SPECTRAL_PERSIST(8);
    case 16: SPECTRAL_PERSIST(16);
    case 32: SPECTRAL_PERSIST(32);
    case 64: SPECTRAL_PERSIST(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_PERSIST
}

// The registers, local bytes and resident blocks per SM of the persist
// instantiation that tables of this kind take, in the free-running
// (variant 0), ring (1) or lane-stop (2) form, at `smem` bytes of tables
// plus the spectral state (spectral_kernel_info's out): the host's
// choice of build (megakernel.persist_library) and the measurement tools.
extern "C" int spectral_persist_info(int n_samples, int many, int tri,
                                     int variant, int smem, int* out) {
  spectral::TableArgs ta{};
  ta.n_obj = many ? spectral::SMEM_OBJECTS + 1 : 1;
  ta.n_runs = 1;
  ta.tri = tri;
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
#define SPECTRAL_PERSIST_INFO(S)                                               \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto m, auto t) {          \
    constexpr bool M = decltype(m)::value, T = decltype(t)::value;            \
    const int bytes = smem + (int)spectral::persist_state_bytes(S);           \
    if (variant == 1) {                                                       \
      return spectral_kernel_info(                                            \
          spectral::persist_kernel<S, true, false, M, T>, bytes, out);        \
    }                                                                         \
    if (variant == 2) {                                                       \
      return spectral_kernel_info(                                            \
          spectral::persist_kernel<S, false, true, M, T>, bytes, out);        \
    }                                                                         \
    return spectral_kernel_info(spectral::persist_kernel<S, false, false, M, T>, \
                                bytes, out);                                  \
  })
  switch (n_samples) {
    case 8: SPECTRAL_PERSIST_INFO(8);
    case 16: SPECTRAL_PERSIST_INFO(16);
    case 32: SPECTRAL_PERSIST_INFO(32);
    case 64: SPECTRAL_PERSIST_INFO(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_PERSIST_INFO
}
