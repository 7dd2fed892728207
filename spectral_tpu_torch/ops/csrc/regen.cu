// cuda_regen for Hopper (sm_90a).
//
// Replaces, from the JAX package's spectral_tpu/ops/pallas/megakernel.py:
//   cuda_regen <- `run_regen` -> `kernel_regen` (pallas_call at :2171, body
//                 :1894): K frames per launch; a lane whose path ends starts
//                 its pixel's next frame, and the output is the SUM of the
//                 K frames' radiance.
//
// What bounds it on the H100: the FP32 ALU work of the bounce step (the
// bound of PERF.md counts this launch's live path iterations), in a lane
// loop whose lanes do unequal work: a pixel's K paths take a few hundred
// to a few thousand iterations, and the block that holds a pixel holds
// its SM slot until its slowest lane is done. Its bytes (the pixel
// coordinates in, [S, n] radiance out once) are noise.
//
// Design.
// - Primaries in the kernel. Frame j's primary at the lane's pixel is
//   computed here from the camera table and the frame's Hammersley
//   offsets (primary_direction), in the op order and bits of the host
//   raygen (render/camera.py:generate_primary_rays): IEEE division, no
//   FMA. The host builds no direction planes and calls no raygen per
//   frame. (restart_direction, the free-running persist kernel's, takes
//   reciprocal products and lands ulps away: not used here.)
// - Depth of field (the TPU kernel's per-frame lens origins, :1733-1746,
//   pack_camera_frames :2508-2542). One lens point per frame: the host
//   computes each frame's shift once (camera.py:lens_point) and ships the
//   [K][4] table; a path's start moves the origin by its frame's shift and
//   re-aims the pinhole direction at the focus plane in the host raygen's
//   op order (camera.py:refocus). The lens code is compiled only with
//   -DSPECTRAL_LENS, into libraries of their own (runtime/build.py:
//   regen_lens, regen_fx_lens; and the shadow-interval regen_si), which
//   the host loads for a lens scene: a uniform branch once per path start
//   in the default libraries moved the registers and spills of several
//   pinhole instantiations. A library without it refuses a lens table.
// - A resident grid with dynamic pixels. The grid is as many blocks as
//   fit the card at once (the occupancy API), and a lane that has summed
//   its pixel's K frames takes the next pixel (lane index, in the host's
//   lane order: Morton for clustered scenes) from a global counter, one
//   atomic per warp for the lanes that ask together. No lane idles while
//   another of its warp is busy, except at the very end, and no block
//   waits for a wave. Each pixel's K frames stay in one lane and are
//   summed in frame order, so the result is the plain version's bit for
//   bit whatever lane takes a pixel.
// - The radiance bins in shared memory at S = 64 (SHARED). A lane's
//   thr[64] and rad[64] held 128 of regen_kernel<64,0,0>'s 193 registers:
//   2 blocks of 128 per SM, against 4 at S = 32, for a latency-bound lane
//   loop. The shared build keeps rad[64] after the tables, lane-minor
//   ([S][BLOCK] floats, bounce.cuh:SharedBins), and thr[64] in registers
//   (rad is read and written only at a diffuse hit; thr every bounce):
//   128 registers without spills, 4 blocks per SM, and the hero frame's
//   launches ran 5.15 ms a frame against 9.71 on an H100 (PERF.md
//   section 6). Both rows in shared memory, as in cuda_persist, gave 3
//   blocks by shared memory and 6.93 ms. The arithmetic and its order are the
//   register build's, so the sums are its bits. The host takes it per
//   launch where it holds more resident blocks per SM than the register
//   build at the launch's tables (megakernel.shared_bins): it was
//   11-42% faster wherever it did, even in the lens feature builds that
//   spill 28-56 B; at a tie 0.4-0.7% slower, and with 1 block against 2
//   (96 KB of tables) 1.68x the time. At S <= 32 only the register
//   build exists.

#include "bounce.cuh"

namespace spectral {
namespace {

// Frame j's primary direction at pixel (px, py) from the camera table
// (megakernel.cuh CB_*) and the frame's offsets off = (off_x, off_y):
// the op order of generate_primary_rays, normalized twice like it.
__device__ __forceinline__ void primary_direction(const float* cb,
                                                  const float* off,
                                                  uint32_t px, uint32_t py,
                                                  float& x, float& y,
                                                  float& z) {
  const float focal = cb[CB_FOCAL], aspect = cb[CB_ASPECT];
  const float y_ndc = -((((float)py + off[1]) / cb[CB_HEIGHT]) * 2.0f - 1.0f);
  const float x_ndc = ((((float)px + off[0]) / cb[CB_WIDTH]) * 2.0f - 1.0f) * aspect;
  x = cb[CB_FWD] * focal - cb[CB_RIGHT] * x_ndc + cb[CB_UP] * y_ndc;
  y = cb[CB_FWD + 1] * focal - cb[CB_RIGHT + 1] * x_ndc + cb[CB_UP + 1] * y_ndc;
  z = cb[CB_FWD + 2] * focal - cb[CB_RIGHT + 2] * x_ndc + cb[CB_UP + 2] * y_ndc;
  normalize3(x, y, z);  // the reference normalizes in raygen AND in Ray::new
  normalize3(x, y, z);
}

// Frame j's first trace: the primary at the lane's pixel, from the camera;
// with a lens table, from the camera moved by frame j's shift, through the
// pinhole ray's point on the focus plane: normalize(normalize(d * t_f -
// shift)) with t_f = focus / d.forward.
template <int S, bool SHARED>
__device__ __forceinline__ void start_frame(Lane<S, false, SHARED>& L, const float* cb,
                                            const float* off,
                                            const float* lens, int j,
                                            uint32_t ux, uint32_t uy,
                                            uint32_t first_frame,
                                            int max_bounces) {
  float dx, dy, dz;
  primary_direction(cb, off + 2 * j, ux, uy, dx, dy, dz);
  float ox = cb[CB_POS], oy = cb[CB_POS + 1], oz = cb[CB_POS + 2];
#ifdef SPECTRAL_LENS
  if (lens != nullptr) {
    const float* sh = lens + 4 * j;
    const float t_f =
        cb[CB_FOCUS] / dot3(dx, dy, dz, cb[CB_FWD], cb[CB_FWD + 1], cb[CB_FWD + 2]);
    dx = dx * t_f - sh[0];
    dy = dy * t_f - sh[1];
    dz = dz * t_f - sh[2];
    normalize3(dx, dy, dz);
    normalize3(dx, dy, dz);
    ox = ox + sh[0];
    oy = oy + sh[1];
    oz = oz + sh[2];
  }
#endif
  start_path(L, ox, oy, oz, dx, dy, dz, first_frame + (uint32_t)j, max_bounces);
}

template <int S, bool MANY, bool TRI, bool SHARED>
__global__ void __launch_bounds__(BLOCK)
regen_kernel(int n, TableArgs ta, int max_bounces, uint32_t first_frame,
             int k, const int* __restrict__ px, const int* __restrict__ py,
             const float* __restrict__ cam, const float* __restrict__ off,
             const float* __restrict__ lens, float* __restrict__ out,
             unsigned* __restrict__ counter) {
  extern __shared__ float smem[];
  __shared__ float s_cam[CAM_BASIS];
  if (threadIdx.x < CAM_BASIS) s_cam[threadIdx.x] = cam[threadIdx.x];
  const Tables tb = load_tables<MANY>(smem, ta, S);  // its __syncthreads publishes s_cam
#ifdef SPECTRAL_STATS
  stats_begin();
  unsigned stat_iters = 0, stat_pixels = 0;
#endif
  int lane = blockIdx.x * BLOCK + threadIdx.x;
  if (lane < n) {
    uint32_t ux = (uint32_t)px[lane], uy = (uint32_t)py[lane];
    Lane<S, false, SHARED> L;
    if constexpr (SHARED) {  // rad after the NEE scales, the last of the tables
      L.rad.p = tb.scale + tb.n_lights * BLOCK + threadIdx.x;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
    int j = 0;  // the frame in flight, 0..k-1
    start_frame(L, s_cam, off, lens, j, ux, uy, first_frame, max_bounces);
    for (;;) {
#ifdef SPECTRAL_STATS
      ++stat_iters;
#endif
      if (bounce_step<S, MANY, TRI>(tb, L, ux, uy)) continue;
      if (++j == k) {
        // the pixel's K frames are summed: store them, take the next pixel
#pragma unroll
        for (int s = 0; s < S; ++s) out[(size_t)s * n + lane] = L.rad[s];
#ifdef SPECTRAL_STATS
        ++stat_pixels;
#endif
        lane = next_lane(counter, gridDim.x * BLOCK);
        if (lane >= n) break;
        ux = (uint32_t)px[lane];
        uy = (uint32_t)py[lane];
#pragma unroll
        for (int s = 0; s < S; ++s) L.rad[s] = 0.0f;
        j = 0;
      }
      start_frame(L, s_cam, off, lens, j, ux, uy, first_frame, max_bounces);
    }
  }
#ifdef SPECTRAL_STATS
  stats_end(stat_iters, stat_pixels);
#endif
}

template <int S, bool MANY, bool TRI, bool SHARED>
cudaError_t launch_regen(int n, const TableArgs& ta, int max_bounces,
                         uint32_t first_frame, int k, const int* px,
                         const int* py, const float* cam, const float* off,
                         const float* lens, float* out, unsigned* counter,
                         cudaStream_t stream) {
  const auto kernel = regen_kernel<S, MANY, TRI, SHARED>;
  size_t smem;
  cudaError_t err = prepare(kernel, ta, S, smem, shared_bins_bytes(S, SHARED));
  if (err != cudaSuccess) return err;
  int blocks = (n + BLOCK - 1) / BLOCK;
  if ((err = resident_grid(kernel, smem, n, counter, stream, blocks)) != cudaSuccess) return err;
  kernel<<<blocks, BLOCK, smem, stream>>>(n, ta, max_bounces, first_frame, k,
                                          px, py, cam, off, lens, out,
                                          counter);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). `shared_bins`
// selects the build with the radiance bins in shared memory (S = 64
// only). `lens` is the [k][4] lens table with depth of field, NULL for a
// pinhole camera; a library built without the lens refuses one.
// `counter` is one unsigned of device scratch, which the launch zeroes
// on its stream.
extern "C" int spectral_regen(int n, int n_samples, int max_bounces,
                              unsigned int first_frame, int k, int shared_bins,
                              SPECTRAL_TABLE_PARAMS, const void* px,
                              const void* py, const void* cam,
                              const void* off, const void* lens, void* out,
                              void* counter, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || (shared_bins && n_samples != spectral::kSharedBinsSamples))
    return (int)cudaErrorInvalidValue;
#ifndef SPECTRAL_LENS
  if (lens != nullptr) return (int)cudaErrorInvalidValue;  // a lens library's table
#endif
  const spectral::TableArgs ta = SPECTRAL_TABLE_ARGS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPECTRAL_REGEN(S, SHARED)                                              \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto many, auto tri) {     \
    return spectral::launch_regen<S, decltype(many)::value,                   \
                                  decltype(tri)::value, SHARED>(              \
        n, ta, max_bounces, first_frame, k, static_cast<const int*>(px),      \
        static_cast<const int*>(py), static_cast<const float*>(cam),          \
        static_cast<const float*>(off), static_cast<const float*>(lens),      \
        static_cast<float*>(out), static_cast<unsigned*>(counter), st);       \
  })
  switch (n_samples) {
    case 8: SPECTRAL_REGEN(8, false);
    case 16: SPECTRAL_REGEN(16, false);
    case 32: SPECTRAL_REGEN(32, false);
    case 64:
      if (shared_bins) SPECTRAL_REGEN(64, true);
      SPECTRAL_REGEN(64, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_REGEN
}

// The registers, local bytes and resident blocks per SM of the regen
// instantiation that tables of this kind take, in the register build or
// (shared_bins) the shared-bins build, at `smem` bytes of tables plus the
// build's radiance bins (spectral_kernel_info's out): the host's choice
// of build (megakernel.shared_bins) and the measurement tools. A
// shared-bins build that does not exist (S != 64) or whose bins the
// tables leave no room reads all zeros: no block of it is resident.
extern "C" int spectral_regen_info(int n_samples, int many, int tri,
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
#define SPECTRAL_REGEN_INFO(S, SHARED)                                         \
  return (int)spectral::dispatch_tables<S>(ta, [&](auto m, auto t) {          \
    return spectral_kernel_info(                                              \
        spectral::regen_kernel<S, decltype(m)::value, decltype(t)::value,     \
                               SHARED>,                                       \
        smem + (int)spectral::shared_bins_bytes(S, SHARED), out);              \
  })
  switch (n_samples) {
    case 8: SPECTRAL_REGEN_INFO(8, false);
    case 16: SPECTRAL_REGEN_INFO(16, false);
    case 32: SPECTRAL_REGEN_INFO(32, false);
    case 64:
      if (shared_bins) SPECTRAL_REGEN_INFO(64, true);
      SPECTRAL_REGEN_INFO(64, false);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPECTRAL_REGEN_INFO
}
