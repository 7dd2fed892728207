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
// What bounds them on the H100: operations (utils/flops.py: probe_terms).
// 196,608 rays x 1,024 spheres is 2.0e8 pairs. Every pair needs the test
// (kernel A: the offsets, b, c and disc, 20 FP32 operations; kernel B: b,
// c and disc from the two products, 10); the root stage (15) only the
// pairs with disc > 0, 0.17% of them at the probe's seed 0; kernel B's two
// dot products are 3xTF32 tensor-core products, counted over the 3
// components the rays and centres carry (the inputs pad them to 8 with
// zeros), so that the FP32 work bounds kernel B too. The rays are 4.7 MB
// in and 1.6 MB out (2 us at 3.35 TB/s).
//
// The design, measured against the earlier one (PERF.md section 6):
// - The root stage only where a warp needs it. The earlier kernels took
//   sqrtf, both roots, the pick and the mask for every pair, and sqrtf of
//   the clamped 0 of 99.8% of them leaves the IEEE square root's fast path
//   for a CALL. Here a pair's disc is computed, and the root stage runs
//   only where __any_sync finds disc > 0: first over a group of pairs,
//   then per pair. A pair with disc <= 0 gives +inf, which never wins a
//   strict <, so skipping it changes no bit. A lane that runs the root
//   stage with its warp but has disc <= 0 takes the square root of 1 (its
//   result is masked), so sqrtf stays on its fast path.
// - cuda_probe_fori: FORI_RAYS rays per thread, so that one broadcast
//   16-byte shared load of a sphere serves them all and their independent
//   chains fill the pipes; the sphere loop split in FORI_SHARES shares of
//   128 threads each over the same rays, merged exactly (the first share's
//   first minimum, then strict < for the later ones), for more warps per
//   SM; the next sphere loaded while this one is tested; a grid of as many
//   blocks as the card holds at once (the occupancy API), each walking ray
//   groups with a grid stride. Op for op as probe_fori_plain: bit-identical
//   to it. Its test alone runs at the card's FP32 issue rate (13 FP32
//   instructions a pair, 5 of them FMAs).
// - cuda_probe_mma: a persistent grid of one block of MMA_WGS warpgroups
//   per SM. A prologue kernel splits the spheres into TF32 high parts and
//   residuals once per launch, into the wrapper's scratch, in the layout
//   wgmma reads (below), pads them to a multiple of MMA_CHUNK with spheres
//   that never pass the test (centre 0, cc = +inf: c = +inf, disc = -inf),
//   and zeroes the tile counter. Each block brings the whole table into
//   shared memory with one bulk asynchronous copy (cp.async.bulk, an
//   mbarrier), and each warpgroup walks 64-ray tiles taken from the
//   counter. Per MMA_CHUNK spheres it issues six wgmma.mma_async m64n32k8
//   TF32 products (3xTF32: lo*hi + hi*lo + hi*hi, the small terms first,
//   for d.c and for o.c; A, the rays' split parts, from registers, B from
//   shared memory), waits for them and runs the chunk's epilogue. On the
//   H100 the TF32 products and the FP32 work of an SM do not overlap
//   (measured, PERF.md section 6), so keeping the
//   products in flight during the epilogue (two accumulator sets,
//   pipelined) measured slower, and one set leaves room for six
//   warpgroups. The epilogue keeps b/2 and disc/4 (b = 2 (d.o - d.c) and 4a
//   are exact doublings, so the roots are the same bits), forms all 16
//   pairs of a thread first, reads cc once per column pair, keeps the
//   minimum per thread with strict < (a thread's columns ascend) and merges
//   the quad's four minima at the tile's end, lowest index on ties. 3xTF32
//   drops lo*lo and the tensor cores accumulate with truncation, so t
//   agrees with the plain version to float32's error against an exact
//   evaluation, not bit for bit (trace_probe.error_bound at MMA_DOT_GAMMA).
// - Each block holds every sphere in shared memory: the wrapper refuses a
//   sphere count beyond spectral_probe_max_spheres before any launch.
//
// The PTX of Hopper (cvt.rna.tf32, wgmma, cp.async.bulk, mbarrier) is kept
// under #if defined(__CUDA_ARCH__), so that a host compiler can still
// rehearse the sources with stand-ins (README).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace spectral_probe {
namespace {

constexpr int MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot3f(float x0, float x1, float x2, float y0,
                                       float y1, float y2) {
  return fmaf(x2, y2, fmaf(x0, y0, x1 * y1));
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r = 0;
#if defined(__CUDA_ARCH__)
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
#endif
  return r;
}

// x as TF32 high part and TF32 residual (x - hi is exact in f32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
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

constexpr int FORI_RAYS = 4;     // rays per thread
constexpr int FORI_SHARES = 2;   // shares of the sphere loop per ray group
constexpr int FORI_GROUP = 128;  // threads per ray group (its rays: FORI_RAYS * 128)
constexpr int FORI_BLOCK = FORI_GROUP * FORI_SHARES;
constexpr int FORI_SPAN = FORI_GROUP * FORI_RAYS;  // rays per block and pass

constexpr int MMA_WGS = 6;               // warpgroups per block (one block per SM)
constexpr int MMA_BLOCK = 128 * MMA_WGS;
constexpr int MMA_TILE = 64;             // rays per warpgroup tile (wgmma's M)
constexpr int MMA_CHUNK = 32;            // spheres per product (wgmma's N)
constexpr int MMA_HEAD = 128;            // bytes before the table: mbarrier, tile slots
constexpr int SPLIT_BLOCK = 256;

// The resident grid of `kernel` at `block` threads and `smem` bytes: as
// many blocks as the card holds at once (the occupancy API), no more than
// `wanted`.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int block, size_t smem, int wanted, int& blocks) {
  int device, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = wanted < per_sm * sms ? wanted : per_sm * sms;
  return cudaSuccess;
}

// The root stage of one pair whose test gave `disc`: t, or +inf. A lane
// whose disc <= 0 runs it only with its warp, and takes the root of 1 so
// that sqrtf stays on its fast path; its t is masked to +inf.
__device__ __forceinline__ float root_of(float b, float disc, float inv2a) {
  const bool pos = disc > 0.0f;
  const float sq = sqrtf(pos ? disc : 1.0f);
  const float t1 = (-b - sq) * inv2a;
  const float t2 = (-b + sq) * inv2a;
  const float t = t1 > 0.0f ? t1 : t2;
  return (pos && t > 0.0f) ? t : INFINITY;
}

// ------------------------------------------------------- cuda_probe_fori
// Bytes of shared memory of a fori block: the spheres and one more slot
// (the loop loads sphere o + 1 while it tests sphere o), then the minima
// that the later shares hand to the first.
constexpr size_t fori_smem(int n_obj) {
  return 16 * ((size_t)n_obj + 1) + (size_t)(FORI_SHARES - 1) * FORI_GROUP * FORI_RAYS * 8;
}

// A block is FORI_SHARES groups of 128 threads over the same rays,
// FORI_RAYS per thread (rays first + 32 r of the warp's span): group p
// walks the spheres [p n_obj / S, (p + 1) n_obj / S) in index order with
// strict <, and group 0 then takes each later group's minimum only if
// strictly smaller: the loop's first minimum. Every lane runs the loop
// (padded rays, beyond n, never pass the test: d = 0 gives disc = -0).
__global__ void __launch_bounds__(FORI_BLOCK, 1)
fori_kernel(int n, int n_obj, const float* __restrict__ geom,
            const float* __restrict__ ox, const float* __restrict__ oy,
            const float* __restrict__ oz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            float* __restrict__ t_out, float* __restrict__ w_out) {
  constexpr int R = FORI_RAYS, S = FORI_SHARES;
  extern __shared__ float4 s_geom[];  // [n_obj + 1]: cx, cy, cz, r^2
  float* s_t = reinterpret_cast<float*>(s_geom + n_obj + 1);  // [S - 1][R][128]
  int* s_w = reinterpret_cast<int*>(s_t + (S - 1) * R * FORI_GROUP);
  for (int i = threadIdx.x; i <= n_obj; i += FORI_BLOCK) {
    s_geom[i] = i < n_obj ? make_float4(geom[4 * i], geom[4 * i + 1], geom[4 * i + 2],
                                        geom[4 * i + 3])
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  const int part = threadIdx.x / FORI_GROUP, tid = threadIdx.x % FORI_GROUP;
  const int lane = tid & 31;
  const int o_begin = (int)((long long)part * n_obj / S);
  const int o_end = (int)((long long)(part + 1) * n_obj / S);
  for (int base = blockIdx.x * FORI_SPAN; base < n; base += gridDim.x * FORI_SPAN) {
    const int first = base + (tid >> 5) * 32 * R + lane;
    float x[R], y[R], z[R], u[R], v[R], w[R], inv2a[R], foura[R], t_best[R];
    int win[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = first + 32 * r;
      const bool in = i < n;
      x[r] = in ? ox[i] : 0.0f;
      y[r] = in ? oy[i] : 0.0f;
      z[r] = in ? oz[i] : 0.0f;
      u[r] = in ? dx[i] : 0.0f;
      v[r] = in ? dy[i] : 0.0f;
      w[r] = in ? dz[i] : 0.0f;
      const float a = dot3f(u[r], v[r], w[r], u[r], v[r], w[r]);
      inv2a[r] = 1.0f / (2.0f * a);
      foura[r] = 4.0f * a;
      t_best[r] = INFINITY;
      win[r] = -1;
    }
    float4 g = s_geom[o_begin];
#pragma unroll 2
    for (int o = o_begin; o < o_end; ++o) {
      const float4 g_next = s_geom[o + 1];  // its latency hides behind this sphere's test
      float b[R], disc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float rx = x[r] - g.x, ry = y[r] - g.y, rz = z[r] - g.z;
        b[r] = 2.0f * dot3f(u[r], v[r], w[r], rx, ry, rz);
        const float c = dot3f(rx, ry, rz, rx, ry, rz) - g.w;
        disc[r] = fmaf(b[r], b[r], -(foura[r] * c));
      }
      float most = disc[0];
#pragma unroll
      for (int r = 1; r < R; ++r) most = fmaxf(most, disc[r]);
      if (__any_sync(FULL, most > 0.0f)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (__any_sync(FULL, disc[r] > 0.0f)) {
            const float t = root_of(b[r], disc[r], inv2a[r]);
            if (t < t_best[r]) {
              t_best[r] = t;
              win[r] = o;
            }
          }
        }
      }
      g = g_next;
    }
    if (part > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s_t[((part - 1) * R + r) * FORI_GROUP + tid] = t_best[r];
        s_w[((part - 1) * R + r) * FORI_GROUP + tid] = win[r];
      }
    }
    __syncthreads();
    if (part == 0) {
      for (int p = 1; p < S; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float t = s_t[((p - 1) * R + r) * FORI_GROUP + tid];
          if (t < t_best[r]) {
            t_best[r] = t;
            win[r] = s_w[((p - 1) * R + r) * FORI_GROUP + tid];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = first + 32 * r;
        if (i < n) {
          t_out[i] = t_best[r];
          w_out[i] = (float)win[r];
        }
      }
    }
    __syncthreads();  // the next pass writes s_t and s_w again
  }
}

// ------------------------------------------------------- cuda_probe_mma
// The split table (words), one part after the other: hi, lo, each
// [n_pad / 8][2][8][4] (per group of 8 spheres, components 0-3 of the 8
// spheres, then components 4-7: the K-major layout without swizzle that
// wgmma reads, core matrices of 8 rows x 16 bytes), then cc [n_pad], then
// the tile counter.
__device__ __forceinline__ int table_word(int sphere, int k) {
  return (sphere >> 3) * 64 + (k >> 2) * 32 + (sphere & 7) * 4 + (k & 3);
}

__global__ void __launch_bounds__(SPLIT_BLOCK)
split_kernel(int n_obj, int n_pad, const float* __restrict__ cmat,
             const float* __restrict__ cc, uint32_t* __restrict__ table,
             unsigned* __restrict__ counter) {
  const int i = blockIdx.x * SPLIT_BLOCK + threadIdx.x;
  if (i == 0) *counter = 0u;
  if (i < 8 * n_pad) {
    const int j = i >> 3, k = i & 7;
    uint32_t hi, lo;
    split_tf32(j < n_obj ? cmat[(size_t)k * n_obj + j] : 0.0f, hi, lo);
    table[table_word(j, k)] = hi;
    table[8 * n_pad + table_word(j, k)] = lo;
  }
  if (i < n_pad) {
    reinterpret_cast<float*>(table)[16 * n_pad + i] = i < n_obj ? cc[i] : INFINITY;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared-memory matrix descriptor of B (PTX ISA, wgmma): the start
// address, the leading byte offset (between the two 16-byte K halves of a
// core matrix row: 128 B) and the stride byte offset (between groups of 8
// spheres: 256 B), each in 16-byte units; no swizzle. A chunk further is
// MMA_CHUNK * 32 bytes further: CHUNK_DESC in the address field.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}
constexpr uint64_t CHUNK_DESC = MMA_CHUNK * 32 >> 4;

// D (+)= A * B, one wgmma m64n32k8 TF32 product of the warpgroup, f32
// accumulate, A from registers, B (32 spheres x 8 components) from shared
// memory; `accumulate` 0 overwrites D. Fragments (PTX ISA, m64nNk8 .tf32;
// warp w of the warpgroup, g = lane / 4, q = lane % 4): a = A[16w+g][q],
// A[16w+g+8][q], A[16w+g][q+4], A[16w+g+8][q+4]; d[4i + 2h + e] =
// D[16w + g + 8h][8i + 2q + e].
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
#endif
}

// Orders the compiler's accesses of the accumulators against the
// asynchronous products (which write them behind its back).
__device__ __forceinline__ void fence_operands(float (&acc)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(acc[e])::"memory");
}

// The ray tile's state in one thread: two rays (rows 16w + g and + 8), the
// split parts of their d and o (A fragments), d.o, o.o, a, 2 / 2a, and the
// running minimum with its sphere.
struct Rays {
  uint32_t dh[4], dl[4], oh[4], ol[4];
  float dor[2], oor[2], a[2], inva[2], t_best[2];
  int win[2];
};

// The six products of chunk `chunk` into acc (d.c in [0, 16), o.c in [16,
// 32)), the small terms first, then waits for them. `hi0` / `lo0` are the
// descriptors of chunk 0's two parts.
__device__ __forceinline__ void products(float (&acc)[32], const Rays& r, uint64_t hi0,
                                         uint64_t lo0, int chunk) {
  const uint64_t bh = hi0 + chunk * CHUNK_DESC, bl = lo0 + chunk * CHUNK_DESC;
  __syncwarp();
  fence_operands(acc);
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
  wgmma_n32(acc, r.dl, bh, 0);
  wgmma_n32(acc, r.dh, bl, 1);
  wgmma_n32(acc, r.dh, bh, 1);
  wgmma_n32(acc + 16, r.ol, bh, 0);
  wgmma_n32(acc + 16, r.oh, bl, 1);
  wgmma_n32(acc + 16, r.oh, bh, 1);
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#endif
  fence_operands(acc);
}

// The epilogue of chunk `chunk`: per pair b/2 = d.o - d.c, c = (o.o - 2 o.c)
// + cc and disc/4 = fma(b/2, b/2, -(a c)), all 16 pairs of the thread
// first (independent chains); then the root stage under a warp vote on
// the chunk's largest disc, then per 8 columns (4 pairs a thread), then
// per pair in each lane.
__device__ __forceinline__ void epilogue(const float (&acc)[32], Rays& r, const float* s_cc,
                                         int chunk, int q) {
  float2 cc2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cc2[i] = *reinterpret_cast<const float2*>(s_cc + chunk * MMA_CHUNK + 8 * i + 2 * q);
  }
  float dq[16], most[4];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int h = (k >> 1) & 1;
    const float bh = r.dor[h] - acc[k];
    const float c = fmaf(-2.0f, acc[16 + k], r.oor[h]) + ((k & 1) ? cc2[k >> 2].y : cc2[k >> 2].x);
    dq[k] = fmaf(bh, bh, -(r.a[h] * c));
    most[k >> 2] = (k & 3) ? fmaxf(most[k >> 2], dq[k]) : dq[k];
  }
  const float top = fmaxf(fmaxf(most[0], most[1]), fmaxf(most[2], most[3]));
  if (!__any_sync(FULL, top > 0.0f)) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!__any_sync(FULL, most[i] > 0.0f)) continue;
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
      const int k = 4 * i + e4, h = e4 >> 1;
      if (dq[k] > 0.0f) {
        const float t = root_of(r.dor[h] - acc[k], dq[k], r.inva[h]);
        if (t < r.t_best[h]) {
          r.t_best[h] = t;
          r.win[h] = chunk * MMA_CHUNK + 8 * i + 2 * q + (e4 & 1);
        }
      }
    }
  }
}

// Wait for the mbarrier's phase `parity` to complete. A copy that never
// lands traps after about 2^32 cycles (2 s) rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#if defined(__CUDA_ARCH__)
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  }
#endif
}

__global__ void __launch_bounds__(MMA_BLOCK, 1)
mma_kernel(int n, int n_pad, const float* __restrict__ dmat,
           const float* __restrict__ omat, const float* __restrict__ dov,
           const float* __restrict__ oov, const float* __restrict__ av,
           const uint32_t* __restrict__ table, unsigned* __restrict__ counter,
           float* __restrict__ t_out, float* __restrict__ w_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* slots = reinterpret_cast<int*>(smem + 16);  // [MMA_WGS][2] tile indices
  const uint32_t* s_hi = reinterpret_cast<const uint32_t*>(smem + MMA_HEAD);
  const float* s_cc = reinterpret_cast<const float*>(s_hi + 16 * n_pad);
  const uint32_t bar_addr = smem_addr(bar);
  // the table, once per block: one bulk copy, completion on the mbarrier
  if (threadIdx.x == 0) {
#if defined(__CUDA_ARCH__)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#if defined(__CUDA_ARCH__)
    const uint32_t bytes = 68u * (uint32_t)n_pad;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(s_hi)),
        "l"(table), "r"(bytes), "r"(bar_addr)
        : "memory");
#endif
  }
  mbar_wait(bar_addr, 0);

  const int wg = threadIdx.x >> 7, wtid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const uint64_t hi0 = b_desc(smem_addr(s_hi)), lo0 = b_desc(smem_addr(s_hi + 8 * n_pad));
  const int n_chunks = n_pad / MMA_CHUNK;
  for (int k = 0;; ++k) {
    // the warpgroup's next tile: one atomic, handed on through shared
    // memory (two slots: a slot is written again only after every thread
    // of the warpgroup has passed the next barrier)
    if (wtid == 0) slots[2 * wg + (k & 1)] = (int)atomicAdd(counter, 1u);
#if defined(__CUDA_ARCH__)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
#endif
    const int row0 = slots[2 * wg + (k & 1)] * MMA_TILE;
    if (row0 >= n) break;
    const int rows[2] = {row0 + 16 * (wtid >> 5) + g, row0 + 16 * (wtid >> 5) + g + 8};
    Rays r;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int row = rows[kk & 1], col = q + 4 * (kk >> 1);
      const bool in = row < n;
      split_tf32(in ? dmat[(size_t)row * 8 + col] : 0.0f, r.dh[kk], r.dl[kk]);
      split_tf32(in ? omat[(size_t)row * 8 + col] : 0.0f, r.oh[kk], r.ol[kk]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = rows[h] < n;
      const float a = in ? av[rows[h]] : 1.0f;
      r.dor[h] = in ? dov[rows[h]] : 0.0f;
      r.oor[h] = in ? oov[rows[h]] : 0.0f;
      r.a[h] = a;
      r.inva[h] = 2.0f * (1.0f / (2.0f * a));  // 2 inv2a, exact
      r.t_best[h] = INFINITY;
      r.win[h] = -1;
    }
    // The products of a chunk, then its epilogue, chunk after chunk: the
    // tensor cores and the FP32 work of an SM do not overlap on the H100
    // (measured, PERF.md section 6), so the warpgroups' turns are what
    // keep both busy, and one accumulator set leaves room for six
    // warpgroups per SM. The first product of a chunk overwrites the set.
    float acc[32];
    for (int c = 0; c < n_chunks; ++c) {
      products(acc, r, hi0, lo0, c);
      epilogue(acc, r, s_cc, c, q);
    }
    // the quad's four threads hold the same two rays, their columns
    // interleaved: the lower index on a tie
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float t2 = __shfl_xor_sync(FULL, r.t_best[h], off);
        const int i2 = __shfl_xor_sync(FULL, r.win[h], off);
        if (t2 < r.t_best[h] || (t2 == r.t_best[h] && i2 < r.win[h])) {
          r.t_best[h] = t2;
          r.win[h] = i2;
        }
      }
      if (q == 0 && rows[h] < n) {
        t_out[rows[h]] = r.t_best[h];
        w_out[rows[h]] = (float)r.win[h];
      }
    }
  }
}

// The spheres of the table: n_obj padded to a multiple of MMA_CHUNK.
constexpr int table_spheres(int n_obj) { return (n_obj + MMA_CHUNK - 1) / MMA_CHUNK * MMA_CHUNK; }

// Shared-memory bytes of an mma block: the head, then the table.
constexpr size_t mma_smem(int n_pad) { return MMA_HEAD + 68 * (size_t)n_pad; }

// The most spheres a block holds: kernel A's, and kernel B's as a multiple
// of MMA_CHUNK (any count up to it pads to a table that fits).
constexpr int FORI_MAX_SPHERES = (int)((MAX_SMEM - fori_smem(0)) / 16);
constexpr int MMA_MAX_SPHERES = (MAX_SMEM - MMA_HEAD) / 68 / MMA_CHUNK * MMA_CHUNK;
static_assert(fori_smem(FORI_MAX_SPHERES) <= MAX_SMEM &&
                  fori_smem(FORI_MAX_SPHERES + 1) > MAX_SMEM,
              "kernel A's sphere limit");
static_assert(mma_smem(MMA_MAX_SPHERES) <= MAX_SMEM &&
                  mma_smem(MMA_MAX_SPHERES + MMA_CHUNK) > MAX_SMEM,
              "kernel B's sphere limit");

// The split prologue, then mma_kernel on the resident grid.
cudaError_t launch_mma(int n, int n_obj, const float* dmat, const float* omat, const float* cmat,
                       const float* cc, const float* dov, const float* oov, const float* av,
                       uint32_t* table, float* t, float* win, cudaStream_t st) {
  const int n_pad = table_spheres(n_obj);
  const size_t smem = mma_smem(n_pad);
  cudaError_t err = set_smem(mma_kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + MMA_TILE - 1) / MMA_TILE;
  int blocks = 0;
  err = resident_blocks(mma_kernel, MMA_BLOCK, smem, (tiles + MMA_WGS - 1) / MMA_WGS, blocks);
  if (err != cudaSuccess) return err;
  unsigned* counter = reinterpret_cast<unsigned*>(table + 17 * n_pad);
  split_kernel<<<(8 * n_pad + SPLIT_BLOCK - 1) / SPLIT_BLOCK, SPLIT_BLOCK, 0, st>>>(
      n_obj, n_pad, cmat, cc, table, counter);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mma_kernel<<<blocks, MMA_BLOCK, smem, st>>>(n, n_pad, dmat, omat, dov, oov, av, table,
                                              counter, t, win);
  return cudaGetLastError();
}

// Launch fori_kernel on the resident grid.
cudaError_t launch_fori(int n, int n_obj, const float* geom, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy, const float* dz,
                        float* t, float* win, cudaStream_t st) {
  const size_t smem = fori_smem(n_obj);
  cudaError_t err = set_smem(fori_kernel, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = resident_blocks(fori_kernel, FORI_BLOCK, smem, (n + FORI_SPAN - 1) / FORI_SPAN, blocks);
  if (err != cudaSuccess) return err;
  fori_kernel<<<blocks, FORI_BLOCK, smem, st>>>(n, n_obj, geom, ox, oy, oz, dx, dy, dz, t, win);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spectral_probe

#define PROBE_F(p) static_cast<const float*>(p)

// C interface, bound with ctypes: every pointer and the stream are void*;
// returns the cudaError_t of the launch (0 on success). Rays are planes
// of n floats (kernel A) or rows of 8 (kernel B, dmat/omat [n][8]).
// `scratch` (kernel B) is the wrapper's, of the floats spectral_probe_info
// gives: 17 * n_pad + 4, n_pad = n_obj rounded up to MMA_CHUNK.
extern "C" int spectral_probe_fori(int n, int n_obj, const void* geom,
                                   const void* ox, const void* oy,
                                   const void* oz, const void* dx,
                                   const void* dy, const void* dz, void* t,
                                   void* win, void* stream) {
  using namespace spectral_probe;
  if (n <= 0) return 0;
  if (n_obj < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_fori(n, n_obj, PROBE_F(geom), PROBE_F(ox), PROBE_F(oy), PROBE_F(oz),
                          PROBE_F(dx), PROBE_F(dy), PROBE_F(dz), static_cast<float*>(t),
                          static_cast<float*>(win), st);
}

extern "C" int spectral_probe_mma(int n, int n_obj, const void* dmat,
                                  const void* omat, const void* cmat,
                                  const void* cc, const void* dov,
                                  const void* oov, const void* av, void* scratch,
                                  void* t, void* win, void* stream) {
  using namespace spectral_probe;
  if (n <= 0) return 0;
  if (n_obj < 8 || n_obj % 8 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)launch_mma(n, n_obj, PROBE_F(dmat), PROBE_F(omat), PROBE_F(cmat), PROBE_F(cc),
                         PROBE_F(dov), PROBE_F(oov), PROBE_F(av),
                         static_cast<uint32_t*>(scratch), static_cast<float*>(t),
                         static_cast<float*>(win), st);
}

// The layout of this build's kernels at n_obj spheres, into out[3]: the
// most spheres a block of kernel A holds in shared memory, kernel B's, and
// the floats of kernel B's scratch (0 beyond its limit). The wrappers
// refuse more spheres before any launch.
extern "C" int spectral_probe_info(int n_obj, int* out) {
  using namespace spectral_probe;
  if (n_obj < 0) return (int)cudaErrorInvalidValue;
  out[0] = FORI_MAX_SPHERES;
  out[1] = MMA_MAX_SPHERES;
  out[2] = n_obj <= MMA_MAX_SPHERES ? 17 * table_spheres(n_obj) + 4 : 0;
  return 0;
}
