// Fused 1x1 conv + BatchNorm affine + activation (K4), hand-written for
// Hopper (sm_90a), behind one extern "C" launcher that returns
// cudaGetLastError() so the wrapper (ops/pallas_conv.py:conv1x1_bn_act) can
// raise.
//
// Replaces: paddle_tpu/ops/pallas_conv.py:_pallas_matmul_affine (its
// pallas_call, body _fused_kernel), the TPU kernel behind the op
// fused_conv1x1_bn_act.
//
// Contract:
//   Y[m, n] = act( (sum_k X[m, k] * W[n, k]) * scale[n] + shift[n] )
// X (M, K) row-major is the NHWC activation (M = B*H*W, K = C); W (N, K)
// row-major is the OIHW 1x1 weight as (O, C); scale and shift (N,) are the
// folded BN affine, already in X's type; act is none or ReLU. The sum is
// f32; the affine and the activation are applied in f32 to the f32 sum,
// and Y (M, N) row-major is rounded once to X's type (f32 or bf16), as the
// reference kernel does. M, N and K are arbitrary: edge tiles are masked
// and K is zero-padded in shared memory.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense, 67 TFLOP/s f32
// outside the tensor cores), at ResNet-50's bottleneck shapes (batch 128,
// 224x224): in bf16 the 13.15 GFLOP of each reduce conv (256->64@56 ...
// 2048->512@7) take 13.3 us on the tensor cores, while X, W and Y are
// 257 / 128.6 / 64.7 / 34.2 MB, 76.7 / 38.4 / 19.3 / 10.2 us: bytes bound
// all but the last. In f32 the operations take 196 us and bound them all.
//
// Three bodies; the launcher picks one by type, shape and alignment alone
// (conv1x1_bn_act_plan), never after a failure:
//
// - bf16, wgmma (conv1x1_wgmma_kernel), wherever TMA can describe the
//   operands: K % 8 == 0 and N % 8 == 0, X, W and Y 16-byte aligned,
//   scale and shift 4-byte aligned. X (M, K) is a K-major A operand and
//   W (N, K) a K-major B operand of wgmma, so neither is transposed.
//   A persistent grid of one CTA per SM (at most one per output tile)
//   walks the 128 x BN tiles of Y with N fastest, so the CTAs that run
//   together share one X row block and X comes from device memory about
//   once; W (at most 2 MB) stays in L2. BN is 64 where N <= 64, else 128.
//   Each CTA is warp-specialised: one producer warp issues TMA loads of
//   64-deep K slices (128 bytes of bf16, the 128-byte swizzle) of X (128
//   rows) and W (BN rows) into a ring of 8 (BN 64) or 6 (BN 128) stages,
//   each with a full and an empty mbarrier; two consumer warpgroups of 64
//   rows each run four wgmma m64nBNk16 per slice on the stages that have
//   arrived, keep one slice's products in flight, and release a stage
//   once its products are done. setmaxnreg moves registers from the
//   producer (40 a thread) to the consumers (232). The ring runs across
//   tiles, so the next tile's loads overlap this tile's epilogue. The
//   epilogue works on the f32 accumulator fragments in registers: scale
//   and shift of the thread's columns, the affine, the act, one rounding;
//   each consumer writes its 64 x BN half as bf16 pairs into 64 x 64
//   boxes of shared memory laid out with the 128-byte swizzle (a warp's
//   stores hit 32 distinct banks), and one thread hands the boxes to TMA
//   stores, which write whole lines and drop what lies past M and N. The
//   stores drain while the consumer multiplies the next tile; its boxes
//   are written again only once the stores have read them. No split-K
//   and no atomics: every output is one fixed chain of products, so a
//   launch is bitwise repeatable.
//   At ResNet-50's 12 stride-1 1x1 shapes (batch 128) the tiles are
//   128 x 64 at 64->64 @56 and 256->64 @56, 128 x 128 at the other ten.
//   A 128 x 256 tile (n256 wgmma, 128 accumulators a thread) left room
//   for 3 stages beside its output boxes; it won by 2-4% at two of them
//   (64->256 @56, 512->2048 @7) and lost at the other ten (PERF.md,
//   Findings).
//   Built: 168 registers a thread, no local memory, 214,016 (BN 64) or
//   230,400 (BN 128) bytes of dynamic shared memory, 1 CTA an SM.
// - bf16, WMMA (conv1x1_bf16_kernel), every other bf16 shape: one CTA per
//   128 x 64 tile, 256 threads, 32-deep K slices double-buffered through
//   registers and shared memory, 8 warps of 32 x 32 WMMA m16n16k16 blocks,
//   the accumulators through shared memory for the epilogue; 16-byte loads
//   where K % 8 == 0 and the bases are aligned, else scalar.
// - f32 (conv1x1_f32_kernel): plain FMA (TF32 would break the f32
//   contract), the same 128 x 64 tiles, 16-deep slices stored K-major in
//   shared memory, each thread an 8 x 4 register block.
//
// The TMA descriptors are encoded on the host at each launch through
// libcuda's cuTensorMapEncodeTiled, fetched with the runtime's entry-point
// query (cudaGetDriverEntryPointByVersion): no link to libcuda.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "kernel_info.cuh"

namespace wmma = nvcuda::wmma;

namespace {

constexpr int kBM = 128;         // rows of Y per CTA
constexpr int kBN = 64;          // columns of Y per CTA
constexpr int kThreads = 256;

// ---------------------------------------------------------------- bf16 ---

typedef __nv_bfloat16 bf16;
constexpr int kBK16 = 32;                 // K per slice
constexpr int kLD16 = kBK16 + 8;          // padded smem row (elements)
constexpr int kLDC = kBN + 4;             // f32 epilogue tile row (floats)
constexpr int kStage16 = (kBM + kBN) * kLD16;            // elements per stage
constexpr int kSmem16 = 2 * kStage16 * 2;                // bytes, 2 stages
constexpr int kSmemC = kBM * kLDC * 4;                   // epilogue tile
constexpr int kSmemBytes16 = kSmem16 > kSmemC ? kSmem16 : kSmemC;

// 8 bf16 of row `row` (of `rows`) at column k0 (of K) of a row-major
// (rows, K) matrix, zero outside it.
template <bool kVec>
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ a,
                                       long long row, long long rows,
                                       int k0, int K) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const bf16* p = a + row * (long long)K + k0;
  if (kVec) {
    if (k0 < K) v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    unsigned short h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = 0;
      if (k0 + j < K) {
        h[j] = __bfloat16_as_ushort(p[j]);
      }
    }
    v.x = h[0] | ((unsigned)h[1] << 16);
    v.y = h[2] | ((unsigned)h[3] << 16);
    v.z = h[4] | ((unsigned)h[5] << 16);
    v.w = h[6] | ((unsigned)h[7] << 16);
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv1x1_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ scale,
                    const bf16* __restrict__ shift, bf16* __restrict__ y,
                    int M, int N, int K, int relu) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes16];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  float* ctile = reinterpret_cast<float*>(smem);

  const int n_tiles = (N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 32;        // warp's rows in the tile
  const int wn = (warp & 1) * 32;         // warp's columns

  // per slice: X tile 128 x 32 = 512 vectors of 8 (2 per thread), W tile
  // 64 x 32 = 256 vectors (1 per thread); vector v covers row v / 4,
  // columns (v % 4) * 8 ..
  uint4 ra[2], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      ra[i] = load8<kVec>(x, m0 + (v >> 2), M, k0 + (v & 3) * 8, K);
    }
    rb = load8<kVec>(w, n0 + (tid >> 2), N, k0 + (tid & 3) * 8, K);
  };
  auto stash = [&](int s) {
    bf16* a = stages + s * kStage16;
    bf16* b = a + kBM * kLD16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      *reinterpret_cast<uint4*>(a + (v >> 2) * kLD16 + (v & 3) * 8) = ra[i];
    }
    *reinterpret_cast<uint4*>(b + (tid >> 2) * kLD16 + (tid & 3) * 8) = rb;
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int slices = (K + kBK16 - 1) / kBK16;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < slices; ++t) {
    const int s = t & 1;
    if (t + 1 < slices) fetch((t + 1) * kBK16);
    const bf16* a = stages + s * kStage16;
    const bf16* b = a + kBM * kLD16;
#pragma unroll
    for (int kk = 0; kk < kBK16; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a + (wm + i * 16) * kLD16 + kk, kLD16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b + (wn + j * 16) * kLD16 + kk, kLD16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (t + 1 < slices) stash(s ^ 1);
    __syncthreads();
  }

  // epilogue: the f32 sums through shared memory (the stages are dead
  // after the last __syncthreads), affine + act in f32, one rounding
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ctile + (wm + i * 16) * kLDC + wn + j * 16,
                              acc[i][j], kLDC, wmma::mem_row_major);
  __syncthreads();
  // each thread: one column (coalesced along the row), every 4th row
  const int c = tid & (kBN - 1);
  const int n = n0 + c;
  if (n >= N) return;
  const float sc = __bfloat162float(scale[n]);
  const float sh = __bfloat162float(shift[n]);
  for (int r = tid >> 6; r < kBM; r += kThreads / kBN) {
    const long long m = m0 + r;
    if (m >= M) break;
    float v = ctile[r * kLDC + c] * sc + sh;
    if (relu) v = fmaxf(v, 0.f);
    y[m * N + n] = __float2bfloat16(v);
  }
}

// ----------------------------------------------------------------- f32 ---

constexpr int kBK32 = 16;                 // K per slice
constexpr int kLDA32 = kBM + 4;           // K-major smem rows (floats)
constexpr int kLDB32 = kBN + 4;

// 4 floats of row `row` at column k0, zero outside the matrix
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ a,
                                        long long row, long long rows,
                                        int k0, int K) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows) return v;
  const float* p = a + row * (long long)K + k0;
  if (kVec) {
    if (k0 < K) v = __ldg(reinterpret_cast<const float4*>(p));
  } else {
    if (k0 < K) v.x = p[0];
    if (k0 + 1 < K) v.y = p[1];
    if (k0 + 2 < K) v.z = p[2];
    if (k0 + 3 < K) v.w = p[3];
  }
  return v;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
conv1x1_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift, float* __restrict__ y,
                   int M, int N, int K, int relu) {
  __shared__ __align__(16) float as[2][kBK32][kLDA32];
  __shared__ __align__(16) float bs[2][kBK32][kLDB32];

  const int n_tiles = (N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % n_tiles) * kBN;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;      // rows ty*8 .. +7
  const int tx = tid & 15;      // columns tx*4 .. +3

  // per slice: X tile 128 x 16 = 512 float4 (2 per thread), W tile 64 x 16
  // = 256 float4 (1 per thread); float4 v covers row v / 4, columns
  // (v % 4) * 4 ..; stored transposed (K-major)
  float4 ra[2], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      ra[i] = load4<kVec>(x, m0 + (v >> 2), M, k0 + (v & 3) * 4, K);
    }
    rb = load4<kVec>(w, n0 + (tid >> 2), N, k0 + (tid & 3) * 4, K);
  };
  auto stash = [&](int s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = tid + i * kThreads;
      const int row = v >> 2, k = (v & 3) * 4;
      as[s][k + 0][row] = ra[i].x;
      as[s][k + 1][row] = ra[i].y;
      as[s][k + 2][row] = ra[i].z;
      as[s][k + 3][row] = ra[i].w;
    }
    const int row = tid >> 2, k = (tid & 3) * 4;
    bs[s][k + 0][row] = rb.x;
    bs[s][k + 1][row] = rb.y;
    bs[s][k + 2][row] = rb.z;
    bs[s][k + 3][row] = rb.w;
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int slices = (K + kBK32 - 1) / kBK32;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int t = 0; t < slices; ++t) {
    const int s = t & 1;
    if (t + 1 < slices) fetch((t + 1) * kBK32);
#pragma unroll
    for (int k = 0; k < kBK32; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[s][k][ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[s][k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[s][k][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (t + 1 < slices) stash(s ^ 1);
    __syncthreads();
  }

  float sc[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx * 4 + j;
    sc[j] = n < N ? scale[n] : 0.f;
    sh[j] = n < N ? shift[n] : 0.f;
  }
  const int nb = n0 + tx * 4;
  // a whole float4 of Y when N % 4 == 0 (y is a fresh, aligned tensor)
  const bool vec_out = (N & 3) == 0 && nb < N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty * 8 + i;
    if (m >= M) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = acc[i][j] * sc[j] + sh[j];
      if (relu) v[j] = fmaxf(v[j], 0.f);
    }
    if (vec_out) {
      *reinterpret_cast<float4*>(y + m * N + nb) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nb + j < N) y[m * N + nb + j] = v[j];
    }
  }
}

// --------------------------------------------------------- bf16, wgmma ---

namespace wg {

constexpr int kBM = 128;              // rows of Y a tile
constexpr int kBK = 64;               // K a stage: 128 bytes of bf16
constexpr int kConsumers = 2;         // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kSmemBytes = 224 * 1024;  // the ring and the output tiles
constexpr int kMaxStages = 8;
constexpr int kOutBox = 64;             // a TMA store box: 64 x 64 bf16

template <int kBN>
struct Tile {
  static constexpr int kStageA = kBM * kBK * 2;
  static constexpr int kStage = kStageA + kBN * kBK * 2;
  // each consumer's 64 x kBN output half, as kBN / 64 swizzled boxes
  static constexpr int kOutHalf = 64 * kBN * 2;
  static constexpr int kOut = kConsumers * kOutHalf;
  static constexpr int kFit = (kSmemBytes - kOut) / kStage;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  // + 1024: the ring is aligned to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = kStages * kStage + kOut + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed. A
// barrier that never completes (a fault in the kernel) traps after about
// 2^32 cycles rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 32)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// One TMA box of `map` at (c0 = K, c1 = row) into shared memory at `dst`,
// completing `bytes` of the barrier's transaction count; rows and K past
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1)
      : "memory");
}

// One TMA box of shared memory at `src` to `map` at (c0 = column, c1 =
// row); what lies past the tensor's edges is not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The thread's TMA stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Shared-memory writes of this thread become visible to TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// A barrier of one warpgroup's 128 threads.
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand laid out by TMA
// with the 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes
// apart (the stride byte offset); the leading byte offset is unused for a
// swizzled K-major operand. A 16-deep step along K adds 32 bytes to the
// start address (2 in its 16-byte units).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(kPending)
               : "memory");
}

// Orders the accumulators' reads after the wait that completed them.
template <int kN>
__device__ __forceinline__ void fence_acc(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x N, f32, N / 2 registers a thread) += A (64 x 16) . B (16 x N),
// A and B bf16 in shared memory, both K-major and 128-byte swizzled
// (descriptors da, db); scale_d 0 overwrites D instead of adding to it.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kBN>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBN / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (kBN == 64) {
    wgmma_n64(d, da, db, scale_d);
  } else {
    wgmma_n128(d, da, db, scale_d);
  }
}

// Persistent: CTA i takes tiles i, i + gridDim.x, ... of the (M / 128) x
// (N / kBN) tiles, N fastest. Warpgroup 0 produces (one thread issues the
// TMA loads), warpgroups 1 and 2 consume rows 0-63 and 64-127 of a tile.
template <int kBN>
__global__ void __launch_bounds__(kThreads, 1)
conv1x1_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap ty,
                     const bf16* __restrict__ scale,
                     const bf16* __restrict__ shift, int M, int N, int K,
                     int relu) {
  using T = Tile<kBN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) unsigned long long bars[2 * T::kStages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * T::kStages;
  const int n_tiles = (N + kBN - 1) / kBN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int slices = (K + kBK - 1) / kBK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;"
                 :: "n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * kBM;
        const int n0 = (t % n_tiles) * kBN;
        for (int s = 0; s < slices; ++s) {
          // a fresh barrier passes the wait on parity 1 at once
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t a = ring + stage * T::kStage;
          const uint32_t full = full0 + 8 * stage;
          mbar_expect_tx(full, T::kStage);
          tma_load(a, &tx, full, s * kBK, m0);
          tma_load(a + T::kStageA, &tw, full, s * kBK, n0);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;"
                 :: "n"(kConsumerRegs));
    const int c = wgi - 1;                  // rows c * 64 .. + 63 of a tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t out_half = ring + T::kStages * T::kStage + c * T::kOutHalf;
    float acc[kBN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * kBM;
      const int n0 = (t % n_tiles) * kBN;
      int prev = 0;
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a = ring + stage * T::kStage;
        const uint64_t da = sw128_desc(a + c * 64 * 128);
        const uint64_t db = sw128_desc(a + T::kStageA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_tile<kBN>(acc, da + 2 * kk, db + 2 * kk,
                          (s > 0 || kk > 0) ? 1 : 0);
        wgmma_commit();
        // the previous slice's products are done: release its stage
        wgmma_wait<1>();
        if (s > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);

      // epilogue on the fragments: acc[4j + 2h + e] is row
      // 16 warp + lane / 4 + 8 h of the half, column 8 j + 2 (lane % 4) + e.
      // The affine and the act in f32, one rounding, a bf16 pair into the
      // half's output boxes (64 columns each, 128-byte rows, their 16-byte
      // chunks swizzled by row % 8 = lane / 4 as TMA lays them out, so a
      // warp's stores hit 32 distinct banks), then TMA stores of the boxes,
      // which drop what lies past M and N. The boxes are reused once the
      // last tile's stores have read them.
      if (leader) bulk_wait_read();
      warpgroup_bar(1 + c);
      const int rl = warp * 16 + lane / 4;
      const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        float2 sc = make_float2(0.f, 0.f);
        float2 sh = make_float2(0.f, 0.f);
        if (col < N) {                      // N % 8 == 0: the pair is in
          sc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(scale + col));
          sh = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(shift + col));
        }
        const uint32_t chunk =
            out_half + (j / 8) * (kOutBox * kOutBox * 2)
            + (((j % 8) ^ (lane / 4)) * 16) + 4 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] * sc.x + sh.x;
          float v1 = acc[4 * j + 2 * h + 1] * sc.y + sh.y;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
          st_shared(chunk + (rl + 8 * h) * 128,
                    *reinterpret_cast<const uint32_t*>(&pair));
        }
      }
      fence_async_shared();
      warpgroup_bar(1 + c);
      if (leader) {
#pragma unroll
        for (int b = 0; b < kBN / kOutBox; ++b)
          tma_store(&ty, out_half + b * (kOutBox * kOutBox * 2),
                    n0 + b * kOutBox, m0 + c * 64);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
  }
}

}  // namespace wg

// ----------------------------------------------------------------- host ---

// the bodies, as conv1x1_bn_act_plan reports them
enum Body { kBodyWmma = 0, kBodyWgmma = 1, kBodyF32 = 2 };

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, through the runtime (no link to
// libcuda); null if the installed libcuda has none.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map of a row-major (rows, K) matrix, boxes of
// 64 (wg::kBK, wg::kOutBox) x box_rows, 128-byte swizzle, zeros past the
// edges on a load.
bool encode(EncodeTiledFn fn, CUtensorMap* map, const void* base, int rows,
            int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {(cuuint32_t)wg::kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

int ring_stages(int bn) {
  return bn == 64 ? wg::Tile<64>::kStages : wg::Tile<128>::kStages;
}

// The current card's SMs, read once a card
cudaError_t sm_count(int* sms) {
  static int known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) known[dev] = *sms;
  return e;
}

struct Plan {
  int body;
  int bn;        // columns of a tile (the 128-row tile of every body)
  int grid;      // CTAs
  int stages;    // K slices in flight in shared memory
};

// The body, tile and grid for one call, from the type, the shape and the
// pointers' alignment alone.
int make_plan(int M, int N, int K, int is_bf16, const void* x, const void* w,
              const void* scale, const void* shift, const void* y,
              Plan* p) {
  if (M < 0 || N < 0 || K < 1) return (int)cudaErrorInvalidValue;
  const long long m_tiles = (M + kBM - 1) / kBM;
  const bool tma = is_bf16 && K % 8 == 0 && N % 8 == 0 && aligned(x, 16)
                   && aligned(w, 16) && aligned(y, 16) && aligned(scale, 4)
                   && aligned(shift, 4);
  if (!tma) {
    const long long tiles = m_tiles * ((N + kBN - 1) / kBN);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    *p = {is_bf16 ? kBodyWmma : kBodyF32, kBN, (int)tiles, 2};
    return 0;
  }
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int bn = N <= 64 ? 64 : 128;
  const long long tiles = m_tiles * ((N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  *p = {kBodyWgmma, bn, (int)(tiles < sms ? tiles : sms), ring_stages(bn)};
  return 0;
}

// setmaxnreg hands the producer's registers to the consumers; the CTA
// must hold enough of them, or the consumers' request would never be met
template <int kBN>
cudaError_t wgmma_ready() {
  static cudaError_t status = cudaErrorNotReady;
  if (status == cudaErrorNotReady) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, wg::conv1x1_wgmma_kernel<kBN>);
    if (e == cudaSuccess
        && a.numRegs * wg::kThreads < wg::kProducerRegs * 128
                                      + wg::kConsumerRegs * 128
                                        * wg::kConsumers)
      e = cudaErrorInvalidConfiguration;
    status = e;
  }
  if (status != cudaSuccess) return status;
  return cudaFuncSetAttribute(wg::conv1x1_wgmma_kernel<kBN>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              wg::Tile<kBN>::kSmem);
}

template <int kBN>
int launch_wgmma(const Plan& p, const void* x, const void* w,
                 const void* scale, const void* shift, void* y, int M, int N,
                 int K, int relu, cudaStream_t st) {
  cudaError_t e = wgmma_ready<kBN>();
  if (e != cudaSuccess) return (int)e;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tx, tw, ty;
  if (!encode(fn, &tx, x, M, K, wg::kBM) || !encode(fn, &tw, w, N, K, kBN)
      || !encode(fn, &ty, y, M, N, wg::kOutBox))
    return (int)cudaErrorInvalidValue;
  wg::conv1x1_wgmma_kernel<kBN>
      <<<p.grid, wg::kThreads, wg::Tile<kBN>::kSmem, st>>>(
          tx, tw, ty, static_cast<const bf16*>(scale),
          static_cast<const bf16*>(shift), M, N, K, relu);
  return (int)cudaGetLastError();
}

template <int kBN>
int wgmma_info(int* out) {
  const cudaError_t e = wgmma_ready<kBN>();
  if (e != cudaSuccess) return (int)e;
  return describe_kernel(wg::conv1x1_wgmma_kernel<kBN>, wg::kThreads,
                         wg::Tile<kBN>::kSmem, out);
}

}  // namespace

extern "C" {

// x (M, K), w (N, K), scale and shift (N,), y (M, N), all row-major and of
// one type: bf16 when `is_bf16` is non-zero, else f32. Launches on
// `stream` the body conv1x1_bn_act_plan names.
int conv1x1_bn_act(const void* x, const void* w, const void* scale,
                   const void* shift, void* y, int M, int N, int K,
                   int is_bf16, int relu, void* stream) {
  Plan p;
  const int err = make_plan(M, N, K, is_bf16, x, w, scale, shift, y, &p);
  if (err != 0) return err;
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.body == kBodyWgmma) {
    switch (p.bn) {
      case 64:
        return launch_wgmma<64>(p, x, w, scale, shift, y, M, N, K, relu, st);
      case 128:
        return launch_wgmma<128>(p, x, w, scale, shift, y, M, N, K, relu, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const bool aligned16 = aligned(x, 16) && aligned(w, 16);
  if (p.body == kBodyWmma) {
    typedef __nv_bfloat16 T;
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    const T* sc = static_cast<const T*>(scale);
    const T* sh = static_cast<const T*>(shift);
    T* yp = static_cast<T*>(y);
    if (aligned16 && K % 8 == 0)
      conv1x1_bf16_kernel<true><<<(unsigned)p.grid, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
    else
      conv1x1_bf16_kernel<false><<<(unsigned)p.grid, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
  } else {
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    const float* sc = static_cast<const float*>(scale);
    const float* sh = static_cast<const float*>(shift);
    float* yp = static_cast<float*>(y);
    if (aligned16 && K % 4 == 0)
      conv1x1_f32_kernel<true><<<(unsigned)p.grid, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
    else
      conv1x1_f32_kernel<false><<<(unsigned)p.grid, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
  }
  return (int)cudaGetLastError();
}

// What conv1x1_bn_act would launch for these arguments: out[0] the body
// (0 bf16 WMMA, 1 bf16 wgmma, 2 f32), out[1] the tile's columns, out[2]
// the CTAs, out[3] the K slices in flight.
int conv1x1_bn_act_plan(int M, int N, int K, int is_bf16, const void* x,
                        const void* w, const void* scale, const void* shift,
                        const void* y, int* out) {
  Plan p;
  const int err = make_plan(M, N, K, is_bf16, x, w, scale, shift, y, &p);
  if (err != 0) return err;
  out[0] = p.body;
  out[1] = p.bn;
  out[2] = p.grid;
  out[3] = p.stages;
  return 0;
}

// What a body was built with (body as in conv1x1_bn_act_plan; bn, the
// wgmma body's tile columns, 64 or 128): out[0] registers, out[1]
// local memory a thread, out[2] static and out[3] dynamic shared memory,
// out[4] CTAs an SM, out[5] threads.
int conv1x1_bn_act_kernel_info(int body, int bn, int* out) {
  switch (body) {
    case kBodyWmma:
      return describe_kernel(conv1x1_bf16_kernel<true>, kThreads, 0, out);
    case kBodyF32:
      return describe_kernel(conv1x1_f32_kernel<true>, kThreads, 0, out);
    case kBodyWgmma:
      switch (bn) {
        case 64: return wgmma_info<64>(out);
        case 128: return wgmma_info<128>(out);
        default: return (int)cudaErrorInvalidValue;
      }
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* conv1x1_bn_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
