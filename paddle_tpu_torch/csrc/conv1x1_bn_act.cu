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
// Design: one CTA per 128 x 64 tile of Y, 256 threads, a K loop over
// 32-deep (bf16) or 16-deep (f32) slices staged through double-buffered
// shared memory; the next slice is loaded into registers while the current
// one is multiplied, so one __syncthreads per slice suffices. The tile's
// CTAs walk N fastest, so the CTAs that read one X row block run together
// and X comes from device memory about once (what the bytes bound needs).
// - bf16: 8 warps, each a 32 x 32 block of WMMA m16n16k16 products (bf16
//   in, f32 accumulate) on the tensor cores. W's (N, K) rows are exactly
//   the column-major B operand. The accumulators go through shared memory
//   (WMMA's register layout is opaque) for the epilogue.
// - f32: plain FMA (TF32 would break the f32 contract), each thread an
//   8 x 4 register block; slices are stored K-major in shared memory so a
//   thread reads its 8 rows and 4 columns as float4s.
// Loads are 16-byte vectors where K and the pointers allow (K % 8 == 0 for
// bf16, K % 4 == 0 for f32, 16-byte aligned bases), else scalar with the
// same masking. wgmma with TMA and a deeper cp.async pipeline are the way
// to the bound; this kernel is the simple, right first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

}  // namespace

extern "C" {

// x (M, K), w (N, K), scale and shift (N,), y (M, N), all row-major and of
// one type: bf16 when `is_bf16` is non-zero, else f32. Launches on
// `stream`.
int conv1x1_bn_act(const void* x, const void* w, const void* scale,
                   const void* shift, void* y, int M, int N, int K,
                   int is_bf16, int relu, void* stream) {
  if (M < 0 || N < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles =
      (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x)
                         | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  if (is_bf16) {
    typedef __nv_bfloat16 T;
    const T* xp = static_cast<const T*>(x);
    const T* wp = static_cast<const T*>(w);
    const T* sc = static_cast<const T*>(scale);
    const T* sh = static_cast<const T*>(shift);
    T* yp = static_cast<T*>(y);
    if (aligned && K % 8 == 0)
      conv1x1_bf16_kernel<true><<<(unsigned)tiles, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
    else
      conv1x1_bf16_kernel<false><<<(unsigned)tiles, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
  } else {
    const float* xp = static_cast<const float*>(x);
    const float* wp = static_cast<const float*>(w);
    const float* sc = static_cast<const float*>(scale);
    const float* sh = static_cast<const float*>(shift);
    float* yp = static_cast<float*>(y);
    if (aligned && K % 4 == 0)
      conv1x1_f32_kernel<true><<<(unsigned)tiles, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
    else
      conv1x1_f32_kernel<false><<<(unsigned)tiles, kThreads, 0, st>>>(
          xp, wp, sc, sh, yp, M, N, K, relu);
  }
  return (int)cudaGetLastError();
}

const char* conv1x1_bn_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
