// Flash attention for the training path, forward and backward, hand-written
// for Hopper (sm_90a). Three kernels, each behind an extern "C" launcher that
// takes a FlashParams block (mirrored by a ctypes Structure in ops/nn_ops.py)
// and the stream, and returns cudaGetLastError() so the wrapper can raise.
//
// Contract (paddle_tpu/ops/nn_ops.py:fused_attention):
//   O = softmax(Q . K^T * sm_scale + bias) . V          over (B, H, S, D)
// with `causal` the top-left tril(ones(Sq, Sk)): query row i attends keys
// j <= i; masked keys are never scored. The bias is f32 and broadcast: the
// wrapper passes bias.expand(B, H, Sq, Sk) as a pointer and four strides,
// 0 on the broadcast dimensions, so no (B, H, Sq, Sk) copy is ever made.
// Q, K, V and dO are f32 or bf16 with any row strides (the head-split views
// of the projections are read in place); O, dQ, dK and dV are written
// contiguous in the same type. Every sum is f32. Each kernel has two
// bodies: bf16 runs its products on the tensor cores (WMMA m16n16k16, bf16
// in, f32 accumulate; P and dS enter the second product as two bf16 terms,
// so they keep about 16 bits); f32 runs them as plain f32 FMA, since TF32
// would break the f32 contract.
//
// Shapes that bound them, at BERT-base's training step (B 128, H 12, S 128,
// D 64, bf16) on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//
// flash_attention_fwd                                               (K3)
//   Replaces: the stock Pallas flash_attention forward that
//   paddle_tpu/ops/nn_ops.py:fused_attention calls on a TPU
//   (jax/experimental/pallas/ops/tpu/flash_attention.py:758, with `ab`).
//   The stock kernel computes (Q.K^T + ab) * sm_scale, so the JAX op
//   pre-divides its bias; this one computes the contract directly.
//   Bound: about 101 MB (Q, K, V read, O and the f32 log-sum-exp written)
//   against 6.4 GFLOP: bytes, about 30 us; the operations take about 6.5 us
//   on the bf16 tensor cores.
//   Design: one CTA per (64-row query tile, head, batch).
//   The query tile is staged once; K/V tiles of 64 keys stream through
//   shared memory with an online softmax, so the score matrix never reaches
//   device memory and each Q, K, V row is read from device memory once per
//   query tile (S 128 needs two). Writes O and the per-row log-sum-exp
//   (B, H, Sq) f32 that the backward recomputes P from. Under causal the
//   key loop stops at the tile's last causal key.
//
// flash_attention_bwd_dkv                                           (K3b)
//   Replaces: the stock _flash_attention_bwd_dkv (flash_attention.py:1121).
//   Computes dK and dV from Q, K, V, bias, dO, the log-sum-exp and
//   di = rowsum(O . dO) (computed by the wrapper in torch, as the stock code
//   computes it outside its Pallas calls).
//   Bound: about 152 MB against 12.9 GFLOP: bytes, about 45 us; the
//   operations take about 13 us on the bf16 tensor cores.
//   Design: one CTA per (64-key tile, head, batch) looping over query tiles:
//   K and V are staged once, Q and dO stream. It recomputes
//   P^T = exp(K.Q^T * sm_scale + bias - lse), takes dS^T = P^T o (dP^T - di)
//   and accumulates dV = P^T.dO and dK = dS^T.Q * sm_scale in registers.
//   Every dK/dV row is owned by one CTA, so no atomics are needed and the
//   gradients are deterministic.
//
// flash_attention_bwd_dq                                            (K3b)
//   Replaces: the stock _flash_attention_bwd_dq (flash_attention.py:1456).
//   Bound: about 127 MB against 9.7 GFLOP: bytes, about 38 us; the
//   operations take about 10 us on the bf16 tensor cores.
//   Design: one CTA per (64-row query tile, head, batch) looping over key
//   tiles; Q and dO staged once. dQ = dS.K * sm_scale accumulates in
//   registers. When the bias needs a gradient it also writes dS in f32
//   (B, H, Sq, Sk), which the wrapper sums to the bias's shape, as the stock
//   backward returns `ds`.
//
// The three kernels use the same exponent (expf of the same f32 score, bias
// added after the scale), the same mask and the same log-sum-exp, so the P
// the backward recomputes is the P the forward normalised.
//
// What the design does about the bound: it keeps every S x S intermediate
// (scores, P, dP, dS) in registers and shared memory, so device memory
// traffic is the inputs and outputs alone, the bytes the bound counts plus
// one re-read of K/V (forward, dQ) or Q/dO (dK/dV) per 64-row tile.
// - bf16 (the training path): 4 warps per 64-row tile, each a 16-row strip;
//   the tiles stay bf16 in shared memory and feed WMMA directly; the
//   softmax and gradient elementwise work reads the f32 score strips from
//   shared memory (WMMA's accumulator layout is opaque). The products no
//   longer bound the kernel; the elementwise pass through shared memory
//   does. mma.sync with register-resident softmax, then wgmma with TMA, is
//   the way on.
// - f32: 256 threads per tile, each owning a 4 x 4 register block of the
//   64 x 64 score tile (rows and columns 16 apart, so the float4 reads of
//   shared rows padded by 4 floats are free of bank conflicts), compute-
//   bound on the f32 FMA pipe.
//
// Head dims: D in {16, 32, 64, 128}, templated. Shared memory is dynamic
// (up to 170 KB for the f32 dK/dV at D 128), raised above 48 KB with
// cudaFuncSetAttribute before each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace wmma = nvcuda::wmma;

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;     // dO, the gradient of O
  const float* bias;   // (B, H, Sq, Sk) through bias_str, or null
  float* lse;          // (B, H, Sq) f32: written by fwd, read by backward
  const float* di;     // (B, H, Sq) f32: rowsum(O . dO)
  void* o;             // (B, H, Sq, D) contiguous
  void* dq;            // (B, H, Sq, D) contiguous
  void* dk;            // (B, H, Sk, D) contiguous
  void* dv;            // (B, H, Sk, D) contiguous
  float* ds;           // (B, H, Sq, Sk) f32 zero-filled, or null
  long long q_str[3];  // element strides over (b, h, row); the last dim is 1
  long long k_str[3];
  long long v_str[3];
  long long do_str[3];
  long long bias_str[4];
  int B, H, Sq, Sk, D, causal, bf16;
  float sm_scale;
};

namespace {

constexpr int kTile = 64;            // query rows and keys per tile
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 scores each
constexpr int kLDS = kTile + 4;      // padded row stride of a 64 x 64 tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// reductions over the 16 threads of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Stage `rows` rows of a (rows, kD) f32 tile with row stride `stride` into
// shared rows of kD + 4; rows past `rows` are zero.
template <int kD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride, int rows) {
  constexpr int kChunks = kD / 4;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      v = *reinterpret_cast<const float4*>(src + r * stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * (kD + 4) + c * 4) = v;
  }
}

// acc[i][j] = sum_d a[rg + 16 i][d] * b[cg + 16 j][d]  (rows of kD + 4)
template <int kD>
__device__ __forceinline__ void score_tile(const float* a, const float* b,
                                           float acc[4][4], int rg, int cg) {
  constexpr int kLD = kD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (rg + 16 * i) * kLD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (cg + 16 * j) * kLD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(x[i].x, y[j].x, s);
        s = fmaf(x[i].y, y[j].y, s);
        s = fmaf(x[i].z, y[j].z, s);
        s = fmaf(x[i].w, y[j].w, s);
        acc[i][j] = s;
      }
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// acc[i][c] += sum_t p[rg + 16 i][t] * b[t][cg + 16 c]
// p: 64 x 64 tile (rows of kLDS); b: 64 rows of kD + 4
template <int kD>
__device__ __forceinline__ void pv_tile(const float* p, const float* b,
                                        float acc[4][kD / 16], int rg,
                                        int cg) {
  constexpr int kLD = kD + 4;
  constexpr int kC = kD / 16;
#pragma unroll 2
  for (int t = 0; t < kTile; t += 4) {
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = *reinterpret_cast<const float4*>(p + (rg + 16 * i) * kLDS + t);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      float y[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) y[c] = b[(t + tt) * kLD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = lane4(x[i], tt);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(pi, y[c], acc[i][c]);
      }
    }
  }
}

// The attended, scaled, biased score of (query qi, key kj), or -inf where
// the key is masked or out of range (qi is a real row).
__device__ __forceinline__ float biased(const FlashParams& p,
                                        const float* bias, float s, int qi,
                                        int kj) {
  if (kj >= p.Sk || (p.causal && kj > qi)) return neg_inf();
  float x = s * p.sm_scale;
  if (bias != nullptr)
    x += bias[qi * p.bias_str[2] + kj * p.bias_str[3]];
  return x;
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLD = kD + 4;
  constexpr int kC = kD / 16;
  float* q_s = smem;
  float* k_s = q_s + kTile * kLD;
  float* v_s = k_s + kTile * kLD;
  float* p_s = v_s + kTile * kLD;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int q_rows = min(kTile, p.Sq - q0);

  const float* q = static_cast<const float*>(p.q) + b * p.q_str[0] + h * p.q_str[1]
      + q0 * p.q_str[2];
  const float* kp = static_cast<const float*>(p.k) + b * p.k_str[0] + h * p.k_str[1];
  const float* vp = static_cast<const float*>(p.v) + b * p.v_str[0] + h * p.v_str[1];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];

  load_tile<kD>(q_s, q, p.q_str[2], q_rows);

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = p.causal ? min(p.Sk, q0 + kTile) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int k_rows = min(kTile, p.Sk - k0);
    __syncthreads();              // the last tile's readers are done
    load_tile<kD>(k_s, kp + k0 * p.k_str[2], p.k_str[2], k_rows);
    load_tile<kD>(v_s, vp + k0 * p.v_str[2], p.v_str[2], k_rows);
    __syncthreads();

    float s[4][4];
    score_tile<kD>(q_s, k_s, s, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      // rows past Sq keep their scores unbiased; they are never stored
      const int qi = q0 + r;
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        s[i][j] = qi < p.Sq ? biased(p, bias, s[i][j], qi, kj)
            : (kj < p.Sk ? s[i][j] * p.sm_scale : neg_inf());
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      // a row with no attended key so far keeps p = 0 and alpha = 0
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - m_use);
        p_s[r * kLDS + cg + 16 * j] = pj;
        sum += pj;
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<kD>(p_s, v_s, acc, rg, cg);
  }

  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0;
  float* o = static_cast<float*>(p.o) + row0 * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r < q_rows) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        store(o + (size_t)r * kD + cg + 16 * c, acc[i][c] * inv);
      if (cg == 0) p.lse[row0 + r] = m[i] + logf(l[i]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLD = kD + 4;
  constexpr int kC = kD / 16;
  float* q_s = smem;
  float* do_s = q_s + kTile * kLD;
  float* k_s = do_s + kTile * kLD;
  float* v_s = k_s + kTile * kLD;
  float* ds_s = v_s + kTile * kLD;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int q_rows = min(kTile, p.Sq - q0);

  const float* q = static_cast<const float*>(p.q) + b * p.q_str[0] + h * p.q_str[1]
      + q0 * p.q_str[2];
  const float* dop = static_cast<const float*>(p.d_o) + b * p.do_str[0]
      + h * p.do_str[1] + q0 * p.do_str[2];
  const float* kp = static_cast<const float*>(p.k) + b * p.k_str[0] + h * p.k_str[1];
  const float* vp = static_cast<const float*>(p.v) + b * p.v_str[0] + h * p.v_str[1];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0;
  float* ds = p.ds == nullptr ? nullptr : p.ds + row0 * p.Sk;

  load_tile<kD>(q_s, q, p.q_str[2], q_rows);
  load_tile<kD>(do_s, dop, p.do_str[2], q_rows);
  float lse[4], di[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    lse[i] = r < q_rows ? p.lse[row0 + r] : 0.f;
    di[i] = r < q_rows ? p.di[row0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  const int k_end = p.causal ? min(p.Sk, q0 + kTile) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int k_rows = min(kTile, p.Sk - k0);
    __syncthreads();
    load_tile<kD>(k_s, kp + k0 * p.k_str[2], p.k_str[2], k_rows);
    load_tile<kD>(v_s, vp + k0 * p.v_str[2], p.v_str[2], k_rows);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_tile<kD>(q_s, k_s, s, rg, cg);
    score_tile<kD>(do_s, v_s, dp, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + cg + 16 * j;
        float d = 0.f;
        if (r < q_rows) {
          const float x = biased(p, bias, s[i][j], qi, kj);
          const float pij = x == neg_inf() ? 0.f : expf(x - lse[i]);
          d = pij * (dp[i][j] - di[i]);
          if (ds != nullptr && kj < p.Sk) ds[(size_t)r * p.Sk + kj] = d;
        }
        ds_s[r * kLDS + cg + 16 * j] = d;
      }
    }
    __syncthreads();
    pv_tile<kD>(ds_s, k_s, acc, rg, cg);
  }

  float* dq = static_cast<float*>(p.dq) + row0 * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r < q_rows) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        store(dq + (size_t)r * kD + cg + 16 * c, acc[i][c] * p.sm_scale);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const FlashParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLD = kD + 4;
  constexpr int kC = kD / 16;
  float* k_s = smem;
  float* v_s = k_s + kTile * kLD;
  float* q_s = v_s + kTile * kLD;
  float* do_s = q_s + kTile * kLD;
  float* pt_s = do_s + kTile * kLD;
  float* dst_s = pt_s + kTile * kLDS;
  float* lse_s = dst_s + kTile * kLDS;
  float* di_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rg = threadIdx.x >> 4;
  const int cg = threadIdx.x & 15;
  const int k_rows = min(kTile, p.Sk - k0);

  const float* qp = static_cast<const float*>(p.q) + b * p.q_str[0] + h * p.q_str[1];
  const float* dop = static_cast<const float*>(p.d_o) + b * p.do_str[0]
      + h * p.do_str[1];
  const float* kp = static_cast<const float*>(p.k) + b * p.k_str[0] + h * p.k_str[1]
      + k0 * p.k_str[2];
  const float* vp = static_cast<const float*>(p.v) + b * p.v_str[0] + h * p.v_str[1]
      + k0 * p.v_str[2];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];
  const size_t bh_rows = ((size_t)b * p.H + h) * p.Sq;

  load_tile<kD>(k_s, kp, p.k_str[2], k_rows);
  load_tile<kD>(v_s, vp, p.v_str[2], k_rows);
  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk[i][c] = 0.f;
      dv[i][c] = 0.f;
    }

  // under causal (top-left) key k0 is first attended by query row k0
  const int q_begin = p.causal ? (k0 / kTile) * kTile : 0;
  for (int q0 = q_begin; q0 < p.Sq; q0 += kTile) {
    const int q_rows = min(kTile, p.Sq - q0);
    __syncthreads();
    load_tile<kD>(q_s, qp + q0 * p.q_str[2], p.q_str[2], q_rows);
    load_tile<kD>(do_s, dop + q0 * p.do_str[2], p.do_str[2], q_rows);
    for (int t = threadIdx.x; t < kTile; t += kThreads) {
      lse_s[t] = t < q_rows ? p.lse[bh_rows + q0 + t] : 0.f;
      di_s[t] = t < q_rows ? p.di[bh_rows + q0 + t] : 0.f;
    }
    __syncthreads();

    // transposed tiles: rows are keys, columns are queries
    float st[4][4], dpt[4][4];
    score_tile<kD>(k_s, q_s, st, rg, cg);
    score_tile<kD>(v_s, do_s, dpt, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const int qi = q0 + c;
        float pij = 0.f;
        if (c < q_rows) {
          const float x = biased(p, bias, st[i][j], qi, kj);
          pij = x == neg_inf() ? 0.f : expf(x - lse_s[c]);
        }
        pt_s[r * kLDS + c] = pij;
        dst_s[r * kLDS + c] = pij * (dpt[i][j] - di_s[c]);
      }
    }
    __syncthreads();
    pv_tile<kD>(pt_s, do_s, dv, rg, cg);
    pv_tile<kD>(dst_s, q_s, dk, rg, cg);
  }

  const size_t key0 = ((size_t)b * p.H + h) * p.Sk + k0;
  float* dkp = static_cast<float*>(p.dk) + key0 * kD;
  float* dvp = static_cast<float*>(p.dv) + key0 * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r < k_rows) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        store(dkp + (size_t)r * kD + cg + 16 * c, dk[i][c] * p.sm_scale);
        store(dvp + (size_t)r * kD + cg + 16 * c, dv[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (WMMA m16n16k16, f32 accumulators)
// ---------------------------------------------------------------------------
//
// One CTA of 4 warps per 64-row tile, each warp a 16-row strip. Tiles stay
// bf16 in shared memory (rows padded by 8 elements); a warp's 16 x 64 score
// strips go through f32 shared memory for the elementwise softmax and
// gradient work (the accumulator fragments' layout is opaque). P and dS
// enter the second product as two bf16 terms, hi + lo (split_store), so it
// carries about 16 bits of them rather than bf16's 8 and the result agrees
// with the f32 plain version to its own output rounding. The sums of the
// softmax (max, l, the log-sum-exp) are f32 over the f32 scores.

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kWarpsTC = 4;
constexpr int kThreadsTC = kWarpsTC * 32;
constexpr int kLDB = kTile + 8;      // bf16 row stride of a 16 x 64 strip
constexpr int kLDF = kTile + 4;      // f32 row stride of a 16 x 64 strip

template <int kD>
__host__ __device__ constexpr int tc_ld() { return kD + 8; }
// f32 scratch rows wide enough for a 64-key strip or a D-wide output
template <int kD>
__host__ __device__ constexpr int sc_ld() {
  return (kD > kTile ? kD : kTile) + 4;
}

// Copy a (rows, kD) bf16 tile with row stride `stride` into shared rows of
// kD + 8; rows past `rows` are zero.
template <int kD>
__device__ __forceinline__ void load_tile_tc(bf16* dst, const bf16* src,
                                             long long stride, int rows) {
  constexpr int kChunks = kD / 8;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreadsTC) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + r * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * tc_ld<kD>() + c * 8) = v;
  }
}

// out[16][64] (f32, row stride ldo) = a[16][kD] . b[64][kD]^T
template <int kD>
__device__ __forceinline__ void strip_abt(const bf16* a, const bf16* b,
                                          float* out, int ldo) {
  FragC c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < kD; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, tc_ld<kD>());
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragBc fb;
      wmma::load_matrix_sync(fb, b + j * 16 * tc_ld<kD>() + kk, tc_ld<kD>());
      wmma::mma_sync(c[j], fa, fb, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(out + j * 16, c[j], ldo, wmma::mem_row_major);
}

// acc[n] += p[16][64] . b[64][kD], n over the kD / 16 column blocks
template <int kD>
__device__ __forceinline__ void strip_pb(const bf16* p, const bf16* b,
                                         FragC (&acc)[kD / 16]) {
#pragma unroll
  for (int kk = 0; kk < kTile; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk, kLDB);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + kk * tc_ld<kD>() + n * 16, tc_ld<kD>());
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// x as two bf16 terms, hi + lo, at hi[i] and lo[i]: together about 16 bits
// of x's mantissa, where bf16 alone keeps 8
__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, int i,
                                            float x) {
  const bf16 h = __float2bfloat16(x);
  hi[i] = h;
  lo[i] = __float2bfloat16(x - __bfloat162float(h));
}

// Write a warp's 16 x kD result (fragments scaled by `scale`) as bf16 rows
// `out + r * kD`, r < rows, through the warp's f32 scratch.
template <int kD>
__device__ __forceinline__ void store_strip(FragC (&acc)[kD / 16], float scale,
                                            float* scratch, bf16* out,
                                            int rows, int lane) {
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
    wmma::store_matrix_sync(scratch + n * 16, acc[n], sc_ld<kD>(),
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int e = lane; e < 16 * kD; e += 32) {
    const int r = e / kD;
    const int c = e % kD;
    if (r < rows) store(out + (size_t)r * kD + c, scratch[r * sc_ld<kD>() + c]);
  }
  __syncwarp();
}

template <int kD>
__global__ void __launch_bounds__(kThreadsTC)
flash_fwd_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kLD = tc_ld<kD>();
  constexpr int kSC = sc_ld<kD>();
  constexpr int kOL = kD + 4;
  constexpr int kWarpF = 16 * kSC + 16 * kOL + 16;   // floats per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTile * kLD;
  bf16* v_s = k_s + kTile * kLD;
  float* fbase = reinterpret_cast<float*>(v_s + kTile * kLD);
  float* sc = fbase + warp * kWarpF;   // scores, then the P.V strip
  float* os = sc + 16 * kSC;           // the running O strip
  float* rs = os + 16 * kOL;           // per-row alpha
  bf16* pb = reinterpret_cast<bf16*>(fbase + kWarpsTC * kWarpF)
      + warp * 2 * 16 * kLDB;        // P as hi + lo
  bf16* pl = pb + 16 * kLDB;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_rows = min(kTile, p.Sq - q0);
  const int w_rows = q_rows - warp * 16;           // this warp's real rows
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_str[0]
      + h * p.q_str[1] + q0 * p.q_str[2];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_str[0]
      + h * p.k_str[1];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_str[0]
      + h * p.v_str[1];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];

  load_tile_tc<kD>(q_s, q, p.q_str[2], q_rows);
  for (int e = lane; e < 16 * kOL; e += 32) os[e] = 0.f;

  // softmax work: lane pair (2r, 2r + 1) owns row r, 32 columns each
  const int r = lane >> 1;
  const int c0 = (lane & 1) * 32;
  const int qi = q0 + warp * 16 + r;
  float m = neg_inf();
  float l = 0.f;

  const int k_end = p.causal ? min(p.Sk, q0 + kTile) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int k_rows = min(kTile, p.Sk - k0);
    __syncthreads();
    load_tile_tc<kD>(k_s, kp + k0 * p.k_str[2], p.k_str[2], k_rows);
    load_tile_tc<kD>(v_s, vp + k0 * p.v_str[2], p.v_str[2], k_rows);
    __syncthreads();

    strip_abt<kD>(q_s + warp * 16 * kLD, k_s, sc, kSC);
    __syncwarp();
    float* row = sc + r * kSC;
    float mx = neg_inf();
    for (int c = c0; c < c0 + 32; ++c) {
      const int kj = k0 + c;
      // rows past Sq keep their scores unbiased; they are never stored
      const float x = qi < p.Sq ? biased(p, bias, row[c], qi, kj)
          : (kj < p.Sk ? row[c] * p.sm_scale : neg_inf());
      row[c] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(kFull, mx, 1)));
    const float m_use = m_new == neg_inf() ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    float sum = 0.f;
    for (int c = c0; c < c0 + 32; ++c) {
      const float pj = expf(row[c] - m_use);
      split_store(pb, pl, r * kLDB + c, pj);
      sum += pj;
    }
    l = l * alpha + sum + __shfl_xor_sync(kFull, sum, 1);
    m = m_new;
    if ((lane & 1) == 0) rs[r] = alpha;
    __syncwarp();

    FragC acc[kD / 16];
#pragma unroll
    for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
    strip_pb<kD>(pb, v_s, acc);
    strip_pb<kD>(pl, v_s, acc);
#pragma unroll
    for (int n = 0; n < kD / 16; ++n)
      wmma::store_matrix_sync(sc + n * 16, acc[n], kSC, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 16 * kD; e += 32) {
      const int rr = e / kD;
      const int cc = e % kD;
      os[rr * kOL + cc] = os[rr * kOL + cc] * rs[rr] + sc[rr * kSC + cc];
    }
    __syncwarp();
  }

  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0 + warp * 16;
  if ((lane & 1) == 0) {
    rs[r] = 1.f / l;
    if (r < w_rows) p.lse[row0 + r] = m + logf(l);
  }
  __syncwarp();
  bf16* o = static_cast<bf16*>(p.o) + row0 * kD;
  for (int e = lane; e < 16 * kD; e += 32) {
    const int rr = e / kD;
    const int cc = e % kD;
    if (rr < w_rows) store(o + (size_t)rr * kD + cc, os[rr * kOL + cc] * rs[rr]);
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreadsTC)
flash_bwd_dq_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kLD = tc_ld<kD>();
  constexpr int kSC = sc_ld<kD>();
  constexpr int kWarpF = 16 * kSC + 16 * kLDF + 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kTile * kLD;
  bf16* k_s = do_s + kTile * kLD;
  bf16* v_s = k_s + kTile * kLD;
  float* fbase = reinterpret_cast<float*>(v_s + kTile * kLD);
  float* s_w = fbase + warp * kWarpF;   // scores, then the dQ strip
  float* dp_w = s_w + 16 * kSC;
  float* lse_w = dp_w + 16 * kLDF;
  float* di_w = lse_w + 16;
  bf16* ds_b = reinterpret_cast<bf16*>(fbase + kWarpsTC * kWarpF)
      + warp * 2 * 16 * kLDB;        // dS as hi + lo
  bf16* ds_l = ds_b + 16 * kLDB;

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_rows = min(kTile, p.Sq - q0);
  const int w_rows = q_rows - warp * 16;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_str[0]
      + h * p.q_str[1] + q0 * p.q_str[2];
  const bf16* dop = static_cast<const bf16*>(p.d_o) + b * p.do_str[0]
      + h * p.do_str[1] + q0 * p.do_str[2];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_str[0]
      + h * p.k_str[1];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_str[0]
      + h * p.v_str[1];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0 + warp * 16;
  float* ds = p.ds == nullptr ? nullptr : p.ds + row0 * p.Sk;

  load_tile_tc<kD>(q_s, q, p.q_str[2], q_rows);
  load_tile_tc<kD>(do_s, dop, p.do_str[2], q_rows);
  if (lane < 16) {
    lse_w[lane] = lane < w_rows ? p.lse[row0 + lane] : 0.f;
    di_w[lane] = lane < w_rows ? p.di[row0 + lane] : 0.f;
  }
  FragC acc[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int k_end = p.causal ? min(p.Sk, q0 + kTile) : p.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    const int k_rows = min(kTile, p.Sk - k0);
    __syncthreads();
    load_tile_tc<kD>(k_s, kp + k0 * p.k_str[2], p.k_str[2], k_rows);
    load_tile_tc<kD>(v_s, vp + k0 * p.v_str[2], p.v_str[2], k_rows);
    __syncthreads();

    strip_abt<kD>(q_s + warp * 16 * kLD, k_s, s_w, kSC);
    strip_abt<kD>(do_s + warp * 16 * kLD, v_s, dp_w, kLDF);
    __syncwarp();
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int rr = e / kTile;          // query row of the strip
      const int cc = e % kTile;          // key of the tile
      const int kj = k0 + cc;
      float d = 0.f;
      if (rr < w_rows) {
        const float x = biased(p, bias, s_w[rr * kSC + cc], q0 + warp * 16 + rr,
                               kj);
        const float pij = x == neg_inf() ? 0.f : expf(x - lse_w[rr]);
        d = pij * (dp_w[rr * kLDF + cc] - di_w[rr]);
        if (ds != nullptr && kj < p.Sk) ds[(size_t)rr * p.Sk + kj] = d;
      }
      split_store(ds_b, ds_l, rr * kLDB + cc, d);
    }
    __syncwarp();
    strip_pb<kD>(ds_b, k_s, acc);
    strip_pb<kD>(ds_l, k_s, acc);
  }

  store_strip<kD>(acc, p.sm_scale, s_w, static_cast<bf16*>(p.dq) + row0 * kD,
                  w_rows, lane);
}

template <int kD>
__global__ void __launch_bounds__(kThreadsTC)
flash_bwd_dkv_tc_kernel(const FlashParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kLD = tc_ld<kD>();
  constexpr int kSC = sc_ld<kD>();
  constexpr int kWarpF = 16 * kSC + 16 * kLDF;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * kLD;
  bf16* q_s = v_s + kTile * kLD;
  bf16* do_s = q_s + kTile * kLD;
  float* lse_s = reinterpret_cast<float*>(do_s + kTile * kLD);
  float* di_s = lse_s + kTile;
  float* fbase = di_s + kTile;
  float* st_w = fbase + warp * kWarpF;  // S^T strip, then the outputs
  float* dpt_w = st_w + 16 * kSC;
  // P^T and dS^T, each as hi + lo
  bf16* pt_b = reinterpret_cast<bf16*>(fbase + kWarpsTC * kWarpF)
      + warp * 4 * 16 * kLDB;
  bf16* pt_l = pt_b + 16 * kLDB;
  bf16* dst_b = pt_l + 16 * kLDB;
  bf16* dst_l = dst_b + 16 * kLDB;

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_rows = min(kTile, p.Sk - k0);
  const int w_rows = k_rows - warp * 16;
  const bf16* qp = static_cast<const bf16*>(p.q) + b * p.q_str[0]
      + h * p.q_str[1];
  const bf16* dop = static_cast<const bf16*>(p.d_o) + b * p.do_str[0]
      + h * p.do_str[1];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_str[0]
      + h * p.k_str[1] + k0 * p.k_str[2];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_str[0]
      + h * p.v_str[1] + k0 * p.v_str[2];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];
  const size_t bh_rows = ((size_t)b * p.H + h) * p.Sq;

  load_tile_tc<kD>(k_s, kp, p.k_str[2], k_rows);
  load_tile_tc<kD>(v_s, vp, p.v_str[2], k_rows);
  FragC dk[kD / 16], dv[kD / 16];
#pragma unroll
  for (int n = 0; n < kD / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  // under causal (top-left) key k0 is first attended by query row k0
  const int q_begin = p.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < p.Sq; q0 += kTile) {
    const int q_rows = min(kTile, p.Sq - q0);
    __syncthreads();
    load_tile_tc<kD>(q_s, qp + q0 * p.q_str[2], p.q_str[2], q_rows);
    load_tile_tc<kD>(do_s, dop + q0 * p.do_str[2], p.do_str[2], q_rows);
    for (int t = threadIdx.x; t < kTile; t += kThreadsTC) {
      lse_s[t] = t < q_rows ? p.lse[bh_rows + q0 + t] : 0.f;
      di_s[t] = t < q_rows ? p.di[bh_rows + q0 + t] : 0.f;
    }
    __syncthreads();

    // transposed strips: rows are this warp's 16 keys, columns the queries
    strip_abt<kD>(k_s + warp * 16 * kLD, q_s, st_w, kSC);
    strip_abt<kD>(v_s + warp * 16 * kLD, do_s, dpt_w, kLDF);
    __syncwarp();
    for (int e = lane; e < 16 * kTile; e += 32) {
      const int rr = e / kTile;          // key of the strip
      const int cc = e % kTile;          // query of the tile
      float pij = 0.f;
      if (cc < q_rows) {
        const float x = biased(p, bias, st_w[rr * kSC + cc], q0 + cc,
                               k0 + warp * 16 + rr);
        pij = x == neg_inf() ? 0.f : expf(x - lse_s[cc]);
      }
      split_store(pt_b, pt_l, rr * kLDB + cc, pij);
      split_store(dst_b, dst_l, rr * kLDB + cc,
                  pij * (dpt_w[rr * kLDF + cc] - di_s[cc]));
    }
    __syncwarp();
    strip_pb<kD>(pt_b, do_s, dv);
    strip_pb<kD>(pt_l, do_s, dv);
    strip_pb<kD>(dst_b, q_s, dk);
    strip_pb<kD>(dst_l, q_s, dk);
  }

  const size_t key0 = ((size_t)b * p.H + h) * p.Sk + k0 + warp * 16;
  store_strip<kD>(dk, p.sm_scale, st_w, static_cast<bf16*>(p.dk) + key0 * kD,
                  w_rows, lane);
  store_strip<kD>(dv, 1.f, st_w, static_cast<bf16*>(p.dv) + key0 * kD,
                  w_rows, lane);
}

template <int kD>
constexpr size_t tile_bytes() { return (size_t)kTile * (kD + 4) * sizeof(float); }
constexpr size_t score_bytes() { return (size_t)kTile * kLDS * sizeof(float); }
template <int kD>
constexpr size_t tc_tile_bytes() { return (size_t)kTile * tc_ld<kD>() * sizeof(bf16); }
constexpr size_t tc_strip_bytes() { return (size_t)16 * kLDB * sizeof(bf16); }

template <typename Kernel>
int launch(Kernel kernel, const FlashParams& p, int tiles, int threads,
           size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, p.H, p.B), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_fwd(const FlashParams& p, cudaStream_t st) {
  const int tiles = (p.Sq + kTile - 1) / kTile;
  if (p.bf16)
    return launch(flash_fwd_tc_kernel<kD>, p, tiles, kThreadsTC,
                  3 * tc_tile_bytes<kD>() + kWarpsTC * 2 * tc_strip_bytes()
                      + kWarpsTC * sizeof(float)
                            * (16 * sc_ld<kD>() + 16 * (kD + 4) + 16),
                  st);
  return launch(flash_fwd_kernel<kD>, p, tiles, kThreads,
                3 * tile_bytes<kD>() + score_bytes(), st);
}

template <int kD>
int launch_dq(const FlashParams& p, cudaStream_t st) {
  const int tiles = (p.Sq + kTile - 1) / kTile;
  if (p.bf16)
    return launch(flash_bwd_dq_tc_kernel<kD>, p, tiles, kThreadsTC,
                  4 * tc_tile_bytes<kD>() + kWarpsTC * 2 * tc_strip_bytes()
                      + kWarpsTC * sizeof(float)
                            * (16 * sc_ld<kD>() + 16 * kLDF + 32),
                  st);
  return launch(flash_bwd_dq_kernel<kD>, p, tiles, kThreads,
                4 * tile_bytes<kD>() + score_bytes(), st);
}

template <int kD>
int launch_dkv(const FlashParams& p, cudaStream_t st) {
  const int tiles = (p.Sk + kTile - 1) / kTile;
  if (p.bf16)
    return launch(flash_bwd_dkv_tc_kernel<kD>, p, tiles, kThreadsTC,
                  4 * tc_tile_bytes<kD>() + 2 * kTile * sizeof(float)
                      + kWarpsTC * 4 * tc_strip_bytes()
                      + kWarpsTC * sizeof(float)
                            * (16 * sc_ld<kD>() + 16 * kLDF),
                  st);
  return launch(flash_bwd_dkv_kernel<kD>, p, tiles, kThreads,
                4 * tile_bytes<kD>() + 2 * score_bytes()
                    + 2 * kTile * sizeof(float),
                st);
}

}  // namespace

#define FLASH_DISPATCH(LAUNCH)                                              \
  const FlashParams& p = *static_cast<const FlashParams*>(params);          \
  const cudaStream_t st = static_cast<cudaStream_t>(stream);                \
  switch (p.D) {                                                            \
    case 16: return LAUNCH<16>(p, st);                                      \
    case 32: return LAUNCH<32>(p, st);                                      \
    case 64: return LAUNCH<64>(p, st);                                      \
    case 128: return LAUNCH<128>(p, st);                                    \
    default: return (int)cudaErrorInvalidValue;                             \
  }

extern "C" {

int flash_attention_fwd(const void* params, void* stream) {
  FLASH_DISPATCH(launch_fwd)
}

int flash_attention_bwd_dkv(const void* params, void* stream) {
  FLASH_DISPATCH(launch_dkv)
}

int flash_attention_bwd_dq(const void* params, void* stream) {
  FLASH_DISPATCH(launch_dq)
}

int flash_attention_params_size() { return (int)sizeof(FlashParams); }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
