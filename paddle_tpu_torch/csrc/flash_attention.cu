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
// bodies: bf16 runs its products on the tensor cores (bf16 in, f32
// accumulate; P and dS enter the second product as two bf16 terms, hi +
// lo, so they keep about 16 bits); f32 runs them as plain f32 FMA, since
// TF32 would break the f32 contract. The three bf16 bodies run mma.sync
// m16n8k16 with every accumulator in registers.
//
// Saved row statistics. The forward writes, for each query row, the max m
// of its scores x = s sm_scale + bias and log l, l = sum exp(x - m) over
// its keys, as two f32 (B, H, Sq) rows (natural log), and the backward
// recomputes P = exp((x - m) - log l). One log-sum-exp m + log l would do
// for ordinary rows, but where a finfo.min bias masks every key of a row
// (m = -FLT_MAX) the sum rounds back to m and drops log l: P would come
// out 1 on every key where the softmax gives 1/S.
//
// The causal mask follows the JAX op, which fills masked scores with
// finfo.min: they weigh nothing unless every attended key of the row
// scores -FLT_MAX too, and then the row's scores all tie and the softmax
// weighs all Sk keys alike, those past the diagonal included. The kernels
// never visit the masked tiles, so they patch such rows afterwards
// (lowest_row and the helpers beside it): O is the mean of all Sk V rows
// and log l = log Sk (forward), and each masked key's dV gains dO / Sk
// (dK/dV). dS stays 0 on masked pairs: the mask's `where` passes a masked
// score no gradient.
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
//   Bound: about 101 MB (Q, K, V read, O and the f32 row statistics
//   written) against 6.4 GFLOP: bytes, about 30 us. With P as hi + lo the
//   products are 9.7 GFLOP, about 10 us at the tensor cores' peak.
//   Design (bf16): one CTA of 4 warps per (64-row query tile, head, batch),
//   each warp a 16-row strip; Q and two stages of 64-key K/V tiles reach
//   shared memory through cp.async, the next K/V tile in flight while the
//   current one is computed. S = Q.K^T runs on mma.sync with Q and K
//   fragments from ldmatrix; the scores stay in the accumulator registers,
//   where scale, bias, mask, the row max and sum (quad shuffles) and
//   p = exp2((x - m) log2 e) are applied (x and m in the natural-log
//   domain: a finfo.min bias times log2 e would leave the f32 range); the
//   accumulator layout is the next product's A layout, so P is split into
//   hi and lo fragments in registers and P.V runs on mma.sync with V from
//   ldmatrix.trans. O is rescaled and summed in registers, normalised once
//   and staged through the Q buffer for 16-byte stores. What bounds it on
//   this card: not bytes (it moves them at about half the memory rate) but
//   the issue of its products, ldmatrix reads and elementwise work: 12
//   warps an SM (143 registers, 3 CTAs) hold too little in flight to hide
//   the mma.sync latencies, and hi + lo costs a third more products than
//   one bf16 P. An interior tile (no bias, no ragged or causal edge) takes
//   a branch-free path; the masked path tests each score.
//   Writes O and the row statistics (m, log l) that the backward
//   recomputes P from, in natural log (log l = (log2 l) ln 2).
//
// flash_attention_bwd_dkv                                           (K3b)
//   Replaces: the stock _flash_attention_bwd_dkv (flash_attention.py:1121).
//   Computes dK and dV from Q, K, V, bias, dO, the row statistics and
//   di = rowsum(O . dO) (computed by the wrapper in torch, as the stock code
//   computes it outside its Pallas calls).
//   Bound: about 152 MB against 12.9 GFLOP: bytes, about 45 us; with P^T
//   and dS^T as hi + lo the products are 19.3 GFLOP, about 20 us at peak.
//   Design (bf16): one CTA of 4 warps per (64-key tile, head, batch), each
//   warp a 16-key strip that owns its dK and dV rows (no atomics, so the
//   gradients are deterministic). K and V are loaded once; Q, dO and their
//   m, log l and di rows stream in 64-query tiles through a two-stage
//   cp.async ring. Per 32-query block, in registers: S^T = K.Q^T and
//   dP^T = V.dO^T on mma.sync; P^T = exp2((x - m) log2 e - log2 l),
//   dS^T = P^T o (dP^T - di); then dV += P^T.dO and dK += dS^T.Q with P^T
//   and dS^T re-laid as hi + lo A fragments and dO and Q from
//   ldmatrix.trans. dK and dV stay in registers for the whole loop and are
//   written once, scaled, through the strip's own K and V rows. What bounds
//   it: as the forward, the issue of six products per block (168
//   registers, 12 warps an SM) rather than bytes.
//
// flash_attention_bwd_dq                                         (K3b-dq)
//   Replaces: the stock _flash_attention_bwd_dq (flash_attention.py:1456).
//   Bound: about 127 MB against 9.7 GFLOP: bytes, about 38 us; with dS as
//   hi + lo the products are 12.9 GFLOP, about 13 us at the tensor cores'
//   peak.
//   Design (bf16): one CTA of 4 warps per (64-row query tile, head,
//   batch), each warp a 16-row strip, as the forward. Q and dO are loaded
//   once; K/V tiles of 64 stream through a two-stage cp.async ring. Per
//   32-key block, in registers: S = Q.K^T and dP = dO.V^T on mma.sync (K
//   and V as n-major B fragments from ldmatrix), P = exp2((x - m) log2 e
//   - log2 l), dS = P o (dP - di), then dQ += dS.K with dS re-laid as hi +
//   lo A fragments and K from ldmatrix.trans. dQ stays in registers for
//   the whole loop and is written once, scaled, through the strip's own Q
//   rows. When the bias needs a gradient it also writes dS in f32
//   (B, H, Sq, Sk) straight from the accumulators, which the wrapper sums
//   to the bias's shape, as the stock backward returns `ds`. A separate
//   kernel from dK/dV, so neither needs atomics and both are bitwise
//   repeatable. What bounds it: as the forward, the issue of its five
//   products per block (S, dP, two for dQ's hi + lo) rather than bytes.
//
// The three kernels use the same mask and the same row statistics, and
// the same exponent up to rounding (expf in the f32 bodies, exp2 of the
// same natural-log exponent times log2 e in the bf16 bodies), so the P the
// backward recomputes is the P the forward normalised.
//
// f32 bodies: 256 threads per 64-row tile, each owning a 4 x 4 register
// block of the 64 x 64 score tile (rows and columns 16 apart, so the
// float4 reads of shared rows padded by 4 floats are free of bank
// conflicts), compute-bound on the f32 FMA pipe.
//
// Head dims: D in {16, 32, 64, 128}, templated. Shared memory is dynamic
// (up to 170 KB for the f32 dK/dV at D 128), raised above 48 KB with
// cudaFuncSetAttribute once per kernel and device.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "kernel_info.cuh"

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* d_o;     // dO, the gradient of O
  const float* bias;   // (B, H, Sq, Sk) through bias_str, or null
  float* row_max;      // (B, H, Sq) f32: each row's max score m; written
  float* row_log_l;    // by fwd, read by backward; log l, l = sum exp(x - m)
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

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
  return __bfloat162float(*p);
}

// Patches for causal rows whose every attended key scores -FLT_MAX (the
// header's "causal mask"): the softmax weighs all Sk keys 1 / Sk there.
// lowest_row tells such a row by its max, and whether it has masked keys
// (it lies above the last key). Rare (a finfo.min mask over a whole causal
// row), so the patches read device memory directly.
__device__ __forceinline__ bool lowest_row(const FlashParams& p, float m,
                                           int qi) {
  return p.causal && m == -FLT_MAX && qi < p.Sq && qi < p.Sk - 1;
}

// sum over all Sk keys of V[key][c]
template <typename T>
__device__ float key_sum(const T* vp, long long stride, int sk, int c) {
  float s = 0.f;
  for (int j = 0; j < sk; ++j) s += load_f(vp + j * stride + c);
  return s;
}

// Whether any query row below `q_hi` (of the (b, h) rows from `rows`) is a
// lowest row: the dK/dV CTAs whose keys such rows mask ask this together
// (every thread of the CTA must call it).
__device__ __forceinline__ bool any_lowest_row(const FlashParams& p,
                                               const float* rows, int q_hi) {
  int any = 0;
  for (int i = threadIdx.x; i < min(q_hi, p.Sq); i += blockDim.x)
    any |= lowest_row(p, rows[i], i);
  return __syncthreads_or(any) != 0;
}

// dV of key kj, column c: what the lowest rows above it (which do not
// attend it) add, sum over those rows qi < kj of dO[qi][c] / Sk.
template <typename T>
__device__ float masked_dv(const FlashParams& p, const float* rows,
                           const T* dop, int kj, int c) {
  float s = 0.f;
  for (int qi = 0; qi < min(kj, p.Sq); ++qi)
    if (lowest_row(p, rows[qi], qi)) s += load_f(dop + qi * p.do_str[2] + c);
  return s / p.Sk;
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
    if (lowest_row(p, m[i], q0 + r)) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        acc[i][c] = key_sum(vp, p.v_str[2], p.Sk, cg + 16 * c);
      l[i] = (float)p.Sk;
    }
    if (r < q_rows) {
      const float inv = 1.f / l[i];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        store(o + (size_t)r * kD + cg + 16 * c, acc[i][c] * inv);
      if (cg == 0) {
        p.row_max[row0 + r] = m[i];
        p.row_log_l[row0 + r] = logf(l[i]);
      }
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
  float mx[4], ll[4], di[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    mx[i] = r < q_rows ? p.row_max[row0 + r] : 0.f;
    ll[i] = r < q_rows ? p.row_log_l[row0 + r] : 0.f;
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
          const float pij = x == neg_inf() ? 0.f : expf((x - mx[i]) - ll[i]);
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
  float* m_s = dst_s + kTile * kLDS;
  float* ll_s = m_s + kTile;
  float* di_s = ll_s + kTile;

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
      m_s[t] = t < q_rows ? p.row_max[bh_rows + q0 + t] : 0.f;
      ll_s[t] = t < q_rows ? p.row_log_l[bh_rows + q0 + t] : 0.f;
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
          pij = x == neg_inf() ? 0.f : expf((x - m_s[c]) - ll_s[c]);
        }
        pt_s[r * kLDS + c] = pij;
        dst_s[r * kLDS + c] = pij * (dpt[i][j] - di_s[c]);
      }
    }
    __syncthreads();
    pv_tile<kD>(pt_s, do_s, dv, rg, cg);
    pv_tile<kD>(dst_s, q_s, dk, rg, cg);
  }

  if (p.causal && any_lowest_row(p, p.row_max + bh_rows, k0 + kTile - 1)) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        dv[i][c] += masked_dv(p, p.row_max + bh_rows, dop, k0 + rg + 16 * i,
                              cg + 16 * c);
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
// bf16 forward and dK/dV: mma.sync m16n8k16 with the softmax in registers
// ---------------------------------------------------------------------------
//
// Each warp owns a 16-row strip (query rows in the forward, keys in dK/dV)
// and keeps every product's accumulator in registers. The fragment layouts
// of m16n8k16 (PTX ISA, "Matrix fragments for mma.m16n8k16"), lane = 4 g + t:
//   A (16 x 16, row-major)  a0: row g, cols 2t, 2t+1   a1: row g+8, cols 2t..
//                           a2: row g, cols 2t+8..     a3: row g+8, cols 2t+8..
//   B (16 x 8, k x n)       b0: rows 2t, 2t+1 of col g b1: rows 2t+8, 2t+9
//   C (16 x 8, f32)         c0, c1: row g, cols 2t, 2t+1; c2, c3: row g+8
// so the C of two neighbouring n-tiles is, element for element, the A of the
// next product over those 16 columns (acc_to_a), and P or dS never leave the
// registers. The lower column of each pair sits in the lower 16 bits.
//
// Tiles reach shared memory through cp.async (16 bytes a thread, ragged rows
// zero-filled by the src-size operand) in a two-stage ring, the next tile in
// flight while the current one is computed; rows are kD + 8 bf16 long, so
// the eight 16-byte rows an ldmatrix phase reads fall in distinct banks.

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes from global to shared memory, asynchronously; zeros unless `ok`
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes from global to shared memory, asynchronously; zero unless `ok`
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of the ith
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// d += a . b on the tensor cores: 16 x 16 bf16 by 16 x 8 bf16, f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: 2 ulp; -inf gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// (x, y) as two bf16 pairs, hi + lo: together about 16 bits of each, where
// bf16 alone keeps 8; x in the lower half
__device__ __forceinline__ void split2(float x, float y, unsigned& hi,
                                       unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of the 16 x 16 block whose columns are the
// accumulators c0 (columns 0-7) and c1 (columns 8-15).
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         unsigned (&hi)[4],
                                         unsigned (&lo)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// ldmatrix row addresses, for a warp reading a 16 x 16 block at (r0, c0) of
// a bf16 tile with rows of kLD:
// - as an A fragment, or as the B fragments (ldsm4_t) of two n-tiles of a
//   k x n block stored k-major: lane l gives row r0 + l % 16, col c0 + 8 (l/16)
template <int kLD>
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int r0, int c0,
                                              int lane) {
  return t + (r0 + (lane & 15)) * kLD + c0 + ((lane >> 4) << 3);
}
// - as the B fragments (ldsm4) of two n-tiles of an n x k block stored
//   n-major (rows r0..r0+15 are the n index, K rows in Q.K^T): matrices
//   (rows 0-7, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 0-7), (8-15, 8-15)
template <int kLD>
__device__ __forceinline__ const bf16* frag_bt(const bf16* t, int r0, int c0,
                                               int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kLD + c0
      + (((lane >> 3) & 1) << 3);
}

// Start copying a (rows, kD) bf16 tile with row stride `stride` into
// `n_rows` shared rows of kD + 8; rows past `rows` are zero-filled.
template <int kD, int kThr>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long stride, int rows,
                                                int n_rows) {
  constexpr int kChunks = kD / 8;
  for (int e = threadIdx.x; e < n_rows * kChunks; e += kThr) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const bool ok = r < rows;
    cp_async16(dst + r * (kD + 8) + c * 8, ok ? src + r * stride + c * 8 : src,
               ok);
  }
}

// Write a warp's 16 x kD f32 accumulators (scaled by `scale`, rows of the
// fragment layout) as bf16 rows `out + r * kD` for r < rows, staged through
// the warp's own 16 shared rows `stage` (rows of kD + 8) so that each lane
// stores 16 bytes at a time.
template <int kD>
__device__ __forceinline__ void store_rows(const float (&acc)[kD / 8][4],
                                           float scale0, float scale1,
                                           bf16* stage, bf16* out, int rows,
                                           int lane) {
  constexpr int kLD = kD + 8;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    const int c = 8 * n + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kLD + c) =
        __floats2bfloat162_rn(acc[n][0] * scale0, acc[n][1] * scale0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kLD + c) =
        __floats2bfloat162_rn(acc[n][2] * scale1, acc[n][3] * scale1);
  }
  __syncwarp();
  constexpr int kChunks = kD / 8;
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    if (r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)r * kD + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLD + c * 8);
  }
}

// The three mma.sync bodies' CTA shape: 4 warps, each a 16-row (forward,
// dQ) or 16-key (dK/dV) strip, and at D <= 64 3 CTAs an SM, which caps the
// registers at 170 a thread (D 128 asks for 2: its dK/dV accumulators alone
// take kD registers a thread); dK/dV works through each query tile in
// register blocks of 32 queries, dQ through each key tile whole (64 keys:
// 168 registers at D 64, no spills, 2-4% faster than blocks of 32 or 16).
// At BERT-base's shape on the H100 this is as fast as 4 CTAs an SM under a
// 128-register cap, which spills, and faster than 8 warps in 1 or 2 CTAs
// (PERF.md).
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows or keys a CTA takes
constexpr int kDkvSub = 32;
constexpr int kDqSub = 64;

// Forward, bf16. One CTA per (kMmaRows query rows, head, batch); warp w
// owns rows 16 w .. 16 w + 15 of the tile. K/V tiles of 64 keys stream
// through a two-stage cp.async ring; each tile re-reads the warp's Q
// fragments from shared memory (holding them would cost 4 kD / 16 registers
// a thread for two ldmatrix reads at S 128). The scores x = s sm_scale +
// bias, the running max m and sum l and the O accumulator stay in
// registers, and p = 2^((x - m) log2 e). x and m stay in the natural-log
// domain, so a bias near -FLT_MAX (a finfo.min mask) is never scaled out of
// the f32 range: a row whose every key it masks gets the same weight on
// every key, as the softmax gives it. O is normalised once and leaves
// through the Q buffer; m and log l go to the row statistics.
template <int kD>
__global__ void __launch_bounds__(kMmaThreads, kD <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const FlashParams p) {
  constexpr int kLD = kD + 8;
  constexpr int kBM = kMmaRows;
  constexpr int kThr = kMmaThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);          // [kBM][kLD]
  bf16* kv_s = q_s + kBM * kLD;          // [stage][K, V][kTile][kLD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_rows = min(kBM, p.Sq - q0);
  const int w0 = warp * 16;                       // the strip's first row
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_str[0]
      + h * p.q_str[1] + q0 * p.q_str[2];
  const bf16* kp = static_cast<const bf16*>(p.k) + b * p.k_str[0]
      + h * p.k_str[1];
  const bf16* vp = static_cast<const bf16*>(p.v) + b * p.v_str[0]
      + h * p.v_str[1];
  const float* bias = p.bias == nullptr ? nullptr
      : p.bias + b * p.bias_str[0] + h * p.bias_str[1];

  const int k_end = p.causal ? min(p.Sk, q0 + kBM) : p.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  auto load_kv = [&](int t) {
    const int k0 = t * kTile;
    const int rows = min(kTile, p.Sk - k0);
    bf16* ks = kv_s + (t & 1) * 2 * kTile * kLD;
    load_rows_async<kD, kThr>(ks, kp + k0 * p.k_str[2], p.k_str[2], rows,
                              kTile);
    load_rows_async<kD, kThr>(ks + kTile * kLD, vp + k0 * p.v_str[2],
                              p.v_str[2], rows, kTile);
  };
  load_rows_async<kD, kThr>(q_s, q, p.q_str[2], q_rows, kBM);
  load_kv(0);
  cp_async_commit();

  // this thread's two query rows: g and g + 8 of the strip
  const int qa = q0 + w0 + g;
  const int qb = qa + 8;
  const bool live = w0 < q_rows;
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {neg_inf(), neg_inf()};
  float l[2] = {0.f, 0.f};         // this thread's part of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kTile;
    const bf16* ks = kv_s + (t & 1) * 2 * kTile * kLD;
    const bf16* vs = ks + kTile * kLD;
    // under causal a tile that starts past the strip's last row is masked
    if (live && !(p.causal && k0 > q0 + w0 + 15)) {
      float s[kTile / 8][4];
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        unsigned qf[4];
        ldsm4(qf, frag_a<kLD>(q_s, w0, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < kTile / 16; ++np) {
          unsigned kf[4];
          ldsm4(kf, frag_bt<kLD>(ks, np * 16, kk * 16, lane));
          mma(s[2 * np], qf, kf[0], kf[1]);
          mma(s[2 * np + 1], qf, kf[2], kf[3]);
        }
      }

      // scale, bias and mask; keys past Sk and masked keys are -inf before
      // the row max. A tile with no bias, no key past Sk and (under causal)
      // no key past the strip's first row needs only the scale.
      const bool plain = bias == nullptr && k0 + kTile <= p.Sk
          && !(p.causal && k0 + kTile - 1 > q0 + w0);
      if (plain) {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= p.sm_scale;
      } else {
#pragma unroll
        for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qi = e < 2 ? qa : qb;
            const bool ok = kj < p.Sk && !(p.causal && kj > qi);
            float bv = 0.f;                       // rows past Sq: unbiased
            if (ok && bias != nullptr && qi < p.Sq)
              bv = bias[qi * p.bias_str[2] + kj * p.bias_str[3]];
            s[j][e] = ok ? fmaf(s[j][e], p.sm_scale, bv) : neg_inf();
          }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float mu[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        // a row with no attended key so far keeps p = 0 and alpha = 0
        mu[i] = m_new == neg_inf() ? 0.f : m_new;
        alpha[i] = exp2_approx((m[i] - mu[i]) * kLog2e);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pj = exp2_approx((s[j][e] - mu[e >> 1]) * kLog2e);
          s[j][e] = pj;
          l[e >> 1] += pj;
        }
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P . V, P as hi + lo A fragments straight from the scores
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        unsigned ph[4], pl[4];
        acc_to_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
        for (int dp = 0; dp < kD / 16; ++dp) {
          unsigned vf[4];
          ldsm4_t(vf, frag_a<kLD>(vs, kk * 16, dp * 16, lane));
          mma(o[2 * dp], ph, vf[0], vf[1]);
          mma(o[2 * dp], pl, vf[0], vf[1]);
          mma(o[2 * dp + 1], ph, vf[2], vf[3]);
          mma(o[2 * dp + 1], pl, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();              // the stage is free for the next load
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (lowest_row(p, m[i], i == 0 ? qa : qb)) {
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][2 * i] = key_sum(vp, p.v_str[2], p.Sk, 8 * n + 2 * t4);
        o[n][2 * i + 1] = key_sum(vp, p.v_str[2], p.Sk, 8 * n + 2 * t4 + 1);
      }
      l[i] = (float)p.Sk;
    }
  }
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0 + w0;
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (w0 + g + 8 * i < q_rows) {
        p.row_max[row0 + g + 8 * i] = m[i];
        p.row_log_l[row0 + g + 8 * i] = log2f(l[i]) * kLn2;
      }
    }
  }
  // the Q rows are free: only this warp read its strip, before the loop's
  // last barrier
  store_rows<kD>(o, 1.f / l[0], 1.f / l[1], q_s + w0 * kLD,
                 static_cast<bf16*>(p.o) + row0 * kD, q_rows - w0, lane);
}

// dK and dV, bf16. One CTA per (kMmaRows keys, head, batch); warp w owns
// keys 16 w .. 16 w + 15 and their dK and dV rows, so no two warps write
// one row and nothing is atomic. K and V are loaded once and re-read as A
// fragments; query tiles of 64 stream Q, dO and their m, log l and di rows
// through a two-stage cp.async ring. For each block of kDkvSub queries, in
// registers:
//   S^T = K.Q^T, dP^T = V.dO^T,
//   P^T = 2^((x - m) log2 e - log2 l), x = S^T sm_scale + bias (0 where
//         masked; x - m in the natural-log domain, as in the forward, so a
//         finfo.min bias stays finite),
//   dS^T = P^T o (dP^T - di),
//   dV += P^T.dO, dK += dS^T.Q (P^T and dS^T as hi + lo A fragments).
template <int kD>
__global__ void __launch_bounds__(kMmaThreads, kD <= 64 ? 3 : 2)
flash_bwd_dkv_mma_kernel(const FlashParams p) {
  constexpr int kLD = kD + 8;
  constexpr int kBN = kMmaRows;
  constexpr int kThr = kMmaThreads;
  constexpr int kSub = kDkvSub;        // query columns per register block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);           // [kBN][kLD]
  bf16* v_s = k_s + kBN * kLD;                             // [kBN][kLD]
  bf16* qd_s = v_s + kBN * kLD;          // [stage][Q, dO][kTile][kLD]
  float* m_s = reinterpret_cast<float*>(qd_s + 4 * kTile * kLD);
  float* ll_s = m_s + 2 * kTile;                         // [stage][kTile]
  float* di_s = ll_s + 2 * kTile;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kBN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k_rows = min(kBN, p.Sk - k0);
  const int w0 = warp * 16;                       // the strip's first key
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

  // under causal (top-left) key k0 is first attended by query row k0
  const int q_begin = p.causal ? k0 : 0;
  const int n_tiles = q_begin < p.Sq ? (p.Sq - q_begin + kTile - 1) / kTile
                                     : 0;
  auto load_q = [&](int t) {
    const int q0 = q_begin + t * kTile;
    const int rows = min(kTile, p.Sq - q0);
    bf16* qs = qd_s + (t & 1) * 2 * kTile * kLD;
    load_rows_async<kD, kThr>(qs, qp + q0 * p.q_str[2], p.q_str[2], rows,
                              kTile);
    load_rows_async<kD, kThr>(qs + kTile * kLD, dop + q0 * p.do_str[2],
                              p.do_str[2], rows, kTile);
    for (int e = threadIdx.x; e < kTile; e += kThr) {
      const bool ok = e < rows;
      const size_t r = bh_rows + q0 + (ok ? e : 0);
      cp_async4(m_s + (t & 1) * kTile + e, p.row_max + r, ok);
      cp_async4(ll_s + (t & 1) * kTile + e, p.row_log_l + r, ok);
      cp_async4(di_s + (t & 1) * kTile + e, p.di + r, ok);
    }
  };
  load_rows_async<kD, kThr>(k_s, kp, p.k_str[2], k_rows, kBN);
  load_rows_async<kD, kThr>(v_s, vp, p.v_str[2], k_rows, kBN);
  if (n_tiles > 0) load_q(0);
  cp_async_commit();

  // this thread's two keys: g and g + 8 of the strip
  const int ka = k0 + w0 + g;
  const int kb = ka + 8;
  const bool live = w0 < k_rows;
  const float sl2 = p.sm_scale * kLog2e;
  float dk[kD / 8][4], dv[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk[n][e] = 0.f;
      dv[n][e] = 0.f;
    }

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_q(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = q_begin + t * kTile;
    const bf16* qs = qd_s + (t & 1) * 2 * kTile * kLD;
    const bf16* ds = qs + kTile * kLD;
    const float* m_t = m_s + (t & 1) * kTile;
    const float* ll_t = ll_s + (t & 1) * kTile;
    const float* di_t = di_s + (t & 1) * kTile;
    // under causal a tile that ends before the strip's first key is masked
    if (live && !(p.causal && q0 + kTile - 1 < k0 + w0)) {
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += kSub) {
        float st[kSub / 8][4], dpt[kSub / 8][4];
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] = 0.f;
            dpt[j][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          unsigned kf[4], vf[4];
          ldsm4(kf, frag_a<kLD>(k_s, w0, kk * 16, lane));
          ldsm4(vf, frag_a<kLD>(v_s, w0, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < kSub / 16; ++np) {
            unsigned bq[4], bd[4];
            ldsm4(bq, frag_bt<kLD>(qs, c0 + np * 16, kk * 16, lane));
            mma(st[2 * np], kf, bq[0], bq[1]);
            mma(st[2 * np + 1], kf, bq[2], bq[3]);
            ldsm4(bd, frag_bt<kLD>(ds, c0 + np * 16, kk * 16, lane));
            mma(dpt[2 * np], vf, bd[0], bd[1]);
            mma(dpt[2 * np + 1], vf, bd[2], bd[3]);
          }
        }
        // P^T and dS^T; queries past Sq, keys past Sk and masked pairs give
        // exactly 0, so nothing from a zero-filled row reaches dK or dV. A
        // block with no bias, no query past Sq, no key past Sk and (under
        // causal) no key past its first query needs no test.
        const bool plain = bias == nullptr && q0 + c0 + kSub <= p.Sq
            && k0 + w0 + 16 <= p.Sk
            && !(p.causal && k0 + w0 + 15 > q0 + c0);
        if (plain) {
#pragma unroll
          for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = c0 + 8 * j + 2 * t4 + (e & 1);
              st[j][e] = exp2_approx(
                  fmaf(st[j][e], sl2, -(m_t[qc] + ll_t[qc]) * kLog2e));
            }
        } else {
#pragma unroll
          for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qc = c0 + 8 * j + 2 * t4 + (e & 1);
              const int qi = q0 + qc;
              const int kj = e < 2 ? ka : kb;
              const bool ok = qi < p.Sq && kj < p.Sk && !(p.causal && kj > qi);
              float bv = 0.f;
              if (ok && bias != nullptr)
                bv = bias[qi * p.bias_str[2] + kj * p.bias_str[3]];
              const float x = fmaf(st[j][e], p.sm_scale, bv);
              st[j][e] = ok ? exp2_approx(fmaf(x - m_t[qc], kLog2e,
                                               -ll_t[qc] * kLog2e))
                            : 0.f;
            }
        }
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + 8 * j + 2 * t4 + (e & 1);
            dpt[j][e] = st[j][e] * (dpt[j][e] - di_t[qc]);
          }
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          unsigned ph[4], pl[4], sh[4], sl[4];
          acc_to_a(st[2 * kk], st[2 * kk + 1], ph, pl);
          acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
          for (int dp = 0; dp < kD / 16; ++dp) {
            unsigned f[4];
            ldsm4_t(f, frag_a<kLD>(ds, c0 + kk * 16, dp * 16, lane));
            mma(dv[2 * dp], ph, f[0], f[1]);
            mma(dv[2 * dp], pl, f[0], f[1]);
            mma(dv[2 * dp + 1], ph, f[2], f[3]);
            mma(dv[2 * dp + 1], pl, f[2], f[3]);
            ldsm4_t(f, frag_a<kLD>(qs, c0 + kk * 16, dp * 16, lane));
            mma(dk[2 * dp], sh, f[0], f[1]);
            mma(dk[2 * dp], sl, f[0], f[1]);
            mma(dk[2 * dp + 1], sh, f[2], f[3]);
            mma(dk[2 * dp + 1], sl, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();              // the stage is free for the next load
  }
  cp_async_wait<0>();             // K and V, when no query tile ran
  __syncthreads();
  if (p.causal && any_lowest_row(p, p.row_max + bh_rows, k0 + kBN - 1)) {
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dv[n][e] += masked_dv(p, p.row_max + bh_rows, dop, e < 2 ? ka : kb,
                              8 * n + 2 * t4 + (e & 1));
  }

  // the warp's own K and V rows stage its dK and dV rows
  const size_t key0 = ((size_t)b * p.H + h) * p.Sk + k0 + w0;
  store_rows<kD>(dk, p.sm_scale, p.sm_scale, k_s + w0 * kLD,
                 static_cast<bf16*>(p.dk) + key0 * kD, k_rows - w0, lane);
  store_rows<kD>(dv, 1.f, 1.f, v_s + w0 * kLD,
                 static_cast<bf16*>(p.dv) + key0 * kD, k_rows - w0, lane);
}

// dQ, bf16. One CTA per (kMmaRows query rows, head, batch); warp w owns
// rows 16 w .. 16 w + 15 and their dQ rows. Q and dO are loaded once and
// re-read as A fragments; K/V tiles of 64 stream through a two-stage
// cp.async ring. For each block of kDqSub keys, in registers:
//   S = Q.K^T, dP = dO.V^T,
//   P = 2^((x - m) log2 e - log2 l), x = S sm_scale + bias (0 where
//       masked), as in dK/dV,
//   dS = P o (dP - di), written to ds in f32 when the bias takes a
//        gradient,
//   dQ += dS.K (dS as hi + lo A fragments, K from ldmatrix.trans).
template <int kD>
__global__ void __launch_bounds__(kMmaThreads, kD <= 64 ? 3 : 2)
flash_bwd_dq_mma_kernel(const FlashParams p) {
  constexpr int kLD = kD + 8;
  constexpr int kBM = kMmaRows;
  constexpr int kThr = kMmaThreads;
  constexpr int kSub = kDqSub;         // keys per register block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);           // [kBM][kLD]
  bf16* do_s = q_s + kBM * kLD;                            // [kBM][kLD]
  bf16* kv_s = do_s + kBM * kLD;         // [stage][K, V][kTile][kLD]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_rows = min(kBM, p.Sq - q0);
  const int w0 = warp * 16;                       // the strip's first row
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
  const size_t row0 = ((size_t)b * p.H + h) * p.Sq + q0 + w0;
  float* ds = p.ds == nullptr ? nullptr : p.ds + row0 * p.Sk;

  const int k_end = p.causal ? min(p.Sk, q0 + kBM) : p.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  auto load_kv = [&](int t) {
    const int k0 = t * kTile;
    const int rows = min(kTile, p.Sk - k0);
    bf16* ks = kv_s + (t & 1) * 2 * kTile * kLD;
    load_rows_async<kD, kThr>(ks, kp + k0 * p.k_str[2], p.k_str[2], rows,
                              kTile);
    load_rows_async<kD, kThr>(ks + kTile * kLD, vp + k0 * p.v_str[2],
                              p.v_str[2], rows, kTile);
  };
  load_rows_async<kD, kThr>(q_s, q, p.q_str[2], q_rows, kBM);
  load_rows_async<kD, kThr>(do_s, dop, p.do_str[2], q_rows, kBM);
  load_kv(0);
  cp_async_commit();

  // this thread's two query rows, g and g + 8 of the strip, and their
  // statistics: m, log2 l, di and, for the interior path, (m + log l) log2 e
  const int qa = q0 + w0 + g;
  const int qb = qa + 8;
  const bool live = w0 < q_rows;
  float mr[2], l2[2], dr[2], cr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = (i == 0 ? qa : qb) < p.Sq;
    const size_t r = row0 + g + 8 * i;
    mr[i] = ok ? p.row_max[r] : 0.f;
    l2[i] = ok ? p.row_log_l[r] * kLog2e : 0.f;
    dr[i] = ok ? p.di[r] : 0.f;
    cr[i] = fmaf(mr[i], kLog2e, l2[i]);
  }
  const float sl2 = p.sm_scale * kLog2e;
  float dq[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kTile;
    const bf16* ks = kv_s + (t & 1) * 2 * kTile * kLD;
    const bf16* vs = ks + kTile * kLD;
    if (live) {
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += kSub) {
        // a block past Sk, or (under causal) past the strip's last row,
        // has P = 0 throughout
        if (k0 + c0 >= p.Sk || (p.causal && k0 + c0 > q0 + w0 + 15)) break;
        float s[kSub / 8][4], dp[kSub / 8][4];
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = 0.f;
            dp[j][e] = 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          unsigned qf[4], df[4];
          ldsm4(qf, frag_a<kLD>(q_s, w0, kk * 16, lane));
          ldsm4(df, frag_a<kLD>(do_s, w0, kk * 16, lane));
#pragma unroll
          for (int np = 0; np < kSub / 16; ++np) {
            unsigned kf[4], vf[4];
            ldsm4(kf, frag_bt<kLD>(ks, c0 + np * 16, kk * 16, lane));
            mma(s[2 * np], qf, kf[0], kf[1]);
            mma(s[2 * np + 1], qf, kf[2], kf[3]);
            ldsm4(vf, frag_bt<kLD>(vs, c0 + np * 16, kk * 16, lane));
            mma(dp[2 * np], df, vf[0], vf[1]);
            mma(dp[2 * np + 1], df, vf[2], vf[3]);
          }
        }
        // P; keys past Sk and masked pairs give exactly 0. A block with no
        // bias, no key past Sk and (under causal) no key past the strip's
        // first row needs no test; rows past Sq read zero Q and dO rows
        // and give dS = 0.
        const bool plain = bias == nullptr && k0 + c0 + kSub <= p.Sk
            && !(p.causal && k0 + c0 + kSub - 1 > q0 + w0);
        if (plain) {
#pragma unroll
          for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = exp2_approx(fmaf(s[j][e], sl2, -cr[e >> 1]));
        } else {
#pragma unroll
          for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + c0 + 8 * j + 2 * t4 + (e & 1);
              const int qi = e < 2 ? qa : qb;
              const bool ok = kj < p.Sk && !(p.causal && kj > qi);
              float bv = 0.f;
              if (ok && bias != nullptr && qi < p.Sq)
                bv = bias[qi * p.bias_str[2] + kj * p.bias_str[3]];
              const float x = fmaf(s[j][e], p.sm_scale, bv);
              s[j][e] = ok ? exp2_approx(fmaf(x - mr[e >> 1], kLog2e,
                                              -l2[e >> 1]))
                           : 0.f;
            }
        }
        // dS = P o (dP - di), in dp
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = s[j][e] * (dp[j][e] - dr[e >> 1]);
        if (ds != nullptr) {
#pragma unroll
          for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kj = k0 + c0 + 8 * j + 2 * t4 + (e & 1);
              if ((e < 2 ? qa : qb) < p.Sq && kj < p.Sk)
                ds[(size_t)(g + 8 * (e >> 1)) * p.Sk + kj] = dp[j][e];
            }
        }
        // dQ += dS . K
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk) {
          unsigned sh[4], sl[4];
          acc_to_a(dp[2 * kk], dp[2 * kk + 1], sh, sl);
#pragma unroll
          for (int dn = 0; dn < kD / 16; ++dn) {
            unsigned f[4];
            ldsm4_t(f, frag_a<kLD>(ks, c0 + kk * 16, dn * 16, lane));
            mma(dq[2 * dn], sh, f[0], f[1]);
            mma(dq[2 * dn], sl, f[0], f[1]);
            mma(dq[2 * dn + 1], sh, f[2], f[3]);
            mma(dq[2 * dn + 1], sl, f[2], f[3]);
          }
        }
      }
    }
    __syncthreads();              // the stage is free for the next load
  }

  // the Q rows are free: only this warp read its strip, before the loop's
  // last barrier
  store_rows<kD>(dq, p.sm_scale, p.sm_scale, q_s + w0 * kLD,
                 static_cast<bf16*>(p.dq) + row0 * kD, q_rows - w0, lane);
}

template <int kD>
constexpr size_t fwd_mma_smem() {
  return (size_t)(kMmaRows + 4 * kTile) * (kD + 8) * sizeof(bf16);
}
template <int kD>
constexpr size_t dkv_mma_smem() {
  return (size_t)(2 * kMmaRows + 4 * kTile) * (kD + 8) * sizeof(bf16)
      + 6 * kTile * sizeof(float);
}
template <int kD>
constexpr size_t dq_mma_smem() {
  return (size_t)(2 * kMmaRows + 4 * kTile) * (kD + 8) * sizeof(bf16);
}

template <int kD>
constexpr size_t tile_bytes() { return (size_t)kTile * (kD + 4) * sizeof(float); }
constexpr size_t score_bytes() { return (size_t)kTile * kLDS * sizeof(float); }

// Raise `kernel`'s dynamic shared-memory ceiling to `smem` bytes, once per
// device: `raised` is the caller's static bit set (one per kernel
// instantiation, whose shared size never changes).
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, size_t smem, unsigned& raised) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0u && (__atomic_load_n(&raised, __ATOMIC_ACQUIRE) & bit))
    return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) __atomic_fetch_or(&raised, bit, __ATOMIC_RELEASE);
  return e;
}

template <typename Kernel>
int launch(Kernel kernel, unsigned& raised, const FlashParams& p, int tiles,
           int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t e = raise_smem(kernel, smem, raised);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(tiles, p.H, p.B), threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// One launchable body: the kernel, its block, its dynamic shared memory and
// the rows or keys one CTA takes.
template <typename Kernel>
struct Body {
  Kernel kernel;
  int threads;
  size_t smem;
  int tile;
};

template <typename Kernel>
Body<Kernel> body(Kernel kernel, int threads, size_t smem, int tile) {
  return {kernel, threads, smem, tile};
}

// the six bodies' raise_smem flags at head dim kD
template <int kD>
unsigned* raised_flags() {
  static unsigned raised[6];
  return raised;
}

// kind 0: forward, 1: dK/dV, 2: dQ; calls f(Body, its raise_smem flag)
template <int kD, typename F>
int with_body(int kind, bool bf16, F&& f) {
  unsigned* raised = raised_flags<kD>();
  switch (kind * 2 + (bf16 ? 1 : 0)) {
    case 0:
      return f(body(flash_fwd_kernel<kD>, kThreads,
                    3 * tile_bytes<kD>() + score_bytes(), kTile), raised[0]);
    case 1:
      return f(body(flash_fwd_mma_kernel<kD>, kMmaThreads, fwd_mma_smem<kD>(),
                    kMmaRows), raised[1]);
    case 2:
      return f(body(flash_bwd_dkv_kernel<kD>, kThreads,
                    4 * tile_bytes<kD>() + 2 * score_bytes()
                        + 3 * kTile * sizeof(float), kTile), raised[2]);
    case 3:
      return f(body(flash_bwd_dkv_mma_kernel<kD>, kMmaThreads,
                    dkv_mma_smem<kD>(), kMmaRows), raised[3]);
    case 4:
      return f(body(flash_bwd_dq_kernel<kD>, kThreads,
                    4 * tile_bytes<kD>() + score_bytes(), kTile), raised[4]);
    case 5:
      return f(body(flash_bwd_dq_mma_kernel<kD>, kMmaThreads,
                    dq_mma_smem<kD>(), kMmaRows), raised[5]);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int kD>
int launch_kind(int kind, const FlashParams& p, cudaStream_t st) {
  // the forward and dQ tile the queries, dK/dV the keys
  const int rows = kind == 1 ? p.Sk : p.Sq;
  return with_body<kD>(kind, p.bf16 != 0, [&](auto bd, unsigned& raised) {
    return launch(bd.kernel, raised, p, (rows + bd.tile - 1) / bd.tile,
                  bd.threads, bd.smem, st);
  });
}

template <int kD>
int launch_fwd(const FlashParams& p, cudaStream_t st) {
  return launch_kind<kD>(0, p, st);
}

template <int kD>
int launch_dkv(const FlashParams& p, cudaStream_t st) {
  return launch_kind<kD>(1, p, st);
}

template <int kD>
int launch_dq(const FlashParams& p, cudaStream_t st) {
  return launch_kind<kD>(2, p, st);
}

// out as describe_kernel (kernel_info.cuh) gives it
template <int kD>
int kernel_info(int kind, bool bf16, int* out) {
  return with_body<kD>(kind, bf16, [&](auto bd, unsigned& raised) {
    const cudaError_t e = raise_smem(bd.kernel, bd.smem, raised);
    if (e != cudaSuccess) return (int)e;
    return describe_kernel(bd.kernel, bd.threads, (int)bd.smem, out);
  });
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

// What the body `kind` (0 forward, 1 dK/dV, 2 dQ) at head dim `d` in bf16 or
// f32 was built with and how many of its CTAs an SM holds: out[6] =
// {registers, spill bytes, static shared, dynamic shared, CTAs per SM,
// threads per CTA}.
int flash_attention_kernel_info(int kind, int d, int bf16, int* out) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return kernel_info<16>(kind, bf16 != 0, out);
    case 32: return kernel_info<32>(kind, bf16 != 0, out);
    case 64: return kernel_info<64>(kind, bf16 != 0, out);
    case 128: return kernel_info<128>(kind, bf16 != 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
