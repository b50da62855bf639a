// Paged attention for the decode-serving path, hand-written for Hopper
// (sm_90a). Two kernels, each behind an extern "C" launcher that returns
// cudaGetLastError() so the ctypes wrapper in ops/nn_ops.py can raise.
//
// Pool layout (as in paddle_tpu/serving/decode/kv_cache.py): k_pages and
// v_pages are (H, NB, BS, D), contiguous; block_tables is (S, max_bps)
// int32 with each sequence's cache blocks in order, padded with the scratch
// block 0. A key at position t of sequence s lives at
//   pages[h, block_tables[s, t / BS], t % BS, :].
//
// Payloads (the pool's kv_dtype): f32; bf16; int8 with one f32 scale a
// (head, position) row, k_scales and v_scales laid out (H, NB, BS). Both
// kernels take the payload as a template parameter (Payload<T> below) and
// dequantize each K or V row as it is loaded: bf16 widened to f32 (exact),
// int8 as (float)q * scale[h][block][row], one f32 product. That is the
// value the reference's gather-then-dequantize makes
// (paddle_tpu/ops/nn_ops.py:_gather_pages), and every operation after the
// load is the f32 arithmetic of the f32 payload, so the f32 instantiation
// is the kernel it was and the others compute what the plain version
// computes from the same pool. q and out stay f32. A quantized pool cuts
// the bytes a launch reads (2 bytes an element for bf16, 1 plus 4 a row
// for int8); nothing else changes.
//
// The verify read of speculative decoding (q (S, H, K, D), row j attending
// context_lens + j keys) is no kernel of its own: the wrapper flattens it
// into S * K single-query rows (tables repeated, contexts + j) and launches
// paged_decode_attention on them, so each verify row is computed exactly as
// the lockstep row at that context (the cluster depends on max_bps only).
//
// paged_decode_attention
//   Replaces: the stock Pallas paged-attention kernel that
//   paddle_tpu/ops/nn_ops.py:paged_attention calls on a TPU
//   (jax/experimental/pallas/ops/tpu/paged_attention/paged_attention_kernel.py).
//   Computes: out[s, h] = softmax(q[s, h] . K^T * sm_scale) . V over the keys
//   t < context_lens[s] of sequence s. The TPU kernel was handed q already
//   scaled by sm_scale; this one scales the scores, as the plain version
//   does (equal up to rounding).
//   Bound: bytes. Each attended key costs 2 * D * 4 bytes of K and V rows
//   read once, against 4 * D flops; there is no reuse to exploit. At the
//   served shape (8 slots, 8 heads of 64, contexts 128-188) that is about
//   5 MB, under 2 us at 3.35 TB/s: the latency of a chain of dependent
//   loads and the launch, not the bytes, set the time.
//   Design: split-context flash-decoding in one launch. The grid is
//   (H, S, ranges); each CTA of 8 warps takes a fixed range of kSplitKeys
//   keys of one (head, slot) (several in turn once a context needs more
//   than kMaxCluster ranges), so a served context of 128-188 keys keeps 2-3
//   CTAs of each pair busy and the grid fills the card. A CTA whose range
//   starts at or past its slot's context reads no K or V row. The CTA
//   loads its range's block-table entries into shared memory once (the
//   first range's beside the context length, which they do not depend
//   on), so no key waits on a dependent table read. A warp takes 8 keys;
//   kD / 4 lanes share one key row, each with a float4 of K and of V, so
//   one warp instruction reads whole 256-byte rows (at D 64, two
//   neighbouring keys), every K and V load of the warp is issued before the
//   first score, and the dot products reduce by shuffles. Scores are scaled by sm_scale log2 e and
//   exponentiated with exp2f. The warps merge their (max, sum, o[D])
//   through shared memory into the CTA's partial. The ranges of one (head,
//   slot) form a thread-block cluster (Hopper), and its rank 0 merges the
//   partials in range order straight from the other CTAs' shared memory:
//   no second kernel, no scratch in device memory and no float atomics,
//   so a launch is bitwise repeatable (the served replay contract rests on
//   it).
//
// paged_prefill_attention
//   Replaces: the stock Pallas flash_attention(causal=True) forward that
//   paddle_tpu/ops/nn_ops.py:paged_prefill_attention calls on a TPU
//   (jax/experimental/pallas/ops/tpu/flash_attention.py).
//   Computes: what the plain version computes, causal attention of the
//   bucket-padded prompt's q (B, H, Lq, D) over the paged K/V view: row r
//   attends keys 0..r read through the block table. Rows past the real
//   prompt read finite stale or scratch rows: garbage by contract, but
//   finite and in bounds.
//   Bound: per head 2 * Lq * (Lq + 1) * D f32 flops (the causal half)
//   against 16 * Lq * D bytes (q, K, V, out read or written once): bytes
//   below Lq ~ 160 on an H100, f32 operations above (the top rung is 256).
//   At the served shape (8 heads of 64, Lq 256) that is about 1 us: the
//   time is the latency of the chain table entry -> K/V rows -> scores ->
//   softmax -> P.V -> merge, not bytes or operations.
//   Design: key-split flash attention. One CTA per (16-row query tile,
//   head, sequence), 8 warps (4 at D 128, for shared memory). The tile's
//   causal keys 0 .. q0 + 15 are cut into one contiguous range a warp, so
//   the split follows the tile's key count: at Lq 256 the last tile's
//   warps take 32 keys each and the first tile's 2, and no warp walks more
//   than one 32-key chunk in series. Each warp reads its keys' block-table
//   entries (one a lane), then issues every K and V row of its chunk with
//   cp.async, 16 bytes a lane with neighbouring lanes on neighbouring
//   addresses, beside the CTA's q tile, before the first score. Scores
//   are register-blocked as one key a lane against all 16 rows (K rows
//   padded by 4 floats, so the lanes' float4 reads are free of bank
//   conflicts; q rows are broadcast), pre-scaled by sm_scale log2 e and
//   exponentiated with exp2f; a row's online-softmax update is one
//   shuffle reduction of its max, and each lane keeps its own share of
//   the row sums until the end. P goes through a small per-warp buffer to
//   the P.V update, in which a lane owns 1-4 columns of every row. The
//   warps merge their (max, sum, O) once, through shared memory, in warp
//   order: no atomics, so a launch is bitwise repeatable. Plain f32 FMA,
//   no tensor cores (f32, no TF32).
//   Built: 204 registers a thread at D 64 (164-220 across D), no local
//   memory, 164,096 bytes of dynamic shared memory at D 64 (62,720 at D
//   16, 153,856 at D 128), 1 CTA an SM.
//
// Both kernels are compiled for head_dim D in {16, 32, 64, 128} and take any
// BS >= 1.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kernel_info.cuh"

namespace {

constexpr int kSplitKeys = 64;        // keys of one decode range
constexpr int kSplitWarps = 8;
constexpr int kMaxCluster = 8;        // CTAs of one (head, slot): portable
constexpr int kPrefillRows = 16;      // query rows per CTA
constexpr int kKeyChunk = 32;         // keys a warp holds at once: one a lane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Four consecutive elements of a K or V row as f32: the pool's payload
// widened (bf16) or times its row's scale (int8). kScaled: the payload has
// row scales (k_scales / v_scales) to read beside the row.
template <typename T>
struct Payload;

template <>
struct Payload<float> {
  static constexpr bool kScaled = false;
  static __device__ __forceinline__ float4 load4(const float* p, float) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
};

template <>
struct Payload<__nv_bfloat16> {
  static constexpr bool kScaled = false;
  // element 0 is the low half of the first word (little-endian)
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p,
                                                 float) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
};

template <>
struct Payload<int8_t> {
  static constexpr bool kScaled = true;
  static __device__ __forceinline__ float4 load4(const int8_t* p,
                                                 float scale) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4((float)c.x * scale, (float)c.y * scale,
                       (float)c.z * scale, (float)c.w * scale);
  }
};

// One CTA per (head, slot, rank); the ranks of one (head, slot) are one
// cluster along z. Rank r takes keys [r passes kSplitKeys, (r + 1) passes
// kSplitKeys), kSplitKeys at a time with an online softmax across passes.
// T is the pool's payload; k_scales and v_scales are read only for int8.
template <int kD, typename T>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const float* __restrict__ k_scales,
                              const float* __restrict__ v_scales,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ context_lens,
                              float* __restrict__ out, int H, int NB, int BS,
                              int max_bps, int passes, float scale_log2) {
  namespace cg = cooperative_groups;
  using PL = Payload<T>;
  constexpr int kLanes = kD / 4;             // lanes that share one key row
  constexpr int kRows = 32 / kLanes;         // keys a warp reads at a time
  constexpr int kWarpKeys = kSplitKeys / kSplitWarps;
  constexpr int kSteps = kWarpKeys / kRows;
  static_assert(kWarpKeys % kRows == 0, "key split");
  __shared__ int blk_s[kSplitKeys];          // the range's table entries
  __shared__ float m_s[kSplitWarps];
  __shared__ float l_s[kSplitWarps];
  __shared__ __align__(16) float o_s[kSplitWarps][kD];
  __shared__ float ml_c[2];                  // the CTA's max and sum
  __shared__ float o_c[kD];                  // and its unnormalised o

  const cg::cluster_group cluster = cg::this_cluster();
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int rank = blockIdx.z;               // the cluster spans z
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row_off = ((size_t)s * H + h) * kD;
  const int span = passes * kSplitKeys;
  const int max_keys = max_bps * BS;
  const int* table = block_tables + (size_t)s * max_bps;
  // the first range's table entries lie in the table whatever the context:
  // read them beside the context length rather than after it
  const int c_first = rank * span;
  const int first_blocks = c_first < max_keys
      ? (min(c_first + kSplitKeys, max_keys) - 1) / BS - c_first / BS + 1 : 0;
  const int blk_first =
      threadIdx.x < first_blocks ? table[c_first / BS + threadIdx.x] : 0;
  const int n_keys = min(context_lens[s], max_keys);
  const int k_stop = min((rank + 1) * span, n_keys);

  // lane group `grp` reads key k0 + grp of each step; the lane holds
  // columns col .. col + 3 of it
  const int grp = lane / kLanes;
  const int col = (lane % kLanes) * 4;
  const float4 qv = *reinterpret_cast<const float4*>(q + row_off + col);
  const T* kh = k_pages + (size_t)h * NB * BS * kD + col;
  const T* vh = v_pages + (size_t)h * NB * BS * kD + col;
  // the head's row scales (int8 only): one f32 a (block, row)
  const float* ksh = PL::kScaled ? k_scales + (size_t)h * NB * BS : nullptr;
  const float* vsh = PL::kScaled ? v_scales + (size_t)h * NB * BS : nullptr;
  // a warp with no key (past the context) keeps m = -inf, l = 0, o = 0
  float mw = neg_inf();
  float lw = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = c_first; c0 < k_stop; c0 += kSplitKeys) {
    const int k_end = min(c0 + kSplitKeys, k_stop);
    const int b_first = c0 / BS;
    __syncthreads();                 // the last pass's table readers are done
    if (c0 == c_first) {
      if (threadIdx.x < first_blocks) blk_s[threadIdx.x] = blk_first;
    } else {
      for (int i = threadIdx.x; i <= (k_end - 1) / BS - b_first;
           i += blockDim.x)
        blk_s[i] = table[b_first + i];
    }
    __syncthreads();
    const int w_begin = c0 + warp * kWarpKeys;
    float4 kr[kSteps], vr[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int t = w_begin + st * kRows + grp;
      kr[st] = vr[st] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < k_end) {
        const size_t r = (size_t)blk_s[t / BS - b_first] * BS + t % BS;
        float ks = 1.f, vs = 1.f;
        if constexpr (PL::kScaled) {
          ks = __ldg(ksh + r);
          vs = __ldg(vsh + r);
        }
        kr[st] = PL::load4(kh + r * kD, ks);
        vr[st] = PL::load4(vh + r * kD, vs);
      }
    }
    float sc[kSteps];
    float mx = neg_inf();
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float d = qv.x * kr[st].x;
      d = fmaf(qv.y, kr[st].y, d);
      d = fmaf(qv.z, kr[st].z, d);
      d = fmaf(qv.w, kr[st].w, d);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(kFull, d, o);
      sc[st] = w_begin + st * kRows + grp < k_end ? d * scale_log2
                                                  : neg_inf();
      mx = fmaxf(mx, sc[st]);
    }
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    const float m_new = fmaxf(mw, mx);
    const float alpha = mw == neg_inf() ? 0.f : exp2f(mw - m_new);
    lw *= alpha;
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const float pj = sc[st] == neg_inf() ? 0.f : exp2f(sc[st] - m_new);
      lw += pj;
      acc.x = fmaf(pj, vr[st].x, acc.x);
      acc.y = fmaf(pj, vr[st].y, acc.y);
      acc.z = fmaf(pj, vr[st].z, acc.z);
      acc.w = fmaf(pj, vr[st].w, acc.w);
    }
    mw = m_new;
  }
#pragma unroll
  for (int o = kLanes; o < 32; o <<= 1) {
    lw += __shfl_xor_sync(kFull, lw, o);
    acc.x += __shfl_xor_sync(kFull, acc.x, o);
    acc.y += __shfl_xor_sync(kFull, acc.y, o);
    acc.z += __shfl_xor_sync(kFull, acc.z, o);
    acc.w += __shfl_xor_sync(kFull, acc.w, o);
  }
  if (lane == 0) {
    m_s[warp] = mw;
    l_s[warp] = lw;
  }
  if (lane < kLanes) *reinterpret_cast<float4*>(&o_s[warp][col]) = acc;
  __syncthreads();

  // the CTA's partial; a CTA past the context keeps M = -inf, L = 0, o = 0
  float M = neg_inf();
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) M = fmaxf(M, m_s[w]);
  float wt[kSplitWarps];
  float L = 0.f;
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) {
    wt[w] = m_s[w] == neg_inf() ? 0.f : exp2f(m_s[w] - M);
    L = fmaf(l_s[w], wt[w], L);
  }
  for (int d = threadIdx.x; d < kD; d += blockDim.x) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) a = fmaf(o_s[w][d], wt[w], a);
    o_c[d] = a;
  }
  if (threadIdx.x == 0) {
    ml_c[0] = M;
    ml_c[1] = L;
  }
  cluster.sync();

  if (rank == 0) {
    // the ranks that hold keys, merged in rank order
    const int n = (n_keys + span - 1) / span;
    float Mc = neg_inf();
    for (int r = 0; r < n; ++r)
      Mc = fmaxf(Mc, cluster.map_shared_rank(ml_c, r)[0]);
    float Lc = 0.f;
    for (int r = 0; r < n; ++r) {
      const float* ml = cluster.map_shared_rank(ml_c, r);
      Lc = fmaf(ml[1], exp2f(ml[0] - Mc), Lc);
    }
    for (int d = threadIdx.x; d < kD; d += blockDim.x) {
      float a = 0.f;
      for (int r = 0; r < n; ++r)
        a = fmaf(cluster.map_shared_rank(o_c, r)[d],
                 exp2f(cluster.map_shared_rank(ml_c, r)[0] - Mc), a);
      // nothing to attend (n = 0): a defined zero row
      out[row_off + d] = n > 0 ? a / Lc : 0.f;
    }
  }
  cluster.sync();        // every rank's shared memory outlives rank 0's reads
}

// ------------------------------------------------------------- prefill ---

template <int kD>
struct Prefill {
  static constexpr int kWarps = kD == 128 ? 4 : 8;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kD4 = kD / 4;
  static constexpr int kDP = kD + 4;          // padded K, V and q rows
  static constexpr int kPP = kPrefillRows + 4;  // padded P rows (a key's)
  // P.V: a lane owns kLaneCols columns of kLaneRows rows of the tile
  static constexpr int kLaneCols = kD >= 32 ? kD / 32 : 1;
  static constexpr int kColLanes = kD / kLaneCols;
  static constexpr int kLaneRows = kPrefillRows * kColLanes / 32;
  // shared memory, in floats: the q tile, then each warp's K and V rows,
  // then each warp's P; the merge reuses the K and V rows
  static constexpr int kQ = kPrefillRows * kDP;
  static constexpr int kWarpKV = 2 * kKeyChunk * kDP;
  static constexpr int kWarpP = kKeyChunk * kPP;
  static constexpr int kMerge = kWarps * kPrefillRows * (kD + 2);
  static constexpr int kSmem = (kQ + kWarps * (kWarpKV + kWarpP)) * 4;
  static_assert(kMerge <= kWarps * kWarpKV, "merge fits in the K/V rows");
  static_assert(kLaneRows % 4 == 0, "P rows are read as float4");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// The K and V rows of keys c0 .. c0 + nk - 1 (nk <= 32) into k_s and v_s
// as f32: each lane first finds its key's row (and, for int8, its row
// scales) through the block table, then the warp moves four elements a
// lane, neighbouring lanes on neighbouring addresses of a row. An f32
// payload goes with cp.async, all in flight at once; bf16 and int8 are
// loaded, dequantized (Payload<T>) and stored.
template <int kD, typename T>
__device__ __forceinline__ void load_keys(float* k_s, float* v_s,
                                          const T* kh, const T* vh,
                                          const float* ksh, const float* vsh,
                                          const int* table, int BS, int c0,
                                          int nk, int lane) {
  using P = Prefill<kD>;
  using PL = Payload<T>;
  const int t = c0 + lane;
  const int row = lane < nk ? table[t / BS] * BS + t % BS : 0;
  float ks = 1.f, vs = 1.f;
  if constexpr (PL::kScaled) {
    if (lane < nk) {
      ks = ksh[row];
      vs = vsh[row];
    }
  }
#pragma unroll
  for (int i = 0; i < P::kD4; ++i) {
    const int e = lane + 32 * i;
    const int j = e / P::kD4;
    const int c = 4 * (e % P::kD4);
    const int rj = __shfl_sync(kFull, row, j);
    float ksj = 1.f, vsj = 1.f;
    if constexpr (PL::kScaled) {
      ksj = __shfl_sync(kFull, ks, j);
      vsj = __shfl_sync(kFull, vs, j);
    }
    if (j < nk) {
      if constexpr (std::is_same<T, float>::value) {
        cp_async16(k_s + j * P::kDP + c, kh + (size_t)rj * kD + c);
        cp_async16(v_s + j * P::kDP + c, vh + (size_t)rj * kD + c);
      } else {
        *reinterpret_cast<float4*>(k_s + j * P::kDP + c) =
            PL::load4(kh + (size_t)rj * kD + c, ksj);
        *reinterpret_cast<float4*>(v_s + j * P::kDP + c) =
            PL::load4(vh + (size_t)rj * kD + c, vsj);
      }
    }
  }
}

// One CTA per (16-row query tile, head, sequence). The tile's causal keys
// 0 .. q0 + rows - 1 are split into kWarps contiguous ranges, one a warp;
// each warp runs an online softmax over its range for all 16 rows, 32 keys
// at a time, and the warps merge their (max, sum, O) once, in warp order.
// T is the pool's payload; k_scales and v_scales are read only for int8.
template <int kD, typename T>
__global__ void __launch_bounds__(Prefill<kD>::kThreads, 1)
paged_prefill_attention_kernel(const float* __restrict__ q,
                               const T* __restrict__ k_pages,
                               const T* __restrict__ v_pages,
                               const float* __restrict__ k_scales,
                               const float* __restrict__ v_scales,
                               const int* __restrict__ block_tables,
                               float* __restrict__ out, int H, int Lq, int NB,
                               int BS, int max_bps, float scale_log2) {
  using P = Prefill<kD>;
  constexpr int kR = kPrefillRows;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* kv_all = q_s + P::kQ;
  float* p_all = kv_all + P::kWarps * P::kWarpKV;

  const int q0 = blockIdx.x * kR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = min(kR, Lq - q0);
  const size_t bh_off = ((size_t)b * H + h) * Lq * kD;
  const int* table = block_tables + (size_t)b * max_bps;
  const T* kh = k_pages + (size_t)h * NB * BS * kD;
  const T* vh = v_pages + (size_t)h * NB * BS * kD;
  const float* ksh =
      Payload<T>::kScaled ? k_scales + (size_t)h * NB * BS : nullptr;
  const float* vsh =
      Payload<T>::kScaled ? v_scales + (size_t)h * NB * BS : nullptr;
  float* k_s = kv_all + warp * P::kWarpKV;
  float* v_s = k_s + kKeyChunk * P::kDP;
  float* p_s = p_all + warp * P::kWarpP;

  // this warp's share of the tile's causal keys
  const int n_keys = q0 + rows;
  const int span = (n_keys + P::kWarps - 1) / P::kWarps;
  const int k_begin = min(warp * span, n_keys);
  const int k_end = min(k_begin + span, n_keys);

  // the q tile (rows past the prompt zero, never stored) and the warp's
  // first chunk of keys, all in flight before the first score
  for (int e = tid; e < kR * P::kD4; e += P::kThreads) {
    const int r = e / P::kD4;
    const int c = 4 * (e % P::kD4);
    if (r < rows)
      cp_async16(q_s + r * P::kDP + c, q + bh_off + (size_t)(q0 + r) * kD + c);
    else
      *reinterpret_cast<float4*>(q_s + r * P::kDP + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (k_begin < k_end)
    load_keys<kD, T>(k_s, v_s, kh, vh, ksh, vsh, table, BS, k_begin,
                     min(kKeyChunk, k_end - k_begin), lane);
  cp_async_wait_all();
  __syncthreads();

  // the lane's P.V block: columns col0 .., rows row0 .. of the tile
  const int col0 = (lane % P::kColLanes) * P::kLaneCols;
  const int row0 = (lane / P::kColLanes) * P::kLaneRows;
  float o[P::kLaneRows][P::kLaneCols];
#pragma unroll
  for (int i = 0; i < P::kLaneRows; ++i)
#pragma unroll
    for (int c = 0; c < P::kLaneCols; ++c) o[i][c] = 0.f;
  // running max (the same in every lane) and the lane's share of the sum
  float m_row[kR];
  float l_row[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m_row[r] = neg_inf();
    l_row[r] = 0.f;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kKeyChunk) {
    const int nk = min(kKeyChunk, k_end - c0);
    if (c0 != k_begin) {
      load_keys<kD, T>(k_s, v_s, kh, vh, ksh, vsh, table, BS, c0, nk,
                       lane);
      cp_async_wait_all();
      __syncwarp();
    }
    // scores: lane j holds key c0 + j against every row (a lane past the
    // chunk reads a stale row, masked below)
    float s[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) s[r] = 0.f;
    const float* kr = k_s + lane * P::kDP;
#pragma unroll 4
    for (int c = 0; c < kD; c += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + r * P::kDP + c);
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    // online softmax per row; the lane's P column goes to shared memory
    const int t = c0 + lane;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float sc =
          lane < nk && t <= q0 + r ? s[r] * scale_log2 : neg_inf();
      const float m_new = fmaxf(m_row[r], warp_max(sc));
      const float alpha =
          m_row[r] == neg_inf() ? 0.f : exp2f(m_row[r] - m_new);
      const float p = sc == neg_inf() ? 0.f : exp2f(sc - m_new);
      l_row[r] = fmaf(l_row[r], alpha, p);
      m_row[r] = m_new;
      s[r] = p;
      // rescale the lane's O rows (kLaneRows < kR only at D 16: rows
      // row0 .. row0 + 7)
      if (P::kLaneRows == kR || (r < P::kLaneRows) == (row0 == 0)) {
#pragma unroll
        for (int c = 0; c < P::kLaneCols; ++c)
          o[r % P::kLaneRows][c] *= alpha;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; r += 4)
      *reinterpret_cast<float4*>(p_s + lane * P::kPP + r) =
          make_float4(s[r], s[r + 1], s[r + 2], s[r + 3]);
    __syncwarp();
    // O += P . V over the chunk's keys
    for (int j = 0; j < nk; ++j) {
      float pv[P::kLaneRows];
#pragma unroll
      for (int i = 0; i < P::kLaneRows; i += 4) {
        const float4 x =
            *reinterpret_cast<const float4*>(p_s + j * P::kPP + row0 + i);
        pv[i] = x.x;
        pv[i + 1] = x.y;
        pv[i + 2] = x.z;
        pv[i + 3] = x.w;
      }
      float vv[P::kLaneCols];
      const float* vr = v_s + j * P::kDP + col0;
      if constexpr (P::kLaneCols == 4) {
        const float4 x = *reinterpret_cast<const float4*>(vr);
        vv[0] = x.x;
        vv[1] = x.y;
        vv[2] = x.z;
        vv[3] = x.w;
      } else if constexpr (P::kLaneCols == 2) {
        const float2 x = *reinterpret_cast<const float2*>(vr);
        vv[0] = x.x;
        vv[1] = x.y;
      } else {
        vv[0] = vr[0];
      }
#pragma unroll
      for (int i = 0; i < P::kLaneRows; ++i)
#pragma unroll
        for (int c = 0; c < P::kLaneCols; ++c)
          o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
    __syncwarp();        // the next chunk overwrites K, V and P
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) l_row[r] = warp_sum(l_row[r]);

  // merge the warps' (max, sum, O) in warp order, through the K/V rows
  __syncthreads();
  float* o_m = kv_all;                          // [warp][row][kD]
  float* m_m = o_m + P::kWarps * kR * kD;       // [warp][row]
  float* l_m = m_m + P::kWarps * kR;
#pragma unroll
  for (int i = 0; i < P::kLaneRows; ++i)
#pragma unroll
    for (int c = 0; c < P::kLaneCols; ++c)
      o_m[(warp * kR + row0 + i) * kD + col0 + c] = o[i][c];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      m_m[warp * kR + r] = m_row[r];
      l_m[warp * kR + r] = l_row[r];
    }
  }
  __syncthreads();
  // each row's weight of every warp and its sum, once a row (a warp with
  // no key of the row weighs 0; key 0 is every row's, so M is finite)
  float* wt = p_all;                            // [row][warp], then L
  float* l_tot = wt + kR * P::kWarps;
  if (tid < rows) {
    float M = neg_inf();
    for (int w = 0; w < P::kWarps; ++w) M = fmaxf(M, m_m[w * kR + tid]);
    float L = 0.f;
    for (int w = 0; w < P::kWarps; ++w) {
      const float m = m_m[w * kR + tid];
      const float x = m == neg_inf() ? 0.f : exp2f(m - M);
      wt[tid * P::kWarps + w] = x;
      L = fmaf(l_m[w * kR + tid], x, L);
    }
    l_tot[tid] = L;
  }
  __syncthreads();
  for (int e = tid; e < rows * kD; e += P::kThreads) {
    const int r = e / kD;
    const int d = e % kD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < P::kWarps; ++w)
      a = fmaf(o_m[(w * kR + r) * kD + d], wt[r * P::kWarps + w], a);
    out[bh_off + (size_t)(q0 + r) * kD + d] = a / l_tot[r];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// (H, S, ranks) CTAs in clusters of (1, 1, ranks): up to kMaxCluster
// ranks, each taking `passes` ranges of kSplitKeys keys
template <int kD, typename T>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales,
                  const void* block_tables, const void* context_lens,
                  void* out, int S, int H, int NB, int BS, int max_bps,
                  float sm_scale, cudaStream_t stream) {
  int ranges = (max_bps * BS + kSplitKeys - 1) / kSplitKeys;
  if (ranges < 1) ranges = 1;
  const int ranks = ranges < kMaxCluster ? ranges : kMaxCluster;
  const int passes = (ranges + ranks - 1) / ranks;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, S, ranks);
  cfg.blockDim = dim3(kSplitWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = ranks;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_decode_attention_kernel<kD, T>, static_cast<const float*>(q),
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out), H, NB,
      BS, max_bps, passes, sm_scale * kLog2e);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kD, typename T>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* block_tables, void* out, int B, int H, int Lq,
                   int NB, int BS, int max_bps, float sm_scale,
                   cudaStream_t stream) {
  using P = Prefill<kD>;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_attention_kernel<kD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Lq + kPrefillRows - 1) / kPrefillRows, H, B);
  paged_prefill_attention_kernel<kD, T>
      <<<grid, P::kThreads, P::kSmem, stream>>>(
          static_cast<const float*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), static_cast<const float*>(k_scales),
          static_cast<const float*>(v_scales),
          static_cast<const int*>(block_tables), static_cast<float*>(out), H,
          Lq, NB, BS, max_bps, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int kD, typename T>
int kernel_info(int kind, int* out) {
  if (kind == 0)
    return describe_kernel(paged_decode_attention_kernel<kD, T>,
                           kSplitWarps * 32, 0, out);
  using P = Prefill<kD>;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_attention_kernel<kD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return (int)e;
  return describe_kernel(paged_prefill_attention_kernel<kD, T>, P::kThreads,
                         P::kSmem, out);
}

// The instantiation for a head dim and a payload code (0 f32, 1 bf16,
// 2 int8: kv_cache.py's KV_DTYPE_CODES): f(std::integral_constant<int, D>,
// payload type tag), or cudaErrorInvalidValue for one not built.
template <typename T>
struct Tag {
  using type = T;
};

template <typename F>
int dispatch(int D, int payload, F&& f) {
  auto with_d = [&](auto tag) -> int {
    switch (D) {
      case 16: return f(std::integral_constant<int, 16>(), tag);
      case 32: return f(std::integral_constant<int, 32>(), tag);
      case 64: return f(std::integral_constant<int, 64>(), tag);
      case 128: return f(std::integral_constant<int, 128>(), tag);
      default: return (int)cudaErrorInvalidValue;
    }
  };
  switch (payload) {
    case 0: return with_d(Tag<float>());
    case 1: return with_d(Tag<__nv_bfloat16>());
    case 2: return with_d(Tag<int8_t>());
    default: return (int)cudaErrorInvalidValue;
  }
}

int decode(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* context_lens, void* out,
           int S, int H, int D, int NB, int BS, int max_bps, int payload,
           float sm_scale, cudaStream_t stream) {
  return dispatch(D, payload, [&](auto d, auto tag) -> int {
    using T = typename decltype(tag)::type;
    return launch_decode<decltype(d)::value, T>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, context_lens,
        out, S, H, NB, BS, max_bps, sm_scale, stream);
  });
}

int prefill(const void* q, const void* k_pages, const void* v_pages,
            const void* k_scales, const void* v_scales,
            const void* block_tables, void* out, int B, int H, int Lq, int D,
            int NB, int BS, int max_bps, int payload, float sm_scale,
            cudaStream_t stream) {
  return dispatch(D, payload, [&](auto d, auto tag) -> int {
    using T = typename decltype(tag)::type;
    return launch_prefill<decltype(d)::value, T>(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, out, B, H, Lq,
        NB, BS, max_bps, sm_scale, stream);
  });
}

int info(int kind, int D, int payload, int* out) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  return dispatch(D, payload, [&](auto d, auto tag) -> int {
    using T = typename decltype(tag)::type;
    return kernel_info<decltype(d)::value, T>(kind, out);
  });
}

}  // namespace

extern "C" {

// payload: 0 f32, 1 bf16, 2 int8 (k_scales and v_scales (H, NB, BS) f32,
// else unread and may be null)
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scales,
                           const void* v_scales, const void* block_tables,
                           const void* context_lens, void* out, int S, int H,
                           int D, int NB, int BS, int max_bps, int payload,
                           float sm_scale, void* stream) {
  return decode(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                context_lens, out, S, H, D, NB, BS, max_bps, payload,
                sm_scale, static_cast<cudaStream_t>(stream));
}

int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const void* block_tables,
                            void* out, int B, int H, int Lq, int D, int NB,
                            int BS, int max_bps, int payload, float sm_scale,
                            void* stream) {
  return prefill(q, k_pages, v_pages, k_scales, v_scales, block_tables, out,
                 B, H, Lq, D, NB, BS, max_bps, payload, sm_scale,
                 static_cast<cudaStream_t>(stream));
}

// What a body was built with (kind 0 the decode kernel, 1 the prefill
// kernel; head dim d; payload code): out[0] registers, out[1] local memory
// a thread, out[2] static and out[3] dynamic shared memory, out[4] CTAs an
// SM, out[5] threads.
int paged_attention_kernel_info(int kind, int d, int payload, int* out) {
  return info(kind, d, payload, out);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
