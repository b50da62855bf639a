// Paged attention for the decode-serving path, f32, hand-written for Hopper
// (sm_90a). Two kernels, each behind an extern "C" launcher that returns
// cudaGetLastError() so the ctypes wrapper in ops/nn_ops.py can raise.
//
// Pool layout (as in paddle_tpu/serving/decode/kv_cache.py): k_pages and
// v_pages are (H, NB, BS, D) f32, contiguous; block_tables is (S, max_bps)
// int32 with each sequence's cache blocks in order, padded with the scratch
// block 0. A key at position t of sequence s lives at
//   pages[h, block_tables[s, t / BS], t % BS, :].
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
//   Design: one CTA of 8 warps per (16-row query tile, head, sequence), so
//   a 256-token prompt over 8 heads fills 128 CTAs. The q tile is staged in
//   shared memory once; K/V are staged 32 keys at a time, each key row
//   located through the block table, so any block size works. The key loop
//   stops at the tile's last causal key. Each warp owns two query rows and
//   each lane one key of the chunk, so a row's online-softmax update (max,
//   rescale, sum) is a warp shuffle reduction on scores held in registers;
//   each thread then keeps a slice of the tile's output in registers for
//   the P.V update. Shared rows are padded by 4 floats so float4 reads
//   across lanes are free of bank conflicts. Plain f32 FMA, no tensor cores
//   (f32, no TF32).
//
// Both kernels are compiled for head_dim D in {16, 32, 64, 128} and take any
// BS >= 1.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSplitKeys = 64;        // keys of one decode range
constexpr int kSplitWarps = 8;
constexpr int kMaxCluster = 8;        // CTAs of one (head, slot): portable
constexpr int kPrefillRows = 16;      // query rows per CTA
constexpr int kKeyChunk = 32;         // keys staged per step: one per lane
constexpr int kPrefillWarps = 8;
constexpr int kPrefillThreads = kPrefillWarps * 32;
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

template <int kD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD / 4; ++c) {
    const float4 x = a4[c];
    const float4 y = b4[c];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// One CTA per (head, slot, rank); the ranks of one (head, slot) are one
// cluster along z. Rank r takes keys [r passes kSplitKeys, (r + 1) passes
// kSplitKeys), kSplitKeys at a time with an online softmax across passes.
template <int kD>
__global__ void __launch_bounds__(kSplitWarps * 32)
paged_decode_attention_kernel(const float* __restrict__ q,
                              const float* __restrict__ k_pages,
                              const float* __restrict__ v_pages,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ context_lens,
                              float* __restrict__ out, int H, int NB, int BS,
                              int max_bps, int passes, float scale_log2) {
  namespace cg = cooperative_groups;
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
  const float* kh = k_pages + (size_t)h * NB * BS * kD + col;
  const float* vh = v_pages + (size_t)h * NB * BS * kD + col;
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
        const size_t row =
            ((size_t)blk_s[t / BS - b_first] * BS + t % BS) * kD;
        kr[st] = __ldg(reinterpret_cast<const float4*>(kh + row));
        vr[st] = __ldg(reinterpret_cast<const float4*>(vh + row));
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

template <int kD>
__global__ void __launch_bounds__(kPrefillThreads)
paged_prefill_attention_kernel(const float* __restrict__ q,
                               const float* __restrict__ k_pages,
                               const float* __restrict__ v_pages,
                               const int* __restrict__ block_tables,
                               float* __restrict__ out, int H, int Lq, int NB,
                               int BS, int max_bps, float sm_scale) {
  constexpr int kDP = kD + 4;                 // padded shared row stride
  constexpr int kSP = kKeyChunk + 1;          // padded score row stride
  constexpr int kD4 = kD / 4;
  constexpr int kAcc = kPrefillRows * kD / kPrefillThreads;
  constexpr int kRowsPerWarp = kPrefillRows / kPrefillWarps;
  static_assert(kPrefillRows * kD % kPrefillThreads == 0, "tile split");
  __shared__ __align__(16) float q_s[kPrefillRows * kDP];
  __shared__ __align__(16) float k_s[kKeyChunk * kDP];
  __shared__ __align__(16) float v_s[kKeyChunk * kDP];
  __shared__ float p_s[kPrefillRows * kSP];
  __shared__ float a_s[kPrefillRows];
  __shared__ float l_s[kPrefillRows];

  const int q0 = blockIdx.x * kPrefillRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = min(kPrefillRows, Lq - q0);
  const size_t bh_off = ((size_t)b * H + h) * Lq * kD;

  for (int e = tid; e < kPrefillRows * kD4; e += kPrefillThreads) {
    const int r = e / kD4;
    const int c = e % kD4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = reinterpret_cast<const float4*>(q + bh_off + (size_t)(q0 + r) * kD)[c];
    *reinterpret_cast<float4*>(q_s + r * kDP + 4 * c) = val;
  }

  // warp w owns rows w, w + kPrefillWarps, ...: their running max and sum
  // live in registers (every lane holds the same copy)
  float m_row[kRowsPerWarp];
  float l_row[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m_row[i] = neg_inf();
    l_row[i] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const int* table = block_tables + (size_t)b * max_bps;
  const size_t head_off = (size_t)h * NB * BS * kD;
  const int n_keys = q0 + rows;               // the tile's last causal key + 1

  for (int k0 = 0; k0 < n_keys; k0 += kKeyChunk) {
    const int nk = min(kKeyChunk, n_keys - k0);
    for (int e = tid; e < nk * kD4; e += kPrefillThreads) {
      const int j = e / kD4;
      const int c = e % kD4;
      const int t = k0 + j;
      const size_t row = head_off + ((size_t)table[t / BS] * BS + t % BS) * kD;
      *reinterpret_cast<float4*>(k_s + j * kDP + 4 * c) =
          reinterpret_cast<const float4*>(k_pages + row)[c];
      *reinterpret_cast<float4*>(v_s + j * kDP + 4 * c) =
          reinterpret_cast<const float4*>(v_pages + row)[c];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + i * kPrefillWarps;
      float p = 0.f;
      float alpha = 0.f;
      if (r < rows) {                         // uniform across the warp
        const bool valid = lane < nk && k0 + lane <= q0 + r;
        const float sc = valid
            ? dot<kD>(q_s + r * kDP, k_s + lane * kDP) * sm_scale : neg_inf();
        // key 0 is causal for every row, so m_new is finite from chunk 0 on
        const float m_new = fmaxf(m_row[i], warp_max(sc));
        alpha = expf(m_row[i] - m_new);
        p = valid ? expf(sc - m_new) : 0.f;
        l_row[i] = l_row[i] * alpha + warp_sum(p);
        m_row[i] = m_new;
      }
      p_s[r * kSP + lane] = p;
      if (lane == 0) a_s[r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kPrefillThreads;
      const int r = e / kD;
      const int d = e % kD;
      const float* pr = p_s + r * kSP;
      float a = acc[i] * a_s[r];
#pragma unroll
      for (int j = 0; j < kKeyChunk; ++j) {
        if (j < nk) a = fmaf(pr[j], v_s[j * kDP + d], a);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (lane == 0) l_s[warp + i * kPrefillWarps] = l_row[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int e = tid + i * kPrefillThreads;
    const int r = e / kD;
    const int d = e % kD;
    if (r < rows) out[bh_off + (size_t)(q0 + r) * kD + d] = acc[i] / l_s[r];
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// (H, S, ranks) CTAs in clusters of (1, 1, ranks): up to kMaxCluster
// ranks, each taking `passes` ranges of kSplitKeys keys
template <int kD>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
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
      &cfg, paged_decode_attention_kernel<kD>, static_cast<const float*>(q),
      static_cast<const float*>(k_pages), static_cast<const float*>(v_pages),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(context_lens), static_cast<float*>(out), H, NB,
      BS, max_bps, passes, sm_scale * kLog2e);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kD>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, void* out, int B, int H, int Lq,
                   int NB, int BS, int max_bps, float sm_scale,
                   cudaStream_t stream) {
  const dim3 grid((Lq + kPrefillRows - 1) / kPrefillRows, H, B);
  paged_prefill_attention_kernel<kD><<<grid, kPrefillThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(block_tables),
      static_cast<float*>(out), H, Lq, NB, BS, max_bps, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* context_lens, void* out, int S, int H,
                           int D, int NB, int BS, int max_bps, float sm_scale,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_decode<16>(q, k_pages, v_pages, block_tables,
                               context_lens, out, S, H, NB, BS, max_bps,
                               sm_scale, st);
    case 32:
      return launch_decode<32>(q, k_pages, v_pages, block_tables,
                               context_lens, out, S, H, NB, BS, max_bps,
                               sm_scale, st);
    case 64:
      return launch_decode<64>(q, k_pages, v_pages, block_tables,
                               context_lens, out, S, H, NB, BS, max_bps,
                               sm_scale, st);
    case 128:
      return launch_decode<128>(q, k_pages, v_pages, block_tables,
                                context_lens, out, S, H, NB, BS, max_bps,
                                sm_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* block_tables,
                            void* out, int B, int H, int Lq, int D, int NB,
                            int BS, int max_bps, float sm_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_prefill<16>(q, k_pages, v_pages, block_tables,
                                out, B, H, Lq, NB, BS, max_bps, sm_scale,
                                st);
    case 32:
      return launch_prefill<32>(q, k_pages, v_pages, block_tables,
                                out, B, H, Lq, NB, BS, max_bps, sm_scale,
                                st);
    case 64:
      return launch_prefill<64>(q, k_pages, v_pages, block_tables,
                                out, B, H, Lq, NB, BS, max_bps, sm_scale,
                                st);
    case 128:
      return launch_prefill<128>(q, k_pages, v_pages, block_tables,
                                 out, B, H, Lq, NB, BS, max_bps, sm_scale,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
