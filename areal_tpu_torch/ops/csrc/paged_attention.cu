// Paged decode attention for Hopper (sm_90a): one query token per slot,
// K and V read in place through the block table.
//
// Replaces the TPU kernel `areal_tpu/ops/paged_attention.py::_paged_attn_kernel`
// (:118), launched there by `_paged_attention_pallas` (:224). It computes
// exactly what that kernel computes:
//   s = (q . k) * sm_scale in f32, with invalid rows set to -1e30;
//   online (m, l, acc) update over the pool blocks, with the guard
//   p = (m_new > -5e29) ? exp(s - m_new) : 0;
//   out = acc / (l > 0 ? l : 1), so a slot with no valid row outputs 0;
//   written in q's dtype.
//
// Bound. Per call the work is 4 * nH * hd flops per valid KV row, on the
// CUDA cores in f32, against 2 * nKV * hd * sizeof(T) bytes of K and V for
// the same row: about 7 flops per byte for bf16 at Qwen2.5 widths (GQA
// group 7), far below the H100's ~20 f32 flops per byte of HBM (67 TFLOP/s
// over 3.35 TB/s). So the kernel is bound by bytes: the valid K and V rows,
// plus q, out, the block table and the validity mask, over 3.35 TB/s.
//
// Design, first version (made fast in a later change):
//   - one thread block per (kv head h, slot r), on the caller's stream; the
//     TPU kernel's sequential grid axis over the table becomes a loop inside
//     the block, since nothing carries between CUDA blocks;
//   - 1024 threads per block: R * nKV blocks (64 at R=16, nKV=4) leave each
//     SM one block, so that block's warps are all the latency hiding the SM
//     gets. At the serve shapes chip_smoke.py measured 0.77 ms with 128
//     threads and 0.23 ms with 1024 (H100 80GB HBM3, 700 W);
//   - the group's q rows sit in shared memory in f32; acc lives in
//     registers (one output column per thread, the page's rows split over
//     1024 / hd slices of threads, summed once at the end) and m, l in
//     shared memory;
//   - per page: load its validity bits and skip the page if none is set
//     (exact: an all-masked page leaves m, l and acc unchanged), so pages
//     past a slot's length and null-block tails cost only their mask bytes;
//   - K rows are read once per page with 16-byte vector loads by a team of
//     hd * sizeof(T) / 16 threads that reduce the dot product with warp
//     shuffles; rows that are not valid are not read at all, K or V, so the
//     bytes moved are the valid rows (the bound above);
//   - the GQA group (7 for Qwen2.5) is a runtime loop over at most 16 rows:
//     no power-of-two assumption.
// What it leaves on the table: each block walks its pages in turn, and a
// page costs several dependent memory and barrier latencies whatever the
// thread count, so the kernel sits ~30x above its bound. Splitting the page
// walk across blocks (split-KV with a second reduction pass) so the pages
// of all slots run at once is the next step.
//
// K5a, `paged_attn_q8_kernel`, replaces
// `areal_tpu/ops/paged_attention.py::_paged_attn_kernel_q8` (:168), which the
// same `pallas_call` (:270) launches for an int8 pool. It is K3's body
// (`paged_attn_body`, instantiated with an int8 pool) with two changes:
//   - K and V are int8 `[n_blocks, bsz, nKV, hd]` with one f32 scale per
//     (row, kv head) in `[n_blocks, nKV, bsz]`: the scales of one
//     (block, head) are `bsz` contiguous floats, read once per page into
//     shared memory (valid rows only) through the same block id as the data;
//   - one 16-byte load carries 16 int8 values, so a K row's team is hd / 16
//     threads; each value is dequantized in f32 right after the load
//     (`q8 * scale`, as the TPU kernel does at :198 and :212), and the
//     attention math that follows is K3's, in f32.
// Bound: bytes, as for K3, with 2 * (hd + 4) bytes per valid row and kv
// head (int8 data and its f32 scale) in place of 2 * hd * sizeof(T): about
// half of K3's bytes for a bf16 pool.
//
// K4, `paged_verify_kernel`, replaces
// `areal_tpu/ops/paged_attention.py::_paged_verify_kernel` (:284), launched
// there by `_paged_verify_pallas` (:407) for `paged_attention_qlen` (:464):
// speculative verify attention, W query positions per slot, query w of slot
// r attending the logical rows s with valid[r, w, s] (its causal horizon).
// K5b, `paged_verify_q8_kernel`, replaces `_paged_verify_kernel_q8` (:346),
// the same on an int8 pool. Per query row they compute what K3 computes
// (scores in f32 times sm_scale, -1e30 on invalid rows, the guarded online
// softmax, out = acc / (l > 0 ? l : 1), so a query with no valid row
// outputs 0).
// Bound. The bytes are K3's, counted once: each K and V row valid for some
// query, plus q, out, table and the [R, W, span] mask. The work is
// 4 * nH * hd flops per (query, valid row) pair, W times K3's per row; on
// the CUDA cores in f32 (67 TFLOP/s) that is ~0.012 ms at the serve cell's
// verify batch (R 16, W 5, 28/4 heads, ~11,000 valid rows), above its
// ~0.007 ms of bytes, so the f32 version is bound by operations; tensor
// cores would put the ceiling back at the bytes.
// Design, first version:
//   - one block of 1024 threads per (kv head, slot), walking the slot's
//     pages as K3 does; a page with no row valid for any query is skipped
//     (only its mask bytes are read), as is a 32-row tile within a page;
//   - each valid K and V row is read once, into a 32-row tile of shared
//     memory (f32; int8 dequantized right after the load with the page's
//     scale strip, read once into shared memory as K5a does), and scored
//     against all M = W * group query rows: this is what the TPU kernel
//     exists for (one block DMA for all W queries, :297-300);
//   - scores: one warp per query row, one lane per tile row (the K tile's
//     rows padded to hd + 1 floats, so the lanes hit distinct banks); the
//     warp then holds the row's whole tile and does its online-softmax
//     step with shuffles, masking per query from valid[r, w, :];
//   - P.V: each thread owns one output column and the query rows m with
//     m % (1024 / hd) == its slice, so every accumulator lives in one
//     thread's registers from the first page to the store and no
//     cross-thread reduction buffer exists (K3's [kSlices, group, hd]
//     buffer, instantiated with group := W * group, would need ~290 KB at
//     W 8, group 7: more than a block may have);
//   - shared memory is the f32 q rows (M x hd), two 32-row tiles, the
//     tile's probabilities (M x 32) and per-row m, l, alpha: at most
//     ~120 KB at the limits W <= 16 and W * group <= 128 (hd 128), 57 KB at
//     W 5, group 7.
// What it leaves: K3's serial page walk per block, and f32 CUDA-core math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxGroup = 16;
constexpr int kMaxPage = 256;
constexpr float kNegInf = -1e30f;

template <typename P>
struct VecWidth;  // pool elements per 16-byte load
template <>
struct VecWidth<float> {
  static constexpr int value = 4;
};
template <>
struct VecWidth<__nv_bfloat16> {
  static constexpr int value = 8;
};
template <>
struct VecWidth<int8_t> {
  static constexpr int value = 16;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// The body of K3 (P = T, no scales) and K5a (P = int8_t, f32 scales).
template <typename T, typename P, int HD>
__device__ __forceinline__ void paged_attn_body(
    const T* __restrict__ q,             // [R, nH, HD]
    const P* __restrict__ k_pool,        // [n_blocks, bsz, nKV, HD]
    const float* __restrict__ k_scale,   // [n_blocks, nKV, bsz] (int8 only)
    const P* __restrict__ v_pool,        // [n_blocks, bsz, nKV, HD]
    const float* __restrict__ v_scale,   // [n_blocks, nKV, bsz] (int8 only)
    const int32_t* __restrict__ table,   // [R, nb]
    const uint8_t* __restrict__ valid,   // [R, nb * bsz]
    T* __restrict__ out,                 // [R, nH, HD]
    int nKV, int group, int bsz, int nb, int n_blocks, float sm_scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = VecWidth<P>::value;
  constexpr int kTeam = HD / kVec;  // threads sharing one K row
  static_assert(kTeam >= 1 && kTeam <= 32 && (kTeam & (kTeam - 1)) == 0,
                "a K row must be read by a power-of-two team within a warp");
  constexpr int kTeams = kThreads / kTeam;
  constexpr int kSlices = kThreads / HD;  // threads per output column

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int nH = nKV * group;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [group, HD]
  float* s_s = q_s + group * HD;       // [group, bsz] scores, then p
  float* m_s = s_s + group * bsz;      // [group]
  float* l_s = m_s + group;            // [group]
  float* a_s = l_s + group;            // [group] this page's rescale
  float* red = a_s + group;            // [kSlices, group, HD]
  int* mask_s = reinterpret_cast<int*>(red + kSlices * group * HD);  // [bsz]
  float* ks_s = reinterpret_cast<float*>(mask_s + bsz);  // [bsz] (int8 only)
  float* vs_s = ks_s + bsz;                              // [bsz] (int8 only)

  const T* q_r = q + ((size_t)r * nH + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads) q_s[i] = to_f32(q_r[i]);
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int d = tid % HD;      // output column of this thread
  const int slice = tid / HD;  // which rows of a page it accumulates
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const int team = tid / kTeam;
  const int team_lane = tid % kTeam;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t row_stride = (size_t)nKV * HD;
  const size_t block_stride = (size_t)bsz * row_stride;
  const uint8_t* valid_r = valid + (size_t)r * nb * bsz;
  const int32_t* table_r = table + (size_t)r * nb;
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    int any = 0;
    for (int j = tid; j < bsz; j += kThreads) {
      const int v = valid_r[(size_t)b * bsz + j] != 0;
      mask_s[j] = v;
      any |= v;
    }
    if (!__syncthreads_or(any)) continue;
    // a page with valid rows must name a pool block: a bad id faults the
    // launch, as an out-of-range index does in PyTorch's CUDA kernels,
    // rather than reading another allocation or giving a quietly wrong
    // output (block ids of pages without valid rows are never read)
    const int blk = table_r[b];
    if (blk < 0 || blk >= n_blocks) __trap();
    if constexpr (kQuant) {
      // this (block, head)'s scale strips: bsz contiguous floats each
      const float* ks_blk = k_scale + ((size_t)blk * nKV + h) * bsz;
      const float* vs_blk = v_scale + ((size_t)blk * nKV + h) * bsz;
      for (int j = tid; j < bsz; j += kThreads) {
        const bool m = mask_s[j] != 0;
        ks_s[j] = m ? ks_blk[j] : 0.f;
        vs_s[j] = m ? vs_blk[j] : 0.f;
      }
      __syncthreads();
    }

    // scores: s[g, j] = (q[g] . K[j]) * sm_scale, or -1e30 for invalid j
    const P* k_blk = k_pool + (size_t)blk * block_stride + (size_t)h * HD;
    for (int j0 = 0; j0 < bsz; j0 += kTeams) {
      const int j = j0 + team;
      const bool live = j < bsz && mask_s[j] != 0;
      float kf[kVec];
      if (live) {
        load16(k_blk + (size_t)j * row_stride + team_lane * kVec, kf);
        if constexpr (kQuant) {
          const float sc = ks_s[j];  // dequantize right after the load
#pragma unroll
          for (int e = 0; e < kVec; ++e) kf[e] *= sc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kf[e] = 0.f;
      }
      for (int g = 0; g < group; ++g) {
        const float* qg = q_s + g * HD + team_lane * kVec;
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) part += qg[e] * kf[e];
#pragma unroll
        for (int off = kTeam / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (team_lane == 0 && j < bsz)
          s_s[g * bsz + j] = live ? part * sm_scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one warp per group row
    for (int g = warp; g < group; g += kThreads / 32) {
      float* sg = s_s + g * bsz;
      float mx = kNegInf;
      for (int j = lane; j < bsz; j += 32) mx = fmaxf(mx, sg[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = lane; j < bsz; j += 32) {
        const float p = m_new > kNegInf * 0.5f ? expf(sg[j] - m_new) : 0.f;
        sg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * alpha[g] + sum_j p[g, j] * V[j, d]
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] *= a_s[g];
    const P* v_blk = v_pool + (size_t)blk * block_stride + (size_t)h * HD + d;
    for (int j = slice; j < bsz; j += kSlices) {
      if (!mask_s[j]) continue;
      float v = to_f32(v_blk[(size_t)j * row_stride]);
      if constexpr (kQuant) v *= vs_s[j];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < group) acc[g] += s_s[g * bsz + j] * v;
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group) red[(slice * group + g) * HD + d] = acc[g];
  __syncthreads();
  T* out_r = out + ((size_t)r * nH + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD; i += kThreads) {
    const int g = i / HD;
    const int col = i % HD;
    float a = 0.f;
    for (int s = 0; s < kSlices; ++s) a += red[(s * group + g) * HD + col];
    const float l = l_s[g];
    store(a / (l > 0.f ? l : 1.f), out_r + i);
  }
}

// K3: a pool in q's dtype
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                      const T* __restrict__ v_pool,
                      const int32_t* __restrict__ table,
                      const uint8_t* __restrict__ valid, T* __restrict__ out,
                      int nKV, int group, int bsz, int nb, int n_blocks,
                      float sm_scale) {
  paged_attn_body<T, T, HD>(q, k_pool, nullptr, v_pool, nullptr, table, valid,
                            out, nKV, group, bsz, nb, n_blocks, sm_scale);
}

// K5a: an int8 pool with per-(row, kv head) f32 scales
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_q8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ k_pool,
                         const float* __restrict__ k_scale,
                         const int8_t* __restrict__ v_pool,
                         const float* __restrict__ v_scale,
                         const int32_t* __restrict__ table,
                         const uint8_t* __restrict__ valid, T* __restrict__ out,
                         int nKV, int group, int bsz, int nb, int n_blocks,
                         float sm_scale) {
  paged_attn_body<T, int8_t, HD>(q, k_pool, k_scale, v_pool, v_scale, table,
                                 valid, out, nKV, group, bsz, nb, n_blocks,
                                 sm_scale);
}

// K4 / K5b: the verify kernels' limits (ops/paged_attention.py states them)
constexpr int kVerifyMaxW = 16;
constexpr int kVerifyMaxRows = 128;  // W * group
constexpr int kTile = 32;            // K/V rows scored per step, one per lane

// The body of K4 (P = T, no scales) and K5b (P = int8_t, f32 scales).
template <typename T, typename P, int HD>
__device__ __forceinline__ void paged_verify_body(
    const T* __restrict__ q,             // [R, W, nH, HD]
    const P* __restrict__ k_pool,        // [n_blocks, bsz, nKV, HD]
    const float* __restrict__ k_scale,   // [n_blocks, nKV, bsz] (int8 only)
    const P* __restrict__ v_pool,        // [n_blocks, bsz, nKV, HD]
    const float* __restrict__ v_scale,   // [n_blocks, nKV, bsz] (int8 only)
    const int32_t* __restrict__ table,   // [R, nb]
    const uint8_t* __restrict__ valid,   // [R, W, nb * bsz]
    T* __restrict__ out,                 // [R, W, nH, HD]
    int W, int nKV, int group, int bsz, int nb, int n_blocks,
    float sm_scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kVec = VecWidth<P>::value;
  constexpr int kVecsPerRow = HD / kVec;
  constexpr int kSlices = kThreads / HD;  // threads per output column
  constexpr int kAcc = (kVerifyMaxRows + kSlices - 1) / kSlices;
  constexpr int kKStride = HD + 1;  // padded: lane j reads row j conflict-free
  constexpr int kWarps = kThreads / 32;

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int nH = nKV * group;
  const int M = W * group;  // query rows of this block, m = w * group + g
  const size_t span = (size_t)nb * bsz;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [M, HD]
  float* k_s = q_s + M * HD;          // [kTile, HD + 1]
  float* v_s = k_s + kTile * kKStride;  // [kTile, HD]
  float* p_s = v_s + kTile * HD;      // [M, kTile]
  float* m_s = p_s + M * kTile;       // [M]
  float* l_s = m_s + M;               // [M]
  float* a_s = l_s + M;               // [M] this tile's rescale
  float* ks_s = a_s + M;              // [bsz] (int8 only)
  float* vs_s = ks_s + bsz;           // [bsz] (int8 only)
  int* any_s = reinterpret_cast<int*>(vs_s + bsz);  // [bsz] valid for some w

  for (int i = tid; i < M * HD; i += kThreads) {
    const int m = i / HD;
    const int w = m / group;
    const int g = m % group;
    q_s[i] = to_f32(q[(((size_t)r * W + w) * nH + (size_t)h * group + g) * HD + i % HD]);
  }
  for (int m = tid; m < M; m += kThreads) {
    m_s[m] = kNegInf;
    l_s[m] = 0.f;
  }

  const int d = tid % HD;      // output column of this thread
  const int slice = tid / HD;  // its query rows: m = slice + i * kSlices
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  const size_t row_stride = (size_t)nKV * HD;
  const size_t block_stride = (size_t)bsz * row_stride;
  const uint8_t* valid_r = valid + (size_t)r * W * span;
  const int32_t* table_r = table + (size_t)r * nb;
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    const size_t page = (size_t)b * bsz;
    int any = 0;
    for (int j = tid; j < bsz; j += kThreads) {
      int v = 0;
      for (int w = 0; w < W; ++w) v |= valid_r[(size_t)w * span + page + j];
      any_s[j] = v != 0;
      any |= v;
    }
    if (!__syncthreads_or(any)) continue;
    // a page with a row valid for some query must name a pool block: a bad
    // id faults the launch (ids of pages without such rows are never read)
    const int blk = table_r[b];
    if (blk < 0 || blk >= n_blocks) __trap();
    if constexpr (kQuant) {
      const float* ks_blk = k_scale + ((size_t)blk * nKV + h) * bsz;
      const float* vs_blk = v_scale + ((size_t)blk * nKV + h) * bsz;
      for (int j = tid; j < bsz; j += kThreads) {
        const bool live = any_s[j] != 0;
        ks_s[j] = live ? ks_blk[j] : 0.f;
        vs_s[j] = live ? vs_blk[j] : 0.f;
      }
      // the barrier of the first tile's skip test orders these writes
    }
    const P* k_blk = k_pool + (size_t)blk * block_stride + (size_t)h * HD;
    const P* v_blk = v_pool + (size_t)blk * block_stride + (size_t)h * HD;

    for (int j0 = 0; j0 < bsz; j0 += kTile) {
      const int nt = min(kTile, bsz - j0);
      if (!__syncthreads_or(tid < nt && any_s[j0 + tid] != 0)) continue;
      // the tile's K and V rows in f32, read once; rows no query may read
      // are zero (their probabilities are exactly 0)
      for (int i = tid; i < kTile * kVecsPerRow; i += kThreads) {
        const int jj = i / kVecsPerRow;
        const int c = (i % kVecsPerRow) * kVec;
        float kf[kVec], vf[kVec];
        if (jj < nt && any_s[j0 + jj]) {
          const size_t off = (size_t)(j0 + jj) * row_stride + c;
          load16(k_blk + off, kf);
          load16(v_blk + off, vf);
          if constexpr (kQuant) {  // dequantize right after the load
            const float ks = ks_s[j0 + jj];
            const float vs = vs_s[j0 + jj];
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              kf[e] *= ks;
              vf[e] *= vs;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) kf[e] = vf[e] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          k_s[jj * kKStride + c + e] = kf[e];
          v_s[jj * HD + c + e] = vf[e];
        }
      }
      __syncthreads();

      // scores and the online-softmax step: warp per query row, lane per
      // tile row
      for (int m = warp; m < M; m += kWarps) {
        const int w = m / group;
        const bool live =
            lane < nt && valid_r[(size_t)w * span + page + j0 + lane] != 0;
        float s = kNegInf;
        if (live) {
          const float* qm = q_s + m * HD;
          const float* kj = k_s + lane * kKStride;
          float dot = 0.f;
#pragma unroll 16
          for (int e = 0; e < HD; ++e) dot += qm[e] * kj[e];
          s = dot * sm_scale;
        }
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[m];
        const float m_new = fmaxf(m_prev, mx);
        const float p = m_new > kNegInf * 0.5f ? expf(s - m_new) : 0.f;
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        p_s[m * kTile + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[m] = l_s[m] * alpha + sum;
          m_s[m] = m_new;
          a_s[m] = alpha;
        }
      }
      __syncthreads();

      // acc[m, d] = acc[m, d] * alpha[m] + sum_j p[m, j] * V[j, d]
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int m = slice + i * kSlices;
        if (m < M) {
          const float* pm = p_s + m * kTile;
          float a = acc[i] * a_s[m];
          for (int jj = 0; jj < nt; ++jj) a += pm[jj] * v_s[jj * HD + d];
          acc[i] = a;
        }
      }
      // the next tile's skip test is the barrier before k_s/v_s/p_s reuse
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int m = slice + i * kSlices;
    if (m < M) {
      const int w = m / group;
      const int g = m % group;
      const float l = l_s[m];
      store(acc[i] / (l > 0.f ? l : 1.f),
            out + (((size_t)r * W + w) * nH + (size_t)h * group + g) * HD + d);
    }
  }
}

// K4: a pool in q's dtype
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_verify_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int32_t* __restrict__ table,
                        const uint8_t* __restrict__ valid, T* __restrict__ out,
                        int W, int nKV, int group, int bsz, int nb,
                        int n_blocks, float sm_scale) {
  paged_verify_body<T, T, HD>(q, k_pool, nullptr, v_pool, nullptr, table,
                              valid, out, W, nKV, group, bsz, nb, n_blocks,
                              sm_scale);
}

// K5b: an int8 pool with per-(row, kv head) f32 scales
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_verify_q8_kernel(const T* __restrict__ q,
                           const int8_t* __restrict__ k_pool,
                           const float* __restrict__ k_scale,
                           const int8_t* __restrict__ v_pool,
                           const float* __restrict__ v_scale,
                           const int32_t* __restrict__ table,
                           const uint8_t* __restrict__ valid,
                           T* __restrict__ out, int W, int nKV, int group,
                           int bsz, int nb, int n_blocks, float sm_scale) {
  paged_verify_body<T, int8_t, HD>(q, k_pool, k_scale, v_pool, v_scale, table,
                                   valid, out, W, nKV, group, bsz, nb,
                                   n_blocks, sm_scale);
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* k_scale;  // null for an fp pool
  const void* v_pool;
  const void* v_scale;  // null for an fp pool
  const void* table;
  const void* valid;
  void* out;
  int R, nKV, group, bsz, nb, n_blocks;
  float sm_scale;
  int W;  // query positions per slot (K4, K5b); 0 for K3, K5a
};

template <typename T, typename P, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kSlices = kThreads / HD;
  const size_t smem =
      sizeof(float) * ((size_t)a.group * HD + (size_t)a.group * a.bsz +
                       3 * a.group + (size_t)kSlices * a.group * HD +
                       (kQuant ? 2 * (size_t)a.bsz : 0)) +
      sizeof(int) * a.bsz;
  const dim3 grid(a.nKV, a.R);
  if constexpr (kQuant) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_attn_q8_kernel<T, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_attn_q8_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k_pool),
        static_cast<const float*>(a.k_scale),
        static_cast<const int8_t*>(a.v_pool),
        static_cast<const float*>(a.v_scale),
        static_cast<const int32_t*>(a.table),
        static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.nKV,
        a.group, a.bsz, a.nb, a.n_blocks, a.sm_scale);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_attn_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), static_cast<const int32_t*>(a.table),
        static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.nKV,
        a.group, a.bsz, a.nb, a.n_blocks, a.sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, typename P, int HD>
cudaError_t launch_verify(const Args& a, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const size_t M = (size_t)a.W * a.group;
  const size_t smem =
      sizeof(float) * (M * HD + (size_t)kTile * (HD + 1) + (size_t)kTile * HD +
                       M * kTile + 3 * M + 2 * (size_t)a.bsz) +
      sizeof(int) * a.bsz;
  const dim3 grid(a.nKV, a.R);
  if constexpr (kQuant) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_verify_q8_kernel<T, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_verify_q8_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k_pool),
        static_cast<const float*>(a.k_scale),
        static_cast<const int8_t*>(a.v_pool),
        static_cast<const float*>(a.v_scale),
        static_cast<const int32_t*>(a.table),
        static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.W,
        a.nKV, a.group, a.bsz, a.nb, a.n_blocks, a.sm_scale);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_verify_kernel<T, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_verify_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k_pool),
        static_cast<const T*>(a.v_pool), static_cast<const int32_t*>(a.table),
        static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.W,
        a.nKV, a.group, a.bsz, a.nb, a.n_blocks, a.sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  const bool v = a.W > 0;
  switch (hd) {
    case 16:
      return v ? launch_verify<T, P, 16>(a, stream) : launch<T, P, 16>(a, stream);
    case 32:
      return v ? launch_verify<T, P, 32>(a, stream) : launch<T, P, 32>(a, stream);
    case 64:
      return v ? launch_verify<T, P, 64>(a, stream) : launch<T, P, 64>(a, stream);
    case 128:
      return v ? launch_verify<T, P, 128>(a, stream) : launch<T, P, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t check_args(int R, int nH, int nKV, int bsz, int nb) {
  if (R <= 0 || nb <= 0 || nKV <= 0 || nH % nKV != 0)
    return cudaErrorInvalidValue;
  const int group = nH / nKV;
  if (group < 1 || group > kMaxGroup || bsz < 1 || bsz > kMaxPage || R > 65535)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t check_verify(int W, int group) {
  if (W < 1 || W > kVerifyMaxW || W * group > kVerifyMaxRows)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// Plain C entries for ctypes. Every pointer is a device pointer of a
// contiguous tensor; `stream` is the caller's cudaStream_t. Each returns the
// launch's cudaGetLastError() (0 on success); the wrapper raises on
// anything else. R and nb must be at least 1: with no row to attend the
// output is 0, which the wrapper returns without a launch.

// K3: q, k_pool and v_pool in one dtype (f32 or bf16).
extern "C" int areal_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* valid, void* out, int R,
                                     int nH, int nKV, int hd, int bsz, int nb,
                                     int n_blocks, float sm_scale, int is_bf16,
                                     void* stream) {
  const cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, nullptr, v_pool, nullptr, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, s);
  return dispatch_hd<float, float>(hd, a, s);
}

// K5a: q in f32 or bf16; int8 k/v pools with f32 scales [n_blocks, nKV, bsz].
extern "C" int areal_paged_attention_q8(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* valid, void* out,
    int R, int nH, int nKV, int hd, int bsz, int nb, int n_blocks,
    float sm_scale, int is_bf16, void* stream) {
  const cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, k_scale, v_pool, v_scale, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a, s);
  return dispatch_hd<float, int8_t>(hd, a, s);
}

// K4: q [R, W, nH, hd], k_pool and v_pool in q's dtype (f32 or bf16), valid
// [R, W, nb * bsz]; out [R, W, nH, hd].
extern "C" int areal_paged_verify(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* valid, void* out, int R, int W,
                                  int nH, int nKV, int hd, int bsz, int nb,
                                  int n_blocks, float sm_scale, int is_bf16,
                                  void* stream) {
  cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e == cudaSuccess) e = check_verify(W, nH / nKV);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, nullptr, v_pool, nullptr, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, s);
  return dispatch_hd<float, float>(hd, a, s);
}

// K5b: K4 on int8 k/v pools with f32 scales [n_blocks, nKV, bsz].
extern "C" int areal_paged_verify_q8(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* valid, void* out,
    int R, int W, int nH, int nKV, int hd, int bsz, int nb, int n_blocks,
    float sm_scale, int is_bf16, void* stream) {
  cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e == cudaSuccess) e = check_verify(W, nH / nKV);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, k_scale, v_pool, v_scale, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16, int8_t>(hd, a, s);
  return dispatch_hd<float, int8_t>(hd, a, s);
}

extern "C" const char* areal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
