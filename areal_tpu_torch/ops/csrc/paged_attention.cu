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
// Bound. Per call the work is 4 * nH * hd flops per valid KV row against
// 2 * nKV * hd * sizeof(T) bytes of K and V for the same row: about 7
// flops per byte for bf16 at Qwen2.5 widths (GQA group 7), far below the
// H100's ~20 f32 flops per byte of HBM (67 TFLOP/s over 3.35 TB/s) and its
// ~295 bf16 tensor-core flops per byte. So the kernel is bound by bytes:
// the valid K and V rows, plus q, out, the block table and the validity
// mask, over 3.35 TB/s (0.0068 ms at the serve batch: R 16, 28/4 heads,
// hd 128, ~11,018 valid rows).
//
// K5a, `paged_attn_q8_kernel` / `paged_attn_q8_mma_kernel`, replaces
// `areal_tpu/ops/paged_attention.py::_paged_attn_kernel_q8` (:168), which the
// same `pallas_call` (:270) launches for an int8 pool: K and V are int8
// `[n_blocks, bsz, nKV, hd]` with one f32 scale per (row, kv head) in
// `[n_blocks, nKV, bsz]` (the scales of one (block, head) are `bsz`
// contiguous floats), dequantized as `q8 * scale` (the TPU kernel's :198 and
// :212); the attention math is K3's. Bound: bytes, as for K3, with
// 2 * (hd + 4) bytes per valid row and kv head (int8 data and its f32
// scale) in place of 2 * hd * sizeof(T): about half of K3's bytes.
//
// Two routes for K3 and K5a, by q's dtype:
//
// bf16 q (the main path), `paged_attn_mma_kernel` (K3) and
// `paged_attn_q8_mma_kernel` (K5a): split-KV over pages on the tensor
// cores, with warps over keys.
//   - grid (split, kv head, slot): a split owns `pages_per_split` pages of
//     the slot's table, so the pages of every slot run at once; the
//     wrapper picks the most pages (a power of two) that leave 1.5 blocks
//     per SM: 2 at the serve batch (9-10 pages), the fastest of the card's
//     sweep there, and the fastest or within 1.27x of it over tables of
//     2-32 pages (chip_smoke.py --decode-sweep);
//   - the group's M = group <= 16 query rows are one m16 A tile, read from
//     global memory straight into registers (HD / 4 of them) while the
//     block scans its split's mask bytes once: the pool row of each valid
//     row into shared memory (the block id is checked here) and the list
//     of 64-row tiles that hold one. A split with none writes m = -1e30,
//     l = 0 and returns, having read only its mask bytes and table entries;
//   - four warps per block; warp w takes rows 16w..16w+15 of every live
//     tile and copies its own quarter through the block table with 16-byte
//     cp.async, double-buffered, with only __syncwarp between its steps
//     (rows that are not valid are zero-filled and never read); a block
//     holds ~70 KB (K5a ~73 KB) at the serve batch, so three blocks, twelve
//     warps, per SM;
//   - per warp and tile: S = Q K^T for its 16 keys and one 16-key P V stage
//     on mma.sync.m16n8k16 (bf16 in, f32 sums) in K1's register layout,
//     scores in log2 units, P as bf16 hi + lo, the stage summed from zero
//     and added in f32 (one bf16 term misses the bf16 tolerance,
//     `tests/test_torch_paged_decode_design.py`); each warp keeps its own
//     (m, l, acc);
//   - K5a: each warp widens its int8 quarter unscaled to bf16 in shared
//     memory (exact); the K scale multiplies score column j after the
//     product and the V scale probability column j before its hi/lo split
//     (l sums the unscaled p), both in f32;
//   - at the split's end the four warps' states meet in shared memory (over
//     the tile buffers) and merge in warp order with the combine's formula;
//     the block writes f32 partials (m, l, acc) for the combine pass
//     (`paged_attn_combine_kernel` / `paged_attn_q8_combine_kernel`: the
//     verify combine at W = 1, under K3's and K5a's names), or with one
//     split the output itself.
//   Registers (ptxas, sm_90a): K3 182/128/72/56 and K5a 180/128/80/64 at hd
//   128/64/32/16, the combine 39; no spills.
//   What it leaves: at the serve batch it runs ~3.5x its byte bound; each
//   block pays a serial prologue (mask scan, table reads, the first
//   quarter) before its two to eight quarter steps, and 9 of the 16 rows of
//   the m16 tile are padding at Qwen2.5's group of 7.
//
// f32 q, `paged_attn_kernel` and `paged_attn_q8_kernel`: the first version,
// kept because f32 is held at an f32 tolerance that bf16 products cannot
// meet; it never runs on the main path.
//   - one thread block of 1024 threads per (kv head h, slot r), walking the
//     slot's pages in turn (R * nKV blocks, 64 at the serve batch);
//   - the group's q rows sit in shared memory in f32; acc lives in
//     registers (one output column per thread, the page's rows split over
//     1024 / hd slices of threads, summed once at the end) and m, l in
//     shared memory;
//   - per page: load its validity bits and skip the page if none is set
//     (exact: an all-masked page leaves m, l and acc unchanged);
//   - K rows are read once per page with 16-byte vector loads by a team of
//     hd * sizeof(T) / 16 threads that reduce the dot product with warp
//     shuffles; rows that are not valid are not read at all, K or V;
//     K5a reads the page's scale strips into shared memory (valid rows
//     only) and dequantizes each value in f32 right after its load;
//   - the GQA group is a runtime loop over at most 16 rows.
//   Each page costs several dependent memory and barrier latencies, so in
//   bf16 it ran ~34x its bound at the serve batch (0.232 ms, chip_smoke.py's
//   paged line, H100 80GB HBM3, 700 W).
//
// K4 and K5b replace `areal_tpu/ops/paged_attention.py::_paged_verify_kernel`
// (:284) and `::_paged_verify_kernel_q8` (:346), launched there by
// `_paged_verify_pallas` (:407) for `paged_attention_qlen` (:464):
// speculative verify attention, W query positions per slot, query w of slot
// r attending the logical rows s with valid[r, w, s] (its causal horizon),
// on a pool in q's dtype (K4) or an int8 pool with per-(row, kv head) f32
// scales (K5b). Per query row they compute what K3 computes: scores in f32
// times sm_scale, -1e30 on invalid rows, the guarded online softmax
// (p = m_new > -5e29 ? exp(s - m_new) : 0), out = acc / (l > 0 ? l : 1), so
// a query with no valid row outputs exactly 0, in q's dtype; a block id
// outside the pool on a page with a row valid for some query traps.
// Bound. Bytes, counted once: each K and V row valid for some query, plus q,
// out, table and the [R, W, span] mask. The work is 4 * nH * hd flops per
// (query, valid row) pair; on the tensor cores (989 TFLOP/s bf16) that is far
// below the bytes' time (at the serve cell's verify batch: R 16, W 5, 28/4
// heads, ~10,750 valid rows, 0.0069 ms of bytes for a bf16 pool, 0.0038 for
// int8; H100 SXM, 3.35 TB/s).
//
// Two routes, by q's dtype:
//
// bf16 q (the main path), `paged_verify_mma_kernel` (K4) and
// `paged_verify_q8_mma_kernel` (K5b): split-KV over pages on the tensor
// cores.
//   - grid (split, kv head, slot): a split owns `pages_per_split` pages of
//     the slot's table, so the pages of every slot run at once. The wrapper
//     picks the most pages (a power of two, at most kVMaxSplitRows rows)
//     that leave two blocks per SM: 2 at the spec batch (9 pages), the
//     fastest of 1, 2, 4 and 9 (0.042, 0.038, 0.058 and 0.094 device ms for
//     K4; H100 80GB HBM3, 700 W, chip_smoke.py's verify line);
//   - a block has ceil(M / 16) warps for the M = W * group query rows of its
//     (slot, kv head), m = w * group + g; warp i owns rows 16i..16i+15 as a
//     padded bf16 shared tile, read as ldmatrix A fragments;
//   - first the block reads its split's mask bytes once: a W-bit row mask
//     and the row's pool offset per logical row into shared memory (the
//     block id is checked here, for rows valid for some query), and a list
//     of the 64-row tiles that hold such a row. A split with none writes
//     m = -1e30, l = 0 and returns, having read only its mask bytes and
//     table entries;
//   - the live tiles' K and V rows come through the block table with
//     16-byte cp.async, double-buffered; a tile may cross pages (pages of
//     fewer than 64 rows), and rows valid for no query are zero-filled and
//     never read;
//   - S = Q K^T and O += P V use mma.sync.m16n8k16 (bf16 in, f32 sums) in
//     K1's register layout (`flash_attention.cu`); scores in log2 units;
//     P goes to P V as bf16 hi + lo, each 16-key stage summed from zero
//     and added in f32 (the tensor cores' truncating sum; one bf16 term
//     misses the bf16 tolerance, `tests/test_torch_paged_verify_design.py`);
//   - K5b: int8 values are exact in bf16, so the int8 tiles (cp.async into
//     their own double buffer) are widened unscaled to bf16 in one
//     shared-to-shared pass; the K scale multiplies score column j after
//     the product and the V scale multiplies probability column j before
//     its hi/lo split (l sums the unscaled p), both in f32;
//   - each split writes f32 partials (m in log2 units, l, the unnormalised
//     acc [M, hd]) to scratch the wrapper allocates; a second launch,
//     `paged_verify_combine_kernel` (`paged_verify_q8_combine_kernel` for
//     K5b, so a profile files it under its kernel), reads a (slot, kv head)'s
//     splits in split order, out = sum 2^(m_s - M*) acc_s / sum 2^(m_s - M*)
//     l_s over the splits with l_s > 0, and 0 where there is none. With one
//     split the main kernel writes the output itself and nothing else runs.
//   Shared memory per block (hd 128, W 5, group 7, 128-row pages, two pages
//   per split): q 13,056 bytes, K/V 69,632 (K5b: 34,816 bf16 + 36,864 int8
//   + 1,024 scales), row masks and offsets 1,536, tile lists 32: 84,256
//   bytes (K5b 87,328), so two blocks per SM; at most 157,696 (K5b, W x
//   group 128, 4096 rows per split). Registers (ptxas, sm_90a): K4
//   181/144/104/98 and K5b 179/151/110/76 at hd 128/64/32/16, the combine
//   39; no spills.
//   What it leaves: at the spec batch K4 runs ~5.5x its byte bound. Each
//   block pays a serial prologue (mask scan, then the Q tile and first K/V
//   tile) before its two to four tiles; the Q fragments are re-read from
//   shared memory for each tile; the partials cost 2 * M * hd * 4 bytes per
//   live split besides the K/V rows; mma.sync, not wgmma.
//
// f32 q, `paged_verify_kernel` and `paged_verify_q8_kernel`: the first
// version, kept because f32 is held at an f32 tolerance that bf16 products
// cannot meet; it never runs on the main path.
//   - one block of 1024 threads per (kv head, slot), walking the slot's
//     pages as K3's first version does; a page with no row valid for any
//     query is skipped (only its mask bytes are read), as is a 32-row tile
//     within a page;
//   - each valid K and V row is read once, into a 32-row tile of shared
//     memory (f32; int8 dequantized right after the load with the page's
//     scale strip, read once into shared memory as K5a does), and scored
//     against all M = W * group query rows;
//   - scores: one warp per query row, one lane per tile row (the K tile's
//     rows padded to hd + 1 floats); the warp then does its online-softmax
//     step with shuffles, masking per query from valid[r, w, :];
//   - P.V: each thread owns one output column and the query rows m with
//     m % (1024 / hd) == its slice;
//   - shared memory is the f32 q rows (M x hd), two 32-row tiles, the
//     tile's probabilities (M x 32) and per-row m, l, alpha.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// the pool's element type, as the wrapper passes it
constexpr int kPoolF32 = 0;
constexpr int kPoolBF16 = 1;
constexpr int kPoolI8 = 2;
template <typename P>
__host__ __device__ constexpr int pool_code() {
  return std::is_same<P, float>::value ? kPoolF32 : std::is_same<P, bf16>::value ? kPoolBF16 : kPoolI8;
}

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
struct VecWidth<int8_t> {
  static constexpr int value = 16;
};
template <>
struct VecWidth<bf16> {
  static constexpr int value = 8;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

// a bf16 pool under f32 q: each value widened exactly, as `.to(torch.float32)`
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }

// The first version's body of K3 (P = T, no scales; P = bf16 for a bf16
// pool under f32 q) and K5a (P = int8_t, f32 scales), instantiated for f32
// q only: bf16 q takes the tensor-core route.
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

// K3 (f32 q): an fp pool, P = T or a bf16 pool (each value widened exactly
// after its load)
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attn_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                      const P* __restrict__ v_pool,
                      const int32_t* __restrict__ table,
                      const uint8_t* __restrict__ valid, T* __restrict__ out,
                      int nKV, int group, int bsz, int nb, int n_blocks,
                      float sm_scale) {
  paged_attn_body<T, P, HD>(q, k_pool, nullptr, v_pool, nullptr, table, valid,
                            out, nKV, group, bsz, nb, n_blocks, sm_scale);
}

// K5a (f32 q): an int8 pool with per-(row, kv head) f32 scales
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
constexpr int kTile = 32;  // first version: K/V rows scored per step, one per lane

// The first version's body of K4 (P = T, no scales; P = bf16 for a bf16 pool
// under f32 q) and K5b (P = int8_t, f32 scales), instantiated for f32 q
// only: bf16 q takes the tensor-core route.
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

// K4 (f32 q): an fp pool, P = T or bf16
template <typename T, typename P, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_verify_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const int32_t* __restrict__ table,
                        const uint8_t* __restrict__ valid, T* __restrict__ out,
                        int W, int nKV, int group, int bsz, int nb,
                        int n_blocks, float sm_scale) {
  paged_verify_body<T, P, HD>(q, k_pool, nullptr, v_pool, nullptr, table,
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

// ===========================================================================
// K4 and K5b, bf16 q: split-KV over pages on the tensor cores
// ===========================================================================

constexpr int kVTile = 64;             // K/V rows per tile
constexpr int kVRowPad = 8;            // bf16 elements (16 bytes) past each shared row
constexpr int kVRawPad = 16;           // bytes past each shared int8 row
constexpr int kVMaxThreads = kVerifyMaxRows / 16 * 32;  // 8 warps of 16 query rows
constexpr int kVMaxSplitRows = 4096;   // logical rows per split
constexpr int kCombineThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct VerifyArgs {
  const bf16* q;           // [R, W, nH, HD]
  const void* k_pool;      // [n_blocks, bsz, nKV, HD], bf16 or int8
  const float* k_scale;    // [n_blocks, nKV, bsz] (int8 only)
  const void* v_pool;
  const float* v_scale;
  const int32_t* table;    // [R, nb]
  const uint8_t* valid;    // [R, W, nb * bsz]
  float* part_m;           // [R, nKV, n_splits, M], log2 units (n_splits > 1)
  float* part_l;           // [R, nKV, n_splits, M]
  float* part_acc;         // [R, nKV, n_splits, M, HD], unnormalised
  bf16* out;               // [R, W, nH, HD]
  int R, W, nKV, group, bsz, nb, n_blocks, pps, n_splits;
  float sm_scale;
};

// Byte offsets of one block's dynamic shared memory, as the launch sizes it.
struct VerifySmem {
  size_t q, kv, raw, scale, row_off, row_mask, live, list, total;
};

// Bytes of one shared row of raw (not bf16) pool elements: an int8 or f32
// pool's rows are staged as they are, then widened or rounded to bf16.
__host__ __device__ inline size_t raw_row_bytes(int hd, int pool) {
  return (size_t)hd * (pool == kPoolF32 ? 4 : 1) + kVRawPad;
}

__host__ __device__ inline VerifySmem verify_smem(int M, int hd, int bsz, int pps, int pool) {
  const bool raw = pool != kPoolBF16, quant = pool == kPoolI8;
  const size_t ld = (size_t)hd + kVRowPad;
  const size_t m_pad = (size_t)(M + 15) / 16 * 16;
  const size_t rows = (size_t)(pps * bsz + kVTile - 1) / kVTile * kVTile;
  VerifySmem s;
  size_t o = 0;
  s.q = o;
  o += m_pad * ld * 2;
  s.kv = o;  // K and V bf16 tiles: two buffers, or one for a raw pool (converted here)
  o += (raw ? 1 : 2) * 2 * (size_t)kVTile * ld * 2;
  s.raw = o;  // int8 or f32 pools only: K and V raw tiles, two buffers
  if (raw) o += 2 * 2 * (size_t)kVTile * raw_row_bytes(hd, pool);
  s.scale = o;  // int8 only: K and V scales, two buffers
  if (quant) o += 2 * 2 * (size_t)kVTile * 4;
  s.row_off = o;  // per logical row of the split: pool row, or -1
  o += rows * 4;
  s.row_mask = o;  // per logical row: bit w set if query w reads it
  o += rows * 2;
  o = (o + 3) / 4 * 4;
  s.live = o;  // per tile: 1 if a row of it is read
  o += rows / kVTile * 4;
  s.list = o;  // the live tiles, in order
  o += rows / kVTile * 4;
  s.total = o;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `full` false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat162 p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}

// an f32 pair (x in the low half) as two bf16 pairs whose sum is within
// 2^-16 of it: hi rounds the pair, lo rounds the remainder
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pair_bits(h);
  lo = pair_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of k-step kk (columns 16kk..16kk+15) of a
// [16, 8n] accumulator tile c: the m16n8 accumulator layout of n-tiles
// 2kk and 2kk+1 is the m16k16 A layout.
__device__ __forceinline__ void acc_to_a(float (*c)[4], int kk, uint32_t* hi,
                                         uint32_t* lo) {
  split_pair(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_pair(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_pair(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_pair(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// 8 f32 values (32 bytes of shared memory, 16-byte aligned) rounded to bf16
// to nearest even, as `.to(torch.bfloat16)`, into 16 bytes of a bf16 tile
__device__ __forceinline__ void round8(const int8_t* src, bf16* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 16);
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      pair_bits(__floats2bfloat162_rn(a.x, a.y)), pair_bits(__floats2bfloat162_rn(a.z, a.w)),
      pair_bits(__floats2bfloat162_rn(b.x, b.y)), pair_bits(__floats2bfloat162_rn(b.z, b.w)));
}

// One split of one (slot, kv head). Warp i owns query rows 16i..16i+15;
// thread (g, t4) = (lane / 4, lane % 4) holds rows g and g + 8 of those
// and, in each 8-column n-tile, columns 2 t4 and 2 t4 + 1 (K1's layout).
template <typename PoolT, int HD>
__device__ __forceinline__ void verify_mma_body(const VerifyArgs& a) {
  constexpr bool kQuant = std::is_same<PoolT, int8_t>::value;  // scales
  constexpr bool kRaw = !std::is_same<PoolT, bf16>::value;     // staged, then converted
  constexpr int LD = HD + kVRowPad;
  constexpr int LDR = HD * sizeof(PoolT) + kVRawPad;  // bytes per shared raw row
  constexpr int kTE = kVTile * LD;    // elements of one bf16 tile
  constexpr int KK = HD / 16;         // k-steps of S = Q K^T
  constexpr int NO = HD / 8;          // n-tiles of O
  constexpr int kElems = 16 / sizeof(PoolT);  // pool elements per 16-byte copy
  constexpr int CH = HD / kElems;             // 16-byte copies per pool row
  const int split = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int W = a.W, group = a.group, M = W * group, nH = a.nKV * group;
  const int span = a.nb * a.bsz;
  const int start = split * a.pps * a.bsz;  // the split's first logical row
  const int rows = min(a.pps * a.bsz, span - start);
  const int ntiles = (rows + kVTile - 1) / kVTile;

  extern __shared__ __align__(16) unsigned char smem_v[];
  const VerifySmem lay = verify_smem(M, HD, a.bsz, a.pps, pool_code<PoolT>());
  bf16* q_s = reinterpret_cast<bf16*>(smem_v + lay.q);
  bf16* kv_s = reinterpret_cast<bf16*>(smem_v + lay.kv);
  int8_t* raw_s = reinterpret_cast<int8_t*>(smem_v + lay.raw);
  float* sc_s = reinterpret_cast<float*>(smem_v + lay.scale);
  int* off_s = reinterpret_cast<int*>(smem_v + lay.row_off);
  uint16_t* mask_s = reinterpret_cast<uint16_t*>(smem_v + lay.row_mask);
  int* live_s = reinterpret_cast<int*>(smem_v + lay.live);
  int* list_s = reinterpret_cast<int*>(smem_v + lay.list);
  __shared__ int n_live_s;

  // the split's mask bytes, read once: per logical row, which queries read
  // it and, if any does, its pool row (the block id checked here)
  for (int i = tid; i < ntiles; i += nthr) live_s[i] = 0;
  __syncthreads();
  const uint8_t* valid_r = a.valid + (size_t)r * W * span + start;
  const int32_t* table_r = a.table + (size_t)r * a.nb;
  for (int x = tid; x < ntiles * kVTile; x += nthr) {  // warp-uniform trip count
    unsigned qmask = 0;
    int off = -1;
    if (x < rows) {
      const int t = start + x;
      const int page = t / a.bsz;
      const int blk = table_r[page];
      for (int w = 0; w < W; ++w) qmask |= (unsigned)(valid_r[(size_t)w * span + x] != 0) << w;
      if (qmask) {
        // a page with a row valid for some query must name a pool block
        if (blk < 0 || blk >= a.n_blocks) __trap();
        off = blk * a.bsz + (t - page * a.bsz);
      }
    }
    off_s[x] = off;
    mask_s[x] = static_cast<uint16_t>(qmask);
    if (__ballot_sync(kFull, qmask != 0) && lane == 0) live_s[x / kVTile] = 1;
  }
  __syncthreads();
  if (warp == 0) {  // the live tiles, in order
    int cnt = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool f = i < ntiles && live_s[i];
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) list_s[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
      cnt += __popc(bal);
    }
    if (lane == 0) n_live_s = cnt;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const size_t part = (((size_t)r * a.nKV + h) * a.n_splits + split) * M;  // row 0's partials
  bf16* out_r = a.out + (size_t)r * W * nH * HD;

  if (n_live == 0) {  // no row of this split is read by any query
    if (a.n_splits == 1) {
      for (int i = tid; i < M * HD; i += nthr) {
        const int m = i / HD, w = m / group;
        out_r[((size_t)w * nH + h * group + m - w * group) * HD + i % HD] = __float2bfloat16_rn(0.f);
      }
    } else {
      for (int m = tid; m < M; m += nthr) {
        a.part_m[part + m] = kNegInf;
        a.part_l[part + m] = 0.f;
      }
    }
    return;
  }

  // the query rows (padding rows zero), then the first live tile
  const bf16* q_r = a.q + (size_t)r * W * nH * HD;
  const int m_pad = nthr / 32 * 16;
  for (int c = tid; c < m_pad * (HD / 8); c += nthr) {
    const int m = c / (HD / 8), ch = c % (HD / 8);
    const bool ok = m < M;
    const int w = ok ? m / group : 0;
    cp_async16(q_s + m * LD + ch * 8,
               ok ? q_r + ((size_t)w * nH + h * group + m - w * group) * HD + ch * 8 : q_r, ok);
  }
  cp_async_commit();

  const PoolT* k_pool = static_cast<const PoolT*>(a.k_pool);
  const PoolT* v_pool = static_cast<const PoolT*>(a.v_pool);
  // live tile i's K and V rows (and int8 scales) into buffer i & 1
  auto issue = [&](int i) {
    const int x0 = list_s[i] * kVTile;
    const int b = i & 1;
    for (int c = tid; c < 2 * kVTile * CH; c += nthr) {
      const int which = c / (kVTile * CH);  // 0: K, 1: V
      const int row = (c / CH) % kVTile, ch = c % CH;
      const int off = off_s[x0 + row];
      const PoolT* pool = which ? v_pool : k_pool;
      const PoolT* src = pool + ((size_t)(off < 0 ? 0 : off) * a.nKV + h) * HD + ch * kElems;
      void* dst;
      if constexpr (kRaw)
        dst = raw_s + ((b * 2 + which) * kVTile + row) * LDR + ch * 16;
      else
        dst = kv_s + (b * 2 + which) * kTE + row * LD + ch * 8;
      cp_async16(dst, src, off >= 0);
    }
    if constexpr (kQuant) {
      for (int c = tid; c < 2 * kVTile; c += nthr) {
        const int which = c / kVTile, row = c % kVTile;
        const int off = off_s[x0 + row];
        const int blk = off < 0 ? 0 : off / a.bsz;
        const int j = off < 0 ? 0 : off - blk * a.bsz;
        const float* sc = which ? a.v_scale : a.k_scale;
        cp_async4(sc_s + (b * 2 + which) * kVTile + row, sc + ((size_t)blk * a.nKV + h) * a.bsz + j,
                  off >= 0);
      }
    }
    cp_async_commit();
  };
  issue(0);

  int wrow[2];  // the query position of this thread's rows; -1 for padding
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int m = warp * 16 + g + 8 * ri;
    wrow[ri] = m < M ? m / group : -1;
  }
  // the warp's Q rows as A fragments are re-read from q_s for every tile:
  // holding them would take HD / 4 registers more
  const bf16* qa_row = q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = a.sm_scale * kLog2e;  // scores in log2 units

  for (int i = 0; i < n_live; ++i) {
    if (i + 1 < n_live) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int x0 = list_s[i] * kVTile;
    const bf16* ks = kv_s;
    if constexpr (kRaw && !kQuant) {
      // the f32 tiles rounded to bf16 to nearest even, as .to(torch.bfloat16)
      const int8_t* src = raw_s + (i & 1) * 2 * kVTile * LDR;
      for (int c = tid; c < 2 * kVTile * (HD / 8); c += nthr) {
        const int rr = c / (HD / 8), ch = c % (HD / 8);  // rr: K rows, then V rows
        round8(src + rr * LDR + ch * 32, kv_s + (rr / kVTile) * kTE + (rr % kVTile) * LD + ch * 8);
      }
      __syncthreads();
    } else if constexpr (kQuant) {
      // the int8 tiles widened to bf16, unscaled (|x| <= 127 is exact)
      const int8_t* src = raw_s + (i & 1) * 2 * kVTile * LDR;
      for (int c = tid; c < 2 * kVTile * (HD / 16); c += nthr) {
        const int rr = c / (HD / 16), ch = c % (HD / 16);  // rr: K rows, then V rows
        const int4 v = *reinterpret_cast<const int4*>(src + rr * LDR + ch * 16);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&v);
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = pair_bits(__floats2bfloat162_rn(static_cast<float>(e8[2 * k]),
                                                 static_cast<float>(e8[2 * k + 1])));
        bf16* dst = kv_s + (rr / kVTile) * kTE + (rr % kVTile) * LD + ch * 16;
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncthreads();
    } else {
      ks = kv_s + (i & 1) * 2 * kTE;
    }
    const bf16* vs = ks + kTE;
    const float* ksc = sc_s + (i & 1) * 2 * kVTile;  // int8 only
    const float* vsc = ksc + kVTile;

    // S = Q K^T: [16 rows, 64 keys] per warp, 8 n-tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qa_row + kk * 16);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks + (np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                       ((lane / 8) % 2) * 8);
        mma16816(s[2 * np], qa, b[0], b[1]);
        mma16816(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    // scale (K5b: the column's K scale), mask per query, online softmax in
    // log2 units; a row's max and sum over its quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1), ri = e >> 1;
        const unsigned cm = mask_s[x0 + c];
        const bool ok = wrow[ri] >= 0 && ((cm >> wrow[ri]) & 1u);
        const float f = kQuant ? ksc[c] * scale2 : scale2;
        s[j][e] = ok ? s[j][e] * f : kNegInf;
        mx[ri] = fmaxf(mx[ri], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(kFull, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(kFull, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      alpha[ri] = exp2f(m[ri] - m_new);
      m[ri] = m_new;
      l[ri] *= alpha[ri];  // this thread's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const float p = m[ri] > kNegInf * 0.5f ? exp2f(s[j][e] - m[ri]) : 0.f;
        l[ri] += p;
        // K5b: the column's V scale, in f32 before the hi/lo split
        s[j][e] = kQuant ? p * vsc[j * 8 + 2 * t4 + (e & 1)] : p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += P V by 16-key stages, P as hi + lo A fragments from registers,
    // each stage's product summed from zero and added rounding to nearest
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      acc_to_a(s, kk, ph, pl);
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + np * 16 +
                         (lane / 16) * 8);
        mma16816(t0, pl, b[0], b[1]);
        mma16816(t0, ph, b[0], b[1]);
        mma16816(t1, pl, b[2], b[3]);
        mma16816(t1, ph, b[2], b[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[2 * np][e] += t0[e];
          acc[2 * np + 1][e] += t1[e];
        }
      }
    }
    __syncthreads();  // the next iteration refills the buffers read here
  }

#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(kFull, l[ri], 1);
    l[ri] += __shfl_xor_sync(kFull, l[ri], 2);
    const int row = warp * 16 + g + 8 * ri;
    if (row >= M) continue;
    if (a.n_splits == 1) {  // the whole table: the output itself
      const int w = row / group;
      const float safe_l = l[ri] > 0.f ? l[ri] : 1.f;
      bf16* o = out_r + ((size_t)w * nH + h * group + row - w * group) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(o + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * ri] / safe_l, acc[n][2 * ri + 1] / safe_l);
    } else {
      if (t4 == 0) {
        a.part_m[part + row] = m[ri];
        a.part_l[part + row] = l[ri];
      }
      float* pa = a.part_acc + (part + row) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(pa + n * 8) = make_float2(acc[n][2 * ri], acc[n][2 * ri + 1]);
    }
  }
}

// The combine pass: grid (W, nKV, R), one block per (query position, kv
// head, slot) over its group rows. The splits are read in split order, so
// the output does not depend on which block finished first.
template <int HD>
__device__ __forceinline__ void verify_combine_body(const VerifyArgs& a) {
  const int w = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int group = a.group, M = a.W * group, S = a.n_splits, nH = a.nKV * group;
  const size_t base = ((size_t)r * a.nKV + h) * S * M + (size_t)w * group;  // split 0, row (w, 0)
  __shared__ float mx_s[kMaxGroup], den_s[kMaxGroup];
  const int tid = threadIdx.x;
  if (tid < group) {
    float mx = kNegInf, den = 0.f;
    for (int s = 0; s < S; ++s)
      if (a.part_l[base + (size_t)s * M + tid] > 0.f) mx = fmaxf(mx, a.part_m[base + (size_t)s * M + tid]);
    for (int s = 0; s < S; ++s) {
      const float ls = a.part_l[base + (size_t)s * M + tid];
      if (ls > 0.f) den += exp2f(a.part_m[base + (size_t)s * M + tid] - mx) * ls;
    }
    mx_s[tid] = mx;
    den_s[tid] = den > 0.f ? den : 1.f;
  }
  __syncthreads();
  bf16* out = a.out + (((size_t)r * a.W + w) * nH + (size_t)h * group) * HD;
  for (int i = tid; i < group * HD / 4; i += blockDim.x) {
    const int gg = i / (HD / 4), c4 = i % (HD / 4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < S; ++s) {
      const size_t row = base + (size_t)s * M + gg;
      if (a.part_l[row] > 0.f) {  // acc of a split with no row read is never written
        const float c = exp2f(a.part_m[row] - mx_s[gg]);
        const float4 v = *reinterpret_cast<const float4*>(a.part_acc + row * HD + c4 * 4);
        o.x += c * v.x;
        o.y += c * v.y;
        o.z += c * v.z;
        o.w += c * v.w;
      }
    }
    const float d = den_s[gg];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out + (size_t)gg * HD + c4 * 4);
    dst[0] = __floats2bfloat162_rn(o.x / d, o.y / d);
    dst[1] = __floats2bfloat162_rn(o.z / d, o.w / d);
  }
}

// K4: a bf16 pool
template <int HD>
__global__ void __launch_bounds__(kVMaxThreads) paged_verify_mma_kernel(VerifyArgs a) {
  verify_mma_body<bf16, HD>(a);
}

// K4 over an f32 pool: its rows staged raw, then rounded to bf16
template <int HD>
__global__ void __launch_bounds__(kVMaxThreads) paged_verify_f32pool_mma_kernel(VerifyArgs a) {
  verify_mma_body<float, HD>(a);
}

// K5b: an int8 pool with per-(row, kv head) f32 scales
template <int HD>
__global__ void __launch_bounds__(kVMaxThreads) paged_verify_q8_mma_kernel(VerifyArgs a) {
  verify_mma_body<int8_t, HD>(a);
}

// their combine passes (one body; two names, so a profile files each under
// its kernel; an f32 pool's split kernel shares the bf16 pool's combine)
template <int HD>
__global__ void __launch_bounds__(kCombineThreads) paged_verify_combine_kernel(VerifyArgs a) {
  verify_combine_body<HD>(a);
}

template <int HD>
__global__ void __launch_bounds__(kCombineThreads) paged_verify_q8_combine_kernel(VerifyArgs a) {
  verify_combine_body<HD>(a);
}

// ===========================================================================
// K3 and K5a, bf16 q: split-KV over pages on the tensor cores, warps over keys
// ===========================================================================

constexpr int kDecodeWarps = 4;  // warp i takes rows 16i..16i+15 of every 64-row tile
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kQuarter = kVTile / kDecodeWarps;

// Byte offsets of one decode block's dynamic shared memory, as the launch
// sizes it. After the tiles, the warps' merge reuses the memory from `kv`.
struct DecodeSmem {
  size_t kv, raw, scale, row_off, live, list, total;
};

__host__ __device__ inline DecodeSmem decode_smem(int hd, int bsz, int pps, int pool) {
  const bool raw = pool != kPoolBF16, quant = pool == kPoolI8;
  const size_t ld = (size_t)hd + kVRowPad;
  const size_t rows = (size_t)(pps * bsz + kVTile - 1) / kVTile * kVTile;
  DecodeSmem s;
  size_t o = 0;
  s.kv = o;  // per warp: its K and V bf16 quarters, two buffers (raw pools: one, converted there)
  o += (size_t)kDecodeWarps * (raw ? 1 : 2) * 2 * kQuarter * ld * 2;
  s.raw = o;  // int8 or f32 pools only: per warp, its K and V raw quarters, two buffers
  if (raw) o += (size_t)kDecodeWarps * 2 * 2 * kQuarter * raw_row_bytes(hd, pool);
  s.scale = o;  // int8 only: per warp, its K and V scales, two buffers
  if (quant) o += (size_t)kDecodeWarps * 2 * 2 * kQuarter * 4;
  s.row_off = o;  // per logical row of the split: pool row, or -1 if not valid
  o += rows * 4;
  s.live = o;  // per tile: 1 if a row of it is valid
  o += rows / kVTile * 4;
  s.list = o;  // the live tiles, in order
  o += rows / kVTile * 4;
  // the merge: per warp and query row, acc [HD] then m and l, all f32
  const size_t merge = s.kv + (size_t)kDecodeWarps * 16 * (hd + 2) * 4;
  s.total = o > merge ? o : merge;
  return s;
}

// One split of one (slot, kv head) for the single query token of each
// slot: the group's rows (M = group <= 16) are one m16 A tile, read from
// global memory straight into registers. Warp i takes the 16-row quarter
// i of each live 64-row tile: it copies its own quarter (double-buffered
// cp.async, only __syncwarp between its steps), computes S = Q K^T for its
// 16 keys and one 16-key P V stage, and keeps its own (m, l, acc). At the
// split's end the warps' states are merged in warp order with the
// combine's formula. Thread (g, t4) = (lane / 4, lane % 4) holds query
// rows g and g + 8 (K1's layout).
template <typename PoolT, int HD>
__device__ __forceinline__ void decode_mma_body(const VerifyArgs& a) {
  constexpr bool kQuant = std::is_same<PoolT, int8_t>::value;  // scales
  constexpr bool kRaw = !std::is_same<PoolT, bf16>::value;     // staged, then converted
  constexpr int LD = HD + kVRowPad;
  constexpr int LDR = HD * sizeof(PoolT) + kVRawPad;  // bytes per shared raw row
  constexpr int kQE = kQuarter * LD;   // elements of one bf16 quarter
  constexpr int KK = HD / 16;          // k-steps of S = Q K^T
  constexpr int NO = HD / 8;           // n-tiles of O
  constexpr int kElems = 16 / sizeof(PoolT);  // pool elements per 16-byte copy
  constexpr int CH = HD / kElems;             // 16-byte copies per pool row
  const int split = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int group = a.group, nH = a.nKV * group;
  const int span = a.nb * a.bsz;
  const int start = split * a.pps * a.bsz;  // the split's first logical row
  const int rows = min(a.pps * a.bsz, span - start);
  const int ntiles = (rows + kVTile - 1) / kVTile;

  // the query rows as A fragments (rows past the group zero), in flight
  // during the mask scan: thread (g, t4) holds rows g and g + 8, columns
  // 2 t4 and 2 t4 + 1 of each 8-column half of every 16-column k-step
  uint32_t qa[KK][4];
  {
    const uint32_t* q32 =
        reinterpret_cast<const uint32_t*>(a.q + ((size_t)r * nH + (size_t)h * group) * HD);
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e & 1), col = kk * 16 + 8 * (e >> 1) + 2 * t4;
        qa[kk][e] = row < group ? q32[(row * HD + col) / 2] : 0u;
      }
  }

  extern __shared__ __align__(16) unsigned char smem_v[];
  const DecodeSmem lay = decode_smem(HD, a.bsz, a.pps, pool_code<PoolT>());
  bf16* kv_s = reinterpret_cast<bf16*>(smem_v + lay.kv) + warp * (kRaw ? 1 : 2) * 2 * kQE;
  int8_t* raw_s = reinterpret_cast<int8_t*>(smem_v + lay.raw) + warp * 2 * 2 * kQuarter * LDR;
  float* sc_s = reinterpret_cast<float*>(smem_v + lay.scale) + warp * 2 * 2 * kQuarter;
  int* off_s = reinterpret_cast<int*>(smem_v + lay.row_off);
  int* live_s = reinterpret_cast<int*>(smem_v + lay.live);
  int* list_s = reinterpret_cast<int*>(smem_v + lay.list);
  __shared__ int n_live_s;
  __shared__ float wt_s[kDecodeWarps][16], den_s[16], mx_s[16];

  // the split's mask bytes, read once: per logical row, its pool row if it
  // is valid (the block id checked here), else -1
  for (int i = tid; i < ntiles; i += kDecodeThreads) live_s[i] = 0;
  __syncthreads();
  const uint8_t* valid_r = a.valid + (size_t)r * span + start;
  const int32_t* table_r = a.table + (size_t)r * a.nb;
  for (int x = tid; x < ntiles * kVTile; x += kDecodeThreads) {  // warp-uniform trip count
    int off = -1;
    if (x < rows && valid_r[x]) {
      const int t = start + x;
      const int page = t / a.bsz;
      const int blk = table_r[page];
      // a page with a valid row must name a pool block
      if (blk < 0 || blk >= a.n_blocks) __trap();
      off = blk * a.bsz + (t - page * a.bsz);
    }
    off_s[x] = off;
    if (__ballot_sync(kFull, off >= 0) && lane == 0) live_s[x / kVTile] = 1;
  }
  __syncthreads();
  if (warp == 0) {  // the live tiles, in order
    int cnt = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const int i = base + lane;
      const bool f = i < ntiles && live_s[i];
      const unsigned bal = __ballot_sync(kFull, f);
      if (f) list_s[cnt + __popc(bal & ((1u << lane) - 1u))] = i;
      cnt += __popc(bal);
    }
    if (lane == 0) n_live_s = cnt;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const size_t part = (((size_t)r * a.nKV + h) * a.n_splits + split) * group;  // row 0's partials
  // W = 1: the group's query rows of (slot r, kv head h) are contiguous
  bf16* out_r = a.out + ((size_t)r * nH + (size_t)h * group) * HD;

  if (n_live == 0) {  // no valid row in this split
    if (a.n_splits == 1) {
      for (int i = tid; i < group * HD; i += kDecodeThreads) out_r[i] = __float2bfloat16_rn(0.f);
    } else {
      for (int m = tid; m < group; m += kDecodeThreads) {
        a.part_m[part + m] = kNegInf;
        a.part_l[part + m] = 0.f;
      }
    }
    return;
  }

  const PoolT* k_pool = static_cast<const PoolT*>(a.k_pool);
  const PoolT* v_pool = static_cast<const PoolT*>(a.v_pool);
  // this warp's quarter of live tile i (K and V rows, int8 scales) into
  // its buffer i & 1
  auto issue = [&](int i) {
    const int x0 = list_s[i] * kVTile + warp * kQuarter;
    const int b = i & 1;
    for (int c = lane; c < 2 * kQuarter * CH; c += 32) {
      const int which = c / (kQuarter * CH);  // 0: K, 1: V
      const int row = (c / CH) % kQuarter, ch = c % CH;
      const int off = off_s[x0 + row];
      const PoolT* pool = which ? v_pool : k_pool;
      const PoolT* src = pool + ((size_t)(off < 0 ? 0 : off) * a.nKV + h) * HD + ch * kElems;
      void* dst;
      if constexpr (kRaw)
        dst = raw_s + ((b * 2 + which) * kQuarter + row) * LDR + ch * 16;
      else
        dst = kv_s + (b * 2 + which) * kQE + row * LD + ch * 8;
      cp_async16(dst, src, off >= 0);
    }
    if constexpr (kQuant) {  // 32 lanes: 16 K scales, then 16 V scales
      const int which = lane / kQuarter, row = lane % kQuarter;
      const int off = off_s[x0 + row];
      const int blk = off < 0 ? 0 : off / a.bsz;
      const int j = off < 0 ? 0 : off - blk * a.bsz;
      const float* sc = which ? a.v_scale : a.k_scale;
      cp_async4(sc_s + (b * 2 + which) * kQuarter + row, sc + ((size_t)blk * a.nKV + h) * a.bsz + j,
                off >= 0);
    }
    cp_async_commit();
  };
  issue(0);

  float acc[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float scale2 = a.sm_scale * kLog2e;  // scores in log2 units

  for (int i = 0; i < n_live; ++i) {
    if (i + 1 < n_live) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int x0 = list_s[i] * kVTile + warp * kQuarter;
    const bf16* ks = kv_s;
    if constexpr (kRaw && !kQuant) {
      // the f32 quarters rounded to bf16 to nearest even, as .to(torch.bfloat16)
      const int8_t* src = raw_s + (i & 1) * 2 * kQuarter * LDR;
      for (int c = lane; c < 2 * kQuarter * (HD / 8); c += 32) {
        const int rr = c / (HD / 8), ch = c % (HD / 8);  // rr: K rows, then V rows
        round8(src + rr * LDR + ch * 32, kv_s + (rr / kQuarter) * kQE + (rr % kQuarter) * LD + ch * 8);
      }
      __syncwarp();
    } else if constexpr (kQuant) {
      // the int8 quarters widened to bf16, unscaled (|x| <= 127 is exact)
      const int8_t* src = raw_s + (i & 1) * 2 * kQuarter * LDR;
      for (int c = lane; c < 2 * kQuarter * (HD / 16); c += 32) {
        const int rr = c / (HD / 16), ch = c % (HD / 16);  // rr: K rows, then V rows
        const int4 v = *reinterpret_cast<const int4*>(src + rr * LDR + ch * 16);
        const int8_t* e8 = reinterpret_cast<const int8_t*>(&v);
        uint32_t o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          o[k] = pair_bits(__floats2bfloat162_rn(static_cast<float>(e8[2 * k]),
                                                 static_cast<float>(e8[2 * k + 1])));
        bf16* dst = kv_s + (rr / kQuarter) * kQE + (rr % kQuarter) * LD + ch * 16;
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
      }
      __syncwarp();
    } else {
      ks = kv_s + (i & 1) * 2 * kQE;
    }
    const bf16* vs = ks + kQE;
    const float* ksc = sc_s + (i & 1) * 2 * kQuarter;  // int8 only
    const float* vsc = ksc + kQuarter;

    // S = Q K^T: [16 rows, 16 keys], 2 n-tiles
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, ks + ((lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8);
      mma16816(s[0], qa[kk], b[0], b[1]);
      mma16816(s[1], qa[kk], b[2], b[3]);
    }

    // scale (K5a: the column's K scale), mask, online softmax in log2
    // units; a row's max and sum over its quad. Padding rows (>= group)
    // are computed and never written.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1);
        const float f = kQuant ? ksc[c] * scale2 : scale2;
        s[j][e] = off_s[x0 + c] >= 0 ? s[j][e] * f : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(kFull, mx[ri], 1));
      mx[ri] = fmaxf(mx[ri], __shfl_xor_sync(kFull, mx[ri], 2));
      const float m_new = fmaxf(m[ri], mx[ri]);
      alpha[ri] = exp2f(m[ri] - m_new);
      m[ri] = m_new;
      l[ri] *= alpha[ri];  // this thread's share of the row sum
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const float p = m[ri] > kNegInf * 0.5f ? exp2f(s[j][e] - m[ri]) : 0.f;
        l[ri] += p;
        // K5a: the column's V scale, in f32 before the hi/lo split
        s[j][e] = kQuant ? p * vsc[j * 8 + 2 * t4 + (e & 1)] : p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // acc += P V, one 16-key stage: P as hi + lo A fragments from
    // registers, the stage's product summed from zero and added rounding
    // to nearest
    uint32_t ph[4], pl[4];
    acc_to_a(s, 0, ph, pl);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
      uint32_t b[4];
      ldsm_x4_t(b, vs + (lane % 8 + ((lane / 8) % 2) * 8) * LD + np * 16 + (lane / 16) * 8);
      mma16816(t0, pl, b[0], b[1]);
      mma16816(t0, ph, b[0], b[1]);
      mma16816(t1, pl, b[2], b[3]);
      mma16816(t1, ph, b[2], b[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] += t0[e];
        acc[2 * np + 1][e] += t1[e];
      }
    }
    __syncwarp();  // the next step refills the buffers read here
  }

  // the warps' (m, l, acc) through shared memory (over the tile buffers,
  // once every warp is done with them), merged in warp order
  __syncthreads();
  float* mg_acc = reinterpret_cast<float*>(smem_v + lay.kv);  // [warp][16][HD]
  float* mg_m = mg_acc + kDecodeWarps * 16 * HD;              // [warp][16]
  float* mg_l = mg_m + kDecodeWarps * 16;                     // [warp][16]
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(kFull, l[ri], 1);
    l[ri] += __shfl_xor_sync(kFull, l[ri], 2);
    const int row = g + 8 * ri;
    if (row >= group) continue;
    if (t4 == 0) {
      mg_m[warp * 16 + row] = m[ri];
      mg_l[warp * 16 + row] = l[ri];
    }
    float* pa = mg_acc + (warp * 16 + row) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(pa + n * 8) = make_float2(acc[n][2 * ri], acc[n][2 * ri + 1]);
  }
  __syncthreads();
  if (tid < group) {  // the combine's formula over the warps with l > 0
    float mx = kNegInf, den = 0.f;
    for (int w = 0; w < kDecodeWarps; ++w)
      if (mg_l[w * 16 + tid] > 0.f) mx = fmaxf(mx, mg_m[w * 16 + tid]);
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float lw = mg_l[w * 16 + tid];
      const float c = lw > 0.f ? exp2f(mg_m[w * 16 + tid] - mx) : 0.f;
      wt_s[w][tid] = c;
      den += c * lw;
    }
    mx_s[tid] = mx;
    den_s[tid] = den;
  }
  __syncthreads();
  for (int i = tid; i < group * HD / 4; i += kDecodeThreads) {
    const int row = i / (HD / 4), c4 = i % (HD / 4);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = wt_s[w][row];
      if (c > 0.f) {
        const float4 v = *reinterpret_cast<const float4*>(mg_acc + (w * 16 + row) * HD + c4 * 4);
        o.x += c * v.x;
        o.y += c * v.y;
        o.z += c * v.z;
        o.w += c * v.w;
      }
    }
    if (a.n_splits == 1) {  // the whole table: the output itself
      const float d = den_s[row] > 0.f ? den_s[row] : 1.f;
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out_r + (size_t)row * HD + c4 * 4);
      dst[0] = __floats2bfloat162_rn(o.x / d, o.y / d);
      dst[1] = __floats2bfloat162_rn(o.z / d, o.w / d);
    } else {
      *reinterpret_cast<float4*>(a.part_acc + (part + row) * HD + c4 * 4) = o;
    }
  }
  if (a.n_splits > 1 && tid < group) {
    a.part_m[part + tid] = den_s[tid] > 0.f ? mx_s[tid] : kNegInf;
    a.part_l[part + tid] = den_s[tid];
  }
}

// K3: a bf16 pool
template <int HD>
__global__ void __launch_bounds__(kDecodeThreads) paged_attn_mma_kernel(VerifyArgs a) {
  decode_mma_body<bf16, HD>(a);
}

// K3 over an f32 pool: its rows staged raw, then rounded to bf16
template <int HD>
__global__ void __launch_bounds__(kDecodeThreads) paged_attn_f32pool_mma_kernel(VerifyArgs a) {
  decode_mma_body<float, HD>(a);
}

// K5a: an int8 pool with per-(row, kv head) f32 scales
template <int HD>
__global__ void __launch_bounds__(kDecodeThreads) paged_attn_q8_mma_kernel(VerifyArgs a) {
  decode_mma_body<int8_t, HD>(a);
}

// their combine passes: the verify combine at W = 1, under K3's and K5a's
// names so a profile files each under its kernel (an f32 pool's with K3's)
template <int HD>
__global__ void __launch_bounds__(kCombineThreads) paged_attn_combine_kernel(VerifyArgs a) {
  verify_combine_body<HD>(a);
}

template <int HD>
__global__ void __launch_bounds__(kCombineThreads) paged_attn_q8_combine_kernel(VerifyArgs a) {
  verify_combine_body<HD>(a);
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

// K3 / K5a, f32 q: the first version
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
          paged_attn_kernel<T, P, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_attn_kernel<T, P, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
        static_cast<const P*>(a.v_pool), static_cast<const int32_t*>(a.table),
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
          paged_verify_kernel<T, P, HD>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    paged_verify_kernel<T, P, HD><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const P*>(a.k_pool),
        static_cast<const P*>(a.v_pool), static_cast<const int32_t*>(a.table),
        static_cast<const uint8_t*>(a.valid), static_cast<T*>(a.out), a.W,
        a.nKV, a.group, a.bsz, a.nb, a.n_blocks, a.sm_scale);
  }
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, P, 16>(a, stream);
    case 32:
      return launch<T, P, 32>(a, stream);
    case 64:
      return launch<T, P, 64>(a, stream);
    case 128:
      return launch<T, P, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K4 / K5b, f32 q: the first version
template <typename P>
cudaError_t dispatch_verify_f32(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_verify<float, P, 16>(a, stream);
    case 32:
      return launch_verify<float, P, 32>(a, stream);
    case 64:
      return launch_verify<float, P, 64>(a, stream);
    case 128:
      return launch_verify<float, P, 128>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K4 / K5b (bf16 q): the split kernel, then (with more than one split) the
// combine pass, both on `stream`
template <typename P, int HD>
cudaError_t launch_verify_mma(const VerifyArgs& a, cudaStream_t stream) {
  constexpr int kPool = pool_code<P>();
  const int M = a.W * a.group;
  const size_t smem = verify_smem(M, HD, a.bsz, a.pps, kPool).total;
  const auto kernel = kPool == kPoolI8    ? paged_verify_q8_mma_kernel<HD>
                      : kPool == kPoolF32 ? paged_verify_f32pool_mma_kernel<HD>
                                          : paged_verify_mma_kernel<HD>;
  static size_t opted_in = 48 * 1024;  // the dynamic shared memory this kernel may take
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  kernel<<<dim3(a.n_splits, a.nKV, a.R), 32 * ((M + 15) / 16), smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return e;
  const auto combine =
      kPool == kPoolI8 ? paged_verify_q8_combine_kernel<HD> : paged_verify_combine_kernel<HD>;
  combine<<<dim3(a.W, a.nKV, a.R), kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// K3 / K5a (bf16 q): the same two launches for one query per slot
template <typename P, int HD>
cudaError_t launch_decode_mma(const VerifyArgs& a, cudaStream_t stream) {
  constexpr int kPool = pool_code<P>();
  const size_t smem = decode_smem(HD, a.bsz, a.pps, kPool).total;
  const auto kernel = kPool == kPoolI8    ? paged_attn_q8_mma_kernel<HD>
                      : kPool == kPoolF32 ? paged_attn_f32pool_mma_kernel<HD>
                                          : paged_attn_mma_kernel<HD>;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  kernel<<<dim3(a.n_splits, a.nKV, a.R), kDecodeThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_splits == 1) return e;
  const auto combine =
      kPool == kPoolI8 ? paged_attn_q8_combine_kernel<HD> : paged_attn_combine_kernel<HD>;
  combine<<<dim3(1, a.nKV, a.R), kCombineThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename P, bool kDecode, int HD>
cudaError_t launch_mma(const VerifyArgs& a, cudaStream_t stream) {
  return kDecode ? launch_decode_mma<P, HD>(a, stream) : launch_verify_mma<P, HD>(a, stream);
}

template <typename P, bool kDecode>
cudaError_t dispatch_mma(int hd, const VerifyArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch_mma<P, kDecode, 16>(a, stream);
    case 32:
      return launch_mma<P, kDecode, 32>(a, stream);
    case 64:
      return launch_mma<P, kDecode, 64>(a, stream);
    case 128:
      return launch_mma<P, kDecode, 128>(a, stream);
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

// Route a call by q's dtype, over a pool of element type P (float, bf16 or
// int8_t): f32 q to the first version (K3/K5a with a.W 0, else K4/K5b), bf16
// q to the split kernels and their combine. `scratch` holds the splits'
// partials ((hd + 2) floats per query row per split), unused with one split
// or f32 q.
template <typename P>
int paged_route(const Args& a, int hd, int is_bf16, float* scratch, int pages_per_split,
                cudaStream_t stream) {
  const bool decode = a.W == 0;
  if (!is_bf16)
    return decode ? dispatch_hd<float, P>(hd, a, stream) : dispatch_verify_f32<P>(hd, a, stream);
  if (pages_per_split < 1 || (size_t)pages_per_split * a.bsz > kVMaxSplitRows)
    return cudaErrorInvalidValue;
  const int W = decode ? 1 : a.W;
  const int n_splits = (a.nb + pages_per_split - 1) / pages_per_split;
  const size_t rows = (size_t)a.R * a.nKV * n_splits * W * a.group;  // partial rows
  if (n_splits > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  VerifyArgs v{static_cast<const bf16*>(a.q), a.k_pool, static_cast<const float*>(a.k_scale),
               a.v_pool, static_cast<const float*>(a.v_scale),
               static_cast<const int32_t*>(a.table), static_cast<const uint8_t*>(a.valid),
               // acc first: its float4 rows stay 16-byte aligned
               scratch + rows * hd, scratch + rows * hd + rows, scratch,
               static_cast<bf16*>(a.out), a.R, W, a.nKV, a.group, a.bsz, a.nb,
               a.n_blocks, pages_per_split, n_splits, a.sm_scale};
  return decode ? dispatch_mma<P, true>(hd, v, stream) : dispatch_mma<P, false>(hd, v, stream);
}

// An fp pool's route by its element type (kPoolF32 or kPoolBF16).
int fp_route(const Args& a, int hd, int is_bf16, int pool, float* scratch, int pages_per_split,
             cudaStream_t stream) {
  if (pool == kPoolF32)
    return paged_route<float>(a, hd, is_bf16, scratch, pages_per_split, stream);
  if (pool == kPoolBF16)
    return paged_route<bf16>(a, hd, is_bf16, scratch, pages_per_split, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Every pointer is a device pointer of a
// contiguous tensor; `stream` is the caller's cudaStream_t. Each returns the
// launch's cudaGetLastError() (0 on success); the wrapper raises on
// anything else. R and nb must be at least 1: with no row to attend the
// output is 0, which the wrapper returns without a launch. `pool` is the
// pool's element type (0 f32, 1 bf16, 2 int8; the int8 entries take 2). For bf16 q,
// `pages_per_split` pages of the table go to each block (at most 4096
// rows), and `scratch` is f32 device memory of R * W * nH * n_splits *
// (hd + 2) floats (W = 1 for K3 and K5a; n_splits = ceil(nb /
// pages_per_split)), null allowed with one split.

// K3: q [R, nH, hd] (f32 or bf16), k_pool and v_pool f32 or bf16.
extern "C" int areal_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* valid, void* out, int R,
                                     int nH, int nKV, int hd, int bsz, int nb,
                                     int n_blocks, float sm_scale, int is_bf16, int pool,
                                     void* scratch, int pages_per_split, void* stream) {
  const cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, nullptr, v_pool, nullptr, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, 0};
  return fp_route(a, hd, is_bf16, pool, static_cast<float*>(scratch), pages_per_split,
                  static_cast<cudaStream_t>(stream));
}

// K5a: q in f32 or bf16; int8 k/v pools with f32 scales [n_blocks, nKV, bsz].
extern "C" int areal_paged_attention_q8(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* valid, void* out,
    int R, int nH, int nKV, int hd, int bsz, int nb, int n_blocks,
    float sm_scale, int is_bf16, int pool, void* scratch, int pages_per_split, void* stream) {
  cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e == cudaSuccess && pool != kPoolI8) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, k_scale, v_pool, v_scale, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, 0};
  return paged_route<int8_t>(a, hd, is_bf16, static_cast<float*>(scratch), pages_per_split,
                             static_cast<cudaStream_t>(stream));
}

// K4: q [R, W, nH, hd] (f32 or bf16), k_pool and v_pool f32 or bf16, valid
// [R, W, nb * bsz]; out [R, W, nH, hd].
extern "C" int areal_paged_verify(const void* q, const void* k_pool,
                                  const void* v_pool, const void* table,
                                  const void* valid, void* out, int R, int W,
                                  int nH, int nKV, int hd, int bsz, int nb,
                                  int n_blocks, float sm_scale, int is_bf16, int pool,
                                  void* scratch, int pages_per_split, void* stream) {
  cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e == cudaSuccess) e = check_verify(W, nH / nKV);
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, nullptr, v_pool, nullptr, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, W};
  return fp_route(a, hd, is_bf16, pool, static_cast<float*>(scratch), pages_per_split,
                  static_cast<cudaStream_t>(stream));
}

// K5b: K4 on int8 k/v pools with f32 scales [n_blocks, nKV, bsz].
extern "C" int areal_paged_verify_q8(
    const void* q, const void* k_pool, const void* k_scale, const void* v_pool,
    const void* v_scale, const void* table, const void* valid, void* out,
    int R, int W, int nH, int nKV, int hd, int bsz, int nb, int n_blocks,
    float sm_scale, int is_bf16, int pool, void* scratch, int pages_per_split, void* stream) {
  cudaError_t e = check_args(R, nH, nKV, bsz, nb);
  if (e == cudaSuccess) e = check_verify(W, nH / nKV);
  if (e == cudaSuccess && pool != kPoolI8) e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  const Args a{q,     k_pool, k_scale, v_pool, v_scale, table,
               valid, out,    R,       nKV,    nH / nKV, bsz,
               nb,    n_blocks, sm_scale, W};
  return paged_route<int8_t>(a, hd, is_bf16, static_cast<float*>(scratch), pages_per_split,
                             static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory of one block of a bf16 split kernel, as its
// launch sizes it: K4 (K5b over an int8 `pool`) at W query positions, or K3
// (K5a) with W = 0.
extern "C" long long areal_paged_smem_bytes(int W, int group, int hd, int bsz,
                                            int pages_per_split, int pool) {
  if (W == 0) return (long long)decode_smem(hd, bsz, pages_per_split, pool).total;
  return (long long)verify_smem(W * group, hd, bsz, pages_per_split, pool).total;
}

extern "C" const char* areal_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
