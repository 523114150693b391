// Packed, segment-causal flash attention for Hopper (sm_90a): the forward
// (K1) and its two backward kernels (K2a: dQ, K2b: dK/dV), over one packed
// token stream read in place in its token-major layout.
//
// Replaces the TPU kernels of `areal_tpu/ops/flash_attention.py`:
//   K1  `_fwd_kernel`     (:73, launched by `_fwd_call` :149 at :166)
//   K2a `_bwd_dq_kernel`  (:228, launched by `_bwd_call` :355 at :382)
//   K2b `_bwd_dkv_kernel` (:287, launched at :419)
// and computes what they compute:
//   a key is valid for a query iff same segment, qpos >= kpos, and the
//   query's segment is not -1; s = (q . k) * sm_scale in f32, -1e30 where
//   invalid; online softmax (m, l, acc) over the key tiles with the guard
//   p = (m_new > -5e29) ? exp(s - m_new) : 0; o = acc / (l > 0 ? l : 1) in
//   q's dtype and lse = l > 0 ? m + log(l) : -1e30 (f32). The backward
//   recomputes p = (lse > -5e29) ? exp(s - lse) : 0 and takes
//   ds = p * (dp - delta + dlse), with delta = rowsum(dO * O) computed by
//   the caller (the wrapper passes dd = dlse - delta per row);
//   dq = sm_scale * ds @ K, dv = p^T @ dO, dk = sm_scale * ds^T @ Q.
//
// Layout. q, o, dO, dq are [Tq, nH, HD]; k, v, dk, dv [Tk, nKV, HD], the
// token-major layout the model produces (the JAX wrapper transposes to
// head-major first). lse and dd are f32 [nH, Tq]; segment ids and
// positions int32. GQA: query head h reads kv head h / group, for any
// group (6 for Qwen2.5-1.5B, 7 for 7B); no power of two is assumed.
//
// Bound. Per valid (query, key) pair the forward does 4 * HD flops per
// query head, the dQ pass 6 and the dK/dV pass 8. At the train shape
// (Qwen2.5-1.5B, a packed 8192-token micro-batch of sequences up to ~770
// tokens: ~2.4M valid pairs per head, 12 query heads, HD 128) that is
// 15-30 GFLOP against 10-25 MB of inputs and outputs. At the bf16
// tensor-core rate (989 TFLOP/s) and 3.35 TB/s, K1's and K2a's least
// times are their bytes (0.018 and 0.025 ms, against 0.015 and 0.023 ms
// of operations) and K2b's its operations (0.030 ms).
//
// Two routes, chosen by dtype:
//
// bf16 (the training path): all three kernels on the tensor cores.
//   - mma.sync.m16n8k16, bf16 operands, f32 accumulators; 4 warps of 16
//     tile rows each (queries in K1 and K2a, keys in K2b). K1 and K2a: one
//     block per (64-row Q tile, query head); K2b: one block per (64-row K
//     tile, kv head, split) that loops over its share of the group's heads
//     and their live Q tiles and sums dK and dV in f32 registers (128 of
//     its 255 registers at HD 128). A sequence's first K tile sees all of
//     its Q tiles and its last sees one, so on a short grid a few blocks
//     carry most of the work: the wrapper splits the heads over `splits`
//     blocks, by default one query head each (the fastest of 1..group at
//     the train shape, chip_smoke.py's split sweep), and a second launch
//     adds their f32 partials in split order. Deterministic, no atomics.
//   - Tiles in shared memory as bf16, rows padded by 16 bytes so that
//     ldmatrix is free of bank conflicts. K1 keeps its Q tile and K2a its
//     Q and dO tiles, and both double-buffer the K/V tiles of their live
//     list; K2b keeps its K/V tiles and double-buffers the Q/dO tiles (with
//     their ids, lse and dd) of its live (head, Q tile) list. Each tile is
//     copied with cp.async (16 bytes per copy; rows past T read as 0), the
//     next live tile's copy issued before the current tile's products.
//   - Scores come out of the mma in the accumulator layout of m16n8, which
//     is the A-fragment layout of m16k16: P (K1), dS (K2a), P^T and dS^T
//     (K2b) feed the next product from registers and never touch shared
//     memory. The second operand is read with ldmatrix (.trans for V in
//     K1, K in K2a, dO and Q in K2b). The online softmax runs in
//     registers: a row lives in the 4 threads of a quad (two shuffles),
//     exponentials as exp2f on scores prescaled by sm_scale * log2(e).
//   - K2a recomputes P from lse, so nothing carries from key to key but
//     the dQ sums (64 registers at HD 128): it takes each K tile 32 keys at
//     a time, and S, dP and dS of a step hold 16 + 16 registers where a
//     whole tile would take 64. The Q and dO fragments are re-read from
//     shared memory at every step.
//   - Numerics. Every product of two bf16 inputs is exact in f32. P and
//     dS are f32 in the JAX kernel and in the plain version; a single
//     bf16 term (FlashAttention-2's choice) moves o, dq, dk and dv by
//     ~2^-9 of a term, which misses the train-shape check's 2e-5 absolute
//     term 20-60x (tests/test_torch_flash_attention.py emulates both). So each
//     is split into bf16 hi + lo (within 2^-16 of the f32 value) and
//     multiplied twice, lo first. The tensor cores' f32 accumulation
//     truncates, so each stage of the second products (64 keys in K1, 16
//     keys in K2a, 16 queries in K2b) is summed from zero and added into
//     the running f32 sums on the CUDA cores, rounding to nearest (K1
//     folds the softmax rescale into that add).
//   - Masks: every visited tile is masked per element (a tile that no
//     boundary crosses pays the compares too).
//
// f32: the first version, on the CUDA cores (the f32 tolerance, summation
// order only, leaves no room for bf16 operands):
//   - 64-row tiles, the same block per tile as above; 256 threads as a
//     16 x 16 grid, each owning 4 rows and, in a 64 x 64 score tile, the 4
//     columns tx + 16*j; a row's softmax reductions are shuffles across the
//     16 lanes of its half-warp. In the [64, HD] products each thread owns
//     4 rows x HD/16 columns.
//   - Tiles sit in dynamic shared memory in f32, rows padded to HD + 1
//     floats so that a half-warp reading one column of 16 rows hits 16
//     banks; P (and dS) go through shared memory as f32 tiles.
//
// Both routes skip tiles exactly: the wrapper gives each 64-row tile its
// segment range and position extreme over non-pad rows; a (Q tile, K tile)
// pair is visited only if the segment ranges overlap and the tile's
// smallest key position is <= the Q tile's largest query position. Pairs
// with no valid entry are the only ones skipped, and an all-masked pair
// would leave (m, l, acc) unchanged anyway. For a packed stream
// (non-decreasing segments, positions an arange) this skips everything off
// the per-sequence causal blocks. Every output element is written by one
// thread, once. Each C entry returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kTx = 16;
constexpr int kRows = kTile / 16;  // rows per thread
constexpr int kCols = kTile / kTx;  // score columns per thread
constexpr int kLdP = kTile + 1;     // padded row of a [64, 64] score tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;


struct Args {
  const void* q;     // [Tq, nH, HD]
  const void* k;     // [Tk, nKV, HD]
  const void* v;     // [Tk, nKV, HD]
  const void* dout;  // [Tq, nH, HD] (backward)
  const int* seg_q;  // [Tq]
  const int* seg_k;  // [Tk]
  const int* pos_q;  // [Tq]
  const int* pos_k;  // [Tk]
  const int* meta_q;  // [nq, 3]: seg min, seg max, largest position
  const int* meta_k;  // [nk, 3]: seg min, seg max, smallest position
  const float* lse;  // [nH, Tq] (backward)
  const float* dd;   // [nH, Tq] dlse - delta (backward)
  void* out;         // K1: o; K2a: dq; K2b: dk
  void* out2;        // K1: lse (f32 [nH, Tq]); K2b: dv
  float* work;       // K2b (bf16) with splits > 1: f32 [2, splits, Tk, nKV, HD]
  int Tq, Tk, nH, nKV, group;
  int splits;        // K2b (bf16): blocks sharing a (K tile, kv head)'s heads
  float sm_scale;
};

__device__ __forceinline__ bool pair_live(const int* qm, const int* km) {
  return qm[0] <= km[1] && km[0] <= qm[1] && km[2] <= qm[2];
}

// rows [t0, t0 + 64) of head `head` of a [T, n, HD] tensor into a padded
// f32 tile; rows past T read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int t0,
                                          int T_, int n, int head) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, t = t0 + r;
    dst[r * LD + d] =
        t < T_ ? (src[((size_t)t * n + head) * HD + d]) : 0.f;
  }
}

__device__ __forceinline__ void load_ids(int* seg_s, int* pos_s, const int* seg,
                                         const int* pos, int t0, int T_) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int t = t0 + r;
    seg_s[r] = t < T_ ? seg[t] : -1;
    pos_s[r] = t < T_ ? pos[t] : 0;
  }
}

__device__ __forceinline__ bool valid(int sq, int pq, int sk, int pk) {
  return sq != -1 && sq == sk && pq >= pk;
}

// ===========================================================================
// f32 route: the first version, on the CUDA cores
// ===========================================================================

// ---------------------------------------------------------------------------
// K1: forward. Grid (nq, nH).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kTx;
  const int qt = blockIdx.x, h = blockIdx.y;
  const int kvh = h / a.group;
  const int nk = (a.Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* p_s = v_s + kTile * LD;  // [64][kLdP]
  int* segq_s = reinterpret_cast<int*>(p_s + kTile * kLdP);
  int* posq_s = segq_s + kTile;
  int* segk_s = posq_s + kTile;
  int* posk_s = segk_s + kTile;
  unsigned char* live_s = reinterpret_cast<unsigned char*>(posk_s + kTile);

  const int q0 = qt * kTile;
  load_tile<T, HD>(q_s, static_cast<const T*>(a.q), q0, a.Tq, a.nH, h);
  load_ids(segq_s, posq_s, a.seg_q, a.pos_q, q0, a.Tq);
  const int* qm = a.meta_q + 3 * qt;
  for (int j = tid; j < nk; j += kThreads) live_s[j] = pair_live(qm, a.meta_k + 3 * j);
  __syncthreads();

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[i][o] = 0.f;
  }

  for (int j = 0; j < nk; ++j) {
    if (!live_s[j]) continue;  // the same flag for the whole block
    const int k0 = j * kTile;
    load_tile<T, HD>(k_s, static_cast<const T*>(a.k), k0, a.Tk, a.nKV, kvh);
    load_tile<T, HD>(v_s, static_cast<const T*>(a.v), k0, a.Tk, a.nKV, kvh);
    load_ids(segk_s, posk_s, a.seg_k, a.pos_k, k0, a.Tk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = k_s[(tx + kTx * c) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[i][c] += qv[i] * kv[c];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int sq = segq_s[r], pq = posq_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kc = tx + kTx * c;
        s[i][c] = valid(sq, pq, segk_s[kc], posk_s[kc]) ? s[i][c] * a.sm_scale
                                                         : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = m_new > kNegInf * 0.5f ? expf(s[i][c] - m_new) : 0.f;
        p_s[r * kLdP + tx + kTx * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int o = 0; o < kOut; ++o) acc[i][o] *= alpha;
    }
    __syncthreads();

    // acc += P @ V
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float vv = v_s[c * LD + tx + kTx * o];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][o] += pv[i] * vv;
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out);
  float* lse = static_cast<float*>(a.out2);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty * kRows + i;
    if (t >= a.Tq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    T* row = out + ((size_t)t * a.nH + h) * HD;
#pragma unroll
    for (int o = 0; o < kOut; ++o) row[tx + kTx * o] = acc[i][o] / safe_l;
    if (tx == 0) lse[(size_t)h * a.Tq + t] = l[i] > 0.f ? m[i] + logf(safe_l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// K2a: dQ. Grid (nq, nH).
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kTx;
  const int qt = blockIdx.x, h = blockIdx.y;
  const int kvh = h / a.group;
  const int nk = (a.Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * LD;
  float* k_s = do_s + kTile * LD;
  float* v_s = k_s + kTile * LD;
  float* ds_s = v_s + kTile * LD;  // [64][kLdP]
  int* segq_s = reinterpret_cast<int*>(ds_s + kTile * kLdP);
  int* posq_s = segq_s + kTile;
  int* segk_s = posq_s + kTile;
  int* posk_s = segk_s + kTile;
  unsigned char* live_s = reinterpret_cast<unsigned char*>(posk_s + kTile);

  const int q0 = qt * kTile;
  load_tile<T, HD>(q_s, static_cast<const T*>(a.q), q0, a.Tq, a.nH, h);
  load_tile<T, HD>(do_s, static_cast<const T*>(a.dout), q0, a.Tq, a.nH, h);
  load_ids(segq_s, posq_s, a.seg_q, a.pos_q, q0, a.Tq);
  const int* qm = a.meta_q + 3 * qt;
  for (int j = tid; j < nk; j += kThreads) live_s[j] = pair_live(qm, a.meta_k + 3 * j);

  float lse_r[kRows], dd_r[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty * kRows + i;
    lse_r[i] = t < a.Tq ? a.lse[(size_t)h * a.Tq + t] : kNegInf;
    dd_r[i] = t < a.Tq ? a.dd[(size_t)h * a.Tq + t] : 0.f;
#pragma unroll
    for (int o = 0; o < kOut; ++o) acc[i][o] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < nk; ++j) {
    if (!live_s[j]) continue;
    const int k0 = j * kTile;
    load_tile<T, HD>(k_s, static_cast<const T*>(a.k), k0, a.Tk, a.nKV, kvh);
    load_tile<T, HD>(v_s, static_cast<const T*>(a.v), k0, a.Tk, a.nKV, kvh);
    load_ids(segk_s, posk_s, a.seg_k, a.pos_k, k0, a.Tk);
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = q_s[(ty * kRows + i) * LD + d];
        ov[i] = do_s[(ty * kRows + i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        kv[c] = k_s[(tx + kTx * c) * LD + d];
        vv[c] = v_s[(tx + kTx * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          s[i][c] += qv[i] * kv[c];
          dp[i][c] += ov[i] * vv[c];
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int sq = segq_s[r], pq = posq_s[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kc = tx + kTx * c;
        const float sc = valid(sq, pq, segk_s[kc], posk_s[kc]) ? s[i][c] * a.sm_scale
                                                                : kNegInf;
        const float p = lse_r[i] > kNegInf * 0.5f ? expf(sc - lse_r[i]) : 0.f;
        ds_s[r * kLdP + kc] = p * (dp[i][c] + dd_r[i]);
      }
    }
    __syncthreads();

    // acc += dS @ K
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = ds_s[(ty * kRows + i) * kLdP + c];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const float kk = k_s[c * LD + tx + kTx * o];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][o] += dsv[i] * kk;
      }
    }
    __syncthreads();
  }

  T* dq = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + ty * kRows + i;
    if (t >= a.Tq) continue;
    T* row = dq + ((size_t)t * a.nH + h) * HD;
#pragma unroll
    for (int o = 0; o < kOut; ++o) row[tx + kTx * o] = a.sm_scale * acc[i][o];
  }
}

// ---------------------------------------------------------------------------
// K2b: dK, dV. Grid (nk, nKV); each block sums over its group's heads.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int kOut = HD / kTx;
  const int kt = blockIdx.x, g = blockIdx.y;
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int tid = threadIdx.x, tx = tid % kTx, ty = tid / kTx;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * LD;
  float* q_s = v_s + kTile * LD;
  float* do_s = q_s + kTile * LD;
  float* pt_s = do_s + kTile * LD;   // [64 keys][kLdP queries]
  float* dst_s = pt_s + kTile * kLdP;
  float* lse_s = dst_s + kTile * kLdP;  // [64]
  float* dd_s = lse_s + kTile;           // [64]
  int* segq_s = reinterpret_cast<int*>(dd_s + kTile);
  int* posq_s = segq_s + kTile;
  int* segk_s = posq_s + kTile;
  int* posk_s = segk_s + kTile;
  unsigned char* live_s = reinterpret_cast<unsigned char*>(posk_s + kTile);

  const int k0 = kt * kTile;
  load_tile<T, HD>(k_s, static_cast<const T*>(a.k), k0, a.Tk, a.nKV, g);
  load_tile<T, HD>(v_s, static_cast<const T*>(a.v), k0, a.Tk, a.nKV, g);
  load_ids(segk_s, posk_s, a.seg_k, a.pos_k, k0, a.Tk);
  const int* km = a.meta_k + 3 * kt;
  for (int i = tid; i < nq; i += kThreads) live_s[i] = pair_live(a.meta_q + 3 * i, km);

  float dk[kRows][kOut], dv[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int o = 0; o < kOut; ++o) dk[i][o] = dv[i][o] = 0.f;
  __syncthreads();

  for (int hh = 0; hh < a.group; ++hh) {
    const int h = g * a.group + hh;
    for (int qi = 0; qi < nq; ++qi) {
      if (!live_s[qi]) continue;
      const int q0 = qi * kTile;
      load_tile<T, HD>(q_s, static_cast<const T*>(a.q), q0, a.Tq, a.nH, h);
      load_tile<T, HD>(do_s, static_cast<const T*>(a.dout), q0, a.Tq, a.nH, h);
      load_ids(segq_s, posq_s, a.seg_q, a.pos_q, q0, a.Tq);
      for (int r = tid; r < kTile; r += kThreads) {
        const int t = q0 + r;
        lse_s[r] = t < a.Tq ? a.lse[(size_t)h * a.Tq + t] : kNegInf;
        dd_s[r] = t < a.Tq ? a.dd[(size_t)h * a.Tq + t] : 0.f;
      }
      __syncthreads();

      // transposed tiles: rows are this block's keys, columns the queries
      float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; ++d) {
        float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kv[i] = k_s[(ty * kRows + i) * LD + d];
          vv[i] = v_s[(ty * kRows + i) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          qv[c] = q_s[(tx + kTx * c) * LD + d];
          ov[c] = do_s[(tx + kTx * c) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            st[i][c] += kv[i] * qv[c];
            dpt[i][c] += vv[i] * ov[c];
          }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty * kRows + i;
        const int sk = segk_s[kr], pk = posk_s[kr];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int qc = tx + kTx * c;
          const float sc = valid(segq_s[qc], posq_s[qc], sk, pk) ? st[i][c] * a.sm_scale
                                                                  : kNegInf;
          const float lr = lse_s[qc];
          const float p = lr > kNegInf * 0.5f ? expf(sc - lr) : 0.f;
          pt_s[kr * kLdP + qc] = p;
          dst_s[kr * kLdP + qc] = p * (dpt[i][c] + dd_s[qc]);
        }
      }
      __syncthreads();

      // dv += P^T @ dO, dk += dS^T @ Q
#pragma unroll 2
      for (int c = 0; c < kTile; ++c) {
        float pv[kRows], dsv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pv[i] = pt_s[(ty * kRows + i) * kLdP + c];
          dsv[i] = dst_s[(ty * kRows + i) * kLdP + c];
        }
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          const float ov = do_s[c * LD + tx + kTx * o];
          const float qv = q_s[c * LD + tx + kTx * o];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            dv[i][o] += pv[i] * ov;
            dk[i][o] += dsv[i] * qv;
          }
        }
      }
      __syncthreads();
    }
  }

  T* dk_out = static_cast<T*>(a.out);
  T* dv_out = static_cast<T*>(a.out2);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = k0 + ty * kRows + i;
    if (t >= a.Tk) continue;
    const size_t row = ((size_t)t * a.nKV + g) * HD;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      dk_out[row + tx + kTx * o] = a.sm_scale * dk[i][o];
      dv_out[row + tx + kTx * o] = dv[i][o];
    }
  }
}

// ===========================================================================
// bf16 route: K1, K2a and K2b on the tensor cores
// ===========================================================================

constexpr int kMmaThreads = 128;  // 4 warps, 16 tile rows each
constexpr int kRowPad = 8;        // bf16 elements (16 bytes) past each shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 p) {
  return *reinterpret_cast<const uint32_t*>(&p);
}

// an f32 pair (x in the low half) as two bf16 pairs whose sum is within
// 2^-16 of it: hi rounds the pair, lo rounds the remainder
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
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

// rows [t0, t0 + 64) of head `head` of a [T, n, HD] bf16 tensor into a
// shared tile with rows of HD + kRowPad; rows past T read as 0
template <int HD>
__device__ __forceinline__ void tile_async(bf16* dst, const bf16* src, int t0, int T_,
                                           int n, int head) {
  constexpr int kChunks = HD / 8;  // 16-byte copies per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += kMmaThreads) {
    const int r = c / kChunks, ch = c % kChunks, t = t0 + r;
    const bool ok = t < T_;
    cp_async16(dst + r * (HD + kRowPad) + ch * 8,
               ok ? src + ((size_t)t * n + head) * HD + ch * 8 : src, ok);
  }
}

// element i < 64 of the row vector src[t0 + i] (int or f32), 0 past T
__device__ __forceinline__ void elem_async(void* dst, const void* src, int t0, int T_,
                                           int i) {
  const int t = t0 + i;
  cp_async4(static_cast<uint32_t*>(dst) + i,
            static_cast<const uint32_t*>(src) + (t < T_ ? t : 0), t < T_);
}

// The tiles j < n whose pair with the fixed tile is live, in order, into
// list; their number into *count. Run by warp 0 (a ballot per 32 tiles).
template <bool kFixedIsQuery>
__device__ __forceinline__ void live_list(int* list, int* count, const int* fixed,
                                          const int* metas, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int cnt = 0;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    bool f = false;
    if (j < n)
      f = kFixedIsQuery ? pair_live(fixed, metas + 3 * j) : pair_live(metas + 3 * j, fixed);
    const unsigned bal = __ballot_sync(kFull, f);
    if (f) list[cnt + __popc(bal & ((1u << lane) - 1u))] = j;
    cnt += __popc(bal);
  }
  if (lane == 0) *count = cnt;
}

// acc[16 rows, HD] += A[16 rows, 16] B[16, HD], A as hi + lo fragments, B
// row-major in shared memory from b_row (this lane's ldmatrix.trans
// address for n-tiles 0-1); each n-tile's product is summed from zero on
// the tensor cores, then added rounding to nearest
template <int HD>
__device__ __forceinline__ void second_product(float (*acc)[4], const uint32_t* hi,
                                               const uint32_t* lo, const bf16* b_row) {
#pragma unroll
  for (int np = 0; np < HD / 16; ++np) {
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t b[4];
    ldsm_x4_t(b, b_row + np * 16);
    mma16816(t0, lo, b[0], b[1]);
    mma16816(t0, hi, b[0], b[1]);
    mma16816(t1, lo, b[2], b[3]);
    mma16816(t1, hi, b[2], b[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * np][e] += t0[e];
      acc[2 * np + 1][e] += t1[e];
    }
  }
}

// ---------------------------------------------------------------------------
// K1 (bf16): forward. Grid (nq, nH), 4 warps; warp w owns query rows
// 16w..16w+15 of the tile, thread (g, t4) = (lane / 4, lane % 4) rows g and
// g + 8 of those and, in each 8-column n-tile, columns 2 t4 and 2 t4 + 1.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_fwd_mma_kernel(Args a) {
  constexpr int LD = HD + kRowPad;
  constexpr int kTE = kTile * LD;  // elements of one shared tile
  constexpr int KK = HD / 16;  // k-steps of S = Q K^T
  constexpr int NO = HD / 8;   // n-tiles of O
  const int qt = blockIdx.x, h = blockIdx.y;
  const int kvh = h / a.group;
  const int nk = (a.Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);
  bf16* kv_s = q_s + kTE;  // buffer b: K at kv_s + 2b kTE, V after it
  int* ids_s = reinterpret_cast<int*>(kv_s + 4 * kTE);  // buffer b: seg, pos
  int* list_s = ids_s + 4 * kTile;
  __shared__ int n_live_s;

  const int q0 = qt * kTile;
  tile_async<HD>(q_s, q, q0, a.Tq, a.nH, h);
  cp_async_commit();
  live_list<true>(list_s, &n_live_s, a.meta_q + 3 * qt, a.meta_k, nk);
  __syncthreads();
  const int n_live = n_live_s;

  // the K/V tile list_s[i] and its ids into buffer i & 1
  auto issue = [&](int i) {
    const int k0 = list_s[i] * kTile;
    bf16* ks = kv_s + (i & 1) * 2 * kTE;
    tile_async<HD>(ks, k, k0, a.Tk, a.nKV, kvh);
    tile_async<HD>(ks + kTE, v, k0, a.Tk, a.nKV, kvh);
    int* ids = ids_s + (i & 1) * 2 * kTile;
    if (tid < kTile)
      elem_async(ids, a.seg_k, k0, a.Tk, tid);
    else
      elem_async(ids + kTile, a.pos_k, k0, a.Tk, tid - kTile);
    cp_async_commit();
  };
  if (n_live > 0) issue(0);

  int sq[2], pq[2];  // this thread's two query rows
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = q0 + warp * 16 + g + 8 * ri;
    sq[ri] = t < a.Tq ? a.seg_q[t] : -1;
    pq[ri] = t < a.Tq ? a.pos_q[t] : 0;
  }
  // the warp's Q rows as A fragments are re-read from q_s for every tile:
  // holding them would take HD / 4 registers more
  const bf16* qa_row = q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  cp_async_wait<0>();
  __syncthreads();

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
    const bf16* ks = kv_s + (i & 1) * 2 * kTE;
    const bf16* vs = ks + kTE;
    const int* segk = ids_s + (i & 1) * 2 * kTile;
    const int* posk = segk + kTile;
    const int kn = a.Tk - list_s[i] * kTile;  // key columns inside the stream

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

    // mask, online softmax in log2 units; a row's max and sum over its quad
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t4 + (e & 1), ri = e >> 1;
        const bool ok = c < kn && valid(sq[ri], pq[ri], segk[c], posk[c]);
        s[j][e] = ok ? s[j][e] * scale2 : kNegInf;
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
        s[j][e] = p;
        l[ri] += p;
      }

    // acc = alpha * acc + P V, P as hi + lo A fragments from registers, the
    // tile's product summed from zero and added rounding to nearest
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s, kk, ph[kk], pl[kk]);
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[4];
        ldsm_x4_t(b, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + np * 16 +
                         (lane / 16) * 8);
        mma16816(t0, pl[kk], b[0], b[1]);
        mma16816(t0, ph[kk], b[0], b[1]);
        mma16816(t1, pl[kk], b[2], b[3]);
        mma16816(t1, ph[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2 * np][e] = fmaf(acc[2 * np][e], alpha[e >> 1], t0[e]);
        acc[2 * np + 1][e] = fmaf(acc[2 * np + 1][e], alpha[e >> 1], t1[e]);
      }
    }
    __syncthreads();  // buffer i & 1 is refilled by the next iteration's copy
  }

  bf16* out = static_cast<bf16*>(a.out);
  float* lse = static_cast<float*>(a.out2);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(kFull, l[ri], 1);
    l[ri] += __shfl_xor_sync(kFull, l[ri], 2);
    const int t = q0 + warp * 16 + g + 8 * ri;
    if (t >= a.Tq) continue;
    const float safe_l = l[ri] > 0.f ? l[ri] : 1.f;
    bf16* row = out + ((size_t)t * a.nH + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) = __floats2bfloat162_rn(
          acc[n][2 * ri] / safe_l, acc[n][2 * ri + 1] / safe_l);
    if (t4 == 0)
      lse[(size_t)h * a.Tq + t] = l[ri] > 0.f ? m[ri] * kLn2 + logf(safe_l) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// K2a (bf16): dQ. Grid (nq, nH), 4 warps; warp w owns query rows
// 16w..16w+15 of the tile and their dQ rows over all HD columns (f32
// registers), summed over the live K tiles, each taken 32 keys at a time.
// Thread (g, t4) holds rows g and g + 8, as in K1.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_bwd_dq_mma_kernel(Args a) {
  constexpr int LD = HD + kRowPad;
  constexpr int kTE = kTile * LD;  // elements of one shared tile
  constexpr int KK = HD / 16;      // k-steps of S = Q K^T and dP = dO V^T
  constexpr int NO = HD / 8;       // n-tiles of dQ
  constexpr int kStep = 32;        // keys per step
  constexpr int NS = kStep / 8;    // n-tiles of a step's S and dP
  const int qt = blockIdx.x, h = blockIdx.y;
  const int kvh = h / a.group;
  const int nk = (a.Tk + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);  // Q, then dO at q_s + kTE
  bf16* kv_s = q_s + 2 * kTE;  // buffer b: K at kv_s + 2b kTE, V after it
  int* ids_s = reinterpret_cast<int*>(kv_s + 4 * kTE);  // buffer b: seg, pos
  int* list_s = ids_s + 4 * kTile;
  __shared__ int n_live_s;

  const int q0 = qt * kTile;
  tile_async<HD>(q_s, static_cast<const bf16*>(a.q), q0, a.Tq, a.nH, h);
  tile_async<HD>(q_s + kTE, static_cast<const bf16*>(a.dout), q0, a.Tq, a.nH, h);
  cp_async_commit();
  live_list<true>(list_s, &n_live_s, a.meta_q + 3 * qt, a.meta_k, nk);
  __syncthreads();
  const int n_live = n_live_s;

  // the K/V tile list_s[i] and its ids into buffer i & 1
  auto issue = [&](int i) {
    const int k0 = list_s[i] * kTile;
    bf16* ks = kv_s + (i & 1) * 2 * kTE;
    tile_async<HD>(ks, k, k0, a.Tk, a.nKV, kvh);
    tile_async<HD>(ks + kTE, v, k0, a.Tk, a.nKV, kvh);
    int* ids = ids_s + (i & 1) * 2 * kTile;
    if (tid < kTile)
      elem_async(ids, a.seg_k, k0, a.Tk, tid);
    else
      elem_async(ids + kTile, a.pos_k, k0, a.Tk, tid - kTile);
    cp_async_commit();
  };
  if (n_live > 0) issue(0);

  // this thread's two query rows: ids, lse in log2 units, dd. A row whose
  // lse is -1e30 (no valid key) has p = 0 everywhere: it takes segment -1,
  // which matches no key.
  int sq[2], pq[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = q0 + warp * 16 + g + 8 * ri;
    const bool in = t < a.Tq;
    const float lse = in ? a.lse[(size_t)h * a.Tq + t] : kNegInf;
    sq[ri] = in && lse > kNegInf * 0.5f ? a.seg_q[t] : -1;
    pq[ri] = in ? a.pos_q[t] : 0;
    lse2[ri] = lse * kLog2e;
    dd[ri] = in ? a.dd[(size_t)h * a.Tq + t] : 0.f;
  }
  // the warp's Q and dO rows as A fragments, re-read from shared memory at
  // every step: holding them would take HD / 2 registers more
  const bf16* qa_row = q_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* da_row = qa_row + kTE;
  cp_async_wait<0>();
  __syncthreads();

  float acc[NO][4];
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
    const bf16* ks = kv_s + (i & 1) * 2 * kTE;
    const bf16* vs = ks + kTE;
    const int* segk = ids_s + (i & 1) * 2 * kTile;
    const int* posk = segk + kTile;
    const int kn = a.Tk - list_s[i] * kTile;  // key columns inside the stream

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += kStep) {
      // S = Q K^T and dP = dO V^T: [16 rows, 32 keys] per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, qa_row + kk * 16);
        ldsm_x4(da, da_row + kk * 16);
#pragma unroll
        for (int np = 0; np < kStep / 16; ++np) {
          const int off =
              (c0 + np * 16 + (lane / 16) * 8 + lane % 8) * LD + kk * 16 + ((lane / 8) % 2) * 8;
          uint32_t b[4];
          ldsm_x4(b, ks + off);
          mma16816(s[2 * np], qa, b[0], b[1]);
          mma16816(s[2 * np + 1], qa, b[2], b[3]);
          ldsm_x4(b, vs + off);
          mma16816(dp[2 * np], da, b[0], b[1]);
          mma16816(dp[2 * np + 1], da, b[2], b[3]);
        }
      }
      // P = exp(S - lse), dS = P (dP + dd), in registers (dS over dP)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * t4 + (e & 1), ri = e >> 1;
          const bool ok = c < kn && valid(sq[ri], pq[ri], segk[c], posk[c]);
          const float p = ok ? exp2f(fmaf(s[j][e], scale2, -lse2[ri])) : 0.f;
          dp[j][e] = p * (dp[j][e] + dd[ri]);
        }
      // dQ += dS K, 16 keys per stage, dS as hi + lo, K read transposed
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        uint32_t dh[4], dl[4];
        acc_to_a(dp, kk, dh, dl);
        second_product<HD>(
            acc, dh, dl,
            ks + (c0 + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8);
      }
    }
    __syncthreads();  // buffer i & 1 is refilled by the next iteration's copy
  }

  bf16* dq = static_cast<bf16*>(a.out);
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = q0 + warp * 16 + g + 8 * ri;
    if (t >= a.Tq) continue;
    bf16* row = dq + ((size_t)t * a.nH + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + n * 8) = __floats2bfloat162_rn(
          a.sm_scale * acc[n][2 * ri], a.sm_scale * acc[n][2 * ri + 1]);
  }
}

// ---------------------------------------------------------------------------
// K2b (bf16): dK, dV. Grid (nk, nKV, splits), 4 warps; warp w owns key rows
// 16w..16w+15 of the tile and their dK, dV rows over all HD columns (f32
// registers), summed over its share of the group's heads x live Q tiles.
// Scores are taken transposed (keys as rows), 16 queries at a time. With
// one split the block writes dk and dv; with more, each block writes its
// f32 partial sums and `flash_dkv_reduce_kernel` adds them in split order.
// ---------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_bwd_dkv_mma_kernel(Args a) {
  constexpr int LD = HD + kRowPad;
  constexpr int kTE = kTile * LD;  // elements of one shared tile
  constexpr int KK = HD / 16;
  constexpr int NO = HD / 8;
  const int kt = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int h0 = kvh * a.group + split * a.group / a.splits;  // this block's heads
  const int n_heads = kvh * a.group + (split + 1) * a.group / a.splits - h0;
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_mma);
  bf16* v_s = k_s + kTE;
  bf16* qd_s = v_s + kTE;  // buffer b: Q at qd_s + 2b kTE, dO after it
  int* rows_s = reinterpret_cast<int*>(qd_s + 4 * kTE);  // buffer b: seg, pos, lse, dd
  int* list_s = rows_s + 8 * kTile;
  __shared__ int n_live_s;

  const int k0 = kt * kTile;
  tile_async<HD>(k_s, static_cast<const bf16*>(a.k), k0, a.Tk, a.nKV, kvh);
  tile_async<HD>(v_s, static_cast<const bf16*>(a.v), k0, a.Tk, a.nKV, kvh);
  cp_async_commit();
  live_list<false>(list_s, &n_live_s, a.meta_k + 3 * kt, a.meta_q, nq);
  __syncthreads();
  const int n_live = n_live_s;
  const int n_items = n_heads * n_live;  // (head, Q tile), head-major

  auto issue = [&](int i) {
    const int hh = i / n_live;
    const int h = h0 + hh;
    const int q0 = list_s[i - hh * n_live] * kTile;
    bf16* qs = qd_s + (i & 1) * 2 * kTE;
    tile_async<HD>(qs, q, q0, a.Tq, a.nH, h);
    tile_async<HD>(qs + kTE, dout, q0, a.Tq, a.nH, h);
    int* rows = rows_s + (i & 1) * 4 * kTile;
    const int r = tid % kTile;
    if (tid < kTile) {
      elem_async(rows, a.seg_q, q0, a.Tq, r);
      elem_async(rows + 2 * kTile, a.lse + (size_t)h * a.Tq, q0, a.Tq, r);
    } else {
      elem_async(rows + kTile, a.pos_q, q0, a.Tq, r);
      elem_async(rows + 3 * kTile, a.dd + (size_t)h * a.Tq, q0, a.Tq, r);
    }
    cp_async_commit();
  };
  if (n_items > 0) issue(0);

  int sk[2], pk[2];  // this thread's two key rows; -1 past Tk matches no query
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = k0 + warp * 16 + g + 8 * ri;
    sk[ri] = t < a.Tk ? a.seg_k[t] : -1;
    pk[ri] = t < a.Tk ? a.pos_k[t] : 0;
  }
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale2 = a.sm_scale * kLog2e;
  const bf16* ka_row = k_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const bf16* va_row = v_s + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;

  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = qd_s + (i & 1) * 2 * kTE;
    const bf16* dos = qs + kTE;
    const int* segq = rows_s + (i & 1) * 4 * kTile;
    const int* posq = segq + kTile;
    const float* lse_s = reinterpret_cast<const float*>(segq + 2 * kTile);
    const float* dd_s = lse_s + kTile;
    const int qn = a.Tq - list_s[i % n_live] * kTile;  // query columns inside the stream

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 16) {  // 16 queries at a time
      // S^T = K Q^T and dP^T = V dO^T: [16 keys, 16 queries] per warp
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      const int b_off = (c0 + (lane / 16) * 8 + lane % 8) * LD + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        uint32_t ka[4], va[4], b[4];
        ldsm_x4(ka, ka_row + kk * 16);
        ldsm_x4(b, qs + b_off + kk * 16);
        mma16816(st[0], ka, b[0], b[1]);
        mma16816(st[1], ka, b[2], b[3]);
        ldsm_x4(va, va_row + kk * 16);
        ldsm_x4(b, dos + b_off + kk * 16);
        mma16816(dpt[0], va, b[0], b[1]);
        mma16816(dpt[1], va, b[2], b[3]);
      }
      // P^T = exp(S^T - lse), dS^T = P^T (dP^T + dd), in registers
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + j * 8 + 2 * t4 + (e & 1), ri = e >> 1;
          const float lse_c = lse_s[c];
          const bool ok = c < qn && lse_c > kNegInf * 0.5f &&
                          valid(segq[c], posq[c], sk[ri], pk[ri]);
          const float p = ok ? exp2f(fmaf(st[j][e], scale2, -lse_c * kLog2e)) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] + dd_s[c]);
        }
      uint32_t ph[4], pl[4], dh[4], dl[4];
      acc_to_a(st, 0, ph, pl);
      acc_to_a(dpt, 0, dh, dl);
      // dV += P^T dO, then dK += dS^T Q, over these 16 queries (hi + lo),
      // each summed from zero and added rounding to nearest
      const bf16* b_row = dos + (c0 + lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;
      second_product<HD>(dv, ph, pl, b_row);
      second_product<HD>(dk, dh, dl, b_row - kTE);  // Q sits just before dO
    }
    __syncthreads();  // buffer i & 1 is refilled by the next iteration's copy
  }

  bf16* dk_out = static_cast<bf16*>(a.out);
  bf16* dv_out = static_cast<bf16*>(a.out2);
  const size_t part = (size_t)a.splits * a.Tk * a.nKV * HD;  // dv partials after dk's
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int t = k0 + warp * 16 + g + 8 * ri;
    if (t >= a.Tk) continue;
    const size_t row = ((size_t)t * a.nKV + kvh) * HD + 2 * t4;
    if (a.splits == 1) {
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk_out + row + n * 8) = __floats2bfloat162_rn(
            a.sm_scale * dk[n][2 * ri], a.sm_scale * dk[n][2 * ri + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_out + row + n * 8) =
            __floats2bfloat162_rn(dv[n][2 * ri], dv[n][2 * ri + 1]);
      }
    } else {
      float* w = a.work + (size_t)split * a.Tk * a.nKV * HD + row;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(w + n * 8) = make_float2(dk[n][2 * ri], dk[n][2 * ri + 1]);
        *reinterpret_cast<float2*>(w + part + n * 8) =
            make_float2(dv[n][2 * ri], dv[n][2 * ri + 1]);
      }
    }
  }
}

// K2b's second pass when its heads are split: dk = sm_scale * sum and
// dv = sum of the splits' f32 partials, in split order (deterministic);
// 4 consecutive elements per thread. n = Tk * nKV * HD.
__global__ void __launch_bounds__(256) flash_dkv_reduce_kernel(const float* __restrict__ work,
                                                               bf16* dk, bf16* dv, size_t n,
                                                               int splits, float sm_scale) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < splits; ++s) {
    const float4 pk = *reinterpret_cast<const float4*>(work + s * n + i);
    const float4 pv = *reinterpret_cast<const float4*>(work + (splits + s) * n + i);
    sk = make_float4(sk.x + pk.x, sk.y + pk.y, sk.z + pk.z, sk.w + pk.w);
    sv = make_float4(sv.x + pv.x, sv.y + pv.y, sv.z + pv.z, sv.w + pv.w);
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
  k2[0] = __floats2bfloat162_rn(sm_scale * sk.x, sm_scale * sk.y);
  k2[1] = __floats2bfloat162_rn(sm_scale * sk.z, sm_scale * sk.w);
  v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
  v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// Dynamic shared memory of one block. First version: f32 tiles with padded
// rows, the score tile(s), per-row ids, and one live flag per tile walked.
// Tensor-core kernels (bf16): bf16 tiles with padded rows (K1: Q, 2 x K/V; K2a:
// Q, dO, 2 x K/V; K2b: K/V, 2 x Q/dO), double-buffered row vectors, and
// the live list.
size_t smem_bytes(Which which, int hd, int nq, int nk, int is_bf16) {
  if (is_bf16) {
    const size_t tile = sizeof(__nv_bfloat16) * kTile * (hd + kRowPad);
    if (which == kFwd) return 5 * tile + sizeof(int) * (4 * kTile + nk);
    if (which == kDq) return 6 * tile + sizeof(int) * (4 * kTile + nk);
    return 6 * tile + sizeof(int) * (8 * kTile + nq);
  }
  const size_t tile = sizeof(float) * kTile * (hd + 1);
  const size_t ptile = sizeof(float) * kTile * kLdP;
  const size_t ids = sizeof(int) * 4 * kTile;
  if (which == kFwd) return 3 * tile + ptile + ids + nk;
  if (which == kDq) return 4 * tile + ptile + ids + nk;
  return 4 * tile + 2 * ptile + sizeof(float) * 2 * kTile + ids + nq;
}

template <typename T, int HD>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int nk = (a.Tk + kTile - 1) / kTile;
  void (*kernel)(Args);
  dim3 grid;
  int threads = kThreads;
  if (which == kFwd) {
    grid = dim3(nq, a.nH);
    if constexpr (kBf16) {
      kernel = flash_fwd_mma_kernel<HD>;
      threads = kMmaThreads;
    } else {
      kernel = flash_fwd_kernel<T, HD>;
    }
  } else if (which == kDq) {
    grid = dim3(nq, a.nH);
    if constexpr (kBf16) {
      kernel = flash_bwd_dq_mma_kernel<HD>;
      threads = kMmaThreads;
    } else {
      kernel = flash_bwd_dq_kernel<T, HD>;
    }
  } else {
    grid = dim3(nk, a.nKV);
    if constexpr (kBf16) {
      kernel = flash_bwd_dkv_mma_kernel<HD>;
      threads = kMmaThreads;
      grid.z = a.splits;
    } else {
      kernel = flash_bwd_dkv_kernel<T, HD>;
    }
  }
  const size_t smem = smem_bytes(which, HD, nq, nk, kBf16);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (threads == kMmaThreads) {  // room for two blocks per SM
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || !kBf16 || which != kDkv || a.splits == 1) return e;
  const size_t n = (size_t)a.Tk * a.nKV * HD;
  flash_dkv_reduce_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      a.work, static_cast<bf16*>(a.out), static_cast<bf16*>(a.out2), n, a.splits, a.sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, Which which, const Args& a, cudaStream_t s) {
  switch (hd) {
    case 16:
      return launch<T, 16>(which, a, s);
    case 32:
      return launch<T, 32>(which, a, s);
    case 64:
      return launch<T, 64>(which, a, s);
    case 128:
      return launch<T, 128>(which, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(Which which, const Args& a, int hd, int is_bf16, void* stream) {
  if (a.Tq <= 0 || a.Tk <= 0 || a.nKV <= 0 || a.nH % a.nKV != 0 ||
      a.nH > 65535 || a.nKV > 65535)
    return cudaErrorInvalidValue;
  const bool split = is_bf16 && which == kDkv;
  if (a.splits < 1 || a.splits > a.group || (a.splits > 1 && (!split || !a.work)))
    return cudaErrorInvalidValue;
  if (is_bf16) {  // the tensor-core kernels' cp.async reads 16-byte rows
    const void* rows[] = {a.q, a.k, a.v, a.dout};
    for (const void* p : rows)
      if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16>(hd, which, a, s);
  return dispatch_hd<float>(hd, which, a, s);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* seg_q, const void* seg_k, const void* pos_q,
               const void* pos_k, const void* meta_q, const void* meta_k,
               const void* lse, const void* dd, void* out, void* out2, int Tq,
               int Tk, int nH, int nKV, float sm_scale, void* work = nullptr,
               int splits = 1) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.seg_q = static_cast<const int*>(seg_q);
  a.seg_k = static_cast<const int*>(seg_k);
  a.pos_q = static_cast<const int*>(pos_q);
  a.pos_k = static_cast<const int*>(pos_k);
  a.meta_q = static_cast<const int*>(meta_q);
  a.meta_k = static_cast<const int*>(meta_k);
  a.lse = static_cast<const float*>(lse);
  a.dd = static_cast<const float*>(dd);
  a.out = out;
  a.out2 = out2;
  a.work = static_cast<float*>(work);
  a.splits = splits;
  a.Tq = Tq;
  a.Tk = Tk;
  a.nH = nH;
  a.nKV = nKV;
  a.group = nKV > 0 ? nH / nKV : 0;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace

// Plain C entries for ctypes. Every pointer is a device pointer of a
// contiguous tensor (layouts above); `stream` is the caller's
// cudaStream_t. Each returns its launch's cudaGetLastError() (0 on
// success); the wrapper raises on anything else. Tq and Tk must be >= 1.
// On the bf16 route q, k, v and dout must be 16-byte aligned.

// K1: o [Tq, nH, HD] in q's dtype, lse f32 [nH, Tq].
extern "C" int areal_flash_fwd(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_k,
                               const void* pos_q, const void* pos_k,
                               const void* meta_q, const void* meta_k,
                               void* out, void* lse, int Tq, int Tk, int nH,
                               int nKV, int hd, float sm_scale, int is_bf16,
                               void* stream) {
  const Args a = make_args(q, k, v, nullptr, seg_q, seg_k, pos_q, pos_k, meta_q,
                           meta_k, nullptr, nullptr, out, lse, Tq, Tk, nH, nKV,
                           sm_scale);
  return run(kFwd, a, hd, is_bf16, stream);
}

// K2a: dq [Tq, nH, HD] in q's dtype.
extern "C" int areal_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* dd, const void* seg_q,
                                  const void* seg_k, const void* pos_q,
                                  const void* pos_k, const void* meta_q,
                                  const void* meta_k, void* dq, int Tq, int Tk,
                                  int nH, int nKV, int hd, float sm_scale,
                                  int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, seg_q, seg_k, pos_q, pos_k, meta_q,
                           meta_k, lse, dd, dq, nullptr, Tq, Tk, nH, nKV,
                           sm_scale);
  return run(kDq, a, hd, is_bf16, stream);
}

// K2b: dk, dv [Tk, nKV, HD] in k's dtype, summed over the GQA group. In
// bf16, `splits` blocks (1..group) share each (K tile, kv head)'s heads;
// with more than 1, `work` is f32 scratch of 2 * splits * Tk * nKV * HD
// (16-byte aligned) and a second launch adds the partials.
extern "C" int areal_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* dd, const void* seg_q,
                                   const void* seg_k, const void* pos_q,
                                   const void* pos_k, const void* meta_q,
                                   const void* meta_k, void* dk, void* dv,
                                   void* work, int splits, int Tq, int Tk, int nH,
                                   int nKV, int hd, float sm_scale, int is_bf16,
                                   void* stream) {
  const Args a = make_args(q, k, v, dout, seg_q, seg_k, pos_q, pos_k, meta_q,
                           meta_k, lse, dd, dk, dv, Tq, Tk, nH, nKV, sm_scale, work,
                           splits);
  return run(kDkv, a, hd, is_bf16, stream);
}

// Dynamic shared memory one block of `which` (0: K1, 1: K2a, 2: K2b)
// takes at head dim `hd` over Tq queries and Tk keys, for bf16 (the
// tensor-core route) or f32 inputs.
extern "C" int areal_flash_smem_bytes(int which, int hd, int Tq, int Tk, int is_bf16) {
  return (int)smem_bytes(static_cast<Which>(which), hd, (Tq + kTile - 1) / kTile,
                         (Tk + kTile - 1) / kTile, is_bf16);
}

extern "C" const char* areal_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
