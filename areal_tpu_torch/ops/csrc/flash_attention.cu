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
// query head, the dQ pass 6 and the dK/dV pass 8 (two and three products
// of HD, plus one of HD for the recomputed scores), against a few bytes
// per token: at training lengths (sequences of hundreds of tokens) the
// work is far above the card's bytes-per-flop line, so these kernels are
// bound by operations. This first version runs them on the f32 CUDA
// cores (67 TFLOP/s on an H100 SXM), reading both operands of every
// product from shared memory; tensor cores (mma.sync / wgmma on bf16
// tiles, 989 TFLOP/s) and TMA are the next step.
//
// Design, first version:
//   - 64-row tiles. K1 and K2a: one block per (Q tile, query head); the
//     TPU kernels' sequential grid axis over K tiles becomes a loop inside
//     the block. K2b: one block per (K tile, kv head) that loops over the
//     group's query heads and their Q tiles, so dK and dV are summed over
//     the GQA group in f32 registers and written once, in k's dtype: no
//     [nH, T, HD] f32 temporary and no reduction outside (JAX :457).
//   - 256 threads as a 16 x 16 grid: each thread owns 4 rows (ty*4+i) and,
//     in a 64 x 64 score tile, the 4 columns tx + 16*j; a row's softmax
//     reductions are shuffles across the 16 lanes of its half-warp. In the
//     [64, HD] products each thread owns 4 rows x HD/16 columns.
//   - Tiles sit in dynamic shared memory in f32 (inputs upcast once, as
//     the Pallas kernel upcasts), rows padded to HD + 1 floats so that a
//     half-warp reading one column of 16 rows hits 16 banks. At HD 128:
//     K1 116 KB, K2a 149 KB, K2b 166 KB, one block per SM.
//   - Tile skipping, exact for any input: the wrapper gives each tile its
//     segment range and position extreme over non-pad rows; a (Q tile,
//     K tile) pair is visited only if the segment ranges overlap and the
//     tile's smallest key position is <= the Q tile's largest query
//     position. Pairs with no valid entry are the only ones skipped, and
//     an all-masked pair would leave (m, l, acc) unchanged anyway. For a
//     packed stream (non-decreasing segments, positions an arange) this
//     skips everything off the per-sequence causal blocks; each block reads
//     its flags into shared memory first, so a skipped tile costs nothing.
//   - Deterministic: no atomics; every output element is written by one
//     thread, once.
// Each C entry returns cudaGetLastError() of its launch.

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

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
  int Tq, Tk, nH, nKV, group;
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
        t < T_ ? to_f32(src[((size_t)t * n + head) * HD + d]) : 0.f;
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
    for (int o = 0; o < kOut; ++o) store(acc[i][o] / safe_l, row + tx + kTx * o);
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
    for (int o = 0; o < kOut; ++o) store(a.sm_scale * acc[i][o], row + tx + kTx * o);
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
      store(a.sm_scale * dk[i][o], dk_out + row + tx + kTx * o);
      store(dv[i][o], dv_out + row + tx + kTx * o);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// dynamic shared memory of one block: f32 tiles with padded rows, the
// score tile(s), per-row ids, and one live flag per tile walked
size_t smem_bytes(Which which, int hd, int nq, int nk) {
  const size_t tile = sizeof(float) * kTile * (hd + 1);
  const size_t ptile = sizeof(float) * kTile * kLdP;
  const size_t ids = sizeof(int) * 4 * kTile;
  if (which == kFwd) return 3 * tile + ptile + ids + nk;
  if (which == kDq) return 4 * tile + ptile + ids + nk;
  return 4 * tile + 2 * ptile + sizeof(float) * 2 * kTile + ids + nq;
}

template <typename T, int HD>
cudaError_t launch(Which which, const Args& a, cudaStream_t stream) {
  const int nq = (a.Tq + kTile - 1) / kTile;
  const int nk = (a.Tk + kTile - 1) / kTile;
  void (*kernel)(Args);
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, HD>;
    grid = dim3(nq, a.nH);
  } else if (which == kDq) {
    kernel = flash_bwd_dq_kernel<T, HD>;
    grid = dim3(nq, a.nH);
  } else {
    kernel = flash_bwd_dkv_kernel<T, HD>;
    grid = dim3(nk, a.nKV);
  }
  const size_t smem = smem_bytes(which, HD, nq, nk);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return dispatch_hd<__nv_bfloat16>(hd, which, a, s);
  return dispatch_hd<float>(hd, which, a, s);
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* seg_q, const void* seg_k, const void* pos_q,
               const void* pos_k, const void* meta_q, const void* meta_k,
               const void* lse, const void* dd, void* out, void* out2, int Tq,
               int Tk, int nH, int nKV, float sm_scale) {
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

// K2b: dk, dv [Tk, nKV, HD] in k's dtype, summed over the GQA group.
extern "C" int areal_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* dd, const void* seg_q,
                                   const void* seg_k, const void* pos_q,
                                   const void* pos_k, const void* meta_q,
                                   const void* meta_k, void* dk, void* dv,
                                   int Tq, int Tk, int nH, int nKV, int hd,
                                   float sm_scale, int is_bf16, void* stream) {
  const Args a = make_args(q, k, v, dout, seg_q, seg_k, pos_q, pos_k, meta_q,
                           meta_k, lse, dd, dk, dv, Tq, Tk, nH, nKV, sm_scale);
  return run(kDkv, a, hd, is_bf16, stream);
}

// Dynamic shared memory one block of `which` (0: K1, 1: K2a, 2: K2b)
// takes at head dim `hd` over Tq queries and Tk keys.
extern "C" int areal_flash_smem_bytes(int which, int hd, int Tq, int Tk) {
  return (int)smem_bytes(static_cast<Which>(which), hd, (Tq + kTile - 1) / kTile,
                         (Tk + kTile - 1) / kTile);
}

extern "C" const char* areal_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
