// Int8-weight matmul for Hopper (sm_90a): out[T, N] = (x[T, K] @ q[K, N]) *
// scale[N], f32 accumulation, output in x's dtype (f32 or bf16).
//
// Replaces the TPU kernel `areal_tpu/ops/quant_matmul.py::_quant_matmul_kernel`
// (:55), launched there by `_quant_matmul_pallas` (:84). The weights are
// per-output-channel symmetric absmax int8 (`ops/quant.py`): row-major
// [K, N] int8 with N contiguous, one f32 scale per column. It computes what
// that kernel computes, with the scale folded in after the K loop instead of
// before it: the values -127..127 are exact in bf16, so every product
// x * q is exact in f32 and the result differs from the plain version
// (`x @ (q * scale)` in f32) only by the order and rounding of the f32 sums.
//
// Bound. In decode (T = 1..16) each weight byte is used by at most 16
// rows: 2 * T flops per byte, far below the H100's ~295 bf16 flops per byte
// of HBM, so the kernel is bound by bytes: the int8 weights, the scales, x
// and the output, over 3.35 TB/s (one decode step's 196 calls read 6.53 GB
// at Qwen2.5-7B, ~1.95 ms). In prefill (T up to 1024) it is bound by its
// 2 * T * K * N operations at the bf16 tensor-core rate.
//
// Design, first version (made fast in a later change):
//   - one block of 4 warps per 128 output columns x BT rows (BT = 16 when
//     T <= 16, else 64), so at decode sizes every weight byte is read once
//     per call; when those blocks cannot fill the card, the K loop is split
//     across blocks (split-K): each split writes its f32 partial tile to a
//     workspace, and the last split of a tile to arrive (an atomic counter,
//     reset by that block) sums the partials in split order, applies the
//     scale and writes the output: one launch, deterministic sums;
//   - a 4-stage cp.async pipeline of 64-deep stages: int8 weight rows of
//     128 bytes loaded as 16-byte chunks along N, x rows along K; ragged T,
//     K and N are zero-filled (cp.async with a source size of 0), and a
//     weight or x row that is not 16-byte aligned (N % 16, or K % 8 for
//     bf16 / K % 4 for f32) is staged with element loads instead;
//   - the products run on the tensor cores, `mma.sync.m16n8k16` bf16 with
//     f32 accumulators. The weight operand needs two consecutive k of one
//     column per register while the tile holds N contiguous; so each thread
//     reads 32-bit words of 4 neighbouring columns from 4 k rows, and the
//     byte j of a word feeds n8 fragment j: fragment j of warp w covers
//     columns 32w + 4g + j (g the lane's group). The int8 values become bf16
//     in registers (exact); no fp copy of the weights exists outside them;
//   - f32 x is split into three bf16 terms (hi + mid + lo, exact for a
//     24-bit mantissa) and multiplied three times, smallest first, so f32
//     inputs keep their precision on the tensor cores;
//   - the tensor cores' f32 accumulation truncates (rounds toward zero),
//     which over a 3584-deep sum biases the result by ~1e-5 of its largest
//     value (measured on an H100). So each 64-deep stage is summed by the
//     mma from zero, and the stage sums are added into the running sum on
//     the CUDA cores, rounding to nearest;
//   - shared rows are padded (weights 144 bytes, x 72 elements) so the
//     fragment reads are free of bank conflicts.
// What it leaves on the table: the int8 -> bf16 conversion costs CUDA-core
// instructions for every weight byte, the output is written as scattered
// 2- or 4-byte stores, and mma.sync reaches a fraction of wgmma's rate at
// prefill sizes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps, 32 output columns each
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 64;        // depth of one pipeline stage
constexpr int kStages = 4;
constexpr int kWRow = kBN + 16;  // bytes per shared weight row
constexpr int kXRow = kBK + 8;   // elements per shared x row

template <typename TX, int MT>
struct Tile {
  static constexpr int kBT = 16 * MT;  // rows of x per block
  static constexpr int kWBytes = kBK * kWRow;
  static constexpr int kXBytes = kBT * kXRow * (int)sizeof(TX);
  static constexpr int kStageBytes = kWBytes + kXBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// bf16 pair (k, k+1) of byte j of two weight words (rows k and k+1)
__device__ __forceinline__ uint32_t pack_i8(uint32_t w_k, uint32_t w_k1,
                                            int j) {
  const float lo = static_cast<float>(static_cast<int8_t>(w_k >> (8 * j)));
  const float hi = static_cast<float>(static_cast<int8_t>(w_k1 >> (8 * j)));
  return pack_bf16(lo, hi);
}

// f32 -> three bf16 terms whose sum is exactly v (24 = 3 x 8 mantissa bits)
__device__ __forceinline__ void split3(float v, float* t) {
  const float h = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - h;  // exact
  const float m = __bfloat162float(__float2bfloat16_rn(r));
  t[0] = h;
  t[1] = m;
  t[2] = r - m;  // exact, and a bf16 value
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void store(float v, float* p) { *p = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

template <typename TX, int MT>
__global__ void __launch_bounds__(kThreads)
    quant_matmul_kernel(const TX* __restrict__ x,        // [T, K]
                        const int8_t* __restrict__ w,    // [K, N]
                        const float* __restrict__ scale,  // [N]
                        TX* __restrict__ out,            // [T, N]
                        float* __restrict__ part,        // [splits, T, N]
                        int* __restrict__ counters,      // [m_tiles, n_tiles]
                        int T, int K, int N, int tiles_per_split, int x_vec,
                        int w_vec) {
  using TL = Tile<TX, MT>;
  constexpr int kBT = TL::kBT;
  constexpr bool kF32 = std::is_same<TX, float>::value;
  constexpr int kXV = 16 / (int)sizeof(TX);  // x elements per 16 bytes

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_split;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // mma group
  const int t4 = lane & 3;  // thread in group
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBT;
  const int split = blockIdx.z;
  const int splits = gridDim.z;
  const int k_tiles = (K + kBK - 1) / kBK;
  const int kt0 = split * tiles_per_split;
  const int nk = min(tiles_per_split, k_tiles - kt0);

  auto w_stage = [&](int st) { return smem + st * TL::kStageBytes; };
  auto x_stage = [&](int st) {
    return reinterpret_cast<TX*>(smem + st * TL::kStageBytes + TL::kWBytes);
  };

  auto load_tile = [&](int st, int kt) {
    const int k0 = kt * kBK;
    uint8_t* ws = w_stage(st);
    if (w_vec) {
      for (int c = tid; c < kBK * (kBN / 16); c += kThreads) {
        const int row = c / (kBN / 16), ch = c % (kBN / 16);
        const int k = k0 + row, n = n0 + ch * 16;
        const bool ok = k < K && n < N;  // N % 16 == 0: all or nothing
        cp_async16(ws + row * kWRow + ch * 16, ok ? w + (size_t)k * N + n : w,
                   ok);
      }
    } else {
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int row = e / kBN, col = e % kBN;
        const int k = k0 + row, n = n0 + col;
        ws[row * kWRow + col] =
            (k < K && n < N) ? static_cast<uint8_t>(w[(size_t)k * N + n]) : 0;
      }
    }
    TX* xs = x_stage(st);
    if (x_vec) {
      for (int c = tid; c < kBT * (kBK / kXV); c += kThreads) {
        const int row = c / (kBK / kXV), ch = c % (kBK / kXV);
        const int t = m0 + row, k = k0 + ch * kXV;
        const bool ok = t < T && k < K;  // K % kXV == 0: all or nothing
        cp_async16(xs + row * kXRow + ch * kXV,
                   ok ? x + (size_t)t * K + k : x, ok);
      }
    } else {
      for (int e = tid; e < kBT * kBK; e += kThreads) {
        const int row = e / kBK, col = e % kBK;
        const int t = m0 + row, k = k0 + col;
        xs[row * kXRow + col] =
            (t < T && k < K) ? x[(size_t)t * K + k] : zero<TX>();
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto compute = [&](int st) {
    const uint8_t* ws = w_stage(st);
    const TX* xs = x_stage(st);
    float part[MT][4][4];  // this stage's sums, from the tensor cores
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // weight fragments: words of columns 32 * warp + 4g .. +3 at the
      // rows k = kk + 2 t4 (+1, +8, +9)
      const uint8_t* wr = ws + (kk + 2 * t4) * kWRow + warp * 32 + 4 * g;
      const uint32_t r0 = *reinterpret_cast<const uint32_t*>(wr);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(wr + kWRow);
      const uint32_t r2 = *reinterpret_cast<const uint32_t*>(wr + 8 * kWRow);
      const uint32_t r3 = *reinterpret_cast<const uint32_t*>(wr + 9 * kWRow);
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = pack_i8(r0, r1, j);
        b[j][1] = pack_i8(r2, r3, j);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = 16 * i + g;
        const int col = kk + 2 * t4;
        if constexpr (kF32) {
          // (row, col), (row + 8, col), (row, col + 8), (row + 8, col + 8)
          float2 v[4];
          v[0] = *reinterpret_cast<const float2*>(xs + row * kXRow + col);
          v[1] = *reinterpret_cast<const float2*>(xs + (row + 8) * kXRow + col);
          v[2] = *reinterpret_cast<const float2*>(xs + row * kXRow + col + 8);
          v[3] =
              *reinterpret_cast<const float2*>(xs + (row + 8) * kXRow + col + 8);
          float xk[4][3], xk1[4][3];  // the terms of x at k and k + 1
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            split3(v[r].x, xk[r]);
            split3(v[r].y, xk1[r]);
          }
#pragma unroll
          for (int p = 2; p >= 0; --p) {  // lo, mid, hi: smallest first
            uint32_t a[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = pack_bf16(xk[r][p], xk1[r][p]);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b[j]);
          }
        } else {
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(xs + row * kXRow + col);
          a[1] = *reinterpret_cast<const uint32_t*>(xs + (row + 8) * kXRow + col);
          a[2] = *reinterpret_cast<const uint32_t*>(xs + row * kXRow + col + 8);
          a[3] = *reinterpret_cast<const uint32_t*>(xs + (row + 8) * kXRow +
                                                    col + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(part[i][j], a, b[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  };

  // the pipeline: kStages - 1 tiles in flight ahead of the one computed
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(s, kt0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` landed; stage (it - 1) % kStages is free
    const int nxt = it + kStages - 1;
    if (nxt < nk) load_tile(nxt % kStages, kt0 + nxt);
    cp_async_commit();
    compute(it % kStages);
  }
  cp_async_wait<0>();

  // accumulator (i, j, e) -> row 16 i + g (+8 for e >= 2), column
  // 32 warp + 8 t4 + j (+4 for odd e)
  const int col_base = n0 + warp * 32 + 8 * t4;
  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m0 + 16 * i + g + (e >= 2 ? 8 : 0);
          const int col = col_base + j + (e & 1 ? 4 : 0);
          if (row < T && col < N)
            store(acc[i][j][e] * scale[col], out + (size_t)row * N + col);
        }
    return;
  }

  // split-K: this split's partial tile, then the last split to arrive
  // sums all of them in split order
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + 16 * i + g + (e >= 2 ? 8 : 0);
        const int col = col_base + j + (e & 1 ? 4 : 0);
        if (row < T && col < N)
          part[((size_t)split * T + row) * N + col] = acc[i][j][e];
      }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = counters + blockIdx.y * gridDim.x + blockIdx.x;
    const int prev = atomicAdd(cnt, 1);
    last_split = prev == splits - 1;
    if (last_split) *cnt = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_split) return;
  __threadfence();
  for (int e = tid; e < kBT * kBN; e += kThreads) {
    const int row = m0 + e / kBN, col = n0 + e % kBN;
    if (row >= T || col >= N) continue;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s)
      sum += __ldcg(part + ((size_t)s * T + row) * N + col);
    store(sum * scale[col], out + (size_t)row * N + col);
  }
}

template <typename TX, int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   void* part, void* counters, int T, int K, int N,
                   int splits, int tiles_per_split, int x_vec, int w_vec,
                   cudaStream_t stream) {
  using TL = Tile<TX, MT>;
  static bool smem_set = false;  // once per process (one card)
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        quant_matmul_kernel<TX, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TL::kSmem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (T + TL::kBT - 1) / TL::kBT, splits);
  quant_matmul_kernel<TX, MT><<<grid, kThreads, TL::kSmem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TX*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), T, K, N,
      tiles_per_split, x_vec, w_vec);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_mt(int mt, const void* x, const void* w,
                        const void* scale, void* out, void* part,
                        void* counters, int T, int K, int N, int splits,
                        int tiles_per_split, int x_vec, int w_vec,
                        cudaStream_t stream) {
  if (mt == 1)
    return launch<TX, 1>(x, w, scale, out, part, counters, T, K, N, splits,
                         tiles_per_split, x_vec, w_vec, stream);
  if (mt == 4)
    return launch<TX, 4>(x, w, scale, out, part, counters, T, K, N, splits,
                         tiles_per_split, x_vec, w_vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry for ctypes. Every pointer is a device pointer of a
// contiguous tensor; `stream` is the caller's cudaStream_t. `mt` is 1
// (T <= 16) or 4 row fragments of 16 per block. With splits > 1, `part`
// holds splits * T * N floats and `counters` one zeroed int per output tile
// (m_tiles * n_tiles), which the launch leaves zeroed again. The k tiles
// (64 deep) are dealt `tiles_per_split` to a split, and every split gets at
// least one. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int areal_quant_matmul(const void* x, const void* w,
                                  const void* scale, void* out, void* part,
                                  void* counters, int T, int K, int N, int mt,
                                  int splits, int tiles_per_split, int x_vec,
                                  int w_vec, int is_bf16, void* stream) {
  const int k_tiles = (K + kBK - 1) / kBK;
  if (T <= 0 || K <= 0 || N <= 0 || splits < 1 || splits > 65535 ||
      tiles_per_split < 1 || (long long)splits * tiles_per_split < k_tiles ||
      (long long)(splits - 1) * tiles_per_split >= k_tiles ||
      (T + 16 * mt - 1) / (16 * mt) > 65535 ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_mt<__nv_bfloat16>(mt, x, w, scale, out, part, counters, T,
                                      K, N, splits, tiles_per_split, x_vec,
                                      w_vec, s);
  return dispatch_mt<float>(mt, x, w, scale, out, part, counters, T, K, N,
                            splits, tiles_per_split, x_vec, w_vec, s);
}

extern "C" const char* areal_quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
