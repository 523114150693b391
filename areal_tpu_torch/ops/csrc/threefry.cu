// Position-keyed Gumbel noise of the decode sampler, for Hopper (sm_90a).
//
// What it replaces: no Pallas kernel. The JAX engine draws each token with
// `jax.random.categorical(fold_in(base_key, position), logits)`
// (`areal_tpu/engine/jax_decode.py::_make_sample_fn`, :211), which XLA
// fuses into the decode step. Eager PyTorch would spend ~150 elementwise
// launches per draw on the same Threefry arithmetic; this is one launch.
//
// For row r and column i < n it computes, bit for bit as jax.random does
// (jax_threefry_partitionable=True):
//   key  = threefry2x32(base[r], (0, pos[r]))        fold_in(base, pos)
//   key  = threefry2x32(key, (0, 1)) if secondary    the top-p draw's key
//   bits = y0 ^ y1 of threefry2x32(key, (0, i))       jax.random.bits
//   u    = max(tiny, float(bits >> 9 | 0x3f800000) - 1 + tiny)
//   g    = -log(-log(u))                              jax.random.gumbel
// and writes g, u or bits (kind 0, 1, 2). Only `log` may differ from XLA's,
// in its last ulp.
//
// Bound. Per element 74 32-bit integer operations (20 rounds of add,
// rotate and xor, 11 key-injection adds, the output xor, and the shift and
// or of the mantissa trick) and two logs against 4 bytes written:
// operations, at the H100's 64 int32 lanes per SM (132 SMs, 1.98 GHz,
// ~16.7 T ops/s), about 0.011 ms for a 16 x 152,064 draw.
//
// Design: one thread per 4 columns of one row (grid y = row), each thread
// derives the row's key itself (two hashes, cheaper than a barrier), and
// the stores of a warp are contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define AREAL_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  AREAL_ROUND(13) AREAL_ROUND(15) AREAL_ROUND(26) AREAL_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  AREAL_ROUND(17) AREAL_ROUND(29) AREAL_ROUND(16) AREAL_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  AREAL_ROUND(13) AREAL_ROUND(15) AREAL_ROUND(26) AREAL_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  AREAL_ROUND(17) AREAL_ROUND(29) AREAL_ROUND(16) AREAL_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  AREAL_ROUND(13) AREAL_ROUND(15) AREAL_ROUND(26) AREAL_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef AREAL_ROUND

__global__ void __launch_bounds__(kThreads)
    threefry_noise_kernel(const long long* __restrict__ base_keys,  // [R, 2]
                          const long long* __restrict__ positions,  // [R]
                          void* __restrict__ out,                   // [R, n]
                          int n, int secondary, int kind) {
  const int r = blockIdx.y;
  uint32_t k0 = static_cast<uint32_t>(base_keys[2 * r]);
  uint32_t k1 = static_cast<uint32_t>(base_keys[2 * r + 1]);
  uint32_t y0 = 0u, y1 = static_cast<uint32_t>(positions[r]);
  threefry2x32(k0, k1, y0, y1);  // fold_in(base, position)
  k0 = y0;
  k1 = y1;
  if (secondary) {
    y0 = 0u;
    y1 = 1u;
    threefry2x32(k0, k1, y0, y1);  // fold_in(key, 1)
    k0 = y0;
    k1 = y1;
  }
  const float tiny = 1.17549435e-38f;  // FLT_MIN, jax's minval
  const size_t row = static_cast<size_t>(r) * n;
  const int base = blockIdx.x * kThreads * kPerThread + threadIdx.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = base + e * kThreads;
    if (i >= n) break;
    uint32_t x0 = 0u, x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if (kind == 2) {
      static_cast<uint32_t*>(out)[row + i] = bits;
      continue;
    }
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const float u = fmaxf(tiny, __fadd_rn(f, tiny));
    static_cast<float*>(out)[row + i] = kind == 1 ? u : -logf(-logf(u));
  }
}

}  // namespace

// Plain C entry for ctypes. base_keys [R, 2] and positions [R] are int64
// device tensors (uint32 values in the keys); out is [R, n] f32 (kinds 0
// and 1) or 32-bit words (kind 2). Returns the launch's cudaGetLastError().
extern "C" int areal_threefry_noise(const void* base_keys,
                                    const void* positions, void* out, int R,
                                    int n, int secondary, int kind,
                                    void* stream) {
  if (R <= 0 || R > 65535 || n <= 0 || kind < 0 || kind > 2)
    return cudaErrorInvalidValue;
  const int per_block = kThreads * kPerThread;
  const dim3 grid((n + per_block - 1) / per_block, R);
  threefry_noise_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(base_keys),
      static_cast<const long long*>(positions), out, n, secondary, kind);
  return cudaGetLastError();
}

extern "C" const char* areal_threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
