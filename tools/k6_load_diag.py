"""Where the bf16 int8-matmul kernel (K6) loses time against a bare stream.

Run from the repository root on a machine with one H100 and the CUDA
toolkit:

    python3 tools/k6_load_diag.py

It times, on the device alone, at Qwen2.5-7B's gate (3584 x 18944) and
down (18944 x 3584) int8 weights and T 16, four kernels that stream the
same weights in the same 64 x 128-byte units and even split:

- `stream`: a bare cp.async stream (4 stages, no compute, no output);
- `loads_only`: `quant_matmul_sk_kernel` built with `QMM_DIAG_LOADS_ONLY`,
  its compute replaced by one shared-memory read per stage (loads, x, the
  cut tiles' partials and fix-up, the output);
- `no_handover`: built with `QMM_DIAG_NO_HANDOVER` as well, without the
  partials, the fix-up and the output;
- `kernel`: the kernel itself.

The two reduced copies are built from `areal_tpu_torch/ops/csrc/quant_matmul.cu`
with those macros (`chip_smoke.k6_variants`) and launched through the
wrapper's own plan (`quant_matmul._launch_bf16`). It prints one JSON line
of device ms and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from areal_tpu_torch.ops import _build  # noqa: E402
from areal_tpu_torch.ops import quant_matmul as qm  # noqa: E402

OUT = ROOT / "build" / "k6_diag"
SHAPES = {"gate": (3584, 18944), "down": (18944, 3584)}
T = 16

STREAM_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// 64 x 128-byte units of an int8 [K, N], n-tile major, k fastest, dealt
// evenly over the grid; cp.async in 4 stages of 8 KB; no compute
__global__ void __launch_bounds__(128) stream_k(const int8_t* w, int K, int N, float* sink) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int k_tiles = K / 64, units = k_tiles * (N / 128);
  const int q = units / gridDim.x, r = units % gridDim.x, b = blockIdx.x;
  const int u0 = b * q + min(b, r), n = q + (b < r), tid = threadIdx.x;
  auto load = [&](int st, int u) {
    const int8_t* base = w + (size_t)(u % k_tiles) * 64 * N + (size_t)(u / k_tiles) * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = i * 128 + tid, row = c / 8, ch = c % 8;
      const unsigned s = (unsigned)__cvta_generic_to_shared(smem + st * 8192 + row * 128 + ch * 16);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(base + (size_t)row * N + ch * 16));
    }
  };
  float acc = 0.f;
  for (int s = 0; s < 3; ++s) {
    if (s < n) load(s, u0 + s);
    asm volatile("cp.async.commit_group;\n");
  }
  for (int it = 0; it < n; ++it) {
    asm volatile("cp.async.wait_group 2;\n");
    __syncthreads();
    if (it + 3 < n) load((it + 3) % 4, u0 + it + 3);
    asm volatile("cp.async.commit_group;\n");
    acc += (float)smem[(it % 4) * 8192 + tid * 64];
  }
  asm volatile("cp.async.wait_group 0;\n");
  if (acc == 12345.f) sink[b] = acc;
}
extern "C" int stream_units(const void* w, int K, int N, float* sink, int grid, void* stream) {
  cudaFuncSetAttribute(stream_k, cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * 8192);
  stream_k<<<grid, 128, 4 * 8192, (cudaStream_t)stream>>>((const int8_t*)w, K, N, sink);
  return cudaGetLastError();
}
"""


def _build_lib(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    dev, smi = chip_smoke.phase_device()
    libs = {"kernel": qm._kernel_lib(), **chip_smoke.k6_variants(
        {"loads_only": ("QMM_DIAG_LOADS_ONLY",),
         "no_handover": ("QMM_DIAG_LOADS_ONLY", "QMM_DIAG_NO_HANDOVER")})}
    stream = _build_lib("stream", STREAM_CU)
    stream.stream_units.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_void_p]
    sink = torch.zeros(4096, device=dev)
    rows = {}
    for shape, (K, N) in SHAPES.items():
        ws = [(torch.randint(-127, 128, (K, N), device=dev, dtype=torch.int8),
               torch.rand(N, device=dev) + 0.5) for _ in range(2)]  # 2 x 68 MB: past the L2
        x = torch.randn((T, K), device=dev).to(torch.bfloat16)
        out = torch.empty((T, N), dtype=torch.bfloat16, device=dev)
        p = qm._plan_on(dev, T, K, N)

        def run_stream(i):
            err = stream.stream_units(ws[i % 2][0].data_ptr(), K, N, sink.data_ptr(), p.grid,
                                      torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        ms = {"stream": chip_smoke._time_device(run_stream, 100)}
        for name, lib in libs.items():
            ms[name] = chip_smoke._time_device(
                lambda i, lib=lib: qm._launch_bf16(x, *ws[i % 2], out, p, lib), 100)
        rows[shape] = dict(K=K, N=N, T=T, grid=p.grid, bytes=K * N, ms_device=ms,
                           tb_per_s={k: K * N / (v * 1e9) for k, v in ms.items()})
        del ws
    chip_smoke.emit("k6_load_diag", rows=rows)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
