"""Int8-weight dequant-matmul (counterpart of `areal_tpu/ops/quant_matmul.py`).

Weight serving stores the dense transformer kernels as per-output-channel
symmetric absmax int8 (`ops/quant.py`): int8 data in the kernel's own
shape plus one f32 scale per output channel. `quant_einsum` keeps the JAX
shape contract (:120-155): the weight's contraction axes lead, x's trail,
so both collapse to a 2-D `[T, K] @ [K, N]` with the scale per column.

On a CUDA tensor it launches the hand-written Hopper kernel
(`csrc/quant_matmul.cu`, the port of `_quant_matmul_kernel`) or raises; on
a CPU tensor it runs `quant_matmul_ref`, the plain version
(`_quant_matmul_xla`, :107-117). The JAX package falls back to XLA when K
or N is not a multiple of 128; the kernel masks ragged T, K and N itself,
so there is no fallback here.

`launches` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from areal_tpu_torch.ops import _build

TILE_N = 128  # output columns per block (csrc/quant_matmul.cu kBN)
TILE_K = 64  # depth of one pipeline stage (kBK)
# blocks a launch aims for: up to 4 small-T blocks fit on one SM at once
# (46 KB of shared memory each), and one block's 4 warps alone cannot hide
# the latency of its loads
_BLOCKS_PER_SM = 4
_MIN_TILES_PER_SPLIT = 2  # 128 deep: a split's partial tile is 1/16 of its weight bytes at T 16

# kernel launches since the process started (or the last reset to 0)
launches = 0

_lib: ctypes.CDLL | None = None
_counters: dict[torch.device, torch.Tensor] = {}


def quant_matmul_ref(x2, q2, s_row, out_dtype):
    """Plain version, `_quant_matmul_xla` op for op: dequantize the whole
    weight in f32 (`q * scale`), multiply with f32 x, cast to `out_dtype`."""
    w = q2.float() * s_row[None, :]
    return (x2.float() @ w).to(out_dtype)


@functools.lru_cache(maxsize=4096)
def plan(T: int, K: int, N: int, n_sms: int) -> tuple[int, int, int]:
    """(row fragments of 16 per block, splits of K, 64-deep k tiles per
    split) of one launch: 16 rows per block when T <= 16 (decode), else 64;
    K split across blocks only when the output tiles are fewer than
    `_BLOCKS_PER_SM` per SM, then into enough splits for that many blocks,
    each split at least `_MIN_TILES_PER_SPLIT` k tiles deep."""
    mt = 1 if T <= 16 else 4
    tiles = -(-N // TILE_N) * -(-T // (16 * mt))
    k_tiles = -(-K // TILE_K)
    if tiles >= _BLOCKS_PER_SM * n_sms:
        return mt, 1, k_tiles
    want = -(-_BLOCKS_PER_SM * n_sms // tiles)
    splits = max(1, min(want, k_tiles // _MIN_TILES_PER_SPLIT))
    per = -(-k_tiles // splits)
    return mt, -(-k_tiles // per), per


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("quant_matmul")
        lib.areal_quant_matmul.argtypes = [
            ctypes.c_void_p,  # x
            ctypes.c_void_p,  # w (int8)
            ctypes.c_void_p,  # scale
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # split-K partials
            ctypes.c_void_p,  # split-K tile counters
            ctypes.c_int,  # T
            ctypes.c_int,  # K
            ctypes.c_int,  # N
            ctypes.c_int,  # mt
            ctypes.c_int,  # splits
            ctypes.c_int,  # tiles per split
            ctypes.c_int,  # x rows 16-byte aligned
            ctypes.c_int,  # w rows 16-byte aligned
            ctypes.c_int,  # is_bf16
            ctypes.c_void_p,  # stream
        ]
        lib.areal_quant_matmul.restype = ctypes.c_int
        lib.areal_quant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.areal_quant_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _tile_counters(dev: torch.device, n: int) -> torch.Tensor:
    """One int per output tile, zero between launches (each launch leaves
    the counters it used at 0). Grows, never shrinks."""
    buf = _counters.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _counters[dev] = buf
    return buf


def _check(x2, q2, s_row) -> None:
    for name, t in dict(x=x2, q=q2, scale=s_row).items():
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x2.dtype}: the kernel takes float32 or bfloat16")
    if q2.dtype != torch.int8:
        raise TypeError(f"weight dtype {q2.dtype}, need int8")
    if s_row.dtype != torch.float32:
        raise TypeError(f"scale dtype {s_row.dtype}, need float32")
    if x2.dim() != 2 or q2.dim() != 2 or s_row.dim() != 1:
        raise ValueError("x [T, K], weight [K, N], scale [N]")
    if q2.shape[0] != x2.shape[1] or s_row.shape[0] != q2.shape[1]:
        raise ValueError(
            f"x {tuple(x2.shape)}, weight {tuple(q2.shape)}, scale {tuple(s_row.shape)}"
        )


def quant_matmul(x2, q2, s_row):
    """`[T, K] @ int8 [K, N]` times `scale [N]`, in x's dtype: the kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    global launches
    if x2.device.type == "cpu":
        return quant_matmul_ref(x2, q2, s_row, x2.dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x2.device}")
    _check(x2, q2, s_row)
    T, K = x2.shape
    N = q2.shape[1]
    out = torch.empty((T, N), dtype=x2.dtype, device=x2.device)
    if T == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    mt, splits, per = plan(T, K, N, _n_sms(x2.device))
    part = counters = None
    if splits > 1:
        part = torch.empty((splits, T, N), dtype=torch.float32, device=x2.device)
        counters = _tile_counters(x2.device, -(-N // TILE_N) * -(-T // (16 * mt)))
    lib = _kernel_lib()
    x_vec = K % (16 // x2.element_size()) == 0 and x2.data_ptr() % 16 == 0
    w_vec = N % 16 == 0 and q2.data_ptr() % 16 == 0
    err = lib.areal_quant_matmul(
        x2.data_ptr(), q2.data_ptr(), s_row.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        T, K, N, mt, splits, per, int(x_vec), int(w_vec),
        int(x2.dtype == torch.bfloat16),
        torch.cuda.current_stream(x2.device).cuda_stream,
    )
    if err != 0:
        msg = lib.areal_quant_matmul_error_string(err).decode()
        raise RuntimeError(f"quant matmul kernel launch failed: {msg} ({err})")
    launches += 1
    return out


def quant_einsum(x, w_q, w_scale, n_contract: int, *, matmul=quant_matmul):
    """einsum(x, dequant(w_q, w_scale)) contracting w's leading `n_contract`
    axes with x's trailing `n_contract` axes (the JAX contract): returns
    x's batch dims + w's output dims, in x's dtype. `matmul` is the 2-D
    product (`quant_matmul`, or a plain version a check swaps in)."""
    k_dims = tuple(w_q.shape[:n_contract])
    out_dims = tuple(w_q.shape[n_contract:])
    if tuple(x.shape[x.dim() - n_contract:]) != k_dims:
        raise ValueError(
            f"x contraction dims {tuple(x.shape[x.dim() - n_contract:])} != "
            f"weight contraction dims {k_dims}"
        )
    kk, nn = math.prod(k_dims), math.prod(out_dims)
    batch = tuple(x.shape[: x.dim() - n_contract])
    x2 = x.reshape(math.prod(batch) if batch else 1, kk).contiguous()
    out2 = matmul(x2, w_q.reshape(kk, nn), w_scale.reshape(nn))
    return out2.reshape(*batch, *out_dims)


def quant_einsum_ref(x, w_q, w_scale, n_contract: int):
    """`quant_einsum` through the plain version on any device (no launch):
    what a check swaps in to compare a path with the kernel's."""
    return quant_einsum(
        x, w_q, w_scale, n_contract,
        matmul=lambda x2, q2, s_row: quant_matmul_ref(x2, q2, s_row, x2.dtype),
    )
