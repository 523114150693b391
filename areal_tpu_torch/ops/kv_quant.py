"""Int8 KV quantization, shared by every writer and reader of the pool
(counterpart of `areal_tpu/ops/kv_quant.py`): symmetric per-row,
per-kv-head absmax int8 (`ops/quant.py`).

Storage layout, per K and per V, as in the JAX package:

    data   [L, n_blocks, block_size, nKV, hd]   int8
    scales [L, n_blocks, nKV, block_size]       f32

The scale pool is paged exactly like the data pool (same block ids, same
block tables). The kv head sits before the page row, so the kernel reads
the scales of one (block, head) as `block_size` contiguous floats.

Pool operands travel as a bare tensor (fp) or a `(data, scales)` tuple
(int8); `split_pool` / `join_pool` convert between the two forms.
"""

from __future__ import annotations

import torch

from areal_tpu_torch.ops.quant import (  # noqa: F401 — INT8_QMAX re-exported
    INT8_QMAX,
    dequantize_absmax,
    quantize_absmax,
)

# TorchDecodeConfig.kv_dtype values: "fp" stores kv_cache_dtype verbatim,
# "int8" stores the paged pool in this module's scheme
KV_DTYPES = ("fp", "int8")


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp rows [..., hd] -> (int8 values [..., hd], f32 scales [...]): one
    scale per (token row, kv head); an all-zero row gets scale 1.0."""
    return quantize_absmax(x, axis=-1)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """(int8 [..., hd], f32 [...]) -> fp [..., hd] in `dtype`."""
    return dequantize_absmax(q, scale, dtype, axis=-1)


def split_pool(pool):
    """Pool operand -> (data, scales); scales is None on the fp path."""
    if isinstance(pool, tuple):
        return pool
    return pool, None


def join_pool(data, scales):
    """Inverse of split_pool: the operand form `data` came in."""
    return data if scales is None else (data, scales)


def scales_rowmajor(scales: torch.Tensor) -> torch.Tensor:
    """Scale blocks [..., nb, nKV, bsz] -> row-major [..., nb*bsz, nKV],
    aligned with a gathered [..., nb*bsz, nKV, hd] data workspace."""
    *lead, nb, nkv, bsz = scales.shape
    return scales.transpose(-1, -2).reshape(*lead, nb * bsz, nkv)


def scales_blocked(rows: torch.Tensor, nb: int, bsz: int) -> torch.Tensor:
    """Inverse of scales_rowmajor: [..., nb*bsz, nKV] -> [..., nb, nKV, bsz]."""
    *lead, _, nkv = rows.shape
    return rows.reshape(*lead, nb, bsz, nkv).transpose(-1, -2)
