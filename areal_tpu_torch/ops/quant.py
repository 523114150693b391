"""Symmetric absmax int8 quantization, axis-generic (counterpart of
`areal_tpu/ops/quant.py`): the one scheme of the int8 KV pool and of the
int8 weights.

    scale = max(|x|, axes) / 127        (1.0 when the slice is all zero,
                                         so dequantization is always finite)
    q     = round(x / scale) clipped to [-127, 127], int8
    dehat = q * scale

KV quantization reduces over the trailing head_dim (one scale per token
row per kv head); weight quantization over a kernel's contraction axes
(one scale per output channel), which lets the matmul fold the scale in
after it accumulates in f32:

    (x @ q) * scale  ==  x @ (q * scale)      [exactly, in real arithmetic]

The op sequence is the JAX one (f32 upcast, abs, amax, where, a division
`x / scale`, round, clip, int8 cast). `torch.round` rounds half to even,
as `jnp.round` does, so on the same f32 input the int8 values and scales
equal the JAX package's bit for bit.
"""

from __future__ import annotations

import torch

INT8_QMAX = 127.0


def _as_axes(axis) -> tuple[int, ...]:
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _expand(scale: torch.Tensor, axes: tuple[int, ...], ndim: int) -> torch.Tensor:
    """Re-insert the reduced axes as size-1 dims (`jnp.expand_dims`)."""
    for a in sorted(a % ndim for a in axes):
        scale = scale.unsqueeze(a)
    return scale


def quantize_absmax(
    x: torch.Tensor, axis: int | tuple[int, ...] = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """fp tensor -> (int8 values, f32 scales reduced over `axis`).

    `axis` is the reduction axis or axes of the absmax: those dims are
    dropped from the scale tensor. An all-zero slice gets scale 1.0, so
    its dequantized slice is an exact zero."""
    axes = _as_axes(axis)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axes)
    scale = torch.where(amax > 0.0, amax / INT8_QMAX, 1.0)
    q = torch.clamp(
        torch.round(xf / _expand(scale, axes, x.dim())), -INT8_QMAX, INT8_QMAX
    )
    return q.to(torch.int8), scale.float()


def quantize_absmax_compiled(
    x: torch.Tensor, axis: int | tuple[int, ...] = -1
) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_absmax` as XLA compiles the JAX version under `jit`, where
    it folds the division `amax / 127` into a product with the f32
    reciprocal (scales then differ from the eager ones by an ulp, and a
    few int8 values by one). The JAX trainer quantizes its int8 weight
    push under `jit` (`jax_engine.py:1037`); the port's push uses this to
    send the same bytes."""
    axes = _as_axes(axis)
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=axes)
    recip = torch.tensor(1.0 / INT8_QMAX, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0.0, amax * recip, 1.0)
    q = torch.clamp(
        torch.round(xf / _expand(scale, axes, x.dim())), -INT8_QMAX, INT8_QMAX
    )
    return q.to(torch.int8), scale.float()


def dequantize_absmax(
    q: torch.Tensor,
    scale: torch.Tensor,
    dtype: torch.dtype,
    axis: int | tuple[int, ...] = -1,
) -> torch.Tensor:
    """(int8, f32 scales) -> fp tensor in `dtype`; `axis` as in quantize."""
    return (q.float() * _expand(scale, _as_axes(axis), q.dim())).to(dtype)
