"""Padded and packed batches, micro-batch splitting, reward/advantage
normalization, and the rollout side's padding and concatenation (a copy
of the parts of `areal_tpu/utils/data.py` the GRPO loop runs, :83-130,
:131-311, :319, :429, :457).

A batch is a dict of numpy arrays on the host: padded `[B, T]` with an
`attention_mask`, or packed 1-D with `cu_seqlens`. Packing pads the token
stream to a multiple of 128 with one extra sequence: the pad tail is its
own segment, so the model attends within it like any other sequence and
the loss mask keeps it out of every loss.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import MicroBatchSpec, NormConfig
from areal_tpu_torch.utils import datapack


def pad_sequences_to_tensors(
    sequences: list[dict[str, Any]], pad_value: float = 0.0
) -> dict[str, np.ndarray]:
    """Stack a list of variable-length 1-D sample dicts into padded [B, T]
    arrays + attention_mask."""
    if not sequences:
        return {}
    max_len = max(len(seq["input_ids"]) for seq in sequences)
    out: dict[str, list] = {}
    for seq in sequences:
        seq_len = len(seq["input_ids"])
        for k, v in seq.items():
            arr = np.asarray(v)
            if arr.ndim >= 1 and arr.shape[0] == seq_len:
                pad_width = [(0, max_len - seq_len)] + [(0, 0)] * (arr.ndim - 1)
                padded = np.pad(arr, pad_width, constant_values=pad_value)
            else:
                padded = arr
            out.setdefault(k, []).append(padded)
        mask = np.zeros(max_len, dtype=bool)
        mask[:seq_len] = True
        out.setdefault("attention_mask", []).append(mask)
    return {k: np.stack(v) for k, v in out.items()}


def concat_padded_tensors(
    tensor_dicts: list[dict[str, np.ndarray]], pad_value: float = 0.0
) -> dict[str, np.ndarray]:
    """Concatenate padded batches along the batch dim, re-padding every
    sequence-shaped array to the common max length."""
    if not tensor_dicts:
        return {}
    max_len = max(d["attention_mask"].shape[1] for d in tensor_dicts)
    keys = tensor_dicts[0].keys()
    if any(d.keys() != keys for d in tensor_dicts):
        raise ValueError("inconsistent batch keys")
    out: dict[str, list] = {k: [] for k in keys}
    for d in tensor_dicts:
        cur_len = d["attention_mask"].shape[1]
        for k, v in d.items():
            v = np.asarray(v)
            if v.ndim >= 2 and v.shape[1] == cur_len:
                pad_width = [(0, 0), (0, max_len - cur_len)] + [(0, 0)] * (v.ndim - 2)
                fill = 0 if k == "attention_mask" else pad_value
                v = np.pad(v, pad_width, constant_values=fill)
            out[k].append(v)
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


def cycle_dataloader(dataloader):
    """Infinite iterator over a (re-shuffling) dataloader."""
    while True:
        yield from dataloader


def pack_tensor_dict(data: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Padded [B, T] -> packed 1-D layout with cu_seqlens (int32 [B+1]) and
    max_seqlen. Values shaped [B, T, ...] are flattened to
    [total_tokens, ...]; everything else passes through."""
    mask = data["attention_mask"].astype(bool)
    bsz, _ = mask.shape
    lens = mask.sum(axis=1).astype(np.int32)
    cu_seqlens = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    out: dict[str, Any] = {}
    for k, v in data.items():
        if k == "attention_mask":
            continue
        v = np.asarray(v)
        if v.ndim >= 2 and v.shape[:2] == mask.shape:
            out[k] = v[mask]
        else:
            out[k] = v
    out["cu_seqlens"] = cu_seqlens
    out["max_seqlen"] = int(lens.max()) if bsz else 0
    return out


def unpack_sequence(packed, cu_seqlens: np.ndarray) -> list:
    """Packed 1-D array -> list of per-sequence arrays."""
    return [
        packed[cu_seqlens[i] : cu_seqlens[i + 1]] for i in range(len(cu_seqlens) - 1)
    ]


def pad_packed_tensor_dict(
    data: dict[str, Any],
    pad_to_length: int | None = None,
    pad_to_multiple: int = 128,
    pad_token: int = 0,
) -> tuple[dict[str, Any], int]:
    """Pad a packed batch's token stream to a multiple of `pad_to_multiple`
    by appending one fake sequence of pad tokens (an extra cu_seqlens
    entry). Returns (padded_dict, pad_len)."""
    cu_seqlens = data["cu_seqlens"]
    total = int(cu_seqlens[-1])
    if pad_to_length is None:
        pad_to_length = ((total + pad_to_multiple - 1) // pad_to_multiple) * pad_to_multiple
        pad_to_length = max(pad_to_length, pad_to_multiple)
    if pad_to_length < total:
        raise ValueError(f"pad_to_length {pad_to_length} < total tokens {total}")
    pad_len = pad_to_length - total
    out: dict[str, Any] = {}
    for k, v in data.items():
        if k == "cu_seqlens":
            out[k] = (
                np.concatenate([cu_seqlens, [pad_to_length]]).astype(np.int32)
                if pad_len > 0
                else cu_seqlens
            )
        elif k == "max_seqlen":
            out[k] = max(int(v), pad_len)
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == total:
            pad_width = [(0, pad_len)] + [(0, 0)] * (v.ndim - 1)
            value = pad_token if k == "input_ids" else 0
            out[k] = np.pad(v, pad_width, constant_values=value)
        else:
            out[k] = v
    return out, pad_len


@dataclass
class MicroBatchList:
    """A padded batch split into packed micro-batches."""

    data: dict[str, Any]
    mbs: list[dict[str, Any]]
    group_lens: list[int] = field(default_factory=list)
    # sample indices of the original batch in each micro-batch
    forward_indices: list[list[int]] = field(default_factory=list)
    padded_to: list[int] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.mbs)


def split_padded_tensor_dict_into_mb_list(
    data: dict[str, np.ndarray],
    mb_spec: MicroBatchSpec,
    pad_to_multiple: int = 128,
) -> MicroBatchList:
    """Split a padded batch into FFD-balanced packed micro-batches under a
    token budget. Groups of `mb_spec.granularity` adjacent samples stay
    together; each micro-batch is packed and padded."""
    mask = data["attention_mask"].astype(bool)
    bsz = mask.shape[0]
    g = max(mb_spec.granularity, 1)
    if bsz % g != 0:
        raise ValueError(f"batch size {bsz} not divisible by granularity {g}")
    group_lens = mask.reshape(bsz // g, g, -1).sum(axis=(1, 2)).astype(np.int64)

    if mb_spec.max_tokens_per_mb is not None:
        capacity = mb_spec.max_tokens_per_mb
    else:
        capacity = int(group_lens.sum()) + 1
    min_groups = mb_spec.n_mbs or 1
    bins = datapack.ffd_allocate(list(group_lens), capacity, min_groups=min_groups)

    mbs, fwd_indices, padded_to = [], [], []
    for b in bins:
        sample_idx = datapack.flat2d([list(range(gi * g, (gi + 1) * g)) for gi in b])
        sub = {k: np.asarray(v)[sample_idx] for k, v in data.items()
               if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == bsz}
        packed = pack_tensor_dict(sub)
        packed, pad_len = pad_packed_tensor_dict(packed, pad_to_multiple=pad_to_multiple)
        mbs.append(packed)
        fwd_indices.append(sample_idx)
        padded_to.append(pad_len)
    return MicroBatchList(
        data=data,
        mbs=mbs,
        group_lens=[int(x) for x in group_lens],
        forward_indices=fwd_indices,
        padded_to=padded_to,
    )


class Normalization:
    """Reward/advantage normalization with independent mean/std levels
    ("batch" | "group" | None), leave-one-out means and unbiased std, on
    the host over the whole batch."""

    def __init__(self, config: NormConfig):
        if config.mean_level not in {"batch", "group", None}:
            raise ValueError(f"bad mean_level {config.mean_level}")
        if config.std_level not in {"batch", "group", None}:
            raise ValueError(f"bad std_level {config.std_level}")
        self.mean_level = config.mean_level
        self.mean_leave1out = config.mean_leave1out
        self.std_level = config.std_level
        self.std_unbiased = config.std_unbiased
        self.group_size = config.group_size
        self.eps = config.eps

    def __call__(
        self, x: np.ndarray, loss_mask: np.ndarray | None = None
    ) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if loss_mask is not None:
            loss_mask = np.asarray(loss_mask, dtype=np.float64)
            if loss_mask.sum() == 0:
                return x.astype(np.float32)

        mean = self._mean_at_level(x, loss_mask)
        x_centered = x - mean
        if loss_mask is not None:
            x_centered = x_centered * loss_mask

        if self.std_level is None:
            std, eps = np.ones_like(x), 0.0
        else:
            std, eps = self._std_at_level(x, loss_mask, mean), self.eps
        return (x_centered / (std + eps)).astype(np.float32)

    def _mean_at_level(self, x, mask):
        if self.mean_level is None:
            return np.zeros_like(x)
        if self.mean_level == "batch":
            return self._mean(x, mask, self.mean_leave1out)
        out = np.zeros_like(x)
        for i in range(x.shape[0] // self.group_size):
            s = slice(i * self.group_size, (i + 1) * self.group_size)
            m = mask[s] if mask is not None else None
            if self.group_size == 1 and self.mean_leave1out:
                out[s] = 0.0
            else:
                out[s] = self._mean(x[s], m, self.mean_leave1out)
        return out

    @staticmethod
    def _mean(x, mask, leave_one_out):
        if mask is None:
            factor = x.size
            x_masked = x
        else:
            x_masked = x * mask
            factor = mask.sum()
        total = x_masked.sum()
        if leave_one_out:
            if factor <= 1:
                return np.zeros_like(x)
            if mask is None:
                return (total - x) / (factor - 1)
            loo = (total - x_masked) / np.clip(factor - mask, 1.0, None)
            return np.where(mask > 0, loo, total / factor)
        if factor == 0:
            return np.zeros_like(x)
        return np.full_like(x, total / factor)

    def _std_at_level(self, x, mask, mean):
        if self.std_level == "batch":
            return self._std(x, mask, mean, self.std_unbiased)
        out = np.zeros_like(x)
        for i in range(x.shape[0] // self.group_size):
            s = slice(i * self.group_size, (i + 1) * self.group_size)
            m = mask[s] if mask is not None else None
            if self.group_size == 1 and self.std_unbiased:
                out[s] = 1.0
            else:
                out[s] = self._std(x[s], m, mean[s], self.std_unbiased)
        return out

    @staticmethod
    def _std(x, mask, mean, unbiased):
        if mask is None:
            factor = x.size
            centered = x - mean
        else:
            factor = mask.sum()
            centered = x * mask - mean * mask
        ssq = (centered**2).sum()
        if unbiased:
            if factor <= 1:
                return np.ones_like(x)
            return np.full_like(x, np.sqrt(ssq / (factor - 1)))
        if factor == 0:
            return np.ones_like(x)
        return np.full_like(x, np.sqrt(ssq / factor))


class KLEstimator:
    """Schulman k1/k2/k3 approximate KL, on numpy arrays or torch tensors."""

    def __init__(self, kl_estimator: str = "k1", apply_clamp: bool = True):
        if kl_estimator not in ("k1", "k2", "k3"):
            raise ValueError(f"invalid KL estimator {kl_estimator}")
        self.kl_estimator = kl_estimator
        self.apply_clamp = apply_clamp

    def __call__(self, log_probs, log_probs_base):
        lr = log_probs - log_probs_base
        if self.kl_estimator == "k2":
            lr = lr**2 / 2.0
        elif self.kl_estimator == "k3":
            neg = -lr
            exp = torch.exp if isinstance(lr, torch.Tensor) else np.exp
            lr = exp(neg) - 1 - neg
        if self.apply_clamp:
            lr = lr.clip(-10.0, 10.0)
        return lr
