"""Supervised fine-tuning engine (counterpart of
`areal_tpu/engine/sft/lm_engine.py`).

`compute_packed_sft_loss` is the packed causal-LM objective: token t
predicts token t+1 within its segment, and `loss_mask` picks the answer
tokens. The loss is normalised per micro-batch; `train_lm` hands
`train_batch` the count of trained tokens as each micro-batch's weight
(`sft_loss_weight`), so the normalisation is global over the batch.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from areal_tpu_torch.engine.torch_engine import TorchTrainEngine, fused_lm_loss_enabled
from areal_tpu_torch.models.qwen2 import segment_ids_from_cu_seqlens
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.functional import label_logprobs_of


def compute_packed_sft_loss(logits, mb: dict[str, Any]):
    """Next-token NLL over packed segments (JAX :22): position t is
    trained iff t+1 is in its segment and `loss_mask[t+1]` is set; the last
    position of each segment has no next token."""
    labels = torch.roll(mb["input_ids"], -1)
    seg = mb["segment_ids"]
    same_seg = torch.roll(seg, -1) == seg
    valid = same_seg & torch.roll(mb["loss_mask"].bool(), -1)
    logprobs = label_logprobs_of(logits, labels)
    n = torch.clamp(valid.sum(), min=1)
    return -torch.where(valid, logprobs, 0.0).sum() / n


def compute_packed_sft_loss_fused(head, mb: dict[str, Any]):
    """The same objective through the fused vocab-chunked head (`head` an
    `LMHead`): no [T, V] logits in either pass (JAX :41)."""
    return compute_packed_sft_loss(head, mb)


compute_packed_sft_loss_fused.hidden_loss = True


def sft_loss_weight(mb: dict[str, Any]) -> float:
    """Trained tokens of a micro-batch, for the global normalisation (JAX
    :50). It reads the host-side packed dict, before the engine adds
    `segment_ids`, so the segments come from `cu_seqlens`."""
    if "segment_ids" in mb:
        seg = np.asarray(mb["segment_ids"])
    else:
        cu = np.asarray(mb["cu_seqlens"])
        seg = segment_ids_from_cu_seqlens(cu, int(cu[-1]))
    mask = np.asarray(mb["loss_mask"]).astype(bool)
    same_seg = np.roll(seg, -1) == seg
    return float((same_seg & np.roll(mask, -1)).sum())


class LMEngine:
    """Thin SFT wrapper over a train engine (JAX :68)."""

    def __init__(self, engine: TorchTrainEngine):
        self.engine = engine

    def _loss_fn(self):
        if fused_lm_loss_enabled(self.engine):
            return compute_packed_sft_loss_fused
        return compute_packed_sft_loss

    def train_lm(self, data: dict[str, Any]) -> dict[str, float]:
        stats = self.engine.train_batch(data, self._loss_fn(), sft_loss_weight)
        stats_tracker.scalar(**{f"sft/{k}": v for k, v in stats.items()})
        return stats

    def evaluate_lm(self, data: dict[str, Any]) -> float:
        return self.engine.eval_batch(data, self._loss_fn(), sft_loss_weight)


class TorchLMEngine(TorchTrainEngine):
    """Train engine with the SFT methods (the counterpart of
    `JaxLMEngine`, :94)."""

    def train_lm(self, data: dict[str, Any]) -> dict[str, float]:
        return LMEngine(self).train_lm(data)

    def evaluate_lm(self, data: dict[str, Any]) -> float:
        return LMEngine(self).evaluate_lm(data)
