"""Pairwise reward-model training, Bradley-Terry (counterpart of
`areal_tpu/engine/rw/rw_engine.py`).

Each training sample is a (chosen, rejected) pair; the model is the
critic (a scalar value head), and the loss is
-log sigmoid(score_chosen - score_rejected) with each score read at its
sequence's last token. Pairs stay whole through micro-batching
(`MicroBatchSpec.granularity` 2, the mechanism that keeps GRPO groups
together), so in a packed micro-batch pair k is segments (2k, 2k+1).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.api.cli_args import TrainEngineConfig
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.utils import stats_tracker


def rw_pairwise_loss(values, mb: dict[str, Any]):
    """Packed Bradley-Terry loss (JAX :30).

    `rw_seq_end` marks each sequence's last real token (built on the host,
    so the pad tail carries none). Segment k belongs to pair k // 2, with
    sign + for chosen (even k) and - for rejected (odd k); a pair counts
    only with exactly two end markers, which leaves out the pad segment
    and a pair missing a half. The pair count is bounded by the stream's
    length, T // 2 + 1 as in JAX, which needs no read of the segment ids
    on the host."""
    seg = mb["segment_ids"].long()
    ends = mb["rw_seq_end"]
    is_end = ends.to(values.dtype)
    pair = seg // 2
    sign = 1.0 - 2.0 * (seg % 2).to(values.dtype)
    K = seg.shape[0] // 2 + 1
    diff = torch.zeros(K, dtype=values.dtype, device=values.device).index_add_(
        0, pair, values * is_end * sign)
    cnt = torch.zeros(K, dtype=torch.int32, device=values.device).index_add_(
        0, pair, ends.to(torch.int32))
    valid = (cnt == 2).to(values.dtype)
    return -(F.logsigmoid(diff) * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _identity_hook(v, mb):
    return v


def _attach_seq_end(data: dict[str, Any]) -> dict[str, Any]:
    """Add the `[B, T]` end-of-sequence marker read from attention_mask."""
    am = np.asarray(data["attention_mask"])
    B = am.shape[0]
    lens = am.sum(-1).astype(np.int64)
    end = np.zeros_like(am)
    end[np.arange(B), np.clip(lens - 1, 0, None)] = 1
    out = dict(data)
    out["rw_seq_end"] = end
    return out


def _pair_weight(mb: dict[str, Any]) -> float:
    """A micro-batch's pairs, its share of the batch's mean loss."""
    return float(np.asarray(mb["rw_seq_end"]).sum() / 2)


class TorchRWEngine(TorchTrainEngine):
    """Reward-model engine (JAX `JaxRWEngine`): `is_critic` forced on and
    `mb_spec.granularity` made even, so pairs never split."""

    def __init__(self, config: TrainEngineConfig, device: str | torch.device | None = None):
        if not config.is_critic:
            config = dataclasses.replace(config, is_critic=True)
        if config.mb_spec.granularity % 2 != 0:
            config = dataclasses.replace(
                config, mb_spec=dataclasses.replace(config.mb_spec, granularity=2))
        super().__init__(config, device=device)

    def train_rw(self, data: dict[str, Any]) -> dict[str, float]:
        """One optimizer step on a padded pair batch: rows (2i, 2i+1) are
        the (chosen, rejected) halves of pair i."""
        if data["input_ids"].shape[0] % 2 != 0:
            raise ValueError("an RW batch holds pairs: an even number of rows")
        data = _attach_seq_end(data)
        self.train()
        stat = self.train_batch(data, loss_fn=rw_pairwise_loss, loss_weight_fn=_pair_weight)
        stats_tracker.scalar(**{f"rw_{k}": v for k, v in stat.items()})
        return stat

    def eval_rw(self, data: dict[str, Any]) -> float:
        data = _attach_seq_end(data)
        self.eval()
        return self.eval_batch(data, loss_fn=rw_pairwise_loss, loss_weight_fn=_pair_weight)

    def compute_scores(self, data: dict[str, Any]) -> np.ndarray:
        """Per-sequence scores: the value at each sequence's last real
        token."""
        self.eval()
        flat = self.forward(input_=data, post_hook=_identity_hook, aggregate_fn=list)
        lens = np.asarray(data["attention_mask"]).sum(-1).astype(np.int64)
        return np.array([float(np.asarray(seq)[n - 1]) for seq, n in zip(flat, lens)],
                        dtype=np.float32)
