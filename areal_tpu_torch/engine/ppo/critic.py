"""PPO critic: value prediction and value-clipped regression updates
(counterpart of `areal_tpu/engine/ppo/critic.py`).

The critic is the actor's decoder trunk ending in a scalar value head
(`ModelConfig.is_critic`). `compute_values` fills `data["values"]`, which
the actor's GAE reads (`PPOActor.compute_advantages`), and `ppo_update`
regresses the values onto `data["returns"]` over `ppo_n_minibatches`
minibatches, one optimizer step each.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import PPOCriticConfig
from areal_tpu_torch.api.engine_api import TrainEngine
from areal_tpu_torch.engine.ppo.actor import _split_minibatches
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.functional import ppo_critic_loss_fn

# the actor's keys, which the critic's update does not read (JAX :56-62)
_ACTOR_KEYS = ("rewards", "tot_rewards", "kl_rewards", "versions", "advantages", "prox_logp",
               "logprobs", "ref_logp")


def _value_hook(values, mb):
    return values


class PPOCritic:
    def __init__(self, config: PPOCriticConfig, engine: TrainEngine):
        self.config = config
        self.engine = engine
        self._loss_fn = functools.partial(critic_loss_fn, value_eps_clip=config.eps_clip)
        self._loss_fn.returns_aux = True  # value_clip_ratio through the engine's stats

    def compute_values(self, data: dict[str, Any]) -> np.ndarray:
        """Token values under the current weights, re-padded to `[B, T]`."""
        self.engine.eval()
        flat = self.engine.forward(input_=data, post_hook=_value_hook, aggregate_fn=list)
        B, T = data["input_ids"].shape
        out = np.zeros((B, T), dtype=np.float32)
        for i, seq in enumerate(flat):
            out[i, : len(seq)] = np.asarray(seq)
        return out

    def ppo_update(self, data: dict[str, Any]) -> list[dict[str, float]]:
        """Value regression over `ppo_n_minibatches` minibatches, on the
        batch after `PPOActor.compute_advantages` (`values`, `returns` and
        the rolled `loss_mask` set). Each minibatch's stats go to the
        tracker as `critic_<name>`."""
        data = {k: v for k, v in data.items() if k not in _ACTOR_KEYS}
        self.engine.train()
        all_stats = []
        for mb in _split_minibatches(data, self.config.ppo_n_minibatches):
            train_stat = self.engine.train_batch(
                mb,
                loss_fn=self._loss_fn,
                loss_weight_fn=lambda x: float(np.asarray(x["loss_mask"]).sum()),
            )
            stats_tracker.scalar(**{f"critic_{k}": v for k, v in train_stat.items()})
            all_stats.append(stats_tracker.export_all())
        return all_stats


def critic_loss_fn(values, mb: dict[str, Any], value_eps_clip: float):
    """Packed critic loss: the value update clipped around the old values
    (JAX :88). Returns (loss, stats); the engine averages the clip
    fraction into the update's stats."""
    loss, stat = ppo_critic_loss_fn(
        value=values,
        old_value=mb["values"],
        target_value=mb["returns"],
        value_eps_clip=value_eps_clip,
        loss_mask=mb["loss_mask"],
    )
    n = torch.clamp(mb["loss_mask"].bool().sum(), min=1)
    # the clip mask arrives masked by ppo_critic_loss_fn
    return loss, dict(value_clip_ratio=stat["clip_mask"].sum() / n)


class TorchPPOCritic(TorchTrainEngine):
    """Train engine and critic algorithms in one object (JAX
    `JaxPPOCritic`); its config's `is_critic` is forced on."""

    def __init__(self, config: PPOCriticConfig, device: str | torch.device | None = None):
        if not config.is_critic:
            config = dataclasses.replace(config, is_critic=True)
        super().__init__(config, device=device)
        self.critic = PPOCritic(config, self)

    def compute_values(self, *args, **kwargs) -> np.ndarray:
        return self.critic.compute_values(*args, **kwargs)

    def ppo_update(self, *args, **kwargs) -> list[dict[str, float]]:
        return self.critic.ppo_update(*args, **kwargs)
