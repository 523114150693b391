"""PPO/GRPO actor: advantages and decoupled-PPO policy updates
(counterpart of `areal_tpu/engine/ppo/actor.py`, :49-449).

The three phases of a step are the JAX package's:

1. `compute_logp` recomputes token logprobs under the current weights
   (the proximal policy of decoupled PPO);
2. `compute_advantages` shapes rewards (bias, scale, clip, overlong
   penalty, normalization), adds KL-regularised token rewards, runs masked
   GAE and normalizes advantages;
3. `ppo_update` optionally drops all-equal groups, splits the batch into
   `ppo_n_minibatches` token-balanced minibatches and takes one optimizer
   step per minibatch with the clipped decoupled loss.

The reward and advantage shaping is numpy on the host over the padded
`[B, T]` batch, as in the JAX package; GAE runs on the engine's device.
The JAX actor's publish of the consumed-sample counter to name_resolve
belongs to the async executor, which is not in the port yet.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import PPOActorConfig
from areal_tpu_torch.api.engine_api import TrainEngine
from areal_tpu_torch.engine.torch_engine import TorchTrainEngine, fused_lm_loss_enabled
from areal_tpu_torch.ops.gae import gae_padded
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.data import KLEstimator, Normalization
from areal_tpu_torch.utils.datapack import ffd_allocate
from areal_tpu_torch.utils.functional import (
    clamped_entropy_of,
    dynamic_sampling,
    label_logprobs_entropy_of,
    label_logprobs_of,
    ppo_actor_loss_fn,
    reward_overlong_penalty,
)


class PPOActor:
    def __init__(self, config: PPOActorConfig, engine: TrainEngine):
        self.config = config
        self.engine = engine
        self.reward_bias = config.reward_bias
        self.reward_scaling = config.reward_scaling
        self.reward_clip = config.reward_clip
        self.group_size = config.group_size
        self.kl_ctl = config.kl_ctl
        self.kl_estimator = KLEstimator(config.kl_estimator)
        self.adv_norm = Normalization(config.adv_norm) if config.adv_norm else None
        self.reward_norm = Normalization(config.reward_norm) if config.reward_norm else None
        self.discount = config.discount
        self.gae_lambda = config.gae_lambda
        self.mask_no_eos_with_zero = config.mask_no_eos_with_zero
        self.temperature = config.temperature
        self.dynamic_sampling = config.dynamic_sampling
        self.entropy_coeff = config.entropy_coeff
        self._update_steps = 0
        self._loss_fn = functools.partial(
            grpo_loss_fn,
            temperature=config.temperature,
            eps_clip=config.eps_clip,
            eps_clip_higher=config.eps_clip_higher,
            c_clip=config.c_clip,
            behav_imp_weight_cap=config.behav_imp_weight_cap,
            entropy_coeff=config.entropy_coeff,
            entropy_clamp=config.entropy_clamp,
        )
        self._loss_fn.hidden_loss = fused_lm_loss_enabled(engine)
        self._loss_fn.returns_aux = True

    def _calc_logprobs_fn(self, temp: float):
        def calc_logprobs(logits, mb):
            labels = torch.roll(mb["input_ids"], shifts=-1)
            return label_logprobs_of(logits, labels, temp)

        calc_logprobs.hidden_loss = fused_lm_loss_enabled(self.engine)
        return calc_logprobs

    def compute_logp(self, data: dict[str, Any], temperature: float | None = None):
        """Token logprobs under the current weights, `[B, T]` padded;
        logp[t] scores token t+1."""
        temp = self.temperature if temperature is None else temperature
        self.engine.eval()
        flat = self.engine.forward(
            input_=data, post_hook=self._calc_logprobs_fn(temp), aggregate_fn=list
        )
        B, T = data["input_ids"].shape
        out = np.zeros((B, T), dtype=np.float32)
        for i, seq in enumerate(flat):
            out[i, : len(seq)] = np.asarray(seq)
        return out

    def compute_advantages(self, data: dict[str, Any]) -> None:
        """In-place advantage computation on the padded batch dict."""
        cfg = self.config
        if cfg.overlong_reward_penalty:
            data.update(reward_overlong_penalty(
                data,
                overlong_tokens=cfg.overlong_tokens,
                overlong_penalty_factor=cfg.overlong_penalty_factor,
                max_response_length=cfg.max_new_tokens,
            ))

        reward_score = np.asarray(data["rewards"], dtype=np.float32)
        reward_score = (reward_score + self.reward_bias) * self.reward_scaling
        reward_score = np.clip(reward_score, -self.reward_clip, self.reward_clip)
        if self.reward_norm is not None:
            reward_score = self.reward_norm(reward_score[:, None])[:, 0]

        B, T = data["input_ids"].shape
        batch_idx = np.arange(B)
        # roll the loss mask: position t now means "token t+1 is trained"
        loss_mask = np.roll(np.asarray(data["loss_mask"], dtype=np.float32), shift=-1, axis=-1)

        if not cfg.use_decoupled_loss and cfg.recompute_logprob:
            # ignore inference-engine logprobs entirely
            old_logp = data["logprobs"] = np.asarray(data["prox_logp"])
        else:
            old_logp = np.roll(np.asarray(data["logprobs"]), shift=-1, axis=-1)
            if not cfg.use_decoupled_loss:
                data["prox_logp"] = old_logp
        ref_logp = np.asarray(data.get("ref_logp", np.zeros_like(old_logp)), dtype=np.float32)
        ref_logp = ref_logp * loss_mask
        old_logp = old_logp * loss_mask

        attn_mask = np.asarray(data["attention_mask"])
        seqlens = attn_mask.sum(-1).astype(np.int64)
        seq_no_eos_mask = (seqlens == attn_mask.shape[1]).astype(np.float32)

        # KL-regularised token rewards; the task reward lands on the token
        # before the final one (the action that produced the last token)
        rewards = -self.kl_ctl * np.asarray(self.kl_estimator(old_logp, ref_logp), dtype=np.float32)
        kl_rewards = rewards.copy()
        rewards[batch_idx, seqlens - 1] = 0.0
        final_idx = np.clip(seqlens - 2, 0, None)
        if self.mask_no_eos_with_zero:
            rewards[batch_idx, final_idx] += np.where(seq_no_eos_mask > 0, 0.0, reward_score)
        else:
            rewards[batch_idx, final_idx] += reward_score

        values = np.asarray(data.get("values", np.zeros_like(rewards)), dtype=np.float32)
        dev = self.engine.device
        advantages, returns = gae_padded(
            torch.from_numpy(rewards).to(dev),
            torch.from_numpy(values).to(dev),
            torch.from_numpy(loss_mask).to(dev),
            torch.from_numpy(seq_no_eos_mask).to(dev),
            self.discount,
            self.gae_lambda,
        )
        advantages = advantages.cpu().numpy()
        data["returns"] = returns.cpu().numpy()

        if self.adv_norm is not None:
            advantages = self.adv_norm(advantages, loss_mask)

        data["advantages"] = advantages.astype(np.float32)
        data["kl_rewards"] = kl_rewards
        data["tot_rewards"] = rewards
        data["loss_mask"] = loss_mask
        data["logprobs"] = old_logp

    def ppo_update(self, data: dict[str, Any]) -> list[dict[str, float]]:
        cfg = self.config
        if self.dynamic_sampling and len(data["rewards"]) % self.group_size == 0:
            data, sampling_stat = dynamic_sampling(data, self.group_size)
            stats_tracker.scalar(**sampling_stat)

        attn_mask = np.asarray(data["attention_mask"])
        loss_mask = np.asarray(data["loss_mask"])
        reward_score = np.asarray(data["rewards"], dtype=np.float32)
        seqlens = attn_mask.sum(-1).astype(np.float32)

        stats_tracker.denominator(
            n_seqs=np.ones_like(reward_score, dtype=bool),
            n_tokens=np.ones_like(loss_mask, dtype=bool),
            n_valid_tokens=loss_mask.astype(bool),
            correct_n_seqs=reward_score > 0,
            incorrect_n_seqs=reward_score <= 0,
        )
        stats_tracker.stat(denominator="correct_n_seqs", correct_seq_len=seqlens)
        stats_tracker.stat(denominator="incorrect_n_seqs", incorrect_seq_len=seqlens)
        stats_tracker.stat(
            denominator="n_valid_tokens",
            advantages=np.asarray(data["advantages"], dtype=np.float32),
            kl_rewards=np.asarray(data["kl_rewards"], dtype=np.float32),
            final_reward=np.asarray(data["tot_rewards"], dtype=np.float32),
        )
        prompt_lens = attn_mask.sum(-1) - np.asarray(data["loss_mask"]).sum(-1)
        stats_tracker.stat(
            denominator="n_seqs",
            no_eos_ratios=(seqlens == attn_mask.shape[-1]).astype(np.float32),
            task_reward=reward_score,
            prompt_len=prompt_lens.astype(np.float32),
            seq_len=seqlens,
        )
        stats_tracker.scalar(eps_clip=cfg.eps_clip)
        global_stats = stats_tracker.export_all()
        for k in ("n_seqs", "n_tokens", "n_valid_tokens", "correct_n_seqs", "incorrect_n_seqs"):
            global_stats.pop(k, None)

        data = {
            k: v for k, v in data.items()
            if k not in ("rewards", "tot_rewards", "kl_rewards", "versions",
                         "rollout_id", "rollout_version")
        }

        self.engine.train()
        if cfg.adaptive_entropy_coeff:
            # a token-aligned broadcast of the current coefficient
            data["entropy_coeff"] = np.full(
                np.asarray(data["attention_mask"]).shape, self.entropy_coeff, np.float32
            )

        all_stats = []
        ent_trace: list[float] = []
        for mb in _split_minibatches(data, cfg.ppo_n_minibatches):
            train_stat = self.engine.train_batch(
                mb,
                loss_fn=self._loss_fn,
                loss_weight_fn=lambda x: float(np.asarray(x["loss_mask"]).sum()),
            )
            if "entropy" in train_stat:
                ent_trace.append(float(train_stat["entropy"]))
            stats_tracker.scalar(**train_stat)
            all_stats.append(stats_tracker.export_all())
        self._update_steps += 1
        if cfg.adaptive_entropy_coeff and ent_trace:
            self._adapt_entropy_coeff(sum(ent_trace) / len(ent_trace))
        all_stats[0].update(global_stats)
        return all_stats

    def _adapt_entropy_coeff(self, entropy: float) -> None:
        """AEnt adaptive coefficient: below entropy_low the bonus grows,
        above entropy_high it shrinks, clipped to the box bounds."""
        cfg = self.config
        if self._update_steps <= cfg.entropy_warmup_steps:
            return
        self.entropy_coeff -= cfg.entropy_coeff_lr * (
            min(0.0, entropy - cfg.entropy_low) + max(0.0, entropy - cfg.entropy_high)
        )
        self.entropy_coeff = min(
            max(self.entropy_coeff, cfg.entropy_coeff_box_low), cfg.entropy_coeff_box_high
        )


def _split_minibatches(data: dict[str, Any], n_mbs: int) -> list[dict[str, Any]]:
    """Split a padded batch into `n_mbs` token-balanced sample groups."""
    attn = np.asarray(data["attention_mask"])
    B = attn.shape[0]
    n_mbs = min(n_mbs, B)
    lens = attn.sum(-1).astype(np.int64)
    cap = int(lens.sum() // n_mbs + lens.max())
    bins = ffd_allocate(list(lens), cap, min_groups=n_mbs)
    out = []
    for b in bins:
        if not b:
            continue
        idx = np.array(sorted(b))
        out.append({
            k: (np.asarray(v)[idx] if isinstance(v, np.ndarray) and
                np.asarray(v).ndim >= 1 and np.asarray(v).shape[0] == B else v)
            for k, v in data.items()
        })
    return out


class TorchPPOActor(TorchTrainEngine):
    """TrainEngine and actor algorithms in one object (JAX `JaxPPOActor`)."""

    def __init__(self, config: PPOActorConfig, device: str | torch.device | None = None):
        super().__init__(config, device=device)
        self.actor = PPOActor(config, self)

    def compute_logp(self, *args, **kwargs):
        return self.actor.compute_logp(*args, **kwargs)

    def compute_advantages(self, *args, **kwargs) -> None:
        self.actor.compute_advantages(*args, **kwargs)

    def ppo_update(self, *args, **kwargs) -> list[dict[str, float]]:
        return self.actor.ppo_update(*args, **kwargs)


def grpo_loss_fn(
    logits,
    mb: dict[str, Any],
    temperature: float,
    eps_clip: float,
    eps_clip_higher: float | None,
    c_clip: float | None,
    behav_imp_weight_cap: float | None,
    entropy_coeff: float = 0.0,
    entropy_clamp: float = 0.0,
):
    """Packed GRPO/decoupled-PPO loss (JAX :378) and its per-update stats
    (masked means over trained tokens). Labels are the packed stream rolled
    by -1; cross-segment labels carry loss_mask 0. With `entropy_clamp > 0`
    the entropy (the AEnt bonus and the logged stat) is the clamped one
    (JAX :387-406)."""
    labels = torch.roll(mb["input_ids"], shifts=-1)
    loss_mask = mb["loss_mask"].bool()
    if entropy_clamp > 0:
        logprobs = label_logprobs_of(logits, labels, temperature)
        entropy = clamped_entropy_of(logits, entropy_clamp, temperature)
    else:
        logprobs, entropy = label_logprobs_entropy_of(logits, labels, temperature)
    loss, stat = ppo_actor_loss_fn(
        logprobs=logprobs,
        proximal_logprobs=mb["prox_logp"],
        old_logprobs=mb["logprobs"],
        advantages=mb["advantages"],
        eps_clip=eps_clip,
        loss_mask=loss_mask,
        eps_clip_higher=eps_clip_higher,
        c_clip=c_clip,
        behav_imp_weight_cap=behav_imp_weight_cap,
    )
    n = torch.clamp(loss_mask.sum(), min=1)

    def masked_mean(x, m=loss_mask):
        return torch.where(m, x, 0.0).sum() / n

    # "entropy_coeff" in the batch (adaptive mode) overrides the static one
    coeff = mb["entropy_coeff"][0] if "entropy_coeff" in mb else entropy_coeff
    if "entropy_coeff" in mb or entropy_coeff:
        loss = loss - coeff * masked_mean(entropy)

    stats = dict(
        entropy=masked_mean(entropy).detach(),
        importance_weight=masked_mean(stat["importance_weight"]),
        approx_kl=masked_mean(stat["approx_kl"]),
        clip_ratio=stat["clip_mask"].sum() / n,
        dual_clip_ratio=stat["dual_clip_mask"].sum() / n,
        behave_imp_weight=masked_mean(stat["behave_imp_weight"]),
        behave_approx_kl=masked_mean(stat["behave_approx_kl"]),
    )
    return loss, stats
