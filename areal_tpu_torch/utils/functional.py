"""Loss and probability functions for PPO/GRPO (counterpart of
`areal_tpu/utils/functional.py`).

The device functions are plain PyTorch on whatever device their inputs
live; the JAX `stop_gradient`s become `detach()`. The host functions
(`dynamic_sampling`, `reward_overlong_penalty`) stay numpy, as in the JAX
package, because they change the batch's shape.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def gather_logprobs(logits, labels, temperature: float = 1.0):
    """log p(labels) from raw logits; [T, V] + [T] -> [T] in float32
    (:45). `temperature` divides the logits as the sampler does."""
    logits = logits.float() / max(temperature, 1e-6)
    logz = torch.logsumexp(logits, dim=-1)
    gathered = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return gathered - logz


def gather_logprobs_entropy(logits, labels, temperature: float = 1.0):
    """(log p(labels), entropy) in one pass over dense logits (:77)."""
    logits = logits.float() / max(temperature, 1e-6)
    logz = torch.logsumexp(logits, dim=-1)
    logprobs_all = logits - logz[..., None]
    entropy = -(torch.exp(logprobs_all) * logprobs_all).sum(-1)
    gathered = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return gathered - logz, entropy


def label_logprobs_of(x, labels, temperature: float = 1.0):
    """log p(labels) from dense [T, V] logits or an `LMHead` (the fused
    vocab-chunked head, models/qwen2.py)."""
    if hasattr(x, "label_logprobs"):
        return x.label_logprobs(labels, temperature)
    return gather_logprobs(x, labels, temperature)


def label_logprobs_entropy_of(x, labels, temperature: float = 1.0):
    """(log p(labels), entropy) from dense logits or an `LMHead`."""
    if hasattr(x, "label_logprobs_entropy"):
        return x.label_logprobs_entropy(labels, temperature)
    return gather_logprobs_entropy(x, labels, temperature)


def masked_normalization(
    x,
    mask=None,
    dim=None,
    unbiased: bool = False,
    eps: float = 1e-5,
    high_precision: bool = True,
):
    """Zero-mean unit-variance normalization over masked elements (:139).
    `high_precision` computes in float64, as the JAX version does when x64
    is enabled; the result is float32."""
    dtype = torch.float64 if high_precision else torch.float32
    x = x.to(dtype)
    if dim is None:
        dim = tuple(range(x.dim()))
    if mask is None:
        factor = torch.tensor(
            float(np.prod([x.shape[d] for d in dim])), dtype=dtype, device=x.device
        )
    else:
        mask = mask.to(dtype)
        x = x * mask
        factor = mask.sum(dim=dim, keepdim=True)
    x_sum = x.sum(dim=dim, keepdim=True)
    x_sum_sq = (x**2).sum(dim=dim, keepdim=True)
    mean = x_sum / factor
    var = x_sum_sq / factor - mean**2
    if unbiased:
        var = var * factor / torch.clamp(factor - 1, min=1)
    return ((x - mean) / (torch.sqrt(torch.clamp(var, min=0.0)) + eps)).float()


def ppo_actor_loss_fn(
    logprobs,
    proximal_logprobs,
    old_logprobs,
    advantages,
    eps_clip: float,
    loss_mask,
    eps_clip_higher: float | None = None,
    c_clip: float | None = None,
    behav_imp_weight_cap: float | None = None,
):
    """Clipped-ratio PPO policy loss with the decoupled-PPO split (:170).

    `logprobs` is the current policy (differentiated), `proximal_logprobs`
    the proximal policy the ratio is clipped against, `old_logprobs` the
    behaviour policy that generated the tokens; exp(prox - behav),
    optionally capped, reweights each token's loss."""
    loss_mask = loss_mask.bool()
    loss_mask_count = torch.clamp(loss_mask.sum(), min=1)
    ratio = torch.where(loss_mask, torch.exp(logprobs - proximal_logprobs), 0.0)

    upper = eps_clip if eps_clip_higher is None else eps_clip_higher
    clipped_ratio = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + upper)

    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    clip_mask = pg_loss1 < pg_loss2
    pg_loss = torch.maximum(pg_loss1, pg_loss2)
    if c_clip is not None:
        if not c_clip > 1.0:
            raise ValueError(f"c_clip must exceed 1, got {c_clip}")
        pg_loss3 = torch.sign(advantages) * c_clip * advantages
        dual_clip_mask = pg_loss3 < pg_loss
        pg_loss = torch.minimum(pg_loss, pg_loss3)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)

    behav_kl = proximal_logprobs - old_logprobs
    behav_imp_weight = torch.exp(behav_kl)
    if behav_imp_weight_cap is not None:
        behav_mask = (behav_imp_weight <= behav_imp_weight_cap) & loss_mask
    else:
        behav_mask = loss_mask
    behav_kl = torch.where(behav_mask, behav_kl, 0.0)
    behav_imp_weight = torch.where(behav_mask, behav_imp_weight, 0.0)
    pg_loss = pg_loss * behav_imp_weight.detach()

    logging_loss = pg_loss.detach()
    pg_loss = torch.where(loss_mask, pg_loss, 0.0).sum() / loss_mask_count
    stat = dict(
        loss=logging_loss,
        importance_weight=ratio.detach(),
        approx_kl=(logprobs - proximal_logprobs).detach(),
        clip_mask=clip_mask & loss_mask,
        dual_clip_mask=dual_clip_mask & loss_mask,
        behave_imp_weight=behav_imp_weight,
        behave_approx_kl=behav_kl,
        behave_mask=behav_mask,
    )
    return pg_loss, stat


def dynamic_sampling(
    data: dict[str, Any], group_size: int
) -> tuple[dict[str, Any], dict[str, int]]:
    """Drop GRPO groups whose rewards are all equal (:292; DAPO). Host-side:
    it changes the batch size."""
    rewards = np.asarray(data["rewards"])
    batch_size = rewards.shape[0]
    if group_size <= 0:
        return data, dict(n_group_kept=0, n_group_filtered=0)
    if batch_size % group_size != 0:
        return data, dict(n_group_kept=batch_size // group_size, n_group_filtered=0)
    num_groups = batch_size // group_size
    grouped = rewards.reshape(num_groups, group_size)
    all_equal = (grouped == grouped[:, :1]).all(axis=1)
    valid = ~all_equal
    mask = np.repeat(valid, group_size)
    if not mask.any():
        return data, dict(n_group_kept=0, n_group_filtered=num_groups)
    n_kept = int(valid.sum())
    filtered = {}
    for k, v in data.items():
        arr = np.asarray(v) if not isinstance(v, np.ndarray) else v
        if isinstance(v, (np.ndarray, list)) and getattr(arr, "shape", ())[:1] == (batch_size,):
            filtered[k] = arr[mask]
        else:
            filtered[k] = v
    return filtered, dict(n_group_kept=n_kept, n_group_filtered=num_groups - n_kept)


def reward_overlong_penalty(
    data: dict[str, Any],
    overlong_tokens: int,
    overlong_penalty_factor: float,
    max_response_length: int,
) -> dict[str, Any]:
    """DAPO soft overlong penalty (:322): responses that enter the last
    `overlong_tokens` of the budget are penalised linearly."""
    rewards = np.asarray(data["rewards"], dtype=np.float32).copy()
    response_lengths = np.asarray(data["loss_mask"]).sum(axis=-1).astype(np.int64)
    expected_len = max_response_length - overlong_tokens
    exceed = response_lengths - expected_len
    penalty = np.minimum(-exceed / overlong_tokens * overlong_penalty_factor, 0.0)
    data = dict(data)
    data["rewards"] = rewards + penalty.astype(np.float32)
    return data
