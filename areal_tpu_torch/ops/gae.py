"""Generalized Advantage Estimation over padded batches (counterpart of
`areal_tpu/ops/gae.py::gae_padded`, :41).

The JAX version evaluates the masked backward recurrence as an affine
associative scan; here it is the recurrence itself, a reverse loop over
time with each step vectorised over the batch, on the device of its
inputs (`gae_padded_reference`, :136, is the same loop in float64 numpy).
The loop is T small steps; GAE runs once per training step, next to a
forward and backward of the whole model.
"""

from __future__ import annotations

import torch


def gae_padded(
    rewards,  # [B, T] token-level rewards (already KL-regularised)
    values,  # [B, T] value estimates (zeros for GRPO)
    loss_mask,  # [B, T] 1 where the token contributes (rolled mask)
    seq_no_eos_mask,  # [B] 1 if the sequence hit the length limit
    discount: float,
    gae_lambda: float,
):
    """Masked GAE. Returns (advantages, returns), both [B, T] float32,
    with advantages[:, T-1] == 0. The bootstrap value at the sequence end
    is values[:, T-1] when the sequence has no EOS and 0 otherwise; masked
    positions pass the running advantage and bootstrap value through."""
    rewards = rewards.float()
    values = values.float()
    mask = loss_mask.float()
    B, T = rewards.shape
    adv = torch.zeros_like(rewards)
    lastgaelam = torch.zeros(B, dtype=torch.float32, device=rewards.device)
    nextvalues = values[:, T - 1] * seq_no_eos_mask.float()
    for t in range(T - 2, -1, -1):
        delta = rewards[:, t] + discount * nextvalues - values[:, t]
        newgaelam = delta + discount * gae_lambda * lastgaelam
        m = mask[:, t]
        nextvalues = nextvalues * (1 - m) + values[:, t] * m
        lastgaelam = lastgaelam * (1 - m) + newgaelam * m
        adv[:, t] = lastgaelam
    return adv, adv + values
