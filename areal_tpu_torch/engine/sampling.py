"""Per-slot token sampling on the device (counterpart of
`areal_tpu/engine/jax_decode.py::_make_sample_fn`, :211-257).

- greedy slots take the argmax of the logits;
- the others sample from softmax(logits / temperature) over the full
  vocabulary, or, when the batch has a slot with top_p < 1, that slot
  samples within the top-64 candidates filtered to its nucleus;
- the reported logprob is always the full-vocabulary log-softmax of the
  chosen token.

Categorical draws are Gumbel-max (what `jax.random.categorical` does)
with noise from one `torch.Generator` on the device, so a decode chunk
needs no host round trip. The draws cannot match JAX's `fold_in` keys bit
for bit; the tests check their statistics instead.
"""

from __future__ import annotations

import torch

TOP_P_CANDIDATES = 64


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits), by Gumbel-max."""
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device,
        dtype=torch.float32,
    )
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample(
    logits: torch.Tensor,  # [R, V]
    temps: torch.Tensor,  # [R] f32
    top_ps: torch.Tensor,  # [R] f32
    greedy: torch.Tensor,  # [R] bool
    generator: torch.Generator,
    use_topp: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [R] int64, logprobs [R] f32)."""
    logits = logits.float()
    logprobs_all = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    sampled = _categorical(scaled, generator)
    if use_topp:
        k = min(TOP_P_CANDIDATES, logits.shape[-1])
        vals, idx = torch.topk(scaled, k, dim=-1)
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_ps[:, None]
        vals = torch.where(keep, vals, -1e30)
        pick = _categorical(vals, generator)
        sampled_topp = idx.gather(1, pick[:, None])[:, 0]
        sampled = torch.where(top_ps < 1.0, sampled_topp, sampled)
    tok = torch.where(greedy, greedy_tok, sampled)
    logp = logprobs_all.gather(1, tok[:, None])[:, 0]
    return tok, logp
