"""Per-slot token sampling on the device, position-keyed as in the JAX
engine (counterpart of `areal_tpu/engine/jax_decode.py::_make_sample_fn`,
:211-257, and of its per-slot keys, :1367-1373, :2955-2969).

Row r draws with the subkey `fold_in(base_keys[r], positions[r])`: the
request's base key, fixed at its first admission, folded with the logical
position of the token being sampled. A slot's stream is therefore a pure
function of its key and its positions: it does not depend on chunk
boundaries, on its batchmates, on which sampler variant they force, on
preemption, or on speculative verification, which samples all W positions
of a verify forward at once with the same keys.

- greedy rows take the argmax of the logits;
- the others draw `argmax(logits / temperature + gumbel)`, which is
  `jax.random.categorical`, from the full vocabulary with the subkey;
- with `use_topp` (some live row has top_p < 1), such a row draws within
  the top-64 candidates filtered to its nucleus, with `fold_in(subkey,
  1)`; rows with top_p == 1 keep the full draw with the subkey in both
  variants;
- the reported logprob is always the full-vocabulary log-softmax of the
  chosen token.

The noise is `ops/threefry.gumbel_noise`: jax.random's bits exactly, one
kernel per draw on the card. With the same logits the tokens equal
`jax.vmap(jax.random.categorical)`'s, but for a near-tie that an ulp of
`log` decides.
"""

from __future__ import annotations

import numpy as np
import torch

from areal_tpu_torch.ops.threefry import gumbel_noise

TOP_P_CANDIDATES = 64


def slot_base_key(random_seed: int, admission_seq: int) -> np.ndarray:
    """A request's base key, from the engine seed and its admission index
    (jax_decode.py:2962-2968): `[2]` uint32."""
    seq = np.random.SeedSequence(entropy=(int(random_seed), int(admission_seq)))
    return seq.generate_state(2, np.uint32)


def sample(
    logits: torch.Tensor,  # [R, V]
    base_keys: torch.Tensor,  # [R, 2] int64 of uint32 values
    positions: torch.Tensor,  # [R] int64: the logical position sampled
    temps: torch.Tensor,  # [R] f32
    top_ps: torch.Tensor,  # [R] f32
    greedy: torch.Tensor,  # [R] bool
    use_topp: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [R] int64, logprobs [R] f32)."""
    logits = logits.float()
    logprobs_all = torch.log_softmax(logits, dim=-1)
    greedy_tok = torch.argmax(logits, dim=-1)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    V = logits.shape[-1]
    sampled = torch.argmax(gumbel_noise(base_keys, positions, V) + scaled, dim=-1)
    if use_topp:
        k = min(TOP_P_CANDIDATES, V)
        vals, idx = torch.topk(scaled, k, dim=-1)
        probs = torch.softmax(vals, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_ps[:, None]
        vals = torch.where(keep, vals, -1e30)
        noise = gumbel_noise(base_keys, positions, k, secondary=True)
        pick = torch.argmax(noise + vals, dim=-1)
        sampled_topp = idx.gather(1, pick[:, None])[:, 0]
        sampled = torch.where(top_ps < 1.0, sampled_topp, sampled)
    tok = torch.where(greedy, greedy_tok, sampled)
    logp = logprobs_all.gather(1, tok[:, None])[:, 0]
    return tok, logp
