"""Label logprobs (and entropy) from the LM head without [T, V] logits
(counterpart of `areal_tpu/ops/fused_xent.py::chunked_label_logprobs`,
:34). There is no Pallas kernel behind it, so it is plain PyTorch.

An online logsumexp runs over vocab chunks: each chunk's [T, chunk]
logits fold into running (max, sumexp, entropy numerator, label logit)
carries, and `torch.utils.checkpoint` around each chunk makes the
backward recompute that chunk's logits, so the f32 [T, V] tensor never
exists in either pass.

As in the JAX version (`preferred_element_type=jnp.float32`), each chunk
matmul takes bf16 operands to f32 logits with no bf16 rounding between
(`_HeadLogits`): on the card one cuBLAS call with an f32 output, on the
CPU the operands upcast, which gives the same products. Its backward
splits the f32 cotangent into two bf16 halves, so the head's gradients
see it to about 2^-16 of itself, where JAX's backward takes it whole in
f32.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _mm_f32(a, b):
    """a @ b as f32 from operands of one float dtype, accumulated in f32."""
    if a.dtype != torch.float32 and a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _HeadLogits(torch.autograd.Function):
    """[T, H] x [H, chunk] -> f32 logits. `torch.mm` with an `out_dtype`
    has no derivative, hence the Function; the gradients come back in the
    operands' dtypes."""

    @staticmethod
    def forward(ctx, hidden, w):
        ctx.save_for_backward(hidden, w)
        return _mm_f32(hidden, w)

    @staticmethod
    def backward(ctx, g):
        hidden, w = ctx.saved_tensors
        if hidden.dtype == torch.float32:
            parts = (g,)
        else:  # g = hi + lo to about 2^-16 of g, each half exact in bf16
            hi = g.to(hidden.dtype)
            parts = (hi, (g - hi.float()).to(hidden.dtype))
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = sum(_mm_f32(p, w.t()) for p in parts).to(hidden.dtype)
        if ctx.needs_input_grad[1]:
            dw = sum(_mm_f32(hidden.t(), p) for p in parts).to(w.dtype)
        return dh, dw


def _fold(carry_m, carry_s, carry_e, carry_lab, hidden, w_chunk, labels,
          offset: int, head_is_vh: bool, inv_t: float, with_entropy: bool):
    logits = _HeadLogits.apply(hidden, w_chunk.t() if head_is_vh else w_chunk) * inv_t
    width = logits.shape[1]
    m_new = torch.maximum(carry_m, logits.amax(dim=-1))
    scale = torch.exp(carry_m - m_new)
    p = torch.exp(logits - m_new[:, None])
    s = carry_s * scale + p.sum(dim=-1)
    e = carry_e * scale + (p * logits).sum(dim=-1) if with_entropy else carry_e
    idx = labels - offset
    ok = (idx >= 0) & (idx < width)
    picked = torch.gather(logits, 1, idx.clamp(0, width - 1)[:, None])[:, 0]
    lab = carry_lab + torch.where(ok, picked, 0.0)
    return m_new, s, e, lab


def chunked_label_logprobs(
    hidden,
    head_w,
    labels,
    *,
    head_is_vh: bool = False,
    temperature: float = 1.0,
    with_entropy: bool = False,
    vocab_chunk: int = 16384,
):
    """log p(labels) (f32 [T]), and entropy [T] when `with_entropy`, from
    post-final-norm hidden states [T, H] and the LM head weight: [H, V]
    untied, or the [V, H] embedding table with `head_is_vh=True`.
    `temperature` divides the logits. A label outside [0, V) gets no
    picked logit (logp = -logsumexp), as in the JAX version; pad rows are
    the caller's to mask."""
    T = hidden.shape[0]
    V = head_w.shape[0] if head_is_vh else head_w.shape[1]
    cs = int(min(vocab_chunk, V))
    inv_t = 1.0 / max(temperature, 1e-6)
    labels = labels.long()
    dev = hidden.device
    m = torch.full((T,), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros(T, dtype=torch.float32, device=dev)
    e = torch.zeros(T, dtype=torch.float32, device=dev)
    lab = torch.zeros(T, dtype=torch.float32, device=dev)
    remat = torch.is_grad_enabled() and (hidden.requires_grad or head_w.requires_grad)
    for offset in range(0, V, cs):
        width = min(cs, V - offset)
        w_c = head_w[offset:offset + width] if head_is_vh else head_w[:, offset:offset + width]
        args = (m, s, e, lab, hidden, w_c, labels, offset, head_is_vh, inv_t, with_entropy)
        if remat:
            m, s, e, lab = checkpoint(_fold, *args, use_reentrant=False)
        else:
            m, s, e, lab = _fold(*args)
    lse = m + torch.log(s)
    logp = lab - lse
    if with_entropy:
        return logp, lse - e / s
    return logp
