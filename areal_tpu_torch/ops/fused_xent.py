"""Label logprobs (and entropy) from the LM head without [T, V] logits
(counterpart of `areal_tpu/ops/fused_xent.py::chunked_label_logprobs`,
:34), and the AEnt clamped entropy over token chunks
(`chunked_clamped_entropy`, :135). There is no Pallas kernel behind
either, so they are plain PyTorch.

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


def _split_f32(g, dtype: torch.dtype):
    """An f32 cotangent as operands of `dtype`: itself in f32, else
    hi + lo, each exact in the narrow dtype, to about 2^-16 of g."""
    if dtype == torch.float32:
        return (g,)
    hi = g.to(dtype)
    return hi, (g - hi.float()).to(dtype)


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
        parts = _split_f32(g, hidden.dtype)
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


class _ClampedEntropy(torch.autograd.Function):
    """Clamped entropy over token chunks of the head's logits. The forward
    keeps no chunk: the backward computes each chunk's logits again, takes
    its cotangent through the dense `clamped_softmax_entropy`, and adds the
    head's gradient over the chunks in an f32 accumulator the head's shape,
    rounded once at the end (a sum of bf16-rounded chunk gradients drifts by
    about 2^-9 of the running sum per chunk)."""

    @staticmethod
    def forward(ctx, hidden, head_w, head_is_vh, entropy_clamp, temperature, token_chunk):
        from areal_tpu_torch.utils.functional import clamped_softmax_entropy

        w_hv = head_w.t() if head_is_vh else head_w
        out = [clamped_softmax_entropy(_mm_f32(hidden[s:s + token_chunk], w_hv),
                                       entropy_clamp, temperature)
               for s in range(0, hidden.shape[0], token_chunk)]
        ctx.save_for_backward(hidden, head_w)
        ctx.args = (head_is_vh, entropy_clamp, temperature, token_chunk)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, g):
        from areal_tpu_torch.utils.functional import clamped_softmax_entropy

        hidden, head_w = ctx.saved_tensors
        head_is_vh, entropy_clamp, temperature, token_chunk = ctx.args
        w_hv = head_w.t() if head_is_vh else head_w
        dh = torch.empty_like(hidden) if ctx.needs_input_grad[0] else None
        acc = (torch.zeros(head_w.shape, dtype=torch.float32, device=head_w.device)
               if ctx.needs_input_grad[1] else None)
        for s in range(0, hidden.shape[0], token_chunk):
            h = hidden[s:s + token_chunk]
            with torch.enable_grad():
                logits = _mm_f32(h, w_hv).requires_grad_()
                ent = clamped_softmax_entropy(logits, entropy_clamp, temperature)
                (dl,) = torch.autograd.grad(ent, logits, g[s:s + token_chunk])
            parts = _split_f32(dl, hidden.dtype)
            if dh is not None:
                dh[s:s + token_chunk] = sum(_mm_f32(p, w_hv.t()) for p in parts).to(dh.dtype)
            if acc is not None:
                for p in parts:
                    acc += _mm_f32(p.t(), h) if head_is_vh else _mm_f32(h.t(), p)
        dw = acc.to(head_w.dtype) if acc is not None else None
        return dh, dw, None, None, None, None


def chunked_clamped_entropy(
    hidden,
    head_w,
    *,
    head_is_vh: bool = False,
    entropy_clamp: float = 0.2,
    temperature: float = 1.0,
    token_chunk: int = 128,
):
    """AEnt clamped entropy (f32 [T]) from post-final-norm hidden states
    [T, H] and the LM head weight ([H, V], or [V, H] with `head_is_vh`).
    The clamp's threshold is an order statistic over the whole vocab, so it
    cannot ride the online vocab scan: the tokens go in chunks of
    `token_chunk`, each chunk's [token_chunk, V] f32 logits computed whole
    (78 MB at 128 x 151936) and computed again in the backward, so one
    chunk of logits is the peak in both passes. The same value as
    `clamped_softmax_entropy` of the dense logits, to f32 rounding; the
    head's gradient is summed over the chunks in f32 (where JAX's `lax.map`
    adds the chunks' bf16 gradients in bf16)."""
    return _ClampedEntropy.apply(hidden, head_w, bool(head_is_vh), float(entropy_clamp),
                                 float(temperature), int(token_chunk))
