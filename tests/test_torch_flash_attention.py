"""The port's flash attention against the JAX package's, on the CPU in f32.

On CPU tensors the port's `flash_attention` / `flash_attention_chunk` run
`flash_attention_ref`, the plain version of the CUDA kernels K1/K2a/K2b
(dense masked softmax, autograd for the backward); the JAX side runs the
Pallas kernels in interpret mode, as `tests/test_flash_attention.py`
does. Same numpy inputs (seeded) go to both. Tolerances are those of the
JAX package's own flash tests: atol = rtol = 2e-5 on outputs and lse,
2e-4 on gradients (f32, blockwise online softmax against one dense
softmax, sums taken in another order).

The tile-skipping rule the kernels apply (`tile_meta`) is held against
the dense mask here too: it may never skip a tile pair that holds a valid
pair, and on a packed stream it skips every pair that holds none. The
plain versions of the backward kernels (`flash_bwd_dq_ref`,
`flash_bwd_dkv_ref`) are held against autograd, and the autograd Function
that launches the kernels is run with each launcher replaced by its plain
version, at the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from areal_tpu.ops import flash_attention as jfa
from areal_tpu_torch.ops import flash_attention as tfa

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
SHAPES = [(4, 2, 16), (6, 1, 32), (4, 4, 64)]


def _segments(T, n_seqs, pad, rng):
    body = T - pad
    cuts = np.sort(rng.choice(np.arange(1, body), size=n_seqs - 1, replace=False))
    seg = np.zeros(T, dtype=np.int32)
    prev = 0
    for si, c in enumerate(list(cuts) + [body]):
        seg[prev:c] = si
        prev = c
    seg[body:] = tfa.PADDING_SEGMENT
    return seg


def _inputs(T, nH, nKV, hd, seed, n_seqs=5, pad=11):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((T, nH, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((T, nKV, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((T, nKV, hd)) * 0.5).astype(np.float32)
    return q, k, v, _segments(T, n_seqs, pad, rng)


def _t(*arrays):
    return [torch.from_numpy(a).requires_grad_(a.dtype == np.float32) for a in arrays]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("T", [130, 256])
def test_forward_and_grads_match_jax(T, shape):
    nH, nKV, hd = shape
    q, k, v, seg = _inputs(T, nH, nKV, hd, seed=T + hd)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, jnp.asarray(seg), block_q=128, block_k=128,
                                interpret=True)
        return jnp.sum(jnp.sin(o)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v)
    to = tfa.flash_attention(tq, tk, tv, torch.from_numpy(seg))
    torch.sin(to).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")
    # pad rows attend to nothing: exactly 0
    assert torch.equal(to[seg == -1], torch.zeros_like(to[seg == -1]))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_chunk_with_offsets_and_dlse_matches_jax(shape):
    """A q chunk against an earlier kv chunk (ring-attention style global
    positions), with a gradient through lse as well as through o."""
    nH, nKV, hd = shape
    Tq, Tk = 130, 96
    rng = np.random.default_rng(hd)
    q = (rng.standard_normal((Tq, nH, hd)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((Tk, nKV, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((Tk, nKV, hd)) * 0.5).astype(np.float32)
    # kv tokens 40..135 of the stream, queries 100..229; segments span both
    kpos = np.arange(40, 40 + Tk, dtype=np.int32)
    qpos = np.arange(100, 100 + Tq, dtype=np.int32)
    seg_k = (kpos // 50).astype(np.int32)
    seg_q = (qpos // 50).astype(np.int32)
    seg_q[-7:] = tfa.PADDING_SEGMENT
    seg_q[20:30] = 9  # a segment with no key in this chunk: fully masked rows
    w_o = rng.standard_normal((Tq, nH, hd)).astype(np.float32)
    w_l = rng.standard_normal((Tq, nH)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_chunk(
            q, k, v, jnp.asarray(seg_q), jnp.asarray(seg_k), jnp.asarray(qpos),
            jnp.asarray(kpos), block_q=128, block_k=128, interpret=True)
        live = lse > -5e29
        return jnp.sum(o * w_o) + jnp.sum(jnp.where(live, lse, 0.0) * w_l), (o, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, k, v)
    to, tl = tfa.flash_attention_chunk(
        tq, tk, tv, *(torch.from_numpy(a) for a in (seg_q, seg_k, qpos, kpos)))
    live = tl > -5e29
    ((to * torch.from_numpy(w_o)).sum()
     + (torch.where(live, tl, 0.0) * torch.from_numpy(w_l)).sum()).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=FWD_TOL, rtol=FWD_TOL)
    for t, j, name in zip((tq, tk, tv), jg, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")
    # fully-masked rows: o = 0 and lse = -1e30 exactly, as in the kernels
    dead = (seg_q == -1) | (seg_q == 9)
    assert torch.equal(to.detach()[dead], torch.zeros_like(to[dead]))
    assert bool((tl.detach()[dead] == -1e30).all())


def test_ref_matches_its_wrappers_and_rejects_other_devices():
    q, k, v, seg = _inputs(130, 4, 2, 16, seed=3)
    tq, tk, tv, tseg = (torch.from_numpy(a) for a in (q, k, v, seg))
    pos = torch.arange(130)
    ref_o, ref_l = tfa.flash_attention_ref(tq, tk, tv, tseg, tseg, pos, pos)
    assert torch.equal(tfa.flash_attention(tq, tk, tv, tseg), ref_o)
    assert ref_l.shape == (130, 4) and ref_l.dtype == torch.float32
    with pytest.raises(ValueError):
        tfa.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"), tseg.to("meta"))


def _live(meta_q, meta_k):
    qm, km = meta_q[:, None, :], meta_k[None, :, :]
    return (qm[..., 0] <= km[..., 1]) & (km[..., 0] <= qm[..., 1]) & (km[..., 2] <= qm[..., 2])


def _tile_any(mask, tile=64):
    Tq, Tk = mask.shape
    nq, nk = -(-Tq // tile), -(-Tk // tile)
    padded = np.zeros((nq * tile, nk * tile), bool)
    padded[:Tq, :Tk] = mask
    return padded.reshape(nq, tile, nk, tile).any(axis=(1, 3))


@pytest.mark.parametrize("case", ["packed", "random"])
def test_tile_skipping_is_exact(case):
    rng = np.random.default_rng(7)
    if case == "packed":  # ~500-token sequences and a pad tail, as trained
        T = 2000
        seg = _segments(T, 4, 37, rng)
        seg_q = seg_k = seg
        qpos = kpos = np.arange(T, dtype=np.int32)
    else:  # unsorted segments, arbitrary positions (the chunk entry)
        T = 700
        seg_q = rng.integers(-1, 6, T).astype(np.int32)
        seg_k = rng.integers(-1, 6, T).astype(np.int32)
        qpos = rng.integers(0, 900, T).astype(np.int32)
        kpos = rng.integers(0, 900, T).astype(np.int32)
    mask = ((seg_q[:, None] == seg_k[None, :]) & (qpos[:, None] >= kpos[None, :])
            & (seg_q[:, None] != -1))
    need = _tile_any(mask)
    live = _live(
        tfa.tile_meta(torch.from_numpy(seg_q), torch.from_numpy(qpos), queries=True).numpy(),
        tfa.tile_meta(torch.from_numpy(seg_k), torch.from_numpy(kpos), queries=False).numpy(),
    )
    assert not (need & ~live).any(), "a tile pair holding a valid pair would be skipped"
    if case == "packed":
        assert (live == need).all()
        # the point of skipping: ~500-token sequences fill few of the pairs
        assert live.sum() < 0.3 * live.size


def _chunk_inputs(shape, seed):
    nH, nKV, hd = shape
    rng = np.random.default_rng(seed)
    T = 150
    q, k, v, seg = _inputs(T, nH, nKV, hd, seed=seed)
    seg = seg.copy()
    seg[30:40] = 77  # a segment of its own: causal within, no earlier key
    pos = np.arange(T, dtype=np.int32)
    w_o = rng.standard_normal((T, nH, hd)).astype(np.float32)
    w_l = rng.standard_normal((T, nH)).astype(np.float32)
    return q, k, v, seg, pos, w_o, w_l


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_autograd(shape):
    """The plain versions of K2a and K2b (`flash_bwd_dq_ref`,
    `flash_bwd_dkv_ref`), fed the forward's lse and dd = dlse - rowsum(dO *
    O) as the kernels are, give autograd's gradients of the plain forward,
    dlse included."""
    q, k, v, seg, pos, w_o, w_l = _chunk_inputs(shape, seed=shape[2])
    tq, tk, tv = _t(q, k, v)
    ids = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    sm = 1.0 / np.sqrt(shape[2])
    o, lse = tfa.flash_attention_ref(tq, tk, tv, *ids)
    live = lse > -5e29
    ((o * torch.from_numpy(w_o)).sum()
     + (torch.where(live, lse, 0.0) * torch.from_numpy(w_l)).sum()).backward()
    do = torch.from_numpy(w_o)
    dlse = torch.where(live, torch.from_numpy(w_l), 0.0).t()
    dd = dlse - (o.detach() * do).sum(-1).t()
    lse_k = lse.detach().t().contiguous()
    args = (tq.detach(), tk.detach(), tv.detach(), do, lse_k, dd, *ids, sm)
    dq = tfa.flash_bwd_dq_ref(*args)
    dk, dv = tfa.flash_bwd_dkv_ref(*args)
    for got, want, name in ((dq, tq.grad, "dq"), (dk, tk.grad, "dk"), (dv, tv.grad, "dv")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


def test_autograd_function_wiring_with_plain_kernels(monkeypatch):
    """`_FlashAttention` (forward K1, backward K2a + K2b) with each kernel
    launcher replaced by its plain version on the CPU: the Function's
    layouts, delta and dlse plumbing and launch counts give autograd's
    answer for the plain forward."""
    def fwd(q, k, v, sq, sk, pq, pk, mq, mk, sm):
        tfa.launches_fwd += 1
        o, lse = tfa.flash_attention_ref(q, k, v, sq, sk, pq, pk, sm_scale=sm)
        return o, lse.t().contiguous()

    def dq(q, k, v, do, lse, dd, sq, sk, pq, pk, mq, mk, sm):
        tfa.launches_dq += 1
        return tfa.flash_bwd_dq_ref(q, k, v, do, lse, dd, sq, sk, pq, pk, sm)

    def dkv(q, k, v, do, lse, dd, sq, sk, pq, pk, mq, mk, sm):
        tfa.launches_dkv += 1
        return tfa.flash_bwd_dkv_ref(q, k, v, do, lse, dd, sq, sk, pq, pk, sm)

    for name, fn in dict(flash_fwd=fwd, flash_bwd_dq=dq, flash_bwd_dkv=dkv).items():
        monkeypatch.setattr(tfa, name, fn)
    for name in ("launches_fwd", "launches_dq", "launches_dkv"):
        monkeypatch.setattr(tfa, name, 0)
    shape = (6, 2, 16)
    q, k, v, seg, pos, w_o, w_l = _chunk_inputs(shape, seed=1)
    ids = [torch.from_numpy(a) for a in (seg, seg, pos, pos)]
    grads = []
    for path in ("function", "plain"):
        tq, tk, tv = _t(q, k, v)
        if path == "function":
            o, lse = tfa._FlashAttention.apply(tq, tk, tv, *ids, 1.0 / np.sqrt(shape[2]))
            lse = lse.t()
        else:
            o, lse = tfa.flash_attention_ref(tq, tk, tv, *ids)
        live = lse > -5e29
        ((o * torch.from_numpy(w_o)).sum()
         + (torch.where(live, lse, 0.0) * torch.from_numpy(w_l)).sum()).backward()
        grads.append((o.detach(), lse.detach(), tq.grad, tk.grad, tv.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=GRAD_TOL, rtol=GRAD_TOL)
    assert (tfa.launches_fwd, tfa.launches_dq, tfa.launches_dkv) == (1, 1, 1)
