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

import chip_smoke
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
    to = tfa.flash_attention(tq, tk, tv, tfa.packed_layout(torch.from_numpy(seg)))
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
        tq, tk, tv, tfa.flash_layout(*(torch.from_numpy(a) for a in (seg_q, seg_k, qpos, kpos))))
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
    assert torch.equal(tfa.flash_attention(tq, tk, tv, tfa.packed_layout(tseg)), ref_o)
    assert ref_l.shape == (130, 4) and ref_l.dtype == torch.float32
    with pytest.raises(ValueError):
        tfa.flash_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"),
                            tfa.packed_layout(tseg.to("meta")))


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
            o, lse = tfa._FlashAttention.apply(tq, tk, tv, *tfa.flash_layout(*ids),
                                               1.0 / np.sqrt(shape[2]))
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


# ---------------------------------------------------------------------------
# The bf16 kernels' numerics design, emulated in plain PyTorch
# ---------------------------------------------------------------------------
#
# The tensor-core kernels K1, K2a and K2b (`csrc/flash_attention.cu`)
# multiply bf16 operands with f32 sums; P (K1), dS (K2a), P^T and dS^T
# (K2b) are f32 values fed to the second products as bf16 hi + lo terms;
# exponentials are taken in log2 units. The emulation below follows that
# rounding tile by tile (64 keys per K1 step, 16 keys per K2a stage) and is
# held to chip_smoke.py's bf16 tolerances: phase_flash_kernel's (a, rtol) =
# (2^-8, 2^-8), lse (2e-5, 0), against the plain version with autograd (dq
# with chip_smoke's delta term) and against the JAX Pallas kernels in
# interpret mode; and the train-shape check of its flash line,
# (2e-5, 2^-8) against the plain version on the same lse and dd. An element
# passes when |x - ref| <= a max|ref| + rtol |ref|.

BF16_TOL = (2.0 ** -8, 2.0 ** -8)
LSE_TOL = (2e-5, 0.0)
TRAIN_SHAPE_TOL = (2e-5, 2.0 ** -8)
_LOG2E = 1.4426950408889634
QWEN15 = (12, 2, 128)  # Qwen2.5-1.5B heads and head dim


def _bf(x):
    return x.to(torch.bfloat16).float()


def _terms(x, split):
    """x as the kernels feed it to a product: bf16 hi (+ bf16 lo)."""
    hi = _bf(x)
    return hi + _bf(x - hi) if split else hi


def _emulated_fwd(q, k, v, ids, sm, split):
    """K1: (o rounded to bf16 [Tq, nH, hd], lse f32 [nH, Tq])."""
    Tq, nH, hd = q.shape
    Tk, nKV, _ = k.shape
    g = nH // nKV
    valid = tfa._valid(*ids)
    qh = q.reshape(Tq, nKV, g, hd)
    m = torch.full((nKV, g, Tq, 1), -1e30)
    l = torch.zeros(nKV, g, Tq, 1)
    acc = torch.zeros(nKV, g, Tq, hd)
    for k0 in range(0, Tk, 64):
        s = torch.einsum("tkgd,skd->kgts", qh, k[k0:k0 + 64]) * (sm * _LOG2E)
        s = torch.where(valid[:, k0:k0 + 64], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(m_new > -5e29, torch.exp2(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("kgts,skd->kgtd", _terms(p, split), v[k0:k0 + 64])
        m = m_new
    safe_l = torch.where(l > 0, l, 1.0)
    o = (acc / safe_l).permute(2, 0, 1, 3).reshape(Tq, nH, hd)
    lse = torch.where(l > 0, m / _LOG2E + torch.log(safe_l), -1e30)[..., 0].reshape(nH, Tq)
    return _bf(o), lse


def _emulated_p_ds(q, k, v, do, lse, dd, ids, sm):
    """The backward's P and dS in f32 `[nKV, g, Tq, Tk]` as K2a and K2b form
    them (exponentials in log2 units), with q and dO grouped by kv head."""
    Tq, nH, hd = q.shape
    nKV = k.shape[1]
    g = nH // nKV
    qh = q.reshape(Tq, nKV, g, hd)
    s = torch.where(tfa._valid(*ids), torch.einsum("tkgd,skd->kgts", qh, k), -1e30)
    lse2 = lse.reshape(nKV, g, Tq, 1) * _LOG2E
    p = torch.where(lse2 > -5e29, torch.exp2(s * (sm * _LOG2E) - lse2), 0.0)
    dof = do.reshape(Tq, nKV, g, hd)
    ds = p * (torch.einsum("tkgd,skd->kgts", dof, v) + dd.reshape(nKV, g, Tq, 1))
    return p, ds, qh, dof


def _emulated_dq(q, k, v, do, lse, dd, ids, sm, split):
    """K2a: dq rounded to bf16; dS @ K summed 16 keys per stage, each
    stage from zero."""
    Tq, nH, hd = q.shape
    _, ds, _, _ = _emulated_p_ds(q, k, v, do, lse, dd, ids, sm)
    dq = sum(torch.einsum("kgts,skd->tkgd", _terms(ds[..., k0:k0 + 16], split), k[k0:k0 + 16])
             for k0 in range(0, k.shape[0], 16))
    return _bf(dq.reshape(Tq, nH, hd) * sm)


def _emulated_dkv(q, k, v, do, lse, dd, ids, sm, split):
    """K2b: (dk, dv) rounded to bf16, summed over the GQA group."""
    p, ds, qh, dof = _emulated_p_ds(q, k, v, do, lse, dd, ids, sm)
    dk = torch.einsum("kgts,tkgd->skd", _terms(ds, split), qh) * sm
    dv = torch.einsum("kgts,tkgd->skd", _terms(p, split), dof)
    return _bf(dk), _bf(dv)


def _emulated_kernels(q, k, v, ids, w_o, w_l, split=True):
    """(o, lse [Tq, nH], dq, dk, dv) of sum(o w_o) + sum(lse w_l) over live
    rows, as the bf16 kernels and `_FlashAttention.backward` compute them."""
    sm = 1.0 / np.sqrt(q.shape[-1])
    o, lse = _emulated_fwd(q, k, v, ids, sm, split)
    live = lse > -5e29
    dd = torch.where(live, w_l.t(), 0.0) - (o * w_o).sum(-1).t()
    dq = _emulated_dq(q, k, v, w_o, lse, dd, ids, sm, split)
    dk, dv = _emulated_dkv(q, k, v, w_o, lse, dd, ids, sm, split)
    return o, lse.t(), dq, dk, dv, dd


def _ratio(x, ref, tol):
    a, rtol = tol
    return ((x - ref).abs() / (a * ref.abs().max() + rtol * ref.abs())).max().item()


def _design_case(case, seed=0):
    """chip_smoke's flash cases at T 512 with Qwen2.5-1.5B heads: a packed
    stream with a 45-row pad tail, or a query chunk against an earlier,
    overlapping kv chunk with a keyless segment and a gradient through lse.
    Inputs are bf16 values held in f32."""
    nH, nKV, hd = QWEN15
    T = 512
    rng = np.random.default_rng(seed)
    if case == "packed":
        seg_q = seg_k = _segments(T, 3, 45, rng)
        pos_q = pos_k = np.arange(T, dtype=np.int32)
    else:
        pos_k = np.arange(1000, 1000 + T, dtype=np.int32)
        pos_q = pos_k + T // 2
        seg_k, seg_q = pos_k // 300, pos_q // 300
        seg_q[100:150] = 10 ** 6  # no key of this segment: fully masked rows
        seg_q[-45:] = tfa.PADDING_SEGMENT
    q, k, v, w_o = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
                    for s in ((T, nH, hd), (T, nKV, hd), (T, nKV, hd), (T, nH, hd)))
    w_l = (_bf(torch.from_numpy(rng.standard_normal((T, nH)).astype(np.float32)))
           if case == "chunk" else torch.zeros(T, nH))
    ids = [torch.from_numpy(np.ascontiguousarray(a)) for a in (seg_q, seg_k, pos_q, pos_k)]
    return q, k, v, ids, w_o, w_l


def _plain_with_grads(q, k, v, ids, w_o, w_l):
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tfa.flash_attention_ref(*qkv, *ids)
    live = lse > -5e29
    loss = (o * w_o).sum() + (torch.where(live, lse, 0.0) * w_l).sum()
    return (o.detach(), lse.detach(), *torch.autograd.grad(loss, qkv))


@pytest.mark.parametrize("case,seed", [("packed", 0), ("packed", 1), ("packed", 2),
                                       ("chunk", 0)])
def test_bf16_kernel_numerics_hold_the_chip_tolerances(case, seed):
    """The emulated bf16 kernels (P and dS as hi + lo) against the plain
    version with autograd at phase_flash_kernel's tolerances: K1's o and
    lse, K2a's dq (its reference carrying the delta term, see the next
    test), K2b's dk and dv. At the flash line's train-shape tolerance,
    against the plain versions fed the same lse and dd: o, dq, dk, dv."""
    q, k, v, ids, w_o, w_l = _design_case(case, seed)
    got = _emulated_kernels(q, k, v, ids, w_o, w_l)
    ref = _plain_with_grads(q, k, v, ids, w_o, w_l)
    live = ref[1] > -5e29
    assert torch.equal(got[1][~live], torch.full_like(got[1][~live], -1e30))
    assert torch.equal(got[0][~live], torch.zeros_like(got[0][~live]))
    assert _ratio(got[1][live], ref[1][live], LSE_TOL) <= 1.0
    for name, j in (("o", 0), ("dk", 3), ("dv", 4)):
        assert _ratio(got[j], ref[j], BF16_TOL) <= 1.0, name
    sm = 1.0 / np.sqrt(q.shape[-1])
    term = chip_smoke._dq_delta_term(q, k, ids, got[0], ref[0], w_o, sm)
    assert _ratio(got[2], ref[2] + term, BF16_TOL) <= 1.0, "dq"
    # the train-shape check: the same lse and dd on both sides
    o, lse, dq, dk, dv, dd = got
    lse_k = lse.t().contiguous()
    ro, _ = tfa.flash_attention_ref(q, k, v, *ids)
    rdq = tfa.flash_bwd_dq_ref(q, k, v, w_o, lse_k, dd, *ids, sm)
    rdk, rdv = tfa.flash_bwd_dkv_ref(q, k, v, w_o, lse_k, dd, *ids, sm)
    for name, x, r in (("o", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert _ratio(x, r, TRAIN_SHAPE_TOL) <= 1.0, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_dq_distance_is_delta_of_the_bf16_output(seed):
    """dq through autograd: the backward's delta = rowsum(dO * O) reads the
    bf16 O (as the JAX kernel does on bf16 inputs), an error shared by a
    whole row of ds that dq sums coherently; at seed 2 it takes dq to 1.24x
    phase_flash_kernel's bf16 tolerance. chip_smoke's reference carries that
    term exactly (`_dq_delta_term`: ds is linear in delta) at the unchanged
    tolerance; with delta from the f32 O, the emulated K2a holds it bare."""
    q, k, v, ids, w_o, w_l = _design_case("packed", seed)
    got = _emulated_kernels(q, k, v, ids, w_o, w_l)
    ref = _plain_with_grads(q, k, v, ids, w_o, w_l)
    sm = 1.0 / np.sqrt(q.shape[-1])
    term = chip_smoke._dq_delta_term(q, k, ids, got[0], ref[0], w_o, sm)
    bare, held = _ratio(got[2], ref[2], BF16_TOL), _ratio(got[2], ref[2] + term, BF16_TOL)
    assert held <= 1.0, (bare, held)
    if seed == 2:
        assert bare > 1.0, bare
    o32, _ = tfa.flash_attention_ref(q, k, v, *ids)
    dd = -(o32 * w_o).sum(-1).t()
    dq = _emulated_dq(q, k, v, w_o, got[1].t(), dd, ids, sm, True)
    assert _ratio(dq, ref[2], BF16_TOL) <= 1.0


def test_single_bf16_term_would_miss_the_train_shape_tolerance():
    """Why P and dS are split: as one bf16 term (FlashAttention-2's choice)
    o, dq, dk and dv land tens of times outside the train-shape check's
    2e-5 absolute term, while hi + lo stays inside it."""
    q, k, v, ids, w_o, w_l = _design_case("packed", seed=1)
    sm = 1.0 / np.sqrt(q.shape[-1])
    ro, _ = tfa.flash_attention_ref(q, k, v, *ids)
    for split, inside in ((True, True), (False, False)):
        o, lse = _emulated_fwd(q, k, v, ids, sm, split)
        dd = (-(o * w_o).sum(-1).t()).contiguous()
        dq = _emulated_dq(q, k, v, w_o, lse, dd, ids, sm, split)
        dk, dv = _emulated_dkv(q, k, v, w_o, lse, dd, ids, sm, split)
        rdq = tfa.flash_bwd_dq_ref(q, k, v, w_o, lse, dd, *ids, sm)
        rdk, rdv = tfa.flash_bwd_dkv_ref(q, k, v, w_o, lse, dd, *ids, sm)
        ratios = [_ratio(o, ro, TRAIN_SHAPE_TOL), _ratio(dq, rdq, TRAIN_SHAPE_TOL),
                  _ratio(dk, rdk, TRAIN_SHAPE_TOL), _ratio(dv, rdv, TRAIN_SHAPE_TOL)]
        if inside:
            assert max(ratios) <= 1.0, ratios
        else:
            assert min(ratios) > 5.0, ratios


@pytest.mark.parametrize("case", ["packed", "chunk"])
def test_bf16_kernel_numerics_match_jax_pallas(case):
    """The emulated bf16 kernels against the JAX Pallas kernels (interpret
    mode) on the same bf16-valued inputs, at phase_flash_kernel's bf16
    tolerances (lse at its f32 one): K1's o and lse, K2a's dq (the JAX
    reference with the delta term of the kernels' bf16 O against its own),
    K2b's dk and dv."""
    q, k, v, ids, w_o, w_l = _design_case(case, seed=2)
    got = _emulated_kernels(q, k, v, ids, w_o, w_l)
    jids = [jnp.asarray(t.numpy()) for t in ids]

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_chunk(q, k, v, *jids, block_q=128, block_k=128,
                                           interpret=True)
        live = lse > -5e29
        return (jnp.sum(o * w_o.numpy()) + jnp.sum(jnp.where(live, lse, 0.0) * w_l.numpy()),
                (o, lse))

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(x)) for x in (jo, jl, *jg)]
    live = want[1] > -5e29
    assert _ratio(got[1][live], want[1][live], LSE_TOL) <= 1.0
    for name, j in (("o", 0), ("dk", 3), ("dv", 4)):
        assert _ratio(got[j], want[j], BF16_TOL) <= 1.0, name
    term = chip_smoke._dq_delta_term(q, k, ids, got[0], want[0], w_o, 1.0 / np.sqrt(q.shape[-1]))
    assert _ratio(got[2], want[2] + term, BF16_TOL) <= 1.0, "dq"


# ---------------------------------------------------------------------------
# The segment layout, built once per micro-batch
# ---------------------------------------------------------------------------


def test_packed_layout_holds_what_the_kernels_read():
    seg = torch.from_numpy(_segments(150, 3, 9, np.random.default_rng(0)))
    builds = tfa.layout_builds
    lay = tfa.packed_layout(seg.long())
    assert tfa.layout_builds == builds + 1
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in lay)
    assert torch.equal(lay.seg_q, seg) and torch.equal(lay.seg_k, seg)
    assert torch.equal(lay.pos_q, torch.arange(150, dtype=torch.int32))
    assert torch.equal(lay.pos_k, lay.pos_q)
    assert torch.equal(lay.meta_q, tfa.tile_meta(seg, lay.pos_q, queries=True))
    assert torch.equal(lay.meta_k, tfa.tile_meta(seg, lay.pos_k, queries=False))
    assert lay.meta_q.shape == (3, 3)  # 150 rows: three 64-row tiles


def test_bf16_kernels_refuse_misaligned_rows():
    """K1, K2a and K2b copy 16-byte rows with cp.async: a bf16 tensor whose
    storage starts off a 16-byte boundary raises (no silent copy), in each
    launcher before any kernel is built; f32 inputs go to the first
    version, which reads elements."""
    base = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    tfa._check_aligned(q=base[:512].view(8, 4, 16))
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_aligned(q=base[1:513].view(8, 4, 16))
    tfa._check_aligned(q=torch.zeros(513)[1:].view(8, 4, 16))
    q = base[1:513].view(8, 4, 16)
    kv = torch.zeros(8, 2, 16, dtype=torch.bfloat16)
    ids = tfa.packed_layout(torch.zeros(8, dtype=torch.int32))
    rows = torch.zeros(4, 8)
    for launch in (lambda: tfa.flash_fwd(q, kv, kv, *ids, 0.25),
                   lambda: tfa.flash_bwd_dq(q, kv, kv, q, rows, rows, *ids, 0.25),
                   lambda: tfa.flash_bwd_dkv(q, kv, kv, q, rows, rows, *ids, 0.25)):
        with pytest.raises(ValueError, match="16-byte"):
            launch()


def test_model_builds_the_layout_once_per_forward(monkeypatch):
    """`models/qwen2.forward` builds the flash layout once and hands it to
    every layer and every remat rerun; outputs and gradients are bit for bit
    those of the per-call layout (each attention call building its own)."""
    from areal_tpu_torch.models import qwen2 as tq

    cfg = tq.ModelConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                         num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
                         dtype="float32", param_dtype="float32", scan_layers=False, remat=True)
    base = tq.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    T = 90
    ids = torch.from_numpy(rng.integers(0, 64, T))
    seg = torch.from_numpy(_segments(T, 3, 7, rng))
    pos = torch.arange(T)
    calls = []
    real = tq.flash_attention

    def per_call(q, k, v, layout):
        calls.append(layout)
        return real(q, k, v, tfa.packed_layout(layout.seg_q))  # its own, as before

    results = {}
    for mode in ("once", "per_call"):
        if mode == "per_call":
            monkeypatch.setattr(tq, "flash_attention", per_call)
        params = {n: t.clone().requires_grad_() for n, t in base.items()}
        builds = tfa.layout_builds
        out = tq.forward(params, ids, pos, seg, cfg)
        out.square().mean().backward()
        results[mode] = (out.detach(), {n: p.grad for n, p in params.items()},
                         tfa.layout_builds - builds)
    (o1, g1, n1), (o2, g2, n2) = results["once"], results["per_call"]
    assert n1 == 1  # the forward's; the remat reruns reuse it
    assert n2 == 1 + 2 * cfg.num_hidden_layers  # plus one per layer, forward and rerun
    assert len(calls) == 2 * cfg.num_hidden_layers
    assert all(lay is calls[0] and isinstance(lay, tfa.FlashLayout) for lay in calls)
    assert torch.equal(o1, o2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
