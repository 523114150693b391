"""The bf16 verify kernels' numerics design (K4, K5b), emulated on the CPU.

The tensor-core route of `csrc/paged_attention.cu` (`paged_verify_mma_kernel`,
`paged_verify_q8_mma_kernel` and their combine passes) computes each
(slot, kv head)'s attention split by split over the block table: a split
owns `pages_per_split` pages and walks them in 64-row tiles; bf16 Q and K
(int8 K for K5b, exact in bf16) are multiplied with f32 sums; K5b's K scale
multiplies score column j after the product; scores are in log2 units; the
online softmax keeps (m, l, acc) per split; P (times K5b's V scale) goes to
P V as bf16 hi + lo, each 16-key stage summed from zero; each split writes
f32 partials and the combine pass reads them in split order:
out = sum 2^(m_s - M*) acc_s / sum 2^(m_s - M*) l_s over the splits with
l_s > 0, and 0 where there is none. `_emulate` below follows that rounding.

It is held, on numpy-seeded inputs, against the port's plain version
`paged_attention_qlen_ref` and the JAX package's `paged_attention_qlen`
(XLA path, f32), at `chip_smoke.py`'s bf16 tolerance `KERNEL_TOL`:
|x - ref| <= 1e-5 + 2^-8 |ref| (the output's own bf16 rounding, to nearest,
moves a value by up to 2^-8 of itself; 1e-5 is the f32 summation term).
Queries with no valid row must give exactly 0 (the JAX XLA path gives the
mean of the gathered V rows there, so it is compared on the other queries).

The inputs cover splits of 1, 2 and 4 pages and the whole table, a slot
with no valid row, a query with no valid row, a slot whose rows end on a
split boundary, 16- and 40-row pages (40: a tile crosses pages, a split's
last tile is partial), W 2, 5 and 9 at GQA groups 6 and 7, and fp and
int8 pools.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu.ops.paged_attention import paged_attention_qlen as jax_qlen
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.ops.kv_quant import quantize_kv

TOL = chip_smoke.KERNEL_TOL[torch.bfloat16]  # (1e-5, 2^-8)
assert TOL == (1e-5, 2.0 ** -8)
_LOG2E = 1.4426950408889634
_TILE = 64  # K/V rows per tile
_STAGE = 16  # keys per P V stage
R, NKV, HD, NB = 4, 2, 32, 6


def _bf(x):
    return x.to(torch.bfloat16).float()


def _terms(x, split):
    """x as the kernels feed it to a product: bf16 hi (+ bf16 lo)."""
    hi = _bf(x)
    return hi + _bf(x - hi) if split else hi


@functools.lru_cache(maxsize=None)
def _inputs(W, group, bsz, quant, seed=0):
    """Slot r's query w attends rows s <= base[r] + w: slot 0 none, slot 1
    none for query 0, slot 2 the whole span, slot 3 ending on the 4-page
    boundary (a split boundary at 1, 2 and 4 pages per split). Values are
    bf16 (q, fp pools) or int8 with f32 scales, held in f32 tensors."""
    rng = np.random.default_rng(seed + 100 * W + group + bsz)
    nH, span = NKV * group, NB * bsz
    n_blocks = R * NB + 1
    base = np.array([-W, -1, span - W, 4 * bsz - W])
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, NB), np.int32)
    for r in range(R):
        used = -(-max(int(base[r]) + W, 0) // bsz)
        table[r, :used] = perm[r * NB: r * NB + used]
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((R, W, nH, HD), (n_blocks, bsz, NKV, HD), (n_blocks, bsz, NKV, HD)))
    valid = np.arange(span)[None, None, :] <= (base[:, None] + np.arange(W))[:, :, None]
    pools = tuple(_int8(x) for x in (k, v)) if quant else (k, v)
    return q, pools, torch.from_numpy(table), torch.from_numpy(valid)


def _int8(pool):
    """(int8 data, f32 scales [n_blocks, nKV, bsz]), as the engine stores them."""
    data, sc = quantize_kv(pool)
    return data, sc.transpose(1, 2).contiguous()


def _emulate(q, k_pool, v_pool, table, valid, pps, split=True):
    """The bf16 kernels' output (rounded to bf16) with `pps` pages per
    split; `split` False feeds P as one bf16 term."""
    (kd, ks), (vd, vs) = (p if isinstance(p, tuple) else (p, None) for p in (k_pool, v_pool))
    Rq, W, nH, hd = q.shape
    bsz, nKV = kd.shape[1], kd.shape[2]
    nb = table.shape[1]
    group, span = nH // nKV, nb * bsz
    M = W * group
    idx = table.reshape(-1).long()
    # rows a kernel tile holds: valid for some query, else zero-filled
    live = valid.any(1)[:, :, None, None]
    kc = torch.where(live, kd.float()[idx].reshape(Rq, span, nKV, hd), 0.0)
    vc = torch.where(live, vd.float()[idx].reshape(Rq, span, nKV, hd), 0.0)
    scale2 = 1.0 / math.sqrt(hd) * _LOG2E
    if ks is not None:  # the scale strips, per row [R, nKV, span]
        ksc = torch.where(valid.any(1)[:, None], ks[idx].reshape(Rq, nb, nKV, bsz)
                          .permute(0, 2, 1, 3).reshape(Rq, nKV, span), 0.0)
        vsc = torch.where(valid.any(1)[:, None], vs[idx].reshape(Rq, nb, nKV, bsz)
                          .permute(0, 2, 1, 3).reshape(Rq, nKV, span), 0.0)
    qg = q.reshape(Rq, W, nKV, group, hd).permute(0, 2, 1, 3, 4).reshape(Rq, nKV, M, hd)
    mask = valid.repeat_interleave(group, dim=1)[:, None]  # [R, 1, M, span]
    parts = []
    for start in range(0, span, pps * bsz):
        end = min(start + pps * bsz, span)
        m = torch.full((Rq, nKV, M, 1), -1e30)
        l = torch.zeros(Rq, nKV, M, 1)
        acc = torch.zeros(Rq, nKV, M, hd)
        # a tile no query reads leaves (m, l, acc) as they are, so every
        # tile is taken here, as the kernels take only the live ones
        for t0 in range(start, end, _TILE):
            t1 = min(t0 + _TILE, end)
            s = torch.einsum("rkmd,rskd->rkms", qg, kc[:, t0:t1])
            f = ksc[:, :, None, t0:t1] * scale2 if ks is not None else scale2
            s = torch.where(mask[..., t0:t1], s * f, -1e30)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(m_new > -5e29, torch.exp2(s - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            if vs is not None:
                p = p * vsc[:, :, None, t0:t1]
            acc = acc * alpha
            for j0 in range(0, t1 - t0, _STAGE):
                acc = acc + torch.einsum("rkms,rskd->rkmd", _terms(p[..., j0:j0 + _STAGE], split),
                                         vc[:, t0 + j0:min(t0 + j0 + _STAGE, t1)])
            m = m_new
        parts.append((m, l, acc))
    out = _output(parts)
    return _bf(out.reshape(Rq, nKV, W, group, hd).permute(0, 2, 1, 3, 4).reshape(Rq, W, nH, hd))


def _merge(parts):
    """The combine's formula over (m, l, acc) states in order: M* the
    largest m among those with l > 0, then sum 2^(m - M*) acc and sum
    2^(m - M*) l over them; m -1e30 where none has l > 0."""
    mx = torch.full_like(parts[0][0], -1e30)
    for m, l, _ in parts:
        mx = torch.where(l > 0, torch.maximum(mx, m), mx)
    num, den = torch.zeros_like(parts[0][2]), torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        c = torch.where(l > 0, torch.exp2(m - mx), 0.0)
        num = num + c * acc
        den = den + c * l
    return torch.where(den > 0, mx, -1e30), den, num


def _output(parts):
    """The splits' states to the f32 output: with one split the split
    kernel writes acc / l itself, else the combine pass merges them in
    split order; 0 where no row was valid."""
    if len(parts) == 1:  # the split kernel writes the output itself
        _, l, acc = parts[0]
    else:  # the combine pass, splits in order
        _, l, acc = _merge(parts)
    return acc / torch.where(l > 0, l, 1.0)


@functools.lru_cache(maxsize=None)
def _references(W, group, bsz, quant):
    """(plain version, JAX XLA path), both f32."""
    q, (kp, vp), table, valid = _inputs(W, group, bsz, quant)
    plain = pa.paged_attention_qlen_ref(q, kp, vp, table, valid)
    j = (lambda p: tuple(jnp.asarray(x.numpy()) for x in p)) if quant else (
        lambda p: jnp.asarray(p.numpy()))
    theirs = jax_qlen(jnp.asarray(q.numpy()), j(kp), j(vp), jnp.asarray(table.numpy()),
                      jnp.asarray(valid.numpy()), impl="xla")
    return plain, torch.from_numpy(np.array(theirs))


@pytest.mark.parametrize("pps", [1, 2, 4, None], ids=["pages1", "pages2", "pages4", "whole"])
@pytest.mark.parametrize("W,group", [(2, 6), (5, 6), (9, 6), (2, 7), (5, 7), (9, 7)])
@pytest.mark.parametrize("bsz", [16, 40])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_emulated_kernels_hold_the_chip_tolerance(quant, bsz, W, group, pps):
    q, (kp, vp), table, valid = _inputs(W, group, bsz, quant)
    got = _emulate(q, kp, vp, table, valid, pps or NB)
    plain, theirs = _references(W, group, bsz, quant)
    empty = ~valid.any(-1)  # [R, W]
    assert empty[0].all() and empty[1, 0] and not empty[1, 1:].any() and not empty[2:].any()
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    assert chip_smoke._tol_ratio(got, plain, *TOL) <= 1.0
    assert chip_smoke._tol_ratio(got[~empty], theirs[~empty], *TOL) <= 1.0


def test_split_boundary_case_ends_a_split():
    """Slot 3's last valid row is the last row of page 4: splits of 1, 2
    and 4 pages end there, and the splits after it hold no valid row."""
    for bsz in (16, 40):
        _, _, table, valid = _inputs(5, 7, bsz, False)
        last = int(valid[3].any(0).nonzero().max())
        assert last == 4 * bsz - 1
        assert (table[3, 4:] == 0).all() and (table[3, :4] > 0).all()


def test_single_bf16_term_would_miss_the_tolerance():
    """Why P goes as hi + lo: one long-row query (a 16,384-row context,
    one page per split) whose output sits near the bf16 tolerance's edge.
    With P as one bf16 term the emulated kernel lands outside
    `KERNEL_TOL` (2.4x it here; up to 131x on the small cases above); with
    hi + lo it stays inside (0.84)."""
    rng = np.random.default_rng(7)
    W, group, bsz, nb = 1, 7, 128, 128
    nH, span = NKV * group, nb * bsz
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((1, W, nH, HD), (nb, bsz, NKV, HD), (nb, bsz, NKV, HD)))
    table = torch.arange(nb, dtype=torch.int32)[None]
    valid = torch.ones(1, W, span, dtype=torch.bool)
    ref = pa.paged_attention_qlen_ref(q, k, v, table, valid)
    two = chip_smoke._tol_ratio(_emulate(q, k, v, table, valid, 1), ref, *TOL)
    one = chip_smoke._tol_ratio(_emulate(q, k, v, table, valid, 1, split=False), ref, *TOL)
    assert two <= 1.0 < one, (two, one)


def test_pages_per_split_rule():
    """The wrapper's split: two pages per block at the spec batch (R 16,
    Qwen2.5-7B's 4 kv heads, 9 pages of 128 rows, 132 SMs), the fastest of
    the sweep on the card; in general the most pages (a power of two) that
    keep `VERIFY_MIN_BLOCKS_PER_SM` blocks per SM, never more than
    `VERIFY_MAX_SPLIT_ROWS` rows or the table."""
    assert pa.verify_pages_per_split(9, 128, 16, 4, 132) == 2
    assert pa.verify_pages_per_split(32, 128, 16, 4, 132) == 4
    floor = pa.VERIFY_MIN_BLOCKS_PER_SM * 132
    for nb, bsz, Rs, nkv in [(9, 128, 16, 4), (32, 128, 64, 4), (256, 16, 32, 8), (4096, 1, 16, 4),
                             (3, 256, 2000, 8), (5, 40, 1, 1)]:
        pps = pa.verify_pages_per_split(nb, bsz, Rs, nkv, 132)
        assert pps * bsz <= pa.VERIFY_MAX_SPLIT_ROWS and 1 <= pps <= nb
        if pps > 1:  # the grid at pps keeps the floor
            assert Rs * nkv * -(-nb // pps) >= floor or pps == nb
        at_cap = 2 * pps * bsz > pa.VERIFY_MAX_SPLIT_ROWS or pps >= nb
        assert at_cap or Rs * nkv * -(-nb // (2 * pps)) < floor  # twice as many would not
