"""The bf16 decode kernels' numerics design (K3, K5a), emulated on the CPU.

The tensor-core route of `csrc/paged_attention.cu` (`paged_attn_mma_kernel`,
`paged_attn_q8_mma_kernel` and their combine passes) computes each
(slot, kv head)'s single-token attention split by split over the block
table: a split owns `pages_per_split` pages and walks them in 64-row
tiles; warp w of its four takes rows 16w..16w+15 of every tile and keeps
its own online-softmax state (m, l, acc) over those keys. Per warp and
tile: bf16 Q and K (int8 K for K5a, exact in bf16) are multiplied with f32
sums; K5a's K scale multiplies score column j after the product; scores
are in log2 units; P (times K5a's V scale) goes to P V as bf16 hi + lo, the
16-key stage summed from zero. At the split's end the four warps' states
are merged in warp order with the combine's formula; each split then
writes f32 partials and the combine pass reads them in split order (one
split: the split kernel writes acc / l itself). `_emulate_decode` below
follows that rounding.

It is held, on numpy-seeded inputs, against the port's plain version
`paged_attention_ref` and the JAX package's `paged_attention` (the XLA
path and the Pallas kernel in interpret mode, both f32), at
`chip_smoke.py`'s bf16 tolerance `KERNEL_TOL`: |x - ref| <= 1e-5 + 2^-8
|ref|. A slot with no valid row must give exactly 0 (the JAX XLA path gives
the mean of the gathered V rows there, so it is compared on the others).

The inputs cover splits of 1, 2 and 4 pages and the whole table, a slot
with no valid row, a slot whose rows end on a split boundary, a slot
ending mid-page, 16- and 40-row pages (40: a tile crosses pages, a
split's last tile is partial, a warp's quarter may hold no row), GQA
groups 2, 6 and 7, and fp and int8 pools.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu.ops.paged_attention import paged_attention as jax_paged_attention
from areal_tpu_torch.ops import paged_attention as pa
from tests.test_torch_paged_verify_design import TOL, _bf, _int8, _merge, _output, _terms

_LOG2E = 1.4426950408889634
_TILE = 64  # K/V rows per tile
_WARPS = 4  # warps per block, each a quarter of every tile
_QUARTER = _TILE // _WARPS
R, NKV, HD, NB = 4, 2, 32, 6


@functools.lru_cache(maxsize=None)
def _inputs(group, bsz, quant, seed=0):
    """Slot 0 has no valid row, slot 1 ends mid-page, slot 2 fills the
    span, slot 3 ends on the 4-page boundary (a split boundary at 1, 2 and
    4 pages per split). Values are bf16 (q, fp pools) or int8 with f32
    scales, held in f32 tensors."""
    rng = np.random.default_rng(seed + group + 1000 * bsz)
    nH, span = NKV * group, NB * bsz
    n_blocks = R * NB + 1
    lengths = np.array([-1, 2 * bsz + bsz // 2, span - 1, 4 * bsz - 1])
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, NB), np.int32)
    for r in range(R):
        used = -(-(int(lengths[r]) + 1) // bsz)
        table[r, :used] = perm[r * NB: r * NB + used]
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((R, nH, HD), (n_blocks, bsz, NKV, HD), (n_blocks, bsz, NKV, HD)))
    valid = np.arange(span)[None, :] <= lengths[:, None]
    pools = tuple(_int8(x) for x in (k, v)) if quant else (k, v)
    return q, pools, torch.from_numpy(table), torch.from_numpy(valid)


def _emulate_decode(q, k_pool, v_pool, table, valid, pps, split=True):
    """The bf16 decode kernels' output (rounded to bf16) with `pps` pages
    per split; `split` False feeds P as one bf16 term."""
    (kd, ks), (vd, vs) = (p if isinstance(p, tuple) else (p, None) for p in (k_pool, v_pool))
    Rq, nH, hd = q.shape
    bsz, nKV = kd.shape[1], kd.shape[2]
    nb = table.shape[1]
    group, span = nH // nKV, nb * bsz
    idx = table.reshape(-1).long()
    # rows a warp's quarter holds: valid, else zero-filled
    live = valid[:, :, None, None]
    kc = torch.where(live, kd.float()[idx].reshape(Rq, span, nKV, hd), 0.0)
    vc = torch.where(live, vd.float()[idx].reshape(Rq, span, nKV, hd), 0.0)
    scale2 = 1.0 / math.sqrt(hd) * _LOG2E
    if ks is not None:  # the scale strips, per row [R, nKV, span]
        ksc, vsc = (torch.where(valid[:, None], s[idx].reshape(Rq, nb, nKV, bsz)
                                .permute(0, 2, 1, 3).reshape(Rq, nKV, span), 0.0) for s in (ks, vs))
    qg = q.reshape(Rq, nKV, group, hd)
    mask = valid[:, None, None, :]  # [R, 1, 1, span]
    parts = []
    for start in range(0, span, pps * bsz):
        end = min(start + pps * bsz, span)
        warps = []
        for w in range(_WARPS):
            m = torch.full((Rq, nKV, group, 1), -1e30)
            l = torch.zeros(Rq, nKV, group, 1)
            acc = torch.zeros(Rq, nKV, group, hd)
            # a quarter with no valid row leaves (m, l, acc) as they are, so
            # every tile is taken here, as the kernels take only the live ones
            for t0 in range(start + _QUARTER * w, end, _TILE):
                t1 = min(t0 + _QUARTER, end)
                s = torch.einsum("rkgd,rskd->rkgs", qg, kc[:, t0:t1])
                f = ksc[:, :, None, t0:t1] * scale2 if ks is not None else scale2
                s = torch.where(mask[..., t0:t1], s * f, -1e30)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.where(m_new > -5e29, torch.exp2(s - m_new), 0.0)
                l = l * alpha + p.sum(-1, keepdim=True)
                if vs is not None:
                    p = p * vsc[:, :, None, t0:t1]
                acc = acc * alpha + torch.einsum("rkgs,rskd->rkgd", _terms(p, split), vc[:, t0:t1])
                m = m_new
            warps.append((m, l, acc))
        parts.append(_merge(warps))  # the warps in order, within the block
    return _bf(_output(parts).reshape(Rq, nH, hd))


def _jax(q, pools, table, valid, quant, **kw):
    j = (lambda p: tuple(jnp.asarray(x.numpy()) for x in p)) if quant else (
        lambda p: jnp.asarray(p.numpy()))
    out = jax_paged_attention(jnp.asarray(q.numpy()), j(pools[0]), j(pools[1]),
                              jnp.asarray(table.numpy()), jnp.asarray(valid.numpy()), **kw)
    return torch.from_numpy(np.array(out))


@functools.lru_cache(maxsize=None)
def _references(group, bsz, quant):
    """(plain version, JAX XLA path, JAX Pallas kernel in interpret mode),
    all f32."""
    q, pools, table, valid = _inputs(group, bsz, quant)
    plain = pa.paged_attention_ref(q, *pools, table, valid)
    xla = _jax(q, pools, table, valid, quant, impl="xla")
    pallas = _jax(q, pools, table, valid, quant, impl="pallas", interpret=True)
    return plain, xla, pallas


@pytest.mark.parametrize("pps", [1, 2, 4, None], ids=["pages1", "pages2", "pages4", "whole"])
@pytest.mark.parametrize("group", [2, 6, 7])
@pytest.mark.parametrize("bsz", [16, 40])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_emulated_kernels_hold_the_chip_tolerance(quant, bsz, group, pps):
    q, pools, table, valid = _inputs(group, bsz, quant)
    got = _emulate_decode(q, *pools, table, valid, pps or NB)
    plain, xla, pallas = _references(group, bsz, quant)
    assert not valid[0].any() and valid[1:].any(-1).all()
    assert torch.equal(got[0], torch.zeros_like(got[0]))  # no valid row: exactly 0
    assert chip_smoke._tol_ratio(got, plain, *TOL) <= 1.0
    assert chip_smoke._tol_ratio(got, pallas, *TOL) <= 1.0
    assert chip_smoke._tol_ratio(got[1:], xla[1:], *TOL) <= 1.0


def test_split_boundary_case_ends_a_split():
    """Slot 3's last valid row is the last row of page 4: splits of 1, 2
    and 4 pages end there, and the splits after it hold no valid row;
    slot 1 ends mid-page."""
    for bsz in (16, 40):
        _, _, table, valid = _inputs(7, bsz, False)
        assert int(valid[3].nonzero().max()) == 4 * bsz - 1
        assert (table[3, 4:] == 0).all() and (table[3, :4] > 0).all()
        assert (int(valid[1].nonzero().max()) + 1) % bsz


def test_single_bf16_term_would_miss_the_tolerance():
    """Why P goes as hi + lo: one slot with a 16,384-row context (one page
    per split) whose output sits near the bf16 tolerance's edge. With P as
    one bf16 term the emulated kernel lands outside `KERNEL_TOL`; with
    hi + lo it stays inside."""
    rng = np.random.default_rng(7)
    group, bsz, nb = 7, 128, 128
    nH, span = NKV * group, nb * bsz
    q, k, v = (_bf(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
               for s in ((1, nH, HD), (nb, bsz, NKV, HD), (nb, bsz, NKV, HD)))
    table = torch.arange(nb, dtype=torch.int32)[None]
    valid = torch.ones(1, span, dtype=torch.bool)
    ref = pa.paged_attention_ref(q, k, v, table, valid)
    two = chip_smoke._tol_ratio(_emulate_decode(q, k, v, table, valid, 1), ref, *TOL)
    one = chip_smoke._tol_ratio(_emulate_decode(q, k, v, table, valid, 1, split=False), ref, *TOL)
    assert two <= 1.0 < one, (two, one)


def test_decode_pages_per_split_rule():
    """The decode wrapper's split: two pages per block at the serve batch
    (R 16, Qwen2.5-7B's 4 kv heads, 9-10 pages of 128 rows, 132 SMs) and at
    the train rollout batch (R 32, 2 kv heads, 8 pages), the fastest of
    the sweep on the card, and 1, 4 and 8 for the serve batch's tables of
    4, 16 and 32 pages; in general the most pages (a power of two) that
    keep `DECODE_MIN_BLOCKS_PER_SM` blocks per SM, never more than
    `VERIFY_MAX_SPLIT_ROWS` rows or the table."""
    assert pa.decode_pages_per_split(10, 128, 16, 4, 132) == 2
    assert pa.decode_pages_per_split(9, 128, 16, 4, 132) == 2
    assert pa.decode_pages_per_split(8, 128, 32, 2, 132) == 2
    assert [pa.decode_pages_per_split(nb, 128, 16, 4, 132) for nb in (4, 16, 32)] == [1, 4, 8]
    floor = pa.DECODE_MIN_BLOCKS_PER_SM * 132
    for nb, bsz, Rs, nkv in [(10, 128, 16, 4), (32, 128, 64, 4), (256, 16, 32, 8), (4096, 1, 16, 4),
                             (3, 256, 2000, 8), (5, 40, 1, 1), (64, 128, 256, 8)]:
        pps = pa.decode_pages_per_split(nb, bsz, Rs, nkv, 132)
        assert pps * bsz <= pa.VERIFY_MAX_SPLIT_ROWS and 1 <= pps <= nb
        if pps > 1:  # the grid at pps keeps the floor
            assert Rs * nkv * -(-nb // pps) >= floor or pps == nb
        at_cap = 2 * pps * bsz > pa.VERIFY_MAX_SPLIT_ROWS or pps >= nb
        assert at_cap or Rs * nkv * -(-nb // (2 * pps)) < floor  # twice as many would not
