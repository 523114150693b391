"""The bf16 int8-weight matmul kernel's design (K6), emulated on the CPU.

The bf16 route of `csrc/quant_matmul.cu` (`quant_matmul_sk_kernel`)
widens int8 weights to bf16 without a conversion instruction, deals
(row tile, n tile, k tile) units evenly over the blocks the card holds,
and finishes a tile cut between blocks by summing the blocks' f32
partials in block order. Three pieces are held here, on numpy-seeded
inputs at small shapes:

- the conversion, emulated with numpy `uint32` operations using the
  constants and `prmt` selectors as written in the `.cu` (read from the
  source): it must give `float(v)`'s bf16 bits for all 256 int8 values, in
  the fragment order the kernel uses (byte j of a word of 4 neighbouring
  columns feeds n8 fragment j; rows k and k + 1 share a register, k low);
- the work partition (`quant_matmul.plan`, `run_start`, `tile_segments`,
  the pure-Python copy of the kernel's arithmetic): every unit belongs to
  exactly one block, no block is empty, blocks differ by at most one unit,
  and each cut tile's segments come in block order with the partial slots
  the kernel writes and reads;
- the kernel's sum for bf16 x: each 16-deep mma step added into the stage
  sum with truncation (the tensor cores' f32 accumulation), each 64-deep
  stage summed from zero and added on the CUDA cores, a tile's segments
  summed in order from zero, the scale last, one bf16 rounding. It is held
  against JAX's `quant_einsum` (the XLA impl, and the Pallas kernel in
  interpret mode) at `chip_smoke.py`'s bf16 `QMM_TOL`, one case at K 18944,
  and a dropped segment must read above it.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from areal_tpu.ops.quant_matmul import quant_einsum as jax_quant_einsum
from areal_tpu_torch.ops import quant_matmul as qm

CU = (Path(qm.__file__).parent / "csrc" / "quant_matmul.cu").read_text()
TOL = chip_smoke.QMM_TOL[torch.bfloat16]
SMS = 132  # an H100's SMs

# (K, N) of Qwen2.5-7B's q/o, k/v, gate/up and down kernels, and two ragged
SHAPES_7B = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584)]
SHAPES = SHAPES_7B + [(3037, 777), (1000, 3536)]
TS = (1, 16, 17, 80, 700, 1024)


# -- the conversion ---------------------------------------------------------


def _cu_constants() -> dict:
    """The conversion's constants and `prmt` operands as the kernel source
    writes them."""
    body = re.search(r"float i8_as_f32\(uint32_t u, uint32_t exp_word\) \{(.*?)\n\}", CU,
                     re.S).group(1)
    pair = re.search(r"uint32_t bf16_pair\(float lo, float hi\) \{(.*?)\n\}", CU, re.S).group(1)
    operands = re.search(r'"r"\((\w+)\), "r"\((\w+)\), "n"\((0x[0-9A-Fa-f]+) \| J\)', body)
    return dict(exp_word=int(re.search(r"exp_word = (0x[0-9A-Fa-f]+)u;", CU).group(1), 16),
                operands=operands.group(1, 2), sel=int(operands.group(3), 16),
                sub=float(re.search(r"-\s*([0-9.]+)f;", body).group(1)),
                pair_sel=int(re.search(r"%2, (0x[0-9A-Fa-f]+);", pair).group(1), 16),
                xor=int(re.search(r"x80 = (0x[0-9A-Fa-f]+)u;", CU).group(1), 16))


def _prmt(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """PTX `prmt.b32` (default mode): byte i of the result is byte
    (sel >> 4 i) & 7 of {b, a}, a's bytes 0-3 and b's 4-7."""
    src = np.stack([(a >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
                   + [(b >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint32(8 * i)
    return out


def _emulate_fragments(w_k: np.ndarray, w_k1: np.ndarray) -> np.ndarray:
    """The kernel's bf16x2 registers from two weight words (rows k and
    k + 1, 4 neighbouring columns each): [..., j] for n8 fragment j."""
    c = _cu_constants()
    u0, u1 = w_k ^ np.uint32(c["xor"]), w_k1 ^ np.uint32(c["xor"])
    regs = []
    for j in range(4):
        f0, f1 = (_prmt(*[dict(u=u, exp_word=np.full_like(u, c["exp_word"]))[o]
                          for o in c["operands"]], c["sel"] | j).view(np.float32)
                  - np.float32(c["sub"]) for u in (u0, u1))
        regs.append(_prmt(f0.view(np.uint32), f1.view(np.uint32), c["pair_sel"]))
    return np.stack(regs, -1)


def _bf16_bits(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16).view(torch.int16).numpy() \
        .astype(np.uint16)


def test_conversion_constants_as_designed():
    """2^23 under the exponent, the byte in the low mantissa, 2^23 + 128
    subtracted, the upper halves packed with row k low; the constant word
    is `prmt`'s first source (a register in SASS), the selector the
    immediate."""
    c = _cu_constants()
    assert np.uint32(c["exp_word"]).view(np.float32) == 2.0 ** 23
    assert c["sub"] == 2.0 ** 23 + 128 and c["xor"] == 0x80808080
    assert c["operands"] == ("exp_word", "u")
    assert c["sel"] == 0x3004 and c["pair_sel"] == 0x7632


@pytest.mark.parametrize("rotate", [0, 1, 2, 3])
def test_conversion_is_exact_for_every_int8(rotate):
    """All 256 values, each in every byte position (rotated over the 4
    columns) and in both rows of a register: the bits of bf16(float(v)),
    row k in the low half, column 4g + j in fragment j."""
    v = np.roll(np.arange(-128, 128, dtype=np.int8).reshape(64, 4), rotate, axis=1)
    w_k = v.view(np.uint32).reshape(64)  # little-endian: column j is byte j
    v1 = v[::-1].copy()
    w_k1 = v1.view(np.uint32).reshape(64)
    regs = _emulate_fragments(w_k, w_k1)
    lo, hi = (regs & 0xFFFF).astype(np.uint16), (regs >> 16).astype(np.uint16)
    np.testing.assert_array_equal(lo, _bf16_bits(v.astype(np.float32)))
    np.testing.assert_array_equal(hi, _bf16_bits(v1.astype(np.float32)))


# -- the work partition -----------------------------------------------------


def _partition_checks(p: qm.Plan, resident: int) -> None:
    units = p.units
    assert p.grid == max(1, min(resident, units // qm.STAGES))
    starts = [qm.run_start(b, units, p.grid) for b in range(p.grid + 1)]
    sizes = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == units  # every unit, once
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1  # none empty, even
    written = np.zeros((p.grid, 2), int)
    for tile in range(p.m_tiles * p.n_tiles):
        segs = qm.tile_segments(p, tile)
        blocks = [s[0] for s in segs]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))  # block order
        first = tile * p.k_tiles
        assert segs[0][2] == first and segs[-1][3] == first + p.k_tiles - 1
        for (b, slot, lo, hi), nxt in zip(segs, segs[1:] + [None]):
            assert starts[b] <= lo <= hi < starts[b + 1]
            assert nxt is None or nxt[2] == hi + 1  # contiguous, in k order
            # the writer's slot: 0 for the segment its run starts with
            assert slot == int(lo != starts[b])
            if len(segs) > 1:
                written[b, slot] += 1
    assert written.max() <= 1  # no slot written twice in a launch


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_partition_covers_every_unit_once(K, N, T):
    mt, m_tiles = qm.row_tiles(T)
    assert 16 * mt * m_tiles >= T > 16 * mt * (m_tiles - 1) and mt <= qm.MAX_ROWS // 16
    if T <= qm.MAX_ROWS:
        assert m_tiles == 1  # each weight byte read once per call
    for blocks_per_sm in (1, 3):
        resident = blocks_per_sm * SMS
        p = qm.plan(T, K, N, resident)
        assert (p.n_tiles, p.k_tiles) == (-(-N // qm.TILE_N), -(-K // qm.TILE_K))
        _partition_checks(p, resident)


def test_partition_edge_cases():
    """A grid of one block, more blocks than units, and a grid that cuts
    every tile."""
    for T, K, N, resident in [(16, 64, 128, 1), (16, 64, 128, 528), (5, 1000, 30, 7),
                              (80, 640, 384, 29), (100, 128, 256, 3)]:
        _partition_checks(qm.plan(T, K, N, resident), resident)


# -- the kernel's sum -------------------------------------------------------


def _rtz(v: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero."""
    r = v.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(r, np.float32(0)), r)


def _emulate(x: np.ndarray, q: np.ndarray, s: np.ndarray, p: qm.Plan, drop=None) -> np.ndarray:
    """The kernel's output (f32 of its bf16) on plan `p`: bf16 x (as f32),
    int8 q, f32 s. `drop` (tile, segment index) leaves one segment out of
    its tile's sum."""
    T, K = x.shape
    N = q.shape[1]
    BT, BN, BK = 16 * p.mt, qm.TILE_N, qm.TILE_K
    xp = np.zeros((p.m_tiles * BT, p.k_tiles * BK))
    xp[:T, :K] = x
    qp = np.zeros((p.k_tiles * BK, p.n_tiles * BN))
    qp[:K, :N] = q
    out = np.zeros((p.m_tiles * BT, p.n_tiles * BN), np.float32)
    for tile in range(p.m_tiles * p.n_tiles):
        mi, ni = divmod(tile, p.n_tiles)
        xt = xp[mi * BT:(mi + 1) * BT]
        qt = qp[:, ni * BN:(ni + 1) * BN]
        # the exact sum of each 16-deep step, [k steps, BT, BN]
        steps = np.einsum("tsk,skn->stn", xt.reshape(BT, -1, 16),
                          qt.reshape(-1, 16, BN))
        total = np.zeros((BT, BN), np.float32)
        for si, (_, _, lo, hi) in enumerate(qm.tile_segments(p, tile)):
            acc = np.zeros((BT, BN), np.float32)
            for kt in range(lo - tile * p.k_tiles, hi - tile * p.k_tiles + 1):
                stage = np.zeros((BT, BN), np.float32)
                for st in steps[4 * kt:4 * kt + 4]:
                    stage = _rtz(stage.astype(np.float64) + st)
                acc = acc + stage  # f32, round to nearest
            if (tile, si) != drop:
                total = total + acc
        sp = np.zeros(p.n_tiles * BN, np.float32)
        sp[:N] = s
        out[mi * BT:(mi + 1) * BT, ni * BN:(ni + 1) * BN] = total * sp[ni * BN:(ni + 1) * BN]
    return torch.from_numpy(out[:T, :N]).to(torch.bfloat16).float().numpy()


@functools.lru_cache(maxsize=None)
def _case(T: int, K: int, N: int, seed: int = 0):
    """bf16-valued x (held in f32), int8 q and f32 scales absmax-quantized
    from normal weights, and JAX's `quant_einsum` on them in f32, as the XLA
    impl and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(seed + T + K + N)
    x = torch.from_numpy(rng.standard_normal((T, K)).astype(np.float32)).to(torch.bfloat16)
    x = x.float().numpy()
    w = rng.standard_normal((K, N)).astype(np.float32)
    s = np.abs(w).max(0) / 127.0
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    s = s.astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(q), jnp.asarray(s), 1)
    xla = np.asarray(jax_quant_einsum(*args, impl="xla"))
    pallas = np.asarray(jax_quant_einsum(*args, impl="pallas", interpret=True))
    return x, q, s, xla, pallas


def _ratio(got, ref) -> float:
    return chip_smoke._scaled_ratio(torch.from_numpy(got), torch.from_numpy(ref), *TOL)


@pytest.mark.parametrize("T,K,N,resident", [
    (16, 3584, 256, 528),   # decode, every tile cut in 56 segments
    (16, 3584, 256, 20),    # whole tiles and cut ones
    (80, 3584, 256, 264),   # the verify batch: five fragments, one row tile
    (48, 1024, 384, 11),
    (16, 18944, 256, 396),  # down's depth: 296 stages
    (5, 1000, 200, 7),      # ragged K and N
    (100, 640, 256, 13),    # two row tiles of 64 rows
])
def test_emulated_kernel_holds_the_chip_tolerance(T, K, N, resident):
    x, q, s, xla, pallas = _case(T, K, N)
    p = qm.plan(T, K, N, resident)
    got = _emulate(x, q, s, p)
    assert _ratio(got, xla) <= 1.0
    if K % 128 == 0 and N % 128 == 0:  # else JAX's Pallas route is its XLA one
        assert _ratio(got, pallas) <= 1.0
    segs = [len(qm.tile_segments(p, t)) for t in range(p.m_tiles * p.n_tiles)]
    if max(segs) > 1:
        # chip_smoke's planted fault: the plain version without one segment
        # of a cut tile must read above the tolerance
        tile = int(np.argmax(segs))
        assert _ratio(_emulate(x, q, s, p, drop=(tile, segs[tile] // 2)), xla) > 1.0


def test_segment_order_does_not_move_with_the_grid_alone():
    """The sum of a tile depends on its segments, not on which block
    arrives last: the same plan gives the same bits twice, and a whole
    tile's sum equals the same tile computed as one segment."""
    x, q, s, _, _ = _case(16, 3584, 256)
    p = qm.plan(16, 3584, 256, 20)
    a, b = _emulate(x, q, s, p), _emulate(x, q, s, p)
    assert np.array_equal(a, b)
    whole = _emulate(x, q, s, qm.plan(16, 3584, 256, 1))
    assert _ratio(a, whole) <= 1.0
