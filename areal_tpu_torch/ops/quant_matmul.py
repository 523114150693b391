"""Int8-weight dequant-matmul (counterpart of `areal_tpu/ops/quant_matmul.py`).

Weight serving stores the dense transformer kernels as per-output-channel
symmetric absmax int8 (`ops/quant.py`): int8 data in the kernel's own
shape plus one f32 scale per output channel. `quant_einsum` keeps the JAX
shape contract (:120-155): the weight's contraction axes lead, x's trail,
so both collapse to a 2-D `[T, K] @ [K, N]` with the scale per column.

On a CUDA tensor it launches the hand-written Hopper kernel
(`csrc/quant_matmul.cu`, the port of `_quant_matmul_kernel`) or raises; on
a CPU tensor it runs `quant_matmul_ref`, the plain version
(`_quant_matmul_xla`, :107-117). The JAX package falls back to XLA when K
or N is not a multiple of 128; the kernel masks ragged T, K and N itself,
so there is no fallback here.

bf16 x (the serving path) runs the stream-K kernel: the work is a list of
(row tile, 128-column tile, 64-deep k tile) units, k fastest, dealt evenly
over blocks that the card holds at once (`plan`, `run_start`:
`BLOCKS_PER_SM` per SM, or fewer where the occupancy is lower), so every
block streams the same weight bytes; one row tile holds up to 80
rows, so a decode or verify call reads each weight byte once. A tile cut
between blocks is summed by the last of them to arrive, segment by segment
in block order (`tile_segments`), so results are the same from run to run.
The occupancy, the SM count and each shape's plan are asked once per
process and cached. The partials' scratch and the tiles' counters are kept
per (device, stream) and grow, so launches that share them run in stream
order; they must not grow while a CUDA graph is captured (that raises), nor
after it, since the graph would keep the old buffers' addresses. f32 x runs
the first version (`plan_f32`: a split-K grid).

`launches` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from areal_tpu_torch.ops import _build

TILE_N = 128  # output columns of a tile (csrc/quant_matmul.cu kBN)
TILE_K = 64  # depth of one pipeline stage, one unit of work (kBK)
MAX_ROWS = 80  # rows of x one bf16 tile carries: five m16 fragments (kMaxMT)
STAGES = 4  # the bf16 kernel's pipeline depth (kSkStages)
# resident blocks per SM a launch uses, at most: `chip_smoke.py --qmm-sweep`
# found 2 the fastest at every Qwen2.5-7B shape (3, the occupancy at one row
# fragment, 3-9% slower at T 16; T 80 holds 2)
BLOCKS_PER_SM = 2

# The f32 route's first version: blocks a launch aims for (up to 4 small-T
# blocks fit on one SM at once, 46 KB of shared memory each) and the least
# k tiles of a split, 128 deep: a split's f32 partial tile (16 x 128 x 4
# bytes at T 16) is half its int8 weight bytes (128 x 128).
_BLOCKS_PER_SM = 4
_MIN_TILES_PER_SPLIT = 2

# kernel launches since the process started (or the last reset to 0)
launches = 0

_lib: ctypes.CDLL | None = None
# per (device, stream handle)
_counters: dict[tuple[torch.device, int], torch.Tensor] = {}
_workspaces: dict[tuple[torch.device, int], torch.Tensor] = {}


def quant_matmul_ref(x2, q2, s_row, out_dtype):
    """Plain version, `_quant_matmul_xla` op for op: dequantize the whole
    weight in f32 (`q * scale`), multiply with f32 x, cast to `out_dtype`."""
    w = q2.float() * s_row[None, :]
    return (x2.float() @ w).to(out_dtype)


class Plan(NamedTuple):
    """One bf16 launch: `m_tiles` row tiles of `mt` m16 fragments, tiles of
    `TILE_N` columns and `TILE_K`-deep units, `grid` blocks."""

    mt: int
    m_tiles: int
    n_tiles: int
    k_tiles: int
    grid: int

    @property
    def units(self) -> int:
        return self.m_tiles * self.n_tiles * self.k_tiles


def row_tiles(T: int) -> tuple[int, int]:
    """(m16 fragments per row tile, row tiles): the fewest row tiles of at
    most `MAX_ROWS` rows, each as short as they allow."""
    m_tiles = -(-T // MAX_ROWS)
    return -(-T // (16 * m_tiles)), m_tiles


def plan(T: int, K: int, N: int, resident: int) -> Plan:
    """The bf16 kernel's launch: units of (row tile, n tile, k tile), k
    fastest, dealt evenly over `resident` blocks (the blocks the card holds
    at once), or over fewer where that would leave a block fewer units than
    its pipeline's `STAGES` (one block at least)."""
    mt, m_tiles = row_tiles(T)
    n_tiles, k_tiles = -(-N // TILE_N), -(-K // TILE_K)
    units = m_tiles * n_tiles * k_tiles
    return Plan(mt, m_tiles, n_tiles, k_tiles, max(1, min(resident, units // STAGES)))


def run_start(b: int, units: int, grid: int) -> int:
    """First unit of block b's run; block b owns [run_start(b),
    run_start(b + 1)), of units // grid or one more units."""
    q, r = divmod(units, grid)
    return b * q + min(b, r)


def tile_segments(p: Plan, tile: int) -> list[tuple[int, int, int, int]]:
    """The segments of `tile` (row tile * n_tiles + n tile) in the order
    the kernel sums them: (block, partial slot, first unit, last unit).
    One segment is a whole tile, written out by its block; otherwise the
    slot is 0 for the first segment of a block's run and 1 for its last."""
    first = tile * p.k_tiles
    last = first + p.k_tiles - 1
    q, r = divmod(p.units, p.grid)
    big = r * (q + 1)

    def owner(u):
        return u // (q + 1) if u < big else r + (u - big) // q

    segs = []
    for b in range(owner(first), owner(last) + 1):
        s0, s1 = run_start(b, p.units, p.grid), run_start(b + 1, p.units, p.grid)
        lo, hi = max(s0, first), min(s1, last + 1) - 1
        segs.append((b, int(lo != s0), lo, hi))
    return segs


def plan_f32(T: int, K: int, N: int, n_sms: int) -> tuple[int, int, int]:
    """(row fragments of 16 per block, splits of K, 64-deep k tiles per
    split) of one f32 launch (the first version): 16 rows per block when
    T <= 16, else 64; K split across blocks only when the output tiles are
    fewer than `_BLOCKS_PER_SM` per SM, then into enough splits for that
    many blocks, each split at least `_MIN_TILES_PER_SPLIT` k tiles deep."""
    mt = 1 if T <= 16 else 4
    tiles = -(-N // TILE_N) * -(-T // (16 * mt))
    k_tiles = -(-K // TILE_K)
    if tiles >= _BLOCKS_PER_SM * n_sms:
        return mt, 1, k_tiles
    want = -(-_BLOCKS_PER_SM * n_sms // tiles)
    splits = max(1, min(want, k_tiles // _MIN_TILES_PER_SPLIT))
    per = -(-k_tiles // splits)
    return mt, -(-k_tiles // per), per


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("quant_matmul"))
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/quant_matmul.cu) with its C signatures set."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x, w (int8), scale, out, partials, tile counters, T, K, N, mt,
    # m_tiles, grid, x / w / out rows 16-byte aligned, stream
    lib.areal_quant_matmul_bf16.argtypes = [ptr] * 6 + [i32] * 9 + [ptr]
    lib.areal_quant_matmul_bf16.restype = i32
    lib.areal_quant_matmul_bf16_occupancy.argtypes = [i32, ctypes.POINTER(i32)]
    lib.areal_quant_matmul_bf16_occupancy.restype = i32
    # x, w, scale, out, partials, counters, T, K, N, mt, splits, tiles
    # per split, x / w rows 16-byte aligned, stream
    lib.areal_quant_matmul_f32.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.areal_quant_matmul_f32.restype = i32
    lib.areal_quant_matmul_error_string.argtypes = [i32]
    lib.areal_quant_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int) -> None:
    if err != 0:
        msg = _kernel_lib().areal_quant_matmul_error_string(err).decode()
        raise RuntimeError(f"quant matmul kernel launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def _n_sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def occupancy(dev: torch.device, mt: int) -> int:
    """Blocks of the bf16 kernel at `mt` row fragments that one SM of `dev`
    holds at once (the occupancy API; asked once per process)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        _raise_on(_kernel_lib().areal_quant_matmul_bf16_occupancy(mt, ctypes.byref(n)))
    if n.value < 1:
        raise RuntimeError(f"quant matmul kernel (mt {mt}) does not fit an SM")
    return n.value


@functools.lru_cache(maxsize=4096)
def _plan_on(dev: torch.device, T: int, K: int, N: int) -> Plan:
    mt = row_tiles(T)[0]
    return plan(T, K, N, min(occupancy(dev, mt), BLOCKS_PER_SM) * _n_sms(dev))


def _grown(bufs: dict, key: tuple, n: int, make) -> torch.Tensor:
    """The buffer of `key` in `bufs`, made anew by `make(size)` when it
    holds fewer than `n` elements. Grows, never shrinks; refuses to grow
    under a CUDA graph's capture, which would free memory the graph's
    earlier launches use."""
    buf = bufs.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "quant matmul scratch would grow during CUDA graph capture: "
                "call the largest shape on this stream before capturing")
        buf = bufs[key] = make(max(n, 4096))
    return buf


def _scratch(dev: torch.device, stream: int, n_part: int, n_tiles: int):
    """(f32 partials of cut tiles, one int counter per output tile) of
    `stream` on `dev`. The counters are zero between launches: each launch
    leaves the ones it used at 0."""
    key = (dev, stream)
    part = _grown(_workspaces, key, n_part,
                  lambda n: torch.empty(n, dtype=torch.float32, device=dev))
    counters = _grown(_counters, key, n_tiles,
                      lambda n: torch.zeros(n, dtype=torch.int32, device=dev))
    return part, counters


def _check(x2, q2, s_row) -> None:
    for name, t in dict(x=x2, q=q2, scale=s_row).items():
        if t.device != x2.device:
            raise ValueError(f"{name} is on {t.device}, x on {x2.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x2.dtype}: the kernel takes float32 or bfloat16")
    if q2.dtype != torch.int8:
        raise TypeError(f"weight dtype {q2.dtype}, need int8")
    if s_row.dtype != torch.float32:
        raise TypeError(f"scale dtype {s_row.dtype}, need float32")
    if x2.dim() != 2 or q2.dim() != 2 or s_row.dim() != 1:
        raise ValueError("x [T, K], weight [K, N], scale [N]")
    if q2.shape[0] != x2.shape[1] or s_row.shape[0] != q2.shape[1]:
        raise ValueError(
            f"x {tuple(x2.shape)}, weight {tuple(q2.shape)}, scale {tuple(s_row.shape)}"
        )


def _launch_bf16(x2, q2, s_row, out, p: Plan, lib: ctypes.CDLL | None = None) -> None:
    """The bf16 kernel on `p`; a check, a sweep or a diagnostic may pass its
    own plan, or another build `lib` of the source."""
    global launches
    dev, (T, K), N = x2.device, x2.shape, q2.shape[1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    part, counters = _scratch(dev, stream, p.grid * 2 * 16 * p.mt * TILE_N, p.m_tiles * p.n_tiles)
    x_ptr, s_ptr, o_ptr = x2.data_ptr(), s_row.data_ptr(), out.data_ptr()
    _raise_on((lib or _kernel_lib()).areal_quant_matmul_bf16(
        x_ptr, q2.data_ptr(), s_ptr, o_ptr, part.data_ptr(), counters.data_ptr(),
        T, K, N, p.mt, p.m_tiles, p.grid,
        int(K % 8 == 0 and x_ptr % 16 == 0), int(N % 16 == 0 and q2.data_ptr() % 16 == 0),
        int(N % 8 == 0 and o_ptr % 16 == 0 and s_ptr % 16 == 0), stream,
    ))
    launches += 1


def _launch_f32(x2, q2, s_row, out) -> None:
    global launches
    dev, (T, K), N = x2.device, x2.shape, q2.shape[1]
    mt, splits, per = plan_f32(T, K, N, _n_sms(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    part = counters = None
    if splits > 1:
        part, counters = _scratch(dev, stream, splits * T * N, -(-N // TILE_N) * -(-T // (16 * mt)))
    _raise_on(_kernel_lib().areal_quant_matmul_f32(
        x2.data_ptr(), q2.data_ptr(), s_row.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(),
        T, K, N, mt, splits, per,
        int(K % 4 == 0 and x2.data_ptr() % 16 == 0), int(N % 16 == 0 and q2.data_ptr() % 16 == 0),
        stream,
    ))
    launches += 1


def quant_matmul(x2, q2, s_row):
    """`[T, K] @ int8 [K, N]` times `scale [N]`, in x's dtype: the kernel on
    a CUDA tensor, the plain version on a CPU tensor. bf16 x takes the
    stream-K kernel on the plan `_plan_on` caches per shape; f32 x the
    first version."""
    if x2.device.type == "cpu":
        return quant_matmul_ref(x2, q2, s_row, x2.dtype)
    if x2.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on cuda or cpu, not {x2.device}")
    _check(x2, q2, s_row)
    T, K = x2.shape
    N = q2.shape[1]
    out = torch.empty((T, N), dtype=x2.dtype, device=x2.device)
    if T == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    if x2.dtype == torch.bfloat16:
        _launch_bf16(x2, q2, s_row, out, _plan_on(x2.device, T, K, N))
    else:
        _launch_f32(x2, q2, s_row, out)
    return out


def quant_einsum(x, w_q, w_scale, n_contract: int, *, matmul=quant_matmul):
    """einsum(x, dequant(w_q, w_scale)) contracting w's leading `n_contract`
    axes with x's trailing `n_contract` axes (the JAX contract): returns
    x's batch dims + w's output dims, in x's dtype. `matmul` is the 2-D
    product (`quant_matmul`, or a plain version a check swaps in)."""
    k_dims = tuple(w_q.shape[:n_contract])
    out_dims = tuple(w_q.shape[n_contract:])
    if tuple(x.shape[x.dim() - n_contract:]) != k_dims:
        raise ValueError(
            f"x contraction dims {tuple(x.shape[x.dim() - n_contract:])} != "
            f"weight contraction dims {k_dims}"
        )
    kk, nn = math.prod(k_dims), math.prod(out_dims)
    batch = tuple(x.shape[: x.dim() - n_contract])
    x2 = x.reshape(math.prod(batch) if batch else 1, kk).contiguous()
    out2 = matmul(x2, w_q.reshape(kk, nn), w_scale.reshape(nn))
    return out2.reshape(*batch, *out_dims)


def quant_einsum_ref(x, w_q, w_scale, n_contract: int):
    """`quant_einsum` through the plain version on any device (no launch):
    what a check swaps in to compare a path with the kernel's."""
    return quant_einsum(
        x, w_q, w_scale, n_contract,
        matmul=lambda x2, q2, s_row: quant_matmul_ref(x2, q2, s_row, x2.dtype),
    )
