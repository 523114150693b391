"""Paged decode attention over the KV pool, read in place (counterpart of
`areal_tpu/ops/paged_attention.py`).

`paged_attention` keeps the JAX signature and layout (:514): R single-token
queries `[R, nH, hd]` attend over a pool `[n_blocks, bsz, nKV, hd]` through
the `[R, nb]` block table, under the `[R, nb * bsz]` validity mask. On a
CUDA tensor it launches the hand-written Hopper kernel
(`csrc/paged_attention.cu`, the port of `_paged_attn_kernel`) or raises; on
a CPU tensor it runs `paged_attention_ref`, the plain version. There is no
fallback from one to the other.

Int8 pools (`ops/kv_quant.py`): `k_pool` and `v_pool` may be `(int8 data,
f32 scales)` tuples, as in the JAX package (:30-37), with scales
`[n_blocks, nKV, bsz]`. On a CUDA tensor they go to the int8 kernel (the
port of `_paged_attn_kernel_q8`, in the same source); the plain version
dequantizes right after its gather (`_gather_dequant`, :75-85).

`paged_attention_qlen` keeps the JAX signature of the speculative-verify
attention (:464): W query positions per slot, q `[R, W, nH, hd]`, each
with its own causal horizon in `valid [R, W, nb * bsz]`. On a CUDA tensor
it launches K4 (`_paged_verify_kernel`'s port, an fp pool) or K5b
(`_paged_verify_kernel_q8`'s, an int8 pool), which read each valid K/V row
once for all W queries; on a CPU tensor it runs
`paged_attention_qlen_ref`. The kernels take W <= `VERIFY_MAX_W` and
W * group <= `VERIFY_MAX_ROWS` (`check_verify_width`).

For bf16 q all four run on the tensor cores with the slot's table split
over blocks (`decode_pages_per_split` / `verify_pages_per_split` pages
each) and a combine pass over the splits' f32 partials (scratch this
module allocates); f32 q runs the first versions, one block per (kv head,
slot).

An fp pool may be in the other dtype than q's (f32 q over a bf16 pool, bf16
q over an f32 pool), as the decode engine's `kv_cache_dtype` allows: the
plain versions cast the pool to q's dtype after the gather (the XLA path,
:95-109). The kernels do the same: f32 q reads a bf16 pool through the
first versions, widening each value exactly; bf16 q stages an f32 pool's
rows in shared memory as they are and rounds them to bf16 to nearest even
before the tensor cores read them, which is `.to(torch.bfloat16)`.

`launches` counts launches of the fp kernel (K3) on a pool in q's dtype,
`launches_q8` those of the int8 kernel (K5a), `launches_verify` and
`launches_verify_q8` those of K4 and K5b, and `launches_f32q_bf16pool`,
`launches_bf16q_f32pool`, `launches_verify_f32q_bf16pool` and
`launches_verify_bf16q_f32pool` those of K3's and K4's variants over a pool
in the other dtype, so a run can show that its main path went through
them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops.kv_quant import dequantize_kv, scales_rowmajor, split_pool

_NEG_INF = -1e30
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 16
_MAX_PAGE = 256
# the verify kernels' limits: query positions per slot, and query rows
# (W x GQA group) per (slot, kv head) block, whose f32 q tile and
# accumulators live in shared memory and registers
VERIFY_MAX_W = 16
VERIFY_MAX_ROWS = 128
# the bf16 split kernels: logical rows per split at most, and the blocks
# per SM a split count may not go below: two ~85 KB verify blocks fit on
# an SM; for the decode blocks (4 warps, ~70 KB, three per SM) the card's
# sweep over table widths put the fastest split at ~1.9 blocks per SM
VERIFY_MAX_SPLIT_ROWS = 4096
VERIFY_MIN_BLOCKS_PER_SM = 2
DECODE_MIN_BLOCKS_PER_SM = 1.5

# kernel launches since the process started (or the last reset to 0):
# fp pools (K3) and int8 pools (K5a); verify on fp (K4) and int8 (K5b)
launches = 0
launches_q8 = 0
launches_verify = 0
launches_verify_q8 = 0
launches_f32q_bf16pool = 0
launches_bf16q_f32pool = 0
launches_verify_f32q_bf16pool = 0
launches_verify_bf16q_f32pool = 0
# the pool's element type as the kernels take it
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_lib: ctypes.CDLL | None = None
_sms: dict[int, int] = {}  # SMs per CUDA device index


def _n_sms(dev: torch.device) -> int:
    """The device's SM count, read once per device."""
    n = _sms.get(dev.index)
    if n is None:
        n = _sms[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _gather_dequant(pool, scales, idx, R, nb, bsz, nKV, hd, dtype):
    """Gather `idx` blocks into [R, nb*bsz, nKV, hd]; an int8 pool is
    dequantized to `dtype` right after the gather (JAX :75-85)."""
    c = pool.index_select(0, idx).reshape(R, nb * bsz, nKV, hd)
    if scales is None:
        return c
    sc = scales_rowmajor(scales.index_select(0, idx).reshape(R, nb, nKV, bsz))
    return dequantize_kv(c, sc, dtype)


def paged_attention_ref(q, k_pool, v_pool, block_table, valid, *, sm_scale=None):
    """Plain PyTorch version: `paged_attention_qlen_ref` with one query
    per slot, which is `_paged_attention_xla` (:88-110) op for op: gather
    the table's blocks (dequantizing an int8 pool to q's dtype), score in
    q's dtype, divide by sqrt(hd) exactly when `sm_scale` is the default,
    mask with -1e30, softmax in f32, round the probabilities to q's dtype,
    and sum V.

    One departure: a slot with no valid row returns 0, as
    `_paged_attn_kernel` (and the CUDA kernel) do; the XLA path returns the
    mean of the gathered V rows there. The decode step never produces such
    a slot (row 0 is always valid)."""
    out = paged_attention_qlen_ref(
        q[:, None], k_pool, v_pool, block_table, valid[:, None], sm_scale=sm_scale
    )
    return out[:, 0]


def paged_attention_qlen_ref(q, k_pool, v_pool, block_table, valid, *, sm_scale=None):
    """Plain PyTorch version of `paged_attention_qlen`. It follows the XLA
    path (:493-503) op for op: `_gather_dequant` of the table's blocks,
    then `verify_attention` (`areal_tpu/ops/chunked_attention.py:55-70`):
    score in q's dtype, divide by sqrt(hd) exactly when `sm_scale` is the
    default, cast to f32, mask with -1e30, softmax in f32, round the
    probabilities to q's dtype, and sum V.

    One departure: a query with no valid row returns 0, as the kernels do;
    the XLA path returns the mean of the gathered V rows there."""
    (k_pool, k_scales), (v_pool, v_scales) = split_pool(k_pool), split_pool(v_pool)
    R, W, nH, hd = q.shape
    bsz, nKV = k_pool.shape[1], k_pool.shape[2]
    nb = block_table.shape[1]
    idx = block_table.reshape(-1).long()
    kc = _gather_dequant(k_pool, k_scales, idx, R, nb, bsz, nKV, hd, q.dtype)
    vc = _gather_dequant(v_pool, v_scales, idx, R, nb, bsz, nKV, hd, q.dtype)
    return verify_attention(q, kc, vc, valid, sm_scale=sm_scale)


def verify_attention(q, k_cache, v_cache, valid, *, sm_scale=None):
    """W queries per slot over per-slot contiguous KV (JAX
    `ops/chunked_attention.py::verify_attention`, :31-70): q `[R, W, nH,
    hd]`, caches `[R, S, nKV, hd]` in any fp dtype (cast to q's), valid
    `[R, W, S]`. The attention of `paged_attention_qlen_ref` after its
    gather, and of the workspace layout's steps (`models/qwen2.verify_step`,
    `decode_step`), so the layouts agree bit for bit. A query with no
    valid row gives 0."""
    R, W, nH, hd = q.shape
    nKV = k_cache.shape[2]
    group = nH // nKV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(R, W, nKV, group, hd)
    scores = torch.einsum("rwkgd,rskd->rwkgs", qg, k_cache.to(q.dtype))
    if sm_scale == 1.0 / math.sqrt(hd):
        scores = (scores / math.sqrt(hd)).float()
    else:
        scores = (scores * sm_scale).float()
    scores = torch.where(valid[:, :, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("rwkgs,rskd->rwkgd", probs, v_cache.to(q.dtype))
    out = torch.where(valid.any(dim=2)[:, :, None, None, None], out, 0)
    return out.reshape(R, W, nH, hd)


def check_verify_width(W: int, group: int) -> None:
    """Raise ValueError for a verify width the kernels do not take."""
    if not 1 <= W <= VERIFY_MAX_W or W * group > VERIFY_MAX_ROWS:
        raise ValueError(
            f"verify width W={W} at GQA group {group}: the verify kernels take "
            f"1 <= W <= {VERIFY_MAX_W} and W x group <= {VERIFY_MAX_ROWS}"
        )


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        tail = [
            ctypes.c_void_p,  # block table
            ctypes.c_void_p,  # valid
            ctypes.c_void_p,  # out
            ctypes.c_int,  # R
        ]
        shape = [
            ctypes.c_int,  # nH
            ctypes.c_int,  # nKV
            ctypes.c_int,  # hd
            ctypes.c_int,  # bsz
            ctypes.c_int,  # nb
            ctypes.c_int,  # n_blocks
            ctypes.c_float,  # sm_scale
            ctypes.c_int,  # is_bf16 (q)
            ctypes.c_int,  # the pool's element type (_POOL_CODE)
            ctypes.c_void_p,  # scratch (bf16 q, more than one split)
            ctypes.c_int,  # pages_per_split (bf16 q)
            ctypes.c_void_p,  # stream
        ]
        fp = [ctypes.c_void_p] * 3  # q, k_pool, v_pool
        q8 = [ctypes.c_void_p] * 5  # q, k_pool (int8), k scales, v_pool (int8), v scales
        # K4 and K5b take W after R
        for name, args in (("areal_paged_attention", fp + tail + shape),
                           ("areal_paged_attention_q8", q8 + tail + shape),
                           ("areal_paged_verify", fp + tail + [ctypes.c_int] + shape),
                           ("areal_paged_verify_q8", q8 + tail + [ctypes.c_int] + shape)):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = ctypes.c_int
        lib.areal_paged_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.areal_paged_smem_bytes.restype = ctypes.c_longlong
        lib.areal_cuda_error_string.argtypes = [ctypes.c_int]
        lib.areal_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, block_table, valid, verify: bool = False) -> None:
    """Refuse what the kernels do not take. Pools are f32 or bf16 tensors,
    in q's dtype or the other (K3, K4), or `(int8 data, f32 scales
    [n_blocks, nKV, bsz])` tuples (K5a, K5b). With `verify`, q is `[R, W, nH, hd]` and valid `[R, W, nb * bsz]`
    (K4, K5b), else q `[R, nH, hd]` and valid `[R, nb * bsz]`."""
    (k_pool, k_scales), (v_pool, v_scales) = split_pool(k_pool), split_pool(v_pool)
    if (k_scales is None) != (v_scales is None):
        raise TypeError("k_pool and v_pool must both be int8 tuples or neither")
    tensors = dict(
        q=q, k_pool=k_pool, v_pool=v_pool, block_table=block_table,
        valid=valid,
    )
    if k_scales is not None:
        tensors.update(k_scales=k_scales, v_scales=v_scales)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or bfloat16")
    pools = (torch.float32, torch.bfloat16) if k_scales is None else (torch.int8,)
    if k_pool.dtype not in pools or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            f"pool dtypes {k_pool.dtype}/{v_pool.dtype} must be one of {pools}, both alike"
        )
    if k_scales is not None:
        n_blocks, bsz, nKV = k_pool.shape[:3]
        for name, t in dict(k_scales=k_scales, v_scales=v_scales).items():
            if t.dtype != torch.float32:
                raise TypeError(f"{name} dtype {t.dtype}, need float32")
            if tuple(t.shape) != (n_blocks, nKV, bsz):
                raise ValueError(
                    f"{name} {tuple(t.shape)} != [n_blocks, nKV, bsz] "
                    f"{(n_blocks, nKV, bsz)}"
                )
    if block_table.dtype != torch.int32:
        raise TypeError(f"block_table dtype {block_table.dtype}, need int32")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid dtype {valid.dtype}, need bool")
    if q.dim() != (4 if verify else 3) or k_pool.dim() != 4 or block_table.dim() != 2:
        raise ValueError(
            f"q [R, {'W, ' if verify else ''}nH, hd], pools [n_blocks, bsz, nKV, hd], table [R, nb]"
        )
    R, nH, hd = q.shape[0], q.shape[-2], q.shape[-1]
    lead = tuple(q.shape[:-2])  # (R,) or (R, W)
    n_blocks, bsz, nKV, hd_k = k_pool.shape
    nb = block_table.shape[1]
    if v_pool.shape != k_pool.shape or hd_k != hd:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} vs q {tuple(q.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {_HEAD_DIMS}")
    if nH % nKV or not 1 <= nH // nKV <= _MAX_GROUP:
        raise ValueError(f"{nH} query heads over {nKV} kv heads: group must be 1..{_MAX_GROUP}")
    if not 1 <= bsz <= _MAX_PAGE:
        raise ValueError(f"page size {bsz} not in 1..{_MAX_PAGE}")
    if block_table.shape[0] != R or tuple(valid.shape) != (*lead, nb * bsz):
        raise ValueError(
            f"table {tuple(block_table.shape)} / valid {tuple(valid.shape)} "
            f"do not match q's {lead}, nb*bsz={nb * bsz}"
        )
    if verify:
        check_verify_width(q.shape[1], nH // nKV)
    # the kernels read pool rows 16 bytes at a time (vector loads, cp.async),
    # and the tensor-core route q's rows too
    aligned = dict(k_pool=k_pool, v_pool=v_pool)
    if q.dtype == torch.bfloat16:
        aligned["q"] = q
    for name, t in aligned.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} starts at {t.data_ptr():#x}, not 16-byte "
                             "aligned: the paged kernels read 16-byte rows")


def paged_attention(q, k_pool, v_pool, block_table, valid, *, sm_scale=None):
    """Decode attention of R single-token queries over paged KV.

    q `[R, nH, hd]`; pools `[n_blocks, bsz, nKV, hd]` (one layer), or
    `(int8 data, f32 scales [n_blocks, nKV, bsz])` tuples; table
    `[R, nb]` int32 pool-block ids; valid `[R, nb * bsz]` bool. Logical row
    s of slot r lives at `(block_table[r, s // bsz], s % bsz)`; rows that
    `valid` hides (the null block 0 in table tails, rows past a slot's
    position) are never scored. Returns `[R, nH, hd]` in q's dtype.

    A block id outside the pool on a page that has valid rows faults the
    kernel (the CUDA error surfaces at the next synchronisation), as an
    out-of-range index does in PyTorch's own CUDA kernels; the plain
    version raises IndexError.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, block_table, valid, sm_scale=sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, block_table, valid)
    if q.shape[0] == 0 or block_table.shape[1] == 0:
        return torch.zeros_like(q)  # no row to attend: the output is 0
    return _launch(q, k_pool, v_pool, block_table, valid, sm_scale)


def _pages_per_split(nb: int, bsz: int, R: int, nKV: int, n_sms: int,
                     min_blocks_per_sm: float) -> int:
    """The most pages of the table per block (a power of two, at most
    `VERIFY_MAX_SPLIT_ROWS` rows and the table) that leave the grid at
    least `min_blocks_per_sm` blocks per SM. Fewer splits write and
    combine fewer partials; too few leave SMs idle."""
    pps = 1
    while (pps < nb and 2 * pps * bsz <= VERIFY_MAX_SPLIT_ROWS
           and R * nKV * -(-nb // (2 * pps)) >= min_blocks_per_sm * n_sms):
        pps *= 2
    return min(pps, nb)


def decode_pages_per_split(nb: int, bsz: int, R: int, nKV: int, n_sms: int) -> int:
    """Pages of the table per block of the bf16 decode kernels (K3, K5a):
    `_pages_per_split` at `DECODE_MIN_BLOCKS_PER_SM`. At the serve batch
    (R 16, 4 kv heads, 9-10 pages of 128 rows, 132 SMs) that is 2, the
    fastest of 1, 2, 4 and the whole table on an H100; over tables of 2-32
    pages it is the fastest split or within 1.27x of it (`PERF.md`)."""
    return _pages_per_split(nb, bsz, R, nKV, n_sms, DECODE_MIN_BLOCKS_PER_SM)


def _launch(q, k_pool, v_pool, block_table, valid, sm_scale: float,
            pages_per_split: int | None = None):
    """Launch K3/K5a (q [R, nH, hd]) or K4/K5b (q [R, W, nH, hd]) on checked
    CUDA tensors and count the launch. For bf16 q, `pages_per_split`
    (default: `decode_pages_per_split` or `verify_pages_per_split`) sets the
    blocks' share of the table; f32 q ignores it."""
    global launches, launches_q8, launches_verify, launches_verify_q8
    global launches_f32q_bf16pool, launches_bf16q_f32pool
    global launches_verify_f32q_bf16pool, launches_verify_bf16q_f32pool
    W = q.shape[1] if q.dim() == 4 else 0  # 0: one query per slot
    (k_data, k_scales), (v_data, v_scales) = split_pool(k_pool), split_pool(v_pool)
    R, nH, hd = q.shape[0], q.shape[-2], q.shape[-1]
    n_blocks, bsz, nKV, _ = k_data.shape
    nb = block_table.shape[1]
    out = torch.empty_like(q)
    lib = _kernel_lib()
    bf16 = q.dtype == torch.bfloat16
    if not bf16:
        pages_per_split = 1
    elif pages_per_split is None:
        rule = verify_pages_per_split if W else decode_pages_per_split
        pages_per_split = rule(nb, bsz, R, nKV, _n_sms(q.device))
    # the splits' f32 partials: (hd + 2) floats per query row and split
    n_splits = -(-nb // pages_per_split)
    scratch = (torch.empty(R * max(W, 1) * nH * n_splits * (hd + 2), dtype=torch.float32,
                           device=q.device) if bf16 and n_splits > 1 else None)
    tail = (
        block_table.data_ptr(), valid.data_ptr(), out.data_ptr(), R, *((W,) if W else ()),
        nH, nKV, hd, bsz, nb, n_blocks, float(sm_scale), int(bf16), _POOL_CODE[k_data.dtype],
        None if scratch is None else scratch.data_ptr(), pages_per_split,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    name = "areal_paged_verify" if W else "areal_paged_attention"
    if k_scales is None:
        err = getattr(lib, name)(q.data_ptr(), k_data.data_ptr(), v_data.data_ptr(), *tail)
    else:
        err = getattr(lib, name + "_q8")(
            q.data_ptr(), k_data.data_ptr(), k_scales.data_ptr(),
            v_data.data_ptr(), v_scales.data_ptr(), *tail,
        )
    if err != 0:
        msg = lib.areal_cuda_error_string(err).decode()
        kind = "verify" if W else "attention"
        raise RuntimeError(f"paged {kind} kernel launch failed: {msg} ({err})")
    mixed = k_scales is None and k_data.dtype != q.dtype
    if W and mixed and bf16:
        launches_verify_bf16q_f32pool += 1
    elif W and mixed:
        launches_verify_f32q_bf16pool += 1
    elif W and k_scales is None:
        launches_verify += 1
    elif W:
        launches_verify_q8 += 1
    elif mixed and bf16:
        launches_bf16q_f32pool += 1
    elif mixed:
        launches_f32q_bf16pool += 1
    elif k_scales is None:
        launches += 1
    else:
        launches_q8 += 1
    return out


def verify_pages_per_split(nb: int, bsz: int, R: int, nKV: int, n_sms: int) -> int:
    """Pages of the table per block of the bf16 verify kernels (K4, K5b):
    `_pages_per_split` at `VERIFY_MIN_BLOCKS_PER_SM`. At the spec batch
    (R 16, 4 kv heads, 9 pages of 128 rows, 132 SMs) that is 2, the fastest
    of 1, 2, 4 and 9 on an H100 (`PERF.md`)."""
    return _pages_per_split(nb, bsz, R, nKV, n_sms, VERIFY_MIN_BLOCKS_PER_SM)


def split_smem_bytes(W: int, group: int, hd: int, bsz: int, pages_per_split: int,
                     pool: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block of a bf16 split kernel over a pool
    of `pool` elements (bf16, int8 for K5a/K5b, or f32), as its launch
    sizes it: K4 at W query positions, or K3 with W = 0 (builds the
    library)."""
    return _kernel_lib().areal_paged_smem_bytes(W, group, hd, bsz, pages_per_split,
                                                _POOL_CODE[pool])


def paged_attention_qlen(q, k_pool, v_pool, block_table, valid, *, sm_scale=None):
    """Speculative-verify attention: W query positions per slot over paged
    KV, each under its own row of `valid`.

    q `[R, W, nH, hd]`; pools as for `paged_attention`; table `[R, nb]`
    int32; valid `[R, W, nb * bsz]` bool (query w of slot r attends the
    logical rows s with `valid[r, w, s]`, typically s <= base + w). Returns
    `[R, W, nH, hd]` in q's dtype; a query with no valid row gives 0. A
    block id outside the pool on a page with a row valid for some query
    faults the kernel, as in `paged_attention`.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_qlen_ref(
            q, k_pool, v_pool, block_table, valid, sm_scale=sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_qlen runs on cuda or cpu, not {q.device}")
    _check(q, k_pool, v_pool, block_table, valid, verify=True)
    if q.shape[0] == 0 or block_table.shape[1] == 0:
        return torch.zeros_like(q)  # no row to attend: the output is 0
    return _launch(q, k_pool, v_pool, block_table, valid, sm_scale)
