"""Segment-aware flash attention over one packed token stream (counterpart
of `areal_tpu/ops/flash_attention.py`).

`flash_attention(q, k, v, layout)` and `flash_attention_chunk(q, k, v,
layout)` keep the token-major layout of the JAX functions: q
`[T, nH, hd]`, k/v `[T, nKV, hd]`. Where the JAX functions take segment
ids and positions, these take their `FlashLayout`: `packed_layout(
segment_ids)` for a packed stream attending to itself, `flash_layout(
seg_q, seg_k, q_positions, kv_positions)` for queries against a kv chunk.
A key is valid for a query iff it has the same segment, `qpos >= kpos`,
and the query's segment is not `PADDING_SEGMENT` (-1). The chunk entry
also returns the per-row log-sum-exp `[Tq, nH]` and differentiates
through it.

On CUDA tensors both run `_FlashAttention`, one `torch.autograd.Function`
whose forward is the hand-written Hopper kernel K1 and whose backward is
K2a (dQ) and K2b (dK/dV), all in `csrc/flash_attention.cu`; a failed
build or launch raises. In bf16 the three run on the tensor cores and
read q, k, v and dO with 16-byte copies: a tensor whose storage does not
start 16-byte aligned raises. On CPU tensors they run
`flash_attention_ref`, the plain version, differentiated by autograd.
There is no fallback from one to the other.

The layout (int32 segment ids and positions, and each 64-row tile's
`tile_meta`) belongs to the token stream, not to a layer: a caller that
attends one stream in every layer builds it once (`layout_builds` counts
the builds) and passes it to each call.

Each kernel has its launcher (`flash_fwd`, `flash_bwd_dq`,
`flash_bwd_dkv`, CUDA tensors only) and its plain version
(`flash_attention_ref`, `flash_bwd_dq_ref`, `flash_bwd_dkv_ref`) on the
same inputs. `launches_fwd`, `launches_dq` and `launches_dkv` count
kernel launches, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from areal_tpu_torch.ops import _build

PADDING_SEGMENT = -1
_NEG_INF = -1e30
_TILE = 64  # rows of a kernel tile (kTile in the source)
_HEAD_DIMS = (16, 32, 64, 128)
_INT_MAX = torch.iinfo(torch.int32).max
_INT_MIN = torch.iinfo(torch.int32).min

# kernel launches since the process started (or the last reset to 0)
launches_fwd = 0
launches_dq = 0
launches_dkv = 0
layout_builds = 0  # flash_layout calls

_lib: ctypes.CDLL | None = None


def _valid(seg_q, seg_k, q_positions, kv_positions):
    """[Tq, Tk] validity: same segment, causal by position, query not pad."""
    return (
        (seg_q[:, None] == seg_k[None, :])
        & (q_positions[:, None] >= kv_positions[None, :])
        & (seg_q[:, None] != PADDING_SEGMENT)
    )


def flash_attention_ref(q, k, v, seg_q, seg_k, q_positions, kv_positions, *,
                        sm_scale: float | None = None):
    """Plain version: dense masked softmax in f32, differentiable by
    autograd. Returns (o `[Tq, nH, hd]` in q's dtype, lse `[Tq, nH]` f32).
    A fully-masked row gives o = 0 and lse = -1e30, as the kernels do."""
    Tq, nH, hd = q.shape
    nKV = k.shape[1]
    group = nH // nKV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qf = q.float().reshape(Tq, nKV, group, hd)
    s = torch.einsum("tkgd,skd->kgts", qf, k.float()) * sm_scale
    s = torch.where(_valid(seg_q, seg_k, q_positions, kv_positions), s, _NEG_INF)
    # the row max only shifts the exponent: no gradient flows through it
    m = s.amax(dim=-1, keepdim=True).detach()
    p = torch.where(m > _NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("kgts,skd->tkgd", p / safe_l, v.float()).reshape(Tq, nH, hd)
    lse = torch.where(l > 0, m + torch.log(safe_l), _NEG_INF)[..., 0]
    return o.to(q.dtype), lse.reshape(nH, Tq).t()


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.areal_flash_fwd.argtypes = (
            [ptr] * 11 + [i32] * 5 + [f32, i32, ptr]
        )
        lib.areal_flash_bwd_dq.argtypes = (
            [ptr] * 13 + [i32] * 5 + [f32, i32, ptr]
        )
        lib.areal_flash_bwd_dkv.argtypes = (
            [ptr] * 15 + [i32] * 6 + [f32, i32, ptr]
        )
        for fn in (lib.areal_flash_fwd, lib.areal_flash_bwd_dq, lib.areal_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.areal_flash_smem_bytes.argtypes = [i32] * 5
        lib.areal_flash_smem_bytes.restype = i32
        lib.areal_flash_error_string.argtypes = [ctypes.c_int]
        lib.areal_flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = _kernel_lib().areal_flash_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} kernel launch failed: {msg} ({err})")


def tile_meta(seg, pos, *, queries: bool):
    """int32 `[n_tiles, 3]` per 64-row tile: the smallest and largest
    segment id over non-pad rows, and the largest (queries) or smallest
    (keys) position over them; an all-pad tile gets an empty range. The
    kernels visit a (Q tile, K tile) pair only where these say a valid
    pair can exist."""
    T = seg.shape[0]
    n = -(-T // _TILE)
    pad = n * _TILE - T
    seg = F.pad(seg, (0, pad), value=PADDING_SEGMENT).view(n, _TILE)
    pos = F.pad(pos, (0, pad)).view(n, _TILE)
    real = seg != PADDING_SEGMENT
    smin = torch.where(real, seg, _INT_MAX).amin(dim=1)
    smax = torch.where(real, seg, _INT_MIN).amax(dim=1)
    if queries:
        p = torch.where(real, pos, _INT_MIN).amax(dim=1)
    else:
        p = torch.where(real, pos, _INT_MAX).amin(dim=1)
    return torch.stack([smin, smax, p], dim=1).to(torch.int32).contiguous()


def smem_bytes(T: int, hd: int, dtype: torch.dtype = torch.bfloat16) -> dict[str, int]:
    """Dynamic shared memory of one block of each kernel over a T-token
    stream at head dim `hd` for `dtype` inputs, as the launches size it
    (builds the library)."""
    lib = _kernel_lib()
    bf16 = int(dtype == torch.bfloat16)
    return {name: lib.areal_flash_smem_bytes(i, hd, T, T, bf16)
            for i, name in enumerate(("fwd", "dq", "dkv"))}


class FlashLayout(NamedTuple):
    """The segment layout of one (query, key) stream pair as the kernels
    read it: int32 segment ids and positions, and each 64-row tile's
    `tile_meta`."""
    seg_q: torch.Tensor
    seg_k: torch.Tensor
    pos_q: torch.Tensor
    pos_k: torch.Tensor
    meta_q: torch.Tensor
    meta_k: torch.Tensor


def flash_layout(seg_q, seg_k, q_positions, kv_positions) -> FlashLayout:
    """The `FlashLayout` of queries (`seg_q`, `q_positions` `[Tq]`) against
    keys (`seg_k`, `kv_positions` `[Tk]`)."""
    global layout_builds
    layout_builds += 1
    sq, sk, pq, pk = (t.to(torch.int32).contiguous()
                      for t in (seg_q, seg_k, q_positions, kv_positions))
    return FlashLayout(sq, sk, pq, pk, tile_meta(sq, pq, queries=True),
                       tile_meta(sk, pk, queries=False))


def packed_layout(segment_ids) -> FlashLayout:
    """The `FlashLayout` of a packed stream attending to itself, causal by
    stream index."""
    pos = torch.arange(segment_ids.shape[0], device=segment_ids.device, dtype=torch.int32)
    return flash_layout(segment_ids, segment_ids, pos, pos)


def _check(q, k, v, seg_q, seg_k, pos_q, pos_k) -> None:
    for name, t in dict(k=k, v=v, seg_q=seg_q, seg_k=seg_k, pos_q=pos_q, pos_k=pos_k).items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype} must equal q's {q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q [Tq, nH, hd], k/v [Tk, nKV, hd]: got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    Tq, nH, hd = q.shape
    Tk, nKV, hd_k = k.shape
    if hd_k != hd or hd not in _HEAD_DIMS:
        raise ValueError(f"head_dim {hd}/{hd_k}: the kernels take {_HEAD_DIMS}")
    if nH % nKV:
        raise ValueError(f"{nH} query heads over {nKV} kv heads")
    if seg_q.shape != (Tq,) or pos_q.shape != (Tq,) or seg_k.shape != (Tk,) or pos_k.shape != (Tk,):
        raise ValueError("segment ids and positions must be [Tq] and [Tk]")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_aligned(**tensors) -> None:
    """The bf16 kernels copy rows of q, k, v and dO 16 bytes at a time
    (cp.async): their storage must start 16-byte aligned."""
    for name, t in tensors.items():
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} starts at {t.data_ptr():#x}, not 16-byte aligned: "
                             "the bf16 flash kernels copy 16-byte rows")


def flash_fwd(q, k, v, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k, sm_scale: float):
    """K1 on CUDA tensors (contiguous; int32 ids and `tile_meta`s):
    (o `[Tq, nH, hd]` in q's dtype, lse `[nH, Tq]` f32)."""
    global launches_fwd
    _check_aligned(q=q, k=k, v=v)
    Tq, nH, hd = q.shape
    Tk, nKV, _ = k.shape
    o = torch.empty_like(q)
    lse = torch.empty((nH, Tq), dtype=torch.float32, device=q.device)
    err = _kernel_lib().areal_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
        seg_k.data_ptr(), pos_q.data_ptr(), pos_k.data_ptr(),
        meta_q.data_ptr(), meta_k.data_ptr(), o.data_ptr(), lse.data_ptr(),
        Tq, Tk, nH, nKV, hd, float(sm_scale), int(q.dtype == torch.bfloat16), _stream(q),
    )
    _raise_on(err, "forward")
    launches_fwd += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, dd, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k,
                 sm_scale: float):
    """K2a on CUDA tensors: dq `[Tq, nH, hd]` in q's dtype. `dd` is
    `dlse - rowsum(dO * O)`, f32 `[nH, Tq]`."""
    global launches_dq
    _check_aligned(q=q, k=k, v=v, do=do)
    Tq, nH, hd = q.shape
    Tk, nKV, _ = k.shape
    dq = torch.empty_like(q)
    err = _kernel_lib().areal_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), seg_q.data_ptr(), seg_k.data_ptr(), pos_q.data_ptr(),
        pos_k.data_ptr(), meta_q.data_ptr(), meta_k.data_ptr(), dq.data_ptr(),
        Tq, Tk, nH, nKV, hd, float(sm_scale), int(q.dtype == torch.bfloat16), _stream(q),
    )
    _raise_on(err, "dq")
    launches_dq += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dd, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k,
                  sm_scale: float, *, splits: int | None = None):
    """K2b on CUDA tensors: (dk, dv) `[Tk, nKV, hd]` in k's dtype, summed
    over each kv head's group of query heads. In bf16 `splits` blocks
    (by default the group size: one query head each) share each K tile's
    heads, and a second launch adds their f32 partials in a fixed order;
    f32 takes one block per (K tile, kv head)."""
    global launches_dkv
    _check_aligned(q=q, k=k, v=v, do=do)
    Tq, nH, hd = q.shape
    Tk, nKV, _ = k.shape
    bf16 = q.dtype == torch.bfloat16
    if splits is None:
        splits = nH // nKV if bf16 else 1
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    work = None
    if splits > 1:
        work = torch.empty(2 * splits * k.numel(), dtype=torch.float32, device=q.device)
    err = _kernel_lib().areal_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        dd.data_ptr(), seg_q.data_ptr(), seg_k.data_ptr(), pos_q.data_ptr(),
        pos_k.data_ptr(), meta_q.data_ptr(), meta_k.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if work is None else work.data_ptr(), splits,
        Tq, Tk, nH, nKV, hd, float(sm_scale), int(bf16), _stream(q),
    )
    _raise_on(err, "dkv")
    launches_dkv += 1
    return dk, dv


def _bwd_ds(q, k, v, do, lse, dd, ids, sm_scale):
    """The backward's dense terms in f32 `[nKV, group, Tq, Tk]`: p
    recomputed from lse (0 where lse <= -5e29), and ds = p * (dp + dd)
    with dd = dlse - delta; also dO grouped by kv head."""
    Tq, nH, hd = q.shape
    nKV = k.shape[1]
    g = nH // nKV
    s = torch.einsum("tkgd,skd->kgts", q.float().reshape(Tq, nKV, g, hd), k.float()) * sm_scale
    s = torch.where(_valid(*ids), s, _NEG_INF)
    lse = lse.reshape(nKV, g, Tq, 1)
    p = torch.where(lse > _NEG_INF / 2, torch.exp(s - lse), 0.0)
    dof = do.float().reshape(Tq, nKV, g, hd)
    dp = torch.einsum("tkgd,skd->kgts", dof, v.float())
    return p, p * (dp + dd.reshape(nKV, g, Tq, 1)), dof


def flash_bwd_dq_ref(q, k, v, do, lse, dd, seg_q, seg_k, pos_q, pos_k, sm_scale: float):
    """Plain version of K2a (dense, f32): dq in q's dtype."""
    Tq, nH, hd = q.shape
    _, ds, _ = _bwd_ds(q, k, v, do, lse, dd, (seg_q, seg_k, pos_q, pos_k), sm_scale)
    dq = torch.einsum("kgts,skd->tkgd", ds, k.float()) * sm_scale
    return dq.reshape(Tq, nH, hd).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, dd, seg_q, seg_k, pos_q, pos_k, sm_scale: float):
    """Plain version of K2b (dense, f32): (dk, dv) in k's dtype, summed
    over the GQA group."""
    Tq, nH, hd = q.shape
    nKV = k.shape[1]
    p, ds, dof = _bwd_ds(q, k, v, do, lse, dd, (seg_q, seg_k, pos_q, pos_k), sm_scale)
    qf = q.float().reshape(Tq, nKV, nH // nKV, hd)
    dk = torch.einsum("kgts,tkgd->skd", ds, qf) * sm_scale
    dv = torch.einsum("kgts,tkgd->skd", p, dof)
    return dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """Forward K1, backward K2a + K2b. Inputs are CUDA tensors: q
    `[Tq, nH, hd]`, k/v `[Tk, nKV, hd]`, and the six tensors of a
    `FlashLayout`. Returns (o `[Tq, nH, hd]`, lse `[nH, Tq]` f32)."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k, sm_scale):
        o, lse = flash_fwd(q, k, v, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_k, pos_q, pos_k, meta_q, meta_k)
        ctx.sm_scale = sm_scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse, *ids = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O), outside the kernels as in JAX (:366)
        delta = (o.float() * do.float()).sum(dim=-1).t()
        dd = (dlse.float() - delta).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, dd, *ids, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, dd, *ids, ctx.sm_scale)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_chunk(q, k, v, layout: FlashLayout, *, sm_scale: float | None = None):
    """Attention of queries `[Tq, nH, hd]` against one kv chunk
    `[Tk, nKV, hd]` under `layout` (`flash_layout` of their segment ids
    and global positions, which decide causality). Returns (out
    `[Tq, nH, hd]`, lse `[Tq, nH]` f32), `out` normalised within this
    chunk and differentiable through both."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")
    ints = layout[:4]
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, *ints, sm_scale=sm_scale)
    _check(q, k, v, *ints)
    if q.shape[0] == 0 or k.shape[0] == 0:
        raise ValueError("flash attention needs at least one query and one key")
    o, lse = _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), *layout,
                                   float(sm_scale))
    return o, lse.t()


def flash_attention(q, k, v, layout: FlashLayout, *, sm_scale: float | None = None):
    """Packed-layout attention: q `[T, nH, hd]`, k/v `[T, nKV, hd]` under
    `layout = packed_layout(segment_ids)` (PADDING_SEGMENT marks pad
    tokens), causal by stream index within each segment. Returns
    `[T, nH, hd]` in q's dtype."""
    return flash_attention_chunk(q, k, v, layout, sm_scale=sm_scale)[0]
