"""Chip check of the PyTorch/CUDA port (`areal_tpu_torch`) on one H100.

Run from the repository root, with no arguments, on a machine with one
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, then drives the main
paths with seeded random weights in bf16: it serves 16 concurrent
requests through `TorchDecodeEngine` at Qwen2.5-7B full width and depth,
serves self-quoting traffic with speculative decode (`spec_decode=
"ngram"`) beside a spec-off engine, serves the first traffic again from
an int8 engine (int8 weights and an int8 KV pool) and the speculative
traffic from an int8 spec engine, and runs three colocated GRPO
iterations (rollout, `compute_logp`, `compute_advantages`, `ppo_update`,
weight push) through `TorchPPOActor` at Qwen2.5-1.5B full width and
depth. It checks that the kernels really carried each path. Each phase prints one JSON line; then
come the `kernels` line, the card's name and power limit, and last
`{"ok": true, "device": ...}`. Any failed check raises, and the script
exits non-zero without that last line.
It imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --paged-times

times only K3 and K5a (as issued, on the device alone, and the wrapper's
host time per call) at the serve batch's shapes on a synthetic pool. It
calls nothing but `paged_attention`, so a copy of this script placed at
the root of another tree (an earlier commit, say) times that tree's
kernels the same way.

    python3 chip_smoke.py --decode-sweep

times bf16 K3 and K5a on the device alone over table widths and pages per
split, beside the split rule's choice.

    python3 chip_smoke.py --qmm-times

times only K6 (device ms per layer and per product at T 16, 80 and 1024,
and the wrapper's host ms per call) on random Qwen2.5-7B int8 weights. It
calls nothing but `quant_matmul`, so a copy of this script at the root of
another tree times that tree's kernel.

    python3 chip_smoke.py --qmm-sweep

times the bf16 K6 kernel at Qwen2.5-7B's four (K, N) shapes at T 16 and 80
over resident blocks per SM and pipeline depths (2 and 8 from copies of
its source built with another `QMM_STAGES`), beside the default plan.
"""

from __future__ import annotations

import asyncio
import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    JaxEngineConfig,
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import FinetuneSpec, ModelRequest, WeightUpdateMeta
from areal_tpu_torch.engine import sampling
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models.qwen2 import (
    decode_step_paged,
    init_params,
    segment_ids_from_cu_seqlens,
    verify_step_paged,
)
from areal_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from areal_tpu_torch.ops.quant import quantize_absmax
from areal_tpu_torch.models.smoke import (
    QWEN25_1_5B,
    QWEN25_1_5B_SOURCE,
    QWEN25_7B,
    QWEN25_7B_SOURCE,
)
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.ops import quant_matmul as qm
from areal_tpu_torch.ops import threefry as tf
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak rate for math on inputs of `dtype`."""
    return BF16_FLOPS if dtype in (torch.bfloat16, torch.float16) else F32_FLOPS

KERNEL_SOURCE = "areal_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "areal_tpu/ops/paged_attention.py:118"
Q8_REPLACES = "areal_tpu/ops/paged_attention.py:168"
VERIFY_REPLACES = "areal_tpu/ops/paged_attention.py:284"
VERIFY_Q8_REPLACES = "areal_tpu/ops/paged_attention.py:346"
QMM_SOURCE = "areal_tpu_torch/ops/csrc/quant_matmul.cu"
QMM_REPLACES = "areal_tpu/ops/quant_matmul.py:55"
FLASH_SOURCE = "areal_tpu_torch/ops/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_attention_fwd": "areal_tpu/ops/flash_attention.py:73",
    "flash_attention_bwd_dq": "areal_tpu/ops/flash_attention.py:228",
    "flash_attention_bwd_dkv": "areal_tpu/ops/flash_attention.py:287",
}

# serve phase (Qwen2.5-7B decode at the north-star recipe's batch shape)
SERVE = dict(
    max_running_requests=16, context_length=4096, page_size=128,
    new_tokens_per_chunk=128,
)
N_REQUESTS = 16
PROMPT_LEN = (64, 1024)
MAX_NEW = 256
# the int8 serve phase: the same engine settings and traffic
SERVE_INT8 = dict(SERVE, weight_dtype="int8", kv_dtype="int8")
# Qwen2.5-7B's bytes as reckoned from its shapes (models/smoke.py), to set
# beside the measured ones: weights with int8 dense kernels + f32 scales
# + bf16 embedding, head, norms and biases; the int8 pool + f32 scales at
# the serve shape (16 slots x 4096 context, page 128: 513 blocks)
RECKONED_INT8_WEIGHTS_GB = 8.72
RECKONED_INT8_KV_POOL_GB = 1.94

# phase 3: kernel vs plain
KERNEL_CASES = [
    dict(name="qwen2.5-7b", nH=28, nKV=4, hd=128, bsz=128, R=16, max_len=4096),
    # the train phase's rollout engine: 32 slots, context 1024
    dict(name="qwen2.5-1.5b", nH=12, nKV=2, hd=128, bsz=128, R=32, max_len=1024),
    dict(name="qwen2.5-0.5b", nH=14, nKV=2, hd=64, bsz=128, R=16, max_len=4096),
    dict(name="small-page", nH=4, nKV=2, hd=16, bsz=16, R=8, max_len=512),
    # a group above 8: the bf16 kernels' query rows g + 8 of the m16 tile
    dict(name="group-12", nH=24, nKV=2, hd=128, bsz=64, R=8, max_len=1000),
]
# pages per split of the bf16 decode kernels' sweep (checked and timed);
# None: the whole table in one split
DECODE_SPLITS = (1, 2, 4, None)
# (atol, rtol): an element passes when |out - ref| <= atol + rtol * |ref|.
# f32: summation order only. bf16: held against the f32-upcast reference
# (the plain bf16 path would also round scores and probabilities to bf16,
# :100-109). The kernel computes in f32 from the same bf16 inputs and
# rounds its output to bf16 once, to nearest, which moves a value by at
# most 2^-8 of itself; the f32 summation term is the f32 case's atol.
KERNEL_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -8)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = resolve_device(None)  # raises unless sm_90
    smi = nvidia_smi()
    emit(
        "device",
        name=torch.cuda.get_device_name(dev),
        count=torch.cuda.device_count(),
        capability=list(torch.cuda.get_device_capability(dev)),
        nvidia_smi=smi,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        python=sys.version.split()[0],
    )
    return dev, smi


def _ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from nvcc's `-Xptxas -v` report:
    kernel<dtype,head_dim>, registers, spill bytes. The flash tensor-core
    kernels (`*_mma_kernel<HD>`) take bf16 only."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d((?:flash|paged|quant)_[a-z0-9_]+?kernel)I(f|13__nv_bfloat16)?Li(\d+)E"
                          r"(?:Li(\d+)E)?", line)
            dtype = "f32" if m and m.group(2) == "f" else "bf16"
            if m and m.group(1).startswith("quant_matmul"):
                # K6: <row fragments>
                name = f"{m.group(1)}<{m.group(3)}>"
            elif m:
                name = f"{m.group(1)}<{dtype},{m.group(3)}>"
            else:
                name = line.split("'")[1]
        elif "spill stores" in line and name:
            spill = re.findall(r"(\d+) bytes spill", line)
        elif "Used" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, spills {'/'.join(spill)} bytes")
            name = None
    return out


def phase_build() -> None:
    """Every source, one nvcc each, started together; each kernel's
    registers and spills from ptxas (K2a, K3, K5a, K4 and K5b on the tensor
    cores must not spill at hd 128, nor K6's bf16 route at any row-tile
    size), K6's bf16 occupancy (blocks per SM) at each row-tile size, and
    the dynamic shared memory of the flash, int8-matmul and bf16 paged
    kernels' blocks as their launches size it."""
    t0 = time.perf_counter()
    built = _build.build_all()
    wall_s = time.perf_counter() - t0
    rows = [dict(name=b.name, seconds=b.seconds, cached=b.cached, ptxas=_ptxas_summary(b.log))
            for b in built.values()]
    # K2a on the tensor cores at every head dim: its dQ sums and a 32-key
    # step's scores must fit in registers
    k2a = [line for r in rows for line in r["ptxas"] if line.startswith("flash_bwd_dq_mma_kernel")]
    check(len(k2a) == 4, f"K2a: {len(k2a)} tensor-core instantiations in the ptxas report")
    check(any(line.startswith("flash_bwd_dq_mma_kernel<bf16,128>:") and
              line.endswith("spills 0/0 bytes") for line in k2a), f"K2a spills at hd 128: {k2a}")
    # K3, K5a, K4 and K5b on the tensor cores (bf16 q) at every head dim, no
    # spill at hd 128; their combine passes
    paged_ptxas = {}
    for kern in ("paged_attn_mma_kernel", "paged_attn_q8_mma_kernel", "paged_verify_mma_kernel",
                 "paged_verify_q8_mma_kernel", "paged_attn_combine_kernel",
                 "paged_attn_q8_combine_kernel"):
        found = [line for r in rows for line in r["ptxas"] if line.startswith(kern + "<")]
        check(len(found) == 4, f"{kern}: {len(found)} instantiations in the ptxas report")
        check(any(line.startswith(f"{kern}<bf16,128>:") and line.endswith("spills 0/0 bytes")
                  for line in found), f"{kern} spills at hd 128: {found}")
        paged_ptxas[kern] = found
    # K6's bf16 route at every row-tile size (the main path launches all
    # five: decode 1, verify 2-5, prefill 4-5)
    k6 = [line for r in rows for line in r["ptxas"] if line.startswith("quant_matmul_")]
    k6_mts = range(1, qm.MAX_ROWS // 16 + 1)
    for mt in k6_mts:
        check(any(line.startswith(f"quant_matmul_sk_kernel<{mt}>:") and
                  line.endswith("spills 0/0 bytes") for line in k6),
              f"K6 <{mt}> missing or spills: {k6}")
    k6_occupancy = {mt: qm.occupancy(torch.device("cuda", 0), mt) for mt in k6_mts}
    # ptxas reports static shared memory only; the kernels size theirs per launch
    smem = {f"{str(dt).split('.')[-1]}_hd{hd}": fa.smem_bytes(8192, hd, dt)
            for dt in (torch.bfloat16, torch.float32) for hd in (16, 64, 128)}
    # quant_matmul: stages of a 64 x 144-byte int8 tile and a 16 mt x 72 x tile
    qmm = {f"bf16_mt{mt}": qm.STAGES * (64 * 144 + 16 * mt * 72 * 2) for mt in k6_mts}
    qmm.update({f"f32_mt{mt}": 4 * (64 * 144 + 16 * mt * 72 * 4) for mt in (1, 4)})
    # K4/K5b (bf16 q): q rows, K/V tiles (K5b: int8 tiles and scales beside
    # them), per-row masks and offsets of a split; page 128
    verify = {f"{'K5b' if quant else 'K4'}_W{W}_group{g}_hd{hd}_pages{pps}":
              pa.split_smem_bytes(W, g, hd, 128, pps, quant)
              for quant in (False, True)
              for W, g, hd, pps in ((5, 7, 128, 1), (5, 7, 128, 2), (5, 7, 128, 9), (9, 7, 128, 2),
                                    (16, 8, 128, 2), (16, 8, 128, 32), (9, 7, 64, 2))}
    # K3/K5a (bf16 q): q rows, each warp's K/V quarters (K5a: int8 quarters
    # and scales beside them), per-row offsets of a split; page 128
    decode = {f"{'K5a' if quant else 'K3'}_hd{hd}_pages{pps}":
              pa.split_smem_bytes(0, 7, hd, 128, pps, quant)
              for quant in (False, True) for hd, pps in ((128, 1), (128, 2), (128, 10), (64, 1))}
    emit("build", kernels=rows, wall_s=wall_s, k2a_ptxas=k2a, paged_ptxas=paged_ptxas,
         k6_ptxas=k6, k6_occupancy=k6_occupancy,
         shared_memory=dict(paged_attention_f32="dynamic, sized per launch",
                            paged_attention_bf16=decode, paged_verify_bf16=verify,
                            flash_attention_T8192=smem, quant_matmul=qmm))


def _paged_case(case: dict, dtype: torch.dtype, dev: torch.device, seed: int):
    """Random pools, a ragged block table with null-block tails, one slot
    with no valid row, one full slot and one whose rows end on page 4's
    last row."""
    R, nH, nKV, hd, bsz = case["R"], case["nH"], case["nKV"], case["hd"], case["bsz"]
    nb = -(-case["max_len"] // bsz)
    n_blocks = R * nb + 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = rng.integers(1, case["max_len"], R)
    lengths[0] = -1  # no valid row: output must be exactly 0
    lengths[1] = case["max_len"] - 1
    if case["max_len"] > 4 * bsz:  # rows ending on a split boundary (1, 2 and 4 pages)
        lengths[2] = 4 * bsz - 1
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, nb), np.int32)
    for r in range(R):
        used = -(-(int(lengths[r]) + 1) // bsz)
        table[r, :used] = perm[r * nb : r * nb + used]
    shape = (n_blocks, bsz, nKV, hd)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn((R, nH, hd), generator=gen, device=dev).to(dtype)
    valid = torch.arange(nb * bsz, device=dev)[None, :] <= torch.as_tensor(lengths, device=dev)[:, None]
    return q, k, v, torch.as_tensor(table, device=dev), valid.contiguous()


def _tol_ratio(out, ref, atol: float, rtol: float) -> float:
    """Largest |out - ref| / (atol + rtol * |ref|): at most 1 passes."""
    return ((out.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _decode_splits(q, pools, table, valid, ref, dtype, name: str) -> tuple[dict, float]:
    """bf16 K3/K5a at every split of `DECODE_SPLITS` against `ref`: the
    tolerance ratio per split and the largest error; each must pass, and
    the slot with no valid row must give exactly 0."""
    if dtype != torch.bfloat16:
        return {}, 0.0
    atol, rtol = KERNEL_TOL[dtype]
    nb = table.shape[1]
    ratios, err = {}, 0.0
    for pps in DECODE_SPLITS:
        o = pa._launch(q, *pools, table, valid, 1.0 / math.sqrt(q.shape[-1]), pps or nb)
        torch.cuda.synchronize()
        ratios[pps or "all"] = r = _tol_ratio(o, ref, atol, rtol)
        err = max(err, (o.float() - ref).abs().max().item())
        check(math.isfinite(r) and r <= 1.0,
              f"{name} at {pps or nb} pages per split: {r} x the tolerance")
        check(bool((o[0] == 0).all().item()),
              f"{name} at {pps or nb} pages per split: slot with no valid row is not 0")
    return ratios, err


def phase_kernel(dev: torch.device) -> float:
    """K3 against its plain version, f32 q (the first version) and bf16 q
    (the tensor-core kernel, at its default split and at every split of
    `DECODE_SPLITS`). Besides the sound reading, each case reads the kernel
    against a planted fault, the plain version with the first page of
    every multi-page slot dropped, and checks that the tolerance would
    catch it."""
    rows, worst = [], 0.0
    for i, case in enumerate(KERNEL_CASES):
        nb = -(-case["max_len"] // case["bsz"])
        default_pps = pa.decode_pages_per_split(nb, case["bsz"], case["R"], case["nKV"], pa._n_sms(dev))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, valid = _paged_case(case, dtype, dev, SEED + i)
            out = pa.paged_attention(q, k, v, table, valid)
            torch.cuda.synchronize()
            qf, kf, vf = q.float(), k.float(), v.float()
            ref = pa.paged_attention_ref(qf, kf, vf, table, valid)
            dropped = valid.clone()
            dropped[:, : case["bsz"]] &= ~(valid.sum(1) > case["bsz"])[:, None]
            ref_fault = pa.paged_attention_ref(qf, kf, vf, table, dropped)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]
            err = (out.float() - ref).abs().max().item()
            ratio = _tol_ratio(out, ref, atol, rtol)
            fault_ratio = _tol_ratio(out, ref_fault, atol, rtol)
            empty_zero = bool((out[0] == 0).all().item())
            name = f"K3 {case['name']} {str(dtype).split('.')[-1]}"
            split_ratios, split_err = _decode_splits(q, (k, v), table, valid, ref, dtype, name)
            rows.append(dict(case=case["name"], dtype=str(dtype).split(".")[-1],
                             max_abs_err=max(err, split_err), atol=atol, rtol=rtol, tol_ratio=ratio,
                             planted_fault_tol_ratio=fault_ratio,
                             empty_slot_zero=empty_zero,
                             **(dict(default_pages_per_split=default_pps,
                                     split_tol_ratio=split_ratios) if split_ratios else {})))
            check(math.isfinite(ratio) and ratio <= 1.0,
                  f"kernel vs plain {name}: {ratio} x the tolerance (max abs err {err})")
            check(fault_ratio > 1.0, f"kernel {name}: a dropped page passes the tolerance")
            check(empty_zero, f"kernel {name}: slot with no valid row is not 0")
            worst = max(worst, err, split_err)
    # a table with no column: nothing to attend, the output is exactly 0
    none = pa.paged_attention(q, k, v, table[:, :0].contiguous(), valid[:, :0].contiguous())
    check(bool((none == 0).all().item()), "kernel: an empty table does not give 0")
    emit("kernel", tol={str(k).split(".")[-1]: v for k, v in KERNEL_TOL.items()},
         splits=[p or "all" for p in DECODE_SPLITS], cases=rows, max_abs_err=worst)
    return worst


# Run in a child process, one per q dtype: a faulted launch leaves the CUDA
# context unusable. Slot 1's second page names block 7, outside the 5-block
# pool. While that page holds no valid row the id is never read: the output
# equals the launch with a good id there, bit for bit (bf16: at every split
# of 1 and 2 pages). Then its rows are made valid: the launch must fault.
_BAD_TABLE_PROBE = """
import json, sys, torch
from areal_tpu_torch.ops import paged_attention as pa
dev = torch.device("cuda")
dtype = getattr(torch, sys.argv[1])
q = torch.randn(2, 4, 16, device=dev).to(dtype)
k = torch.randn(5, 16, 2, 16, device=dev).to(dtype)
table = torch.tensor([[1, 2], [3, 7]], dtype=torch.int32, device=dev)  # 7: no such block
good = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device=dev)
valid = torch.ones(2, 32, dtype=torch.bool, device=dev)
valid[1, 16:] = False
outs = [(pa.paged_attention(q, k, k, table, valid), pa.paged_attention(q, k, k, good, valid))]
if dtype == torch.bfloat16:
    for pps in (1, 2):
        outs.append(tuple(pa._launch(q, k, k, t, valid, 0.25, pps) for t in (table, good)))
torch.cuda.synchronize()
res = dict(dtype=sys.argv[1], unread_bad_id_ok=all(torch.equal(a, b) for a, b in outs),
           faulted=False)
valid[1] = True
try:
    pa.paged_attention(q, k, k, table, valid)
    torch.cuda.synchronize()
except (RuntimeError, getattr(torch, "AcceleratorError", RuntimeError)) as e:
    res.update(faulted=True, error=str(e).splitlines()[0])
print(json.dumps(res), flush=True)
"""


def phase_bad_table() -> None:
    """A block id outside the pool on a page with valid rows must fault the
    kernel's launch; on a page without valid rows it is never read. Both
    routes: f32 q (the first version) and bf16 q (the tensor-core kernel)."""
    results = []
    for dtype in ("float32", "bfloat16"):
        proc = subprocess.run(
            [sys.executable, "-c", _BAD_TABLE_PROBE, dtype], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=300,
        )
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        check(bool(lines), f"bad-table probe ({dtype}) printed nothing (rc {proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
        results.append(json.loads(lines[-1]))
    emit("bad_table", cases=results)
    for res in results:
        check(res["unread_bad_id_ok"],
              f"kernel ({res['dtype']}): a bad id on a page without valid rows changed the output")
        check(res["faulted"],
              f"kernel ({res['dtype']}): a bad block id on a valid page did not fault the launch")


# phase: K1/K2a/K2b against the plain version
FLASH_CASES = [
    dict(name="qwen2.5-1.5b", nH=12, nKV=2, hd=128, T=4096, n_seqs=40),
    dict(name="qwen2.5-7b", nH=28, nKV=4, hd=128, T=2048, n_seqs=12),
    dict(name="qwen2.5-0.5b", nH=14, nKV=2, hd=64, T=2048, n_seqs=16),
    dict(name="small", nH=4, nKV=2, hd=16, T=1000, n_seqs=9),
    # hd 32, one kv head for a group of 6, a ragged T
    dict(name="hd32-mqa", nH=6, nKV=1, hd=32, T=777, n_seqs=5),
]
FLASH_PAD = 45  # pad-tail rows (segment -1): fully masked, o 0 and lse -1e30
# (a, rtol): an element passes when |x - ref| <= a * max|ref| + rtol * |ref|,
# ref the plain version on the f32-upcast inputs. f32: summation order
# only (the two sides sum up to a few thousand f32 products in different
# orders, ~1e-6 of the largest value). bf16: the kernels round each output
# to bf16 once (at most 2^-8 of itself: rtol), and the tensor-core kernels
# feed P and dS to their second products as bf16 hi + lo (within 2^-16):
# a = 2^-8. The backward's delta = rowsum(dO * O) reads the kernels' O,
# rounded to bf16, where the plain version reads its f32 O; that error is
# shared by a whole row of ds and summed coherently into dq, so the dq
# reference carries it exactly (`_dq_delta_term`). lse is f32 in both and
# takes the f32 tolerance.
FLASH_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (2.0 ** -8, 2.0 ** -8)}
LSE_TOL = (2e-5, 0.0)


def _packed_segments(T: int, n_seqs: int, pad: int, rng) -> np.ndarray:
    """A packed stream: `n_seqs` sequences of random lengths, then a pad
    tail of segment -1."""
    body = T - pad
    cuts = np.sort(rng.choice(np.arange(1, body), n_seqs - 1, replace=False))
    seg = np.full(T, fa.PADDING_SEGMENT, np.int32)
    for i, (a, b) in enumerate(zip([0, *cuts], [*cuts, body])):
        seg[a:b] = i
    return seg


def _flash_run(fn, q, k, v, ids, w_o, w_l):
    """(o, lse [Tq, nH], dq, dk, dv) of sum(o * w_o) + sum(lse * w_l) over
    rows with a valid key."""
    o, lse = fn(q, k, v, *ids)
    live = lse > -5e29
    loss = (o.float() * w_o).sum() + (torch.where(live, lse, 0.0) * w_l).sum()
    grads = torch.autograd.grad(loss, (q, k, v))
    return (o.detach(), lse.detach(), *grads)


def _scaled_ratio(x, ref, a: float, rtol: float) -> float:
    """Largest |x - ref| / (a * max|ref| + rtol * |ref|): at most 1 passes."""
    x, ref = x.float(), ref.float()
    bound = a * ref.abs().max() + rtol * ref.abs()
    return ((x - ref).abs() / bound).max().item()


def _dq_delta_term(q, k, ids, o, o_ref, do, sm_scale: float):
    """What dq moves by, through autograd, when the backward's delta =
    rowsum(dO * O) reads the kernels' output `o` where the plain version
    reads its f32 `o_ref`: ds = p (dp - delta + dlse) is linear in delta, so
    dq gains -sm_scale (delta_o - delta_ref)_i sum_j p_ij k_j, and
    sum_j p_ij k_j is the plain forward with k in v's place. [Tq, nH, hd]."""
    d_delta = ((o.float() - o_ref.float()) * do.float()).sum(-1)
    pk, _ = fa.flash_attention_ref(q.float(), k.float(), k.float(), *ids, sm_scale=sm_scale)
    return -sm_scale * d_delta[..., None] * pk


def _flash_case(case: dict, dtype, dev, seed: int, chunk: bool):
    """Inputs of one case. The packed case attends a stream to itself; the
    chunk case attends a query chunk to an earlier, overlapping kv chunk
    (global positions, as ring attention would), with a segment that has no
    key in the chunk and a non-zero gradient through lse."""
    rng = np.random.default_rng(seed)
    nH, nKV, hd, T = case["nH"], case["nKV"], case["hd"], case["T"]
    if chunk:
        pos_k = np.arange(1000, 1000 + T, dtype=np.int32)
        pos_q = np.arange(1000 + T // 2, 1000 + T // 2 + T, dtype=np.int32)
        seg_k, seg_q = pos_k // 300, pos_q // 300
        seg_q[100:150] = 10 ** 6  # no key of this segment: fully masked rows
        seg_q[-FLASH_PAD:] = fa.PADDING_SEGMENT
    else:
        seg_q = seg_k = _packed_segments(T, case["n_seqs"], FLASH_PAD, rng)
        pos_q = pos_k = np.arange(T, dtype=np.int32)
    ids = [torch.as_tensor(x, device=dev) for x in (seg_q, seg_k, pos_q, pos_k)]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype).float()

    q, k, v = rand(T, nH, hd), rand(T, nKV, hd), rand(T, nKV, hd)
    w_o = rand(T, nH, hd)  # representable in `dtype`: both sides get the same dO
    w_l = rand(T, nH) if chunk else torch.zeros(T, nH, device=dev)
    return q, k, v, ids, w_o, w_l


def phase_flash_kernel(dev: torch.device) -> dict:
    """K1, K2a and K2b (through `flash_attention_chunk` and autograd)
    against `flash_attention_ref` with autograd, on the card: o, lse, dq, dk
    and dv, the dq reference with the delta term of the kernels' O
    (`_dq_delta_term`; the ratio without it is printed beside). Each case
    also reads the kernels against a planted fault, the plain version with
    the causal diagonal excluded (query positions shifted by one), and
    checks that the tolerance would catch it."""
    def kernels(q, k, v, *ids):
        return fa.flash_attention_chunk(q, k, v, fa.flash_layout(*ids))

    rows, worst = [], {}
    cases = [(c, False) for c in FLASH_CASES] + [(FLASH_CASES[0], True)]
    for i, (case, chunk) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ids, w_o, w_l = _flash_case(case, dtype, dev, SEED + 10 + i, chunk)
            xs = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            got = _flash_run(kernels, *xs, ids, w_o, w_l)
            torch.cuda.synchronize()
            fs = [t.clone().requires_grad_() for t in (q, k, v)]
            ref = _flash_run(fa.flash_attention_ref, *fs, ids, w_o, w_l)
            shifted = [ids[0], ids[1], ids[2] - 1, ids[3]]
            fault = _flash_run(fa.flash_attention_ref, *fs, shifted, w_o, w_l)
            torch.cuda.synchronize()
            live = ref[1] > -5e29
            dead_ok = bool((got[1][~live] == -1e30).all() and (got[0][~live] == 0).all())
            row = dict(case=case["name"] + (" chunk+dlse" if chunk else ""),
                       dtype=str(dtype).split(".")[-1], T=case["T"],
                       masked_rows=int((~live).any(dim=1).sum()), dead_rows_exact=dead_ok)
            name = f"{row['case']} {row['dtype']}"
            sm = 1.0 / math.sqrt(case["hd"])
            term = _dq_delta_term(q, k, ids, got[0], ref[0], w_o, sm)
            for j, out in enumerate(("o", "lse", "dq", "dk", "dv")):
                a, rtol = LSE_TOL if out == "lse" else FLASH_TOL[dtype]
                x, r, f = got[j], ref[j], fault[j]
                if out == "lse":
                    x, r, f = x[live], r[live], f[live]
                extra = {}
                if out == "dq":
                    extra["tol_ratio_without_delta_term"] = _scaled_ratio(x, r, a, rtol)
                    r = r + term
                err = (x.float() - r).abs().max().item()
                ratio = _scaled_ratio(x, r, a, rtol)
                fault_ratio = _scaled_ratio(x, f, a, rtol)
                row[out] = dict(max_abs_err=err, tol_ratio=ratio, fault_tol_ratio=fault_ratio,
                                **extra)
                check(math.isfinite(ratio) and ratio <= 1.0,
                      f"flash {name} {out}: {ratio} x the tolerance (max abs err {err})")
                check(fault_ratio > 1.0, f"flash {name} {out}: the planted fault passes")
                worst[out] = max(worst.get(out, 0.0), err)
            check(dead_ok, f"flash {name}: a fully-masked row is not o 0, lse -1e30")
            rows.append(row)
            del xs, got, fs, ref, fault, term
    # the bf16 kernels copy 16-byte rows: a misaligned view raises in the
    # wrapper and never reaches them
    q, k, v, ids, _, _ = _flash_case(FLASH_CASES[-1], torch.bfloat16, dev, SEED, False)
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(q.shape)
    shifted.copy_(q)
    try:
        kernels(shifted, k.to(torch.bfloat16), v.to(torch.bfloat16), *ids)
        misaligned_raises = False
    except ValueError:
        misaligned_raises = True
    check(misaligned_raises, "flash: a misaligned bf16 q reached the kernels")
    emit("flash_kernel", tol=dict(f32=FLASH_TOL[torch.float32],
                                  bf16=FLASH_TOL[torch.bfloat16], lse=LSE_TOL),
         cases=rows, max_abs_err=worst, misaligned_bf16_raises=misaligned_raises)
    return worst


# phase: K5a and K6 against their plain versions
Q8_CASES = [
    KERNEL_CASES[0],  # the serve shape: Qwen2.5-7B, R 16, context 4096
    KERNEL_CASES[1],  # the rollout shape: Qwen2.5-1.5B, R 32, context 1024
    dict(name="small-page-hd64", nH=14, nKV=2, hd=64, bsz=16, R=8, max_len=512),
    KERNEL_CASES[3],  # hd 16, page 16
    KERNEL_CASES[4],  # group 12
]
# (K, N) of Qwen2.5-7B's q/o, k/v, gate/up and down kernels, then ragged
# ones: K and N off the 64/128 tiles (element loads), and N a multiple of
# 16 but not of 128 with K not of 64 (16-byte loads, masked tiles)
QMM_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (3037, 777), (1000, 3536)]
# one slot, a decode batch, the verify batches of 16 slots at W 2 and 3,
# the smallest prefill bucket, the verify batch at W 5, a ragged prefill
# bucket: the bf16 kernel at every row-tile size (row fragments 1, 1, 2,
# 3, 4, 5, 5)
QMM_T = (1, 16, 32, 48, 64, 80, 700)
# (a, rtol): an element passes when |out - ref| <= a * max|ref| + rtol * |ref|,
# ref the plain version in f32 (`q * scale` first, then the f32 product).
# The kernel's products are exact (int8 is exact in bf16; f32 x is split
# into three bf16 terms) and it scales after the K loop, so the two differ
# by the order and rounding of f32 sums of up to 18,944 terms: a = 1e-5 of
# the largest value. bf16 output: one rounding to nearest, rtol 2^-8.
QMM_TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-5, 2.0 ** -8)}


def _int8_pool(pool):
    """fp pool [n_blocks, bsz, nKV, hd] -> (int8 data, f32 scales
    [n_blocks, nKV, bsz]), quantized by the port's `quantize_kv`."""
    q, sc = quantize_kv(pool)
    return q, sc.transpose(1, 2).contiguous()


def _dropped_segment_ratio(x, wq, ws, out, ref, p, a: float, rtol: float):
    """The bf16 K6 planted fault: the plain version without the middle
    segment of the tile cut into the most segments under plan `p`, read
    against the kernel's output (None when no tile is cut)."""
    n_seg = [len(qm.tile_segments(p, t)) for t in range(p.m_tiles * p.n_tiles)]
    tile = max(range(len(n_seg)), key=n_seg.__getitem__)
    if n_seg[tile] == 1:
        return None
    _, _, lo, hi = qm.tile_segments(p, tile)[n_seg[tile] // 2]
    mi, ni = divmod(tile, p.n_tiles)
    rows = slice(16 * p.mt * mi, 16 * p.mt * (mi + 1))
    cols = slice(qm.TILE_N * ni, qm.TILE_N * (ni + 1))
    ks = slice((lo % p.k_tiles) * qm.TILE_K, (hi % p.k_tiles + 1) * qm.TILE_K)
    ref_fault = ref.clone()
    ref_fault[rows, cols] -= qm.quant_matmul_ref(
        x[rows, ks].contiguous(), wq[ks, cols].contiguous(), ws[cols].contiguous(), torch.float32)
    return _scaled_ratio(out, ref_fault, a, rtol)


def phase_quant_kernel(dev: torch.device) -> dict:
    """K5a against its plain version with the attention in f32 (the plain
    bf16 path rounds the dequantized K/V to bf16, which the kernel does
    not): the tolerances of K3, since both dequantize to the same f32
    values; bf16 q also at every split of `DECODE_SPLITS`. The planted
    fault: the plain version with the scales of the
    first page of every multi-page slot ignored (read as 1). K6 against
    `_quant_matmul_xla`'s arithmetic at Qwen2.5-7B's four (K, N) shapes
    and two ragged ones, for every `QMM_T`, bf16 and f32 x, each launched
    twice (the two outputs must be equal bit for bit). The planted faults:
    the plain version without the last 64-deep K tile, and for bf16 x
    without one segment of a tile cut between blocks. Each fault must
    read above its tolerance."""
    rows, worst = [], dict(paged_attention_q8=0.0, quant_matmul=0.0)
    for i, case in enumerate(Q8_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, table, valid = _paged_case(case, dtype, dev, SEED + 30 + i)
            kq, vq = _int8_pool(k), _int8_pool(v)
            del k, v
            out = pa.paged_attention(q, kq, vq, table, valid)
            torch.cuda.synchronize()
            ref = pa.paged_attention_ref(q.float(), kq, vq, table, valid)
            multi = (valid.sum(1) > case["bsz"]).nonzero()[:, 0]
            first = table[multi, 0].long()
            fk, fv = (kq[0], kq[1].clone()), (vq[0], vq[1].clone())
            fk[1][first] = 1.0
            fv[1][first] = 1.0
            ref_fault = pa.paged_attention_ref(q.float(), fk, fv, table, valid)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]
            err = (out.float() - ref).abs().max().item()
            ratio = _tol_ratio(out, ref, atol, rtol)
            fault_ratio = _tol_ratio(out, ref_fault, atol, rtol)
            empty_zero = bool((out[0] == 0).all().item())
            name = f"K5a {case['name']} {str(dtype).split('.')[-1]}"
            split_ratios, split_err = _decode_splits(q, (kq, vq), table, valid, ref, dtype, name)
            rows.append(dict(kernel="paged_attention_q8", case=case["name"],
                             dtype=str(dtype).split(".")[-1], max_abs_err=max(err, split_err),
                             atol=atol, rtol=rtol, tol_ratio=ratio,
                             planted_fault_tol_ratio=fault_ratio, empty_slot_zero=empty_zero,
                             **(dict(split_tol_ratio=split_ratios) if split_ratios else {})))
            check(math.isfinite(ratio) and ratio <= 1.0,
                  f"{name}: {ratio} x the tolerance (max abs err {err})")
            check(fault_ratio > 1.0, f"{name}: ignored page scales pass the tolerance")
            check(empty_zero, f"{name}: slot with no valid row is not 0")
            worst["paged_attention_q8"] = max(worst["paged_attention_q8"], err, split_err)
            del q, kq, vq, fk, fv, out, ref, ref_fault
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    for K, N in QMM_SHAPES:
        w = torch.randn((K, N), generator=gen, device=dev)
        wq, ws = quantize_absmax(w, axis=0)
        del w
        k_last = (K - 1) // qm.TILE_K * qm.TILE_K  # the last K tile's first row
        wq_fault = wq.clone()
        wq_fault[k_last:] = 0
        for T in QMM_T:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((T, K), generator=gen, device=dev).to(dtype)
                out = qm.quant_matmul(x, wq, ws)
                again = qm.quant_matmul(x, wq, ws)
                torch.cuda.synchronize()
                ref = qm.quant_matmul_ref(x, wq, ws, torch.float32)
                ref_fault = qm.quant_matmul_ref(x, wq_fault, ws, torch.float32)
                a, rtol = QMM_TOL[dtype]
                err = (out.float() - ref).abs().max().item()
                ratio = _scaled_ratio(out, ref, a, rtol)
                fault_ratio = _scaled_ratio(out, ref_fault, a, rtol)
                name = f"K6 T {T} K {K} N {N} {str(dtype).split('.')[-1]}"
                row = dict(kernel="quant_matmul", T=T, K=K, N=N, dtype=str(dtype).split(".")[-1],
                           max_abs_err=err, a=a, rtol=rtol, tol_ratio=ratio,
                           planted_fault_tol_ratio=fault_ratio,
                           bit_equal_relaunch=torch.equal(_bits(out), _bits(again)))
                if dtype == torch.bfloat16:
                    p = qm._plan_on(dev, T, K, N)
                    row.update(mt=p.mt, m_tiles=p.m_tiles, grid=p.grid, units=p.units)
                    seg_ratio = _dropped_segment_ratio(x, wq, ws, out, ref, p, a, rtol)
                    row["dropped_segment_tol_ratio"] = seg_ratio
                    check(seg_ratio is None or seg_ratio > 1.0,
                          f"{name}: a dropped segment of a cut tile passes the tolerance")
                else:
                    row.update(zip(("mt", "splits", "tiles_per_split"),
                                   qm.plan_f32(T, K, N, qm._n_sms(dev))))
                rows.append(row)
                check(out.shape == (T, N) and out.dtype == dtype, f"{name}: shape or dtype")
                check(math.isfinite(ratio) and ratio <= 1.0,
                      f"{name}: {ratio} x the tolerance (max abs err {err})")
                check(fault_ratio > 1.0, f"{name}: a dropped K tile passes the tolerance")
                check(row["bit_equal_relaunch"], f"{name}: two launches differ")
                worst["quant_matmul"] = max(worst["quant_matmul"], err)
        del wq, ws, wq_fault
    torch.cuda.empty_cache()
    emit("quant_kernel", tol=dict(paged_attention_q8={str(k).split(".")[-1]: v
                                                      for k, v in KERNEL_TOL.items()},
                                  quant_matmul={str(k).split(".")[-1]: v
                                                for k, v in QMM_TOL.items()}),
         cases=rows, max_abs_err=worst)
    return worst


# phase: K4 and K5b against their plain version, and the sampler's noise
VERIFY_CASES = [
    KERNEL_CASES[0],  # the serve shape: Qwen2.5-7B, R 16, context 4096
    KERNEL_CASES[1],  # the rollout shape: Qwen2.5-1.5B, 12/2 heads, R 32
    KERNEL_CASES[2],  # hd 64
    KERNEL_CASES[3],  # hd 16, page 16
    # 40-row pages: a 64-row tile crosses pages, and a split's last tile is
    # partial (zero-filled past its rows)
    dict(name="page-40", nH=28, nKV=4, hd=128, bsz=40, R=8, max_len=1000),
    # the serve shape with slot 3's rows ending on a split boundary (8
    # pages: a boundary of every swept split but the whole table)
    dict(KERNEL_CASES[0], name="split-end", split_end_pages=8),
]
# pages per split of the bf16 verify kernels' sweep (checked and timed);
# None: the whole table in one split
VERIFY_SPLITS = (1, 2, 4, None)
VERIFY_WIDTHS = (2, 3, 5, 9)
SPEC_K = 4  # the spec serve phases' spec_k: verify widths 2, 3 and 5
# jax.random on the CPU (jax 0.9.0): fold_in(key (123, 456), 7), then the
# first 4 bits, uniforms (as f32 bit patterns) and Gumbel values of that
# key, and fold_in(that key, 1) with its first 4 bits
JAX_FOLD_IN_123_456_7 = (3069288025, 2881389178)
JAX_BITS_4 = (4166509511, 2500705419, 59026623, 1202473212)
JAX_UNIFORM_BITS_4 = (1064851426, 1058344380, 1013000960, 1049581712)
JAX_GUMBEL_4 = (3.4944510459899902, 0.6145741939544678, -1.4556370973587036, -0.24142631888389587)
JAX_SECONDARY_BITS_4 = (3303635717, 263785089, 1523738081, 3748719349)
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 64 int32 lanes per SM at boost clock
# 32-bit integer operations per element of the unrolled hash: 20 rounds of
# add, rotate (one funnel shift) and xor (60), 11 key-injection adds (the
# row's key sums are per row), then the xor of the two words and the shift
# and or of the mantissa trick (3); the float tail (subtract, add, max, two
# logs) runs on other units
THREEFRY_OPS = 74


def _verify_case(case: dict, W: int, dtype, dev, seed: int):
    """Random pools and queries; slot r's query w attends rows s <=
    base[r] + w over a ragged block table with null-block tails. Slot 0
    has no valid row for any query, slot 1 none for query 0, slot 2 is
    full; with `split_end_pages`, slot 3's rows end on that page boundary."""
    R, nH, nKV, hd, bsz = case["R"], case["nH"], case["nKV"], case["hd"], case["bsz"]
    nb = -(-case["max_len"] // bsz)
    n_blocks = R * nb + 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = rng.integers(1, case["max_len"] - W, R)
    base[0], base[1], base[2] = -W, -1, case["max_len"] - W
    if "split_end_pages" in case:  # the last query's last row ends a split
        base[3] = case["split_end_pages"] * bsz - W
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((R, nb), np.int32)
    for r in range(R):
        used = -(-max(int(base[r]) + W, 0) // bsz)
        table[r, :used] = perm[r * nb : r * nb + used]
    shape = (n_blocks, bsz, nKV, hd)
    k = torch.randn(shape, generator=gen, device=dev).to(dtype)
    v = torch.randn(shape, generator=gen, device=dev).to(dtype)
    q = torch.randn((R, W, nH, hd), generator=gen, device=dev).to(dtype)
    horizon = torch.as_tensor(base, device=dev)[:, None] + torch.arange(W, device=dev)
    valid = torch.arange(nb * bsz, device=dev)[None, None, :] <= horizon[:, :, None]
    return q, k, v, torch.as_tensor(table, device=dev), valid.contiguous()


def _noise_checks(dev: torch.device) -> dict:
    """The sampler's noise kernel against its plain version on the card
    (bits and uniforms bit for bit, Gumbel values within GUMBEL_TOL), and
    against constants jax.random gave on the CPU; a planted fault (the
    plain version one position on) must differ."""
    rng = np.random.default_rng(SEED + 50)
    rows = []
    for R, n in ((16, 152064), (80, 151936), (5, 64), (3, 1000)):
        keys = torch.as_tensor(rng.integers(0, 2**32, (R, 2)), device=dev)
        keys[0] = torch.tensor([123, 456])
        pos = torch.as_tensor(rng.integers(0, 40000, R), device=dev)
        pos[0] = 7
        for secondary in (False, True):
            got = {kind: tf.gumbel_noise(keys, pos, n, secondary=secondary, kind=kind) for kind in tf.KINDS}
            ref = {kind: tf.gumbel_noise_ref(keys, pos, n, secondary=secondary, kind=kind) for kind in tf.KINDS}
            fault = tf.gumbel_noise_ref(keys, pos + 1, n, secondary=secondary, kind="bits")
            torch.cuda.synchronize()
            bits_ok = torch.equal(got["bits"], ref["bits"])
            uni_ok = torch.equal(got["uniform"].view(torch.int32), ref["uniform"].view(torch.int32))
            atol, rtol = tf.GUMBEL_TOL
            g_ratio = _tol_ratio(got["gumbel"], ref["gumbel"], atol, rtol)
            g_equal = (got["gumbel"] == ref["gumbel"]).float().mean().item()
            fault_differs = (got["bits"] != fault).float().mean().item()
            name = f"noise R {R} n {n}{' secondary' if secondary else ''}"
            check(bits_ok, f"{name}: bits differ from the plain version")
            check(uni_ok, f"{name}: uniforms differ from the plain version")
            check(g_ratio <= 1.0, f"{name}: Gumbel {g_ratio} x the tolerance")
            check(fault_differs > 0.99, f"{name}: the next position's bits pass")
            want_bits = JAX_SECONDARY_BITS_4 if secondary else JAX_BITS_4
            check(got["bits"][0, :4].tolist() == list(want_bits[: min(n, 4)]),
                  f"{name}: bits of fold_in((123, 456), 7) differ from jax.random's")
            if not secondary:
                check(got["uniform"][0, :4].view(torch.int32).tolist() == list(JAX_UNIFORM_BITS_4),
                      f"{name}: uniforms differ from jax.random's")
                g4 = torch.tensor(JAX_GUMBEL_4, device=dev)
                check(_tol_ratio(got["gumbel"][0, :4], g4, atol, rtol) <= 1.0,
                      f"{name}: Gumbel values beyond the tolerance of jax.random's")
            rows.append(dict(R=R, n=n, secondary=secondary, bits_equal=bits_ok, uniforms_equal=uni_ok,
                             gumbel_tol_ratio=g_ratio, gumbel_share_equal=g_equal,
                             planted_fault_share_differs=fault_differs))
    key = tf.fold_in(torch.tensor([[123, 456]], device=dev), 7)
    check(tuple(key[0].tolist()) == JAX_FOLD_IN_123_456_7, f"fold_in((123, 456), 7) = {key.tolist()}")
    return dict(cases=rows, tol=tf.GUMBEL_TOL)


def _purity_checks(dev: torch.device) -> dict:
    """On the card, a row's token is a function of its logits, key and
    position alone: the same draw alone, in a shuffled batch, and beside a
    top-p row (which makes the batch run the top-p variant)."""
    rng = np.random.default_rng(SEED + 51)
    R, V = 8, 152064
    logits = torch.randn((R, V), generator=torch.Generator(device=dev).manual_seed(SEED + 51),
                         device=dev) * 3
    keys = torch.as_tensor(rng.integers(0, 2**32, (R, 2)), device=dev)
    pos = torch.as_tensor(rng.integers(0, 4096, R), device=dev)
    ones = torch.ones(R, device=dev)
    no = torch.zeros(R, dtype=torch.bool, device=dev)
    base, base_lp = sampling.sample(logits, keys, pos, ones, ones, no, use_topp=False)
    alone = torch.cat([sampling.sample(logits[r:r + 1], keys[r:r + 1], pos[r:r + 1], ones[:1],
                                       ones[:1], no[:1], use_topp=False)[0] for r in range(R)])
    perm = torch.as_tensor(rng.permutation(R), device=dev)
    shuffled, _ = sampling.sample(logits[perm], keys[perm], pos[perm], ones, ones, no, use_topp=False)
    tops = ones.clone()
    tops[R - 1] = 0.5
    mixed, _ = sampling.sample(logits, keys, pos, ones, tops, no, use_topp=True)
    # the same rows' tokens from the plain noise on the same card
    plain = torch.argmax(tf.gumbel_noise_ref(keys, pos, V) + logits, dim=-1)
    torch.cuda.synchronize()
    res = dict(alone=torch.equal(alone, base), shuffled=torch.equal(shuffled, base[perm]),
               beside_top_p=torch.equal(mixed[: R - 1], base[: R - 1]),
               plain_noise=torch.equal(plain, base), distinct_tokens=len(set(base.tolist())))
    for what, ok in res.items():
        if what != "distinct_tokens":
            check(ok, f"sampler purity: a row's draw changed {what.replace('_', ' ')}")
    return res


def phase_verify_kernel(dev: torch.device) -> dict:
    """K4 (fp pool) and K5b (int8 pool) against `paged_attention_qlen_ref`
    with f32 attention (K3's tolerances: the plain bf16 path would round
    scores and probabilities to bf16, which the kernels do not), at widths
    2, 3, 5 and 9, the serve and rollout shapes, hd 64, a 16-row page, a
    40-row page and a slot whose rows end on a split boundary, f32 q (the
    first version) and bf16 q (the tensor-core kernels, at their default
    split and at every split of `VERIFY_SPLITS`), with queries that have no
    valid row (exactly 0). The planted faults, each of which must read
    above its tolerance: K4, the plain version with the last query's mask
    replaced by the first one's; K5b, the scales of every multi-page slot's
    first page ignored (read as 1). Then the sampler's noise kernel and the
    sampler's purity."""
    rows, worst = [], dict(paged_verify=0.0, paged_verify_q8=0.0)
    for i, case in enumerate(VERIFY_CASES):
        nb = -(-case["max_len"] // case["bsz"])
        default_pps = pa.verify_pages_per_split(nb, case["bsz"], case["R"], case["nKV"],
                                                qm._n_sms(dev))
        for W in VERIFY_WIDTHS:
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, table, valid = _verify_case(case, W, dtype, dev, SEED + 60 + 10 * i + W)
                empty = ~valid.any(-1)
                for quant in (False, True):
                    if quant:
                        kp, vp = _int8_pool(k), _int8_pool(v)
                        multi = ((valid.any(1).sum(-1)) > case["bsz"]).nonzero()[:, 0]
                        first = table[multi, 0].long()
                        fk, fv = (kp[0], kp[1].clone()), (vp[0], vp[1].clone())
                        fk[1][first] = 1.0
                        fv[1][first] = 1.0
                        fault_args = (fk, fv, table, valid)
                    else:
                        kp, vp = k.float(), v.float()
                        moved = valid.clone()
                        moved[:, -1] = valid[:, 0]
                        fault_args = (kp, vp, table, moved)
                    pools = (kp, vp) if quant else (k, v)
                    out = pa.paged_attention_qlen(q, *pools, table, valid)
                    torch.cuda.synchronize()
                    ref = pa.paged_attention_qlen_ref(q.float(), kp, vp, table, valid)
                    ref_fault = pa.paged_attention_qlen_ref(q.float(), *fault_args)
                    torch.cuda.synchronize()
                    atol, rtol = KERNEL_TOL[dtype]
                    err = (out.float() - ref).abs().max().item()
                    ratio = _tol_ratio(out, ref, atol, rtol)
                    fault_ratio = _tol_ratio(out, ref_fault, atol, rtol)
                    empty_zero = bool((out[empty] == 0).all().item())
                    kname = "paged_verify_q8" if quant else "paged_verify"
                    name = f"{'K5b' if quant else 'K4'} {case['name']} W {W} {str(dtype).split('.')[-1]}"
                    split_ratios = {}
                    if dtype == torch.bfloat16:  # the tensor-core kernels at every swept split
                        for pps in VERIFY_SPLITS:
                            o = pa._launch(q, *pools, table, valid, 1.0 / math.sqrt(case["hd"]),
                                                  pps or nb)
                            torch.cuda.synchronize()
                            split_ratios[pps or "all"] = _tol_ratio(o, ref, atol, rtol)
                            err = max(err, (o.float() - ref).abs().max().item())
                            check(math.isfinite(split_ratios[pps or "all"])
                                  and split_ratios[pps or "all"] <= 1.0,
                                  f"{name} at {pps or nb} pages per split: "
                                  f"{split_ratios[pps or 'all']} x the tolerance")
                            check(bool((o[empty] == 0).all().item()),
                                  f"{name} at {pps or nb} pages per split: a query with no valid row is not 0")
                    rows.append(dict(kernel=kname, case=case["name"], W=W,
                                     dtype=str(dtype).split(".")[-1], max_abs_err=err, atol=atol,
                                     rtol=rtol, tol_ratio=ratio, planted_fault_tol_ratio=fault_ratio,
                                     empty_queries=int(empty.sum()), empty_queries_zero=empty_zero,
                                     **(dict(default_pages_per_split=default_pps,
                                             split_tol_ratio=split_ratios) if split_ratios else {})))
                    check(math.isfinite(ratio) and ratio <= 1.0,
                          f"{name}: {ratio} x the tolerance (max abs err {err})")
                    check(fault_ratio > 1.0, f"{name}: the planted fault passes the tolerance")
                    check(empty_zero, f"{name}: a query with no valid row is not 0")
                    worst[kname] = max(worst[kname], err)
                    del out, ref, ref_fault, fault_args
                del q, k, v
    torch.cuda.empty_cache()
    noise = _noise_checks(dev)
    purity = _purity_checks(dev)
    emit("verify_kernel", tol={str(k).split(".")[-1]: v for k, v in KERNEL_TOL.items()},
         limits=dict(W=pa.VERIFY_MAX_W, rows=pa.VERIFY_MAX_ROWS),
         cases=rows, max_abs_err=worst, noise=noise, purity=purity)
    return worst


def _requests(rng, vocab: int, stop_prompt: list[int], stop_id: int) -> list[ModelRequest]:
    """8 greedy (the first carries `stop_id`), 4 at temperature 1, 4 at
    temperature 1 with top_p 0.9."""
    reqs = []
    for i in range(N_REQUESTS):
        if i == 0:
            ids = stop_prompt
        else:
            ids = rng.integers(0, vocab, int(rng.integers(*PROMPT_LEN, endpoint=True))).tolist()
        g = GenerationHyperparameters(max_new_tokens=MAX_NEW)
        if i < 8:
            g = g.new(greedy=True, stop_token_ids=[stop_id] if i == 0 else [])
        elif i < 12:
            g = g.new(temperature=1.0)
        else:
            g = g.new(temperature=1.0, top_p=0.9)
        reqs.append(ModelRequest(rid=f"r{i}", input_ids=ids, gconfig=g))
    return reqs


def _check_wave(resps, reqs, stop_id: int, version: int) -> None:
    for req, resp in zip(reqs, resps):
        lp = np.asarray(resp.output_logprobs)
        check(np.isfinite(lp).all() and (lp <= 0).all(), f"{req.rid}: logprobs not finite and <= 0")
        check(resp.output_versions == [version] * resp.output_len, f"{req.rid}: versions != {version}")
        toks = resp.output_tokens
        if req.gconfig.stop_token_ids and stop_id in toks:
            first = toks.index(stop_id)
            check(resp.stop_reason == "stop" and resp.output_len == first + 1,
                  f"{req.rid}: did not end at its first stop id")
        else:
            check(resp.stop_reason == "length" and resp.output_len == MAX_NEW,
                  f"{req.rid}: {resp.stop_reason} after {resp.output_len} tokens")


async def _serve_wave(engine, reqs):
    return await asyncio.gather(*[engine.agenerate(r) for r in reqs])


def _serve_traffic(engine, cfg, rng) -> dict:
    """The serve cell's traffic: one greedy probe request (its 9th token
    becomes the stop id), then two waves of 16 concurrent requests with a
    host weight push between them (layer 0 takes layer 1's tensors, under
    the engine's own names) and the version bumped to 1. Checks stop
    reasons and version stamps; returns what the phase reports."""
    steps0, tokens0, secs0 = engine.decode_steps, engine.decode_tokens, engine.decode_seconds
    prefills0, prefill_s0 = engine.prefill_calls, engine.prefill_seconds
    stop_prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(*PROMPT_LEN, endpoint=True))).tolist()
    pre = engine.generate(ModelRequest(
        rid="pre", input_ids=stop_prompt,
        gconfig=GenerationHyperparameters(max_new_tokens=32, greedy=True),
    ))
    stop_id = pre.output_tokens[8]
    waves, pushed = [], []
    for version in (0, 1):
        if version == 1:
            # push layer 0 from the host (layer 1's weights), then bump
            donor = {k.split("/", 1)[1]: t.cpu() for k, t in engine.params.items() if k.startswith("layers_1/")}
            pushed = sorted(f"layers_0/{k}" for k in donor)
            engine.update_weights_from_tensor({f"layers_0/{k}": t for k, t in donor.items()})
            engine.set_version(1)
        reqs = _requests(rng, cfg.vocab_size, stop_prompt, stop_id)
        t = time.perf_counter()
        resps = asyncio.run(_serve_wave(engine, reqs))
        wall = time.perf_counter() - t
        _check_wave(resps, reqs, stop_id, version)
        waves.append(dict(
            version=version, wall_s=wall,
            tokens=sum(r.output_len for r in resps),
            ttft_ms=[r.ttft * 1e3 for r in resps],
            stop_request=dict(len=resps[0].output_len, reason=resps[0].stop_reason),
        ))
    steps = engine.decode_steps - steps0
    dec_tokens = engine.decode_tokens - tokens0
    dec_secs = engine.decode_seconds - secs0
    ttft = [x for w in waves for x in w["ttft_ms"]]
    return dict(
        stop_id=stop_id, pushed=pushed,
        waves=[{k: v for k, v in w.items() if k != "ttft_ms"} for w in waves],
        decode_steps=steps, prefill_calls=engine.prefill_calls - prefills0,
        decode_tok_s=dec_tokens / dec_secs,
        decode_step_ms=dec_secs / steps * 1e3,
        wave_tok_s=[w["tokens"] / w["wall_s"] for w in waves],
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        prefill_s=engine.prefill_seconds - prefill_s0,
    )


def _serve_engine(dev: torch.device, settings: dict):
    """Qwen2.5-7B at full width and depth (bf16, random weights from SEED)
    in a decode engine with `settings`."""
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False)  # layers_{i}/... tensors
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **settings), device=dev)
    engine.set_model(params, cfg)
    del params
    torch.cuda.empty_cache()
    engine.initialize()
    torch.cuda.empty_cache()
    weight_bytes = sum(t.numel() * t.element_size() for t in engine.params.values())
    pools = [t for t in (engine._k_pool, engine._v_pool, engine._k_scale, engine._v_scale)
             if t is not None]
    kv_bytes = sum(t.numel() * t.element_size() for t in pools)
    return engine, cfg, dict(init_s=init_s, weights_gb=weight_bytes / 1e9, kv_pool_gb=kv_bytes / 1e9,
                             kv_pool_shape=list(engine._k_pool.shape))


def phase_serve(dev: torch.device):
    engine, cfg, info = _serve_engine(dev, SERVE)
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED)

    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = 0
    traffic = _serve_traffic(engine, cfg, rng)
    launches = pa.launches
    # ---- end of the main path ----
    steps = traffic["decode_steps"]
    check(launches > 0 and launches == steps * cfg.num_hidden_layers,
          f"paged attention launches {launches} != decode steps {steps} x {cfg.num_hidden_layers}")
    emit(
        "serve",
        model="Qwen2.5-7B", source=QWEN25_7B_SOURCE,
        layers=cfg.num_hidden_layers, dtype="bfloat16", **info,
        launches=launches, **{k: v for k, v in traffic.items() if k != "pushed"},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        prefill_tokens=engine.prefill_tokens,
    )
    return engine, cfg, launches


def phase_serve_int8(dev: torch.device):
    """The serve cell again from an int8 engine (weight_dtype and kv_dtype
    "int8") on the same weights and traffic; the push between the waves
    ships `<path>/q` + `<path>/scale` tensors. Launch formulas over the
    phase: K5a = decode steps x L, K6 = 7 x L x (decode steps + prefill
    calls) (every dense matmul of every layer, prefill included), K3 = 0."""
    engine, cfg, info = _serve_engine(dev, SERVE_INT8)
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED)

    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = pa.launches_q8 = qm.launches = 0
    traffic = _serve_traffic(engine, cfg, rng)
    launches = dict(paged_attention=pa.launches, paged_attention_q8=pa.launches_q8,
                    quant_matmul=qm.launches)
    # ---- end of the main path ----
    steps, prefills = traffic["decode_steps"], traffic["prefill_calls"]
    check(launches["paged_attention_q8"] > 0 and launches["paged_attention_q8"] == steps * L,
          f"K5a launches {launches['paged_attention_q8']} != decode steps {steps} x {L}")
    check(launches["quant_matmul"] > 0 and launches["quant_matmul"] == 7 * L * (steps + prefills),
          f"K6 launches {launches['quant_matmul']} != 7 x {L} x ({steps} steps + {prefills} prefills)")
    check(launches["paged_attention"] == 0, f"K3 launched {launches['paged_attention']} times")
    quant = [n for n in traffic["pushed"] if n.endswith(("/q", "/scale"))]
    check(len(quant) == 14, f"the push carried {len(quant)} q/scale tensors, not 14")
    emit(
        "serve_int8",
        model="Qwen2.5-7B", source=QWEN25_7B_SOURCE, layers=L, dtype="bfloat16",
        weight_dtype="int8", kv_dtype="int8", **info,
        reckoned_weights_gb=RECKONED_INT8_WEIGHTS_GB,
        reckoned_kv_pool_gb=RECKONED_INT8_KV_POOL_GB,
        launches=launches, pushed_q_scale=len(quant),
        **{k: v for k, v in traffic.items() if k != "pushed"},
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        prefill_tokens=engine.prefill_tokens,
    )
    return engine, cfg, launches


def _served_batch(engine, cfg, rng, width: int = 1):
    """16 slots over the served pool: lengths from 64 + 128 to 1024 + 128,
    blocks from the engine's allocator (they hold the waves' KV) through
    the `width` rows a step writes."""
    R = SERVE["max_running_requests"]
    alloc = engine._alloc
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, R) + 128
    for r in range(R):
        check(alloc.ensure(r, int(lengths[r]) + width), "pool cannot back the step")
    nb = int(alloc.nblocks.max())
    dev = engine.device
    table = torch.from_numpy(alloc.table_slice(nb)).to(dev)
    positions = torch.as_tensor(lengths, device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, R), device=dev)
    return table, positions, tokens, lengths


def _attn_f32(q, k_pool, v_pool, table, valid):
    """The plain version with its attention in f32 (what the kernels
    compute), rounded back to q's dtype; an int8 pool is dequantized to
    f32 right after the gather."""
    def f32(pool):
        return pool if isinstance(pool, tuple) else pool.float()

    return pa.paged_attention_ref(q.float(), f32(k_pool), f32(v_pool), table, valid).to(q.dtype)


def phase_step(engine, cfg) -> dict:
    """One decode step at full width on the served pool: the kernel path
    against the plain path (bf16 attention, the JAX XLA arithmetic) and
    against the plain path with its attention in f32. The check: the
    kernel path's logits are no further from the f32-attention logits
    than the plain bf16 path's are, or than 4 bf16 ulps of the largest
    logit (the logits come out of a bf16 matmul), whichever is larger."""
    rng = np.random.default_rng(SEED + 1)
    engine.pause_generation()
    table, positions, tokens, lengths = _served_batch(engine, cfg, rng)
    active = torch.ones(len(lengths), dtype=torch.bool, device=engine.device)
    logits = {}
    with torch.no_grad():
        for name, fn in (("kernel", pa.paged_attention),
                         ("plain", pa.paged_attention_ref),
                         ("plain_f32_attn", _attn_f32)):
            logits[name] = decode_step_paged(
                engine.params, tokens, positions, engine._k_pool,
                engine._v_pool, table, cfg, active=active, attn_fn=fn,
                layers=engine._layers,
            )
    torch.cuda.synchronize()
    a, b, c = logits["kernel"], logits["plain"], logits["plain_f32_attn"]
    scale = c.abs().max().item()
    kernel_vs_f32 = (a - c).abs().max().item()
    plain_vs_f32 = (b - c).abs().max().item()
    kernel_vs_plain = (a - b).abs().max().item()
    tol = max(plain_vs_f32, 4 * 2.0 ** (math.floor(math.log2(scale)) - 7))
    check(torch.isfinite(a).all().item(), "kernel-path logits not finite")
    check(kernel_vs_f32 <= tol,
          f"decode step: kernel path {kernel_vs_f32} from the f32-attention "
          f"logits > {tol} (plain bf16 path: {plain_vs_f32})")
    emit("step", max_abs_logit=scale, tol=tol,
         kernel_vs_f32_attn=kernel_vs_f32, plain_vs_f32_attn=plain_vs_f32,
         kernel_vs_plain=kernel_vs_plain, rel_kernel_vs_plain=kernel_vs_plain / scale,
         argmax_agree_kernel_plain=(a.argmax(-1) == b.argmax(-1)).float().mean().item(),
         argmax_agree_kernel_f32=(a.argmax(-1) == c.argmax(-1)).float().mean().item())
    return dict(table=table, lengths=lengths)


def phase_quant_step(engine, cfg) -> dict:
    """One decode step at full width on the int8 engine's served pool and
    weights. The check: the kernel path (K5a and K6) against the plain
    path (both swapped for their plain versions), held as phase `step`
    holds K3: the kernel path's logits are no further from the plain path
    with f32 attention than the plain bf16 path is, or than 4 bf16 ulps of
    the largest logit, whichever is larger. The measurement: the kernel
    path against the fp engine's step (K3, bf16 matmuls) on the fp weights
    the int8 ones were quantized from (the same push applied) and the same
    KV rows dequantized to bf16: max |logit difference| and argmax
    agreement, the cost of int8 weights and of quantizing the new row."""
    rng = np.random.default_rng(SEED + 1)
    engine.pause_generation()
    table, positions, tokens, lengths = _served_batch(engine, cfg, rng)
    dev = engine.device
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)
    k_pool, v_pool = engine.kv_pools()
    logits = {}
    with torch.no_grad():
        for name, attn, mm in (("kernel", pa.paged_attention, qm.quant_einsum),
                               ("plain", pa.paged_attention_ref, qm.quant_einsum_ref),
                               ("plain_f32_attn", _attn_f32, qm.quant_einsum_ref)):
            logits[name] = decode_step_paged(
                engine.params, tokens, positions, k_pool, v_pool, table, cfg,
                active=active, attn_fn=attn, layers=engine._layers, matmul_fn=mm,
            )
    torch.cuda.synchronize()
    a, b, c = logits["kernel"], logits["plain"], logits["plain_f32_attn"]
    scale = c.abs().max().item()
    kernel_vs_f32 = (a - c).abs().max().item()
    plain_vs_f32 = (b - c).abs().max().item()
    kernel_vs_plain = (a - b).abs().max().item()
    tol = max(plain_vs_f32, 4 * 2.0 ** (math.floor(math.log2(scale)) - 7))
    check(torch.isfinite(a).all().item(), "int8 kernel-path logits not finite")
    check(kernel_vs_f32 <= tol,
          f"int8 decode step: kernel path {kernel_vs_f32} from the f32-attention "
          f"plain logits > {tol} (plain bf16 path: {plain_vs_f32})")
    # the fp engine's step: fp weights (regenerated from the seed, with the
    # serve traffic's push) over the same KV rows in bf16
    fp = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    for k in [k for k in fp if k.startswith("layers_0/")]:
        fp[k] = fp["layers_1/" + k.split("/", 1)[1]]
    fp_pools = []
    for data, sc in (k_pool, v_pool):
        out = torch.empty(data.shape, dtype=torch.bfloat16, device=dev)
        for i in range(data.shape[0]):
            out[i] = dequantize_kv(data[i], sc[i].transpose(1, 2), torch.bfloat16)
        fp_pools.append(out)
    with torch.no_grad():
        fp_logits = decode_step_paged(fp, tokens, positions, *fp_pools, table, cfg,
                                      active=active)
    torch.cuda.synchronize()
    d = (a - fp_logits).abs()
    emit("quant_step", max_abs_logit=scale, tol=tol,
         kernel_vs_f32_attn=kernel_vs_f32, plain_vs_f32_attn=plain_vs_f32,
         kernel_vs_plain=kernel_vs_plain, rel_kernel_vs_plain=kernel_vs_plain / scale,
         argmax_agree_kernel_plain=(a.argmax(-1) == b.argmax(-1)).float().mean().item(),
         vs_fp_engine=dict(max_abs_logit_diff=d.max().item(), mean_abs_logit_diff=d.mean().item(),
                           rel_max=d.max().item() / fp_logits.abs().max().item(),
                           argmax_agree=(a.argmax(-1) == fp_logits.argmax(-1)).float().mean().item()))
    del fp, fp_pools, fp_logits, logits
    torch.cuda.empty_cache()
    return dict(table=table, lengths=lengths)


def phase_profile(engine, cfg, batch: dict, steps: int = 4, phase: str = "profile",
                  width: int = 0) -> None:
    """Where a decode step's time goes: `torch.profiler` over `steps` decode
    steps on the step phase's batch (or, with `width`, verify forwards of
    that many positions per slot), device time summed by kernel family,
    and the device busy share of the wall time. A measurement, not a
    check."""
    from torch.profiler import ProfilerActivity, profile

    table, lengths = batch["table"], batch["lengths"]
    dev = engine.device
    positions = torch.as_tensor(lengths, device=dev)
    tokens = torch.zeros((len(lengths), width) if width else len(lengths), dtype=torch.long,
                         device=dev)
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)
    k_pool, v_pool = engine.kv_pools()
    fn = verify_step_paged if width else decode_step_paged

    def step():
        return fn(engine.params, tokens, positions, k_pool, v_pool, table, cfg,
                  active=active, layers=engine._layers)

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3  # unprofiled
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    families, n_kernels, _ = _device_ms_by_family(prof)
    busy = sum(families.values())
    host = sorted(((ev.self_cpu_time_total / 1e3 / steps, ev.count // steps, ev.key)
                   for ev in prof.key_averages() if ev.self_cpu_time_total > 0), reverse=True)
    emit(phase, steps=steps, verify_width=width, wall_ms_per_step=wall_ms / steps,
         # host ms per step (profiled, so inflated) and calls per step of the
         # costliest ops: where the host's launch time goes
         host_top_ops=[dict(ms=m, calls=c, op=k[:60]) for m, c, k in host[:10]],
         profiled_wall_ms_per_step=profiled_ms / steps,
         device_ms_per_step={k: v / steps for k, v in families.items()},
         kernels_per_step=n_kernels / steps,
         # device time (profiled) over the unprofiled wall of the same steps
         device_busy_share=(busy / wall_ms) if busy else "not measured")


def _time(fn, iters: int) -> float:
    """ms per call, CUDA events around `iters` calls after a warm-up. Where
    the host takes longer to launch a call than the device to run it, this
    is the host's time."""
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


H100_MAX_CLOCK_HZ = 1.98e9  # SM boost clock: a sleep of n cycles lasts >= n / this


def _time_device(fn, iters: int) -> float:
    """Device ms per call (see `_time_device_and_host`)."""
    return _time_device_and_host(fn, iters)[0]


def _time_device_and_host(fn, iters: int) -> tuple[float, float]:
    """Device ms per call: as `_time`, but the timed calls are queued behind
    a sleep kernel four times as long as the host takes to launch them (by
    one call's launch time), so the device finds them all queued and the
    events time the device alone. Raises if the host still fell behind.
    Also the host's ms per call while it queued them."""
    for _ in range(3):
        fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(1)
    launch_s = (time.perf_counter() - t0) * iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    sleep_s = 4 * launch_s + 0.02
    torch.cuda._sleep(int(sleep_s * H100_MAX_CLOCK_HZ))
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(queued_s < sleep_s, f"device timing: launching took {queued_s} s, the sleep {sleep_s} s")
    return start.elapsed_time(end) / iters, queued_s * 1e3 / iters


def _paged_times(kp: list, vp: list, table, lengths, nH: int, full: bool = True) -> dict:
    """K3 timings (K5a on int8 pools) of bf16 queries over `table` with
    slot r valid through row lengths[r], rotating over the layers' pools
    in `kp`/`vp` so the KV rows come from HBM rather than a warm L2, as in
    a real decode step: as issued, on the device alone, and the wrapper's
    host ms per call. With `full`, also the plain version, the split sweep
    (`DECODE_SPLITS`, through `pa._launch`), route A (K4's body at
    W = 1: `pa._launch` of q viewed as [R, 1, nH, hd], at each swept
    split),
    and the library yardstick: SDPA over KV gathered (and dequantized to
    bf16) into [R, nH, span, hd] ahead of time (kv heads repeated for the
    query heads; the gather is not timed)."""
    quant = isinstance(kp[0], tuple)
    data = kp[0][0] if quant else kp[0]
    dev = data.device
    R, nb = table.shape
    bsz, nKV, hd = data.shape[1:]
    layers = len(kp)
    span = nb * bsz
    valid = (torch.arange(span, device=dev)[None, :] <= torch.as_tensor(lengths, device=dev)[:, None]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn((R, nH, hd), generator=gen, device=dev).to(torch.bfloat16)

    def counter():
        return pa.launches_q8 if quant else pa.launches

    def kernel(i):
        return pa.paged_attention(q, kp[i % layers], vp[i % layers], table, valid)

    calls = counter()
    ms = _time(kernel, 200)
    ms_device, host_ms = _time_device_and_host(kernel, 200)
    check(counter() > calls, "timing did not launch the kernel")
    out = dict(ms=ms, ms_device=ms_device, host_ms=host_ms, host_minus_device_ms=ms - ms_device)
    if not full:
        return out
    out["plain_ms"] = _time(lambda i: pa.paged_attention_ref(q, kp[i % layers], vp[i % layers],
                                                             table, valid), 20)
    sm_scale = 1.0 / math.sqrt(hd)
    out["pages_per_split"] = pa.decode_pages_per_split(nb, bsz, R, nKV, pa._n_sms(dev))
    sweep, route_a = {}, {}
    q1, valid1 = q[:, None], valid[:, None]
    for pps in DECODE_SPLITS:
        def run(i, pps=pps or nb):
            return pa._launch(q, kp[i % layers], vp[i % layers], table, valid, sm_scale, pps)

        def run_a(i, pps=pps or nb):
            return pa._launch(q1, kp[i % layers], vp[i % layers], table, valid1, sm_scale, pps)
        sweep[pps or "all"] = dict(pages=pps or nb, ms=_time(run, 200), ms_device=_time_device(run, 200))
        route_a[pps or "all"] = dict(pages=pps or nb, ms_device=_time_device(run_a, 200))
    out.update(split_sweep=sweep, route_a_k4_at_w1=route_a)
    idx = table.reshape(-1).long()

    def gathered(pool):
        d, sc = pool if quant else (pool, None)
        g = pa._gather_dequant(d, sc, idx, R, nb, bsz, nKV, hd, torch.bfloat16)
        return g.permute(0, 2, 1, 3).repeat_interleave(nH // nKV, dim=1).contiguous()

    ks = [gathered(p) for p in kp]
    vs = [gathered(p) for p in vp]
    q4 = q[:, :, None, :]
    mask = valid[:, None, None, :]
    out["library_ms"] = _time(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, ks[i % layers], vs[i % layers], attn_mask=mask), 200)
    return out


def phase_paged_line(engine, cfg, batch: dict, launches: int, max_err: float) -> dict:
    """K3 timings (K5a on an int8 engine's pool) at the serve phase's
    shapes: the 16 slots of the step phase over the served pool, rotating
    over 4 layers' pools (`_paged_times`)."""
    quant = engine._k_scale is not None
    table, lengths = batch["table"], batch["lengths"]
    R, nb = table.shape
    bsz, nKV, hd = engine._k_pool.shape[2:]
    nH = cfg.num_attention_heads
    layers = min(4, cfg.num_hidden_layers)
    if quant:
        kp = [(engine._k_pool[i], engine._k_scale[i]) for i in range(layers)]
        vp = [(engine._v_pool[i], engine._v_scale[i]) for i in range(layers)]
    else:
        kp = [engine._k_pool[i] for i in range(layers)]
        vp = [engine._v_pool[i] for i in range(layers)]
    times = _paged_times(kp, vp, table, lengths, nH)
    rows = int((np.asarray(lengths) + 1).sum())
    span = nb * bsz
    # per valid row and kv head: K and V, bf16 (K3) or int8 + an f32 scale (K5a)
    row_bytes = 2 * (hd + 4) if quant else 2 * hd * 2
    nbytes = (rows * nKV * row_bytes + 2 * R * nH * hd * 2 + R * nb * 4 + R * span)
    flops = 4 * nH * hd * rows
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops(torch.bfloat16) * 1e3
    return dict(
        name="paged_attention_q8" if quant else "paged_attention", route="cuda",
        source=KERNEL_SOURCE, replaces=Q8_REPLACES if quant else KERNEL_REPLACES,
        launches=launches, max_abs_err=max_err, max_err=max_err, **times,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes_ms=bytes_ms, ops_ms=ops_ms,
        library_call="scaled_dot_product_attention, KV pre-gathered"
                     + (" and pre-dequantized to bf16" if quant else ""),
        shape=dict(R=R, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb, valid_rows=rows,
                   dtype="bfloat16", pool="int8 + f32 scales" if quant else "bfloat16"),
    )


# `--decode-sweep`: table widths (pages) and the shapes they are swept at
SWEEP_WIDTHS = (2, 4, 8, 16, 32)
SWEEP_SHAPES = (
    dict(name="serve", R=16, nH=28, nKV=4, quant=(False, True)),  # Qwen2.5-7B's serve batch
    dict(name="rollout", R=32, nH=12, nKV=2, quant=(False,)),  # the train phase's rollout batch
)


def decode_sweep_only() -> int:
    """`--decode-sweep`: device ms of bf16 K3 (and K5a at the serve shape)
    for tables of `SWEEP_WIDTHS` pages of 128 rows at hd 128, at every
    power-of-two pages per split up to the table, beside the split
    `decode_pages_per_split` picks. Slot lengths are uniform over the
    table, the last slot filling it (the chunk's longest slot sets the
    width); 4 layers of random pools from SEED, rotated."""
    dev, smi = phase_device()
    hd, bsz = 128, SERVE["page_size"]
    rows = []
    for shape in SWEEP_SHAPES:
        R, nH, nKV = shape["R"], shape["nH"], shape["nKV"]
        n_blocks = R * max(SWEEP_WIDTHS) + 1
        gen = torch.Generator(device=dev).manual_seed(SEED)
        pools = [torch.randn((n_blocks, bsz, nKV, hd), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(8)]
        for quant in shape["quant"]:
            kv = [_int8_pool(p) for p in pools] if quant else pools
            rng = np.random.default_rng(SEED + 3)
            for nb in SWEEP_WIDTHS:
                lengths = rng.integers(1, nb * bsz, R)
                lengths[-1] = nb * bsz - 1
                table = torch.as_tensor(rng.permutation(np.arange(1, n_blocks))[: R * nb]
                                        .reshape(R, nb).astype(np.int32), device=dev)
                valid = (torch.arange(nb * bsz, device=dev)[None, :]
                         <= torch.as_tensor(lengths, device=dev)[:, None]).contiguous()
                q = torch.randn((R, nH, hd), generator=gen, device=dev).to(torch.bfloat16)
                ms = {}
                pps = 1
                while pps <= nb:
                    ms[pps] = _time_device(lambda i, pps=pps: pa._launch(
                        q, kv[i % 4], kv[4 + i % 4], table, valid, 1.0 / math.sqrt(hd), pps), 200)
                    pps *= 2
                rows.append(dict(shape=shape["name"], pool="int8" if quant else "bf16", R=R, nH=nH,
                                 nKV=nKV, nb=nb, valid_rows=int((lengths + 1).sum()),
                                 ms_device=ms, fastest=min(ms, key=ms.get),
                                 rule=pa.decode_pages_per_split(nb, bsz, R, nKV, pa._n_sms(dev))))
            del kv
        del pools
        torch.cuda.empty_cache()
    emit("decode_sweep", min_blocks_per_sm=pa.DECODE_MIN_BLOCKS_PER_SM, rows=rows)
    print(smi, flush=True)
    return 0


def paged_times_only() -> int:
    """`--paged-times`: K3 and K5a as issued, on the device alone and the
    wrapper's host ms per call, at the serve batch's shapes on a synthetic
    pool (Qwen2.5-7B's 28/4 heads, hd 128, page 128; 16 slots of 192-1152
    rows, `_served_batch`'s lengths; 4 layers of a 513-block pool, random
    bf16 values from SEED, the int8 pool quantized from them). It calls
    only `paged_attention`, so the same script times another tree's
    package when it is run from that tree's root."""
    dev, smi = phase_device()
    cfg = QWEN25_7B
    nH, nKV = cfg.num_attention_heads, cfg.num_key_value_heads
    hd, bsz = cfg.hidden_size // nH, SERVE["page_size"]
    R = SERVE["max_running_requests"]
    n_blocks = R * SERVE["context_length"] // bsz + 1
    rng = np.random.default_rng(SEED + 1)
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, R) + 128
    nb = int(-(-(lengths.max() + 1) // bsz))
    table = np.zeros((R, nb), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    for r in range(R):
        used = -(-(int(lengths[r]) + 1) // bsz)
        table[r, :used] = perm[r * nb: r * nb + used]
    table = torch.as_tensor(table, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pools = [torch.randn((n_blocks, bsz, nKV, hd), generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(8)]
    res = dict(fp=_paged_times(pools[:4], pools[4:], table, lengths, nH, full=False))
    q8 = [_int8_pool(p) for p in pools]
    del pools
    res["int8"] = _paged_times(q8[:4], q8[4:], table, lengths, nH, full=False)
    emit("paged_times", shape=dict(R=R, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb,
                                   valid_rows=int((lengths + 1).sum())), **res)
    print(smi, flush=True)
    return 0


# the spec serve phases: the serve cells' engines with spec_decode="ngram"
SPEC_MAX_NEW = 128
SPEC_SEGMENT = (16, 64)  # each prompt repeats one random segment of this length


def _spec_requests(rng, vocab: int) -> list[ModelRequest]:
    """16 requests whose prompts quote themselves, as math and code
    rollouts quote theirs: a random 16-64-token segment repeated to 64-1024
    tokens. 8 greedy, 4 at temperature 1, 4 with top_p 0.9; 128 new
    tokens each."""
    reqs = []
    for i in range(N_REQUESTS):
        seg = rng.integers(0, vocab, int(rng.integers(*SPEC_SEGMENT, endpoint=True))).tolist()
        n = int(rng.integers(*PROMPT_LEN, endpoint=True))
        ids = (seg * (n // len(seg) + 1))[:n]
        g = GenerationHyperparameters(max_new_tokens=SPEC_MAX_NEW)
        if i < 8:
            g = g.new(greedy=True)
        elif i < 12:
            g = g.new(temperature=1.0)
        else:
            g = g.new(temperature=1.0, top_p=0.9)
        reqs.append(ModelRequest(rid=f"s{i}", input_ids=ids, gconfig=g))
    return reqs


def _pushed_params(dev: torch.device, cfg):
    """The serve cells' weights after their push: the seeded random weights
    with layer 0 holding layer 1's tensors."""
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    for k in [k for k in params if k.startswith("layers_0/")]:
        params[k] = params["layers_1/" + k.split("/", 1)[1]]
    return params


def phase_serve_spec(dev: torch.device, settings: dict, phase: str):
    """The spec serve cell: Qwen2.5-7B at full width and depth (bf16, the
    serve cells' weights) in an engine with `settings` and
    spec_decode="ngram", spec_k 4, serving one wave of `_spec_requests`;
    the same wave on a spec-off engine with the same weights and seed
    first (each engine's admission order, and so its keys, is the wave's
    order). Launch formulas over the spec-on wave: on an fp engine K4 =
    verify forwards x L, K3 = decode steps x L, K5a = K5b = K6 = 0; on an
    int8 one K5b = verify forwards x L, K5a = steps x L, K6 = 7 L x (steps
    + verify forwards + prefill calls), K3 = K4 = 0. The noise kernel
    launches once or twice (top-p batches) per step or forward. The
    accounting: drafted = accepted + rejected; the tokens delivered are
    the verify forwards' accepted + 1 per slot plus the normal chunks'
    tokens, less those cut at a stop. Reported, not checked: each
    request's prefix that agrees with its spec-off stream."""
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False)
    L = cfg.num_hidden_layers
    quant = settings.get("kv_dtype") == "int8"
    params = _pushed_params(dev, cfg)
    engines = {}
    for spec in ("off", "ngram"):
        eng = TorchDecodeEngine(TorchDecodeConfig(
            random_seed=SEED, spec_decode=spec, spec_k=SPEC_K, **settings), device=dev)
        eng.set_model(params, cfg)
        engines[spec] = eng.initialize()
    del params
    torch.cuda.empty_cache()
    off, on = engines["off"], engines["ngram"]
    rng = np.random.default_rng(SEED + 7)
    reqs = _spec_requests(rng, cfg.vocab_size)
    try:
        want = asyncio.run(_serve_wave(off, reqs))
        off_stats = dict(decode_steps=off.decode_steps, decode_tok_s=off.decode_tokens / off.decode_seconds,
                         decode_step_ms=off.decode_seconds / off.decode_steps * 1e3,
                         ttft_p50_ms=float(np.percentile([r.ttft * 1e3 for r in want], 50)))
    finally:
        off.destroy()
    del off, engines
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    c0 = dict(steps=on.decode_steps, verify=on.verify_dispatches, secs=on.decode_seconds,
              vsecs=on.verify_seconds, tokens=on.decode_tokens, prefills=on.prefill_calls)

    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = pa.launches_q8 = pa.launches_verify = pa.launches_verify_q8 = 0
    qm.launches = tf.launches = 0
    t = time.perf_counter()
    got = asyncio.run(_serve_wave(on, reqs))
    wall = time.perf_counter() - t
    launches = dict(paged_attention=pa.launches, paged_attention_q8=pa.launches_q8,
                    paged_verify=pa.launches_verify, paged_verify_q8=pa.launches_verify_q8,
                    quant_matmul=qm.launches, threefry_noise=tf.launches)
    # ---- end of the main path ----
    steps = on.decode_steps - c0["steps"]
    vd = on.verify_dispatches - c0["verify"]
    prefills = on.prefill_calls - c0["prefills"]
    delivered = sum(r.output_len for r in got)
    for req, resp in zip(reqs, got):
        lp = np.asarray(resp.output_logprobs)
        check(np.isfinite(lp).all() and (lp <= 0).all(), f"{req.rid}: logprobs not finite and <= 0")
        check(resp.stop_reason == "length" and resp.output_len == SPEC_MAX_NEW
              and resp.output_versions == [0] * SPEC_MAX_NEW,
              f"{req.rid}: {resp.stop_reason} after {resp.output_len} tokens")
    check(vd > 0, "the spec wave ran no verify forward")
    want_launch = dict(paged_attention=0 if quant else steps * L,
                       paged_attention_q8=steps * L if quant else 0,
                       paged_verify=0 if quant else vd * L,
                       paged_verify_q8=vd * L if quant else 0,
                       quant_matmul=7 * L * (steps + vd + prefills) if quant else 0)
    for name, n in want_launch.items():
        check(launches[name] == n, f"{phase}: {name} launched {launches[name]} times, want {n}")
    check(steps + vd <= launches["threefry_noise"] <= 2 * (steps + vd),
          f"{phase}: noise kernel launched {launches['threefry_noise']} times for "
          f"{steps} steps and {vd} verify forwards")
    check(on.spec_drafted == on.spec_accepted + on.spec_rejected, "drafted != accepted + rejected")
    check(on.decode_tokens - c0["tokens"] == delivered, "decode_tokens != tokens delivered")
    check(on.spec_chunk_slots + on.spec_accepted + on.chunk_tokens - on.tokens_cut == delivered,
          "delivered != verify (accepted + 1) + normal-chunk tokens - cut tokens")
    agree = []
    for a, b in zip(want, got):
        n = next((i for i, (x, y) in enumerate(zip(a.output_tokens, b.output_tokens)) if x != y),
                 min(a.output_len, b.output_len))
        agree.append(n)
    secs = on.decode_seconds - c0["secs"]
    vsecs = on.verify_seconds - c0["vsecs"]
    ttft = [r.ttft * 1e3 for r in got]
    emit(
        phase, model="Qwen2.5-7B", source=QWEN25_7B_SOURCE, layers=L, dtype="bfloat16",
        weight_dtype=settings.get("weight_dtype", "fp"), kv_dtype=settings.get("kv_dtype", "fp"),
        spec_k=SPEC_K, spec_ngram_max=on.config.spec_ngram_max, launches=launches,
        verify_dispatches=vd, decode_steps=steps, prefill_calls=prefills,
        spec_hist=on.spec_hist.tolist(), spec_drafted=on.spec_drafted,
        spec_accepted=on.spec_accepted, spec_rejected=on.spec_rejected,
        spec_chunk_slots=on.spec_chunk_slots, tokens_cut=on.tokens_cut,
        tokens_per_verify_forward=(on.spec_chunk_slots + on.spec_accepted) / vd,
        accepted_per_slot_forward=on.spec_accepted / on.spec_chunk_slots,
        tokens=delivered, wall_s=wall, wave_tok_s=delivered / wall,
        decode_tok_s=delivered / secs, verify_ms_per_forward=vsecs / vd * 1e3,
        decode_step_ms=(secs - vsecs) / steps * 1e3 if steps else None,
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        spec_off=off_stats,
        agree_prefix_with_spec_off=agree,
        agree_full=sum(n == SPEC_MAX_NEW for n in agree),
        agree_full_greedy=sum(n == SPEC_MAX_NEW for n in agree[:8]),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
    )
    return on, cfg, launches


def phase_spec_step(engine, cfg, width: int = SPEC_K + 1) -> dict:
    """One verify forward at W 5 on the spec engine's pool against W
    decode steps fed the same tokens on a copy of the same pool state.
    Checks: (1) the kernel path (K4) against the plain path with f32
    attention, held as phase `step` holds K3: no further from it than the
    plain bf16 path is, or than 4 bf16 ulps of the largest logit; (2) the
    layer-0 K/V rows both write bit-equal, on the kernel and the plain
    path: they come from the embeddings and the q/k/v matmuls alone, so a
    row written at the wrong place or rotated at the wrong position shows
    there; (3) the verify logits against the sequential kernel-path logits,
    and the rows of all layers, each within the larger of 4 bf16 ulps and
    twice the same distance on the plain path (the two forwards multiply
    at M = R W and M = R rows, where cuBLAS may tile and round
    differently, and bf16 activations carry that through the layers);
    (4) no other pool row differs; (5) a planted fault that only deeper
    layers see, each query's causal horizon one row too far (query j also
    reads column j + 1's row), reads above both tolerances of (3).
    Reported: argmax agreement per position, and the planted fault's
    readings."""
    rng = np.random.default_rng(SEED + 8)
    engine.pause_generation()
    table, positions, _, lengths = _served_batch(engine, cfg, rng, width=width)
    dev = engine.device
    R = len(lengths)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (R, width)), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    kp, vp = engine._k_pool, engine._v_pool
    ks, vs = kp.clone(), vp.clone()

    def verify(attn, pools):
        return verify_step_paged(engine.params, tokens, positions, *pools, table, cfg,
                                 active=active, attn_fn=attn, layers=engine._layers)

    def sequential(attn, pools):
        return torch.stack([decode_step_paged(
            engine.params, tokens[:, j], positions + j, *pools, table, cfg, active=active,
            attn_fn=attn, layers=engine._layers) for j in range(width)], dim=1)

    def _attn_qlen_f32(q, k_pool, v_pool, table, valid):
        """As `_attn_f32`, for the verify attention."""
        def f32(pool):
            return pool if isinstance(pool, tuple) else pool.float()

        return pa.paged_attention_qlen_ref(q.float(), f32(k_pool), f32(v_pool), table,
                                           valid).to(q.dtype)

    # the rows both paths wrote; every other row must stay as it was
    pos = positions[:, None] + torch.arange(width, device=dev)
    written = torch.zeros(kp.shape[1:3], dtype=torch.bool, device=dev)
    written[table.long().gather(1, pos // kp.shape[2]), pos % kp.shape[2]] = True

    def rows_apart() -> dict:
        """Max |difference| of the written rows (all layers; layer 0), their
        largest value, the least per-layer share of equal values, and
        whether all other rows are equal."""
        out = dict(max_diff=0.0, layer0_max_diff=0.0, scale=0.0, share_equal_min=1.0,
                   others_equal=True)
        for x, y in ((kp, ks), (vp, vs)):
            for i in range(x.shape[0]):
                xw, yw = x[i][written].float(), y[i][written].float()
                d = (xw - yw).abs().max().item()
                out["max_diff"] = max(out["max_diff"], d)
                if i == 0:
                    out["layer0_max_diff"] = max(out["layer0_max_diff"], d)
                out["scale"] = max(out["scale"], yw.abs().max().item())
                out["share_equal_min"] = min(out["share_equal_min"], (xw == yw).float().mean().item())
                out["others_equal"] &= torch.equal(x[i][~written], y[i][~written])
        return out

    def off_by_one(q, k_pool, v_pool, table, valid):
        """The planted fault: query j attends with query j + 1's horizon
        (the last keeps its own)."""
        return pa.paged_attention_qlen(q, k_pool, v_pool, table,
                                       torch.cat([valid[:, 1:], valid[:, -1:]], dim=1))

    with torch.no_grad():
        a = verify(pa.paged_attention_qlen, (kp, vp))
        s_kernel = sequential(pa.paged_attention, (ks, vs))
        torch.cuda.synchronize()
        rows = rows_apart()
        fault = verify(off_by_one, (kp, vp))
        torch.cuda.synchronize()
        rows_fault = rows_apart()
        b = verify(pa.paged_attention_qlen_ref, (kp, vp))
        s_plain = sequential(pa.paged_attention_ref, (ks, vs))
        torch.cuda.synchronize()
        rows_plain = rows_apart()
        c = verify(_attn_qlen_f32, (kp, vp))
    torch.cuda.synchronize()
    del ks, vs
    torch.cuda.empty_cache()

    def ulps4(x: float) -> float:
        return 4 * 2.0 ** (math.floor(math.log2(x)) - 7)

    scale = c.abs().max().item()
    kernel_vs_f32 = (a - c).abs().max().item()
    plain_vs_f32 = (b - c).abs().max().item()
    tol = max(plain_vs_f32, ulps4(scale))
    verify_vs_seq = (a - s_kernel).abs().max().item()
    plain_verify_vs_seq = (b - s_plain).abs().max().item()
    tol_seq = max(ulps4(scale), 2 * plain_verify_vs_seq)
    tol_rows = max(ulps4(rows["scale"]), 2 * rows_plain["max_diff"])
    check(torch.isfinite(a).all().item(), "verify kernel-path logits not finite")
    check(kernel_vs_f32 <= tol, f"verify step: kernel path {kernel_vs_f32} from the f32-attention "
          f"logits > {tol} (plain bf16 path: {plain_vs_f32})")
    check(verify_vs_seq <= tol_seq, f"verify step: {verify_vs_seq} from {width} decode steps "
          f"> {tol_seq} (plain path: {plain_verify_vs_seq})")
    check(rows["layer0_max_diff"] == 0 and rows_plain["layer0_max_diff"] == 0,
          f"verify step: layer-0 K/V rows differ from the decode steps' (kernel path "
          f"{rows['layer0_max_diff']}, plain path {rows_plain['layer0_max_diff']})")
    check(rows["max_diff"] <= tol_rows, f"verify step: written K/V rows {rows['max_diff']} from "
          f"the decode steps' > {tol_rows} (plain path: {rows_plain['max_diff']})")
    check(rows["others_equal"] and rows_plain["others_equal"],
          "verify step: a pool row outside the W written rows differs")
    fault_vs_seq = (fault - s_kernel).abs().max().item()
    check(fault_vs_seq > tol_seq and rows_fault["max_diff"] > tol_rows,
          f"verify step: the planted off-by-one horizon reads {fault_vs_seq} on the logits "
          f"(tolerance {tol_seq}) and {rows_fault['max_diff']} on the rows (tolerance {tol_rows})")
    emit("spec_step", width=width, max_abs_logit=scale, tol=tol, kernel_vs_f32_attn=kernel_vs_f32,
         plain_vs_f32_attn=plain_vs_f32, tol_vs_sequential=tol_seq,
         verify_vs_sequential=verify_vs_seq, plain_verify_vs_sequential=plain_verify_vs_seq,
         rows_tol=tol_rows, rows=rows, rows_plain=rows_plain,
         fault_vs_sequential=fault_vs_seq, rows_fault=rows_fault,
         argmax_agree_verify_sequential=(a.argmax(-1) == s_kernel.argmax(-1)).float().mean(0).tolist(),
         argmax_agree_kernel_plain=(a.argmax(-1) == b.argmax(-1)).float().mean().item())
    return dict(table=table, lengths=lengths)


def phase_verify_line(engine, cfg, batch: dict, launches: int, max_err: float,
                      width: int = SPEC_K + 1) -> dict:
    """K4 timings (K5b on an int8 engine's pool) at the spec batch: the 16
    slots of `phase_spec_step`'s batch (or the int8 engine's own) with W 5
    queries each over the served pool, rotating over 4 layers' pools so
    the rows come from HBM; as issued and on the device alone, at the
    default split and at each of `VERIFY_SPLITS`. Yardsticks (timed here
    only; the port never calls them): SDPA over KV pre-gathered (and
    pre-dequantized) with the [W, span] masks, and K3 (K5a) launched over
    R x W virtual slots, the alternative the TPU kernel was designed to
    beat."""
    dev = engine.device
    quant = engine._k_scale is not None
    table, lengths = batch["table"], batch["lengths"]
    R, nb = table.shape
    bsz, nKV, hd = engine._k_pool.shape[2:]
    nH = cfg.num_attention_heads
    layers = min(4, cfg.num_hidden_layers)
    span = nb * bsz
    horizon = torch.as_tensor(lengths, device=dev)[:, None] + torch.arange(width, device=dev)
    valid = (torch.arange(span, device=dev)[None, None, :] <= horizon[:, :, None]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    q = torch.randn((R, width, nH, hd), generator=gen, device=dev).to(torch.bfloat16)
    if quant:
        kp = [(engine._k_pool[i], engine._k_scale[i]) for i in range(layers)]
        vp = [(engine._v_pool[i], engine._v_scale[i]) for i in range(layers)]
    else:
        kp = [engine._k_pool[i] for i in range(layers)]
        vp = [engine._v_pool[i] for i in range(layers)]

    def counter():
        return pa.launches_verify_q8 if quant else pa.launches_verify

    calls = counter()
    ms = _time(lambda i: pa.paged_attention_qlen(q, kp[i % layers], vp[i % layers], table, valid), 200)
    ms_device = _time_device(
        lambda i: pa.paged_attention_qlen(q, kp[i % layers], vp[i % layers], table, valid), 200)
    plain_ms = _time(lambda i: pa.paged_attention_qlen_ref(q, kp[i % layers], vp[i % layers],
                                                           table, valid), 20)
    check(counter() > calls, "timing did not launch the kernel")
    # the split sweep: pages of the table per block (the whole table last),
    # as issued and on the device alone
    sm_scale = 1.0 / math.sqrt(hd)
    default_pps = pa.verify_pages_per_split(nb, bsz, R, nKV, qm._n_sms(dev))
    sweep = {}
    for pps in VERIFY_SPLITS:
        def run(i, pps=pps or nb):
            return pa._launch(q, kp[i % layers], vp[i % layers], table, valid, sm_scale, pps)
        sweep[pps or "all"] = dict(pages=pps or nb, ms=_time(run, 200), ms_device=_time_device(run, 200))
    # K3 / K5a over R x W virtual slots, one query each
    qv = q.reshape(R * width, nH, hd)
    tv = table.repeat_interleave(width, dim=0).contiguous()
    vv = valid.reshape(R * width, span)
    per_query_ms = _time(lambda i: pa.paged_attention(qv, kp[i % layers], vp[i % layers], tv, vv), 200)
    idx = table.reshape(-1).long()

    def gathered(pool):
        data, sc = pool if quant else (pool, None)
        g = pa._gather_dequant(data, sc, idx, R, nb, bsz, nKV, hd, torch.bfloat16)
        return g.permute(0, 2, 1, 3).repeat_interleave(nH // nKV, dim=1).contiguous()

    ks = [gathered(p) for p in kp]
    vs = [gathered(p) for p in vp]
    q4 = q.transpose(1, 2)  # [R, nH, W, hd]
    mask = valid[:, None]  # [R, 1, W, span]
    library_ms = _time(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, ks[i % layers], vs[i % layers], attn_mask=mask), 200)
    del ks, vs
    rows_any = int((np.asarray(lengths) + width).sum())  # rows some query reads
    pairs = int(sum((np.asarray(lengths) + 1 + w).sum() for w in range(width)))  # (query, row)
    row_bytes = 2 * (hd + 4) if quant else 2 * hd * 2
    nbytes = (rows_any * nKV * row_bytes + 2 * R * width * nH * hd * 2 + R * nb * 4
              + R * width * span)
    flops = 4 * nH * hd * pairs
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak_flops(q.dtype) * 1e3
    return dict(
        name="paged_verify_q8" if quant else "paged_verify", route="cuda",
        source=KERNEL_SOURCE, replaces=VERIFY_Q8_REPLACES if quant else VERIFY_REPLACES,
        launches=launches, max_abs_err=max_err, max_err=max_err, ms=ms, ms_device=ms_device,
        plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes_ms=bytes_ms, ops_ms=ops_ms, library_ms=library_ms,
        pages_per_split=default_pps, split_sweep=sweep,
        library_call="scaled_dot_product_attention, KV pre-gathered"
                     + (" and pre-dequantized to bf16" if quant else "") + ", [W, span] mask",
        per_query_kernel_ms=per_query_ms,
        per_query_kernel=("K5a" if quant else "K3") + f" over R x W = {R * width} virtual slots",
        shape=dict(R=R, W=width, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb, rows=rows_any,
                   pairs=pairs, dtype="bfloat16",
                   pool="int8 + f32 scales" if quant else "bfloat16"),
    )


def phase_noise_line(dev: torch.device) -> dict:
    """The sampler's noise kernel at a decode step's draw (16 rows over
    Qwen2.5-7B's 152,064-token vocabulary) against its plain version (the
    same Threefry as ~150 elementwise PyTorch ops); bound by its integer
    operations. No PyTorch call computes jax.random's draw."""
    R, V = N_REQUESTS, QWEN25_7B.vocab_size
    gen = np.random.default_rng(SEED + 52)
    keys = torch.as_tensor(gen.integers(0, 2**32, (R, 2)), device=dev)
    pos = torch.as_tensor(gen.integers(0, 4096, R), device=dev)
    calls = tf.launches
    ms = _time(lambda i: tf.gumbel_noise(keys, pos + i, V), 200)
    plain_ms = _time(lambda i: tf.gumbel_noise_ref(keys, pos + i, V), 10)
    check(tf.launches > calls, "timing did not launch the noise kernel")
    bytes_ms = (R * V * 4 + R * 24) / HBM_BYTES_PER_S * 1e3
    ops_ms = R * V * THREEFRY_OPS / INT32_OPS_PER_S * 1e3
    return dict(name="threefry_noise", route="cuda", source="areal_tpu_torch/ops/csrc/threefry.cu",
                ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None, shape=dict(R=R, n=V))


QMM_NAMES = ("attn/q_kernel", "attn/k_kernel", "attn/v_kernel", "attn/o_kernel",
             "mlp/gate_kernel", "mlp/up_kernel", "mlp/down_kernel")
QMM_LINE_T = (16, 80, 1024)  # a decode step, the verify batch, a prefill bucket


def _qmm_layer_times(w: list, xs: dict, T: int, by_shape: bool = True) -> dict:
    """K6 at T rows on one layer's 7 products (`QMM_NAMES`), rotating over
    the layers of `w` ([{name: (q [K, N], scale [N])}]) so the weights come
    from HBM: device ms per layer, the wrapper's host ms per call while
    the calls are queued, and (`by_shape`) device ms per product. Calls
    nothing but `quant_matmul`, so it times another tree's kernel as well."""
    L = len(w)
    iters = 50 if T <= 80 else 10

    def layer(i):
        for n in QMM_NAMES:
            qm.quant_matmul(xs[n][T], *w[i % L][n])

    ms, host_ms = _time_device_and_host(layer, iters)
    res = dict(ms=ms, host_ms_per_call=host_ms / len(QMM_NAMES))
    if by_shape:
        res["by_shape"] = {n: _time_device(
            lambda i, n=n: qm.quant_matmul(xs[n][T], *w[i % L][n]), iters) for n in QMM_NAMES}
    return res


def _qmm_inputs(w0: dict, dev, ts=QMM_LINE_T) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    return {n: {T: torch.randn((T, q.shape[0]), generator=gen, device=dev).to(torch.bfloat16)
                for T in ts} for n, (q, _) in w0.items()}


def _qmm_bound(w0: dict, T: int) -> tuple[float, str]:
    """Least ms for one layer's 7 products at T rows: each weight byte, scale,
    x and output element moved once, or 2 T K N operations at the bf16 peak."""
    nbytes = ops = 0
    for q, _ in w0.values():
        K, N = q.shape
        nbytes += K * N + 4 * N + 2 * T * K + 2 * T * N
        ops += 2 * T * K * N
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_qmm_line(engine, cfg, launches: int, max_err: float) -> dict:
    """K6 timings at the main path's shapes: the 7 dense matmuls of one
    layer (q, k, v, o, gate, up, down) at T 16 (a decode step: the unit of
    `ms`), 80 (the verify batch) and 1024 (a prefill bucket), rotating over
    the int8 engine's layers so the weights come from HBM (each layer's
    233 MB exceeds the 50 MB L2); device ms per layer and per product, and
    the wrapper's host ms per call. A call runs for less time than the host
    takes to launch it, so the times are the device's alone
    (`_time_device`); `host_bound_ms` is the T 16 layer timed as the other
    kernels are, which the host's launch rate sets. The plain version and
    the library yardstick, the bf16 cuBLAS matmul on the weights
    pre-dequantized to bf16 (what the fp engine runs, over 4 layers), take
    the same 7 products. `torch._weight_int8pack_mm` (int8 weights, a scale
    per column) is timed too where this torch has it for CUDA (as launched,
    since it synchronizes). No yardstick is called by the port."""
    dev = engine.device

    def weights(lp, name):
        qt, st = lp[name + "/q"], lp[name + "/scale"]
        K = math.prod(qt.shape[: 2 if name.endswith("o_kernel") else 1])
        return qt.reshape(K, -1), st.reshape(-1)

    w = [{n: weights(lp, n) for n in QMM_NAMES} for lp in engine._layers]
    xs = _qmm_inputs(w[0], dev)
    calls = qm.launches
    times = {T: _qmm_layer_times(w, xs, T) for T in QMM_LINE_T}
    host_ms = _time(lambda i: [qm.quant_matmul(xs[n][16], *w[i % len(w)][n]) for n in QMM_NAMES], 50)
    check(qm.launches > calls, "timing did not launch the kernel")
    plain_ms = _time_device(
        lambda i: [qm.quant_matmul_ref(xs[n][16], *w[i % 4][n], torch.bfloat16) for n in QMM_NAMES],
        10)
    # library yardsticks, on weights dequantized ahead of time (not timed)
    wd = [{n: (q.float() * s[None, :]).to(torch.bfloat16) for n, (q, s) in lw.items()}
          for lw in w[:4]]
    library = {T: _time_device(lambda i, T=T: [xs[n][T] @ wd[i % 4][n] for n in QMM_NAMES],
                               50 if T <= 80 else 10) for T in QMM_LINE_T}
    int8pack = None
    if torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        wt = [{n: (q.t().contiguous(), s.to(torch.bfloat16)) for n, (q, s) in lw.items()}
              for lw in w[:4]]
        # timed as launched: the call synchronizes, so it cannot be queued
        int8pack = _time(lambda i: [torch._weight_int8pack_mm(xs[n][16], *wt[i % 4][n])
                                    for n in QMM_NAMES], 20)
        del wt
    del wd
    bounds = {T: _qmm_bound(w[0], T) for T in QMM_LINE_T}
    ops_1024 = sum(2 * 1024 * q.numel() for q, _ in w[0].values())
    return dict(
        name="quant_matmul", route="cuda", source=QMM_SOURCE, replaces=QMM_REPLACES,
        launches=launches, max_abs_err=max_err, max_err=max_err,
        unit="the 7 dense matmuls of one layer (q, k, v, o, gate, up, down), T 16",
        timing="device only: the calls queued behind a sleep kernel (_time_device)",
        ms=times[16]["ms"], host_bound_ms=host_ms, plain_ms=plain_ms, bound_ms=bounds[16][0],
        bound_by=bounds[16][1], library_ms=library[16],
        library_call="torch.matmul, bf16 x on the weights pre-dequantized to bf16 (cuBLAS)",
        library_int8pack_ms=int8pack,
        by_T={T: dict(times[T], bound_ms=bounds[T][0], bound_by=bounds[T][1],
                      library_ms=library[T]) for T in QMM_LINE_T},
        prefill_T1024_tflops=ops_1024 / (times[1024]["ms"] * 1e9),
        plans={T: {n: qm._plan_on(dev, T, *w[0][n][0].shape)._asdict() for n in QMM_NAMES}
               for T in QMM_LINE_T},
        occupancy={mt: qm.occupancy(dev, mt) for mt in range(1, qm.MAX_ROWS // 16 + 1)},
        shape=dict(T=16, dtype="bfloat16", weights="int8 + f32 scale per column",
                   layers_rotated=len(w)),
    )


def _qwen7b_int8_layers(dev, n: int) -> list:
    """`n` layers of Qwen2.5-7B's 7 dense products as random int8 weights
    and f32 scales ([K, N], [N]) from SEED."""
    cfg = QWEN25_7B
    H, I = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * (H // cfg.num_attention_heads)
    shapes = dict(zip(QMM_NAMES, [(H, H), (H, kv), (H, kv), (H, H), (H, I), (H, I), (I, H)]))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return [{name: (torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8),
                    torch.rand(N, generator=gen, device=dev) * 1e-2 + 1e-3)
             for name, (K, N) in shapes.items()} for _ in range(n)]


def qmm_times_only() -> int:
    """`--qmm-times`: K6 device ms per layer and per product at T 16, 80
    and 1024, and the wrapper's host ms per call, on 28 layers of random
    Qwen2.5-7B int8 weights. It calls only `quant_matmul`, so the same
    script times another tree's kernel when it is run from that tree's
    root."""
    dev, smi = phase_device()
    w = _qwen7b_int8_layers(dev, QWEN25_7B.num_hidden_layers)
    xs = _qmm_inputs(w[0], dev)
    qm.quant_matmul(xs[QMM_NAMES[0]][16], *w[0][QMM_NAMES[0]])  # build and load first
    emit("qmm_times", **{f"T{T}": _qmm_layer_times(w, xs, T) for T in QMM_LINE_T},
         bound_ms={f"T{T}": _qmm_bound(w[0], T)[0] for T in QMM_LINE_T})
    print(smi, flush=True)
    return 0


K6_VARIANTS = Path(__file__).resolve().parent / "build" / "k6_variants"


def k6_variants(defines: dict[str, tuple[str, ...]]) -> dict[str, ctypes.CDLL]:
    """Copies of K6's library built from its source with other macros
    (`defines[tag]`, each passed as -D): a sweep's pipeline depths, the load
    diagnostic's reduced kernels. One nvcc each, all started together, into
    build/k6_variants/; bound as the wrapper binds its own."""
    K6_VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, macros in defines.items():
        so = K6_VARIANTS / f"libquant_matmul_{tag}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o", str(so),
               str(_build.SOURCES["quant_matmul"])]
        procs[tag] = so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for K6 variant {tag}:\n{log}")
        libs[tag] = qm.bind(ctypes.CDLL(str(so)))
    return libs


def qmm_sweep_only() -> int:
    """`--qmm-sweep`: device ms of the bf16 K6 kernel at Qwen2.5-7B's four
    (K, N) shapes at T 16 and 80, for every resident blocks per SM up to the
    occupancy and pipeline depths of 2, 4 (the wrapper's build) and 8
    (copies built with `QMM_STAGES`), beside the default plan; weights
    rotated over copies of 128 MB or more in all, so they come from HBM."""
    dev, smi = phase_device()
    libs = {qm.STAGES: qm._kernel_lib(),
            **{int(t): lib for t, lib in k6_variants({"2": ("QMM_STAGES=2",),
                                                      "8": ("QMM_STAGES=8",)}).items()}}
    w = _qwen7b_int8_layers(dev, 1)[0]
    n_sms = qm._n_sms(dev)
    rows = []
    for name in ("attn/q_kernel", "attn/k_kernel", "mlp/gate_kernel", "mlp/down_kernel"):
        q, sc = w[name]
        K, N = q.shape
        copies = [(q, sc)] + [(q.clone(), sc.clone()) for _ in range(-(-(128 << 20) // q.numel()) - 1)]
        for T in (16, 80):
            x = torch.randn((T, K), device=dev).to(torch.bfloat16)
            out = torch.empty((T, N), dtype=torch.bfloat16, device=dev)
            mt = qm.row_tiles(T)[0]
            ms = {}
            for st, lib in sorted(libs.items()):
                occ = ctypes.c_int(0)
                qm._raise_on(lib.areal_quant_matmul_bf16_occupancy(mt, ctypes.byref(occ)))
                for bps in range(1, occ.value + 1):
                    p = qm.plan(T, K, N, bps * n_sms)
                    # at least `st` units a block, as `plan` keeps STAGES
                    p = p._replace(grid=max(1, min(bps * n_sms, p.units // st)))
                    ms[f"stages{st}_bps{bps}"] = _time_device(
                        lambda i, p=p, lib=lib: qm._launch_bf16(
                            x, *copies[i % len(copies)], out, p, lib), 100)
            best = min(ms, key=ms.get)
            default = qm._plan_on(dev, T, K, N)
            rows.append(dict(shape=name, K=K, N=N, T=T, copies=len(copies), ms_device=ms,
                             fastest=best, default=dict(default._asdict(), ms=_time_device(
                                 lambda i: qm._launch_bf16(x, *copies[i % len(copies)], out,
                                                           default), 100))))
        del copies
        torch.cuda.empty_cache()
    emit("qmm_sweep", n_sms=n_sms, rows=rows)
    print(smi, flush=True)
    return 0


# phase: one colocated GRPO loop at Qwen2.5-1.5B
TRAIN_ROLLOUT = dict(
    max_running_requests=32, context_length=1024, page_size=128,
    new_tokens_per_chunk=128,
)
N_PROMPTS, GROUP = 8, 4  # 8 prompts x 4 samples, the GRPO group
TRAIN_PROMPT_LEN = (64, 512)
TRAIN_MAX_NEW = 256
TRAIN_ITERS = 3
# bf16 weights of the 1.5B model sit near 1/sqrt(1536) ~ 0.026, where bf16
# values are 2^-13 ~ 1.2e-4 apart: an AdamW step (about lr per element)
# under half of that rounds away in the cast back to bf16 and nothing
# would move. 1e-4 moves most matrix elements by one bf16 step.
TRAIN_LR = 1e-4
# behaviour (decode engine) vs recomputed (trainer) logprobs of the same
# tokens under the same weights: the two run the same bf16 model through
# different kernels and GEMM shapes (and the trainer's loss head keeps its
# logits in f32), so they differ by bf16 rounding only. On an H100 (700 W)
# the train phase read max 0.0032 and mean 0.00067 over 8,192 tokens; the
# bounds leave ~15x and ~7x of room for other seeds and cards.
LOGP_MAX_ABS_DIFF = 0.05
LOGP_MEAN_ABS_DIFF = 0.005


def reward_of(tokens: list[int]) -> float:
    """The fixed reward of a response (random weights have no task): 1 when
    more than half of its token ids are even, else 0. About half of the
    samples score 1, so most groups have a non-zero advantage."""
    return float(2 * sum(1 for t in tokens if t % 2 == 0) > len(tokens))


def _grpo_batch(prompts: list[list[int]], resps) -> dict:
    """The RLVR workflow's padded batch (`areal_tpu/workflow/rlvr.py`):
    prompt + response tokens, the behaviour logprob of each response token
    at its own position, a loss mask over the response, one reward per
    sequence."""
    B = len(resps)
    T = max(len(p) + r.output_len for p, r in zip(prompts, resps))
    batch = dict(
        input_ids=np.zeros((B, T), np.int64),
        attention_mask=np.zeros((B, T), np.int64),
        loss_mask=np.zeros((B, T), np.int32),
        logprobs=np.zeros((B, T), np.float32),
        versions=np.full((B, T), -1, np.int32),
        rewards=np.zeros(B, np.float32),
    )
    for i, (p, r) in enumerate(zip(prompts, resps)):
        n, m = len(p), r.output_len
        batch["input_ids"][i, : n + m] = p + r.output_tokens
        batch["attention_mask"][i, : n + m] = 1
        batch["loss_mask"][i, n : n + m] = 1
        batch["logprobs"][i, n : n + m] = r.output_logprobs
        batch["versions"][i, n : n + m] = r.output_versions
        batch["rewards"][i] = reward_of(r.output_tokens)
    return batch


def _segment_ids_of(mb: dict) -> np.ndarray:
    """A packed micro-batch's segment ids, as the train engine makes them."""
    cu = np.asarray(mb["cu_seqlens"])
    return segment_ids_from_cu_seqlens(cu, int(cu[-1]))


def _flash_counts() -> np.ndarray:
    return np.array([fa.launches_fwd, fa.launches_dq, fa.launches_dkv])


def _kernel_family(name: str) -> str:
    # K4's and K5b's combine passes (`paged_verify_combine_kernel`,
    # `paged_verify_q8_combine_kernel`) fall under their kernels
    name = name.lower()
    if "paged_verify_q8" in name:
        return "K5b paged_verify_q8"
    if "paged_verify" in name:
        return "K4 paged_verify"
    if "threefry" in name:
        return "threefry_noise"
    if "paged_attn_q8" in name:
        return "K5a paged_attention_q8"
    if "paged_attn" in name:
        return "paged_attention"
    if "quant_matmul" in name:
        return "K6 quant_matmul"
    if "flash_fwd" in name:
        return "K1 flash_fwd"
    if "flash_bwd_dq" in name:
        return "K2a flash_bwd_dq"
    if "flash_bwd_dkv" in name:
        return "K2b flash_bwd_dkv"
    if any(s in name for s in ("gemm", "sm90", "cutlass", "nvjet", "xmma")):
        return "gemm"
    return "other"


def _device_ms_by_family(prof) -> tuple[dict, int, list]:
    """Device ms summed by kernel family, the kernel count, and the six
    costliest kernels of the "other" family."""
    fams: dict[str, float] = {}
    others = []
    n = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if not dev_us or ev.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            continue
        n += ev.count
        fam = _kernel_family(ev.key)
        fams[fam] = fams.get(fam, 0.0) + dev_us / 1e3
        if fam == "other":
            others.append((dev_us / 1e3, ev.count, ev.key[:90]))
    return fams, n, sorted(others, reverse=True)[:6]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def phase_train(dev: torch.device) -> dict:
    """One colocated GRPO loop at Qwen2.5-1.5B full width and depth (bf16,
    random weights from the seed): for each of 3 iterations, 8 prompts x 4
    samples from a `TorchDecodeEngine` (K3), rewards by `reward_of`, then
    `compute_logp` (K1), `compute_advantages`, `ppo_update` (K1 twice per
    layer under remat, K2a, K2b) and `update_weights` into the decode
    engine. Checks: decode-engine and trainer logprobs agree on the first
    iteration's weights; the first update (lr 0) leaves every parameter
    bit for bit, the second moves them; each moving update lowers the PPO
    loss on its own batch; loss and grad norm are finite; responses carry
    the version of the last push; K1/K2a/K2b launch exactly L per
    micro-batch per pass (K1 twice under remat), and K3 launches."""
    from torch.profiler import ProfilerActivity, profile

    cfg = dataclasses.replace(QWEN25_1_5B, scan_layers=False, remat=True)
    L = cfg.num_hidden_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 20), dev)
    actor_cfg = PPOActorConfig(
        experiment_name="chip_smoke", trial_name="train", path="",
        init_from_scratch=True, dtype="bfloat16", gradient_checkpointing=True,
        jax=JaxEngineConfig(fused_lm_loss=True), mb_spec=MicroBatchSpec(max_tokens_per_mb=8192),
        optimizer=OptimizerConfig(
            lr=TRAIN_LR, weight_decay=0.01, lr_scheduler_type="constant",
            warmup_steps_proportion=0.001, gradient_clipping=1.0,
        ),
        group_size=GROUP, ppo_n_minibatches=1, eps_clip=0.2, kl_ctl=0.0,
        use_decoupled_loss=True, recompute_logprob=True, temperature=1.0,
        adv_norm=NormConfig(mean_level="group", std_level="group", group_size=GROUP),
    )
    actor = TorchPPOActor(actor_cfg, device=dev)
    actor.model_config = cfg
    actor.create_process_group()
    actor.initialize(None, FinetuneSpec(1, TRAIN_ITERS * N_PROMPTS * GROUP, N_PROMPTS * GROUP),
                     params=params)
    engine = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **TRAIN_ROLLOUT), device=dev)
    engine.set_model(params, cfg)
    del params
    torch.cuda.empty_cache()
    engine.initialize()
    meta = WeightUpdateMeta.from_memory()
    actor.connect_engine(engine, meta)
    rng = np.random.default_rng(SEED + 3)
    loss_fn = actor.actor._loss_fn

    def weight_fn(mb):
        return float(np.asarray(mb["loss_mask"]).sum())

    torch.cuda.reset_peak_memory_stats(dev)
    iters, snapshot, main_mb = [], None, None
    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    eval_launches = np.zeros(3, np.int64)
    for it in range(TRAIN_ITERS):
        prompts = [
            rng.integers(0, cfg.vocab_size, int(rng.integers(*TRAIN_PROMPT_LEN, endpoint=True))).tolist()
            for _ in range(N_PROMPTS)
        ]
        reqs = [
            ModelRequest(rid=f"it{it}-p{i}-s{j}", input_ids=p,
                         gconfig=GenerationHyperparameters(max_new_tokens=TRAIN_MAX_NEW,
                                                           temperature=1.0))
            for i, p in enumerate(prompts) for j in range(GROUP)
        ]
        k3_before = pa.launches
        t0 = time.perf_counter()
        resps = asyncio.run(_serve_wave(engine, reqs))
        rollout_s = time.perf_counter() - t0
        check(pa.launches > k3_before, "the rollout did not launch K3")
        for r in resps:
            check(r.output_len == TRAIN_MAX_NEW and r.output_versions == [it] * r.output_len,
                  f"{r.input_len}-token prompt: {r.output_len} tokens, versions "
                  f"{sorted(set(r.output_versions))} != [{it}]")
        batch = _grpo_batch([q.input_ids for q in reqs], resps)
        n_mbs = len(split_padded_tensor_dict_into_mb_list(batch, actor_cfg.mb_spec).mbs)
        if main_mb is None:
            main_mb = split_padded_tensor_dict_into_mb_list(batch, actor_cfg.mb_spec).mbs[0]

        c0 = _flash_counts()
        batch["prox_logp"] = actor.compute_logp(batch)
        c1 = _flash_counts()
        check((c1 - c0).tolist() == [n_mbs * L, 0, 0],
              f"compute_logp launched {(c1 - c0).tolist()}, want [{n_mbs * L}, 0, 0]")
        row = dict(iteration=it, rollout_s=rollout_s, n_mbs=n_mbs,
                   tokens=int(batch["attention_mask"].sum()),
                   response_tokens=int(batch["loss_mask"].sum()),
                   reward_mean=float(batch["rewards"].mean()))
        if it == 0:
            # behaviour vs recomputed logprobs of each response token
            lm = batch["loss_mask"][:, 1:] > 0
            d = batch["prox_logp"][:, :-1][lm] - batch["logprobs"][:, 1:][lm]
            row.update(behave_approx_kl=float(d.mean()), logp_max_abs_diff=float(np.abs(d).max()),
                       logp_mean_abs_diff=float(np.abs(d).mean()))
            check(np.abs(d).max() <= LOGP_MAX_ABS_DIFF and np.abs(d).mean() <= LOGP_MEAN_ABS_DIFF,
                  f"decode vs trainer logprobs: max |d| {np.abs(d).max()}, mean {np.abs(d).mean()}")
        actor.compute_advantages(batch)
        moving = it > 0
        if moving:  # the PPO loss on this batch before the update
            e0 = _flash_counts()
            row["loss_before"] = actor.eval_batch(batch, loss_fn, weight_fn)
            eval_launches += _flash_counts() - e0
        else:
            snapshot = {k: v.detach().clone() for k, v in actor.params.items()}
        c2, builds0 = _flash_counts(), fa.layout_builds
        if it == TRAIN_ITERS - 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                stats = actor.ppo_update(batch)
                torch.cuda.synchronize()
                profiled_s = time.perf_counter() - t0
            fams, n_kernels, top_other = _device_ms_by_family(prof)
            row["profile"] = dict(
                wall_ms=profiled_s * 1e3, kernels=n_kernels,
                device_ms=fams, device_total_ms=sum(fams.values()),
                device_busy_share=sum(fams.values()) / (profiled_s * 1e3),
                top_other_ms=top_other,
            )
        else:
            stats = actor.ppo_update(batch)
        c3 = _flash_counts()
        # the segment layout is built once per micro-batch forward (the remat
        # reruns reuse it); before, every flash call built its own
        row["layout_builds"] = fa.layout_builds - builds0
        check(row["layout_builds"] == n_mbs,
              f"ppo_update built the flash layout {row['layout_builds']} times, want {n_mbs}")
        if "profile" in row:
            # one layout build's kernels, from L builds in a row: the host's
            # launch calls, and the kernels the device trace recorded
            seg_dev = torch.as_tensor(_segment_ids_of(main_mb), device=dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as lprof:
                for _ in range(L):
                    fa.packed_layout(seg_dev)
                torch.cuda.synchronize()
            per_build = sum(ev.count for ev in lprof.key_averages()
                            if ev.key.startswith(("cudaLaunchKernel", "cuLaunchKernel"))) / L
            flash_calls = int(c3[0] - c2[0])
            row["profile"].update(
                layout_launches_per_build=per_build,
                layout_traced_kernels_per_build=_device_ms_by_family(lprof)[1] / L,
                flash_calls=flash_calls, layout_builds=row["layout_builds"],
                # reckoned, not traced: this run's kernels plus one build's
                # launches for each flash call past the micro-batches' own
                reckoned_kernels_with_a_layout_per_call=n_kernels + per_build * (
                    flash_calls - row["layout_builds"]))
        want = [2 * n_mbs * L, n_mbs * L, n_mbs * L]
        check((c3 - c2).tolist() == want, f"ppo_update launched {(c3 - c2).tolist()}, want {want}")
        st = stats[0]
        row.update(loss=st["loss"], grad_norm=st["grad_norm"], lr=st["lr"],
                   n_mbs_trained=st["n_mbs"], step_s=st["train_batch_time"],
                   tokens_per_s=st["tokens_per_sec_per_chip"], mfu=st["mfu"],
                   behave_approx_kl_stat=st.get("behave_approx_kl"),
                   behave_imp_weight=st.get("behave_imp_weight"),
                   clip_ratio=st.get("clip_ratio"), entropy=st.get("entropy"))
        check(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"]),
              f"iteration {it}: loss {st['loss']}, grad norm {st['grad_norm']}")
        if it == 0:
            same = all(torch.equal(_bits(v), _bits(snapshot[k])) for k, v in actor.params.items())
            check(same, "the first update (lr 0) changed the parameters")
            row["params_bitwise_unchanged"] = same
        else:
            e0 = _flash_counts()
            row["loss_after"] = actor.eval_batch(batch, loss_fn, weight_fn)
            eval_launches += _flash_counts() - e0
            check(row["loss_after"] < row["loss_before"],
                  f"iteration {it}: PPO loss {row['loss_before']} -> {row['loss_after']}")
        if it == 1:
            changed = sum(int((_bits(v) != _bits(snapshot[k])).sum()) for k, v in actor.params.items())
            total = sum(v.numel() for v in actor.params.values())
            row["params_changed_share"] = changed / total
            check(changed > 0, "the second update moved no parameter")
            snapshot = None
        actor.set_version(it + 1)
        actor.update_weights(meta)
        check(engine.get_version() == it + 1, "the push did not stamp the new version")
        iters.append(row)
    launches = dict(
        paged_attention=pa.launches,
        flash_attention_fwd=fa.launches_fwd - int(eval_launches[0]),
        flash_attention_bwd_dq=fa.launches_dq - int(eval_launches[1]),
        flash_attention_bwd_dkv=fa.launches_dkv - int(eval_launches[2]),
    )
    # ---- end of the main path ----
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    emit("train", model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE, layers=L,
         dtype=cfg.dtype, lr=TRAIN_LR, max_tokens_per_mb=8192,
         launches=launches, eval_launches=eval_launches.tolist(),
         max_memory_allocated_gb=peak_gb, iterations=iters,
         decode_tok_s=engine.decode_tokens / engine.decode_seconds,
         decode_step_ms=engine.decode_seconds / engine.decode_steps * 1e3,
         decode_steps=engine.decode_steps, prefill_tokens=engine.prefill_tokens,
         prefill_s=engine.prefill_seconds)
    seg = _segment_ids_of(main_mb)
    engine.destroy()
    actor.destroy()
    return dict(launches=launches, segment_ids=seg, cfg=cfg)


FLASH_FLOPS_PER_PAIR = {  # x head_dim x query heads, per valid (query, key) pair
    "flash_attention_fwd": 4, "flash_attention_bwd_dq": 6, "flash_attention_bwd_dkv": 8,
}


def _flash_bounds(T: int, nH: int, nKV: int, hd: int, pairs: int) -> dict:
    """Least time of each kernel at these inputs: the bytes each must move
    (every input read once, every output written once; bf16 tensors, f32
    lse/dd, int32 ids) at the HBM rate, or its FLOPs over the valid pairs at
    the bf16 tensor-core rate, whichever is larger."""
    q = T * nH * hd * 2
    kv = T * nKV * hd * 2
    rows = T * nH * 4
    ids = 4 * T * 4
    moved = {
        "flash_attention_fwd": q + 2 * kv + ids + q + rows,
        "flash_attention_bwd_dq": 2 * q + 2 * kv + 2 * rows + ids + q,
        "flash_attention_bwd_dkv": 2 * q + 2 * kv + 2 * rows + ids + 2 * kv,
    }
    out = {}
    for name, nbytes in moved.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = FLASH_FLOPS_PER_PAIR[name] * hd * nH * pairs / BF16_FLOPS * 1e3
        out[name] = dict(bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def _live_tile_pairs(mq, mk) -> int:
    """(Q tile, K tile) pairs the kernels visit for one head (`tile_meta`'s
    liveness rule)."""
    qm, km = mq[:, None, :], mk[None, :, :]
    live = (qm[..., 0] <= km[..., 1]) & (km[..., 0] <= qm[..., 1]) & (km[..., 2] <= qm[..., 2])
    return int(live.sum())


def phase_flash_line(dev: torch.device, train: dict) -> list[dict]:
    """K1, K2a and K2b at the train phase's micro-batch shape (the first
    micro-batch's packed segments, Qwen2.5-1.5B heads, bf16): each kernel
    wrapper against its plain version on the same inputs (f32-upcast),
    CUDA-event times of both, and `scaled_dot_product_attention` with the
    [T, T] segment-causal mask and `varlen_attn`, forward and backward timed
    apart, as the library yardsticks (timed here only; the port never calls
    them). Kernels and yardsticks are timed as the host issues them
    (`_time`) and on the device alone (`_time_device`)."""
    cfg = train["cfg"]
    seg_np = train["segment_ids"]
    T = len(seg_np)
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    g = nH // nKV
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = rand(T, nH, hd), rand(T, nKV, hd), rand(T, nKV, hd), rand(T, nH, hd)
    lay = fa.packed_layout(torch.as_tensor(seg_np, device=dev))
    ids, mq, mk = lay[:4], lay.meta_q, lay.meta_k
    sm = 1.0 / math.sqrt(hd)
    o, lse = fa.flash_fwd(q, k, v, *ids, mq, mk, sm)
    dd = (-(o.float() * do.float()).sum(-1).t()).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, do, lse, dd, *ids, mq, mk, sm)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dd, *ids, mq, mk, sm)
    f32 = [t.float() for t in (q, k, v, do)]
    with torch.no_grad():
        ro, rl = fa.flash_attention_ref(*f32[:3], *ids, sm_scale=sm)
        rdq = fa.flash_bwd_dq_ref(*f32, lse, dd, *ids, sm)
        rdk, rdv = fa.flash_bwd_dkv_ref(*f32, lse, dd, *ids, sm)
    torch.cuda.synchronize()
    a, rtol = 2e-5, 2.0 ** -8  # same inputs: f32 summation order + one bf16 rounding
    checks = {
        "flash_attention_fwd": dict(o=(o, ro), lse=(lse, rl.t())),
        "flash_attention_bwd_dq": dict(dq=(dq, rdq)),
        "flash_attention_bwd_dkv": dict(dk=(dk, rdk), dv=(dv, rdv)),
    }
    errs, ratios, rounding = {}, {}, {}
    for name, outs in checks.items():
        ratios[name] = max(_scaled_ratio(x, r, a, rtol) for x, r in outs.values())
        errs[name] = max((x.float() - r).abs().max().item() for x, r in outs.values())
        rounding[name] = {out: _rounding_stats(x, r, a, rtol)
                          for out, (x, r) in outs.items() if out != "lse"}
        check(ratios[name] <= 1.0,
              f"{name} vs its plain version at the train shape: {ratios[name]} x the tolerance")
    # K2b at every split of a kv head's query heads over blocks (the
    # default, one head per block, is the last), each checked and timed
    split_sweep = []
    for splits in range(1, g + 1):
        def dkv(i, splits=splits):
            return fa.flash_bwd_dkv(q, k, v, do, lse, dd, *ids, mq, mk, sm, splits=splits)

        sdk, sdv = dkv(0)
        ratio = max(_scaled_ratio(sdk, rdk, a, rtol), _scaled_ratio(sdv, rdv, a, rtol))
        check(ratio <= 1.0, f"K2b at {splits} splits vs its plain version at the train "
                            f"shape: {ratio} x the tolerance")
        split_sweep.append(dict(splits=splits, tol_ratio=ratio, device_ms=_time_device(dkv, 20)))
    del ro, rl, rdq, rdk, rdv, f32, checks, sdk, sdv

    calls = {
        "flash_attention_fwd": lambda i: fa.flash_fwd(q, k, v, *ids, mq, mk, sm),
        "flash_attention_bwd_dq": lambda i: fa.flash_bwd_dq(q, k, v, do, lse, dd, *ids, mq, mk, sm),
        "flash_attention_bwd_dkv": lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, dd, *ids, mq, mk,
                                                               sm),
    }
    ms = {name: _time(fn, 20) for name, fn in calls.items()}
    device_ms = {name: _time_device(fn, 20) for name, fn in calls.items()}
    with torch.no_grad():
        plain_ms = {
            "flash_attention_fwd": _time(
                lambda i: fa.flash_attention_ref(q, k, v, *ids, sm_scale=sm), 5),
            "flash_attention_bwd_dq": _time(
                lambda i: fa.flash_bwd_dq_ref(q, k, v, do, lse, dd, *ids, sm), 5),
            "flash_attention_bwd_dkv": _time(
                lambda i: fa.flash_bwd_dkv_ref(q, k, v, do, lse, dd, *ids, sm), 5),
        }
    # library yardstick: SDPA over [1, nH, T, hd] with kv heads repeated and
    # the dense [T, T] segment-causal mask
    mask = fa._valid(*ids)
    q4 = q.transpose(0, 1)[None].contiguous().requires_grad_()
    k4 = k.transpose(0, 1)[None].repeat_interleave(g, dim=1).contiguous().requires_grad_()
    v4 = v.transpose(0, 1)[None].repeat_interleave(g, dim=1).contiguous().requires_grad_()
    do4 = do.transpose(0, 1)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib, lib_device = {}, {}

    def sdpa_fwd(i):
        return sdpa(q4, k4, v4, attn_mask=mask)

    with torch.no_grad():
        lib["fwd"], lib_device["fwd"] = _time(sdpa_fwd, 20), _time_device(sdpa_fwd, 20)
    out4 = sdpa(q4, k4, v4, attn_mask=mask)

    def sdpa_bwd(i):
        return torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True)

    lib["bwd"], lib_device["bwd"] = _time(sdpa_bwd, 20), _time_device(sdpa_bwd, 20)
    del out4, q4, k4, v4, do4, mask
    varlen = _varlen_library_ms(q, k, v, do, seg_np, g)
    lens = np.bincount(seg_np[seg_np >= 0])
    pairs = int((lens * (lens + 1) // 2).sum())
    tile_pairs = _live_tile_pairs(mq.cpu(), mk.cpu()) * nH
    bounds = _flash_bounds(T, nH, nKV, hd, pairs)
    rows = []
    for name in ms:
        d = "fwd" if name.endswith("fwd") else "bwd"
        flops = FLASH_FLOPS_PER_PAIR[name] * hd * nH * pairs
        rows.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE, replaces=FLASH_REPLACES[name],
            launches=train["launches"][name], max_abs_err=errs[name], max_err=errs[name],
            tol=dict(a=a, rtol=rtol), tol_ratio=ratios[name], rounding=rounding[name],
            ms=ms[name], device_ms=device_ms[name],
            tflops=flops / (device_ms[name] * 1e-3) / 1e12, tile_pairs=tile_pairs,
            route_detail="tensor cores (mma.sync bf16, P/dS as hi + lo)",
            plain_ms=plain_ms[name], **bounds[name],
            library_ms=lib[d], library_device_ms=lib_device[d],
            library_call=("scaled_dot_product_attention forward, [T, T] mask"
                          if d == "fwd" else
                          "scaled_dot_product_attention backward (dq, dk, dv in one call)"),
            library_varlen_ms=varlen[d], library_varlen_device_ms=varlen[d + "_device"],
            library_varlen_call=varlen["call"],
            shape=dict(T=T, nH=nH, nKV=nKV, hd=hd, segments=len(lens),
                       valid_pairs=pairs, dtype="bfloat16"),
        ))
        if name == "flash_attention_bwd_dkv":
            rows[-1].update(splits=g, split_sweep=split_sweep)
    return rows


def _rounding_stats(x, ref, a: float, rtol: float) -> dict:
    """How a bf16 output sits against its f32 plain version: the share of
    elements past half the tolerance, the share equal to the plain version
    rounded to bf16, and the largest distance from it in bf16 ulps where
    the relative term of the tolerance governs (rtol |ref| >= a max|ref|;
    closer to 0 the f32 summation order alone is many ulps): 0 where the
    two round alike, 1 where the summation order tips a rounding."""
    x, ref = x.float(), ref.float()
    scale = a * ref.abs().max()
    ratio = (x - ref).abs() / (scale + rtol * ref.abs())
    rb = ref.to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(rb.abs().clamp_min(1e-30))) - 7)
    rel = rtol * ref.abs() >= scale
    return dict(share_over_half_tol=(ratio > 0.5).float().mean().item(),
                share_equal_rounded_plain=(x == rb).float().mean().item(),
                max_ulps_from_rounded_plain=((x - rb).abs() / ulp)[rel].max().item())


def _varlen_library_ms(q, k, v, do, seg_np, g) -> dict:
    """`torch.nn.attention.varlen.varlen_attn` of the card's torch, causal
    within each sequence, timed like SDPA. A yardstick only."""
    from torch.nn.attention.varlen import varlen_attn

    lens = np.bincount(seg_np[seg_np >= 0])
    cu = torch.as_tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32, device=q.device)
    kr = k.repeat_interleave(g, dim=1).contiguous()
    vr = v.repeat_interleave(g, dim=1).contiguous()
    mx = int(lens.max())
    causal = (-1, 0)
    with torch.no_grad():
        def fwd_fn(i):
            return varlen_attn(q, kr, vr, cu, cu, mx, mx, window_size=causal)

        fwd, fwd_device = _time(fwd_fn, 20), _time_device(fwd_fn, 20)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, kr, vr))
    out = varlen_attn(qg, kg, vg, cu, cu, mx, mx, window_size=causal)

    def bwd_fn(i):
        return torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)

    bwd, bwd_device = _time(bwd_fn, 20), _time_device(bwd_fn, 20)
    return dict(fwd=fwd, bwd=bwd, fwd_device=fwd_device, bwd_device=bwd_device,
                call="torch.nn.attention.varlen.varlen_attn "
                "(window_size=(-1, 0), kv heads repeated)")


def main() -> int:
    t0 = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    max_err = phase_kernel(dev)
    phase_bad_table()
    phase_flash_kernel(dev)
    q_err = phase_quant_kernel(dev)
    v_err = phase_verify_kernel(dev)
    engine, cfg, launches = phase_serve(dev)
    try:
        batch = phase_step(engine, cfg)
        phase_profile(engine, cfg, batch)
        paged = phase_paged_line(engine, cfg, batch, launches, max_err)
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    engine, cfg, s_launches = phase_serve_spec(dev, SERVE, "serve_spec")
    try:
        batch = phase_spec_step(engine, cfg)
        phase_profile(engine, cfg, batch, phase="profile_verify", width=SPEC_K + 1)
        verify = phase_verify_line(engine, cfg, batch, s_launches["paged_verify"],
                                   v_err["paged_verify"])
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    engine, cfg, q_launches = phase_serve_int8(dev)
    try:
        batch = phase_quant_step(engine, cfg)
        phase_profile(engine, cfg, batch, phase="profile_int8")
        q8 = phase_paged_line(engine, cfg, batch, q_launches["paged_attention_q8"],
                              q_err["paged_attention_q8"])
        qmm_row = phase_qmm_line(engine, cfg, q_launches["quant_matmul"], q_err["quant_matmul"])
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    engine, cfg, s8_launches = phase_serve_spec(dev, SERVE_INT8, "serve_spec_int8")
    try:
        batch = _served_batch(engine, cfg, np.random.default_rng(SEED + 8), width=SPEC_K + 1)
        batch = dict(table=batch[0], lengths=batch[3])
        verify_q8 = phase_verify_line(engine, cfg, batch, s8_launches["paged_verify_q8"],
                                      v_err["paged_verify_q8"])
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    noise = phase_noise_line(dev)
    noise["launches_by_path"] = dict(serve_spec=s_launches["threefry_noise"],
                                     serve_spec_int8=s8_launches["threefry_noise"])
    emit("noise_line", **noise)
    train = phase_train(dev)
    torch.cuda.empty_cache()
    # K3 runs in the serve and train paths and in the spec path's normal
    # chunks; K5a in the int8 serve path and the int8 spec path's; K6 in both
    # int8 paths
    paged["launches_by_path"] = dict(serve=launches, serve_spec=s_launches["paged_attention"],
                                     train=train["launches"]["paged_attention"])
    paged["launches"] = sum(paged["launches_by_path"].values())
    q8["launches_by_path"] = dict(serve_int8=q_launches["paged_attention_q8"],
                                  serve_spec_int8=s8_launches["paged_attention_q8"])
    q8["launches"] = sum(q8["launches_by_path"].values())
    qmm_row["launches_by_path"] = dict(serve_int8=q_launches["quant_matmul"],
                                       serve_spec_int8=s8_launches["quant_matmul"])
    qmm_row["launches"] = sum(qmm_row["launches_by_path"].values())
    rows = [paged, *phase_flash_line(dev, train), q8, qmm_row, verify, verify_q8]
    for r in rows:
        check(r["launches"] > 0, f"{r['name']}: no launch on the main path")
    print(json.dumps({"kernels": rows}), flush=True)
    emit("done", seconds=time.perf_counter() - t0)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    modes = {"--paged-times": paged_times_only, "--decode-sweep": decode_sweep_only,
             "--qmm-times": qmm_times_only, "--qmm-sweep": qmm_sweep_only}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:] else main())
