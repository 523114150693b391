"""Chip check of the PyTorch/CUDA port (`areal_tpu_torch`) on one H100.

Run from the repository root, with no arguments, on a machine with one
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, then drives the two
main paths with seeded random weights in bf16: it serves 16 concurrent
requests through `TorchDecodeEngine` at Qwen2.5-7B full width and depth,
and runs three colocated GRPO iterations (rollout, `compute_logp`,
`compute_advantages`, `ppo_update`, weight push) through `TorchPPOActor`
at Qwen2.5-1.5B full width and depth. It checks that the kernels really
carried each path. Each phase prints one JSON line; then come the
`kernels` line, the card's name and power limit, and last
`{"ok": true, "device": ...}`. Any failed check raises, and the script
exits non-zero without that last line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
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
    MicroBatchSpec,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
    TorchDecodeConfig,
)
from areal_tpu_torch.api.io_struct import FinetuneSpec, ModelRequest, WeightUpdateMeta
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models.qwen2 import (
    decode_step_paged,
    init_params,
    segment_ids_from_cu_seqlens,
)
from areal_tpu_torch.models.smoke import (
    QWEN25_1_5B,
    QWEN25_1_5B_SOURCE,
    QWEN25_7B,
    QWEN25_7B_SOURCE,
)
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import flash_attention as fa
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.platforms import resolve_device
from areal_tpu_torch.utils.data import split_padded_tensor_dict_into_mb_list

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, bf16 tensor cores, dense
KERNEL_SOURCE = "areal_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "areal_tpu/ops/paged_attention.py:118"
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

# phase 3: kernel vs plain
KERNEL_CASES = [
    dict(name="qwen2.5-7b", nH=28, nKV=4, hd=128, bsz=128, R=16, max_len=4096),
    # the train phase's rollout engine: 32 slots, context 1024
    dict(name="qwen2.5-1.5b", nH=12, nKV=2, hd=128, bsz=128, R=32, max_len=1024),
    dict(name="qwen2.5-0.5b", nH=14, nKV=2, hd=64, bsz=128, R=16, max_len=4096),
    dict(name="small-page", nH=4, nKV=2, hd=16, bsz=16, R=8, max_len=512),
]
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
    kernel<dtype,head_dim>, registers, spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d((?:flash|paged)_[a-z_]+?kernel)I(f|13__nv_bfloat16)Li(\d+)E", line)
            name = (f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'},{m.group(3)}>"
                    if m else line.split("'")[1])
        elif "spill stores" in line and name:
            spill = re.findall(r"(\d+) bytes spill", line)
        elif "Used" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} registers, spills {'/'.join(spill)} bytes")
            name = None
    return out


def phase_build() -> None:
    """Both sources, one nvcc each, started together; each kernel's
    registers and spills from ptxas, and the dynamic shared memory of the
    flash kernels' blocks as their launches size it."""
    t0 = time.perf_counter()
    built = _build.build_all()
    wall_s = time.perf_counter() - t0
    rows = [dict(name=b.name, seconds=b.seconds, cached=b.cached, ptxas=_ptxas_summary(b.log))
            for b in built.values()]
    # ptxas reports static shared memory only; the kernels size theirs per launch
    smem = {f"hd{hd}": fa.smem_bytes(8192, hd) for hd in (16, 64, 128)}
    emit("build", kernels=rows, wall_s=wall_s,
         shared_memory=dict(paged_attention="dynamic, sized per launch",
                            flash_attention_T8192=smem))


def _paged_case(case: dict, dtype: torch.dtype, dev: torch.device, seed: int):
    """Random pools, a ragged block table with null-block tails, one slot
    with no valid row and one full slot."""
    R, nH, nKV, hd, bsz = case["R"], case["nH"], case["nKV"], case["hd"], case["bsz"]
    nb = -(-case["max_len"] // bsz)
    n_blocks = R * nb + 1
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = rng.integers(1, case["max_len"], R)
    lengths[0] = -1  # no valid row: output must be exactly 0
    lengths[1] = case["max_len"] - 1
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


def phase_kernel(dev: torch.device) -> float:
    """K3 against its plain version. Besides the sound reading, each case
    reads the kernel against a planted fault, the plain version with the
    first page of every multi-page slot dropped, and checks that the
    tolerance would catch it."""
    rows, worst = [], 0.0
    for i, case in enumerate(KERNEL_CASES):
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
            name = f"{case['name']} {str(dtype).split('.')[-1]}"
            rows.append(dict(case=case["name"], dtype=str(dtype).split(".")[-1],
                             max_abs_err=err, atol=atol, rtol=rtol, tol_ratio=ratio,
                             planted_fault_tol_ratio=fault_ratio,
                             empty_slot_zero=empty_zero))
            check(math.isfinite(ratio) and ratio <= 1.0,
                  f"kernel vs plain {name}: {ratio} x the tolerance (max abs err {err})")
            check(fault_ratio > 1.0, f"kernel {name}: a dropped page passes the tolerance")
            check(empty_zero, f"kernel {name}: slot with no valid row is not 0")
            worst = max(worst, err)
    # a table with no column: nothing to attend, the output is exactly 0
    none = pa.paged_attention(q, k, v, table[:, :0].contiguous(), valid[:, :0].contiguous())
    check(bool((none == 0).all().item()), "kernel: an empty table does not give 0")
    emit("kernel", cases=rows, max_abs_err=worst)
    return worst


# Run in a child process: a faulted launch leaves the CUDA context unusable.
_BAD_TABLE_PROBE = """
import json, torch
from areal_tpu_torch.ops import paged_attention as pa
dev = torch.device("cuda")
q = torch.randn(2, 4, 16, device=dev)
k = torch.randn(5, 16, 2, 16, device=dev)
table = torch.tensor([[1], [7]], dtype=torch.int32, device=dev)  # 7: no such block
valid = torch.ones(2, 16, dtype=torch.bool, device=dev)
valid[1] = False
out = pa.paged_attention(q, k, k, table, valid)
torch.cuda.synchronize()
res = dict(unread_bad_id_ok=bool((out[1] == 0).all()), faulted=False)
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
    kernel's launch; on a page without valid rows it is never read."""
    proc = subprocess.run(
        [sys.executable, "-c", _BAD_TABLE_PROBE], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=300,
    )
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    check(bool(lines), f"bad-table probe printed nothing (rc {proc.returncode}): {proc.stderr[-2000:]}")
    res = json.loads(lines[-1])
    emit("bad_table", **res)
    check(res["unread_bad_id_ok"], "kernel: a bad id on a page without valid rows changed the output")
    check(res["faulted"], "kernel: a bad block id on a valid page did not fault the launch")


# phase: K1/K2a/K2b against the plain version
FLASH_CASES = [
    dict(name="qwen2.5-1.5b", nH=12, nKV=2, hd=128, T=4096, n_seqs=40),
    dict(name="qwen2.5-7b", nH=28, nKV=4, hd=128, T=2048, n_seqs=12),
    dict(name="qwen2.5-0.5b", nH=14, nKV=2, hd=64, T=2048, n_seqs=16),
    dict(name="small", nH=4, nKV=2, hd=16, T=1000, n_seqs=9),
]
FLASH_PAD = 45  # pad-tail rows (segment -1): fully masked, o 0 and lse -1e30
# (a, rtol): an element passes when |x - ref| <= a * max|ref| + rtol * |ref|,
# ref the plain version on the f32-upcast inputs. f32: summation order
# only (the two sides sum up to a few thousand f32 products in different
# orders, ~1e-6 of the largest value). bf16: the kernels round each output
# to bf16 once (at most 2^-8 of itself: rtol), and the backward's delta =
# rowsum(dO * O) reads the bf16-rounded O where the plain version reads the
# f32 one, which moves ds, and so dq and dk, by a few 2^-9 of their scale:
# a = 2^-8, of which dq read at most 0.744 on an H100 (700 W).
# lse is f32 in both and takes the f32 tolerance.
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
    and dv. Each case also reads the kernels against a planted fault, the
    plain version with the causal diagonal excluded (query positions
    shifted by one), and checks that the tolerance would catch it."""
    rows, worst = [], {}
    cases = [(c, False) for c in FLASH_CASES] + [(FLASH_CASES[0], True)]
    for i, (case, chunk) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, ids, w_o, w_l = _flash_case(case, dtype, dev, SEED + 10 + i, chunk)
            xs = [t.to(dtype).requires_grad_() for t in (q, k, v)]
            got = _flash_run(fa.flash_attention_chunk, *xs, ids, w_o, w_l)
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
            for j, out in enumerate(("o", "lse", "dq", "dk", "dv")):
                a, rtol = LSE_TOL if out == "lse" else FLASH_TOL[dtype]
                x, r, f = got[j], ref[j], fault[j]
                if out == "lse":
                    x, r, f = x[live], r[live], f[live]
                err = (x.float() - r).abs().max().item()
                ratio = _scaled_ratio(x, r, a, rtol)
                fault_ratio = _scaled_ratio(x, f, a, rtol)
                row[out] = dict(max_abs_err=err, tol_ratio=ratio, fault_tol_ratio=fault_ratio)
                check(math.isfinite(ratio) and ratio <= 1.0,
                      f"flash {name} {out}: {ratio} x the tolerance (max abs err {err})")
                check(fault_ratio > 1.0, f"flash {name} {out}: the planted fault passes")
                worst[out] = max(worst.get(out, 0.0), err)
            check(dead_ok, f"flash {name}: a fully-masked row is not o 0, lse -1e30")
            rows.append(row)
            del xs, got, fs, ref, fault
    emit("flash_kernel", tol=dict(f32=FLASH_TOL[torch.float32],
                                  bf16=FLASH_TOL[torch.bfloat16], lse=LSE_TOL),
         cases=rows, max_abs_err=worst)
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


def phase_serve(dev: torch.device):
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False)  # layers_{i}/... tensors
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in params.values())
    engine = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **SERVE), device=dev)
    engine.set_model(params, cfg)
    del params
    torch.cuda.empty_cache()
    engine.initialize()
    kv_bytes = 2 * engine._k_pool.numel() * engine._k_pool.element_size()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED)

    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = 0
    steps0, tokens0, secs0 = engine.decode_steps, engine.decode_tokens, engine.decode_seconds
    stop_prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(*PROMPT_LEN, endpoint=True))).tolist()
    pre = engine.generate(ModelRequest(
        rid="pre", input_ids=stop_prompt,
        gconfig=GenerationHyperparameters(max_new_tokens=32, greedy=True),
    ))
    stop_id = pre.output_tokens[8]
    waves = []
    for version in (0, 1):
        if version == 1:
            # push layer 0 from the host (layer 1's weights), then bump
            donor = {k.split("/", 1)[1]: t.cpu() for k, t in engine.params.items() if k.startswith("layers_1/")}
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
    launches = pa.launches
    steps = engine.decode_steps - steps0
    # ---- end of the main path ----
    check(launches > 0 and launches == steps * cfg.num_hidden_layers,
          f"paged attention launches {launches} != decode steps {steps} x {cfg.num_hidden_layers}")
    dec_tokens = engine.decode_tokens - tokens0
    dec_secs = engine.decode_seconds - secs0
    ttft = [x for w in waves for x in w["ttft_ms"]]
    emit(
        "serve",
        model="Qwen2.5-7B", source=QWEN25_7B_SOURCE,
        layers=cfg.num_hidden_layers, dtype="bfloat16",
        weights_gb=weight_bytes / 1e9, kv_pool_gb=kv_bytes / 1e9,
        kv_pool_shape=list(engine._k_pool.shape), init_s=init_s,
        stop_id=stop_id,
        waves=[{k: v for k, v in w.items() if k != "ttft_ms"} for w in waves],
        decode_steps=steps, launches=launches,
        decode_tok_s=dec_tokens / dec_secs,
        decode_step_ms=dec_secs / steps * 1e3,
        wave_tok_s=[w["tokens"] / w["wall_s"] for w in waves],
        ttft_p50_ms=float(np.percentile(ttft, 50)),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        prefill_tokens=engine.prefill_tokens, prefill_s=engine.prefill_seconds,
    )
    return engine, cfg, launches


def _served_batch(engine, cfg, rng):
    """16 slots over the served pool: lengths from 64 + 128 to 1024 + 128,
    blocks from the engine's allocator (they hold the waves' KV)."""
    R = SERVE["max_running_requests"]
    alloc = engine._alloc
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, R) + 128
    for r in range(R):
        check(alloc.ensure(r, int(lengths[r]) + 1), "pool cannot back the step")
    nb = int(alloc.nblocks.max())
    dev = engine.device
    table = torch.from_numpy(alloc.table_slice(nb)).to(dev)
    positions = torch.as_tensor(lengths, device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, R), device=dev)
    return table, positions, tokens, lengths


def _attn_f32(q, k_pool, v_pool, table, valid):
    """The plain version with its attention in f32 (what the kernel
    computes), rounded back to q's dtype."""
    return pa.paged_attention_ref(
        q.float(), k_pool.float(), v_pool.float(), table, valid
    ).to(q.dtype)


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


def phase_profile(engine, cfg, batch: dict, steps: int = 4) -> None:
    """Where a decode step's time goes: `torch.profiler` over `steps` decode
    steps on the phase-5 batch, device time summed by kernel family, and
    the device busy share of the wall time. A measurement, not a check."""
    from torch.profiler import ProfilerActivity, profile

    table, lengths = batch["table"], batch["lengths"]
    dev = engine.device
    positions = torch.as_tensor(lengths, device=dev)
    tokens = torch.zeros(len(lengths), dtype=torch.long, device=dev)
    active = torch.ones(len(lengths), dtype=torch.bool, device=dev)

    def step():
        return decode_step_paged(engine.params, tokens, positions, engine._k_pool,
                                 engine._v_pool, table, cfg, active=active,
                                 layers=engine._layers)

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
    emit("profile", steps=steps, wall_ms_per_step=wall_ms / steps,
         profiled_wall_ms_per_step=profiled_ms / steps,
         device_ms_per_step={k: v / steps for k, v in families.items()},
         kernels_per_step=n_kernels / steps,
         # device time (profiled) over the unprofiled wall of the same steps
         device_busy_share=(busy / wall_ms) if busy else "not measured")


def _time(fn, iters: int) -> float:
    """ms per call, CUDA events around `iters` calls after a warm-up."""
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


def phase_paged_line(engine, cfg, batch: dict, launches: int, max_err: float) -> dict:
    """K3 timings at the serve phase's shapes: the 16 slots of phase 5
    over the served pool, rotating over 4 layers' pools so the KV rows
    come from HBM rather than a warm L2, as in a real decode step."""
    dev = engine.device
    table, lengths = batch["table"], batch["lengths"]
    R, nb = table.shape
    bsz, nKV, hd = engine._k_pool.shape[2:]
    nH = cfg.num_attention_heads
    layers = 4
    span = nb * bsz
    valid = (torch.arange(span, device=dev)[None, :] <= torch.as_tensor(lengths, device=dev)[:, None]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn((R, nH, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp = [engine._k_pool[i] for i in range(layers)]
    vp = [engine._v_pool[i] for i in range(layers)]
    calls = pa.launches
    ms = _time(lambda i: pa.paged_attention(q, kp[i % layers], vp[i % layers], table, valid), 200)
    plain_ms = _time(lambda i: pa.paged_attention_ref(q, kp[i % layers], vp[i % layers], table, valid), 20)
    check(pa.launches > calls, "timing did not launch the kernel")
    # library yardstick: SDPA over KV gathered into [R, nH, span, hd]
    # ahead of time (kv heads repeated for the query heads); not timed
    idx = table.reshape(-1).long()

    def gathered(pool):
        g = pool.index_select(0, idx).reshape(R, span, nKV, hd).permute(0, 2, 1, 3)
        return g.repeat_interleave(nH // nKV, dim=1).contiguous()

    ks = [gathered(p) for p in kp]
    vs = [gathered(p) for p in vp]
    q4 = q[:, :, None, :]
    mask = valid[:, None, None, :]
    library_ms = _time(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q4, ks[i % layers], vs[i % layers], attn_mask=mask), 200)
    rows = int((np.asarray(lengths) + 1).sum())
    nbytes = (2 * rows * nKV * hd * 2 + 2 * R * nH * hd * 2 + R * nb * 4 + R * span)
    flops = 4 * nH * hd * rows
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return dict(
        name="paged_attention", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, max_abs_err=max_err,
        max_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
        shape=dict(R=R, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb, valid_rows=rows,
                   dtype="bfloat16"),
    )


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


def _flash_counts() -> np.ndarray:
    return np.array([fa.launches_fwd, fa.launches_dq, fa.launches_dkv])


def _kernel_family(name: str) -> str:
    name = name.lower()
    if "paged_attn" in name:
        return "paged_attention"
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
        fused_lm_loss=True, mb_spec=MicroBatchSpec(max_tokens_per_mb=8192),
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
        c2 = _flash_counts()
        if it == TRAIN_ITERS - 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                stats = actor.ppo_update(batch)
                torch.cuda.synchronize()
                profiled_s = time.perf_counter() - t0
            fams, n_kernels, top_other = _device_ms_by_family(prof)
            row["profile"] = dict(
                wall_ms=profiled_s * 1e3, kernels=n_kernels,
                device_ms=fams, device_busy_share=sum(fams.values()) / (profiled_s * 1e3),
                top_other_ms=top_other,
            )
        else:
            stats = actor.ppo_update(batch)
        c3 = _flash_counts()
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
    seg = segment_ids_from_cu_seqlens(np.asarray(main_mb["cu_seqlens"]), int(main_mb["cu_seqlens"][-1]))
    engine.destroy()
    actor.destroy()
    return dict(launches=launches, segment_ids=seg, cfg=cfg)


def _flash_bounds(T: int, nH: int, nKV: int, hd: int, pairs: int) -> dict:
    """Least time of each kernel at these inputs: the bytes each must move
    (every input read once, every output written once; bf16 tensors, f32
    lse/dd, int32 ids) at the HBM rate, or its FLOPs over the valid pairs at
    the bf16 tensor-core rate, whichever is larger."""
    q = T * nH * hd * 2
    kv = T * nKV * hd * 2
    rows = T * nH * 4
    ids = 4 * T * 4
    work = {
        "flash_attention_fwd": (q + 2 * kv + ids + q + rows, 4),
        "flash_attention_bwd_dq": (2 * q + 2 * kv + 2 * rows + ids + q, 6),
        "flash_attention_bwd_dkv": (2 * q + 2 * kv + 2 * rows + ids + 2 * kv, 8),
    }
    out = {}
    for name, (nbytes, per_pair) in work.items():
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = per_pair * hd * nH * pairs / BF16_FLOPS * 1e3
        out[name] = dict(bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    return out


def phase_flash_line(dev: torch.device, train: dict) -> list[dict]:
    """K1, K2a and K2b at the train phase's micro-batch shape (the first
    micro-batch's packed segments, Qwen2.5-1.5B heads, bf16): each kernel
    wrapper against its plain version on the same inputs (f32-upcast),
    CUDA-event times of both, and `scaled_dot_product_attention` with the
    [T, T] segment-causal mask, forward and backward timed apart, as the
    library yardstick (timed here only; the port never calls it)."""
    cfg = train["cfg"]
    seg_np = train["segment_ids"]
    T = len(seg_np)
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    g = nH // nKV
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, do = rand(T, nH, hd), rand(T, nKV, hd), rand(T, nKV, hd), rand(T, nH, hd)
    seg = torch.as_tensor(seg_np, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    ids = (seg, seg, pos, pos)
    mq = fa.tile_meta(seg, pos, queries=True)
    mk = fa.tile_meta(seg, pos, queries=False)
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
    del ro, rl, rdq, rdk, rdv, f32, checks

    ms = {
        "flash_attention_fwd": _time(lambda i: fa.flash_fwd(q, k, v, *ids, mq, mk, sm), 20),
        "flash_attention_bwd_dq": _time(
            lambda i: fa.flash_bwd_dq(q, k, v, do, lse, dd, *ids, mq, mk, sm), 20),
        "flash_attention_bwd_dkv": _time(
            lambda i: fa.flash_bwd_dkv(q, k, v, do, lse, dd, *ids, mq, mk, sm), 20),
    }
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
    with torch.no_grad():
        lib_fwd = _time(lambda i: sdpa(q4, k4, v4, attn_mask=mask), 20)
    out4 = sdpa(q4, k4, v4, attn_mask=mask)
    lib_bwd = _time(lambda i: torch.autograd.grad(out4, (q4, k4, v4), do4, retain_graph=True), 20)
    varlen = _varlen_library_ms(q, k, v, do, seg_np, g)
    lib = {"flash_attention_fwd": lib_fwd, "flash_attention_bwd_dq": lib_bwd,
           "flash_attention_bwd_dkv": lib_bwd}
    lens = np.bincount(seg_np[seg_np >= 0])
    pairs = int((lens * (lens + 1) // 2).sum())
    bounds = _flash_bounds(T, nH, nKV, hd, pairs)
    rows = []
    for name in ms:
        rows.append(dict(
            name=name, route="cuda", source=FLASH_SOURCE, replaces=FLASH_REPLACES[name],
            launches=train["launches"][name], max_abs_err=errs[name], max_err=errs[name],
            tol=dict(a=a, rtol=rtol), tol_ratio=ratios[name], rounding=rounding[name],
            ms=ms[name], plain_ms=plain_ms[name], **bounds[name], library_ms=lib[name],
            library_call=("scaled_dot_product_attention forward, [T, T] mask"
                          if name.endswith("fwd") else
                          "scaled_dot_product_attention backward (dq, dk, dv in one call)"),
            library_varlen_ms=varlen["fwd" if name.endswith("fwd") else "bwd"],
            library_varlen_call=varlen["call"],
            shape=dict(T=T, nH=nH, nKV=nKV, hd=hd, segments=len(lens),
                       valid_pairs=pairs, dtype="bfloat16"),
        ))
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
        fwd = _time(lambda i: varlen_attn(q, kr, vr, cu, cu, mx, mx, window_size=causal), 20)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, kr, vr))
    out = varlen_attn(qg, kg, vg, cu, cu, mx, mx, window_size=causal)
    bwd = _time(lambda i: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True), 20)
    return dict(fwd=fwd, bwd=bwd, call="torch.nn.attention.varlen.varlen_attn "
                "(window_size=(-1, 0), kv heads repeated)")


def main() -> int:
    t0 = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    max_err = phase_kernel(dev)
    phase_bad_table()
    phase_flash_kernel(dev)
    engine, cfg, launches = phase_serve(dev)
    try:
        batch = phase_step(engine, cfg)
        phase_profile(engine, cfg, batch)
        paged = phase_paged_line(engine, cfg, batch, launches, max_err)
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    train = phase_train(dev)
    torch.cuda.empty_cache()
    # K3 runs in both paths: the serve phase's launches and the rollouts'
    paged["launches_by_path"] = dict(serve=launches, train=train["launches"]["paged_attention"])
    paged["launches"] = launches + train["launches"]["paged_attention"]
    rows = [paged, *phase_flash_line(dev, train)]
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
    sys.exit(main())
