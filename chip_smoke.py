"""Chip check of the PyTorch/CUDA port (`areal_tpu_torch`) on one H100.

Run from the repository root, with no arguments, on a machine with one
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, serves 16 concurrent
requests through `TorchDecodeEngine` at Qwen2.5-7B full width and depth
(seeded random weights, bf16), and checks the kernels really carried that
path. Each phase prints one JSON line; then come the `kernels` line, the
card's name and power limit, and last `{"ok": true, "device": ...}`. Any
failed check raises, and the script exits non-zero without that last line.
It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import GenerationHyperparameters, TorchDecodeConfig
from areal_tpu_torch.api.io_struct import ModelRequest
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.models.qwen2 import decode_step_paged, init_params
from areal_tpu_torch.models.smoke import QWEN25_7B, QWEN25_7B_SOURCE
from areal_tpu_torch.ops import _build
from areal_tpu_torch.ops import paged_attention as pa
from areal_tpu_torch.platforms import resolve_device

SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_SOURCE = "areal_tpu_torch/ops/csrc/paged_attention.cu"
KERNEL_REPLACES = "areal_tpu/ops/paged_attention.py:118"

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


def phase_build() -> None:
    built = _build.build_all()
    rows = []
    for b in built.values():
        ptxas = [
            " ".join(line.split())
            for line in b.log.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]
        rows.append(dict(
            name=b.name, seconds=b.seconds, cached=b.cached, ptxas=ptxas,
            # ptxas reports static shared memory only; the kernels size
            # theirs dynamically per launch
            shared_memory="dynamic, sized per launch",
        ))
    emit("build", kernels=rows)


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
    families = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    n_kernels = 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if not dev_us or ev.key.startswith(("aten::", "cuda", "Memcpy", "Memset")):
            continue
        n_kernels += ev.count
        name = ev.key.lower()
        fam = ("paged_attention" if "paged_attn" in name
               else "gemm" if any(s in name for s in ("gemm", "sm90", "cutlass", "nvjet"))
               else "other")
        families[fam] += dev_us / 1e3
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


def phase_kernels_line(engine, cfg, batch: dict, launches: int, max_err: float) -> None:
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
    print(json.dumps({"kernels": [dict(
        name="paged_attention", route="cuda", source=KERNEL_SOURCE,
        replaces=KERNEL_REPLACES, launches=launches, max_abs_err=max_err,
        max_err=max_err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
        shape=dict(R=R, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb, valid_rows=rows,
                   dtype="bfloat16"),
    )]}), flush=True)


def main() -> int:
    t0 = time.perf_counter()
    dev, smi = phase_device()
    phase_build()
    max_err = phase_kernel(dev)
    phase_bad_table()
    engine, cfg, launches = phase_serve(dev)
    try:
        batch = phase_step(engine, cfg)
        phase_profile(engine, cfg, batch)
        phase_kernels_line(engine, cfg, batch, launches, max_err)
    finally:
        engine.destroy()
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
