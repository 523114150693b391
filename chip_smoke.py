"""Chip check of the PyTorch/CUDA port (`areal_tpu_torch`) on one H100.

Run from the repository root, with no arguments, on a machine with one
Hopper card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each against its plain PyTorch version on the card, then drives the main
paths with seeded random weights in bf16: it serves 16 concurrent
requests through `TorchDecodeEngine` at Qwen2.5-7B's full width and depth,
drives the decode scheduler's defaults on such an engine, at 2 of its 28
layers as the spec and int8 engines below (GRPO groups
forked from one prefill under run-ahead 1 and 0, a multi-turn suffix
prefill, interrupt and parked-KV resume, stop strings, and the frequency
penalty on the spec engine), serves self-quoting traffic with
speculative decode (`spec_decode="ngram"`) beside a spec-off engine, serves the first traffic again from
an int8 engine (int8 weights and an int8 KV pool) and the speculative
traffic from an int8 spec engine, runs the port's GRPO entry point
(`areal_tpu_torch/examples/gsm8k_grpo.py`: the async loop of staleness
gate, RLVR episodes, decoupled-PPO update and weight push) on
`examples/configs/arith_grpo_smoke.yaml`, as a learning run beside its
lr=0 control, and at Qwen2.5-1.5B full width and depth, and runs three
colocated GRPO iterations (rollout, `compute_logp`, `compute_advantages`,
`ppo_update`, weight push) through `TorchPPOActor` at Qwen2.5-1.5B full
width (2 of its 28 layers). Then the trainer's persistence and the SFT path: the
port's SFT entry point (`areal_tpu_torch/examples/gsm8k_sft.py`) at
Qwen2.5-1.5B full width, 4 steps with an HF export, 2 steps
with a recovery point and a resume to 4 that must equal the uninterrupted
run bit for bit; `arith_sft_smoke.yaml` unchanged with its evaluations;
the GRPO entry point's recovery (a resume at step 2 serving the restored
weights); and the AEnt clamped entropy, in a GRPO run and at Qwen2.5-1.5B's
head against its dense version. Last, the decoupled path
(`allocation_mode=jax:d1+d1`): a decode server process
(`areal_tpu_torch/launcher/decode_server.py`, spawned by the local
launcher) serves the GRPO entry point's rollouts at Qwen2.5-1.5B full
width while the trainer runs in this process and pushes its
weights back over HTTP; then a dcn and a disk push of the same weights
must give the same greedy tokens, and the launcher runs the smoke yaml end
to end with both processes on the card. Then the customization layer's
other trainers: the PPO entry point (`areal_tpu_torch/examples/gsm8k_ppo.py`:
an actor and a value-head critic beside the decode engine) on
`arith_ppo_smoke.yaml` and at Qwen2.5-1.5B full width for both
models; the Bradley-Terry reward model (`TorchRWEngine`) at Qwen2.5-1.5B
and through its entry point (`examples/hhrlhf_rw.py`) on
`arith_rw_smoke.yaml`; and the multi-turn workflow through the GRPO entry
point on `arith_grpo_multiturn_smoke.yaml` and at Qwen2.5-1.5B, its retries
served from the decode engine's prefix registry. Last, checkpoints from
local paths: a Qwen2.5-1.5B checkpoint written sharded in bf16 by the
port's own writer, read back bit for bit by the GRPO entry point's actor
and its frozen KL reference policy (1 step on the countdown dataset), by
the offline evaluator (`areal_tpu_torch/evaluation/eval_and_aggregate.py`)
and by a decode server started with `--model-path`, whose greedy tokens
must equal an in-process engine's. Last, code and tool RL: the TIR entry
point (`areal_tpu_torch/examples/tir_math.py`) on `tir_math.yaml` with
its offline overrides at Qwen2.5-1.5B, its checkpoints scored by the
checkpoint watcher's evaluation jobs on the card; tool rounds of the TIR
workflow (a python tool and a calculator) whose decode logprobs must
agree with the trainer's; the verification service, the agent layer and
the OpenAI-style client, and the code evaluation. Then the memory
estimator (`areal_tpu_torch/utils/hbm.py`) beside the measured peaks of
five of those runs, and last the fault-injection harness
(`areal_tpu_torch/core/fault_injection.py`) on the GRPO path's kernels:
a colocated GRPO loop killed at four seams in turn (each trainer's
successor its resume) and past a torn checkpoint, resumed bit-equal to an
unfaulted oracle with every sample trained once. Then the host KV tier, the gather paths and fp pools in another
dtype, on the serve cell's weights at 2 of its 28 layers: 16 requests
parked, evicted to pinned host memory by a filler wave and promoted back
with no prefill, their streams bit-equal to a never-evicted engine's,
and the same requests under pool pressure, preempted slots offloaded and
promoted; a planted promotion fault that costs one prefill,
an int8 pool's blocks through the tier, and the workspace layout and the
paged gather path bit-equal to each other and beside the kernels; and
Qwen2.5-1.5B (2 layers) with bf16 weights over an f32 pool and f32
weights over a bf16 pool, on K3's and K4's mixed-dtype variants, which
the kernel phase holds against their plain versions first. Last, the
decode fleet on one card at Qwen2.5-1.5B's widths: port decode servers
in this process behind the port's router and supervisor, a remote
client routing GRPO groups through the router (streams equal to one
engine's), the fault-injection plan of two servers through the router
with a weight push whose commit fails, a drain-first scale-down under
traffic whose resumes are promotions on the survivor, and planted
supervisor transitions (a replace, a crash loop, a rollback, a replayed
migration); then the prefill/decode roles and the KV fabric: a mixed
trace handed off from a prefill replica to a decode replica by the
client (and the same trace on two unified replicas, for the ITL
readings), a block-aligned head forked from a registration that
diverges later, a run fetched from a sibling on a hint, a scale-up
warm-started from its peers, a scale-down drained as identities only,
and a re-role under traffic. Last, vision RLVR at Qwen2.5-VL-3B's
published widths: 16 image requests (a CLEVR image's 187 image tokens
each) and 8 text ones through one engine at full depth, their image
slots decoding with their m-rope deltas through the paged kernel and
the greedy ones held against a plain oracle (a dense prefill from
spliced embeddings and m-rope tables) beside two planted faults; the
tower read back bit for bit from a checkpoint the script writes;
`areal_tpu_torch/examples/clevr_grpo.py` on its docstring's offline
recipe; and the GRPO entry point with `workflow=vision_rlvr` on that
checkpoint. The PPO, multi-turn, checkpoint, decoupled and TIR runs trace
their last train step through the train engine's own trace window
(`AREAL_TPU_XPROF_DIR`). The decoupled, PPO, multi-turn, checkpoint and
TIR (t1, t2) runs, the train phase and the SFT entry point at
Qwen2.5-1.5B take 2 of its 28 layers, the chaos phase and the fleet 1,
the GRPO, decoupled and PPO runs at Qwen2.5-1.5B 2 steps, the checkpoint
and TIR runs 1, and the vision phase's checkpoint 2 of Qwen2.5-VL-3B's 36, so
that the script keeps within its time
limit; each phase's seconds are printed. It checks that the
kernels really carried each path. Each phase prints one JSON line; then
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

    python3 chip_smoke.py --decoupled

runs only the decoupled phase (after the device and build phases).

    python3 chip_smoke.py --trainers

runs only the ppo, rw and multi_turn phases (after the device and build
phases).

    python3 chip_smoke.py --hf-path

runs only the hf_path phase (after the device and build phases).

    python3 chip_smoke.py --chaos

runs only the chaos phase (after the device and build phases).

    python3 chip_smoke.py --tir

runs only the tir phase (after the device and build phases).

    python3 chip_smoke.py --kv-tier

runs only the mixed-dtype kernel checks and the kv_tier phase (after the
device and build phases), on the serve cell's weights made anew.

    python3 chip_smoke.py --fleet

runs only the fleet phase (after the device and build phases).

    python3 chip_smoke.py --vision

runs only the vision phase (after the device and build phases).

    python3 chip_smoke.py --qmm-sweep

times the bf16 K6 kernel at Qwen2.5-7B's four (K, N) shapes at T 16 and 80
over resident blocks per SM and pipeline depths (2 and 8 from copies of
its source built with another `QMM_STAGES`), beside the default plan.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import ctypes
import dataclasses
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch

from areal_tpu_torch.api.cli_args import (
    GenerationHyperparameters,
    GRPOConfig,
    InferenceEngineConfig,
    JaxEngineConfig,
    MicroBatchSpec,
    NameResolveConfig,
    NormConfig,
    OptimizerConfig,
    PPOActorConfig,
    TorchDecodeConfig,
    TrainEngineConfig,
    load_expr_config,
)
from areal_tpu_torch.api.io_struct import FinetuneSpec, ModelRequest, WeightUpdateMeta
from areal_tpu_torch.engine import sampling
from areal_tpu_torch.engine.ppo.actor import TorchPPOActor
from areal_tpu_torch.engine.torch_decode import TorchDecodeEngine
from areal_tpu_torch.examples import gsm8k_grpo
from areal_tpu_torch.dataset.arith import ArithTokenizer
from areal_tpu_torch.models.qwen2 import (
    ModelConfig,
    decode_step_paged,
    init_params,
    layer_views,
    named_shapes,
    prefill,
    segment_ids_from_cu_seqlens,
    verify_step_paged,
)
from areal_tpu_torch.ops.kv_quant import dequantize_kv, quantize_kv
from areal_tpu_torch.ops.quant import quantize_absmax
from areal_tpu_torch.models import hf_io
from areal_tpu_torch.models.qwen2_vl import (
    VisionConfig,
    forward_vision,
    init_vision_params,
    mrope_positions,
    mrope_table,
    patch_grid_coords,
    splice_image_embeds,
)
from areal_tpu_torch.models.smoke import (
    QWEN25_1_5B,
    QWEN25_1_5B_HF,
    QWEN25_1_5B_SOURCE,
    QWEN25_7B,
    QWEN25_7B_SOURCE,
    QWEN25_VL_3B_HF,
    QWEN25_VL_3B_SOURCE,
    QWEN3_30B_A3B_HF,
    QWEN3_30B_A3B_SOURCE,
    QWEN15_MOE_A27B_HF,
    QWEN15_MOE_A27B_SOURCE,
    smoke_model_config,
)
from areal_tpu_torch.reward.vqa import synthetic_vision_reward
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
    # the vision phase's (v1) engine: Qwen2.5-VL-3B's 16/2 heads (a group
    # of 8, the m16 tile's g + 8 rows exactly), 32 slots, context 4096
    dict(name="qwen2.5-vl-3b", nH=16, nKV=2, hd=128, bsz=128, R=32, max_len=4096),
    # the moe phase's engines: Qwen3-30B-A3B's 32/4 heads at (m1)'s 32
    # slots of 2048, and Qwen1.5-MoE-A2.7B's MHA 16/16 (a group of 1: one
    # live row of the m16 tile) at (m3)'s 16 slots
    dict(name="qwen3-30b-a3b", nH=32, nKV=4, hd=128, bsz=128, R=32, max_len=2048),
    dict(name="qwen1.5-moe", nH=16, nKV=16, hd=128, bsz=128, R=16, max_len=2048),
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


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": time.perf_counter() - _T0, **fields}),
          flush=True)


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
    kernel<dtype,head_dim>, registers, spill bytes; a kernel templated on
    its pool's type too (K3's and K4's f32-q first versions) reads
    kernel<dtype,pool,head_dim>. The flash tensor-core kernels
    (`*_mma_kernel<HD>`) take bf16 only."""
    out, name = [], None
    types = {"f": "f32", "13__nv_bfloat16": "bf16", None: "bf16"}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"\d((?:flash|paged|quant)_[a-z0-9_]+?kernel)I(f|13__nv_bfloat16)?"
                          r"(f|13__nv_bfloat16)?Li(\d+)E(?:Li(\d+)E)?", line)
            if m and m.group(1).startswith("quant_matmul"):
                # K6: <row fragments>
                name = f"{m.group(1)}<{m.group(4)}>"
            elif m and m.group(3):
                name = f"{m.group(1)}<{types[m.group(2)]},{types[m.group(3)]},{m.group(4)}>"
            elif m:
                name = f"{m.group(1)}<{types[m.group(2)]},{m.group(4)}>"
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
    # the variants over a pool in the other dtype (first versions for f32 q,
    # tensor-core kernels for bf16 q): built at every head dim, reported
    for kern in ("paged_attn_kernel<f32,bf16,", "paged_verify_kernel<f32,bf16,",
                 "paged_attn_f32pool_mma_kernel<", "paged_verify_f32pool_mma_kernel<"):
        found = [line for r in rows for line in r["ptxas"] if line.startswith(kern)]
        check(len(found) == 4, f"{kern}: {len(found)} instantiations in the ptxas report")
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
              pa.split_smem_bytes(W, g, hd, 128, pps, torch.int8 if quant else torch.bfloat16)
              for quant in (False, True)
              for W, g, hd, pps in ((5, 7, 128, 1), (5, 7, 128, 2), (5, 7, 128, 9), (9, 7, 128, 2),
                                    (16, 8, 128, 2), (16, 8, 128, 32), (9, 7, 64, 2))}
    # K3/K5a (bf16 q): q rows, each warp's K/V quarters (K5a: int8 quarters
    # and scales beside them), per-row offsets of a split; page 128
    decode = {f"{'K5a' if quant else 'K3'}_hd{hd}_pages{pps}":
              pa.split_smem_bytes(0, 7, hd, 128, pps, torch.int8 if quant else torch.bfloat16)
              for quant in (False, True) for hd, pps in ((128, 1), (128, 2), (128, 10), (64, 1))}
    # K3/K4 over an f32 pool (bf16 q): the f32 rows staged raw beside the
    # bf16 tiles they are rounded into; page 128
    f32_pool = {f"{'K4' if W else 'K3'}_W{W}_hd128_pages{pps}":
                pa.split_smem_bytes(W, 7, 128, 128, pps, torch.float32)
                for W, pps in ((0, 2), (0, 10), (5, 2), (5, 9))}
    emit("build", kernels=rows, wall_s=wall_s, k2a_ptxas=k2a, paged_ptxas=paged_ptxas,
         k6_ptxas=k6, k6_occupancy=k6_occupancy,
         shared_memory=dict(paged_attention_f32="dynamic, sized per launch",
                            paged_attention_bf16=decode, paged_verify_bf16=verify,
                            paged_f32_pool=f32_pool,
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
    # one child per dtype (the fault spoils its CUDA context), run side by side
    procs = {dtype: subprocess.Popen(
        [sys.executable, "-c", _BAD_TABLE_PROBE, dtype], cwd=Path(__file__).resolve().parent,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for dtype in ("float32", "bfloat16")}
    try:
        for dtype, proc in procs.items():
            out, err = proc.communicate(timeout=300)
            lines = [l for l in out.splitlines() if l.startswith("{")]
            check(bool(lines), f"bad-table probe ({dtype}) printed nothing "
                               f"(rc {proc.returncode}): {err[-2000:]}")
            results.append(json.loads(lines[-1]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
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
    # the vision phase's (v3) trainer: Qwen2.5-VL-3B's 16/2 heads, a
    # micro-batch of 4 image rollouts of ~290 tokens
    dict(name="qwen2.5-vl-3b", nH=16, nKV=2, hd=128, T=1216, n_seqs=4),
    # the moe phase's (m2) trainer: Qwen3-30B-A3B's 32/4 heads, a
    # micro-batch of 16 of its 32 rollouts of ~280 tokens; and Qwen1.5-MoE's
    # MHA 16/16 at the same micro-batch
    dict(name="qwen3-30b-a3b", nH=32, nKV=4, hd=128, T=4480, n_seqs=16),
    dict(name="qwen1.5-moe", nH=16, nKV=16, hd=128, T=4480, n_seqs=16),
]
FLASH_MISALIGNED_CASE = 4  # hd32-mqa
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
    q, k, v, ids, _, _ = _flash_case(FLASH_CASES[FLASH_MISALIGNED_CASE], torch.bfloat16, dev,
                                     SEED, False)
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


# The serve cell runs all of Qwen2.5-7B's 28 layers; the sched, spec and
# int8 serve cells, built on the same engine settings, run SERVE_LAYERS of
# them to keep the script within its time limit (their decode steps are
# host-bound: the launches per step scale with the depth); widths stay the
# published ones and every launch formula reads its own L. 2 since the
# vision phase came (4 since the fleet phase's (f5)-(f7), 14 before, 28
# before that)
SERVE_LAYERS = 2


def _serve_engine(dev: torch.device, settings: dict, layers: int = SERVE_LAYERS):
    """Qwen2.5-7B at full width, `layers` of its 28 layers (bf16, random
    weights from SEED) in a decode engine with `settings`."""
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False,  # layers_{i}/... tensors
                              num_hidden_layers=layers)
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
    engine, cfg, info = _serve_engine(dev, SERVE, layers=QWEN25_7B.num_hidden_layers)
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


# phase sched: the decode scheduler's defaults on the serve cell's engine
# (g) GRPO groups: one prompt per 64-token bucket, so the wave's prefills
# are one forward each; 2 greedy members, 1 sampled, 1 top-p per group
SCHED_LENS = (256, 512, 768, 1024)
SCHED_NEW = 256
SCHED_GCONFIGS = (dict(greedy=True), dict(greedy=True), dict(temperature=1.0),
                  dict(temperature=1.0, top_p=0.9))
# (m) multi-turn: turn 1's prompt and answer, turn 2's fresh tokens and answer
MT_PROMPT, MT_NEW1, MT_FRESH, MT_NEW2, MT_AGREE = 512, 128, 64, 128, 32
# The suffix prefill's KV rows against a full prefill of the whole turn-2
# prompt, per layer: max |a - b| over max |b|. The two are bf16 rows from
# different GEMM shapes, and the prefix the suffix attends to was written
# by the decode steps of turn 1 rather than by a prefill; a suffix off by
# one position (the planted fault) must read above it.
SUFFIX_KV_TOL = 2.0 ** -4
# (i) interrupt: prompts, new tokens, requests
INT_PROMPT, INT_NEW, INT_N = 512, 256, 4
# seconds any one request or wave of the phase may take before it fails
SCHED_TIMEOUT = 300


def _sched_counts(engine) -> dict:
    return dict(prefill_calls=engine.prefill_calls, prefills=engine._n_prefills,
                forks=engine._n_prefix_forks, inplace=engine._n_prefix_inplace,
                suffix_prefills=engine._n_suffix_prefills, decode_steps=engine.decode_steps,
                decode_tokens=engine.decode_tokens, decode_seconds=engine.decode_seconds,
                prefill_seconds=engine.prefill_seconds, verify=engine.verify_dispatches,
                runahead_discarded=engine.runahead_discarded)


def _delta(engine, c0: dict) -> dict:
    return {k: v - c0[k] for k, v in _sched_counts(engine).items()}


def _paused_wave(engine, reqs, interrupt: bool = False) -> list:
    """Serve `reqs` as one admission wave: queued while the engine is
    paused, then released together. With `interrupt`, pause again as soon
    as the wave's prefill is queued (so the pause lands on the first
    chunk's boundary, while the scheduler is still queueing that chunk)
    and `abort_all`: every request returns with stop reason "interrupt"
    and its KV parked."""
    engine.pause_generation()
    out: list = []
    t = threading.Thread(target=lambda: out.extend(asyncio.run(_serve_wave(engine, reqs))))
    t.start()
    deadline = time.monotonic() + 60
    while engine._request_q.qsize() < len(reqs):
        check(time.monotonic() < deadline, "requests never enqueued")
        time.sleep(0.001)
    calls = engine.prefill_calls
    engine.continue_generation()
    if interrupt:
        while engine.prefill_calls == calls:
            check(time.monotonic() < deadline, "the wave was never prefilled")
            time.sleep(0.0005)
        engine.pause_generation()
        n = engine.abort_all()
        engine.continue_generation()
        check(n == len(reqs), f"abort_all ended {n} of {len(reqs)}")
    t.join(SCHED_TIMEOUT)
    check(len(out) == len(reqs), f"the wave did not finish in {SCHED_TIMEOUT} s")
    return out


def _sched_groups(engine, reqs) -> tuple[list, dict]:
    """(g) on one engine: the wave, its counts, K3 launches, peak blocks."""
    engine._alloc.reset_peaks()
    c0 = _sched_counts(engine)
    pa.launches = 0
    t = time.perf_counter()
    resps = _paused_wave(engine, reqs)
    wall = time.perf_counter() - t
    launches = pa.launches
    d = _delta(engine, c0)
    L = engine.model_config.num_hidden_layers
    check(launches > 0 and launches == d["decode_steps"] * L,
          f"(g) K3 launches {launches} != decode steps {d['decode_steps']} x {L}")
    check(d["prefill_calls"] == len(SCHED_LENS) and d["prefills"] == len(SCHED_LENS),
          f"(g) {d['prefill_calls']} prefill calls for {d['prefills']} prefills, want 4 and 4")
    check(d["forks"] == len(reqs) - len(SCHED_LENS), f"(g) {d['forks']} forks, want 12")
    for req, resp in zip(reqs, resps):
        lp = np.asarray(resp.output_logprobs)
        check(np.isfinite(lp).all() and (lp <= 0).all(), f"{req.rid}: logprobs not finite and <= 0")
        check(resp.stop_reason == "length" and resp.output_len == SCHED_NEW,
              f"{req.rid}: {resp.stop_reason} after {resp.output_len} tokens")
    per = len(SCHED_GCONFIGS)
    for i in range(len(SCHED_LENS)):
        check(resps[i * per + 1].output_tokens == resps[i * per].output_tokens,
              f"(g) group {i}: the forked greedy member's tokens differ from the first's")
    ttft = [r.ttft * 1e3 for r in resps]
    return resps, dict(
        runahead=int(engine.config.decode_runahead_chunks), wall_s=wall, k3_launches=launches,
        decode_tok_s=d["decode_tokens"] / d["decode_seconds"],
        ttft_p50_ms=float(np.percentile(ttft, 50)), prefill_calls=d["prefill_calls"],
        prefill_s=d["prefill_seconds"], prefills=d["prefills"], forks=d["forks"],
        suffix_prefills=d["suffix_prefills"], decode_steps=d["decode_steps"],
        runahead_discarded=d["runahead_discarded"],
        peak_blocks=engine._alloc.peak_blocks,
        peak_blocks_without_sharing=engine._alloc.peak_table_blocks,
    )


def _suffix_rows(engine, turn2: list[int], plen: int):
    """The K and V rows [plen, len(turn2) - 1) of the slot registered for
    turn 2's conversation: [L, n, nKV, hd] each."""
    slot = engine._find_covering_donor(tuple(turn2[:-1]))
    check(slot is not None, "turn 2's conversation is not registered")
    bsz = engine._alloc.block_size
    pos = np.arange(plen, len(turn2) - 1)
    blocks = torch.as_tensor(engine._alloc.tables[slot][pos // bsz].astype(np.int64), device=engine.device)
    offs = torch.as_tensor(pos % bsz, device=engine.device)
    return engine._k_pool[:, blocks, offs], engine._v_pool[:, blocks, offs]


def _row_ratio(a, b) -> float:
    """Worst layer's max |a - b| over its max |b|."""
    a, b = a.float(), b.float()
    L = a.shape[0]
    return max(float((a[i] - b[i]).abs().max() / b[i].abs().max()) for i in range(L))


def _sched_multiturn(engine, ref, cfg, rng) -> dict:
    """(m) on `engine`: two conversations' turn 1, then turn 2 (turn 1's
    prompt + answer + fresh tokens) as a suffix prefill; its KV rows
    against a full prefill of turn 2, and its first tokens against
    `ref`'s run of turn 2 from a full prefill."""
    turn1 = [rng.integers(0, cfg.vocab_size, MT_PROMPT).tolist() for _ in range(2)]
    g1 = GenerationHyperparameters(max_new_tokens=MT_NEW1, greedy=True)
    r1 = _paused_wave(engine, [ModelRequest(rid=f"m{i}-1", input_ids=t, gconfig=g1)
                               for i, t in enumerate(turn1)])
    turn2 = [t + r.output_tokens + rng.integers(0, cfg.vocab_size, MT_FRESH).tolist()
             for t, r in zip(turn1, r1)]
    g2 = GenerationHyperparameters(max_new_tokens=MT_NEW2, greedy=True)
    c0 = _sched_counts(engine)
    r2 = _paused_wave(engine, [ModelRequest(rid=f"m{i}-2", input_ids=t, gconfig=g2)
                               for i, t in enumerate(turn2)])
    d = _delta(engine, c0)
    check(d["suffix_prefills"] == 2 and d["prefill_calls"] == 2 and d["prefills"] == 0,
          f"(m) turn 2: {d['suffix_prefills']} suffix prefills in {d['prefill_calls']} calls, "
          f"{d['prefills']} full prefills; want 2, 2, 0")
    plen = MT_PROMPT - 1 + MT_NEW1  # turn 1's registration: prompt + answer, less its last token
    rows, agree = [], []
    with torch.no_grad():
        for t2 in turn2:
            k, v = _suffix_rows(engine, t2, plen)
            _, fk, fv = prefill(engine.params, torch.as_tensor(t2[:-1], device=engine.device),
                                torch.arange(len(t2) - 1, device=engine.device), cfg,
                                with_logits=False, layers=engine._layers)
            P1 = len(t2) - 1
            rows.append(dict(
                k=_row_ratio(k, fk[:, plen:P1]), v=_row_ratio(v, fv[:, plen:P1]),
                k_layer0=_row_ratio(k[:1], fk[:1, plen:P1]),
                planted_k=_row_ratio(k[:, :-1], fk[:, plen + 1:P1]),
                planted_v=_row_ratio(v[:, :-1], fv[:, plen + 1:P1])))
    for r in rows:
        check(max(r["k"], r["v"]) <= SUFFIX_KV_TOL,
              f"(m) suffix KV rows off the full prefill's: {r}")
        check(min(r["planted_k"], r["planted_v"]) > SUFFIX_KV_TOL,
              f"(m) a suffix one position off reads within the tolerance: {r}")
    refs = _paused_wave(ref, [ModelRequest(rid=f"m{i}-ref", input_ids=t, gconfig=g2.new(
        max_new_tokens=MT_AGREE)) for i, t in enumerate(turn2)])
    for a, b in zip(r2, refs):
        agree.append(next((i for i, (x, y) in enumerate(zip(a.output_tokens, b.output_tokens))
                           if x != y), MT_AGREE))
    return dict(suffix_prefills=d["suffix_prefills"], prefill_calls=d["prefill_calls"],
                prefix_len=plen, suffix_len=len(turn2[0]) - 1 - plen, tol=SUFFIX_KV_TOL,
                rows=rows, agree_first_32_with_full_prefill=agree,
                prefill_s=d["prefill_seconds"])


def _sched_interrupt(engine, ref, cfg, rng) -> dict:
    """(i) on `engine`: 4 greedy requests interrupted after the first chunk
    and resumed (prompt + partial tokens, same rid) with no prefill, the
    joined streams against `ref`'s uninterrupted run; then one more
    interrupted request, a weight push, and its resume prefills again."""
    n_chunk = int(engine.config.new_tokens_per_chunk)
    prompts = [rng.integers(0, cfg.vocab_size, INT_PROMPT).tolist() for _ in range(INT_N)]
    g = GenerationHyperparameters(max_new_tokens=INT_NEW, greedy=True)
    first = _paused_wave(engine, [ModelRequest(rid=f"i{k}", input_ids=p, gconfig=g)
                                  for k, p in enumerate(prompts)], interrupt=True)
    for r in first:
        check(r.stop_reason == "interrupt" and r.output_len == n_chunk,
              f"(i) {r.stop_reason} after {r.output_len} tokens, want interrupt after {n_chunk}")
    c0 = _sched_counts(engine)
    resumed = _paused_wave(engine, [
        ModelRequest(rid=f"i{k}", input_ids=p + r.output_tokens,
                     gconfig=g.new(max_new_tokens=INT_NEW - r.output_len))
        for k, (p, r) in enumerate(zip(prompts, first))])
    d = _delta(engine, c0)
    check(d["prefill_calls"] == 0 and d["forks"] + d["inplace"] + d["suffix_prefills"] == 0,
          f"(i) the resume prefilled or forked: {d}")
    want = _paused_wave(ref, [ModelRequest(rid=f"iref{k}", input_ids=p, gconfig=g)
                              for k, p in enumerate(prompts)])
    joined = [a.output_tokens + b.output_tokens for a, b in zip(first, resumed)]
    equal = [j == w.output_tokens for j, w in zip(joined, want)]
    check(all(equal), f"(i) interrupted + resumed streams differ from the uninterrupted: {equal}")
    # a weight push between abort and resume: the resume prefills again
    p = rng.integers(0, cfg.vocab_size, INT_PROMPT).tolist()
    cut, = _paused_wave(engine, [ModelRequest(rid="ipush", input_ids=p, gconfig=g)], interrupt=True)
    engine.update_weights_from_tensor({"final_norm": engine.params["final_norm"]}, version=1)
    c1 = _sched_counts(engine)
    again = engine.generate(ModelRequest(rid="ipush", input_ids=p + cut.output_tokens,
                                         gconfig=g.new(max_new_tokens=INT_NEW - cut.output_len)),
                            timeout=SCHED_TIMEOUT)
    d1 = _delta(engine, c1)
    check(d1["prefill_calls"] == 1 and d1["prefills"] == 1,
          f"(i) the resume after a push ran {d1['prefill_calls']} prefill calls, want 1")
    check(again.output_versions == [1] * again.output_len, "(i) the resume after the push is not version 1")
    return dict(interrupted_at=[r.output_len for r in first], resume=d, joined_equal=sum(equal),
                resume_after_push=dict(prefill_calls=d1["prefill_calls"], prefills=d1["prefills"]))


def _sched_stop_strings(dev) -> dict:
    """(s) on the GRPO-loop (a) smoke decoder (f32, seeded random weights)
    with the port's `ArithTokenizer`: a stop string spanning two tokens
    cuts where the decoded output first holds it, also when a stop id of
    the request comes later in the stream."""
    tok = ArithTokenizer()
    cfg = smoke_model_config("float32", vocab_size=tok.vocab_size)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    engine = TorchDecodeEngine(TorchDecodeConfig(
        random_seed=SEED, context_length=256, max_running_requests=4, page_size=16,
        new_tokens_per_chunk=8, kv_cache_dtype="float32"), tokenizer=tok, device=dev)
    engine.set_model(params, cfg)
    engine.initialize()
    try:
        g = GenerationHyperparameters(max_new_tokens=48, greedy=True)
        for a in range(10, 100, 7):
            prompt = tok.encode(f"{a}+{a // 3}=")
            full = engine.generate(ModelRequest(input_ids=prompt, gconfig=g),
                                   timeout=SCHED_TIMEOUT).output_tokens
            text = [tok.decode([t]) for t in full]
            for j in range(len(full) - 2):
                s = "".join(text[j:j + 2])
                later = [t for t in full[j + 2:] if t not in full[:j + 2] and tok.decode([t])]
                if len(s) == 2 and s not in tok.decode(full[:j + 1]) and later:
                    break
            else:
                continue
            break
        else:
            raise AssertionError("(s) no greedy stream held a two-token stop string")
        cut = j + 2
        r1 = engine.generate(ModelRequest(input_ids=prompt, gconfig=g.new(stop=[s])),
                             timeout=SCHED_TIMEOUT)
        r2 = engine.generate(ModelRequest(input_ids=prompt, gconfig=g.new(
            stop=[s], stop_token_ids=[later[0]])), timeout=SCHED_TIMEOUT)
        for r in (r1, r2):
            check(r.stop_reason == "stop" and r.output_tokens == full[:cut],
                  f"(s) stop {s!r}: {r.stop_reason} after {r.output_len} tokens, want stop after {cut}")
        return dict(prompt=tok.decode(prompt), stream=tok.decode(full), stop=s, cut=cut,
                    later_stop_id=int(later[0]), reasons=[r1.stop_reason, r2.stop_reason])
    finally:
        engine.destroy()


def phase_sched(dev: torch.device) -> dict:
    """The decode scheduler's JAX defaults through `agenerate` on the serve
    cell's engine (Qwen2.5-7B, full width, SERVE_LAYERS of 28 layers, bf16, random weights
    from SEED, `decode_runahead_chunks` 1):

    (g) 4 prompts x 4 samples in one wave: 4 prefill forwards (one per
        bucket), 12 forks; the forked greedy member equals the first;
        K3 = decode steps x L; peak blocks beside the count without
        sharing. Then the same wave on an engine over the same weights
        with `decode_runahead_chunks=0`: tokens equal, logprobs within
        KERNEL_TOL, the bit-equal count printed.
    (m) two conversations: turn 2 (turn 1's prompt + answer + 64 fresh
        tokens) is one suffix prefill each; its KV rows against a full
        prefill of turn 2 within SUFFIX_KV_TOL (a one-off suffix must read
        above it); the first 32 tokens against a run from a full prefill.
    (i) 4 requests paused after their first chunk, `abort_all`, resumed
        under their rids with no prefill; joined streams equal an
        uninterrupted run's; after a weight push the resume prefills.
    (s) stop strings on the smoke decoder with `ArithTokenizer`.
    (f), the frequency penalty, runs on the spec engine (`_sched_freq`)."""
    engine, cfg, info = _serve_engine(dev, SERVE)
    sync = TorchDecodeEngine(TorchDecodeConfig(
        random_seed=SEED, decode_runahead_chunks=0, **SERVE), device=dev)
    sync.set_model(engine.params, cfg)
    sync.initialize()
    torch.cuda.empty_cache()
    try:
        rng = np.random.default_rng(SEED + 12)
        reqs = []
        for i, n in enumerate(SCHED_LENS):
            ids = rng.integers(0, cfg.vocab_size, n).tolist()
            reqs += [ModelRequest(rid=f"g{i}-{j}", input_ids=ids, gconfig=GenerationHyperparameters(
                max_new_tokens=SCHED_NEW, **gc)) for j, gc in enumerate(SCHED_GCONFIGS)]
        ahead, g1 = _sched_groups(engine, reqs)
        behind, g0 = _sched_groups(sync, reqs)
        a_tol, r_tol = KERNEL_TOL[torch.bfloat16]
        bit_equal = 0
        for req, a, b in zip(reqs, ahead, behind):
            check(a.output_tokens == b.output_tokens,
                  f"(g) {req.rid}: run-ahead 1 and 0 streams differ")
            x, y = np.asarray(a.output_logprobs), np.asarray(b.output_logprobs)
            check(bool(np.all(np.abs(x - y) <= a_tol + r_tol * np.abs(y))),
                  f"(g) {req.rid}: logprobs differ beyond KERNEL_TOL")
            bit_equal += a.output_logprobs == b.output_logprobs
        m = _sched_multiturn(engine, sync, cfg, rng)
        i = _sched_interrupt(engine, sync, cfg, rng)
    finally:
        engine.destroy()
        sync.destroy()
    del engine, sync
    torch.cuda.empty_cache()
    s = _sched_stop_strings(dev)
    return dict(model="Qwen2.5-7B", source=QWEN25_7B_SOURCE, init_s=info["init_s"],
                g=dict(runahead_1=g1, runahead_0=g0, streams=len(reqs),
                       bit_equal_streams=bit_equal, kernel_tol=[a_tol, r_tol]),
                m=m, i=i, s=s, k3_launches=g1["k3_launches"] + g0["k3_launches"])


def _sched_freq(engine, cfg) -> dict:
    """(f) on the spec serve engine (spec_decode="ngram"): a greedy
    request with frequency_penalty 1.0 alone under run-ahead 0, then
    beside three self-quoting spec requests in one wave under run-ahead 1:
    no verify forward runs while it is active (the penalty's counts evolve
    token by token, which one verify forward cannot reproduce), and its
    stream is the same in both. (It runs alone first: a slot keeps the
    counts an unpenalized request added beside a penalized one, as in the
    JAX engine, ROADMAP.md queue 3, so the wave must come second.)"""
    rng = np.random.default_rng(SEED + 13)
    spec = _spec_requests(rng, cfg.vocab_size)
    pen = GenerationHyperparameters(max_new_tokens=SPEC_MAX_NEW, greedy=True, frequency_penalty=1.0)
    engine.continue_generation()  # the spec step left the engine paused
    engine.config.decode_runahead_chunks = 0
    try:
        alone = engine.generate(ModelRequest(rid="pen0", input_ids=spec[3].input_ids, gconfig=pen),
                                timeout=SCHED_TIMEOUT)
    finally:
        engine.config.decode_runahead_chunks = 1
    c0 = _sched_counts(engine)
    t = time.perf_counter()
    got = _paused_wave(engine, spec[:3] + [ModelRequest(rid="pen1", input_ids=spec[3].input_ids,
                                                        gconfig=pen)])
    wall = time.perf_counter() - t
    d = _delta(engine, c0)
    check(d["verify"] == 0 and d["decode_steps"] > 0,
          f"(f) {d['verify']} verify forwards while a penalized request was active")
    check(alone.output_tokens == got[-1].output_tokens,
          "(f) the penalized stream differs between run-ahead 0 and 1")
    # the fallback ends with the penalty: a spec request alone verifies again
    engine.generate(spec[4], timeout=SCHED_TIMEOUT)
    check(engine.verify_dispatches > c0["verify"], "(f) no verify forward after the penalty")
    x, y = np.asarray(got[-1].output_logprobs), np.asarray(alone.output_logprobs)
    return dict(verify_forwards_while_penalized=d["verify"], decode_steps=d["decode_steps"],
                wall_s=wall, distinct_tokens=len(set(got[-1].output_tokens)),
                stream_equal=True, logprobs_bit_equal=bool(np.array_equal(x, y)),
                logprob_max_abs_diff=float(np.abs(x - y).max()))


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


def _k3_bound(rows: int, R: int, nb: int, bsz: int, nKV: int, nH: int, hd: int,
              quant: bool) -> tuple[float, str, float, float]:
    """The least time of one K3 (K5a on an int8 pool) launch with bf16 q
    over `rows` valid rows in all: (bound ms, "bytes" or "operations",
    bytes ms, operations ms). Bytes: each valid row's K and V per kv head
    (bf16, or int8 + an f32 scale), q and the output, the [R, nb] table
    and the [R, nb x bsz] mask, at HBM_BYTES_PER_S; operations: 4 nH hd
    per valid (query, row) pair at the bf16 peak."""
    row_bytes = 2 * (hd + 4) if quant else 2 * hd * 2
    nbytes = rows * nKV * row_bytes + 2 * R * nH * hd * 2 + R * nb * 4 + R * nb * bsz
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * nH * hd * rows / peak_flops(torch.bfloat16) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms


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
    bound_ms, bound_by, bytes_ms, ops_ms = _k3_bound(rows, R, nb, bsz, nKV, nH, hd, quant)
    return dict(
        name="paged_attention_q8" if quant else "paged_attention", route="cuda",
        source=KERNEL_SOURCE, replaces=Q8_REPLACES if quant else KERNEL_REPLACES,
        launches=launches, max_abs_err=max_err, max_err=max_err, **times,
        bound_ms=bound_ms, bound_by=bound_by, bytes_ms=bytes_ms, ops_ms=ops_ms,
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
    """The spec serve cell: Qwen2.5-7B at full width, SERVE_LAYERS of its
    28 layers (bf16, the
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
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False, num_hidden_layers=SERVE_LAYERS)
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
    # the wave's retired slots keep their blocks as donor material: free
    # them, so the slots below draw their blocks from the free list
    engine._invalidate_prefixes()
    table, positions, _, lengths = _served_batch(engine, cfg, rng, width=width)
    dev = engine.device
    R = len(lengths)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (R, width)), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)
    kp, vp = engine._k_pool, engine._v_pool
    # the last two slots hold no KV of their own (zero rows): there a query
    # attends only to the W rows of this forward, so the planted fault of
    # (5) shows on the logits. Over a few hundred served rows it moves
    # them by less than the 4-ulp floor; the first versions' batch had
    # two such slots only because the free list ran out of served blocks.
    for r in (R - 2, R - 1):
        own = table[r, : int(engine._alloc.nblocks[r])].long()
        kp[:, own] = 0
        vp[:, own] = 0
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
    pre-dequantized to bf16 (what the fp engine runs, over up to 4 layers), take
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
        lambda i: [qm.quant_matmul_ref(xs[n][16], *w[i % len(w)][n], torch.bfloat16)
                   for n in QMM_NAMES],
        10)
    # library yardsticks, on weights dequantized ahead of time (not timed)
    wd = [{n: (q.float() * s[None, :]).to(torch.bfloat16) for n, (q, s) in lw.items()}
          for lw in w[:4]]
    library = {T: _time_device(lambda i, T=T: [xs[n][T] @ wd[i % len(wd)][n] for n in QMM_NAMES],
                               50 if T <= 80 else 10) for T in QMM_LINE_T}
    int8pack = None
    if torch._C._dispatch_has_kernel_for_dispatch_key("aten::_weight_int8pack_mm", "CUDA"):
        wt = [{n: (q.t().contiguous(), s.to(torch.bfloat16)) for n, (q, s) in lw.items()}
              for lw in w[:4]]
        # timed as launched: the call synchronizes, so it cannot be queued
        int8pack = _time(lambda i: [torch._weight_int8pack_mm(xs[n][16], *wt[i % len(wt)][n])
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
    costliest kernels of the "other" family, from the kernel events of the
    profile's Chrome trace (`key_averages` builds a Python record of every
    event first: ~45 s after a traced rollout wait of ~200k kernels)."""
    with tempfile.TemporaryDirectory(prefix="trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    fams: dict[str, float] = collections.defaultdict(float)
    others: dict[str, list] = {}
    n = 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        n += 1
        ms = e.get("dur", 0.0) / 1e3
        fam = _kernel_family(e["name"])
        fams[fam] += ms
        if fam == "other":
            rec = others.setdefault(e["name"], [0.0, 0])
            rec[0] += ms
            rec[1] += 1
    top = sorted(((ms, c, name[:90]) for name, (ms, c) in others.items()), reverse=True)[:6]
    return dict(fams), n, top


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.element_size() == 2 else t.view(torch.int32)


def phase_train(dev: torch.device) -> dict:
    """One colocated GRPO loop at Qwen2.5-1.5B full width, CUT_LAYERS of its
    28 layers (bf16,
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

    cfg = dataclasses.replace(QWEN25_1_5B, scan_layers=False, remat=True,
                              num_hidden_layers=CUT_LAYERS)
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
    return dict(launches=launches, segment_ids=seg, cfg=cfg, peak_gb=peak_gb)


# phase: the port's GRPO entry point (`areal_tpu_torch/examples/gsm8k_grpo.py`)
GRPO_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "arith_grpo_smoke.yaml")
# the yaml's evaluator fires first at step 9 (its 10th step), between the
# executor's pause and resume, where it admits nothing and its wait runs
# into the 3600 s deadline (ROADMAP queue 3): every run stays below it
LOOP_STEPS = 9
# tests/test_grpo_learning.py's settings as overrides of the yaml, at the
# smoke geometry (its TINY has hd 8, which no kernel takes)
LEARN_STEPS = 12
LEARN_OVERRIDES = [
    "async_training=false", "gconfig.n_samples=8", "actor.group_size=8",
    "actor.adv_norm.group_size=8", "train_dataset.batch_size=8",
    "rollout.consumer_batch_size=8", "gconfig.max_new_tokens=2",
    "actor.ppo_n_minibatches=1", f"total_train_steps={LEARN_STEPS}",
    "evaluator.freq_steps=null",
]
LEARN_LR = 3e-2
# 2 of the 3 steps PR 10-18 ran (a reduction for the time budget, PERF.md
# section 4): the async overlap, the lag and the traced last step stay
FULL_STEPS = 2
FULL_OVERRIDES = [
    "train_dataset.batch_size=8", "gconfig.n_samples=4", "gconfig.max_new_tokens=256",
    "rollout.consumer_batch_size=8", "decode.context_length=512",
    "decode.max_running_requests=32", "decode.new_tokens_per_chunk=128",
    "decode.dtype=bfloat16", "decode.kv_cache_dtype=bfloat16", "actor.dtype=bfloat16",
    "actor.group_size=4", "actor.adv_norm.group_size=4", "actor.optimizer.lr=1e-4",
    f"total_train_steps={FULL_STEPS}",
    # the train phase's micro-batch and remat settings
    "actor.mb_spec.max_tokens_per_mb=8192", "actor.gradient_checkpointing=true",
]
LOOP_TIMINGS = ("rollout", "recompute_logp", "compute_advantage", "train_step",
                "update_weights")
# Qwen2.5-1.5B's depth (28 layers) in the train, SFT, decoupled (d1), PPO
# (p2), multi-turn (m2), checkpoint (h0-h3) and TIR (t1, t2) runs, cut to keep the
# script within its time limit (4 until the moe phase came); their widths
# stay the published ones and their launch formulas read their own L
CUT_LAYERS = 2


def dense_reward(prompt, completion, prompt_ids, completion_ids, **kwargs) -> float:
    """tests/test_grpo_learning.py's dense verifiable reward: the first
    generated token pulled to 16."""
    return 1.0 - abs(completion_ids[0] - 16) / 32.0


def parity_reward(prompt, completion, prompt_ids, completion_ids, **kwargs) -> float:
    """The train phase's `reward_of` under the reward-function contract."""
    return reward_of(completion_ids)


def _traced(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` under a device trace: (its result, the trace's
    device ms by kernel family, kernel count and costliest "other"
    kernels, and the call's wall ms up to a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fams, n_kernels, top_other = _device_ms_by_family(prof)
    total = sum(fams.values())
    return out, dict(wall_ms=wall_ms, kernels=n_kernels, device_ms=fams, device_total_ms=total,
                     device_busy_share=total / wall_ms, top_other_ms=top_other)


XPROF_FAMILIES = ("K1 flash_fwd", "K2a flash_bwd_dq", "K2b flash_bwd_dkv")


def _read_xprof(path: str) -> dict:
    """A Chrome trace of the env-gated window (`utils/perf_tracer.py`),
    read back: its `train_batch` ranges, and the device ms and launches by
    kernel family (`_kernel_family`) of the kernels launched within those
    spans, by the launching thread. The trainer's are those of the thread
    that opened the ranges and of autograd's backward threads (the threads
    that ran an `autograd::engine::evaluate_function` inside a range): they
    give the families, the launches and the ranges' busy share. The
    kernels that other threads launched inside the ranges are kept apart:
    the decode scheduler's (a thread that launches K3 anywhere in the
    trace) under "decode", any other thread's under "other_threads"."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_batch"
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in spans]

    def inside(ts):
        return any(a <= ts <= b for a, b in ranges)

    trainer = {e["tid"] for e in spans}
    backward = {e["tid"] for e in events if e.get("cat") == "cpu_op"
                and str(e.get("name", "")).startswith("autograd::engine::evaluate_function")
                and inside(e["ts"])}
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["ts"], e["tid"])
    kernels = []
    for e in events:
        if e.get("cat") == "kernel":
            at = launch.get(e.get("args", {}).get("correlation"))
            if at is not None:
                kernels.append((e, _kernel_family(e["name"]), *at))
    decode_tids = {tid for _, fam, _, tid in kernels if fam == "paged_attention"}
    by_part = {part: (collections.defaultdict(float), collections.Counter())
               for part in ("trainer", "decode", "other_threads")}
    for e, fam, ts, tid in kernels:
        if not inside(ts):
            continue
        part = ("trainer" if tid in trainer | backward
                else "decode" if tid in decode_tids else "other_threads")
        by_part[part][0][fam] += e["dur"] / 1e3
        by_part[part][1][fam] += 1
    device_ms, launches = by_part["trainer"]
    wall_ms = sum(b - a for a, b in ranges) / 1e3
    total = sum(device_ms.values())
    apart = {part: dict(device_ms=dict(ms), device_total_ms=sum(ms.values()),
                        kernels=sum(n.values()),
                        busy_share=sum(ms.values()) / wall_ms if wall_ms else None)
             for part, (ms, n) in by_part.items() if part != "trainer"}
    return dict(trace_events=len(events), train_batch_ranges=len(ranges), wall_ms=wall_ms,
                threads=dict(trainer=len(trainer), backward=len(backward - trainer),
                             decode=len(decode_tids)),
                device_ms=dict(device_ms), device_total_ms=total,
                device_busy_share=total / wall_ms if wall_ms else None,
                launches={k: launches[k] for k in XPROF_FAMILIES}, **apart)


@contextlib.contextmanager
def _xprof_window(tag: str, steps: str):
    """Run the enclosed entry point under the train engine's own env-gated
    trace window (`AREAL_TPU_XPROF_DIR`, `AREAL_TPU_XPROF_STEPS` = `steps`,
    the `train_batch` counts of the run's last step), reset before and
    flushed after. Records each `train_batch` that ran inside the window
    and its micro-batches; after the block, reads the trace back and checks
    that it holds those `train_batch` ranges with K1 = L x 2 (under remat)
    x trained mbs and K2a = K2b = L x trained mbs launched inside them,
    summed over the calls (each with its engine's L). The record is in the
    yielded dict's "xprof"."""
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.utils import perf_tracer

    seen: dict = dict(calls=[])
    train_batch = TorchTrainEngine.train_batch

    def train_batch_(self, *args, **kwargs):
        st = train_batch(self, *args, **kwargs)
        if perf_tracer._xprof_state["active"]:
            mc = self.model_config
            seen["calls"].append(dict(critic=bool(mc.is_critic), layers=mc.num_hidden_layers,
                                      remat=bool(mc.remat), n_mbs=int(st["n_mbs"]),
                                      owner=perf_tracer._xprof_state["owner"] == id(self)))
        return st

    target = tempfile.mkdtemp(prefix=f"xprof-{tag}-")
    keys = ("AREAL_TPU_XPROF_DIR", "AREAL_TPU_XPROF_STEPS")
    old = {k: os.environ.get(k) for k in keys}
    perf_tracer.reset_xprof_window()
    os.environ.update(AREAL_TPU_XPROF_DIR=target, AREAL_TPU_XPROF_STEPS=steps)
    TorchTrainEngine.train_batch = train_batch_
    try:
        yield seen
    finally:
        TorchTrainEngine.train_batch = train_batch
        path = perf_tracer.reset_xprof_window()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        check(path is not None, f"{tag}: the trace window never opened (steps {steps})")
        trace = _read_xprof(path)
        trace_bytes = os.path.getsize(path)
    finally:
        shutil.rmtree(target, ignore_errors=True)
    calls = seen["calls"]
    k2 = sum(c["layers"] * c["n_mbs"] for c in calls)
    want = {"K1 flash_fwd": sum(c["layers"] * (2 if c["remat"] else 1) * c["n_mbs"]
                                for c in calls),
            "K2a flash_bwd_dq": k2, "K2b flash_bwd_dkv": k2}
    seen["xprof"] = dict(steps=steps, calls=seen.pop("calls"), trace_bytes=trace_bytes,
                         formula=want, **trace)
    check(trace["train_batch_ranges"] == len(seen["xprof"]["calls"]) > 0,
          f"{tag}: {trace['train_batch_ranges']} train_batch ranges in the trace for "
          f"{len(seen['xprof']['calls'])} calls in the window")
    check(trace["launches"] == want,
          f"{tag}: launches inside train_batch {trace['launches']}, formula {want}")


def _last_step_window(config) -> str:
    """`AREAL_TPU_XPROF_STEPS` for a run's last step: its `train_batch`
    counts, one per minibatch."""
    n_mb = config.actor.ppo_n_minibatches
    lo = (config.total_train_steps - 1) * n_mb
    return f"{lo}-{lo + n_mb - 1}"


@contextlib.contextmanager
def _observe_dump():
    """While a run dumps recovery points: each `_state_save`'s seconds (the
    state's copy to the host, which waits behind the work queued on the
    stream, and its write) and the seconds of `torch.save` inside it."""
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    seen = []
    state_save, save = TorchTrainEngine._state_save, torch.save

    def save_(*args, **kwargs):
        t0 = time.perf_counter()
        save(*args, **kwargs)
        seen[-1]["torch_save_s"] = time.perf_counter() - t0

    def state_save_(self, *args, **kwargs):
        seen.append({})
        t0 = time.perf_counter()
        state_save(self, *args, **kwargs)
        seen[-1]["state_save_s"] = time.perf_counter() - t0
        seen[-1]["host_copy_s"] = seen[-1]["state_save_s"] - seen[-1]["torch_save_s"]

    TorchTrainEngine._state_save, torch.save = state_save_, save_
    try:
        yield seen
    finally:
        TorchTrainEngine._state_save, torch.save = state_save, save


@contextlib.contextmanager
def _observe_loop(trace_step: int | None = None):
    """While `main` runs: keep the decode engine it builds (its counters
    outlive `destroy`), read the engine's decode counters and the peak
    device memory as each `ppo_update` ends, and trace step `trace_step`'s
    `prepare_batch` (the rollout wait, with the decode steps that run in
    it) and `ppo_update` on the device, with the K3 bound of every decode
    step dispatched in the traced rollout wait (`_k3_bound` of the valid
    rows each slot's mask marks: its length + 1, growing by one a step on
    the active slots). Patches the classes' methods for the duration and
    restores them."""
    seen = dict(engines=[], updates=[], rollouts=0, traces={}, k3_bounds=None)
    init = TorchDecodeEngine.initialize
    prepare = TorchDecodeEngine.prepare_batch
    dispatch = TorchDecodeEngine._dispatch_chunk
    update = TorchPPOActor.ppo_update

    def initialize(self):
        seen["engines"].append(self)
        return init(self)

    def dispatch_chunk(self, active):
        lengths = self._slot_lengths.copy()
        rec = dispatch(self, active)
        if seen["k3_bounds"] is not None and rec is not None and not rec.spec_w:
            cfg = self.model_config
            pre = np.where(rec.active, self._slot_lengths - rec.n_chunk, lengths)
            for st in range(rec.n_chunk):
                rows = int((pre + 1).sum()) + st * int(rec.active.sum())
                seen["k3_bounds"].append(_k3_bound(
                    rows, len(pre), rec.nb, self._alloc.block_size, cfg.num_key_value_heads,
                    cfg.num_attention_heads, cfg.head_dim_, quant=False))
        return rec

    def prepare_batch(self, *args, **kwargs):
        step, seen["rollouts"] = seen["rollouts"], seen["rollouts"] + 1
        if step != trace_step:
            return prepare(self, *args, **kwargs)
        steps0 = self.decode_steps
        seen["k3_bounds"] = []
        out, trace = _traced(prepare, self, *args, **kwargs)
        bounds, seen["k3_bounds"] = seen["k3_bounds"], None
        trace["k3_bound_ms_per_launch"] = (
            float(np.mean([b[0] for b in bounds])) if bounds else None)
        trace["k3_bound_by"] = sorted({b[1] for b in bounds})
        seen["traces"]["rollout"] = dict(trace, decode_steps=self.decode_steps - steps0)
        return out

    def ppo_update(self, *args, **kwargs):
        eng = seen["engines"][-1]
        if len(seen["updates"]) == trace_step:
            steps0 = eng.decode_steps
            out, trace = _traced(update, self, *args, **kwargs)
            seen["traces"]["ppo_update"] = dict(trace, decode_steps=eng.decode_steps - steps0)
        else:
            out = update(self, *args, **kwargs)
        seen["updates"].append(dict(
            decode_tokens=eng.decode_tokens, decode_seconds=eng.decode_seconds,
            decode_steps=eng.decode_steps,
            max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9))
        return out

    TorchDecodeEngine.initialize, TorchDecodeEngine.prepare_batch = initialize, prepare_batch
    TorchDecodeEngine._dispatch_chunk = dispatch_chunk
    TorchPPOActor.ppo_update = ppo_update
    try:
        yield seen
    finally:
        TorchDecodeEngine.initialize, TorchDecodeEngine.prepare_batch = init, prepare
        TorchDecodeEngine._dispatch_chunk = dispatch
        TorchPPOActor.ppo_update = update


def _step_rows(tag: str, history: list, config, first_step: int = 0,
               trace_step: int | None = None, batch_check=None) -> tuple[list, int, int]:
    """Each step's record of a `main` run (the mean reward, the loop's
    timings, the version lag: the step's weight version minus the oldest
    version of a token it trains on, the micro-batches of the actor's and
    the reference policy's `compute_logp` and of `ppo_update`, and what
    `batch_check(batch)` returns), and the run's micro-batch totals: the
    untrained passes (both `compute_logp`s) and the trained ones."""
    steps, logp_mbs, train_mbs = [], 0, 0
    for i, rec in enumerate(history):
        st, batch = rec["stats"][0], rec["batch"]
        gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
        recompute = config.actor.recompute_logprob or config.actor.use_decoupled_loss
        n_logp = len(split_padded_tensor_dict_into_mb_list(
            batch, config.actor.mb_spec).mbs) if recompute else 0
        n_train = int(sum(d["grpo_actor/n_mbs"] for d in rec["stats"]))
        # the reference policy's forward on the same batch (its own mb_spec)
        n_ref = len(split_padded_tensor_dict_into_mb_list(
            batch, config.ref.mb_spec).mbs) if "ref_logp" in batch else 0
        logp_mbs, train_mbs = logp_mbs + n_logp + n_ref, train_mbs + n_train
        completions = {tuple(ids[b:n]) for ids, b, n in zip(
            batch["input_ids"].tolist(), batch["begin_of_answer"].tolist(),
            batch["attention_mask"].sum(-1).tolist())}
        row = dict(step=first_step + i, reward_mean=float(np.mean(batch["rewards"])),
                   distinct_completions=len(completions),
                   version_lag=int(first_step + i - batch["versions"][gen].min()),
                   samples=int(batch["input_ids"].shape[0]),
                   tokens=int(batch["attention_mask"].sum()), logp_mbs=n_logp,
                   ref_logp_mbs=n_ref, train_mbs=n_train, loss=st["grpo_actor/loss"],
                   entropy=st["grpo_actor/entropy"],
                   **{f"{k}_s": st.get(f"timeperf/{k}") for k in LOOP_TIMINGS})
        row["trained_tokens_per_s"] = row["tokens"] / row["train_step_s"]
        for k in ("checkpoint_for_recover", "ref_logp"):
            if f"timeperf/{k}" in st:
                row[f"{k}_s"] = st[f"timeperf/{k}"]
        if batch_check is not None:
            row.update(batch_check(batch))
        if i == trace_step:
            # the step's rollout and train_step times include the tracer's
            # own processing; `traced_step` holds the traced windows' walls
            row["traced"] = True
        check(math.isfinite(row["loss"]), f"{tag} step {i}: loss {row['loss']}")
        steps.append(row)
    return steps, logp_mbs, train_mbs


def _loop_run(dev, tag: str, overrides: list[str], model_config=None, reward_fn=None,
              trace_step: int | None = None, root: str | None = None,
              first_step: int = 0, yaml: str | None = None, batch_check=None,
              entry=None, xprof: bool = False) -> dict:
    """One run of the entry point (`entry`, `gsm8k_grpo.main` by default)
    on `yaml` (the smoke yaml by default)
    with `overrides`, its kernel counts set to 0 just before and read just
    after, and each step's record: the mean reward, the loop's timings, the
    version lag (the step's weight version minus the oldest version of a
    token it trains on), the micro-batches of `compute_logp` and of
    `ppo_update`, and `batch_check(batch)`. `root` (a temporary directory
    by default) is the run's file root, and `first_step` the global step a
    resumed run starts at. With `xprof`, the run's last step is traced
    through the train engine's env-gated window (`_xprof_window`)."""
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(tempfile.TemporaryDirectory())
        argv = ["--config", yaml or GRPO_YAML, *overrides, f"cluster.fileroot={root}",
                f"experiment_name=chip-smoke-{tag.split('/')[0]}"]
        config, _ = load_expr_config(argv, GRPOConfig)
        torch.cuda.reset_peak_memory_stats(dev)
        window = (_xprof_window(tag, _last_step_window(config)) if xprof
                  else contextlib.nullcontext({}))
        with _observe_loop(trace_step) as seen, _observe_dump() as dumps, window as xp:
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
            t0 = time.perf_counter()
            history = (entry or gsm8k_grpo.main)(argv, model_config=model_config,
                                                 reward_fn=reward_fn, device=dev)
            wall = time.perf_counter() - t0
            launches = dict(paged_attention=pa.launches, flash_attention_fwd=fa.launches_fwd,
                            flash_attention_bwd_dq=fa.launches_dq,
                            flash_attention_bwd_dkv=fa.launches_dkv)
            # ---- end of the main path ----
    engine = seen["engines"][0]
    L = engine.model_config.num_hidden_layers
    remat = engine.model_config.remat
    steps, logp_mbs, train_mbs = _step_rows(tag, history, config, first_step, trace_step,
                                            batch_check)
    for i, u in enumerate(seen["updates"]):
        prev = seen["updates"][i - 1] if i else dict(decode_tokens=0, decode_seconds=0.0)
        dt = u["decode_seconds"] - prev["decode_seconds"]
        steps[i].update(max_memory_allocated_gb=u["max_memory_allocated_gb"],
                        decode_tok_s=(u["decode_tokens"] - prev["decode_tokens"]) / dt
                        if dt else None)
    want = dict(paged_attention=L * engine.decode_steps,
                flash_attention_fwd=L * (logp_mbs + (2 if remat else 1) * train_mbs),
                flash_attention_bwd_dq=L * train_mbs, flash_attention_bwd_dkv=L * train_mbs)
    check(launches == want, f"{tag}: launches {launches}, formulas {want}")
    # each RLVR group's later members fork the first's prompt KV (or reuse
    # it in place); a multi-turn episode asks one answer a turn
    n = config.gconfig.n_samples
    admissions = dict(prefills=engine._n_prefills, forks=engine._n_prefix_forks,
                      inplace=engine._n_prefix_inplace, suffix_prefills=engine._n_suffix_prefills)
    if config.workflow == "rlvr":
        check(admissions["forks"] + admissions["inplace"] >= (n - 1) * admissions["prefills"],
              f"{tag}: {admissions} for groups of {n}")
    out = dict(run=tag, workflow=config.workflow, overrides=overrides, layers=L,
               dtype=engine.model_config.dtype,
               wall_s=wall, launches=launches, formulas=dict(
                   paged_attention="decode steps x L",
                   flash_attention_fwd="L x (logp mbs + ref logp mbs + (2 if remat else 1) x "
                                       "trained mbs)",
                   flash_attention_bwd_dq="L x trained mbs",
                   flash_attention_bwd_dkv="L x trained mbs"),
               decode_steps=engine.decode_steps, prefill_calls=engine.prefill_calls,
               admissions=admissions, runahead_discarded=engine.runahead_discarded,
               max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               max_version_lag=max(r["version_lag"] for r in steps), steps=steps)
    if seen["traces"]:
        out["traced_step"] = dict(step=trace_step, **seen["traces"])
    if "xprof" in xp:
        out["xprof"] = xp["xprof"]
    if dumps:
        out["dumps"] = dumps
    return out


def phase_grpo_loop(dev: torch.device) -> dict:
    """The port's GRPO entry point, `gsm8k_grpo.main`, on the card:

    (a) on `examples/configs/arith_grpo_smoke.yaml` unchanged but for the
        step count and the run's paths (the smoke decoder in f32, hd 16:
        the kernels' f32 routes): async rollouts behind the staleness gate,
        each step's version lag within `max_head_offpolicyness`;
    (b) the learning check of `tests/test_grpo_learning.py` through the
        same `main` (its dense reward and settings as overrides): the mean
        reward of the last 3 steps is above 0.9 and 0.05 above that of the
        first 3, and an lr=0 control run fails that check;
    (c) Qwen2.5-1.5B at its published widths and depth, bf16, random
        weights, with the train phase's reward: `FULL_STEPS` steps of 8
        prompts x 4 samples, 256 new tokens, async (no recovery point: the sft and
        grpo_recover phases dump and resume one).

    In every run K3 launches L per decode step and K1/K2a/K2b L per
    micro-batch pass (K1 twice per trained micro-batch under remat); the
    last step of (c) is traced on the device, its rollout wait and its
    update apart."""
    runs = {}
    runs["yaml"] = _loop_run(dev, "yaml", [f"total_train_steps={LOOP_STEPS}"])
    lag_cap = 2  # the yaml's rollout.max_head_offpolicyness
    check(runs["yaml"]["max_version_lag"] <= lag_cap,
          f"yaml run: version lag {runs['yaml']['max_version_lag']} > {lag_cap}")
    curves = {}
    for lr in (LEARN_LR, 0.0):
        tag = f"learn_lr{lr:g}"
        runs[tag] = _loop_run(dev, tag, LEARN_OVERRIDES + [f"actor.optimizer.lr={lr}"],
                              reward_fn=dense_reward)
        curves[lr] = [r["reward_mean"] for r in runs[tag]["steps"]]
    learned = {}
    for lr, c in curves.items():
        start, end = float(np.mean(c[:3])), float(np.mean(c[-3:]))
        learned[lr] = dict(start=start, end=end, rise=end - start,
                           passes=end - start > 0.05 and end > 0.9)
    check(learned[LEARN_LR]["passes"], f"lr {LEARN_LR}: no learning, rewards {curves[LEARN_LR]}")
    check(not learned[0.0]["passes"], f"lr 0 control 'learned': rewards {curves[0.0]}")
    full_cfg = dataclasses.replace(QWEN25_1_5B, remat=True)
    runs["full"] = _loop_run(dev, "full", FULL_OVERRIDES, model_config=full_cfg,
                             reward_fn=parity_reward, trace_step=FULL_STEPS - 1)
    check(runs["full"]["max_version_lag"] <= lag_cap,
          f"full run: version lag {runs['full']['max_version_lag']} > {lag_cap}")
    # 256 tokens drawn from a near-uniform 151,936-way distribution: two
    # samples can only coincide if they share their sampling keys
    for r in runs["full"]["steps"]:
        check(r["distinct_completions"] == r["samples"],
              f"full run step {r['step']}: {r['distinct_completions']} distinct "
              f"completions of {r['samples']}")
    rollout = runs["full"]["traced_step"]["rollout"]
    fam = rollout["device_ms"].get("paged_attention", 0.0)
    k3_steps = rollout["decode_steps"] * runs["full"]["layers"]
    k3_at_loop = dict(shape="R 32, 12/2 heads, hd 128, page 128, bf16",
                      bound_ms=rollout["k3_bound_ms_per_launch"], bound_by=rollout["k3_bound_by"],
                      device_ms_per_launch=fam / k3_steps if k3_steps else None)
    emit("grpo_loop", entry_point="areal_tpu_torch/examples/gsm8k_grpo.py:main",
         k3_at_loop=k3_at_loop,
         yaml="examples/configs/arith_grpo_smoke.yaml",
         full_model="Qwen2.5-1.5B", full_source=QWEN25_1_5B_SOURCE,
         learning=dict(check="end - start > 0.05 and end > 0.9 (means of the first and "
                             "last 3 steps)", lr=LEARN_LR, curves={str(k): v for k, v in curves.items()},
                       result={str(k): v for k, v in learned.items()}),
         runs=list(runs.values()))
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["full"]["launches"]}
    return dict(launches=total, by_run={t: r["launches"] for t, r in runs.items()},
                peak_gb=runs["full"]["max_memory_allocated_gb"])


# phases: checkpoints, recovery and the SFT entry point
# (`areal_tpu_torch/examples/gsm8k_sft.py`)
SFT_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "arith_sft_smoke.yaml")
# examples/configs/gsm8k_sft.yaml's model and optimizer settings on the
# synthetic set: 1024 items a step (4 steps to the 4096-item epoch, ~10k
# tokens, two 8192-token micro-batches), the evaluator off
SFT_OVERRIDES = [
    "train_dataset.batch_size=1024", "model.dtype=bfloat16",
    "model.gradient_checkpointing=true", "model.mb_spec.max_tokens_per_mb=8192",
    "model.optimizer.lr=1e-5", "model.optimizer.lr_scheduler_type=cosine",
    "model.optimizer.warmup_steps_proportion=0.01", "model.optimizer.weight_decay=0.05",
    "evaluator.freq_steps=null",
]
SFT_STEPS = 4
# free disk the full-size phase needs: A's HF export (f32, ~6.2 GB) and
# B's recovery point (~12.4 GB), with room to spare
SFT_DISK_BYTES = 24e9
SMOKE_SFT_STEPS = 30
SMOKE_SFT_EVAL_STEPS = [9, 19, 29]  # the yaml's evaluator.freq_steps: 10
FLASH_COUNTERS = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


@contextlib.contextmanager
def _observe_recover():
    """While an entry point runs: each `RecoverHandler.load`'s seconds and
    the step it restored, and with a decode engine the trainer's and the
    decode engine's versions and whether the decode engine serves the
    trainer's restored weights bit for bit, read right after the load's
    re-push."""
    from areal_tpu_torch.utils.recover import RecoverHandler

    seen = []
    load = RecoverHandler.load

    def load_(self, engine, *args, inference_engine=None, **kwargs):
        t0 = time.perf_counter()
        info = load(self, engine, *args, inference_engine=inference_engine, **kwargs)
        rec = dict(seconds=time.perf_counter() - t0,
                   step=None if info is None else info.last_step_info.global_step)
        if info is not None and inference_engine is not None:
            served = inference_engine.params
            rec.update(trainer_version=engine.get_version(),
                       decode_version=inference_engine.get_version(),
                       weights_equal=all(torch.equal(v, served[k])
                                         for k, v in engine.params.items()))
        seen.append(rec)
        return info

    RecoverHandler.load = load_
    try:
        yield seen
    finally:
        RecoverHandler.load = load


@contextlib.contextmanager
def _observe_sft():
    """While `gsm8k_sft.main` runs: keep each engine's final parameters
    (`destroy` drops them), the peak device memory after each step and the
    micro-batches of every `eval_batch`. Patches the methods for the
    duration and restores them."""
    from areal_tpu_torch.engine.sft.lm_engine import TorchLMEngine

    seen = dict(final=[], model_config=None, peak_gb=[], eval_mbs=0)
    destroy, train_lm, evaluate = TorchLMEngine.destroy, TorchLMEngine.train_lm, \
        TorchLMEngine.eval_batch

    def destroy_(self):
        seen["final"].append(self.params)  # dropped by the caller unless kept
        seen["model_config"] = self.model_config
        return destroy(self)

    def train_lm_(self, data):
        out = train_lm(self, data)
        seen["peak_gb"].append(torch.cuda.max_memory_allocated() / 1e9)
        return out

    def eval_batch_(self, input_, *args, **kwargs):
        seen["eval_mbs"] += len(split_padded_tensor_dict_into_mb_list(
            input_, self.config.mb_spec).mbs)
        return evaluate(self, input_, *args, **kwargs)

    TorchLMEngine.destroy, TorchLMEngine.train_lm = destroy_, train_lm_
    TorchLMEngine.eval_batch = eval_batch_
    try:
        yield seen
    finally:
        TorchLMEngine.destroy, TorchLMEngine.train_lm = destroy, train_lm
        TorchLMEngine.eval_batch = evaluate


def _sft_run(dev, tag: str, argv: list[str], model_config=None,
             keep_final: bool = False) -> dict:
    """One run of the SFT entry point, its flash counts set to 0 just before
    and read just after; the counts must equal L x (2 if remat else 1) x
    trained micro-batches + L x evaluated micro-batches for K1 and L x
    trained micro-batches for K2a and K2b. Peak memory is reported above
    what was allocated before the run (an earlier run's kept parameters);
    `keep_final` keeps the engine's final parameters on the device."""
    from areal_tpu_torch.examples import gsm8k_sft

    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    with _observe_sft() as seen, _observe_dump() as dumps, _observe_recover() as loads:
        # ---- the main path: counts to 0 just before, read just after ----
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        t0 = time.perf_counter()
        history = gsm8k_sft.main(argv, model_config=model_config, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(flash_attention_fwd=fa.launches_fwd,
                        flash_attention_bwd_dq=fa.launches_dq,
                        flash_attention_bwd_dkv=fa.launches_dkv)
        # ---- end of the main path ----
    cfg = seen["model_config"]
    L, remat = cfg.num_hidden_layers, cfg.remat
    train_mbs = int(sum(r["n_mbs"] for r in history))
    want = dict(flash_attention_fwd=L * ((2 if remat else 1) * train_mbs + seen["eval_mbs"]),
                flash_attention_bwd_dq=L * train_mbs, flash_attention_bwd_dkv=L * train_mbs)
    check(launches == want, f"sft {tag}: launches {launches}, formulas {want}")
    steps = []
    for r, peak in zip(history, seen["peak_gb"]):
        check(math.isfinite(r["loss"]), f"sft {tag} step {r['global_step']}: loss {r['loss']}")
        steps.append(dict(
            step=r["global_step"], loss=r["loss"], grad_norm=r["grad_norm"], lr=r["lr"],
            n_mbs=r["n_mbs"], tokens=r["n_tokens"], wall_s=r["timeperf/train_step"],
            trained_tokens_per_s=r["n_tokens"] / r["train_batch_time"], mfu=r["mfu"],
            max_memory_allocated_gb=peak - base_gb, save_s=r["timeperf/save"],
            checkpoint_for_recover_s=r["timeperf/checkpoint_for_recover"],
            **({"eval_loss": r["eval_loss"]} if "eval_loss" in r else {})))
    return dict(run=tag, wall_s=wall, layers=L, launches=launches, eval_mbs=seen["eval_mbs"],
                train_mbs=train_mbs, loads=loads, dumps=dumps, steps=steps,
                allocated_before_gb=base_gb, final=seen["final"][0] if keep_final else None)


def phase_sft(dev: torch.device) -> dict:
    """The port's SFT entry point at Qwen2.5-1.5B full width, its depth cut
    to CUT_LAYERS, bf16, on `arith_sft_smoke.yaml` with the overrides of
    `SFT_OVERRIDES`:

    A. 4 steps (the epoch) uninterrupted, `saver.freq_epochs=1`: the HF
       export fires at step 3;
    B. 2 steps, `recover.mode=auto`, `recover.freq_steps=2`,
       `recover.keep_last=1`: one recovery point, at global step 1;
    C. `recover.mode=resume` to 4 steps in B's file root: it must start at
       global step 2.

    Checks: C's losses at steps 2-3 and its final parameters equal A's bit
    for bit (no flash kernel adds with atomics, and the same kernels run on
    the same card); A's HF export, loaded into a fresh engine, equals A's
    final parameters bit for bit (bf16 -> F32 on disk -> bf16), and its
    size is the reckoned bytes (every parameter as f32, the tied head
    once); K1 = L x 2 x trained micro-batches (remat), K2a = K2b = L x
    trained micro-batches in every run. Everything is written under a
    temporary directory that the phase removes."""
    from areal_tpu_torch.api.cli_args import SFTConfig
    from areal_tpu_torch.api.io_struct import SaveLoadMeta
    from areal_tpu_torch.engine.sft.lm_engine import TorchLMEngine
    from areal_tpu_torch.models.qwen2 import named_shapes
    from areal_tpu_torch.utils.saver import Saver

    cfg = dataclasses.replace(QWEN25_1_5B, remat=True, num_hidden_layers=CUT_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sft_")
    try:
        free = shutil.disk_usage(tmp).free
        emit("sft_disk", path=tmp, free_bytes=free, needs_bytes=SFT_DISK_BYTES)
        check(free >= SFT_DISK_BYTES, f"sft: {free} bytes free under {tmp}, "
                                      f"{SFT_DISK_BYTES:.0f} needed")
        base = ["--config", SFT_YAML, *SFT_OVERRIDES, "experiment_name=chip-smoke-sft"]
        runs = {}
        argv_a = base + [f"cluster.fileroot={tmp}/A", f"total_train_steps={SFT_STEPS}",
                         "saver.freq_epochs=1"]
        runs["A"] = _sft_run(dev, "A", argv_a, cfg, keep_final=True)
        runs["B"] = _sft_run(dev, "B", base + [
            f"cluster.fileroot={tmp}/B", "total_train_steps=2", "recover.mode=auto",
            "recover.freq_steps=2", "recover.keep_last=1"], cfg)
        step_dirs = sorted(Path(tmp, "B", "recover").rglob("step-*"))
        check([d.name for d in step_dirs] == ["step-1"], f"sft B: recovery points {step_dirs}")
        dump_bytes = _dir_bytes(str(step_dirs[0]))
        runs["C"] = _sft_run(dev, "C", base + [
            f"cluster.fileroot={tmp}/B", f"total_train_steps={SFT_STEPS}",
            "recover.mode=resume"], cfg, keep_final=True)
        a, c = runs["A"], runs["C"]
        check([r["step"] for r in c["steps"]] == [2, 3],
              f"sft C: steps {[r['step'] for r in c['steps']]}, expected [2, 3]")
        check(c["loads"][0]["step"] == 1, f"sft C: loaded {c['loads']}")
        a_loss = [r["loss"] for r in a["steps"][2:]]
        c_loss = [r["loss"] for r in c["steps"]]
        check(a_loss == c_loss, f"sft: resumed losses {c_loss} != uninterrupted {a_loss}")
        differ = [k for k in a["final"] if not torch.equal(a["final"][k], c["final"][k])]
        check(not differ, f"sft: resumed final parameters differ from A's at {differ[:5]}")
        # A's HF export into a fresh engine (no optimizer)
        config, _ = load_expr_config(argv_a, SFTConfig)
        export = Path(Saver.get_save_checkpoint_path(config.saver, 0, SFT_STEPS - 1,
                                                     SFT_STEPS - 1))
        f = export / "model.safetensors"
        check(f.exists(), f"sft A: no HF export at {f}")
        with open(f, "rb") as fh:
            header = 8 + int.from_bytes(fh.read(8), "little")
        reckoned = sum(math.prod(shape) for shape in named_shapes(cfg).values()) * 4
        size = f.stat().st_size
        check(size - header == reckoned,
              f"sft A: export holds {size - header} tensor bytes, reckoned {reckoned}")
        model_cfg = dataclasses.replace(config.model, optimizer=None)
        fresh = TorchLMEngine(model_cfg, device=dev)
        fresh.model_config = cfg
        fresh.create_process_group()
        fresh.initialize(None, None)
        t0 = time.perf_counter()
        fresh.load(SaveLoadMeta(path=str(export), weight_format="hf"))
        torch.cuda.synchronize()
        hf_load_s = time.perf_counter() - t0
        differ = [k for k in a["final"] if not torch.equal(a["final"][k], fresh.params[k])]
        fresh.destroy()
        check(not differ, f"sft: the HF export reloads unequal at {differ[:5]}")
        for r in runs.values():
            r.pop("final")
        dump_s = runs["B"]["steps"][1]["checkpoint_for_recover_s"]
        emit("sft", entry_point="areal_tpu_torch/examples/gsm8k_sft.py:main", yaml=SFT_YAML,
             overrides=SFT_OVERRIDES, model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE,
             resumed_losses=c_loss, losses_equal=True, final_params_equal=True,
             hf_export=dict(path=str(f.relative_to(tmp)), bytes=size, header_bytes=header,
                            reckoned_tensor_bytes=reckoned, save_s=a["steps"][-1]["save_s"],
                            load_s=hf_load_s, reload_equal=True),
             recover=dict(dump_s=dump_s, dump_bytes=dump_bytes, dump_split=runs["B"]["dumps"],
                          load_s=c["loads"][0]["seconds"]),
             runs=list(runs.values()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in FLASH_COUNTERS}
    return dict(launches=total, by_run={t: r["launches"] for t, r in runs.items()})


def phase_sft_smoke(dev: torch.device) -> dict:
    """`arith_sft_smoke.yaml` unchanged through the SFT entry point (the
    smoke decoder in f32: the flash kernels' f32 routes): 30 steps, the
    evaluator at steps 9, 19 and 29 (`eval_batch`, K1 alone). The loss at
    the last step is below the first, every eval loss is finite, and the
    flash counts equal their formulas."""
    with tempfile.TemporaryDirectory() as root:
        run = _sft_run(dev, "smoke", ["--config", SFT_YAML, f"cluster.fileroot={root}",
                                      "experiment_name=chip-smoke-sft-smoke"])
    steps = run["steps"]
    check(len(steps) == SMOKE_SFT_STEPS, f"sft_smoke: {len(steps)} steps")
    evals = [r["step"] for r in steps if "eval_loss" in r]
    check(evals == SMOKE_SFT_EVAL_STEPS, f"sft_smoke: evaluations at {evals}")
    check(all(math.isfinite(r["eval_loss"]) for r in steps if "eval_loss" in r),
          "sft_smoke: eval loss not finite")
    check(steps[-1]["loss"] < steps[0]["loss"],
          f"sft_smoke: loss {steps[0]['loss']} -> {steps[-1]['loss']} did not fall")
    run.pop("final")
    emit("sft_smoke", yaml=SFT_YAML, first_loss=steps[0]["loss"], last_loss=steps[-1]["loss"],
         eval_losses={r["step"]: r["eval_loss"] for r in steps if "eval_loss" in r}, **run)
    return dict(launches=run["launches"])


def phase_grpo_recover(dev: torch.device) -> dict:
    """The GRPO entry point's recovery on the smoke yaml: 2 steps with
    `recover.mode=auto` and `recover.freq_steps=1`, then a resume to 4
    steps in the same file root. The resumed run restores global step 1
    and starts at step 2 with version 2 on both engines, the decode engine
    serves the trainer's restored weights bit for bit, the version lag stays
    within the yaml's 2, and each run's launches equal their formulas
    (`_loop_run`)."""
    over = ["evaluator.freq_steps=null", "recover.mode=auto", "recover.freq_steps=1"]
    with tempfile.TemporaryDirectory() as root, _observe_recover() as loads:
        first = _loop_run(dev, "grpo_recover/first", over + ["total_train_steps=2"], root=root)
        resumed = _loop_run(dev, "grpo_recover/resumed", over + ["total_train_steps=4"],
                            root=root, first_step=2)
    check(loads[0]["step"] is None, f"grpo_recover: the first run loaded {loads[0]}")
    rec = loads[1]
    check(rec["step"] == 1 and rec["trainer_version"] == 2 and rec["decode_version"] == 2,
          f"grpo_recover: resumed from {rec}")
    check(rec["weights_equal"], "grpo_recover: the decode engine does not serve the "
                                "trainer's restored weights")
    check([r["step"] for r in resumed["steps"]] == [2, 3],
          f"grpo_recover: resumed steps {[r['step'] for r in resumed['steps']]}")
    for run in (first, resumed):
        check(run["max_version_lag"] <= 2, f"{run['run']}: version lag {run['max_version_lag']}")
    emit("grpo_recover", load=rec, runs=[first, resumed])
    return dict(launches={k: first["launches"][k] + resumed["launches"][k]
                          for k in first["launches"]})


AENT_CLAMP = 0.2
AENT_T = 4096
# fused vs dense clamped entropy: the same bf16 operands, products exact in
# f32, sums in another order (over H and over the kept vocab), so the
# entropy (~11.9 for these logits, f32 ulp ~1e-6) agrees to 1e-4 absolute;
# the gradients come back in bf16, one rounding of an f32 value whose
# inputs carry the cotangent as bf16 hi + lo (2^-16): 2^-8 relative plus
# 2^-8 of the largest
AENT_TOL = dict(entropy=(1e-4, 0.0), grad=(2.0 ** -8, 2.0 ** -8))


def phase_aent(dev: torch.device) -> dict:
    """The AEnt clamped entropy: (a) a 3-step smoke-yaml GRPO run with
    `actor.entropy_clamp=0.2` through the entry point: losses and logged
    entropy finite, the trained loss's entropy the clamped one (every
    trained micro-batch calls `clamped_entropy_of` and none the unclamped
    entropy); (b) `chunked_clamped_entropy` forward and backward at
    Qwen2.5-1.5B's tied head (V 151936, H 1536, T 4096, bf16 hidden)
    against the dense f32 version, within `AENT_TOL`, with the peak memory
    of each."""
    from areal_tpu_torch.engine.ppo import actor as actor_mod
    from areal_tpu_torch.ops.fused_xent import chunked_clamped_entropy
    from areal_tpu_torch.utils.functional import clamped_softmax_entropy

    calls = dict(clamped=0, unclamped=0)
    clamped, unclamped = actor_mod.clamped_entropy_of, actor_mod.label_logprobs_entropy_of

    def clamped_(*a, **k):
        calls["clamped"] += 1
        return clamped(*a, **k)

    def unclamped_(*a, **k):
        calls["unclamped"] += 1
        return unclamped(*a, **k)

    actor_mod.clamped_entropy_of, actor_mod.label_logprobs_entropy_of = clamped_, unclamped_
    try:
        run = _loop_run(dev, "aent", ["evaluator.freq_steps=null", "total_train_steps=3",
                                      f"actor.entropy_clamp={AENT_CLAMP}"])
    finally:
        actor_mod.clamped_entropy_of, actor_mod.label_logprobs_entropy_of = clamped, unclamped
    entropy = [r["entropy"] for r in run["steps"]]
    check(all(math.isfinite(e) for e in entropy), f"aent: entropy {entropy}")
    train_mbs = sum(r["train_mbs"] for r in run["steps"])
    check(calls == dict(clamped=train_mbs, unclamped=0),
          f"aent: entropy calls {calls}, {train_mbs} trained micro-batches")

    cfg = QWEN25_1_5B
    V, H, T = cfg.vocab_size, cfg.hidden_size, AENT_T
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    hidden = torch.randn(T, H, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(V, H, generator=gen, device=dev) / math.sqrt(H)).to(torch.bfloat16)
    g = torch.randn(T, generator=gen, device=dev)
    out = {}
    for name in ("fused", "dense"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if name == "fused":
            h, wt = hidden.clone().requires_grad_(), w.clone().requires_grad_()
            ent = chunked_clamped_entropy(h, wt, head_is_vh=True, entropy_clamp=AENT_CLAMP)
        else:
            h, wt = hidden.float().requires_grad_(), w.float().requires_grad_()
            ent = clamped_softmax_entropy(h @ wt.t(), AENT_CLAMP)
        dh, dw = torch.autograd.grad(ent, (h, wt), g)
        torch.cuda.synchronize()
        out[name] = dict(ent=ent.detach(), dh=dh, dw=dw, s=time.perf_counter() - t0,
                         peak_gb=(torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        del h, wt, ent
    f, d = out["fused"], out["dense"]
    ratios = dict(
        entropy=_tol_ratio(f["ent"], d["ent"], *AENT_TOL["entropy"]),
        dhidden=_tol_ratio(f["dh"], d["dh"], AENT_TOL["grad"][0] * d["dh"].abs().max().item(),
                           AENT_TOL["grad"][1]),
        dhead=_tol_ratio(f["dw"], d["dw"], AENT_TOL["grad"][0] * d["dw"].abs().max().item(),
                         AENT_TOL["grad"][1]))
    for k, r in ratios.items():
        check(r <= 1.0, f"aent: chunked_clamped_entropy {k} at {r} x the tolerance")
    emit("aent", run=run, entropy_calls=calls, clamp=AENT_CLAMP,
         chunked=dict(V=V, H=H, T=T, token_chunk=128, tol=AENT_TOL, tol_ratio=ratios,
                      max_abs_err=(f["ent"] - d["ent"]).abs().max().item(),
                      entropy_mean=d["ent"].mean().item(),
                      fused_peak_gb=f["peak_gb"], dense_peak_gb=d["peak_gb"],
                      fused_s=f["s"], dense_s=d["s"]))
    del out, f, d
    return dict(launches=run["launches"])


# phase decoupled: the DECOUPLED allocation (`allocation_mode=jax:d1+d1`), a
# decode server process (`areal_tpu_torch/launcher/decode_server.py`, K3)
# beside the trainer (K1/K2a/K2b) on the same card
DECOUPLED_ALLOC = "jax:d1+d1"
# loop cell (c)'s settings
DECOUPLED_OVERRIDES = FULL_OVERRIDES
DECOUPLED_STEPS = 2  # (d2): the launcher end to end on the unchanged yaml
PROBE_REQUESTS, PROBE_NEW = 8, 64
PROBE_PROMPT_LEN = (32, 256)
SERVER_TIMEOUT = 300
# the ModelConfig fields `--scratch-model` carries: the geometry
GEOMETRY_KEYS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
                 "num_attention_heads", "num_key_value_heads", "head_dim", "rope_theta",
                 "rms_norm_eps", "tie_word_embeddings", "max_position_embeddings",
                 "model_type", "qkv_bias", "hidden_act")


def _scratch_model_json(cfg) -> str:
    return json.dumps({k: getattr(cfg, k) for k in GEOMETRY_KEYS})


def _server_get(addr: str, endpoint: str) -> dict:
    from areal_tpu_torch.utils.http import request_with_retry

    return request_with_retry(addr, endpoint, method="GET", max_retries=1, timeout=60)


def _server_post(addr: str, endpoint: str, payload: dict) -> dict:
    from areal_tpu_torch.utils.http import request_with_retry

    return request_with_retry(addr, endpoint, payload=payload, max_retries=1, timeout=600)


def _card_memory_used() -> str:
    """The card's memory in use by every process on it (`nvidia-smi`; it
    cannot tell the processes apart in a sandbox, where each reads as pid
    1 with the card's total)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not measured ({e!r})"
    return r.stdout.strip() if r.returncode == 0 else "not measured"


@contextlib.contextmanager
def _observe_decoupled():
    """While `main` runs DECOUPLED: keep the trainer past `main` (its
    `destroy` is deferred to the caller) and the `RemoteInfEngine` it
    builds (its weight-sync counters outlive `destroy`)."""
    from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine

    seen = dict(actors=[], clients=[])
    destroy, init = TorchPPOActor.destroy, RemoteInfEngine.initialize

    def initialize(self, *args, **kwargs):
        seen["clients"].append(self)
        return init(self, *args, **kwargs)

    TorchPPOActor.destroy = lambda self: seen["actors"].append(self)
    RemoteInfEngine.initialize = initialize
    try:
        yield seen
    finally:
        TorchPPOActor.destroy, RemoteInfEngine.initialize = destroy, init


def _probe_wave(addr: str, client, prompts: list[list[int]], tag: str) -> list:
    """`prompts` as greedy requests of PROBE_NEW tokens released as one
    admission wave: the server paused, every request queued, then let go
    (so both probes prefill and decode the same batches)."""
    from areal_tpu_torch.api.cli_args import GenerationHyperparameters as G

    _server_post(addr, "/pause_generation", {"abort": False})
    reqs = [ModelRequest(rid=f"{tag}-{i}", input_ids=p,
                         gconfig=G(greedy=True, max_new_tokens=PROBE_NEW))
            for i, p in enumerate(prompts)]
    out: dict = {}

    async def run_all():
        return await asyncio.gather(*[client.agenerate(r) for r in reqs])

    t = threading.Thread(target=lambda: out.update(resps=asyncio.run(run_all())), daemon=True)
    t.start()
    deadline = time.monotonic() + 120
    while _server_get(addr, "/metrics")["queued_requests"] < len(reqs):
        check(time.monotonic() < deadline and t.is_alive(), f"{tag}: requests not queued")
        time.sleep(0.05)
    _server_post(addr, "/continue_generation", {})
    t.join(timeout=600)
    check(not t.is_alive() and "resps" in out, f"{tag}: the probe wave did not finish")
    return out["resps"]


def _server_pause_read(addr: str) -> dict:
    """/metrics with the server paused (no pass in progress, so the launch
    counters are whole), then resumed."""
    _server_post(addr, "/pause_generation", {"abort": True})
    m = _server_get(addr, "/metrics")
    _server_post(addr, "/continue_generation", {})
    return m


def _decoupled_loop(dev, root: str) -> dict:
    """(d1): the trainer here, the server spawned by `LocalLauncher`."""
    from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
    from areal_tpu_torch.launcher import local
    from areal_tpu_torch.utils import name_resolve

    full_cfg = dataclasses.replace(QWEN25_1_5B, remat=True, num_hidden_layers=CUT_LAYERS)
    L = full_cfg.num_hidden_layers
    argv = ["--config", GRPO_YAML, *DECOUPLED_OVERRIDES, f"cluster.fileroot={root}",
            "cluster.name_resolve.type=nfs", f"cluster.name_resolve.nfs_record_root={root}/nr",
            f"allocation_mode={DECOUPLED_ALLOC}", "experiment_name=chip-smoke-decoupled"]
    config, _ = load_expr_config(argv, GRPOConfig)
    name_resolve.reconfigure(config.cluster.name_resolve)
    launcher = local.LocalLauncher(config.experiment_name, config.trial_name, root)
    t_spawn = time.perf_counter()
    handle = launcher.spawn_decode_server(
        model_path=config.tokenizer_path,
        extra_args=local._server_args(config, dev) + [
            "--scratch-model", _scratch_model_json(full_cfg)],
        env=name_resolve.to_env(config.cluster.name_resolve), timeout=SERVER_TIMEOUT)
    job, addr = handle.job, handle.addr
    spawn_s = time.perf_counter() - t_spawn
    try:
        m0 = _server_get(addr, "/metrics")["kernel_launches"]
        check(all(v == 0 for v in m0.values()), f"d1: the server launched before the run: {m0}")
        torch.cuda.reset_peak_memory_stats(dev)
        with _observe_decoupled() as seen, _xprof_window(
                "d1", _last_step_window(config)) as xp:
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
            t0 = time.perf_counter()
            history = gsm8k_grpo.main(argv, model_config=full_cfg, reward_fn=parity_reward,
                                      device=dev)
            wall = time.perf_counter() - t0
            trainer = dict(paged_attention=pa.launches, flash_attention_fwd=fa.launches_fwd,
                           flash_attention_bwd_dq=fa.launches_dq,
                           flash_attention_bwd_dkv=fa.launches_dkv)
            server = _server_pause_read(addr)
            # ---- end of the main path ----
        trainer_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        trainer_reserved_gb = torch.cuda.max_memory_reserved(dev) / 1e9
        card_memory_used = _card_memory_used()
        actor, client = seen["actors"][0], seen["clients"][0]
        steps, logp_mbs, train_mbs = _step_rows("decoupled", history, config)
        lag_cap = config.rollout.max_head_offpolicyness
        check(max(r["version_lag"] for r in steps) <= lag_cap,
              f"decoupled: version lag {[r['version_lag'] for r in steps]} > {lag_cap}")
        k = server["kernel_launches"]
        launches = dict(trainer, paged_attention=k["paged_attention"])
        want = dict(paged_attention=L * k["decode_steps"],
                    flash_attention_fwd=L * (logp_mbs + 2 * train_mbs),
                    flash_attention_bwd_dq=L * train_mbs, flash_attention_bwd_dkv=L * train_mbs)
        check(launches == want, f"decoupled: launches {launches}, formulas {want}")
        check(trainer["paged_attention"] == 0, "decoupled: the trainer launched K3")
        check(k["flash_attention_fwd"] == 0 and k["quant_matmul"] == 0,
              f"decoupled: the server launched {k}")
        ws = server["weight_sync"]
        check(ws["n_pushes"] == FULL_STEPS, f"decoupled: {ws['n_pushes']} pushes committed")
        # one more push of the final weights, greedy probes, the trainer's
        # logprobs of them; then a disk push of the same weights and the
        # same probes again
        probe = RemoteInfEngine(config.rollout)
        probe.initialize(addr=[addr])
        try:
            meta = WeightUpdateMeta(type="dcn")
            actor.connect_engine(probe, meta)
            actor.set_version(FULL_STEPS + 1)
            t_push = time.perf_counter()
            actor.update_weights(meta)
            push_s = time.perf_counter() - t_push
            check(_server_get(addr, "/health")["version"] == FULL_STEPS + 1,
                  "d1: the last push's version is not served")
            rng = np.random.default_rng(SEED + 30)
            prompts = [rng.integers(0, full_cfg.vocab_size, int(n)).tolist()
                       for n in rng.integers(*PROBE_PROMPT_LEN, PROBE_REQUESTS)]
            resps = _probe_wave(addr, probe, prompts, "probe-dcn")
            check(all(r.output_versions == [FULL_STEPS + 1] * PROBE_NEW for r in resps),
                  "d1: probe tokens not stamped with the pushed version")
            batch = _grpo_batch(prompts, resps)
            batch["prox_logp"] = actor.compute_logp(batch)
            lm = batch["loss_mask"][:, 1:] > 0
            d = batch["prox_logp"][:, :-1][lm] - batch["logprobs"][:, 1:][lm]
            logp = dict(tokens=int(lm.sum()), max_abs_diff=float(np.abs(d).max()),
                        mean_abs_diff=float(np.abs(d).mean()))
            check(logp["max_abs_diff"] <= LOGP_MAX_ABS_DIFF
                  and logp["mean_abs_diff"] <= LOGP_MEAN_ABS_DIFF,
                  f"d1: server vs trainer logprobs after the dcn push: {logp}")
            disk = WeightUpdateMeta(type="disk", path=os.path.join(root, "disk_push"))
            t_disk = time.perf_counter()
            actor.update_weights(disk)
            disk_s = time.perf_counter() - t_disk
            resps2 = _probe_wave(addr, probe, prompts, "probe-disk")
            check([r.output_tokens for r in resps2] == [r.output_tokens for r in resps],
                  "d1: the disk push's greedy tokens differ from the dcn push's")
            after = _server_get(addr, "/metrics")
            server_peak = after["device_memory_peak"]
            check(server_peak is not None and server_peak["max_allocated_bytes"] > 0,
                  f"d1: the server reports no device memory peak: {server_peak}")
        finally:
            probe.destroy()
            actor.destroy()
        client_sync = client.get_metrics()
    finally:
        launcher.stop_all()
        name_resolve.reconfigure(NameResolveConfig(type="memory"))
    log = Path(job.log_path).read_text()
    check("Traceback" not in log, "d1: the server's log holds a Traceback")
    check(job.proc.poll() is not None, "d1: the server process is still running")
    host, port = addr.rsplit(":", 1)
    with socket.socket() as s:
        check(s.connect_ex((host, int(port))) != 0, f"d1: {addr} still accepts connections")
    rows = [dict(step=r["step"], version_lag=r["version_lag"],
                 **{f"{t}_s": r[f"{t}_s"] for t in LOOP_TIMINGS}) for r in steps]
    busy = server["device_busy_s"]
    return dict(
        run="d1", model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE, layers=L,
        allocation_mode=DECOUPLED_ALLOC, overrides=DECOUPLED_OVERRIDES, wall_s=wall,
        server_spawn_s=spawn_s, launches=launches, xprof=xp["xprof"], formulas=dict(
            paged_attention="server decode steps x L (read from its /metrics)",
            flash_attention_fwd="L x (logp mbs + 2 x trained mbs)",
            flash_attention_bwd_dq="L x trained mbs", flash_attention_bwd_dkv="L x trained mbs"),
        server_decode_steps=k["decode_steps"], server_prefill_calls=k["prefill_calls"],
        steps=rows, update_weights=dict(
            client=client_sync, server=ws,
            last_push=dict(dcn_s=push_s, disk_s=disk_s,
                           server_after=after["weight_sync"])),
        server_decode_tok_s=server["generated_tokens_total"] / busy if busy else None,
        server_device_idle_frac=server["device_idle_frac"],
        server_itl_p50_ms=server["itl_p50_ms"], logp=logp,
        trainer_max_memory_allocated_gb=trainer_peak_gb,
        trainer_max_memory_reserved_gb=trainer_reserved_gb,
        server_max_memory_allocated_gb=server_peak["max_allocated_bytes"] / 1e9,
        server_max_memory_reserved_gb=server_peak["max_reserved_bytes"] / 1e9,
        card_memory_used=card_memory_used)


def _decoupled_launcher(dev, root: str) -> dict:
    """(d2): `run_experiment` on the smoke yaml, DECOUPLED, both processes
    on the card."""
    from areal_tpu_torch.api.cli_args import BaseExperimentConfig
    from areal_tpu_torch.launcher import local
    from areal_tpu_torch.utils import name_resolve

    argv = ["--config", GRPO_YAML, f"allocation_mode={DECOUPLED_ALLOC}",
            f"total_train_steps={DECOUPLED_STEPS}", f"cluster.fileroot={root}",
            "cluster.name_resolve.type=nfs", f"cluster.name_resolve.nfs_record_root={root}/nr"]
    config, _ = load_expr_config(argv, BaseExperimentConfig, ignore_unknown=True)
    t0 = time.perf_counter()
    try:
        local.run_experiment(config, [sys.executable, "-m", "areal_tpu_torch.examples.gsm8k_grpo",
                                      *argv], device=dev, timeout=SERVER_TIMEOUT)
    finally:
        name_resolve.reconfigure(NameResolveConfig(type="memory"))
    wall = time.perf_counter() - t0
    logs = Path(root) / "logs" / config.experiment_name / config.trial_name
    trainer, server = ((logs / f).read_text() for f in ("trainer_0.log", "decode_server_0.log"))
    check("(global step 1)" in trainer, "d2: the trainer's log has no global step 1")
    for name, text in (("trainer", trainer), ("server", server)):
        check("Traceback" not in text, f"d2: the {name}'s log holds a Traceback")
    return dict(run="d2", yaml="examples/configs/arith_grpo_smoke.yaml", overrides=argv[2:3],
                steps=DECOUPLED_STEPS, wall_s=wall,
                trainer_log_tail=trainer.strip().splitlines()[-1][:200])


def decoupled_only() -> int:
    """`--decoupled`: the device and build phases, then the decoupled
    phase alone."""
    dev, smi = phase_device()
    phase_build()
    out = phase_decoupled(dev)
    print(smi, flush=True)
    print(json.dumps({"decoupled_launches": out["launches"]}), flush=True)
    return 0


def phase_decoupled(dev: torch.device) -> dict:
    """The DECOUPLED allocation (`allocation_mode=jax:d1+d1`) on the card:

    (d1) Qwen2.5-1.5B at full width, its depth cut to CUT_LAYERS, with
         loop cell (c)'s settings: `LocalLauncher` spawns the decode server
         (`--scratch-model`, that geometry, `--device cuda:0`, nfs
         name_resolve under a temporary root) and the trainer runs here,
         `gsm8k_grpo.main(... allocation_mode=jax:d1+d1)`, weights going to
         the server over the staged dcn push every step. Each step's
         version lag is within `max_head_offpolicyness`; K3's launches
         read from the server's /metrics equal its decode steps x L, and
         K1/K2a/K2b's here `_loop_run`'s formulas. Then one more dcn push
         of the final weights, 8 greedy probes of 64 tokens whose
         logprobs agree with the trainer's `compute_logp` within the train
         phase's bounds, a disk push of the same weights (an HF
         checkpoint), and the same probes again: the same tokens bit for
         bit. The server's log has no Traceback, and its process has
         ended and released its port.
    (d2) `run_experiment` on `arith_grpo_smoke.yaml` unchanged but for
         the allocation, 2 steps and the run's paths: both processes on
         the card; the trainer logs global step 1, neither log holds a
         Traceback, and both end."""
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        runs["d1"] = _decoupled_loop(dev, root)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        runs["d2"] = _decoupled_launcher(dev, root)
    emit("decoupled", entry_point="areal_tpu_torch/examples/gsm8k_grpo.py:main",
         server="areal_tpu_torch/launcher/decode_server.py",
         launcher="areal_tpu_torch/launcher/local.py", runs=list(runs.values()))
    return dict(launches=runs["d1"]["launches"])


# phases: the customization layer's other trainers, the PPO critic
# (`areal_tpu_torch/examples/gsm8k_ppo.py`), the reward model
# (`areal_tpu_torch/examples/hhrlhf_rw.py`) and the multi-turn workflow
# (`areal_tpu_torch/examples/multi_turn_math.py`)
PPO_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "arith_ppo_smoke.yaml")
RW_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "arith_rw_smoke.yaml")
MT_YAML = str(Path(__file__).resolve().parent / "examples" / "configs"
              / "arith_grpo_multiturn_smoke.yaml")
PPO_SMOKE_STEPS = 4
# loop cell (c)'s traffic on the PPO yaml: the actor and the critic at
# (c)'s micro-batch and remat settings, two minibatches each
PPO_FULL_OVERRIDES = [o for o in FULL_OVERRIDES if not o.startswith("actor.adv_norm")] + [
    "actor.ppo_n_minibatches=2", "critic.dtype=bfloat16", "critic.optimizer.lr=1e-4",
    "critic.mb_spec.max_tokens_per_mb=8192", "critic.gradient_checkpointing=true",
    "critic.ppo_n_minibatches=2",
]
PPO_TIMINGS = ("rollout", "critic_values", "compute_advantage", "train_step", "critic_step",
               "update_weights")
RW_PAIRS, RW_STEPS = 16, 4
RW_LEN, RW_PREFIX = (256, 512), 192
RW_MB_TOKENS = 4096
RW_SMOKE_STEPS = 30
RW_SMOKE_EVAL_STEPS = [9, 19, 29]  # the yaml's evaluator.freq_steps: 10
MT_SMOKE_STEPS = MT_FULL_STEPS = 2
# cell (c)'s traffic with two turns of 256 tokens (and (c)'s two
# minibatches an update): a retry's prompt is the first turn's
# conversation and the feedback (up to 6 + 256 + 38 tokens), and its 256
# new tokens need a context above (c)'s 512
MT_FULL_OVERRIDES = [o for o in FULL_OVERRIDES if not o.startswith(
    ("actor.adv_norm", "decode.context_length", "total_train_steps"))] + [
    "decode.context_length=1024", "max_turns=2", "actor.ppo_n_minibatches=2",
    f"total_train_steps={MT_FULL_STEPS}"]


@contextlib.contextmanager
def _observe_passes():
    """While a trainer runs: every packed micro-batch pass of every train
    engine (`_device_mb`), with gradients (a trained micro-batch) or without
    (`forward`, `eval_batch`), by actor or critic, with the engine's depth
    and remat, and the end markers of each reward-model micro-batch. The
    flash formulas read these: K1 = L x (passes without gradients + (2
    under remat, else 1) x passes with), K2a = K2b = L x passes with."""
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    seen = dict(engines={}, rw_ends=[])
    device_mb = TorchTrainEngine._device_mb

    def device_mb_(self, mb):
        cfg = self.model_config
        rec = seen["engines"].setdefault(
            "critic" if cfg.is_critic else "actor",
            dict(layers=cfg.num_hidden_layers, remat=cfg.remat, trained=0, untrained=0))
        rec["trained" if torch.is_grad_enabled() else "untrained"] += 1
        if "rw_seq_end" in mb:
            seen["rw_ends"].append(int(np.asarray(mb["rw_seq_end"]).sum()))
        return device_mb(self, mb)

    TorchTrainEngine._device_mb = device_mb_
    try:
        yield seen
    finally:
        TorchTrainEngine._device_mb = device_mb


def _flash_want(passes: dict) -> dict:
    """The flash launch formulas over `_observe_passes`'s counts."""
    fwd = sum(e["layers"] * (e["untrained"] + (2 if e["remat"] else 1) * e["trained"])
              for e in passes["engines"].values())
    bwd = sum(e["layers"] * e["trained"] for e in passes["engines"].values())
    return dict(flash_attention_fwd=fwd, flash_attention_bwd_dq=bwd, flash_attention_bwd_dkv=bwd)


def _flash_launches() -> dict:
    return dict(flash_attention_fwd=fa.launches_fwd, flash_attention_bwd_dq=fa.launches_dq,
                flash_attention_bwd_dkv=fa.launches_dkv)


def _ppo_run(dev, tag: str, overrides: list[str], model_config=None,
             critic_model_config=None, reward_fn=None, xprof: bool = False) -> dict:
    """One run of the PPO entry point (`gsm8k_ppo.main`) on the PPO yaml
    with `overrides`, its kernel counts set to 0 just before and read just
    after: K3 = decode steps x L, K1/K2a/K2b on `_flash_want` over both
    engines' passes (the actor's `compute_logp` when the yaml asks for
    it, the critic's `compute_values`, both updates); each step's version
    lag within `max_head_offpolicyness`, the critic's stats under
    `ppo_critic/`, its loss finite."""
    from areal_tpu_torch.api.cli_args import PPOConfig
    from areal_tpu_torch.examples import gsm8k_ppo

    with tempfile.TemporaryDirectory() as root:
        argv = ["--config", PPO_YAML, *overrides, f"cluster.fileroot={root}",
                f"experiment_name=chip-smoke-ppo-{tag}"]
        config, _ = load_expr_config(argv, PPOConfig)
        torch.cuda.reset_peak_memory_stats(dev)
        window = (_xprof_window(f"ppo {tag}", _last_step_window(config)) if xprof
                  else contextlib.nullcontext({}))
        with _observe_loop() as seen, _observe_passes() as passes, window as xp:
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
            t0 = time.perf_counter()
            history = gsm8k_ppo.main(argv, model_config=model_config,
                                     critic_model_config=critic_model_config,
                                     reward_fn=reward_fn, device=dev)
            wall = time.perf_counter() - t0
            launches = dict(paged_attention=pa.launches, **_flash_launches())
            # ---- end of the main path ----
    engine = seen["engines"][0]
    L = engine.model_config.num_hidden_layers
    want = dict(paged_attention=L * engine.decode_steps, **_flash_want(passes))
    check(launches == want, f"ppo {tag}: launches {launches}, formulas {want}")
    lag_cap = config.rollout.max_head_offpolicyness
    steps = []
    for i, rec in enumerate(history):
        st, batch = rec["stats"][0], rec["batch"]
        gen = batch["attention_mask"].astype(bool) & (batch["versions"] >= 0)
        row = dict(step=i, reward_mean=float(np.mean(batch["rewards"])),
                   tokens=int(batch["attention_mask"].sum()),
                   version_lag=int(i - batch["versions"][gen].min()),
                   actor_loss=st["ppo_actor/loss"], critic_loss=st["ppo_critic/critic_loss"],
                   value_clip_ratio=st["ppo_critic/critic_value_clip_ratio"],
                   critic_grad_norm=st["ppo_critic/critic_grad_norm"],
                   values_mean=float(batch["values"][batch["attention_mask"] > 0].mean()),
                   **{f"{k}_s": st[f"timeperf/{k}"] for k in PPO_TIMINGS})
        row["step_s"] = sum(row[f"{k}_s"] for k in PPO_TIMINGS)
        check(math.isfinite(row["critic_loss"]) and math.isfinite(row["actor_loss"]),
              f"ppo {tag} step {i}: losses {row['actor_loss']}, {row['critic_loss']}")
        check(row["version_lag"] <= lag_cap, f"ppo {tag} step {i}: lag {row['version_lag']}")
        check(not any(k.startswith("ppo_actor/critic") for k in st),
              f"ppo {tag}: critic stats under ppo_actor/")
        steps.append(row)
    for i, u in enumerate(seen["updates"]):
        steps[i]["max_memory_allocated_gb_at_actor_update"] = u["max_memory_allocated_gb"]
    return dict(run=tag, overrides=overrides, layers=L, dtype=engine.model_config.dtype,
                wall_s=wall, launches=launches, xprof=xp.get("xprof"), formulas=dict(
                    paged_attention="decode steps x L",
                    flash_attention_fwd="L x (logp mbs + value mbs + (2 if remat else 1) x "
                                        "trained mbs of both engines)",
                    flash_attention_bwd_dq="L x trained mbs of both engines",
                    flash_attention_bwd_dkv="L x trained mbs of both engines"),
                passes=passes["engines"], decode_steps=engine.decode_steps,
                prefill_calls=engine.prefill_calls,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                max_memory_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
                max_version_lag=max(r["version_lag"] for r in steps), steps=steps)


def phase_ppo(dev: torch.device) -> dict:
    """The port's PPO entry point (actor and critic) on the card:

    (p1) `arith_ppo_smoke.yaml` unchanged but for the step count and the
         run's paths (the smoke decoder and its value-head twin in f32,
         hd 16: the kernels' f32 routes), 4 async steps;
    (p2) Qwen2.5-1.5B at its published widths, the depth cut to
         CUT_LAYERS, for both the actor
         and the critic (a value head in place of the tied LM head), bf16,
         random weights, with the colocated decode engine, on loop cell
         (c)'s traffic and the train phase's reward: `FULL_STEPS` steps of 8
         prompts x 4 samples, 256 new tokens, 32 slots, context 512, 128-step chunks,
         remat, `ppo_n_minibatches` 2 for each engine.

    Each run: K3 = decode steps x L; K1/K2a/K2b on `_flash_want` over both
    engines; the version lag within 2; the critic's stats under
    `ppo_critic/` (its loss finite, `value_clip_ratio` read); the step's
    timers (`critic_values` and `critic_step` among them) and the peak
    device memory, two trainers and the decode engine on one card."""
    runs = {"p1": _ppo_run(dev, "p1", [f"total_train_steps={PPO_SMOKE_STEPS}"])}
    torch.cuda.empty_cache()
    runs["p2"] = _ppo_run(dev, "p2", PPO_FULL_OVERRIDES,
                          model_config=dataclasses.replace(QWEN25_1_5B, remat=True,
                                                           num_hidden_layers=CUT_LAYERS),
                          critic_model_config=dataclasses.replace(
                              QWEN25_1_5B, remat=True, is_critic=True,
                              num_hidden_layers=CUT_LAYERS),
                          reward_fn=parity_reward, xprof=True)
    emit("ppo", entry_point="areal_tpu_torch/examples/gsm8k_ppo.py:main", yaml=PPO_YAML,
         full_model="Qwen2.5-1.5B", full_source=QWEN25_1_5B_SOURCE, runs=list(runs.values()))
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["p2"]["launches"]}
    return dict(launches=total, by_run={t: r["launches"] for t, r in runs.items()},
                p2_peak_gb=runs["p2"]["max_memory_allocated_gb"])


def _rw_pairs(rng, vocab: int, pairs: int) -> dict:
    """`pairs` (chosen, rejected) rows (2i, 2i+1) of RW_LEN tokens each,
    sharing a RW_PREFIX-token prefix, padded to one batch."""
    from areal_tpu_torch.utils.data import pad_sequences_to_tensors

    seqs = []
    for _ in range(pairs):
        prefix = rng.integers(3, vocab, RW_PREFIX).tolist()
        for _ in range(2):
            n = int(rng.integers(RW_LEN[0], RW_LEN[1] + 1))
            ids = np.asarray(prefix + rng.integers(3, vocab, n - RW_PREFIX).tolist(), np.int32)
            seqs.append(dict(input_ids=ids, loss_mask=np.ones_like(ids)))
    return pad_sequences_to_tensors(seqs)


def _rw_full(dev) -> dict:
    """(r1): `TorchRWEngine` at Qwen2.5-1.5B with random weights from seed
    0, remat, bf16, RW_MB_TOKENS-token micro-batches: RW_STEPS `train_rw`
    steps, one `eval_rw` and `compute_scores` on RW_PAIRS pairs, and a
    `forward` whose values at each sequence's last token must equal the
    scores bit for bit. Every micro-batch carries an even count of end
    markers (whole pairs); the flash counts equal `_flash_want`."""
    from areal_tpu_torch.api.cli_args import TrainEngineConfig
    from areal_tpu_torch.engine.rw.rw_engine import TorchRWEngine, _identity_hook

    cfg = dataclasses.replace(QWEN25_1_5B, remat=True, is_critic=True, scan_layers=False)
    econf = TrainEngineConfig(
        experiment_name="chip-smoke-rw", trial_name="r1", dtype="bfloat16",
        mb_spec=MicroBatchSpec(max_tokens_per_mb=RW_MB_TOKENS),
        optimizer=OptimizerConfig(lr=1e-5, weight_decay=0.01, warmup_steps_proportion=0.0,
                                  lr_scheduler_type="constant", gradient_clipping=1.0))
    rng = np.random.default_rng(SEED + 14)
    batches = [_rw_pairs(rng, cfg.vocab_size, RW_PAIRS) for _ in range(RW_STEPS + 1)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = TorchRWEngine(econf, device=dev)
    engine.model_config = cfg
    engine.create_process_group()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    engine.initialize(None, FinetuneSpec(1, RW_STEPS * RW_PAIRS, RW_PAIRS),
                      params=init_params(cfg, gen, dev))
    try:
        with _observe_passes() as passes:
            # ---- the main path: counts to 0 just before, read just after ----
            fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
            wall = time.perf_counter()
            steps = []
            for i in range(RW_STEPS):
                t0 = time.perf_counter()
                st = engine.train_rw(batches[i])
                steps.append(dict(step=i, loss=st["loss"], grad_norm=st["grad_norm"],
                                  lr=st["lr"], n_mbs=st["n_mbs"], tokens=st["n_tokens"],
                                  wall_s=time.perf_counter() - t0, mfu=st["mfu"],
                                  trained_tokens_per_s=st["tokens_per_sec_per_chip"]))
            t0 = time.perf_counter()
            eval_loss = engine.eval_rw(batches[-1])
            eval_s = time.perf_counter() - t0
            scores = engine.compute_scores(batches[-1])
            flat = engine.forward(batches[-1], post_hook=_identity_hook, aggregate_fn=list)
            wall = time.perf_counter() - wall
            launches = _flash_launches()
            # ---- end of the main path ----
    finally:
        engine.destroy()
    lens = batches[-1]["attention_mask"].sum(-1)
    last = np.array([seq[n - 1] for seq, n in zip(flat, lens)], np.float32)
    check(np.array_equal(scores, last), "rw r1: compute_scores differ from the forward's values "
                                        "at the last tokens")
    check(all(math.isfinite(r["loss"]) for r in steps) and math.isfinite(eval_loss),
          f"rw r1: losses {[r['loss'] for r in steps]}, eval {eval_loss}")
    odd = [n for n in passes["rw_ends"] if n % 2]
    check(not odd, f"rw r1: micro-batches with an odd count of end markers: {odd}")
    check(all(r["n_mbs"] > 1 for r in steps), f"rw r1: {[r['n_mbs'] for r in steps]} mbs a step")
    want = _flash_want(passes)
    check(launches == want, f"rw r1: launches {launches}, formulas {want}")
    return dict(run="r1", wall_s=wall, model="Qwen2.5-1.5B", layers=cfg.num_hidden_layers,
                pairs=RW_PAIRS,
                seq_len=RW_LEN, shared_prefix=RW_PREFIX, max_tokens_per_mb=RW_MB_TOKENS,
                launches=launches, passes=passes["engines"],
                end_markers_per_mb=passes["rw_ends"], steps=steps, eval_loss=eval_loss,
                eval_s=eval_s, chosen_above_rejected=float(np.mean(scores[0::2] > scores[1::2])),
                max_memory_allocated_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                max_memory_reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9)


def _rw_smoke(dev) -> dict:
    """(r2): `arith_rw_smoke.yaml` unchanged through the reward-model entry
    point (the smoke decoder with a value head, f32): 30 steps, the
    evaluator at steps 9, 19 and 29; every loss finite, the last three
    steps' mean below the first three's, the flash counts on
    `_flash_want`."""
    from areal_tpu_torch.examples import hhrlhf_rw

    with tempfile.TemporaryDirectory() as root, _observe_passes() as passes:
        # ---- the main path: counts to 0 just before, read just after ----
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        t0 = time.perf_counter()
        history = hhrlhf_rw.main(["--config", RW_YAML, f"cluster.fileroot={root}",
                                  "experiment_name=chip-smoke-rw-smoke"], device=dev)
        wall = time.perf_counter() - t0
        launches = _flash_launches()
        # ---- end of the main path ----
    check(len(history) == RW_SMOKE_STEPS, f"rw r2: {len(history)} steps")
    evals = {r["global_step"]: r["eval_loss"] for r in history if "eval_loss" in r}
    check(sorted(evals) == RW_SMOKE_EVAL_STEPS, f"rw r2: evaluations at {sorted(evals)}")
    losses = [r["rw_loss"] for r in history]
    check(all(map(math.isfinite, losses + list(evals.values()))), "rw r2: a loss is not finite")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]), f"rw r2: losses did not fall: {losses}")
    want = _flash_want(passes)
    check(launches == want, f"rw r2: launches {launches}, formulas {want}")
    odd = [n for n in passes["rw_ends"] if n % 2]
    check(not odd, f"rw r2: micro-batches with an odd count of end markers: {odd}")
    return dict(run="r2", yaml=RW_YAML, wall_s=wall, launches=launches, passes=passes["engines"],
                losses=losses, eval_losses=evals)


def phase_rw(dev: torch.device) -> dict:
    """The port's Bradley-Terry reward model on the card: (r1) the engine
    at Qwen2.5-1.5B full width and depth, (r2) the entry point on its smoke
    yaml."""
    runs = dict(r1=_rw_full(dev))
    torch.cuda.empty_cache()
    runs["r2"] = _rw_smoke(dev)
    emit("rw", entry_point="areal_tpu_torch/examples/hhrlhf_rw.py:main",
         engine="areal_tpu_torch/engine/rw/rw_engine.py:TorchRWEngine",
         full_source=QWEN25_1_5B_SOURCE, runs=list(runs.values()))
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in FLASH_COUNTERS}
    return dict(launches=dict(total, paged_attention=0),
                r1_peak_gb=runs["r1"]["max_memory_allocated_gb"])


def _feedback_spans(batch: dict) -> dict:
    """The retries in a trained multi-turn batch: each feedback span must
    carry version -1 and loss mask 0 (read through `compute_advantages`'
    roll of the mask by -1)."""
    from areal_tpu_torch.workflow.multi_turn import DEFAULT_FEEDBACK

    fb = ArithTokenizer().encode(DEFAULT_FEEDBACK)
    k, spans = len(fb), 0
    for i in range(batch["input_ids"].shape[0]):
        n = int(batch["attention_mask"][i].sum())
        ids = batch["input_ids"][i, :n].tolist()
        mask = np.roll(np.asarray(batch["loss_mask"][i]), 1)[:n]
        ver = batch["versions"][i, :n]
        for p in range(int(batch["begin_of_answer"][i]), n - k + 1):
            if ids[p:p + k] == fb:
                check(not mask[p:p + k].any() and (ver[p:p + k] == -1).all(),
                      f"multi_turn: row {i}'s feedback at {p} is trained or stamped")
                spans += 1
    return dict(feedback_spans=spans, rows=int(batch["input_ids"].shape[0]),
                discounted_rewards=sorted(set(np.round(batch["rewards"], 6).tolist())))


def phase_multi_turn(dev: torch.device) -> dict:
    """The multi-turn workflow through the GRPO entry point
    (`workflow=multi_turn`) on the card:

    (m1) `arith_grpo_multiturn_smoke.yaml` unchanged but for the step
         count and the run's paths, 2 steps, through `multi_turn_math.main`'s
         path (the entry point with `workflow=multi_turn`);
    (m2) Qwen2.5-1.5B at full width, the depth cut to CUT_LAYERS, random
         weights, on loop
         cell (c)'s traffic with `max_turns=2` and a context of 1024 (a
         retry re-sends up to 300 tokens and asks 256 more), 2 steps, with
         the dataset's reward. Random weights answer no sum, so every
         trained episode holds a retry.

    Each run: every feedback span in the trained rows has loss mask 0 and
    version -1; K3 = decode steps x L and K1/K2a/K2b on the loop formulas
    (`_loop_run`); the decode engine's prefills, forks and suffix
    prefills printed. In (m2) the retries, each re-sending its whole
    conversation, are served by suffix prefills (or forks)."""
    runs = {"m1": _loop_run(dev, "m1", [f"total_train_steps={MT_SMOKE_STEPS}"], yaml=MT_YAML,
                            batch_check=_feedback_spans)}
    torch.cuda.empty_cache()
    runs["m2"] = _loop_run(dev, "m2", MT_FULL_OVERRIDES, yaml=MT_YAML,
                           model_config=dataclasses.replace(QWEN25_1_5B, remat=True,
                                                            num_hidden_layers=CUT_LAYERS),
                           batch_check=_feedback_spans, xprof=True)
    for tag, r in runs.items():
        check(r["workflow"] == "multi_turn", f"{tag}: workflow {r['workflow']}")
        check(r["max_version_lag"] <= 2, f"{tag}: version lag {r['max_version_lag']}")
    m2 = runs["m2"]
    for r in m2["steps"]:
        check(r["feedback_spans"] == r["rows"],
              f"m2 step {r['step']}: {r['feedback_spans']} retries in {r['rows']} rows")
    served = m2["admissions"]["suffix_prefills"] + m2["admissions"]["forks"]
    check(served > 0, f"m2: no retry served from the prefix registry: {m2['admissions']}")
    emit("multi_turn", entry_point="areal_tpu_torch/examples/gsm8k_grpo.py:main "
                                   "(workflow=multi_turn; multi_turn_math.py appends it)",
         workflow="areal_tpu_torch/workflow/multi_turn.py", yaml=MT_YAML,
         full_model="Qwen2.5-1.5B", runs=list(runs.values()))
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in runs["m2"]["launches"]}
    return dict(launches=total, by_run={t: r["launches"] for t, r in runs.items()})


# phase: HF checkpoints from local paths (the GRPO entry point's actor and
# reference policy, the offline evaluator, the decode server's
# --model-path)
# Qwen2.5-1.5B's widths at CUT_LAYERS of its 28 layers (0.65 GB of bf16
# tensors at 2; 3.09 GB at full depth): 2 shards
HF_SHARD_BYTES = 512 << 20
HF_KL = 0.05
# loop cell (c)'s traffic on the countdown dataset, the actor and the
# reference policy loaded from the checkpoint
HF_STEPS = FULL_STEPS
HF_OVERRIDES = FULL_OVERRIDES + [
    "train_dataset.path=countdown", "actor.init_from_scratch=false", f"actor.kl_ctl={HF_KL}",
    "ref.dtype=bfloat16", "ref.mb_spec.max_tokens_per_mb=8192",
    f"total_train_steps={HF_STEPS}"]
HF_EVAL = ["--data-names", "synthetic-arith", "--tokenizer-path", "synthetic-arith",
           "--max-problems", "16", "--n-sampling", "4", "--max-gen-tokens", "64"]
HF_METRICS = {"n_problems", "n_samples", "mean_reward", "pass_at_1", "pass@1", "pass@4",
              "mean_output_len", "maj_at_n"}
HF_PROBES, HF_PROBE_NEW = 4, 32
# the served engine's and the in-process engine's settings
HF_SERVE = dict(context_length=1024, max_running_requests=8, new_tokens_per_chunk=32)


def _bit_sums(params: dict) -> dict:
    """Each tensor's bits, read as int16, summed on its device plainly and
    weighted by position mod 65521: equal tensors give equal sums, and a
    changed or moved value changes them."""
    out = {}
    for name, t in params.items():
        bits = t.detach().reshape(-1).view(torch.int16)
        plain = weighted = 0
        for start in range(0, bits.numel(), 1 << 22):
            chunk = bits[start:start + (1 << 22)].to(torch.int64)
            pos = torch.arange(start, start + chunk.numel(), device=chunk.device) % 65521 + 1
            plain += int(chunk.sum())
            weighted += int((chunk * pos).sum())
        out[name] = (plain, weighted)
    return out


def _version_of(module: str) -> str | None:
    """An installed package's version, or None, without importing it."""
    from importlib import metadata

    try:
        return metadata.version(module)
    except metadata.PackageNotFoundError:
        return None


def _write_hf_checkpoint(dev, root: str) -> tuple[dict, dict]:
    """Qwen2.5-1.5B at its published widths and CUT_LAYERS of its 28
    layers, bf16 weights from seed 0, written sharded in HF format by the port's writer (`hf_io`) with
    `QWEN25_1_5B_HF` as its config.json: (the written tensors'
    `_bit_sums`, the write's record)."""
    cfg = dataclasses.replace(QWEN25_1_5B, scan_layers=False, num_hidden_layers=CUT_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    t0 = time.perf_counter()
    hf_io.save_hf_params(params, cfg, root, upcast_bf16=False, max_shard_bytes=HF_SHARD_BYTES)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dict(QWEN25_1_5B_HF, num_hidden_layers=CUT_LAYERS,
                       architectures=["Qwen2ForCausalLM"]), f)
    write_s = time.perf_counter() - t0
    with open(os.path.join(root, "model.safetensors.index.json")) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    check(len(shards) >= 2, f"hf_path: {shards}: fewer than 2 shards")
    sums = _bit_sums(params)
    reckoned = sum(t.numel() * t.element_size() for t in params.values())
    del params
    return sums, dict(path=root, shards=shards, write_s=write_s, tensor_bytes=reckoned,
                      disk_bytes=_dir_bytes(root))


@contextlib.contextmanager
def _observe_engines(written: dict):
    """While `main` runs: each train engine's weights right after its
    `initialize`, their `_bit_sums` held against `written`, with its load
    seconds and whether it built an optimizer."""
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine

    seen = []
    init = TorchTrainEngine.initialize

    def initialize(self, *args, **kwargs):
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        secs = time.perf_counter() - t0
        loaded = _bit_sums(self.params)
        diff = sorted(k for k in written if loaded.get(k) != written[k])
        seen.append(dict(path=self.config.path, initialize_s=secs, tensors=len(loaded),
                         bit_equal=not diff and set(loaded) == set(written),
                         differ=diff[:5], optimizer=self.optimizer is not None))

    TorchTrainEngine.initialize = initialize
    try:
        yield seen
    finally:
        TorchTrainEngine.initialize = init


@contextlib.contextmanager
def _observe_countdown():
    """The countdown reward as `pick_reward_fn` finds it, counting each
    call by (prompt, completion) ids with the reward it returned."""
    from areal_tpu_torch.reward import countdown

    calls: dict = {}
    reward = countdown.countdown_reward

    def counted(prompt, completion, prompt_ids, completion_ids, **kw):
        r = reward(prompt, completion, prompt_ids, completion_ids, **kw)
        calls.setdefault((tuple(prompt_ids), tuple(completion_ids)), []).append(r)
        return r

    countdown.countdown_reward = counted
    try:
        yield calls
    finally:
        countdown.countdown_reward = reward


def _ref_check(batch: dict) -> dict:
    """A trained batch's reference logprobs against the actor's recomputed
    ones on the trained tokens, and its KL rewards."""
    lm = np.roll(batch["loss_mask"], -1, axis=-1) > 0
    d = np.abs(batch["ref_logp"][lm] - batch["prox_logp"][lm])
    return dict(ref_vs_actor_logp=dict(tokens=int(lm.sum()), max_abs_diff=float(d.max()),
                                       mean_abs_diff=float(d.mean())),
                kl_rewards_max_abs=float(np.abs(batch["kl_rewards"]).max()))


def _hf_grpo(dev, ckpt: str, written: dict) -> dict:
    """(h1) the GRPO entry point on the checkpoint: the actor and the
    reference policy load it bit for bit, step 0's reference logprobs
    equal the actor's, the countdown reward scores every sample once."""
    with _observe_engines(written) as engines, _observe_countdown() as calls:
        run = _loop_run(dev, "h1", HF_OVERRIDES + [f"actor.path={ckpt}", f"ref.path={ckpt}"],
                        batch_check=_ref_check, xprof=True)
    check(len(engines) == 2, f"h1: {len(engines)} train engines, want actor and reference")
    for name, e in zip(("actor", "ref"), engines):
        check(e["path"] == ckpt and e["bit_equal"],
              f"h1: the {name}'s loaded weights differ from the written ones: {e['differ']}")
    check(engines[0]["optimizer"] and not engines[1]["optimizer"],
          f"h1: optimizers {[e['optimizer'] for e in engines]}: the actor's only")
    r0 = run["steps"][0]["ref_vs_actor_logp"]
    check(r0["max_abs_diff"] <= LOGP_MAX_ABS_DIFF and r0["mean_abs_diff"] <= LOGP_MEAN_ABS_DIFF,
          f"h1 step 0: reference vs actor logprobs {r0}")
    check(all(r["ref_logp_mbs"] > 0 for r in run["steps"]), "h1: a step without the reference")
    samples = sum(r["samples"] for r in run["steps"])
    once = all(len(v) == 1 for v in calls.values())
    check(once, "h1: a sample scored twice")
    check(len(calls) >= samples, f"h1: {len(calls)} countdown rewards for {samples} trained samples")
    return dict(run, engines=engines, countdown_reward_calls=len(calls), trained_samples=samples,
                kl_ctl=HF_KL)


def _hf_eval(dev, ckpt: str, root: str) -> dict:
    """(h2) `eval_and_aggregate.main` in process with `--model-path`: K3 =
    decode steps x L; every metric written."""
    from areal_tpu_torch.evaluation import eval_and_aggregate

    out = os.path.join(root, "eval")
    with _observe_loop() as seen:
        # ---- the main path: counts to 0 just before, read just after ----
        pa.launches = 0
        t0 = time.perf_counter()
        eval_and_aggregate.main(HF_EVAL + ["--model-path", ckpt, "--output-path", out],
                                device=dev)
        wall = time.perf_counter() - t0
        k3 = pa.launches
        # ---- end of the main path ----
    eng = seen["engines"][0]
    L = eng.model_config.num_hidden_layers
    check(k3 == L * eng.decode_steps > 0, f"h2: K3 {k3}, want {L} x {eng.decode_steps}")
    with open(os.path.join(out, "synthetic-arith", "metrics.json")) as f:
        metrics = json.load(f)
    check(set(metrics) == HF_METRICS, f"h2: metrics.json keys {sorted(metrics)}")
    check(all(math.isfinite(v) for v in metrics.values()), f"h2: metrics {metrics}")
    check(metrics["n_problems"] == 16 and metrics["n_samples"] == 4, f"h2: {metrics}")
    return dict(run="h2", argv=HF_EVAL, wall_s=wall, launches=dict(paged_attention=k3),
                decode_steps=eng.decode_steps, prefill_calls=eng.prefill_calls, metrics=metrics)


def _subprocess_grades(out: dict) -> None:
    """Two grades through the math grader's forkserver children (whose
    server preloads this script), an equal pair and an unequal one, and
    their seconds, into `out`."""
    from areal_tpu_torch.reward.math_parser import math_equal_subprocess

    t0 = time.perf_counter()
    out["grades"] = [math_equal_subprocess("\\frac{1}{2}", "0.5", timeout_s=120),
                     math_equal_subprocess("\\frac{1}{2}", "0.6", timeout_s=120)]
    out["seconds"] = time.perf_counter() - t0


def _hf_serve(dev, ckpt: str, root: str) -> dict:
    """(h3) the decode server started with `--model-path`, and an engine
    in this process with `model_path` and the same settings: greedy
    tokens of HF_PROBES prompts, one request at a time, equal; K3 =
    decode steps x L in both."""
    from areal_tpu_torch.launcher import local
    from areal_tpu_torch.utils import name_resolve

    rng = np.random.default_rng(SEED + 40)
    prompts = [rng.integers(0, QWEN25_1_5B.vocab_size, int(n)).tolist()
               for n in rng.integers(*PROBE_PROMPT_LEN, HF_PROBES)]
    gconfig = dict(greedy=True, max_new_tokens=HF_PROBE_NEW)
    nr = NameResolveConfig(type="nfs", nfs_record_root=os.path.join(root, "nr"))
    name_resolve.reconfigure(nr)
    launcher = local.LocalLauncher("chip-smoke-hf", "run0", root)
    args = ["--dtype", "bfloat16", "--device", str(dev)]
    for k, v in HF_SERVE.items():
        args += [f"--{k.replace('_', '-')}", str(v)]
    t0 = time.perf_counter()
    handle = launcher.spawn_decode_server(model_path=ckpt, extra_args=args,
                                          env=name_resolve.to_env(nr), timeout=SERVER_TIMEOUT)
    job, addr = handle.job, handle.addr
    spawn_s = time.perf_counter() - t0
    try:
        # ---- the main path (the server's counts start at 0) ----
        served = [_server_post(addr, "/generate", dict(input_ids=p, gconfig=gconfig))
                  for p in prompts]
        server = _server_pause_read(addr)
        # ---- end of the main path ----
    finally:
        launcher.stop_all()
        name_resolve.reconfigure(NameResolveConfig(type="memory"))
    log = Path(job.log_path).read_text()
    check("Traceback" not in log, "h3: the server's log holds a Traceback")
    eng = TorchDecodeEngine(TorchDecodeConfig(model_path=ckpt, **HF_SERVE),
                            InferenceEngineConfig(), device=dev)
    eng.initialize()
    try:
        # ---- the main path: counts to 0 just before, read just after ----
        pa.launches = 0
        local_out = [eng.generate(ModelRequest(input_ids=p,
                                               gconfig=GenerationHyperparameters(**gconfig)))
                     for p in prompts]
        k3_local = pa.launches
        # ---- end of the main path ----
        steps_local = eng.decode_steps
    finally:
        eng.destroy()
    L = CUT_LAYERS  # the checkpoint's depth
    k = server["kernel_launches"]
    check(k["paged_attention"] == L * k["decode_steps"] > 0, f"h3: server launches {k}")
    check(k3_local == L * steps_local > 0, f"h3: K3 {k3_local}, want {L} x {steps_local}")
    tokens = [r["output_tokens"] for r in served]
    check(all(len(t) == HF_PROBE_NEW for t in tokens), "h3: a served probe stopped early")
    check(tokens == [r.output_tokens for r in local_out],
          "h3: the server's greedy tokens differ from the in-process engine's")
    return dict(run="h3", server_spawn_s=spawn_s, probes=HF_PROBES, new_tokens=HF_PROBE_NEW,
                settings=HF_SERVE, tokens_equal=True,
                packages={m: _version_of(m) for m in ("transformers", "datasets")},
                server_tokenizer_log=[ln[-200:] for ln in log.splitlines() if "tokenizer" in ln],
                launches=dict(paged_attention=k["paged_attention"] + k3_local),
                server_decode_steps=k["decode_steps"], local_decode_steps=steps_local)


def phase_hf_path(dev: torch.device) -> dict:
    """HF checkpoints from local paths on the card:

    (h0) Qwen2.5-1.5B at its published widths and CUT_LAYERS of its 28
         layers, bf16 weights from seed 0,
         written by the port's own writer in 2 shards with an index;
    (h1) the GRPO entry point on it, colocated, under loop cell (c)'s
         settings on the countdown dataset, with `actor.path` and
         `ref.path` at the checkpoint and `actor.kl_ctl` 0.05, `HF_STEPS`
         step:
         both engines load it with the written tensors' bit sums (the
         reference without an optimizer), step 0's reference logprobs
         equal the actor's within the bf16 logprob tolerances, the
         countdown reward scores each sample once; K3 = decode steps x L, K1 = L x (logp mbs + ref logp
         mbs + 2 x trained mbs), K2a = K2b = L x trained mbs;
    (h2) `eval_and_aggregate` in process with `--model-path`: K3 = decode
         steps x L, every metric in `metrics.json`;
    (h3) the decode server with `--model-path`: its greedy tokens equal
         those of an engine loaded here from the same directory; beside
         it, the math grader's subprocess grades an equal pair True and
         an unequal one False from inside the run.

    The checkpoint is deleted at the end."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ckpt = os.path.join(root, "qwen2.5-1.5b")
        written, write = _write_hf_checkpoint(dev, ckpt)
        torch.cuda.empty_cache()
        h1 = _hf_grpo(dev, ckpt, written)
        del written
        torch.cuda.empty_cache()
        h2 = _hf_eval(dev, ckpt, root)
        torch.cuda.empty_cache()
        # the grader's forkserver starts (and imports this script) while
        # the server process loads the checkpoint
        grades: dict = {}
        grader = threading.Thread(target=_subprocess_grades, args=(grades,), daemon=True)
        grader.start()
        h3 = _hf_serve(dev, ckpt, root)
        grader.join(timeout=300)
    check(not grader.is_alive() and grades.get("grades") == [True, False],
          f"hf_path: subprocess grades {grades}")
    runs = [h1, h2, h3]
    emit("hf_path", wall_s=time.perf_counter() - t0,
         checkpoint=dict(write, model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE),
         entry_points=["areal_tpu_torch/examples/gsm8k_grpo.py:main",
                       "areal_tpu_torch/evaluation/eval_and_aggregate.py:main",
                       "areal_tpu_torch/launcher/decode_server.py --model-path"],
         subprocess_grades=grades, runs=runs)
    total = dict(h1["launches"])
    total["paged_attention"] += h2["launches"]["paged_attention"] + h3["launches"][
        "paged_attention"]
    return dict(launches=total, by_run={r["run"]: r["launches"] for r in runs},
                h1_peak_gb=h1["max_memory_allocated_gb"])


# phase: code and tool RL (`areal_tpu_torch/examples/tir_math.py` over
# `workflow/tir.py`, the code graders and the verification service, the
# agent layer and the OpenAI-style client, the checkpoint watcher)
TIR_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "tir_math.yaml")
# the offline smoke overrides of examples/tir_math.py's docstring, and the
# validation set's (the yaml's math500 is a hub id)
TIR_OFFLINE = ["tokenizer_path=synthetic-arith", "train_dataset.path=synthetic-arith",
               "actor.path=", "decode.model_path=", "actor.init_from_scratch=true",
               "valid_dataset.path=synthetic-arith"]
# two checkpoints, so the watcher publishes two evaluations in step order
TIR_STEPS = 2
# (t1): loop cell (c)'s size on the yaml, and a checkpoint every step
TIR_OVERRIDES = TIR_OFFLINE + [o for o in FULL_OVERRIDES if not o.startswith(
    "total_train_steps")] + [f"total_train_steps={TIR_STEPS}", "actor.ppo_n_minibatches=2",
                             "rollout.max_concurrent_rollouts=32", "saver.freq_steps=1"]
# the watcher scores each checkpoint with its default command
TIR_AUTO_EVAL = dict(data_names="synthetic-arith", tokenizer_path="synthetic-arith",
                     max_gen_tokens=64, n_sampling=4, max_problems=16, max_concurrent_jobs=2)
TIR_AUTO_TIMEOUT = 300
# (t2): tool rounds at Qwen2.5-1.5B's widths, CUT_LAYERS of its 28 layers,
# with the arithmetic
# tokenizer's vocabulary in place of 151,936 rows, and the random weights'
# final norm scaled down, so that the sampler draws the 21 rows near
# uniformly and meets a one-character marker every ~21 tokens (with the
# norm at 1 the random model loops on a few rows: two chip runs sampled 4
# of the 18 characters, and no closing marker); the tools' markers are
# arithmetic characters
TIR_PY_MARKERS = ("?", "=")
TIR_CALC_MARKERS = ("*", ".")
TIR_FINAL_NORM_SCALE = 0.05
TIR_PROMPTS, TIR_SAMPLES, TIR_MAX_NEW, TIR_MAX_CALLS = 8, 4, 128, 4
# (c)'s slots and context; 16-step chunks, since a round ends at its
# marker within a few tokens and the engine cuts it at the chunk's end
TIR_DECODE = dict(max_running_requests=32, context_length=512, new_tokens_per_chunk=16)
# (t3): one stdio problem, 4 canonical solutions and 4 broken ones
VERIFY_IO = dict(inputs=["3 4\n", "10 -2\n"], outputs=["7\n", "8\n"], fn_name="")
VERIFY_ANSWERS = [
    "```python\na, b = map(int, input().split())\nprint(a + b)\n```",
    "```py\nimport sys\nprint(sum(map(int, sys.stdin.read().split())))\n```",
    "reasoning first\n```python\nx = input().split()\nprint(int(x[0]) + int(x[1]))\n```",
    "```python\nprint(eval('+'.join(input().split())))\n```",
    "```python\na, b = map(int, input().split())\nprint(a - b)\n```",
    "```python\nprint(7)\n```",
    "```python\nprint(a + b\n```",
    "a, b = map(int, input().split())\nprint(a + b)\n",  # no fence: no code
]
VERIFY_WANT = [1.0] * 4 + [0.0] * 4
# (t3): 8 HumanEval-style problems for `eval_and_aggregate --task code`
CODE_EVAL_PROBLEMS = 8
CODE_EVAL = ["--task", "code", "--tokenizer-path", "synthetic-arith", "--n-sampling", "2",
             "--max-gen-tokens", "64"]


class _ChatTokenizer(ArithTokenizer):
    """The arithmetic tokenizer made lossless for a chat client: every id
    decodes to a character of its own (ids without one to private-use code
    points), and the chat template concatenates the turns (a user's content
    and "=", an assistant's content as decoded), so the next turn's prompt
    extends the previous call's tokens."""

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        return "".join(self._i2c.get(int(i)) or chr(0xE000 + int(i))
                       for i in np.asarray(ids).reshape(-1))

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        return [self._c2i[c] if c in self._c2i else ord(c) - 0xE000 for c in text]

    def apply_chat_template(self, messages, add_generation_prompt=True, tokenize=True, **kw):
        text = "".join(m["content"] + ("=" if m["role"] == "user" else "") for m in messages)
        return self.encode(text) if tokenize else text


@contextlib.contextmanager
def _observe_tools():
    """While a run goes: each call of the TIR python tool (`run_python_tool`)
    and its output."""
    from areal_tpu_torch.workflow import tir

    calls = []
    run = tir.run_python_tool

    def run_(code, *args, **kwargs):
        out = run(code, *args, **kwargs)
        calls.append(out)
        return out

    tir.run_python_tool = run_
    try:
        yield calls
    finally:
        tir.run_python_tool = run


def _tool_tokens(batch: dict) -> dict:
    """The tool-output tokens of a TIR batch (past `begin_of_answer`, loss
    mask 0; `compute_advantages` has rolled the mask by -1 when `rolled`):
    their count, and whether each has logprob 0 and version -1."""
    n_tool, ok = 0, True
    for i in range(batch["input_ids"].shape[0]):
        n, boa = int(batch["attention_mask"][i].sum()), int(batch["begin_of_answer"][i])
        mask = np.asarray(batch["loss_mask"][i])[:n]
        tool = np.flatnonzero(mask[boa:] == 0) + boa
        n_tool += len(tool)
        ok &= bool((batch["versions"][i, tool] == -1).all()
                   and (batch["logprobs"][i, tool] == 0).all())
    return dict(tool_tokens=n_tool, tool_tokens_masked=ok)


def _tir_loop(dev, root: str) -> tuple[dict, tuple]:
    """(t1): `tir_math.main` on tir_math.yaml with the offline smoke
    overrides at (c)'s size, a checkpoint every step; then
    `AutomaticEvaluator` with its default command starts a child process
    on the card for each checkpoint (`_tir_watch` waits for them):
    (the run's record, (the watcher, its publications, the root))."""
    from areal_tpu_torch.evaluation.auto import AutomaticEvaluator
    from areal_tpu_torch.examples import tir_math
    from areal_tpu_torch.utils.saver import Saver

    full_cfg = dataclasses.replace(QWEN25_1_5B, remat=True, num_hidden_layers=CUT_LAYERS)

    def no_tool_tokens(batch):
        # compute_advantages rolled the loss mask by -1: undo it
        b = dict(batch, loss_mask=np.roll(batch["loss_mask"], 1, axis=1))
        return _tool_tokens(b)

    with _observe_tools() as calls:
        run = _loop_run(dev, "t1", TIR_OVERRIDES, model_config=full_cfg,
                        reward_fn=parity_reward, root=root, yaml=TIR_YAML,
                        batch_check=no_tool_tokens, entry=tir_math.main, xprof=True)
    config, _ = load_expr_config(["--config", TIR_YAML, *TIR_OVERRIDES,
                                  f"cluster.fileroot={root}",
                                  "experiment_name=chip-smoke-t1"], GRPOConfig)
    check(run["workflow"] == "tir", f"t1: workflow {run['workflow']}")
    lag_cap = config.rollout.max_head_offpolicyness
    check(run["max_version_lag"] <= lag_cap, f"t1: version lag {run['max_version_lag']} > {lag_cap}")
    # the arithmetic tokenizer cannot spell ```python: no tool call
    check(not calls and all(r["tool_tokens"] == 0 for r in run["steps"]),
          f"t1: {len(calls)} tool calls, tool tokens {[r['tool_tokens'] for r in run['steps']]}")
    ckpt_root = Saver.get_save_checkpoint_root(config.saver)
    ckpts = sorted(os.listdir(ckpt_root))
    check(len(ckpts) == TIR_STEPS, f"t1: checkpoints {ckpts}")
    # a run from scratch saves no config.json (the train engine copies the
    # one at `actor.path`, as the JAX engine does), and the watcher's
    # evaluator reads one: the model's goes beside each checkpoint
    without_config = [c for c in ckpts
                      if not os.path.exists(os.path.join(ckpt_root, c, "config.json"))]
    hf_config = dict(json.loads(_scratch_model_json(full_cfg)),
                     architectures=["Qwen2ForCausalLM"], torch_dtype=full_cfg.dtype)
    for c in without_config:
        with open(os.path.join(ckpt_root, c, "config.json"), "w") as f:
            json.dump(hf_config, f)
    torch.cuda.empty_cache()
    published = []
    ev = AutomaticEvaluator(ckpt_root, os.path.join(root, "auto_eval"),
                            publish=lambda g, r: published.append((g, r)), **TIR_AUTO_EVAL)
    # the jobs start here and run beside (t2) and (t3)
    ev.step()
    return dict(run, tool_calls=len(calls), checkpoint_root=ckpt_root, checkpoints=ckpts,
                checkpoints_saved_without_config=without_config), (ev, published, root)


def _tir_watch(ev, published: list, root: str) -> dict:
    """(t1)'s watcher: wait for its jobs, each checkpoint published once,
    in step order, with every metric."""
    t0 = time.perf_counter()
    ev.drain(timeout=TIR_AUTO_TIMEOUT)
    auto_s = time.perf_counter() - t0
    steps = [g for g, _ in published]
    logs = {g: Path(root, "auto_eval", f"globalstep{g}", "eval_job.log").read_text()
            for g in ev.statuses}
    check(steps == list(range(TIR_STEPS)) and set(ev.statuses.values()) == {"logged"},
          f"t1: the watcher published steps {steps}, statuses {ev.statuses}; the jobs' "
          f"logs end: {[text[-1500:] for text in logs.values()]}")
    for g, result in published:
        m = result.get("synthetic-arith", {})
        check(m.get("n_problems") == TIR_AUTO_EVAL["max_problems"]
              and all(math.isfinite(v) for v in m.values()), f"t1: globalstep{g}'s result {m}")
    check(not any("Traceback" in text for text in logs.values()),
          "t1: an evaluation job's log holds a Traceback")
    return dict(command=ev._cmd(ev._steps[0])[1:3], settings=TIR_AUTO_EVAL,
                drain_s=auto_s, published=published,
                k3="launched in the jobs' own processes: not in this phase's count")


def _tir_engine(dev):
    """(t2)'s model, actor and decode engine: Qwen2.5-1.5B's widths at
    CUT_LAYERS of its 28 layers with the arithmetic tokenizer's rows, bf16, random weights; the
    engine with the tokenizer (stop strings) at (c)'s slots and context."""
    tok = ArithTokenizer()
    cfg = dataclasses.replace(QWEN25_1_5B, vocab_size=tok.vocab_size, scan_layers=False,
                              remat=True, num_hidden_layers=CUT_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 50), dev)
    params["final_norm"].mul_(TIR_FINAL_NORM_SCALE)
    actor_cfg = PPOActorConfig(
        experiment_name="chip_smoke", trial_name="tir", path="", init_from_scratch=True,
        dtype="bfloat16", gradient_checkpointing=True,
        jax=JaxEngineConfig(fused_lm_loss=True), mb_spec=MicroBatchSpec(max_tokens_per_mb=8192),
        optimizer=OptimizerConfig(lr=TRAIN_LR, weight_decay=0.01, lr_scheduler_type="constant",
                                  warmup_steps_proportion=0.001, gradient_clipping=1.0),
        group_size=TIR_SAMPLES, ppo_n_minibatches=1, eps_clip=0.2, kl_ctl=0.0,
        use_decoupled_loss=True, recompute_logprob=True, temperature=1.0,
        adv_norm=NormConfig(mean_level="group", std_level="group", group_size=TIR_SAMPLES),
    )
    actor = TorchPPOActor(actor_cfg, device=dev)
    actor.model_config = cfg
    actor.create_process_group()
    actor.initialize(None, FinetuneSpec(1, TIR_PROMPTS * TIR_SAMPLES, TIR_PROMPTS * TIR_SAMPLES),
                     params=params)
    engine = TorchDecodeEngine(
        TorchDecodeConfig(random_seed=SEED, **TIR_DECODE),
        InferenceEngineConfig(max_concurrent_rollouts=TIR_PROMPTS, consumer_batch_size=TIR_PROMPTS),
        tokenizer=tok, device=dev)
    engine.set_model(params, cfg)
    del params
    engine.initialize()
    actor.connect_engine(engine, WeightUpdateMeta.from_memory())
    return cfg, actor, engine


def _tir_rounds(dev, actor, engine, cfg) -> dict:
    """(t2): `TIRWorkflow` with a python tool and the calculator on
    arithmetic markers, 8 prompts x 4 samples; tool tokens masked, the
    actor's logprobs against the decode engine's, one `ppo_update`."""
    from areal_tpu_torch.dataset import get_custom_dataset
    from areal_tpu_torch.workflow import tir

    tok = ArithTokenizer()
    items = get_custom_dataset("synthetic-arith", split="train", n_items=TIR_PROMPTS)
    py_markers, calc_markers = TIR_PY_MARKERS, TIR_CALC_MARKERS
    seen = dict(python=[], calculator=[])

    tool_s = dict(python=[], calculator=[])

    def counted(name, fn):
        def call(x):
            t0 = time.perf_counter()
            out = fn(x)
            tool_s[name].append(time.perf_counter() - t0)
            seen[name].append(out)
            return out
        return call

    tools = [tir.Tool("python", *py_markers,
                      fn=counted("python", lambda code: tir.run_python_tool(code, 8.0)),
                      output_template=tir.OUTPUT_TEMPLATE),
             tir.Tool("calculator", *calc_markers,
                      fn=counted("calculator", tir.calculator_tool().fn))]
    wf = tir.TIRWorkflow(parity_reward, GenerationHyperparameters(
        n_samples=TIR_SAMPLES, max_new_tokens=TIR_MAX_NEW, temperature=1.0), tok,
        max_tool_calls=TIR_MAX_CALLS, tools=tools)
    rounds = collections.Counter()
    agenerate = engine.agenerate

    async def counted_generate(req):
        resp = await agenerate(req)
        text = tok.decode(resp.output_tokens)
        ended = next((m for m in req.gconfig.stop if text.endswith(m)), "none")
        rounds[(resp.stop_reason, f"ends on marker {ended!r}")] += 1
        rounds["tokens"] += resp.output_len
        return resp

    engine.agenerate = counted_generate
    c0 = dict(steps=engine.decode_steps, prefills=engine._n_prefills,
              forks=engine._n_prefix_forks, suffix=engine._n_suffix_prefills,
              inplace=engine._n_prefix_inplace)
    t0 = time.perf_counter()
    try:
        batch = engine.rollout_batch([dict(x) for x in items], workflow=wf)
    finally:
        del engine.agenerate
    rollout_s = time.perf_counter() - t0
    rounds = {str(k): v for k, v in rounds.items()}
    rows = int(batch["input_ids"].shape[0])
    check(rows == TIR_PROMPTS * TIR_SAMPLES, f"t2: {rows} rows")
    gen = batch["attention_mask"].astype(bool) & (batch["loss_mask"] > 0)
    # the sampled rows' shares, under which the markers occur
    ids, counts = np.unique(batch["input_ids"][gen], return_counts=True)
    shares = {tok.decode([int(i)], skip_special_tokens=False): round(int(c) / int(gen.sum()), 4)
              for i, c in zip(ids, counts)}
    for name, outs in seen.items():
        check(len(outs) > 0, f"t2: the {name} tool never ran (markers {py_markers}, "
                             f"{calc_markers}; runs {[len(v) for v in seen.values()]}; "
                             f"rounds {rounds}; generated {shares})")
    # a python run that failed to start (`preexec_fn` in a threaded
    # process) returns its exception's name and message: reported
    py_failed = [o for o in seen["python"] if re.match(r"[A-Za-z]+(Error|Exception): ", o)
                 and not o.startswith("TimeoutError: code did not finish")]
    tokens = _tool_tokens(batch)
    check(tokens["tool_tokens"] > 0 and tokens["tool_tokens_masked"],
          f"t2: tool tokens {tokens}")
    check((batch["versions"][gen] == 0).all(), "t2: a generated token not stamped version 0")
    admissions = dict(prefills=engine._n_prefills - c0["prefills"],
                      forks=engine._n_prefix_forks - c0["forks"],
                      inplace=engine._n_prefix_inplace - c0["inplace"],
                      suffix_prefills=engine._n_suffix_prefills - c0["suffix"])
    n_logp = len(split_padded_tensor_dict_into_mb_list(batch, actor.config.mb_spec).mbs)
    t0 = time.perf_counter()
    batch["prox_logp"] = actor.compute_logp(batch)
    logp_s = time.perf_counter() - t0
    lm = batch["loss_mask"][:, 1:] > 0
    d = batch["prox_logp"][:, :-1][lm] - batch["logprobs"][:, 1:][lm]
    logp = dict(tokens=int(lm.sum()), max_abs_diff=float(np.abs(d).max()),
                mean_abs_diff=float(np.abs(d).mean()))
    check(logp["max_abs_diff"] <= LOGP_MAX_ABS_DIFF and logp["mean_abs_diff"] <= LOGP_MEAN_ABS_DIFF,
          f"t2: decode vs trainer logprobs over tool rounds: {logp}")
    actor.compute_advantages(batch)
    t0 = time.perf_counter()
    stats = actor.ppo_update(batch)
    update_s = time.perf_counter() - t0
    loss = float(stats[0]["loss"])
    check(math.isfinite(loss), f"t2: ppo_update loss {loss}")
    n_train = int(sum(st["n_mbs"] for st in stats))
    # the update goes to the engine, which serves (t3) at version 1
    t0 = time.perf_counter()
    actor.set_version(1)
    actor.update_weights(WeightUpdateMeta.from_memory())
    push_s = time.perf_counter() - t0
    check(engine.get_version() == 1, "t2: the push did not stamp version 1")
    # rows that spliced a tool's output: a version -1 past the prompt
    past = np.arange(batch["versions"].shape[1])[None] >= batch["begin_of_answer"][:, None]
    with_tool = int(((batch["versions"] == -1) & past).any(axis=1).sum())
    return dict(run="t2", model=f"Qwen2.5-1.5B widths, {CUT_LAYERS} of 28 layers, vocab 21 (the arithmetic "
                "tokenizer's rows in place of 151,936)", final_norm_scale=TIR_FINAL_NORM_SCALE, markers=dict(
                    python=py_markers, calculator=calc_markers),
                rows=rows, rows_with_a_tool_round=with_tool, generated_shares=shares,
                rounds=rounds,
                tool_runs={k: len(v) for k, v in seen.items()},
                tool_ms={k: [round(min(v) * 1e3, 1), round(max(v) * 1e3, 1)]
                         for k, v in tool_s.items() if v},
                python_tool_start_failures=len(py_failed),
                python_outputs=[o[:80] for o in seen["python"][:4]],
                calculator_outputs=[o[:40] for o in seen["calculator"][:4]],
                admissions=admissions, decode_steps=engine.decode_steps - c0["steps"],
                rollout_s=rollout_s, logp_s=logp_s, update_s=update_s, push_s=push_s, loss=loss,
                logp_mbs=n_logp, train_mbs=n_train, logp=logp, **tokens)


def _agent_rounds(engine) -> dict:
    """(t3) on (t2)'s engine: `AgentWorkflow` over `MathSingleStepAgent`,
    and `ArealOpenAI` in 2 conversations of 2 turns whose exported
    logprobs are the engine's own."""
    from areal_tpu_torch.agent.math_single_step import (
        AgentWorkflow,
        MathSingleStepAgent,
        MathSingleStepEnv,
    )
    from areal_tpu_torch.dataset import get_custom_dataset
    from areal_tpu_torch.experimental.openai import ArealOpenAI

    items = get_custom_dataset("synthetic-arith", split="test", n_items=4)
    agent = MathSingleStepAgent(GenerationHyperparameters(n_samples=2, max_new_tokens=32),
                                ArithTokenizer())
    t0 = time.perf_counter()
    rows = engine.rollout_batch([dict(x) for x in items],
                                workflow=AgentWorkflow(agent, MathSingleStepEnv))
    agent_s = time.perf_counter() - t0
    check(rows["input_ids"].shape[0] == 2 * len(items), f"t3: {rows['input_ids'].shape[0]} rows")
    resps = []
    agenerate = engine.agenerate

    async def spy(req):
        resp = await agenerate(req)
        resps.append(resp)
        return resp

    engine.agenerate = spy
    try:
        client = ArealOpenAI(engine, _ChatTokenizer(),
                             gconfig=GenerationHyperparameters(max_new_tokens=32))

        async def conversation(q):
            messages = [{"role": "user", "content": q}]
            r1 = await client.chat.completions.create(messages=messages)
            messages += [{"role": "assistant", "content": r1.choices[0].message.content},
                         {"role": "user", "content": "1+1"}]
            r2 = await client.chat.completions.create(messages=messages)
            client.set_reward(r2.id, 1.0)
            return r1.id, r2.id

        async def both():
            return await asyncio.gather(conversation("2+3"), conversation("40-1"))

        ids = asyncio.run(both())
    finally:
        del engine.agenerate
    client.apply_reward_discount(turn_discount=0.9)
    export = client.export_interactions()
    check(export["input_ids"].shape[0] == 4, f"t3: {export['input_ids'].shape[0]} exported rows")
    for r1, r2 in ids:
        check(client.get_interaction(r2).parent_id == r1, "t3: a second turn without its parent")
    by_tokens = {tuple(r.input_tokens + r.output_tokens): r for r in resps}
    for i in range(export["input_ids"].shape[0]):
        n = int(export["attention_mask"][i].sum())
        r = by_tokens[tuple(export["input_ids"][i, :n].tolist())]
        check(np.array_equal(export["logprobs"][i, r.input_len:n],
                             np.asarray(r.output_logprobs, np.float32)),
              "t3: an exported logprob differs from the engine's")
    return dict(agent_rows=int(rows["input_ids"].shape[0]), agent_s=agent_s,
                agent_rewards=rows["rewards"].tolist(), openai_calls=len(resps),
                exported_rows=int(export["input_ids"].shape[0]),
                exported_rewards=sorted(export["rewards"].tolist()))


def _verify_service() -> dict:
    """(t3) a `VerifyServer` on a free port with AREAL_VERIFIER_SERVICE
    set: `MathCodeSingleStepEnv` grades the canonical and broken solutions
    through it (a spy here counts the payloads it served), then the same
    call after `stop()` grades locally to the same list."""
    from areal_tpu_torch.agent.math_code_env import MathCodeSingleStepEnv
    from areal_tpu_torch.reward.verify_server import VerifyServer

    env = MathCodeSingleStepEnv({"q0": dict(task="code", input_output=VERIFY_IO)})
    srv = VerifyServer(max_workers=4)
    served = []
    verify = srv.verify
    srv.verify = lambda body: served.append(body["language"]) or verify(body)
    addr = srv.start("127.0.0.1", 0)
    old = os.environ.get("AREAL_VERIFIER_SERVICE")
    os.environ["AREAL_VERIFIER_SERVICE"] = addr
    try:
        t0 = time.perf_counter()
        _, remote, *_ = asyncio.run(env.step(("q0@0", VERIFY_ANSWERS)))
        remote_s = time.perf_counter() - t0
        srv.stop()
        t0 = time.perf_counter()
        _, local, *_ = asyncio.run(env.step(("q0@0", VERIFY_ANSWERS)))
        local_s = time.perf_counter() - t0
    finally:
        srv.stop()
        if old is None:
            os.environ.pop("AREAL_VERIFIER_SERVICE", None)
        else:
            os.environ["AREAL_VERIFIER_SERVICE"] = old
    payloads = math.ceil(len(VERIFY_ANSWERS) / 10)
    check(remote == VERIFY_WANT, f"t3: the service graded {remote}")
    check(served == ["CODE"] * payloads, f"t3: the service served {served}")
    check(local == remote, f"t3: after stop() the call graded {local}")
    return dict(service=addr, graded=remote, payloads_served=len(served), remote_s=remote_s,
                after_stop=local, after_stop_s=local_s)


def _code_eval(dev, ckpt: str) -> dict:
    """(t3) `eval_and_aggregate --task code` in process on (t1)'s
    checkpoint and 8 HumanEval-style fixture problems: K3 = decode steps
    x L, `metrics.json` written."""
    from areal_tpu_torch.evaluation import eval_and_aggregate

    # a relative dataset name: each dataset's outputs go to --output-path
    # joined with its name (an absolute name would be the file itself)
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as d:
        data = os.path.join(os.path.relpath(d), "humaneval")
        with open(data, "w") as f:
            for i in range(CODE_EVAL_PROBLEMS):
                f.write(json.dumps(dict(
                    task_id=f"Fix/{i}", prompt=f"def f{i}(x):\n", entry_point=f"f{i}",
                    test=f"def check(c):\n    assert c({i}) == {i + 1}\n")) + "\n")
        out = os.path.join(d, "out")
        with _observe_loop() as seen:
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = 0
            t0 = time.perf_counter()
            eval_and_aggregate.main(CODE_EVAL + ["--data-names", data, "--model-path", ckpt,
                                                 "--output-path", out], device=dev)
            wall = time.perf_counter() - t0
            k3 = pa.launches
            # ---- end of the main path ----
        with open(os.path.join(out, data, "metrics.json")) as f:
            metrics = json.load(f)
    eng = seen["engines"][0]
    L = eng.model_config.num_hidden_layers
    check(k3 == L * eng.decode_steps > 0, f"t3 eval: K3 {k3}, want {L} x {eng.decode_steps}")
    check(metrics["n_problems"] == CODE_EVAL_PROBLEMS and metrics["n_samples"] == 2
          and all(math.isfinite(v) for v in metrics.values()), f"t3 eval: {metrics}")
    return dict(argv=CODE_EVAL, wall_s=wall, decode_steps=eng.decode_steps,
                launches=dict(paged_attention=k3), metrics=metrics)


def phase_tir(dev: torch.device) -> dict:
    """Code and tool RL on the card:

    (t1) `tir_math.py` (the GRPO entry point with `workflow=tir`) on
         `tir_math.yaml` with its offline smoke overrides at loop cell
         (c)'s size: Qwen2.5-1.5B at full width, CUT_LAYERS of its 28
         layers, random weights
         from seed 0, `synthetic-arith`, 8 prompts x 4 samples, 256 new
         tokens, 32 slots, context 512, 128-step chunks,
         `ppo_n_minibatches` 2, `TIR_STEPS` step, a checkpoint every step; then the
         checkpoint watcher (`AutomaticEvaluator`, its default command)
         scores each checkpoint in a child process on the card, beside
         (t2) and (t3), and publishes each once, in step order. The arithmetic tokenizer
         cannot spell the tool's fence: zero tool calls, reported. K3 = L x
         decode steps, K1 = L x (logp mbs + 2 x trained mbs), K2a = K2b =
         L x trained mbs, the version lag within `max_head_offpolicyness`.
    (t2) tool rounds: `TIRWorkflow` with a python tool and the calculator
         on markers of arithmetic characters, at Qwen2.5-1.5B's widths and
         CUT_LAYERS of its 28 layers, with the arithmetic tokenizer's 21
         rows in place of 151,936 and the random weights' final norm scaled by
         TIR_FINAL_NORM_SCALE (so that the sampler draws the rows near
         uniformly and meets the markers), 8 prompts x 4 samples,
         `max_tool_calls` 4. Each tool
         runs; tool tokens have loss mask 0, logprob 0 and version -1; the
         actor's `compute_logp` agrees with the decode logprobs on the
         generated tokens within the train phase's bounds; one
         `ppo_update`; the engine's forks and suffix prefills reported.
    (t3) a `VerifyServer` on a free port with AREAL_VERIFIER_SERVICE set:
         `MathCodeSingleStepEnv` grades 4 canonical and 4 broken solutions
         to [1, 1, 1, 1, 0, 0, 0, 0] in one payload, and the same after
         `stop()` grades locally alike; `AgentWorkflow` and `ArealOpenAI`
         (2 conversations x 2 turns) on (t2)'s engine, the exported
         logprobs the engine's; `eval_and_aggregate --task code` on 8
         fixture problems and (t1)'s checkpoint writes `metrics.json`."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        t1, watch = _tir_loop(dev, root)
        torch.cuda.empty_cache()
        try:
            cfg, actor, engine = _tir_engine(dev)
            try:
                # ---- the main path: counts to 0 just before, read just after ----
                pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
                t2 = _tir_rounds(dev, actor, engine, cfg)
                agents = _agent_rounds(engine)
                t2_launches = dict(paged_attention=pa.launches, **_flash_launches())
                # ---- end of the main path ----
                L = cfg.num_hidden_layers
                steps = engine.decode_steps
            finally:
                engine.destroy()
                actor.destroy()
            del engine, actor
            torch.cuda.empty_cache()
            want = dict(paged_attention=L * steps,
                        flash_attention_fwd=L * (t2["logp_mbs"] + 2 * t2["train_mbs"]),
                        flash_attention_bwd_dq=L * t2["train_mbs"],
                        flash_attention_bwd_dkv=L * t2["train_mbs"])
            check(t2_launches == want, f"t2/t3: launches {t2_launches}, formulas {want}")
            t3 = dict(run="t3", verify=_verify_service(), agents=agents,
                      code_eval=_code_eval(dev, os.path.join(t1["checkpoint_root"],
                                                             t1["checkpoints"][-1])))
            t1["auto_eval"] = _tir_watch(*watch)
        finally:
            # a failed phase leaves no evaluation job running
            for job in watch[0]._steps.values():
                if job.process is not None and job.process.poll() is None:
                    job.process.kill()
                    job.process.wait()
    t2["launches"] = t2_launches
    t2["formulas"] = dict(paged_attention="L x decode steps (the TIR rounds and the agents)",
                          flash_attention_fwd="L x (logp mbs + 2 x trained mbs)",
                          flash_attention_bwd_dq="L x trained mbs",
                          flash_attention_bwd_dkv="L x trained mbs")
    emit("tir", wall_s=time.perf_counter() - t0,
         entry_point="areal_tpu_torch/examples/tir_math.py:main",
         workflow="areal_tpu_torch/workflow/tir.py", yaml=TIR_YAML, full_model="Qwen2.5-1.5B",
         full_source=QWEN25_1_5B_SOURCE, runs=[t1, t2, t3])
    total = {k: t1["launches"][k] + t2_launches[k] for k in t1["launches"]}
    total["paged_attention"] += t3["code_eval"]["launches"]["paged_attention"]
    return dict(launches=total, by_run=dict(t1=t1["launches"], t2=t2_launches,
                                            t3=t3["code_eval"]["launches"]))


def tir_only() -> int:
    """`--tir`: the device and build phases, then the tir phase alone."""
    dev, smi = phase_device()
    phase_build()
    out = phase_tir(dev)
    print(smi, flush=True)
    print(json.dumps({"tir_launches": out["launches"]}), flush=True)
    return 0


def hf_path_only() -> int:
    """`--hf-path`: the device and build phases, then the hf_path phase
    alone."""
    dev, smi = phase_device()
    phase_build()
    out = phase_hf_path(dev)
    print(smi, flush=True)
    print(json.dumps({"hf_path_launches": out["launches"]}), flush=True)
    return 0


def trainers_only() -> int:
    """`--trainers`: the device and build phases, then the ppo, rw and
    multi_turn phases alone."""
    dev, smi = phase_device()
    phase_build()
    out = dict(ppo=phase_ppo(dev)["launches"])
    torch.cuda.empty_cache()
    out["rw"] = phase_rw(dev)["launches"]
    torch.cuda.empty_cache()
    out["multi_turn"] = phase_multi_turn(dev)["launches"]
    print(smi, flush=True)
    print(json.dumps({"trainers_launches": out}), flush=True)
    return 0


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


def phase_flash_line(dev: torch.device, train: dict, paths: dict[str, dict]) -> list[dict]:
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
            launches=sum(p[name] for p in paths.values()),
            launches_by_path={path: p[name] for path, p in paths.items()},
            max_abs_err=errs[name], max_err=errs[name],
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


# ---------------------------------------------------------------------------
# phase: chaos — the fault-injection harness on the GRPO path's kernels
# ---------------------------------------------------------------------------

# (x1) trainer chaos: a colocated GRPO loop killed at each seam and resumed
CHAOS_KILL_SITES = ("recover.dump.save", "recover.dump.marker", "train.step",
                    "train.weights.push")
CHAOS_KILL_STEP = 2
CHAOS_TRAIN = dict(n_prompts=8, group=2, prompt_len=48, new_tokens=64, steps=3,
                   mb_tokens=4096)
CHAOS_DECODE = dict(max_running_requests=16, context_length=256, page_size=128,
                    new_tokens_per_chunk=64)
# Qwen2.5-1.5B's widths at 1 of its 28 layers, and AdamW's first moment in
# bf16: the legs build the trainer and the decode engine seven times, and
# load or dump a recovery point (the embedding's 233M parameters dominate
# it) twelve times
CHAOS_LAYERS = 1
CHAOS_LR = 1e-3
# (x2) fleet chaos: two in-process servers, 8 greedy requests
# one prefill a pass: a prompt's KV is the same bytes whether it was
# prefilled beside others or alone, so the probes around the failed
# commit fork from donors whose rows any admission order gives alike
CHAOS_SERVE = dict(max_running_requests=8, context_length=256, page_size=128,
                   new_tokens_per_chunk=32, max_prefill_tokens=64)
CHAOS_REQUESTS = 8
CHAOS_PROMPT_LEN = (16, 48)  # under a page: no prefix reuse between passes
CHAOS_MAX_NEW = 32
CHAOS_TIMEOUT = 300


def chaos_reward(prompt, completion, prompt_ids, completion_ids, **kwargs) -> float:
    """`bench.py` chaostrain's reward: a function of the first 8 tokens."""
    return float(sum(completion_ids[:8]) % 7) / 7.0


def _fingerprint(params: dict) -> str:
    """sha256 of every parameter's bytes, in name order."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        t = params[name].detach().contiguous().cpu()
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _stat(stats: list[dict], suffix: str) -> float:
    s = stats[0]
    for k in sorted(s):
        if k == suffix or k.endswith("/" + suffix):
            return float(s[k])
    raise KeyError(f"no stat ending in {suffix!r}: {sorted(s)[:8]}")


def _link_tree(src: str, dst: str) -> None:
    """Copy a recovery file root: its checkpoint files (written once, never
    changed in place) as hard links, the sample ledger's journal (appended
    and rolled back in place) as a copy."""
    def link_or_copy(a, b):
        if os.path.basename(a) == "ledger.wal":
            return shutil.copy2(a, b)
        os.link(a, b)
        return b

    shutil.copytree(src, dst, copy_function=link_or_copy)


def _wave_rollout(engine, data, workflow, n_requests: int):
    """`rollout_batch` with every request of the batch admitted in one
    wave: queued while the decode engine is paused, then released, so a
    replayed step prefills and decodes in the same shapes as its first
    run."""
    engine.pause_generation()
    out: dict = {}

    def run():
        try:
            out["batch"] = engine.rollout_batch(data, workflow=workflow)
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + CHAOS_TIMEOUT
    while engine._request_q.qsize() < n_requests and t.is_alive():
        check(time.monotonic() < deadline, "the chaos wave was never enqueued")
        time.sleep(0.001)
    engine.continue_generation()
    t.join(CHAOS_TIMEOUT)
    if "error" in out:
        raise out["error"]
    check("batch" in out, f"the chaos wave did not finish in {CHAOS_TIMEOUT} s")
    return out["batch"]


def chaos_train(dev, cfg, root: str, sizes: dict | None = None) -> dict:
    """(x1): `bench.py` chaostrain on the port. A colocated GRPO loop
    (`TorchDecodeEngine` + `TorchPPOActor`, `RLVRWorkflow`, an unshuffled
    `SimpleDataLoader`, greedy decoding, batches sorted by rollout id,
    `RecoverHandler` with a recovery point every step and the `SampleWAL`)
    runs unfaulted as the oracle. Then the kill legs, one per kill site, in
    a chain on one file root (the oracle's recovery point of the step
    before `CHAOS_KILL_STEP`, its files hard-linked and its journal
    copied): each leg is a trainer restarted from the root's newest
    committed point and killed at that step by an `InjectedFault`, torn
    down and resumed by the next leg's trainer, the last by the "resume"
    leg, which runs to the end. Last, a leg whose newest committed step is
    torn (a `recover.load` abort) and must resume from its predecessor.
    Per leg: the step it was killed at, the step and version it resumed
    at (the committed one, in the trainer and the engine), the WAL at the
    resume (one entry per committed step), and the loss of every step it
    trained equal to the oracle's; for the legs that run to the end, one
    WAL entry per step with every trajectory once, versions that never go
    back, and the final weights' sha256 equal to the oracle's; and (on the
    card) K3 = L x decode steps, K1 = L x (logp mbs + 2 x trained mbs)
    under remat, K2a = K2b = L x trained mbs."""
    from areal_tpu_torch.api.cli_args import RecoverConfig
    from areal_tpu_torch.api.io_struct import StepInfo
    from areal_tpu_torch.core import fault_injection
    from areal_tpu_torch.core.fault_injection import FaultPlan, FaultPoint, InjectedFault
    from areal_tpu_torch.core.sample_ledger import SampleWAL
    from areal_tpu_torch.dataset import SimpleDataLoader
    from areal_tpu_torch.utils import recover as recover_mod
    from areal_tpu_torch.utils.recover import RecoverHandler, ledger_wal_path
    from areal_tpu_torch.workflow.rlvr import RLVRWorkflow

    sz = dict(CHAOS_TRAIN, **(sizes or {}))
    n_prompts, group, steps = sz["n_prompts"], sz["group"], sz["steps"]
    kill = CHAOS_KILL_STEP
    samples = n_prompts * group
    L = cfg.num_hidden_layers
    rng = np.random.RandomState(SEED + 11)
    # one epoch is `steps` batches: every leg sees the same prompts in the
    # same order (the loader's position is checkpointed state)
    dataset = [dict(input_ids=rng.randint(1, cfg.vocab_size, (sz["prompt_len"],)).tolist())
               for _ in range(n_prompts * steps)]
    ft_spec = FinetuneSpec(1, len(dataset), samples)
    decode = dict(CHAOS_DECODE, **sz.get("decode", {}))
    counts = dict(logp_mbs=0, train_mbs=0, decode_steps=0)

    def rcfg(fileroot):
        return RecoverConfig(experiment_name="chip-smoke", trial_name="chaos",
                             fileroot=fileroot, mode="fault", freq_steps=1, keep_last=2)

    def build(fileroot):
        env = types.SimpleNamespace(rcfg=rcfg(fileroot))
        actor = TorchPPOActor(PPOActorConfig(
            experiment_name="chip-smoke", trial_name="chaos", path="",
            init_from_scratch=True,  # the engine's fixed init seed: the same weights every leg
            dtype=cfg.dtype, gradient_checkpointing=cfg.remat,
            mb_spec=MicroBatchSpec(max_tokens_per_mb=sz["mb_tokens"]),
            optimizer=OptimizerConfig(lr=CHAOS_LR, warmup_steps_proportion=0.0,
                                      lr_scheduler_type="constant", gradient_clipping=1.0,
                                      moment_dtype=cfg.dtype),
            group_size=group, ppo_n_minibatches=1, eps_clip=0.2, kl_ctl=0.0,
            # greedy group members are identical: group-level norms would
            # zero every advantage and the oracle would never move
            adv_norm=NormConfig(mean_level="batch", std_level="batch", group_size=group),
            use_decoupled_loss=True, temperature=1.0), device=dev)
        actor.model_config = cfg
        actor.create_process_group()
        actor.initialize(None, ft_spec)
        rollout = TorchDecodeEngine(
            TorchDecodeConfig(random_seed=SEED, dtype=cfg.dtype, kv_cache_dtype=cfg.dtype,
                              **decode),
            InferenceEngineConfig(max_concurrent_rollouts=samples * 2,
                                  consumer_batch_size=samples,
                                  max_head_offpolicyness=steps + 2, request_timeout=3600),
            device=dev)
        rollout.set_model(actor.params, cfg)
        rollout.initialize()
        actor.connect_engine(rollout, WeightUpdateMeta.from_memory())
        rollout.attach_ledger_wal(ledger_wal_path(env.rcfg))
        env.actor, env.rollout = actor, rollout
        env.workflow = RLVRWorkflow(chaos_reward, GenerationHyperparameters(
            n_samples=group, max_new_tokens=sz["new_tokens"], greedy=True))
        env.loader = SimpleDataLoader(dataset, batch_size=n_prompts, shuffle=False)
        env.handler = RecoverHandler(env.rcfg, ft_spec)
        return env

    def destroy(env):
        counts["decode_steps"] += env.rollout.decode_steps
        env.rollout.destroy()
        env.actor.destroy()
        env.actor = env.rollout = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def si(g):
        return StepInfo(epoch=0, epoch_step=g, global_step=g, steps_per_epoch=steps)

    def one_step(env, g, out) -> float:
        batch = _wave_rollout(env.rollout, next(env.data_iter), env.workflow, samples)
        # the executor hands results back in completion order: sort by the
        # ledger's rollout id so a replayed step trains the same batch
        order = np.argsort(np.asarray(batch["rollout_id"]), kind="stable")
        batch = {k: np.asarray(v)[order] for k, v in batch.items()}
        counts["logp_mbs"] += len(split_padded_tensor_dict_into_mb_list(
            batch, env.actor.config.mb_spec).mbs)
        batch["prox_logp"] = env.actor.compute_logp(batch)
        env.actor.compute_advantages(batch)
        stats = env.actor.ppo_update(batch)
        counts["train_mbs"] += int(_stat(stats, "n_mbs"))
        out["trained"][g] = _stat(stats, "loss")
        env.actor.set_version(g + 1)
        env.rollout.pause()
        env.actor.update_weights(None)
        env.rollout.set_version(g + 1)
        env.rollout.resume()
        return out["trained"][g]

    def dump(env, g) -> bool:
        """True when a dump seam fired: the handler degraded, and what is
        on disk is what a trainer that died there leaves."""
        before = fault_injection.snapshot()
        env.handler.dump(env.actor, si(g), dataloader=env.loader, rollout=env.rollout)
        after = fault_injection.snapshot()
        return any(after.get(k, 0) > before.get(k, 0) for k in after)

    def trainer(fileroot, committed: dict, resume: bool, plan=None, load_plan=None,
                snapshot=None) -> dict:
        """One trainer on `fileroot`: fresh, or restarted from its newest
        committed recovery point (with `load_plan` armed for the load only),
        then the steps to the end with `plan` armed, until an
        `InjectedFault` kills it. `snapshot` receives a copy of the file
        root once step `kill - 1` has committed (the kill legs start from
        it: the steps before the kill are the oracle's). Its "losses" are
        the committed steps', "trained" every loss it computed."""
        env = build(fileroot)
        out = dict(start=0, crashed_at=None, losses=dict(committed), trained={})
        try:
            if resume:
                fault_injection.configure(load_plan)
                try:
                    info = env.handler.load(env.actor, dataloader=env.loader,
                                            inference_engine=env.rollout,
                                            weight_update_meta=WeightUpdateMeta.from_memory())
                finally:
                    fault_injection.deactivate()
                check(info is not None, f"{fileroot}: no recoverable state after the crash")
                out.update(start=info.last_step_info.next().global_step,
                           resumed_version=env.actor.get_version(),
                           engine_version=env.rollout.get_version(),
                           wal_at_resume=check_wal(
                               SampleWAL(ledger_wal_path(env.rcfg)).replay()))
            env.data_iter = iter(env.loader)
            fault_injection.configure(plan)
            for g in range(out["start"], steps):
                try:
                    loss = one_step(env, g, out)
                except InjectedFault:
                    out["crashed_at"] = g
                    break
                if dump(env, g):
                    out["crashed_at"] = g
                    break
                out["losses"][g] = loss
                if snapshot is not None and g == kill - 1:
                    _link_tree(fileroot, snapshot)
            if out["crashed_at"] is None:
                out.update(fp=_fingerprint(env.actor.params),
                           wal=SampleWAL(ledger_wal_path(env.rcfg)).replay())
        finally:
            fault_injection.deactivate()
            destroy(env)
        return out

    def check_wal(wal):
        """The journal's entries and versions, and the rollouts of the
        steps it holds lost or journaled twice."""
        versions = [e["version"] for e in wal]
        rids = [r for e in wal for r in e["rids"]]
        return dict(entries=len(wal), versions=versions,
                    lost=len(wal) * n_prompts - len(set(rids)),
                    duplicated=len(rids) - len(set(rids)))

    def leg_counts():
        c = dict(counts)
        counts.update(logp_mbs=0, train_mbs=0, decode_steps=0)
        return c

    def run_launches(fn, *args):
        """`fn(*args)` with the kernel counts set to 0 just before and read
        just after: (its result, the counts)."""
        # ---- the main path: counts to 0 just before, read just after ----
        pa.launches = fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        out = fn(*args)
        launches = dict(paged_attention=pa.launches, flash_attention_fwd=fa.launches_fwd,
                        flash_attention_bwd_dq=fa.launches_dq,
                        flash_attention_bwd_dkv=fa.launches_dkv)
        # ---- end of the main path ----
        return out, launches

    def want_of(c):
        return dict(paged_attention=L * c["decode_steps"],
                    flash_attention_fwd=L * (c["logp_mbs"] + (2 if cfg.remat else 1)
                                             * c["train_mbs"]),
                    flash_attention_bwd_dq=L * c["train_mbs"],
                    flash_attention_bwd_dkv=L * c["train_mbs"])

    total = dict.fromkeys(("paged_attention", "flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv"), 0)
    legs = []

    def finish_leg(tag, t0, launches, c, res, oracle):
        """Record one leg: its kill, its resume and the losses it trained
        against the oracle's; for a leg that ran to the end, its WAL and
        its final weights too."""
        want = want_of(c)
        row = dict(leg=tag, seconds=time.perf_counter() - t0, crashed_at=res["crashed_at"],
                   resumed_at=res["start"], resumed_version=res.get("resumed_version"),
                   wal_at_resume=res.get("wal_at_resume"), trained_steps=sorted(res["trained"]),
                   launches=launches, formulas=want, mbs=c)
        if "wal_at_resume" in res:
            committed = list(range(res["start"]))
            check(res["resumed_version"] == res["start"] == res["engine_version"],
                  f"{tag}: resumed at step {res['start']} with trainer version "
                  f"{res['resumed_version']}, engine version {res['engine_version']}")
            check(res["wal_at_resume"] == dict(entries=res["start"], versions=committed, lost=0,
                                               duplicated=0),
                  f"{tag}: the journal at the resume is {res['wal_at_resume']}, "
                  f"want the committed steps {committed}")
        if oracle is not None:
            diff = [g for g in sorted(res["trained"])
                    if res["trained"][g] != oracle["losses"][g]]
            row["loss_steps_differing"] = diff
            check(not diff, f"{tag}: losses differ from the oracle's at steps {diff}: "
                            f"{[res['trained'][g] for g in diff]} vs "
                            f"{[oracle['losses'][g] for g in diff]}")
        if res["crashed_at"] is None:
            wal = check_wal(res["wal"])
            row.update(wal=wal, losses=[res["losses"][g] for g in range(steps)],
                       fingerprint=res["fp"][:16])
            check(wal == dict(entries=steps, versions=list(range(steps)), lost=0, duplicated=0),
                  f"{tag}: not exactly once: {wal}")
            if oracle is not None:
                check(res["fp"] == oracle["fp"], f"{tag}: final weights differ from the oracle's")
        if dev.type == "cuda":
            check(launches == want, f"{tag}: launches {launches}, formulas {want}")
        for k in total:
            total[k] += launches[k]
        legs.append(row)
        return row

    # -- the oracle ----------------------------------------------------
    t0 = time.perf_counter()
    oracle_root = os.path.join(root, "oracle")
    chain_root = os.path.join(root, "chain")
    oracle, launches = run_launches(trainer, oracle_root, {}, False, None, None, chain_root)
    o_losses = oracle["losses"]
    check(oracle["crashed_at"] is None and len(o_losses) == steps,
          f"the oracle crashed at {oracle['crashed_at']}")
    finish_leg("oracle", t0, launches, leg_counts(), oracle, None)
    check(len(set(o_losses.values())) > 1, f"the oracle's losses never move: {o_losses}")

    # -- the kill legs, chained on one file root that starts as the
    # oracle's recovery point of step kill - 1: each trainer is restarted
    # from the newest committed point and killed at step `kill` (its seam's
    # first visit); the next leg's trainer is its resume ----------------
    committed = {g: o_losses[g] for g in range(kill)}
    for site in CHAOS_KILL_SITES:
        t0 = time.perf_counter()
        plan = FaultPlan(seed=5, points=[FaultPoint(site=site, mode="abort", at=(0,),
                                                    times=1)])
        res, launches = run_launches(trainer, chain_root, committed, True, plan)
        check(res["crashed_at"] == kill,
              f"{site}: crashed at step {res['crashed_at']}, planned {kill}")
        check(res["start"] == kill, f"{site}: restarted at step {res['start']}, want {kill}")
        finish_leg(site, t0, launches, leg_counts(), res, oracle)
    t0 = time.perf_counter()
    res, launches = run_launches(trainer, chain_root, committed, True)
    check(res["start"] == kill, f"resume: resumed at step {res['start']}, want {kill}")
    finish_leg("resume", t0, launches, leg_counts(), res, oracle)
    shutil.rmtree(chain_root, ignore_errors=True)

    # -- the newest committed step torn: resume from its predecessor ------
    t0 = time.perf_counter()
    recover_mod.reset_metrics()
    torn_plan = FaultPlan(seed=5, points=[FaultPoint(site="recover.load", mode="abort",
                                                     at=(0,), times=1)])
    res, launches = run_launches(trainer, oracle_root,
                                 {g: o_losses[g] for g in range(steps - 1)}, True, None,
                                 torn_plan)
    skipped = recover_mod.get_metrics().get("recover_torn_skipped_total", 0)
    check(skipped == 1, f"torn leg: {skipped} candidates skipped, want 1")
    check(res["start"] == steps - 1, f"torn leg: resumed at {res['start']}, want {steps - 1}")
    row = finish_leg("recover.load (newest torn)", t0, launches, leg_counts(), res, oracle)
    row["torn_skipped"] = skipped
    return dict(model=dict(layers=L, hidden=cfg.hidden_size, vocab=cfg.vocab_size,
                           dtype=cfg.dtype), sizes=sz, kill_step=kill, legs=legs,
                launches=total)


def _chaos_wave(client, prompts: dict, tag: str) -> dict:
    """Each request of `prompts` once through `client`, concurrently:
    rid -> tokens."""
    async def go():
        async def one(rid):
            r = await client.agenerate(ModelRequest(
                rid=f"{tag}-{rid}", input_ids=prompts[rid],
                gconfig=GenerationHyperparameters(max_new_tokens=CHAOS_MAX_NEW, greedy=True)))
            return rid, list(r.output_tokens)

        return await asyncio.gather(*[one(rid) for rid in prompts])

    out = asyncio.run(asyncio.wait_for(go(), CHAOS_TIMEOUT))
    check(len({rid for rid, _ in out}) == len(prompts), f"{tag}: a request was lost")
    return dict(out)


def _served_counts(addrs: list[str]) -> dict:
    """The servers' admissions (prefills, forks and suffix prefills),
    generated tokens and idempotency hits, summed, from `/metrics`."""
    from areal_tpu_torch.utils.http import request_with_retry

    tot = collections.Counter()
    for a in addrs:
        m = request_with_retry(a, "/metrics", method="GET", max_retries=1, timeout=30)
        tot["admissions"] += (m["prefills_total"] + m["prefix_forks_total"]
                              + m["prefix_inplace_total"] + m["suffix_prefills_total"])
        tot["generated_tokens"] += m["generated_tokens_total"]
        tot["idem_hits"] += m["idem_hits_total"]
        tot["decode_steps"] += m["kernel_launches"]["decode_steps"]
    return dict(tot)


def chaos_fleet(dev, cfg) -> dict:
    """(f2): `tests/test_chaos.py`'s chaos smoke through the router
    (:521-605). Two port `DecodeServer`s in this process, each over a
    `TorchDecodeEngine` on the card with the same weights, behind the
    port's `DecodeRouter`, which a `RemoteInfEngine` finds through
    name_resolve; the client sends 8 greedy requests fault-free, then again
    under a plan of a `client.http.send` abort, a `client.http.recv` error
    after effect, a torn `client.http.body`, a `server.generate` delay, a
    `router.schedule` abort of both tries of one request (it falls back to
    the client's local policy) and a `router.poll` delay. Checks: 0 lost,
    tokens equal to the fault-free pass, one generation per request on the
    servers together (their `/metrics`), at least 2 idempotency hits, all
    four modes and both router seams fired. Then a dcn push to one server
    with a `server.weights.commit` abort: the server keeps its version and
    its greedy probes; the next push lands version 1, and its probes equal
    an in-process engine holding the pushed weights."""
    from areal_tpu_torch.api.cli_args import RouterConfig
    from areal_tpu_torch.core import fault_injection
    from areal_tpu_torch.core.fault_injection import FaultPlan, FaultPoint
    from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine
    from areal_tpu_torch.engine.torch_engine import TorchTrainEngine
    from areal_tpu_torch.launcher.decode_server import DecodeServer
    from areal_tpu_torch.launcher.router import DecodeRouter
    from areal_tpu_torch.utils import name_resolve
    from areal_tpu_torch.utils.http import HttpRequestError

    L = cfg.num_hidden_layers
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 40), dev)
    dcfg = TorchDecodeConfig(random_seed=SEED, dtype=cfg.dtype, kv_cache_dtype=cfg.dtype,
                             **CHAOS_SERVE)
    engines, servers = [], []
    out: dict = {}
    name_resolve.reconfigure(NameResolveConfig(type="memory"))
    router = DecodeRouter("chip-smoke", "chaos", config=RouterConfig(health_poll_interval=0.2))
    try:
        for _ in range(2):
            eng = TorchDecodeEngine(dcfg, device=dev)
            eng.set_model(params, cfg)
            eng.initialize()
            engines.append(eng)
            servers.append(DecodeServer(dcfg, engine=eng))
        addrs = [s.start("127.0.0.1", 0) for s in servers]
        for srv in servers:
            srv.register("chip-smoke", "chaos", srv.addr)
        router.start("127.0.0.1", 0)
        _wait_router(router, addrs)
        client = RemoteInfEngine(InferenceEngineConfig(
            experiment_name="chip-smoke", trial_name="chaos", request_timeout=CHAOS_TIMEOUT,
            request_retries=3, fleet_failover_retries=2, setup_timeout=60))
        client.addresses = list(addrs)
        rng = np.random.default_rng(SEED + 41)
        prompts = {f"r{i}": rng.integers(1, cfg.vocab_size, int(rng.integers(
            *CHAOS_PROMPT_LEN, endpoint=True))).tolist() for i in range(CHAOS_REQUESTS)}
        # ---- the main path: counts to 0 just before, read just after ----
        pa.launches = 0
        c0 = _served_counts(addrs)
        ref = _chaos_wave(client, prompts, "ref")
        c1 = _served_counts(addrs)
        plan = FaultPlan(seed=77, points=[
            FaultPoint(site="client.http.send", mode="abort", at=(1,), times=1,
                       match={"endpoint": "/generate"}),
            FaultPoint(site="client.http.recv", mode="error_after_effect", at=(0,), times=1,
                       match={"endpoint": "/generate"}),
            FaultPoint(site="client.http.body", mode="torn", at=(2,), times=1,
                       match={"endpoint": "/generate"}),
            FaultPoint(site="server.generate", mode="delay", at=(1,), times=1, delay_s=0.1),
            # both tries of one request's placement: it falls back to the
            # client's local policy
            FaultPoint(site="router.schedule", mode="abort", times=2,
                       match={"qid": "chaos-r3"}),
            FaultPoint(site="router.poll", mode="delay", at=(0,), times=1, delay_s=0.2),
        ])
        ref_routed = router._metrics()["schedules_total"]
        fault_injection.configure(plan)
        t0 = time.perf_counter()
        try:
            chaos = _chaos_wave(client, prompts, "chaos")
        finally:
            fired = fault_injection.snapshot()
            fault_injection.deactivate()
        chaos_s = time.perf_counter() - t0
        check(fired.get("router.schedule|abort") == 2 and fired.get("router.poll|delay") == 1
              and client._router == "", f"router seams: fired {fired}, client router "
                                        f"{client._router!r}")
        check(ref_routed == len(prompts), f"the fault-free pass placed {ref_routed} requests "
                                          f"through the router, want {len(prompts)}")
        c2 = _served_counts(addrs)
        for e in engines:
            e.pause_generation()  # drain the pass in flight before reading K3
            e.continue_generation()
        k3 = pa.launches
        # ---- end of the main path ----
        d_ref = {k: c1[k] - c0[k] for k in c0}
        d_chaos = {k: c2[k] - c1[k] for k in c1}
        out["wave"] = dict(requests=len(prompts), fired=fired, seconds=chaos_s,
                           ref=d_ref, chaos=d_chaos, tokens_equal=chaos == ref,
                           launches=dict(paged_attention=k3),
                           formula=dict(paged_attention=f"{L} x {c2['decode_steps']} decode "
                                                        f"steps"))
        check(chaos == ref, f"chaos streams differ from the fault-free pass: "
                            f"{[r for r in ref if chaos.get(r) != ref[r]]}")
        for tag, d in (("fault-free", d_ref), ("chaos", d_chaos)):
            check(d["admissions"] == len(prompts),
                  f"{tag} pass: {d['admissions']} admissions for {len(prompts)} requests")
            check(d["generated_tokens"] == len(prompts) * CHAOS_MAX_NEW,
                  f"{tag} pass: {d['generated_tokens']} tokens generated, want "
                  f"{len(prompts) * CHAOS_MAX_NEW}")
        check(d_chaos["idem_hits"] >= 2, f"{d_chaos['idem_hits']} idempotency hits, want >= 2")
        check({k.split("|")[1] for k in fired} == {"abort", "error_after_effect", "delay",
                                                     "torn"}, f"modes fired: {fired}")
        out["wave"]["router_schedules"] = dict(fault_free=ref_routed,
                                               total=router._metrics()["schedules_total"])
        if dev.type == "cuda":
            check(k3 == L * c2["decode_steps"],
                  f"K3 {k3} launches, formula {L} x {c2['decode_steps']} decode steps")

        # -- a dcn push whose commit aborts, then one that lands ----------
        new = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 42), dev)
        trainer = TorchTrainEngine(TrainEngineConfig(
            experiment_name="chip-smoke", trial_name="chaos", init_from_scratch=True,
            dtype=cfg.dtype, optimizer=None), device=dev)
        trainer.create_process_group()
        trainer.model_config = cfg
        trainer.initialize(None, None, params=new)
        pusher = RemoteInfEngine(InferenceEngineConfig(
            experiment_name="chip-smoke", trial_name="chaos-push", request_retries=1,
            request_timeout=CHAOS_TIMEOUT, setup_timeout=60))
        pusher.addresses = [addrs[0]]
        trainer.connect_engine(pusher, WeightUpdateMeta(type="dcn"))
        probe_prompts = {f"p{i}": p for i, p in enumerate(list(prompts.values())[:4])}

        def probes(client_or_engine) -> dict:
            got = {}
            for rid, p in probe_prompts.items():  # one at a time
                req = ModelRequest(rid=f"probe-{rid}-{time.monotonic_ns()}", input_ids=p,
                                   gconfig=GenerationHyperparameters(
                                       max_new_tokens=CHAOS_MAX_NEW, greedy=True))
                got[rid] = list(client_or_engine.generate(req).output_tokens)
            return got

        before = probes(pusher)
        trainer.set_version(1)
        fault_injection.configure(FaultPlan(points=[
            FaultPoint(site="server.weights.commit", mode="abort", at=(0,), times=1)]))
        try:
            trainer.update_weights()
            aborted = False
        except HttpRequestError:
            aborted = True
        finally:
            fired = fault_injection.snapshot()
            fault_injection.deactivate()
        v_after_abort = engines[0].get_version()
        after_abort = probes(pusher)
        check(aborted and fired == {"server.weights.commit|abort": 1},
              f"the commit abort did not fail the push (fired {fired})")
        check(v_after_abort == 0 and after_abort == before,
              f"after the aborted commit: version {v_after_abort}, probes changed "
              f"{after_abort != before}")
        trainer.update_weights()
        v_pushed = engines[0].get_version()
        pushed = probes(pusher)
        # the weights as the wire carries them: each float tensor cast to bf16
        wire = {k: v.detach().to(torch.bfloat16).to(v.dtype) for k, v in trainer.params.items()}
        engines[1].update_weights_from_distributed(WeightUpdateMeta.from_memory(), wire, cfg,
                                                   version=1)
        in_process = probes(engines[1])
        check(v_pushed == 1, f"the second push landed version {v_pushed}, want 1")
        check(pushed == in_process, "pushed server's probes differ from the in-process engine's")
        check(pushed != before, "the pushed weights did not change the probes")
        out["push"] = dict(aborted=aborted, fired=fired, version_after_abort=v_after_abort,
                           probes_kept=after_abort == before, version_after_push=v_pushed,
                           probes_equal_in_process=pushed == in_process,
                           client=pusher.get_metrics())
        trainer.destroy()
    finally:
        fault_injection.deactivate()
        router.stop()
        for s in servers:
            s.stop()
        for e in engines:
            e.destroy()
        name_resolve.reconfigure(NameResolveConfig(type="memory"))
    out["launches"] = dict(out["wave"]["launches"])
    return out


def phase_chaos(dev: torch.device) -> dict:
    """The fault-injection harness on the GRPO path's kernels at
    Qwen2.5-1.5B's widths, `CHAOS_LAYERS` of its 28 layers, bf16, random
    weights from the seed: (x1) `chaos_train`. The fleet's chaos, (x2)
    before the router came, is the fleet phase's (f2)."""
    cfg = dataclasses.replace(QWEN25_1_5B, num_hidden_layers=CHAOS_LAYERS, scan_layers=False,
                              remat=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chaos-") as root:
        train = chaos_train(dev, cfg, root)
    train_s = time.perf_counter() - t0
    launches = dict(train["launches"])
    emit("chaos", model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE,
         cut=f"{CHAOS_LAYERS} of 28 layers", x1_trainer=train, x1_seconds=train_s,
         launches=launches)
    return dict(launches=launches)


def chaos_only() -> int:
    """`--chaos`: the device and build phases, then the chaos phase alone."""
    dev, smi = phase_device()
    phase_build()
    out = phase_chaos(dev)
    print(smi, flush=True)
    print(json.dumps({"chaos_launches": out["launches"]}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase: fleet — the router, session migration with /drain, the supervisor
# ---------------------------------------------------------------------------

# 1 of Qwen2.5-1.5B's 28 layers (`CUT_LAYERS`, 4, before the vision
# phase came), to pay for the vision phase (PERF.md section 4)
FLEET_LAYERS = 1
# each replica's engine; one prefill per scheduler pass (the first
# admission always goes through, the budget's floor is one 64-token
# bucket), so a stream's arithmetic does not depend on what else a pass
# admitted and a replica's streams equal one engine's token for token
FLEET_SERVE = dict(max_running_requests=16, context_length=1024, page_size=128,
                   new_tokens_per_chunk=32, max_prefill_tokens=64, kv_pool_tokens=16384)
FLEET_GROUPS, FLEET_GROUP_SIZE = 8, 4  # (f1): one qid a group
FLEET_PROMPT = (64, 256)
FLEET_F1_NEW = 128
FLEET_F3_REQUESTS, FLEET_F3_NEW = 16, 256
FLEET_F4_REQUESTS, FLEET_F4_NEW = 8, 128
FLEET_EXP = "chip-smoke-fleet"
FLEET_TIMEOUT = 300
# (f5): JAX bench.py's bench_disagg trace (:1659-1700), greedy: decode-heavy
# requests (short prompts, long generations) and prefill-heavy ones
FLEET_F5_DECODE = dict(n=8, prompt=(64, 128), new=256)
FLEET_F5_PREFILL = dict(n=8, prompt=(640, 896), new=16)
# the prefill replica holds every parked session until its export, and the
# router must find it admissible for the whole trace: a larger pool, and a
# host tier that keeps an evicted parked session exportable
FLEET_PREFILL_ROLE = dict(role="prefill", kv_pool_tokens=32768, kv_host_pool_mb=512.0)
# one pool block of the fleet's model: its layers x K,V x 128 rows x 2 kv
# heads x 128 x 2 bytes (bf16)
FLEET_BLOCK_NBYTES = FLEET_LAYERS * 2 * 128 * 2 * 128 * 2
# (f6): a 4-block head shared by requests whose tails diverge
FLEET_F6_HEAD, FLEET_F6_TAIL, FLEET_F6_NEW = 512, 100, 16
FLEET_F6D_REQUESTS, FLEET_F6D_PROMPT, FLEET_F6D_NEW = 4, (200, 300), 128
# (f7): the re-role leg's traffic
FLEET_F7_REQUESTS, FLEET_F7_NEW = 12, 128


def _wait_router(router, addrs: list[str], timeout: float = 60.0) -> None:
    """Until the router's poll has seen every server of `addrs`."""
    deadline = time.monotonic() + timeout
    while True:
        with router._lock:
            seen = set(router.servers)
        if set(addrs) <= seen:
            return
        check(time.monotonic() < deadline, f"the router never saw {addrs} (it sees {seen})")
        time.sleep(0.05)


class _FleetReplica:
    """One in-process replica on the card: a port `DecodeServer` over its
    own `TorchDecodeEngine`, registered for the router, its served
    requests logged (rid, input length, whether it completed). `kill` is
    the supervisor's: the server stops, the engine is destroyed (its
    requests in flight answer 500), the registration goes."""

    def __init__(self, dev, params, cfg, trial: str, **settings):
        from areal_tpu_torch.launcher.decode_server import DecodeServer

        dcfg = TorchDecodeConfig(random_seed=SEED, dtype=cfg.dtype, kv_cache_dtype=cfg.dtype,
                                 **dict(FLEET_SERVE, **settings))
        self.engine = TorchDecodeEngine(dcfg, device=dev)
        self.engine.set_model(params, cfg)
        self.engine.initialize()
        self.served: list[tuple[str, int, bool]] = []
        # rid -> (latency, ttft, tokens) of a served request (the engine's clock)
        self.timing: dict[str, tuple[float, float, int]] = {}
        orig = self.engine.generate

        def generate(req, timeout=None):
            try:
                resp = orig(req, timeout)
            except BaseException:
                self.served.append((req.rid, len(req.input_ids), False))
                raise
            self.served.append((req.rid, len(req.input_ids), resp.stop_reason != "interrupt"))
            self.timing[req.rid] = (resp.latency, resp.ttft, len(resp.output_tokens))
            return resp
        self.engine.generate = generate
        self.server = DecodeServer(dcfg, engine=self.engine)
        self.addr = self.server.start("127.0.0.1", 0)
        self.server.register(FLEET_EXP, trial, self.addr)
        self.killed = False

    def kill(self) -> None:
        self.killed = True
        self.server.stop()
        self.engine.destroy()

    def close(self) -> None:
        if not self.killed:
            self.kill()


def _fleet_prompts(rng, vocab: int, n: int) -> list[list[int]]:
    return [rng.integers(1, vocab, int(rng.integers(*FLEET_PROMPT, endpoint=True))).tolist()
            for _ in range(n)]


def _fleet_client(trial: str):
    from areal_tpu_torch.core.remote_inf_engine import RemoteInfEngine

    return RemoteInfEngine(InferenceEngineConfig(
        experiment_name=FLEET_EXP, trial_name=trial, request_timeout=FLEET_TIMEOUT,
        request_retries=3, fleet_failover_retries=3, setup_timeout=60))


def _fleet_wave(client, reqs: list[ModelRequest]) -> list:
    async def go():
        return await asyncio.gather(*[client.agenerate(r) for r in reqs])
    return asyncio.run(asyncio.wait_for(go(), FLEET_TIMEOUT))


def _fleet_reference(dev, params, cfg, reqs: list[ModelRequest]) -> tuple[list, float]:
    """The same requests on one in-process engine, never interrupted: the
    streams and the wall seconds."""
    eng = _tier_engine(dev, params, cfg, dtype=cfg.dtype, kv_cache_dtype=cfg.dtype,
                       **FLEET_SERVE)
    try:
        async def go():
            return await asyncio.gather(*[eng.agenerate(r) for r in reqs])
        t0 = time.perf_counter()
        out = _streams(asyncio.run(asyncio.wait_for(go(), FLEET_TIMEOUT)))
        return out, time.perf_counter() - t0
    finally:
        eng.destroy()


def _drained_replica(replicas):
    """Wrap each replica's `_drain_once` to record its answer and seconds."""
    log: list = []
    for rep in replicas:
        orig = rep.server._drain_once

        def drain_once(req, targets, orig=orig, rep=rep):
            t0 = time.perf_counter()
            out = orig(req, targets)
            log.append(dict(out, replica=rep.addr, seconds=time.perf_counter() - t0))
            return out
        rep.server._drain_once = drain_once
    return log


def _generated(replicas) -> list[int]:
    return [r.engine.get_metrics()["generated_tokens_total"] for r in replicas]


def _mid_stream(replicas, base: list[int], min_tokens: int, running: int = 1,
                timeout: float = 120.0) -> None:
    """Until `running` requests run on the replicas together, each replica
    runs some, and each has emitted `min_tokens` since `base` (its
    `_generated` count before the traffic)."""
    deadline = time.monotonic() + timeout
    while True:
        ms = [r.engine.get_metrics() for r in replicas]
        if (sum(m["running_requests"] for m in ms) >= running
                and all(m["running_requests"] >= 1 and m["generated_tokens_total"] - b
                        >= min_tokens for m, b in zip(ms, base))):
            return
        check(time.monotonic() < deadline, f"traffic never ran on every replica: {ms}")
        time.sleep(0.02)  # the replicas' schedulers share this process's GIL


def _no_spawn(role: str):
    raise RuntimeError("this leg spawns no replica")


def _fleet_f1(dev, params, cfg, router, replicas, client) -> dict:
    """(f1) routing: 8 prompts x 4 samples, one qid a group, 128 new tokens,
    greedy, `prefix_affinity` over two servers."""
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(SEED + 60)
    prompts = _fleet_prompts(rng, cfg.vocab_size, FLEET_GROUPS)
    g = GenerationHyperparameters(max_new_tokens=FLEET_F1_NEW, greedy=True)
    reqs = [ModelRequest(rid=f"f1-g{i}", input_ids=p, gconfig=g)
            for i, p in enumerate(prompts) for _ in range(FLEET_GROUP_SIZE)]
    want, ref_s = _fleet_reference(dev, params, cfg, reqs)
    latencies: list[float] = []
    orig = router._schedule_request

    def timed(req):
        t0 = time.perf_counter()
        try:
            return orig(req)
        finally:
            latencies.append(time.perf_counter() - t0)
    router._schedule_request = timed
    steps0 = [r.engine.decode_steps for r in replicas]
    # ---- the main path: counts to 0 just before, read just after ----
    pa.launches = 0
    t0 = time.perf_counter()
    got = _streams(_fleet_wave(client, reqs))
    wall = time.perf_counter() - t0
    for r in replicas:
        r.engine.pause_generation()  # drain the pass in flight before reading K3
        r.engine.continue_generation()
    k3 = pa.launches
    # ---- end of the main path ----
    router._schedule_request = orig
    steps = sum(r.engine.decode_steps - s for r, s in zip(replicas, steps0))
    homes = {}
    for r in replicas:
        for rid, _, _ in r.served:
            if rid.startswith("f1-"):
                homes.setdefault(rid, set()).add(r.addr)
    per_server = {r.addr: sum(rid.startswith("f1-") for rid, _, _ in r.served) for r in replicas}
    exact = _exact(got, want, "(f1) routed streams vs one engine's")
    time.sleep(0.1)  # the clients' last /finish_request
    m = router._metrics()
    check(all(len(h) == 1 for h in homes.values()) and len(homes) == FLEET_GROUPS,
          f"(f1) a group split across servers: {homes}")
    check(all(n > 0 for n in per_server.values()), f"(f1) a server served nothing: {per_server}")
    check(m["tracked_qids"] == 0 and sum(m["request_counts"].values()) == 0,
          f"(f1) the router still holds {m['tracked_qids']} qids, {m['request_counts']}")
    check(m["schedules_total"] == len(reqs), f"(f1) {m['schedules_total']} placements")
    if dev.type == "cuda":
        check(k3 == L * steps, f"(f1) K3 {k3} launches, formula {L} x {steps} decode steps")
    lat = np.asarray(latencies) * 1e3
    return dict(requests=len(reqs), groups=FLEET_GROUPS, new_tokens=FLEET_F1_NEW,
                seconds=wall, reference_s=ref_s, decode_steps=steps, per_server=per_server,
                against_one_engine=exact,
                affinity_hits=m["affinity_hits_total"], schedules=m["schedules_total"],
                schedule_ms=dict(p50=float(np.percentile(lat, 50)),
                                 p99=float(np.percentile(lat, 99)), n=len(lat)),
                launches=dict(paged_attention=k3),
                formula=dict(paged_attention=f"{L} x {steps} decode steps"))


def _fleet_f3(dev, params, cfg, router, replicas, client) -> dict:
    """(f3) drain-first scale-down: 16 greedy requests of 256 new tokens
    over two servers; a supervisor whose policy plans a scale-down while
    they run drains the victim to the survivor, then kills it; the
    clients' resumes fail over through the router."""
    from areal_tpu_torch.api.cli_args import SupervisorConfig
    from areal_tpu_torch.launcher.supervisor import FleetSupervisor

    rng = np.random.default_rng(SEED + 61)
    g = GenerationHyperparameters(max_new_tokens=FLEET_F3_NEW, greedy=True)
    reqs = [ModelRequest(rid=f"f3-{i}", input_ids=p, gconfig=g)
            for i, p in enumerate(_fleet_prompts(rng, cfg.vocab_size, FLEET_F3_REQUESTS))]
    want, ref_s = _fleet_reference(dev, params, cfg, reqs)
    drains = _drained_replica(replicas)
    before = {r.addr: r.engine.get_metrics() for r in replicas}
    # idle at any load (util <= 1.0), never pressured: it plans a scale-down
    sup = FleetSupervisor(router.addr, _no_spawn, experiment_name=FLEET_EXP, trial_name="f1",
                          config=SupervisorConfig(min_replicas=1, max_replicas=2,
                                                  scale_down_util=1.0, scale_up_util=1e9,
                                                  scale_down_cooldown_s=0.0,
                                                  tick_interval_s=0.1, drain_deadline_s=120.0))
    for r in replicas:
        sup.adopt(r)
    out: dict = {}
    t = threading.Thread(target=lambda: out.update(r=_fleet_wave(client, reqs)))
    t0 = time.perf_counter()
    base = _generated(replicas)
    t.start()
    # most requests admitted (one prefill a pass) and none finished
    _mid_stream(replicas, base, 2 * FLEET_F3_REQUESTS, running=FLEET_F3_REQUESTS * 3 // 4)
    t_sup = time.perf_counter()
    sup.start("127.0.0.1", 0)
    deadline = time.monotonic() + FLEET_TIMEOUT
    while sup.get_metrics()["kills_total"] < 1:
        check(time.monotonic() < deadline, f"(f3) no kill: {sup.get_metrics()}")
        time.sleep(0.01)
    transition_s = time.perf_counter() - t_sup
    t.join(FLEET_TIMEOUT)
    wall = time.perf_counter() - t0
    sup.stop()
    sm = sup.get_metrics()
    check("r" in out, "(f3) the clients did not finish")
    victim = next(r for r in replicas if r.killed)
    survivor = next(r for r in replicas if not r.killed)
    (drain,) = drains
    check(drain["replica"] == victim.addr, f"(f3) the drain was on {drain['replica']}")
    interrupted = {rid for rid, _, done in victim.served if rid.startswith("f3-") and not done}
    check(drain["drained"] == drain["sessions"] and drain["failed"] == 0,
          f"(f3) drain {drain}")
    # one prefill a pass: requests still queued at the drain end with no
    # session and start afresh elsewhere; those that ran are the sessions
    check(0 < drain["sessions"] <= len(interrupted),
          f"(f3) {drain['sessions']} sessions drained, {len(interrupted)} requests cut")
    check(sm["scale_downs_total"] == 1 and sm["kills_total"] == 1
          and sm["drain_rollbacks_total"] == 0, f"(f3) supervisor {sm}")
    sv0, sv1 = before[survivor.addr], survivor.engine.get_metrics()
    admitted = sum(1 for rid, _, _ in survivor.served if rid.startswith("f3-"))
    hits = sv1["kv_host_hits_total"] - sv0["kv_host_hits_total"]
    prefills = sv1["prefills_total"] - sv0["prefills_total"]
    # every drained session resumed on the survivor as a promotion, and
    # every other admission there was a request it took fresh
    check(hits == drain["drained"], f"(f3) {hits} host hits for {drain['drained']} sessions")
    check(prefills == admitted - hits, f"(f3) survivor prefills {prefills}, admissions "
                                       f"{admitted}, promotions {hits}")
    block = sv1["kv_block_nbytes"]
    moved_in = sv1["kv_migrated_in_bytes_total"] - sv0["kv_migrated_in_bytes_total"]
    itemsize = torch.empty(0, dtype=getattr(torch, cfg.dtype)).element_size()
    check(block == 2 * cfg.num_hidden_layers * FLEET_SERVE["page_size"]
          * cfg.num_key_value_heads * cfg.head_dim_ * itemsize, f"(f3) block bytes {block}")
    check(moved_in > 0 and moved_in % block == 0
          and sv1["kv_migrated_in_sessions_total"] - sv0["kv_migrated_in_sessions_total"]
          == drain["drained"], f"(f3) {moved_in} bytes in, block {block}")
    stats = victim.server._migrate_stats
    check(stats["out_sessions"] == drain["drained"] and stats["out_failures"] == 0,
          f"(f3) victim's migration {stats}")
    exact = _exact(_streams(out["r"]), want, "(f3) drained streams vs never-interrupted")
    return dict(requests=len(reqs), new_tokens=FLEET_F3_NEW, seconds=wall,
                reference_s=ref_s, until_mid_stream_s=t_sup - t0,
                transition_s=transition_s, drain=drain, victim_migration=dict(stats),
                migrated_blocks=moved_in // block, block_nbytes=block,
                migrate_gb_s=(stats["out_bytes"] / stats["transfer_secs"] / 1e9
                              if stats["transfer_secs"] else None),
                survivor=dict(admissions=admitted, host_hits=hits, prefills=prefills),
                supervisor=sm, against_never_interrupted=exact)


def _fleet_f4(dev, params, cfg) -> dict:
    """(f4) planted transitions on a fresh pair: a replace from
    `supervisor.health` aborts, a crash loop from `supervisor.spawn` aborts,
    a rollback from a `supervisor.drain` delay, and a `kv.migrate.send`
    abort replayed under the same xid."""
    from areal_tpu_torch.api.cli_args import RouterConfig, SupervisorConfig
    from areal_tpu_torch.core import fault_injection
    from areal_tpu_torch.core.fault_injection import FaultPlan, FaultPoint
    from areal_tpu_torch.launcher.router import DecodeRouter
    from areal_tpu_torch.launcher.supervisor import FleetSupervisor
    from areal_tpu_torch.utils.http import request_with_retry

    out: dict = {}
    reps = [_FleetReplica(dev, params, cfg, "f4") for _ in range(2)]
    spawned: list = []
    router = DecodeRouter(FLEET_EXP, "f4", config=RouterConfig(
        schedule_policy="round_robin", health_poll_interval=0.1, dead_after_failures=2))
    router.start("127.0.0.1", 0)
    try:
        _wait_router(router, [r.addr for r in reps])
        client = _fleet_client("f4")
        client.addresses = [r.addr for r in reps]
        rng = np.random.default_rng(SEED + 62)
        g = GenerationHyperparameters(max_new_tokens=FLEET_F4_NEW, greedy=True)
        reqs = [ModelRequest(rid=f"f4-{i}", input_ids=p, gconfig=g)
                for i, p in enumerate(_fleet_prompts(rng, cfg.vocab_size, FLEET_F4_REQUESTS))]
        want, out["reference_s"] = _fleet_reference(dev, params, cfg, reqs)

        # -- a replace: the victim's health probes abort -------------------
        def spawn_fn(role):
            spawned.append(_FleetReplica(dev, params, cfg, "f4"))
            return spawned[-1]

        sup = FleetSupervisor(router.addr, spawn_fn, experiment_name=FLEET_EXP, trial_name="f4",
                              config=SupervisorConfig(min_replicas=2, max_replicas=2,
                                                      health_fail_threshold=2,
                                                      replace_cooldown_s=0.0,
                                                      tick_interval_s=0.1))
        for r in reps:
            sup.adopt(r)
        res: dict = {}
        t = threading.Thread(target=lambda: res.update(r=_fleet_wave(client, reqs)))
        base = _generated(reps)
        t.start()
        _mid_stream(reps, base, 2 * FLEET_F4_REQUESTS)
        victim = reps[0]
        fault_injection.configure(FaultPlan(points=[FaultPoint(
            site="supervisor.health", mode="abort", times=2, match={"target": victim.addr})]))
        t0 = time.perf_counter()
        sup.start("127.0.0.1", 0)
        deadline = time.monotonic() + FLEET_TIMEOUT
        while not spawned or sup.get_metrics()["fleet_alive"] < 2:
            check(time.monotonic() < deadline, f"(f4) no replace: {sup.get_metrics()}")
            time.sleep(0.01)
        replace_s = time.perf_counter() - t0
        fired = fault_injection.snapshot()
        fault_injection.deactivate()
        t.join(FLEET_TIMEOUT)
        sup.stop()
        m = sup.get_metrics()
        check("r" in res, "(f4) replace: the clients did not finish")
        check(m["replacements_total"] == 1 and m["kills_total"] == 1 and victim.killed
              and m["spawn_attempts_total"] == 1 and len(spawned) == 1,
              f"(f4) replace: {m}, spawned {len(spawned)}")
        done = collections.Counter(rid for r in reps + spawned for rid, _, ok in r.served
                                   if ok and rid.startswith("f4-"))
        check(done == {r.rid: 1 for r in reqs}, f"(f4) completions per request: {done}")
        exact = _exact(_streams(res["r"]), want, "(f4) replaced replica's requests")
        rm = router._metrics()
        cut = sum(1 for rid, _, ok in victim.served if not ok)
        check(cut > 0, "(f4) the victim held no request when it was killed")
        # the supervisor deregisters the victim before the kill, so the
        # router drops it from discovery; the cut requests' retries come
        # back to the router with requeue=True
        check(rm["client_requeues_total"] >= cut,
              f"(f4) {rm['client_requeues_total']} requeues for {cut} cut requests")
        health = request_with_retry(spawned[0].addr, "/health", method="GET")
        out["replace"] = dict(fired=fired, seconds=replace_s, supervisor=m, cut_requests=cut,
                              completions=dict(done), against_never_interrupted=exact,
                              router=dict(failovers=rm["failovers_total"],
                                          requeues=rm["requeues_total"],
                                          client_requeues=rm["client_requeues_total"]),
                              respawned_health=health["status"])
        fleet = [reps[1], spawned[0]]
        _wait_router(router, [r.addr for r in fleet])

        # -- a crash loop: every spawn attempt aborts ----------------------
        calls: list = []
        sup = FleetSupervisor(router.addr, lambda role: calls.append(role),
                              config=SupervisorConfig(min_replicas=2, max_replicas=3,
                                                      scale_up_util=0.0, spawn_max_attempts=3,
                                                      spawn_backoff_s=0.05,
                                                      spawn_backoff_max_s=0.1,
                                                      scale_up_cooldown_s=0.0))
        for r in fleet:
            sup.adopt(r)
        fault_injection.configure(FaultPlan(points=[FaultPoint(
            site="supervisor.spawn", mode="abort", times=3)]))
        t0 = time.perf_counter()
        extra = 5  # ticks after the crash loop: no further spawn
        for _ in range(60):
            sup._tick()
            for w in list(sup._workers):
                w.join(30)
            if sup.get_metrics()["crash_loops_total"]:
                extra -= 1
                if extra < 0:
                    break
            time.sleep(0.05)
        crash_s = time.perf_counter() - t0
        fired = fault_injection.snapshot()
        fault_injection.deactivate()
        m = sup.get_metrics()
        check(m["crash_loops_total"] == 1 and m["spawn_failures_total"] == 3
              and m["spawn_attempts_total"] == 3 and m["scale_ups_total"] == 1 and not calls,
              f"(f4) crash loop: {m}, spawn_fn calls {len(calls)}")
        out["crash_loop"] = dict(fired=fired, supervisor=m, seconds=crash_s)

        # -- a rollback: the drain hangs past its deadline -----------------
        sup = FleetSupervisor(router.addr, _no_spawn, config=SupervisorConfig(
            min_replicas=1, max_replicas=2, scale_down_util=1.0, scale_up_util=1e9,
            scale_down_cooldown_s=600.0, drain_deadline_s=0.5))
        for r in fleet:
            sup.adopt(r)
        fault_injection.configure(FaultPlan(points=[FaultPoint(
            site="supervisor.drain", mode="delay", at=(0,), times=1, delay_s=1.0)]))
        sup._tick()
        for w in list(sup._workers):
            w.join(30)
        fired = fault_injection.snapshot()
        fault_injection.deactivate()
        m = sup.get_metrics()
        time.sleep(0.7)  # the hung call ends, and sends nothing
        probe = request_with_retry(fleet[0].addr, "/generate", payload=dict(
            input_ids=reqs[0].input_ids, gconfig=dict(max_new_tokens=8, greedy=True)),
            timeout=60)
        check(m["drain_rollbacks_total"] == 1 and m["kills_total"] == 0
              and not any(r.killed for r in fleet) and len(probe["output_tokens"]) == 8,
              f"(f4) rollback: {m}")
        check(all(r.server._drain_inflight is None for r in fleet),
              "(f4) rollback: a drain reached a replica")
        out["rollback"] = dict(fired=fired, supervisor=m)

        # -- a kv.migrate.send abort inside a drain ------------------------
        src, dst = fleet
        res = {}
        t = threading.Thread(target=lambda: res.update(r=[
            request_with_retry(src.addr, "/generate", payload=dict(
                rid=r.rid + "-d", input_ids=r.input_ids,
                gconfig=dict(max_new_tokens=FLEET_F4_NEW, greedy=True)), timeout=120)
            for r in reqs[:1]]))
        base = _generated([src])
        t.start()
        _mid_stream([src], base, 4)
        fault_injection.configure(FaultPlan(points=[FaultPoint(
            site="kv.migrate.send", mode="abort", at=(0,), times=1)]))
        dst0 = dst.engine.get_metrics()
        drain = request_with_retry(src.addr, "/drain", payload=dict(targets=[dst.addr]),
                                   timeout=120, max_retries=1)
        fired = fault_injection.snapshot()
        fault_injection.deactivate()
        t.join(120)
        dst1 = dst.engine.get_metrics()
        dm = request_with_retry(dst.addr, "/metrics", method="GET")
        check(fired == {"kv.migrate.send|abort": 1} and drain["drained"] == drain["sessions"]
              and drain["failed"] == 0 and drain["sessions"] >= 1, f"(f4) replay: {drain}, "
                                                                    f"fired {fired}")
        landed = dst1["kv_migrated_in_sessions_total"] - dst0["kv_migrated_in_sessions_total"]
        check(landed == drain["drained"] and dm["kv_migrate"]["commit_dedups"] == 0,
              f"(f4) replay: {landed} sessions landed for {drain['drained']}")
        out["migrate_replay"] = dict(fired=fired, drain=drain, landed=landed,
                                     server=dm["kv_migrate"])
    finally:
        fault_injection.deactivate()
        router.stop()
        for r in reps + spawned:
            r.close()
    return out


def _fleet_router(trial: str, reps: list):
    """A started port router over `reps` (trial `trial`), once its poll
    has seen every replica and its role."""
    from areal_tpu_torch.api.cli_args import RouterConfig
    from areal_tpu_torch.launcher.router import DecodeRouter

    router = DecodeRouter(FLEET_EXP, trial, config=RouterConfig(
        schedule_policy="prefix_affinity", health_poll_interval=0.1, dead_after_failures=2))
    router.start("127.0.0.1", 0)
    _wait_router(router, [r.addr for r in reps])
    deadline = time.monotonic() + 30
    while True:
        with router._lock:
            roles = {s: router._roles.get(s) for s in router.servers}
        if all(roles.get(r.addr) == r.engine.config.role for r in reps):
            return router
        check(time.monotonic() < deadline, f"the router never saw the roles: {roles}")
        time.sleep(0.05)


def _f5_trace(cfg) -> tuple[list[ModelRequest], set[str]]:
    """bench_disagg's mixed trace, decode-heavy and prefill-heavy requests
    interleaved; the decode-heavy rids."""
    rng = np.random.default_rng(SEED + 63)
    reqs, heavy = [], set()
    for i in range(FLEET_F5_DECODE["n"]):
        for kind, spec in (("d", FLEET_F5_DECODE), ("p", FLEET_F5_PREFILL)):
            n = int(rng.integers(*spec["prompt"], endpoint=True))
            reqs.append(ModelRequest(rid=f"f5-{kind}{i}",
                                     input_ids=rng.integers(1, cfg.vocab_size, n).tolist(),
                                     gconfig=GenerationHyperparameters(
                                         max_new_tokens=spec["new"], greedy=True)))
            if kind == "d":
                heavy.add(reqs[-1].rid)
    return reqs, heavy


def _f5_run(dev, params, cfg, roles: tuple, trial: str, reqs, heavy, want) -> dict:
    """The trace on replicas of `roles` behind a port router, through the
    client: its streams against one engine's, each replica's counters
    over the run, K3's launches and the ITL readings: the decode-heavy
    requests' mean wall ITL (the engine's latency less its TTFT over the
    tokens after the first), its p50 and p99 over them, and the decoding
    replicas' wall ITL windows (bench_disagg's reading)."""
    L = cfg.num_hidden_layers
    reps = [_FleetReplica(dev, params, cfg, trial, **(FLEET_PREFILL_ROLE if r == "prefill"
                                                       else dict(role=r))) for r in roles]
    router = None
    try:
        router = _fleet_router(trial, reps)
        client = _fleet_client(trial)
        client.addresses = [r.addr for r in reps]
        for r in reps:
            r.engine.reset_timing_windows()
        m0 = [r.engine.get_metrics() for r in reps]
        steps0 = [r.engine.decode_steps for r in reps]
        # ---- the main path: counts to 0 just before, read just after ----
        pa.launches = 0
        t0 = time.perf_counter()
        got = _streams(_fleet_wave(client, reqs))
        wall = time.perf_counter() - t0
        for r in reps:
            r.engine.pause_generation()  # drain the pass in flight before reading K3
            r.engine.continue_generation()
        k3 = pa.launches
        # ---- end of the main path ----
        m1 = [r.engine.get_metrics() for r in reps]
        steps = [r.engine.decode_steps - s for r, s in zip(reps, steps0)]
        rm = router._metrics()
        decoding = [r for r in reps if r.engine.config.role != "prefill"]
        samples = np.asarray([x for r in decoding for x in r.engine._chunk_wall_itl_ms])
        per = []
        for r in decoding:
            for rid, (lat, ttft, n) in r.timing.items():
                if rid in heavy and n > 1:
                    per.append((lat - ttft) / (n - 1) * 1e3)
        check(len(per) == len(heavy), f"(f5) {trial}: {len(per)} decode-heavy timings")
        exact = _exact(got, want, f"(f5) {trial} streams vs one engine's")
        if dev.type == "cuda":
            check(k3 == L * sum(steps), f"(f5) {trial}: K3 {k3} launches, formula {L} x "
                                        f"{sum(steps)} decode steps")
        delta = [{k: b[k] - a[k] for k in ("prefills_total", "suffix_prefills_total",
                                           "prefix_forks_total", "kv_host_hits_total",
                                           "kv_migrated_in_sessions_total",
                                           "kv_migrated_in_bytes_total",
                                           "kv_migrated_out_sessions_total",
                                           "kv_migrated_out_bytes_total")}
                 for a, b in zip(m0, m1)]
        return dict(roles=list(roles), seconds=wall, decode_steps=steps,
                    against_one_engine=exact, per_replica=delta,
                    router=dict(disagg=rm["disagg_schedules_total"],
                                schedules=rm["schedules_total"]),
                    itl_heavy_mean_ms=dict(p50=float(np.percentile(per, 50)),
                                           p99=float(np.percentile(per, 99)), n=len(per)),
                    itl_wall_window_ms=dict(p50=float(np.percentile(samples, 50)),
                                            p99=float(np.percentile(samples, 99)),
                                            n=int(samples.size)),
                    ttft_transfer_p99_ms=[m["ttft_transfer_p99_ms"] for m in m1],
                    ttft_prefill_p99_ms=[m["ttft_prefill_p99_ms"] for m in m1],
                    launches=dict(paged_attention=k3),
                    formula=dict(paged_attention=f"{L} x {sum(steps)} decode steps"))
    finally:
        if router is not None:
            router.stop()
        for r in reps:
            r.close()


def _fleet_f5(dev, params, cfg) -> dict:
    """(f5) the disaggregated handoff: a prefill replica and a decode
    replica behind the router, every request handed off by the client;
    then the same trace on two unified replicas, for the ITL readings."""
    reqs, heavy = _f5_trace(cfg)
    want, ref_s = _fleet_reference(dev, params, cfg, reqs)
    dis = _f5_run(dev, params, cfg, ("prefill", "decode"), "f5", reqs, heavy, want)
    pre, dec = dis["per_replica"]
    n = len(reqs)
    blocks = sum(-(-(len(r.input_ids) - 1) // FLEET_SERVE["page_size"]) for r in reqs)
    check(dis["router"]["disagg"] == n, f"(f5) {dis['router']} placements for {n}")
    check(pre["kv_migrated_out_sessions_total"] == dec["kv_migrated_in_sessions_total"] == n
          and dec["kv_host_hits_total"] == n,
          f"(f5) handoffs: prefill replica {pre}, decode replica {dec}")
    check(dec["prefills_total"] == dec["suffix_prefills_total"] == 0 and pre["prefills_total"] == n,
          f"(f5) the decode replica prefilled: {dec}")
    check(dec["kv_migrated_in_bytes_total"] == blocks * FLEET_BLOCK_NBYTES,
          f"(f5) {dec['kv_migrated_in_bytes_total']} bytes for {blocks} blocks of "
          f"{FLEET_BLOCK_NBYTES}")
    check(dis["decode_steps"][0] == 0, f"(f5) the prefill replica decoded: {dis['decode_steps']}")
    uni = _f5_run(dev, params, cfg, ("unified", "unified"), "f5u", reqs, heavy, want)
    return dict(requests=n, decode_heavy=FLEET_F5_DECODE, prefill_heavy=FLEET_F5_PREFILL,
                reference_s=ref_s, migrated_blocks=blocks, block_nbytes=FLEET_BLOCK_NBYTES,
                disagg=dis, unified=uni, card=nvidia_smi(),
                launches=dict(paged_attention=dis["launches"]["paged_attention"]
                              + uni["launches"]["paged_attention"]))


def _f6_prompts(cfg, rng, n_tails: int) -> tuple[list[int], list[list[int]]]:
    head = rng.integers(1, cfg.vocab_size, FLEET_F6_HEAD).tolist()
    return head, [head + rng.integers(1, cfg.vocab_size, FLEET_F6_TAIL).tolist()
                  for _ in range(n_tails)]


def _fleet_f6(dev, params, cfg) -> dict:
    """(f6) the fabric: (a) the device rung on one engine, (b) a fetch from
    a sibling on a router hint, (c) a supervisor's scale-up warm-started
    from its peers, (d) a scale-down drained as identities only."""
    from areal_tpu_torch.api.cli_args import SupervisorConfig
    from areal_tpu_torch.core import kv_fabric
    from areal_tpu_torch.launcher.supervisor import FleetSupervisor
    from areal_tpu_torch.utils.http import request_with_retry

    L = cfg.num_hidden_layers
    out: dict = {}
    g = GenerationHyperparameters(max_new_tokens=FLEET_F6_NEW, greedy=True)
    rng = np.random.default_rng(SEED + 64)
    head, tails = _f6_prompts(cfg, rng, 5)

    def chain(tokens):
        return kv_fabric.chain_keys(tokens, FLEET_SERVE["page_size"], 0, "fp")

    # -- (a) a head shared with a registration that diverges later ---------
    runs = {}
    for name, fabric in (("fabric", True), ("off", False)):
        eng = _tier_engine(dev, params, cfg, dtype=cfg.dtype, kv_cache_dtype=cfg.dtype,
                           kv_fabric=fabric, **FLEET_SERVE)
        try:
            eng.generate(ModelRequest(rid="a1", input_ids=tails[0], gconfig=g))
            m0, s0 = eng.get_metrics(), eng.decode_steps
            pa.launches = 0
            r = eng.generate(ModelRequest(rid="a2", input_ids=tails[1], gconfig=g))
            eng.pause_generation()
            eng.continue_generation()
            k3 = pa.launches
            m1 = eng.get_metrics()
            if dev.type == "cuda":
                check(k3 == L * (eng.decode_steps - s0), f"(f6a) {name}: K3 {k3} launches")
            runs[name] = (_streams([r]), {k: m1[k] - m0[k] for k in (
                "prefills_total", "suffix_prefills_total", "prefix_forks_total",
                "kv_fabric_local_hits_total", "kv_fabric_local_tokens_avoided_total")}, k3)
        finally:
            eng.destroy()
    (got, fab, k3a), (want, off, _) = runs["fabric"], runs["off"]
    check(fab == dict(prefills_total=0, suffix_prefills_total=1, prefix_forks_total=0,
                      kv_fabric_local_hits_total=1,
                      kv_fabric_local_tokens_avoided_total=FLEET_F6_HEAD),
          f"(f6a) the fabric engine's second request: {fab}")
    check(off["prefills_total"] == 1 and off["kv_fabric_local_hits_total"] == 0,
          f"(f6a) the kv_fabric=False engine: {off}")
    check(got[0][0] == want[0][0], "(f6a) the fork + suffix stream's tokens differ from a "
                                   "full prefill's")
    out["a"] = dict(fabric=fab, off=off, tokens_equal=True, k3=k3a)

    # -- (b) a sibling's run fetched on a hint ------------------------------
    a, b = (_FleetReplica(dev, params, cfg, "f6") for _ in range(2))
    router = None
    spawned: list = []
    try:
        router = _fleet_router("f6", [a, b])
        post = dict(gconfig=dict(max_new_tokens=FLEET_F6_NEW, greedy=True))
        request_with_retry(a.addr, "/generate", payload=dict(post, rid="b1",
                                                             input_ids=tails[2]), timeout=120)
        b0 = b.engine.get_metrics()
        keys = kv_fabric.encode_digest(chain(head))
        t0 = time.perf_counter()
        on_b = request_with_retry(b.addr, "/generate", payload=dict(
            post, rid="b2", input_ids=tails[3], kv_fabric=dict(peer=a.addr, keys=keys)),
            timeout=120)
        fetch_s = time.perf_counter() - t0
        b1 = b.engine.get_metrics()
        on_a = request_with_retry(a.addr, "/generate", payload=dict(post, rid="b3",
                                                                    input_ids=tails[3]),
                                  timeout=120)
        fetched = b1["kv_fabric_fetch_bytes_total"] - b0["kv_fabric_fetch_bytes_total"]
        hits = b1["kv_fabric_remote_hits_total"] - b0["kv_fabric_remote_hits_total"]
        check(hits == 1 and fetched == 4 * FLEET_BLOCK_NBYTES
              and b1["prefills_total"] == b0["prefills_total"],
              f"(f6b) B: {hits} remote hits, {fetched} bytes fetched")
        check(on_b["output_tokens"] == on_a["output_tokens"]
              and on_b["output_logprobs"] == on_a["output_logprobs"],
              "(f6b) B's stream differs from A's")
        out["b"] = dict(fetched_bytes=fetched, remote_hits=hits, seconds=fetch_s,
                        bit_equal=True, ttft_transfer_p99_ms=b1["ttft_transfer_p99_ms"],
                        server=request_with_retry(b.addr, "/metrics",
                                                  method="GET")["kv_fabric"])

        # -- (c) a scale-up warm-started from its peers ---------------------
        def spawn_fn(role):
            spawned.append(_FleetReplica(dev, params, cfg, "f6", role=role))
            return spawned[-1]

        sup = FleetSupervisor(router.addr, spawn_fn, experiment_name=FLEET_EXP,
                              trial_name="f6", config=SupervisorConfig(
                                  min_replicas=2, max_replicas=3, scale_up_cooldown_s=0.0,
                                  warm_start_sessions=4))
        for r in (a, b):
            sup.adopt(r)
        sup._poll_router = lambda: {"queue_depth": 10}  # pressure: a scale-up
        t0 = time.perf_counter()
        sup._tick()
        for w in list(sup._workers):
            w.join(120)
        warm_s = time.perf_counter() - t0
        check(len(spawned) == 1, f"(f6c) {len(spawned)} replicas spawned")
        c = spawned[0]
        cm0 = request_with_retry(c.addr, "/metrics", method="GET")
        r = request_with_retry(c.addr, "/generate", payload=dict(post, rid="c1",
                                                                 input_ids=tails[4]),
                               timeout=120)
        cm1 = c.engine.get_metrics()
        warm = cm0["kv_fabric"]
        check(warm["warm_start_sessions"] >= 1 and cm0["kv_fabric_sessions_in_total"] >= 1,
              f"(f6c) warm start: {warm}")
        check(cm1["kv_fabric_remote_hits_total"] - cm0["kv_fabric_remote_hits_total"] == 1
              and cm1["prefills_total"] == cm0["prefills_total"] == 0
              and len(r["output_tokens"]) == FLEET_F6_NEW,
              f"(f6c) the first request on the new replica: {cm1['prefills_total']} prefills")
        out["c"] = dict(seconds=warm_s, warm_start=warm,
                        resident_blocks=cm0["kv_fabric_blocks_resident"],
                        supervisor=sup.get_metrics())
    finally:
        if router is not None:
            router.stop()
        for r in [a, b] + spawned:
            r.close()
    out["d"] = _fleet_f6d(dev, params, cfg)
    return out


def _fleet_f6d(dev, params, cfg) -> dict:
    """(f6d) a scale-down whose survivor's digest covers the victim's
    sessions: the survivor ran the same requests to the end first, the
    victim is drained mid-stream, the sessions leave as identities only,
    and their resumes on the survivor rebuild from its blocks."""
    from areal_tpu_torch.api.cli_args import SupervisorConfig
    from areal_tpu_torch.launcher.supervisor import FleetSupervisor
    from areal_tpu_torch.utils.http import request_with_retry

    rng = np.random.default_rng(SEED + 65)
    g = GenerationHyperparameters(max_new_tokens=FLEET_F6D_NEW, greedy=True)
    reqs = [ModelRequest(rid=f"f6d-{i}", input_ids=rng.integers(
                1, cfg.vocab_size, int(rng.integers(*FLEET_F6D_PROMPT, endpoint=True))).tolist(),
                gconfig=g) for i in range(FLEET_F6D_REQUESTS)]
    surv, victim = (_FleetReplica(dev, params, cfg, "f6d") for _ in range(2))
    router = None
    try:
        router = _fleet_router("f6d", [surv, victim])

        # the survivor's own run, never interrupted, is the reference
        async def on_survivor():
            return await asyncio.gather(*[surv.engine.agenerate(r) for r in reqs])
        want = _streams(asyncio.run(on_survivor()))
        deadline = time.monotonic() + 30
        while not (router._pressure.get(surv.addr) or {}).get("kv_fabric_digest"):
            check(time.monotonic() < deadline, "(f6d) the router never saw the digest")
            time.sleep(0.05)
        time.sleep(0.3)  # a poll after the last retirement
        drains = _drained_replica([victim])
        sup = FleetSupervisor(router.addr, _no_spawn, experiment_name=FLEET_EXP,
                              trial_name="f6d", config=SupervisorConfig(
                                  min_replicas=1, max_replicas=2, drain_deadline_s=120.0))
        sup.adopt(surv)
        slot = sup.adopt(victim)
        res: dict = {}

        def run(r):
            res[r.rid] = request_with_retry(victim.addr, "/generate", payload=dict(
                rid=r.rid, input_ids=r.input_ids, gconfig=dict(
                    max_new_tokens=FLEET_F6D_NEW, greedy=True)), timeout=120)
        threads = [threading.Thread(target=run, args=(r,)) for r in reqs]
        base = _generated([victim])
        for t in threads:
            t.start()
        _mid_stream([victim], base, 4 * FLEET_F6D_REQUESTS, running=FLEET_F6D_REQUESTS)
        s0 = surv.engine.get_metrics()
        kill = sup._kill

        def kill_after_replies(victim_slot):
            # the interrupted requests' replies leave before the kill
            for t in threads:
                t.join(120)
            kill(victim_slot)
        sup._kill = kill_after_replies
        sup._do_scale_down(sup._slots[slot])
        for t in threads:
            t.join(120)
        (drain,) = drains
        s1 = surv.engine.get_metrics()
        check(victim.killed and sup.get_metrics()["scale_downs_total"] == 1,
              f"(f6d) scale-down: {sup.get_metrics()}")
        check(drain["sessions"] >= 1 and drain["meta_only"] == drain["sessions"]
              == drain["drained"] and drain["failed"] == 0, f"(f6d) drain {drain}")
        check(s1["kv_migrated_in_bytes_total"] == s0["kv_migrated_in_bytes_total"]
              and s1["kv_migrated_in_sessions_total"] - s0["kv_migrated_in_sessions_total"]
              == drain["sessions"], f"(f6d) block bytes on the wire: {drain}")
        # the clients' resumes on the survivor: prompt + what they got
        resumed = []
        for r in reqs:
            part = res[r.rid]
            toks = list(part["output_tokens"])
            if part["stop_reason"] == "interrupt":
                more = request_with_retry(surv.addr, "/generate", payload=dict(
                    rid=r.rid, input_ids=r.input_ids + toks, gconfig=dict(
                        max_new_tokens=FLEET_F6D_NEW - len(toks), greedy=True)), timeout=120)
                resumed.append(r.rid)
                part = dict(output_tokens=toks + more["output_tokens"],
                            output_logprobs=list(part["output_logprobs"])
                            + more["output_logprobs"])
            res[r.rid] = (part["output_tokens"], part["output_logprobs"])
        s2 = surv.engine.get_metrics()
        check(len(resumed) >= drain["sessions"], f"(f6d) {len(resumed)} resumes")
        rebuilt = {k: s2[k] - s1[k] for k in ("prefills_total", "prefix_forks_total",
                                               "prefix_inplace_total", "suffix_prefills_total",
                                               "kv_fabric_local_hits_total")}
        check(rebuilt["prefills_total"] == 0, f"(f6d) the resumes prefilled: {rebuilt}")
        exact = _exact([res[r.rid] for r in reqs], want, "(f6d) drained streams")
        return dict(drain=drain, resumes=len(resumed), rebuilt=rebuilt,
                    against_never_interrupted=exact)
    finally:
        if router is not None:
            router.stop()
        for r in (surv, victim):
            r.close()


def _fleet_f7(dev, params, cfg) -> dict:
    """(f7) a re-role: a supervisor over a prefill and two decode replicas,
    told that the fleet's work is all prefill, drains a decode replica
    under traffic and flips it through /set_role; every request completes
    once."""
    from areal_tpu_torch.api.cli_args import SupervisorConfig
    from areal_tpu_torch.launcher.supervisor import FleetSupervisor

    rng = np.random.default_rng(SEED + 66)
    g = GenerationHyperparameters(max_new_tokens=FLEET_F7_NEW, greedy=True)
    reqs = [ModelRequest(rid=f"f7-{i}", input_ids=p, gconfig=g)
            for i, p in enumerate(_fleet_prompts(rng, cfg.vocab_size, FLEET_F7_REQUESTS))]
    reps = [_FleetReplica(dev, params, cfg, "f7", **FLEET_PREFILL_ROLE),
            _FleetReplica(dev, params, cfg, "f7", role="decode"),
            _FleetReplica(dev, params, cfg, "f7", role="decode")]
    router = None
    try:
        router = _fleet_router("f7", reps)
        client = _fleet_client("f7")
        client.addresses = [r.addr for r in reps]
        drains = _drained_replica(reps)
        sup = FleetSupervisor(router.addr, _no_spawn, experiment_name=FLEET_EXP,
                              trial_name="f7", config=SupervisorConfig(
                                  min_replicas=1, max_replicas=3, rerole_band=0.25,
                                  rerole_cooldown_s=0.0, scale_up_util=1e9,
                                  scale_down_util=-1.0, drain_deadline_s=120.0))
        for r in reps:
            sup.adopt(r, role=r.engine.config.role)
        real = sup._poll_router
        fake = {"pre": 0.0}

        def poll():
            # the router's view, with every replica's device time prefill:
            # the prefill share is 1, past the band around 1 of 3
            m = real()
            fake["pre"] += 1.0
            for p in (m or {}).get("pressure", {}).values():
                p["prefill_secs_total"], p["device_busy_s"] = fake["pre"], 0.0
            return m
        sup._poll_router = poll
        res: dict = {}
        t = threading.Thread(target=lambda: res.update(r=_fleet_wave(client, reqs)))
        base = _generated(reps[1:])
        t0 = time.perf_counter()
        t.start()
        _mid_stream(reps[1:], base, 2 * FLEET_F7_REQUESTS, running=FLEET_F7_REQUESTS // 2)
        deadline = time.monotonic() + FLEET_TIMEOUT
        while sup.get_metrics()["reroles_total"] < 1:
            check(time.monotonic() < deadline, f"(f7) no re-role: {sup.get_metrics()}")
            sup._tick()
            for w in list(sup._workers):
                w.join(120)
        rerole_s = time.perf_counter() - t0
        t.join(FLEET_TIMEOUT)
        m = sup.get_metrics()
        check("r" in res, "(f7) the clients did not finish")
        (drain,) = drains
        roles = [r.engine.config.role for r in reps]
        check(m["reroles_total"] == 1 and m["drain_rollbacks_total"] == 0
              and drain["failed"] == 0 and sorted(roles) == ["decode", "prefill", "prefill"],
              f"(f7) re-role: {m}, drain {drain}, roles {roles}")
        done = collections.Counter(rid for r in reps for rid, _, ok in r.served if ok)
        check(done == {r.rid: 1 for r in reqs}, f"(f7) completions per request: {done}")
        check(all(len(r.output_tokens) == FLEET_F7_NEW for r in res["r"]),
              "(f7) a request came back short")
        return dict(requests=len(reqs), seconds=rerole_s, drain=drain, roles=roles,
                    supervisor=m, completions=len(done))
    finally:
        if router is not None:
            router.stop()
        for r in reps:
            r.close()


def phase_fleet(dev: torch.device) -> dict:
    """The decode fleet on one card (ROADMAP queue 1, item 4.2): Qwen2.5-1.5B
    at full width, `FLEET_LAYERS` of its 28 layers, bf16, one set of random
    weights from the seed for every replica; each replica a port
    `DecodeServer` over a `TorchDecodeEngine` in this process, the port's
    router and supervisor on loopback, a `RemoteInfEngine` finding the
    router through name_resolve. (f1) routing, (f2) chaos through the
    router, (f3) a drain-first scale-down, (f4) planted transitions, (f5)
    the disaggregated handoff (and the same trace on two unified replicas),
    (f6) the KV fabric, (f7) a re-role."""
    from areal_tpu_torch.api.cli_args import RouterConfig
    from areal_tpu_torch.launcher.router import DecodeRouter
    from areal_tpu_torch.utils import name_resolve

    cfg = dataclasses.replace(QWEN25_1_5B, num_hidden_layers=FLEET_LAYERS, scan_layers=False)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 59), dev)
    name_resolve.reconfigure(NameResolveConfig(type="memory"))
    torch.cuda.reset_peak_memory_stats(dev)
    secs: dict = {}
    t0 = time.perf_counter()
    reps = [_FleetReplica(dev, params, cfg, "f1") for _ in range(2)]
    router = DecodeRouter(FLEET_EXP, "f1", config=RouterConfig(
        schedule_policy="prefix_affinity", health_poll_interval=0.1, dead_after_failures=2))
    router.start("127.0.0.1", 0)
    try:
        _wait_router(router, [r.addr for r in reps])
        client = _fleet_client("f1")
        client.addresses = [r.addr for r in reps]
        f1 = _fleet_f1(dev, params, cfg, router, reps, client)
        secs["f1"] = time.perf_counter() - t0
        emit("fleet_f1", seconds_leg=secs["f1"], **f1)
        t1 = time.perf_counter()
        f3 = _fleet_f3(dev, params, cfg, router, reps, client)
        secs["f3"] = time.perf_counter() - t1
        emit("fleet_f3", seconds_leg=secs["f3"], **f3)
    finally:
        router.stop()
        for r in reps:
            r.close()
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    f4 = _fleet_f4(dev, params, cfg)
    secs["f4"] = time.perf_counter() - t2
    emit("fleet_f4", seconds_leg=secs["f4"], **f4)
    torch.cuda.empty_cache()
    later = {}
    for leg, fn in (("f5", _fleet_f5), ("f6", _fleet_f6), ("f7", _fleet_f7)):
        t = time.perf_counter()
        later[leg] = fn(dev, params, cfg)
        secs[leg] = time.perf_counter() - t
        emit(f"fleet_{leg}", seconds_leg=secs[leg], **later[leg])
        torch.cuda.empty_cache()
    t3 = time.perf_counter()
    # (x2)'s own geometry: CHAOS_LAYERS of the 28 layers
    f2 = chaos_fleet(dev, dataclasses.replace(cfg, num_hidden_layers=CHAOS_LAYERS))
    secs["f2"] = time.perf_counter() - t3
    name_resolve.reconfigure(NameResolveConfig(type="memory"))
    launches = dict(paged_attention=f1["launches"]["paged_attention"]
                    + f2["launches"]["paged_attention"]
                    + later["f5"]["launches"]["paged_attention"] + later["f6"]["a"]["k3"])
    emit("fleet", model="Qwen2.5-1.5B", source=QWEN25_1_5B_SOURCE,
         cut=f"{FLEET_LAYERS} of 28 layers", replica=FLEET_SERVE, f2_chaos=f2, seconds=secs,
         device_memory_peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
         launches=launches)
    del params
    return dict(launches=launches)


def fleet_only() -> int:
    """`--fleet`: the device and build phases, then the fleet phase alone."""
    dev, smi = phase_device()
    phase_build()
    out = phase_fleet(dev)
    print(smi, flush=True)
    print(json.dumps({"fleet_launches": out["launches"]}), flush=True)
    return 0


# phase: vision RLVR (`areal_tpu_torch/models/qwen2_vl.py`, the decode
# engine's image admissions and per-slot rope offsets,
# `workflow/vision_rlvr.py`, `examples/clevr_grpo.py`) at Qwen2.5-VL-3B's
# published widths
VL_IMAGE_TOKEN = QWEN25_VL_3B_HF["image_token_id"]
VL_START, VL_END = QWEN25_VL_3B_HF["vision_start_token_id"], QWEN25_VL_3B_HF["vision_end_token_id"]
VL_SECTIONS = tuple(QWEN25_VL_3B_HF["rope_scaling"]["mrope_section"])
# a 480x320 CLEVR image under the Qwen2.5-VL processor's resize to
# multiples of 28 (476x308): 22 x 34 patches of 14, 748 rows of 1176
# values, 187 image tokens after the 2x2 merge
VL_GRID = (1, 22, 34)
VL_TEXT_VOCAB = 151643  # ordinary tokens: below the special ones
# clevr_grpo.yaml's decode settings
VL_DECODE = dict(max_running_requests=32, context_length=4096, new_tokens_per_chunk=128,
                 page_size=128)
VL_IMAGES, VL_TEXTS, VL_GREEDY, VL_NEW = 16, 8, 4, 128
VL_IMAGE_TEXT = (20, 60)  # text tokens around an image span
VL_TEXT_LEN = (64, 256)  # the text-only prompts
VL_ORACLE_TOKENS = 16
# bf16 logprobs of the engine's tokens (K3 decode, rope offsets) against
# the plain oracle's (a dense prefill from spliced embeddings and m-rope
# tables). With random weights the bf16 logits spread little (logprobs
# near -11.9), and their step at their magnitude is 2^-9: the two paths'
# rounding orders differ by up to two such steps a token (0.0039), the
# planted rope-delta fault by six (0.0117, mean 0.0046; readings on an
# H100 80GB HBM3 at 700 W). The tolerance is three steps, and a mean of
# 0.002
VL_LOGP_TOL = dict(max_abs=3 * 2.0 ** -9, mean_abs=0.002)
# (v3) step 0's decode logprobs (K3, the checkpoint's CUT_LAYERS) against
# the oracle with the image, and the trainer's (K1) against its
# token-only view, over 16 rows of 64 tokens: each read one bf16 step at
# most (max 0.00196 and 0.00191, mean 0.00039 and 0.00042), and the
# decode logprobs one position late a mean of 0.30 (readings on an H100
# 80GB HBM3 at 700 W, at 4 layers). The bound is two steps, and a mean
# of 0.001
VL_LOOP_TOL = dict(max_abs=2 * 2.0 ** -9, mean_abs=0.001)
VL_YAML = str(Path(__file__).resolve().parent / "examples" / "configs" / "clevr_grpo.yaml")
# `examples/clevr_grpo.py`'s docstring: the offline recipe
VL_OFFLINE = ["tokenizer_path=synthetic-arith", "train_dataset.path=synthetic-vision",
              "actor.path=", "decode.model_path=", "actor.init_from_scratch=true"]
VL_STEPS = 2
# (v2): clevr_grpo.yaml's groups of 8, 8 prompts a step (16 in the yaml)
VL_OFFLINE_SIZE = [f"total_train_steps={VL_STEPS}", "train_dataset.batch_size=8",
                   "rollout.consumer_batch_size=64"]
VL_MAX_LAG = 4  # clevr_grpo.yaml's rollout.max_head_offpolicyness
VL_DATASET = "chip-smoke-clevr"
# (v3): 4 prompts x 4 samples, 64 new tokens, on the (v1b) checkpoint
VL_LOOP = ["tokenizer_path=synthetic-arith", f"train_dataset.path={VL_DATASET}",
           "actor.init_from_scratch=false", "train_dataset.batch_size=4", "gconfig.n_samples=4",
           "gconfig.max_new_tokens=64", "rollout.consumer_batch_size=4", "actor.group_size=4",
           "decode.context_length=1024", "decode.dtype=bfloat16",
           "decode.kv_cache_dtype=bfloat16", "actor.mb_spec.max_tokens_per_mb=8192",
           "saver.freq_epochs=null", "recover.mode=disabled", "evaluator.freq_steps=null",
           "actor.use_decoupled_loss=true", f"total_train_steps={VL_STEPS}"]
VL_SHARD_BYTES = 512 << 20


def _vl_image(rng) -> dict:
    t, h, w = VL_GRID
    vcfg = VisionConfig.from_hf_dict(QWEN25_VL_3B_HF["vision_config"])
    return dict(pixel_values=rng.standard_normal((t * h * w, vcfg.patch_dim), dtype=np.float32),
                image_grid_thw=np.array([VL_GRID], dtype=np.int64))


def _vl_prompt(rng, n_text: int) -> list[int]:
    """Text, one image span (187 image tokens between the vision start and
    end tokens), text: `n_text` ordinary tokens in all."""
    n_img = VL_GRID[0] * (VL_GRID[1] // 2) * (VL_GRID[2] // 2)
    head = rng.integers(0, VL_TEXT_VOCAB, n_text // 2).tolist()
    tail = rng.integers(0, VL_TEXT_VOCAB, n_text - n_text // 2).tolist()
    return head + [VL_START] + [VL_IMAGE_TOKEN] * n_img + [VL_END] + tail


def _vl_model(dev):
    """Qwen2.5-VL-3B's language model (full depth) and tower, bf16, random
    weights from SEED."""
    cfg = ModelConfig.from_hf_config(QWEN25_VL_3B_HF, dtype="bfloat16", param_dtype="bfloat16",
                                     scan_layers=False)
    vcfg = VisionConfig.from_hf_dict(QWEN25_VL_3B_HF["vision_config"])
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    vparams = init_vision_params(vcfg, torch.Generator(device=dev).manual_seed(SEED + 1),
                                 dtype=torch.bfloat16, device=dev)
    return cfg, vcfg, params, vparams


def _vl_engine_model(engine) -> dict:
    """What `_vl_oracle` reads of a decode engine: its language model and
    tower."""
    return dict(params=engine.params, cfg=engine.model_config, layers=engine._layers,
                vparams=engine._vision_params, vcfg=engine._vision_config)


def _vl_oracle(model: dict, prompt: list[int], image: dict, tokens: list[int],
               with_image: bool = True) -> dict:
    """The plain oracle: the logprob of each of `tokens` after `prompt`
    from one dense prefill of prompt + tokens[:-1] (by causality, the
    per-step full prefill's logits) through the plain path
    (`models/qwen2.prefill`: dense attention, no kernel). `with_image`:
    the tower's vectors spliced over the image-pad positions and m-rope
    tables (the decode engine's view); else token embeddings and 1-D
    positions (the trainer's view)."""
    cfg, params = model["cfg"], model["params"]
    dev = params["embed/embedding"].device
    seq = list(prompt) + list(tokens[:-1])
    with torch.no_grad():
        ids = torch.as_tensor(seq, device=dev)
        extra = {}
        if with_image:
            thw = np.asarray(image["image_grid_thw"]).reshape(-1, 3)
            coords = patch_grid_coords(thw, 2).astype(np.int64)
            img = forward_vision(model["vparams"], torch.as_tensor(
                image["pixel_values"], device=dev).to(torch.bfloat16),
                torch.as_tensor(coords, device=dev), model["vcfg"])
            splice_ids = ids.clone()
            splice_ids[len(prompt):] = 0  # generated tokens never splice
            embeds = splice_image_embeds(params["embed/embedding"][ids].to(torch.bfloat16),
                                         splice_ids, img, VL_IMAGE_TOKEN)
            pos3, _ = mrope_positions(np.asarray(seq), thw, VL_IMAGE_TOKEN, 2)
            cos, sin = mrope_table(pos3, cfg.head_dim_, cfg.rope_theta, VL_SECTIONS)
            extra = dict(input_embeds=embeds, rope_cos=cos.to(dev), rope_sin=sin.to(dev))
        logits, _, _ = prefill(params, ids, torch.arange(len(seq), device=dev), cfg,
                               layers=model["layers"], **extra)
        logp = torch.log_softmax(logits[len(prompt) - 1:], dim=-1)
        want = torch.as_tensor(tokens, device=dev)
        return dict(logp=logp.gather(1, want[:, None])[:, 0].cpu().numpy(),
                    argmax=logp.argmax(-1).cpu().numpy())


def _vl_agreement(engine, req, resp) -> dict:
    toks = list(resp.output_tokens[:VL_ORACLE_TOKENS])
    o = _vl_oracle(_vl_engine_model(engine), req.input_ids, req.image_data[0], toks)
    d = np.abs(np.asarray(resp.output_logprobs[:len(toks)]) - o["logp"])
    return dict(tokens=len(toks), max_abs=float(d.max()), mean_abs=float(d.mean()),
                equal_token_share=float(np.mean(o["argmax"] == np.asarray(toks))))


def _vl_within(a: dict, tol: dict = VL_LOGP_TOL) -> bool:
    return a["max_abs"] <= tol["max_abs"] and a["mean_abs"] <= tol["mean_abs"]


@contextlib.contextmanager
def _observe_image_prefills():
    """Each image admission's slot rope delta right after its prefill,
    beside `mrope_positions`'s delta for the request's prompt."""
    seen = []
    image_prefill = TorchDecodeEngine._image_prefill

    def observed(self, slot, item, prompt, ids, pre, bucket):
        image_prefill(self, slot, item, prompt, ids, pre, bucket)
        thw = np.concatenate([np.asarray(d["image_grid_thw"]).reshape(-1, 3)
                              for d in item.image_data])
        _, want = mrope_positions(np.asarray(prompt), thw, self._image_token_id,
                                  self._vision_config.spatial_merge_size)
        seen.append(dict(rid=item.rid, delta=int(self._slot_rope_delta[slot]), want=int(want)))

    TorchDecodeEngine._image_prefill = observed
    try:
        yield seen
    finally:
        TorchDecodeEngine._image_prefill = image_prefill


VL_PLANTED = ("rope_delta_0", "pad_embeds")


def _vl_planted(engine, req) -> dict:
    """The first greedy image request twice more in one wave on the same
    engine, each copy with a planted fault: its m-rope delta forced to 0
    (text decodes at its row, not its m-rope position), or its image
    vectors replaced by the pad token's embedding. Their logprobs against
    the oracle's."""
    image_prefill, encode = engine._image_prefill, engine._encode_images

    def planted(slot, item, prompt, ids, pre, bucket):
        if item.rid == "pad_embeds":
            def pad_embeds(image_data):
                n = encode(image_data).shape[0]
                return engine.params["embed/embedding"][VL_IMAGE_TOKEN].expand(n, -1).to(
                    torch.bfloat16)
            engine._encode_images = pad_embeds
        try:
            image_prefill(slot, item, prompt, ids, pre, bucket)
        finally:
            engine.__dict__.pop("_encode_images", None)
        if item.rid == "rope_delta_0":
            engine._slot_rope_delta[slot] = 0

    engine._image_prefill = planted
    try:
        g = GenerationHyperparameters(greedy=True, max_new_tokens=VL_ORACLE_TOKENS)
        resps = _paused_wave(engine, [ModelRequest(rid=f, input_ids=req.input_ids, gconfig=g,
                                                   image_data=req.image_data)
                                      for f in VL_PLANTED])
    finally:
        engine.__dict__.pop("_image_prefill", None)
    return {f: _vl_agreement(engine, req, r) for f, r in zip(VL_PLANTED, resps)}


def _vl_serve(dev, cfg, vcfg, params, vparams) -> dict:
    """(v1) one engine at full width and depth with clevr_grpo.yaml's
    decode settings: 16 image requests and 8 text-only ones in one wave."""
    engine = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **VL_DECODE), device=dev)
    engine.set_model(params, cfg)
    engine.set_vision_model(vparams, vcfg, VL_IMAGE_TOKEN, mrope_sections=VL_SECTIONS)
    engine.initialize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(SEED + 70)
    images = [_vl_image(rng) for _ in range(VL_IMAGES)]
    reqs = []
    for i, image in enumerate(images):
        g = dict(greedy=True) if i < VL_GREEDY else dict(temperature=1.0)
        reqs.append(ModelRequest(input_ids=_vl_prompt(rng, int(rng.integers(*VL_IMAGE_TEXT))),
                                 gconfig=GenerationHyperparameters(max_new_tokens=VL_NEW, **g),
                                 image_data=[image]))
    for n in rng.integers(*VL_TEXT_LEN, VL_TEXTS):
        reqs.append(ModelRequest(input_ids=rng.integers(0, VL_TEXT_VOCAB, int(n)).tolist(),
                                 gconfig=GenerationHyperparameters(max_new_tokens=VL_NEW,
                                                                   temperature=1.0)))
    try:
        with _observe_image_prefills() as deltas:
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = 0
            t0 = time.perf_counter()
            resps = _paused_wave(engine, reqs)
            wall = time.perf_counter() - t0
            k3 = pa.launches
            # ---- end of the main path ----
        L, steps = cfg.num_hidden_layers, engine.decode_steps
        check(k3 == L * steps > 0, f"vision (v1): K3 {k3}, want {L} x {steps}")
        check(len(deltas) == VL_IMAGES, f"vision (v1): {len(deltas)} image prefills")
        check(all(d["delta"] == d["want"] for d in deltas), f"vision (v1): deltas {deltas}")
        check(all(len(r.output_tokens) == VL_NEW and np.isfinite(r.output_logprobs).all()
                  for r in resps), "vision (v1): a request stopped early or a logprob is not finite")
        agree = [_vl_agreement(engine, reqs[i], resps[i]) for i in range(VL_GREEDY)]
        faults = _vl_planted(engine, reqs[0])
        emit("vision_oracle", tolerance=VL_LOGP_TOL, greedy=agree, planted=faults)
        for i, a in enumerate(agree):
            check(_vl_within(a), f"vision (v1): greedy image request {i} against the oracle {a}")
        for f, a in faults.items():
            check(not _vl_within(a), f"vision (v1): planted {f} within the tolerance: {a}")
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        # the tower per image, traced (device ms summed over its kernels,
        # wall up to a synchronize: ~1,300 kernels a call overrun the
        # launch queue behind `_time_device_and_host`'s sleep); an image
        # prefill beside a text prefill of the same length
        _traced(engine._encode_images, [images[0]])
        _, tower = _traced(engine._encode_images, [images[1]])
        prefill_ms = {}
        for kind in ("image", "text", "image", "text"):
            req = reqs[0] if kind == "image" else ModelRequest(
                input_ids=rng.integers(0, VL_TEXT_VOCAB, len(reqs[0].input_ids)).tolist(),
                gconfig=GenerationHyperparameters(max_new_tokens=1))
            s0 = engine.prefill_seconds
            engine.prefill(ModelRequest(input_ids=req.input_ids, gconfig=req.gconfig,
                                        image_data=req.image_data))
            prefill_ms[kind] = (engine.prefill_seconds - s0) * 1e3  # the second of each
        return dict(run="v1", requests=dict(image=VL_IMAGES, text=VL_TEXTS, greedy=VL_GREEDY,
                                            new_tokens=VL_NEW),
                    settings=VL_DECODE, wall_s=wall, decode_steps=steps,
                    launches=dict(paged_attention=k3), formulas=dict(paged_attention="decode steps x L"),
                    prefill_calls=engine.prefill_calls, image_prefills=len(deltas),
                    rope_deltas=sorted({d["delta"] for d in deltas}),
                    oracle_tolerance=VL_LOGP_TOL, oracle=agree, planted=faults,
                    tower_ms_per_image=dict(device=tower["device_total_ms"],
                                            as_issued=tower["wall_ms"], kernels=tower["kernels"]),
                    prefill_ms=dict(image_request=prefill_ms["image"],
                                    text_request_same_length=prefill_ms["text"],
                                    prompt_tokens=len(reqs[0].input_ids)),
                    max_memory_allocated_gb=peak, images=images, engine=engine)
    except BaseException:
        engine.destroy()
        raise


def _vl_hf_visual(vparams: dict, vcfg) -> dict:
    """The tower's tensors under their HF `visual.*` names and layouts (the
    inverse of `hf_io.load_hf_vision_params`)."""
    D, nH, hd = vcfg.embed_dim, vcfg.num_heads, vcfg.head_dim
    out = {"visual.patch_embed.proj.weight": vparams["patch_embed/kernel"].t().reshape(
        D, vcfg.in_channels, vcfg.temporal_patch_size, vcfg.patch_size, vcfg.patch_size)}
    for i, name in (("0", "fc1"), ("2", "fc2")):
        out[f"visual.merger.mlp.{i}.weight"] = vparams[f"merger/{name}_kernel"].t()
        out[f"visual.merger.mlp.{i}.bias"] = vparams[f"merger/{name}_bias"]
    out["visual.merger.ln_q.weight"] = vparams["merger/ln_q/scale"]
    for b in range(vcfg.depth):
        p = f"visual.blocks.{b}."
        out[p + "norm1.weight"] = vparams["blocks/norm1/scale"][b]
        out[p + "norm2.weight"] = vparams["blocks/norm2/scale"][b]
        out[p + "attn.qkv.weight"] = vparams["blocks/attn/qkv_kernel"][b].reshape(D, 3 * nH * hd).t()
        out[p + "attn.qkv.bias"] = vparams["blocks/attn/qkv_bias"][b].reshape(-1)
        out[p + "attn.proj.weight"] = vparams["blocks/attn/proj_kernel"][b].reshape(nH * hd, D).t()
        out[p + "attn.proj.bias"] = vparams["blocks/attn/proj_bias"][b]
        for m in ("gate", "up", "down"):
            out[p + f"mlp.{m}_proj.weight"] = vparams[f"blocks/mlp/{m}_kernel"][b].t()
            out[p + f"mlp.{m}_proj.bias"] = vparams[f"blocks/mlp/{m}_bias"][b]
    return {k: v.contiguous() for k, v in out.items()}


def _vl_checkpoint(dev, root: str, cfg, params, vparams, vcfg) -> dict:
    """(v1b)'s checkpoint: config.json as Qwen2.5-VL-3B's (the language
    model as model_type "qwen2"), the language model at CUT_LAYERS of its
    36 layers and the tower at full depth, bf16, sharded with an index."""
    cut = dataclasses.replace(cfg, num_hidden_layers=CUT_LAYERS)
    lm = {k: v for k, v in params.items()
          if not k.startswith("layers_") or int(k.split("/")[0][7:]) < CUT_LAYERS}
    t0 = time.perf_counter()
    hf_io.save_hf_params(lm, cut, root, upcast_bf16=False, max_shard_bytes=VL_SHARD_BYTES)
    visual = _vl_hf_visual(vparams, vcfg)
    hf_io.write_safetensors(visual, os.path.join(root, "visual.safetensors"))
    index = os.path.join(root, "model.safetensors.index.json")
    with open(index) as f:
        idx = json.load(f)
    for name in visual:
        idx["weight_map"][name] = "visual.safetensors"
    del visual
    with open(index, "w") as f:
        json.dump(idx, f)
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(dict(QWEN25_VL_3B_HF, num_hidden_layers=CUT_LAYERS,
                       architectures=["Qwen2ForCausalLM"]), f)
    return dict(path=root, write_s=time.perf_counter() - t0, disk_bytes=_dir_bytes(root),
                shards=sorted(set(idx["weight_map"].values())))


def _vl_from_checkpoint(dev, ckpt: str, v1: dict) -> dict:
    """(v1b) an engine started with `model_path` on the checkpoint loads
    the tower through `_maybe_load_vision_tower`; on (v1)'s pixels its
    image vectors are bit-equal to the in-memory tower's."""
    t0 = time.perf_counter()
    eng = TorchDecodeEngine(TorchDecodeConfig(model_path=ckpt, dtype="bfloat16",
                                              kv_cache_dtype="bfloat16", max_running_requests=4,
                                              context_length=1024, page_size=128), device=dev)
    eng.initialize()
    load_s = time.perf_counter() - t0
    try:
        check(eng._vision_params is not None and eng._mrope_sections == VL_SECTIONS
              and eng._image_token_id == VL_IMAGE_TOKEN,
              f"vision (v1b): tower {eng._vision_params is not None}, sections "
              f"{eng._mrope_sections}, image token {eng._image_token_id}")
        mem = v1["engine"]
        with torch.no_grad():
            equal = [torch.equal(eng._encode_images([im]), mem._encode_images([im]))
                     for im in v1["images"][:4]]
        check(all(equal), f"vision (v1b): the loaded tower's vectors differ {equal}")
        return dict(run="v1b", load_s=load_s, layers=eng.model_config.num_hidden_layers,
                    tower_depth=eng._vision_config.depth, images_bit_equal=len(equal))
    finally:
        eng.destroy()


def _vl_items(split: str) -> list[dict]:
    """(v3)'s items in synthetic-vision's schema, at the checkpoint's
    patch size and the CLEVR grid: pre-tokenized prompts with image-pad
    spans and processed patch dicts, made from the seed."""
    rng = np.random.default_rng(SEED + 71 + (split == "train"))
    out = []
    for _ in range(16):
        count = int(rng.integers(1, 5))
        image = _vl_image(rng)
        out.append(dict(input_ids=_vl_prompt(rng, int(rng.integers(*VL_IMAGE_TEXT))),
                        images=[image], answer=str(count)))
    return out


def _vl_dataset() -> None:
    """Register `_vl_items` under VL_DATASET."""
    from areal_tpu_torch.dataset import register_dataset

    @register_dataset(VL_DATASET)
    def _items(path, split, type, tokenizer=None, max_length=None, **kw):
        return _vl_items(split)


def _vl_loop_logps(cfg, vcfg, ckpt: str, dev):
    """(v3)'s batch check. Under the decoupled loss `compute_advantages`
    leaves the decode engine's logprobs in `logprobs` and the trainer's
    recomputed ones in `prox_logp`, both at position t for token t + 1,
    where its rolled `loss_mask` marks them. Step 0's batch is all of
    weight version 0, the checkpoint's: each row's `logprobs` are held
    against the plain oracle with the row's image (`_vl_oracle`), its
    `prox_logp` against the oracle's token-only view (the trainer sees no
    image, 1-D positions), both within VL_LOOP_TOL, and a planted fault,
    the decode logprobs read one position late, must miss it. Every step
    prints the two side by side and their gap."""
    images = {tuple(it["input_ids"]): it["images"][0] for it in _vl_items("train")}
    calls = []

    def batch_check(batch: dict) -> dict:
        lm = batch["loss_mask"] > 0
        gen, tr = batch["logprobs"][lm], batch["prox_logp"][lm]
        d = np.abs(gen - tr)
        row = dict(decode_logp_mean=float(gen.mean()), trainer_logp_mean=float(tr.mean()),
                   decode_first=[round(float(x), 4) for x in gen[:6]],
                   trainer_first=[round(float(x), 4) for x in tr[:6]],
                   max_abs_diff=float(d.max()), mean_abs_diff=float(d.mean()))
        calls.append(row)
        if len(calls) > 1:
            return row
        check(bool((batch["versions"][batch["versions"] >= 0] == 0).all()),
              "vision (v3): step 0 trains on a token of another weight version")
        cut = dataclasses.replace(cfg, num_hidden_layers=CUT_LAYERS)
        params = hf_io.load_hf_params(ckpt, cut, dtype="bfloat16", device=dev)
        model = dict(params=params, cfg=cut, layers=None, vcfg=vcfg,
                     vparams=hf_io.load_hf_vision_params(ckpt, vcfg, device=dev))
        seen, text, late = [], [], []
        for i in range(batch["input_ids"].shape[0]):
            n, p = int(batch["attention_mask"][i].sum()), int(batch["begin_of_answer"][i])
            at = np.arange(p - 1, n - 1)  # position t predicts token t + 1
            check(bool(lm[i, at].all()) and int(lm[i].sum()) == len(at),
                  f"vision (v3): row {i}'s rolled loss mask is not its completion")
            ids = batch["input_ids"][i, :n].tolist()
            prompt, tokens = ids[:p], ids[p:]
            image = images[tuple(prompt)]
            o = _vl_oracle(model, prompt, image, tokens)["logp"]
            t = _vl_oracle(model, prompt, image, tokens, with_image=False)["logp"]
            seen.append(np.abs(batch["logprobs"][i, at] - o))
            text.append(np.abs(batch["prox_logp"][i, at] - t))
            late.append(np.abs(batch["logprobs"][i, at + 1] - o))
        del model, params
        torch.cuda.empty_cache()
        readings = {name: dict(max_abs=float(np.concatenate(x).max()),
                               mean_abs=float(np.concatenate(x).mean()))
                    for name, x in (("decode", seen), ("trainer", text),
                                    ("decode_one_late", late))}
        emit("vision_loop_oracle", tolerance=VL_LOOP_TOL, rows=len(seen),
             tokens=int(sum(len(x) for x in seen)), readings=readings)
        for name in ("decode", "trainer"):
            check(_vl_within(readings[name], VL_LOOP_TOL),
                  f"vision (v3): the {name} logprobs against the oracle {readings[name]}")
        check(not _vl_within(readings["decode_one_late"], VL_LOOP_TOL),
              f"vision (v3): decode logprobs one position late pass {readings['decode_one_late']}")
        row["oracle"] = readings
        return row

    return batch_check


def phase_vision(dev: torch.device) -> dict:
    """Vision RLVR on the card:

    (v1) Qwen2.5-VL-3B at its published widths and depth (36 layers,
         bf16, random weights from SEED) with its tower (32 blocks) in
         memory, clevr_grpo.yaml's decode settings: 16 image requests of
         187 image tokens at CLEVR's processed grid plus 20-60 text
         tokens and 8 text-only ones of 64-256 tokens, 128 new tokens
         each, 4 image requests greedy; K3 = decode steps x 36; each image
         slot's rope delta is `mrope_positions`'s (-170); the 4 greedy
         streams' first 16 logprobs agree with the plain oracle within
         VL_LOGP_TOL, and two planted faults (the delta forced to 0, the
         image vectors replaced by the pad token's) miss it; the tower's
         ms per image, an image prefill beside a text prefill of the same
         length, peak memory;
    (v1b) a checkpoint of the language model at CUT_LAYERS and the tower
         at full depth: an engine started on it loads the tower, and its
         vectors on (v1)'s pixels are bit-equal;
    (v2) `examples/clevr_grpo.py` with its docstring's offline overrides
         for VL_STEPS steps of 8 prompts x 8 samples: the loss, K3 and
         K1/K2a/K2b on their formulas, the version lag within
         max_head_offpolicyness;
    (v3) the GRPO entry point with `workflow=vision_rlvr` on (v1b)'s
         checkpoint (actor and decode engine) under the decoupled loss:
         4 prompts x 4 samples, 64 new tokens, VL_STEPS steps, the launch
         formulas; step 0's decode logprobs against the oracle with each
         row's image and the trainer's against its token-only view, at the
         same positions, within VL_LOOP_TOL, and the decode logprobs read
         one position late outside it (`_vl_loop_logps`)."""
    from areal_tpu_torch.examples import clevr_grpo

    t0 = time.perf_counter()
    cfg, vcfg, params, vparams = _vl_model(dev)
    v1 = _vl_serve(dev, cfg, vcfg, params, vparams)
    times = dict(v1=time.perf_counter() - t0)
    try:
        with tempfile.TemporaryDirectory() as root:
            t = time.perf_counter()
            ckpt = _vl_checkpoint(dev, os.path.join(root, "qwen2.5-vl-3b"), cfg, params,
                                  vparams, vcfg)
            del params, vparams
            torch.cuda.empty_cache()
            v1b = _vl_from_checkpoint(dev, ckpt["path"], v1)
            v1["engine"].destroy()
            torch.cuda.empty_cache()
            times["v1b"] = time.perf_counter() - t
            t = time.perf_counter()
            v2 = _loop_run(dev, "v2", VL_OFFLINE + VL_OFFLINE_SIZE, yaml=VL_YAML,
                           entry=clevr_grpo.main)
            check(v2["max_version_lag"] <= VL_MAX_LAG, f"vision (v2): lag {v2['max_version_lag']}")
            times["v2"] = time.perf_counter() - t
            torch.cuda.empty_cache()
            t = time.perf_counter()
            _vl_dataset()
            v3 = _loop_run(dev, "v3", VL_LOOP + [f"actor.path={ckpt['path']}",
                                                 f"decode.model_path={ckpt['path']}",
                                                 "workflow=vision_rlvr"],
                           yaml=VL_YAML,
                           batch_check=_vl_loop_logps(cfg, vcfg, ckpt["path"], dev),
                           reward_fn=synthetic_vision_reward)
            times["v3"] = time.perf_counter() - t
    finally:
        v1["engine"].destroy()
    v1 = {k: v for k, v in v1.items() if k not in ("engine", "images")}
    runs = [v1, v1b, v2, v3]
    emit("vision", model="Qwen2.5-VL-3B-Instruct", source=QWEN25_VL_3B_SOURCE,
         layers=cfg.num_hidden_layers, tower_depth=vcfg.depth, grid=VL_GRID,
         checkpoint=ckpt, seconds=times,
         rewards={r["run"]: [s["reward_mean"] for s in r["steps"]] for r in (v2, v3)},
         entry_points=["areal_tpu_torch/examples/clevr_grpo.py:main",
                       "areal_tpu_torch/examples/gsm8k_grpo.py:main workflow=vision_rlvr"],
         runs=runs)
    total = {k: v2["launches"][k] + v3["launches"][k] for k in v2["launches"]}
    total["paged_attention"] += v1["launches"]["paged_attention"]
    return dict(launches=total, by_run={r["run"]: r.get("launches") for r in runs})


def vision_only() -> int:
    """`--vision`: the device and build phases, K3 and K1/K2a/K2b against
    their plain versions (the vision shapes among their cases), then the
    vision phase alone."""
    dev, smi = phase_device()
    phase_build()
    phase_kernel(dev)
    phase_flash_kernel(dev)
    out = phase_vision(dev)
    print(smi, flush=True)
    print(json.dumps({"vision_launches": out["launches"]}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the MoE families: Qwen3-30B-A3B and Qwen1.5-MoE-A2.7B
# ---------------------------------------------------------------------------

# (m1): Qwen3-30B-A3B at all 48 layers, 32 greedy requests in one wave:
# a prefill budget of every slot's context admits the whole wave in one
# pass (at the default 8,192 tokens it took three, and four 128-step
# chunks in place of two)
MOE_DECODE = dict(max_running_requests=32, context_length=2048, page_size=128,
                  new_tokens_per_chunk=128, max_prefill_tokens=32 * 1024)
MOE_REQUESTS = 32
MOE_PROMPT = (128, 1024)
MOE_NEW = 256
# 30,532,122,624 parameters in bf16; the dense pool of 32 slots x 16 pages
# of 128 tokens and the null page (513 pages) at 98,304 bytes a token (48
# layers x K and V x 4 heads x 128 x 2 bytes)
MOE_RECKONED_WEIGHTS_GB = 61.06
MOE_RECKONED_KV_GB = 6.455
# (m2): the GRPO entry point at Qwen3-30B-A3B's widths and 4 of its 48
# layers (3.11B parameters), with (c)'s traffic
MOE_LOOP_LAYERS = 4
MOE_LOOP_LAG = 2  # arith_grpo_smoke.yaml's rollout.max_head_offpolicyness
# (m3): Qwen1.5-MoE-A2.7B at 2 of its 24 layers, 16 greedy requests
MOE15_LAYERS = 2
MOE15_DECODE = dict(max_running_requests=16, context_length=2048, page_size=128,
                    new_tokens_per_chunk=128, max_prefill_tokens=16 * 1024)
MOE15_REQUESTS = 16
# the step gate: a one-ulp bf16 difference between K3 and the plain path
# crosses near ties of the random routers and flips picks, and a flipped
# pick changes the hidden state of every layer after it; so the step's
# logits are compared with the plain run's picks replayed in every run,
# and the share of the (layer, slot, k) picks that the kernel path would
# have chosen otherwise stays below this bound. Measured on the H100: 5.1%
# of Qwen3-30B-A3B's 48 x 32 (layer, slot) pick sets differ under the
# replay (6.6% with K3's own routes, where 1 of 32 slots routes alike in
# all 48 layers); the bound holds the picks themselves, with margin
MOE_FLIP_BOUND = 0.02


@contextlib.contextmanager
def _observe_routes():
    """While it is open, `moe_mlp` reports each call's routing: the picks
    claimed and kept, summed on the device apart for decode steps (one
    token a slot) and the rest (prefills)."""
    from areal_tpu_torch.models import qwen2 as model

    rec = dict(counts={}, decode_rows=None)

    def observe(topk_idx, keep, valid):
        n, k = topk_idx.shape
        kind = "decode" if n == rec["decode_rows"] else "other"
        picks = (torch.full((), n, device=keep.device) if valid is None
                 else valid.sum()) * k
        row = torch.stack([picks.float(), keep.sum().float()])
        rec["counts"][kind] = rec["counts"].get(kind, 0) + row

    prev, model.moe_observer = model.moe_observer, observe
    try:
        yield rec
    finally:
        model.moe_observer = prev


def _drop_shares(rec: dict) -> dict:
    out = {}
    for kind, t in rec["counts"].items():
        picks, kept = (float(x) for x in t.tolist())
        out[kind] = dict(picks=picks, dropped=picks - kept,
                         dropped_share=(picks - kept) / picks if picks else 0.0)
    return out


def _moe_requests(rng, vocab: int, n: int, prompt: tuple, new: int) -> list[ModelRequest]:
    return [ModelRequest(rid=f"moe{i}", input_ids=rng.integers(
        0, vocab, int(rng.integers(*prompt, endpoint=True))).tolist(),
        gconfig=GenerationHyperparameters(max_new_tokens=new, greedy=True))
        for i in range(n)]


def _dropped_first_page(attn_fn, bsz: int):
    """`attn_fn` with the first page of every multi-page slot left out of
    its valid rows: the step gate's planted fault."""
    def fn(q, k_pool, v_pool, table, valid):
        dropped = valid.clone()
        dropped[:, :bsz] &= ~(valid.sum(1) > bsz)[:, None]
        return attn_fn(q, k_pool, v_pool, table, dropped)
    return fn


@contextlib.contextmanager
def _route_replay():
    """While it is open, `moe_mlp`'s picks pass through `rec`: each call's
    own picks are appended to `rec["own"]`, and while `rec["replay"]` holds
    a run's recorded picks, call i routes with its i-th entry instead."""
    from areal_tpu_torch.models import qwen2 as model

    rec = dict(own=[], replay=None)

    def picks(topk_idx):
        i = len(rec["own"])
        rec["own"].append(topk_idx)
        return topk_idx if rec["replay"] is None else rec["replay"][i]

    prev, model.moe_picks = model.moe_picks, picks
    try:
        yield rec
    finally:
        model.moe_picks = prev


def _moe_step_gate(engine, cfg, rng, prompt: tuple, tag: str) -> dict:
    """One decode step of the engine's R slots over its served pool (its
    allocator's blocks, every slot active, lengths in the traffic's range
    plus half its new tokens). The plain paged attention (the JAX XLA
    arithmetic) runs it first with its own routes; then K3, the plain path
    with f32 attention, and the f32 path with a planted fault (the first
    page of every slot dropped) run it with those routes replayed, so
    that only attention differs. The check, phase `step`'s rule on every
    slot: the kernel path's logits are no further from the f32-attention
    logits than the plain bf16 path's are, or than 4 bf16 ulps of the
    largest logit, whichever is larger; the planted fault reads further.
    Routes: the share of the (layer, slot, k) picks that K3's path would
    have chosen otherwise under the replay (attention ulps crossing a near
    tie) stays below MOE_FLIP_BOUND; K3's path with its own routes is read
    beside it (a flip there changes every later layer), with the slots
    whose routes agree in all layers."""
    R, L = engine.config.max_running_requests, cfg.num_hidden_layers
    bsz = engine._alloc.block_size
    engine.pause_generation()
    lengths = rng.integers(prompt[0], prompt[1] + 1, R) + MOE_NEW // 2
    for r in range(R):
        check(engine._alloc.ensure(r, int(lengths[r]) + 1), f"{tag}: pool cannot back the step")
    nb = int(engine._alloc.nblocks.max())
    dev = engine.device
    table = torch.from_numpy(engine._alloc.table_slice(nb)).to(dev)
    positions = torch.as_tensor(lengths, device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, R), device=dev)
    active = torch.ones(R, dtype=torch.bool, device=dev)

    def step(rec, fn, replay=None):
        rec["own"], rec["replay"] = [], replay
        out = decode_step_paged(engine.params, tokens, positions, engine._k_pool,
                                engine._v_pool, table, cfg, active=active, attn_fn=fn,
                                layers=engine._layers)
        check(len(rec["own"]) == L, f"{tag}: {len(rec['own'])} routed layers, want {L}")
        return out, torch.stack([t.sort(dim=-1).values for t in rec["own"]])  # [L, R, K]

    with _route_replay() as rec, torch.no_grad():
        plain, plain_picks = step(rec, pa.paged_attention_ref)
        routes = list(rec["own"])
        free, free_picks = step(rec, pa.paged_attention)
        kernel, own_picks = step(rec, pa.paged_attention, routes)
        f32, _ = step(rec, _attn_f32, routes)
        fault, _ = step(rec, _dropped_first_page(_attn_f32, bsz), routes)
    torch.cuda.synchronize()
    # a pick of K3's path absent from the plain run's set: [L, R, K]
    flipped = ~(own_picks[..., :, None] == plain_picks[..., None, :]).any(-1)
    flips = flipped.any(-1)  # [L, R], under the replay
    free_flips = (free_picks != plain_picks).any(-1)  # [L, R], K3's own routes
    scale = f32.abs().max().item()
    kernel_vs_f32 = (kernel - f32).abs().max().item()
    plain_vs_f32 = (plain - f32).abs().max().item()
    fault_vs_f32 = (fault - f32).abs().max().item()
    tol = max(plain_vs_f32, 4 * 2.0 ** (math.floor(math.log2(scale)) - 7))
    out = dict(slots=R, flip_bound=MOE_FLIP_BOUND,
               flipped_pick_share=flipped.float().mean().item(),
               flipped_pick_set_share=flips.float().mean().item(),
               flipped_slots_by_layer=flips.sum(1).tolist(),
               own_routes=dict(flipped_pick_set_share=free_flips.float().mean().item(),
                               slots_agreeing_in_every_layer=int((~free_flips.any(0)).sum()),
                               first_flip_layer=torch.where(
                                   free_flips.any(0), free_flips.float().argmax(0), -1).tolist(),
                               max_abs_logit_diff=(free - plain).abs().max().item()),
               max_abs_logit=scale, tol=tol, kernel_vs_f32_attn=kernel_vs_f32,
               plain_vs_f32_attn=plain_vs_f32, fault_vs_f32_attn=fault_vs_f32,
               kernel_vs_plain=(kernel - plain).abs().max().item())
    emit(f"moe_step_gate_{tag}", **out)
    check(torch.isfinite(kernel).all().item(), f"{tag}: kernel-path logits not finite")
    check(kernel_vs_f32 <= tol, f"{tag}: kernel path {kernel_vs_f32} from the f32-attention "
                                f"logits > {tol} (plain bf16 path: {plain_vs_f32})")
    check(fault_vs_f32 > tol, f"{tag}: the dropped page reads {fault_vs_f32} <= {tol}")
    check(out["flipped_pick_share"] <= MOE_FLIP_BOUND,
          f"{tag}: {out['flipped_pick_share']} of the (layer, slot) picks flip under K3")
    engine.continue_generation()
    return out


def _moe_serve(dev, cfg, settings: dict, n: int, tag: str, rng) -> dict:
    """A decode engine at `cfg` (weights drawn on the card from SEED and
    donated to it), one wave of `n` greedy requests of MOE_PROMPT tokens and
    MOE_NEW new ones, K3 = decode steps x L, then the step gate."""
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **settings), device=dev)
    engine.set_model(params, cfg, donate=True)
    del params
    try:
        engine.initialize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        weights_gb = sum(t.numel() * t.element_size() for t in engine.params.values()) / 1e9
        kv_gb = sum(t.numel() * t.element_size() for t in (engine._k_pool, engine._v_pool)) / 1e9
        reqs = _moe_requests(rng, cfg.vocab_size, n, MOE_PROMPT, MOE_NEW)
        retries0 = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
        with _observe_routes() as rec:
            rec["decode_rows"] = settings["max_running_requests"]
            # ---- the main path: counts to 0 just before, read just after ----
            pa.launches = 0
            t = time.perf_counter()
            resps = _paused_wave(engine, reqs)
            wall = time.perf_counter() - t
            k3 = pa.launches
            # ---- end of the main path ----
            drops = _drop_shares(rec)
        L, steps = cfg.num_hidden_layers, engine.decode_steps
        check(k3 == L * steps > 0, f"{tag}: K3 {k3}, want {L} x {steps}")
        check(all(len(r.output_tokens) == MOE_NEW and np.isfinite(r.output_logprobs).all()
                  and max(r.output_logprobs) <= 0 for r in resps),
              f"{tag}: a request stopped early or a logprob is not finite and <= 0")
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        # the caching allocator near a full card: its peak reservation and
        # the allocations it retried after freeing its cache (each a sync)
        reserved = torch.cuda.max_memory_reserved(dev) / 1e9
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - retries0
        gate = _moe_step_gate(engine, cfg, rng, MOE_PROMPT, tag)
        ttft = [r.ttft * 1e3 for r in resps]
        return dict(run=tag, layers=L, settings=settings, requests=n, prompt=MOE_PROMPT,
                    new_tokens=MOE_NEW, init_s=init_s, weights_gb=weights_gb, kv_pool_gb=kv_gb,
                    max_memory_allocated_gb=peak, max_memory_reserved_gb=reserved,
                    alloc_retries=retries, wall_s=wall, decode_steps=steps,
                    decode_tok_s=engine.decode_tokens / engine.decode_seconds,
                    decode_step_ms=engine.decode_seconds / steps * 1e3,
                    ttft_p50_ms=float(np.percentile(ttft, 50)),
                    prefill_calls=engine.prefill_calls, prefill_s=engine.prefill_seconds,
                    routing=drops, launches=dict(paged_attention=k3),
                    formulas=dict(paged_attention="decode steps x L"), step_gate=gate)
    finally:
        engine.destroy()
        del engine
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _observe_moe_train():
    """While the entry point runs: each trained micro-batch's router aux
    loss (read from the forward `train_batch` runs with `with_aux`) and
    each `train_batch`'s stats, by optimizer step."""
    from areal_tpu_torch.engine import torch_engine

    seen = dict(aux=[], steps=[])
    fwd = torch_engine.model_forward
    train_batch = torch_engine.TorchTrainEngine.train_batch

    def forward(*args, **kwargs):
        out = fwd(*args, **kwargs)
        if kwargs.get("with_aux"):
            seen["aux"].append(out[1].detach())
        return out

    def batch(self, *args, **kwargs):
        n0 = len(seen["aux"])
        stats = train_batch(self, *args, **kwargs)
        seen["steps"].append(dict(stats=stats, aux=[float(a) for a in seen["aux"][n0:]]))
        return stats

    torch_engine.model_forward, torch_engine.TorchTrainEngine.train_batch = forward, batch
    try:
        yield seen
    finally:
        torch_engine.model_forward, torch_engine.TorchTrainEngine.train_batch = fwd, train_batch


def _moe_loop(dev) -> dict:
    """(m2) the GRPO entry point at Qwen3-30B-A3B's widths, MOE_LOOP_LAYERS
    of its 48 layers, remat, router_aux_loss_coef 0.001 as published, on
    (c)'s traffic (`FULL_OVERRIDES`: synthetic-arith, 8 prompts x 4
    samples, 256 new tokens, 2 steps). K3 and K1/K2a/K2b on `_loop_run`'s
    formulas, the version lag within 2, the aux loss finite and above 0 in
    every trained micro-batch of every step, MFU (`utils/flops.py`) and
    `utils/hbm.py`'s estimate beside the peak. The decode engine's and the
    trainer's logprobs of each step's batch are printed side by side with
    their gap, not gated: a decode step groups its 32 slots for routing, a
    trainer micro-batch its packed stream, and capacity drops differ."""
    cfg = ModelConfig.from_hf_config(QWEN3_30B_A3B_HF, dtype="bfloat16", param_dtype="bfloat16",
                                     scan_layers=False, num_hidden_layers=MOE_LOOP_LAYERS,
                                     remat=True)
    gaps = []

    def batch_check(batch: dict) -> dict:
        lm = batch["loss_mask"] > 0
        d = np.abs(batch["logprobs"][lm] - batch["prox_logp"][lm])
        row = dict(decode_logp_mean=float(batch["logprobs"][lm].mean()),
                   trainer_logp_mean=float(batch["prox_logp"][lm].mean()),
                   max_abs_diff=float(d.max()), mean_abs_diff=float(d.mean()))
        gaps.append(row)
        return dict(logp_gap=row)

    with _observe_moe_train() as seen:
        run = _loop_run(dev, "m2", FULL_OVERRIDES + ["actor.use_decoupled_loss=true"],
                        model_config=cfg, reward_fn=parity_reward, batch_check=batch_check)
    check(run["max_version_lag"] <= MOE_LOOP_LAG, f"moe (m2): lag {run['max_version_lag']}")
    steps = seen["steps"]
    check(len(steps) >= FULL_STEPS, f"moe (m2): {len(steps)} train_batch calls")
    for i, s in enumerate(steps):
        check(s["aux"] and all(math.isfinite(a) and a > 0 for a in s["aux"]),
              f"moe (m2) train_batch {i}: aux losses {s['aux']}")
    kind = torch.cuda.get_device_name(dev)
    hbm_row = _hbm_cell(kind, "(m2)", run["max_memory_allocated_gb"],
                        [("actor", cfg, 8192)], (cfg, 32, 512))
    run.update(model="Qwen3-30B-A3B", router_aux_loss_coef=cfg.router_aux_loss_coef,
               params=sum(math.prod(s) for s in named_shapes(cfg).values()),
               train_batches=[dict(aux=s["aux"], loss=s["stats"]["loss"],
                                   mfu=s["stats"]["mfu"],
                                   tokens_per_s=s["stats"]["tokens_per_sec_per_chip"],
                                   train_batch_s=s["stats"]["train_batch_time"])
                              for s in steps], hbm=hbm_row)
    return run


def phase_moe(dev: torch.device) -> dict:
    """The MoE families on the card, random bf16 weights drawn there from
    SEED:

    (m1) Qwen3-30B-A3B at its published widths and all 48 layers
         (61.06 GB of weights) in one decode engine (32 slots, context
         2048, page 128): 32 greedy requests of 128-1024 random tokens
         and 256 new ones in one wave; K3 = decode steps x 48; resident
         weight and pool bytes beside the reckoned ones, peak memory,
         decode tokens/s, ms a step, TTFT p50, the share of routed picks
         dropped at capacity (decode steps and prefills apart); then one
         engine step through K3 against the plain paths with the plain
         run's routes replayed, with a planted dropped page that must
         read outside the tolerance, and the picks K3's path would flip
         (`_moe_step_gate`);
    (m2) the GRPO entry point at Qwen3-30B-A3B's widths and 4 layers
         (`_moe_loop`);
    (m3) Qwen1.5-MoE-A2.7B (MHA 16/16, a shared expert) at 2 of its 24
         layers: 16 greedy requests, gated as (m1)."""
    rng = np.random.default_rng(SEED + 90)
    t0 = time.perf_counter()
    cfg = ModelConfig.from_hf_config(QWEN3_30B_A3B_HF, dtype="bfloat16", param_dtype="bfloat16",
                                     scan_layers=False)
    m1 = _moe_serve(dev, cfg, MOE_DECODE, MOE_REQUESTS, "m1", rng)
    emit("moe_run", **m1)
    check(abs(m1["weights_gb"] - MOE_RECKONED_WEIGHTS_GB) < 0.01,
          f"moe (m1): {m1['weights_gb']} GB of weights, reckoned {MOE_RECKONED_WEIGHTS_GB}")
    check(abs(m1["kv_pool_gb"] - MOE_RECKONED_KV_GB) < 0.01,
          f"moe (m1): a {m1['kv_pool_gb']} GB pool, reckoned {MOE_RECKONED_KV_GB}")
    times = dict(m1=time.perf_counter() - t0)
    t = time.perf_counter()
    m2 = _moe_loop(dev)
    emit("moe_run", **m2)
    times["m2"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg15 = ModelConfig.from_hf_config(QWEN15_MOE_A27B_HF, dtype="bfloat16",
                                       param_dtype="bfloat16", scan_layers=False,
                                       num_hidden_layers=MOE15_LAYERS)
    m3 = _moe_serve(dev, cfg15, MOE15_DECODE, MOE15_REQUESTS, "m3", rng)
    emit("moe_run", **m3)
    times["m3"] = time.perf_counter() - t
    emit("moe", models=dict(m1="Qwen3-30B-A3B", m2="Qwen3-30B-A3B", m3="Qwen1.5-MoE-A2.7B"),
         sources=dict(qwen3_30b_a3b=QWEN3_30B_A3B_SOURCE, qwen15_moe=QWEN15_MOE_A27B_SOURCE),
         reckoned=dict(weights_gb=MOE_RECKONED_WEIGHTS_GB, kv_pool_gb=MOE_RECKONED_KV_GB),
         seconds=times, launches={r["run"]: r["launches"] for r in (m1, m2, m3)})
    total = dict(m2["launches"])
    total["paged_attention"] += m1["launches"]["paged_attention"] + m3["launches"]["paged_attention"]
    return dict(launches=total, by_run={r["run"]: r["launches"] for r in (m1, m2, m3)})


def moe_only() -> int:
    """`--moe`: the device and build phases, K3 and K1/K2a/K2b against
    their plain versions (the MoE shapes among their cases), then the moe
    phase alone."""
    dev, smi = phase_device()
    phase_build()
    phase_kernel(dev)
    phase_flash_kernel(dev)
    out = phase_moe(dev)
    print(smi, flush=True)
    print(json.dumps({"moe_launches": out["launches"]}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# the memory estimator (`utils/hbm.py`) against the cells' measured peaks
# ---------------------------------------------------------------------------

HBM_ALLOC = "jax:d1+d1"  # one device a side: the allocations the port accepts


def _hbm_cell(kind: str, tag: str, peak_gb: float, trainers: list, decode=None) -> dict:
    """One cell's estimate beside its measured peak: `estimate_train_hbm`
    for each trainer (name, model config, micro-batch tokens) and
    `estimate_decode_hbm` for its decode engine (model config, slots,
    context; the port provisions the dense pool), summed because they
    share the card, and `check_hbm`'s report on the first trainer with the
    decode engine (`HBM_ALLOC`, each half checked alone, as in JAX)."""
    from areal_tpu_torch.api.alloc_mode import AllocationMode
    from areal_tpu_torch.utils import hbm

    parts = {name: hbm.estimate_train_hbm(cfg, microbatch_tokens=mb, remat=cfg.remat)
             for name, cfg, mb in trainers}
    _, cfg0, mb0 = trainers[0]
    row: dict = dict(cell=tag)
    if decode is not None:
        dcfg, slots, ctx = decode
        parts["decode"] = hbm.estimate_decode_hbm(dcfg, slots=slots, context_length=ctx,
                                                  kv_cache_dtype=dcfg.dtype)
        row["check_hbm"] = AllocationMode.from_str(HBM_ALLOC).check_hbm(
            cfg0, kind, microbatch_tokens=mb0, remat=cfg0.remat, decode_slots=slots,
            decode_context=ctx)
    else:
        hbm.check_fit(parts[trainers[0][0]], kind)
    total = sum(e.total_bytes for e in parts.values())
    peak = peak_gb * 1e9
    row.update(estimate={k: e.breakdown() for k, e in parts.items()}, estimate_bytes=total,
               measured_peak_bytes=int(peak), measured_over_estimate=peak / total,
               under_estimate=peak > total)
    return row


def phase_hbm(dev: torch.device, loop: dict, train: dict, ppo: dict, rw: dict,
              hf_path: dict) -> dict:
    """(x4): the closed-form estimator beside `torch.cuda.max_memory_allocated`
    for loop cell (c), the train cell, (p2), (r1) and (h1), with the ratio,
    on the card's own row of `utils/hbm.py`; and `check_hbm` must refuse
    Qwen2.5-7B training on one H100."""
    from areal_tpu_torch.api.alloc_mode import AllocationMode, AllocationValidationError
    from areal_tpu_torch.utils import hbm

    kind = torch.cuda.get_device_name(dev)
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    check(hbm.hbm_bytes(kind) == total_memory,
          f"utils/hbm.py's row for {kind!r}: {hbm.hbm_bytes(kind)} bytes, the card reports "
          f"{total_memory}")
    c_cfg = dataclasses.replace(QWEN25_1_5B, remat=True)
    cut = dataclasses.replace(c_cfg, num_hidden_layers=CUT_LAYERS)
    rows = [
        _hbm_cell(kind, "(c)", loop["peak_gb"], [("actor", c_cfg, 8192)], (c_cfg, 32, 512)),
        _hbm_cell(kind, "train", train["peak_gb"], [("actor", train["cfg"], 8192)],
                  (train["cfg"], TRAIN_ROLLOUT["max_running_requests"],
                   TRAIN_ROLLOUT["context_length"])),
        _hbm_cell(kind, "(p2)", ppo["p2_peak_gb"],
                  [("actor", cut, 8192), ("critic", dataclasses.replace(cut, is_critic=True),
                                          8192)], (cut, 32, 512)),
        _hbm_cell(kind, "(r1)", rw["r1_peak_gb"],
                  [("rw", dataclasses.replace(c_cfg, is_critic=True), RW_MB_TOKENS)]),
        # the frozen reference policy's copy of the weights has no term in
        # the estimator (nor in JAX's)
        _hbm_cell(kind, "(h1)", hf_path["h1_peak_gb"], [("actor", cut, 8192)], (cut, 32, 512)),
    ]
    try:
        AllocationMode.from_str(HBM_ALLOC).check_hbm(QWEN25_7B, kind, microbatch_tokens=8192,
                                                     decode_pool_tokens=1 << 16)
        refused = None
    except AllocationValidationError as e:
        refused = str(e)
    check(refused is not None and refused.startswith("train half"),
          f"check_hbm did not refuse Qwen2.5-7B training on one {kind}: {refused}")
    emit("hbm", device=kind, total_memory=total_memory, allocation=HBM_ALLOC,
         estimator="areal_tpu_torch/utils/hbm.py", cells=rows, qwen25_7b_train_refused=refused)
    return dict(cells=rows)


# ---------------------------------------------------------------------------
# the host KV tier, the gather paths and fp pools in another dtype
# ---------------------------------------------------------------------------

# K3's and K4's variants over a pool in the other dtype than q's: (q dtype,
# pool dtype) -> the wrapper's counter and the kernels line's name
MIXED_VARIANTS = {
    (False, torch.float32, torch.bfloat16): ("launches_f32q_bf16pool",
                                             "paged_attention_f32q_bf16pool"),
    (False, torch.bfloat16, torch.float32): ("launches_bf16q_f32pool",
                                             "paged_attention_bf16q_f32pool"),
    (True, torch.float32, torch.bfloat16): ("launches_verify_f32q_bf16pool",
                                            "paged_verify_f32q_bf16pool"),
    (True, torch.bfloat16, torch.float32): ("launches_verify_bf16q_f32pool",
                                            "paged_verify_bf16q_f32pool"),
}
MIXED_KERNEL_NAMES = {False: "paged_attn_{}_kernel", True: "paged_verify_{}_kernel"}


def _mixed_inputs(case: dict, verify: bool, qdt, pdt, dev, seed: int):
    """A kernel case with its pools in `pdt` and q in `qdt`: K3's at the
    serve batch (`_paged_case`), K4's at W = SPEC_K + 1 (`_verify_case`)."""
    if verify:
        q, k, v, table, valid = _verify_case(case, SPEC_K + 1, pdt, dev, seed)
    else:
        q, k, v, table, valid = _paged_case(case, pdt, dev, seed)
    return q.to(qdt), k, v, table, valid


def _mixed_timing_inputs(verify: bool, qdt, pdt, dev, layers: int = 4):
    """The serve batch's shape for timing (as `_served_batch`: 16 slots of
    64 + 128 to 1024 + 128 rows, Qwen2.5-7B's heads, page 128; K4 at W =
    SPEC_K + 1 past each slot's rows) over `layers` pools in `pdt`, a
    random block table, q in `qdt`."""
    rng = np.random.default_rng(SEED + 45)
    R, nH, nKV, hd, bsz = SERVE["max_running_requests"], 28, 4, 128, SERVE["page_size"]
    W = SPEC_K + 1 if verify else 1
    lengths = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, R) + 128
    nb = -(-(int(lengths.max()) + W) // bsz)
    table = torch.as_tensor(rng.permutation(R * nb).reshape(R, nb) + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 45)
    shape = (R * nb + 1, bsz, nKV, hd)
    kp = [torch.randn(shape, generator=gen, device=dev).to(pdt) for _ in range(layers)]
    vp = [torch.randn(shape, generator=gen, device=dev).to(pdt) for _ in range(layers)]
    q = torch.randn((R, W, nH, hd), generator=gen, device=dev).to(qdt)
    horizon = torch.as_tensor(lengths, device=dev)[:, None] + torch.arange(W, device=dev)
    valid = (torch.arange(nb * bsz, device=dev)[None, None, :] <= horizon[:, :, None]).contiguous()
    if not verify:
        q, valid = q[:, 0].contiguous(), valid[:, 0].contiguous()
    return q, kp, vp, table, valid


def _mixed_ref(verify: bool, q, k, v, table, valid):
    """The plain version of what the variant computes: the pool cast to q's
    dtype (`kc.to(q.dtype)`, the XLA path), then attention in f32."""
    fn = pa.paged_attention_qlen_ref if verify else pa.paged_attention_ref
    return fn(q.float(), k.to(q.dtype).float(), v.to(q.dtype).float(), table, valid)


def _mixed_bound(verify: bool, q, k, table, valid) -> tuple[float, str]:
    """Bytes: each K and V row some query reads, in the pool's dtype, q and
    the output in q's, the table and the mask, at HBM_BYTES_PER_S;
    operations: 4 nH hd per valid (query, row) pair at q's dtype's peak."""
    R, nb = table.shape
    nH, hd = q.shape[-2], q.shape[-1]
    nKV = k.shape[2]
    rows = int((valid.any(dim=1) if verify else valid).sum().item())
    pairs = int(valid.sum().item())
    nbytes = (rows * nKV * 2 * hd * k.element_size() + 2 * q.numel() * q.element_size()
              + R * nb * 4 + valid.numel())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * nH * hd * pairs / peak_flops(q.dtype) * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def phase_mixed_kernel(dev: torch.device) -> dict:
    """K3's and K4's variants over a pool in the other dtype than q's (f32 q
    over a bf16 pool: the first versions, each value widened exactly; bf16
    q over an f32 pool: the tensor-core kernels, the f32 rows rounded to
    bf16 to nearest even in shared memory) against their plain versions
    on the serve shape of `KERNEL_CASES` (R 16, context 4096), a second
    shape (K3: a group of 12; K4: 40-row pages, W 5) and the shape the
    kv_tier phase's (d) leg gives them (Qwen2.5-1.5B's 12/2 heads, R 8,
    context 2048, page 128; K4 at W = SPEC_K + 1), within `KERNEL_TOL`
    of q's dtype, and against a planted fault (the first page of every
    multi-page slot dropped from the plain version's mask), which must
    read above it. At the serve batch (K4: the spec batch, W 5), rotating
    over 4 layers' pools: ms as issued and on the device alone,
    the plain version's ms and SDPA's on KV pre-gathered and cast to q's
    dtype. Returns one kernels-line row per variant (launches filled in by
    the kv_tier phase's (d) leg)."""
    rows = {}
    d_case = dict(KERNEL_CASES[1], name="kv_tier-d", R=KV_TIER_D_DECODE["max_running_requests"],
                  max_len=KV_TIER_D_DECODE["context_length"])
    for (verify, qdt, pdt), (_, name) in MIXED_VARIANTS.items():
        checks = []
        second = VERIFY_CASES[4] if verify else KERNEL_CASES[4]
        for i, case in enumerate((KERNEL_CASES[0], second, d_case)):
            q, k, v, table, valid = _mixed_inputs(case, verify, qdt, pdt, dev, SEED + 40 + i)
            fn = pa.paged_attention_qlen if verify else pa.paged_attention
            out = fn(q, k, v, table, valid)
            ref = _mixed_ref(verify, q, k, v, table, valid)
            dropped = valid.clone()
            multi = (valid.any(dim=1) if verify else valid).sum(-1) > case["bsz"]
            page0 = dropped[..., : case["bsz"]]
            page0 &= ~multi.reshape(-1, *([1] * (valid.dim() - 1)))
            ref_fault = _mixed_ref(verify, q, k, v, table, dropped)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[qdt]
            ratio = _tol_ratio(out, ref, atol, rtol)
            fault = _tol_ratio(out, ref_fault, atol, rtol)
            err = (out.float() - ref).abs().max().item()
            checks.append(dict(case=case["name"], max_abs_err=err, tol_ratio=ratio,
                               planted_fault_tol_ratio=fault))
            check(math.isfinite(ratio) and ratio <= 1.0,
                  f"{name} {case['name']}: {ratio} x the tolerance (max abs err {err})")
            check(fault > 1.0, f"{name} {case['name']}: a dropped page passes the tolerance")
        # timings at the serve (spec) batch, over 4 layers' pools
        q, kp, vp, table, valid = _mixed_timing_inputs(verify, qdt, pdt, dev)
        k = kp[0]
        fn = pa.paged_attention_qlen if verify else pa.paged_attention
        plain = pa.paged_attention_qlen_ref if verify else pa.paged_attention_ref
        counter = MIXED_VARIANTS[(verify, qdt, pdt)][0]
        calls = getattr(pa, counter)
        ms = _time(lambda i: fn(q, kp[i % 4], vp[i % 4], table, valid), 200)
        ms_device = _time_device(lambda i: fn(q, kp[i % 4], vp[i % 4], table, valid), 200)
        check(getattr(pa, counter) > calls, f"{name}: timing did not launch the kernel")
        plain_ms = _time(lambda i: plain(q, kp[i % 4], vp[i % 4], table, valid), 20)
        R, nb = table.shape
        bsz, nKV, hd = k.shape[1:]
        nH = q.shape[-2]
        idx = table.reshape(-1).long()

        def gathered(pool):
            g = pool.index_select(0, idx).reshape(R, nb * bsz, nKV, hd).to(qdt)
            return g.permute(0, 2, 1, 3).repeat_interleave(nH // nKV, dim=1).contiguous()

        ks, vs = [gathered(p) for p in kp], [gathered(p) for p in vp]
        q4 = (q if verify else q[:, None]).permute(0, 2, 1, 3)  # [R, nH, W, hd]
        mask = (valid if verify else valid[:, None])[:, None]  # [R, 1, W, span]
        library_ms = _time(lambda i: torch.nn.functional.scaled_dot_product_attention(
            q4, ks[i % 4], vs[i % 4], attn_mask=mask), 200)
        bound_ms, bound_by = _mixed_bound(verify, q, k, table, valid)
        q_name = "f32" if qdt == torch.float32 else "bf16"
        p_name = "bf16" if pdt == torch.bfloat16 else "f32"
        kernel = (f"paged_{'verify' if verify else 'attn'}_kernel<float, bf16>" if qdt == torch.float32
                  else f"paged_{'verify' if verify else 'attn'}_f32pool_mma_kernel + combine")
        rows[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=VERIFY_REPLACES if verify else KERNEL_REPLACES, kernel=kernel,
            launches=0, max_abs_err=max(c["max_abs_err"] for c in checks),
            ms=ms, ms_device=ms_device, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms,
            library_call=f"scaled_dot_product_attention, KV pre-gathered and cast to {q_name}",
            checks=checks,
            shape=dict(R=R, W=q.shape[1] if verify else 1, nH=nH, nKV=nKV, hd=hd, bsz=bsz, nb=nb,
                       q=q_name, pool=p_name),
        )
        del kp, vp, ks, vs
        torch.cuda.empty_cache()
    emit("mixed_kernel", tol={str(k).split(".")[-1]: v for k, v in KERNEL_TOL.items()},
         variants=list(rows.values()))
    return rows


# the kv_tier phase: Qwen2.5-7B, bf16, 16 slots, context 4096, page 128, on
# the serve cell's weights. KV_TIER_SETTINGS admits a whole 16-request wave
# in one pass (16 prompts of up to 1024 tokens), so that a wave's prefills
# are grouped alike in every engine.
KV_TIER_SETTINGS = dict(SERVE, max_prefill_tokens=16384)
KV_TIER_POOL = 20480  # (k1): the 16 parked slots fit; the fillers' admissions evict them
KV_TIER_HOST_MB = 2048
KV_TIER_PREEMPT_POOL = 12288  # (k2): 96 blocks for 16 slots of up to 10: active slots preempt
KV_TIER_PROMPT = (512, 1024)
KV_TIER_NEW = 256
KV_TIER_FILL_PROMPT = (32, 96)
KV_TIER_FILL_NEW = 16
# every leg on the serve cell's weights at CUT_LAYERS (2) of its 28 layers
# since the fleet phase came (at SERVE_LAYERS, 14, the phase took 79.5-118.5
# s on an H100 80GB HBM3 at 700 W; with (k1)-(k3) at 28, 111.2 s): the
# checks are per layer and per block (launch formulas, swap bytes by
# `kv_block_nbytes`, streams bit-equal)
KV_TIER_LAYERS = CUT_LAYERS
KV_TIER_INT8_REQUESTS = 8
KV_TIER_W_REQUESTS = 8
KV_TIER_W_NEW = 128
# kernel paths against plain ones on whole streams: greedy tokens equal up
# to a first divergence (a near tie that the two paths' roundings break
# differently), logprobs within STREAM_LOGP_TOL there and at the
# divergence, where both are the argmax's; and teacher-forced (`_forced`)
# at every emitted token. The bound the script holds decode logprobs to
# against the trainer's
STREAM_LOGP_TOL = LOGP_MAX_ABS_DIFF


def _tier_requests(rng, vocab: int, n: int, tag: str) -> list[ModelRequest]:
    """`n` requests, prompts of 512-1024 tokens, `KV_TIER_NEW` new tokens;
    the first half greedy, the rest at temperature 1.0."""
    out = []
    for i in range(n):
        ids = rng.integers(0, vocab, int(rng.integers(*KV_TIER_PROMPT, endpoint=True))).tolist()
        g = GenerationHyperparameters(max_new_tokens=KV_TIER_NEW)
        g = g.new(greedy=True) if i < n // 2 else g.new(temperature=1.0)
        out.append(ModelRequest(rid=f"{tag}{i}", input_ids=ids, gconfig=g))
    return out


def _fillers(rng, vocab: int, n: int, tag: str) -> list[ModelRequest]:
    g = GenerationHyperparameters(max_new_tokens=KV_TIER_FILL_NEW, greedy=True)
    return [ModelRequest(rid=f"{tag}{i}", gconfig=g, input_ids=rng.integers(
        0, vocab, int(rng.integers(*KV_TIER_FILL_PROMPT, endpoint=True))).tolist())
        for i in range(n)]


def _resumes(reqs, first) -> list[ModelRequest]:
    """The client's resume of interrupted requests: prompt + partial tokens
    under the same rid, the rest of the budget."""
    return [ModelRequest(rid=r.rid, input_ids=r.input_ids + f.output_tokens,
                         gconfig=r.gconfig.new(max_new_tokens=r.gconfig.max_new_tokens - f.output_len))
            for r, f in zip(reqs, first)]


def _tier_engine(dev, params, cfg, **settings):
    eng = TorchDecodeEngine(TorchDecodeConfig(random_seed=SEED, **settings), device=dev)
    eng.set_model(params, cfg)
    return eng.initialize()


def _exact(got: list, want: list, what: str) -> dict:
    """Streams of the same kernels: tokens equal, logprobs within
    KERNEL_TOL (bf16) of the reference; how many are bit-equal."""
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    bit = 0
    for i, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
        check(gt == wt, f"{what}: stream {i}'s tokens differ")
        gl, wl = np.asarray(gl), np.asarray(wl)
        check(bool((np.abs(gl - wl) <= atol + rtol * np.abs(wl)).all()),
              f"{what}: stream {i}'s logprobs differ beyond KERNEL_TOL")
        bit += bool(np.array_equal(gl, wl))
    return dict(streams=len(got), tokens_equal=len(got), logprobs_bit_equal=bit)


def _agree(got: list, want: list, greedy: list, what: str) -> dict:
    """A kernel path's streams against a plain or differently batched one:
    tokens equal up to a first divergence, logprobs within STREAM_LOGP_TOL
    before it; a greedy stream's logprobs also at it (both are the argmax's
    logprob: a near tie). Streams equal in full, and each one's prefix."""
    prefixes, worst = [], 0.0
    for i, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
        n = next((j for j, (a, b) in enumerate(zip(gt, wt)) if a != b), min(len(gt), len(wt)))
        m = min(n + 1, len(gt), len(wt)) if greedy[i] else n
        d = float(np.abs(np.asarray(gl[:m]) - np.asarray(wl[:m])).max()) if m else 0.0
        check(d <= STREAM_LOGP_TOL, f"{what}: stream {i}'s logprobs differ by {d} before "
                                    f"position {n}")
        prefixes.append(n)
        worst = max(worst, d)
    return dict(streams=len(got), equal=sum(n == len(g[0]) == len(w[0]) for n, g, w in
                                            zip(prefixes, got, want)),
                agree_prefix=prefixes, logprob_max_abs_diff=worst)


def _streams(resps) -> list:
    return [(list(r.output_tokens), list(r.output_logprobs)) for r in resps]


def _forced(params, cfg, reqs, streams, what: str, dev, planted: bool = False) -> dict:
    """Teacher-forced: each stream's prompt and emitted tokens through the
    plain dense forward (`prefill`: no hand-written kernel, attention in
    the XLA op order), and every emitted token's logprob against the
    stream's, to the stream's end (no other run's divergence ends it):
    within STREAM_LOGP_TOL; a greedy stream's token the forward's argmax
    up to STREAM_LOGP_TOL (a near tie). With `planted`, the longest
    prompt's stream is scored again without its first page of context
    (positions kept), which must read above the tolerance."""
    layers = layer_views(params, cfg)

    def score(ids, start, toks):
        with torch.no_grad():
            pos = torch.arange(start, start + len(ids), device=dev)
            logits, _, _ = prefill(params, torch.as_tensor(ids, device=dev), pos, cfg,
                                   layers=layers)
            lp = torch.log_softmax(logits[-len(toks):], dim=-1)  # the rows that chose toks
            got = lp.gather(1, torch.as_tensor(toks, device=dev)[:, None])[:, 0]
            gap = (lp.max(dim=-1).values - got).max().item()
            return got.double().cpu().numpy(), gap

    worst = gap = total = 0.0
    n = 0
    for req, (toks, lps) in zip(reqs, streams):
        got, g = score(req.input_ids + toks[:-1], 0, toks)
        d = np.abs(got - np.asarray(lps, np.float64))
        worst, total, n = max(worst, float(d.max())), total + float(d.sum()), n + d.size
        if req.gconfig.greedy:
            gap = max(gap, g)
    check(worst <= STREAM_LOGP_TOL, f"{what}: teacher-forced logprobs differ by {worst}")
    check(gap <= STREAM_LOGP_TOL, f"{what}: a greedy token is {gap} below the forward's argmax")
    out = dict(tokens=n, max_abs_diff=worst, mean_abs_diff=total / n, greedy_argmax_gap=gap)
    if planted:
        i = max(range(len(reqs)), key=lambda j: len(reqs[j].input_ids))
        toks, lps = streams[i]
        page = KV_TIER_SETTINGS["page_size"]
        got, _ = score((reqs[i].input_ids + toks[:-1])[page:], page, toks)
        out["planted_fault_max_abs_diff"] = fault = float(np.abs(got - np.asarray(lps)).max())
        check(fault > STREAM_LOGP_TOL, f"{what}: a dropped page of context reads {fault}, "
                                       f"within {STREAM_LOGP_TOL}")
    return out


def _pinned_rates(nbytes: int, dev) -> dict:
    """GB/s of one plain copy of `nbytes` each way between pinned host
    memory and the card, and what the first pin of a buffer that size cost."""
    t = time.perf_counter()
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    first_pin_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    del host
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)  # from the allocator's cache
    cached_pin_ms = (time.perf_counter() - t) * 1e3
    dev_buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    d2h = _time(lambda i: host.copy_(dev_buf, non_blocking=True), 5)
    h2d = _time(lambda i: dev_buf.copy_(host, non_blocking=True), 5)
    return dict(bytes=nbytes, d2h_gb_s=nbytes / d2h / 1e6, h2d_gb_s=nbytes / h2d / 1e6,
                first_pin_ms=first_pin_ms, cached_pin_ms=cached_pin_ms)


def _tier_metrics(eng) -> dict:
    m = eng.get_metrics()
    return {k: m[k] for k in m if k.startswith(("kv_host", "kv_swap", "kv_offload", "kv_promote",
                                                "reprefill", "kv_block_nbytes"))}


def _tier_k1(dev, params, cfg, oracle_reqs, oracle) -> dict:
    """(k1): the 16 requests interrupted after their first chunk (parked),
    16 fillers whose admissions evict every parked slot to the host tier,
    then the 16 resumed under their rids: promoted, no prefill, the joined
    streams the never-evicted engine's (`_exact`: the same waves, so the
    same K3 splits and prefill groups)."""
    n_chunk = KV_TIER_SETTINGS["new_tokens_per_chunk"]
    eng = _tier_engine(dev, params, cfg, kv_pool_tokens=KV_TIER_POOL,
                       kv_host_pool_mb=KV_TIER_HOST_MB, **KV_TIER_SETTINGS)
    rng = np.random.default_rng(SEED + 51)
    try:
        first = _paused_wave(eng, oracle_reqs, interrupt=True)
        for r in first:
            check(r.stop_reason == "interrupt" and r.output_len == n_chunk,
                  f"(k1) {r.stop_reason} after {r.output_len} tokens, want interrupt after {n_chunk}")
        check(len(eng._parked) == len(oracle_reqs), f"(k1) {len(eng._parked)} parked")
        covered = [len(r.input_ids) - 1 + f.output_len for r, f in zip(oracle_reqs, first)]
        blocks = sum(-(-c // eng._alloc.block_size) for c in covered)
        t = time.perf_counter()
        _paused_wave(eng, _fillers(rng, cfg.vocab_size, len(oracle_reqs), "kf"))
        fill_s = time.perf_counter() - t
        m1 = _tier_metrics(eng)
        check(m1["kv_host_pool_entries"] == len(oracle_reqs),
              f"(k1) {m1['kv_host_pool_entries']} host entries after the fillers")
        check(m1["kv_swap_out_bytes_total"] == blocks * m1["kv_block_nbytes"],
              f"(k1) swapped out {m1['kv_swap_out_bytes_total']} B, want {blocks} blocks x "
              f"{m1['kv_block_nbytes']}")
        c1 = _sched_counts(eng)
        t = time.perf_counter()
        second = _paused_wave(eng, _resumes(oracle_reqs, first))
        resume_s = time.perf_counter() - t
        d = _delta(eng, c1)
        m2 = _tier_metrics(eng)
        check(d["prefill_calls"] == 0, f"(k1) the resumes ran {d['prefill_calls']} prefill forwards")
        check(m2["kv_host_hits_total"] == len(oracle_reqs) and m2["kv_host_hit_rate"] == 1.0,
              f"(k1) host hits {m2['kv_host_hits_total']}, hit rate {m2['kv_host_hit_rate']}")
        check(m2["kv_offload_failures_total"] == 0 and m2["kv_promote_failures_total"] == 0,
              f"(k1) failures: offload {m2['kv_offload_failures_total']}, "
              f"promote {m2['kv_promote_failures_total']}")
        check(m2["kv_swap_in_bytes_total"] == blocks * m2["kv_block_nbytes"],
              f"(k1) swapped in {m2['kv_swap_in_bytes_total']} B, want {blocks} blocks")
        joined = [(a.output_tokens + b.output_tokens, a.output_logprobs + b.output_logprobs)
                  for a, b in zip(first, second)]
        rates = eng.swap_rates()
        return dict(
            layers=cfg.num_hidden_layers, requests=len(oracle_reqs), blocks=blocks,
            block_nbytes=m2["kv_block_nbytes"], fillers_s=fill_s, resume_s=resume_s,
            resume_prefill_calls=d["prefill_calls"], resume_decode_steps=d["decode_steps"],
            tier=m2, against_never_evicted=_exact(joined, oracle, "(k1) evicted vs never-evicted"),
            swap=dict(out_bytes=rates["out"]["bytes"], out_s=rates["out"]["seconds"],
                      out_gb_s=rates["out"]["bytes"] / rates["out"]["seconds"] / 1e9,
                      in_bytes=rates["in"]["bytes"], in_s=rates["in"]["seconds"],
                      in_gb_s=rates["in"]["bytes"] / rates["in"]["seconds"] / 1e9,
                      plain_pinned=_pinned_rates(blocks * m2["kv_block_nbytes"] // len(oracle_reqs),
                                                 dev)),
        )
    finally:
        eng.destroy()


def _tier_k3(dev, params, cfg, req, want) -> dict:
    """(k3), 4 slots: the first of the 16 requests (greedy) interrupted,
    evicted by 4 fillers, and a planted `kv.swap_in` fault at its
    promotion: one promotion failure, one prefill, no offload failure, the
    stream against the never-evicted one (`want`; `_agree`: the prefill
    writes rows the decode steps had written, rounded otherwise) and
    teacher-forced."""
    from areal_tpu_torch.core import fault_injection

    settings = dict(KV_TIER_SETTINGS, max_running_requests=4)
    rng = np.random.default_rng(SEED + 56)
    eng = _tier_engine(dev, params, cfg, kv_host_pool_mb=KV_TIER_HOST_MB, **settings)
    try:
        cut, = _paused_wave(eng, [req], interrupt=True)
        _paused_wave(eng, _fillers(rng, cfg.vocab_size, settings["max_running_requests"], "kg"))
        c3, m3 = _sched_counts(eng), _tier_metrics(eng)
        check(m3["kv_host_pool_entries"] == 1, f"(k3) {m3['kv_host_pool_entries']} host entries")
        fault_injection.configure(fault_injection.FaultPlan.from_json(
            '{"points": [{"site": "kv.swap_in", "at": [0]}]}'))
        try:
            again, = _paused_wave(eng, _resumes([req], [cut]))
        finally:
            fault_injection.deactivate()
        d3, m4 = _delta(eng, c3), _tier_metrics(eng)
        check(m4["kv_promote_failures_total"] == 1, f"(k3) {m4['kv_promote_failures_total']} "
                                                    "promotion failures, want 1")
        check(d3["prefill_calls"] == 1 and d3["prefills"] == 1,
              f"(k3) the faulted resume ran {d3['prefill_calls']} prefill forwards, want 1")
        check(m4["kv_offload_failures_total"] == 0, "(k3) an offload failed")
        stream = [(cut.output_tokens + again.output_tokens, cut.output_logprobs + again.output_logprobs)]
        return dict(layers=cfg.num_hidden_layers, promote_failures=m4["kv_promote_failures_total"],
                    prefill_calls=d3["prefill_calls"],
                    against_never_evicted=_agree(stream, [want], [True], "(k3)"),
                    forced=_forced(params, cfg, [req], stream, "(k3)", dev))
    finally:
        eng.destroy()


def _tier_k2(dev, params, cfg, reqs, oracle) -> dict:
    """(k2): the 16 requests on a pool of 12,288 tokens under run-ahead 1:
    pool pressure preempts active slots, whose consumed coverage goes to
    the host tier and is promoted at re-admission. The preemptions change
    which slots share a step (so K3's split of a slot's table may differ
    from the never-evicted run's): the streams are held to `_agree` and
    teacher-forced, with its planted fault."""
    eng = _tier_engine(dev, params, cfg, kv_pool_tokens=KV_TIER_PREEMPT_POOL,
                       kv_host_pool_mb=KV_TIER_HOST_MB, **KV_TIER_SETTINGS)
    try:
        c0 = _sched_counts(eng)
        t = time.perf_counter()
        got = _paused_wave(eng, reqs)
        wall = time.perf_counter() - t
        d, m = _delta(eng, c0), _tier_metrics(eng)
        check(eng.n_preemptions > 0 and m["kv_host_hits_total"] > 0,
              f"(k2) {eng.n_preemptions} preemptions, {m['kv_host_hits_total']} host hits")
        check(m["kv_offload_failures_total"] == 0 and m["kv_promote_failures_total"] == 0,
              "(k2) an offload or a promotion failed")
        for req, r in zip(reqs, got):
            check(r.stop_reason == "length" and r.output_len == KV_TIER_NEW,
                  f"(k2) {req.rid}: {r.stop_reason} after {r.output_len}")
        return dict(preemptions=eng.n_preemptions, wall_s=wall, prefill_calls=d["prefill_calls"],
                    decode_steps=d["decode_steps"], tier=m,
                    against_never_evicted=_agree(_streams(got), oracle,
                                                 [r.gconfig.greedy for r in reqs], "(k2)"),
                    forced=_forced(params, cfg, reqs, _streams(got), "(k2)", dev, planted=True))
    finally:
        eng.destroy()


def _layer_subset(params: dict, layers: int) -> dict:
    """The first `layers` layers of a `layers_{i}/...` tree and the rest."""
    return {k: t for k, t in params.items()
            if not k.startswith("layers_") or int(k.split("/")[0].split("_")[1]) < layers}


def _tier_k4(dev, params, cfg) -> dict:
    """(k4): an int8 pool, 8 slots, 8 requests: evicted and resumed as
    (k1), the streams bit-equal to a never-evicted int8 engine on the same
    weights; K5a = decode steps x L over the evicted engine's leg, K3 = 0."""
    L = cfg.num_hidden_layers
    n = KV_TIER_INT8_REQUESTS
    settings = dict(KV_TIER_SETTINGS, max_running_requests=n, kv_dtype="int8")
    reqs = _tier_requests(np.random.default_rng(SEED + 52), cfg.vocab_size, n, "q")
    oracle_eng = _tier_engine(dev, params, cfg, **settings)
    try:
        oracle = _streams(_paused_wave(oracle_eng, reqs))
    finally:
        oracle_eng.destroy()
    eng = _tier_engine(dev, params, cfg, kv_host_pool_mb=KV_TIER_HOST_MB, **settings)
    try:
        steps0 = eng.decode_steps
        pa.launches = pa.launches_q8 = 0
        first = _paused_wave(eng, reqs, interrupt=True)
        _paused_wave(eng, _fillers(np.random.default_rng(SEED + 53), cfg.vocab_size, n, "qf"))
        c1 = _sched_counts(eng)
        second = _paused_wave(eng, _resumes(reqs, first))
        launches = dict(paged_attention=pa.launches, paged_attention_q8=pa.launches_q8)
        d, m = _delta(eng, c1), _tier_metrics(eng)
        steps = eng.decode_steps - steps0
        check(launches["paged_attention_q8"] == steps * L and launches["paged_attention"] == 0,
              f"(k4) K5a {launches['paged_attention_q8']} != {steps} steps x {L}, "
              f"K3 {launches['paged_attention']}")
        check(d["prefill_calls"] == 0 and m["kv_host_hits_total"] == n,
              f"(k4) resume prefills {d['prefill_calls']}, host hits {m['kv_host_hits_total']}")
        check(m["kv_offload_failures_total"] == 0 and m["kv_promote_failures_total"] == 0,
              "(k4) an offload or a promotion failed")
        joined = [(a.output_tokens + b.output_tokens, a.output_logprobs + b.output_logprobs)
                  for a, b in zip(first, second)]
        exact = _exact(joined, oracle, "(k4) int8 evicted vs never-evicted")
        check(exact["logprobs_bit_equal"] == n, f"(k4) {exact['logprobs_bit_equal']} of {n} bit-equal")
        return dict(layers=L, requests=n, launches=launches, decode_steps=steps,
                    tier=m, against_never_evicted=exact)
    finally:
        eng.destroy()


def _record_dispatches(eng) -> list:
    """Wrap the engine's dispatch to record each pass's (nb, verify width)."""
    log, orig = [], eng._dispatch_chunk

    def dispatch(active):
        rec = orig(active)
        if rec is not None:
            log.append((rec.nb, rec.spec_w))
        return rec
    eng._dispatch_chunk = dispatch
    return log


def _tier_w(dev, params, cfg) -> dict:
    """(w): one greedy wave of 8 on three engines: the workspace layout,
    the paged gather path (`paged_attn_impl="xla"`) and the paged kernels
    with spec decode on. The two gather paths run the same plain
    arithmetic: tokens and logprobs equal bit for bit. The kernels'
    streams against them by `_agree`, and teacher-forced.
    `kv_workspace_copy_bytes_total` equals copies x R x nb x block bytes
    summed over each engine's passes (2 for the workspace, 1 for the
    gather path, 0 for the kernels)."""
    rng = np.random.default_rng(SEED + 54)
    g = GenerationHyperparameters(max_new_tokens=KV_TIER_W_NEW, greedy=True)
    reqs = [ModelRequest(rid=f"w{i}", gconfig=g, input_ids=rng.integers(
        0, cfg.vocab_size, int(rng.integers(*KV_TIER_PROMPT, endpoint=True))).tolist())
        for i in range(KV_TIER_W_REQUESTS)]
    out, streams = {}, {}
    for name, extra, copies in (("workspace", dict(kv_layout="workspace"), 2),
                                ("xla", dict(paged_attn_impl="xla"), 1),
                                ("kernels_spec", dict(spec_decode="ngram", spec_k=SPEC_K), 0)):
        eng = _tier_engine(dev, params, cfg, **KV_TIER_SETTINGS, **extra)
        try:
            log = _record_dispatches(eng)
            pa.launches = pa.launches_verify = 0
            t = time.perf_counter()
            streams[name] = _streams(_paused_wave(eng, reqs))
            wall = time.perf_counter() - t
            m = eng.get_metrics()
            R = eng.config.max_running_requests
            want = sum(copies * R * nb * m["kv_block_nbytes"] for nb, _ in log)
            check(m["kv_workspace_copy_bytes_total"] == want,
                  f"(w) {name}: copy bytes {m['kv_workspace_copy_bytes_total']}, want {want}")
            launches = dict(paged_attention=pa.launches, paged_verify=pa.launches_verify)
            L = cfg.num_hidden_layers
            want_k3 = eng.decode_steps * L if copies == 0 else 0
            want_k4 = eng.verify_dispatches * L if copies == 0 else 0
            check(launches == dict(paged_attention=want_k3, paged_verify=want_k4),
                  f"(w) {name}: launches {launches}, want K3 {want_k3}, K4 {want_k4}")
            out[name] = dict(wall_s=wall, passes=len(log), copy_bytes=m["kv_workspace_copy_bytes_total"],
                             launches=launches, decode_steps=eng.decode_steps,
                             verify_dispatches=eng.verify_dispatches)
        finally:
            eng.destroy()
    out["workspace_vs_xla"] = _exact(streams["xla"], streams["workspace"], "(w) xla vs workspace")
    check(out["workspace_vs_xla"]["logprobs_bit_equal"] == len(reqs),
          "(w) the gather path and the workspace layout are not bit-equal")
    out["kernels_spec_vs_workspace"] = _agree(streams["kernels_spec"], streams["workspace"],
                                              [True] * len(reqs), "(w) kernels vs workspace")
    out["kernels_spec_forced"] = _forced(params, cfg, reqs, streams["kernels_spec"], "(w) kernels",
                                         dev)
    out["launches"] = out["kernels_spec"]["launches"]
    return out


@contextlib.contextmanager
def _plain_paged_attention():
    """The decode and verify steps' default attention swapped for the
    plain versions (what `decode_step_paged` and `verify_step_paged` call
    when the engine passes none)."""
    saved = decode_step_paged.__defaults__, verify_step_paged.__defaults__

    def swap(defaults, old, new):
        return tuple(new if d is old else d for d in defaults)
    decode_step_paged.__defaults__ = swap(saved[0], pa.paged_attention, pa.paged_attention_ref)
    verify_step_paged.__defaults__ = swap(saved[1], pa.paged_attention_qlen,
                                          pa.paged_attention_qlen_ref)
    try:
        yield
    finally:
        decode_step_paged.__defaults__, verify_step_paged.__defaults__ = saved


KV_TIER_D_DECODE = dict(max_running_requests=8, context_length=2048, page_size=128,
                        new_tokens_per_chunk=64, spec_decode="ngram", spec_k=SPEC_K)


def _tier_d(dev) -> dict:
    """(d): Qwen2.5-1.5B at full width, CUT_LAYERS deep, bf16 weights over
    an f32 pool and f32 weights over a bf16 pool, 8 greedy self-quoting
    requests each with spec decode on: K3's and K4's mixed variants
    launched decode steps x L and verify forwards x L times, and the
    streams against the same engine with the plain paged attention
    swapped in (`_agree`) and teacher-forced."""
    cfg0 = dataclasses.replace(QWEN25_1_5B, scan_layers=False, num_hidden_layers=CUT_LAYERS)
    L = CUT_LAYERS
    reqs = [r for r in _spec_requests(np.random.default_rng(SEED + 55), cfg0.vocab_size)[:8]]
    reqs = [ModelRequest(rid=r.rid, input_ids=r.input_ids[:512], gconfig=r.gconfig) for r in reqs]
    out, launches = {}, {}
    for dtype, pool in (("bfloat16", "float32"), ("float32", "bfloat16")):
        cfg = dataclasses.replace(cfg0, dtype=dtype, param_dtype=dtype)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
        verify_key = (True, *(tuple(getattr(torch, x) for x in (dtype, pool))))
        decode_key = (False, *verify_key[1:])
        names = [MIXED_VARIANTS[decode_key], MIXED_VARIANTS[verify_key]]
        settings = dict(KV_TIER_D_DECODE, dtype=dtype, kv_cache_dtype=pool)
        eng = _tier_engine(dev, params, cfg, **settings)
        try:
            check(eng._k_pool.dtype == getattr(torch, pool), f"(d) pool {eng._k_pool.dtype}")
            for counter, _ in names:
                setattr(pa, counter, 0)
            pa.launches = pa.launches_verify = 0
            got = _streams(_paused_wave(eng, reqs))
            n = {name: getattr(pa, counter) for counter, name in names}
            steps, vd = eng.decode_steps, eng.verify_dispatches
            check(vd > 0, f"(d) {dtype} over {pool}: no verify forward")
            check(list(n.values()) == [steps * L, vd * L] and pa.launches == pa.launches_verify == 0,
                  f"(d) {dtype} over {pool}: launches {n}, want {steps} x {L} and {vd} x {L}")
            launches.update(n)
        finally:
            eng.destroy()
        forced = _forced(params, cfg, reqs, got, f"(d) {dtype} over {pool}", dev)
        with _plain_paged_attention():
            eng = _tier_engine(dev, params, cfg, **settings)
            try:
                calls = sum(getattr(pa, c) for c, _ in names)
                want = _streams(_paused_wave(eng, reqs))
                check(sum(getattr(pa, c) for c, _ in names) == calls, "(d) the plain run launched")
            finally:
                eng.destroy()
        del params
        torch.cuda.empty_cache()
        out[f"{dtype}_over_{pool}"] = dict(
            decode_steps=steps, verify_dispatches=vd, launches=n,
            against_plain=_agree(got, want, [True] * len(reqs), f"(d) {dtype} over {pool}"),
            forced=forced)
    out["launches"] = launches
    return out


def phase_kv_tier(dev: torch.device, params: dict, layers: int = KV_TIER_LAYERS) -> dict:
    """The host KV tier, the gather paths and fp pools in another dtype on
    the serve cell's Qwen2.5-7B weights (bf16, full width): the
    never-evicted streams of the 16 requests first (a fresh engine with
    the serve cell's dense pool), then (k1)-(k4) and (w) at `layers`
    layers, and (d) on Qwen2.5-1.5B. Counts of K3, K4 and K5a are set to 0
    before each leg's main path and read after it."""
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False, num_hidden_layers=layers)
    p = _layer_subset(params, layers)
    reqs = _tier_requests(np.random.default_rng(SEED + 50), cfg.vocab_size, N_REQUESTS, "k")
    times, out = {}, {}
    t = time.perf_counter()
    oracle_eng = _tier_engine(dev, p, cfg, **KV_TIER_SETTINGS)
    try:
        pa.launches = 0
        oracle = _streams(_paused_wave(oracle_eng, reqs))
        k3_launches_oracle = pa.launches
    finally:
        oracle_eng.destroy()
    times["oracle"] = time.perf_counter() - t
    t = time.perf_counter()
    pa.launches = 0
    out["k1"] = _tier_k1(dev, p, cfg, reqs, oracle)
    out["k1"]["k3_launches"] = pa.launches
    times["k1"] = time.perf_counter() - t
    t = time.perf_counter()
    pa.launches = 0
    out["k2"] = _tier_k2(dev, p, cfg, reqs, oracle)
    out["k2"]["k3_launches"] = pa.launches
    times["k2"] = time.perf_counter() - t
    t = time.perf_counter()
    pa.launches = 0
    out["k3"] = _tier_k3(dev, p, cfg, reqs[0], oracle[0])
    out["k3"]["k3_launches"] = pa.launches
    times["k3"] = time.perf_counter() - t
    t = time.perf_counter()
    out["k4"] = _tier_k4(dev, p, cfg)
    times["k4"] = time.perf_counter() - t
    t = time.perf_counter()
    out["w"] = _tier_w(dev, p, cfg)
    times["w"] = time.perf_counter() - t
    t = time.perf_counter()
    out["d"] = _tier_d(dev)
    times["d"] = time.perf_counter() - t
    k3 = k3_launches_oracle + out["k1"]["k3_launches"] + out["k2"]["k3_launches"] + \
        out["k3"]["k3_launches"] + out["w"]["launches"]["paged_attention"]
    out["launches"] = dict(paged_attention=k3, paged_attention_q8=out["k4"]["launches"]["paged_attention_q8"],
                           paged_verify=out["w"]["launches"]["paged_verify"], **out["d"]["launches"])
    emit("kv_tier", model="Qwen2.5-7B", source=QWEN25_7B_SOURCE, layers=layers,
         settings=KV_TIER_SETTINGS, pool_tokens=dict(k1=KV_TIER_POOL, k2=KV_TIER_PREEMPT_POOL),
         host_pool_mb=KV_TIER_HOST_MB, seconds=times, **out)
    return out


def kv_tier_only() -> int:
    """`--kv-tier`: the device and build phases, the mixed-dtype kernel
    checks, and the kv_tier phase on the serve cell's weights (the seeded
    random weights after their push, `_pushed_params`)."""
    clock = _PhaseClock()
    dev, smi = phase_device()
    phase_build()
    clock.lap("build")
    mixed = phase_mixed_kernel(dev)
    clock.lap("mixed_kernel")
    cfg = dataclasses.replace(QWEN25_7B, scan_layers=False)
    tier = phase_kv_tier(dev, _pushed_params(dev, cfg))
    clock.lap("kv_tier")
    for name, n in tier["launches"].items():
        if name in mixed:
            mixed[name]["launches"] = n
    emit("phase_seconds", **clock.laps)
    print(json.dumps({"kernels": list(mixed.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class _PhaseClock:
    """Seconds of each phase of `main`, each lap since the one before."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self._t
        self._t = now


def main() -> int:
    t0 = time.perf_counter()
    clock = _PhaseClock()
    dev, smi = phase_device()
    clock.lap("device")
    phase_build()
    clock.lap("build")
    max_err = phase_kernel(dev)
    clock.lap("kernel")
    phase_bad_table()
    clock.lap("bad_table")
    phase_flash_kernel(dev)
    clock.lap("flash_kernel")
    q_err = phase_quant_kernel(dev)
    clock.lap("quant_kernel")
    v_err = phase_verify_kernel(dev)
    clock.lap("verify_kernel")
    mixed = phase_mixed_kernel(dev)
    clock.lap("mixed_kernel")
    engine, cfg, launches = phase_serve(dev)
    try:
        batch = phase_step(engine, cfg)
        phase_profile(engine, cfg, batch)
        paged = phase_paged_line(engine, cfg, batch, launches, max_err)
        served = engine.params  # the serve cell's weights, after its push
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    clock.lap("serve_step_profile")
    tier = phase_kv_tier(dev, served)
    del served
    torch.cuda.empty_cache()
    clock.lap("kv_tier")
    sched = phase_sched(dev)
    engine, cfg, s_launches = phase_serve_spec(dev, SERVE, "serve_spec")
    try:
        batch = phase_spec_step(engine, cfg)
        phase_profile(engine, cfg, batch, phase="profile_verify", width=SPEC_K + 1)
        verify = phase_verify_line(engine, cfg, batch, s_launches["paged_verify"],
                                   v_err["paged_verify"])
        sched["f"] = _sched_freq(engine, cfg)
    finally:
        engine.destroy()
    del engine
    torch.cuda.empty_cache()
    emit("sched", **sched)
    clock.lap("sched_serve_spec")
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
    clock.lap("int8_and_spec_int8")
    noise["launches_by_path"] = dict(serve_spec=s_launches["threefry_noise"],
                                     serve_spec_int8=s8_launches["threefry_noise"])
    emit("noise_line", **noise)
    clock.lap("noise_line")
    loop = phase_grpo_loop(dev)
    clock.lap("grpo_loop")
    torch.cuda.empty_cache()
    train = phase_train(dev)
    clock.lap("train")
    torch.cuda.empty_cache()
    sft = phase_sft(dev)
    clock.lap("sft")
    torch.cuda.empty_cache()
    sft_smoke = phase_sft_smoke(dev)
    clock.lap("sft_smoke")
    recover = phase_grpo_recover(dev)
    clock.lap("grpo_recover")
    aent = phase_aent(dev)
    clock.lap("aent")
    torch.cuda.empty_cache()
    decoupled = phase_decoupled(dev)
    clock.lap("decoupled")
    torch.cuda.empty_cache()
    ppo = phase_ppo(dev)
    clock.lap("ppo")
    torch.cuda.empty_cache()
    rw = phase_rw(dev)
    clock.lap("rw")
    torch.cuda.empty_cache()
    multi_turn = phase_multi_turn(dev)
    clock.lap("multi_turn")
    torch.cuda.empty_cache()
    hf_path = phase_hf_path(dev)
    clock.lap("hf_path")
    torch.cuda.empty_cache()
    tir = phase_tir(dev)
    clock.lap("tir")
    torch.cuda.empty_cache()
    phase_hbm(dev, loop, train, ppo, rw, hf_path)
    clock.lap("hbm")
    chaos = phase_chaos(dev)
    clock.lap("chaos")
    torch.cuda.empty_cache()
    fleet = phase_fleet(dev)
    clock.lap("fleet")
    torch.cuda.empty_cache()
    vision = phase_vision(dev)
    clock.lap("vision")
    torch.cuda.empty_cache()
    moe = phase_moe(dev)
    clock.lap("moe")
    # K1/K2a/K2b run in the GRPO loop, the train phase, both SFT runs, the
    # GRPO recovery runs, the AEnt run, the decoupled trainer, the PPO,
    # reward-model and multi-turn trainers, the GRPO run on a checkpoint
    # with its reference policy, the TIR runs and the chaos legs; K3 in every
    # GRPO and PPO run (the decoupled one's in its server process), the
    # evaluators, the server started on a checkpoint, the agents and the
    # chaos legs and servers
    flash_paths = dict(grpo_loop=loop["launches"], train=train["launches"],
                       sft={k: sft["launches"][k] + sft_smoke["launches"][k]
                            for k in FLASH_COUNTERS},
                       grpo_recover=recover["launches"], aent=aent["launches"],
                       decoupled=decoupled["launches"], ppo=ppo["launches"],
                       rw=rw["launches"], multi_turn=multi_turn["launches"],
                       hf_path=hf_path["launches"], tir=tir["launches"],
                       chaos=chaos["launches"], vision=vision["launches"],
                       moe=moe["launches"])
    # K3 runs in the serve, sched (its group waves) and train paths and in
    # the spec path's normal chunks; K5a in the int8 serve path and the int8 spec path's; K6 in both
    # int8 paths
    paged["launches_by_path"] = dict(serve=launches, sched=sched["k3_launches"],
                                     serve_spec=s_launches["paged_attention"],
                                     grpo_loop=loop["launches"]["paged_attention"],
                                     train=train["launches"]["paged_attention"],
                                     grpo_recover=recover["launches"]["paged_attention"],
                                     aent=aent["launches"]["paged_attention"],
                                     decoupled=decoupled["launches"]["paged_attention"],
                                     ppo=ppo["launches"]["paged_attention"],
                                     multi_turn=multi_turn["launches"]["paged_attention"],
                                     hf_path=hf_path["launches"]["paged_attention"],
                                     tir=tir["launches"]["paged_attention"],
                                     chaos=chaos["launches"]["paged_attention"],
                                     kv_tier=tier["launches"]["paged_attention"],
                                     fleet=fleet["launches"]["paged_attention"],
                                     vision=vision["launches"]["paged_attention"],
                                     moe=moe["launches"]["paged_attention"])
    paged["launches"] = sum(paged["launches_by_path"].values())
    q8["launches_by_path"] = dict(serve_int8=q_launches["paged_attention_q8"],
                                  serve_spec_int8=s8_launches["paged_attention_q8"],
                                  kv_tier=tier["launches"]["paged_attention_q8"])
    q8["launches"] = sum(q8["launches_by_path"].values())
    qmm_row["launches_by_path"] = dict(serve_int8=q_launches["quant_matmul"],
                                       serve_spec_int8=s8_launches["quant_matmul"])
    qmm_row["launches"] = sum(qmm_row["launches_by_path"].values())
    verify["launches_by_path"] = dict(serve_spec=verify["launches"],
                                      kv_tier=tier["launches"]["paged_verify"])
    verify["launches"] = sum(verify["launches_by_path"].values())
    for name, row in mixed.items():
        row["launches"] = tier["launches"][name]
    rows = [paged, *phase_flash_line(dev, train, flash_paths), q8, qmm_row, verify, verify_q8,
            *mixed.values()]
    for r in rows:
        check(r["launches"] > 0, f"{r['name']}: no launch on the main path")
    clock.lap("kernels_line")
    emit("phase_seconds", **clock.laps)
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
             "--qmm-times": qmm_times_only, "--qmm-sweep": qmm_sweep_only,
             "--decoupled": decoupled_only, "--trainers": trainers_only,
             "--hf-path": hf_path_only, "--tir": tir_only, "--chaos": chaos_only,
             "--kv-tier": kv_tier_only, "--fleet": fleet_only, "--vision": vision_only,
             "--moe": moe_only}
    sys.exit(modes[sys.argv[1]]() if sys.argv[1:] else main())
