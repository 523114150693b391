"""Matmul-FLOPs accounting for decoder LMs + peak-FLOPs table (a copy of
`areal_tpu/utils/flops.py` with a row for the H100).

The reference reports training throughput as tokens consumed per step and
derives TFLOP/s / MFU offline (realhf/system/master_worker.py:497-533 logs
`time_perf/e2e` + `n_tokens`; benchmark/.../README.md:33-43 parses them).
Here the FLOPs model is explicit so the train engine can emit TFLOP/s live:

Per-token *forward* matmul FLOPs (2·m·n per [m,n] matmul output element):
  per layer:   qkv proj        2·d·(nH + 2·nKV)·hd
               attn out proj   2·nH·hd·d
               scores + values 4·ctx·nH·hd        (ctx = avg causal context)
               gate/up/down    6·d·ff             (SwiGLU: three matmuls)
  final:       lm_head         2·d·V

Embedding *lookup* is a gather, not a matmul, and is excluded — but the
lm_head projection is a real matmul and is counted (once, even when tied).
Backward re-does each matmul twice (dX and dW) → train = 3× forward.
MoE: ff work is per-activated-expert (top_k), not per-parameter.
"""

from __future__ import annotations


# bf16 peak FLOP/s per chip by NORMALIZED device-kind substring (first
# match wins; normalization strips spaces/dashes/underscores so GKE-style
# spellings like "tpu-v5-lite-podslice" don't fall through to the v5p row).
# The H100 row is NVIDIA's data sheet figure, bf16 dense (no sparsity);
# `torch.cuda.get_device_name` reads e.g. "NVIDIA H100 80GB HBM3".
PEAK_FLOPS: tuple[tuple[str, float], ...] = (
    ("h100", 989e12),
    ("v6", 918e12),
    ("v5lite", 197e12),
    ("v5e", 197e12),
    ("v5", 459e12),  # v5p reports plain "TPU v5"
    ("v4", 275e12),
)


def peak_flops(device_kind: str) -> float:
    kind = (
        device_kind.lower().replace(" ", "").replace("-", "").replace("_", "")
    )
    for sub, f in PEAK_FLOPS:
        if sub in kind:
            return f
    return 100e12  # unknown accelerator / CPU: nominal figure


def forward_flops_per_token(model_cfg, avg_context: float) -> float:
    """Forward matmul FLOPs per token.

    `model_cfg` is areal_tpu.models.qwen2.ModelConfig (duck-typed: needs
    hidden_size, intermediate_size, num_hidden_layers, num_attention_heads,
    num_key_value_heads, vocab_size, and optionally num_experts/
    num_experts_per_tok/moe_intermediate_size).

    `avg_context` is the mean number of kv positions each query attends to;
    for full causal self-attention over length-L sequences this is ~L/2.
    """
    d = model_cfg.hidden_size
    nH = model_cfg.num_attention_heads
    nKV = model_cfg.num_key_value_heads
    hd = d // nH
    L = model_cfg.num_hidden_layers

    qkv = 2 * d * (nH + 2 * nKV) * hd
    out = 2 * nH * hd * d
    attn = 4 * avg_context * nH * hd
    n_experts = getattr(model_cfg, "num_experts", 0) or 0
    if n_experts:
        ff = getattr(model_cfg, "moe_intermediate_size", None) or (
            model_cfg.intermediate_size
        )
        top_k = getattr(model_cfg, "num_experts_per_tok", 1) or 1
        mlp = 6 * d * ff * top_k + 2 * d * n_experts  # experts + router
    else:
        mlp = 6 * d * model_cfg.intermediate_size
    lm_head = 2 * d * model_cfg.vocab_size
    return L * (qkv + out + attn + mlp) + lm_head


def train_flops_per_token(model_cfg, avg_context: float) -> float:
    """Fwd + bwd matmul FLOPs per trained token (bwd = 2x fwd)."""
    return 3.0 * forward_flops_per_token(model_cfg, avg_context)
