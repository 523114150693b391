"""Closed-form per-device memory accounting for train and decode plans
(counterpart of `areal_tpu/utils/hbm.py`), so an allocation plan can be
checked against the device's memory before launch
(`AllocationMode.check_hbm`).

The model is the JAX module's, term for term, so its estimates equal the
JAX package's for the same configuration. Per device, a training step
holds

  params        n_params x param_bytes / (pp * dp * tp)     [ZeRO-3 + TP]
  grads         n_params x param_bytes / (pp * dp * tp)     [same sharding]
  opt (adamw)   2 x n_params x 4      / (pp * dp * tp)      [f32 mu + nu]
  activations   under full remat, per-layer boundaries
                (L/pp) x T_local x d x act_bytes
                plus one layer's recompute working set
                T_local x (3d + 2ff/tp + 2*nH*hd/tp) x act_bytes
  logits        fused vocab-chunked head: T_local x chunk x 4;
                unfused: T_local x V x 4
  pp stash      (2*pp-1) stage inputs for 1f1b, v*(2*pp-1) interleaved

and a decode server holds its tp-sharded parameters plus the paged KV
pool, 2 x L x pool_tokens x nKV x hd x kv_bytes / tp.

The port's trainer is not laid out as the JAX one: its f32 gradient
accumulator, the AdamW moments' dtypes and autograd's saved tensors are
not these terms. `chip_smoke.py` prints each estimate beside the card's
measured peak, and ROADMAP queue 3 lists where the two part; no term is
added here that the JAX module lacks.

Device memory by normalized device-kind substring (first match wins):
the TPU rows are the JAX module's public per-chip specs (v5e 16 GiB, v5p
95 GiB, v4 32 GiB, v6e 32 GiB); the H100 row is the total that
`torch.cuda.get_device_properties(0).total_memory` reported on an NVIDIA
H100 80GB HBM3 at a 700 W power limit (`chip_smoke.py`, phase device).
"""

from __future__ import annotations

from dataclasses import dataclass

GiB = 1024**3

# torch.cuda.get_device_properties(0).total_memory on "NVIDIA H100 80GB
# HBM3", power limit 700.00 W
H100_TOTAL_MEMORY = 85_017_493_504

# Per-chip HBM by NORMALIZED device-kind substring (first match wins).
# Normalization strips spaces/dashes/underscores so every spelling of the
# v5e family ("TPU v5 lite", "tpu-v5-lite-podslice", "v5litepod") hits the
# 16 GiB row — a substring match on the raw string would fall through to
# the plain-"v5" (v5p) row and credit a 16 GiB chip with 95 GiB.
HBM_BYTES: tuple[tuple[str, int], ...] = (
    ("h100", H100_TOTAL_MEMORY),
    ("v6", 32 * GiB),
    ("v5lite", 16 * GiB),
    ("v5e", 16 * GiB),
    ("v5", 95 * GiB),  # v5p reports plain "TPU v5"
    ("v4", 32 * GiB),
)


def _normalize_kind(device_kind: str) -> str:
    return (
        device_kind.lower().replace(" ", "").replace("-", "").replace("_", "")
    )


def hbm_bytes(device_kind: str) -> int:
    kind = _normalize_kind(device_kind)
    for sub, b in HBM_BYTES:
        if sub in kind:
            return b
    return 16 * GiB  # conservative default


def _dtype_bytes(dtype) -> int:
    s = str(dtype)
    if "64" in s:
        return 8
    if "32" in s:
        return 4
    if "16" in s:
        return 2
    if "8" in s:
        return 1
    raise ValueError(f"unrecognized dtype {dtype!r}")


def param_count(cfg) -> int:
    """Exact decoder parameter count for models/qwen2.py's layout."""
    d = cfg.hidden_size
    nH = cfg.num_attention_heads
    nKV = cfg.num_key_value_heads
    hd = d // nH
    L = cfg.num_hidden_layers
    V = cfg.vocab_size

    attn = d * (nH + 2 * nKV) * hd + nH * hd * d
    if getattr(cfg, "qkv_bias", True):
        attn += (nH + 2 * nKV) * hd
    if getattr(cfg, "attn_out_bias", False):
        attn += d
    n_experts = getattr(cfg, "num_experts", 0) or 0
    if n_experts:
        ff = getattr(cfg, "moe_intermediate_size", None) or cfg.intermediate_size
        mlp = n_experts * 3 * d * ff + d * n_experts  # experts + router
        shared = getattr(cfg, "shared_expert_intermediate_size", 0) or 0
        if shared:
            mlp += 3 * d * shared + d  # shared expert + its gate
    else:
        mlp = 3 * d * cfg.intermediate_size
    norms = 2 * d
    per_layer = attn + mlp + norms
    embed = V * d
    head = 0 if getattr(cfg, "tie_word_embeddings", False) else V * d
    return L * per_layer + embed + head + d  # + final norm


def wq_elem_counts(cfg) -> tuple[int, int]:
    """(quantizable kernel elements, scale elements) for int8 weight
    serving, mirroring models/qwen2's layer map (_WQ_ATTN_AXES /
    _WQ_MLP_AXES): the dense attn + mlp matmul kernels quantize with one
    f32 scale per output channel; MoE mlp subtrees (router-marked) stay
    fp — their attn kernels still quantize — as do embed, lm_head, norms,
    biases and LoRA adapters."""
    d = cfg.hidden_size
    nH = cfg.num_attention_heads
    nKV = cfg.num_key_value_heads
    hd = d // nH
    L = cfg.num_hidden_layers
    q = d * (nH + 2 * nKV) * hd + nH * hd * d  # q/k/v + o kernels
    s = (nH + 2 * nKV) * hd + d  # one scale per output channel
    if not (getattr(cfg, "num_experts", 0) or 0):
        ff = cfg.intermediate_size
        q += 3 * d * ff  # gate + up + down
        s += 2 * ff + d
    return L * q, L * s


@dataclass
class HBMEstimate:
    params_bytes: int
    grads_bytes: int
    opt_bytes: int
    activation_bytes: int
    logits_bytes: int
    kv_bytes: int = 0
    # pipeline stash: the 1f1b schedules keep stage (or virtual-chunk)
    # inputs alive between forward and backward — 2*pp-1 entries for plain
    # 1f1b, v*(2*pp-1) for the interleaved schedule
    stash_bytes: int = 0
    # informational: bytes the ZeRO-1 dp-sharded optimizer update freed
    # per chip vs a dp-replicated opt state (already subtracted from
    # opt_bytes; NOT part of total_bytes)
    opt_freed_bytes: int = 0
    # informational: bytes int8 weight serving freed per chip vs the fp
    # kernels (already subtracted from params_bytes; NOT part of
    # total_bytes) — headroom a fixed HBM budget can hand to the KV pool
    weight_freed_bytes: int = 0

    @property
    def total_bytes(self) -> int:
        return (
            self.params_bytes
            + self.grads_bytes
            + self.opt_bytes
            + self.activation_bytes
            + self.logits_bytes
            + self.kv_bytes
            + self.stash_bytes
        )

    def breakdown(self) -> dict:
        out = {
            "params_gib": round(self.params_bytes / GiB, 3),
            "grads_gib": round(self.grads_bytes / GiB, 3),
            "opt_gib": round(self.opt_bytes / GiB, 3),
            "activations_gib": round(self.activation_bytes / GiB, 3),
            "logits_gib": round(self.logits_bytes / GiB, 3),
            "kv_gib": round(self.kv_bytes / GiB, 3),
            "stash_gib": round(self.stash_bytes / GiB, 3),
            "total_gib": round(self.total_bytes / GiB, 3),
        }
        if self.opt_freed_bytes:
            out["zero1_freed_gib"] = round(self.opt_freed_bytes / GiB, 3)
        if self.weight_freed_bytes:
            out["wquant_freed_gib"] = round(self.weight_freed_bytes / GiB, 3)
        return out


def estimate_train_hbm(
    model_cfg,
    *,
    dp: int = 1,
    tp: int = 1,
    pp: int = 1,
    sp: int = 1,
    microbatch_tokens: int = 8192,
    remat: bool = True,
    fused_lm_head: bool = True,
    vocab_chunk: int = 8192,
    optimizer: str = "adamw",
    fsdp: bool = True,
    zero1: bool = False,
    pipeline_schedule: str = "1f1b",
    virtual_pp: int = 1,
) -> HBMEstimate:
    """Per-chip peak HBM for one training step of the GSPMD engine.

    `microbatch_tokens` is the GLOBAL token count of one microbatch (the
    unit `train_batch` runs per dispatch); dp and sp shard it.

    Sharding regimes: `fsdp=True` dp-shards params, grads AND opt state
    (the ZeRO-3-ish default the estimator has always priced). With
    `fsdp=False`, params/grads replicate over dp; `zero1=True` then still
    dp-shards the f32 AdamW moments (jax.zero1_optimizer's reduce-scatter
    / sharded-update / all-gather step) — `opt_freed_bytes` records what
    that sharding saved per chip vs a replicated opt state.

    Pipelining: for pp>1 the 1f1b schedules stash stage inputs between a
    microbatch's forward and its backward — 2*pp-1 entries for "1f1b",
    `virtual_pp`*(2*pp-1) *chunk* inputs for "1f1b_interleaved" (each 1/v
    the layers but a full [T_local, d] activation, so the stash bytes grow
    ~v times while the bubble shrinks ~1/v: that trade is exactly what
    bench --mode ppsched measures).
    """
    n = param_count(model_cfg)
    pbytes = _dtype_bytes(getattr(model_cfg, "param_dtype", "float32"))
    abytes = _dtype_bytes(getattr(model_cfg, "dtype", "bfloat16"))
    shard = (dp if fsdp else 1) * tp * pp
    opt_shard = (dp if (fsdp or zero1) else 1) * tp * pp
    d = model_cfg.hidden_size
    nH = model_cfg.num_attention_heads
    hd = d // nH
    ff = model_cfg.intermediate_size
    L = model_cfg.num_hidden_layers

    t_local = max(1, microbatch_tokens // (dp * sp))
    layers_local = max(1, L // pp)
    boundary = layers_local * t_local * d * abytes
    # one decoder layer's live intermediates during (re)computation: qkv
    # streams + two ff intermediates + attn scores working set, tp-sharded
    working = t_local * (3 * d + (2 * ff + 2 * nH * hd) // tp) * abytes
    if remat:
        act = boundary + working
    else:
        # ~10 saved tensors per layer (qkv, probs-free flash residuals,
        # ff gate/up, norms) — the classic no-remat multiplier
        act = boundary * 10 + working
    if fused_lm_head:
        logits = t_local * min(vocab_chunk, model_cfg.vocab_size) * 4
    else:
        logits = t_local * model_cfg.vocab_size * 4
    stash = 0
    if pp > 1 and pipeline_schedule in ("1f1b", "1f1b_interleaved"):
        v = virtual_pp if pipeline_schedule == "1f1b_interleaved" else 1
        stash = v * (2 * pp - 1) * t_local * d * abytes
    opt_mult = 2 if optimizer == "adamw" else 0  # f32 mu + nu
    opt = opt_mult * n * 4 // opt_shard
    opt_freed = 0
    if zero1 and not fsdp and dp > 1:
        opt_freed = opt_mult * n * 4 // (tp * pp) - opt
    return HBMEstimate(
        params_bytes=n * pbytes // shard,
        grads_bytes=n * pbytes // shard,
        opt_bytes=opt,
        activation_bytes=act,
        logits_bytes=logits,
        stash_bytes=stash,
        opt_freed_bytes=opt_freed,
    )


def estimate_decode_hbm(
    model_cfg,
    *,
    tp: int = 1,
    pool_tokens: int | None = None,
    slots: int = 64,
    context_length: int = 32768,
    kv_cache_dtype: str = "bfloat16",
    weight_dtype: str = "fp",
) -> HBMEstimate:
    """Per-chip HBM for a decode server: tp-sharded params + paged KV pool.

    `pool_tokens=None` models dense provisioning (slots x context) — the
    difference vs a sized pool is exactly what the paged cache buys.

    `weight_dtype="int8"` (JaxDecodeConfig.weight_dtype) prices the dense
    matmul kernels at 1 byte/element plus one f32 scale per output channel
    instead of param_dtype; the per-chip bytes that frees vs fp serving
    surface as `wquant_freed_gib` in breakdown() — at a fixed HBM budget
    that headroom goes to a larger resident KV pool (bench --mode wquant).
    """
    n = param_count(model_cfg)
    pbytes = _dtype_bytes(getattr(model_cfg, "param_dtype", "bfloat16"))
    kvb = _dtype_bytes(kv_cache_dtype)
    d = model_cfg.hidden_size
    hd = d // model_cfg.num_attention_heads
    nKV = max(model_cfg.num_key_value_heads, tp)  # GQA heads repeat to tp
    if pool_tokens is None:
        pool_tokens = slots * context_length
    kv = 2 * model_cfg.num_hidden_layers * pool_tokens * nKV * hd * kvb // tp
    params_bytes = n * pbytes // tp
    weight_freed = 0
    if weight_dtype == "int8":
        nq, ns = wq_elem_counts(model_cfg)
        quantized = ((n - nq) * pbytes + nq * 1 + ns * 4) // tp
        weight_freed = params_bytes - quantized
        params_bytes = quantized
    elif weight_dtype != "fp":
        raise ValueError(f"weight_dtype={weight_dtype!r} not in ('fp', 'int8')")
    return HBMEstimate(
        params_bytes=params_bytes,
        grads_bytes=0,
        opt_bytes=0,
        activation_bytes=0,
        logits_bytes=0,
        kv_bytes=kv,
        weight_freed_bytes=weight_freed,
    )


def check_fit(
    estimate: HBMEstimate,
    device_kind: str,
    *,
    utilization: float = 0.9,
) -> None:
    """Raise if the plan cannot fit the chip (90% of HBM usable by default:
    XLA needs headroom for fusion temporaries and the compiled program)."""
    cap = int(hbm_bytes(device_kind) * utilization)
    if estimate.total_bytes > cap:
        raise MemoryError(
            f"plan needs {estimate.total_bytes / GiB:.2f} GiB/chip but "
            f"{device_kind!r} offers {cap / GiB:.2f} GiB usable "
            f"({utilization:.0%} of {hbm_bytes(device_kind) / GiB:.0f} GiB): "
            f"{estimate.breakdown()}"
        )
