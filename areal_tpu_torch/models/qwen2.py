"""Qwen2-class decoder (counterpart of `areal_tpu/models/qwen2.py`): the
packed training forward and the serving path.

The dense GLU / RMSNorm / RoPE decoder of Qwen2 and Qwen2.5 (qkv bias,
tied or untied head), which Llama and Mistral share when unwindowed.
The JAX decoder's other families (MoE, Qwen3 q/k norm, Gemma, GPT-2,
sliding windows, LoRA) are refused by `check_supported` until their
ROADMAP item ports them. A critic (`is_critic`) ends in the scalar value
head `value_head/kernel` `[H, 1]` and `value_head/bias` `[1]` instead of
the LM head: `forward` returns f32 values `[T]`. It trains and scores, and
never serves: `prefill` and the paged steps refuse it
(`check_servable`).

`forward` runs one packed token stream `[T]` with `segment_ids` (causal
within each segment), its attention through the flash kernels
(`ops/flash_attention.py`) or the dense path, with per-layer
`torch.utils.checkpoint` when `cfg.remat`; `LMHead` hands the post-norm
hidden states to the vocab-chunked loss (`ops/fused_xent.py`).

Parameters are a flat dict of tensors keyed by the `/`-joined names of the
JAX parameter tree, the wire names `core/weight_transfer.py` ships
("embed/embedding", "layers/attn/q_kernel", ...), with the same shapes:
scanned `layers/...` leaves stacked `[L, ...]` when `cfg.scan_layers`,
else `layers_{i}/...` per layer. Layer code reads a layer's tensors as
views (`layer_params`), so nothing is copied.

`decode_step_paged` and `verify_step_paged` update the KV pool in place
where the JAX versions return a new pool: the pool is the largest tensor
the engine owns, and an in-place row write is what the JAX version's
donated scatter compiles to.

Int8 weight serving (JAX :803-946): `quantize_weights` turns each dense
matmul kernel (q/k/v/o, gate/up/down) into two tensors, `<path>/q` (int8,
the kernel's shape) and `<path>/scale` (f32, its output dims), the JAX
wire names. The serving path's matmuls go through `_w_einsum`, which runs
the fp matmul unchanged for a tensor and `ops/quant_matmul.quant_einsum`
for a quantized pair. Embedding, LM head, norms and biases stay fp.
"""

from __future__ import annotations

import functools
import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from areal_tpu_torch.ops.flash_attention import PADDING_SEGMENT, flash_attention, packed_layout
from areal_tpu_torch.ops.fused_xent import chunked_clamped_entropy, chunked_label_logprobs
from areal_tpu_torch.ops.kv_quant import quantize_kv, split_pool
from areal_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_qlen,
    verify_attention,
)
from areal_tpu_torch.ops.quant import dequantize_absmax, quantize_absmax
from areal_tpu_torch.ops.quant_matmul import quant_einsum

_NEG_INF = -1e30


@dataclass(frozen=True)
class ModelConfig:
    """The JAX package's `ModelConfig` (:57-166), field for field."""

    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int | None = None
    rope_theta: float = 10000.0
    rope_scaling_type: str | None = None
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 32768
    model_type: str = "qwen2"
    qkv_bias: bool = True
    qk_norm: bool = False
    sliding_window: int | None = None
    hidden_act: str = "silu"
    norm_zero_centered: bool = False
    normalize_embed: bool = False
    norm_type: str = "rmsnorm"
    pos_embed: str = "rope"
    mlp_style: str = "glu"
    attn_out_bias: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "full"
    attn_impl: str = "auto"
    cp_zigzag: bool = False
    is_critic: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int | None = None
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = True
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.0
    moe_group_size: int = 1024
    loss_vocab_chunk: int = 16384
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_targets: tuple = ("q_proj", "v_proj")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def rope_scaling_(self) -> tuple | None:
        if self.rope_scaling_type == "llama3":
            return (
                "llama3",
                self.rope_scaling_factor,
                self.rope_low_freq_factor,
                self.rope_high_freq_factor,
                self.rope_original_max_position,
            )
        if self.rope_scaling_type == "linear":
            return ("linear", self.rope_scaling_factor)
        return None

    @classmethod
    def from_hf_config(cls, path_or_dict, **overrides) -> "ModelConfig":
        """Build from an HF `config.json` (a dict, or a model directory)
        for the dense families the port serves (JAX :169)."""
        if isinstance(path_or_dict, str):
            with open(os.path.join(path_or_dict, "config.json")) as f:
                hf = json.load(f)
        else:
            hf = dict(path_or_dict)
        model_type = hf.get("model_type", "qwen2")
        if model_type in ("qwen2_vl", "qwen2_5_vl"):
            # JAX reads these types with qkv_bias=False (its :261), yet the
            # language model of both checkpoints carries q/k/v biases: an
            # HF VL checkpoint's decoder is served as model_type "qwen2"
            # (ROADMAP.md queue 3)
            raise NotImplementedError(
                f"model_type={model_type!r}: its language model has q/k/v biases, which "
                "the JAX package drops for this type; write the checkpoint's config "
                "with model_type 'qwen2' (ROADMAP.md queue 3)"
            )
        if model_type not in ("qwen2", "llama", "mistral"):
            raise NotImplementedError(
                f"model_type={model_type!r} is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 6.7)"
            )
        L = hf["num_hidden_layers"]
        # HF windows layers >= max_window_layers; Qwen2.5 ships 28/28 (none)
        windowed = (
            model_type == "mistral" and hf.get("sliding_window")
        ) or (
            model_type == "qwen2"
            and hf.get("use_sliding_window")
            and (hf.get("max_window_layers", L) or L) < L
        )
        if windowed:
            raise NotImplementedError(
                "sliding-window attention is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 6.7)"
            )
        rope_kw: dict = {}
        rs = hf.get("rope_scaling") or {}
        rs_type = rs.get("rope_type", rs.get("type"))
        if rs_type == "llama3":
            rope_kw = dict(
                rope_scaling_type="llama3",
                rope_scaling_factor=rs.get("factor", 8.0),
                rope_low_freq_factor=rs.get("low_freq_factor", 1.0),
                rope_high_freq_factor=rs.get("high_freq_factor", 4.0),
                rope_original_max_position=rs.get(
                    "original_max_position_embeddings", 8192
                ),
            )
        elif rs_type == "linear":
            rope_kw = dict(
                rope_scaling_type="linear",
                rope_scaling_factor=rs.get("factor", 1.0),
            )
        elif rs_type not in (None, "default", "mrope"):
            # "mrope" (Qwen2-VL's mrope_section) keeps 1-D rope for text: the
            # decode engine builds an image prompt's m-rope tables itself
            raise NotImplementedError(
                f"rope_scaling type {rs_type!r} not implemented "
                "(supported: llama3, linear, mrope)"
            )
        kw = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=L,
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get(
                "num_key_value_heads", hf["num_attention_heads"]
            ),
            head_dim=hf.get("head_dim"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
            model_type=model_type,
            qkv_bias=model_type == "qwen2",
            hidden_act=hf.get("hidden_act", "silu"),
            **rope_kw,
        )
        kw.update(overrides)
        return cls(**kw)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a model feature outside the port's
    dense serving path, naming the ROADMAP item that ports it."""
    todo = {
        "num_experts": cfg.num_experts != 0,
        "qk_norm": cfg.qk_norm,
        "norm_type": cfg.norm_type != "rmsnorm",
        "norm_zero_centered": cfg.norm_zero_centered,
        "normalize_embed": cfg.normalize_embed,
        "pos_embed": cfg.pos_embed != "rope",
        "mlp_style": cfg.mlp_style != "glu",
        "attn_out_bias": cfg.attn_out_bias,
        "sliding_window": cfg.sliding_window is not None,
        "lora_rank": cfg.lora_rank != 0,
    }
    for name, unsupported in todo.items():
        if unsupported:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not in the PyTorch port "
                "yet (ROADMAP.md queue 1, item 6.7)"
            )


def check_servable(cfg: ModelConfig) -> None:
    """Refuse a critic on the serving path (the decode engine, `prefill`,
    the paged steps), which samples from an LM head."""
    if cfg.is_critic:
        raise ValueError(
            "is_critic=True: a critic's value head gives one value per token, "
            "not logits, so the decode engine, prefill and the paged steps "
            "cannot serve it"
        )


def torch_dtype(name: str) -> torch.dtype:
    return {
        "bfloat16": torch.bfloat16,
        "float32": torch.float32,
        "float16": torch.float16,
    }[name]


# ---------------------------------------------------------------------------
# Parameter names and shapes
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: ModelConfig) -> dict:
    H, M = cfg.hidden_size, cfg.intermediate_size
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    attn = {
        "q_kernel": (H, nH, hd),
        "k_kernel": (H, nKV, hd),
        "v_kernel": (H, nKV, hd),
        "o_kernel": (nH, hd, H),
    }
    if cfg.qkv_bias:
        attn.update(q_bias=(nH, hd), k_bias=(nKV, hd), v_bias=(nKV, hd))
    return {
        "attn": attn,
        "mlp": {
            "gate_kernel": (H, M),
            "up_kernel": (H, M),
            "down_kernel": (M, H),
        },
        "input_norm": (H,),
        "post_attn_norm": (H,),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Nested shape tree, equal to the JAX `param_shapes` (:692)."""
    check_supported(cfg)
    layer = _layer_shapes(cfg)
    if cfg.scan_layers:
        L = cfg.num_hidden_layers

        def stack(node):
            if isinstance(node, dict):
                return {k: stack(v) for k, v in node.items()}
            return (L, *node)

        layers_tree = {"layers": stack(layer)}
    else:
        layers_tree = {f"layers_{i}": layer for i in range(cfg.num_hidden_layers)}
    out = {
        "embed": {"embedding": (cfg.vocab_size, cfg.hidden_size)},
        **layers_tree,
        "final_norm": (cfg.hidden_size,),
    }
    if cfg.is_critic:
        out["value_head"] = {"kernel": (cfg.hidden_size, 1), "bias": (1,)}
    elif not cfg.tie_word_embeddings:
        out["lm_head"] = {"kernel": (cfg.hidden_size, cfg.vocab_size)}
    return out


def flatten_names(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_names(v, name))
        else:
            out[name] = v
    return out


def named_shapes(cfg: ModelConfig) -> dict[str, tuple]:
    """{"/"-joined name: shape} of every parameter."""
    return flatten_names(param_shapes(cfg))


def init_params(
    cfg: ModelConfig,
    generator: torch.Generator,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """Random weights with the distribution of the JAX `init_params`
    (:766-800): truncated normal on [-2, 2] scaled by 1/sqrt(fan_in) for
    matrices, ones for norms, zeros for biases; stored in
    `cfg.param_dtype`. `generator` must live on `device`."""
    dtype = torch_dtype(cfg.param_dtype)
    out = {}
    for name, shape in named_shapes(cfg).items():
        core = shape[1:] if name.startswith("layers/") else shape
        if name.endswith("_bias") or name == "value_head/bias":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        if len(core) == 1:  # norms
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        # fan-in = the contracted input dim (JAX :781): last-but-one for
        # stacked/3-D kernels whose dim -2 dominates, else the first
        fan_in = shape[-2] if len(shape) >= 3 and shape[-2] >= shape[0] else shape[0]
        t = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out[name] = t.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)
        del t
    return out


def layer_params(params: dict, cfg: ModelConfig, i: int) -> dict[str, torch.Tensor]:
    """Layer i's tensors keyed by their in-layer names ("attn/q_kernel",
    "mlp/up_kernel", "input_norm", ...): views, never copies."""
    if cfg.scan_layers:
        return {
            k[len("layers/"):]: v[i]
            for k, v in params.items()
            if k.startswith("layers/")
        }
    prefix = f"layers_{i}/"
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def layer_views(params: dict, cfg: ModelConfig) -> list[dict[str, torch.Tensor]]:
    """`layer_params` of every layer, for a caller that builds them once
    per weight install (in-place weight updates keep the views valid)
    instead of rescanning the parameter names at every step."""
    check_supported(cfg)
    return [layer_params(params, cfg, i) for i in range(cfg.num_hidden_layers)]


# ---------------------------------------------------------------------------
# Int8 weight serving: per-output-channel symmetric absmax (JAX :803-946)
# ---------------------------------------------------------------------------

# TorchDecodeConfig.weight_dtype values: "fp" serves the config dtype
# verbatim, "int8" stores the dense matmul kernels in this scheme
WEIGHT_DTYPES = ("fp", "int8")

# contraction axes per unstacked kernel (the stacked [L, ...] layout shifts
# every axis by one); the absmax reduces over them, leaving one scale per
# output channel for the matmul to fold in after it accumulates
_WQ_ATTN_AXES = {
    "q_kernel": (0,),
    "k_kernel": (0,),
    "v_kernel": (0,),
    "o_kernel": (0, 1),
}
_WQ_MLP_AXES = {
    "gate_kernel": (0,),
    "up_kernel": (0,),
    "down_kernel": (0,),
    "fc1_kernel": (0,),
    "fc2_kernel": (0,),
}
_WQ_PARTS = ("q", "scale")


def wq_contraction_axes(leaf: str, stacked: bool) -> tuple[int, ...] | None:
    """Contraction axes of one kernel leaf ("q_kernel", ...), or None when
    that leaf never quantizes; `stacked` shifts them for the [L, ...]
    layout."""
    ax = _WQ_ATTN_AXES.get(leaf) or _WQ_MLP_AXES.get(leaf)
    if ax is None:
        return None
    off = 1 if stacked else 0
    return tuple(a + off for a in ax)


def _wq_axes(path: str) -> tuple[int, ...] | None:
    """Contraction axes of the quantizable kernel at the flat name `path`
    ("layers/attn/q_kernel", "layers_3/mlp/up_kernel"), or None."""
    parts = path.split("/")
    if len(parts) != 3:
        return None
    layer, sub, leaf = parts
    if layer != "layers" and not layer.startswith("layers_"):
        return None
    table = {"attn": _WQ_ATTN_AXES, "mlp": _WQ_MLP_AXES}.get(sub, {})
    if leaf not in table:
        return None
    return wq_contraction_axes(leaf, stacked=layer == "layers")


def map_quant_kernels(params: dict, fn) -> dict:
    """The flat parameter dict with `fn(leaf, contraction_axes)` applied to
    every weight-quantizable kernel, scanned (`layers/...`) or per layer
    (`layers_{i}/...`); everything else passes through. A quantized kernel
    reaches `fn` as {"q": ..., "scale": ...}; `fn` returns a tensor (kept
    under the kernel's name) or such a dict (kept as `<name>/q`,
    `<name>/scale`)."""
    out, pairs = {}, {}
    for name, t in params.items():
        head, _, last = name.rpartition("/")
        if last in _WQ_PARTS and _wq_axes(head) is not None:
            pairs.setdefault(head, {})[last] = t
        elif _wq_axes(name) is not None:
            pairs[name] = t
        else:
            out[name] = t
    for path, leaf in pairs.items():
        new = fn(leaf, _wq_axes(path))
        if isinstance(new, dict):
            out.update({f"{path}/{k}": v for k, v in new.items()})
        else:
            out[path] = new
    return out


def quantize_weights(params: dict, quant=quantize_absmax) -> dict:
    """fp parameters -> the dense matmul kernels as `<path>/q` (int8) and
    `<path>/scale` (f32), each by `quant` (`ops/quant.quantize_absmax`, or
    its `_compiled` form for the trainer's push). Already-quantized
    kernels pass through, so an install path can call it
    unconditionally."""

    def one(w, axes):
        if isinstance(w, dict):
            return w
        q, s = quant(w, axis=axes)
        return {"q": q, "scale": s}

    return map_quant_kernels(params, one)


def dequantize_weights(params: dict, dtype: torch.dtype) -> dict:
    """Inverse of quantize_weights (lossy): each `q`/`scale` pair -> an fp
    kernel in `dtype`; everything else passes through."""

    def one(w, axes):
        if not isinstance(w, dict):
            return w
        return dequantize_absmax(w["q"], w["scale"], dtype, axis=axes)

    return map_quant_kernels(params, one)


def is_weight_quantized(params: dict) -> bool:
    """True when any dense kernel is a `q`/`scale` pair."""
    return any(
        name.rpartition("/")[2] in _WQ_PARTS
        and _wq_axes(name.rpartition("/")[0]) is not None
        for name in params
    )


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float):
    """RMSNorm computed in f32, returned in x's dtype (JAX :954)."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def _norm(x, weight, cfg: ModelConfig):
    return rms_norm(x, weight, cfg.rms_norm_eps)


def act_fn(cfg: ModelConfig):
    if cfg.hidden_act == "silu":
        return F.silu
    if cfg.hidden_act in ("gelu_pytorch_tanh", "gelu_new"):
        return lambda x: F.gelu(x, approximate="tanh")
    if cfg.hidden_act == "gelu":
        return F.gelu
    raise NotImplementedError(f"hidden_act={cfg.hidden_act!r}")


def rope_table(positions, head_dim: int, theta: float, scaling: tuple | None = None):
    """(cos, sin) tables [T, head_dim/2] in float32, HF-compatible scaling
    ("linear", factor) or ("llama3", factor, low, high, orig_max)."""
    inv_freq = _inv_freq(head_dim, theta, scaling, positions.device)
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, scaling: tuple | None, dev: torch.device):
    """The rope inverse frequencies [head_dim/2], built once per geometry
    and device (the decode step asks for them every step); read only."""
    inv_freq = 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim)
    )
    if scaling is not None and scaling[0] == "linear":
        inv_freq = inv_freq / scaling[1]
    elif scaling is not None and scaling[0] == "llama3":
        _, factor, low_f, high_f, orig_max = scaling
        low_wl = orig_max / low_f
        high_wl = orig_max / high_f
        wavelen = 2.0 * math.pi / inv_freq
        smooth = ((orig_max / wavelen - low_f) / (high_f - low_f)).clamp(0.0, 1.0)
        inv_freq = torch.where(
            wavelen > low_wl,
            inv_freq / factor,
            torch.where(
                wavelen < high_wl,
                inv_freq,
                (1.0 - smooth) * inv_freq / factor + smooth * inv_freq,
            ),
        )
    return inv_freq


def _w_einsum(x, lp: dict, name: str, n_contract: int, qmm=quant_einsum):
    """The matmul seam (JAX `_w_einsum`, :937): x [..., *K] against layer
    kernel `name` [*K, *out] (its first `n_contract` axes contracted) ->
    [..., *out]. An fp kernel runs the plain matmul, so the fp path is
    unchanged bit for bit; a `q`/`scale` pair runs `qmm` (`quant_einsum`:
    the K6 kernel on a CUDA tensor, or a plain version a check swaps in)."""
    w = lp.get(name)
    if w is None:
        return qmm(x, lp[f"{name}/q"], lp[f"{name}/scale"], n_contract)
    K = math.prod(w.shape[:n_contract])
    out = x.reshape(-1, K) @ w.reshape(K, -1)
    return out.reshape(*x.shape[: x.dim() - n_contract], *w.shape[n_contract:])


def _project_qkv(lp: dict, x, cos, sin, cfg: ModelConfig, qmm=quant_einsum):
    """QKV projection + bias + rope (JAX :1844). x [T, H]; cos/sin
    [T, hd/2]."""
    q = _w_einsum(x, lp, "attn/q_kernel", 1, qmm)
    k = _w_einsum(x, lp, "attn/k_kernel", 1, qmm)
    v = _w_einsum(x, lp, "attn/v_kernel", 1, qmm)
    if cfg.qkv_bias:
        q = q + lp["attn/q_bias"]
        k = k + lp["attn/k_bias"]
        v = v + lp["attn/v_bias"]
    cos_b = cos[:, None, :].to(q.dtype)
    sin_b = sin[:, None, :].to(q.dtype)

    def rot(t):
        d2 = t.shape[-1] // 2
        t1, t2 = t[..., :d2], t[..., d2:]
        return torch.cat([t1 * cos_b - t2 * sin_b, t2 * cos_b + t1 * sin_b], dim=-1)

    return rot(q), rot(k), v


def _attn_out(lp: dict, attn, qmm=quant_einsum):
    """[T, nH, hd] attention output -> [T, H] through o_kernel, which
    contracts over (nH, hd)."""
    return _w_einsum(attn, lp, "attn/o_kernel", 2, qmm)


def mlp(lp: dict, x, cfg: ModelConfig, qmm=quant_einsum):
    """Gated MLP (JAX :1275): down(act(gate(x)) * up(x))."""
    act = act_fn(cfg)
    gate = _w_einsum(x, lp, "mlp/gate_kernel", 1, qmm)
    up = _w_einsum(x, lp, "mlp/up_kernel", 1, qmm)
    return _w_einsum(act(gate) * up, lp, "mlp/down_kernel", 1, qmm)


def _embed(params: dict, ids, cfg: ModelConfig):
    return params["embed/embedding"][ids].to(torch_dtype(cfg.dtype))


def _head_logits(params: dict, x, cfg: ModelConfig):
    """[T, H] post-norm hidden states -> [T, V] f32 logits."""
    if cfg.tie_word_embeddings:
        w = params["embed/embedding"].to(x.dtype)
        return (x @ w.t()).float()
    return (x @ params["lm_head/kernel"]).float()


def _head_values(params: dict, x, cfg: ModelConfig):
    """[T, H] post-norm hidden states -> [T] f32 values through the value
    head (JAX :1544-1548), in the hidden states' dtype."""
    w = params["value_head/kernel"]
    return (x @ w.to(x.dtype) + params["value_head/bias"].to(x.dtype))[:, 0].float()


def _logits(params: dict, x, cfg: ModelConfig):
    return _head_logits(params, _norm(x, params["final_norm"], cfg), cfg)


def _dense_attention(q, k, v, mask):
    """Masked softmax attention in the JAX XLA op order (:1244-1254):
    scores in the compute dtype, cast to f32, divided by sqrt(hd), -1e30
    where `mask` [T, T] is False, probabilities rounded back. q
    `[T, nH, hd]`, k/v `[T, nKV, hd]`."""
    T, nH, hd = q.shape
    nKV = k.shape[1]
    qg = q.reshape(T, nKV, nH // nKV, hd)
    scores = torch.einsum("tkgd,skd->kgts", qg, k).float() / math.sqrt(hd)
    scores = torch.where(mask[None, None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    return torch.einsum("kgts,skd->tkgd", probs, v).reshape(T, nH, hd)


# ---------------------------------------------------------------------------
# Packed training forward
# ---------------------------------------------------------------------------


def segment_ids_from_cu_seqlens(cu_seqlens: np.ndarray, total: int) -> np.ndarray:
    """Host helper (JAX :1824): cu_seqlens -> per-token segment ids
    0..n-1. The pad tail appended by `pad_packed_tensor_dict` is its own
    segment, as in the JAX package."""
    seg = np.zeros(total, dtype=np.int32)
    for i in range(len(cu_seqlens) - 1):
        seg[cu_seqlens[i] : cu_seqlens[i + 1]] = i
    return seg


def segment_causal_mask(segment_ids):
    """[T, T] bool (JAX :1132): attend iff same segment AND causal AND the
    query is not padding."""
    T = segment_ids.shape[0]
    seg_q = segment_ids[:, None]
    causal = torch.ones(T, T, dtype=torch.bool, device=segment_ids.device).tril()
    return (seg_q == segment_ids[None, :]) & causal & (seg_q != PADDING_SEGMENT)


_ATTN_IMPLS = ("auto", "flash", "dense", "ring", "chunked")


def resolve_attn_impl(cfg: ModelConfig) -> str:
    """The attention path of the packed forward (JAX :1150). "auto" is
    "flash": the hand-written kernels on CUDA tensors, their plain version
    on CPU tensors. "dense" materialises the [T, T] mask."""
    if cfg.attn_impl not in _ATTN_IMPLS:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} not in {_ATTN_IMPLS}")
    if cfg.attn_impl in ("ring", "chunked"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not in the PyTorch port yet: "
            "ROADMAP.md queue 1, item 5 (ring) and item 6.7 (chunked)"
        )
    return "flash" if cfg.attn_impl == "auto" else cfg.attn_impl


def attention(lp: dict, x, cos, sin, layout, cfg: ModelConfig):
    """Packed GQA attention over one token stream x [T, H] (JAX :1187);
    q/k/v stay in the token-major `[T, n, hd]` layout the kernels read.
    `layout` is what the attention path reads, built once per forward: the
    flash kernels' `packed_layout(segment_ids)`, or the dense [T, T] mask."""
    q, k, v = _project_qkv(lp, x, cos, sin, cfg)
    if resolve_attn_impl(cfg) == "flash":
        out = flash_attention(q, k, v, layout)
    else:
        out = _dense_attention(q, k, v, layout)
    return _attn_out(lp, out)


def decoder_layer(lp: dict, x, cos, sin, layout, cfg: ModelConfig):
    """One pre-norm decoder layer (JAX :1423) of the dense family."""
    x = x + attention(lp, _norm(x, lp["input_norm"], cfg), cos, sin, layout, cfg)
    return x + mlp(lp, _norm(x, lp["post_attn_norm"], cfg), cfg)


_REMAT_POLICIES = ("full", "dots_saveable", "dots_with_no_batch_dims_saveable")


def forward(
    params: dict,
    input_ids,
    position_ids,
    segment_ids,
    cfg: ModelConfig,
    *,
    return_hidden: bool = False,
    layers: list[dict] | None = None,
):
    """Packed forward (JAX :1445): [T] ids -> [T, V] f32 logits (f32
    values [T] for a critic), or the post-final-norm hidden states [T, H]
    with `return_hidden` (the fused LM-loss path, `LMHead`; a critic
    refuses it, JAX :1541). `segment_ids` [T] mark sequence membership;
    attention is causal within a segment. It trains fp weights: an
    int8-quantized tree (`quantize_weights`) is refused.

    With `cfg.remat` and gradients enabled, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward, the flash forward kernel included. Only
    `remat_policy="full"` is ported."""
    if is_weight_quantized(params):
        raise ValueError(
            "forward takes fp weights; this tree holds int8 q/scale kernels, "
            "which only the serving path (prefill, decode_step_paged) reads"
        )
    if return_hidden and cfg.is_critic:
        raise ValueError("return_hidden is the fused LM-loss path; a critic has no LM head")
    if cfg.remat and cfg.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy={cfg.remat_policy!r} not in {_REMAT_POLICIES}")
    if cfg.remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r} is not in the PyTorch port "
            "yet (ROADMAP.md queue 1, item 7); use 'full'"
        )
    if layers is None:
        layers = layer_views(params, cfg)
    x = _embed(params, input_ids, cfg)
    cos, sin = rope_table(position_ids, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_)
    # the segment layout belongs to the micro-batch: built once, read by
    # every layer and by every remat rerun
    if resolve_attn_impl(cfg) == "dense":
        layout = segment_causal_mask(segment_ids)
    else:
        layout = packed_layout(segment_ids)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = checkpoint(decoder_layer, lp, x, cos, sin, layout, cfg, use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cos, sin, layout, cfg)
    x = _norm(x, params["final_norm"], cfg)
    if return_hidden:
        return x
    if cfg.is_critic:
        return _head_values(params, x, cfg)
    return _head_logits(params, x, cfg)


class LMHead:
    """Lazy LM head over post-final-norm hidden states (JAX :1007), handed
    to `hidden_loss`-tagged loss functions instead of dense logits: label
    logprobs and entropy come from the vocab-chunked online logsumexp, so
    the f32 [T, V] logits never exist."""

    def __init__(self, hidden, params: dict, cfg: ModelConfig):
        self.hidden = hidden
        self.params = params
        self.cfg = cfg

    def _head(self):
        if self.cfg.tie_word_embeddings:
            return self.params["embed/embedding"], True
        return self.params["lm_head/kernel"], False

    def label_logprobs(self, labels, temperature: float = 1.0):
        w, vh = self._head()
        return chunked_label_logprobs(
            self.hidden, w.to(self.hidden.dtype), labels, head_is_vh=vh,
            temperature=temperature, vocab_chunk=self.cfg.loss_vocab_chunk,
        )

    def label_logprobs_entropy(self, labels, temperature: float = 1.0):
        w, vh = self._head()
        return chunked_label_logprobs(
            self.hidden, w.to(self.hidden.dtype), labels, head_is_vh=vh,
            temperature=temperature, with_entropy=True,
            vocab_chunk=self.cfg.loss_vocab_chunk,
        )

    def clamped_entropy(self, entropy_clamp: float, temperature: float = 1.0):
        """AEnt clamped entropy (JAX :1054), in token chunks: the clamp's
        threshold cannot ride the online vocab scan."""
        w, vh = self._head()
        return chunked_clamped_entropy(
            self.hidden, w.to(self.hidden.dtype), head_is_vh=vh,
            entropy_clamp=entropy_clamp, temperature=temperature,
        )


# ---------------------------------------------------------------------------
# Prefill and the paged decode step
# ---------------------------------------------------------------------------


def prefill(params: dict, input_ids, position_ids, cfg: ModelConfig,
            with_logits: bool = True, layers: list[dict] | None = None,
            prefix_k=None, prefix_v=None, prefix_len=None,
            input_embeds=None, rope_cos=None, rope_sin=None):
    """Causal forward over ONE sequence [T] (JAX :1872), or over B distinct
    sequences [B, T] that share a bucket (the JAX engine's vmap of it,
    `jax_decode.py:1818-1879`). Returns (logits [(B,) T, V] f32 or None,
    k [(B,) L, T, nKV, hd], v [(B,) L, T, nKV, hd]).

    Attention is dense: plain matmul + softmax in the JAX op order (scores
    in the compute dtype, cast to f32, divided by sqrt(hd), -1e30 above
    the diagonal, probabilities rounded back), one sequence at a time; the
    dense matmuls take the B x T rows at once. `with_logits=False` skips
    the LM head: the decode engine samples every token, the first one
    included, in its decode loop, so prefill only writes KV. `layers` is
    `layer_views(params, cfg)` when the caller keeps it. `position_ids`
    is [T], or [B, T]. A critic is refused (`check_servable`).

    `prefix_k/prefix_v` [L, Tp, nKV, hd] with `prefix_len`: cached context
    for a SUFFIX prefill of one sequence (partial prefix sharing). Every
    token also attends to the prefix rows < prefix_len, and
    `position_ids` must then be the absolute positions (prefix_len +
    arange). One layer body serves both modes, as in JAX.

    `input_embeds` [(B,) T, H] replaces the token-embedding lookup (the
    multimodal path: vision vectors spliced over the image-pad positions,
    `models/qwen2_vl.splice_image_embeds`), and `rope_cos`/`rope_sin`
    [(B,) T, hd/2] replace the 1-D rope tables (Qwen2-VL m-rope,
    `models/qwen2_vl.mrope_table`), as JAX :1872-1920 does."""
    check_servable(cfg)
    if layers is None:
        layers = layer_views(params, cfg)
    batched = input_ids.dim() == 2
    ids = input_ids if batched else input_ids[None]
    B, T = ids.shape
    pos = position_ids if position_ids.dim() == 2 else position_ids[None].expand(B, T)
    if input_embeds is not None:
        x = input_embeds.reshape(B * T, -1).to(torch_dtype(cfg.dtype))
    else:
        x = _embed(params, ids.reshape(-1), cfg)  # [B*T, H]
    if rope_cos is not None:
        hd2 = rope_cos.shape[-1]
        cos, sin = rope_cos.reshape(B * T, hd2), rope_sin.reshape(B * T, hd2)
    else:
        cos, sin = rope_table(pos.reshape(-1), cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_)
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    if prefix_k is not None:
        if batched:
            raise ValueError("a suffix prefill takes one sequence")
        Tp = prefix_k.shape[1]
        in_prefix = torch.arange(Tp, device=x.device) < prefix_len
        mask = torch.cat([in_prefix[None, :].expand(T, Tp), mask], dim=1)  # [T, Tp+T]
    nH, hd = cfg.num_attention_heads, cfg.head_dim_
    ks, vs = [], []
    for i, lp in enumerate(layers):
        h = _norm(x, lp["input_norm"], cfg)
        q, k, v = (t.reshape(B, T, *t.shape[1:]) for t in _project_qkv(lp, h, cos, sin, cfg))
        if prefix_k is not None:
            kk = torch.cat([prefix_k[i].to(k.dtype), k[0]])[None]
            vv = torch.cat([prefix_v[i].to(v.dtype), v[0]])[None]
        else:
            kk, vv = k, v
        attn = torch.stack([_dense_attention(q[b], kk[b], vv[b], mask) for b in range(B)])
        x = x + _attn_out(lp, attn.reshape(B * T, nH, hd))
        h = _norm(x, lp["post_attn_norm"], cfg)
        x = x + mlp(lp, h, cfg)
        ks.append(k)
        vs.append(v)
    k_all, v_all = torch.stack(ks, dim=1), torch.stack(vs, dim=1)  # [B, L, T, nKV, hd]
    logits = None if not with_logits else _logits(params, x, cfg).reshape(B, T, -1)
    if not batched:
        k_all, v_all = k_all[0], v_all[0]
        logits = None if logits is None else logits[0]
    return logits, k_all, v_all


def prefill_with_prefix(params: dict, input_ids, prefix_k, prefix_v, prefix_len: int,
                        cfg: ModelConfig, layers: list[dict] | None = None):
    """Causal forward over a SUFFIX [T] (bucket-padded) whose context is
    cached prefix KV `[L, Tp, nKV, hd]` (JAX :2008): each suffix token
    attends to the prefix rows < prefix_len and, causally, to the earlier
    suffix tokens; suffix token i sits at absolute position prefix_len + i
    for rope. Returns the suffix's (k, v) [L, T, nKV, hd], to be written
    at offset prefix_len. A thin wrapper over `prefill`: one layer body."""
    T = input_ids.shape[0]
    positions = prefix_len + torch.arange(T, device=input_ids.device)
    _, ks, vs = prefill(params, input_ids, positions, cfg, with_logits=False, layers=layers,
                        prefix_k=prefix_k, prefix_v=prefix_v, prefix_len=prefix_len)
    return ks, vs


def decode_step_paged(
    params: dict,
    tokens,  # [R] current input token per slot
    positions,  # [R] logical row the new token occupies
    k_pool,  # [L, n_blocks, bsz, nKV, hd], or (int8, f32 scales), in place
    v_pool,  # [L, n_blocks, bsz, nKV, hd], or (int8, f32 scales), in place
    block_tables,  # [R, nb] int32 pool-block ids per slot
    cfg: ModelConfig,
    active=None,  # [R] bool: slot holds a live request
    attn_fn=paged_attention,
    layers: list[dict] | None = None,  # layer_views(params, cfg), if kept
    matmul_fn=quant_einsum,
    rope_offset=None,  # [R] added to the rotary position only
):
    """One batched decode step attending directly over the paged pool
    (JAX :2153): `verify_step_paged` with one position per slot, its
    attention through `attn_fn` in the one-query form. Returns logits
    [R, V] in f32.

    Each layer writes the new K/V row of every slot at pool coordinates
    `(block_tables[r, p // bsz], p % bsz)` with one in-place `index_put_`
    (O(1) per token), then attends through the block table with
    `attn_fn` (the paged-attention op; chip checks pass its plain version
    to compare). Inactive slots write into the null block 0 instead
    (JAX :2228-2230), so a retired or parked slot's KV is never touched;
    their stale positions are clamped into the table first.

    Int8 pools (JAX :2185-2242): `k_pool`/`v_pool` are `(int8 data
    [L, n_blocks, bsz, nKV, hd], f32 scales [L, n_blocks, nKV, bsz])`
    tuples. The new row is quantized per (row, kv head) at the scatter,
    its scales land at `scales[dest_block, :, dest_off]`, and attention
    reads the row just written through its int8 form. Quantized weights
    run through `matmul_fn` (`quant_einsum`; chip checks swap in its plain
    version).

    `rope_offset` shifts the ROTARY position only, never the KV row (JAX
    :2064-2082): m-rope compresses an image's positions, so an image
    slot's text sits at rotary position row + its delta, where one scalar
    for all three sections is exactly 1-D rope."""

    def one_query(q, kp, vp, table, valid):  # [R, 1, nH, hd] -> [R, 1, nH, hd]
        return attn_fn(q[:, 0], kp, vp, table, valid[:, 0])[:, None]

    return verify_step_paged(
        params, tokens[:, None], positions, k_pool, v_pool, block_tables, cfg,
        active=active, attn_fn=one_query, layers=layers, matmul_fn=matmul_fn,
        rope_offset=rope_offset,
    )[:, 0]


def verify_step_paged(
    params: dict,
    tokens,  # [R, W]: column 0 the slot's last token, then its draft
    positions0,  # [R] logical row column 0 occupies
    k_pool,  # [L, n_blocks, bsz, nKV, hd], or (int8, f32 scales), in place
    v_pool,  # [L, n_blocks, bsz, nKV, hd], or (int8, f32 scales), in place
    block_tables,  # [R, nb] int32 pool-block ids per slot
    cfg: ModelConfig,
    active=None,  # [R] bool: slot holds a live request
    attn_fn=paged_attention_qlen,
    layers: list[dict] | None = None,  # layer_views(params, cfg), if kept
    matmul_fn=quant_einsum,
    rope_offset=None,  # [R] added to the rotary position only
):
    """W positions per slot in one forward over the paged pool, the
    speculative verify step (JAX :2414-2546). Column j of slot r sits at
    `positions0[r] + j`. Returns logits [R, W, V] in f32.

    Each layer writes the R x W new K/V rows at their pool coordinates with
    one in-place `index_put_` per pool (inactive slots write all W rows
    into the null block 0, row 0: a duplicate index, whose last write
    nobody reads), then attends through the block table with `attn_fn`
    (`paged_attention_qlen`: K4, or K5b on an int8 pool; chip checks pass
    its plain version) under per-query causal masks, so column j sees the
    rows written for columns < j in this same forward. Rows are written
    before attention reads them, in one stream's order. An int8 pool
    quantizes the W rows at the scatter and writes their scales to
    `scales[dest_block, :, dest_off]`, as `decode_step_paged` does for its
    one row. Matmuls run through `matmul_fn` at T = R x W rows.
    `rope_offset` [R] shifts slot r's rotary positions only (JAX :2456).
    A critic is refused (`check_servable`)."""
    check_servable(cfg)
    if layers is None:
        layers = layer_views(params, cfg)
    (k_data, k_scales), (v_data, v_scales) = split_pool(k_pool), split_pool(v_pool)
    R, W = tokens.shape
    bsz = k_data.shape[2]
    nb = block_tables.shape[1]
    span = nb * bsz
    nH, hd = cfg.num_attention_heads, cfg.head_dim_
    dev = tokens.device
    positions = positions0.long()[:, None] + torch.arange(W, device=dev)  # [R, W]
    x = _embed(params, tokens.reshape(-1), cfg)  # [R*W, H]
    rope_pos = positions if rope_offset is None else positions + rope_offset.long()[:, None]
    cos, sin = rope_table(rope_pos.reshape(-1), hd, cfg.rope_theta, cfg.rope_scaling_)
    valid = torch.arange(span, device=dev)[None, None, :] <= positions[:, :, None]

    blk_col = (positions // bsz).clamp(0, nb - 1)
    dest_block = block_tables.long().gather(1, blk_col)  # [R, W]
    dest_off = positions % bsz
    if active is not None:
        dest_block = torch.where(active[:, None], dest_block, 0)
        dest_off = torch.where(active[:, None], dest_off, 0)
    dest_block = dest_block.reshape(-1)
    dest_off = dest_off.reshape(-1)

    def write(data, scales, new):  # [n_blocks, bsz, nKV, hd] <- [R*W, nKV, hd]
        if scales is None:
            data.index_put_((dest_block, dest_off), new.to(data.dtype))
            return data
        q_rows, s_rows = quantize_kv(new)  # quantized at the scatter
        data.index_put_((dest_block, dest_off), q_rows)
        scales[dest_block, :, dest_off] = s_rows  # [R*W, nKV]
        return data, scales

    for i, lp in enumerate(layers):
        h = _norm(x, lp["input_norm"], cfg)
        q, k_new, v_new = _project_qkv(lp, h, cos, sin, cfg, matmul_fn)
        kp = write(k_data[i], None if k_scales is None else k_scales[i], k_new)
        vp = write(v_data[i], None if v_scales is None else v_scales[i], v_new)
        attn = attn_fn(q.reshape(R, W, nH, hd), kp, vp, block_tables, valid)
        x = x + _attn_out(lp, attn.reshape(R * W, nH, hd), matmul_fn)
        h = _norm(x, lp["post_attn_norm"], cfg)
        x = x + mlp(lp, h, cfg, matmul_fn)
    return _logits(params, x, cfg).reshape(R, W, -1)


def verify_step(
    params: dict,
    tokens,  # [R, W]: column 0 the slot's last token, then its draft
    positions0,  # [R] row column 0 occupies
    k_cache,  # [L, R, S, nKV, hd] per-slot contiguous workspace, in place
    v_cache,  # [L, R, S, nKV, hd]
    cfg: ModelConfig,
    active=None,  # [R] bool: slot holds a live request
    layers: list[dict] | None = None,  # layer_views(params, cfg), if kept
    matmul_fn=quant_einsum,
    rope_offset=None,  # [R] added to the rotary position only
):
    """The speculative verify step over the workspace layout (JAX :2295):
    W positions per slot in one forward over a dense per-slot cache, which
    the engine gathers from the pool's blocks and scatters back. Column j
    of slot r sits at `positions0[r] + j`; returns logits [R, W, V] in
    f32.

    Each layer writes the R x W new rows at `(r, position)` of the cache
    in place, cast to the cache's dtype; an inactive slot writes its old
    rows back unchanged, so a parked or donor slot's KV passes through the
    gather and scatter intact. Attention is `verify_attention` over the
    cache (cast to q's dtype), the op sequence of the paged plain version,
    so the workspace and paged layouts agree bit for bit. Positions are
    clamped into the cache. `rope_offset` [R] shifts slot r's rotary
    positions only (JAX :2336). A critic is refused (`check_servable`)."""
    check_servable(cfg)
    if layers is None:
        layers = layer_views(params, cfg)
    R, W = tokens.shape
    S = k_cache.shape[2]
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    dev = tokens.device
    positions = positions0.long()[:, None] + torch.arange(W, device=dev)  # [R, W]
    x = _embed(params, tokens.reshape(-1), cfg)  # [R*W, H]
    rope_pos = positions if rope_offset is None else positions + rope_offset.long()[:, None]
    cos, sin = rope_table(rope_pos.reshape(-1), hd, cfg.rope_theta, cfg.rope_scaling_)
    valid = torch.arange(S, device=dev)[None, None, :] <= positions[:, :, None]
    pos_c = positions.clamp(0, S - 1)
    rows = torch.arange(R, device=dev)[:, None].expand(R, W)

    def write(cache, new):  # [R, S, nKV, hd] <- [R*W, nKV, hd], in place
        new = new.reshape(R, W, nKV, hd).to(cache.dtype)
        if active is not None:
            new = torch.where(active[:, None, None, None], new, cache[rows, pos_c])
        cache[rows, pos_c] = new

    for i, lp in enumerate(layers):
        h = _norm(x, lp["input_norm"], cfg)
        q, k_new, v_new = _project_qkv(lp, h, cos, sin, cfg, matmul_fn)
        write(k_cache[i], k_new)
        write(v_cache[i], v_new)
        attn = verify_attention(q.reshape(R, W, nH, hd), k_cache[i], v_cache[i], valid)
        x = x + _attn_out(lp, attn.reshape(R * W, nH, hd), matmul_fn)
        h = _norm(x, lp["post_attn_norm"], cfg)
        x = x + mlp(lp, h, cfg, matmul_fn)
    return _logits(params, x, cfg).reshape(R, W, -1)


def decode_step(
    params: dict,
    tokens,  # [R] current input token per slot
    positions,  # [R] row the new token occupies
    k_cache,  # [L, R, S, nKV, hd] per-slot contiguous workspace, in place
    v_cache,  # [L, R, S, nKV, hd]
    cfg: ModelConfig,
    active=None,  # [R] bool: slot holds a live request
    layers: list[dict] | None = None,
    matmul_fn=quant_einsum,
    rope_offset=None,  # [R] added to the rotary position only
):
    """One batched decode step over the workspace layout (JAX :2046):
    `verify_step` with one position per slot (the masked row write, scores
    in q's dtype), `rope_offset` shifting the rotary position only.
    Returns logits [R, V] in f32."""
    return verify_step(params, tokens[:, None], positions, k_cache, v_cache, cfg,
                       active=active, layers=layers, matmul_fn=matmul_fn,
                       rope_offset=rope_offset)[:, 0]
