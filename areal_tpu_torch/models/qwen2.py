"""Qwen2-class decoder (counterpart of `areal_tpu/models/qwen2.py`): the
packed training forward and the serving path.

The dense GLU / RMSNorm / RoPE decoder of Qwen2 and Qwen2.5 (qkv bias,
tied or untied head), which Llama and Mistral share when unwindowed.
The JAX decoder's other families (MoE, Qwen3 q/k norm, Gemma, GPT-2,
sliding windows, LoRA, critic heads) are refused by `check_supported`
until their ROADMAP item ports them.

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

`decode_step_paged` updates the KV pool in place where the JAX version
returns a new pool: the pool is the largest tensor the engine owns, and an
in-place O(1) row write is what the JAX version's donated scatter compiles
to.
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

from areal_tpu_torch.ops.flash_attention import PADDING_SEGMENT, flash_attention
from areal_tpu_torch.ops.fused_xent import chunked_label_logprobs
from areal_tpu_torch.ops.paged_attention import paged_attention

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
        if model_type not in ("qwen2", "llama", "mistral"):
            raise NotImplementedError(
                f"model_type={model_type!r} is not in the PyTorch port yet "
                "(ROADMAP.md queue 1, item 6)"
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
                "(ROADMAP.md queue 1, item 6)"
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
        elif rs_type not in (None, "default"):
            raise NotImplementedError(
                f"rope_scaling type {rs_type!r} not implemented "
                "(supported: llama3, linear)"
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
        "is_critic": cfg.is_critic,
    }
    for name, unsupported in todo.items():
        if unsupported:
            raise NotImplementedError(
                f"{name}={getattr(cfg, name)!r} is not in the PyTorch port "
                "yet (ROADMAP.md queue 1, item 6)"
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
    if not cfg.tie_word_embeddings:
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
        if name.endswith("_bias"):
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


def _linear(x, w):
    """x [..., H] against a kernel [H, *out] -> [..., *out]."""
    H = w.shape[0]
    return (x.reshape(-1, H) @ w.reshape(H, -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _project_qkv(lp: dict, x, cos, sin, cfg: ModelConfig):
    """QKV projection + bias + rope (JAX :1844). x [T, H]; cos/sin
    [T, hd/2]."""
    q = _linear(x, lp["attn/q_kernel"])
    k = _linear(x, lp["attn/k_kernel"])
    v = _linear(x, lp["attn/v_kernel"])
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


def _attn_out(lp: dict, attn):
    """[T, nH, hd] attention output -> [T, H] through o_kernel."""
    T, nH, hd = attn.shape
    return attn.reshape(T, nH * hd) @ lp["attn/o_kernel"].reshape(nH * hd, -1)


def mlp(lp: dict, x, cfg: ModelConfig):
    """Gated MLP (JAX :1275): down(act(gate(x)) * up(x))."""
    act = act_fn(cfg)
    gate = x @ lp["mlp/gate_kernel"]
    up = x @ lp["mlp/up_kernel"]
    return (act(gate) * up) @ lp["mlp/down_kernel"]


def _embed(params: dict, ids, cfg: ModelConfig):
    return params["embed/embedding"][ids].to(torch_dtype(cfg.dtype))


def _head_logits(params: dict, x, cfg: ModelConfig):
    """[T, H] post-norm hidden states -> [T, V] f32 logits."""
    if cfg.tie_word_embeddings:
        w = params["embed/embedding"].to(x.dtype)
        return (x @ w.t()).float()
    return (x @ params["lm_head/kernel"]).float()


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
            "ROADMAP.md queue 1, item 5 (ring) and item 6 (chunked)"
        )
    return "flash" if cfg.attn_impl == "auto" else cfg.attn_impl


def attention(lp: dict, x, cos, sin, segment_ids, mask, cfg: ModelConfig):
    """Packed GQA attention over one token stream x [T, H] (JAX :1187);
    q/k/v stay in the token-major `[T, n, hd]` layout the kernels read."""
    q, k, v = _project_qkv(lp, x, cos, sin, cfg)
    if resolve_attn_impl(cfg) == "flash":
        out = flash_attention(q, k, v, segment_ids)
    else:
        out = _dense_attention(q, k, v, mask)
    return _attn_out(lp, out)


def decoder_layer(lp: dict, x, cos, sin, segment_ids, mask, cfg: ModelConfig):
    """One pre-norm decoder layer (JAX :1423) of the dense family."""
    x = x + attention(lp, _norm(x, lp["input_norm"], cfg), cos, sin, segment_ids, mask, cfg)
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
    """Packed forward (JAX :1445): [T] ids -> [T, V] f32 logits, or the
    post-final-norm hidden states [T, H] with `return_hidden` (the fused
    LM-loss path, `LMHead`). `segment_ids` [T] mark sequence membership;
    attention is causal within a segment.

    With `cfg.remat` and gradients enabled, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are
    recomputed in the backward, the flash forward kernel included. Only
    `remat_policy="full"` is ported."""
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
    mask = segment_causal_mask(segment_ids) if resolve_attn_impl(cfg) == "dense" else None
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in layers:
        if remat:
            x = checkpoint(decoder_layer, lp, x, cos, sin, segment_ids, mask, cfg,
                           use_reentrant=False)
        else:
            x = decoder_layer(lp, x, cos, sin, segment_ids, mask, cfg)
    x = _norm(x, params["final_norm"], cfg)
    if return_hidden:
        return x
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


# ---------------------------------------------------------------------------
# Prefill and the paged decode step
# ---------------------------------------------------------------------------


def prefill(params: dict, input_ids, position_ids, cfg: ModelConfig,
            with_logits: bool = True, layers: list[dict] | None = None):
    """Causal forward over ONE sequence [T] (JAX :1872). Returns
    (logits [T, V] f32 or None, k [L, T, nKV, hd], v [L, T, nKV, hd]).

    Attention is dense: plain matmul + softmax in the JAX op order (scores
    in the compute dtype, cast to f32, divided by sqrt(hd), -1e30 above
    the diagonal, probabilities rounded back). `with_logits=False` skips
    the LM head: the decode engine samples every token, the first one
    included, in its decode loop, so prefill only writes KV. `layers` is
    `layer_views(params, cfg)` when the caller keeps it."""
    if layers is None:
        layers = layer_views(params, cfg)
    x = _embed(params, input_ids, cfg)
    cos, sin = rope_table(position_ids, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling_)
    T = input_ids.shape[0]
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    ks, vs = [], []
    for lp in layers:
        h = _norm(x, lp["input_norm"], cfg)
        q, k, v = _project_qkv(lp, h, cos, sin, cfg)
        x = x + _attn_out(lp, _dense_attention(q, k, v, mask))
        h = _norm(x, lp["post_attn_norm"], cfg)
        x = x + mlp(lp, h, cfg)
        ks.append(k)
        vs.append(v)
    k_all, v_all = torch.stack(ks), torch.stack(vs)
    if not with_logits:
        return None, k_all, v_all
    return _logits(params, x, cfg), k_all, v_all


def decode_step_paged(
    params: dict,
    tokens,  # [R] current input token per slot
    positions,  # [R] logical row the new token occupies
    k_pool,  # [L, n_blocks, bsz, nKV, hd], written in place
    v_pool,  # [L, n_blocks, bsz, nKV, hd], written in place
    block_tables,  # [R, nb] int32 pool-block ids per slot
    cfg: ModelConfig,
    active=None,  # [R] bool: slot holds a live request
    attn_fn=paged_attention,
    layers: list[dict] | None = None,  # layer_views(params, cfg), if kept
):
    """One batched decode step attending directly over the paged pool
    (JAX :2153). Returns logits [R, V] in f32.

    Each layer writes the new K/V row of every slot at pool coordinates
    `(block_tables[r, p // bsz], p % bsz)` with one in-place `index_put_`
    (O(1) per token), then attends through the block table with
    `attn_fn` (the paged-attention op; chip checks pass its plain version
    to compare). Inactive slots write into the null block 0 instead
    (JAX :2228-2230), so a retired or parked slot's KV is never touched;
    their stale positions are clamped into the table first."""
    if layers is None:
        layers = layer_views(params, cfg)
    R = tokens.shape[0]
    bsz = k_pool.shape[2]
    nb = block_tables.shape[1]
    span = nb * bsz
    nH, hd = cfg.num_attention_heads, cfg.head_dim_
    dev = tokens.device
    x = _embed(params, tokens, cfg)  # [R, H]
    positions = positions.long()
    cos, sin = rope_table(positions, hd, cfg.rope_theta, cfg.rope_scaling_)
    valid = torch.arange(span, device=dev)[None, :] <= positions[:, None]

    blk_col = (positions // bsz).clamp(0, nb - 1)
    dest_block = block_tables.long().gather(1, blk_col[:, None])[:, 0]
    dest_off = positions % bsz
    if active is not None:
        dest_block = torch.where(active, dest_block, 0)
        dest_off = torch.where(active, dest_off, 0)

    for i, lp in enumerate(layers):
        h = _norm(x, lp["input_norm"], cfg)
        q, k_new, v_new = _project_qkv(lp, h, cos, sin, cfg)
        kp, vp = k_pool[i], v_pool[i]
        kp.index_put_((dest_block, dest_off), k_new.to(kp.dtype))
        vp.index_put_((dest_block, dest_off), v_new.to(vp.dtype))
        attn = attn_fn(q.reshape(R, nH, hd), kp, vp, block_tables, valid)
        x = x + _attn_out(lp, attn)
        h = _norm(x, lp["post_attn_norm"], cfg)
        x = x + mlp(lp, h, cfg)
    return _logits(params, x, cfg)
