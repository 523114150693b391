"""HF checkpoint <-> the port's parameters (counterpart of
`areal_tpu/models/hf_io.py`): Qwen2 and Qwen2.5 (q/k/v biases, tied or
untied head), Llama and Mistral, which share its tensor names, Qwen3
(`self_attn.{q,k}_norm`), and the MoE families: Qwen3-MoE and Qwen2-MoE
(`mlp.gate` the router, `mlp.experts.{m}.{gate,up,down}_proj`, Qwen2-MoE's
`mlp.shared_expert.*` and `mlp.shared_expert_gate`) and Mixtral
(`block_sparse_moe.gate`, `block_sparse_moe.experts.{m}.w1/w3/w2` for
gate/up/down). A load stacks each layer's experts `[E, ...]` (JAX
:252-266) and raises on an expert index outside the model's E or one
missing from a stack; a save unstacks them under the family's names (JAX
:344-420).

HF stores each linear weight as `[out, in]`; the port keeps the JAX
package's einsum layout (`[in, out]`, heads split out), so a load is a
transpose and a reshape per tensor (`_convert_tensor`) and a save the
inverse (`_unconvert_tensor`). The parameters are the port's flat dict of
tensors under `/`-joined names (`models/qwen2.py`); `flatten_params` and
`assemble_params` move between it and path tuples of unstacked layers
(`layers_{i}`), stacking them again when `cfg.scan_layers`.

The safetensors format is read and written here, with no package behind
it: an 8-byte little-endian header length, a JSON header mapping each
name to its dtype, shape and byte range, then the tensors' raw
little-endian bytes. As in the JAX package, a save writes one
`model.safetensors` with bf16 tensors upcast to F32 (exact) by default;
it can also keep them in bf16 and shard them under a
`model.safetensors.index.json`, as HF checkpoints ship, and a load reads
either form, a tied head with or without `lm_head.weight` on disk.

A critic's value head is HF's token-classification `score.weight`
`[1, H]` and `score.bias` `[1]` (JAX :62-65); a critic loaded from a
causal-LM checkpoint starts from a zero value head and drops `lm_head`,
as in JAX (:267-277). GPT-2 and Gemma are ROADMAP queue 1, item 6.7.

A Qwen2-VL / Qwen2.5-VL checkpoint's `visual.*` tensors load into the
vision tower's parameters (`load_hf_vision_params`, JAX :515-628), as
strictly as JAX: a `visual.*` tensor the mapping does not know, or a
block missing from a stack, raises. The language model's loader skips
them.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from areal_tpu_torch.models.qwen2 import HF_FAMILIES, ModelConfig, named_shapes, torch_dtype

_ITEM6 = "is not in the PyTorch port yet: ROADMAP.md queue 1, item 6.7 (model breadth)"

# safetensors dtype names
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}
# same-width numpy views of each dtype's bytes (numpy has no bfloat16)
_NP_VIEW = {
    torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
    torch.bfloat16: np.uint16, torch.int64: np.int64, torch.int32: np.int32,
    torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_,
}


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """The tensor's bytes, little-endian, as a flat uint8 array (host)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().reshape(-1).view(np.uint8)


def write_safetensors(tensors: dict[str, torch.Tensor], path: str) -> int:
    """Write `tensors` (any device) to one safetensors file; returns its
    size in bytes. The header is padded with spaces to 8 bytes."""
    header: dict = {}
    names = sorted(tensors)
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = dict(dtype=_ST_NAMES[t.dtype], shape=list(t.shape),
                            data_offsets=[offset, offset + nbytes])
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(_raw_bytes(tensors[name]).tobytes())
    return 8 + len(raw) + offset


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of one safetensors file, as host tensors in their
    stored dtype."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, spec in header.items():
        dtype = _ST_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise TypeError(f"{name}: safetensors dtype {spec['dtype']} is not read")
        begin, end = spec["data_offsets"]
        arr = np.array(data[begin:end]).view(_NP_VIEW[dtype]).reshape(spec["shape"])
        out[name] = torch.from_numpy(arr).view(dtype)
    del data
    return out


def _iter_hf_tensors(model_dir: str):
    """(name, tensor) from `model.safetensors` or the shards that
    `model.safetensors.index.json` lists."""
    index_path = os.path.join(model_dir, "model.safetensors.index.json")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
    else:
        shards = ["model.safetensors"]
    for shard in shards:
        yield from read_safetensors(os.path.join(model_dir, shard)).items()


_LAYER_TABLE = {
    "self_attn.q_proj.weight": ("attn", "q_kernel"),
    "self_attn.k_proj.weight": ("attn", "k_kernel"),
    "self_attn.v_proj.weight": ("attn", "v_kernel"),
    "self_attn.o_proj.weight": ("attn", "o_kernel"),
    "self_attn.q_proj.bias": ("attn", "q_bias"),
    "self_attn.k_proj.bias": ("attn", "k_bias"),
    "self_attn.v_proj.bias": ("attn", "v_bias"),
    "self_attn.q_norm.weight": ("attn", "q_norm"),
    "self_attn.k_norm.weight": ("attn", "k_norm"),
    "mlp.gate_proj.weight": ("mlp", "gate_kernel"),
    "mlp.up_proj.weight": ("mlp", "up_kernel"),
    "mlp.down_proj.weight": ("mlp", "down_kernel"),
    "mlp.gate.weight": ("mlp", "router_kernel"),
    "mlp.shared_expert.gate_proj.weight": ("mlp", "shared_gate_kernel"),
    "mlp.shared_expert.up_proj.weight": ("mlp", "shared_up_kernel"),
    "mlp.shared_expert.down_proj.weight": ("mlp", "shared_down_kernel"),
    "mlp.shared_expert_gate.weight": ("mlp", "shared_router_kernel"),
    "block_sparse_moe.gate.weight": ("mlp", "router_kernel"),
    "input_layernorm.weight": ("input_norm",),
    "post_attention_layernorm.weight": ("post_attn_norm",),
}
_LAYER_NAMES = {v: k for k, v in _LAYER_TABLE.items() if not k.startswith("block_sparse_moe.")}
# an expert's projection -> its stacked leaf: the qwen MoE names, then
# Mixtral's (w1 gate, w3 up, w2 down: HF MixtralBlockSparseTop2MLP)
_EXPERT_LEAVES = {
    "mlp.experts": {"gate_proj": "gate_kernel", "up_proj": "up_kernel",
                    "down_proj": "down_kernel"},
    "block_sparse_moe.experts": {"w1": "gate_kernel", "w3": "up_kernel", "w2": "down_kernel"},
}
_EXPERT_NAMES = {fam: {v: k for k, v in t.items()} for fam, t in _EXPERT_LEAVES.items()}


def hf_name_to_ours(name: str) -> tuple[str, ...] | None:
    """One HF tensor name -> its path in the unstacked tree (JAX :50), or
    None for a tensor the port does not read (rotary buffers; the families
    of item 6.7, which `assemble_params` then finds missing). Expert m's
    projection maps to (`layers_{i}`, "mlp", f"expert_{m}", leaf), which
    `assemble_params` stacks."""
    name = name.removeprefix("model.")
    if name == "embed_tokens.weight":
        return ("embed", "embedding")
    if name == "norm.weight":
        return ("final_norm",)
    if name == "lm_head.weight":
        return ("lm_head", "kernel")
    if name == "score.weight":  # HF token-classification value head
        return ("value_head", "kernel")
    if name == "score.bias":
        return ("value_head", "bias")
    if name.startswith("layers."):
        parts = name.split(".")
        rest = ".".join(parts[2:])
        if rest in _LAYER_TABLE:
            return (f"layers_{int(parts[1])}",) + _LAYER_TABLE[rest]
        for fam, leaves in _EXPERT_LEAVES.items():
            sub = rest[len(fam) + 1:].split(".") if rest.startswith(fam + ".") else []
            if len(sub) == 3 and sub[1] in leaves and sub[2] == "weight":
                return (f"layers_{int(parts[1])}", "mlp", f"expert_{int(sub[0])}", leaves[sub[1]])
    return None


def ours_name_to_hf(path: tuple[str, ...], model_type: str = "qwen2") -> str:
    """A path of the unstacked tree -> its HF tensor name for
    `model_type`'s layout (JAX :361): only the MoE names differ by family,
    Mixtral's `block_sparse_moe.*` against the qwen `mlp.*`."""
    if model_type not in HF_FAMILIES:
        raise NotImplementedError(f"model_type={model_type!r} {_ITEM6}")
    if path == ("embed", "embedding"):
        return "model.embed_tokens.weight"
    if path == ("final_norm",):
        return "model.norm.weight"
    if path == ("lm_head", "kernel"):
        return "lm_head.weight"
    if path == ("value_head", "kernel"):
        return "score.weight"
    if path == ("value_head", "bias"):
        return "score.bias"
    if path[0].startswith("layers_"):
        pre = f"model.layers.{int(path[0].split('_')[1])}."
        fam = "block_sparse_moe" if model_type == "mixtral" else "mlp"
        if len(path) == 4 and path[1] == "mlp" and path[2].startswith("expert_"):
            m = int(path[2].split("_")[1])
            return f"{pre}{fam}.experts.{m}.{_EXPERT_NAMES[fam + '.experts'][path[3]]}.weight"
        if path[1:] == ("mlp", "router_kernel"):
            return f"{pre}{fam}.gate.weight"
        if path[1:] in _LAYER_NAMES:
            return pre + _LAYER_NAMES[path[1:]]
    raise KeyError(path)


_MATRICES = ("gate_kernel", "up_kernel", "down_kernel", "kernel", "router_kernel",
             "shared_gate_kernel", "shared_up_kernel", "shared_down_kernel",
             "shared_router_kernel")


def _convert_tensor(path: tuple[str, ...], w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Torch `[out, in]` -> the port's einsum layout (JAX :118)."""
    nH, nKV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    H = cfg.hidden_size
    leaf = path[-1]
    if leaf in ("q_kernel", "k_kernel", "v_kernel"):
        n = nH if leaf == "q_kernel" else nKV
        return w.t().contiguous().reshape(H, n, hd)
    if leaf == "o_kernel":
        return w.t().contiguous().reshape(nH, hd, H)
    if leaf == "q_bias":
        return w.reshape(nH, hd)
    if leaf in ("k_bias", "v_bias"):
        return w.reshape(nKV, hd)
    if leaf in _MATRICES:
        return w.t().contiguous()
    return w  # norms, embedding


def _unconvert_tensor(path: tuple[str, ...], w: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The port's layout -> torch `[out, in]` (JAX :139)."""
    H = cfg.hidden_size
    leaf = path[-1]
    if leaf in ("q_kernel", "k_kernel", "v_kernel"):
        return w.reshape(H, -1).t().contiguous()
    if leaf == "o_kernel":
        return w.reshape(-1, H).t().contiguous()
    if leaf in ("q_bias", "k_bias", "v_bias"):
        return w.reshape(-1)
    if leaf in _MATRICES:
        return w.t().contiguous()
    return w


def _check_family(cfg: ModelConfig) -> None:
    if cfg.model_type not in HF_FAMILIES:
        raise NotImplementedError(f"model_type={cfg.model_type!r} {_ITEM6}")


def _is_expert_leaf(path: tuple, cfg: ModelConfig) -> bool:
    return bool(cfg.num_experts) and len(path) == 3 and path[1] == "mlp" and path[2] in (
        "gate_kernel", "up_kernel", "down_kernel")


def flatten_params(params: dict[str, torch.Tensor], cfg: ModelConfig) -> dict[tuple, torch.Tensor]:
    """The port's parameters -> {path of the unstacked tree: tensor}
    (JAX :323): stacked `layers/...` leaves split into `layers_{i}`, and a
    MoE layer's `[E, ...]` experts into `expert_{m}` paths (JAX :340-352)."""
    flat: dict[tuple, torch.Tensor] = {}
    for name, t in params.items():
        path = tuple(name.split("/"))
        if path[0] == "layers":
            for i in range(cfg.num_hidden_layers):
                flat[(f"layers_{i}",) + path[1:]] = t[i]
        else:
            flat[path] = t
    for path in [p for p in flat if _is_expert_leaf(p, cfg)]:
        t = flat.pop(path)
        for m in range(cfg.num_experts):
            flat[path[:2] + (f"expert_{m}", path[2])] = t[m]
    return flat


def _stack_experts(flat: dict[tuple, torch.Tensor], cfg: ModelConfig) -> dict[tuple, torch.Tensor]:
    """(..., "expert_{m}", leaf) entries -> one (..., leaf) `[E, ...]` each
    (JAX :252-266). An index outside the model's E, or a stack missing an
    expert, raises: a checkpoint the model cannot hold must not load with
    experts dropped."""
    out, stacks = {}, {}
    for p, w in flat.items():
        if len(p) == 4 and p[2].startswith("expert_"):
            m = int(p[2].split("_")[1])
            if not 0 <= m < cfg.num_experts:
                raise ValueError(f"expert {m} of {p[0]}/{p[3]} is outside the model's "
                                 f"{cfg.num_experts} experts")
            stacks.setdefault(p[:2] + (p[3],), {})[m] = w
        else:
            out[p] = w
    for p, by_m in stacks.items():
        missing = [m for m in range(cfg.num_experts) if m not in by_m]
        if missing:
            raise ValueError(f"{'/'.join(p)}: experts {missing[:8]} missing from the checkpoint")
        out[p] = torch.stack([by_m[m] for m in range(cfg.num_experts)])
    return out


def assemble_params(flat: dict[tuple, torch.Tensor], cfg: ModelConfig,
                    dtype: str) -> dict[str, torch.Tensor]:
    """{path of the unstacked tree: tensor} -> the port's parameters in
    `dtype`, layers stacked when `cfg.scan_layers` (JAX :240); a tied head
    or a critic drops `lm_head`, a critic missing its value head gets a
    zero one, and a model that is no critic drops `value_head` (JAX
    :267-277). Names and shapes must be `cfg`'s exactly."""
    tdt = torch_dtype(dtype)
    if cfg.tie_word_embeddings or cfg.is_critic:
        flat = {p: w for p, w in flat.items() if p[0] != "lm_head"}
    if cfg.is_critic:
        dev = next(iter(flat.values())).device if flat else "cpu"
        flat.setdefault(("value_head", "kernel"), torch.zeros(cfg.hidden_size, 1, device=dev))
        flat.setdefault(("value_head", "bias"), torch.zeros(1, device=dev))
    else:
        flat = {p: w for p, w in flat.items() if p[0] != "value_head"}
    out: dict[str, torch.Tensor] = {}
    if cfg.scan_layers:
        subs = sorted({p[1:] for p in flat if p[0].startswith("layers_")})
        for sub in subs:
            try:
                layers = [flat[(f"layers_{i}",) + sub] for i in range(cfg.num_hidden_layers)]
            except KeyError as e:
                raise ValueError(f"param tree mismatch: missing {e.args[0]}") from None
            out["/".join(("layers",) + sub)] = torch.stack(layers).to(tdt)
        flat = {p: w for p, w in flat.items() if not p[0].startswith("layers_")}
    for p, w in flat.items():
        out["/".join(p)] = w.to(tdt)
    want = named_shapes(cfg)
    if set(out) != set(want):
        raise ValueError(
            f"param tree mismatch: missing={sorted(set(want) - set(out))[:5]} "
            f"extra={sorted(set(out) - set(want))[:5]}"
        )
    for name, t in out.items():
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"shape mismatch at {name}: expected {want[name]}, got {tuple(t.shape)}")
    return out


def load_hf_params(model_dir: str, cfg: ModelConfig, dtype: str | None = None,
                   device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """An HF checkpoint directory -> the port's parameters in `dtype`, by
    default `cfg.param_dtype` (JAX :220), on `device`: each tensor is
    moved there as read, so its transpose runs there."""
    _check_family(cfg)
    flat = {}
    for name, w in _iter_hf_tensors(model_dir):
        path = hf_name_to_ours(name)
        if path is not None:
            flat[path] = _convert_tensor(path, w.to(device), cfg)
    return assemble_params(_stack_experts(flat, cfg), cfg, dtype or cfg.param_dtype)


def save_hf_params(params: dict[str, torch.Tensor], cfg: ModelConfig, out_dir: str, *,
                   upcast_bf16: bool = True, max_shard_bytes: int | None = None) -> str:
    """Write the parameters in HF format in `out_dir` (JAX :488), in
    torch's `[out, in]` layout: by default one `model.safetensors` with
    bf16 upcast to F32 (exact; JAX :505-509). `upcast_bf16=False` keeps
    bf16 tensors as BF16, as HF checkpoints ship them. `max_shard_bytes`
    deals the tensors, in name order, into `model-0000i-of-0000n.safetensors`
    files of at most that many bytes (a larger tensor gets one of its
    own) and writes the `model.safetensors.index.json` that
    `_iter_hf_tensors` reads (`metadata.total_size`, `weight_map`), as
    `save_pretrained` does."""
    _check_family(cfg)
    tensors = {}
    for path, w in flatten_params(params, cfg).items():
        arr = _unconvert_tensor(path, w.detach(), cfg)
        if upcast_bf16 and arr.dtype == torch.bfloat16:
            arr = arr.float()
        tensors[ours_name_to_hf(path, cfg.model_type)] = arr
    os.makedirs(out_dir, exist_ok=True)
    if max_shard_bytes is None:
        write_safetensors(tensors, os.path.join(out_dir, "model.safetensors"))
        return out_dir
    shards: list[list[str]] = [[]]
    size = 0
    for name in sorted(tensors):
        nbytes = tensors[name].numel() * tensors[name].element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += nbytes
    weight_map, total = {}, 0
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        part = {n: tensors[n] for n in names}
        write_safetensors(part, os.path.join(out_dir, fname))
        total += sum(t.numel() * t.element_size() for t in part.values())
        weight_map.update({n: fname for n in names})
    with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
        json.dump(dict(metadata=dict(total_size=total), weight_map=weight_map), f, indent=2)
    return out_dir


_VISION_TOP = {
    # conv (D, C, t, p, p) -> the matmul kernel [C*t*p*p, D]
    "visual.patch_embed.proj.weight": ("patch_embed/kernel", "conv"),
    "visual.merger.ln_q.weight": ("merger/ln_q/scale", None),
    "visual.merger.ln_q.bias": ("merger/ln_q/bias", None),
    "visual.merger.mlp.0.weight": ("merger/fc1_kernel", "t"),
    "visual.merger.mlp.0.bias": ("merger/fc1_bias", None),
    "visual.merger.mlp.2.weight": ("merger/fc2_kernel", "t"),
    "visual.merger.mlp.2.bias": ("merger/fc2_bias", None),
}
_VISION_BLOCK = {
    "norm1.weight": ("norm1/scale", None),
    "norm1.bias": ("norm1/bias", None),
    "norm2.weight": ("norm2/scale", None),
    "norm2.bias": ("norm2/bias", None),
    "attn.qkv.weight": ("attn/qkv_kernel", "qkv"),
    "attn.qkv.bias": ("attn/qkv_bias", "qkv_bias"),
    "attn.proj.weight": ("attn/proj_kernel", "proj"),
    "attn.proj.bias": ("attn/proj_bias", None),
    # Qwen2-VL's gelu MLP
    "mlp.fc1.weight": ("mlp/fc1_kernel", "t"),
    "mlp.fc1.bias": ("mlp/fc1_bias", None),
    "mlp.fc2.weight": ("mlp/fc2_kernel", "t"),
    "mlp.fc2.bias": ("mlp/fc2_bias", None),
    # Qwen2.5-VL's SwiGLU MLP
    "mlp.gate_proj.weight": ("mlp/gate_kernel", "t"),
    "mlp.gate_proj.bias": ("mlp/gate_bias", None),
    "mlp.up_proj.weight": ("mlp/up_kernel", "t"),
    "mlp.up_proj.bias": ("mlp/up_bias", None),
    "mlp.down_proj.weight": ("mlp/down_kernel", "t"),
    "mlp.down_proj.bias": ("mlp/down_bias", None),
}


def load_hf_vision_params(model_dir: str, vcfg, device: torch.device | str = "cpu"
                          ) -> dict[str, torch.Tensor]:
    """The `visual.*` tensors of an HF checkpoint directory -> the vision
    tower's parameters (`models/qwen2_vl.vision_param_shapes`), each in
    its stored dtype, on `device` (JAX :525). Raises ValueError on a
    `visual.*` tensor the mapping does not know (a tower architecture the
    port cannot run must not load "successfully" with weights dropped)
    and on a block missing from a stack."""
    import re

    D, nH, hd, L = vcfg.embed_dim, vcfg.num_heads, vcfg.head_dim, vcfg.depth

    def conv(kind, w):
        if kind == "conv":
            return w.reshape(D, -1).t().contiguous()
        if kind == "t":
            return w.t().contiguous()
        if kind == "qkv":  # [3*nH*hd, D] -> [D, 3, nH, hd]
            return w.reshape(3, nH, hd, D).permute(3, 0, 1, 2).contiguous()
        if kind == "qkv_bias":
            return w.reshape(3, nH, hd)
        if kind == "proj":  # [D, nH*hd] -> [nH, hd, D]
            return w.t().contiguous().reshape(nH, hd, D)
        return w

    out: dict[str, torch.Tensor] = {}
    stacks: dict[str, list] = {}
    unmatched: list[str] = []
    for name, w in _iter_hf_tensors(model_dir):
        if not name.startswith("visual."):
            continue
        w = w.to(device)
        if name in _VISION_TOP:
            path, kind = _VISION_TOP[name]
            out[path] = conv(kind, w)
            continue
        m = re.match(r"visual\.blocks\.(\d+)\.(.+)", name)
        if m and m.group(2) in _VISION_BLOCK:
            path, kind = _VISION_BLOCK[m.group(2)]
            stacks.setdefault(path, [None] * L)[int(m.group(1))] = conv(kind, w)
            continue
        unmatched.append(name)
    if unmatched:
        raise ValueError(
            "unrecognized visual.* tensors (vision architecture not "
            f"supported by this loader): {sorted(unmatched)[:8]}..."
        )
    for path, ws in stacks.items():
        missing = [i for i, x in enumerate(ws) if x is None]
        if missing:
            raise ValueError(f"vision blocks missing layer(s) {missing} for {tuple(path.split('/'))}")
        out[f"blocks/{path}"] = torch.stack(ws)
    return out
