"""The Qwen2-VL / Qwen2.5-VL vision tower and its host helpers (counterpart
of `areal_tpu/models/qwen2_vl.py`).

The decode engine runs this tower when it admits a request carrying
`image_data` (`TorchDecodeEngine._encode_images`), splices its outputs
over the `<|image_pad|>` positions (`splice_image_embeds`), prefills from
those embeddings with m-rope tables (`mrope_positions`, `mrope_table`),
and decodes the slot's text with a per-slot rotary offset.

Both HF families, picked from the checkpoint's `vision_config` by
`VisionConfig.from_hf_dict`:
- **Qwen2-VL**: LayerNorm (with bias) norms, fc1 / quick-gelu / fc2 MLP;
- **Qwen2.5-VL**: RMSNorm, SwiGLU (gate / up / down) MLP.

Data contract (the HF AutoProcessor's): `pixel_values` rows arrive
WINDOW-MAJOR (each run of spatial_merge_size^2 rows is one merge window),
each row a voxel flattened as (C, temporal_patch, patch, patch);
`patch_grid_coords` gives the (h, w) of every row in the same order.
Producers holding row-major patches reorder with `window_major_order`.

Parameters are a flat dict of tensors under the `/`-joined names of the
JAX tree ("patch_embed/kernel", "blocks/attn/qkv_kernel", ...), the
`blocks` leaves stacked `[depth, ...]`, in the JAX layouts. The host
helpers are the JAX package's numpy code. `forward_vision` follows the
JAX op order; its matmuls are `torch.matmul` and its attention is plain
PyTorch, as the JAX tower computes it outside any Pallas kernel. The
Qwen2.5-VL tower runs full attention in every block: its windowed
attention (`window_size`, `fullatt_block_indexes`) is not read, as in
JAX (ROADMAP queue 3).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from areal_tpu_torch.models.qwen2 import flatten_names

__all__ = [
    "VisionConfig",
    "init_vision_params",
    "vision_param_logical_axes",
    "forward_vision",
    "splice_image_embeds",
    "window_major_order",
    "patch_grid_coords",
    "mrope_positions",
    "mrope_table",
]


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Vision-tower geometry covering Qwen2-VL and Qwen2.5-VL (JAX :54)."""

    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_size: int = 3584  # language model hidden (merger output)
    norm_type: str = "layer"  # "layer" (2-VL) | "rms" (2.5-VL)
    mlp_type: str = "gelu"  # "gelu" (fc1/fc2) | "silu_glu" (gate/up/down)
    hidden_act: str = "quick_gelu"
    norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size**2

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size**2

    @classmethod
    def from_hf_dict(cls, d: dict) -> "VisionConfig":
        """An HF `vision_config` (JAX :89). `out_hidden_size` or
        `intermediate_size` marks the Qwen2.5-VL layout, whose
        `hidden_size` is the tower's width and `out_hidden_size` the
        language model's."""
        if "out_hidden_size" in d or "intermediate_size" in d:
            embed = d.get("hidden_size", 1280)
            return cls(
                embed_dim=embed,
                depth=d.get("depth", 32),
                num_heads=d.get("num_heads", 16),
                mlp_dim=d.get("intermediate_size", int(embed * 4)),
                in_channels=d.get("in_channels", 3),
                patch_size=d.get("patch_size", 14),
                temporal_patch_size=d.get("temporal_patch_size", 2),
                spatial_merge_size=d.get("spatial_merge_size", 2),
                hidden_size=d.get("out_hidden_size", 3584),
                norm_type="rms",
                mlp_type="silu_glu",
                hidden_act="silu",
            )
        embed = d.get("embed_dim", 1280)
        return cls(
            embed_dim=embed,
            depth=d.get("depth", 32),
            num_heads=d.get("num_heads", 16),
            mlp_dim=int(embed * d.get("mlp_ratio", 4)),
            in_channels=d.get("in_channels", 3),
            patch_size=d.get("patch_size", 14),
            temporal_patch_size=d.get("temporal_patch_size", 2),
            spatial_merge_size=d.get("spatial_merge_size", 2),
            hidden_size=d.get("hidden_size", 3584),
            norm_type="layer",
            mlp_type="gelu",
            hidden_act=d.get("hidden_act", "quick_gelu"),
        )


def _norm_shapes(cfg: VisionConfig, dim: int) -> dict:
    s = {"scale": (dim,)}
    if cfg.norm_type == "layer":
        s["bias"] = (dim,)
    return s


def _block_shapes(cfg: VisionConfig) -> dict:
    D, M = cfg.embed_dim, cfg.mlp_dim
    if cfg.mlp_type == "gelu":
        mlp = {"fc1_kernel": (D, M), "fc1_bias": (M,), "fc2_kernel": (M, D), "fc2_bias": (D,)}
    else:
        mlp = {"gate_kernel": (D, M), "gate_bias": (M,), "up_kernel": (D, M),
               "up_bias": (M,), "down_kernel": (M, D), "down_bias": (D,)}
    return {
        "norm1": _norm_shapes(cfg, D),
        "norm2": _norm_shapes(cfg, D),
        "attn": {
            "qkv_kernel": (D, 3, cfg.num_heads, cfg.head_dim),
            "qkv_bias": (3, cfg.num_heads, cfg.head_dim),
            "proj_kernel": (cfg.num_heads, cfg.head_dim, D),
            "proj_bias": (D,),
        },
        "mlp": mlp,
    }


def vision_param_shapes(cfg: VisionConfig) -> dict[str, tuple]:
    """{"/"-joined name: shape} of every tower parameter (JAX :150), the
    block leaves stacked `[depth, ...]`."""
    blocks = {f"blocks/{k}": (cfg.depth, *s)
              for k, s in flatten_names(_block_shapes(cfg)).items()}
    merger = flatten_names({
        "ln_q": _norm_shapes(cfg, cfg.embed_dim),
        "fc1_kernel": (cfg.merge_dim, cfg.merge_dim),
        "fc1_bias": (cfg.merge_dim,),
        "fc2_kernel": (cfg.merge_dim, cfg.hidden_size),
        "fc2_bias": (cfg.hidden_size,),
    }, "merger")
    return {"patch_embed/kernel": (cfg.patch_dim, cfg.embed_dim), **blocks, **merger}


def vision_param_logical_axes(cfg: VisionConfig) -> dict[str, tuple]:
    """Logical axes of every parameter (JAX :167), the decoder's table
    (heads and mlp are the axes a tensor-parallel mesh would split). The
    port runs on one card and shards nothing yet (ROADMAP queue 1, item
    5); the table is JAX's, name for name."""
    out = {}
    for name, shape in vision_param_shapes(cfg).items():
        leaf = name.split("/")[-1]
        prefix = ("layers",) if name.startswith("blocks/") else ()
        if leaf == "qkv_kernel":
            axes = (*prefix, "embed", None, "heads", "head_dim")
        elif leaf == "qkv_bias":
            axes = (*prefix, None, "heads", "head_dim")
        elif leaf == "proj_kernel":
            axes = (*prefix, "heads", "head_dim", "embed")
        elif leaf in ("fc1_kernel", "gate_kernel", "up_kernel"):
            axes = (*prefix, "embed", "mlp")
        elif leaf in ("fc2_kernel", "down_kernel"):
            axes = (*prefix, "mlp", "embed")
        elif leaf in ("fc1_bias", "gate_bias", "up_bias"):
            axes = (*prefix, "mlp")
        else:
            # JAX's table, one None per dim of the stacked shape
            axes = (*prefix,) + (None,) * len(shape)
        out[name] = axes
    return out


def init_vision_params(cfg: VisionConfig, generator: torch.Generator,
                       dtype: torch.dtype = torch.float32,
                       device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Random tower weights with the JAX distribution (:195): normal x 0.02
    for kernels, ones for norm scales, zeros for biases, drawn from
    `generator` (which must live on `device`)."""
    out = {}
    for name, shape in vision_param_shapes(cfg).items():
        leaf = name.split("/")[-1]
        if leaf == "scale":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif leaf == "bias" or leaf.endswith("_bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            out[name] = (t * 0.02).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Host helpers: patch ordering, grid coords, m-rope positions (numpy)
# ---------------------------------------------------------------------------


def window_major_order(grid_thw: np.ndarray, merge: int) -> np.ndarray:
    """Row-major -> window-major patch permutation (JAX :228), for
    producers that did not use the HF processor (HF pixel_values are
    already window-major)."""
    order = []
    base = 0
    for t, h, w in np.asarray(grid_thw).reshape(-1, 3):
        idx = np.arange(t * h * w).reshape(t, h, w)
        idx = (
            idx.reshape(t, h // merge, merge, w // merge, merge)
            .transpose(0, 1, 3, 2, 4)
            .reshape(-1)
        )
        order.append(base + idx)
        base += t * h * w
    return np.concatenate(order)


def patch_grid_coords(grid_thw: np.ndarray, merge: int) -> np.ndarray:
    """Per-patch (h, w) coordinates in WINDOW-MAJOR row order (JAX :245),
    the permutation HF's rot_pos_emb applies."""
    coords = []
    for t, h, w in np.asarray(grid_thw).reshape(-1, 3):
        hh = np.broadcast_to(np.arange(h)[:, None], (h, w))
        ww = np.broadcast_to(np.arange(w)[None, :], (h, w))

        def wm(a):
            return (
                a.reshape(h // merge, merge, w // merge, merge)
                .transpose(0, 2, 1, 3)
                .reshape(-1)
            )

        c = np.stack([wm(hh), wm(ww)], axis=-1)  # [h*w, 2] window-major
        coords.append(np.tile(c, (t, 1)))
    return np.concatenate(coords)


def mrope_positions(
    input_ids: np.ndarray,
    image_grid_thw: np.ndarray,
    image_token_id: int,
    merge: int,
) -> tuple[np.ndarray, int]:
    """3-D (temporal, height, width) rope positions [3, T] of one sequence
    and its m-rope position delta (JAX :267; HF get_rope_index): an image
    span takes its grid coordinates offset by the running position, and
    text resumes at the span's max + 1, so positions compress against the
    sequence length."""
    ids = np.asarray(input_ids).reshape(-1)
    T = len(ids)
    pos = np.zeros((3, T), dtype=np.int32)
    grids = np.asarray(image_grid_thw).reshape(-1, 3)
    img_idx = 0
    cur = 0
    i = 0
    while i < T:
        if ids[i] == image_token_id and img_idx < len(grids):
            t, h, w = (int(x) for x in grids[img_idx])
            img_idx += 1
            lh, lw = h // merge, w // merge
            n = t * lh * lw
            n = min(n, T - i)  # a truncated prompt keeps a valid table
            tt = np.repeat(np.arange(t), lh * lw)[:n]
            hh = np.tile(np.repeat(np.arange(lh), lw), t)[:n]
            ww = np.tile(np.arange(lw), t * lh)[:n]
            pos[0, i : i + n] = cur + tt
            pos[1, i : i + n] = cur + hh
            pos[2, i : i + n] = cur + ww
            cur += max(t, lh, lw)
            i += n
        else:
            pos[:, i] = cur
            cur += 1
            i += 1
    return pos, cur - T


def mrope_table(
    positions3: np.ndarray,  # [3, T]
    head_dim: int,
    theta: float,
    sections: tuple[int, ...],  # mrope_section; sums to head_dim // 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 [T, head_dim/2] (JAX :305), frequency j driven by
    the position dimension its m-rope section assigns; computed in float64
    on the host, as JAX does."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    sec_id = np.repeat(np.arange(len(sections)), np.asarray(sections))
    assert sec_id.shape[0] == half, (sections, half)
    p = np.asarray(positions3, dtype=np.float64)[sec_id, :].T  # [T, half]
    angles = p * inv[None, :]
    return (
        torch.from_numpy(np.cos(angles).astype(np.float32)),
        torch.from_numpy(np.sin(angles).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# Tower forward
# ---------------------------------------------------------------------------


def _rot_half(x):
    d2 = x.shape[-1] // 2
    return torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)


def _vision_rope(grid_hw: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """2-D rotary tables [N, head_dim] (JAX :337): the first half of the
    frequency pairs rotated by the row coordinate, the second by the
    column."""
    d4 = head_dim // 4
    inv = 1.0 / (theta ** (torch.arange(0, d4, dtype=torch.float32, device=grid_hw.device) / d4))
    h = grid_hw[:, 0].float()[:, None] * inv[None, :]  # [N, d4]
    w = grid_hw[:, 1].float()[:, None] * inv[None, :]
    angles = torch.cat([h, w], dim=-1)  # [N, head_dim/2]
    angles = torch.cat([angles, angles], dim=-1)  # [N, head_dim]
    return torch.cos(angles), torch.sin(angles)


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def _norm(cfg: VisionConfig, v, params: dict, prefix: str, i: int | None = None):
    """LayerNorm or RMSNorm in f32, returned in v's dtype (JAX :372)."""
    def p(name):
        t = params[f"{prefix}/{name}"]
        return t if i is None else t[i]

    v32 = v.float()
    if cfg.norm_type == "layer":
        mu = v32.mean(dim=-1, keepdim=True)
        var = (v32 - mu).square().mean(dim=-1, keepdim=True)
        out = (v32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p("scale") + p("bias")
    else:
        var = v32.square().mean(dim=-1, keepdim=True)
        out = v32 * torch.rsqrt(var + cfg.norm_eps) * p("scale")
    return out.to(v.dtype)


def forward_vision(
    params: dict[str, torch.Tensor],
    pixel_values: torch.Tensor,  # [N, patch_dim] WINDOW-MAJOR rows (HF format)
    grid_coords: torch.Tensor,  # [N, 2] (h, w) per patch, window-major
    cfg: VisionConfig,
    valid: torch.Tensor | None = None,  # [N] bool: real rows (pads masked out)
) -> torch.Tensor:
    """[N, patch_dim] patches -> [N / merge^2, hidden_size] embeddings in
    pixel_values' dtype (JAX :355), in the JAX op order: the kernels cast
    to the compute dtype, the 2-D rotary on q and k, scores cast to f32
    and divided by sqrt(hd), -1e30 where either row is invalid,
    probabilities rounded back, and the merger's tanh-approximate GELU."""
    compute = pixel_values.dtype
    D, nH, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    N = pixel_values.shape[0]

    def w(name, i=None):
        t = params[name] if i is None else params[name][i]
        return t.to(compute)

    x = pixel_values @ w("patch_embed/kernel")
    cos, sin = _vision_rope(grid_coords, hd)
    c = cos[:, None, :].to(compute)
    s = sin[:, None, :].to(compute)
    mask = None if valid is None else (valid[None, :] & valid[:, None])
    act = _act(cfg.hidden_act)
    for i in range(cfg.depth):
        h = _norm(cfg, x, params, "blocks/norm1", i)
        qkv = (h @ w("blocks/attn/qkv_kernel", i).reshape(D, -1)).reshape(N, 3, nH, hd)
        qkv = qkv + w("blocks/attn/qkv_bias", i)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # [N, nH, hd]
        q = q * c + _rot_half(q) * s
        k = k * c + _rot_half(k) * s
        scores = torch.einsum("nhd,mhd->hnm", q, k).float() / math.sqrt(hd)
        if mask is not None:
            scores = torch.where(mask[None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1).to(compute)
        del scores
        att = torch.einsum("hnm,mhd->nhd", probs, v)
        proj = att.reshape(N, nH * hd) @ w("blocks/attn/proj_kernel", i).reshape(nH * hd, D)
        x = x + proj + w("blocks/attn/proj_bias", i)
        h = _norm(cfg, x, params, "blocks/norm2", i)
        if cfg.mlp_type == "gelu":
            h = act(h @ w("blocks/mlp/fc1_kernel", i) + w("blocks/mlp/fc1_bias", i))
            m = h @ w("blocks/mlp/fc2_kernel", i) + w("blocks/mlp/fc2_bias", i)
        else:
            gate = h @ w("blocks/mlp/gate_kernel", i) + w("blocks/mlp/gate_bias", i)
            up = h @ w("blocks/mlp/up_kernel", i) + w("blocks/mlp/up_bias", i)
            m = (F.silu(gate) * up) @ w("blocks/mlp/down_kernel", i) + w("blocks/mlp/down_bias", i)
        x = x + m
    x = _norm(cfg, x, params, "merger/ln_q")
    m2 = cfg.spatial_merge_size**2
    x = x.reshape(N // m2, m2 * D)
    h = F.gelu(x @ w("merger/fc1_kernel") + w("merger/fc1_bias"), approximate="tanh")
    return h @ w("merger/fc2_kernel") + w("merger/fc2_bias")


def splice_image_embeds(
    token_embeds: torch.Tensor,  # [T, H]
    input_ids: torch.Tensor,  # [T]
    image_embeds: torch.Tensor,  # [K, H] (>= the image-pad count; extra rows unread)
    image_token_id: int,
) -> torch.Tensor:
    """Replace the embeddings at `<|image_pad|>` positions with the vision
    vectors, in order (JAX :428)."""
    is_img = input_ids == image_token_id  # [T]
    order = torch.cumsum(is_img.to(torch.int64), dim=0) - 1  # -1 before the first
    order = order.clamp(0, image_embeds.shape[0] - 1)
    gathered = image_embeds[order].to(token_embeds.dtype)  # [T, H]
    return torch.where(is_img[:, None], gathered, token_embeds)
