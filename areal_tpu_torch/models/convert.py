"""Move weights between the JAX package's parameter tree and the port.

The JAX package keeps parameters as a nested dict of arrays; the port
keeps a flat dict of tensors under the `/`-joined names of that tree
(the wire names of `core/weight_transfer.py`). Both accept the scanned
(`layers` stacked `[L, ...]`) and unscanned (`layers_{i}`) forms, whichever
`cfg.scan_layers` says. The vision tower's tree (`models/qwen2_vl.py`)
moves the same way, its `blocks` stacked `[depth, ...]` in both. Only
numpy crosses between the packages.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from areal_tpu_torch.models.qwen2 import (
    ModelConfig,
    flatten_names,
    named_shapes,
    torch_dtype,
)


def to_tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def unstack_layers(tree: dict) -> dict:
    """A scanned tree (`layers` leaves stacked `[L, ...]`) -> the unscanned
    form (`layers_{i}` subtrees), the layout the port's trainer keeps."""
    if "layers" not in tree:
        return tree
    out = {k: v for k, v in tree.items() if k != "layers"}

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    L = len(next(iter(flatten_names(tree["layers"]).values())))
    for i in range(L):
        out[f"layers_{i}"] = take(tree["layers"], i)
    return out


def params_from_numpy(
    tree: dict, cfg: ModelConfig, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port's flat tensor dict, in
    `cfg.param_dtype`. Names and shapes must match `cfg` exactly; a scanned
    tree is unstacked first when `cfg` is unscanned."""
    if not cfg.scan_layers:
        tree = unstack_layers(tree)
    named = flatten_names(tree)
    want = named_shapes(cfg)
    if set(named) != set(want):
        missing = sorted(set(want) - set(named))[:5]
        extra = sorted(set(named) - set(want))[:5]
        raise KeyError(f"parameter names differ: missing {missing}, extra {extra}")
    dtype = torch_dtype(cfg.param_dtype)
    out = {}
    for name, arr in named.items():
        t = to_tensor(arr)
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
        out[name] = t.to(device=device, dtype=dtype)
    return out


def to_numpy(params: dict[str, torch.Tensor]) -> dict:
    """Inverse of `params_from_numpy`: a nested tree of numpy arrays, in
    float32 (bfloat16 upcasts exactly, and numpy has no bfloat16)."""
    tree: dict = {}
    for name, t in params.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


_LAYER = re.compile(r"^layers_(\d+)/(.*)$")


def to_layout(named: dict, cfg: ModelConfig) -> dict:
    """Flat `/`-named tensors in either layer layout -> the
    layout `cfg.scan_layers` names: `layers_{i}/<leaf>` entries are
    stacked into `layers/<leaf>` `[L, ...]` for a scanned model, and a
    stacked `layers/<leaf>` is split into per-layer views for an unscanned
    one. Other names pass through. Weight pushes name the trainer's
    configured layout; a decode server installs into its own."""
    L = cfg.num_hidden_layers
    out, per_layer = {}, {}
    for name, t in named.items():
        m = _LAYER.match(name)
        if m and cfg.scan_layers:
            per_layer.setdefault(m.group(2), {})[int(m.group(1))] = t
        elif name.startswith("layers/") and not cfg.scan_layers:
            leaf = name[len("layers/"):]
            if len(t) != L:
                raise ValueError(f"{name}: {len(t)} stacked layers, the model has {L}")
            for i in range(L):
                out[f"layers_{i}/{leaf}"] = t[i]
        else:
            out[name] = t
    for leaf, layers in per_layer.items():
        if sorted(layers) != list(range(L)):
            raise KeyError(f"layers_*/{leaf}: layers {sorted(layers)} of {L}")
        out[f"layers/{leaf}"] = torch.stack([layers[i] for i in range(L)])
    return out


def vision_params_from_numpy(
    tree: dict, vcfg, dtype: torch.dtype | None = None,
    device: torch.device | str = "cpu",
) -> dict[str, torch.Tensor]:
    """The JAX vision tower's tree (numpy leaves, `blocks` stacked) -> the
    port's flat tensor dict (`models/qwen2_vl.vision_param_shapes`), in
    each leaf's own dtype unless `dtype` is given. Names and shapes must
    match `vcfg` exactly."""
    from areal_tpu_torch.models.qwen2_vl import vision_param_shapes

    named = flatten_names(tree)
    want = vision_param_shapes(vcfg)
    if set(named) != set(want):
        missing = sorted(set(want) - set(named))[:5]
        extra = sorted(set(named) - set(want))[:5]
        raise KeyError(f"vision parameter names differ: missing {missing}, extra {extra}")
    out = {}
    for name, arr in named.items():
        t = to_tensor(arr)
        if tuple(t.shape) != tuple(want[name]):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {want[name]}")
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out
