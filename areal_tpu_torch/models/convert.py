"""Move weights between the JAX package's parameter tree and the port.

The JAX package keeps parameters as a nested dict of arrays; the port
keeps a flat dict of tensors under the `/`-joined names of that tree
(the wire names of `core/weight_transfer.py`). Both accept the scanned
(`layers` stacked `[L, ...]`) and unscanned (`layers_{i}`) forms, whichever
`cfg.scan_layers` says. Only numpy crosses between the packages.
"""

from __future__ import annotations

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
