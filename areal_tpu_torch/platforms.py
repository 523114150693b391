"""Device selection (counterpart of `areal_tpu/platforms/__init__.py`).

The port runs its kernels on one Hopper card (compute capability 9.0,
the `sm_90a` target they are compiled for). The CPU is used only when a
caller asks for it by name, as the tests do: there is no silent fallback.
"""

from __future__ import annotations

import torch

from areal_tpu_torch.utils import logging

logger = logging.getLogger("platforms")

REQUIRED_CAPABILITY = (9, 0)


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`cuda:0` (or the named CUDA device) after checking it is sm_90;
    `cpu` only when `device` names the CPU. Raises otherwise.

    On the CUDA path this also turns TF32 off for float32 matmuls and
    convolutions, so float32 work on the card runs in full float32, as
    the references the port is checked against do."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"device={device!r}: the port runs on 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if tuple(cap) != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the port's kernels are built for sm_90a "
            "(Hopper)"
        )
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        logger.info("TF32 off: float32 matmuls and convolutions run in float32")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
