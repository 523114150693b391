"""Vision GRPO on CLEVR counting (counterpart of `examples/clevr_grpo.py`):
RLVR for a vision-language model. The processor renders multimodal chat
prompts, image patches ride the request to the decode engine's vision
tower, and training stays token-only. It is the GRPO entry point
(`gsm8k_grpo.py`) with `workflow=vision_rlvr` appended.

Usage, from the repository root:

  # fully offline: the smoke decoder, a tiny tower, synthetic counting
  # images
  python -m areal_tpu_torch.examples.clevr_grpo \\
      --config examples/configs/clevr_grpo.yaml \\
      tokenizer_path=synthetic-arith train_dataset.path=synthetic-vision \\
      actor.path= decode.model_path= actor.init_from_scratch=true

  # a Qwen2.5-VL checkpoint on clevr_count_70k (local files):
  python -m areal_tpu_torch.examples.clevr_grpo \\
      --config examples/configs/clevr_grpo.yaml

It runs on `cuda:0`; from Python, `main([...], device="cpu")` runs the
same loop on the CPU.
"""

from __future__ import annotations

import sys
from typing import Any

from areal_tpu_torch.examples.gsm8k_grpo import main as grpo_main


def main(argv: list[str], device: Any = None, **kw) -> list[dict[str, Any]]:
    return grpo_main(list(argv) + ["workflow=vision_rlvr"], device=device, **kw)


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
