"""Tool-integrated reasoning (TIR) math RL on one CUDA card (counterpart of
`examples/tir_math.py`): the GRPO entry point with `workflow=tir`, where
the model writes ```python blocks that run in a sandbox mid-generation and
the interpreter's output is spliced back into the context, masked from
the loss (`workflow/tir.py`).

Usage, from the repository root:

  # offline smoke (synthetic arithmetic; the arithmetic tokenizer cannot
  # spell a ```python fence, so tool calls are optional):
  python -m areal_tpu_torch.examples.tir_math \\
      --config examples/configs/tir_math.yaml \\
      tokenizer_path=synthetic-arith train_dataset.path=synthetic-arith \\
      actor.path= decode.model_path= actor.init_from_scratch=true

  # ToRL data with Qwen2.5-Math-1.5B-Instruct from local paths:
  python -m areal_tpu_torch.examples.tir_math \\
      --config examples/configs/tir_math.yaml

From Python, `main([...], device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys
from typing import Any

from areal_tpu_torch.examples.gsm8k_grpo import main as grpo_main


def main(argv: list[str], device: Any = None, **kwargs) -> list[dict[str, Any]]:
    """`gsm8k_grpo.main` on `argv` with `workflow=tir` appended; `kwargs`
    pass through (`model_config`, `reward_fn`)."""
    return grpo_main(list(argv) + ["workflow=tir"], device=device, **kwargs)


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
