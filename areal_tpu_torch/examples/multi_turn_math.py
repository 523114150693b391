"""Multi-turn self-correction math RL on one CUDA card (counterpart of
`examples/multi_turn_math.py`): the GRPO entry point with
`workflow=multi_turn`, where a wrong answer gets a feedback prompt and
another attempt, the reward discounted per extra turn
(`workflow/multi_turn.py`).

Usage, from the repository root:

  python -m areal_tpu_torch.examples.multi_turn_math \\
      --config examples/configs/arith_grpo_multiturn_smoke.yaml [key=value ...]

From Python, `main([...], device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys
from typing import Any

from areal_tpu_torch.examples.gsm8k_grpo import main as grpo_main


def main(argv: list[str], device: Any = None, **kwargs) -> list[dict[str, Any]]:
    """`gsm8k_grpo.main` on `argv` with `workflow=multi_turn` appended;
    `kwargs` pass through (`model_config`, `reward_fn`)."""
    return grpo_main(list(argv) + ["workflow=multi_turn"], device=device, **kwargs)


if __name__ == "__main__":
    from areal_tpu_torch.utils.experiment import run_with_status

    run_with_status(main, sys.argv[1:])
