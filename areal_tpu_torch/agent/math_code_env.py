"""Math and code single-step environment (counterpart of
`areal_tpu/agent/math_code_env.py`; parity:
realhf/impl/environment/math_code_single_step_env.py
`MathCodeSingleStepEnv`).

The environment owns per-question metadata (`id2info`: qid -> {"task":
"math" | "code", ...}) and `step((qid, answers))` sends the whole GRPO
group to the matching verifier: math to `reward/remote_verify.
batch_math_verify` (equivalence against the question's `solutions`),
code to `batch_code_verify` (the sandboxed testcases of `input_output`).
Both go to the verification service when `AREAL_VERIFIER_SERVICE` is set
and grade locally otherwise, in worker threads, so the rollout loop never
blocks on sympy or a subprocess. An unknown qid raises.
"""

from __future__ import annotations

import asyncio
from typing import Any

from areal_tpu_torch.api.agent_api import EnvironmentService, register_environment
from areal_tpu_torch.utils import logging

logger = logging.getLogger("math_code_env")


class MathCodeSingleStepEnv(EnvironmentService):
    def __init__(self, id2info: dict[str, dict[str, Any]]):
        self.id2info = dict(id2info)

    async def reset(self, seed=None, options=None):
        if options and "id2info" in options:
            self.id2info = dict(options["id2info"])
        return None

    async def step(self, action: tuple[str, list[str]]):
        """action = (qid, group answers) -> (None, [0/1 per answer],
        True, False, {"task": ...}). Unknown qids raise — a silent zero
        would poison GRPO advantages with fake all-fail groups."""
        qid, answers = action
        qid = str(qid).split("@")[0]
        info = self.id2info[qid]
        task = info.get("task", "math")
        loop = asyncio.get_running_loop()
        if task == "math":
            rewards = await loop.run_in_executor(
                None, self._verify_math, info, list(answers)
            )
        elif task == "code":
            rewards = await loop.run_in_executor(
                None, self._verify_code, info, list(answers)
            )
        else:
            raise ValueError(f"unknown task {task!r} for qid {qid}")
        return None, [float(r) for r in rewards], True, False, {"task": task}

    @staticmethod
    def _verify_math(info: dict, answers: list[str]) -> list[int]:
        # batch seam: offloads to the verify service when
        # AREAL_VERIFIER_SERVICE is set, local thread-pool grading
        # otherwise (parity: math_verify_call switch in the reference env)
        from areal_tpu_torch.reward.remote_verify import batch_math_verify

        qids = ["q"] * len(answers)
        return batch_math_verify({"q": info}, list(answers), qids)

    @staticmethod
    def _verify_code(info: dict, answers: list[str]) -> list[int]:
        from areal_tpu_torch.reward.remote_verify import batch_code_verify

        qids = ["q"] * len(answers)
        return batch_code_verify({"q": info}, list(answers), qids)


register_environment("math-code-single-step", MathCodeSingleStepEnv)
