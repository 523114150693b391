"""Countdown task reward: reach a target with given numbers (a copy of
`areal_tpu/reward/countdown.py`).

Parity: the reference's examples/countdown/reward_score.py — extract the
`<answer>equation</answer>` from the completion, require every provided
number be used exactly once, evaluate, and score 1.0 on hitting the
target, 0.1 for a well-formed-but-wrong equation (format score), 0
otherwise.

Implementation difference: the equation is evaluated by walking a
restricted AST (+, -, *, / over integer literals) instead of the
reference's regex-guarded `eval` — no code execution surface at all.
"""

from __future__ import annotations

import re

FORMAT_SCORE = 0.1
SCORE = 1.0

_ANSWER_RE = re.compile(r"<answer>(.*?)</answer>", re.DOTALL)


def extract_equation(completion: str) -> str | None:
    matches = _ANSWER_RE.findall(completion)
    return matches[-1].strip() if matches else None


def _safe_eval(expr: str) -> float | None:
    """Integer-only arithmetic evaluation (utils/arith_eval.py): floats
    and digit-grouping literals are scoring exploits here, not numbers."""
    from areal_tpu_torch.utils.arith_eval import safe_eval_arithmetic

    return safe_eval_arithmetic(expr, allow_float=False)


def _uses_numbers_exactly(expr: str, numbers: list[int]) -> bool:
    used = sorted(int(n) for n in re.findall(r"\d+", expr))
    return used == sorted(int(n) for n in numbers)


def countdown_reward(
    prompt, completion, prompt_ids, completion_ids, *, target, numbers, **kw
) -> float:
    """1.0 for a valid equation hitting `target`, 0.1 for a present-but-
    wrong equation, 0.0 otherwise."""
    equation = extract_equation(completion or "")
    if equation is None:
        return 0.0
    if not _uses_numbers_exactly(equation, list(numbers)):
        return FORMAT_SCORE
    value = _safe_eval(equation)
    if value is None:
        return FORMAT_SCORE
    return SCORE if abs(value - float(target)) < 1e-5 else FORMAT_SCORE
