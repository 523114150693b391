"""Vision RLVR rewards (a copy of `areal_tpu/reward/vqa.py`).

Both graders extract the model's final answer (an <answer> tag, else the
math parser's boxed or trailing answer) and compare it with the ground
truth: an exact count for CLEVR counting, math or choice equivalence for
Geometry3K. `synthetic_vision_reward` scores the offline smoke dataset by
token identity.
"""

from __future__ import annotations

import re

from areal_tpu_torch.reward.math_parser import extract_answer, math_equal


def _extract(completion: str) -> str | None:
    m = re.search(r"<answer>(.*?)</answer>", completion, re.DOTALL)
    if m:
        return m.group(1).strip()
    return extract_answer(completion)


def clevr_count_reward(
    prompt, completion, prompt_ids=None, completion_ids=None, **data
) -> float:
    """Binary reward: the predicted object count equals the label."""
    target = data.get("answer")
    if completion is None or target is None:
        return 0.0
    pred = _extract(completion)
    if pred is None:
        return 0.0
    digits = re.findall(r"-?\d+", pred)
    tdigits = re.findall(r"-?\d+", str(target))
    if not digits or not tdigits:
        return 0.0
    return 1.0 if int(digits[-1]) == int(tdigits[-1]) else 0.0


def geometry3k_reward(
    prompt, completion, prompt_ids=None, completion_ids=None, **data
) -> float:
    """Binary reward: the answer is equivalent to the ground truth
    (numeric or symbolic through the math parser, else a case-insensitive
    string match for multiple-choice letters)."""
    target = data.get("answer")
    if completion is None or target is None:
        return 0.0
    pred = _extract(completion)
    if pred is None:
        return 0.0
    t = str(target).strip()
    if math_equal(pred, t):
        return 1.0
    return 1.0 if pred.strip().lower() == t.lower() else 0.0


def synthetic_vision_reward(
    prompt, completion, prompt_ids=None, completion_ids=None, **data
) -> float:
    """The offline smoke reward of the synthetic-vision dataset: the label
    count (1-4) must appear among the generated token ids (the smoke
    decoder has no numeral text, so token identity stands in for the
    answer digit)."""
    target = data.get("answer")
    if not completion_ids or target is None:
        return 0.0
    return 1.0 if int(target) in list(completion_ids) else 0.0
