"""The countdown task in the port against the JAX package: the offline
dataset's items (two seeds, both splits) equal JAX's, and
`countdown_reward`, `extract_equation` and `safe_eval_arithmetic` return
what JAX's return on the cases of `tests/test_countdown.py` (the
digit-concatenation exploit among them), whose own checks then run on the
port's functions."""

import importlib.util
import types
from pathlib import Path

import pytest

from areal_tpu.dataset import get_custom_dataset as j_dataset
from areal_tpu.reward import countdown as jc
from areal_tpu.utils.arith_eval import safe_eval_arithmetic as j_eval
from areal_tpu_torch.dataset import get_custom_dataset as t_dataset
from areal_tpu_torch.reward import countdown as tc
from areal_tpu_torch.utils.arith_eval import safe_eval_arithmetic as t_eval

HERE = Path(__file__).resolve().parent

# (completion, target, numbers): the cases of tests/test_countdown.py and
# a few more around the number check
REWARD_CASES = [
    ("thinking... <answer>(3 + 4) * 2</answer>", 14, [2, 3, 4]),
    ("<answer>(3 + 4) + 2</answer>", 14, [2, 3, 4]),
    ("<answer>(3 * 3) + 2</answer>", 11, [2, 3, 4]),
    ("the answer is (3+4)*2", 14, [2, 3, 4]),
    ("<answer>1</answer> no wait <answer>(3 + 4) * 2</answer>", 14, [2, 3, 4]),
    ("<answer>3_4 * 1</answer>", 34, [3, 4, 1]),
    ("<answer>34 * 1</answer>", 34, [3, 4, 1]),
    ("<answer>(12 / 4) - 1</answer>", 2, [12, 4, 1]),
    ("<answer>12 / 5 + 1</answer>", 3.4, [12, 5, 1]),
    ("<answer>1.5 * 2 + 1</answer>", 4, [1, 2, 1]),
    ("<answer></answer>", 0, []),
    ("", 3, [3]),
    (None, 3, [3]),
]
EXPRESSIONS = ["__import__('os')", "(lambda: 1)()", "2 ** 10", "1 / 0", "(3 + 4) * 2",
               "-3 + 4", "3_4", "1.5 + 2", "((((1))))", "7 // 2", "2 * (3 - 10) / 7", "", "1e3"]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("split", ["train", "test"])
def test_items_equal_jax(seed, split):
    kw = dict(path="countdown", split=split, seed=seed, n_items=96)
    assert t_dataset(**kw) == j_dataset(**kw)


@pytest.mark.parametrize("case", REWARD_CASES, ids=lambda c: repr(c[0])[:24])
def test_reward_equals_jax(case):
    completion, target, numbers = case
    got = tc.countdown_reward(None, completion, [], [], target=target, numbers=numbers)
    assert got == jc.countdown_reward(None, completion, [], [], target=target,
                                      numbers=numbers)
    assert tc.extract_equation(completion or "") == jc.extract_equation(completion or "")


@pytest.mark.parametrize("expr", EXPRESSIONS)
def test_safe_eval_equals_jax(expr):
    for allow_float in (False, True):
        got, want = t_eval(expr, allow_float=allow_float), j_eval(expr, allow_float=allow_float)
        assert got == want and type(got) is type(want), (expr, allow_float)


def test_jax_cases_hold_on_the_port():
    spec = importlib.util.spec_from_file_location("_jax_cases_countdown",
                                                  HERE / "test_countdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    scope = dict(vars(mod), get_custom_dataset=t_dataset, FORMAT_SCORE=tc.FORMAT_SCORE,
                 SCORE=tc.SCORE, _safe_eval=tc._safe_eval, countdown_reward=tc.countdown_reward,
                 extract_equation=tc.extract_equation)
    # every function of the file, its helper `_r` included, rebuilt over
    # the port's names
    local = {n: types.FunctionType(f.__code__, scope) for n, f in vars(mod).items()
             if isinstance(f, types.FunctionType) and f.__module__ == mod.__name__}
    scope.update(local)
    names = [n for n in local if n.startswith("test_")]
    assert len(names) >= 6
    for name in names:
        local[name]()
