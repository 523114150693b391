"""The port's math grader (`areal_tpu_torch/reward/math_parser.py`) against
the JAX package's.

Every (prediction, target) pair of `tests/test_math_parser.py` grades the
same in both packages and as that file expects; its other cases run on
the port's functions; and a hypothesis stream of numbers, fractions,
`\\boxed{}` answers and "#### n" solutions goes through `extract_answer`,
`normalize_answer`, `math_equal`, `math_verify_reward` and
`process_results` of both, which must return equal values. The
subprocess grader grades an equal pair True and times a hanging one
(sympy on a tower of powers) out to False.
"""

import importlib.util
import time
import types
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from areal_tpu.reward import math_parser as jm
from areal_tpu_torch.reward import math_parser as tm

HERE = Path(__file__).resolve().parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_cases_{name}", HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JT = _load("test_math_parser")
GRADE_PAIRS = JT.GRADE_PAIRS
STRINGS = sorted({p for p, _, _ in GRADE_PAIRS} | {t for _, t, _ in GRADE_PAIRS})


@pytest.mark.parametrize("pred,target,expected", GRADE_PAIRS)
def test_grade_pairs_equal_jax(pred, target, expected):
    assert tm.math_equal(pred, target) == jm.math_equal(pred, target) == expected


def test_string_functions_equal_jax_on_every_case_string():
    for s in STRINGS:
        for fn in ("extract_answer", "normalize_answer", "parse_number", "extract_boxed"):
            assert getattr(tm, fn)(s) == getattr(jm, fn)(s), (fn, s)
        assert tm.math_verify_reward(None, s, answer="7") == jm.math_verify_reward(
            None, s, answer="7"), s
        assert tm.process_results(s, "\\boxed{7}") == jm.process_results(s, "\\boxed{7}"), s


# tests/test_math_parser.py's other cases (all but the parametrized pairs,
# the subprocess grader, run below, and the dataset mapper, held in
# test_torch_datasets.py), with the port's functions in place of JAX's
_JAX_CASES = sorted(
    n for n, f in vars(JT).items()
    if n.startswith("test_") and isinstance(f, types.FunctionType)
    and n not in ("test_grade_pairs", "test_subprocess_grader", "test_math_items_schema")
)


@pytest.mark.parametrize("name", _JAX_CASES)
def test_jax_cases_hold_on_the_port(name):
    scope = dict(vars(JT))
    scope.update({k: getattr(tm, k) for k in vars(JT) if hasattr(tm, k) and hasattr(jm, k)
                  and getattr(jm, k) is vars(JT)[k]})
    assert scope["math_equal"] is tm.math_equal
    types.FunctionType(vars(JT)[name].__code__, scope)()


_num = st.one_of(
    st.integers(-10_000, 10_000).map(str),
    st.floats(-1e4, 1e4, allow_nan=False, allow_infinity=False).map(lambda x: f"{x:.4g}"),
    st.tuples(st.integers(-50, 50), st.integers(1, 50)).map(lambda t: f"\\frac{{{t[0]}}}{{{t[1]}}}"),
    st.tuples(st.integers(-50, 50), st.integers(1, 50)).map(lambda t: f"{t[0]}/{t[1]}"),
    st.integers(0, 100).map(lambda n: f"{n}\\%"),
    st.integers(1, 99).map(lambda n: f"\\sqrt{{{n}}}"),
)
_answer = st.one_of(
    _num,
    _num.map(lambda s: f"so the result is \\boxed{{{s}}}."),
    _num.map(lambda s: f"Step 1. Compute.\n#### {s}"),
    _num.map(lambda s: f"The answer is {s}"),
    st.text(alphabet="0123456789 +-*/=.x", max_size=20),
)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(pred=_answer, target=_answer)
def test_hypothesis_stream_equals_jax(pred, target):
    for fn in ("extract_answer", "normalize_answer"):
        assert getattr(tm, fn)(pred) == getattr(jm, fn)(pred), (fn, pred)
    assert tm.math_equal(pred, target) == jm.math_equal(pred, target), (pred, target)
    gt = target.split("####")[-1].strip()
    assert tm.math_verify_reward(None, pred, answer=gt) == jm.math_verify_reward(
        None, pred, answer=gt), (pred, gt)
    assert tm.process_results(pred, target) == jm.process_results(pred, target), (pred, target)


def test_subprocess_grader_grades_and_times_out():
    assert tm.math_equal_subprocess("1/2", "0.5", timeout_s=30)
    assert not tm.math_equal_subprocess("1/2", "0.6", timeout_s=30)
    # sympy expands the tower and does not come back: the child is
    # terminated at its timeout and the grade is False
    t0 = time.monotonic()
    assert not tm.math_equal_subprocess("9^{9^{9^{9}}}", "1", timeout_s=2.0)
    assert time.monotonic() - t0 < 15
